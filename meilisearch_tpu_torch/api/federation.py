"""Multi-search and federated search.

Reference: routes/multi_search.rs + search/federated/perform.rs — in
non-federated mode each query runs independently; in federation mode hits
from all queries are merged by weighted ranking score, each annotated with
`_federation` metadata. Remote queries are proxied over HTTP
(federated/proxy.rs) when a network topology is configured.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

from ..search.perform import (
    build_hits,
    include_metadata_header,
    perform_search,
    search_metadata,
)
from ..types.errors import EngineError, ErrorCode


_QUERY_SCOPED_CODES = {
    # per-query errors whose message gains an "Index `uid`: " scope when
    # wrapped for multi-search (reference multi/mod.rs federation_one_query
    # _error vs search_one_query_error: filter/sort/distinct errors carry
    # the index scope; facets and index_not_found do not). Filter errors
    # are absent here because search/filters.py already prefixes them
    # with the index scope (single-search parity).
    ErrorCode.INVALID_SEARCH_SORT,
    ErrorCode.INVALID_SEARCH_DISTINCT,
}


def _wrap_query_error(err: EngineError, qi: int, index_uid: str):
    """Re-raise a per-query error as the multi-search surface: message
    prefixed with the query position, HTTP status forced to 400 (even
    index_not_found — multi/mod.rs pins 400, not 404), code preserved."""
    scope = (
        f"Index `{index_uid}`: " if err.code in _QUERY_SCOPED_CODES else ""
    )
    raise EngineError(
        err.code,
        f"Inside `.queries[{qi}]`: {scope}{err.message}",
        status=400,
    ) from err


def _check_index_uid(qi: int, query: dict) -> str:
    """deserr-level indexUid validation (multi/mod.rs
    simple_search_missing_index_uid / _illegal_index_uid)."""
    from ..engine.scheduler import VALID_INDEX_UID

    if not isinstance(query, dict):
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            f"Invalid value type at `.queries[{qi}]`: expected an object.",
        )
    index_uid = query.get("indexUid")
    if index_uid is None:
        raise EngineError(
            ErrorCode.MISSING_INDEX_UID,
            f"Missing field `indexUid` inside `.queries[{qi}]`",
        )
    if not isinstance(index_uid, str):
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            f"Invalid value at `.queries[{qi}].indexUid`: expected a string.",
        )
    if not VALID_INDEX_UID.match(index_uid):
        raise EngineError(
            ErrorCode.INVALID_INDEX_UID,
            f"Invalid value at `.queries[{qi}].indexUid`: `{index_uid}` is"
            " not a valid index uid. Index uid can be an integer or a string"
            " containing only alphanumeric characters, hyphens (-) and"
            " underscores (_), and can not be more than 512 bytes.",
        )
    return index_uid


def _validate_query_params(app, qi: int, index_uid: str, query: dict):
    """Query-order validation BEFORE any query executes: the reference
    runs queries sequentially so the FIRST invalid query (by position)
    surfaces, even when a later group would execute earlier here
    (multi/mod.rs federation_multiple_query_errors_interleaved)."""
    from ..search.facets import validate_facets
    from ..search.perform import check_distinct_filterable

    try:
        store = app.scheduler.index(index_uid)
    except EngineError as err:
        _wrap_query_error(err, qi, index_uid)
    def _mentions_foreign(flt) -> bool:
        if isinstance(flt, str):
            return "_foreign" in flt
        if isinstance(flt, list):
            return any(_mentions_foreign(f) for f in flt)
        return False

    try:
        from ..search.filters import evaluate_filter

        # `_foreign(..)` join filters resolve later (apply_foreign_filter)
        # with their own pinned error shapes — don't pre-evaluate them raw
        if query.get("filter") is not None and not _mentions_foreign(
            query.get("filter")
        ):
            evaluate_filter(store, query.get("filter"), as_array=True)
        sort = query.get("sort")
        if sort is not None:
            from ..search.executor import Search

            Search(
                store,
                query=query.get("q"),
                sort_criteria=[sort] if isinstance(sort, str) else sort,
            )._check_sort_criteria()
        if query.get("facets"):
            validate_facets(store, query["facets"])
        if query.get("distinct") is not None:
            check_distinct_filterable(store, query["distinct"])
    except EngineError as err:
        _wrap_query_error(err, qi, index_uid)
    return store


def perform_multi_search(app, req) -> dict:
    body = req.body if req.body is not None else {}
    if not isinstance(body, dict):
        import json as _json

        raise EngineError(
            ErrorCode.BAD_REQUEST,
            "Invalid value type: expected an object, but found"
            f" {'an array' if isinstance(body, list) else 'a value'}:"
            f" `{_json.dumps(body, separators=(',', ':'))}`",
        )
    queries = body.get("queries")
    federation = body.get("federation")
    if not isinstance(queries, list):
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            "Missing field `queries`",
        )

    if federation is None:
        for i, query in enumerate(queries):
            index_uid = _check_index_uid(i, query)
            if "federationOptions" in query:
                raise EngineError(
                    ErrorCode.INVALID_MULTI_SEARCH_FEDERATION_OPTIONS,
                    f"Inside `.queries[{i}]`: Using `federationOptions` is"
                    " not allowed in a non-federated search.\n - Hint:"
                    " remove `federationOptions` from the query or add"
                    " `federation` to the request.",
                )
            app.auth.authenticate(req.auth_token, "search", index_uid)
        for i, query in enumerate(queries):
            _validate_query_params(app, i, query["indexUid"], query)
        # group per index so chain-compatible queries share device batches
        # (SURVEY §2.6 batched query execution)
        from ..search.join import apply_foreign_filter, hydrate_response
        from ..search.perform import perform_search_many

        by_index: dict[str, list[int]] = {}
        for i, query in enumerate(queries):
            by_index.setdefault(query["indexUid"], []).append(i)
        results: list = [None] * len(queries)
        for index_uid, idxs in by_index.items():
            store = app.scheduler.index(index_uid)
            bodies = [
                {k: v for k, v in queries[i].items() if k != "indexUid"}
                for i in idxs
            ]
            for i, body in zip(idxs, bodies):
                apply_foreign_filter(app.scheduler, store, body, qpos=i)
            answers = perform_search_many(
                store, bodies, device=app.device, strict=app.strict
            )
            for i, res in zip(idxs, answers):
                hydrate_response(app.scheduler, store, res)
                results[i] = {"indexUid": index_uid, **res}
        if include_metadata_header(req.headers):
            for i, query in enumerate(queries):
                store = app.scheduler.index(query["indexUid"])
                results[i]["metadata"] = search_metadata(
                    store, query.get("q"), with_query=True
                )
        return {"results": results}

    # -- federated ---------------------------------------------------------
    started = time.perf_counter()
    limit = int(federation.get("limit", 20) or 20)
    offset = int(federation.get("offset", 0) or 0)
    fed_distinct = federation.get("distinct")
    network_self = (app.scheduler.network or {}).get("self")

    # query-order validation pre-pass: the whole request must 400 BEFORE
    # any local execution or remote dispatch (reference deserr parse +
    # sequential query validation, multi/mod.rs error suites)
    for qi, query in enumerate(queries):
        index_uid = _check_index_uid(qi, query)
        if "showPerformanceDetails" in query:
            # performance details move to the federation level in
            # federated search (performance_details.rs invalid_federated)
            raise EngineError(
                ErrorCode.INVALID_MULTI_SEARCH_QUERY_SHOW_PERFORMANCE_DETAILS,
                f"Inside `.queries[{qi}]`: Using `.showPerformanceDetails`"
                " is not allowed in federated queries.\n - Hint: remove"
                " `showPerformanceDetails` from the query or remove"
                " `federation` from the request",
            )
        fed_opts = query.get("federationOptions") or {}
        weight = fed_opts.get("weight", 1.0)
        if isinstance(weight, bool) or not isinstance(weight, (int, float)):
            raise EngineError(
                ErrorCode.INVALID_MULTI_SEARCH_WEIGHT,
                f"Invalid value at `.queries[{qi}].federationOptions.weight`:"
                " the value of `weight` is invalid, expected a positive"
                " float (>= 0.0).",
            )
        if weight < 0:
            raise EngineError(
                ErrorCode.INVALID_MULTI_SEARCH_WEIGHT,
                f"Invalid value at `.queries[{qi}].federationOptions.weight`:"
                " the value of `weight` is invalid, expected a positive"
                " float (>= 0.0).",
            )
        for field in ("offset", "limit", "page", "hitsPerPage"):
            if field in query:
                raise EngineError(
                    ErrorCode.INVALID_MULTI_SEARCH_QUERY_PAGINATION,
                    f"Inside `.queries[{qi}]`: Using pagination options is"
                    " not allowed in federated queries.\n - Hint: remove"
                    f" `{field}` from the query or remove `federation` from"
                    " the request\n - Hint: pass `federation.limit` and"
                    " `federation.offset` for pagination in federated"
                    " search",
                )
        if query.get("facets"):
            import json as _json

            raise EngineError(
                ErrorCode.INVALID_MULTI_SEARCH_QUERY_FACETS,
                f"Inside `.queries[{qi}]`: Using facet options is not"
                " allowed in federated queries.\n - Hint: remove `facets`"
                " from the query or remove `federation` from the request\n"
                f" - Hint: pass `federation.facetsByIndex.{index_uid}:"
                f" {_json.dumps(query['facets'])}` for facets in federated"
                " search",
            )
        if fed_distinct is not None and "distinct" in query:
            raise EngineError(
                ErrorCode.INVALID_MULTI_SEARCH_DISTINCT,
                f"Inside `.queries[{qi}]`: Using `distinct` options is not"
                " allowed in federated queries when it also appears in"
                " `.federation.distinct`.\n - Hint: remove `distinct` from"
                " the query or remove `federation` from the request\n "
                " - Note: `distinct` at the query level is discouraged in"
                " federated search.",
            )
        remote_name = fed_opts.get("remote")
        if (remote_name and remote_name != network_self) or fed_opts.get("shard"):
            # index existence + params are the remote's (or the shard
            # owners') to check: a shard this node does not hold is proxied
            continue
        store = _validate_query_params(app, qi, index_uid, query)
        if fed_distinct is not None:
            from ..search.perform import check_distinct_filterable

            try:
                check_distinct_filterable(store, fed_distinct)
            except EngineError as err:
                _wrap_query_error(err, qi, index_uid)

    # facetsByIndex validation (multi/mod.rs federation_non_faceted_for_
    # an_index): errors scope to the first query using the index, or
    # carry a "not used in queries" note
    fbi = federation.get("facetsByIndex") or {}
    for fbi_uid, fbi_facets in fbi.items():
        first_qi = next(
            (
                qi
                for qi, q in enumerate(queries)
                if q.get("indexUid") == fbi_uid
            ),
            None,
        )
        try:
            fbi_store = app.scheduler.index(fbi_uid)
            from ..search.facets import validate_facets

            validate_facets(fbi_store, fbi_facets)
        except EngineError as err:
            inner = f"Inside `.federation.facetsByIndex.{fbi_uid}`: {err.message}"
            if first_qi is None:
                msg = (
                    f"{inner}\n - Note: index `{fbi_uid}` is not used in"
                    " queries"
                )
            else:
                msg = f"Inside `.queries[{first_qi}]`: {inner}"
            raise EngineError(err.code, msg, status=400) from err

    show_perf = federation.get("showPerformanceDetails", False)
    if not isinstance(show_perf, bool):
        from ..search.perform import _fmt_json, _json_type_name

        raise EngineError(
            ErrorCode.INVALID_SEARCH_SHOW_PERFORMANCE_DETAILS,
            "Invalid value type at `.federation.showPerformanceDetails`:"
            " expected a boolean, but found"
            f" {_json_type_name(show_perf)}: `{_fmt_json(show_perf)}`",
        )

    all_hits: list[tuple[float, int, dict]] = []
    seen_pairs: dict[tuple[str, str], float] = {}
    remote_errors: dict[str, dict] = {}
    want_meta = include_metadata_header(req.headers)
    remote_primary_keys: dict[tuple[str, str], str] = {}
    # per-index union of matched docids, for federated facet counting
    # (reference merges per-query candidates before FacetDistribution)
    candidates_by_index: dict[str, set] = {}

    # shard-targeted queries: `federationOptions.shard` fans the query to
    # the shard's owner remotes under the CURRENT topology and — during a
    # resharding window (network.previousShards, set by PATCH /network
    # until the networkTopologyChange task succeeds) — to every previous
    # owner too. Each clone carries a `_shard = <name>` filter evaluated
    # under the receiving instance's NEW topology, so documents that have
    # not moved yet still surface on their old owner; the merged-hit
    # dedup below collapses double-finds. Reference:
    # federated/perform.rs + tasks/network.rs previousShards semantics.
    network = app.scheduler.network
    expanded: list[tuple[int, dict]] = []
    for qi, query in enumerate(queries):
        fed_opts = dict(query.get("federationOptions") or {})
        shard_name = fed_opts.pop("shard", None)
        if not shard_name:
            expanded.append((qi, query))
            continue
        cur = (network.get("shards") or {}).get(shard_name) or {}
        replicas = sorted(cur.get("remotes") or [], key=str)
        # replica failover (reference leader/replica semantics): query ONE
        # available replica of the shard — self first, then the first
        # replica outside its backoff window; the remaining replicas ride
        # along as alternates the proxy loop fails over to
        primary, alternates = _pick_replica(replicas, network)
        targets: list = [primary] if primary is not None else []
        prev = network.get("previousShards")
        prev_targets: set = set()
        if prev:
            for ent in prev.values():
                prev_targets.update((ent or {}).get("remotes") or [])
        prev_targets -= {primary}
        targets.extend(sorted(prev_targets, key=str))
        if not targets:
            targets = [network.get("self")]
        shard_filter = "_shard = '{}'".format(shard_name.replace("'", "\\'"))
        for rname in targets:
            q = dict(query)
            fo = dict(fed_opts)
            if rname and rname != network.get("self"):
                fo["remote"] = rname
            else:
                fo.pop("remote", None)
            q["federationOptions"] = fo
            orig_filter = query.get("filter")
            q["filter"] = [shard_filter] + (
                [orig_filter] if orig_filter is not None else []
            )
            if rname == primary and alternates:
                q["_shard_alternates"] = alternates
            expanded.append((qi, q))

    # partition queries by remote and proxy them over HTTP
    # (reference: federated/proxy.rs — header Meili-Proxy-Search: true)
    remote_queries: dict[str, list[tuple[int, dict]]] = {}
    local_queries: list[tuple[int, dict]] = []
    for qi, query in expanded:
        remote_name = (query.get("federationOptions") or {}).get("remote")
        if remote_name:
            remote_queries.setdefault(remote_name, []).append((qi, query))
        else:
            local_queries.append((qi, query))

    pending_remote = list(remote_queries.items())
    while pending_remote:
        remote_name, entries = pending_remote.pop(0)
        remote = (app.scheduler.network.get("remotes") or {}).get(remote_name)
        if remote is None:
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                f"Invalid `queries[{entries[0][0]}].federationOptions.remote`:"
                f" remote `{remote_name}` is not registered",
            )
        # a remote-proxied query is still scoped by the caller's key: the
        # key must grant `search` on the named index, exactly as for local
        # queries (reference authenticates every federated query uniformly)
        for qi, query in entries:
            index_uid = query.get("indexUid")
            if not isinstance(index_uid, str):
                raise EngineError(
                    ErrorCode.BAD_REQUEST,
                    f"Invalid value at `.queries[{qi}].indexUid`: expected a"
                    " string.",
                )
            app.auth.authenticate(req.auth_token, "search", index_uid)
        try:
            hits = _proxy_search(
                remote_name,
                remote,
                federation,
                entries,
                meta_sink=remote_primary_keys if want_meta else None,
            )
            for score, qi, hit in hits:
                fed = hit.get("_federation") or {}
                dedup_key = (
                    fed.get("remote") or remote_name,
                    fed.get("indexUid"),
                    str(hit["id"]) if "id" in hit
                    else json.dumps(hit, sort_keys=True, default=str),
                )
                all_hits.append((score, qi, dedup_key, hit))
        except EngineError:
            raise
        except Exception as err:
            # shard-replica failover: queries that carried alternates
            # re-route to the next replica (self runs locally); only
            # queries with no replica left surface the error
            dead_end = []
            for qi, query in entries:
                alts = list(query.get("_shard_alternates") or [])
                if not alts:
                    dead_end.append((qi, query))
                    continue
                nxt = alts.pop(0)
                q = dict(query)
                q["_shard_alternates"] = alts
                fo = dict(q.get("federationOptions") or {})
                if nxt and nxt != network.get("self"):
                    fo["remote"] = nxt
                    q["federationOptions"] = fo
                    pending_remote.append((nxt, [(qi, q)]))
                else:
                    fo.pop("remote", None)
                    q["federationOptions"] = fo
                    local_queries.append((qi, q))
            if dead_end:
                remote_errors[remote_name] = (
                    err.payload
                    if isinstance(err, ProxyError)
                    else {
                        "message": str(err),
                        "code": "remote_bad_response",
                        "type": "system",
                        "link": "https://docs.meilisearch.com/errors#remote_bad_response",
                    }
                )

    for qi, query in local_queries:
        index_uid = query.get("indexUid")
        fed_opts = query.get("federationOptions") or {}
        weight = float(fed_opts.get("weight", 1.0))
        app.auth.authenticate(req.auth_token, "search", index_uid)
        store = app.scheduler.index(index_uid)

        from ..search.executor import Search
        from ..search.filters import evaluate_filter
        from ..search.join import apply_foreign_filter

        query = dict(query)
        # foreign-filter errors carry their own query scope (qpos), or
        # none: they must not be wrapped a second time
        apply_foreign_filter(app.scheduler, store, query, qpos=qi)
        try:
            filter_docids = evaluate_filter(
                store, query.get("filter"), as_array=True
            )
            search = Search(
                store,
                query=query.get("q"),
                filter_docids=filter_docids,
                offset=0,
                limit=offset + limit,
                sort_criteria=[query["sort"]]
                if isinstance(query.get("sort"), str)
                else query.get("sort"),
                terms_matching_strategy=query.get("matchingStrategy", "last"),
                attributes_to_search_on=query.get("attributesToSearchOn"),
                compute_scores=True,
            )
            result = search.execute()
        except EngineError as err:
            _wrap_query_error(err, qi, index_uid)
        candidates_by_index.setdefault(index_uid, set()).update(
            int(d) for d in result.candidates
        )
        hits = build_hits(store, query, result.documents_ids, query.get("q"))
        for docid, hit in zip(result.documents_ids, hits):
            raw_score = result.scores_by_docid.get(docid, 1.0)
            score = raw_score * weight
            ext = store.internal_to_external.get(docid, str(docid))
            key = (index_uid, ext)
            if key in seen_pairs and seen_pairs[key] >= score:
                continue
            seen_pairs[key] = score
            hit = dict(hit)
            if query.get("showRankingScore"):
                hit["_rankingScore"] = raw_score
            hit["_federation"] = {
                "indexUid": index_uid,
                "queriesPosition": qi,
                "weightedRankingScore": round(score, 10),
            }
            # identity rides along explicitly: hits shaped by
            # attributesToRetrieve may not carry `id`, and re-deriving
            # identity from displayed fields is lossy (a json-dump prefix
            # collapsed DISTINCT documents as duplicates)
            all_hits.append(
                (score, qi, (None, index_uid, ext), hit, (index_uid, docid))
            )

    # stable merge: score desc, then query position asc
    all_hits.sort(key=lambda x: (-x[0], x[1]))
    # dedup (remote, index, docid) keeping best score
    deduped = []
    emitted = set()
    for entry in all_hits:
        score, qi, dedup_key, hit = entry[:4]
        meta = entry[4] if len(entry) > 4 else None
        if dedup_key in emitted:
            continue
        emitted.add(dedup_key)
        deduped.append((hit, meta))

    # federation.distinct: keep the first (best-ranked) hit per distinct
    # facet value, globally across indexes (reference federated/perform.rs
    # + multi/mod.rs federation_distinct_two_indexes). Facet DISTRIBUTION
    # then counts only kept documents while facet STATS keep the full
    # pre-distinct candidates (federation_distinct_two_indexes_nested
    # pins max over a dropped document's value).
    kept_by_index: Optional[dict[str, set]] = None
    if fed_distinct is not None:
        kept_by_index = {}
        seen_vals: set = set()
        kept = []
        for hit, meta in deduped:
            if meta is None:
                kept.append((hit, meta))  # remote: values resolved remotely
                continue
            uid, docid = meta
            d_store = app.scheduler.index(uid)
            fid = d_store.fields_ids_map.id(fed_distinct)
            vals: list = []
            if fid is not None:
                vals.extend(
                    ("n", v)
                    for v in d_store.docid_facet_numbers.get((fid, docid), ())
                )
                vals.extend(
                    ("s", v)
                    for v, _o in d_store.docid_facet_strings.get(
                        (fid, docid), ()
                    )
                )
            if any(v in seen_vals for v in vals):
                continue
            seen_vals.update(vals)
            kept.append((hit, meta))
            kept_by_index.setdefault(uid, set()).add(docid)
        deduped = kept

    deduped = [hit for hit, _meta in deduped]
    page = deduped[offset : offset + limit]
    # document-join hydration on the merged page (reference
    # FederatedHydrationFormatter): group hits by source index, hydrate
    # per that index's foreignKeys
    if app.scheduler.runtime_features.get("foreignKeys"):
        from ..search.join import hydrate_hits

        by_src: dict[str, list[dict]] = {}
        for hit in page:
            fed = hit.get("_federation") or {}
            uid = fed.get("indexUid")
            if isinstance(uid, str) and not fed.get("remote"):
                by_src.setdefault(uid, []).append(hit)
        for uid, hits_of in by_src.items():
            try:
                src_store = app.scheduler.index(uid)
            except EngineError:
                continue
            if src_store.settings.foreign_keys:
                hydrate_hits(app.scheduler, src_store, hits_of)
    from ..search.perform import _fmt_duration, _uuid7

    response: dict[str, Any] = {
        "hits": page,
        "processingTimeMs": int((time.perf_counter() - started) * 1000),
        "limit": limit,
        "offset": offset,
        "estimatedTotalHits": len(deduped),
        "requestUid": _uuid7(),
    }
    if show_perf:
        response["performanceDetails"] = {
            "federation": _fmt_duration(time.perf_counter() - started),
        }
    if include_metadata_header(req.headers):
        # one entry per query in request order (reference federated/
        # perform.rs build_query_metadata): queryUid fresh, primaryKey
        # from the local index when it ran here, from the proxied
        # response's metadata when it ran remotely; `remote` names the
        # executor (self for local queries when the network names us)
        self_name = network.get("self") if isinstance(network, dict) else None
        meta_list = []
        for query in queries:
            uid = query.get("indexUid")
            rname = (query.get("federationOptions") or {}).get("remote")
            if rname and rname != self_name:
                pk = remote_primary_keys.get((rname, uid))
                meta = search_metadata(
                    None, query.get("q"), remote=rname,
                    with_query=True, primary_key=pk,
                )
                meta["indexUid"] = uid
            else:
                try:
                    store = app.scheduler.index(uid)
                    pk = store.primary_key
                except EngineError:
                    pk = None
                meta = search_metadata(
                    None, query.get("q"), remote=self_name,
                    with_query=True, primary_key=pk,
                )
                meta["indexUid"] = uid
            meta_list.append(meta)
        response["metadata"] = meta_list
    if remote_errors:
        response["remoteErrors"] = remote_errors
    if federation.get("facetsByIndex"):
        from ..search.facets import facet_distribution

        merge = federation.get("mergeFacets")
        facets_by_index = {}
        merged_dist: dict[str, dict] = {}
        merged_stats: dict[str, dict] = {}
        for index_uid, facets in federation["facetsByIndex"].items():
            # facet values/counts disclose document content: require the
            # same `search` grant as a query on that index would
            app.auth.authenticate(req.auth_token, "search", index_uid)
            store = app.scheduler.index(index_uid)
            # count only documents matched by this federation's queries on
            # the index (reference: federated facet merge over per-query
            # candidates), not the whole index
            candidates = candidates_by_index.get(index_uid, set())
            if kept_by_index is not None:
                # distinct: distribution over KEPT docs, stats over the
                # full pre-distinct candidates (see merge loop above)
                dist, _ = facet_distribution(
                    store, facets, kept_by_index.get(index_uid, set())
                )
                _dist, stats = facet_distribution(store, facets, candidates)
            else:
                dist, stats = facet_distribution(store, facets, candidates)
            if merge is not None:
                for facet, values in dist.items():
                    bucket = merged_dist.setdefault(facet, {})
                    for value, count in values.items():
                        bucket[value] = bucket.get(value, 0) + count
                for facet, st in stats.items():
                    cur = merged_stats.get(facet)
                    if cur is None:
                        merged_stats[facet] = dict(st)
                    else:
                        cur["min"] = min(cur["min"], st["min"])
                        cur["max"] = max(cur["max"], st["max"])
            else:
                facets_by_index[index_uid] = {
                    "distribution": dist,
                    "stats": stats,
                }
        if merge is not None:
            # reference MergeFacets{maxValuesPerFacet}: one distribution
            # across indexes, values capped after the merge
            max_values = (merge or {}).get("maxValuesPerFacet")
            if max_values is not None:
                for facet, values in merged_dist.items():
                    top = sorted(values.items(), key=lambda kv: (kv[0],))
                    merged_dist[facet] = dict(top[: int(max_values)])
            response["facetDistribution"] = merged_dist
            response["facetStats"] = merged_stats
        else:
            response["facetsByIndex"] = facets_by_index
    return response


def _pick_replica(replicas: list, network: dict):
    """(primary, alternates) for a shard's replica set: self is free,
    otherwise the first replica outside its availability-backoff window;
    every other replica is an alternate for proxy-failure failover."""
    self_name = network.get("self")
    if self_name in replicas:
        others = [r for r in replicas if r != self_name]
        return self_name, others
    remotes = network.get("remotes") or {}
    available = []
    backed_off = []
    for r in replicas:
        url = (remotes.get(r) or {}).get("url", "")
        try:
            REMOTE_AVAILABILITY.check(r, url)
            available.append(r)
        except ConnectionError:
            backed_off.append(r)
    ordered = available + backed_off
    if not ordered:
        return None, []
    return ordered[0], ordered[1:]


class _RemoteAvailability:
    """Exponential unavailability windows per remote, 30s doubling to 5min
    (reference: meilisearch-types/src/network.rs:8-9,44-80). While a remote
    is inside its window, proxy calls fail fast instead of blocking the
    whole federated request on a dead host. Keyed by the remote's URL —
    the physical endpoint the failures came from — so reconfiguring a
    name to point elsewhere starts fresh."""

    BASE_S = 30.0
    MAX_S = 300.0

    def __init__(self):
        self._state: dict[str, tuple[float, float]] = {}  # url -> (until, backoff)

    def check(self, name: str, url: str) -> None:
        until, _ = self._state.get(url, (0.0, 0.0))
        if time.monotonic() < until:
            raise ConnectionError(
                f"remote `{name}` is marked unavailable (backoff window)"
            )

    def record_failure(self, url: str) -> None:
        _, backoff = self._state.get(url, (0.0, 0.0))
        backoff = min(backoff * 2 if backoff else self.BASE_S, self.MAX_S)
        self._state[url] = (time.monotonic() + backoff, backoff)

    def record_success(self, url: str) -> None:
        self._state.pop(url, None)


REMOTE_AVAILABILITY = _RemoteAvailability()


class ProxyError(Exception):
    """A classified remote-proxy failure (reference: federated/proxy.rs
    ProxySearchError): carries the exact {message, code, type, link}
    surface the reference pins in its `remoteErrors` snapshots, plus
    whether the reference's retry policy retries this class."""

    def __init__(self, message: str, code: str, err_type: str, retryable: bool):
        super().__init__(message)
        self.retryable = retryable
        self.payload = {
            "message": message,
            "code": code,
            "type": err_type,
            "link": f"https://docs.meilisearch.com/errors#{code}",
        }


def _from_remote(body) -> str:
    """serde `Value::to_string` renders compact JSON; non-JSON bodies
    pass through lossily (proxy.rs parse_bytes_as_error)."""
    if body is None:
        return ""
    try:
        compact = json.dumps(json.loads(body), separators=(",", ":"))
    except Exception:
        compact = (
            body.decode("utf-8", "replace") if isinstance(body, bytes) else str(body)
        )
    return f":\n  - response from remote: {compact}"


_HINT_CONFIG = (
    "\n  - hint: check that the remote instance has the correct index"
    " configuration for that request"
    "\n  - hint: check that the `network` experimental feature is enabled"
    " on the remote instance"
)
_HINT_VERSION = (
    "\n  - hint: check that the remote instance is a Meilisearch instance"
    " running the same version"
)


def _classify_http_error(status: int, body) -> ProxyError:
    if status in (401, 403):
        return ProxyError(
            "could not authenticate against the remote host"
            "\n  - hint: check that the remote instance was registered"
            " with a valid API key having the `search` action",
            "remote_invalid_api_key",
            "auth",
            retryable=False,
        )
    if 400 <= status < 500:
        return ProxyError(
            f"remote host responded with code {status}{_from_remote(body)}"
            f"{_HINT_CONFIG}",
            "remote_bad_request",
            "invalid_request",
            retryable=False,
        )
    return ProxyError(
        f"remote host responded with code {status}{_from_remote(body)}",
        "remote_remote_error",
        "system",
        retryable=True,
    )


def _proxy_search(
    remote_name: str, remote: dict, federation: dict, entries, meta_sink=None
):
    """POST /multi-search on a remote (reference: federated/proxy.rs:16).

    The reference's retry policy (proxy.rs try_json_proxy): transport
    errors, 5xx and unparseable bodies retry (try_count=3 with capped
    ~100 ms sleeps, then one final try); timeouts, auth failures and 4xx
    give up immediately. All attempts share one deadline
    (MEILI_EXPERIMENTAL_REMOTE_SEARCH_TIMEOUT_SECONDS, default 25 s).
    Exhausted retries put the remote in its availability-backoff window."""
    import urllib.request

    from ..utils.http_policy import check_url_policy, guarded_urlopen

    base_url = remote["url"].rstrip("/")
    try:
        REMOTE_AVAILABILITY.check(remote_name, base_url)
    except ConnectionError as err:
        raise ProxyError(
            str(err), "remote_could_not_send_request", "system", retryable=False
        )
    url = base_url + "/multi-search"
    check_url_policy(url)
    sub_queries = []
    for _qi, query in entries:
        q = dict(query)
        # strip the remote marker (the target treats it as local) and the
        # failover bookkeeping; keep the weight; request merge scores
        q.pop("_shard_alternates", None)
        opts = dict(q.get("federationOptions") or {})
        opts.pop("remote", None)
        q["federationOptions"] = opts
        q["showRankingScore"] = True
        sub_queries.append(q)
    body = json.dumps(
        {
            "federation": {
                "limit": int(federation.get("limit", 20) or 20)
                + int(federation.get("offset", 0) or 0),
                "offset": 0,
            },
            "queries": sub_queries,
        }
    ).encode("utf-8")
    headers = {
        "Content-Type": "application/json",
        "Meili-Proxy-Search": "true",
    }
    if meta_sink is not None:
        # the caller wants metadata: ask the remote for its primary keys
        # (reference proxy.rs:165 forwards INCLUDE_METADATA_HEADER)
        headers["Meili-Include-Metadata"] = "true"
    req = urllib.request.Request(url, data=body, headers=headers)
    if remote.get("searchApiKey"):
        req.add_header("Authorization", f"Bearer {remote['searchApiKey']}")
    import socket
    import urllib.error

    timeout_s = float(
        os.environ.get("MEILI_EXPERIMENTAL_REMOTE_SEARCH_TIMEOUT_SECONDS", "25")
    )
    deadline = time.monotonic() + timeout_s
    data = None
    last_err: Optional[ProxyError] = None
    _timeout_err = ProxyError(
        "remote host did not answer before the deadline",
        "remote_timeout",
        "system",
        retryable=False,
    )
    for attempt in range(4):  # try_count=3 retries + the final attempt
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            last_err = _timeout_err
            break
        try:
            with guarded_urlopen(req, timeout=remaining) as resp:
                raw = resp.read()
        except urllib.error.HTTPError as err:
            try:
                body = err.read()
            except Exception:
                body = None
            last_err = _classify_http_error(err.code, body)
        except (socket.timeout, TimeoutError):
            last_err = _timeout_err
        except urllib.error.URLError as err:
            if isinstance(getattr(err, "reason", None), (socket.timeout, TimeoutError)):
                last_err = _timeout_err
            else:
                last_err = ProxyError(
                    "error sending request",
                    "remote_could_not_send_request",
                    "system",
                    retryable=True,
                )
        except Exception:
            last_err = ProxyError(
                "error sending request",
                "remote_could_not_send_request",
                "system",
                retryable=True,
            )
        else:
            try:
                data = json.loads(raw.decode("utf-8"))
                if not isinstance(data, dict) or "hits" not in data:
                    raise ValueError
            except Exception:
                last_err = ProxyError(
                    "could not parse response from the remote host as a"
                    f" federated search response{_from_remote(raw)}"
                    f"{_HINT_VERSION}",
                    "remote_bad_response",
                    "system",
                    retryable=True,
                )
            else:
                REMOTE_AVAILABILITY.record_success(base_url)
                last_err = None
                break
        if not last_err.retryable:
            break
        if attempt < 3:
            # 10^attempt ns capped at 100 ms (proxy.rs Retry::into_duration)
            time.sleep(min(10.0 ** attempt * 1e-9, 0.1))
    if last_err is not None:
        if last_err.retryable:
            REMOTE_AVAILABILITY.record_failure(base_url)
        raise last_err
    if meta_sink is not None:
        for m in data.get("metadata") or []:
            if isinstance(m, dict) and m.get("indexUid") and m.get("primaryKey"):
                meta_sink[(remote_name, m["indexUid"])] = m["primaryKey"]
    out = []
    qi_base = entries[0][0]
    for hit in data.get("hits", []):
        fed = hit.get("_federation")
        if not isinstance(fed, dict) or "weightedRankingScore" not in fed:
            raise ProxyError(
                "remote hit does not contain"
                f" `._federation.weightedRankingScore`{_HINT_VERSION}",
                "remote_bad_response",
                "system",
                retryable=False,
            )
        score = float(fed.get("weightedRankingScore", 1.0))
        # remap the remote's query position to ours
        pos = fed.get("queriesPosition", 0)
        local_qi = entries[pos][0] if pos < len(entries) else qi_base
        fed["queriesPosition"] = local_qi
        fed["remote"] = remote_name
        hit["_federation"] = fed
        out.append((score, local_qi, hit))
    return out


import json  # noqa: E402
