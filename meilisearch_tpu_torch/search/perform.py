"""Public search façade: SearchQuery DTO -> API response JSON.

Reference: crates/meilisearch/src/search/mod.rs —
  SearchQuery (:89), prepare_search (:1622), perform_search (:1775),
  HitMaker (formatting, `_formatted`, `_matchesPosition`, `_rankingScore`),
  pagination modes (offset/limit vs page/hitsPerPage), facet distribution
  merging, and perform_facet_search.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

import torch

from ..index.store import IndexStore
from ..types.errors import EngineError, ErrorCode
from .executor import Search
from .facets import facet_distribution, search_facet_values
from .filters import evaluate_filter
from .matches import Matcher, MatchingWords
from .query_terms import DerivationContext, located_query_terms_from_tokens

DEFAULT_CROP_LENGTH = 10
DEFAULT_CROP_MARKER = "…"
DEFAULT_HIGHLIGHT_PRE_TAG = "<em>"
DEFAULT_HIGHLIGHT_POST_TAG = "</em>"
DEFAULT_SEARCH_LIMIT = 20


def _json_type_name(v) -> str:
    """deserr's type names for error messages."""
    if isinstance(v, bool):
        return "a boolean"
    if isinstance(v, str):
        return "a string"
    if isinstance(v, int):
        return "an integer"
    if isinstance(v, float):
        return "a number"
    if isinstance(v, list):
        return "an array"
    if isinstance(v, dict):
        return "an object"
    return "null"


def _fmt_json(v) -> str:
    import json as _json

    return _json.dumps(v, separators=(",", ":"), ensure_ascii=False)


def _type_error(field: str, expected: str, value, code) -> None:
    """deserr-style: 'Invalid value type at `.X`: expected an array, but
    found a string: `"doggo"`' (reference tests/search/errors.rs)."""
    raise EngineError(
        code,
        f"Invalid value type at `.{field}`: expected {expected}, but found"
        f" {_json_type_name(value)}: `{_fmt_json(value)}`",
    )


def _validate_int(query: dict, key: str, default, minimum=0, code=None):
    value = query.get(key, default)
    if value is None:
        value = default
    code = code or ErrorCode.BAD_REQUEST
    if not isinstance(value, int) or isinstance(value, bool):
        _type_error(key, "a positive integer", value, code)
    if value < minimum:
        raise EngineError(
            code,
            f"Invalid value at `.{key}`: expected a positive integer, but got"
            f" `{value!r}`.",
        )
    return value


def perform_search(
    store: IndexStore,
    query: dict,
    features: Optional[dict] = None,
    personalization=None,
    _collect_search: bool = False,
    _result_override=None,
) -> dict:
    """Execute one search request and build the API response.

    Reads hold the store lock for the whole request: the scheduler is the
    single writer and readers must not observe mid-batch table mutations
    (LMDB gives the reference MVCC reader snapshots; copy-on-write
    generation snapshots are the planned lock-free equivalent here).
    """
    started = time.perf_counter()
    with store._lock:
        return _perform_search_locked(
            store, query, features, personalization,
            _collect_search, _result_override, started,
        )


def _perform_search_locked(
    store: IndexStore,
    query: dict,
    features,
    personalization,
    _collect_search,
    _result_override,
    started,
) -> dict:
    unknown = set(query) - _KNOWN_SEARCH_PARAMS
    if unknown:
        field = sorted(unknown)[0]
        known = ", ".join(f"`{k}`" for k in sorted(_KNOWN_SEARCH_PARAMS))
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            f"Unknown field `{field}`: expected one of {known}",
        )

    q = query.get("q")
    if q is not None and not isinstance(q, str):
        _type_error("q", "a string", q, ErrorCode.INVALID_SEARCH_Q)
    # deserr-style boolean flags (reference tests/search/errors.rs)
    for flag, fcode in (
        ("showMatchesPosition", ErrorCode.INVALID_SEARCH_SHOW_MATCHES_POSITION),
        ("showRankingScore", ErrorCode.INVALID_SEARCH_SHOW_RANKING_SCORE),
        (
            "showRankingScoreDetails",
            ErrorCode.INVALID_SEARCH_SHOW_RANKING_SCORE_DETAILS,
        ),
        ("retrieveVectors", ErrorCode.INVALID_SEARCH_RETRIEVE_VECTORS),
        (
            "showPerformanceDetails",
            ErrorCode.INVALID_SEARCH_SHOW_PERFORMANCE_DETAILS,
        ),
    ):
        fv = query.get(flag)
        if fv is not None and not isinstance(fv, bool):
            _type_error(flag, "a boolean", fv, fcode)

    from ..types.locales import validate_locales

    validate_locales(query.get("locales"))

    offset = _validate_int(query, "offset", 0, code=ErrorCode.INVALID_SEARCH_OFFSET)
    limit = _validate_int(
        query, "limit", DEFAULT_SEARCH_LIMIT, code=ErrorCode.INVALID_SEARCH_LIMIT
    )
    page = query.get("page")
    hits_per_page = query.get("hitsPerPage")
    is_finite = page is not None or hits_per_page is not None
    if is_finite:
        page = _validate_int(query, "page", 1, code=ErrorCode.INVALID_SEARCH_PAGE)
        hits_per_page = _validate_int(
            query, "hitsPerPage", 20, code=ErrorCode.INVALID_SEARCH_HITS_PER_PAGE
        )
        offset = (page - 1) * hits_per_page if page > 0 else 0
        # page 0 is "before the first page": totals compute, hits don't
        # (reference pagination.rs page_zero_should_not_return_any_result)
        limit = hits_per_page if page > 0 else 0

    max_total_hits = store.settings.pagination.max_total_hits

    strategy = query.get("matchingStrategy", "last")
    if not isinstance(strategy, str):
        _type_error(
            "matchingStrategy",
            "a string",
            strategy,
            ErrorCode.INVALID_SEARCH_MATCHING_STRATEGY,
        )
    if strategy not in ("last", "all", "frequency"):
        raise EngineError(
            ErrorCode.INVALID_SEARCH_MATCHING_STRATEGY,
            f"Unknown value `{strategy}` at `.matchingStrategy`: expected one"
            " of `last`, `all`, `frequency`",
        )

    filter_docids = evaluate_filter(store, query.get("filter"), as_array=True)

    sort = query.get("sort")
    if sort is not None and not isinstance(sort, list):
        # the GET route converts comma lists before reaching here
        _type_error("sort", "an array", sort, ErrorCode.INVALID_SEARCH_SORT)

    facets_param = query.get("facets")
    if facets_param is not None and not isinstance(facets_param, list):
        _type_error(
            "facets", "an array", facets_param, ErrorCode.INVALID_SEARCH_FACETS
        )

    distinct = query.get("distinct")
    if distinct is not None:
        check_distinct_filterable(store, distinct)

    threshold = query.get("rankingScoreThreshold")
    if threshold is not None:
        if isinstance(threshold, bool) or not isinstance(
            threshold, (int, float)
        ):
            _type_error(
                "rankingScoreThreshold",
                "a number",
                threshold,
                ErrorCode.INVALID_SEARCH_RANKING_SCORE_THRESHOLD,
            )
        if not 0.0 <= float(threshold) <= 1.0:
            raise EngineError(
                ErrorCode.INVALID_SEARCH_RANKING_SCORE_THRESHOLD,
                "Invalid value at `.rankingScoreThreshold`: the value of"
                " `rankingScoreThreshold` is invalid, expected a float"
                " between `0.0` and `1.0`.",
            )

    # semantic / hybrid search kind resolution
    # (reference: routes/indexes/search.rs search_kind)
    vector = query.get("vector")
    hybrid = query.get("hybrid")
    if vector is not None and hybrid is None:
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            "Invalid request: missing `hybrid` parameter when `vector` is"
            " present.",
        )
    if query.get("media") is not None and hybrid is None:
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            "Invalid request: missing `hybrid` parameter when `media` is"
            " present.",
        )

    semantic_hit_count = None
    scores_needed = bool(
        query.get("showRankingScore") or query.get("showRankingScoreDetails")
    )

    search = Search(
        store,
        query=q,
        filter_docids=filter_docids,
        offset=offset,
        limit=min(limit, max_total_hits),
        sort_criteria=sort,
        distinct=distinct,
        terms_matching_strategy=strategy,
        attributes_to_search_on=query.get("attributesToSearchOn"),
        exhaustive_number_hits=is_finite,
        max_total_hits=max_total_hits,
        locales=query.get("locales"),
        compute_scores=scores_needed
        or hybrid is not None
        or threshold is not None,
        compute_score_details=bool(query.get("showRankingScoreDetails")),
        ranking_score_threshold=(
            float(threshold) if threshold is not None else None
        ),
        facets=query.get("facets") or None,
    )

    if _collect_search:
        return search

    t_exec = time.perf_counter()
    if _result_override is not None:
        result = _result_override
    elif hybrid is not None:
        from .hybrid import execute_hybrid

        result, semantic_hit_count = execute_hybrid(
            store, search, query, offset, limit
        )
    else:
        result = search.execute()

    t_format = time.perf_counter()
    hits = build_hits(
        store, query, result.documents_ids, q, located_terms=result.query_terms
    )

    # sorting by `_geoPoint(lat, lng)` attaches `_geoDistance` (rounded
    # meters) to every hit that has `_geo` (reference geo_sort.rs +
    # tests/search/geo.rs bug_4640 snapshot)
    geo_point = None
    for s in sort or ():
        if isinstance(s, str) and s.strip().startswith("_geoPoint("):
            from .executor import _parse_asc_desc

            member, _asc = _parse_asc_desc(s)
            if isinstance(member, tuple):
                geo_point = member
                break
    if geo_point is not None:
        from .executor import _haversine_m as _hav

        for hit, docid in zip(hits, result.documents_ids):
            pt = store.geo_points.get(int(docid))
            if pt is not None:
                hit["_geoDistance"] = int(
                    round(_hav(geo_point[0], geo_point[1], pt[0], pt[1]))
                )

    total = (
        result.total_hits
        if result.total_hits is not None
        else min(len(result.candidates), max_total_hits)
    )
    t_done = time.perf_counter()
    response: dict[str, Any] = {
        "hits": hits,
        "query": q or "",
        "processingTimeMs": int((t_done - started) * 1000),
        # UUID v7 identifying this search request (reference
        # search/mod.rs:1403 request_uid, always present)
        "requestUid": _uuid7(),
    }
    if query.get("showPerformanceDetails"):
        # step-name -> duration map (reference performance_details from
        # progress.accumulated_durations(); Rust's `{:.2?}` format)
        response["performanceDetails"] = {
            "prepare": _fmt_duration(t_exec - started),
            "execute": _fmt_duration(t_format - t_exec),
            "formatting": _fmt_duration(t_done - t_format),
        }
    if is_finite:
        response["hitsPerPage"] = hits_per_page
        response["page"] = page
        response["totalPages"] = (
            (total + hits_per_page - 1) // hits_per_page if hits_per_page else 0
        )
        response["totalHits"] = total
    else:
        response["offset"] = offset
        response["limit"] = limit
        response["estimatedTotalHits"] = total

    facets = query.get("facets")
    if facets:
        # the device batch returns the FULL candidate set as a bitmap
        # (result.candidates holds only the ranked top-k there)
        facet_candidates = (
            result.candidates_mask
            if result.candidates_mask is not None
            else result.candidates
        )
        t_facets = time.perf_counter()
        dist, stats = facet_distribution(store, facets, facet_candidates)
        response["facetDistribution"] = dist
        response["facetStats"] = stats
        if "performanceDetails" in response:
            response["performanceDetails"]["facets"] = _fmt_duration(
                time.perf_counter() - t_facets
            )

    if semantic_hit_count is not None:
        response["semanticHitCount"] = semantic_hit_count

    if scores_needed:
        for hit, docid in zip(hits, result.documents_ids):
            if query.get("showRankingScore"):
                hit["_rankingScore"] = result.scores_by_docid.get(docid, 1.0)
            if query.get("showRankingScoreDetails"):
                hit["_rankingScoreDetails"] = result.details_by_docid.get(
                    docid, {}
                )

    personalize = query.get("personalize")
    if personalize is not None:
        # reference: routes/indexes/search.rs:761 — rerank the built hit page
        # (scores already attached, so they travel with their hits)
        from ..vector.personalization import PersonalizationService

        service = personalization or PersonalizationService(None)
        response["hits"] = service.rerank_hits(hits, personalize, q)

    if result.degraded:
        response["degraded"] = True
    return response


# every accepted POST /search field (reference SearchQuery, deserr
# deny-unknown-fields: an unknown field is a 400)
_KNOWN_SEARCH_PARAMS = {
    "q", "vector", "media", "hybrid", "offset", "limit", "page",
    "hitsPerPage", "attributesToRetrieve", "retrieveVectors",
    "attributesToCrop", "cropLength", "attributesToHighlight",
    "showMatchesPosition", "showRankingScore", "showRankingScoreDetails",
    "filter", "sort", "distinct", "facets", "highlightPreTag",
    "highlightPostTag", "cropMarker", "matchingStrategy",
    "attributesToSearchOn", "rankingScoreThreshold", "locales",
    "personalize", "federationOptions", "showPerformanceDetails",
}


def include_metadata_header(headers: dict) -> bool:
    """Parse `Meili-Include-Metadata` (reference routes/mod.rs
    parse_include_metadata_header): true for "true"/"1" case-insensitive,
    false otherwise."""
    for k, v in (headers or {}).items():
        if k.lower() == "meili-include-metadata":
            return str(v).lower() in ("true", "1")
    return False


def search_metadata(
    store, q=None, remote=None, with_query=False, primary_key=...
) -> dict:
    """One `metadata` entry (reference search/mod.rs SearchMetadata):
    query (federated non-placeholder queries only), queryUid (UUIDv7),
    indexUid, primaryKey + remote when known (None fields are skipped,
    serde skip_serializing_if parity)."""
    md = {}
    if with_query and q:
        md["query"] = q
    md["queryUid"] = _uuid7()
    md["indexUid"] = store.uid if store is not None else None
    if primary_key is ...:
        primary_key = store.primary_key if store is not None else None
    if primary_key is not None:
        md["primaryKey"] = primary_key
    if remote is not None:
        md["remote"] = remote
    return md


def _uuid7() -> str:
    """RFC 9562 UUID v7 (reference Uuid::now_v7 per search request):
    48-bit unix-ms timestamp | ver 7 | 12 rand | var 0b10 | 62 rand."""
    import uuid as _uuid

    ms = time.time_ns() // 1_000_000
    ra = int.from_bytes(os.urandom(2), "big") & 0x0FFF
    rb = int.from_bytes(os.urandom(8), "big") & ((1 << 62) - 1)
    val = (ms << 80) | (0x7 << 76) | (ra << 64) | (0x2 << 62) | rb
    return str(_uuid.UUID(int=val))


def _fmt_duration(seconds: float) -> str:
    """Rust `{:.2?}` Duration formatting: the largest fitting unit with
    two decimals (performance-details strings match the reference's)."""
    ns = seconds * 1e9
    if ns < 1_000:
        return f"{ns:.2f}ns"
    if ns < 1_000_000:
        return f"{ns / 1_000:.2f}µs"
    if ns < 1_000_000_000:
        return f"{ns / 1_000_000:.2f}ms"
    return f"{seconds:.2f}s"

_DEVICE_BATCH_SAFE_KEYS = {
    "q", "filter", "offset", "limit", "page", "hitsPerPage",
    "attributesToRetrieve", "attributesToCrop", "cropLength",
    "attributesToHighlight", "highlightPreTag", "highlightPostTag",
    "cropMarker", "showMatchesPosition", "matchingStrategy", "locales",
    # round 3: sort / facets / distinct ride the device path
    # (search/device_batch.py), with per-query host fallback when the
    # device cannot prove the page exact
    "sort", "facets", "distinct",
    # round 5: _rankingScore decodes from the packed DP key bit fields
    # device-side (device_batch._device_scores); details stay host-only
    # (build_descriptor gates them to the host scorer)
    "showRankingScore",
}


def perform_search_many(
    store: IndexStore,
    queries: list[dict],
    features: Optional[dict] = None,
    *,
    device: torch.device,
    force_device: bool = False,
    strict: bool = False,
) -> list[dict]:
    """Execute a batch of search requests against one index: queries that
    map to the device chain kernel run together as grouped device executes
    on `device`; the rest take the host path. Responses are order-aligned
    with `queries`. `force_device` is the batcher's adaptive-mode signal:
    route eligible queries to the device regardless of batch size
    (engine/batcher.py probe controller). `strict` sends every eligible
    query to the device."""
    import functools

    from .device_batch import search_many

    with store._lock:
        return _perform_search_many_locked(
            store,
            queries,
            features,
            functools.partial(
                search_many, device=device, force_device=force_device, strict=strict
            ),
        )


def _perform_search_many_locked(store, queries, features, search_many):
    prepared: list = []
    for body in queries:
        search = None
        if set(body) <= _DEVICE_BATCH_SAFE_KEYS and (
            body.get("matchingStrategy") in (None, "last", "all")
        ):
            try:
                search = perform_search(
                    store, body, features, _collect_search=True
                )
            except EngineError:
                search = None  # re-raised by the final perform_search pass
        prepared.append(search)

    batched = [s for s in prepared if s is not None]
    results = iter(search_many(store, batched)) if batched else iter(())

    out = []
    for body, search in zip(queries, prepared):
        if search is None:
            out.append(perform_search(store, body, features))
        else:
            out.append(
                perform_search(
                    store, body, features, _result_override=next(results)
                )
            )
    return out


def perform_facet_search(store: IndexStore, body: dict) -> dict:
    """POST /indexes/{uid}/facet-search (reference: routes/indexes/facet_search.rs)."""
    started = time.perf_counter()
    with store._lock:
        return _perform_facet_search_locked(store, body, started)


def _perform_facet_search_locked(store: IndexStore, body: dict, started) -> dict:
    facet_name = body.get("facetName")
    if not isinstance(facet_name, str):
        raise EngineError(
            ErrorCode.INVALID_FACET_SEARCH_FACET_NAME,
            "Invalid value at `.facetName`: expected a string.",
        )
    if not store.settings.facet_search:
        raise EngineError(
            ErrorCode.FACET_SEARCH_DISABLED,
            "The facet search is disabled on this index",
        )
    facet_query = body.get("facetQuery")

    # restrict candidates with the sub-search if q/filter present
    candidates = None
    if any(
        body.get(k) is not None
        for k in ("q", "filter", "vector", "attributesToSearchOn")
    ):
        filter_docids = evaluate_filter(store, body.get("filter"), as_array=True)
        sub = Search(
            store,
            query=body.get("q"),
            filter_docids=filter_docids,
            terms_matching_strategy=body.get("matchingStrategy", "last"),
            attributes_to_search_on=body.get("attributesToSearchOn"),
            limit=10**9,
        )
        candidates = sub.execute().candidates

    from ..types.locales import validate_locales

    validate_locales(body.get("locales"))
    hits = search_facet_values(
        store,
        facet_name,
        facet_query,
        candidates,
        max_values=store.settings.faceting.max_values_per_facet,
        locales=body.get("locales"),
    )
    return {
        "facetHits": hits,
        "facetQuery": facet_query,
        "processingTimeMs": int((time.perf_counter() - started) * 1000),
    }


# ---------------------------------------------------------------------------
# hit building


def check_distinct_filterable(store: IndexStore, distinct: str) -> None:
    """Reference milli error.rs:232 InvalidDistinctAttribute: the message
    appends the available filterable patterns (or the no-filterables
    sentence). Shared with federated `federation.distinct` validation
    (multi/mod.rs federation_distinct_not_filterable)."""
    settings = store.settings
    if settings.filter_features_for(distinct):
        return
    attrs = sorted(settings.filterable_attribute_names())
    if attrs:
        tail = (
            "Available filterable attributes patterns are:"
            f" `{', '.join(attrs)}`."
        )
    else:
        tail = "This index does not have configured filterable attributes."
    raise EngineError(
        ErrorCode.INVALID_SEARCH_DISTINCT,
        f"Attribute `{distinct}` is not filterable and thus, cannot be"
        f" used as distinct attribute. {tail}",
    )


def build_hits(
    store: IndexStore,
    query: dict,
    docids: list[int],
    q: Optional[str],
    located_terms=None,
) -> list[dict]:
    retrieve = query.get("attributesToRetrieve") or ["*"]
    retrieve_vectors = bool(query.get("retrieveVectors", False))
    to_highlight = query.get("attributesToHighlight") or []
    to_crop_raw = query.get("attributesToCrop") or []
    crop_length = query.get("cropLength", DEFAULT_CROP_LENGTH)
    crop_marker = query.get("cropMarker", DEFAULT_CROP_MARKER)
    pre_tag = query.get("highlightPreTag", DEFAULT_HIGHLIGHT_PRE_TAG)
    post_tag = query.get("highlightPostTag", DEFAULT_HIGHLIGHT_POST_TAG)
    show_matches = bool(query.get("showMatchesPosition", False))
    show_score = bool(query.get("showRankingScore", False))
    show_details = bool(query.get("showRankingScoreDetails", False))

    # attributesToCrop entries may carry `field:length`
    to_crop: dict[str, int] = {}
    for entry in to_crop_raw:
        if ":" in entry:
            field, _, length = entry.rpartition(":")
            try:
                to_crop[field] = int(length)
            except ValueError:
                to_crop[entry] = crop_length
        else:
            to_crop[entry] = crop_length

    displayed = store.settings.displayed_attributes
    needs_format = bool(to_highlight or to_crop or show_matches)

    matching_words = None
    tokenizer = store.make_tokenizer(query.get("locales"))
    if q:
        if located_terms is None:
            ctx = DerivationContext(store, store.settings)
            extracted = located_query_terms_from_tokens(ctx, tokenizer, q)
            located_terms = extracted.query_terms
            for i, t in enumerate(located_terms):
                t.start_term_id = t.end_term_id = i
        matching_words = MatchingWords(located_terms)

    hits = []
    for docid in docids:
        doc = store.documents.get(docid)
        if doc is None:
            continue
        displayed_doc = _select_fields(doc, displayed)
        base = _select_fields(displayed_doc, retrieve)
        base = dict(base)
        if not retrieve_vectors:
            base.pop("_vectors", None)
        else:
            vectors = {}
            for emb, per_doc in store.vectors.items():
                if docid in per_doc:
                    vectors[emb] = {
                        "embeddings": per_doc[docid].tolist(),
                        "regenerate": store.vector_regenerate.get(emb, {}).get(
                            docid, False
                        ),
                    }
            base["_vectors"] = vectors

        # _formatted appears only when a requested highlight/crop field
        # is actually displayed (reference formatted.rs
        # displayedattr_2_smol: highlighting undisplayed fields yields no
        # _formatted at all)
        fmt_requested = list(to_highlight) + list(to_crop.keys())
        can_format = any(
            f == "*" or _lookup(displayed_doc, f) is not None
            for f in fmt_requested
        ) and bool(displayed_doc)
        if fmt_requested and can_format:
            formatted = {}
            matches_position = {}
            # _formatted contains retrieve ∪ highlight ∪ crop fields
            format_fields = set()
            for spec in (retrieve, to_highlight, list(to_crop.keys())):
                for f in spec:
                    if f == "*":
                        format_fields.update(_flat_keys(displayed_doc))
                    else:
                        format_fields.add(f)
            hl_all = "*" in to_highlight
            crop_all = "*" in to_crop
            for field in sorted(format_fields):
                value = _lookup(displayed_doc, field)
                if value is None and field not in displayed_doc:
                    continue
                do_hl = hl_all or any(field == h or field.startswith(h + ".") for h in to_highlight)
                do_crop = crop_all or field in to_crop
                formatted[field] = _format_value(
                    value,
                    matching_words,
                    tokenizer,
                    highlight=do_hl,
                    crop=(to_crop.get(field, crop_length) if do_crop else None),
                    pre_tag=pre_tag,
                    post_tag=post_tag,
                    crop_marker=crop_marker,
                )
                if show_matches and matching_words is not None and isinstance(value, str):
                    matcher = Matcher(matching_words, tokenizer, value)
                    positions = matcher.matches_position()
                    if positions:
                        matches_position[field] = positions
            base["_formatted"] = _unflatten(formatted)
            if show_matches:
                base["_matchesPosition"] = matches_position
        elif show_matches:
            matches_position = {}
            if matching_words is not None:
                for field, value in doc.items():
                    if isinstance(value, str):
                        matcher = Matcher(matching_words, tokenizer, value)
                        positions = matcher.matches_position()
                        if positions:
                            matches_position[field] = positions
            base["_matchesPosition"] = matches_position

        if show_score:
            base["_rankingScore"] = 1.0  # refined ranking scores: see scores.py
        if show_details:
            base["_rankingScoreDetails"] = {}
        hits.append(base)
    return hits


def _format_value(
    value,
    matching_words,
    tokenizer,
    highlight,
    crop,
    pre_tag,
    post_tag,
    crop_marker,
):
    if isinstance(value, str):
        if matching_words is None:
            if crop:
                # crop the beginning without matches
                m = Matcher(MatchingWords([]), tokenizer, value)
                return m.format(False, crop, pre_tag, post_tag, crop_marker)
            return value
        m = Matcher(matching_words, tokenizer, value)
        return m.format(highlight, crop, pre_tag, post_tag, crop_marker)
    if isinstance(value, list):
        return [
            _format_value(
                v, matching_words, tokenizer, highlight, crop, pre_tag, post_tag, crop_marker
            )
            for v in value
        ]
    if isinstance(value, dict):
        return {
            k: _format_value(
                v, matching_words, tokenizer, highlight, crop, pre_tag, post_tag, crop_marker
            )
            for k, v in value.items()
        }
    # numbers/bools are stringified in _formatted (reference HitMaker)
    if value is None:
        return None
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return str(value)
    return value


def _select_fields(doc: dict, patterns: list[str]) -> dict:
    """permissive-json-pointer field selection: dot paths and `*` wildcards
    (reference: crates/permissive-json-pointer/src/lib.rs)."""
    if "*" in patterns:
        return doc
    out: dict = {}
    for pattern in patterns:
        _select_into(doc, pattern.split("."), out)
    return out


def _select_into(doc, parts, out):
    key = parts[0]
    if key == "*":
        keys = list(doc.keys()) if isinstance(doc, dict) else []
    else:
        keys = [key] if isinstance(doc, dict) and key in doc else []
        if not keys and isinstance(doc, dict):
            # maybe the full dotted path is a literal key
            dotted = ".".join(parts)
            if dotted in doc:
                out[dotted] = doc[dotted]
                return
    for k in keys:
        value = doc[k]
        if len(parts) == 1:
            out[k] = value
        elif isinstance(value, dict):
            sub = out.setdefault(k, {})
            if isinstance(sub, dict):
                _select_into(value, parts[1:], sub)
        elif isinstance(value, list):
            sub_list = []
            for item in value:
                if isinstance(item, dict):
                    sub_item: dict = {}
                    _select_into(item, parts[1:], sub_item)
                    if sub_item:
                        sub_list.append(sub_item)
            if sub_list:
                out[k] = sub_list


def _lookup(doc, path: str):
    if path in doc:
        return doc[path]
    cur = doc
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    return cur


def _flat_keys(doc: dict, prefix: str = "") -> list[str]:
    out = []
    for k, v in doc.items():
        path = f"{prefix}.{k}" if prefix else k
        out.append(path)
    return out


def _unflatten(formatted: dict) -> dict:
    """Rebuild nested structure for dotted _formatted keys."""
    out: dict = {}
    for key, value in formatted.items():
        if "." not in key:
            out[key] = value
            continue
        parts = key.split(".")
        cur = out
        ok = True
        for p in parts[:-1]:
            nxt = cur.get(p)
            if nxt is None:
                nxt = cur[p] = {}
            elif not isinstance(nxt, dict):
                ok = False
                break
            cur = nxt
        if ok:
            cur[parts[-1]] = value
        else:
            out[key] = value
    return out
