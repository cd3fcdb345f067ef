"""Per-index routes: indexes CRUD, documents, search, facet-search, similar,
settings (+ per-setting sub-routes), stats, compact.

Reference: crates/meilisearch/src/routes/indexes/ (mod.rs, documents.rs,
search.rs, facet_search.rs, similar.rs, settings.rs).
"""

from __future__ import annotations

import csv
import io
import json
from typing import Any, Optional

from ..engine.tasks import TaskType
from ..search.filters import evaluate_filter
from ..search.perform import (
    include_metadata_header,
    perform_facet_search,
    perform_search,
    search_metadata,
)
from ..types.errors import EngineError, ErrorCode
from ..types.settings import Settings


def register_index_routes(app):
    from .app import Response

    # -- indexes CRUD ------------------------------------------------------

    def list_indexes(app_, req):
        limit = int(req.query.get("limit", 20))
        offset = int(req.query.get("offset", 0))
        stores = app_.scheduler.list_indexes()
        return {
            "results": [_index_view(s) for s in stores[offset : offset + limit]],
            "offset": offset,
            "limit": limit,
            "total": len(stores),
        }

    app.add("GET", "/indexes", "indexes.get", list_indexes)

    def create_index(app_, req):
        body = req.body or {}
        uid = body.get("uid")
        if not isinstance(uid, str):
            raise EngineError(
                ErrorCode.INVALID_INDEX_UID,
                f"Invalid value at `.uid`: expected a string, but got `{uid!r}`.",
            )
        task = app_.scheduler.register(
            TaskType.INDEX_CREATION,
            index_uid=uid,
            content={"primaryKey": body.get("primaryKey")},
        )
        return Response(202, json=task.summary())

    app.add("POST", "/indexes", "indexes.create", create_index)

    def get_index(app_, req):
        store = app_.scheduler.index(req.params["index_uid"])
        return _index_view(store)

    app.add("GET", "/indexes/{index_uid}", "indexes.get", get_index)

    def update_index(app_, req):
        uid = req.params["index_uid"]
        app_.scheduler.index(uid)  # 404 when missing
        task = app_.scheduler.register(
            TaskType.INDEX_UPDATE,
            index_uid=uid,
            content={"primaryKey": (req.body or {}).get("primaryKey")},
        )
        return Response(202, json=task.summary())

    app.add("PATCH", "/indexes/{index_uid}", "indexes.update", update_index)

    def delete_index(app_, req):
        uid = req.params["index_uid"]
        task = app_.scheduler.register(TaskType.INDEX_DELETION, index_uid=uid)
        return Response(202, json=task.summary())

    app.add("DELETE", "/indexes/{index_uid}", "indexes.delete", delete_index)

    def index_stats(app_, req):
        store = app_.scheduler.index(req.params["index_uid"])
        return store.stats()

    app.add("GET", "/indexes/{index_uid}/stats", "stats.get", index_stats)

    def compact(app_, req):
        uid = req.params["index_uid"]
        app_.scheduler.index(uid)
        task = app_.scheduler.register(TaskType.INDEX_COMPACTION, index_uid=uid)
        return Response(202, json=task.summary())

    app.add("POST", "/indexes/{index_uid}/compact", "indexes.update", compact)

    def fields(app_, req):
        store = app_.scheduler.index(req.params["index_uid"])
        return store.fields_ids_map.names()

    app.add("GET", "/indexes/{index_uid}/fields", "indexes.get", fields)

    # -- search ----------------------------------------------------------------

    def search_post(app_, req):
        from ..engine.batcher import microbatch_enabled
        from ..search.join import apply_foreign_filter, hydrate_response

        store = app_.scheduler.index(req.params["index_uid"])
        query = dict(req.body or {})
        _apply_tenant_rules(query, req.params.get("_auth"), store.uid)
        apply_foreign_filter(app_.scheduler, store, query)
        if microbatch_enabled() and query.get("personalize") is None:
            # ALL searches drain through the batcher: device-eligible
            # queries share grouped device executes, the rest run in the
            # executor's host section under ONE store-lock acquisition
            # per drain. Sending only device-eligible bodies here (and
            # the rest through the per-core permit, capacity 2 on this
            # host) let the direct path bottleneck the mixed workload.
            res = app_.search_batcher.submit(store, query)
        else:
            res = perform_search(
                store, query, personalization=app_.personalization
            )
        hydrate_response(app_.scheduler, store, res)
        if include_metadata_header(req.headers):
            res["metadata"] = search_metadata(
                store, query.get("q"), with_query=True
            )
        return res

    app.add("POST", "/indexes/{index_uid}/search", "search", search_post)

    def search_get(app_, req):
        from ..search.join import apply_foreign_filter, hydrate_response

        store = app_.scheduler.index(req.params["index_uid"])
        query = _query_params_to_search(req.query)
        _apply_tenant_rules(query, req.params.get("_auth"), store.uid)
        apply_foreign_filter(app_.scheduler, store, query)
        res = perform_search(
            store, query, personalization=app_.personalization
        )
        hydrate_response(app_.scheduler, store, res)
        if include_metadata_header(req.headers):
            res["metadata"] = search_metadata(
                store, query.get("q"), with_query=True
            )
        return res

    app.add("GET", "/indexes/{index_uid}/search", "search", search_get)

    def facet_search(app_, req):
        store = app_.scheduler.index(req.params["index_uid"])
        return perform_facet_search(store, req.body or {})

    app.add("POST", "/indexes/{index_uid}/facet-search", "search", facet_search)

    def similar_post(app_, req):
        from ..vector.similar import perform_similar

        store = app_.scheduler.index(req.params["index_uid"])
        return perform_similar(store, req.body or {})

    app.add("POST", "/indexes/{index_uid}/similar", "search", similar_post)

    def similar_get(app_, req):
        from ..vector.similar import perform_similar

        store = app_.scheduler.index(req.params["index_uid"])
        return perform_similar(store, dict(req.query))

    app.add("GET", "/indexes/{index_uid}/similar", "search", similar_get)

    # -- documents ----------------------------------------------------------------

    def parse_documents_payload(req) -> list[dict]:
        content_type = (
            req.headers.get("content-type")
            or req.headers.get("Content-Type")
            or "application/json"
        ).split(";")[0].strip()
        body = req.body
        if req.raw_body is not None and body is None:
            raw = req.raw_body.decode("utf-8")
        else:
            raw = None
        if content_type == "application/json":
            data = body if body is not None else json.loads(raw or "null")
            if isinstance(data, dict):
                return [data]
            if isinstance(data, list):
                if not all(isinstance(d, dict) for d in data):
                    raise EngineError(
                        ErrorCode.BAD_REQUEST,
                        "The `documents` payload must be an array of JSON objects.",
                    )
                return data
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                "The `documents` payload must be an array of JSON objects.",
            )
        if content_type == "application/x-ndjson":
            text = raw if raw is not None else body
            docs = []
            for line in (text or "").splitlines():
                line = line.strip()
                if line:
                    docs.append(json.loads(line))
            return docs
        if content_type == "text/csv":
            text = raw if raw is not None else body
            delimiter = req.query.get("csvDelimiter", ",")
            reader = csv.reader(io.StringIO(text or ""), delimiter=delimiter)
            rows = list(reader)
            if not rows:
                return []
            header = rows[0]
            fields = []
            for col in header:
                if ":" in col:
                    name, _, ty = col.rpartition(":")
                    fields.append((name, ty))
                else:
                    fields.append((col, "string"))
            docs = []
            for row in rows[1:]:
                doc = {}
                for (name, ty), value in zip(fields, row):
                    if ty == "number":
                        try:
                            doc[name] = float(value) if "." in value else int(value)
                        except ValueError:
                            doc[name] = value
                    elif ty == "boolean":
                        doc[name] = value.lower() == "true"
                    else:
                        doc[name] = value
                docs.append(doc)
            return docs
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            f"The Content-Type `{content_type}` is invalid. Accepted values for"
            " the Content-Type header are: `application/json`,"
            " `application/x-ndjson`, `text/csv`",
        )

    def add_documents(method):
        def handler(app_, req):
            uid = req.params["index_uid"]
            docs = parse_documents_payload(req)
            task = app_.scheduler.register(
                TaskType.DOCUMENT_ADDITION_OR_UPDATE,
                index_uid=uid,
                details={"receivedDocuments": len(docs), "indexedDocuments": None},
                content={
                    "documents": docs,
                    "method": method,
                    "primaryKey": req.query.get("primaryKey"),
                },
            )
            origin = req.headers.get("Meili-Task-Origin") or req.headers.get(
                "meili-task-origin"
            )
            if origin:
                # provenance of cross-instance document movement
                # (reference: meilisearch-types/src/tasks/network.rs Origin)
                task.network = {"origin": {"remote": origin}}
            return Response(202, json=task.summary())

        return handler

    app.add(
        "POST", "/indexes/{index_uid}/documents", "documents.add", add_documents("replace")
    )
    app.add(
        "PUT", "/indexes/{index_uid}/documents", "documents.add", add_documents("update")
    )

    def get_documents_list(app_, req, body: Optional[dict] = None):
        store = app_.scheduler.index(req.params["index_uid"])
        with store._lock:
            return _documents_list_locked(app_, req, store, body)

    def _documents_list_locked(app_, req, store, body):
        params = body if body is not None else req.query
        limit = int(params.get("limit", 20))
        offset = int(params.get("offset", 0))
        fields = params.get("fields")
        if isinstance(fields, str):
            fields = [f.strip() for f in fields.split(",")]
        retrieve_vectors = str(params.get("retrieveVectors", False)).lower() == "true"
        filter_expr = params.get("filter")
        ids = params.get("ids")
        if isinstance(ids, str):
            ids = [i.strip() for i in ids.split(",")]

        docids = sorted(store.documents.keys())
        sort = params.get("sort")
        if isinstance(sort, str):
            sort = [s.strip() for s in sort.split(",")]
        if sort:
            # sort documents by raw attribute values
            # (reference: milli documents/sort.rs recursive_sort)
            from ..search.executor import _parse_asc_desc

            for criterion in reversed(sort):
                member, asc = _parse_asc_desc(criterion)
                if not isinstance(member, str):
                    raise EngineError(
                        ErrorCode.INVALID_DOCUMENT_FIELDS,
                        "Cannot sort documents by `_geoPoint`.",
                    )

                def key(docid, member=member):
                    value = _lookup_raw(store.documents[docid], member)
                    if value is None:
                        return (3, 0)
                    if isinstance(value, bool):
                        return (2, str(value).lower())
                    if isinstance(value, (int, float)):
                        return (0, value)
                    if isinstance(value, str):
                        return (1, value.lower())
                    return (2, str(value))

                missing = [d for d in docids if key(d)[0] == 3]
                present = [d for d in docids if key(d)[0] != 3]
                present.sort(key=key, reverse=not asc)
                docids = present + missing
        if filter_expr is not None:
            allowed = evaluate_filter(
                store, filter_expr, code=ErrorCode.INVALID_DOCUMENT_FILTER
            )
            docids = [d for d in docids if d in allowed]
        if ids is not None:
            wanted = set()
            for ext in ids:
                internal = store.external_to_internal.get(str(ext))
                if internal is not None:
                    wanted.add(internal)
            docids = [d for d in docids if d in wanted]
        total = len(docids)
        page = docids[offset : offset + limit]
        results = []
        from ..search.perform import _select_fields

        for docid in page:
            doc = dict(store.documents[docid])
            if retrieve_vectors:
                vectors = {}
                for emb, per_doc in store.vectors.items():
                    if docid in per_doc:
                        vectors[emb] = {
                            "embeddings": per_doc[docid].tolist(),
                            "regenerate": store.vector_regenerate.get(emb, {}).get(docid, False),
                        }
                doc["_vectors"] = vectors
            else:
                doc.pop("_vectors", None)
            if fields and "*" not in fields:
                doc = _select_fields(doc, fields)
            results.append(doc)
        return {
            "results": results,
            "offset": offset,
            "limit": limit,
            "total": total,
        }

    app.add(
        "GET", "/indexes/{index_uid}/documents", "documents.get", get_documents_list
    )

    def fetch_documents(app_, req):
        return get_documents_list(app_, req, body=req.body or {})

    app.add(
        "POST",
        "/indexes/{index_uid}/documents/fetch",
        "documents.get",
        fetch_documents,
    )

    def get_document(app_, req):
        store = app_.scheduler.index(req.params["index_uid"])
        ext = req.params["document_id"]
        internal = store.external_to_internal.get(str(ext))
        if internal is None:
            raise EngineError(
                ErrorCode.DOCUMENT_NOT_FOUND,
                f"Document `{ext}` not found.",
            )
        doc = dict(store.documents[internal])
        fields = req.query.get("fields")
        retrieve_vectors = str(req.query.get("retrieveVectors", False)).lower() == "true"
        if retrieve_vectors:
            vectors = {}
            for emb, per_doc in store.vectors.items():
                if internal in per_doc:
                    vectors[emb] = {
                        "embeddings": per_doc[internal].tolist(),
                        "regenerate": store.vector_regenerate.get(emb, {}).get(
                            internal, False
                        ),
                    }
            doc["_vectors"] = vectors
        else:
            doc.pop("_vectors", None)
        if fields and fields != "*":
            from ..search.perform import _select_fields

            doc = _select_fields(doc, [f.strip() for f in fields.split(",")])
        return doc

    app.add(
        "GET",
        "/indexes/{index_uid}/documents/{document_id}",
        "documents.get",
        get_document,
    )

    def delete_document(app_, req):
        uid = req.params["index_uid"]
        task = app_.scheduler.register(
            TaskType.DOCUMENT_DELETION,
            index_uid=uid,
            content={"ids": [req.params["document_id"]]},
        )
        return Response(202, json=task.summary())

    app.add(
        "DELETE",
        "/indexes/{index_uid}/documents/{document_id}",
        "documents.delete",
        delete_document,
    )

    def delete_batch(app_, req):
        uid = req.params["index_uid"]
        ids = req.body or []
        if not isinstance(ids, list):
            raise EngineError(
                ErrorCode.BAD_REQUEST, "The body must be an array of document ids."
            )
        task = app_.scheduler.register(
            TaskType.DOCUMENT_DELETION, index_uid=uid, content={"ids": ids}
        )
        return Response(202, json=task.summary())

    app.add(
        "POST",
        "/indexes/{index_uid}/documents/delete-batch",
        "documents.delete",
        delete_batch,
    )

    def delete_by_filter(app_, req):
        uid = req.params["index_uid"]
        body = req.body or {}
        if "filter" not in body or body["filter"] is None:
            raise EngineError(
                ErrorCode.MISSING_DOCUMENT_FILTER,
                "Missing field `filter`",
            )
        # validate the filter eagerly (reference behavior: 400 on bad syntax)
        from ..search.filters import parse_filter

        try:
            parse_filter(body["filter"])
        except EngineError as e:
            raise EngineError(ErrorCode.INVALID_DOCUMENT_FILTER, e.message)
        task = app_.scheduler.register(
            TaskType.DOCUMENT_DELETION,
            index_uid=uid,
            content={"filter": body["filter"]},
        )
        return Response(202, json=task.summary())

    app.add(
        "POST",
        "/indexes/{index_uid}/documents/delete",
        "documents.delete",
        delete_by_filter,
    )

    def delete_all_documents(app_, req):
        uid = req.params["index_uid"]
        task = app_.scheduler.register(
            TaskType.DOCUMENT_DELETION, index_uid=uid, content={"clear_all": True}
        )
        return Response(202, json=task.summary())

    app.add(
        "DELETE", "/indexes/{index_uid}/documents", "documents.delete", delete_all_documents
    )

    def edit_documents(app_, req):
        uid = req.params["index_uid"]
        task = app_.scheduler.register(
            TaskType.DOCUMENT_EDITION, index_uid=uid, content=req.body or {}
        )
        return Response(202, json=task.summary())

    app.add(
        "POST", "/indexes/{index_uid}/documents/edit", "documents.add", edit_documents
    )

    # -- settings ----------------------------------------------------------------

    def get_settings(app_, req):
        from ..types.settings import embedders_api_view

        store = app_.scheduler.index(req.params["index_uid"])
        payload = store.settings.to_json()
        payload["embedders"] = embedders_api_view(payload["embedders"])
        # feature-gated settings only show when their feature is on
        # (reference settings.rs:739 check_foreign_keys_setting)
        if app_.scheduler.runtime_features.get("foreignKeys"):
            payload["foreignKeys"] = list(store.settings.foreign_keys)
        return payload

    app.add("GET", "/indexes/{index_uid}/settings", "settings.get", get_settings)

    def update_settings(app_, req):
        uid = req.params["index_uid"]
        body = req.body
        if not isinstance(body, dict):
            raise EngineError(
                ErrorCode.BAD_REQUEST, "Invalid settings payload: expected an object."
            )
        if body.get("foreignKeys") is not None and not (
            app_.scheduler.runtime_features.get("foreignKeys")
        ):
            from ..search.join import FOREIGN_KEYS_FEATURE_ERROR

            raise EngineError(
                ErrorCode.FEATURE_NOT_ENABLED,
                "setting `foreignKeys` in the index settings"
                f" {FOREIGN_KEYS_FEATURE_ERROR}",
            )
        _validate_settings(body)
        task = app_.scheduler.register(
            TaskType.SETTINGS_UPDATE, index_uid=uid, content={"settings": body}
        )
        return Response(202, json=task.summary())

    app.add("PATCH", "/indexes/{index_uid}/settings", "settings.update", update_settings)
    app.add("PUT", "/indexes/{index_uid}/settings", "settings.update", update_settings)

    def reset_settings(app_, req):
        uid = req.params["index_uid"]
        body = {k: None for k in _SETTING_ROUTES.values()}
        # a settings DELETE never creates the index: the task fails with
        # index_not_found instead (reference:
        # settings/get_settings.rs error_delete_settings_unexisting_index)
        task = app_.scheduler.register(
            TaskType.SETTINGS_UPDATE,
            index_uid=uid,
            content={"settings": body, "is_deletion": True},
        )
        return Response(202, json=task.summary())

    app.add("DELETE", "/indexes/{index_uid}/settings", "settings.update", reset_settings)

    for route_name, json_key in _SETTING_ROUTES.items():
        _register_sub_setting(app, route_name, json_key)


# per-setting sub-routes (reference: routes/indexes/settings.rs macro)
_SETTING_ROUTES = {
    "displayed-attributes": "displayedAttributes",
    "searchable-attributes": "searchableAttributes",
    "filterable-attributes": "filterableAttributes",
    "sortable-attributes": "sortableAttributes",
    "ranking-rules": "rankingRules",
    "stop-words": "stopWords",
    "non-separator-tokens": "nonSeparatorTokens",
    "separator-tokens": "separatorTokens",
    "dictionary": "dictionary",
    "synonyms": "synonyms",
    "distinct-attribute": "distinctAttribute",
    "proximity-precision": "proximityPrecision",
    "typo-tolerance": "typoTolerance",
    "faceting": "faceting",
    "pagination": "pagination",
    "embedders": "embedders",
    "search-cutoff-ms": "searchCutoffMs",
    "localized-attributes": "localizedAttributes",
    "facet-search": "facetSearch",
    "prefix-search": "prefixSearch",
    "chat": "chat",
    "foreign-keys": "foreignKeys",
}


def _register_sub_setting(app, route_name: str, json_key: str):
    from .app import Response

    path = "/indexes/{index_uid}/settings/" + route_name

    def get_one(app_, req):
        store = app_.scheduler.index(req.params["index_uid"])
        if json_key == "chat":
            from ..types.settings import DEFAULT_CHAT_SETTINGS

            return store.settings.chat or dict(DEFAULT_CHAT_SETTINGS)
        if json_key == "foreignKeys":
            return list(store.settings.foreign_keys)
        if json_key == "embedders":
            from ..types.settings import embedders_api_view

            return embedders_api_view(store.settings.embedders)
        return store.settings.to_json().get(json_key)

    def put_one(app_, req):
        uid = req.params["index_uid"]
        body = {json_key: req.body}
        if json_key == "foreignKeys" and req.body is not None and not (
            app_.scheduler.runtime_features.get("foreignKeys")
        ):
            from ..search.join import FOREIGN_KEYS_FEATURE_ERROR

            raise EngineError(
                ErrorCode.FEATURE_NOT_ENABLED,
                "setting `foreignKeys` in the index settings"
                f" {FOREIGN_KEYS_FEATURE_ERROR}",
            )
        _validate_settings(body, sub=True)
        task = app_.scheduler.register(
            TaskType.SETTINGS_UPDATE, index_uid=uid, content={"settings": body}
        )
        return Response(202, json=task.summary())

    def delete_one(app_, req):
        uid = req.params["index_uid"]
        task = app_.scheduler.register(
            TaskType.SETTINGS_UPDATE,
            index_uid=uid,
            content={"settings": {json_key: None}, "is_deletion": True},
        )
        return Response(202, json=task.summary())

    app.add("GET", path, "settings.get", get_one)
    app.add("PUT", path, "settings.update", put_one)
    # typo-tolerance/faceting/pagination historically accept PATCH
    app.add("PATCH", path, "settings.update", put_one)
    app.add("DELETE", path, "settings.update", delete_one)


def _json_type_name(v) -> str:
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


def _setting_type_error(loc: str, expected: str, value, code):
    """deserr-style type error; `loc` empty for a sub-route's top value
    (reference settings/errors.rs: 'Invalid value type: expected ...')."""
    at = f" at `{loc}`" if loc else ""
    raise EngineError(
        code,
        f"Invalid value type{at}: expected {expected}, but found"
        f" {_json_type_name(value)}: `{_fmt_json(value)}`",
    )


# per-setting deserr error codes (reference meilisearch-types/src/settings.rs
# deserr(error = DeserrJsonError<InvalidSettings...>) attributes)
_SETTING_CODES = {
    "displayedAttributes": ErrorCode.INVALID_SETTINGS_DISPLAYED_ATTRIBUTES,
    "searchableAttributes": ErrorCode.INVALID_SETTINGS_SEARCHABLE_ATTRIBUTES,
    "filterableAttributes": ErrorCode.INVALID_SETTINGS_FILTERABLE_ATTRIBUTES,
    "sortableAttributes": ErrorCode.INVALID_SETTINGS_SORTABLE_ATTRIBUTES,
    "rankingRules": ErrorCode.INVALID_SETTINGS_RANKING_RULES,
    "stopWords": ErrorCode.INVALID_SETTINGS_STOP_WORDS,
    "nonSeparatorTokens": ErrorCode.INVALID_SETTINGS_NON_SEPARATOR_TOKENS,
    "separatorTokens": ErrorCode.INVALID_SETTINGS_SEPARATOR_TOKENS,
    "dictionary": ErrorCode.INVALID_SETTINGS_DICTIONARY,
    "synonyms": ErrorCode.INVALID_SETTINGS_SYNONYMS,
    "distinctAttribute": ErrorCode.INVALID_SETTINGS_DISTINCT_ATTRIBUTE,
    "proximityPrecision": ErrorCode.INVALID_SETTINGS_PROXIMITY_PRECISION,
    "typoTolerance": ErrorCode.INVALID_SETTINGS_TYPO_TOLERANCE,
    "faceting": ErrorCode.INVALID_SETTINGS_FACETING,
    "pagination": ErrorCode.INVALID_SETTINGS_PAGINATION,
    "searchCutoffMs": ErrorCode.INVALID_SETTINGS_SEARCH_CUTOFF_MS,
    "localizedAttributes": ErrorCode.INVALID_SETTINGS_LOCALIZED_ATTRIBUTES,
    "facetSearch": ErrorCode.INVALID_SETTINGS_FACET_SEARCH,
    "prefixSearch": ErrorCode.INVALID_SETTINGS_PREFIX_SEARCH,
    "embedders": ErrorCode.INVALID_SETTINGS_EMBEDDERS,
}

_ARRAY_SETTINGS = {
    "displayedAttributes", "searchableAttributes", "filterableAttributes",
    "sortableAttributes", "rankingRules", "stopWords", "nonSeparatorTokens",
    "separatorTokens", "dictionary", "localizedAttributes", "foreignKeys",
}
_OBJECT_SETTINGS = {
    "synonyms", "typoTolerance", "faceting", "pagination", "embedders",
    "chat",
}

_TYPO_TOLERANCE_FIELDS = [
    "enabled", "minWordSizeForTypos", "disableOnWords",
    "disableOnAttributes", "disableOnNumbers",
]


def _check_positive_int(value, loc: str, code):
    if value is None:
        return
    if isinstance(value, bool) or not isinstance(value, int) or value < 0:
        _setting_type_error(loc, "a positive integer", value, code)


def _validate_settings(body: dict, sub: bool = False):
    """Route-layer settings validation (reference: the deserr derive on
    Settings, settings/errors.rs pins these messages). `sub=True` means the
    body came from a per-setting sub-route: the top-level value's location
    is the payload root, so messages drop the `at .key` prefix."""
    known = set(_SETTING_ROUTES.values()) | {"exactAttributes"}
    for key in body:
        if key not in known:
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                f"Unknown field `{key}`: expected one of"
                f" {', '.join(sorted(known))}",
            )

    def loc_of(key, *nested):
        parts = ([] if sub else [key]) + list(nested)
        return "".join(f".{p}" for p in parts)

    for key, value in body.items():
        if value is None:
            continue
        code = _SETTING_CODES.get(key, ErrorCode.BAD_REQUEST)
        if key in _ARRAY_SETTINGS and not isinstance(value, list):
            _setting_type_error(loc_of(key), "an array", value, code)
        if key in _OBJECT_SETTINGS and not isinstance(value, dict):
            _setting_type_error(loc_of(key), "an object", value, code)
        if key == "distinctAttribute" and not isinstance(value, str):
            _setting_type_error(loc_of(key), "a string", value, code)
        if key == "searchCutoffMs":
            _check_positive_int(value, loc_of(key), code)
        if key == "facetSearch" and not isinstance(value, bool):
            _setting_type_error(loc_of(key), "a boolean", value, code)

    rr = body.get("rankingRules")
    if rr is not None:
        for rule in rr:
            if isinstance(rule, str) and rule in (
                "words", "typo", "proximity", "attribute", "attributeRank",
                "wordPosition", "sort", "exactness",
            ):
                continue
            if (
                isinstance(rule, str)
                and ":" in rule
                and rule.rsplit(":", 1)[1] in ("asc", "desc")
            ):
                continue
            raise EngineError(
                ErrorCode.INVALID_SETTINGS_RANKING_RULES,
                f"Invalid value at `{loc_of('rankingRules')}"
                f"[{rr.index(rule)}]`: `{rule}`"
                " ranking rule is invalid. Valid ranking rules are words,"
                " typo, sort, proximity, attribute, exactness and custom"
                " ranking rules.",
            )
        # reference: settings.rs validate_attribute_ranking_rules — the
        # legacy `attribute` rule cannot be mixed with the split rules
        if "attribute" in rr and (
            "attributeRank" in rr or "wordPosition" in rr
        ):
            raise EngineError(
                ErrorCode.INVALID_SETTINGS_RANKING_RULES,
                "Mixed usage of the attribute, attributeRank, and"
                " wordPosition ranking rules. You must either use the"
                " attribute ranking rule alone or the attributeRank and"
                " wordPosition ranking rules.",
            )

    la = body.get("localizedAttributes")
    if isinstance(la, list):
        from ..types.locales import validate_locales

        for i, rule in enumerate(la):
            if not isinstance(rule, dict):
                raise EngineError(
                    ErrorCode.INVALID_SETTINGS_LOCALIZED_ATTRIBUTES,
                    f"Invalid value at `{loc_of('localizedAttributes')}[{i}]`:"
                    " expected an object with `attributePatterns` and"
                    " `locales` fields.",
                )
            validate_locales(
                rule.get("locales"),
                code=ErrorCode.INVALID_SETTINGS_LOCALIZED_ATTRIBUTES,
                field=f"{loc_of('localizedAttributes')}[{i}].locales",
            )

    tt = body.get("typoTolerance")
    if isinstance(tt, dict):
        code = _SETTING_CODES["typoTolerance"]
        for field in tt:
            if field not in _TYPO_TOLERANCE_FIELDS:
                raise EngineError(
                    code,
                    f"Unknown field `{field}`: expected one of "
                    + ", ".join(f"`{f}`" for f in _TYPO_TOLERANCE_FIELDS),
                )
        mws = tt.get("minWordSizeForTypos")
        if mws is not None and not isinstance(mws, dict):
            _setting_type_error(
                loc_of("typoTolerance", "minWordSizeForTypos"),
                "an object", mws, code,
            )
        if isinstance(mws, dict):
            for f in ("oneTypo", "twoTypos"):
                _check_positive_int(
                    mws.get(f),
                    loc_of("typoTolerance", "minWordSizeForTypos", f),
                    code,
                )
        for f in ("enabled", "disableOnNumbers"):
            if f in tt and tt[f] is not None and not isinstance(tt[f], bool):
                _setting_type_error(
                    loc_of("typoTolerance", f), "a boolean", tt[f], code
                )
        for f in ("disableOnWords", "disableOnAttributes"):
            if f in tt and tt[f] is not None and not isinstance(tt[f], list):
                _setting_type_error(
                    loc_of("typoTolerance", f), "an array", tt[f], code
                )

    fc = body.get("faceting")
    if isinstance(fc, dict):
        code = _SETTING_CODES["faceting"]
        _check_positive_int(
            fc.get("maxValuesPerFacet"),
            loc_of("faceting", "maxValuesPerFacet"), code,
        )
        sfv = fc.get("sortFacetValuesBy")
        if sfv is not None and not isinstance(sfv, dict):
            _setting_type_error(
                loc_of("faceting", "sortFacetValuesBy"), "an object", sfv,
                code,
            )

    pg = body.get("pagination")
    if isinstance(pg, dict):
        code = _SETTING_CODES["pagination"]
        mth = pg.get("maxTotalHits")
        _check_positive_int(mth, loc_of("pagination", "maxTotalHits"), code)
        if mth == 0 and not isinstance(mth, bool):
            raise EngineError(
                code,
                f"Invalid value at `{loc_of('pagination', 'maxTotalHits')}`:"
                " a non-zero integer value lower than"
                " `18446744073709551615` was expected, but found a zero",
            )

    pp = body.get("proximityPrecision")
    if pp is not None and pp not in ("byWord", "byAttribute"):
        raise EngineError(
            ErrorCode.INVALID_SETTINGS_PROXIMITY_PRECISION,
            f"Unknown value `{pp}` at `{loc_of('proximityPrecision')}`:"
            " expected one of `byWord`, `byAttribute`.",
        )
    ps = body.get("prefixSearch")
    if ps is not None and ps not in ("indexingTime", "disabled"):
        raise EngineError(
            ErrorCode.INVALID_SETTINGS_PREFIX_SEARCH,
            f"Unknown value `{ps}` at `{loc_of('prefixSearch')}`: expected"
            " one of `indexingTime`, `disabled`.",
        )


def _lookup_raw(doc, path: str):
    if path in doc:
        return doc[path]
    cur = doc
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return None
    return cur


def _index_view(store) -> dict:
    from datetime import datetime, timezone

    def iso(ts):
        return (
            datetime.fromtimestamp(ts, tz=timezone.utc)
            .isoformat(timespec="microseconds")
            .replace("+00:00", "Z")
        )

    return {
        "uid": store.uid,
        "createdAt": iso(store.created_at),
        "updatedAt": iso(store.updated_at),
        "primaryKey": store.primary_key,
    }


def _query_params_to_search(query: dict) -> dict:
    """GET /search query params -> SearchQuery dict
    (reference: SearchQueryGet, routes/indexes/search.rs)."""
    out: dict[str, Any] = {}
    passthrough_str = (
        "q", "highlightPreTag", "highlightPostTag", "cropMarker",
        "matchingStrategy", "distinct", "hybridEmbedder",
    )
    for k in passthrough_str:
        if k in query:
            out[k] = query[k]
    for k in ("offset", "limit", "page", "hitsPerPage", "cropLength"):
        if k in query:
            try:
                out[k] = int(query[k])
            except ValueError:
                out[k] = query[k]
    for k in ("showMatchesPosition", "showRankingScore", "showRankingScoreDetails", "retrieveVectors"):
        if k in query:
            out[k] = str(query[k]).lower() == "true"
    for k in (
        "attributesToRetrieve", "attributesToCrop", "attributesToHighlight",
        "attributesToSearchOn", "facets", "sort", "locales",
    ):
        if k in query:
            value = query[k]
            out[k] = value if isinstance(value, list) else [
                v.strip() for v in str(value).split(",")
            ]
    if "filter" in query:
        out["filter"] = query["filter"]
    if "rankingScoreThreshold" in query:
        try:
            out["rankingScoreThreshold"] = float(query["rankingScoreThreshold"])
        except ValueError:
            out["rankingScoreThreshold"] = query["rankingScoreThreshold"]
    if "hybridSemanticRatio" in query:
        out.setdefault("hybrid", {})["semanticRatio"] = float(
            query["hybridSemanticRatio"]
        )
        if "hybridEmbedder" in query:
            out["hybrid"]["embedder"] = query["hybridEmbedder"]
    return out


def _apply_tenant_rules(query: dict, auth_ctx, index_uid: str):
    """Merge tenant-token searchRules filters into the query
    (reference: meilisearch/src/search/mod.rs add_search_rules)."""
    if not auth_ctx:
        return
    rules = auth_ctx.get("searchRules")
    if not rules:
        return
    from ..engine.auth import _tenant_rules_for_index

    sub = _tenant_rules_for_index(rules, index_uid)
    if not sub:
        return
    rule_filter = sub.get("filter")
    if rule_filter:
        existing = query.get("filter")
        if existing:
            query["filter"] = [rule_filter, existing]
        else:
            query["filter"] = rule_filter
