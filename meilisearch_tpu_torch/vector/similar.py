"""Similar-documents search.

Reference: milli/src/search/similar.rs + routes/indexes/similar.rs —
ANN nns_by_item on a stored document, filterable, with optional
rankingScoreThreshold and retrieveVectors.
"""

from __future__ import annotations

import time

from ..index.arrays import docids_array, intersect
from ..search.filters import evaluate_filter
from ..search.perform import build_hits
from ..types.errors import EngineError, ErrorCode
from .embedders import get_embedder
from .store import VectorSearcher


def perform_similar(store, body: dict) -> dict:
    started = time.perf_counter()
    with store._lock:  # reads never observe mid-batch writes
        return _perform_similar_locked(store, body, started)


def _perform_similar_locked(store, body: dict, started) -> dict:
    doc_id = body.get("id")
    if doc_id is None:
        raise EngineError(
            ErrorCode.INVALID_SIMILAR_ID, "Missing field `id`."
        )
    external = str(doc_id)
    internal = store.external_to_internal.get(external)
    if internal is None:
        raise EngineError(
            ErrorCode.NOT_FOUND,
            f"Document `{external}` not found.",
        )
    embedder_name = body.get("embedder")
    if embedder_name is None:
        raise EngineError(
            ErrorCode.INVALID_EMBEDDER, "Missing field `embedder`."
        )
    # the embedder must exist (validates config) even for userProvided
    get_embedder(store, embedder_name)

    offset = int(body.get("offset", 0) or 0)
    limit = int(body.get("limit", 20) or 20)
    threshold = body.get("rankingScoreThreshold")

    searcher = VectorSearcher(store, embedder_name)
    per_doc = store.vectors.get(embedder_name, {})
    if internal not in per_doc:
        results = []
    else:
        universe = docids_array(store)
        filter_docids = evaluate_filter(store, body.get("filter"), as_array=True)
        if filter_docids is not None:
            universe = intersect(universe, filter_docids)
        universe = universe[universe != internal]
        query_vec = per_doc[internal][0]
        results = searcher.search(query_vec, offset + limit, universe)

    results = results[offset : offset + limit]
    if threshold is not None:
        results = [(d, s) for d, s in results if s >= float(threshold)]

    hit_query = {
        "attributesToRetrieve": body.get("attributesToRetrieve"),
        "retrieveVectors": body.get("retrieveVectors", False),
        "showRankingScore": body.get("showRankingScore", False),
    }
    docids = [d for d, _ in results]
    hits = build_hits(store, hit_query, docids, None)
    if body.get("showRankingScore"):
        for hit, (_d, s) in zip(hits, results):
            hit["_rankingScore"] = s

    return {
        "hits": hits,
        "id": external,
        "processingTimeMs": int((time.perf_counter() - started) * 1000),
        "limit": limit,
        "offset": offset,
        "estimatedTotalHits": len(docids),
    }
