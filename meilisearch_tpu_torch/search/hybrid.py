"""Hybrid (keyword + semantic) search.

Reference: milli/src/search/hybrid.rs — run both searches, weight each side's
global score by its semantic ratio, merge the two ranked lists keeping the
best-scored occurrence of each document, re-apply distinct, and report
`semanticHitCount`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..index.arrays import (
    docids_array,
    filtered_universe,
    intersect,
    to_array,
    union_many,
)
from ..types.errors import EngineError, ErrorCode
from .executor import Search, SearchResult


def resolve_query_vector(store, query: dict) -> Optional[np.ndarray]:
    vector = query.get("vector")
    if vector is not None:
        return np.asarray(vector, dtype=np.float32)
    from ..vector.embedders import get_embedder

    hybrid = query.get("hybrid") or {}
    media = query.get("media")
    q = query.get("q")
    if media is not None:
        # multimodal search: the first searchFragment (name order) that
        # fully renders against {media, q} produces the query embedding
        # (reference: search/mod.rs:306-312 `media` + search_fragments)
        embedder = get_embedder(store, hybrid.get("embedder"))
        fragments = embedder.conf.get("searchFragments") or {}
        if not fragments:
            raise EngineError(
                ErrorCode.INVALID_EMBEDDER,
                f"Embedder `{embedder.name}` does not define"
                " `searchFragments`, so the `media` parameter cannot be"
                " used with it.",
            )
        from ..vector.templates import render_json_fragment

        for _fname, fvalue in sorted(fragments.items()):
            rendered = render_json_fragment(fvalue, media=media, q=q)
            if rendered is not None:
                return embedder.embed_fragment(rendered)
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            "Invalid request: no search fragment matched the provided"
            " `media` fields.",
        )
    if not q:
        return None
    embedder = get_embedder(store, hybrid.get("embedder"))
    return embedder.embed_search(q)


def execute_hybrid(
    store, keyword_search: Search, query: dict, offset: int, limit: int
) -> tuple[SearchResult, Optional[int]]:
    hybrid = query.get("hybrid") or {}
    ratio = float(hybrid.get("semanticRatio", 0.5))
    if not (0.0 <= ratio <= 1.0):
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            "Invalid value at `.hybrid.semanticRatio`: expected a float"
            f" between `0.0` and `1.0`, but got `{ratio}`.",
        )
    embedder_name = hybrid.get("embedder")
    if embedder_name is None:
        raise EngineError(
            ErrorCode.INVALID_EMBEDDER,
            "Missing field `.hybrid.embedder`.",
        )
    from ..vector.embedders import get_embedder

    get_embedder(store, embedder_name)  # validates the embedder exists

    # pure keyword: with ratio 0 the semantic side never runs, so
    # semanticHitCount is ABSENT even when a vector was provided
    # (reference hybrid.rs query_combination)
    if ratio == 0.0:
        return keyword_search.execute(), None

    query_vector = resolve_query_vector(store, query)
    if query_vector is None:
        return keyword_search.execute(), None

    from ..vector.store import VectorSearcher

    # unfiltered searches pass universe=None: the searcher only holds
    # live documents (rebuilt per generation), and a None universe lets
    # it select top-k ON the device (a few KB read back instead of the
    # full (n,) similarity column)
    universe = None
    if keyword_search.filter_docids is not None:
        universe = filtered_universe(store, keyword_search.filter_docids)
    searcher = VectorSearcher(store, embedder_name)
    wanted = offset + limit
    # dispatch the semantic side NOW (async on the accelerator) so its
    # device round trip overlaps the host keyword search below
    semantic_future = searcher.search_async(query_vector, wanted, universe)

    distinct_field = (
        keyword_search.distinct or store.settings.distinct_attribute
    )

    def distinct_exclude(docid: int, excluded: set) -> None:
        """Expand `excluded` with every doc sharing a distinct value with
        docid (reference distinct_single_docid re-applied in the hybrid
        merge, hybrid.rs:178)."""
        if distinct_field is None:
            return
        fid = store.fields_ids_map.id(distinct_field)
        if fid is None:
            return
        for v in store.docid_facet_numbers.get((fid, docid), ()):
            p = store.facet_number_docids.get(fid, {}).get(v)
            if p is not None:
                excluded.update(p)
        for v, _ in store.docid_facet_strings.get((fid, docid), ()):
            p = store.facet_string_docids.get(fid, {}).get(v)
            if p is not None:
                excluded.update(p)

    if ratio == 1.0:
        # pure semantic
        semantic_hits = semantic_future()
        scores = {d: s for d, s in semantic_hits}
        excluded: set = set()
        docids = []
        for d, _s in semantic_hits:
            if d in excluded:
                continue
            excluded.add(d)
            distinct_exclude(d, excluded)
            docids.append(d)
        docids = docids[offset : offset + limit]
        result = SearchResult(
            documents_ids=docids,
            candidates=(
                universe if universe is not None else docids_array(store)
            ),
            scores=[scores.get(d, 0.0) for d in docids],
            scores_by_docid=scores,
        )
        return result, len(docids)

    # hybrid: merge both ranked lists by weighted global score (the
    # semantic side is already in flight on the device)
    keyword_search.compute_scores = True
    keyword_search.offset = 0
    keyword_search.limit = wanted
    kw = keyword_search.execute()
    semantic_hits = semantic_future()

    # entries: (docid, weighted score for merging, raw score, source)
    kw_list = [
        (d, kw.scores_by_docid.get(d, 1.0) * (1.0 - ratio),
         kw.scores_by_docid.get(d, 1.0), "keyword")
        for d in kw.documents_ids
    ]
    sem_list = [(d, s * ratio, s, "semantic") for d, s in semantic_hits]

    merged: list[tuple[int, float, float, str]] = []
    i = j = 0
    while i < len(sem_list) or j < len(kw_list):
        # ties prefer the semantic side (reference merge_by is_ge with
        # vector results on the left)
        if j >= len(kw_list) or (
            i < len(sem_list) and sem_list[i][1] >= kw_list[j][1]
        ):
            merged.append(sem_list[i])
            i += 1
        else:
            merged.append(kw_list[j])
            j += 1

    seen: set = set()
    docids: list[int] = []
    sources: dict[int, str] = {}
    scores: dict[int, float] = {}
    for docid, _weighted, raw, source in merged:
        if docid in seen:
            continue
        seen.add(docid)
        distinct_exclude(docid, seen)
        docids.append(docid)
        sources[docid] = source
        scores[docid] = raw

    page = docids[offset : offset + limit]
    semantic_hit_count = sum(1 for d in page if sources.get(d) == "semantic")
    candidates = union_many(
        [to_array(kw.candidates), to_array({d for d, _ in semantic_hits})]
    )
    result = SearchResult(
        documents_ids=page,
        candidates=candidates,
        scores=[scores.get(d, 0.0) for d in page],
        scores_by_docid=scores,
    )
    return result, semantic_hit_count
