"""Facet distribution, facet stats, and typo-tolerant facet-value search.

Reference:
  - FacetDistribution  (milli/src/search/facet/facet_distribution.rs)
  - SearchForFacetValues (milli/src/search/facet/search.rs)

Distribution counts each facet value's frequency within the candidate set;
value keys are the ORIGINAL form of the first-seen occurrence; numbers are
emitted as numbers. Ordering per facet: lexicographic (default) or by count
(sortFacetValuesBy), capped at maxValuesPerFacet.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from ..index.arrays import ArrayCache, CandidateIndex, to_array
from ..index.store import IndexStore, facet_string_normalize
from ..types.errors import EngineError, ErrorCode

DEFAULT_VALUES_PER_FACET = 100
MAX_FACET_VALUES_RETURNED = 100  # facet search cap (search.rs MAX_NUMBER_OF_FACETS)


def validate_facets(store: IndexStore, facets: Iterable[str]) -> list[str]:
    """Expand `*` and reject non-filterable facets (reference
    FacetDistribution error surface, pinned by tests/search/errors.rs).
    Returns the expanded facet list. Shared with the multi-search
    validation pass, which must fail in query order BEFORE any query
    executes (multi/mod.rs search_one_query_error)."""
    settings = store.settings
    expanded: list[str] = []
    for facet in facets:
        if facet == "*":
            for name in store.fields_ids_map.names():
                if settings.is_filterable(name) and name not in ("_geo", "_geojson"):
                    expanded.append(name)
        else:
            expanded.append(facet)

    invalid = [f for f in expanded if not settings.is_filterable(f)]
    if invalid:
        attrs = sorted(settings.filterable_attribute_names())
        field = invalid[0]
        if attrs:
            msg = (
                f"Invalid facet distribution: Attribute `{field}` is not"
                f" filterable. Available filterable attributes patterns are:"
                f" `{', '.join(attrs)}`."
            )
        else:
            msg = (
                f"Invalid facet distribution: Attribute `{field}` is not"
                " filterable. This index does not have configured filterable"
                " attributes."
            )
        raise EngineError(ErrorCode.INVALID_SEARCH_FACETS, msg)
    return expanded


def facet_distribution(
    store: IndexStore,
    facets: Iterable[str],
    candidates: Optional[set],
    max_values_per_facet: Optional[int] = None,
    sort_facet_values_by: Optional[dict] = None,
) -> tuple[dict, dict]:
    """Returns (facetDistribution, facetStats)."""
    counter = _Counter(store, candidates)
    settings = store.settings
    max_values = (
        max_values_per_facet
        if max_values_per_facet is not None
        else settings.faceting.max_values_per_facet
    )
    order_config = dict(settings.faceting.sort_facet_values_by)
    if sort_facet_values_by:
        order_config.update(sort_facet_values_by)

    expanded = validate_facets(store, facets)

    distribution: dict = {}
    stats: dict = {}
    for facet in expanded:
        fid = store.fields_ids_map.id(facet)
        out: dict = {}
        min_n = max_n = None
        if fid is not None:
            # bulk strategy: ONE gather + reduceat over the concatenated
            # per-value posting arrays counts every value at once
            # (reference facet_distribution.rs iterate-tree arm, without
            # the per-value loop); value selection stays in numpy — only
            # the <= max_values survivors touch Python (a per-distinct-
            # value dict loop cost ~1 s/drain on 100k-author facets)
            from ..index.arrays import facet_concat

            fc = facet_concat(store, fid)
            nk, ncounts, sk, scounts = fc.counts(counter.mask)
            nnz = np.nonzero(ncounts)[0]
            snz = np.nonzero(scounts)[0]
            if len(nnz):
                # num_values is sorted ascending: stats come straight off
                # the nonzero frontier (num_values is a plain list)
                min_n = float(fc.num_values[int(nk[nnz[0]])])
                max_n = float(fc.num_values[int(nk[nnz[-1]])])
            order = order_config.get(facet, order_config.get("*", "alpha"))
            if order == "count":
                # (-count, kind, value-rank): values are pre-sorted inside
                # each kind, and numbers order before strings on ties
                cnt = np.concatenate([ncounts[nnz], scounts[snz]])
                kind = np.concatenate(
                    [np.zeros(len(nnz), np.int8), np.ones(len(snz), np.int8)]
                )
                rank = np.concatenate([nnz, snz])
                sel = np.lexsort((rank, kind, -cnt))[:max_values]
                picks = [
                    (int(kind[j]), int(rank[j]), int(cnt[j])) for j in sel
                ]
            else:
                picks = [(0, int(j), int(ncounts[j])) for j in nnz[:max_values]]
                room = max_values - len(picks)
                picks += [(1, int(j), int(scounts[j])) for j in snz[:room]]
            for knd, j, n in picks:
                if knd == 0:
                    value = float(fc.num_values[nk[j]])
                    key = int(value) if value.is_integer() else value
                else:
                    norm = fc.str_values[sk[j]]
                    key = store.facet_string_original.get((fid, norm), norm)
                out[str(key)] = n

        distribution[facet] = out
        if min_n is not None:
            stats[facet] = {"min": min_n, "max": max_n}
    return distribution, stats


def search_facet_values(
    store: IndexStore,
    facet_name: str,
    query: Optional[str],
    candidates: Optional[set] = None,
    max_values: Optional[int] = None,
    locales: Optional[list] = None,
) -> list[dict]:
    """Typo-tolerant search inside one facet's values
    (reference: SearchForFacetValues::execute, search/facet/search.rs:75).

    Locale handling (locales.rs facet suite): facet strings normalize as
    WHOLE tokens via normalize_facet_string (facet_search_builder.rs:254)
    — Han folds traditional->simplified on BOTH the stored keys and the
    query regardless of locale, so 進撃 finds 进击的巨人 under cmn AND
    jpn. When the query forces locales DISJOINT from the field's
    localizedAttributes rule, the reference's per-language pipelines
    produce incompatible normal forms and nothing matches
    (facet_search_with_localized_attributes: cmn query over a jpn-ruled
    field returns []); modeled as an explicit locale-mismatch check."""
    counter = _Counter(store, candidates)
    settings = store.settings
    if query and locales:
        from ..analysis.tokenizer import canonical_locale

        rule_locs = settings.locales_for_field(facet_name)
        if rule_locs:
            q_set = {canonical_locale(loc) for loc in locales}
            r_set = {canonical_locale(loc) for loc in rule_locs}
            if not (q_set & r_set):
                return []
    feats = settings.filter_features_for(facet_name)
    if not feats or not feats.get("facetSearch", True):
        attrs = sorted(settings.filterable_attribute_names())
        raise EngineError(
            ErrorCode.INVALID_FACET_SEARCH_FACET_NAME,
            f"The facet {facet_name!r} is not searchable. Available facet"
            f" searchable attributes patterns are: `{', '.join(attrs) or ''}`.",
        )
    limit = max_values if max_values is not None else MAX_FACET_VALUES_RETURNED

    fid = store.fields_ids_map.id(facet_name)
    if fid is None:
        return []
    # per-generation sorted value arrays (bulk-built from the packed
    # columns when lazy): per-value `table[norm]` lookups would binary
    # search a 100k-value lazy table once per value
    from ..index.arrays import facet_arrays

    fa = facet_arrays(store, fid)
    values = fa.str_values
    table = dict(zip(values, fa.str_arrays))
    # matching runs over the charabia-NORMALIZED form (deaccented), the
    # reference's facet_id_normalized_string_strings DB: "àdventure"
    # matches "Adventure" (facet_search.rs advanced_facet_search); cached
    # per generation alongside the facet arrays
    from ..analysis.tokenizer import normalize_word

    skeys = getattr(fa, "_search_keys", None)
    if skeys is None:
        # "cmn" folds Han traditional->simplified (facet normal forms are
        # locale-independent, see docstring); Latin handling is unchanged
        skeys = [normalize_word(v, "cmn") for v in values]
        fa._search_keys = skeys

    order = settings.faceting.sort_facet_values_by.get(
        facet_name, settings.faceting.sort_facet_values_by.get("*", "alpha")
    )

    hits: list[tuple[str, str, int]] = []
    if not query:
        for norm in values:
            count = counter.count(("fs", fid, norm), table[norm])
            if count:
                hits.append((norm, store.facet_string_original.get((fid, norm), norm), count))
    else:
        qnorm = normalize_word(facet_string_normalize(query), "cmn")
        # typo budgets as for search words (reference uses the same
        # one/two-typo thresholds with a prefix DFA); a query listed in
        # disableOnWords matches without typos
        tt = settings.typo_tolerance
        n = len(qnorm)
        if (
            not tt.enabled
            or n < tt.min_word_size_for_typos.one_typo
            or qnorm in {normalize_word(w) for w in tt.disable_on_words}
        ):
            max_typos = 0
        elif n < tt.min_word_size_for_typos.two_typos:
            max_typos = 1
        else:
            max_typos = 2
        if max_typos == 0:
            for i, norm in enumerate(values):
                if skeys[i].startswith(qnorm):
                    count = counter.count(("fs", fid, norm), table[norm])
                    if count:
                        hits.append(
                            (norm, store.facet_string_original.get((fid, norm), norm), count)
                        )
        else:
            import numpy as np

            from ..ops.levenshtein import osa_distances, pack_words

            mat, lens = pack_words(skeys)
            _full, prefix_min = osa_distances(qnorm, mat, lens)
            first = qnorm[:1]
            for i, norm in enumerate(values):
                d = int(prefix_min[i])
                if d > max_typos:
                    continue
                if d >= 1 and not skeys[i].startswith(first):
                    # one-typo matches must share the first character
                    if d == 1:
                        continue
                count = counter.count(("fs", fid, norm), table[norm])
                if count:
                    hits.append(
                        (norm, store.facet_string_original.get((fid, norm), norm), count)
                    )

    if order == "count":
        hits.sort(key=lambda h: (-h[2], h[0]))
    else:
        hits.sort(key=lambda h: h[0])
    return [{"value": orig, "count": count} for _norm, orig, count in hits[:limit]]


class _Counter:
    """Counts |value posting ∩ candidates| over the per-generation cached
    posting arrays. `candidates` may be None (no restriction), a docid
    set/array, or a (D,) bool mask (the device batch's full-candidate
    bitmap, search/device_batch.py)."""

    def __init__(self, store, candidates):
        self.none = candidates is None
        self.mask = None
        if self.none:
            return
        self.cache = ArrayCache(store)
        if isinstance(candidates, np.ndarray) and candidates.dtype == bool:
            self.mask = candidates
            return
        arr = (
            candidates
            if isinstance(candidates, np.ndarray)
            else to_array(set(candidates))
        )
        size = max(store._next_docid, 1)
        self.mask = np.zeros(
            max(size, int(arr[-1]) + 1 if len(arr) else 1), dtype=bool
        )
        self.mask[arr] = True

    def count(self, key, docids_set) -> int:
        if self.none:
            return len(docids_set)
        ids = self.cache.get(key, docids_set)
        if not len(ids):
            return 0
        if int(ids[-1]) >= len(self.mask):
            ids = ids[ids < len(self.mask)]
        return int(np.count_nonzero(self.mask[ids]))
