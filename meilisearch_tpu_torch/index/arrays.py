"""Sorted-array posting operations — the frozen snapshot's set algebra.

The mutable store keeps postings as Python sets (cheap fine-grained
del/add); queries read them as sorted int64 arrays cached per generation.
All per-query set algebra then runs as vectorized merges — the host-side
mirror of the device bitmap ops, and the layout the device snapshot uploads
as CSR.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

EMPTY = np.empty(0, dtype=np.int64)


def to_array(docids) -> np.ndarray:
    if isinstance(docids, np.ndarray):
        return docids
    if isinstance(docids, Posting):
        return docids.ids_array()
    if not docids:
        return EMPTY
    arr = np.fromiter(docids, dtype=np.int64, count=len(docids))
    arr.sort()
    return arr


class Posting:
    """One posting list as base segments + incremental delta.

    The LSM-ish replacement for a plain docid set (SURVEY §7 "delta
    segments + periodic merge, query-time union of base+delta", the role
    LMDB upserts play in the reference): the native batch indexer appends
    whole sorted segments with zero per-element Python cost, per-document
    edits go to `extra`, deletions tombstone into `dead`, and readers
    materialize (and compact in place) on demand. Materialization is
    cached per store generation by ArrayCache, so queries pay it once.
    """

    __slots__ = ("segs", "extra", "dead")

    def __init__(self):
        # extra/dead stay None until first touched: bulk indexing creates
        # hundreds of thousands of Postings per batch and every tracked
        # container multiplies the GC sweep cost
        self.segs: list[np.ndarray] = []  # sorted unique int64 arrays
        self.extra: Optional[set] = None
        self.dead: Optional[set] = None

    # -- mutation (mirrors the set API the store used before) ---------------

    def add(self, docid: int) -> None:
        if self.dead is not None:
            self.dead.discard(docid)
        if self.extra is None:
            self.extra = set()
        self.extra.add(docid)

    def update(self, ids) -> None:
        if self.dead is not None:
            self.dead.difference_update(ids)
        if self.extra is None:
            self.extra = set()
        self.extra.update(ids)

    def add_segment(self, arr: np.ndarray) -> None:
        """Append a sorted-unique segment of docids not present before
        (fresh documents only — docids are never reused)."""
        if len(arr):
            self.segs.append(arr)

    def discard(self, docid: int) -> None:
        if self.extra is not None:
            self.extra.discard(docid)
        if self.segs:
            if self.dead is None:
                self.dead = set()
            self.dead.add(docid)

    def __bool__(self) -> bool:
        # conservative: fully-tombstoned segments still count as non-empty
        return bool(self.segs) or bool(self.extra)

    def __len__(self) -> int:
        return len(self.ids_array())

    def __iter__(self):
        return iter(self.ids_array().tolist())

    def __contains__(self, docid) -> bool:
        arr = self.ids_array()
        i = int(np.searchsorted(arr, docid))
        return i < len(arr) and int(arr[i]) == docid

    def __eq__(self, other) -> bool:
        if isinstance(other, Posting):
            return np.array_equal(self.ids_array(), other.ids_array())
        if isinstance(other, (set, frozenset, list, tuple)):
            return set(self.ids_array().tolist()) == set(other)
        return NotImplemented

    __hash__ = None  # mutable container semantics, like set

    # -- reads -----------------------------------------------------------------

    def ids_array(self) -> np.ndarray:
        """Sorted unique docids; compacts the segments in place (callers
        hold the store lock, and logical content is unchanged)."""
        if not self.extra and not self.dead and len(self.segs) <= 1:
            return self.segs[0] if self.segs else EMPTY
        parts = list(self.segs)
        if self.extra:
            parts.append(to_array(self.extra))
        merged = union_many(parts)
        if self.dead:
            merged = difference(merged, to_array(self.dead))
        self.segs = [merged] if len(merged) else []
        self.extra = None
        self.dead = None
        return merged


def union_many(arrays: Iterable[np.ndarray]) -> np.ndarray:
    arrays = [a for a in arrays if len(a)]
    if not arrays:
        return EMPTY
    if len(arrays) == 1:
        return arrays[0]
    return np.unique(np.concatenate(arrays))


def intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sorted-unique intersection via binary search (faster than intersect1d
    for asymmetric sizes)."""
    if len(a) == 0 or len(b) == 0:
        return EMPTY
    if len(a) > len(b):
        a, b = b, a
    idx = np.searchsorted(b, a)
    idx[idx == len(b)] = 0
    return a[b[idx] == a]


def difference(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return a
    idx = np.searchsorted(b, a)
    idx[idx == len(b)] = 0
    return a[b[idx] != a]


def member_mask(candidates: np.ndarray, arr: np.ndarray) -> np.ndarray:
    """Membership of each candidate in the sorted array."""
    if len(arr) == 0 or len(candidates) == 0:
        return np.zeros(len(candidates), dtype=bool)
    idx = np.searchsorted(arr, candidates)
    idx[idx == len(arr)] = 0
    return arr[idx] == candidates


class CandidateIndex:
    """Dense docid -> candidate-slot map for repeated membership tests.

    A query computes O(#terms * #dims) membership masks against one fixed
    candidate array; a dense int32 lookup makes each mask O(|posting|)
    instead of O(n log |posting|) binary searches.
    """

    def __init__(self, candidates: np.ndarray, max_docid: int):
        self.candidates = candidates
        self.n = len(candidates)
        size = max(max_docid + 1, int(candidates[-1]) + 1 if self.n else 1)
        self.idx_of = np.full(size, -1, dtype=np.int32)
        if self.n:
            self.idx_of[candidates] = np.arange(self.n, dtype=np.int32)

    def mask(self, docids: np.ndarray) -> np.ndarray:
        out = np.zeros(self.n, dtype=bool)
        if len(docids) == 0 or self.n == 0:
            return out
        if docids[-1] >= len(self.idx_of):
            docids = docids[docids < len(self.idx_of)]
        slots = self.idx_of[docids]
        out[slots[slots >= 0]] = True
        return out

    def count(self, docids: np.ndarray) -> int:
        """|docids ∩ candidates| in O(|docids|)."""
        if len(docids) == 0 or self.n == 0:
            return 0
        if docids[-1] >= len(self.idx_of):
            docids = docids[docids < len(self.idx_of)]
        return int(np.count_nonzero(self.idx_of[docids] >= 0))

    def slots(self, docids: np.ndarray) -> np.ndarray:
        """Candidate-slot indices of docids ∩ candidates, O(|docids|) —
        lets callers scatter into per-candidate arrays without a full
        n-sized boolean temp per posting (mask())."""
        if len(docids) == 0 or self.n == 0:
            return np.empty(0, dtype=np.int32)
        if docids[-1] >= len(self.idx_of):
            docids = docids[docids < len(self.idx_of)]
        s = self.idx_of[docids]
        return s[s >= 0]


class FacetArrays:
    """Per-(generation, fid) sorted facet-value index for range filters.

    `num_values`/`str_values` are the distinct facet values in ascending
    order with aligned sorted docid arrays, so a range condition is a
    bisect + one union instead of a scan over every value's set."""

    def __init__(self, store, fid: int):
        import bisect

        self._bisect = bisect
        numbers = store.facet_number_docids.get(fid, {})
        strings = store.facet_string_docids.get(fid, {})
        cache = ArrayCache(store)

        def build(table, cache_tag):
            bulk = getattr(table, "bulk_base", None)
            if bulk is None:
                values = sorted(table)
                return values, [
                    cache.get((cache_tag, fid, v), table[v]) for v in values
                ]
            # packed-v3 lazy facet table: the base slice comes out
            # vectorized (values already ascending); overlay keys patch in
            # afterwards — per-key binary searches over 100k+ values made
            # the first facet query O(n log n)
            values, ids, offsets = bulk()
            offs = np.asarray(offsets).tolist()
            arrays = [
                np.asarray(ids[offs[i] : offs[i + 1]])
                for i in range(len(values))
            ]
            loaded, new, deleted = table.overlay_parts()
            if loaded or new or deleted:
                merged = dict(zip(values, arrays))
                for k in deleted:
                    merged.pop(k, None)
                for k, p in {**loaded, **new}.items():
                    arr = p.ids_array()
                    if len(arr):
                        merged[k] = arr
                    else:
                        merged.pop(k, None)
                values = sorted(merged)
                arrays = [merged[v] for v in values]
            return values, arrays

        self.num_values, self.num_arrays = build(numbers, "fn")
        self.str_values, self.str_arrays = build(strings, "fs")

    def number_eq(self, value: float) -> np.ndarray:
        i = self._bisect.bisect_left(self.num_values, value)
        if i < len(self.num_values) and self.num_values[i] == value:
            return self.num_arrays[i]
        return EMPTY

    def string_eq(self, norm: str) -> np.ndarray:
        i = self._bisect.bisect_left(self.str_values, norm)
        if i < len(self.str_values) and self.str_values[i] == norm:
            return self.str_arrays[i]
        return EMPTY

    def number_range(self, lo, hi, lo_strict=False, hi_strict=False):
        """Union of docids with a number value in the range; None bound =
        unbounded on that side."""
        b = self._bisect
        i = 0 if lo is None else (
            b.bisect_right(self.num_values, lo)
            if lo_strict
            else b.bisect_left(self.num_values, lo)
        )
        j = len(self.num_values) if hi is None else (
            b.bisect_left(self.num_values, hi)
            if hi_strict
            else b.bisect_right(self.num_values, hi)
        )
        return union_many(self.num_arrays[i:j])

    def string_prefix(self, prefix: str) -> np.ndarray:
        b = self._bisect
        i = b.bisect_left(self.str_values, prefix)
        parts = []
        while i < len(self.str_values) and self.str_values[i].startswith(prefix):
            parts.append(self.str_arrays[i])
            i += 1
        return union_many(parts)

    def string_range(self, lo, hi, lo_strict=False, hi_strict=False):
        b = self._bisect
        i = 0 if lo is None else (
            b.bisect_right(self.str_values, lo)
            if lo_strict
            else b.bisect_left(self.str_values, lo)
        )
        j = len(self.str_values) if hi is None else (
            b.bisect_left(self.str_values, hi)
            if hi_strict
            else b.bisect_right(self.str_values, hi)
        )
        return union_many(self.str_arrays[i:j])


class FacetConcat:
    """Per-(generation, fid) concatenated facet posting arrays for BULK
    counting: one gather + one reduceat counts EVERY value's candidate
    overlap at once (the vectorized strategy behind facet distribution —
    reference facet_distribution.rs picks between iterate-docs and
    iterate-tree; this is the iterate-tree arm without the per-value
    Python loop)."""

    def __init__(self, store, fid: int):
        fa = facet_arrays(store, fid)

        def build(arrays):
            kept, parts, offs = [], [], [0]
            for i, a in enumerate(arrays):
                if len(a):
                    kept.append(i)
                    parts.append(a)
                    offs.append(offs[-1] + len(a))
            ids = np.concatenate(parts) if parts else EMPTY
            return (
                np.array(kept, dtype=np.int64),
                ids,
                np.array(offs, dtype=np.int64),
            )

        self.num_kept, self.num_ids, self.num_offsets = build(fa.num_arrays)
        self.str_kept, self.str_ids, self.str_offsets = build(fa.str_arrays)
        self.num_values = fa.num_values
        self.str_values = fa.str_values

    def counts(self, mask: Optional[np.ndarray]):
        """(num_kept_idx, num_counts, str_kept_idx, str_counts) of
        |value posting ∩ mask| per kept value; mask None = no restriction."""

        def seg(ids, offsets):
            if len(offsets) <= 1:
                return np.zeros(0, dtype=np.int64)
            if mask is None:
                return np.diff(offsets)
            if len(ids) and int(ids.max()) >= len(mask):
                # ids beyond the mask width cannot be candidates
                hits = np.zeros(len(ids), dtype=np.int64)
                sel = ids < len(mask)
                hits[sel] = mask[ids[sel]]
            else:
                hits = mask[ids].astype(np.int64)
            return np.add.reduceat(hits, offsets[:-1])

        return (
            self.num_kept,
            seg(self.num_ids, self.num_offsets),
            self.str_kept,
            seg(self.str_ids, self.str_offsets),
        )


def facet_concat(store, fid: int) -> FacetConcat:
    cache = getattr(store, "_facet_concat_cache", None)
    if cache is None or cache[0] != store.generation:
        cache = (store.generation, {})
        store._facet_concat_cache = cache
    fc = cache[1].get(fid)
    if fc is None:
        fc = FacetConcat(store, fid)
        cache[1][fid] = fc
    return fc


class SortColumns:
    """Dense per-field sort keys: docid -> min/max number (NaN = none) and
    min/max string rank (-1 = none), built from the sorted facet index."""

    def __init__(self, store, fid: int):
        size = max(store._next_docid, 1)
        fa = facet_arrays(store, fid)
        self.num_min = np.full(size, np.nan)
        self.num_max = np.full(size, np.nan)
        for v, arr in zip(fa.num_values, fa.num_arrays):
            sel = arr[np.isnan(self.num_min[arr])]
            self.num_min[sel] = v
            self.num_max[arr] = v
        self.str_min = np.full(size, -1, dtype=np.int64)
        self.str_max = np.full(size, -1, dtype=np.int64)
        for r, arr in enumerate(fa.str_arrays):
            sel = arr[self.str_min[arr] < 0]
            self.str_min[sel] = r
            self.str_max[arr] = r


def sort_columns(store, fid: int) -> SortColumns:
    cache = getattr(store, "_sort_columns_cache", None)
    if cache is None or cache[0] != store.generation:
        cache = (store.generation, {})
        store._sort_columns_cache = cache
    cols = cache[1].get(fid)
    if cols is None:
        cols = SortColumns(store, fid)
        cache[1][fid] = cols
    return cols


def docids_array(store) -> np.ndarray:
    """Sorted array of all live internal docids, cached per generation
    (maintained incrementally across minor writes by the store)."""
    cached = getattr(store, "_docids_array_cache", None)
    if cached is None or cached[0] != store.generation:
        cached = (store.generation, store.documents_ids_array())
        store._docids_array_cache = cached
    return cached[1]


def filtered_universe(store, filter_docids) -> np.ndarray:
    """live ∩ filter, memoized per (generation, filter array): the filter
    result is itself cached per generation (search/filters.py), so hot
    filters pay the ~10-15 ms live-intersection at 1M docs once instead
    of per query. The entry keeps a reference to the filter array, which
    guarantees its id() stays unique while cached."""
    live = docids_array(store)
    arr = filter_docids
    if not isinstance(arr, np.ndarray):
        return intersect(live, to_array(arr))
    from collections import OrderedDict

    cache = getattr(store, "_universe_arr_lru", None)
    if cache is None or cache[0] != store.generation:
        cache = (store.generation, OrderedDict())
        store._universe_arr_lru = cache
    lru = cache[1]
    ent = lru.get(id(arr))
    if ent is not None and ent[0] is arr:
        lru.move_to_end(id(arr))
        return ent[1]
    res = intersect(live, arr)
    lru[id(arr)] = (arr, res)
    if len(lru) > 128:
        lru.popitem(last=False)
    return res


def facet_arrays(store, fid: int) -> FacetArrays:
    cache = getattr(store, "_facet_arrays_cache", None)
    if cache is None or cache[0] != store.generation:
        cache = (store.generation, {})
        store._facet_arrays_cache = cache
    idx = cache[1].get(fid)
    if idx is None:
        idx = FacetArrays(store, fid)
        cache[1][fid] = idx
    return idx


class ArrayCache:
    """Per-store-generation cache of set -> sorted-array conversions."""

    def __init__(self, store):
        self.store = store
        cache = getattr(store, "_posting_array_cache", None)
        if cache is None or cache[0] != store.generation:
            cache = (store.generation, {})
            store._posting_array_cache = cache
        self.cache: dict = cache[1]

    def get(self, key: tuple, docids_set: Optional[set]) -> np.ndarray:
        arr = self.cache.get(key)
        if arr is None:
            arr = to_array(docids_set)
            if len(self.cache) < 200_000:
                self.cache[key] = arr
        return arr
