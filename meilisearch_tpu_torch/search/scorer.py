"""Fused ranking scorer.

This replaces milli's recursive `bucket_sort` descent
(reference: search/new/bucket_sort.rs:23 + graph_based_ranking_rule.rs:220 +
ranking_rule_graph/cheapest_paths.rs) with a single vectorized pass:

For every candidate document we compute, per ranking rule, the minimal path
cost through the query interpretation graph — exactly the cost at which
milli's PathVisitor would first emit the document. The final ranking is a
lexicographic sort over the per-rule cost columns (plus sort/geo/exact-
attribute columns and the docid tiebreak), which is provably the same order
as the reference's bucket refinement.

The interpretation space is the ranking-rule graph: states are
(query-graph node, typo class) pairs plus a skip state per removable node
(terms-matching-strategy word dropping, reference
graph_based_ranking_rule.rs:150 removal costs + cheapest_paths.rs
nodes_to_skip semantics). A lexicographic dynamic program over this DAG,
batched across all candidates, computes the whole cost matrix. On TPU the DP
inner ops are elementwise min/select over candidate-length vectors (VPU) and
the masks come from posting-bitmap gathers; see ops/.

Cost semantics ported per rule:
  words      — skipped term ids (build.rs:49 cost_of_ignoring × dest_size)
  typo       — typo class + ngram base cost (typo/mod.rs:build_edges)
  proximity  — pair edges rnm..rnm+2 w/ forward prox r+1 / backward prox r,
               fallback term edge at (MAX_DISTANCE-1)+rnm
               (proximity/build.rs + compute_docids.rs)
  fid        — weight × term_count over matching fields (fid/mod.rs)
  position   — bucketed-position cost table (position/mod.rs:cost_from_distance)
  exactness  — 0 for the exact original word/phrase else term_count
               (exactness/mod.rs)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..index.arrays import (
    EMPTY,
    ArrayCache,
    CandidateIndex,
    intersect,
    union_many,
)
from ..index.store import MAX_DISTANCE, IndexStore
from .graph import QueryGraph, QueryNode
from .query_terms import Phrase, QueryTerm

INF = np.int64(1) << 24


def position_cost_from_distance(distance: int) -> int:
    """Reference: position/mod.rs:cost_from_distance."""
    if distance == 0:
        return 0
    if distance == 1:
        return 1
    if distance <= 4:
        return 2
    if distance <= 7:
        return 3
    if distance <= 11:
        return 4
    if distance <= 16:
        return 5
    if distance <= 24:
        return 6
    if distance <= 64:
        return 7
    if distance <= 256:
        return 8
    if distance <= 1024:
        return 9
    return 10


# every value bucketed_position can produce for u16 positions
# (index/store.py:58, reference milli/src/lib.rs:248-260)
_BUCKET_UNIVERSE = tuple(range(16)) + (24,) + tuple(2**k for k in range(5, 17))


class _LazyWordKeyMap:
    """word -> set of second-key values present in a (word, k2)-keyed
    posting table, probed on demand against the small k2 universe.

    Exposes dict-like `.get(word, default)`; results memoize per store
    generation (instances live in store._derived_maps)."""

    __slots__ = ("table", "universe_fn", "cache")

    def __init__(self, table, universe_fn):
        self.table = table
        self.universe_fn = universe_fn
        self.cache: dict = {}

    def get(self, word, default=None):
        s = self.cache.get(word)
        if s is None:
            table = self.table
            s = {k2 for k2 in self.universe_fn() if (word, k2) in table}
            self.cache[word] = s
        return s


class Resolver:
    """Posting-set resolution with per-search caching (the db_cache twin).

    `restricted_fids` mirrors attributesToSearchOn: when set, word postings
    are recomputed as unions of word_fid postings over the allowed fields
    (reference: db_cache.rs:208 get_db_word_docids restricted branch).
    """

    def __init__(
        self,
        store: IndexStore,
        candidates: np.ndarray,
        restricted_fids: Optional[set[int]] = None,
    ):
        self.store = store
        self.candidates = candidates
        self.restricted_fids = restricted_fids
        self.arrays = ArrayCache(store)
        self._phrase_cache: dict[Phrase, np.ndarray] = {}
        # word -> fids / position buckets, probed lazily per word against
        # the small second-key universe (#fields / #position buckets):
        # eagerly inverting the (word, k2) tables cost ~70 s per
        # generation at a 1M-doc vocabulary, all of it on the first
        # query after a write
        maps = getattr(store, "_derived_maps", None)
        if maps is None or maps[0] != store.generation:
            fids_by_word = _LazyWordKeyMap(
                store.word_fid_docids,
                lambda: range(len(store.fields_ids_map)),
            )
            buckets_by_word = _LazyWordKeyMap(
                store.word_position_docids, lambda: _BUCKET_UNIVERSE
            )
            maps = (store.generation, fids_by_word, buckets_by_word)
            store._derived_maps = maps
        self.fids_by_word = maps[1]
        self.buckets_by_word = maps[2]
        self._cand_index = CandidateIndex(candidates, store._next_docid)

    # -- raw postings (sorted int64 arrays, cached per generation) ----------

    def word_docids(self, word: str, original: bool) -> np.ndarray:
        """original=True -> word ∪ exact-word postings; derived words only get
        the tolerant postings (reference db_cache.rs:183)."""
        restricted = self.restricted_fids is not None
        key = ("w", word, original, restricted)
        cached = self.arrays.cache.get(key)
        if cached is not None:
            return cached
        if restricted:
            # derived (typo) words resolve over the TOLERANT restricted
            # fids only — typo-disabled (exact) attributes match without
            # typos (reference db_cache.rs:208-226 restricted_fids
            # tolerant/exact split)
            exact_fids = (
                self.store.exact_attributes_fids() if not original else ()
            )
            parts = [
                self.word_fid_docids(word, fid)
                for fid in self.fids_by_word.get(word, ())
                if fid in self.restricted_fids and fid not in exact_fids
            ]
            arr = union_many(parts)
        elif original:
            arr = union_many(
                [
                    self.arrays.get(
                        ("wd", word), self.store.word_docids.get(word)
                    ),
                    self.arrays.get(
                        ("we", word), self.store.exact_word_docids.get(word)
                    ),
                ]
            )
        else:
            arr = self.arrays.get(("wd", word), self.store.word_docids.get(word))
        self.arrays.cache[key] = arr
        return arr

    def word_fid_docids(self, word: str, fid: int) -> np.ndarray:
        if self.restricted_fids is not None and fid not in self.restricted_fids:
            return EMPTY
        return self.arrays.get(
            ("wf", word, fid), self.store.word_fid_docids.get((word, fid))
        )

    def word_position_docids(self, word: str, bucket: int) -> np.ndarray:
        return self.arrays.get(
            ("wp", word, bucket),
            self.store.word_position_docids.get((word, bucket)),
        )

    def pair_proximity_docids(self, prox: int, w1: str, w2: str) -> np.ndarray:
        """ByWord: direct lookup. ByAttribute: same-attribute co-occurrence,
        proximity-independent (reference db_cache.rs:361)."""
        if self.store.settings.proximity_precision == "byAttribute":
            key = ("pp_attr", w1, w2)
            cached = self.arrays.cache.get(key)
            if cached is None:
                parts = []
                for fid in self.fids_by_word.get(w1, ()):
                    a = self.word_fid_docids(w1, fid)
                    b = self.word_fid_docids(w2, fid)
                    if len(a) and len(b):
                        parts.append(intersect(a, b))
                cached = union_many(parts)
                self.arrays.cache[key] = cached
            return cached
        return self.arrays.get(
            ("pp", prox, w1, w2),
            self.store.word_pair_proximity_docids.get((prox, w1, w2)),
        )

    def phrase_docids(self, phrase: Phrase) -> np.ndarray:
        """Reference: resolve_query_graph.rs:187 compute_phrase_docids."""
        if phrase in self._phrase_cache:
            return self._phrase_cache[phrase]
        words = list(phrase)
        present = [w for w in words if w is not None]
        if not present:
            self._phrase_cache[phrase] = EMPTY
            return EMPTY
        candidates: Optional[np.ndarray] = None
        for w in present:
            docids = self.word_docids(w, original=True)
            if not len(docids):
                self._phrase_cache[phrase] = EMPTY
                return EMPTY
            candidates = docids if candidates is None else intersect(candidates, docids)
        winsize = min(len(words), 3)
        for start in range(0, len(words) - winsize + 1):
            win = words[start : start + winsize]
            for offset, s1 in enumerate(win):
                if s1 is None:
                    continue
                for dist, s2 in enumerate(win[offset + 1 :]):
                    if s2 is None:
                        continue
                    if dist == 0:
                        m = self.pair_proximity_docids(1, s1, s2)
                        if not len(m):
                            self._phrase_cache[phrase] = EMPTY
                            return EMPTY
                        candidates = intersect(candidates, m)
                    else:
                        bitmap = union_many(
                            [
                                self.pair_proximity_docids(d + 1, s1, s2)
                                for d in range(dist + 1)
                            ]
                        )
                        if not len(bitmap):
                            self._phrase_cache[phrase] = EMPTY
                            return EMPTY
                        candidates = intersect(candidates, bitmap)
                    if not len(candidates):
                        self._phrase_cache[phrase] = EMPTY
                        return EMPTY
        self._phrase_cache[phrase] = candidates
        return candidates

    def prefix_words(self, prefix: str) -> list[str]:
        from bisect import bisect_left

        words = self.store.all_words_sorted()
        lo = bisect_left(words, prefix)
        hi = bisect_left(words, prefix + "￿")
        return words[lo:hi]

    # -- term-subset resolution ---------------------------------------------

    def class_words(self, term: QueryTerm, cls: int) -> list[tuple[str, bool]]:
        """(word, is_original) pairs for one typo class.

        Reference query_term/mod.rs:199 all_single_words_except_prefix_db —
        ngram derivations are always Word::Derived.
        """
        is_ngram = term.ngram_words is not None
        out = []
        for w in term.words_for_class(cls):
            out.append((w, not is_ngram if cls == 0 else False))
        return out

    def class_phrases(self, term: QueryTerm, cls: int) -> list[Phrase]:
        return term.phrases_for_class(cls)

    def term_class_docids(self, term: QueryTerm, cls: int) -> np.ndarray:
        """Docids matching one typo class of a term
        (reference resolve_query_graph.rs:33 compute_query_term_subset_docids
        with the class-restricted subset)."""
        parts = [
            self.word_docids(w, original)
            for w, original in self.class_words(term, cls)
        ]
        parts.extend(self.phrase_docids(p) for p in self.class_phrases(term, cls))
        if cls == 0 and term.use_prefix_db is not None:
            is_original = term.ngram_words is None
            parts.extend(
                self.word_docids(w, original=is_original)
                for w in self.prefix_words(term.use_prefix_db)
            )
        return union_many(parts)

    def term_all_docids(self, term: QueryTerm) -> np.ndarray:
        return union_many(
            [self.term_class_docids(term, cls) for cls in range(0, 3)]
        )

    # -- masks over candidates -----------------------------------------------

    def mask(self, docids: np.ndarray) -> np.ndarray:
        return self._cand_index.mask(docids)

    def slots(self, docids: np.ndarray) -> np.ndarray:
        return self._cand_index.slots(docids)


@dataclass
class NodeStates:
    node: QueryNode
    classes: list[int]  # available typo classes
    class_masks: list[np.ndarray]
    removable_group: Optional[int]  # removal-group index or None


def graph_max_cost(
    graph: QueryGraph,
    store: IndexStore,
    strategy: str,
    dim: str,
    k: int,
    node_resolves,
    node_removable,
) -> int:
    """Maximum path cost for one rule over the first-k-terms subgraph
    (reference: graph_based_ranking_rule.rs:144 next_max_cost — the
    successor of this value is the rule's max_rank). Shared by the host
    FusedScorer and the device finish path (search/device_batch.py), which
    supply their own `node_resolves(node)` / `node_removable(node)`
    predicates (universe membership vs candidate-bitmap membership).

    Every rule after `words` computes its max on the graph the words
    rule handed down: QueryGraph::build_from_paths over the bucket's
    GOOD paths (graph_based_ranking_rule.rs:353). An alternative whose
    docids are empty in the universe is on no good path, so it never
    reaches downstream maxes — this is how ngram nodes (whose
    split-words derivation is excluded when it equals their own
    components, compute_derivations.rs:300) drop out of maxTypoCount.
    The words rule itself takes the FULL graph (max computed at
    start_iteration, before any dead-end removal)."""
    nodes = [
        n
        for n in graph.term_nodes()
        if dim == "words"
        or (n.located.end_term_id < k and node_resolves(n))
    ]
    order = sorted(nodes, key=lambda nd: (nd.located.start_term_id, nd.node_id))
    dp: dict[int, int] = {graph.root: 0}
    for node in order:
        term = node.located
        rnm = term.term_ids_len - 1
        best = None
        for p in node.predecessors:
            if p not in dp:
                continue
            cost = 0
            if dim == "typo":
                # the rule's max cost uses the term's STRUCTURAL typo
                # budget (max_typo_cost checks the default-All subsets
                # and the split-words possibility, never realized
                # derivations), plus the ngram base cost
                # (typo/mod.rs:53 build_edges)
                t = term.term
                base = term.term_ids_len if t.ngram_words else 0
                cost = t.max_typo_cost() + base
            elif dim == "proximity":
                adjacent = False
                if p != graph.root:
                    src = graph.nodes[p]
                    adjacent = (
                        src.located.end_position + 1 == term.start_position
                    )
                cost = ((MAX_DISTANCE - 1) + rnm) if adjacent else rnm
            elif dim == "fid":
                weights = store.fid_weight_map()
                max_w = max(weights.values()) if weights else 0
                cost = max_w * term.term_ids_len
            elif dim == "position":
                cost = 10 * term.term_ids_len
            elif dim == "exactness":
                cost = term.term_ids_len
            elif dim == "words":
                # a skippable node can contribute its skip cost
                cost = term.term_ids_len if node_removable(node) else 0
            cand = dp[p] + cost
            if best is None or cand > best:
                best = cand
        if best is not None:
            dp[node.node_id] = best
    # the k-truncated subgraph's paths end at the last KEPT node, which
    # is not a predecessor of graph.end; since every edge cost is >= 0,
    # the max full-path cost equals the max dp value over kept nodes
    best_end = max(dp.values(), default=0)
    if dim == "words" and strategy != "all":
        best_end += max(graph.words_in_phrases_count() - 1, 0)
    return best_end


class FusedScorer:
    """Computes the per-candidate cost matrix for the graph-based rules."""

    def __init__(
        self,
        store: IndexStore,
        resolver: Resolver,
        graph: QueryGraph,
        strategy: str,  # "last" | "all" | "frequency"
        dims: list[str],  # graph dims in assembled rule order
    ):
        self.store = store
        self.r = resolver
        self.graph = graph
        self.strategy = strategy
        self.dims = dims
        self.n = len(resolver.candidates)
        self.dim_idx = {d: i for i, d in enumerate(dims)}
        # Only the typo and exactness rules narrow the term subsets when they
        # rebuild the bucket graph (reference: typo/mod.rs build_edges clears
        # typo classes; exactness/mod.rs keep_only_exact_term). Rules placed
        # BEFORE them see the full subsets (proximity_typo.rs pins this).
        # Per dim we record which subset view it sees: "full", "class", or
        # "exact-aware" (class + the exact-edge restriction).
        typo_pos = self.dim_idx.get("typo", 1 << 20)
        exact_pos = self.dim_idx.get("exactness", 1 << 20)
        # per dim: (sees_typo_restriction, sees_exactness_restriction)
        self.dim_view = {
            d: (i > typo_pos, i > exact_pos) for i, d in enumerate(dims)
        }
        # The exact-edge choice becomes DP state only when some rule runs
        # after exactness.
        self.exact_flagged = exact_pos < len(dims) - 1
        self._pair_cost_cache: dict = {}
        self._fid_addend_cache: dict = {}
        self._pos_addend_cache: dict = {}
        self._exact_mask_cache: dict = {}
        self._prepare()

    def _sel(self, dim: str, cls: int, e: int):
        after_typo, after_exact = self.dim_view[dim]
        if after_exact and e:
            return "exact"
        return cls if after_typo else None

    # -- static prep --------------------------------------------------------

    def _prepare(self):
        if self.strategy == "last":
            groups = self.graph.removal_groups_last()
        elif self.strategy == "frequency":
            groups = self.graph.removal_groups_frequency(self.store)
        else:
            groups = []
        group_of: dict[int, int] = {}
        for gi, g in enumerate(groups):
            for nid in g:
                group_of[nid] = gi
        self.n_groups = len(groups)

        self.node_states: dict[int, NodeStates] = {}
        for node in self.graph.term_nodes():
            term = node.located.term
            classes = list(range(0, term.max_typo_cost() + 1))
            masks = [
                self.r.mask(self.r.term_class_docids(term, c)) for c in classes
            ]
            self.node_states[node.node_id] = NodeStates(
                node, classes, masks, group_of.get(node.node_id)
            )
        self._prepare_packing()

    def _prepare_packing(self):
        """Pack the D cost dims into bit fields of one int64 so the DP's
        lexicographic min becomes a plain `np.minimum` over (N,) vectors.

        Each dim gets a capacity larger than any reachable path cost; fid and
        position (whose addends can be INF per candidate) get a per-dim
        sentinel `dim_inf` sized so that even `len(nodes)` INF accumulations
        stay inside the field. Falls back to the (D, N) matrix DP when the
        fields don't fit in the packing budget."""
        nodes = list(self.graph.term_nodes())
        max_w = 1
        wm = self.store.fid_weight_map()
        if wm:
            max_w = max(max(wm.values()), 1)
        bound: dict[str, int] = {d: 1 for d in self.dims}
        for node in nodes:
            tlen = node.located.term_ids_len
            mt = node.located.term.max_typo_cost()
            for d in self.dims:
                if d == "words":
                    bound[d] += tlen
                elif d == "typo":
                    bound[d] += mt + tlen
                elif d == "proximity":
                    bound[d] += 3 + tlen
                elif d == "fid":
                    bound[d] += max_w * tlen
                elif d == "position":
                    bound[d] += 10 * tlen
                elif d == "exactness":
                    bound[d] += tlen

        self._dim_inf: dict[str, int] = {}
        caps: dict[str, int] = {}
        for d in self.dims:
            if d in ("fid", "position"):
                inf_d = bound[d] + 1
                self._dim_inf[d] = inf_d
                caps[d] = inf_d * (len(nodes) + 1) + bound[d] + 1
            else:
                caps[d] = bound[d] + 1

        self._strides: dict[str, int] = {}
        s = 1
        for d in reversed(self.dims):
            self._strides[d] = s
            s *= caps[d]
        self._caps = caps
        self._pack_inf = 1 << 55
        self._packed_ok = s <= (1 << 55) and len(nodes) <= 100
        self._entry_base_cache: dict = {}

    # -- per-(node,class) cost addends ----------------------------------------

    def _typo_cost(self, node: QueryNode, cls: int) -> int:
        term = node.located
        base = term.term_ids_len if term.term.ngram_words is not None else 0
        return cls + base

    def _term_cache_key(self, kind: str, term: QueryTerm, sel) -> tuple:
        """Cross-query cache key: a term's derivations are a deterministic
        function of its content within one store generation. `is_prefix`
        matters: the same word as the query's last term carries prefix
        expansions the non-prefix occurrence doesn't."""
        return (
            kind,
            term.original,
            term.is_prefix,
            term.phrase,
            tuple(term.ngram_words or ()),
            term.use_prefix_db,
            sel,
            self.r.restricted_fids is not None,
        )

    def _fid_entries(self, term: QueryTerm, sel) -> list:
        """[(docids, weight)] ascending by weight, generation-cached."""
        key = self._term_cache_key("hfid", term, sel)
        cached = self.r.arrays.cache.get(key)
        if cached is not None:
            return cached
        weight_map = self.store.fid_weight_map()
        all_fids: set[int] = set()
        words = self._subset_words(term, sel)
        phrases = self._subset_phrases(term, sel)
        for w in words:
            all_fids |= self.r.fids_by_word.get(w, set())
        for p in phrases:
            for w in p:
                if w is not None:
                    all_fids |= self.r.fids_by_word.get(w, set())
        prefix_words: list[str] = []
        if self._uses_prefix_db(term, sel):
            prefix_words = self.r.prefix_words(term.use_prefix_db)
            for w in prefix_words:
                all_fids |= self.r.fids_by_word.get(w, set())
        if self.r.restricted_fids is not None:
            all_fids &= self.r.restricted_fids

        entries = []
        for fid in sorted(all_fids, key=lambda f: weight_map.get(f, 1 << 16)):
            weight = weight_map.get(fid)
            if weight is None:
                continue
            parts = [self.r.word_fid_docids(w, fid) for w in words + prefix_words]
            for p in phrases:
                first = next((w for w in p if w is not None), None)
                if first is not None:
                    wd = self.r.word_fid_docids(first, fid)
                    if len(wd):
                        parts.append(intersect(self.r.phrase_docids(p), wd))
            docids = union_many(parts)
            if len(docids):
                entries.append((docids, weight))
        self.r.arrays.cache[key] = entries
        return entries

    def _fid_addend(self, node: QueryNode, cls) -> np.ndarray:
        """Per-candidate attribute-rank cost (reference fid/mod.rs:build_edges
        + resolve_condition): min over matching fields of weight × term_count;
        INF when the document matches in no (allowed) field."""
        key = (node.node_id, cls)
        if key in self._fid_addend_cache:
            return self._fid_addend_cache[key]
        tlen = node.located.term_ids_len
        out = np.full(self.n, INF, dtype=np.int64)
        # ascending cost + first-write == min over matching fields, with
        # O(|posting|) slot scatters instead of an n-sized temp per entry
        for docids, weight in sorted(
            self._fid_entries(node.located.term, cls), key=lambda e: e[1]
        ):
            s = self.r.slots(docids)
            if len(s):
                sel = s[out[s] == INF]
                out[sel] = weight * tlen
        self._fid_addend_cache[key] = out
        return out

    def _pos_entries(self, term: QueryTerm, sel) -> list:
        """[(docids, bucket)] per position bucket, generation-cached (the
        bucket→cost mapping depends on the node's start position, applied
        by the caller)."""
        key = self._term_cache_key("hpos", term, sel)
        cached = self.r.arrays.cache.get(key)
        if cached is not None:
            return cached
        words = self._subset_words(term, sel)
        phrases = self._subset_phrases(term, sel)
        prefix_words: list[str] = []
        if self._uses_prefix_db(term, sel):
            prefix_words = self.r.prefix_words(term.use_prefix_db)

        buckets: set[int] = set()
        for w in words + prefix_words:
            buckets |= self.r.buckets_by_word.get(w, set())
        for p in phrases:
            first = next((w for w in p if w is not None), None)
            if first is not None:
                buckets |= self.r.buckets_by_word.get(first, set())

        entries = []
        for b in sorted(buckets):
            parts = [
                self.r.word_position_docids(w, b) for w in words + prefix_words
            ]
            for p in phrases:
                first = next((w for w in p if w is not None), None)
                if first is not None:
                    wd = self.r.word_position_docids(first, b)
                    if len(wd):
                        parts.append(intersect(self.r.phrase_docids(p), wd))
            docids = union_many(parts)
            if len(docids):
                entries.append((docids, b))
        self.r.arrays.cache[key] = entries
        return entries

    def _position_addend(self, node: QueryNode, cls) -> np.ndarray:
        """Per-candidate word-position cost (reference position/mod.rs)."""
        key = (node.node_id, cls)
        if key in self._pos_addend_cache:
            return self._pos_addend_cache[key]
        term = node.located.term
        tlen = node.located.term_ids_len
        start_pos = node.located.start_position

        def bucket_cost(bucket: int) -> int:
            distance = abs(bucket - start_pos)
            return sum(
                position_cost_from_distance(distance + i) for i in range(tlen)
            )

        by_cost: dict[int, list[np.ndarray]] = {}
        for docids, b in self._pos_entries(term, cls):
            by_cost.setdefault(bucket_cost(b), []).append(docids)

        out = np.full(self.n, INF, dtype=np.int64)
        for cost in sorted(by_cost):
            s = self.r.slots(union_many(by_cost[cost]))
            if len(s):
                sel = s[out[s] == INF]
                out[sel] = cost
        self._pos_addend_cache[key] = out
        return out

    def _exactness_addend(self, node: QueryNode) -> np.ndarray:
        """0 when the doc contains the exact original word/phrase, else
        term_count (reference exactness/mod.rs)."""
        key = node.node_id
        if key in self._exact_mask_cache:
            return self._exact_mask_cache[key]
        term = node.located.term
        tlen = node.located.term_ids_len
        docids = EMPTY
        if term.ngram_words is None:
            if term.phrase is not None:
                docids = self.r.phrase_docids(term.phrase)
            elif term.exact is not None:
                docids = self.r.word_docids(term.exact, original=True)
        m = self.r.mask(docids)
        out = np.where(m, np.int64(0), np.int64(tlen))
        self._exact_mask_cache[key] = out
        return out

    # -- proximity -------------------------------------------------------------

    def _subset_words(self, term: QueryTerm, sel) -> list[str]:
        """sel: None = full subsets, int = one typo class, "exact" = the
        exact-edge restriction (keep_only_exact_term)."""
        if sel == "exact":
            if term.ngram_words is None and term.phrase is None and term.exact:
                return [term.exact]
            return []
        classes = (
            range(0, term.max_typo_cost() + 1) if sel is None else [sel]
        )
        out: list[str] = []
        for c in classes:
            out.extend(w for w, _ in self.r.class_words(term, c))
        return out

    def _subset_phrases(self, term: QueryTerm, sel) -> list[Phrase]:
        if sel == "exact":
            return [term.phrase] if term.phrase is not None else []
        classes = (
            range(0, term.max_typo_cost() + 1) if sel is None else [sel]
        )
        out: list[Phrase] = []
        for c in classes:
            out.extend(self.r.class_phrases(term, c))
        return out

    def _uses_prefix_db(self, term: QueryTerm, sel) -> bool:
        if sel == "exact":
            return False
        return term.use_prefix_db is not None and (sel is None or sel == 0)

    def _last_words(self, term: QueryTerm, cls):
        """(phrase_or_None, last_word) pairs
        (reference proximity/compute_docids.rs:last_words_of_term_derivations)."""
        out = []
        for w in self._subset_words(term, cls):
            out.append((None, w))
        for p in self._subset_phrases(term, cls):
            last = p[-1]
            if last is not None:
                out.append((p, last))
        return out

    def _first_words(self, term: QueryTerm, cls):
        out = []
        for w in self._subset_words(term, cls):
            out.append((w, None))
        for p in self._subset_phrases(term, cls):
            first = p[0]
            if first is not None:
                out.append((first, p))
        return out

    def _pair_cost(
        self, left: QueryNode, cls_l: int, right: QueryNode, cls_r: int
    ) -> np.ndarray:
        """Per-candidate relative proximity cost in {0,1,2,3}
        (reference proximity/build.rs + compute_docids.rs)."""
        key = (left.node_id, cls_l, right.node_id, cls_r)
        if key in self._pair_cost_cache:
            return self._pair_cost_cache[key]

        lterm = left.located.term
        rterm = right.located.term

        masks = []
        for rel in (0, 1, 2):
            fwd = rel + 1
            bwd = rel
            parts: list = []
            # prefix-db right side
            if self._uses_prefix_db(rterm, cls_r):
                pwords = self.r.prefix_words(rterm.use_prefix_db)
                for lphrase, lw in self._last_words(lterm, cls_l):
                    constraint = (
                        self.r.phrase_docids(lphrase) if lphrase else None
                    )
                    if constraint is not None and not len(constraint):
                        continue
                    acc_parts = [
                        self.r.pair_proximity_docids(fwd, lw, w) for w in pwords
                    ]
                    if lphrase is None and bwd >= 1:
                        acc_parts.append(
                            self.r.pair_proximity_docids(
                                bwd, rterm.use_prefix_db, lw
                            )
                        )
                    acc = union_many(acc_parts)
                    if constraint is not None:
                        acc = intersect(acc, constraint)
                    parts.append(acc)
            for lphrase, lw in self._last_words(lterm, cls_l):
                for rw, rphrase in self._first_words(rterm, cls_r):
                    constraint = None
                    for p in (lphrase, rphrase):
                        if p is not None:
                            pd = self.r.phrase_docids(p)
                            constraint = (
                                pd if constraint is None else intersect(constraint, pd)
                            )
                    if constraint is not None and not len(constraint):
                        continue
                    acc_parts = [self.r.pair_proximity_docids(fwd, lw, rw)]
                    if bwd >= 1 and lphrase is None and rphrase is None:
                        acc_parts.append(self.r.pair_proximity_docids(bwd, rw, lw))
                    acc = union_many(acc_parts)
                    if constraint is not None:
                        acc = intersect(acc, constraint)
                    parts.append(acc)
            masks.append(self.r.mask(union_many(parts)))

        out = np.full(self.n, 3, dtype=np.int64)
        for rel in (2, 1, 0):
            out = np.where(masks[rel], np.int64(rel), out)
        self._pair_cost_cache[key] = out
        return out

    # -- the DP -----------------------------------------------------------------

    def _exact_edge_mask(self, node: QueryNode) -> np.ndarray:
        """Docids of the ExactInAttribute edge: the exact original word or
        phrase (reference exactness/mod.rs:compute_docids)."""
        key = ("edge", node.node_id)
        if key in self._exact_mask_cache:
            return self._exact_mask_cache[key]
        term = node.located.term
        docids = EMPTY
        if term.ngram_words is None:
            if term.phrase is not None:
                docids = self.r.phrase_docids(term.phrase)
            elif term.exact is not None:
                docids = self.r.word_docids(term.exact, original=True)
        m = self.r.mask(docids)
        self._exact_mask_cache[key] = m
        return m

    def _entry_cost(
        self,
        src_state,  # ("start",) | (node_id, cls, e) | ("skip", node_id)
        dst: QueryNode,
        cls: int,
        e: int,
    ) -> np.ndarray:
        """Cost vector (D, N) of entering (dst, cls, e) from src_state."""
        D = len(self.dims)
        out = np.zeros((D, self.n), dtype=np.int64)
        term = dst.located
        rnm = term.term_ids_len - 1

        if "typo" in self.dim_idx:
            out[self.dim_idx["typo"]] += self._typo_cost(dst, cls)
        if "proximity" in self.dim_idx:
            d = self.dim_idx["proximity"]
            sel_dst = self._sel("proximity", cls, e)
            adjacent = False
            sel_src = None
            if isinstance(src_state[0], int):
                src_node = self.graph.nodes[src_state[0]]
                adjacent = (
                    src_node.located.end_position + 1 == term.start_position
                )
                sel_src = self._sel("proximity", src_state[1], src_state[2])
            if adjacent:
                src_node = self.graph.nodes[src_state[0]]
                out[d] += self._pair_cost(src_node, sel_src, dst, sel_dst) + rnm
            else:
                out[d] += rnm
        if "fid" in self.dim_idx:
            out[self.dim_idx["fid"]] += self._fid_addend(
                dst, self._sel("fid", cls, e)
            )
        if "position" in self.dim_idx:
            out[self.dim_idx["position"]] += self._position_addend(
                dst, self._sel("position", cls, e)
            )
        if "exactness" in self.dim_idx:
            d = self.dim_idx["exactness"]
            if self.exact_flagged:
                if e:
                    # cost 0 via the ExactInAttribute edge; masked below
                    pass
                else:
                    out[d] += term.term_ids_len
            else:
                out[d] += self._exactness_addend(dst)

        # validity mask for the typo class (+ the exact edge if taken)
        ns = self.node_states[dst.node_id]
        m = ns.class_masks[ns.classes.index(cls)]
        if self.exact_flagged and e:
            m = m & self._exact_edge_mask(dst)
        out[0] = np.where(m, out[0], INF)
        return out

    # -- packed DP (bit-field encoding of the lexicographic cost) -------------

    def _entry_base(self, dst: QueryNode, cls: int, e: int) -> np.ndarray:
        """Src-independent part of the packed entry cost for (dst, cls, e):
        every dim's addend except the adjacent-pair proximity term, with the
        typo-class validity mask folded in as the packed INF sentinel."""
        key = (dst.node_id, cls, e)
        cached = self._entry_base_cache.get(key)
        if cached is not None:
            return cached
        term = dst.located
        rnm = term.term_ids_len - 1
        strides = self._strides
        base = np.zeros(self.n, dtype=np.int64)
        scalar = 0
        if "typo" in self.dim_idx:
            scalar += self._typo_cost(dst, cls) * strides["typo"]
        if "proximity" in self.dim_idx:
            scalar += rnm * strides["proximity"]
        if "fid" in self.dim_idx:
            a = self._fid_addend(dst, self._sel("fid", cls, e))
            a = np.where(a >= INF, np.int64(self._dim_inf["fid"]), a)
            base = base + a * strides["fid"]
        if "position" in self.dim_idx:
            a = self._position_addend(dst, self._sel("position", cls, e))
            a = np.where(a >= INF, np.int64(self._dim_inf["position"]), a)
            base = base + a * strides["position"]
        if "exactness" in self.dim_idx:
            if self.exact_flagged:
                if not e:
                    scalar += term.term_ids_len * strides["exactness"]
            else:
                base = base + self._exactness_addend(dst) * strides["exactness"]
        if scalar:
            base = base + scalar
        ns = self.node_states[dst.node_id]
        m = ns.class_masks[ns.classes.index(cls)]
        if self.exact_flagged and e:
            m = m & self._exact_edge_mask(dst)
        base = np.where(m, base, np.int64(self._pack_inf))
        self._entry_base_cache[key] = base
        return base

    def _run_packed(self, T) -> np.ndarray:
        """The same DP as `_run_with_threshold`, over (N,) packed costs."""
        order = sorted(
            self.graph.term_nodes(),
            key=lambda nd: (nd.located.start_term_id, nd.node_id),
        )
        dp: dict = {("start",): np.zeros(self.n, dtype=np.int64)}
        eflags = (0, 1) if self.exact_flagged else (0,)

        def get_states(node_id: int):
            if node_id == self.graph.root:
                return [("start",)]
            ns = self.node_states[node_id]
            states = [(node_id, c, e) for c in ns.classes for e in eflags]
            states.append(("skip", node_id))
            return states

        pstride = self._strides.get("proximity")
        wstride = self._strides.get("words")
        suffix_mode = T is None

        for node in order:
            ns = self.node_states[node.node_id]
            g = ns.removable_group
            if suffix_mode:
                visitable = True
                skippable = g is not None
            else:
                visitable = g is None or g >= T - 1
                skippable = g is not None and g < T

            pred_states = []
            for p in node.predecessors:
                for s in get_states(p):
                    if s in dp:
                        pred_states.append(s)
            if not pred_states:
                continue

            if visitable:
                visit_preds = (
                    [s for s in pred_states if s[0] != "skip"]
                    if suffix_mode and g is not None
                    else pred_states
                )
                for cls in ns.classes:
                    for e in eflags:
                        base = self._entry_base(node, cls, e)
                        best = None
                        for s in visit_preds:
                            add = base
                            if pstride is not None and isinstance(s[0], int):
                                src_node = self.graph.nodes[s[0]]
                                if (
                                    src_node.located.end_position + 1
                                    == node.located.start_position
                                ):
                                    pair = self._pair_cost(
                                        src_node,
                                        self._sel("proximity", s[1], s[2]),
                                        node,
                                        self._sel("proximity", cls, e),
                                    )
                                    add = base + pair * pstride
                            cand = dp[s] + add
                            best = (
                                cand if best is None else np.minimum(best, cand)
                            )
                        if best is not None:
                            dp[(node.node_id, cls, e)] = best
            if skippable:
                skip_scalar = (
                    node.located.term_ids_len * wstride
                    if wstride is not None
                    else 0
                )
                best = None
                for s in pred_states:
                    cand = dp[s] + skip_scalar
                    best = cand if best is None else np.minimum(best, cand)
                dp[("skip", node.node_id)] = best

        end_preds = self.graph.nodes[self.graph.end].predecessors
        best = None
        for p in end_preds:
            for s in get_states(p):
                if s in dp:
                    best = dp[s] if best is None else np.minimum(best, dp[s])
        if best is None:
            best = np.full(self.n, self._pack_inf, dtype=np.int64)
        return best

    def _unpack(self, packed: np.ndarray) -> np.ndarray:
        D = len(self.dims)
        out = np.empty((D, self.n), dtype=np.int64)
        invalid = packed >= self._pack_inf
        rem = np.where(invalid, np.int64(0), packed)
        for i, d in enumerate(self.dims):
            st = self._strides[d]
            v = rem // st
            rem = rem - v * st
            inf_d = self._dim_inf.get(d)
            if inf_d is not None:
                v = np.where(v >= inf_d, np.int64(INF), v)
            out[i] = v
        out[:, invalid] = INF
        return out

    @staticmethod
    def _lexmin(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Elementwise lexicographic min of two (D, N) matrices."""
        D = a.shape[0]
        lt = np.zeros(a.shape[1], dtype=bool)
        eq = np.ones(a.shape[1], dtype=bool)
        for d in range(D):
            lt |= eq & (a[d] < b[d])
            eq &= a[d] == b[d]
        return np.where(lt[None, :], a, b)

    # -- score normalization ---------------------------------------------------

    def _node_resolves(self, node: QueryNode) -> bool:
        """Whether the node's term matches ANY candidate in the universe —
        i.e. whether it can sit on a good path of the words rule and so
        survive into the bucket graphs of the downstream rules."""
        key = ("resolves", node.node_id)
        if key not in self._exact_mask_cache:
            ns = self.node_states.get(node.node_id)
            self._exact_mask_cache[key] = bool(ns) and any(
                m.any() for m in ns.class_masks
            )
        return self._exact_mask_cache[key]

    def max_cost(self, dim: str, k: int) -> int:
        """Maximum path cost for one rule over the first-k-terms subgraph
        (reference: graph_based_ranking_rule.rs:144 next_max_cost — the
        successor of this value is the rule's max_rank)."""
        key = ("maxcost", dim, k)
        if key in self._exact_mask_cache:
            return self._exact_mask_cache[key]

        def removable(node) -> bool:
            ns = self.node_states.get(node.node_id)
            return bool(ns) and ns.removable_group is not None

        best_end = graph_max_cost(
            self.graph, self.store, self.strategy, dim, k,
            self._node_resolves, removable,
        )
        self._exact_mask_cache[key] = best_end
        return best_end

    DEFAULT_DIMS = ["words", "typo", "proximity", "fid", "position", "exactness"]

    def device_compatible(self) -> bool:
        """Whether this query maps to the fused device chain kernel
        (ops/device_scorer.py): `last` strategy, default rule order, 1-gram
        chain with no live ngram/phrase alternatives."""
        if self.strategy != "last" or self.exact_flagged:
            return False
        if self.dims != self.DEFAULT_DIMS:
            return False
        for node in self.graph.term_nodes():
            term = node.located.term
            if node.located.term_ids_len > 1:
                ns = self.node_states[node.node_id]
                if term.use_prefix_db is not None or any(
                    m.any() for m in ns.class_masks
                ):
                    return False
            elif term.phrase is not None:
                return False
        return True

    def _chain_tensors(self, width: int | None = None):
        """The dense chain tensors over the candidate axis, `width` columns
        wide (default N; pad columns match no term, at INF costs), or None
        when the query is not chain-compatible. Shared by run_device
        (single-chip cost matrix) and build_chain_inputs (sharded top-k)."""
        if self.n == 0 or not self.device_compatible():
            return None
        chain = sorted(
            (
                n
                for n in self.graph.term_nodes()
                if n.located.term_ids_len == 1
            ),
            key=lambda nd: nd.located.start_term_id,
        )
        T = len(chain)
        if T == 0 or T > 16:
            return None
        C = 3
        N = self.n
        W = N if width is None else width
        class_mask = np.zeros((T, C, W), dtype=bool)
        fid_cost = np.full((T, C, W), int(INF), dtype=np.int32)
        pos_cost = np.full((T, C, W), int(INF), dtype=np.int32)
        exact_cost = np.zeros((T, W), dtype=np.int32)
        pair_cost = np.zeros((max(T - 1, 1), C, C, W), dtype=np.int8)
        for t, node in enumerate(chain):
            ns = self.node_states[node.node_id]
            for cls in ns.classes:
                class_mask[t, cls, :N] = ns.class_masks[ns.classes.index(cls)]
                fid_cost[t, cls, :N] = np.minimum(
                    self._fid_addend(node, self._sel("fid", cls, 0)), int(INF)
                )
                pos_cost[t, cls, :N] = np.minimum(
                    self._position_addend(node, self._sel("position", cls, 0)),
                    int(INF),
                )
            exact_cost[t, :N] = self._exactness_addend(node)
            if t > 0:
                left = chain[t - 1]
                adjacent = (
                    left.located.end_position + 1 == node.located.start_position
                )
                if adjacent:
                    for c1 in range(C):
                        if c1 not in self.node_states[left.node_id].classes:
                            continue
                        for c2 in ns.classes:
                            pair_cost[t - 1, c1, c2, :N] = self._pair_cost(
                                left,
                                self._sel("proximity", c1, 0),
                                node,
                                self._sel("proximity", c2, 0),
                            ).astype(np.int8)
                # non-adjacent pairs stay 0 (the free term edge)
        return class_mask, pair_cost, fid_cost, pos_cost, exact_cost

    def build_chain_inputs(self, pad_multiple: int = 1):
        """Inputs for ops.device_scorer.chain_query_topk over REAL store
        candidates: (class_mask, pair_cost, fid_cost, pos_cost, exact_mask,
        docids, valid), the candidate axis padded to a multiple of
        `pad_multiple` so a mesh can shard it evenly. Returns None when the
        query is not chain-compatible."""
        tensors = self._chain_tensors()
        if tensors is None:
            return None
        class_mask, pair_cost, fid_cost, pos_cost, exact_cost = tensors
        N = self.n
        # chain nodes all have term_ids_len == 1, so the exactness addend is
        # 0 (doc has the exact original word) or 1 — exactly the kernel's
        # exact_pen encoding
        exact_mask = exact_cost == 0
        docids = np.asarray(self.r.candidates, dtype=np.int32)
        n_pad = -(-max(N, 1) // pad_multiple) * pad_multiple
        if n_pad != N:
            pad = n_pad - N
            class_mask = np.pad(class_mask, ((0, 0), (0, 0), (0, pad)))
            fid_cost = np.pad(
                fid_cost, ((0, 0), (0, 0), (0, pad)), constant_values=int(INF)
            )
            pos_cost = np.pad(
                pos_cost, ((0, 0), (0, 0), (0, pad)), constant_values=int(INF)
            )
            exact_mask = np.pad(exact_mask, ((0, 0), (0, pad)))
            pair_cost = np.pad(pair_cost, ((0, 0), (0, 0), (0, 0), (0, pad)))
            docids = np.pad(docids, (0, pad))
        valid = np.zeros(n_pad, dtype=bool)
        valid[:N] = True
        return (
            class_mask,
            pair_cost,
            fid_cost,
            pos_cost,
            exact_mask,
            docids,
            valid,
        )

    def run_device(self):
        """Build the chain tensors and run the DP (K6, cost mode) on the
        store's device: the card's kernel, or its plain torch version
        when the store has no device (`store.device` None: the CPU, as
        the caller asked). Returns the (D, N) cost matrix or None when
        the query is not chain-compatible."""
        from ..ops.device_scorer import aligned_width, chain_cost_matrix

        # the candidate axis padded to the kernel's bulk-path stride (the
        # JAX package padded it to a power of two so XLA would compile
        # fewer programs); the kernel computes the first N columns only
        tensors = self._chain_tensors(aligned_width(self.n))
        if tensors is None:
            return None
        import torch

        device = self.store.device or torch.device("cpu")
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in tensors]
        out = chain_cost_matrix(*args, n=self.n).cpu().numpy().astype(np.int64)
        return np.where(out >= int(INF), int(INF), out)


    def run(self) -> np.ndarray:
        """Returns the (D, N) cost matrix (INF where no interpretation)."""
        kind, data = self.run_raw()
        if kind == "packed":
            return self._unpack(data)
        return data

    def run_raw(self):
        """("packed", (N,) bit-field key) when the packed DP ran — the key IS
        the lexicographic sort key — else ("matrix", (D, N) cost matrix)."""
        if self.n and self._packed_ok:
            if self.strategy == "last":
                packed = self._run_packed(None)
            else:
                packed = None
                thresholds = (
                    range(self.n_groups + 1)
                    if self.strategy != "all"
                    else range(1)
                )
                for T in thresholds:
                    res = self._run_packed(T)
                    packed = res if packed is None else np.minimum(packed, res)
            return "packed", packed
        return "matrix", self._run_matrix()

    def _run_matrix(self) -> np.ndarray:
        if self.n == 0:
            return np.zeros((len(self.dims), 0), dtype=np.int64)
        if self.strategy == "last":
            # `last` drops suffixes only: one DP with a skip mode suffices
            # (removal-group order is monotone in term position, so once a
            # node is skipped every later node must be skipped too)
            return self._run_with_threshold(None)
        best: Optional[np.ndarray] = None
        thresholds = (
            range(self.n_groups + 1) if self.strategy != "all" else range(1)
        )
        for T in thresholds:
            res = self._run_with_threshold(T)
            best = res if best is None else self._lexmin(best, res)
        return best

    def _run_with_threshold(self, T) -> np.ndarray:
        """One DP where nodes in removal groups < T may be skipped and nodes
        in groups < T-1 may NOT be visited (max_skip <= min_visit invariant,
        reference cheapest_paths.rs nodes_to_skip).

        T=None runs the `last`-strategy suffix-mode DP: every node is
        visitable, every removable node is skippable, but skip states never
        feed back into visit states."""
        D = len(self.dims)
        order = sorted(
            self.graph.term_nodes(),
            key=lambda nd: (nd.located.start_term_id, nd.node_id),
        )
        dp: dict = {("start",): np.zeros((D, self.n), dtype=np.int64)}

        eflags = (0, 1) if self.exact_flagged else (0,)

        def get_states(node_id: int):
            """All DP states of a predecessor node (or START)."""
            if node_id == self.graph.root:
                return [("start",)]
            ns = self.node_states[node_id]
            states = [(node_id, c, e) for c in ns.classes for e in eflags]
            states.append(("skip", node_id))
            return states

        words_dim = self.dim_idx.get("words")

        suffix_mode = T is None

        for node in order:
            ns = self.node_states[node.node_id]
            g = ns.removable_group
            if suffix_mode:
                visitable = True
                skippable = g is not None
            else:
                visitable = g is None or g >= T - 1
                skippable = g is not None and g < T

            preds = node.predecessors
            pred_states = []
            for p in preds:
                for s in get_states(p):
                    if s in dp:
                        pred_states.append(s)
            if not pred_states:
                continue

            if visitable:
                # in suffix mode a REMOVABLE node may not be visited after a
                # skip; mandatory/phrase nodes (no removal group) always may
                visit_preds = (
                    [s for s in pred_states if s[0] != "skip"]
                    if suffix_mode and g is not None
                    else pred_states
                )
                for cls in ns.classes:
                    for e in eflags:
                        best = None
                        for s in visit_preds:
                            cand = dp[s] + self._entry_cost(s, node, cls, e)
                            best = (
                                cand if best is None else self._lexmin(best, cand)
                            )
                        if best is not None:
                            dp[(node.node_id, cls, e)] = best
            if skippable:
                skip_cost = np.zeros((D, self.n), dtype=np.int64)
                if words_dim is not None:
                    skip_cost[words_dim] += node.located.term_ids_len
                best = None
                for s in pred_states:
                    cand = dp[s] + skip_cost
                    best = cand if best is None else self._lexmin(best, cand)
                dp[("skip", node.node_id)] = best

        # END
        end_preds = self.graph.nodes[self.graph.end].predecessors
        best = None
        for p in end_preds:
            for s in get_states(p):
                if s in dp:
                    cand = dp[s]
                    best = cand if best is None else self._lexmin(best, cand)
        if best is None:
            best = np.full((D, self.n), INF, dtype=np.int64)
        # clamp anything that went through an INF mask
        best = np.where(best >= INF, INF, best)
        return best
