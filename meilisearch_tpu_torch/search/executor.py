"""Search execution.

Port of the reference's query pipeline:
  milli Search::execute            (search/mod.rs:280)
  execute_search                   (search/new/mod.rs:812)
  rule assembly                    (search/new/mod.rs:509 get_ranking_rules_*)
  resolve_universe                 (search/new/mod.rs:304)
  ExactAttribute                   (search/new/exact_attribute.rs)
  Sort / GeoSort                   (search/new/sort.rs, geo_sort.rs)
  distinct                         (search/new/distinct.rs)

Instead of the reference's lazy bucket descent, the assembled rule list maps
to columns of a cost matrix (FusedScorer for graph rules; per-document keys
for sort/geo/exact-attribute) and the final ranking is one lexicographic sort
— identical ordering, TPU-friendly shape.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field
from typing import Optional

import numpy as np

from ..index.arrays import (
    EMPTY,
    difference,
    docids_array as _docids_array,
    filtered_universe,
    intersect,
    to_array,
    union_many,
)
from ..index.store import IndexStore, bucketed_position
from ..types.errors import EngineError, ErrorCode
from .graph import QueryGraph
from .query_terms import (
    DerivationContext,
    located_query_terms_from_tokens,
)
from .scorer import INF, FusedScorer, Resolver


@dataclass
class SearchResult:
    documents_ids: list[int]
    candidates: set  # all candidates (for estimatedTotalHits)
    degraded: bool = False
    query_terms: Optional[list] = None
    scores: list = dc_field(default_factory=list)  # aligned with documents_ids
    # global ranking score per docid for the whole ranked list (hybrid merge)
    scores_by_docid: dict = dc_field(default_factory=dict)
    details_by_docid: dict = dc_field(default_factory=dict)
    # device-batch path: exact match count (candidates holds only top-K)
    total_hits: Optional[int] = None
    # device-batch path: full candidate set as a (D,) bool mask, fetched
    # from the kernel's device-resident packed bitmap only when the query
    # needs full-candidate semantics (facet distribution)
    candidates_mask: Optional[np.ndarray] = None


def merge_ranks(ranks: list[tuple[int, int]]) -> float:
    """Reference: score_details.rs:529 Rank::global_score / merge."""
    r, m = 1, 1
    for ri, mi in ranks:
        r = (r - 1) * mi + ri
        m *= mi
    return r / m if m else 1.0


@dataclass
class Search:
    store: IndexStore
    query: Optional[str] = None
    filter_docids: Optional[set] = None  # pre-evaluated filter universe
    offset: int = 0
    limit: int = 20
    sort_criteria: Optional[list[str]] = None
    distinct: Optional[str] = None
    terms_matching_strategy: str = "last"  # last | all | frequency
    attributes_to_search_on: Optional[list[str]] = None
    exhaustive_number_hits: bool = False
    max_total_hits: Optional[int] = None
    locales: Optional[list[str]] = None
    compute_scores: bool = False
    compute_score_details: bool = False
    # drop every document whose global ranking score is below this
    # (reference bucket_sort.rs ranking-score-threshold handling: hits AND
    # exhaustive totals shrink)
    ranking_score_threshold: Optional[float] = None
    cutoff_ms: Optional[int] = None
    # test-only hook mirroring the reference's
    # `Deadline::never().with_stop_after(n)` (lib.rs:203,211): run the
    # bucket-sort loop emulation and stop after n `exceeded()` calls,
    # yielding the reference's mid-flight degraded semantics (which rules
    # report Skipped at a partial budget, and the partial ordering).
    # Pinned by tests/golden/test_cutoff.py against cutoff.rs snapshots.
    stop_after: Optional[int] = None
    # requested facet fields (perform layer); the host executor ignores
    # this (facet distribution reads result.candidates), but the device
    # batch uses it to fetch the full candidate bitmap for those queries
    facets: Optional[list] = None

    # ------------------------------------------------------------------

    def execute(self) -> SearchResult:
        import time as _time

        store = self.store
        settings = store.settings
        cutoff = (
            self.cutoff_ms
            if self.cutoff_ms is not None
            else settings.search_cutoff_ms
        )
        self._deadline = (
            _time.perf_counter() + cutoff / 1000.0 if cutoff is not None else None
        )

        from ..utils.tracing import span

        self._check_sort_criteria()

        # the universe lives as a sorted docid array from here on (the host
        # mirror of the device candidate axis)
        with span("search::universe"):
            universe = _docids_array(store)
            if self.filter_docids is not None:
                universe = filtered_universe(store, self.filter_docids)

        restricted_fids = self._restricted_fids()

        has_query = bool(self.query and self.query.strip())
        terms = []
        negative_words: list[str] = []
        negative_phrases: list = []
        if has_query:
            ctx = DerivationContext(store, settings)
            qlocales = self.locales
            if qlocales is None:
                # auto-infer from localizedAttributes over the searched
                # attributes (reference locales.rs auto_infer_*: a query
                # without `locales` inherits the rules' allow-list)
                qlocales = settings.infer_search_locales(
                    self.attributes_to_search_on
                )
            tokenizer = store.make_tokenizer(qlocales)
            extracted = located_query_terms_from_tokens(
                ctx, tokenizer, self.query
            )
            terms = [t for t in extracted.query_terms]
            negative_words = extracted.negative_words
            negative_phrases = extracted.negative_phrases

        resolver = Resolver(
            store, np.zeros(0, dtype=np.int64), restricted_fids
        )

        # negative words/phrases shrink the universe
        # (reference: search/new/mod.rs:323 resolve_negative_words/_phrases)
        for w in negative_words:
            universe = difference(universe, resolver.word_docids(w, original=True))
        for p in negative_phrases:
            universe = difference(universe, resolver.phrase_docids(p))

        # dynamic search rules: resolve pins, exclude pinned docs from the
        # organic ranking (reference: dynamic_search_rules.rs resolve_pins)
        self._pins = []
        rules = getattr(store, "dynamic_rules", None)
        if rules is not None and rules.rules:
            query_words = [t.term.original for t in terms]
            self._pins = rules.resolve_pins(store, query_words, not terms)
            if self._pins:
                universe = difference(
                    universe, to_array({d for _p, d in self._pins})
                )

        if has_query and terms:
            with span("search::query", q=self.query):
                return self._execute_query_graph(
                    universe, terms, resolver, restricted_fids
                )
        with span("search::placeholder"):
            return self._execute_placeholder(universe)

    def _check_sort_criteria(self):
        """Reference: search/new/mod.rs:998 check_sort_criteria."""
        if not self.sort_criteria:
            return
        settings = self.store.settings
        if "sort" not in settings.ranking_rules:
            raise EngineError(
                ErrorCode.INVALID_SEARCH_SORT,
                "You must specify where `sort` is listed in the rankingRules"
                " setting to use the sort parameter at search time.",
            )
        sortable = set(settings.sortable_attributes)
        for criterion in self.sort_criteria:
            member, _asc = _parse_asc_desc(criterion)
            if isinstance(member, tuple):
                if "_geo" not in sortable:
                    raise EngineError(
                        ErrorCode.INVALID_SEARCH_SORT,
                        "Attribute `_geo` is not sortable. Available sortable"
                        f" attributes are: `{', '.join(sorted(sortable)) or ''}`.",
                    )
            elif not any(
                member == s or member.startswith(s + ".") for s in sortable
            ):
                raise EngineError(
                    ErrorCode.INVALID_SEARCH_SORT,
                    f"Attribute `{member}` is not sortable. Available sortable"
                    f" attributes are: `{', '.join(sorted(sortable)) or ''}`.",
                )

    # -- rule assembly -------------------------------------------------------

    def _assembled_rules(self, for_query: bool) -> list[tuple]:
        """Returns an ordered list of rule descriptors:
        ("graph", name) | ("sort_field", field, asc) | ("geo", lat, lng, asc)
        | ("exact_attribute",)

        Reference: search/new/mod.rs:510 get_ranking_rules_for_query_graph_search
        and :353 get_ranking_rules_for_placeholder_search.
        """
        settings = self.store.settings
        out: list[tuple] = []
        words = typo = proximity = sort = attribute = False
        attribute_rank = word_position = exactness = False
        sorted_fields: set[str] = set()
        geo_sorted = False

        if self.terms_matching_strategy == "all":
            words = True

        def push_sort_criteria():
            nonlocal geo_sorted
            for criterion in self.sort_criteria or []:
                member, asc = _parse_asc_desc(criterion)
                if isinstance(member, tuple):  # geo point
                    if geo_sorted:
                        continue
                    geo_sorted = True
                    out.append(("geo", member[0], member[1], asc))
                else:
                    if member in sorted_fields:
                        continue
                    sorted_fields.add(member)
                    out.append(("sort_field", member, asc))

        for rr in settings.ranking_rules:
            if for_query and rr in (
                "typo",
                "attribute",
                "attributeRank",
                "wordPosition",
                "proximity",
                "exactness",
            ):
                if not words:
                    out.append(("graph", "words"))
                    words = True
            if rr == "words":
                if for_query and not words:
                    out.append(("graph", "words"))
                    words = True
            elif rr == "typo":
                if for_query and not typo:
                    out.append(("graph", "typo"))
                    typo = True
            elif rr == "proximity":
                if for_query and not proximity:
                    out.append(("graph", "proximity"))
                    proximity = True
            elif rr == "attribute":
                if for_query and not (attribute or attribute_rank or word_position):
                    attribute = True
                    out.append(("graph", "fid"))
                    out.append(("graph", "position"))
            elif rr == "attributeRank":
                if for_query and not (attribute or attribute_rank):
                    attribute_rank = True
                    out.append(("graph", "fid"))
            elif rr == "wordPosition":
                if for_query and not (attribute or word_position):
                    word_position = True
                    out.append(("graph", "position"))
            elif rr == "sort":
                if sort:
                    continue
                push_sort_criteria()
                sort = True
            elif rr == "exactness":
                if for_query and not exactness:
                    out.append(("exact_attribute",))
                    out.append(("graph", "exactness"))
                    exactness = True
            else:
                member, asc = _parse_asc_desc(rr)
                if isinstance(member, str) and member not in sorted_fields:
                    sorted_fields.add(member)
                    out.append(("sort_field", member, asc))
        return out

    # -- placeholder search ----------------------------------------------------

    def _execute_placeholder(self, universe: np.ndarray) -> SearchResult:
        rules = self._assembled_rules(for_query=False)
        candidates = universe
        keys = []
        for rule in rules:
            keys.extend(self._rule_key_rows(rule, candidates, None))
        order = _lexsort_rows(keys, candidates)
        ranked = candidates[order]
        return self._paginate(ranked, universe)

    # -- query-graph search -----------------------------------------------------

    def _execute_query_graph(
        self,
        universe: set,
        terms: list,
        resolver: Resolver,
        restricted_fids,
    ) -> SearchResult:
        store = self.store
        ctx = DerivationContext(store, store.settings)
        graph = QueryGraph.from_terms(ctx, terms)

        universe = self._resolve_universe(graph, universe, resolver)
        candidates = universe

        rules = self._assembled_rules(for_query=True)
        graph_dims = [r[1] for r in rules if r[0] == "graph"]

        degraded = False
        packed_key = None
        if graph_dims and self._deadline_exceeded():
            # degraded search (reference: bucket_sort.rs:206 deadline path —
            # remaining rules are Skipped): rank by docid only
            degraded = True
            cost = np.zeros((len(graph_dims), len(candidates)), dtype=np.int64)
            scorer = None
        elif graph_dims:
            mask_resolver = Resolver(store, candidates, restricted_fids)
            mask_resolver._phrase_cache = resolver._phrase_cache
            scorer = FusedScorer(
                store, mask_resolver, graph, self.terms_matching_strategy, graph_dims
            )
            cost = None
            if _device_scorer_enabled():
                cost = scorer.run_device()
            if cost is None:
                kind, data = scorer.run_raw()
                if kind == "packed":
                    packed_key = data
                else:
                    cost = data
        else:
            scorer = None
            cost = np.zeros((0, len(candidates)), dtype=np.int64)

        sortable = all(r[0] in ("graph", "exact_attribute") for r in rules)
        if (
            packed_key is not None
            and sortable
            and not degraded
            and self.stop_after is None
        ):
            return self._finish_packed(
                rules, graph, graph_dims, scorer, packed_key, candidates,
                degraded,
            )
        if packed_key is not None:
            cost = scorer._unpack(packed_key)

        # per-doc words level: how many leading terms the doc's best
        # interpretation kept (drives the ExactAttribute sub-query,
        # reference: bucket refinement passes the reduced graph down)
        n_term_ids = graph.n_term_ids()
        if "words" in graph_dims:
            wrow = cost[graph_dims.index("words")]
            ea_levels = np.maximum(n_term_ids - wrow, 0).astype(np.int64)
        else:
            ea_levels = np.full(len(candidates), n_term_ids, dtype=np.int64)

        # assemble full key matrix in rule order; rule_spans maps each
        # rule to its contiguous slice of key rows (the stop_after walk
        # groups buckets per RULE, not per row)
        keys: list[np.ndarray] = []
        rule_spans: list[tuple[int, int]] = []
        ea_row = None
        gi = 0
        for rule in rules:
            start = len(keys)
            if rule[0] == "graph":
                keys.append(cost[gi].astype(np.float64))
                gi += 1
            elif rule[0] == "exact_attribute":
                ea_row = self._exact_attribute_row(candidates, graph, ea_levels)
                keys.append(ea_row)
            else:
                keys.extend(self._rule_key_rows(rule, candidates, graph))
            rule_spans.append((start, len(keys)))

        # docs with no valid interpretation are dropped (defensive; the
        # universe resolution should exclude them already)
        valid = np.ones(len(candidates), dtype=bool)
        if graph_dims:
            valid = cost[0] < INF

        if self.stop_after is not None and not degraded:
            return self._execute_stop_after(
                rules,
                rule_spans,
                keys,
                candidates,
                valid,
                cost,
                ea_levels,
                ea_row,
                scorer,
                graph,
            )

        order = _lexsort_rows([k[valid] for k in keys], candidates[valid])
        ranked = candidates[valid][order]

        self._located_terms = [n.located for n in graph.term_nodes()]

        scores_by_docid: dict = {}
        details_by_docid: dict = {}
        if self.compute_scores and len(ranked) and not degraded:
            scores_by_docid = self._compute_global_scores(
                rules,
                cost[:, valid][:, order],
                ea_levels[valid][order],
                ea_row[valid][order] if ea_row is not None else None,
                ranked,
                scorer if graph_dims else None,
            )
            if self.compute_score_details:
                details_by_docid = self._compute_score_details(
                    rules,
                    cost[:, valid][:, order],
                    ea_levels[valid][order],
                    ea_row[valid][order] if ea_row is not None else None,
                    ranked,
                    scorer if graph_dims else None,
                )
        ranked, cand_total = self._apply_score_threshold(
            ranked, candidates[valid], scores_by_docid
        )
        result = self._paginate(ranked, cand_total, scores_by_docid)
        result.degraded = degraded
        result.details_by_docid = {
            **details_by_docid,
            **getattr(self, "_pin_details", {}),
        }
        if degraded and self.compute_scores:
            # every rule was skipped past the deadline (reference
            # score_details.rs:403 Skipped => {"skipped": {"order": 0}},
            # rank 0 of 1 => global score 0)
            result.scores_by_docid = {d: 0.0 for d in result.documents_ids}
            result.scores = [0.0 for _ in result.documents_ids]
            if self.compute_score_details:
                result.details_by_docid = {
                    d: {"skipped": {"order": 0}}
                    for d in result.documents_ids
                }
        return result

    def _execute_stop_after(
        self,
        rules,
        rule_spans,
        keys,
        candidates,
        valid,
        cost,
        ea_levels,
        ea_row,
        scorer,
        graph,
    ) -> SearchResult:
        """Reference-exact emulation of the bucket_sort loop under
        `Deadline::never().with_stop_after(n)` (bucket_sort.rs:193-265,
        lib.rs:203-219): `exceeded()` is called once per loop pass over a
        non-empty sub-universe and trips on the (n+1)-th call; the
        empty-universe backtrack does not consume a call; on tripping,
        every level from the current rule up to rule 0 emits its
        remaining universe as a bucket with `Skipped` appended to the
        score prefix (graph rules are always Pending in non-blocking
        mode — resolve_query_graph ignores the deadline internally).
        Runs the Detailed scoring strategy, as the reference cutoff.rs
        suite does. Pinned by tests/golden/test_cutoff.py."""
        cand_v = candidates[valid]
        rows = [k[valid] for k in keys]
        n_rules = len(rules)
        window = self.offset + self.limit
        stop_after = int(self.stop_after)

        calls = 0

        def exceeded() -> bool:
            nonlocal calls
            calls += 1
            return calls > stop_after

        def rule_bucket(ri: int, U: np.ndarray):
            """Split U (ascending positions) into the bucket achieving the
            lexicographic minimum of rule ri's key rows, and the rest."""
            sel = U
            for r in range(*rule_spans[ri]):
                row = rows[r][sel]
                sel = sel[row == row.min()]
            rest = U[~np.isin(U, sel, assume_unique=True)]
            return sel, rest

        universes: list = [None] * max(n_rules, 1)
        universes[0] = np.arange(len(cand_v))
        cur = 0
        # (position, depth, skipped): depth = number of rules whose score
        # applies to this doc; skipped = a Skipped entry follows
        out: list[tuple[int, int, bool]] = []
        degraded = False

        while len(out) < window:
            U = universes[cur]
            if U is None or len(U) == 0:
                universes[cur] = None
                if cur == 0:
                    break
                cur -= 1
                continue
            if exceeded():
                degraded = True
                while True:
                    U = universes[cur]
                    if U is not None and len(U):
                        for p in U.tolist():
                            if len(out) < window:
                                out.append((p, cur, True))
                    universes[cur] = None
                    if cur == 0:
                        break
                    cur -= 1
                break
            bucket, rest = rule_bucket(cur, U)
            universes[cur] = rest
            if cur == n_rules - 1:
                for p in bucket.tolist():
                    if len(out) < window:
                        out.append((p, n_rules, False))
            else:
                cur += 1
                universes[cur] = bucket

        pos = np.array([p for p, _d, _s in out], dtype=np.int64)
        ranked = cand_v[pos] if len(pos) else cand_v[:0]
        self._located_terms = [n.located for n in graph.term_nodes()]

        cost_sorted = cost[:, valid][:, pos] if cost is not None else None
        levels_sorted = ea_levels[valid][pos]
        ea_sorted = ea_row[valid][pos] if ea_row is not None else None

        scores_by_docid: dict = {}
        details_by_docid: dict = {}
        if self.compute_scores and len(ranked):
            max_cache: dict = {}
            for i, (_p, depth, skipped) in enumerate(out):
                docid = int(ranked[i])
                k = int(levels_sorted[i]) if len(levels_sorted) else 0
                ranks: list[tuple[int, int]] = []
                gi = 0
                for rule in rules[:depth]:
                    if rule[0] == "graph":
                        dim = rule[1]
                        ckey = (dim, k)
                        if ckey not in max_cache:
                            max_cache[ckey] = (
                                scorer.max_cost(dim, k) if scorer else 0
                            )
                        next_max = max_cache[ckey] + 1
                        costv = int(cost_sorted[gi, i])
                        rank = min(max(next_max - costv, 1), next_max)
                        ranks.append((rank, next_max))
                        gi += 1
                    elif rule[0] == "exact_attribute" and ea_sorted is not None:
                        ranks.append((3 - int(ea_sorted[i]), 3))
                if skipped:
                    # ScoreDetails::Skipped => Rank { rank: 0, max_rank: 1 }
                    # (score_details.rs:122)
                    ranks.append((0, 1))
                scores_by_docid[docid] = merge_ranks(ranks)
            if self.compute_score_details:
                by_depth: dict[tuple[int, bool], list[int]] = {}
                for i, (_p, depth, skipped) in enumerate(out):
                    by_depth.setdefault((depth, skipped), []).append(i)
                for (depth, skipped), idxs in by_depth.items():
                    ii = np.array(idxs, dtype=np.int64)
                    det = self._compute_score_details(
                        rules[:depth],
                        cost_sorted[:, ii] if cost_sorted is not None else None,
                        levels_sorted[ii],
                        ea_sorted[ii] if ea_sorted is not None else None,
                        ranked[ii],
                        scorer,
                    )
                    for docid, d in det.items():
                        if skipped:
                            nxt = 1 + max(
                                (e.get("order", 0) for e in d.values()),
                                default=-1,
                            )
                            d["skipped"] = {"order": nxt}
                        details_by_docid[docid] = d

        result = self._paginate(ranked, candidates[valid], scores_by_docid)
        result.degraded = degraded
        result.details_by_docid = {
            **details_by_docid,
            **getattr(self, "_pin_details", {}),
        }
        return result

    def _finish_packed(
        self, rules, graph, graph_dims, scorer, packed_key, candidates,
        degraded,
    ) -> SearchResult:
        """Fast finish when every rule is a bit field of the packed DP key:
        the exact-attribute rank is spliced into the key at its rule position
        and one stable argsort replaces the float lexsort."""
        valid = packed_key < scorer._pack_inf
        cand_v = candidates[valid]
        key_v = packed_key[valid]

        n_term_ids = graph.n_term_ids()
        if "words" in scorer.dim_idx:
            st_w = scorer._strides["words"]
            cap_w = scorer._caps["words"]
            wrow = (key_v // st_w) % cap_w
            ea_levels = np.maximum(n_term_ids - wrow, 0).astype(np.int64)
        else:
            ea_levels = np.full(len(cand_v), n_term_ids, dtype=np.int64)

        ea_row = None
        g_before = 0
        for rule in rules:
            if rule[0] == "graph":
                g_before += 1
            elif rule[0] == "exact_attribute":
                ea_row = self._exact_attribute_row(cand_v, graph, ea_levels)
                # splice the 3-valued EA rank between the dims before and
                # after it in rule order (g_before >= 1: words precedes it)
                boundary = scorer._strides[graph_dims[g_before - 1]]
                hi = key_v // boundary
                lo = key_v - hi * boundary
                key_v = (
                    hi * (3 * boundary)
                    + ea_row.astype(np.int64) * boundary
                    + lo
                )
                break

        order = np.argsort(key_v, kind="stable")
        ranked = cand_v[order]

        self._located_terms = [n.located for n in graph.term_nodes()]

        scores_by_docid: dict = {}
        details_by_docid: dict = {}
        if self.compute_scores and len(ranked):
            cost = scorer._unpack(packed_key)
            cost_sorted = cost[:, valid][:, order]
            levels_sorted = ea_levels[order]
            ea_sorted = ea_row[order] if ea_row is not None else None
            scores_by_docid = self._compute_global_scores(
                rules, cost_sorted, levels_sorted, ea_sorted, ranked, scorer
            )
            if self.compute_score_details:
                details_by_docid = self._compute_score_details(
                    rules, cost_sorted, levels_sorted, ea_sorted, ranked,
                    scorer,
                )
        ranked, cand_v = self._apply_score_threshold(
            ranked, cand_v, scores_by_docid
        )
        result = self._paginate(ranked, cand_v, scores_by_docid)
        result.degraded = degraded
        result.details_by_docid = {
            **details_by_docid,
            **getattr(self, "_pin_details", {}),
        }
        return result

    def _apply_score_threshold(self, ranked, candidates, scores_by_docid):
        """(ranked, candidates) with sub-threshold documents dropped —
        both the page and the (exhaustive) totals shrink (reference
        bucket_sort.rs ranking_score_threshold)."""
        t = self.ranking_score_threshold
        if t is None or not len(ranked) or not scores_by_docid:
            return ranked, candidates
        keep = np.fromiter(
            (
                scores_by_docid.get(int(d), 0.0) >= float(t) - 1e-9
                for d in ranked
            ),
            dtype=bool,
            count=len(ranked),
        )
        ranked = ranked[keep]
        return ranked, ranked

    def _deadline_exceeded(self) -> bool:
        import time as _time

        return self._deadline is not None and _time.perf_counter() > self._deadline

    def _compute_score_details(
        self, rules, cost_sorted, levels_sorted, ea_sorted, ranked, scorer
    ) -> dict:
        """Per-rule `_rankingScoreDetails` entries
        (reference: score_details.rs:226 ScoreDetails::to_json_map)."""
        out: dict[int, dict] = {}
        max_cache: dict = {}
        # attribute state: the legacy `attribute` criterion renders fid +
        # position as ONE merged "attribute" entry; the split
        # attributeRank/wordPosition criteria render separate entries
        # (criterion.rs:76 AttributeState::from_criteria)
        separated = any(
            rr in ("attributeRank", "wordPosition")
            for rr in self.store.settings.ranking_rules
        )
        for i, docid in enumerate(ranked.tolist()):
            k = int(levels_sorted[i]) if len(levels_sorted) else 0
            details: dict = {}
            order_idx = 0
            gi = 0
            fid_rank = None
            for rule in rules:
                if rule[0] == "graph":
                    dim = rule[1]
                    ckey = (dim, k)
                    if ckey not in max_cache:
                        max_cache[ckey] = scorer.max_cost(dim, k) if scorer else 0
                    next_max = max_cache[ckey] + 1
                    costv = int(cost_sorted[gi, i])
                    rank = min(max(next_max - costv, 1), next_max)
                    score = rank / next_max
                    if dim == "words":
                        details["words"] = {
                            "order": order_idx,
                            "matchingWords": rank,
                            "maxMatchingWords": next_max,
                            "score": score,
                        }
                        order_idx += 1
                    elif dim == "typo":
                        details["typo"] = {
                            "order": order_idx,
                            "typoCount": costv,
                            "maxTypoCount": next_max - 1,
                            "score": score,
                        }
                        order_idx += 1
                    elif dim == "proximity":
                        details["proximity"] = {"order": order_idx, "score": score}
                        order_idx += 1
                    elif dim == "fid":
                        if separated:
                            details["attributeRank"] = {
                                "order": order_idx,
                                "score": score,
                            }
                        else:
                            fid_rank = (rank, next_max)
                            details["attribute"] = {
                                "order": order_idx,
                                "attributeRankingOrderScore": score,
                            }
                        order_idx += 1
                    elif dim == "position":
                        if separated:
                            details["wordPosition"] = {
                                "order": order_idx,
                                "score": score,
                            }
                            order_idx += 1
                        else:
                            # merged into "attribute"; order already counted
                            # by the fid entry (score_details.rs:288)
                            attr = details.setdefault(
                                "attribute", {"order": order_idx}
                            )
                            attr["queryWordDistanceScore"] = score
                            attr["score"] = merge_ranks(
                                ([fid_rank] if fid_rank else [])
                                + [(rank, next_max)]
                            )
                    elif dim == "exactness":
                        # ExactWords folds into the "exactness" entry the
                        # exact-attribute rule opened; matching word counts
                        # are only shown for noExactMatch
                        # (score_details.rs:330)
                        ex = details.setdefault("exactness", {"order": order_idx})
                        if ex.get("matchType", "noExactMatch") == "noExactMatch":
                            ex.pop("score", None)
                            ex["matchingWords"] = max(rank - 1, 0)
                            ex["maxMatchingWords"] = next_max - 1
                            ex["score"] = merge_ranks(
                                [(1, 3), (rank, next_max)]
                            )
                    gi += 1
                elif rule[0] == "exact_attribute" and ea_sorted is not None:
                    ea = int(ea_sorted[i])
                    match_type = {
                        0: "exactMatch",
                        1: "matchesStart",
                    }.get(ea, "noExactMatch")
                    details["exactness"] = {
                        "order": order_idx,
                        "matchType": match_type,
                        "score": (3 - ea) / 3,
                    }
                    order_idx += 1
                elif rule[0] == "sort_field":
                    field, asc = rule[1], rule[2]
                    key = f"{field}:{'asc' if asc else 'desc'}"
                    fid = self.store.fields_ids_map.id(field)
                    value = None
                    if fid is not None:
                        nums = self.store.docid_facet_numbers.get((fid, docid))
                        if nums:
                            value = (min(nums) if asc else max(nums))
                        else:
                            strs = self.store.docid_facet_strings.get((fid, docid))
                            if strs:
                                value = strs[0][1]
                    details[key] = {"order": order_idx, "value": value}
                    order_idx += 1
                elif rule[0] == "geo":
                    order_idx += 1
            out[docid] = details
        return out

    def _compute_global_scores(
        self, rules, cost_sorted, levels_sorted, ea_sorted, ranked, scorer
    ) -> dict:
        """Global ranking score per ranked docid
        (reference: ScoreDetails::global_score + Rank::merge)."""
        out: dict[int, float] = {}
        max_cache: dict = {}
        for i, docid in enumerate(ranked.tolist()):
            k = int(levels_sorted[i]) if len(levels_sorted) else 0
            ranks: list[tuple[int, int]] = []
            gi = 0
            for rule in rules:
                if rule[0] == "graph":
                    dim = rule[1]
                    ckey = (dim, k)
                    if ckey not in max_cache:
                        max_cache[ckey] = scorer.max_cost(dim, k) if scorer else 0
                    next_max = max_cache[ckey] + 1
                    costv = int(cost_sorted[gi, i])
                    rank = min(max(next_max - costv, 1), next_max)
                    ranks.append((rank, next_max))
                    gi += 1
                elif rule[0] == "exact_attribute" and ea_sorted is not None:
                    ranks.append((3 - int(ea_sorted[i]), 3))
            out[docid] = merge_ranks(ranks)
        return out

    # -- universe ---------------------------------------------------------------

    def _resolve_universe(
        self, graph: QueryGraph, universe: set, resolver: Resolver
    ) -> set:
        """Reference: search/new/mod.rs:273 resolve_maximally_reduced_query_graph
        + resolve_query_graph.rs:133 compute_query_graph_docids."""
        if self.terms_matching_strategy == "last":
            groups = graph.removal_groups_last()
        elif self.terms_matching_strategy == "frequency":
            groups = graph.removal_groups_frequency(self.store)
        else:
            groups = []
        removed: set[int] = set()
        for g in groups:
            removed |= g

        # remove_nodes_keep_edges: predecessors connect to successors
        succs: dict[int, set[int]] = {
            n.node_id: set(n.successors) for n in graph.nodes
        }
        preds: dict[int, set[int]] = {
            n.node_id: set(n.predecessors) for n in graph.nodes
        }
        for nid in removed:
            for p in preds[nid]:
                succs[p].discard(nid)
                succs[p] |= succs[nid]
            for s in succs[nid]:
                preds[s].discard(nid)
                preds[s] |= preds[nid]
            succs[nid] = set()
            preds[nid] = set()

        # BFS in dependency order (arrays all the way)
        node_docids: dict[int, np.ndarray] = {}
        resolved: set[int] = set()
        queue = [graph.root]
        while queue:
            nid = queue.pop(0)
            if nid in resolved:
                continue
            node = graph.nodes[nid]
            if not preds[nid] <= resolved and nid != graph.root:
                queue.append(nid)
                continue
            pred_docids = union_many(
                [node_docids.get(p, EMPTY) for p in preds[nid]]
            )
            if nid == graph.root:
                docids = universe
            elif node.kind == "end":
                return pred_docids
            else:
                term_docids = resolver.term_all_docids(node.located.term)
                docids = intersect(pred_docids, term_docids)
            resolved.add(nid)
            node_docids[nid] = docids
            for s in succs[nid]:
                if s not in resolved:
                    queue.append(s)
        return EMPTY

    # -- sort / geo / exact-attribute key rows ------------------------------------

    def _rule_key_rows(
        self, rule: tuple, candidates: np.ndarray, graph
    ) -> list[np.ndarray]:
        if rule[0] == "sort_field":
            return self._sort_field_rows(rule[1], rule[2], candidates)
        if rule[0] == "geo":
            return self._geo_rows(rule[1], rule[2], rule[3], candidates)
        raise AssertionError(rule)

    def _sort_field_rows(
        self, field: str, asc: bool, candidates: np.ndarray
    ) -> list[np.ndarray]:
        """Two rows: value-class (0 number, 1 string, 2 none — numbers always
        iterate before strings, reference sort.rs number_iter.chain(string_iter))
        and the value key."""
        store = self.store
        fid = store.fields_ids_map.id(field)
        n = len(candidates)
        if fid is None:
            return [np.full(n, 2.0), np.zeros(n)]
        from ..index.arrays import sort_columns

        cols = sort_columns(store, fid)
        nv = (cols.num_min if asc else cols.num_max)[candidates]
        sv = (cols.str_min if asc else cols.str_max)[candidates]
        has_num = ~np.isnan(nv)
        has_str = sv >= 0
        cls = np.where(has_num, 0.0, np.where(has_str, 1.0, 2.0))
        nkey = np.where(has_num, nv if asc else -nv, 0.0)
        skey = np.where(~has_num & has_str, (sv if asc else -sv).astype(np.float64), 0.0)
        val = np.where(has_num, nkey, skey)
        return [cls, val]

    def _geo_rows(
        self, lat: float, lng: float, asc: bool, candidates: np.ndarray
    ) -> list[np.ndarray]:
        """Vectorized haversine over dense per-generation lat/lng columns
        (docs without `_geo` sort last, reference geo_sort.rs)."""
        store = self.store
        cached = getattr(store, "_geo_columns_cache", None)
        if cached is None or cached[0] != store.generation:
            size = max(store._next_docid, 1)
            lats = np.full(size, np.nan)
            lngs = np.full(size, np.nan)
            for docid, (la, lo) in store.geo_points.items():
                lats[docid] = la
                lngs[docid] = lo
            cached = (store.generation, lats, lngs)
            store._geo_columns_cache = cached
        lats, lngs = cached[1][candidates], cached[2][candidates]
        has = ~np.isnan(lats)
        p1 = math.radians(lat)
        p2 = np.radians(lats)
        dp = np.radians(lats - lat)
        dl = np.radians(lngs - lng)
        a = (
            np.sin(dp / 2) ** 2
            + math.cos(p1) * np.cos(p2) * np.sin(dl / 2) ** 2
        )
        d = 2 * 6371000.0 * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))
        cls = np.where(has, 0.0, 1.0)
        val = np.where(has, d if asc else -d, 0.0)
        val = np.where(np.isnan(val), 0.0, val)
        return [cls, val]

    def _exact_attribute_row(
        self, candidates: np.ndarray, graph, ea_levels: np.ndarray
    ) -> np.ndarray:
        """Per-doc rank 0/1/2 (reference: search/new/exact_attribute.rs),
        computed against the words-reduced sub-query of each document's
        bucket level (first k terms)."""
        out = np.full(len(candidates), 2.0)
        for k in sorted(set(ea_levels.tolist())):
            sel = ea_levels == k
            if k <= 0 or not sel.any():
                continue
            row = self._exact_attribute_rank_for_level(candidates, graph, k)
            out[sel] = row[sel]
        return out

    def _exact_attribute_rank_for_level(
        self, candidates: np.ndarray, graph, k: int
    ) -> np.ndarray:
        n = len(candidates)
        out = np.full(n, 2.0)
        if graph is None:
            return out
        restricted = self._restricted_fids()
        resolver = Resolver(self.store, candidates, restricted)
        # the global rank sets are candidate-independent (intersections
        # commute), so cache them per generation and mask per query
        ranks = None
        ckey = None
        if restricted is None:
            ckey = (
                "ear",
                tuple(
                    (n.located.term.original, n.located.start_position)
                    for n in graph.term_nodes()
                ),
                k,
            )
            ranks = resolver.arrays.cache.get(ckey)
        if ranks is None:
            universe = _docids_array(self.store) if restricted is None else candidates
            ranks = exact_attribute_rank_ids(
                self.store, graph, k, universe, resolver
            )
            if ckey is not None:
                resolver.arrays.cache[ckey] = ranks
        rank0, rank1 = ranks
        out = np.where(resolver._cand_index.mask(rank1), 1.0, out)
        out = np.where(resolver._cand_index.mask(rank0), 0.0, out)
        return out

    # -- shared helpers -------------------------------------------------------------

    def _restricted_fids(self) -> Optional[set[int]]:
        if self.attributes_to_search_on is None:
            return None
        if "*" in self.attributes_to_search_on:
            return None
        store = self.store
        searchable = {
            name: fid for name, fid, _ in store.searchable_fields_and_weights()
        }
        out: set[int] = set()
        for attr in self.attributes_to_search_on:
            matched = False
            for name, fid in searchable.items():
                if _attr_pattern_match(attr, name):
                    out.add(fid)
                    matched = True
            if not matched and "*" not in attr:
                if not store.settings.searchable_is_wildcard():
                    raise EngineError(
                        ErrorCode.INVALID_SEARCH_ATTRIBUTES_TO_SEARCH_ON,
                        f"Attribute `{attr}` is not searchable.",
                    )
        return out

    def _paginate(
        self,
        ranked: np.ndarray,
        all_candidates: set,
        scores_by_docid: Optional[dict] = None,
    ) -> SearchResult:
        store = self.store
        if not isinstance(all_candidates, np.ndarray):
            all_candidates = to_array(set(all_candidates))
        distinct_field = self.distinct or store.settings.distinct_attribute
        if distinct_field is None:
            # only maxTotalHits docs can ever be paginated; don't materialize
            # the full ranked list as Python ints
            cap = self.max_total_hits
            if cap is None:
                cap = store.settings.pagination.max_total_hits
            docids = ranked[:cap].tolist()
        else:
            docids = ranked.tolist()

        if distinct_field is not None:
            fid = store.fields_ids_map.id(distinct_field)
            if fid is not None:
                # non-exhaustive searches stop once the page is filled:
                # estimatedTotalHits then subtracts only the duplicate
                # groups PROCESSED so far and decays toward the exact
                # count as the offset grows (reference bucket_sort
                # distinct semantics, tests/search/distinct.rs)
                need = (
                    None
                    if self.exhaustive_number_hits
                    else self.offset + self.limit
                )
                kept = []
                excluded: set = set()
                for docid in docids:
                    if need is not None and len(kept) >= need:
                        break
                    if docid in excluded:
                        continue
                    for v in store.docid_facet_numbers.get((fid, docid), ()):
                        p = store.facet_number_docids.get(fid, {}).get(v)
                        if p is not None:
                            excluded.update(p)
                    for v, _ in store.docid_facet_strings.get((fid, docid), ()):
                        p = store.facet_string_docids.get(fid, {}).get(v)
                        if p is not None:
                            excluded.update(p)
                    kept.append(docid)
                docids = kept
                all_candidates = union_many(
                    [
                        to_array(set(docids)),
                        difference(all_candidates, to_array(excluded)),
                    ]
                )

        max_hits = self.max_total_hits
        if max_hits is None:
            max_hits = store.settings.pagination.max_total_hits
        docids = docids[: max_hits]
        pins = getattr(self, "_pins", None)
        if pins:
            from .dynamic_rules import merge_pins_into_page

            page = merge_pins_into_page(docids, pins, self.offset, self.limit)
            all_candidates = union_many(
                [all_candidates, to_array({d for _p, d in pins})]
            )
            # pinned hits carry the Pin detail; their score defaults to 1.0
            # (reference score_details.rs:408, dynamic rules PinDoc)
            self._pin_details = {
                d: {"pin": {"order": 0, "position": p}} for p, d in pins
            }
        else:
            page = docids[self.offset : self.offset + self.limit]
        scores_by_docid = scores_by_docid or {}
        return SearchResult(
            documents_ids=page,
            candidates=all_candidates,
            scores=[scores_by_docid.get(d, 1.0) for d in page],
            scores_by_docid=scores_by_docid,
            query_terms=getattr(self, "_located_terms", None),
        )


def _device_scorer_enabled() -> bool:
    """MEILI_TPU_DEVICE=1 sends chain queries through the device DP (K6,
    FusedScorer.run_device) on the store's device; a query it cannot take
    (phrases, live n-grams, more than 16 terms) goes to the host pass.

    Off by default, as in the JAX package: the masks are built on the
    host, and shipping them to the device costs more than the DP saves."""
    import os

    return os.environ.get("MEILI_TPU_DEVICE", "0") == "1"


def _lexsort_rows(keys: list[np.ndarray], docids: np.ndarray) -> np.ndarray:
    """Stable lexicographic argsort: keys in priority order, docid last."""
    rows = [docids] + list(reversed(keys))
    return np.lexsort(rows)


def _parse_asc_desc(text: str):
    """Parse `field:asc` / `_geoPoint(lat, lng):desc`.

    Reference: milli AscDesc::from_str."""
    if ":" not in text:
        raise EngineError(
            ErrorCode.INVALID_SEARCH_SORT,
            f"Invalid syntax for the sort parameter: expected expression ending"
            f" by `:asc` or `:desc`, found `{text}`.",
        )
    member, _, order = text.rpartition(":")
    order = order.strip()
    if order not in ("asc", "desc"):
        raise EngineError(
            ErrorCode.INVALID_SEARCH_SORT,
            f"Invalid syntax for the sort parameter: expected expression ending"
            f" by `:asc` or `:desc`, found `{text}`.",
        )
    member = member.strip()
    if member.startswith("_geoPoint(") and member.endswith(")"):
        inner = member[len("_geoPoint(") : -1]
        parts = [p.strip() for p in inner.split(",")]
        if len(parts) != 2:
            raise EngineError(
                ErrorCode.INVALID_SEARCH_SORT,
                f"Invalid syntax for the geo parameter: `{text}`.",
            )
        return (float(parts[0]), float(parts[1])), order == "asc"
    if member == "_geoPoint":
        raise EngineError(
            ErrorCode.INVALID_SEARCH_SORT,
            "You must specify coordinates for `_geoPoint`.",
        )
    return member, order == "asc"


def _attr_pattern_match(pattern: str, attr: str) -> bool:
    if pattern == "*":
        return True
    if pattern.endswith("*"):
        return attr.startswith(pattern[:-1])
    return attr == pattern or attr.startswith(pattern + ".")


def _haversine_m(lat1, lng1, lat2, lng2) -> float:
    r = 6371000.0
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = math.radians(lat2 - lat1)
    dl = math.radians(lng2 - lng1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * r * math.asin(math.sqrt(a))

def exact_attribute_rank_ids(
    store, graph, k: int, universe: np.ndarray, resolver
) -> tuple[np.ndarray, np.ndarray]:
    """(rank0, rank1) docid arrays for the ExactAttribute rule at words
    level k (reference: search/new/exact_attribute.rs). rank0 = the first-k
    sub-query exactly fills an attribute; rank1 = the attribute starts with
    it. Seeded with `universe` (pass all live docids for a global answer)."""
    infos = []
    for node in graph.term_nodes():
        lt = node.located
        term = lt.term
        if lt.end_term_id >= k:
            continue
        if term.ngram_words is not None:
            continue
        if term.phrase is not None:
            words = list(term.phrase)
        elif term.exact is not None:
            words = [term.exact]
        else:
            continue
        infos.append(
            (
                lt.start_term_id,
                words,
                lt.start_position,
                lt.end_position - lt.start_position + 1,
            )
        )
    infos.sort(key=lambda x: x[0])
    dedup = []
    seen_ids = set()
    for info in infos:
        if info[0] not in seen_ids:
            seen_ids.add(info[0])
            dedup.append(info)
    infos = dedup
    if not infos or infos[0][0] != 0:
        return EMPTY, EMPTY
    prev = 0
    for info in infos:
        if info[0] < prev or info[0] - prev > 1:
            return EMPTY, EMPTY
        prev = info[0]

    count_all_positions = sum(x[3] for x in infos)
    cands = universe
    all_words: list[str] = []
    for _tid, words, position, _cnt in infos:
        for offset, word in enumerate(words):
            if word is None:
                continue
            all_words.append(word)
            bucket = bucketed_position(position + offset)
            cands = intersect(
                cands, resolver.word_position_docids(word, bucket)
            )
            if not len(cands):
                return EMPTY, EMPTY
    rank0_parts: list = []
    rank1_parts: list = []
    for fid in sorted(store.searchable_fids()):
        inter = cands
        for word in all_words:
            inter = intersect(inter, resolver.word_fid_docids(word, fid))
            if not len(inter):
                break
        if not len(inter):
            continue
        if count_all_positions < 256:
            wc = resolver.arrays.get(
                ("fwc", fid, count_all_positions),
                store.field_id_word_count_docids.get(
                    (fid, count_all_positions)
                ),
            )
            wc = intersect(wc, universe)
        else:
            wc = EMPTY
        rank0_parts.append(intersect(inter, wc))
        rank1_parts.append(difference(inter, wc))
    rank0 = union_many(rank0_parts)
    rank1 = union_many(rank1_parts)
    return rank0, rank1
