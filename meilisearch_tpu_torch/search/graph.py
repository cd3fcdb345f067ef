"""Query graph construction.

Semantic port of reference search/new/query_graph.rs: a DAG from START to END
where nodes are query-term subsets (1-grams plus 2/3-gram combinations) and
edges connect a node to the nodes with the smallest next term id.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .query_terms import (
    DerivationContext,
    LocatedQueryTerm,
    make_ngram,
)

START = -1
END = -2


@dataclass
class QueryNode:
    node_id: int
    located: Optional[LocatedQueryTerm]  # None for START/END
    kind: str  # "start" | "end" | "term"
    successors: list[int] = field(default_factory=list)
    predecessors: list[int] = field(default_factory=list)


class QueryGraph:
    def __init__(self, nodes: list[QueryNode], root: int, end: int):
        self.nodes = nodes
        self.root = root
        self.end = end

    @classmethod
    def from_terms(
        cls, ctx: DerivationContext, terms: list[LocatedQueryTerm]
    ) -> "QueryGraph":
        """Reference: query_graph.rs:96 from_query — builds 1/2/3-gram nodes."""
        for i, t in enumerate(terms):
            t.start_term_id = i
            t.end_term_id = i

        nodes: list[QueryNode] = [
            QueryNode(0, None, "start"),
            QueryNode(1, None, "end"),
        ]

        def add_term_node(lt: LocatedQueryTerm) -> int:
            nid = len(nodes)
            nodes.append(QueryNode(nid, lt, "term"))
            return nid

        prev2: list[int] = []
        prev1: list[int] = []
        prev0: list[int] = [0]
        for i, lt in enumerate(terms):
            new_nodes = [add_term_node(lt)]
            if prev1:
                ngram = make_ngram(ctx, terms[i - 1 : i + 1])
                if ngram is not None:
                    ngram.start_term_id = i - 1
                    ngram.end_term_id = i
                    new_nodes.append(add_term_node(ngram))
            if prev2:
                ngram = make_ngram(ctx, terms[i - 2 : i + 1])
                if ngram is not None:
                    ngram.start_term_id = i - 2
                    ngram.end_term_id = i
                    new_nodes.append(add_term_node(ngram))
            prev0, prev1, prev2 = new_nodes, prev0, prev1

        graph = cls(nodes, 0, 1)
        graph.build_initial_edges()
        return graph

    def build_initial_edges(self) -> None:
        """Reference: query_graph.rs:254 build_initial_edges."""
        for node in self.nodes:
            node.successors = []
            node.predecessors = []
        for node in self.nodes:
            if node.kind == "end":
                continue
            end_prev = (
                node.located.end_term_id if node.kind == "term" else -1
            )
            best_start = None
            successors: list[int] = []
            for other in self.nodes:
                if other.kind == "term":
                    start_next = other.located.start_term_id
                elif other.kind == "end":
                    start_next = 1 << 30
                else:
                    continue
                if start_next <= end_prev:
                    continue
                if best_start is None or start_next < best_start:
                    best_start = start_next
                    successors = [other.node_id]
                elif start_next == best_start:
                    successors.append(other.node_id)
            node.successors = successors
            for succ in successors:
                self.nodes[succ].predecessors.append(node.node_id)

    def term_nodes(self) -> list[QueryNode]:
        return [n for n in self.nodes if n.kind == "term"]

    def n_term_ids(self) -> int:
        out = 0
        for n in self.term_nodes():
            out = max(out, n.located.end_term_id + 1)
        return out

    def words_in_phrases_count(self) -> int:
        """Reference: query_graph.rs:409."""
        count = 0
        for n in self.term_nodes():
            if n.located.term.phrase is not None:
                count += sum(1 for w in n.located.term.phrase if w is not None)
        return count

    def removal_groups_last(self) -> list[set[int]]:
        """Node groups in removal order for the `last` strategy.

        Reference: query_graph.rs:346 removal_order_for_terms_matching_strategy_last
        — removable nodes grouped by max(1 + last_id - id) ascending; the final
        (costliest) group is dropped unless a mandatory/phrase term exists.
        """
        term_ids = [
            (n.located.start_term_id, n.located.end_term_id)
            for n in self.term_nodes()
        ]
        if not term_ids:
            return []
        first = min(s for s, _ in term_ids)
        last = max(e for _, e in term_ids)
        if first >= last:
            return []
        return self._removal_groups(lambda tid: 1 + last - tid)

    def removal_groups_frequency(self, store) -> list[set[int]]:
        """Reference: query_graph.rs:303 ..._frequency — most frequent terms
        removed first."""
        from collections import defaultdict

        term_docids: dict[int, set] = defaultdict(set)
        for n in self.term_nodes():
            lt = n.located
            docids = set()
            for cls in (0, 1, 2):
                for w in lt.term.words_for_class(cls):
                    docids |= store.get_word_docids(w)
            if lt.term.use_prefix_db:
                for w in store.all_words_sorted():
                    if w.startswith(lt.term.use_prefix_db):
                        docids |= store.get_word_docids(w)
            for tid in range(lt.start_term_id, lt.end_term_id + 1):
                term_docids[tid] |= docids
        freq = {
            tid: (len(d) if d else float("inf")) for tid, d in term_docids.items()
        }
        ordered = sorted(freq.items(), key=lambda kv: -kv[1] if kv[1] != float("inf") else float("-inf"))
        # assign increasing weights, ties share a weight
        weights: dict[int, int] = {}
        w = 1
        for i, (tid, f) in enumerate(ordered):
            weights[tid] = w
            if i + 1 < len(ordered) and ordered[i + 1][1] != f:
                w += 1
        return self._removal_groups(lambda tid: weights.get(tid, 1))

    def _removal_groups(self, order) -> list[set[int]]:
        """Reference: query_graph.rs:379 removal_order_for_terms_matching_strategy."""
        from collections import defaultdict

        groups: dict[int, set[int]] = defaultdict(set)
        at_least_one_mandatory = False
        for n in self.term_nodes():
            lt = n.located
            if lt.term.phrase is not None:
                at_least_one_mandatory = True
                continue
            cost = max(
                order(tid) for tid in range(lt.start_term_id, lt.end_term_id + 1)
            )
            groups[cost].add(n.node_id)
        res = [groups[c] for c in sorted(groups)]
        if not at_least_one_mandatory and res:
            res.pop()
        return res
