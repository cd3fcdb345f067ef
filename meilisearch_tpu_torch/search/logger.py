"""Search introspection: the VisualSearchLogger equivalent.

Reference: milli search/new/logger/visual.rs — a dev-facing logger that
renders the query graph and ranking decisions as graphviz. Here it is a
library call + `meilisearch_tpu_torch.tool explain-query` subcommand
producing DOT plus the per-term derivation table. It reads the store on
the host only: the port's copy of the JAX package's module, on the port's
query graph, query terms and resolver.
"""

from __future__ import annotations

import numpy as np

from ..index.store import IndexStore


def explain_query(store: IndexStore, query: str) -> dict:
    """Returns {dot, terms: [{original, classes, prefix, phrase}], nodes}."""
    from .graph import QueryGraph
    from .query_terms import DerivationContext, located_query_terms_from_tokens
    from .scorer import Resolver

    ctx = DerivationContext(store, store.settings)
    tokenizer = store.make_tokenizer()
    extracted = located_query_terms_from_tokens(ctx, tokenizer, query)
    terms = list(extracted.query_terms)
    graph = QueryGraph.from_terms(ctx, terms)
    resolver = Resolver(store, np.zeros(0, dtype="int64"), None)

    term_rows = []
    for lt in terms:
        t = lt.term
        classes = {}
        for cls in range(t.max_typo_cost() + 1):
            words = [w for w, _ in resolver.class_words(t, cls)]
            phrases = [list(p) for p in resolver.class_phrases(t, cls)]
            if words or phrases:
                classes[cls] = {"words": words[:20], "phrases": phrases[:5]}
        term_rows.append(
            {
                "original": t.original,
                "positions": [lt.start_position, lt.end_position],
                "termIds": [lt.start_term_id, lt.end_term_id],
                "prefix": t.use_prefix_db,
                "phrase": list(t.phrase) if t.phrase is not None else None,
                "ngram": t.ngram_words,
                "classes": classes,
            }
        )

    lines = ["digraph QueryGraph {", "  rankdir=LR;", '  START [shape=point];', '  END [shape=point];']
    for node in graph.term_nodes():
        lt = node.located
        t = lt.term
        n_docs = len(resolver.term_all_docids(t))
        label = t.original.replace('"', "'")
        extra = []
        if t.phrase is not None:
            extra.append("phrase")
        if t.ngram_words is not None:
            extra.append(f"{len(t.ngram_words)}gram")
        if t.use_prefix_db is not None:
            extra.append("prefix*")
        suffix = f" [{' '.join(extra)}]" if extra else ""
        lines.append(
            f'  n{node.node_id} [shape=box label="{label}{suffix}\\n'
            f'ids {lt.start_term_id}..{lt.end_term_id} | {n_docs} docs"];'
        )
    ids = {n.node_id for n in graph.term_nodes()}
    for node in graph.term_nodes():
        for p in node.predecessors:
            src = "START" if p == graph.root else f"n{p}"
            if p == graph.root or p in ids:
                lines.append(f"  {src} -> n{node.node_id};")
    end_preds = graph.nodes[graph.end].predecessors
    for p in end_preds:
        if p in ids:
            lines.append(f"  n{p} -> END;")
    lines.append("}")

    return {
        "query": query,
        "negativeWords": extracted.negative_words,
        "terms": term_rows,
        "dot": "\n".join(lines),
    }
