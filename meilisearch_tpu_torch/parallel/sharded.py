"""Multi-GPU scatter-gather search over a torch.distributed process group.

Reference equivalent: EE sharding + federated `/multi-search`
(crates/milli/src/sharding/enterprise_edition.rs — rendezvous-hash docid
assignment; crates/meilisearch/src/search/federated/perform.rs — HTTP
scatter-gather merge of per-shard top-ks).

The port of the JAX package's `shard_map` programs (K7,
`meilisearch_tpu/parallel/sharded.py`): documents are sharded across ranks
by position on the candidate axis; every rank runs the same scorer on its
local block (K6, no communication), computes a local top-k, and one
all-gather moves the fixed-width (sort key, docid) tuples to every rank,
where a final sort yields the global top-k. NCCL joins the cards, gloo
the CPU processes of the tests.

Sharding contract (the JAX package's `P(axis)`): every rank is given the
global arrays, whose candidate axis N is divisible by the world size S;
rank r takes the block [r N/S, (r+1) N/S), and every rank returns the
same merged result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.device_scorer import INF, aligned_width, chain_query_topk, sort3


@dataclass(frozen=True)
class ShardGroup:
    """The ranks of one scatter-gather (the mesh of the JAX package): the
    default process group's, with this rank's device."""

    device: torch.device
    rank: int
    size: int


def make_group(backend: Optional[str] = None, device=None) -> ShardGroup:
    """The scatter-gather over the initialised default process group (the
    caller runs `torch.distributed.init_process_group`). `device` defaults
    to this process's CUDA device, `backend` to NCCL for a CUDA device and
    gloo for the CPU; the group must run that backend. The world size is
    the process group's."""
    if not dist.is_initialized():
        raise RuntimeError("make_group needs torch.distributed.init_process_group first")
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend not in str(dist.get_backend()):
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    return ShardGroup(device, dist.get_rank(), dist.get_world_size())


def _block(x, shards: ShardGroup, axis: int, width: int | None = None,
           fill=0) -> torch.Tensor:
    """This rank's block of a global array along `axis`, on its device;
    `width` wide along `axis` when given, the pad filled with `fill`."""
    x = torch.as_tensor(x)
    n = x.shape[axis]
    if n % shards.size:
        raise ValueError(f"axis {axis} of length {n} is not divisible by {shards.size} ranks")
    size = n // shards.size
    block = x.narrow(axis, shards.rank * size, size)
    if width is not None and width > size:
        shape = list(block.shape)
        shape[axis] = width - size
        pad = torch.full(shape, fill, dtype=block.dtype, device=block.device)
        block = torch.cat([block, pad], dim=axis)
    return block.contiguous().to(shards.device)


def _all_gather(shards: ShardGroup, x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x`, concatenated in rank order (jax.lax.all_gather
    then reshape(-1))."""
    out = torch.empty((shards.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    # all_gather_single is the newer name of all_gather_into_tensor
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x.contiguous())
    return out


def sharded_query_topk(shards: ShardGroup, inputs: tuple, k: int = 10):
    """Run the fused chain-query scorer (K6) over docid shards and merge
    the top-ks. inputs = (class_mask (T,3,N), pair_cost, fid_cost,
    pos_cost, exact_mask, docids (N,), valid (N,)), numpy arrays or
    tensors on any device, with N divisible by the group's size. Returns (docs, key_hi)
    on the group's device.

    The merge sorts all three packed key words (hi, lo, lo2), the same
    stable 3-key comparison the single-device scorer makes, so cross-shard
    ties order as in a single-device run; full-key ties keep the gathered
    order, which is rank-major."""
    axes = (2, 3, 2, 2, 1, 0, 0)  # the candidate axis of each input
    # each block laid out at K6's bulk-path stride, the pad columns inert
    # (no term matches, INF costs, not valid) and not computed
    fills = (False, 0, INF, INF, False, 0, False)
    size = inputs[5].shape[0] // shards.size
    width = aligned_width(size)
    local = [_block(x, shards, axis, width, fill)
             for x, axis, fill in zip(inputs, axes, fills)]
    keyed = chain_query_topk(*local, k=k, n=size)
    docs, hi, lo, lo2 = (_all_gather(shards, x) for x in keyed)
    s_docs, s_hi, _lo, _lo2 = sort3(hi, lo, lo2, docs, k)
    return s_docs, s_hi


def store_chain_inputs(
    store,
    query: str,
    pad_multiple: int = 1,
    filter_docids=None,
    locales=None,
):
    """Chain-kernel inputs for a REAL indexed store and query string.

    Runs the host side of the search pipeline — tokenize, typo derivations,
    query graph, universe resolution — exactly as `Search.execute` does,
    then materializes the dense chain tensors over the live candidate axis
    (FusedScorer.build_chain_inputs). Returns None when the query is not
    chain-compatible (phrases, live ngrams, >16 terms).
    """
    from ..index.arrays import difference, docids_array, intersect, to_array
    from ..search.executor import Search
    from ..search.graph import QueryGraph
    from ..search.query_terms import (
        DerivationContext,
        located_query_terms_from_tokens,
    )
    from ..search.scorer import FusedScorer, Resolver

    search = Search(store, query=query, limit=10, locales=locales)
    settings = store.settings

    universe = docids_array(store)
    if filter_docids is not None:
        universe = intersect(universe, to_array(filter_docids))

    ctx = DerivationContext(store, settings)
    tokenizer = store.make_tokenizer(locales)
    extracted = located_query_terms_from_tokens(ctx, tokenizer, query)
    terms = list(extracted.query_terms)
    if not terms:
        return None
    resolver = Resolver(store, np.zeros(0, dtype=np.int64), None)
    for w in extracted.negative_words:
        universe = difference(universe, resolver.word_docids(w, original=True))
    for p in extracted.negative_phrases:
        universe = difference(universe, resolver.phrase_docids(p))

    graph = QueryGraph.from_terms(ctx, terms)
    universe = search._resolve_universe(graph, universe, resolver)
    rules = search._assembled_rules(for_query=True)
    graph_dims = [r[1] for r in rules if r[0] == "graph"]
    mask_resolver = Resolver(store, universe, None)
    mask_resolver._phrase_cache = resolver._phrase_cache
    scorer = FusedScorer(store, mask_resolver, graph, "last", graph_dims)
    return scorer.build_chain_inputs(pad_multiple)


def sharded_store_topk(
    shards: ShardGroup,
    store,
    query: str,
    k: int = 10,
    filter_docids=None,
) -> Optional[np.ndarray]:
    """Global top-k docids for a real store and query, the candidate axis
    sharded over the group (local top-k + all-gather merge). Returns None
    when the query is not chain-compatible."""
    inputs = store_chain_inputs(store, query, pad_multiple=shards.size,
                                filter_docids=filter_docids)
    if inputs is None:
        return None
    docs, _hi = sharded_query_topk(shards, inputs, k=k)
    return docs.cpu().numpy()


def sharded_facet_counts(shards: ShardGroup, cand_mask, value_ids, n_values: int):
    """Facet-value histogram over a sharded candidate axis: each rank
    counts its local block, one all-reduce sums the counts. value_ids:
    (N,) int32 per-doc facet value index (-1 = none); cand_mask: (N,)
    bool. Returns (n_values,) int32 numpy."""
    mask = _block(cand_mask, shards, 0)
    vids = _block(value_ids, shards, 0)
    counted = vids[mask & (vids >= 0) & (vids < n_values)].long()
    local = torch.bincount(counted, minlength=n_values)[:n_values]
    dist.all_reduce(local, op=dist.ReduceOp.SUM)
    return local.to(torch.int32).cpu().numpy()


def local_vector_topk(vecs: torch.Tensor, ids: torch.Tensor, q: torch.Tensor, k: int):
    """One rank's cosine top-k: (scores, ids) of its min(k, n) best rows,
    in `lax.top_k`'s order. The product runs in full float32."""
    from ..vector.store import _topk_desc

    if vecs.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the sharded vector top-k needs full float32 matmuls:"
            " torch.backends.cuda.matmul.allow_tf32 is True"
        )
    qn = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-30)
    norms = torch.clamp(torch.linalg.vector_norm(vecs, dim=1), min=1e-30)
    cos = torch.matmul(vecs, qn) / norms
    score, idx = _topk_desc(cos, min(k, vecs.shape[0]))
    return score, ids[idx]


def merge_vector_topk(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """`lax.sort((-scores, ids), num_keys=2)` sliced to k: the highest
    score first, equal scores by lower docid. lax.sort compares floats as
    integers made from their bits, with -0.0 taken as +0.0 (so the two
    zeros are equal here, where `lax.top_k` puts +0.0 above -0.0); the
    scores sort on those integers (as `vector/store.py::topk_key` makes
    them) after a stable pass on the docids (int64, pad rows at its
    maximum). Returns (ids, scores)."""
    order = torch.sort(ids, stable=True).indices
    bits = torch.where(scores == 0, 0.0, scores).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    order = order[torch.sort(-ordered[order], stable=True).indices[:k]]
    return ids[order], scores[order]


def sharded_vector_topk(shards: ShardGroup, vectors, docids, query_vec, k: int = 10):
    """Cosine top-k over a docid-sharded vector matrix: each rank takes
    its local product and top-k, then one all-gather of (score, docid)
    pairs merges globally (ties broken by lower docid). Returns (ids,
    scores), numpy."""
    vecs = _block(np.asarray(vectors, dtype=np.float32), shards, 0)
    ids = _block(np.asarray(docids, dtype=np.int64), shards, 0)
    q = torch.as_tensor(np.asarray(query_vec, dtype=np.float32)).to(shards.device)
    score, top_ids = local_vector_topk(vecs, ids, q, k)
    out_ids, out_scores = merge_vector_topk(
        _all_gather(shards, score), _all_gather(shards, top_ids), k
    )
    return out_ids.cpu().numpy(), out_scores.cpu().numpy()


from .rendezvous import rendezvous_shard  # noqa: E402,F401 — re-export
