"""Entry points of the port, the counterparts of the repository's
`__graft_entry__.py`.

entry()             -> (fn, example_args): the flagship query step, the
                       fused lexicographic ranking DP + top-k (K6,
                       ops/device_scorer.py) on the card.
dryrun_multichip(n) -> runs n ranks in a torch.distributed group (NCCL on
                       n cards, or gloo on the CPU when asked) over a REAL
                       indexed corpus (synthetic hackernews-like documents
                       and vectors) and holds the sharded pipeline against
                       the host: keyword + typo + filter top-k, a tie-heavy
                       block (the 3-key exact merge), a sharded facet
                       histogram and a sharded vector top-k (K7,
                       parallel/sharded.py).

    python -m meilisearch_tpu_torch.entry [N_DEVICES] [--cpu] [--docs N]
"""

from __future__ import annotations

import functools
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

VECTOR_TIE = 1e-6  # host similarities within this of each other compare as a set
RANK_TIMEOUT_S = 3600.0  # a spawned rank that runs longer is stopped


def _device(device) -> torch.device:
    return torch.device(device if device is not None else "cuda")


def entry(device=None):
    """(fn, example_args): `chain_query_topk` with k = 10 and its example
    inputs (T = 4, N = 8192) on `device` (default: the card)."""
    from .ops.device_scorer import chain_query_topk, example_inputs

    dev = _device(device)
    example_args = tuple(x.to(dev) for x in example_inputs(T=4, N=8192, k=10))
    fn = functools.partial(chain_query_topk, k=10)
    return fn, example_args


def _same_within_ties(got: list, host: list) -> bool:
    """Ids in the host's order, except inside a run of hits whose host
    similarities lie within VECTOR_TIE of each other, compared as a set
    (a float32 product summed in another order moves a cosine by ulps)."""
    want = [d for d, _s in host]
    sims = [s for _d, s in host]
    if len(got) != len(want):
        return False
    start = 0
    for i in range(1, len(want) + 1):
        if i == len(want) or abs(sims[i] - sims[i - 1]) > VECTOR_TIE:
            if set(got[start:i]) != set(want[start:i]):
                return False
            start = i
    return True


def _corpus_store(n_docs: int):
    """The dry run's corpus through the normal write path, as the JAX
    package's `dryrun_multichip` builds it: `n_docs` hackernews-like
    documents, 2,000 of them titled "zebra stripe pattern" (a tie block
    for the exact cross-shard merge), and unit 32-d `userProvided` vectors
    on the first min(16,384, n_docs) documents."""
    from .index.store import IndexStore
    from .utils.synthetic import generate_hackernews_like

    if n_docs < 3_000:
        raise ValueError(f"the dry run needs at least 3,000 documents, got {n_docs}")
    docs = generate_hackernews_like(n_docs)
    rng = np.random.default_rng(7)
    for i in range(2_000):
        docs[1_000 + i]["title"] = "zebra stripe pattern"
    dim, n_vec = 32, min(16_384, n_docs)
    vecs = rng.standard_normal((16_384, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    for i in range(n_vec):
        docs[i]["_vectors"] = {"default": vecs[i].tolist()}
    store = IndexStore("dryrun", primary_key="id")
    store.settings.apply_json(
        {
            "searchableAttributes": ["title", "author"],
            "filterableAttributes": ["points", "author"],
            "embedders": {"default": {"source": "userProvided", "dimensions": dim}},
        }
    )
    for s in range(0, n_docs, 50_000):
        store.add_documents(docs[s : s + 50_000])
    return store, vecs


def _dryrun(shards, n_docs: int) -> None:
    """The dry run's checks on this rank of `shards`; each raises on a
    difference. Rank 0 prints each part with its seconds."""
    from .index.arrays import facet_concat
    from .parallel.sharded import (
        sharded_facet_counts,
        sharded_store_topk,
        sharded_vector_topk,
    )
    from .search.executor import Search
    from .search.filters import evaluate_filter
    from .vector.store import VectorSearcher

    n = shards.size
    say = print if shards.rank == 0 else (lambda *_a, **_k: None)
    t0 = time.perf_counter()
    store, vecs = _corpus_store(n_docs)
    say(f"dryrun_multichip({n}): {n_docs}-doc corpus indexed in"
        f" {time.perf_counter() - t0:.3f} s", flush=True)

    # -- keyword / typo / filter / tie-heavy top-k against the host -------
    t0 = time.perf_counter()
    cases = [
        ("rust database", None),
        ("machin learnin", None),  # typo derivations cross-shard
        ("zebra stripe", None),  # 2000-way tie: 3-key merge exactness
        ("python", "points > 2500"),  # filter universe sharded
    ]
    for query, flt in cases:
        filter_docids = evaluate_filter(store, flt, as_array=True) if flt else None
        docs_out = sharded_store_topk(shards, store, query, k=10, filter_docids=filter_docids)
        if docs_out is None:
            raise AssertionError(f"{query!r} is not chain-compatible")
        oracle = Search(store, query=query, filter_docids=filter_docids, limit=10).execute()
        if docs_out.tolist() != list(oracle.documents_ids):
            raise AssertionError((query, docs_out.tolist(), oracle.documents_ids))
        say(f"dryrun_multichip({n}): top-10 parity ok for {query!r}", flush=True)
    say(f"dryrun_multichip({n}): keyword cases {time.perf_counter() - t0:.3f} s", flush=True)

    # -- sharded facet histogram against the host bulk counter ------------
    t0 = time.perf_counter()
    oracle = Search(store, query="rust", limit=10).execute()
    cand = np.asarray(oracle.candidates, dtype=np.int64)
    fc = facet_concat(store, store.fields_ids_map.id("author"))
    n_values = len(fc.str_values)
    D = 1 << (max(int(store._next_docid), 2) - 1).bit_length()
    D += (-D) % n
    mask = np.zeros(D, dtype=bool)
    mask[cand] = True
    value_ids = np.full(D, -1, dtype=np.int32)
    for kept, arr_lo, arr_hi in zip(fc.str_kept, fc.str_offsets[:-1], fc.str_offsets[1:]):
        value_ids[fc.str_ids[arr_lo:arr_hi]] = int(kept)
    counts = sharded_facet_counts(shards, mask, value_ids, n_values)
    _nk, _nc, sk, scounts = fc.counts(mask)
    want = np.zeros(n_values, dtype=np.int64)
    want[np.asarray(sk, dtype=np.int64)] = scounts
    if not np.array_equal(counts.astype(np.int64), want):
        raise AssertionError("facet counts differ from the host")
    say(f"dryrun_multichip({n}): sharded facet histogram ok"
        f" ({int(counts.sum())} candidate values over {n_values} authors,"
        f" {time.perf_counter() - t0:.3f} s)", flush=True)

    # -- sharded vector top-k against the host exact search ---------------
    t0 = time.perf_counter()
    vs = VectorSearcher(store, "default")  # the store has no device: numpy
    nvec = len(vs.docids)
    padv = (-nvec) % n
    matrix = np.pad(vs.matrix, ((0, padv), (0, 0)))
    docids = np.pad(vs.docids, (0, padv), constant_values=np.iinfo(np.int64).max)
    q = vecs[3] * 0.5 + vecs[77] * 0.5
    ids, _scores = sharded_vector_topk(shards, matrix, docids, q, k=10)
    host = vs.search(q, 10)
    if not _same_within_ties(ids.tolist(), host):
        raise AssertionError((ids.tolist(), host))
    say(f"dryrun_multichip({n}): sharded vector top-10 ok"
        f" ({time.perf_counter() - t0:.3f} s)", flush=True)
    say(f"dryrun_multichip({n}): {n_docs}-doc corpus, typo/filter/"
        "tie/facet/vector parity with the host", flush=True)


def _rank_main(rank: int, world: int, store_path: str, device_type: str, n_docs: int) -> None:
    """One rank of a dry run: joins the group through a FileStore (no
    port), runs the checks, leaves the group."""
    from .parallel.sharded import make_group

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        _dryrun(make_group(backend, device), n_docs)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None, n_docs: int = 100_000) -> None:
    """The sharded pipeline over `n_devices` ranks, each check held
    against the host. `device` "cuda" (the default) takes one card a rank
    over NCCL and raises when the machine has fewer cards; "cpu" takes
    gloo. Inside an initialised process group of `n_devices` ranks it
    runs this rank's part; otherwise it starts the ranks itself (one
    rank: in this process; more: one spawned process each) through a
    FileStore in a temporary directory."""
    dev = _device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(
            f"need {n_devices} CUDA devices, have {torch.cuda.device_count()}"
        )
    if dist.is_initialized():
        from .parallel.sharded import make_group

        if dist.get_world_size() != n_devices:
            raise RuntimeError(
                f"the process group has {dist.get_world_size()} ranks, not {n_devices}"
            )
        _dryrun(make_group(device=dev), n_docs)
        return
    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "rendezvous")
        if n_devices == 1:
            _rank_main(0, 1, store_path, dev.type, n_docs)
        else:
            _spawn_ranks(n_devices, store_path, dev.type, n_docs)


def _spawn_ranks(world: int, store_path: str, device_type: str, n_docs: int) -> None:
    """Run `_rank_main` in `world` spawned processes; raise (after
    stopping the others) when one fails or RANK_TIMEOUT_S passes."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_main, args=(r, world, store_path, device_type, n_docs))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"a dry-run rank failed with exit code {failed[0]}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"the dry run's ranks ran past {RANK_TIMEOUT_S} s")
            time.sleep(0.2)
        failed = [p.exitcode for p in procs if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"a dry-run rank failed with exit code {failed[0]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)


def main(argv=None) -> int:
    import argparse

    from ._hooks import block_jax

    parser = argparse.ArgumentParser(description="the port's multi-rank dry run")
    parser.add_argument("n_devices", type=int, nargs="?", default=1)
    parser.add_argument("--cpu", action="store_true", help="gloo on the CPU, not the card")
    parser.add_argument("--docs", type=int, default=100_000)
    opts = parser.parse_args(argv)
    block_jax()  # the port runs without jax, even where jax is installed
    dryrun_multichip(opts.n_devices, device="cpu" if opts.cpu else None, n_docs=opts.docs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
