"""The device chain scorer (K6) and the scatter-gather (K7): the port
against the JAX package.

- K6's plain torch versions (`chain_cost_matrix_torch`, the keys mode and
  its stable 3-key sort) against `meilisearch_tpu.ops.device_scorer`'s
  jitted programs on XLA's CPU backend, bit for bit: costs, keys and
  docids in order, over every candidate (k = N). The inputs are seeded
  numpy draws given to both, with INF addends, columns no term matches,
  invalid columns, and docids at and above 2^23 (clipped in key_lo2, so
  full-key ties that must keep their input order).
- The executor with MEILI_TPU_DEVICE=1 on a store with no device (the
  CPU): the port's page equals its host pass and the JAX package's
  device page; a phrase goes to the host pass.
- K7 in a 4-rank gloo group (four processes, one FileStore): every rank's
  result equals the JAX package's `shard_map` programs on a 4-device CPU
  mesh, and the dry run passes at a small size. The processes are
  stopped, and the test fails, if they take longer than RANKS_TIMEOUT_S.

The kernel itself is compared with its plain version on the card in
tests/test_torch_cuda.py (marked `cuda`)."""

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meilisearch_tpu.index.store import IndexStore as JaxStore
from meilisearch_tpu.ops import device_scorer as jds
from meilisearch_tpu.parallel import sharded as jsh
from meilisearch_tpu.search.executor import Search as JaxSearch
from meilisearch_tpu_torch.entry import dryrun_multichip, entry
from meilisearch_tpu_torch.index.store import IndexStore
from meilisearch_tpu_torch.ops import device_scorer as ds
from meilisearch_tpu_torch.search import scorer as port_scorer
from meilisearch_tpu_torch.search.executor import Search

REPO = Path(__file__).resolve().parent.parent
RANKS = 4
RANKS_TIMEOUT_S = 180.0
INF = 1 << 24


def case_inputs(T: int, N: int, seed: int):
    """`example_inputs` of both packages (equal arrays from one seed),
    then harder columns: INF addends where a class is absent, every 13th
    column matched by no term, every 11th invalid, and from column N // 2
    on docids above 2^23, of which a run of 40 columns holds the same
    values in every input (equal keys: the sort keeps their order).
    Returns numpy (class_mask, pair_cost, fid_cost, pos_cost, exact_mask,
    docids, valid, exact_cost)."""
    arrays = [x.numpy().copy() for x in ds.example_inputs(T=T, N=N, seed=seed)]
    class_mask, pair_cost, fid_cost, pos_cost, exact_mask, docids, valid = arrays
    rng = np.random.default_rng(seed + 1)
    absent = ~class_mask & (rng.random(class_mask.shape) < 0.5)
    fid_cost[absent] = INF
    pos_cost[absent] = INF
    class_mask[:, :, ::13] = False
    valid[::11] = False
    docids[N // 2 :] = (1 << 23) + rng.integers(0, 1 << 20, N - N // 2)
    lo, hi = N // 2, min(N // 2 + 40, N)
    for a in (class_mask, fid_cost, pos_cost):
        a[..., lo:hi] = a[..., lo : lo + 1]
    pair_cost[..., lo:hi] = pair_cost[..., lo : lo + 1]
    exact_mask[:, lo:hi] = exact_mask[:, lo : lo + 1]
    valid[lo:hi] = True
    exact_cost = rng.integers(0, 3, size=(T, N)).astype(np.int32)
    return class_mask, pair_cost, fid_cost, pos_cost, exact_mask, docids, valid, exact_cost


@pytest.mark.parametrize("T", [1, 2, 4])
def test_example_inputs_match_jax(T):
    for a, b in zip(jds.example_inputs(T=T, N=300, seed=T), ds.example_inputs(T=T, N=300, seed=T)):
        assert a.dtype == b.numpy().dtype and np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("N", [257, 8192])
@pytest.mark.parametrize("T", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("mode", ["cost", "keys"])
def test_plain_dp_matches_jax(mode, T, N):
    *inputs, exact_cost = case_inputs(T, N, seed=100 + T)
    cm, pc, fc, pc_, em, docids, valid = inputs
    if mode == "cost":
        want = np.asarray(jds.chain_cost_matrix(cm, pc, fc, pc_, exact_cost))
        got = ds.chain_cost_matrix(*map(torch.from_numpy, (cm, pc, fc, pc_, exact_cost)))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        assert (want[0] >= INF).any() and (want[0] < INF).any()
        return
    want = [np.asarray(x) for x in jds.chain_query_topk(*inputs, k=N)]
    got = ds.chain_query_topk(*map(torch.from_numpy, inputs), k=N)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w)
    # the run of equal columns kept its input order in the sort
    run = docids[N // 2 : N // 2 + 40].tolist()
    pos = [want[0].tolist().index(d) for d in run]
    assert pos == sorted(pos) and pos[-1] - pos[0] == len(run) - 1


def test_sort3_is_stable_on_full_key_ties():
    """Three stable passes order like lax.sort(num_keys=3); a bare
    unstable sort would not keep the tied docids in input order."""
    n = 4096
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 3, n).astype(np.int32)
    lo = rng.integers(0, 2, n).astype(np.int32)
    lo2 = np.full(n, (1 << 23) - 1, np.int32)
    docids = rng.permutation(n).astype(np.int32)
    want = jax.lax.sort(tuple(map(jnp.asarray, (hi, lo, lo2, docids))), num_keys=3)
    got = ds.sort3(*map(torch.from_numpy, (hi, lo, lo2, docids)), n)
    assert np.array_equal(got[0].numpy(), np.asarray(want[3]))


VOCAB = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "theta",
         "lambda", "sigma", "omega", "kappa", "tau"]
QUERIES = ["alpha beta", "gamma delta epsilon", "alpha omge", "sigma kappa tau omega", "alph"]


def _docs(n=200, seed=7, uniq=False):
    """tests/test_device_scorer.py's corpora: `make_store`, or with a
    unique last token (`_real_store_corpus`)."""
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        words = rng.choice(VOCAB, size=rng.integers(2, 9)).tolist()
        docs.append({"id": i, "text": " ".join(words) + (f" uniq{i}" if uniq else "")})
    return docs


def _store(cls, docs):
    store = cls("t", primary_key="id")
    store.settings.apply_json({"searchableAttributes": ["text"]})
    store.add_documents([dict(d) for d in docs])
    return store


@pytest.fixture(scope="module")
def stores():
    docs = _docs()
    return _store(JaxStore, docs), _store(IndexStore, docs)


@pytest.fixture
def device_dp_calls(monkeypatch):
    """Counts the port's run_device calls that took the query."""
    calls = []
    run_device = port_scorer.FusedScorer.run_device

    def counted(self):
        out = run_device(self)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(port_scorer.FusedScorer, "run_device", counted)
    return calls


@pytest.mark.parametrize("query", QUERIES + ['"alpha beta"'])
def test_device_page_matches_host_and_jax(stores, device_dp_calls, monkeypatch, query):
    jstore, store = stores
    assert store.device is None  # the CPU: K6's plain version
    monkeypatch.setenv("MEILI_TPU_DEVICE", "0")
    host = Search(store, query=query, limit=50).execute().documents_ids
    assert device_dp_calls == []
    monkeypatch.setenv("MEILI_TPU_DEVICE", "1")
    page = Search(store, query=query, limit=50).execute().documents_ids
    jax_page = JaxSearch(jstore, query=query, limit=50).execute().documents_ids
    assert page == host == jax_page
    # a phrase is not chain-compatible: the host pass serves it
    assert device_dp_calls == [not query.startswith('"')]


# -- K7: four gloo ranks -----------------------------------------------------

CHILD = r'''
import pickle, sys
import numpy as np
import torch
import torch.distributed as dist

for name in ("meilisearch_tpu", "jax", "jaxlib", "flax"):
    sys.modules[name] = None  # the port runs without them

from meilisearch_tpu_torch.entry import dryrun_multichip
from meilisearch_tpu_torch.entry import dryrun_multichip, entry
from meilisearch_tpu_torch.index.store import IndexStore
from meilisearch_tpu_torch.parallel import sharded

rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
with open(f"{work}/inputs.pkl", "rb") as f:
    inp = pickle.load(f)
dist.init_process_group("gloo", store=dist.FileStore(f"{work}/rendezvous", world),
                        rank=rank, world_size=world)
shards = sharded.make_group(device="cpu")
out = {"rank": shards.rank, "size": shards.size, "query": [], "store": {}}
for inputs, k in inp["query"]:
    docs, hi = sharded.sharded_query_topk(shards, inputs, k=k)
    out["query"].append((docs.numpy(), hi.numpy()))
store = IndexStore("t", primary_key="id")
store.settings.apply_json({"searchableAttributes": ["text"]})
store.add_documents(inp["docs"])
for q in inp["store_queries"]:
    out["store"][q] = sharded.sharded_store_topk(shards, store, q, k=10)
out["facets"] = sharded.sharded_facet_counts(shards, *inp["facets"])
out["vector"] = [sharded.sharded_vector_topk(shards, *args, k=10) for args in inp["vector"]]
scores, ids = (torch.from_numpy(a[rank]) for a in inp["merge"])
gathered = (sharded._all_gather(shards, scores), sharded._all_gather(shards, ids))
merged = sharded.merge_vector_topk(*gathered, k=inp["merge_k"])
out["merge"] = tuple(x.numpy() for x in merged)
dryrun_multichip(world, device="cpu", n_docs=inp["dryrun_docs"])
dist.destroy_process_group()
with open(f"{work}/out{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
'''


def _query_cases():
    """(inputs, k) of the sharded query checks: N divisible by RANKS."""
    cases = [(tuple(x.numpy() for x in ds.example_inputs(T=3, N=256 * RANKS, k=8)), 8)]
    for T, N, k in ((1, 64 * RANKS, 10), (4, 512 * RANKS, 50)):
        cases.append((tuple(case_inputs(T, N, seed=T)[:7]), k))
    # pad columns and clipped docids only: full-key ties across ranks
    cm, pc, fc, pc_, em, docids, valid = (x.numpy() for x in ds.example_inputs(T=2, N=8 * RANKS))
    cm[:] = False
    docids[:] = (1 << 23) + np.arange(len(docids))
    cases.append(((cm, pc, fc, pc_, em, docids, valid), 20))
    return cases


def _vector_cases():
    """(matrix, docids, q) of the sharded vector checks: a random matrix,
    and one whose rows have a single non-zero entry, so every cosine is
    exact (many equal, some +0.0) in both packages."""
    rng = np.random.default_rng(9)
    n, dim = 1000, 16
    mat = rng.standard_normal((n, dim)).astype(np.float32)
    ids = rng.permutation(10 * n)[:n].astype(np.int64)
    out = [(mat, ids, rng.standard_normal(dim).astype(np.float32))]
    axes = rng.integers(0, 4, n)
    exact = np.zeros((n, dim), np.float32)
    exact[np.arange(n), axes] = rng.choice([-2.0, -1.0, 1.0, 2.0], n)
    q = np.array([3.0, -1.0, 0.0, 0.0] + [0.0] * (dim - 4), np.float32)
    out.append((exact, ids, q))
    pad = (-n) % RANKS
    return [
        (np.pad(m, ((0, pad), (0, 0))), np.pad(d, (0, pad), constant_values=np.iinfo(np.int64).max), q)
        for m, d, q in out
    ]


def _merge_case():
    """Each rank's local (scores, ids) with +0.0 and -0.0 among them."""
    scores = np.array([[0.5, 0.0, -0.0, -0.25, 0.0],
                       [-0.0, 0.5, 0.0, -0.0, -0.5],
                       [0.0, -0.0, 0.75, 0.0, -0.0],
                       [-0.0, -0.0, 0.0, 0.5, 0.0]], np.float32)
    ids = np.array([[3, 9, 1, 4, 12], [7, 2, 8, 0, 5], [11, 6, 10, 13, 19],
                    [15, 14, 17, 16, 18]], np.int64)
    return scores, ids


@pytest.fixture(scope="module")
def facet_case():
    rng = np.random.default_rng(4)
    n, n_values = 1024 * RANKS, 37
    mask = rng.random(n) < 0.4
    vids = rng.integers(-1, n_values + 3, n).astype(np.int32)
    return mask, vids, n_values


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, facet_case):
    """Runs CHILD in RANKS gloo processes; returns each rank's results."""
    work = tmp_path_factory.mktemp("k7")
    docs = _docs(n=300, seed=11, uniq=True)
    inputs = {
        "query": _query_cases(), "docs": docs, "store_queries": QUERIES[:3],
        "facets": facet_case, "vector": _vector_cases(), "merge": _merge_case(),
        "merge_k": 12, "dryrun_docs": 4000,
    }
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(RANKS), str(work)],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(RANKS)
    ]
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        logs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"the {RANKS} gloo ranks did not finish in {RANKS_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log.decode()[-4000:]}"
    out = []
    for r in range(RANKS):
        with open(work / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out, inputs, logs[0].decode()


@pytest.fixture(scope="module")
def mesh():
    return jsh.make_mesh(RANKS)


def test_ranks_form_one_group(ranks):
    out, _inputs, log = ranks
    assert [o["rank"] for o in out] == list(range(RANKS))
    assert all(o["size"] == RANKS for o in out)
    # the dry run (rank 0 prints) passed every check in the group
    assert f"dryrun_multichip({RANKS}): 4000-doc corpus, typo/filter/tie/facet/vector" in log


@pytest.mark.parametrize("case", range(4))
def test_sharded_query_topk_matches_jax(ranks, mesh, case):
    out, inputs, _log = ranks
    args, k = inputs["query"][case]
    want_docs, want_hi = jsh.sharded_query_topk(mesh, tuple(map(jnp.asarray, args)), k=k)
    single = jds.chain_query_topk(*map(jnp.asarray, args), k=k)
    assert np.array_equal(np.asarray(want_docs), np.asarray(single[0]))
    for o in out:
        docs, hi = o["query"][case]
        assert docs.tolist() == np.asarray(want_docs).tolist()
        assert hi.tolist() == np.asarray(want_hi).tolist()


@pytest.mark.parametrize("query", QUERIES[:3])
def test_sharded_store_topk_matches_jax_and_host(ranks, mesh, query):
    out, inputs, _log = ranks
    jstore = _store(JaxStore, inputs["docs"])
    want = jsh.sharded_store_topk(mesh, jstore, query, k=10)
    host = JaxSearch(jstore, query=query, limit=10).execute().documents_ids
    assert want.tolist() == list(host)
    for o in out:
        assert o["store"][query].tolist() == want.tolist()


def test_sharded_facet_counts_match_jax(ranks, mesh, facet_case):
    out, _inputs, _log = ranks
    mask, vids, n_values = facet_case
    want = jsh.sharded_facet_counts(mesh, jnp.asarray(mask), jnp.asarray(vids), n_values)
    for o in out:
        assert o["facets"].dtype == np.int32 and np.array_equal(o["facets"], np.asarray(want))


@pytest.mark.parametrize("case", ["random", "exact"])
def test_sharded_vector_topk_matches_jax(ranks, mesh, case):
    out, inputs, _log = ranks
    i = ["random", "exact"].index(case)
    matrix, docids, q = inputs["vector"][i]
    want_ids, want_scores = jsh.sharded_vector_topk(mesh, matrix, docids, q, k=10)
    for o in out:
        ids, scores = o["vector"][i]
        assert ids.tolist() == want_ids.tolist()
        # float32 products summed in another order: an ulp or two
        np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-6)
        if case == "exact":
            assert np.array_equal(scores.view(np.int32), np.asarray(want_scores).view(np.int32))


def test_sharded_vector_topk_matches_host_exact_search(ranks):
    """The random case against the host's exact search, as the dry run
    holds it (tests/test_vector_scale.py's numpy pass)."""
    out, inputs, _log = ranks
    matrix, docids, q = inputs["vector"][0]
    cos = (matrix @ (q / np.linalg.norm(q))) / np.maximum(np.linalg.norm(matrix, axis=1), 1e-30)
    order = np.argsort(-cos, kind="stable")[:10]
    for o in out:
        assert o["vector"][0][0].tolist() == docids[order].tolist()


def test_vector_merge_orders_signed_zeros_as_xla(ranks):
    """+0.0 and -0.0 equal (lax.sort takes -0.0 as +0.0), equal scores by
    docid: the rank-major gather and merge against
    `lax.sort((-scores, ids), num_keys=2)`, scores bit for bit."""
    out, inputs, _log = ranks
    scores, ids = (a.reshape(-1) for a in inputs["merge"])
    neg, want_ids = jax.lax.sort((-jnp.asarray(scores), jnp.asarray(ids)), num_keys=2)
    k = inputs["merge_k"]
    for o in out:
        got_ids, got_scores = o["merge"]
        assert got_ids.tolist() == np.asarray(want_ids)[:k].tolist()
        want_bits = (-np.asarray(neg)[:k]).view(np.int32)
        assert got_scores.view(np.int32).tolist() == want_bits.tolist()
    # the case holds both zeros among the merged
    assert np.signbit(scores[scores == 0]).any() and (~np.signbit(scores[scores == 0])).any()


def test_parallel_package_exports_lazily():
    code = ("import sys; import meilisearch_tpu_torch.parallel as p;"
            " assert 'meilisearch_tpu_torch.parallel.sharded' not in sys.modules;"
            " assert p.make_group.__module__.endswith('sharded'); print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr[-2000:]


def test_entry_returns_the_flagship_step_on_the_cpu():
    fn, args = entry(device="cpu")
    got = fn(*args)
    want = jds.chain_query_topk(*jds.example_inputs(T=4, N=8192, k=10), k=10)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_dryrun_spawns_its_ranks():
    """Outside a process group, dryrun_multichip starts one process a
    rank (gloo on the CPU); it refuses more cards than the machine has."""
    dryrun_multichip(2, device="cpu", n_docs=3000)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        dryrun_multichip(torch.cuda.device_count() + 1)
