"""Vector legs: the port's device legs against the JAX package's.

The JAX package's device legs (`_device_topk_dispatch`, `_device_cosine`,
`_device_hamming`) run jitted on its CPU backend; the port's run on stores
bound to the CPU (`store.device`), where K4h is its plain torch version
(`hamming_rows_torch`). Inputs are seeded numpy draws given to both.

- Binary-quantized results are exact: hamming distances are integers and
  the cosine (dim - 2h) / dim takes the same roundings in both, so docids
  (in `lax.top_k`'s tie order) and scores must be equal.
- Float results: docids in order, scores within 1e-5 (the tolerance of
  tests/test_vector_scale.py): the matrix-vector product sums in another
  order in torch than in XLA, which moves float32 cosines by a few ulps.

The kernel itself is compared with its plain version on the card in
tests/test_torch_cuda.py (marked `cuda`)."""

import numpy as np
import pytest
import torch

from meilisearch_tpu.api.app import App as JaxApp
from meilisearch_tpu.api.app import TestClient as JaxClient
from meilisearch_tpu.index.store import IndexStore as JaxStore
from meilisearch_tpu.ops.backend_probe import backend_kind
from meilisearch_tpu.vector import store as jax_vs
from meilisearch_tpu_torch.api.app import App, TestClient
from meilisearch_tpu_torch.index.store import IndexStore
from meilisearch_tpu_torch.ops import hamming
from meilisearch_tpu_torch.search.device_batch import serving_stats
from meilisearch_tpu_torch.vector import store as vs

CPU = torch.device("cpu")
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _jax_device_legs():
    """The JAX package takes its device legs only once its backend probe
    has resolved (tests/test_vector_scale.py::_wait_backend)."""
    assert backend_kind(wait_s=60.0) == "cpu"
    torch.backends.cuda.matmul.allow_tf32 = False  # the float leg's precision


def _stores(vectors_per_doc, dim, quantized=False):
    """The same documents in a JAX store and in a port store bound to the
    CPU; vectors_per_doc is a list of (rows, dim) arrays, one per doc."""
    conf = {"source": "userProvided", "dimensions": dim}
    if quantized:
        conf["binaryQuantized"] = True
    docs = [{"id": i, "_vectors": {"e": v.tolist()}} for i, v in enumerate(vectors_per_doc)]
    out = []
    for cls in (JaxStore, IndexStore):
        store = cls("t", primary_key="id")
        store.settings.apply_json({"embedders": {"e": conf}})
        store.add_documents([dict(d) for d in docs])
        out.append(store)
    out[1].device = CPU
    return out


def _multi(n, dim, seed):
    """n docs, every 7th with two vectors (tests/test_vector_scale.py:141)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2 if i % 7 == 0 else 1, dim)) for i in range(n)]


def _assert_same(got, want, exact):
    assert [d for d, _ in got] == [d for d, _ in want]
    if exact:
        assert [s for _, s in got] == [s for _, s in want]
    else:
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=ATOL)


def _on_device(searcher):
    return searcher._device.get(("matrix", CPU)) is not None


class _Holder:
    """What the JAX package's `_resident` needs of a searcher."""

    def __init__(self):
        self._device = {}


@pytest.mark.parametrize("W", [1, 4, 12, 24, 48])
def test_hamming_plain_matches_jax(W):
    rng = np.random.default_rng(W)
    packed = rng.integers(0, 1 << 32, size=(777, W), dtype=np.uint64).astype(np.uint32)
    packed[::3, 0] |= np.uint32(1 << 31)  # bit 31 set: negative as int32
    packed[5] = 0xFFFFFFFF
    qbits = rng.integers(0, 1 << 32, size=W, dtype=np.uint64).astype(np.uint32)
    qbits[0] |= np.uint32(1 << 31)
    want = jax_vs._device_hamming(_Holder(), packed, qbits)
    mat = torch.from_numpy(packed.view(np.int32))
    q = torch.from_numpy(qbits.view(np.int32))
    got = hamming.hamming_rows_torch(mat, q)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    before = hamming.LAUNCHES.value
    assert torch.equal(hamming.hamming_rows(mat, q), got)  # CPU: the plain version
    assert hamming.LAUNCHES.value == before


@pytest.mark.parametrize("dim", [32, 64, 100, 768, 1536])
def test_hamming_cosine_rounds_as_the_host(dim):
    """Every cosine a hamming distance can give, bit for bit as the host
    pass and the JAX package compute it."""
    ham = np.arange(dim + 1, dtype=np.int32)
    want = (dim - 2.0 * ham.astype(np.float32)) / dim
    got = hamming.ham_cos(torch.from_numpy(ham), dim).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_hamming_rows_checks_its_inputs():
    mat = torch.zeros((8, 4), dtype=torch.int32)
    q = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        hamming.hamming_rows(mat.long(), q)
    with pytest.raises(ValueError):
        hamming.hamming_rows(mat, q[:3])
    with pytest.raises(ValueError):
        hamming.hamming_rows(mat.t(), q)  # not contiguous
    with pytest.raises(ValueError):
        hamming.hamming_rows(torch.zeros((8, hamming.MAX_WORDS + 1), dtype=torch.int32),
                             torch.zeros(hamming.MAX_WORDS + 1, dtype=torch.int32))
    with pytest.raises(ValueError):
        hamming.hamming_rows(mat.to("meta"), q.to("meta"))


@pytest.mark.parametrize("k", [1, 10, 50])
@pytest.mark.parametrize("quantized", [False, True])
def test_search_matches_jax(quantized, k):
    """4,500 docs, some with two vectors: 5,143 rows pad to 8,192, and
    the device top-k dedups to one hit per document."""
    jstore, pstore = _stores(_multi(4500, 64, seed=5), 64, quantized)
    js, ps = jax_vs.VectorSearcher(jstore, "e"), vs.VectorSearcher(pstore, "e")
    assert ps.matrix.shape[0] == 5143
    rng = np.random.default_rng(50 + k)
    for _ in range(3):
        q = rng.standard_normal(64).astype(np.float32)
        got = ps.search(q, k)
        _assert_same(got, js.search(q, k, universe=None), exact=quantized)
        assert len(got) == k
    assert ps._device[("matrix", CPU)][0].shape[0] == 8192
    # and the port's host pass on the same store agrees
    pstore.device = None
    host = vs.VectorSearcher(pstore, "e")
    assert host.device is None
    _assert_same(host.search(q, k), got, exact=quantized)


@pytest.mark.parametrize("quantized", [False, True])
def test_ties_in_the_reference_order(quantized):
    """dim 32 with every vector one of 40 (and the sign patterns of 40):
    nearly every score is tied, so the hits follow the tie order alone."""
    rng = np.random.default_rng(9)
    base = rng.standard_normal((40, 32))
    vecs = [base[i % 40][None, :] for i in range(4500)]
    jstore, pstore = _stores(vecs, 32, quantized)
    js, ps = jax_vs.VectorSearcher(jstore, "e"), vs.VectorSearcher(pstore, "e")
    for k in (1, 10, 50):
        q = (base[k % 40] + 0.3 * rng.standard_normal(32)).astype(np.float32)
        got = ps.search(q, k)
        _assert_same(got, js.search(q, k, universe=None), exact=quantized)
    assert _on_device(ps)


def test_topk_order_is_lax_top_k():
    """`_topk_desc` against `jax.lax.top_k`: ties (lower index first),
    +0.0 above -0.0, negatives, the -2.0 mask; and a bare torch.topk,
    which orders ties otherwise, differs."""
    import jax

    rng = np.random.default_rng(11)
    cases = [
        np.array([0.5, 0.7, 0.5, 0.7, 0.5, 0.1, 0.7], np.float32),
        np.array([0.0, -0.0, 0.0, -0.0], np.float32),
        rng.choice(np.array([0.0, -0.0, 0.25, -0.25, -2.0, 1.0], np.float32), 4096),
        rng.integers(-3, 4, 8192).astype(np.float32) / 3,
    ]
    bare_differs = False
    for vals in cases:
        for kb in sorted({1, 3, len(vals) // 2, len(vals)}):
            jv, ji = jax.lax.top_k(vals, kb)
            got_v, got_i = vs._topk_desc(torch.from_numpy(vals), kb)
            assert np.array_equal(got_i.numpy(), np.asarray(ji))
            assert np.array_equal(got_v.numpy().view(np.int32), np.asarray(jv).view(np.int32))
            bare = torch.topk(torch.from_numpy(vals), kb).indices.numpy()
            bare_differs |= not np.array_equal(bare, np.asarray(ji))
    assert bare_differs


def test_signed_zero_similarities():
    """Rows whose cosine to the query is exactly +0.0 or -0.0 (the query
    is e0; row 0 entries +0.0 or -0.0, the rest negative): `lax.top_k`
    puts +0.0 first, and the port's hits follow it."""
    rng = np.random.default_rng(12)
    rows = -np.abs(rng.standard_normal((4200, 16))) - 0.1
    rows[:, 0] = np.where(rng.random(4200) < 0.5, 0.0, -0.0)
    rows[::50, 0] = 1.0  # a few rows above the zeros
    jstore, pstore = _stores([r[None, :] for r in rows], 16)
    q = np.zeros(16, np.float32)
    q[0] = 1.0
    js, ps = jax_vs.VectorSearcher(jstore, "e"), vs.VectorSearcher(pstore, "e")
    for k in (10, 120):
        _assert_same(ps.search(q, k), js.search(q, k, universe=None), exact=False)


def test_dedup_shortfall_falls_back(monkeypatch):
    """One document owns nearly every top row: the fetch bucket (512 rows
    for k = 80) dedups to fewer than k documents and the searcher re-runs
    the full column (tests/test_vector_scale.py:170, on the port, with
    600 rows stacked on the document so that the fallback is taken)."""
    rng = np.random.default_rng(6)
    base = rng.standard_normal(16)
    vecs = [base + 0.01 * rng.standard_normal((600, 16))]
    vecs += [rng.standard_normal((1, 16)) for _ in range(1, 4300)]
    jstore, pstore = _stores(vecs, 16)
    ps = vs.VectorSearcher(pstore, "e")
    calls = []
    orig = vs.VectorSearcher._search_sync

    def spy(self, q, k, universe):
        calls.append(k)
        return orig(self, q, k, universe)

    monkeypatch.setattr(vs.VectorSearcher, "_search_sync", spy)
    out = ps.search(base, 80)
    assert calls == [80]  # the shortfall's full column
    assert len(out) == 80 and out[0][0] == 0 and len({d for d, _ in out}) == 80
    want = jax_vs.VectorSearcher(jstore, "e").search(base, 80, universe=None)
    _assert_same(out, want, exact=False)


@pytest.mark.parametrize("quantized", [False, True])
def test_filtered_full_column(quantized, monkeypatch):
    """A universe sends the search to the full similarity column, read
    back from the device legs (`_device_cosine` / `_device_hamming`)."""
    jstore, pstore = _stores(_multi(4500, 64, seed=13), 64, quantized)
    legs = []
    for name in ("_device_cosine", "_device_hamming"):
        orig = getattr(vs, name)
        monkeypatch.setattr(vs, name, lambda *a, _o=orig, _n=name: legs.append(_n) or _o(*a))
    rng = np.random.default_rng(14)
    universe = {int(d) for d in rng.choice(4500, 900, replace=False)}
    js, ps = jax_vs.VectorSearcher(jstore, "e"), vs.VectorSearcher(pstore, "e")
    for k in (1, 20):
        q = rng.standard_normal(64).astype(np.float32)
        got = ps.search(q, k, universe)
        assert {d for d, _ in got} <= universe
        _assert_same(got, js.search(q, k, universe), exact=quantized)
    assert legs == ["_device_hamming" if quantized else "_device_cosine"] * 2


def test_resident_reused_within_a_generation_and_rebuilt_after_a_write():
    _, pstore = _stores(_multi(4200, 16, seed=15), 16)
    rng = np.random.default_rng(16)
    s = vs.VectorSearcher(pstore, "e")
    s.search(rng.standard_normal(16), 5)
    buf = s._device[("matrix", CPU)][0]
    s2 = vs.VectorSearcher(pstore, "e")  # a fresh wrapper, the same generation
    s2.search(rng.standard_normal(16), 5)
    assert s2._device[("matrix", CPU)][0] is buf
    new = rng.standard_normal(16)
    pstore.add_documents([{"id": 99999, "_vectors": {"e": new.tolist()}}])
    s3 = vs.VectorSearcher(pstore, "e")
    assert not s3._device  # a new generation uploads anew
    hits = s3.search(new, 3)
    assert s3._device[("matrix", CPU)][0] is not buf
    assert hits[0][0] == max(pstore.vectors["e"])  # the new document


def test_warm_vector_kernels_uploads():
    _, pstore = _stores(_multi(4200, 16, seed=17), 16)
    vs.warm_vector_kernels(pstore)
    assert _on_device(vs.VectorSearcher(pstore, "e"))
    pstore.device = None
    pstore.add_documents([{"id": 5000, "_vectors": {"e": [0.0] * 16}}])
    vs.warm_vector_kernels(pstore)  # unbound: the host pass, nothing uploaded
    assert not vs.VectorSearcher(pstore, "e")._device


def test_a_device_failure_raises_and_is_counted(monkeypatch):
    _, pstore = _stores(_multi(4200, 64, seed=18), 64, quantized=True)

    def broken(*args):
        raise RuntimeError("hamming kernel launch failed: cudaError_t 1")

    monkeypatch.setattr(vs, "hamming_keyed", broken)  # the top-k leg
    monkeypatch.setattr(vs, "hamming_rows", broken)  # the full column
    before = serving_stats()["device_errors"]
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        vs.VectorSearcher(pstore, "e").search(np.ones(64, np.float32), 5)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        vs.VectorSearcher(pstore, "e").search(np.ones(64, np.float32), 5, {1, 2, 3})
    assert serving_stats()["device_errors"] == before + 2


def test_hybrid_dispatches_the_semantic_side_first(monkeypatch):
    """execute_hybrid queues the semantic side's device work before the
    keyword execute, and passes universe=None when there is no filter
    (tests/test_vector_scale.py:193, on the port)."""
    from meilisearch_tpu_torch.search.executor import Search
    from meilisearch_tpu_torch.search.perform import perform_search

    _, pstore = _stores(_multi(4200, 8, seed=7), 8)
    events = []
    orig_async, orig_dispatch = vs.VectorSearcher.search_async, vs._device_topk_dispatch
    orig_execute = Search.execute

    def spy_async(self, query, k, universe=None):
        events.append(("search_async", universe))
        return orig_async(self, query, k, universe)

    def spy_dispatch(searcher, q, k):
        events.append(("dispatch", None))
        return orig_dispatch(searcher, q, k)

    def spy_execute(self):
        events.append(("keyword", None))
        return orig_execute(self)

    monkeypatch.setattr(vs.VectorSearcher, "search_async", spy_async)
    monkeypatch.setattr(vs, "_device_topk_dispatch", spy_dispatch)
    monkeypatch.setattr(Search, "execute", spy_execute)
    target = pstore.vectors["e"][3][0]
    res = perform_search(pstore, {
        "q": "", "vector": target.tolist(),
        "hybrid": {"semanticRatio": 0.5, "embedder": "e"}, "limit": 5,
    })
    assert events[:3] == [("search_async", None), ("dispatch", None), ("keyword", None)]
    assert res["hits"][0]["id"] == 3


# -- over HTTP: the JAX package's App against the port's App(device="cpu") --

SETTINGS = {
    "searchableAttributes": ["title"],
    "filterableAttributes": ["points"],
    "embedders": {"default": {"source": "userProvided", "dimensions": 32}},
}
WORDS = ["rust", "python", "search", "engine", "vector", "database", "cloud", "gpu"]


def _http_docs():
    rng = np.random.default_rng(21)
    centres = rng.standard_normal((16, 32))
    docs = []
    for i in range(4400):
        n_vec = 2 if i % 7 == 0 else 1
        vec = centres[i % 16] + 0.4 * rng.standard_normal((n_vec, 32))
        docs.append({
            "id": i,
            "title": " ".join(rng.choice(WORDS, size=3)),
            "points": int(rng.integers(0, 2000)),
            "_vectors": {"default": vec.tolist() if n_vec == 2 else vec[0].tolist()},
        })
    return docs, centres


def _requests(centres):
    rng = np.random.default_rng(22)
    out = []
    for r, ratio in enumerate((1.0, 0.5, 1.0, 0.5)):
        vec = (centres[r] + 0.1 * rng.standard_normal(32)).tolist()
        for filt in (None, "points > 1000"):
            body = {"vector": vec, "hybrid": {"semanticRatio": ratio, "embedder": "default"},
                    "showRankingScore": True, "limit": 20, "offset": 10 * (r % 2)}
            if ratio < 1.0:
                body["q"] = WORDS[r]
            if filt:
                body["filter"] = filt
            out.append(("search", body))
    for doc_id, filt in ((3, None), (40, "points > 1000")):
        body = {"id": doc_id, "embedder": "default", "showRankingScore": True, "limit": 15}
        if filt:
            body["filter"] = filt
        out.append(("similar", body))
    return out


def _compare(clients, requests, exact):
    for route, body in requests:
        want, got = (c.post(f"/indexes/vec/{route}", body=dict(body)) for c in clients)
        assert want.status == got.status == 200, (body, want.json, got.json)
        assert [h["id"] for h in got.json["hits"]] == [h["id"] for h in want.json["hits"]], body
        assert got.json.get("semanticHitCount") == want.json.get("semanticHitCount"), body
        scores = [[h["_rankingScore"] for h in r.json["hits"]] for r in (got, want)]
        if exact:
            assert scores[0] == scores[1], body
        else:
            np.testing.assert_allclose(scores[0], scores[1], atol=ATOL, err_msg=str(body))
        assert got.json["hits"], body


def test_http_hybrid_and_similar_match_jax():
    """Hybrid (semanticRatio 0.5 and 1.0, with and without a filter) and
    /similar, float and then binary-quantized (the same documents after
    `PATCH settings`): hit ids and semanticHitCount equal, scores within
    1e-5 for the float embedder and equal for the binary one."""
    apps = [JaxApp(), App(device="cpu")]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    try:
        docs, centres = _http_docs()
        for c in clients:
            c.update_settings("vec", SETTINGS)
            assert c.add_documents("vec", docs)["status"] == "succeeded"
        store = apps[1].scheduler.index("vec")
        assert store.device == CPU
        apps[1].warm_devices()
        requests = _requests(centres)
        _compare(clients, requests, exact=False)
        assert _on_device(vs.VectorSearcher(store, "default"))
        before = hamming.LAUNCHES.value
        for c in clients:
            bq = {"embedders": {"default": {"binaryQuantized": True}}}
            assert c.update_settings("vec", bq)["status"] == "succeeded"
        assert vs.VectorSearcher(store, "default").quantized
        _compare(clients, requests, exact=True)
        assert hamming.LAUNCHES.value == before  # the CPU runs the plain version
        assert _on_device(vs.VectorSearcher(store, "default"))
    finally:
        for a in apps:
            a.search_batcher.stop()
            a.scheduler.stop()
