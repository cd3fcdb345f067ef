"""K3 parity: the port's whole-vocabulary OSA pass against the JAX package.

`osa_device` on CPU tensors runs its plain torch version; it must equal
the JAX package's jitted `osa_device` (on the CPU) byte for byte, padding
rows included, and the host pass `levenshtein.osa_distances` on every real
row (a padding row's full distance is the host pass's m, the device
passes' 9999 clipped). The typo derivations through the port's device
route (`strict`) must equal the JAX package's under
MEILI_TPU_DEVICE_STRICT=1, and a typo search through the port's App on
its device route must give the hits of the JAX package's App. The kernel
itself is compared with its plain version on the card (marked `cuda`).
Its arithmetic is walked here: `kernel_walk` repeats csrc/osa.cu's
bit-parallel recurrence in numpy (uint32 masks, the wrapper's query
table, the length cuts, the `order` permutation, outputs scattered back
to vocabulary order) and must equal the JAX package, the plain version
and the host pass byte for byte.

The JAX package is imported inside the tests that compare with it, so the
`cuda` test runs where jax is absent (`--noconftest`)."""

import ctypes

import numpy as np
import pytest
import torch

from meilisearch_tpu_torch.ops import device_osa as osa
from meilisearch_tpu_torch.ops.levenshtein import MAX_LEN, osa_distances

N = 4096
ALPHABET = [ord(c) for c in "abcdef"] + [0xE9, 0x436, 0x1F600]


def _vocab(seed: int = 3):
    """(mat, lens) numpy: N seeded words of lengths 0-32 over a small
    alphabet with non-ASCII codepoints; the last 64 rows are padding."""
    rng = np.random.default_rng(seed)
    lens = np.where(rng.random(N) < 0.7, rng.integers(1, 12, N), rng.integers(0, 33, N))
    lens[-64:] = 0
    mat = np.array(ALPHABET)[rng.integers(0, len(ALPHABET), size=(N, MAX_LEN))]
    mat = np.where(np.arange(MAX_LEN)[None, :] < lens[:, None], mat, 0)
    return mat.astype(np.int32), lens.astype(np.int32)


def _query(mat, lens, m: int) -> np.ndarray:
    """A query of length m: a vocabulary word's prefix (or the word padded
    with random letters) with one substitution and one transposition."""
    rng = np.random.default_rng(100 + m)
    row = mat[int(rng.choice(np.flatnonzero(lens >= min(m, 31))))]
    q = np.zeros(MAX_LEN, np.int32)
    q[:m] = row[:m]
    q[:m][q[:m] == 0] = ALPHABET[0]
    if m >= 3:
        q[m - 1] = ALPHABET[int(rng.integers(0, len(ALPHABET)))]
        q[1], q[2] = q[2], q[1]
    return q


VOCAB = _vocab()


def _mult_slot(c: int, mult: int) -> int:
    return ((c * mult) & 0xFFFFFFFF) >> (32 - osa.SLOT_BITS)


def _adversarial_vocab(cps: list[int], seed: int):
    """(mat, lens): N words over the query's own codepoints and ALPHABET,
    lengths 0-32, with the query itself, its prefixes and one- and
    two-edit variants among them; the rows sorted by DEcreasing length,
    so no warp of vocabulary order holds one length."""
    rng = np.random.default_rng(seed)
    letters = np.array(sorted(set(cps) | set(ALPHABET)))
    lens = rng.integers(0, MAX_LEN + 1, N)
    mat = letters[rng.integers(0, len(letters), size=(N, MAX_LEN))]
    for r in range(0, N, 8):
        w = list(cps)
        for _ in range(r % 3):
            i = int(rng.integers(1, max(len(w), 2)))
            if i < len(w) and rng.random() < 0.5:
                w[i - 1], w[i] = w[i], w[i - 1]
            elif w:
                w[i % len(w)] = int(letters[rng.integers(0, len(letters))])
        w = w[: int(rng.integers(max(len(w) - 3, 0), len(w) + 1))]
        mat[r, : len(w)] = w
        lens[r] = len(w)
    lens[-64:] = 0
    mat = np.where(np.arange(MAX_LEN)[None, :] < lens[:, None], mat, 0)
    by_len = np.argsort(-lens, kind="stable")
    return mat[by_len].astype(np.int32), lens[by_len].astype(np.int32)


def _adversarial_queries() -> dict:
    """Queries the query table must survive: 32 distinct codepoints up to
    U+1F600; 32 codepoints equal modulo 128 (a naive hash's slot); 32
    that share one slot under query_table's first multiplier."""
    distinct = ALPHABET + [0x41 + k for k in range(20)] + [0x10FFFF, 0x3042, 0x1F4A9]
    same_mod = [0x61 + 128 * k for k in range(MAX_LEN)]
    first = [c for c in range(0x61, 0x40000)
             if _mult_slot(c, osa.FIRST_MULT) == _mult_slot(0x61, osa.FIRST_MULT)]
    return {"32_distinct": distinct, "same_mod_128": same_mod,
            "first_mult_collide": first[:MAX_LEN]}


ADVERSARIAL = _adversarial_queries()


def kernel_walk(mat, lens, order, cps, max_dist):
    """csrc/osa.cu in numpy: thread t takes row order[t], loads the
    16-byte vectors below its cut, runs the bit-vector recurrence with
    the query table of `osa.query_table`, and writes (full, prefix) int8
    at its own row."""
    n, m, cap = len(lens), len(cps), max_dist + 1
    mult, key, mask = osa.query_table(cps)
    key, mask = np.asarray(key, np.int64), np.asarray(mask, np.uint32)
    rows = np.asarray(order, np.int64)
    ln = lens[rows].astype(np.int64)
    if m == 0:
        full = np.where(ln == 0, cap, np.minimum(ln, cap))
        best = np.zeros(n, np.int64)
    else:
        cut = np.where(ln < m - max_dist, 0, np.minimum(ln, m + max_dist))
        vec_loaded = (np.arange(MAX_LEN) // 4 * 4)[None, :] < cut[:, None]
        words = np.where(vec_loaded, mat[rows], 0).astype(np.uint64)
        ones = np.uint32(0xFFFFFFFF)
        vp = np.full(n, ones, np.uint32)
        vn, d0, pm_prev = (np.zeros(n, np.uint32) for _ in range(3))
        score = np.full(n, m, np.int64)
        best = score.copy()
        sh, one = np.uint32(m - 1), np.uint32(1)
        for j in range(MAX_LEN):
            live = j < cut
            c = words[:, j]
            slot = ((c * np.uint64(mult)) & np.uint64(0xFFFFFFFF)) >> np.uint64(
                32 - osa.SLOT_BITS)
            pm = np.where(key[slot] == c.astype(np.int64), mask[slot], 0).astype(np.uint32)
            tr = ((~d0 & pm) << one) & pm_prev
            nd0 = (((pm & vp) + vp) ^ vp) | pm | vn | tr
            hp = vn | ~(nd0 | vp)
            hn = vp & nd0
            nscore = score + ((hp >> sh) & one).astype(np.int64) - (
                (hn >> sh) & one).astype(np.int64)
            hp = (hp << one) | one
            hn = hn << one
            vp = np.where(live, hn | ~(nd0 | hp), vp)
            vn = np.where(live, hp & nd0, vn)
            d0 = np.where(live, nd0, d0)
            pm_prev = np.where(live, pm, pm_prev)
            score = np.where(live, nscore, score)
            best = np.where(live, np.minimum(best, nscore), best)
        full = np.where((ln == 0) | (cut < ln), cap, score)
    assert np.array_equal(np.sort(rows), np.arange(n)), "order is not a permutation"
    out_full = np.empty(n, np.int8)
    out_prefix = np.empty(n, np.int8)
    out_full[rows] = np.minimum(full, cap)
    out_prefix[rows] = np.minimum(best, cap)
    return out_full, out_prefix


def _hold_walk(mat, lens, cps, max_dist):
    """kernel_walk over the length order against the JAX package's
    osa_device, the plain version, and the host pass on real rows."""
    import jax.numpy as jnp

    from meilisearch_tpu.ops.device_osa import osa_device as jax_osa_device

    m = len(cps)
    q = np.zeros(MAX_LEN, np.int32)
    q[:m] = cps
    order = osa.length_order(torch.from_numpy(lens)).numpy()
    wf, wp = kernel_walk(mat, lens, order, cps, max_dist)
    jf, jp = jax_osa_device(
        jnp.asarray(mat), jnp.asarray(lens), jnp.asarray(q), jnp.int32(m),
        n=len(lens), max_dist=max_dist,
    )
    np.testing.assert_array_equal(wf, np.asarray(jf))
    np.testing.assert_array_equal(wp, np.asarray(jp))
    pf, pp = osa.osa_device_torch(
        torch.from_numpy(mat), torch.from_numpy(lens), torch.from_numpy(q), m, max_dist
    )
    np.testing.assert_array_equal(wf, pf.numpy())
    np.testing.assert_array_equal(wp, pp.numpy())
    real = lens > 0
    hf, hp = osa_distances("".join(map(chr, cps)), mat, lens, max_dist)
    np.testing.assert_array_equal(wf[real], hf[real])
    np.testing.assert_array_equal(wp[real], hp[real])


@pytest.mark.parametrize("max_dist", [1, 2])
@pytest.mark.parametrize("m", range(MAX_LEN + 1))
def test_plain_matches_jax_and_host(m, max_dist):
    import jax.numpy as jnp

    from meilisearch_tpu.ops.device_osa import osa_device as jax_osa_device

    mat, lens = VOCAB
    q = _query(mat, lens, m)
    lens_t = torch.from_numpy(lens)
    full, prefix = osa.osa_device(
        torch.from_numpy(mat), lens_t, torch.from_numpy(q), m, max_dist,
        osa.length_order(lens_t),
    )
    assert full.dtype == prefix.dtype == torch.int8
    jf, jp = jax_osa_device(
        jnp.asarray(mat), jnp.asarray(lens), jnp.asarray(q), jnp.int32(m),
        n=N, max_dist=max_dist,
    )
    np.testing.assert_array_equal(full.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(prefix.numpy(), np.asarray(jp))

    real = lens > 0
    text = "".join(map(chr, q[:m]))
    hf, hp = osa_distances(text, mat, lens, max_dist)
    np.testing.assert_array_equal(full.numpy()[real], hf[real])
    np.testing.assert_array_equal(prefix.numpy()[real], hp[real])


@pytest.mark.parametrize("max_dist", [1, 2])
@pytest.mark.parametrize("m", range(MAX_LEN + 1))
def test_kernel_walk_matches_jax_plain_and_host(m, max_dist):
    mat, lens = VOCAB
    _hold_walk(mat, lens, _query(mat, lens, m)[:m].tolist(), max_dist)


@pytest.mark.parametrize("max_dist", [1, 2])
@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
def test_kernel_walk_adversarial_queries(name, max_dist):
    cps = ADVERSARIAL[name]
    mat, lens = _adversarial_vocab(cps, seed=len(name))
    assert (np.diff(lens) <= 0).all()  # rows in decreasing length order
    _hold_walk(mat, lens, cps, max_dist)
    for m in (1, 5, 17, 31):  # and prefixes of the query
        _hold_walk(mat, lens, cps[:m], max_dist)


@pytest.mark.parametrize("name", sorted(ADVERSARIAL) + ["empty", "repeats"])
def test_query_table_is_collision_free(name):
    cps = {"empty": [], "repeats": [0x61, 0x62, 0x61, 0x1F600, 0x61]}.get(name)
    cps = ADVERSARIAL[name] if cps is None else cps
    mult, key, mask = osa.query_table(cps)
    assert mult % 2 == 1 and len(key) == len(mask) == osa.SLOTS
    assert all(-1 <= k <= 0x10FFFF for k in key) and all(0 <= b < 1 << 32 for b in mask)
    want = {}
    for i, c in enumerate(cps):
        want[c] = want.get(c, 0) | (1 << i)
    for c, bits in want.items():
        slot = _mult_slot(c, mult)
        assert key[slot] == c and mask[slot] == bits
    filled = np.asarray(key) != -1
    assert filled.sum() == len(want)  # one slot per distinct codepoint
    assert (np.asarray(mask)[~filled] == 0).all()
    if name == "first_mult_collide":
        assert mult != osa.FIRST_MULT
    params = osa.query_params(cps, 2)
    assert ctypes.sizeof(params) == 8 * osa.SLOTS + 12  # csrc/osa.cu's OsaQuery
    assert (params.mult, params.m, params.max_dist) == (mult, len(cps), 2)
    assert list(params.key) == key and list(params.mask) == mask


@pytest.mark.parametrize("n_keys", [0, 1, 5, 12, 20, 26, 32])
def test_multiplier_search_takes_the_first_free_multiplier(n_keys):
    """`_free_mult` (Python tries, then numpy blocks) returns the first
    multiplier of the sequence under which the keys' slots differ."""
    rng = np.random.default_rng(n_keys)
    for _ in range(20):
        keys = rng.choice(0x110000, size=n_keys, replace=False).tolist()
        k = 0
        while True:
            mult = (osa.FIRST_MULT + k * osa.MULT_STEP) & 0xFFFFFFFF
            if len({_mult_slot(c, mult) for c in keys}) == n_keys:
                break
            k += 1
        assert osa._free_mult(keys) == mult


def test_device_vocab_orders_rows_by_length_once_per_upload(monkeypatch):
    from meilisearch_tpu_torch.ops.levenshtein import pack_words

    mat, lens = VOCAB
    dv = osa.DeviceVocab(mat[:3000], lens[:3000], torch.device("cpu"))
    order = dv.order.numpy()
    assert dv.order.dtype == torch.int32 and dv.n == 4096
    assert np.array_equal(np.sort(order), np.arange(dv.n))  # a permutation
    by_len = dv.lens.numpy()[order]
    assert (np.diff(by_len) >= 0).all()
    ties = np.diff(by_len) == 0
    assert (np.diff(order)[ties] > 0).all()  # stable: row order within a length

    builds = []
    real = osa.length_order
    monkeypatch.setattr(osa, "length_order", lambda x: builds.append(1) or real(x))
    words = ["quick", "quack", "brown", "fox", "lazy", "dog"]
    wmat, wlens = pack_words(words)
    store = _Store()
    store.device = torch.device("cpu")
    for q in ("quick", "brwn", "fx"):
        osa.osa_distances_device(store, wmat, wlens, q)
    assert len(builds) == 1  # one order per upload, reused by every query
    wmat2, wlens2 = pack_words(words + ["lizard"])  # a promotion re-uploads
    osa.osa_distances_device(store, wmat2, wlens2, "lizrd")
    assert len(builds) == 2


def test_padding_rows_clip_to_the_cap():
    mat, lens = VOCAB
    for m, max_dist in ((0, 1), (1, 2), (3, 2), (7, 1)):
        full, prefix = osa.osa_device_torch(
            torch.from_numpy(mat), torch.from_numpy(lens),
            torch.from_numpy(_query(mat, lens, m)), m, max_dist,
        )
        pad = lens == 0
        assert (full.numpy()[pad] == max_dist + 1).all()
        want = min(m, max_dist + 1) if m <= max_dist else max_dist + 1
        assert (prefix.numpy()[pad] == want).all()


def test_wrapper_rejects_bad_inputs():
    mat, lens = (torch.from_numpy(a) for a in VOCAB)
    q = torch.zeros(MAX_LEN, dtype=torch.int32)
    order = osa.length_order(lens)
    with pytest.raises(TypeError):
        osa.osa_device(mat.long(), lens, q, 3, 2, order)
    with pytest.raises(ValueError):
        osa.osa_device(mat[:, :16].contiguous(), lens, q, 3, 2, order)
    with pytest.raises(ValueError):
        osa.osa_device(mat, lens[:-1].contiguous(), q, 3, 2, order)
    with pytest.raises(ValueError):
        osa.osa_device(mat, lens, q, MAX_LEN + 1, 2, order)
    with pytest.raises(ValueError):
        osa.osa_device(mat, lens, q, 3, 3, order)
    with pytest.raises(TypeError):
        osa.osa_device(mat, lens, q, 3, 2)  # the order is required
    with pytest.raises(TypeError):
        osa.osa_device(mat, lens, q, 3, 2, torch.arange(N))  # int64
    with pytest.raises(ValueError):
        osa.osa_device(mat, lens, q, 3, 2, torch.arange(N - 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="q must lie on the CPU"):
        osa.osa_device(mat, lens, q.to("meta"), 3, 2, order)


def test_non_cpu_tensor_never_runs_the_plain_version(monkeypatch):
    """Only a CPU tensor takes the plain version: anything else launches
    the kernel or raises."""

    def fell_back(*a, **k):
        raise AssertionError("the plain version stood in for the kernel")

    monkeypatch.setattr(osa, "osa_device_torch", fell_back)
    mat, lens = (torch.from_numpy(a).to("meta") for a in VOCAB)
    order = torch.arange(N, dtype=torch.int32, device="meta")
    q = torch.zeros(MAX_LEN, dtype=torch.int32)  # the query stays on the host
    with pytest.raises(ValueError, match="cuda or cpu"):
        osa.osa_device(mat, lens, q, 3, 2, order)


def test_refused_launch_raises():
    osa.check_launch(0)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        osa.check_launch(1)  # cudaErrorInvalidValue


class _Store:
    device = None
    osa_strict = False


def test_gate():
    store = _Store()
    assert not osa.device_osa_available(store, 1 << 20)  # no device: host
    store.device = torch.device("cpu")
    assert not osa.device_osa_available(store, 1 << 20)  # CPU: host
    store.osa_strict = True
    assert osa.device_osa_available(store, 10)  # strict: any size
    store.device, store.osa_strict = torch.device("cuda", 0), False
    assert not osa.device_osa_available(store, osa.MIN_DEVICE_VOCAB - 1)
    assert osa.device_osa_available(store, osa.MIN_DEVICE_VOCAB)


def test_distances_device_matches_host_and_caches_the_vocabulary():
    from meilisearch_tpu_torch.ops.levenshtein import pack_words

    rng = np.random.default_rng(11)
    words = sorted({
        "".join(rng.choice(list("abcdef"), size=rng.integers(1, 14)))
        for _ in range(3000)
    })
    mat, lens = pack_words(words)
    store = _Store()
    store.device = torch.device("cpu")
    for q in ("ace", "fedcba", "abcdefab", "a", "abcabcabcabcabc", ""):
        hf, hp = osa_distances(q, mat, lens)
        df, dp = osa.osa_distances_device(store, mat, lens, q)
        assert df.dtype == dp.dtype == np.int32
        np.testing.assert_array_equal(hf, df)
        np.testing.assert_array_equal(hp, dp)
    dv = store._device_vocab[1]
    assert dv.n_real == len(words) and dv.n == 4096
    osa.osa_distances_device(store, mat, lens, "abc")
    assert store._device_vocab[1] is dv  # the upload is reused


DERIVATION_DOCS = [
    {"id": i, "t": w}
    for i, w in enumerate(
        ["quick", "quack", "quicc", "qiuck", "kuick", "quickest",
         "brown", "quik", "xquick", "quicky", "chien", "chine",
         "machine", "machines", "mischief"]
    )
]
DERIVATION_TERMS = (
    ("quick", False), ("quick", True), ("machin", True),
    ("mchine", False), ("quickl", False),
)


def test_typo_derivations_match_the_jax_package(monkeypatch):
    """The case of tests/test_device_osa.py: the port's strict device route
    (plain version on the CPU) against the JAX package's strict device
    route, and both against the port's host pass."""
    from meilisearch_tpu.index.store import IndexStore as JaxStore
    from meilisearch_tpu.search.query_terms import DerivationContext as JaxContext
    from meilisearch_tpu_torch.index.store import IndexStore
    from meilisearch_tpu_torch.search.query_terms import DerivationContext

    def derive(store, context):
        store.add_documents([dict(d) for d in DERIVATION_DOCS])
        ctx = context(store, store.settings)
        out = {}
        for word, prefix in DERIVATION_TERMS:
            t = ctx._base_term_uncached(word, 2, prefix, False)
            out[(word, prefix)] = (t.one_typo, t.two_typos)
        return out

    monkeypatch.setenv("MEILI_TPU_DEVICE_STRICT", "1")
    want = derive(JaxStore("t"), JaxContext)
    port = IndexStore("t")
    port.device, port.osa_strict = torch.device("cpu"), True
    calls = []
    real = osa.osa_distances_device
    monkeypatch.setattr(
        osa, "osa_distances_device", lambda *a, **k: calls.append(1) or real(*a, **k)
    )
    assert derive(port, DerivationContext) == want
    assert len(calls) == len(DERIVATION_TERMS)
    assert derive(IndexStore("t"), DerivationContext) == want  # host pass


def test_typo_pass_device_error_raises_and_is_counted(monkeypatch):
    from meilisearch_tpu_torch.index.store import IndexStore
    from meilisearch_tpu_torch.search.device_batch import serving_stats
    from meilisearch_tpu_torch.search.query_terms import DerivationContext

    def refused(*a, **k):
        raise RuntimeError("osa kernel launch failed: cudaError_t 1")

    monkeypatch.setattr(osa, "osa_distances_device", refused)
    store = IndexStore("t")
    store.device, store.osa_strict = torch.device("cpu"), True
    store.add_documents([dict(d) for d in DERIVATION_DOCS])
    ctx = DerivationContext(store, store.settings)
    before = serving_stats()["device_errors"]
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        ctx._base_term_uncached("quick", 2, False, False)
    assert serving_stats()["device_errors"] == before + 1


def test_typo_search_through_both_apps(monkeypatch):
    from meilisearch_tpu.api.app import App as JaxApp
    from meilisearch_tpu.api.app import TestClient as JaxClient
    from meilisearch_tpu_torch.api.app import App, TestClient
    from meilisearch_tpu_torch.utils.synthetic import generate_large_vocab

    # the JAX App serves on its host paths (a strict one would compile its
    # device programs on daemon threads); the port's App runs its device
    # routes, K1 and K3, in their plain versions
    monkeypatch.delenv("MEILI_TPU_DEVICE_STRICT", raising=False)
    _vocab, docs, queries = generate_large_vocab(1 << 11, seed=5)
    jax_app, app = JaxApp(), App(device="cpu", strict=True)
    try:
        clients = [JaxClient(jax_app), TestClient(app)]
        for c in clients:
            c.update_settings("typo", {"searchableAttributes": ["title"]})
            assert c.add_documents("typo", docs)["status"] == "succeeded"
        store = app.scheduler.index("typo")
        assert store.device == torch.device("cpu") and store.osa_strict
        for q in queries:
            want, got = (c.search("typo", dict(q)) for c in clients)
            assert want.status == got.status == 200, (q, got.json)
            assert [h["id"] for h in got.json["hits"]] == [
                h["id"] for h in want.json["hits"]
            ], q
            assert got.json["estimatedTotalHits"] == want.json["estimatedTotalHits"]
        assert store._device_vocab is not None  # the device route ran
    finally:
        for a in (jax_app, app):
            a.search_batcher.stop()
            a.scheduler.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("max_dist", [1, 2])
def test_kernel_matches_plain_on_the_card(max_dist):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cases = [(VOCAB, _query(*VOCAB, m)[:m].tolist()) for m in range(MAX_LEN + 1)]
    for name, cps in sorted(ADVERSARIAL.items()):
        cases += [(_adversarial_vocab(cps, seed=len(name)), cps[:m]) for m in (5, 17, 32)]
    for k, ((mat_np, lens_np), cps) in enumerate(cases):
        dv = osa.DeviceVocab(mat_np, lens_np, dev)
        m = len(cps)
        q = np.zeros(MAX_LEN, np.int32)
        q[:m] = cps
        qt = torch.from_numpy(q)  # the kernel takes the query on the host
        before = osa.LAUNCHES.value
        got = osa.osa_device(dv.mat, dv.lens, qt, m, max_dist, dv.order)
        torch.cuda.synchronize()
        assert osa.LAUNCHES.value == before + 1
        want = osa.osa_device_torch(dv.mat, dv.lens, qt.to(dev), m, max_dist)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (k, m)
