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
K3 stages nothing through shared memory: each thread loads its own row,
so there is no tile mapping to walk here.

The JAX package is imported inside the tests that compare with it, so the
`cuda` test runs where jax is absent (`--noconftest`)."""

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


@pytest.mark.parametrize("max_dist", [1, 2])
@pytest.mark.parametrize("m", range(MAX_LEN + 1))
def test_plain_matches_jax_and_host(m, max_dist):
    import jax.numpy as jnp

    from meilisearch_tpu.ops.device_osa import osa_device as jax_osa_device

    mat, lens = VOCAB
    q = _query(mat, lens, m)
    full, prefix = osa.osa_device(
        torch.from_numpy(mat), torch.from_numpy(lens), torch.from_numpy(q), m, max_dist
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
    with pytest.raises(TypeError):
        osa.osa_device(mat.long(), lens, q, 3, 2)
    with pytest.raises(ValueError):
        osa.osa_device(mat[:, :16].contiguous(), lens, q, 3, 2)
    with pytest.raises(ValueError):
        osa.osa_device(mat, lens[:-1].contiguous(), q, 3, 2)
    with pytest.raises(ValueError):
        osa.osa_device(mat, lens, q, MAX_LEN + 1, 2)
    with pytest.raises(ValueError):
        osa.osa_device(mat, lens, q, 3, 3)


def test_non_cpu_tensor_never_runs_the_plain_version(monkeypatch):
    """Only a CPU tensor takes the plain version: anything else launches
    the kernel or raises."""

    def fell_back(*a, **k):
        raise AssertionError("the plain version stood in for the kernel")

    monkeypatch.setattr(osa, "osa_device_torch", fell_back)
    mat, lens = (torch.from_numpy(a).to("meta") for a in VOCAB)
    q = torch.zeros(MAX_LEN, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        osa.osa_device(mat, lens, q, 3, 2)


def test_refused_launch_raises():
    osa.check_launch(0)
    with pytest.raises(RuntimeError, match="cudaError_t 1"):
        osa.check_launch(1)  # cudaErrorInvalidValue


class _Store:
    osa_device = None
    osa_strict = False


def test_gate():
    store = _Store()
    assert not osa.device_osa_available(store, 1 << 20)  # no device: host
    store.osa_device = torch.device("cpu")
    assert not osa.device_osa_available(store, 1 << 20)  # CPU: host
    store.osa_strict = True
    assert osa.device_osa_available(store, 10)  # strict: any size
    store.osa_device, store.osa_strict = torch.device("cuda", 0), False
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
    store.osa_device = torch.device("cpu")
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
    port.osa_device, port.osa_strict = torch.device("cpu"), True
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
    store.osa_device, store.osa_strict = torch.device("cpu"), True
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
        assert store.osa_device == torch.device("cpu") and store.osa_strict
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
    mat, lens = (torch.from_numpy(a).to(dev) for a in VOCAB)
    for m in range(MAX_LEN + 1):
        q = torch.from_numpy(_query(*VOCAB, m)).to(dev)
        before = osa.LAUNCHES.value
        got = osa.osa_device(mat, lens, q, m, max_dist)
        torch.cuda.synchronize()
        assert osa.LAUNCHES.value == before + 1
        want = osa.osa_device_torch(mat, lens, q, m, max_dist)
        for g, w in zip(got, want):
            assert torch.equal(g, w), m
