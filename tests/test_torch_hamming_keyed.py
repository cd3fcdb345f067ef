"""K4h's keyed mode: the binary leg's cosine, pad mask and top-k key.

`ops.hamming.hamming_keyed_torch` (the plain version of the kernel's keyed
mode; on the CPU `hamming_keyed` runs it) followed by
`vector.store._topk_from_key` must give what the JAX package's jitted
hamming branch of `_device_topk_dispatch` gives (run on its CPU backend):
the same rows in `lax.top_k`'s order, and values that are its distances
through the host pass's division. Inputs are seeded numpy draws given to
both. The kernel itself is held
against the plain version on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from meilisearch_tpu.ops.backend_probe import backend_kind
from meilisearch_tpu.vector import store as jax_vs
from meilisearch_tpu_torch.ops import hamming
from meilisearch_tpu_torch.vector import store as vs

CPU = torch.device("cpu")
N_LIVE = 4100  # pads to 8,192 rows: half of them pad rows


@pytest.fixture(autouse=True)
def _jax_device_legs():
    """The JAX package's device legs need its backend probe resolved
    (tests/test_vector_scale.py::_wait_backend)."""
    assert backend_kind(wait_s=60.0) == "cpu"


class _Searcher:
    """What both packages' `_device_topk_dispatch` reads of a searcher."""

    def __init__(self, packed, dim, device=None):
        self.matrix, self.dim, self.quantized = packed, dim, True
        self.device, self._device = device, {}


def _tied_matrix(n, W, seed):
    """(n, W) uint32 sign words drawn from 24 patterns (so most distances
    tie), bit 31 set in about half the words and in every word of one
    pattern."""
    rng = np.random.default_rng(seed)
    patterns = rng.integers(0, 1 << 32, size=(24, W), dtype=np.uint64).astype(np.uint32)
    patterns[3] |= np.uint32(1 << 31)
    return patterns[rng.integers(0, 24, n)]


def _query(dim, seed):
    q = np.random.default_rng(seed).standard_normal(dim).astype(np.float32)
    q[31] = 1.0  # the first word's bit 31 set
    return q


@pytest.mark.parametrize("W", [1, 3, 4, 12, 24, 48])
def test_keyed_plain_matches_the_jax_hamming_branch(W):
    """n_live < n_pad, ties, bit 31: k = 30 (kb = 128 of the live rows)
    and k = 1100 (kb = 8,192, every row, the pad rows last). The rows
    equal the JAX program's in order. The values equal its distances
    through the host pass's IEEE division bit for bit, and its own values
    within one ulp: XLA's CPU backend multiplies by 1/dim, which rounds
    otherwise where dim is not a power of two (96 of W = 3 and up), while
    the numpy host pass of both packages divides."""
    dim = 32 * W
    packed = _tied_matrix(N_LIVE, W, seed=W)
    q = _query(dim, seed=100 + W)
    ham = jax_vs._device_hamming(_Searcher(packed, dim), packed, vs._pack_signs(q[None, :])[0])
    host = np.concatenate([(dim - 2.0 * ham.astype(np.float32)) / dim,
                           np.full(8192 - N_LIVE, -2.0, np.float32)])
    for k in (30, 1100):
        jv, ji, jkb, jn = jax_vs._device_topk_dispatch(_Searcher(packed, dim), q, k)
        pv, pi, pkb, pn = vs._device_topk_dispatch(_Searcher(packed, dim, CPU), q, k)
        jv, ji = np.asarray(jv), np.asarray(ji)
        assert (pkb, pn) == (jkb, jn)
        assert np.array_equal(pi.numpy(), ji)
        assert np.array_equal(pv.numpy().view(np.int32), host[ji].view(np.int32))
        assert np.abs(pv.numpy().view(np.int32) - jv.view(np.int32)).max() <= 1
        assert len(np.unique(pv.numpy())) < pkb // 2  # ties decided by row alone
    # the plain version itself on the padded matrix, as the leg calls it
    m_dev, n = vs._resident(_Searcher(packed, dim, CPU), "matrix", packed)
    qw = torch.from_numpy(vs._pack_signs(q[None, :])[0].view(np.int32))
    cos, key = hamming.hamming_keyed_torch(m_dev, qw, dim, n)
    assert np.array_equal(cos.numpy().view(np.int32), host.view(np.int32))
    vals, idx = vs._topk_from_key(cos, key, 128)
    jv, ji, _, _ = jax_vs._device_topk_dispatch(_Searcher(packed, dim), q, 30)
    assert np.array_equal(idx.numpy(), np.asarray(ji))


@pytest.mark.parametrize("dim", [32, 96, 768, 1536])
def test_keyed_cosine_and_key_for_every_distance(dim):
    """Row h lies at distance h from a zero query, h = 0..dim: its cosine
    bit for bit the host's division, its key the order-preserving bits
    of that cosine over 2^32 - 1 - h; the pad rows -2.0."""
    W = (dim + 31) // 32
    ham = np.arange(dim + 1)
    bits = np.arange(W * 32)[None, :] < ham[:, None]
    mat = np.packbits(bits, axis=1, bitorder="little").view(np.int32).reshape(dim + 1, W)
    mat = np.concatenate([mat, np.full((7, W), -1, np.int32)])  # 7 pad rows
    before = hamming.LAUNCHES.value
    cos, key = hamming.hamming_keyed(torch.from_numpy(mat), torch.zeros(W, dtype=torch.int32),
                                     dim, dim + 1)
    assert hamming.LAUNCHES.value == before  # the CPU runs the plain version
    want = np.concatenate([(dim - 2.0 * ham.astype(np.float32)) / dim,
                           np.full(7, -2.0, np.float32)]).astype(np.float32)
    assert cos.dtype == torch.float32 and key.dtype == torch.int64
    assert np.array_equal(cos.numpy().view(np.int32), want.view(np.int32))
    b = want.view(np.int32).astype(np.int64)
    ordered = np.where(b < 0, b ^ 0x7FFFFFFF, b)
    rows = np.arange(len(want), dtype=np.int64)
    assert np.array_equal(key.numpy(), ordered * (1 << 32) + (0xFFFFFFFF - rows))


@pytest.mark.parametrize("quantized", [False, True])
def test_topk_from_key_fails_on_a_bare_topk(quantized, monkeypatch):
    """Both legs select through `_topk_from_key`: each leg's rows are
    `jax.lax.top_k` of its own column, and with a bare torch.topk in its
    place the tie order leaves `lax.top_k`'s (as the tie tests of
    tests/test_torch_vector.py find)."""
    import jax

    dim = 32
    rng = np.random.default_rng(21)
    base = rng.standard_normal((40, dim)).astype(np.float32)
    floats = base[rng.integers(0, 40, N_LIVE)]
    q = _query(dim, seed=22)
    q = q / np.linalg.norm(q)
    if quantized:
        packed = vs._pack_signs(floats)
        searcher = _Searcher(packed, dim, CPU)
        m_dev, n = vs._resident(searcher, "matrix", packed)
        qw = torch.from_numpy(vs._pack_signs(q[None, :])[0].view(np.int32))
        column = hamming.hamming_keyed_torch(m_dev, qw, dim, n)[0]
    else:
        store = vs.IndexStore("t", primary_key="id")
        store.settings.apply_json(
            {"embedders": {"e": {"source": "userProvided", "dimensions": dim}}})
        store.add_documents([{"id": i, "_vectors": {"e": v.tolist()}}
                             for i, v in enumerate(floats)])
        store.device = CPU
        searcher = vs.VectorSearcher(store, "e")
        m_dev, n = vs._resident(searcher, "matrix", searcher.matrix)
        column = vs._cos_column(searcher, m_dev, q)
        column[n:] = -2.0
    ks = (30, 300)
    want = [np.asarray(jax.lax.top_k(column.numpy(), 1 << (4 * k - 1).bit_length())[1])
            for k in ks]

    def rows():
        return [vs._device_topk_dispatch(searcher, q, k)[1].numpy() for k in ks]

    assert all(np.array_equal(g, w) for g, w in zip(rows(), want))
    monkeypatch.setattr(vs, "_topk_from_key",
                        lambda vals, key, kb: tuple(torch.topk(vals, kb, sorted=True)))
    assert not all(np.array_equal(g, w) for g, w in zip(rows(), want))


def test_quantized_dispatch_selects_on_the_kernels_key(monkeypatch):
    """Nothing runs between K4h's keyed launch and the top-k: the key that
    `_topk_from_key` selects on is the tensor `hamming_keyed` returned."""
    packed = _tied_matrix(N_LIVE, 4, seed=5)
    seen = {}
    keyed, from_key = vs.hamming_keyed, vs._topk_from_key

    def spy_keyed(*args):
        seen["out"] = keyed(*args)
        return seen["out"]

    def spy_from_key(vals, key, kb):
        seen["in"] = (vals, key)
        return from_key(vals, key, kb)

    monkeypatch.setattr(vs, "hamming_keyed", spy_keyed)
    monkeypatch.setattr(vs, "_topk_from_key", spy_from_key)
    vs._device_topk_dispatch(_Searcher(packed, 128, CPU), _query(128, seed=6), 10)
    assert all(a is b for a, b in zip(seen["in"], seen["out"]))


def test_hamming_keyed_checks_its_inputs():
    mat = torch.zeros((8, 4), dtype=torch.int32)
    q = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        hamming.hamming_keyed(mat.long(), q, 128, 8)  # dtype
    with pytest.raises(TypeError):
        hamming.hamming_keyed(mat, q.float(), 128, 8)
    with pytest.raises(ValueError):
        hamming.hamming_keyed(mat, q[:3], 128, 8)  # shape
    with pytest.raises(ValueError):
        hamming.hamming_keyed(mat.reshape(-1), q, 128, 8)
    with pytest.raises(ValueError):
        hamming.hamming_keyed(mat.t(), torch.zeros(8, dtype=torch.int32), 128, 4)  # contiguity
    with pytest.raises(ValueError):
        hamming.hamming_keyed(mat.to("meta"), q.to("meta"), 128, 8)  # device
    with pytest.raises(ValueError):
        hamming.hamming_keyed(mat, q, 128, 9)  # n_live > n
    with pytest.raises(ValueError):
        hamming.hamming_keyed(mat, q, 128, -1)
    with pytest.raises(ValueError):
        hamming.hamming_keyed(mat, q, 0, 8)  # dim
    cos, key = hamming.hamming_keyed(mat, q, 128, 0)  # no live row: all pad rows
    assert torch.all(cos == -2.0) and key.shape == (8,)
