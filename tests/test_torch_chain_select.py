"""K6's top-k mode, walked on the CPU: the per-tile exact select.

The kernel's top-k mode (csrc/chain_dp.cu) keeps, per tile of
`tile_width(T)` columns, the min(k, tile) smallest (key_hi, key_lo,
key_lo2, column) entries; `chain_query_topk` then runs the stable 3-key
sort over those survivors only. `ops/device_scorer.py::tile_select_torch`
walks the same tiling in plain torch. Here that two-stage select,
followed by `sort3` and sliced to min(k, N), must equal the JAX package's
`chain_query_topk` docid for docid and key for key:
- at T = 1, 4 and 16, N from 1 to 8192 around the tile's width, k from
  1 to N (`chain_query_topk`'s k is a static argument and its program
  sorts all N then keeps k, so one call at k = N, sliced, stands for
  every k: one XLA compile per (T, N));
- with full-key ties across a tile boundary (docids clipped at 2^23),
  every column invalid, and fewer valid columns than k;
- the CUDA path of `chain_query_topk` (`_kernel_walk`: for k up to
  TOPK_MAX_K the per-tile select in the kernel's layout, then the merge
  passes of `merge_survivors`; above it the sort of all N), on the same
  ladder and cases;
- as a property, on small random keys with many ties, against `sort3`
  over every column;
- a select that breaks ties by the higher column fails the tie test
  (the tie-order guard of ROADMAP fault 3.6).
The callers' padded layout (the bulk path's stride) is checked here too;
the kernel itself is held against these plain versions on the card in
tests/test_torch_cuda.py (marked `cuda`)."""

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from meilisearch_tpu.ops import device_scorer as jds
from meilisearch_tpu_torch.ops import device_scorer as ds

TERMS = (1, 4, 16)


def _widths(T: int) -> list:
    tile = ds.tile_width(T)
    return sorted({1, 257, tile - 1, tile, tile + 1, 3 * tile + 5, 8192})


def _ks(T: int, N: int) -> list:
    tile = ds.tile_width(T)
    return sorted({1, 10, tile, tile + 1, N})


LADDER = [(T, N, k) for T in TERMS for N in _widths(T) for k in _ks(T, N)]


def _ladder_inputs(T: int, N: int) -> tuple:
    return tuple(x.numpy() for x in ds.example_inputs(T=T, N=N, seed=40 + T))


def _tied_inputs() -> tuple:
    """T = 4, N = 3 tiles + 5: docids above 2^23 everywhere (clipped in
    key_lo2), and the 40 best columns, tile - 20 to tile + 19, equal in
    every input: 40 equal full keys across the first tile boundary."""
    T = 4
    tile = ds.tile_width(T)
    cm, pc, fc, pos, em, docids, valid = _ladder_inputs(T, 3 * tile + 5)
    docids[:] = (1 << 23) + np.arange(len(docids))
    run = slice(tile - 20, tile + 20)
    cm[..., run] = True
    fc[..., run] = 0
    pos[..., run] = 0
    pc[..., run] = 0
    em[..., run] = True
    valid[run] = True
    return cm, pc, fc, pos, em, docids, valid


def _invalid_inputs() -> tuple:
    inputs = list(_ladder_inputs(4, 3 * ds.tile_width(4) + 5))
    inputs[6] = np.zeros_like(inputs[6])
    return tuple(inputs)


def _few_valid_inputs() -> tuple:
    inputs = list(_ladder_inputs(4, 3 * ds.tile_width(4) + 5))
    valid = np.zeros_like(inputs[6])
    valid[[3, 300, 700]] = True
    inputs[6] = valid
    inputs[0][0, 0, [3, 300, 700]] = True  # each matches the first term
    return tuple(inputs)


CASES = {"tied": _tied_inputs, "invalid": _invalid_inputs, "few_valid": _few_valid_inputs}


@functools.lru_cache(maxsize=None)
def _case(name: str, T: int = 0, N: int = 0):
    """(inputs, the JAX package's chain_query_topk at k = N, as numpy)."""
    inputs = _ladder_inputs(T, N) if name == "ladder" else CASES[name]()
    n = inputs[5].shape[0]
    want = tuple(np.asarray(x) for x in jds.chain_query_topk(*inputs, k=n))
    return inputs, want


def _two_stage(inputs, tile: int, k: int):
    """The plain keys, the per-tile select, then `sort3` over the
    survivors with their docids gathered by column."""
    cm, pc, fc, pos, em, docids, valid = map(torch.from_numpy, inputs)
    keys = ds.chain_query_keys_torch(cm, pc, fc, pos, em, docids, valid)
    hi, lo, lo2, col = ds.tile_select_torch(*keys, tile, k)
    n = docids.shape[0]
    assert hi.shape[0] == sum(min(k, tile, n - s) for s in range(0, n, tile))
    return ds.sort3(hi, lo, lo2, docids[col.long()], min(k, n))


def _kernel_walk(inputs, tile: int, k: int):
    """The CUDA path of `chain_query_topk`, walked with the plain
    versions: for k <= TOPK_MAX_K the top-k mode's per-tile select
    (sentinel slots included), then the merge passes; for a larger k the
    keys mode and the sort of all N."""
    cm, pc, fc, pos, em, docids, valid = map(torch.from_numpy, inputs)
    keys = ds.chain_query_keys_torch(cm, pc, fc, pos, em, docids, valid)
    if k > ds.TOPK_MAX_K:
        return ds.sort3(*keys, docids, k)
    cols = torch.arange(docids.shape[0], dtype=torch.int32)
    kept = ds.select_torch(torch.stack([*keys, cols]), k, width=tile)
    r = min(k, docids.shape[0])
    hi, lo, lo2, docs = ds.merge_survivors(kept, k, docids, keep=r)
    return docs, hi, lo, lo2


def _assert_equal(got, want, k: int) -> None:
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w[:k])


@pytest.mark.parametrize("T,N,k", LADDER)
def test_tile_select_matches_jax(T, N, k):
    inputs, want = _case("ladder", T, N)
    _assert_equal(_two_stage(inputs, ds.tile_width(T), k), want, k)


@pytest.mark.parametrize("T,N,k", [c for c in LADDER if c[2] <= ds.tile_width(c[0])])
def test_merge_passes_match_jax(T, N, k):
    """The CUDA path's walk: the per-tile select, then the merge passes
    (k up to TOPK_MAX_K; the sort of all N above it)."""
    inputs, want = _case("ladder", T, N)
    _assert_equal(_kernel_walk(inputs, ds.tile_width(T), k), want, k)


@pytest.mark.parametrize("case", ["invalid", "few_valid"])
@pytest.mark.parametrize("k", [1, 10, 255, 256, 257, 773])
def test_tile_select_matches_jax_on_invalid_columns(case, k):
    inputs, want = _case(case)
    got = _two_stage(inputs, ds.tile_width(4), k)
    _assert_equal(got, want, k)
    _assert_equal(_kernel_walk(inputs, ds.tile_width(4), k), want, k)
    if case == "few_valid":  # the 3 valid columns first, then invalid ones
        assert (got[1][:3] < ds.INVALID_HI).all() and (got[1][3:] == ds.INVALID_HI).all()


def test_two_stage_select_keeps_full_key_ties_in_column_order():
    """40 equal full keys across the first tile boundary: the k best are
    the lowest columns of the run, in column order, for every k."""
    inputs, want = _case("tied")
    tile = ds.tile_width(4)
    first = inputs[5][tile - 20]
    for k in (1, 10, 20, 30, 40, tile, tile + 1, len(inputs[5])):
        for got in (_two_stage(inputs, tile, k), _kernel_walk(inputs, tile, k)):
            _assert_equal(got, want, k)
            run = min(k, 40)
            assert got[0][:run].tolist() == list(range(first, first + run))


def _select_high_column_first(key_hi, key_lo, key_lo2, tile: int, k: int):
    """A mutant of tile_select_torch: full-key ties go to the higher
    column."""
    n = key_hi.shape[0]
    parts = []
    for start in range(0, n, tile):
        cols = torch.arange(start, min(start + tile, n)).flip(0)
        cols = cols[torch.sort(key_lo2[cols], stable=True).indices]
        major = (key_hi[cols].long() << 31) | key_lo[cols].long()
        parts.append(cols[torch.sort(major, stable=True).indices][:k])
    keep = torch.cat(parts)
    return key_hi[keep], key_lo[keep], key_lo2[keep], keep.to(torch.int32)


def test_tie_order_mutation_fails_the_tie_test(monkeypatch):
    monkeypatch.setattr(ds, "tile_select_torch", _select_high_column_first)
    with pytest.raises(AssertionError):
        test_two_stage_select_keeps_full_key_ties_in_column_order()


@settings(max_examples=120, deadline=None)
@given(
    n=st.integers(1, 300),
    tile=st.sampled_from([16, 32, 64, 128]),
    k=st.integers(1, 310),
    seed=st.integers(0, 2**32 - 1),
)
def test_tile_select_property(n, tile, k, seed):
    """On small keys with many full-key ties, the two-stage select equals
    the stable 3-key sort over every column."""
    rng = np.random.default_rng(seed)
    hi = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    lo = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    lo2 = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    docids = torch.from_numpy(rng.permutation(n).astype(np.int32))
    want = ds.sort3(hi, lo, lo2, docids, k)
    s_hi, s_lo, s_lo2, col = ds.tile_select_torch(hi, lo, lo2, tile, k)
    got = ds.sort3(s_hi, s_lo, s_lo2, docids[col.long()], min(k, n))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if k <= ds.TOPK_MAX_K:  # and the merge passes over the kernel's slots
        cols = torch.arange(n, dtype=torch.int32)
        kept = ds.select_torch(torch.stack([hi, lo, lo2, cols]), k, width=tile)
        merged = ds.merge_survivors(kept, k, docids, keep=min(k, n))
        for g, w in zip((merged[3], *merged[:3]), want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("m,k", [(1, 1), (1024, 10), (1025, 10), (13_890, 10), (70_000, 32)])
def test_merge_passes_match_sort3(m, k):
    """Survivor-sized inputs with many full-key ties and a permuted
    column word: the merge passes equal the stable sort by (hi, lo, lo2,
    column)."""
    rng = np.random.default_rng(m + k)
    hi, lo, lo2 = (torch.from_numpy(rng.integers(0, 2, m).astype(np.int32)) for _ in range(3))
    cols = torch.from_numpy(rng.permutation(m).astype(np.int32))
    docids = torch.from_numpy(rng.integers(0, 1 << 24, m).astype(np.int32))
    order = torch.sort(cols.long() + (lo2.long() << 32), stable=True).indices
    order = order[torch.sort((hi[order].long() << 31) | lo[order].long(), stable=True).indices][:k]
    got = ds.merge_survivors(torch.stack([hi, lo, lo2, cols]), k, docids, keep=min(k, m))
    assert torch.equal(got[3], docids[cols[order].long()])
    for g, x in zip(got[:3], (hi, lo, lo2)):
        assert torch.equal(g, x[order])


def test_tile_and_aligned_widths():
    assert [ds.tile_width(T) for T in (1, 4, 8, 9, 16)] == [256, 256, 256, 128, 128]
    assert [ds.aligned_width(n) for n in (0, 1, 16, 17, 355_439)] == [16, 16, 16, 32, 355_440]


def _padded(inputs, width: int, n: int):
    """The inputs laid out `width` columns wide, pad columns inert."""
    fills = (False, 0, ds.INF, ds.INF, False, 0, False)
    out = []
    for x, fill in zip(inputs, fills):
        pad = torch.full(x.shape[:-1] + (width - n,), fill, dtype=x.dtype)
        out.append(torch.cat([x, pad], dim=-1).contiguous())
    return out


@pytest.mark.parametrize("T,N", [(1, 257), (4, 1000), (16, 129)])
def test_wrappers_compute_the_first_n_columns(T, N):
    """A padded layout with n = N gives what the unpadded one gives, in
    every mode (the CPU runs the plain versions)."""
    inputs = ds.example_inputs(T=T, N=N, seed=7)
    exact_cost = torch.from_numpy(np.random.default_rng(7).integers(0, 3, (T, N)).astype(np.int32))
    wide = _padded(inputs, ds.aligned_width(N) + 16, N)
    wide_cost = torch.cat([exact_cost, torch.zeros((T, 16 + ds.aligned_width(N) - N),
                                                   dtype=torch.int32)], dim=1)
    assert torch.equal(ds.chain_cost_matrix(*wide[:4], wide_cost, n=N),
                       ds.chain_cost_matrix(*inputs[:4], exact_cost))
    for g, w in zip(ds.chain_query_keys(*wide, n=N), ds.chain_query_keys(*inputs)):
        assert torch.equal(g, w)
    for g, w in zip(ds.chain_query_topk(*wide, k=10, n=N), ds.chain_query_topk(*inputs, k=10)):
        assert torch.equal(g, w)


def test_wrappers_check_n_and_k():
    inputs = ds.example_inputs(T=2, N=64, seed=1)
    with pytest.raises(ValueError):
        ds.chain_query_keys(*inputs, n=65)
    with pytest.raises(ValueError):
        ds.chain_query_keys(*inputs, n=0)
    with pytest.raises(ValueError):
        ds.chain_query_topk(*inputs, k=0)


def test_run_device_lays_out_the_bulk_stride(monkeypatch):
    """The executor's device DP hands K6 an axis aligned_width(N) wide,
    pad columns inert, and n = N."""
    from meilisearch_tpu_torch.index.store import IndexStore
    from meilisearch_tpu_torch.search.executor import Search

    seen = []
    cost_matrix = ds.chain_cost_matrix

    def recorded(*args, n=None):
        seen.append((tuple(args[0].shape), n, args[0][..., n:].any().item(),
                     bool((args[2][..., n:] == ds.INF).all())))
        return cost_matrix(*args, n=n)

    monkeypatch.setattr(ds, "chain_cost_matrix", recorded)
    store = IndexStore("t", primary_key="id")
    store.settings.apply_json({"searchableAttributes": ["text"]})
    words = ["alpha", "beta", "gamma", "delta"]
    rng = np.random.default_rng(3)
    store.add_documents([{"id": i, "text": " ".join(rng.choice(words, 4))} for i in range(37)])
    monkeypatch.setenv("MEILI_TPU_DEVICE", "0")
    host = Search(store, query="alpha beta", limit=20).execute().documents_ids
    monkeypatch.setenv("MEILI_TPU_DEVICE", "1")
    page = Search(store, query="alpha beta", limit=20).execute().documents_ids
    assert page == host and seen
    for shape, n, pad_matched, pad_inf in seen:
        assert shape[-1] == ds.aligned_width(n) and shape[-1] % ds.ALIGN_COLUMNS == 0
        assert not pad_matched and pad_inf
