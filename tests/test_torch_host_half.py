"""The port's jax-free copies of the arena scorer's host half
(meilisearch_tpu_torch/ops/arena_host.py) against the originals in
meilisearch_tpu/ops/arena_scorer.py, on random inputs."""

import numpy as np
import pytest

from meilisearch_tpu.ops import arena_scorer as ref
from meilisearch_tpu_torch.ops import arena_host as port

TS = [1, 2, 3, 4, 5, 6]


def test_constants_match():
    assert port.INVALID_KEY == ref.INVALID_KEY
    assert port.TOPK == ref.TOPK
    assert port.MASK_SLOTS == ref.MASK_SLOTS
    for T in TS:
        assert port._key_layout(T) == ref._key_layout(T)


def _dp_inputs(T, n, rng):
    tp = max(T - 1, 1)
    present = rng.random((T, 3, n)) < 0.5
    fid = rng.integers(0, 9, size=(T, 3, n)).astype(np.int16)
    pos = rng.integers(0, 16, size=(T, 3, n)).astype(np.int16)
    pair = rng.integers(0, 4, size=(tp, 3, 3, n)).astype(np.int16)
    exact = rng.random((T, n)) < 0.3
    return present, fid, pos, pair, exact


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("with_mand", [False, True])
def test_packed_chain_dp_np_matches(T, with_mand):
    rng = np.random.default_rng(T + 10 * with_mand)
    args = _dp_inputs(T, 500, rng)
    mand = None
    if with_mand:
        mand = (rng.random(T) < 0.4).astype(np.int32)
        mand[0] = 1
    got = port.packed_chain_dp_np(*args, T, mand=mand)
    want = ref.packed_chain_dp_np(*args, T, mand=mand)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def _lists(k, D, rng, tie_heavy):
    """Two candidate lists shaped like the scorer's: pass 1 the k smallest
    keys, pass 2 a kth tie class, INVALID_KEY padding."""
    keys = rng.integers(0, 40 if tie_heavy else 1 << 20, size=D).astype(np.int32)
    keys[rng.random(D) < 0.3] = ref.INVALID_KEY
    order = np.lexsort((np.arange(D), keys))
    idx1 = order[:k].astype(np.int32)
    key1 = keys[idx1]
    kth = key1[-1]
    tie = np.flatnonzero(keys == kth)[:k].astype(np.int32)
    idx2 = np.zeros(k, np.int32)
    key2 = np.full(k, ref.INVALID_KEY, np.int32)
    idx2[: len(tie)] = tie
    key2[: len(tie)] = kth
    count = int(np.count_nonzero(keys < ref.INVALID_KEY))
    return idx1, key1, idx2, key2, count


def _delta(rng, D):
    ids = np.sort(rng.choice(np.arange(D, D + 200), size=20, replace=False))
    return ids.astype(np.int32), rng.integers(0, 60, size=20).astype(np.int32)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("with_delta", [False, True])
@pytest.mark.parametrize("return_keys", [False, True])
def test_merge_topk_host_matches(T, with_delta, return_keys):
    rng = np.random.default_rng(100 + T)
    k, D = 64, 2048
    for tie_heavy in (False, True):
        lists = _lists(k, D, rng, tie_heavy)
        delta = _delta(rng, D) if with_delta else (None, None)
        for tie_proven in (True, False):
            kw = dict(
                delta_ids=delta[0], delta_keys=delta[1],
                tie_proven=tie_proven, return_keys=return_keys,
            )
            _same(
                port.merge_topk_host(*lists, k, **kw),
                ref.merge_topk_host(*lists, k, **kw),
            )


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("with_delta", [False, True])
@pytest.mark.parametrize("return_keys", [False, True])
def test_merge_topk_sort_host_matches(T, with_delta, return_keys):
    rng = np.random.default_rng(200 + T)
    k, D = 64, 2048
    sort_vals = rng.integers(0, 50, size=D + 200)
    qsort = (sort_vals * 254 // 50).astype(np.int32)

    def sort_key_rows(cand):
        return [sort_vals[cand]]

    def qsort_of(cand):
        return qsort[cand]

    for tie_heavy in (False, True):
        lists = _lists(k, D, rng, tie_heavy)
        delta = _delta(rng, D) if with_delta else (None, None)
        for tie_proven in (True, False):
            kw = dict(
                delta_ids=delta[0], delta_keys=delta[1],
                tie_proven=tie_proven, return_keys=return_keys,
            )
            _same(
                port.merge_topk_sort_host(*lists, k, T, sort_key_rows, qsort_of, **kw),
                ref.merge_topk_sort_host(*lists, k, T, sort_key_rows, qsort_of, **kw),
            )
