"""The port's planes_chain_topk (CPU) against the JAX package's XLA path.

Counts, candidate bitmaps and mask rows must be identical. Pass 1 must
select the same key multiset, and the same (key, idx) pairs below the kth
key: torch.topk and lax.top_k may pick different members of the kth tie
class, so pass-1 indices are not compared there. Pass 2 (the kth tie
class ordered by (quantized sort rank, docid)) must match in order, and
the host merge must give the same proven page."""

import numpy as np
import pytest
import torch

from meilisearch_tpu.ops.arena_scorer import (
    INVALID_KEY,
    _key_layout,
    _planes_chain_topk_xla,
    merge_topk_host,
    merge_topk_sort_host,
)
from meilisearch_tpu_torch.ops.arena_scorer import planes_chain_topk
from meilisearch_tpu_torch.ops.synthetic import scorer_inputs

B = 4
# few distinct bytes -> large key tie classes at the k boundary
FEW = [0x00, 0x11, 0x80]


@pytest.mark.parametrize(
    "T,D,k,values",
    [
        (3, 1 << 14, 64, None),
        (6, 1 << 14, 64, FEW),
        (2, 1024, 64, FEW),
        (1, 1 << 14, 1024, FEW),
        (4, 1024, 1024, None),
    ],
)
def test_planes_topk_matches_xla(T, D, k, values):
    inputs = scorer_inputs(T, D, B, seed=10 * T + (values is None), values=values)
    mask_sel = np.array([1, 0, 2, 0], np.int32)
    out_x, candw_x, masks_x = (
        np.asarray(a)
        for a in _planes_chain_topk_xla(*inputs, mask_sel, T=T, D=D, k=k)
    )
    pool = torch.from_numpy(inputs[0])
    out_t, candw_t, masks_t = (
        a.numpy()
        for a in planes_chain_topk(pool, *inputs[1:], T=T, D=D, k=k, mask_sel=mask_sel)
    )
    assert out_t.shape == (B, 4 * k + 2)
    np.testing.assert_array_equal(candw_t, candw_x)
    np.testing.assert_array_equal(masks_t, masks_x)
    np.testing.assert_array_equal(out_t[:, 4 * k], out_x[:, 4 * k])  # counts
    assert (out_t[:, 4 * k + 1] == 2).all()
    low_mask = (1 << _key_layout(T)[2]) - 1
    for b in range(B):
        # pass 1 selects on the key with the below-sort bits masked (sort
        # queries); its full keys ride in key1
        def sel(keys):
            return keys & ~low_mask if inputs[5][b] else keys

        idx1_t, key1_t = out_t[b, :k], out_t[b, k : 2 * k]
        idx1_x, key1_x = out_x[b, :k], out_x[b, k : 2 * k]
        assert sorted(sel(key1_t).tolist()) == sorted(sel(key1_x).tolist()), b
        kth = sel(key1_x).max()
        below_t = sorted(
            (kk, i) for kk, i in zip(key1_t.tolist(), idx1_t.tolist())
            if sel(kk) < kth
        )
        below_x = sorted(
            (kk, i) for kk, i in zip(key1_x.tolist(), idx1_x.tolist())
            if sel(kk) < kth
        )
        assert below_t == below_x, b

        def tie_pass(out):
            keys2, idx2 = out[b, 3 * k : 4 * k], out[b, 2 * k : 3 * k]
            return [(kk, i) for kk, i in zip(keys2, idx2) if kk < INVALID_KEY]

        assert tie_pass(out_t) == tie_pass(out_x), b

        # the quantized sort rank of every doc, as the tie pass reads it
        w = inputs[0][inputs[4][b]].astype(np.int64) & 0xFFFFFFFF
        qsort = np.concatenate([(w >> (8 * j)) & 0xFF for j in range(4)]) ^ 0x80

        def page(out):
            lists = (out[b, :k], out[b, k : 2 * k], out[b, 2 * k : 3 * k],
                     out[b, 3 * k : 4 * k], out[b, 4 * k], k)
            if inputs[5][b]:
                ids, n_exact, total = merge_topk_sort_host(
                    *lists, T, lambda c: [qsort[c]], lambda c: qsort[c]
                )
            else:
                ids, n_exact, total = merge_topk_host(*lists)
            # a page holds at most k docs; past k the proven prefix may
            # differ with the pass-1 tie members each top-k picked
            n = min(n_exact, k)
            return ids[:n].tolist(), n, total

        assert page(out_t) == page(out_x), b


def test_row_ids_outside_the_pool_raise():
    inputs = list(scorer_inputs(1, 1024, B, seed=3))
    inputs[1] = inputs[1].copy()
    inputs[1][0, 0, 0] = len(inputs[0])  # one past the last pool row
    with pytest.raises(ValueError, match="outside the pool"):
        planes_chain_topk(torch.from_numpy(inputs[0]), *inputs[1:], T=1, D=1024, k=64)
