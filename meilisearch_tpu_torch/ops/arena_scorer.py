"""Plane-resident batched ranking on torch: the device half of
`meilisearch_tpu/ops/arena_scorer.py`.

`planes_chain_topk` keeps the reference's signature and output contract.
Keys and the candidate bitmap come from K1 (`ops/chain_keys.py`); the
selection tail is the reference's `topk2` pass in torch: a top-k of the
selection key, then a top-k of the kth-key tie class ordered by
(quantized sort rank, docid), so the host merge can prove the page exact.
The reference's `approx` and `sort` selections are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .arena_host import INVALID_KEY, MASK_SLOTS, _key_layout
from .chain_keys import chain_keys, unpack_bytes

_TIE_FLOOR = -(2**31) + 1  # tie_rank of docs outside the kth tie class


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)


def planes_chain_topk(
    byte_pool,
    term_rows,
    pair_rows,
    ea_rows,
    sort_rows,
    use_sort,
    universe,
    use_valid,
    adj,
    mand,
    live_packed,
    T: int,
    D: int,
    k: int,
    mask_sel=None,
):
    """Returns (out, candw, masks) on `byte_pool`'s device:
    out    (B, 4k+2) int32: [idx1 | key1 | idx2 | key2 | count | exact]
    candw  (B, D/32) int32 bit-blocked candidate bitmaps
    masks  (MASK_SLOTS, D/32) int32: candw rows named by `mask_sel`
    `exact` is always 2: top-k selection is exact by construction.
    Host arguments (numpy) are uploaded; `byte_pool`, `universe` and
    `live_packed` are normally already resident."""
    dev = byte_pool.device
    B = len(term_rows)
    tp = max(T - 1, 1)
    rows_np = np.concatenate(
        [
            np.asarray(term_rows, np.int32).reshape(B, T * 3),
            np.asarray(pair_rows, np.int32).reshape(B, tp * 3),
            np.asarray(ea_rows, np.int32).reshape(B, T + 1),
        ],
        axis=1,
    )
    sort_np = np.asarray(sort_rows, np.int32)
    n_pool = byte_pool.shape[0]
    for name, r in (("plane", rows_np), ("sort", sort_np)):
        if r.size and (r.min() < 0 or r.max() >= n_pool):
            raise ValueError(f"{name} row id outside the pool's {n_pool} rows")
    if mask_sel is None:
        mask_sel = np.zeros(MASK_SLOTS, np.int32)

    keys, candw, counts = chain_keys(
        byte_pool,
        _as_tensor(rows_np, dev),
        _as_tensor(adj, dev),
        _as_tensor(mand, dev),
        _as_tensor(use_valid, dev),
        _as_tensor(universe, dev),
        _as_tensor(live_packed, dev),
        T=T,
    )

    low_mask = (1 << _key_layout(T)[2]) - 1  # bits below the sort rule
    use_sort_t = torch.from_numpy(np.asarray(use_sort, bool)).to(dev)
    sel_key = torch.where(use_sort_t[:, None], keys & ~low_mask, keys)
    negv, idx1 = torch.topk(-sel_key, k, dim=1)
    key1 = torch.gather(keys, 1, idx1)
    kth = -negv[:, k - 1 :]
    # the quantized sort rank of every doc (row 0 = constant -> docid order)
    qsort = unpack_bytes(byte_pool[torch.from_numpy(sort_np).to(dev).long()]) ^ 0x80
    iota = torch.arange(D, dtype=torch.int32, device=dev)[None, :]
    tie_rank = torch.where(sel_key == kth, -((qsort << 23) | iota), _TIE_FLOOR)
    tr2, idx2 = torch.topk(tie_rank, k, dim=1)
    key2 = torch.where(tr2 > _TIE_FLOOR, torch.gather(keys, 1, idx2), INVALID_KEY)
    exact = torch.full((B, 1), 2, dtype=torch.int32, device=dev)
    out = torch.cat(
        [idx1.int(), key1, idx2.int(), key2, counts[:, None], exact], dim=1
    )
    sel = torch.from_numpy(np.asarray(mask_sel, np.int64)).to(dev)
    return out, candw, candw.index_select(0, sel)
