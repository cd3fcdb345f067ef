"""Random scorer inputs in the serving layouts, made from a numpy seed.

Used to hold K1 and the selection tail against their references (the
tests, against the JAX package; `chip_smoke.py`, against the plain torch
versions on the card). Byte values cover the whole 0..254 range, so the
exact flag (bit 7) and the -1 absence sentinel (0xFF) both occur.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.device_arena import pack_bitmap, pack_plane
from .chain_keys import n_rows


def scorer_inputs(T: int, D: int, B: int, seed: int, values=None):
    """`planes_chain_topk`'s positional inputs (numpy), from byte_pool to
    live_packed. Row ids differ per query; a 15% share point at row 0, the
    all-absent row. `values` (optional) restricts the present bytes to a
    few values, which makes large key tie classes."""
    rng = np.random.default_rng(seed)
    tp = max(T - 1, 1)
    nr = 2 + n_rows(T) + 8
    pool_bytes = np.full((nr, D), -1, np.int8)
    for r in range(1, nr):
        mask = rng.random(D) < rng.uniform(0.05, 0.4)
        if values is None:
            vals = rng.integers(0, 255, size=D)
        else:
            vals = rng.choice(np.asarray(values), size=D)
        pool_bytes[r] = np.where(mask, vals.astype(np.uint8).view(np.int8), np.int8(-1))
    byte_pool = np.stack([pack_plane(row) for row in pool_bytes])

    def row_ids(shape):
        ids = rng.integers(1, nr, size=shape)
        return np.where(rng.random(shape) < 0.85, ids, 0).astype(np.int32)

    use_sort = rng.random(B) < 0.5
    universe = np.stack(
        [pack_bitmap(np.flatnonzero(rng.random(D) < 0.7), D) for _ in range(B)]
    )
    use_valid = rng.random(B) < 0.5
    adj = rng.random((B, tp)) < 0.7
    # real descriptors always hold a mandatory term (term 0 by default)
    mand = rng.random((B, T)) < 0.3
    mand[:, 0] |= ~mand.any(axis=1)
    live = pack_bitmap(np.flatnonzero(rng.random(D) < 0.9), D)
    return (
        byte_pool, row_ids((B, T, 3)), row_ids((B, tp, 3)), row_ids((B, T + 1)),
        row_ids((B,)), use_sort, universe, use_valid, adj, mand, live,
    )


def kernel_args(inputs, device="cpu"):
    """K1's inputs (byte_pool, rows, adj, mand, use_valid, universe, live)
    as int32 tensors on `device`, from `scorer_inputs`' tuple."""
    (byte_pool, term_rows, pair_rows, ea_rows, _sort_rows, _use_sort,
     universe, use_valid, adj, mand, live) = inputs
    B = len(term_rows)
    rows = np.concatenate(
        [term_rows.reshape(B, -1), pair_rows.reshape(B, -1), ea_rows], axis=1
    )
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
        for a in (byte_pool, rows, adj, mand, use_valid, universe, live)
    )
