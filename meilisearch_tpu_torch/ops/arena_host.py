"""Host half of the arena scorer, free of jax.

Copies of `_key_layout`, `INVALID_KEY`, `TOPK`, `MASK_SLOTS`,
`packed_chain_dp_np`, `merge_topk_host` and `merge_topk_sort_host` from
`meilisearch_tpu/ops/arena_scorer.py`. They are copies, not imports,
because that module imports jax at module level, and the port runs where
jax is not installed. `tests/test_torch_host_half.py` pins each copy to
its original; `_hooks.install_jaxfree_aliases` registers this module under
the original's name where jax is absent, so the reference's shared host
code (`score_delta`, `_device_scores`, `_finish_device_result`) finds
these helpers there.
"""

from __future__ import annotations

import numpy as np

INVALID_KEY = 1 << 30
TOPK = 1024
# fixed candidate-bitmap output slots per batch (facet/distinct queries)
MASK_SLOTS = 4


def _key_layout(T: int):
    """Bit layout of the packed rank key for chain length T. The DP itself
    runs over this packed key (integer min == lexicographic min when every
    field is wide enough for its accumulated bound): words(T via skips),
    typo(2T), proximity(3(T-1)), fid(7T), position(10T), a 2-bit gap where
    the ExactAttribute rank lands AFTER the DP (it depends on the final
    words level), exactness(T). Total <= 29 bits for T <= 6.

    The `sort` ranking rule of the reference's default criteria sits
    between attributeRank (fid) and wordPosition (criterion.rs:121
    default_criteria), i.e. just below bit sh_fd: masking the low sh_fd
    bits (position + ea + exactness) yields the above-sort portion of
    the key."""
    ex_b = (T + 1).bit_length()
    ps_b = (10 * T + 1).bit_length()
    fd_b = (7 * T + 1).bit_length()
    px_b = max((3 * (T - 1) + 1).bit_length(), 1)
    ty_b = (2 * T + 1).bit_length()
    w_b = (T + 1).bit_length()
    sh_ea = ex_b
    sh_ps = sh_ea + 2
    sh_fd = sh_ps + ps_b
    sh_px = sh_fd + fd_b
    sh_ty = sh_px + px_b
    sh_w = sh_ty + ty_b
    total = sh_w + w_b
    assert total <= 29, (T, total)
    return sh_ea, sh_ps, sh_fd, sh_px, sh_ty, sh_w, total


def packed_chain_dp_np(
    present, fid_cost, pos_cost, pair_cost, exact_mask, T, mand=None
):
    """Numpy mirror of _packed_chain_dp over (..., n) arrays — scores the
    MINOR-write delta docids host-side with byte-identical keys to the
    device kernel (search/device_batch.py score_delta overlay). Returns
    (key (n,), BIG, sh_ea, sh_w). `mand` ((T,) 0/1 or None) follows the
    same mandatory-term semantics as _packed_chain_dp."""
    import numpy as np

    sh_ea, sh_ps, sh_fd, sh_px, sh_ty, sh_w, total = _key_layout(T)
    BIG = np.int32(1 << total)
    n = present.shape[-1]

    states = [np.full(n, BIG, np.int32) for _ in range(3)]
    states.append(np.zeros(n, np.int32))

    for t in range(T):
        exact_add = np.where(exact_mask[t], 0, 1).astype(np.int32)
        md = None if mand is None else int(mand[t])
        new_states = []
        visit_prevs = [3] if t == 0 else [0, 1, 2]
        for cls in range(3):
            base = (
                (cls << sh_ty)
                + (np.clip(fid_cost[t, cls], 0, 7).astype(np.int32) << sh_fd)
                + (np.clip(pos_cost[t, cls], 0, 10).astype(np.int32) << sh_ps)
                + exact_add
            )
            best = None
            for prev in visit_prevs:
                add = base
                if t > 0:
                    add = base + (
                        pair_cost[t - 1, prev, cls].astype(np.int32) << sh_px
                    )
                cand = states[prev] + add
                best = cand if best is None else np.minimum(best, cand)
            if md and t > 0:
                # mandatory: also visitable from the skip state (no pair)
                best = np.minimum(best, states[3] + base)
            best = np.where(present[t, cls], best, BIG)
            new_states.append(np.minimum(best, BIG))
        if mand is None and t == 0:
            best_skip = np.full(n, BIG, np.int32)
        elif md:
            best_skip = np.full(n, BIG, np.int32)
        else:
            best_skip = states[0]
            for prev in range(1, 4):
                best_skip = np.minimum(best_skip, states[prev])
            best_skip = np.minimum(best_skip + np.int32(1 << sh_w), BIG)
        new_states.append(best_skip)
        states = new_states

    key = np.minimum(
        np.minimum(states[0], states[1]), np.minimum(states[2], states[3])
    )
    return key, BIG, sh_ea, sh_w


def merge_topk_host(
    idx1, key1, idx2, key2, count, k, delta_ids=None, delta_keys=None,
    tie_proven=True, return_keys=False,
):
    """Exact ordered top-k from the kernel's two candidate lists plus the
    host-scored delta overlay (numpy). Returns (docids int32 padded with
    -1, n_exact, total): docids ascend by (key, docid); positions past
    n_exact are not proven (a truncated kth-tie class may be missing base
    members that precede them). tie_proven=False means the device could
    not validate the kth tie class at all (approx_select exact==1): the
    proven prefix caps at the strictly-below-kth run — every below-kth
    base doc is present and the delta overlay is always complete, so that
    prefix's order is exact; the first kth-valued position is not."""
    import numpy as np

    invalid_key = np.int32(INVALID_KEY)
    idx = np.concatenate([idx1, idx2])
    key = np.concatenate([key1, key2])
    keep = key < invalid_key
    idx, key = idx[keep], key[keep]
    idx, uniq = np.unique(idx, return_index=True)
    key = key[uniq]
    total = int(count)
    is_delta = np.zeros(len(idx), dtype=bool)
    if delta_ids is not None and len(delta_ids):
        idx = np.concatenate([idx, delta_ids.astype(np.int32)])
        key = np.concatenate([key, delta_keys])
        is_delta = np.concatenate(
            [is_delta, np.ones(len(delta_ids), dtype=bool)]
        )
        total += len(delta_ids)

    order = np.lexsort((idx, key))
    idx_o, key_o = idx[order], key[order]

    n_exact = k
    n_tie = int(np.count_nonzero(key2 < invalid_key))
    kth = int(key1[k - 1]) if len(key1) >= k else None
    if not tie_proven:
        if kth is not None and kth < invalid_key:
            n_exact = int(np.count_nonzero(key_o < kth))
    elif count > k and n_tie >= k:
        # the kth-tie class was truncated at its k lowest docids; entries
        # of that class past the included-docid frontier may be preceded
        # by missing base members
        if kth is not None and kth < invalid_key:
            tie_dev = idx2[key2 < invalid_key]
            frontier = int(tie_dev.max()) if len(tie_dev) else -1
            ambiguous = (key_o == kth) & (idx_o > frontier)
            if ambiguous.any():
                n_exact = int(np.argmax(ambiguous))

    out = np.full(k, -1, dtype=np.int32)
    n = min(len(idx_o), k, total)
    out[:n] = idx_o[:n]
    if return_keys:
        # the packed DP key per returned slot (INVALID_KEY pads) — the
        # caller decodes per-rule costs from the bit fields for
        # showRankingScore on the device path
        keys_out = np.full(k, INVALID_KEY, dtype=np.int32)
        keys_out[:n] = key_o[:n]
        return out, n_exact, total, keys_out
    return out, n_exact, total


def merge_topk_sort_host(
    idx1, key1, idx2, key2, count, k, T, sort_key_rows, qsort_of,
    delta_ids=None, delta_keys=None, tie_proven=True, return_keys=False,
):
    """Exact ordered top-k for a SORT query (numpy). The kernel selected on
    the above-sort key portion; the final order is (above-sort key bits,
    sort criteria values, below-sort key bits, docid). Host-scored delta
    docids merge in with true sort values (they are always complete; only
    a truncated device kth-tie class limits the proven prefix).

    sort_key_rows: callback(candidate docids) -> list of key rows for the
    sort criteria in rule order (executor._sort_field_rows semantics).
    qsort_of: callback(candidate docids) -> quantized rank used on device
    (for the truncation-ambiguity proof).

    Returns (docids int32 padded with -1, n_exact, total): positions past
    n_exact are not proven; a page extending there must fall back to the
    host scorer."""
    import numpy as np

    sh_fd = _key_layout(T)[2]
    low_mask = (1 << sh_fd) - 1
    invalid_key = np.int32(INVALID_KEY)

    idx = np.concatenate([idx1, idx2])
    key = np.concatenate([key1, key2])
    keep = key < invalid_key
    idx, key = idx[keep], key[keep]
    idx, uniq = np.unique(idx, return_index=True)
    key = key[uniq]
    total = int(count)
    if delta_ids is not None and len(delta_ids):
        idx = np.concatenate([idx, delta_ids.astype(np.int32)])
        key = np.concatenate([key, delta_keys])
        total += len(delta_ids)
    if not len(idx):
        empty = np.full(k, -1, dtype=np.int32)
        if return_keys:
            return empty, k, total, np.full(k, INVALID_KEY, dtype=np.int32)
        return empty, k, total

    hi = key & ~np.int32(low_mask)
    # the device selection threshold comes from the device lists alone
    dev_hi = key1[key1 < invalid_key] & ~np.int32(low_mask)
    kth = int(dev_hi.max()) if len(dev_hi) else None
    # every base doc with hi < kth is present (top_k guarantees); the kth
    # bucket's base membership comes from the second top_k, selected by
    # (quantized rank, docid); delta docs are always complete
    srows = sort_key_rows(idx)
    lo = key & np.int32(low_mask)
    order = np.lexsort([idx, lo] + list(reversed(srows)) + [hi])
    idx_o, hi_o = idx[order], hi[order]

    # valid idx2 entries all belong to the kth bucket; if fewer than k came
    # back the bucket is complete and everything is exact
    truncated = int(np.count_nonzero(key2 < invalid_key)) >= k
    if not tie_proven:
        # the device could not validate the kth bucket's membership at
        # all (approx_select exact==1): only the strictly-below-kth
        # prefix is proven (pass 1 complete + delta always complete)
        n_exact = (
            int(np.count_nonzero(hi_o < kth)) if kth is not None else k
        )
    elif not truncated or count <= k or kth is None:
        n_exact = k
    else:
        in_kth = hi_o == kth
        q = qsort_of(idx_o)
        # the truncation frontier is the max quantized rank the DEVICE
        # returned for the tie class (delta entries don't move it)
        tie_dev = idx2[key2 < invalid_key]
        qmax = int(qsort_of(tie_dev).max()) if len(tie_dev) else 0
        # kth-bucket members with quantized rank < qmax are ALL present
        # base-side (second top_k truncates at the (qmax, docid)
        # frontier), so the exact prefix ends at the first member —
        # device or delta — with rank >= qmax
        ambiguous = in_kth & (q >= qmax)
        n_exact = int(np.argmax(ambiguous)) if ambiguous.any() else k

    out = np.full(k, -1, dtype=np.int32)
    n = min(len(idx_o), k, total)
    out[:n] = idx_o[:n]
    if return_keys:
        keys_out = np.full(k, INVALID_KEY, dtype=np.int32)
        keys_out[:n] = key[order][:n]
        return out, n_exact, total, keys_out
    return out, n_exact, total
