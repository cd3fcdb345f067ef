"""K6: the fused lexicographic chain DP over a query's candidate axis.

`chain_cost_matrix`, `chain_query_keys` and `chain_query_topk` are the
wrappers of the hand-written CUDA kernel's three modes
(`csrc/chain_dp.cu`, which replaces the jitted XLA programs
`meilisearch_tpu/ops/device_scorer.py::chain_cost_matrix` and
`::chain_query_topk`):
- cost mode: the final (6, N) int32 cost matrix, clipped at INF;
- keys mode: the same DP with the `valid` mask, the 6 dimensions packed
  into three int32 sort keys (hi, lo, lo2);
- top-k mode, for k <= TOPK_MAX_K (a page of results): the keys, then
  each tile of `tile_width(T)` columns keeps its k smallest (hi, lo,
  lo2, column) entries; a merge kernel (`select_kernel`, one launch a
  pass, all passes enqueued by the same C call) keeps the k smallest of
  every SELECT_WIDTH survivors until one run is left: the order of the
  stable 3-key sort over all N, sliced to k. For a larger k
  `chain_query_topk` runs the keys mode and `sort3`.
For a CUDA tensor they launch the kernel or raise; for a CPU tensor they
run `chain_cost_matrix_torch`, `chain_query_keys_torch` and
`chain_query_topk_torch`, the JAX package's loop over t, class and prev
in plain torch, and the sort over all N (`sort3`). `select_torch` is the
plain version of the per-tile select; `tile_select_torch` walks the
kernel's tiling with it and `merge_survivors` the merge's passes, on the
CPU, for the tests.

Query model (the common chain case): T <= 16 terms in sequence, 3 typo
classes, the `last` matching strategy, rule order words, typo, proximity,
attribute (fid), position, exactness. Inputs, W the candidate axis's
width (the row stride):
  class_mask : (T, 3, W) bool   doc matches term t via typo class c
  pair_cost  : (max(T-1, 0..1), 3, 3, W) int8, proximity 0..3 between
               consecutive terms for each (left class, right class)
  fid_cost   : (T, 3, W) int32  attribute addend (INF when absent)
  pos_cost   : (T, 3, W) int32  word-position addend
  exact_cost : (T, W) int32     exactness addend (cost mode)
  exact_mask : (T, W) bool      doc holds the exact word (keys modes)
  docids     : (W,) int32, valid : (W,) bool (keys modes)
The wrappers compute the first `n` columns (default W): a caller that
lays the axis out `aligned_width(N)` wide (pad columns: mask False, INF
costs, valid False) and passes n = N takes the kernel's bulk path.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .chain_keys import LaunchCounter

INF = 1 << 24
N_DIMS = 6  # words, typo, proximity, fid, position, exactness
MAX_REL_PROX = 3
MAX_TERMS = 16  # csrc/chain_dp.cu kMaxTerms; the host gives longer chains to the host pass
LAUNCHES = LaunchCounter()
SELECT_LAUNCHES = LaunchCounter()  # the survivors' merge (select_kernel)
SELECT_WIDTH = 1024  # csrc/chain_dp.cu kSelectWidth: entries a merge block sorts
TOPK_MAX_K = 32  # csrc/chain_dp.cu kMaxTopk: the top-k mode's largest k
MODE_COST, MODE_KEYS, MODE_TOPK = 0, 1, 2  # csrc/chain_dp.cu's modes
INVALID_HI = 1 << 30  # key_hi of a column with no interpretation
SENTINEL = (1 << 31) - 1  # every word of a top-k slot past a short tile
ALIGN_COLUMNS = 16  # the bulk path's row stride is a multiple of this
LAST_PATH = {"path": None}  # "bulk" or "direct": the last launch's


def tile_width(T: int) -> int:
    """Columns a tile of the kernel (csrc/chain_dp.cu) walks at T terms:
    a stage of 37T + 5 bytes a column fits twice in a block."""
    return 256 if T <= 8 else 128


def aligned_width(n: int) -> int:
    """The candidate axis's width that takes the kernel's bulk path."""
    return -(-max(n, 1) // ALIGN_COLUMNS) * ALIGN_COLUMNS


def example_inputs(T: int = 4, N: int = 8192, k: int = 10, seed: int = 0):
    """A synthetic example for checks and demos, drawn with numpy exactly
    as the JAX package's `example_inputs` draws it: (class_mask,
    pair_cost, fid_cost, pos_cost, exact_mask, docids, valid), CPU tensors."""
    rng = np.random.default_rng(seed)
    class_mask = rng.random((T, 3, N)) < np.array([0.2, 0.05, 0.02])[None, :, None]
    pair_cost = rng.integers(0, MAX_REL_PROX + 1, size=(T - 1, 3, 3, N), dtype=np.int8)
    fid_cost = rng.integers(0, 4, size=(T, 3, N)).astype(np.int32)
    pos_cost = rng.integers(0, 10, size=(T, 3, N)).astype(np.int32)
    exact_mask = rng.random((T, N)) < 0.1
    docids = np.arange(N, dtype=np.int32)
    valid = rng.random(N) < 0.9
    return tuple(
        torch.from_numpy(a)
        for a in (class_mask, pair_cost, fid_cost, pos_cost, exact_mask, docids, valid)
    )


def _lexmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic elementwise min of two (6, N) cost stacks; on a full
    tie it keeps b."""
    lt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[1:], dtype=torch.bool, device=a.device)
    for d in range(a.shape[0]):
        lt = lt | (eq & (a[d] < b[d]))
        eq = eq & (a[d] == b[d])
    return torch.where(lt[None], a, b)


def _final_costs(class_mask, pair_cost, fid_cost, pos_cost, exact_add) -> torch.Tensor:
    """The DP of both modes in plain torch: (6, N) int32 before the clip.
    `exact_add` (T, N) int32 is the exactness addend of each term."""
    T, C, N = class_mask.shape
    dev = class_mask.device
    inf_state = torch.full((N_DIMS, N), INF, dtype=torch.int32, device=dev)
    # START lives in the skip slot before term 0
    states = [inf_state, inf_state, inf_state, torch.zeros_like(inf_state)]
    for t in range(T):
        new_states = []
        visit_prevs = [3] if t == 0 else list(range(C))
        for cls in range(C):
            best = None
            for prev in visit_prevs:
                entry = torch.zeros((N_DIMS, N), dtype=torch.int32, device=dev)
                entry[1] += cls
                if t > 0:
                    entry[2] += pair_cost[t - 1, prev, cls].to(torch.int32)
                entry[3] += fid_cost[t, cls]
                entry[4] += pos_cost[t, cls]
                entry[5] += exact_add[t]
                entry[0] += torch.where(class_mask[t, cls], 0, INF).to(torch.int32)
                cand = states[prev] + entry
                best = cand if best is None else _lexmin(best, cand)
            new_states.append(best)
        # skip state: +1 on the words dim; the first term is never skippable
        if t == 0:
            best_skip = inf_state
        else:
            skip_entry = torch.zeros((N_DIMS, 1), dtype=torch.int32, device=dev)
            skip_entry[0] = 1
            best_skip = None
            for prev in range(4):
                cand = states[prev] + skip_entry
                best_skip = cand if best_skip is None else _lexmin(best_skip, cand)
        new_states.append(best_skip)
        states = new_states
    return _lexmin(_lexmin(states[0], states[1]), _lexmin(states[2], states[3]))


def chain_cost_matrix_torch(class_mask, pair_cost, fid_cost, pos_cost, exact_cost):
    """The plain torch version of K6's cost mode: (6, N) int32."""
    final = _final_costs(class_mask, pair_cost, fid_cost, pos_cost, exact_cost)
    return torch.clamp(final, max=INF)


def pack_keys(final: torch.Tensor, docids: torch.Tensor, valid: torch.Tensor):
    """The keys mode's epilogue in plain torch: the clipped (6, N) costs
    of the valid columns packed into (key_hi, key_lo, key_lo2), int32,
    as `meilisearch_tpu/ops/device_scorer.py:186-204` packs them."""
    final = torch.where(valid[None], torch.clamp(final, max=INF), INF)
    w = torch.clamp(final[0], 0, 63)
    ty = torch.clamp(final[1], 0, 127)
    px = torch.clamp(final[2], 0, 511)
    fd = torch.clamp(final[3], 0, (1 << 20) - 1)
    ps = torch.clamp(final[4], 0, (1 << 16) - 1)
    ex = torch.clamp(final[5], 0, (1 << 10) - 1)
    key_hi = (w << 23) | (ty << 16) | (px << 7) | (fd >> 13)
    key_hi = torch.where(final[0] >= INF, INVALID_HI, key_hi).to(torch.int32)
    key_lo = ((fd & ((1 << 13) - 1)) << 18) | (ps << 2) | (ex >> 8)
    key_lo2 = ((ex & 255) << 23) | torch.clamp(docids, 0, (1 << 23) - 1)
    return key_hi, key_lo.to(torch.int32), key_lo2.to(torch.int32)


def sort3(key_hi, key_lo, key_lo2, docids, k: int):
    """`lax.sort((key_hi, key_lo, key_lo2, docids), num_keys=3)` sliced
    to k: a stable lexicographic sort on the three keys, so columns whose
    three keys are equal (pad columns, docids clipped at 2^23) keep their
    input order. torch has no multi-key sort: one stable pass on key_lo2,
    then one stable pass on (key_hi << 31) | key_lo as int64 (both keys
    are non-negative and key_lo < 2^31). Returns (docs, hi, lo, lo2)."""
    order = torch.sort(key_lo2, stable=True).indices
    major = (key_hi.long() << 31) | key_lo.long()
    order = order[torch.sort(major[order], stable=True).indices[:k]]
    return docids[order], key_hi[order], key_lo[order], key_lo2[order]


def chain_query_keys_torch(class_mask, pair_cost, fid_cost, pos_cost, exact_mask,
                           docids, valid):
    """The plain torch version of K6's keys mode: (key_hi, key_lo,
    key_lo2), (N,) int32 each."""
    exact_add = (~exact_mask).to(torch.int32)
    final = _final_costs(class_mask, pair_cost, fid_cost, pos_cost, exact_add)
    return pack_keys(final, docids, valid)


def chain_query_topk_torch(class_mask, pair_cost, fid_cost, pos_cost, exact_mask,
                           docids, valid, k: int):
    """The plain torch version of K6's keys mode and the sort:
    (docs (k,), key_hi, key_lo, key_lo2)."""
    keys = chain_query_keys_torch(class_mask, pair_cost, fid_cost, pos_cost,
                                  exact_mask, docids, valid)
    return sort3(*keys, docids, k)


def select_torch(kept, k: int, docids=None, width: int = SELECT_WIDTH):
    """The per-tile select in plain torch, in the kernel's layout: `kept`
    is (4, m) int32, the rows key_hi, key_lo, key_lo2 and column; per run
    of `width` entries it keeps the min(k, width) smallest by (key_hi,
    key_lo, key_lo2, column), in that order, a run's spare slots (past
    the last entry) the sentinel in every word. With `docids`, the
    column row holds docids[column] (the sentinel stays). Returns (4,
    runs * min(k, width)). The plain version of csrc/chain_dp.cu's
    select_kernel, and of the top-k mode's epilogue."""
    m = kept.shape[1]
    runs = -(-m // width)
    pad = torch.full((4, runs * width - m), SENTINEL, dtype=torch.int32, device=kept.device)
    hi, lo, lo2, col = torch.cat([kept, pad], dim=1).view(4, runs, width)
    # stable passes, least significant key first
    order = torch.sort(col, dim=1, stable=True).indices
    order = order.gather(1, torch.sort(lo2.gather(1, order), dim=1, stable=True).indices)
    major = (hi.gather(1, order).long() << 31) | lo.gather(1, order).long()
    keep = order.gather(1, torch.sort(major, dim=1, stable=True).indices)[:, : min(k, width)]
    out = torch.stack([x.gather(1, keep).reshape(-1) for x in (hi, lo, lo2, col)])
    if docids is not None:
        real = out[3] != SENTINEL
        out[3] = torch.where(real, docids[torch.where(real, out[3], 0).long()], out[3])
    return out


def tile_select_torch(key_hi, key_lo, key_lo2, tile: int, k: int):
    """The top-k mode's per-tile select, walked on the CPU: tiles of
    `tile` consecutive columns, each keeping its min(k, columns in the
    tile) smallest entries by (key_hi, key_lo, key_lo2, column), in that
    order, tile after tile. Returns (hi, lo, lo2, column), int32. Test
    code: `sort3` over these survivors (docids gathered by column),
    sliced to min(k, N), equals `sort3` over all N."""
    cols = torch.arange(key_hi.shape[0], dtype=torch.int32, device=key_hi.device)
    out = select_torch(torch.stack([key_hi, key_lo, key_lo2, cols]), k, width=tile)
    return tuple(out[:, out[3] != SENTINEL])


def _check(class_mask, pair_cost, fid_cost, pos_cost, exact, exact_dtype,
           docids=None, valid=None, n=None) -> tuple[int, int, int]:
    """Validate K6's inputs; returns (T, n, W): the columns to compute
    and the axis's width."""
    tensors = {
        "class_mask": (class_mask, torch.bool), "pair_cost": (pair_cost, torch.int8),
        "fid_cost": (fid_cost, torch.int32), "pos_cost": (pos_cost, torch.int32),
        "exact": (exact, exact_dtype),
    }
    if docids is not None:
        tensors["docids"] = (docids, torch.int32)
        tensors["valid"] = (valid, torch.bool)
    for name, (x, dtype) in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != class_mask.device:
            raise ValueError(f"{name} is on {x.device}, class_mask on {class_mask.device}")
    if class_mask.dim() != 3 or class_mask.shape[1] != 3:
        raise ValueError(f"class_mask must be (T, 3, W), got {tuple(class_mask.shape)}")
    T, _, W = class_mask.shape
    if not 1 <= T <= MAX_TERMS:
        raise ValueError(f"T must be in 1..{MAX_TERMS}, got {T}")
    if not 1 <= W < 1 << 31:
        raise ValueError(f"the candidate axis must be 1..2^31 - 1 wide, got {W}")
    n = W if n is None else n
    if not 1 <= n <= W:
        raise ValueError(f"n must be in 1..{W}, got {n}")
    want = {"fid_cost": (T, 3, W), "pos_cost": (T, 3, W), "exact": (T, W)}
    if docids is not None:
        want.update(docids=(W,), valid=(W,))
    for name, shape in want.items():
        if tuple(tensors[name][0].shape) != shape:
            raise ValueError(
                f"{name} has shape {tuple(tensors[name][0].shape)}, want {shape}"
            )
    pairs = pair_cost.shape[0] if pair_cost.dim() == 4 else -1
    if pairs < T - 1 or tuple(pair_cost.shape[1:]) != (3, 3, W):
        raise ValueError(
            f"pair_cost has shape {tuple(pair_cost.shape)}, want ({max(T - 1, 0)}+, 3, 3, {W})"
        )
    return T, n, W


def _columns(n: int, *tensors):
    """The first n columns of each input (the candidate axis is the last)."""
    return [x[..., :n] for x in tensors]


def check_launch(rc: int) -> None:
    """Raise on a non-zero cudaError_t from the C entry point."""
    if rc != 0:
        raise RuntimeError(f"chain_dp kernel launch failed: cudaError_t {rc}")


def bulk_path(W: int, *tensors) -> bool:
    """Whether K6 takes its bulk path on these inputs: a row stride of a
    multiple of ALIGN_COLUMNS and 16-byte-aligned tensors."""
    return W % ALIGN_COLUMNS == 0 and all(x.data_ptr() % 16 == 0 for x in tensors)


def _launch(mode, inputs, outs, T: int, n: int, W: int, k: int = 0) -> None:
    from ._build import load_library

    dev = inputs[0].device
    bulk = bulk_path(W, *(x for x in inputs if x is not None))
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    rc = load_library().mst_chain_dp(
        *map(ptr, inputs), *map(ptr, outs), T, n, W, mode, k, tile_width(T), int(bulk),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(rc)
    LAUNCHES.add()
    LAST_PATH["path"] = "bulk" if bulk else "direct"


def _device(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} launches its kernel on cuda tensors only, not {dev}")


def chain_cost_matrix(class_mask, pair_cost, fid_cost, pos_cost, exact_cost, n=None):
    """K6, cost mode: (6, n) int32 on the inputs' device, each cost
    clipped at INF. CPU tensors run `chain_cost_matrix_torch`; CUDA
    tensors launch the kernel on the current stream (asynchronously)."""
    T, n, W = _check(class_mask, pair_cost, fid_cost, pos_cost, exact_cost, torch.int32, n=n)
    dev = class_mask.device
    if dev.type == "cpu":
        return chain_cost_matrix_torch(
            *_columns(n, class_mask, pair_cost, fid_cost, pos_cost, exact_cost))
    _device(dev, "chain_cost_matrix")
    out = torch.empty((N_DIMS, n), dtype=torch.int32, device=dev)
    _launch(MODE_COST, (class_mask, pair_cost, fid_cost, pos_cost, exact_cost, None, None),
            (out, None, None, None), T, n, W)
    return out


def chain_query_keys(class_mask, pair_cost, fid_cost, pos_cost, exact_mask, docids, valid,
                     n=None):
    """K6, keys mode: (key_hi, key_lo, key_lo2), (n,) int32 each, on the
    inputs' device (CPU: the plain torch DP and `pack_keys`)."""
    inputs = (class_mask, pair_cost, fid_cost, pos_cost, exact_mask, docids, valid)
    T, n, W = _check(*inputs[:5], torch.bool, docids, valid, n=n)
    dev = class_mask.device
    if dev.type == "cpu":
        return chain_query_keys_torch(*_columns(n, *inputs))
    _device(dev, "chain_query_keys")
    keys = tuple(torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3))
    _launch(MODE_KEYS, inputs, (*keys, None), T, n, W)
    return keys


def chain_query_topk(class_mask, pair_cost, fid_cost, pos_cost, exact_mask, docids,
                     valid, k: int, n=None):
    """K6, top-k mode, and the merge of its survivors: (docs (k,),
    key_hi, key_lo, key_lo2) on the inputs' device, the ranked candidates
    first (fewer than k when n < k). For k <= TOPK_MAX_K one C call
    launches the top-k mode and every merge pass (`mst_chain_topk`,
    walked in plain torch by `merge_survivors`); a larger k runs the keys
    mode and `sort3` of all n. CPU tensors run `chain_query_topk_torch`
    (the sort over all n)."""
    inputs = (class_mask, pair_cost, fid_cost, pos_cost, exact_mask, docids, valid)
    T, n, W = _check(*inputs[:5], torch.bool, docids, valid, n=n)
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    dev = class_mask.device
    if dev.type == "cpu":
        return chain_query_topk_torch(*_columns(n, *inputs), k)
    _device(dev, "chain_query_topk")
    if k > TOPK_MAX_K:
        return sort3(*chain_query_keys(*inputs, n=n), docids[:n], k)
    tile = tile_width(T)
    from ._build import load_library

    m0 = -(-n // tile) * k
    m1 = -(-m0 // SELECT_WIDTH) * k if m0 > SELECT_WIDTH else 0
    keep = min(k, n)
    work = torch.empty(4 * (m0 + m1 + keep), dtype=torch.int32, device=dev)
    hi, lo, lo2, docs = work[4 * (m0 + m1):].view(4, keep)
    bulk = bulk_path(W, *inputs)
    passes = ctypes.c_int(0)
    rc = load_library().mst_chain_topk(
        *(x.data_ptr() for x in inputs), work.data_ptr(), 4 * (m0 + m1), hi.data_ptr(),
        T, n, W, k, keep, tile, int(bulk), ctypes.byref(passes),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(rc)
    LAUNCHES.add()
    SELECT_LAUNCHES.add(passes.value)
    LAST_PATH["path"] = "bulk" if bulk else "direct"
    return docs, hi, lo, lo2


def merge_survivors(kept, k: int, docids, keep: int | None = None):
    """The survivors' merge in plain torch, as `mst_chain_topk` runs it:
    each pass (`select_torch`, the plain version of select_kernel) keeps
    the k best of every run of SELECT_WIDTH entries of `kept` ((4, m):
    hi, lo, lo2, column) until one run is left; that last pass keeps
    `keep` (default k) and gathers the docids. The full key ends with the
    column, so the order is strict and each pass is exact. Returns (4,
    keep): hi, lo, lo2 and docids, the ranked first. Test code."""
    while kept.shape[1] > SELECT_WIDTH:
        kept = select_torch(kept, k)
    return select_torch(kept, k if keep is None else keep, docids)
