"""K6: the fused lexicographic chain DP over a query's candidate axis.

`chain_cost_matrix` and `chain_query_topk` are the wrappers of the
hand-written CUDA kernel's two modes (`csrc/chain_dp.cu`, which replaces
the jitted XLA programs `meilisearch_tpu/ops/device_scorer.py::
chain_cost_matrix` and `::chain_query_topk`):
- cost mode: the final (6, N) int32 cost matrix, clipped at INF;
- keys mode: the same DP with the `valid` mask, the 6 dimensions packed
  into three int32 sort keys (hi, lo, lo2), then a stable 3-key sort in
  torch ops, sliced to k.
For a CUDA tensor they launch the kernel or raise; for a CPU tensor they
run `chain_cost_matrix_torch` and `chain_query_keys_torch`, the JAX
package's loop over t, class and prev in plain torch.

Query model (the common chain case): T <= 16 terms in sequence, 3 typo
classes, the `last` matching strategy, rule order words, typo, proximity,
attribute (fid), position, exactness. Inputs, N the candidate axis:
  class_mask : (T, 3, N) bool   doc matches term t via typo class c
  pair_cost  : (max(T-1, 0..1), 3, 3, N) int8, proximity 0..3 between
               consecutive terms for each (left class, right class)
  fid_cost   : (T, 3, N) int32  attribute addend (INF when absent)
  pos_cost   : (T, 3, N) int32  word-position addend
  exact_cost : (T, N) int32     exactness addend (cost mode)
  exact_mask : (T, N) bool      doc holds the exact word (keys mode)
  docids     : (N,) int32, valid : (N,) bool (keys mode)
"""

from __future__ import annotations

import numpy as np
import torch

from .chain_keys import LaunchCounter

INF = 1 << 24
N_DIMS = 6  # words, typo, proximity, fid, position, exactness
MAX_REL_PROX = 3
MAX_TERMS = 16  # csrc/chain_dp.cu kMaxTerms; the host gives longer chains to the host pass
LAUNCHES = LaunchCounter()
MODE_COST, MODE_KEYS = 0, 1  # csrc/chain_dp.cu's modes
INVALID_HI = 1 << 30  # key_hi of a column with no interpretation


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


def _check(class_mask, pair_cost, fid_cost, pos_cost, exact, exact_dtype,
           docids=None, valid=None) -> tuple[int, int]:
    """Validate K6's inputs; returns (T, N)."""
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
        raise ValueError(f"class_mask must be (T, 3, N), got {tuple(class_mask.shape)}")
    T, _, N = class_mask.shape
    if not 1 <= T <= MAX_TERMS:
        raise ValueError(f"T must be in 1..{MAX_TERMS}, got {T}")
    if not 1 <= N < 1 << 31:
        raise ValueError(f"N must be in 1..2^31 - 1, got {N}")
    want = {"fid_cost": (T, 3, N), "pos_cost": (T, 3, N), "exact": (T, N)}
    if docids is not None:
        want.update(docids=(N,), valid=(N,))
    for name, shape in want.items():
        if tuple(tensors[name][0].shape) != shape:
            raise ValueError(
                f"{name} has shape {tuple(tensors[name][0].shape)}, want {shape}"
            )
    pairs = pair_cost.shape[0] if pair_cost.dim() == 4 else -1
    if pairs < T - 1 or tuple(pair_cost.shape[1:]) != (3, 3, N):
        raise ValueError(
            f"pair_cost has shape {tuple(pair_cost.shape)}, want ({max(T - 1, 0)}+, 3, 3, {N})"
        )
    return T, N


def check_launch(rc: int) -> None:
    """Raise on a non-zero cudaError_t from the C entry point."""
    if rc != 0:
        raise RuntimeError(f"chain_dp kernel launch failed: cudaError_t {rc}")


def _launch(mode, class_mask, pair_cost, fid_cost, pos_cost, exact, docids, valid,
            outs, T: int, N: int) -> None:
    from ._build import load_library

    dev = class_mask.device
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    rc = load_library().mst_chain_dp(
        ptr(class_mask), ptr(pair_cost), ptr(fid_cost), ptr(pos_cost), ptr(exact),
        ptr(docids), ptr(valid), ptr(outs[0]), ptr(outs[1]), ptr(outs[2]),
        T, N, mode, torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(rc)
    LAUNCHES.add()


def chain_cost_matrix(class_mask, pair_cost, fid_cost, pos_cost, exact_cost):
    """K6, cost mode: (6, N) int32 on the inputs' device, each cost
    clipped at INF. CPU tensors run `chain_cost_matrix_torch`; CUDA
    tensors launch the kernel on the current stream (asynchronously)."""
    T, N = _check(class_mask, pair_cost, fid_cost, pos_cost, exact_cost, torch.int32)
    dev = class_mask.device
    if dev.type == "cpu":
        return chain_cost_matrix_torch(class_mask, pair_cost, fid_cost, pos_cost, exact_cost)
    if dev.type != "cuda":
        raise ValueError(f"chain_cost_matrix runs on cuda or cpu tensors, not {dev}")
    out = torch.empty((N_DIMS, N), dtype=torch.int32, device=dev)
    _launch(MODE_COST, class_mask, pair_cost, fid_cost, pos_cost, exact_cost,
            None, None, (out, None, None), T, N)
    return out


def chain_query_keys(class_mask, pair_cost, fid_cost, pos_cost, exact_mask, docids, valid):
    """K6, keys mode, before the sort: (key_hi, key_lo, key_lo2), (N,)
    int32 each, on the inputs' device (CPU: the plain torch DP and
    `pack_keys`)."""
    T, N = _check(class_mask, pair_cost, fid_cost, pos_cost, exact_mask, torch.bool,
                  docids, valid)
    dev = class_mask.device
    if dev.type == "cpu":
        return chain_query_keys_torch(class_mask, pair_cost, fid_cost, pos_cost,
                                      exact_mask, docids, valid)
    if dev.type != "cuda":
        raise ValueError(f"chain_query_keys runs on cuda or cpu tensors, not {dev}")
    keys = tuple(torch.empty(N, dtype=torch.int32, device=dev) for _ in range(3))
    _launch(MODE_KEYS, class_mask, pair_cost, fid_cost, pos_cost, exact_mask,
            docids, valid, keys, T, N)
    return keys


def chain_query_topk(class_mask, pair_cost, fid_cost, pos_cost, exact_mask, docids,
                     valid, k: int):
    """K6, keys mode, and the stable 3-key sort: (docs (k,), key_hi, key_lo,
    key_lo2) on the inputs' device, the ranked candidates first (fewer
    than k when N < k)."""
    keys = chain_query_keys(class_mask, pair_cost, fid_cost, pos_cost, exact_mask,
                            docids, valid)
    return sort3(*keys, docids, k)
