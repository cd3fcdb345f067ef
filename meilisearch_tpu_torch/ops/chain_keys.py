"""K1: per-(query, document) chain-DP keys over the resident plane pool.

`chain_keys` is the wrapper of the hand-written CUDA kernel
(`csrc/chain_keys.cu`, which replaces the Pallas kernel
`meilisearch_tpu/ops/pallas_scorer.py::pallas_chain_keys`). For a CUDA
tensor it launches the kernel or raises; for a CPU tensor it runs
`chain_keys_torch`, the same function in plain torch.

Layouts (index/device_arena.py): pool rows are lane-blocked packed bytes
(byte lane j of word w holds doc j*(D/4) + w); bitmaps are bit-blocked
(bit j of word w holds doc j*(D/32) + w). Keys come back in doc order.
"""

from __future__ import annotations

import threading

import torch

from .arena_host import INVALID_KEY, _key_layout


class LaunchCounter:
    """Kernel launches since the last reset (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0


LAUNCHES = LaunchCounter()
BLOCK = 128  # threads per block; one thread per bitmap word


def n_rows(T: int) -> int:
    """Pool rows one query names: T*3 term, max(T-1,1)*3 pair, T+1 ea."""
    return T * 3 + max(T - 1, 1) * 3 + T + 1


def unpack_bytes(words: torch.Tensor) -> torch.Tensor:
    """(..., D/4) int32 lane-blocked words -> (..., D) raw bytes 0..255."""
    return torch.cat([(words >> (8 * j)) & 0xFF for j in range(4)], dim=-1)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., D/32) int32 bit-blocked words -> (..., D) bool."""
    return torch.cat([((words >> j) & 1).bool() for j in range(32)], dim=-1)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(B, D) bool -> (B, D/32) int32 bit-blocked words."""
    B, D = mask.shape
    shifts = torch.arange(32, device=mask.device, dtype=torch.int64)
    words = (mask.view(B, 32, D // 32).to(torch.int64) << shifts[None, :, None]).sum(1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def chain_keys_torch(byte_pool, rows, adj, mand, use_valid, universe, live, T: int):
    """The plain torch version of K1: (keys (B, D), candw (B, D/32),
    counts (B,)), all int32."""
    B = rows.shape[0]
    tp = max(T - 1, 1)
    sh_ea, sh_ps, sh_fd, sh_px, sh_ty, sh_w, total = _key_layout(T)
    BIG = 1 << total

    def plane(r):  # (B, D) raw bytes of each query's r-th row
        return unpack_bytes(byte_pool[rows[:, r].long()])

    states = None
    for t in range(T):
        p = [plane(t * 3 + c) for c in range(3)]
        if states is None:
            states = [torch.full_like(p[0], BIG) for _ in range(3)]
            states.append(torch.zeros_like(p[0]))
        present = [pc != 0xFF for pc in p]
        exact_add = (~((p[0] >= 0x80) & present[0])).to(torch.int32)
        md = mand[:, t : t + 1] != 0
        if t > 0:
            aj = adj[:, t - 1 : t] != 0
            pr = [
                torch.where(aj, plane(3 * T + (t - 1) * 3 + c), 0)
                for c in range(3)
            ]
        new = []
        for cls in range(3):
            pc = p[cls]
            base = (
                (cls << sh_ty)
                + (((pc >> 4) & 7) << sh_fd)
                + (torch.clamp(pc & 15, max=10) << sh_ps)
                + exact_add
            )
            if t == 0:
                best = states[3] + base
            else:
                best = None
                for prev in range(3):
                    cand = states[prev] + base + (((pr[prev] >> (2 * cls)) & 3) << sh_px)
                    best = cand if best is None else torch.minimum(best, cand)
                best = torch.where(md, torch.minimum(best, states[3] + base), best)
            new.append(torch.where(present[cls], torch.clamp(best, max=BIG), BIG))
        skip = torch.minimum(
            torch.minimum(states[0], states[1]), torch.minimum(states[2], states[3])
        )
        skip = torch.where(md, BIG, torch.clamp(skip + (1 << sh_w), max=BIG))
        states = new + [skip]

    key = torch.minimum(
        torch.minimum(states[0], states[1]), torch.minimum(states[2], states[3])
    )
    dead = key >= BIG
    level = torch.clamp(T - (key >> sh_w), 0, T)
    ea = torch.zeros_like(key)
    for lvl in range(T + 1):
        r = plane(3 * T + 3 * tp + lvl)
        ea = torch.where(level == lvl, torch.where(r >= 0x80, 2, r), ea)
    key = key | (ea << sh_ea)

    valid = unpack_bits(live)[None, :] & (
        unpack_bits(universe) | (use_valid == 0)[:, None]
    )
    cand = valid & ~dead
    keys = torch.where(cand, key, INVALID_KEY).to(torch.int32)
    return keys, pack_bits(cand), cand.sum(1, dtype=torch.int32)


def _check(byte_pool, rows, adj, mand, use_valid, universe, live, T: int) -> int:
    """Validate K1's inputs; returns D."""
    tensors = {
        "byte_pool": byte_pool, "rows": rows, "adj": adj, "mand": mand,
        "use_valid": use_valid, "universe": universe, "live": live,
    }
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != byte_pool.device:
            raise ValueError(f"{name} is on {x.device}, byte_pool on {byte_pool.device}")
    if T not in range(1, 7):
        raise ValueError(f"T must be in 1..6, got {T}")
    if byte_pool.dim() != 2:
        raise ValueError("byte_pool must be (rows, D/4)")
    D = byte_pool.shape[1] * 4
    if D < 1024 or D & (D - 1):
        raise ValueError(f"D must be a power of two >= 1024, got {D}")
    if byte_pool.numel() >= 1 << 31:
        raise ValueError("byte_pool must hold fewer than 2^31 words")
    B = rows.shape[0] if rows.dim() == 2 else -1
    want = {
        "rows": (B, n_rows(T)), "adj": (B, max(T - 1, 1)), "mand": (B, T),
        "use_valid": (B,), "universe": (B, D // 32), "live": (D // 32,),
    }
    for name, shape in want.items():
        if B < 1 or tuple(tensors[name].shape) != shape:
            raise ValueError(
                f"{name} has shape {tuple(tensors[name].shape)}, want {shape}"
            )
    return D


def check_launch(rc: int) -> None:
    """Raise on a non-zero cudaError_t from the C entry point."""
    if rc != 0:
        raise RuntimeError(f"chain_keys kernel launch failed: cudaError_t {rc}")


def chain_keys(byte_pool, rows, adj, mand, use_valid, universe, live, T: int):
    """K1. Returns (keys (B, D), candw (B, D/32), counts (B,)), int32, on
    the inputs' device. CPU tensors run `chain_keys_torch`; CUDA tensors
    launch the kernel on the current stream (asynchronously)."""
    D = _check(byte_pool, rows, adj, mand, use_valid, universe, live, T)
    dev = byte_pool.device
    if dev.type == "cpu":
        return chain_keys_torch(byte_pool, rows, adj, mand, use_valid, universe, live, T)
    if dev.type != "cuda":
        raise ValueError(f"chain_keys runs on cuda or cpu tensors, not {dev}")
    from ._build import load_library

    lib = load_library()
    B, w32 = rows.shape[0], D // 32
    keys = torch.empty((B, D), dtype=torch.int32, device=dev)
    candw = torch.empty((B, w32), dtype=torch.int32, device=dev)
    counts = torch.zeros((B,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mst_chain_keys(
        byte_pool.data_ptr(), rows.data_ptr(), adj.data_ptr(), mand.data_ptr(),
        use_valid.data_ptr(), universe.data_ptr(), live.data_ptr(),
        keys.data_ptr(), candw.data_ptr(), counts.data_ptr(),
        B, T, w32, min(BLOCK, w32), stream,
    )
    check_launch(rc)
    LAUNCHES.add()
    return keys, candw, counts
