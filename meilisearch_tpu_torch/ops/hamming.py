"""K4h: hamming distances from one packed sign query to every row of a
binary-quantized vector matrix.

`hamming_rows` is the wrapper of the hand-written CUDA kernel
(`csrc/hamming.cu`, which replaces the XOR-popcount of the jitted XLA
programs `meilisearch_tpu/vector/store.py::_device_topk_dispatch`, its
hamming branch, and `::_device_hamming`). For a CUDA tensor it launches
the kernel or raises; for a CPU tensor it runs `hamming_rows_torch`, the
same function in plain torch.

Sign words are int32 tensors holding the bit pattern of the JAX package's
uint32 words (torch's uint32 has few operations).
"""

from __future__ import annotations

import torch

from .chain_keys import LaunchCounter

LAUNCHES = LaunchCounter()
MAX_WORDS = 12288  # csrc/hamming.cu kMaxWords: q staged in 48 KB of shared memory
POPCOUNT8 = torch.tensor([bin(b).count("1") for b in range(256)], dtype=torch.int32)


def hamming_rows_torch(mat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The plain torch version of K4h: (n,) int32, the set bits of
    mat[r] ^ q summed over the row's words. It counts the XOR's bytes
    through a 256-entry table: torch shifts int32 arithmetically
    (`tensor([-1], int32) >> 1` is -1), which would corrupt a
    shift-and-mask popcount of words with bit 31 set."""
    x = torch.bitwise_xor(mat, q[None, :]).view(torch.uint8)
    return POPCOUNT8.to(x.device)[x.long()].sum(dim=1, dtype=torch.int32)


def _check(mat, q) -> None:
    for name, x in (("mat", mat), ("q", q)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device != mat.device:
        raise ValueError(f"q is on {q.device}, mat on {mat.device}")
    if mat.dim() != 2 or mat.shape[0] < 1 or not 1 <= mat.shape[1] <= MAX_WORDS:
        raise ValueError(
            f"mat must be (n, W) with n >= 1 and 1 <= W <= {MAX_WORDS},"
            f" got {tuple(mat.shape)}"
        )
    if mat.shape[0] >= 1 << 31:
        raise ValueError("mat must have fewer than 2^31 rows")
    if tuple(q.shape) != (mat.shape[1],):
        raise ValueError(f"q has shape {tuple(q.shape)}, want ({mat.shape[1]},)")


def check_launch(rc: int) -> None:
    """Raise on a non-zero cudaError_t from the C entry point."""
    if rc != 0:
        raise RuntimeError(f"hamming kernel launch failed: cudaError_t {rc}")


def hamming_rows(mat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """K4h. Returns ham (n,) int32 on mat's device for `mat` (n, W) and
    `q` (W,) int32 sign words. CPU tensors run `hamming_rows_torch`; CUDA
    tensors launch the kernel on the current stream (asynchronously)."""
    _check(mat, q)
    dev = mat.device
    if dev.type == "cpu":
        return hamming_rows_torch(mat, q)
    if dev.type != "cuda":
        raise ValueError(f"hamming_rows runs on cuda or cpu tensors, not {dev}")
    from ._build import load_library

    n, w = mat.shape
    out = torch.empty(n, dtype=torch.int32, device=dev)
    rc = load_library().mst_hamming(
        mat.data_ptr(), q.data_ptr(), n, w, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(rc)
    LAUNCHES.add()
    return out
