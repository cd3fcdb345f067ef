"""K4h: hamming distances from one packed sign query to every row of a
binary-quantized vector matrix.

`hamming_rows` and `hamming_keyed` are the wrappers of the hand-written
CUDA kernel's two modes (`csrc/hamming.cu`, which replaces the jitted XLA
programs `meilisearch_tpu/vector/store.py::_device_hamming` and the
hamming branch of `::_device_topk_dispatch`):
- `hamming_rows`: the distances, (n,) int32 (the full column);
- `hamming_keyed`: the cosine of each row, the pad rows masked to -2.0,
  and `topk_key` of that cosine, written by the kernel's epilogue, so
  that the binary leg's top-k follows the launch with nothing between.
For a CUDA tensor they launch the kernel or raise; for a CPU tensor they
run `hamming_rows_torch` and `hamming_keyed_torch`, the same functions in
plain torch.

Sign words are int32 tensors holding the bit pattern of the JAX package's
uint32 words (torch's uint32 has few operations).
"""

from __future__ import annotations

import torch

from .chain_keys import LaunchCounter

LAUNCHES = LaunchCounter()  # launches of either mode
MODE_HAM, MODE_KEYED = 0, 1  # csrc/hamming.cu's modes
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


def ham_cos(ham: torch.Tensor, dim: int) -> torch.Tensor:
    """cos = (dim - 2 ham) / dim of sign vectors in float32, rounded as
    the numpy host pass of both packages rounds it: one IEEE division.
    A product with 1 / dim is an ulp off for some ham where dim is not a
    power of two; the JAX package's jitted leg takes it on XLA's CPU
    backend, and torch takes it for a CUDA tensor divided by a CPU
    scalar, so the divisor is a tensor filled on ham's device."""
    divisor = torch.full((), float(dim), dtype=torch.float32, device=ham.device)
    return (dim - 2.0 * ham.float()) / divisor


def topk_key(vals: torch.Tensor) -> torch.Tensor:
    """`lax.top_k`'s order of a float32 vector as a unique int64 key, the
    largest key first: the high word the value's bits made order-preserving
    as a signed integer (negative floats' magnitude bits flipped; +0.0
    above -0.0), the low word 2^32 - 1 - index (equal values, lower index
    first)."""
    bits = vals.view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    low = 0xFFFFFFFF - torch.arange(vals.numel(), device=vals.device)
    return ordered * (1 << 32) + low


def hamming_keyed_torch(mat: torch.Tensor, q: torch.Tensor, dim: int, n_live: int):
    """The plain torch version of K4h's keyed mode: (cos, key), (n,)
    float32 and int64. cos is `ham_cos` of the distances, -2.0 (below any
    cosine) from row n_live on; key is `topk_key(cos)`."""
    cos = ham_cos(hamming_rows_torch(mat, q), dim)
    cos[n_live:] = -2.0
    return cos, topk_key(cos)


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
        mat.data_ptr(), q.data_ptr(), n, w, MODE_HAM, 0, n, out.data_ptr(), None, None,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(rc)
    LAUNCHES.add()
    return out


def hamming_keyed(mat: torch.Tensor, q: torch.Tensor, dim: int, n_live: int):
    """K4h's keyed mode. Returns (cos, key) on mat's device, (n,) float32
    and int64, for `mat` (n, W) and `q` (W,) int32 sign words of a
    `dim`-dimension embedder whose first `n_live` rows are real (the rest
    are pad rows and are not read on the card). CPU tensors run
    `hamming_keyed_torch`; CUDA tensors launch the kernel on the current
    stream (asynchronously)."""
    _check(mat, q)
    n, w = mat.shape
    if isinstance(dim, bool) or not isinstance(dim, int) or dim < 1:
        raise ValueError(f"dim must be a positive int, got {dim!r}")
    if isinstance(n_live, bool) or not isinstance(n_live, int) or not 0 <= n_live <= n:
        raise ValueError(f"n_live must be an int in [0, {n}], got {n_live!r}")
    dev = mat.device
    if dev.type == "cpu":
        return hamming_keyed_torch(mat, q, dim, n_live)
    if dev.type != "cuda":
        raise ValueError(f"hamming_keyed runs on cuda or cpu tensors, not {dev}")
    from ._build import load_library

    cos = torch.empty(n, dtype=torch.float32, device=dev)
    key = torch.empty(n, dtype=torch.int64, device=dev)
    rc = load_library().mst_hamming(
        mat.data_ptr(), q.data_ptr(), n, w, MODE_KEYED, dim, n_live, None,
        cos.data_ptr(), key.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(rc)
    LAUNCHES.add()
    return cos, key
