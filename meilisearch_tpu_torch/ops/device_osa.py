"""K3: the typo pass's OSA distance over the WHOLE vocabulary, on the device.

`osa_device` is the wrapper of the hand-written CUDA kernel
(`csrc/osa.cu`, which replaces the jitted XLA program
`meilisearch_tpu/ops/device_osa.py::osa_device`). For a CUDA tensor it
launches the kernel or raises; for a CPU tensor it runs
`osa_device_torch`, the same function in plain torch.

The vocabulary lives on the device as a (n, MAX_LEN) int32 codepoint
matrix per base vocabulary (`DeviceVocab`), n padded to a power of two.
The host pass (`ops/levenshtein.py`) serves small vocabularies and the
delta vocabulary of minor writes; it is also the oracle the tests hold
this module against.
"""

from __future__ import annotations

import numpy as np
import torch

from .chain_keys import LaunchCounter
from .levenshtein import INF, MAX_LEN

# the JAX package's crossover, set for a TPU's ~0.35 s round trip against
# the host pass (~1.7 s at 1M words, ~0.1 s at 100k); not yet re-derived
# for the H100
MIN_DEVICE_VOCAB = 1 << 19
PADDING_FULL = 9999  # full distance of a padding row, before the clip
LAUNCHES = LaunchCounter()
BLOCK = 128  # threads per block; one thread per vocabulary word


def _vocab_bucket(n: int) -> int:
    return max(1 << (n - 1).bit_length(), 1024)


def osa_device_torch(dict_mat, dict_lens, q, m: int, max_dist: int):
    """The plain torch version of K3: (full (n,), prefix_min (n,)) int8.

    dict_mat: (n, MAX_LEN) int32 codepoints (0-padded rows)
    dict_lens: (n,) int32 clamped lengths (0 = padding row)
    q: (MAX_LEN,) int32 query codepoints (0-padded)
    m: true query length (<= MAX_LEN)

    The DP takes one query character per step over rows of MAX_LEN + 1
    columns; the insertion recurrence cur[j] = min(best[j], cur[j-1] + 1)
    is a running minimum of best[k] + (j - k)."""
    n, L = dict_mat.shape
    dev = dict_mat.device
    big = int(INF)
    col = torch.arange(L + 1, dtype=torch.int32, device=dev)[None, :]
    qs = [int(c) for c in q[:m].tolist()]
    prev = col.expand(n, L + 1).clone()  # row 0: D[0][j] = j
    prev2 = torch.zeros_like(prev)
    for i in range(m):
        qc = qs[i]
        sub = prev[:, :-1] + (dict_mat != qc).int()
        best = torch.minimum(prev[:, 1:] + 1, sub)
        if i >= 1:
            # transposition: q[i-1] == w[j-1] and q[i] == w[j-2]
            ok = (dict_mat[:, 1:] == qs[i - 1]) & (dict_mat[:, :-1] == qc)
            trans = torch.where(ok, prev2[:, :-2] + 1, big)
            best[:, 1:] = torch.minimum(best[:, 1:], trans)
        first = torch.full((n, 1), i + 1, dtype=torch.int32, device=dev)
        base = torch.cat([first, best], dim=1) - col
        cur = torch.cummin(base, dim=1).values + col
        prev2, prev = prev, cur
    lens = dict_lens.long()
    full = prev.gather(1, lens[:, None])[:, 0]
    full = torch.where(dict_lens == 0, PADDING_FULL, full)
    valid = col[:, 1:] <= dict_lens[:, None]
    prefix = torch.where(valid, prev[:, 1:], big).amin(dim=1)
    prefix = torch.minimum(prefix, full)
    if m <= max_dist:
        prefix = torch.clamp(prefix, max=m)
    cap = max_dist + 1
    return (
        torch.clamp(full, max=cap).to(torch.int8),
        torch.clamp(prefix, max=cap).to(torch.int8),
    )


def _check(dict_mat, dict_lens, q, m: int, max_dist: int) -> int:
    """Validate K3's inputs; returns n."""
    tensors = {"dict_mat": dict_mat, "dict_lens": dict_lens, "q": q}
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != dict_mat.device:
            raise ValueError(f"{name} is on {x.device}, dict_mat on {dict_mat.device}")
    if dict_mat.dim() != 2 or dict_mat.shape[1] != MAX_LEN or dict_mat.shape[0] < 1:
        raise ValueError(f"dict_mat must be (n, {MAX_LEN}), got {tuple(dict_mat.shape)}")
    n = dict_mat.shape[0]
    if tuple(dict_lens.shape) != (n,):
        raise ValueError(f"dict_lens has shape {tuple(dict_lens.shape)}, want ({n},)")
    if tuple(q.shape) != (MAX_LEN,):
        raise ValueError(f"q has shape {tuple(q.shape)}, want ({MAX_LEN},)")
    if not 0 <= m <= MAX_LEN:
        raise ValueError(f"m must be in 0..{MAX_LEN}, got {m}")
    if max_dist not in (1, 2):
        raise ValueError(f"max_dist must be 1 or 2, got {max_dist}")
    return n


def check_launch(rc: int) -> None:
    """Raise on a non-zero cudaError_t from the C entry point."""
    if rc != 0:
        raise RuntimeError(f"osa kernel launch failed: cudaError_t {rc}")


def osa_device(dict_mat, dict_lens, q, m: int, max_dist: int):
    """K3. Returns (full (n,), prefix_min (n,)) int8 on the inputs' device,
    clipped to max_dist + 1. CPU tensors run `osa_device_torch`; CUDA
    tensors launch the kernel on the current stream (asynchronously)."""
    n = _check(dict_mat, dict_lens, q, m, max_dist)
    dev = dict_mat.device
    if dev.type == "cpu":
        return osa_device_torch(dict_mat, dict_lens, q, m, max_dist)
    if dev.type != "cuda":
        raise ValueError(f"osa_device runs on cuda or cpu tensors, not {dev}")
    if dict_mat.data_ptr() % 16:
        raise ValueError("dict_mat must be 16-byte aligned")
    from ._build import load_library

    lib = load_library()
    full = torch.empty(n, dtype=torch.int8, device=dev)
    prefix = torch.empty(n, dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mst_osa(
        dict_mat.data_ptr(), dict_lens.data_ptr(), q.data_ptr(), m, max_dist, n,
        full.data_ptr(), prefix.data_ptr(), BLOCK, stream,
    )
    check_launch(rc)
    LAUNCHES.add()
    return full, prefix


class DeviceVocab:
    """One base vocabulary's codepoint matrix and lengths on a device,
    rows padded to the power-of-two bucket with 0-length padding rows."""

    def __init__(self, mat: np.ndarray, lens: np.ndarray, device: torch.device):
        self.n_real = len(lens)
        self.n = _vocab_bucket(self.n_real)
        self.device = device
        pad = self.n - self.n_real
        if pad:
            mat = np.pad(mat, ((0, pad), (0, 0)))
            lens = np.pad(lens, (0, pad))
        self.mat = torch.from_numpy(np.ascontiguousarray(mat, np.int32)).to(device)
        self.lens = torch.from_numpy(np.ascontiguousarray(lens, np.int32)).to(device)


def get_device_vocab(store, mat, lens, device: torch.device) -> DeviceVocab:
    """The store's resident vocabulary, keyed by the packed matrix's
    identity (kept alive in the entry): the BASE vocabulary is stable
    across minor writes (store.VocabSnapshot), so the upload survives
    them; a promotion swaps the matrix object and re-uploads once."""
    cached = getattr(store, "_device_vocab", None)
    if cached is not None and cached[0] is mat and cached[1].device == device:
        return cached[1]
    dv = DeviceVocab(mat, lens, device)
    store._device_vocab = (mat, dv)
    return dv


def device_osa_available(store, n_words: int) -> bool:
    """Gate: the store's typo pass has a device (`store.osa_device`), and
    either the vocabulary is large enough for the device pass to beat the
    host pass on CUDA or the store is strict (`store.osa_strict`, which
    also takes a CPU device, the tests' plain-version route)."""
    device = getattr(store, "osa_device", None)
    if device is None:
        return False
    if getattr(store, "osa_strict", False):
        return True
    return device.type == "cuda" and n_words >= MIN_DEVICE_VOCAB


def osa_distances_device(
    store, mat, lens, query: str, max_dist: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    """Drop-in for levenshtein.osa_distances over the full base
    vocabulary on `store.osa_device`: numpy int32 (full, prefix_min)
    clipped to max_dist + 1 (a 2 MB readback at 1M words)."""
    dv = get_device_vocab(store, mat, lens, store.osa_device)
    cps = [ord(c) for c in query[:MAX_LEN]]
    q = np.zeros(MAX_LEN, dtype=np.int32)
    q[: len(cps)] = cps
    full, prefix = osa_device(
        dv.mat, dv.lens, torch.from_numpy(q).to(dv.device), len(cps), max_dist
    )
    full = full[: dv.n_real].cpu().numpy().astype(np.int32)
    prefix = prefix[: dv.n_real].cpu().numpy().astype(np.int32)
    return full, prefix
