"""K3: the typo pass's OSA distance over the WHOLE vocabulary, on the device.

`osa_device` is the wrapper of the hand-written CUDA kernel
(`csrc/osa.cu`, which replaces the jitted XLA program
`meilisearch_tpu/ops/device_osa.py::osa_device`). For a CUDA tensor it
launches the kernel or raises; for a CPU tensor it runs
`osa_device_torch`, the same function in plain torch.

The vocabulary lives on the device as a (n, MAX_LEN) int32 codepoint
matrix per base vocabulary (`DeviceVocab`), n padded to a power of two,
with `order`, its row ids sorted by length, so that the kernel's warps
take words of one length. The kernel is bit-parallel over the query: the
host turns the query into a hash table of position masks
(`query_table`) passed to the kernel by value. The host pass
(`ops/levenshtein.py`) serves small vocabularies and the delta vocabulary
of minor writes; it is also the oracle the tests hold this module against.
"""

from __future__ import annotations

import ctypes

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
SLOT_BITS = 7  # the query table's 128 slots (csrc/osa.cu kSlotBits)
SLOTS = 1 << SLOT_BITS
# query_table tries the odd multipliers FIRST_MULT + k * MULT_STEP (mod
# 2^32) for k < MAX_TRIES; with 32 distinct keys in 128 slots about one
# multiplier in 70 is collision-free, with 10 keys about two in three
FIRST_MULT, MULT_STEP, MAX_TRIES = 0x9E3779B1, 0x3C6EF372, 1 << 16
PY_TRIES, MULT_BLOCK = 8, 64


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


def _check(dict_mat, dict_lens, q, m: int, max_dist: int, order) -> int:
    """Validate K3's inputs; returns n. `q` lies on the CPU whatever the
    device: the kernel takes the query on the host."""
    tensors = {"dict_mat": dict_mat, "dict_lens": dict_lens, "q": q, "order": order}
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.type != "cpu":
        raise ValueError(f"q must lie on the CPU, not on {q.device}")
    for name in ("dict_lens", "order"):
        if tensors[name].device != dict_mat.device:
            raise ValueError(f"{name} is on {tensors[name].device}, dict_mat on {dict_mat.device}")
    if dict_mat.dim() != 2 or dict_mat.shape[1] != MAX_LEN or dict_mat.shape[0] < 1:
        raise ValueError(f"dict_mat must be (n, {MAX_LEN}), got {tuple(dict_mat.shape)}")
    n = dict_mat.shape[0]
    for name in ("dict_lens", "order"):
        if tuple(tensors[name].shape) != (n,):
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, want ({n},)")
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


def _free_mult(keys: list[int]) -> int:
    """The first multiplier of the sequence under which `keys` take
    distinct slots. Up to about 20 distinct codepoints a few tries do,
    and the first PY_TRIES are cheapest in Python; past them the search
    takes MULT_BLOCK multipliers at a time in numpy (32 keys need about 70)."""
    shift = 32 - SLOT_BITS
    for k in range(PY_TRIES):
        mult = (FIRST_MULT + k * MULT_STEP) & 0xFFFFFFFF
        if len({((c * mult) & 0xFFFFFFFF) >> shift for c in keys}) == len(keys):
            return mult
    low32 = np.uint64(0xFFFFFFFF)
    cols = np.array(keys, np.uint64)[None, :]
    for k0 in range(PY_TRIES, MAX_TRIES, MULT_BLOCK):
        k = np.arange(k0, k0 + MULT_BLOCK, dtype=np.uint64)[:, None]
        mults = (np.uint64(FIRST_MULT) + k * np.uint64(MULT_STEP)) & low32
        ranked = np.sort(((mults * cols) & low32) >> np.uint64(shift), axis=1)
        free = (ranked[:, 1:] != ranked[:, :-1]).all(axis=1)
        if free.any():
            return int(mults[int(np.argmax(free)), 0])
    raise RuntimeError(f"no collision-free query table for {sorted(keys)}")


def query_table(cps: list[int]) -> tuple[int, list[int], list[int]]:
    """The kernel's view of the query: (mult, key, mask), SLOTS entries
    each. Every distinct codepoint c of `cps` (at most 32, any value up to
    0x10FFFF) sits alone in slot ((c * mult) mod 2^32) >> (32 - SLOT_BITS)
    with its position mask (bit i set where cps[i] == c); the other slots
    hold key -1, which no codepoint equals, and mask 0."""
    masks: dict[int, int] = {}
    for i, c in enumerate(cps):
        masks[c] = masks.get(c, 0) | (1 << i)
    mult = _free_mult(list(masks))
    key, mask = [-1] * SLOTS, [0] * SLOTS
    for c, bits in masks.items():
        slot = ((c * mult) & 0xFFFFFFFF) >> (32 - SLOT_BITS)
        key[slot], mask[slot] = c, bits
    return mult, key, mask


class OsaQuery(ctypes.Structure):
    """csrc/osa.cu's OsaQuery, the kernel's by-value query parameter."""

    _fields_ = [
        ("key", ctypes.c_int32 * SLOTS),
        ("mask", ctypes.c_uint32 * SLOTS),
        ("mult", ctypes.c_uint32),
        ("m", ctypes.c_int32),
        ("max_dist", ctypes.c_int32),
    ]


def query_params(cps: list[int], max_dist: int) -> OsaQuery:
    """The kernel's query parameter for the codepoints `cps`."""
    mult, key, mask = query_table(cps)
    params = OsaQuery(mult=mult, m=len(cps), max_dist=max_dist)
    params.key[:] = key
    params.mask[:] = mask
    return params


def length_order(dict_lens: torch.Tensor) -> torch.Tensor:
    """The row ids stably sorted by length, as int32 on the lengths'
    device: the kernel's thread t takes word order[t]."""
    return torch.sort(dict_lens, stable=True).indices.to(torch.int32)


def launch(dict_mat, dict_lens, order, params: OsaQuery):
    """One launch of K3 on the current stream, on inputs `osa_device`
    has checked and a query `query_params` has prepared."""
    from ._build import load_library

    dev = dict_mat.device
    n = dict_mat.shape[0]
    full = torch.empty(n, dtype=torch.int8, device=dev)
    prefix = torch.empty(n, dtype=torch.int8, device=dev)
    rc = load_library().mst_osa(
        dict_mat.data_ptr(), dict_lens.data_ptr(), order.data_ptr(),
        ctypes.addressof(params), n, full.data_ptr(), prefix.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check_launch(rc)
    LAUNCHES.add()
    return full, prefix


def osa_device(dict_mat, dict_lens, q, m: int, max_dist: int, order):
    """K3. Returns (full (n,), prefix_min (n,)) int8 on dict_mat's device,
    clipped to max_dist + 1. `q` is the (MAX_LEN,) int32 query on the CPU
    (the kernel takes it as a parameter) and `order` the rows sorted by
    length, `DeviceVocab.order` (or `length_order(dict_lens)`): a
    permutation of 0..n-1, which is not checked here; the kernel skips a
    row id out of range, and leaves unwritten the rows it would have named.
    CPU tensors run `osa_device_torch`; CUDA tensors launch the kernel on
    the current stream (asynchronously)."""
    _check(dict_mat, dict_lens, q, m, max_dist, order)
    dev = dict_mat.device
    if dev.type == "cpu":
        return osa_device_torch(dict_mat, dict_lens, q, m, max_dist)
    if dev.type != "cuda":
        raise ValueError(f"osa_device runs on cuda or cpu tensors, not {dev}")
    if dict_mat.data_ptr() % 16:
        raise ValueError("dict_mat must be 16-byte aligned")
    params = query_params(q[:m].tolist(), max_dist)
    return launch(dict_mat, dict_lens, order, params)


class DeviceVocab:
    """One base vocabulary's codepoint matrix and lengths on a device,
    rows padded to the power-of-two bucket with 0-length padding rows, and
    `order`, the row ids stably sorted by length (built once per upload)."""

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
        self.order = length_order(self.lens)


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
    """Gate: the store's typo pass has a device (`store.device`), and
    either the vocabulary is large enough for the device pass to beat the
    host pass on CUDA or the store is strict (`store.osa_strict`, which
    also takes a CPU device, the tests' plain-version route)."""
    device = getattr(store, "device", None)
    if device is None:
        return False
    if getattr(store, "osa_strict", False):
        return True
    return device.type == "cuda" and n_words >= MIN_DEVICE_VOCAB


def query_tensor(query: str) -> tuple[torch.Tensor, int]:
    """The query's first MAX_LEN codepoints as a 0-padded (MAX_LEN,) int32
    CPU tensor, and their count m."""
    cps = [ord(c) for c in query[:MAX_LEN]]
    q = np.zeros(MAX_LEN, dtype=np.int32)
    q[: len(cps)] = cps
    return torch.from_numpy(q), len(cps)


def osa_distances_device(
    store, mat, lens, query: str, max_dist: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    """Drop-in for levenshtein.osa_distances over the full base
    vocabulary on `store.device`: numpy int32 (full, prefix_min)
    clipped to max_dist + 1 (a 2 MB readback at 1M words). The query
    stays on the host: the kernel takes it as a parameter."""
    dv = get_device_vocab(store, mat, lens, store.device)
    q, m = query_tensor(query)
    full, prefix = osa_device(dv.mat, dv.lens, q, m, max_dist, dv.order)
    full = full[: dv.n_real].cpu().numpy().astype(np.int32)
    prefix = prefix[: dv.n_real].cpu().numpy().astype(np.int32)
    return full, prefix
