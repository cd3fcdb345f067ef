"""Vector store: exact nearest-neighbor search + IVF at scale.

Reference behavior: milli/src/vector/store.rs — arroy (random-projection
trees) / hannoy (HNSW, M=16/M0=32/efC=125) ANN over LMDB, with a
linear-scan fallback below 300k items or <10% filter ratio (store.rs:22-27).

Design:
  * an exact dot-product top-k over a per-(embedder, index generation)
    matrix, recall 1.0. The store's device (`store.device`, bound by the
    App: engine/index_map.py) picks the legs: None runs the numpy pass;
    a torch device keeps the matrix resident there (uploaded once per
    generation, rows padded to a power-of-two bucket) and computes the
    similarity column and its top-k there, the JAX package's device legs
    under their names. On a CUDA device the binary-quantized legs go
    through K4h (ops/hamming.py, csrc/hamming.cu), whose keyed mode also
    writes the top-k's cosine, pad mask and sort key; on the CPU through
    its plain torch version. Every device failure raises (counted in
    `serving_stats()["device_errors"]`); nothing falls back to the host.
  * the float leg is one `torch.matmul` (cuBLAS on the card) in full
    float32: it needs `torch.backends.cuda.matmul.allow_tf32 = False`,
    PyTorch's default, and raises otherwise (TF32 keeps about three
    digits and would move near-ties).
  * the device top-k is `lax.top_k`'s: equal values lower row first, and
    +0.0 above -0.0 (`_topk_from_key` on `ops.hamming.topk_key`), so the
    hits and their order equal the JAX package's.
  * binaryQuantized stores SIGN BITS packed 32/word (32x smaller than the
    f32 matrix; the reference's BQ exists for exactly this memory cut,
    store.rs hamming path). Scoring is hamming via XOR+popcount:
    for sign vectors dot = dim - 2*hamming, so the returned similarity
    (1+cos)/2 equals the exact cosine of the quantized vectors.
  * IVF partitioning above MEILI_TPU_IVF_THRESHOLD vectors (default 1M):
    k-means centroids (nlist ~ sqrt(n)), lists contiguous in a reordered
    matrix; a query scans the nprobe nearest lists exactly, on the host.
    Same API, recall reported by tests against the exact path.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from ..index.store import IndexStore
from ..ops.chain_keys import LaunchCounter
from ..ops.hamming import hamming_keyed, hamming_rows, topk_key

# the JAX package's gate (below it its host matmul beat a TPU's dispatch
# cost); not yet re-derived for the H100
DEVICE_MIN_ROWS = 4096
_RESIDENT_LOCK = threading.Lock()  # one upload of a matrix, however many callers
_STORE_LOCKS = threading.Lock()  # makes each store's `_build_lock`
FLOAT_LEGS = LaunchCounter()  # float-leg products issued on a torch device


def _ivf_threshold() -> int:
    return int(os.environ.get("MEILI_TPU_IVF_THRESHOLD", "1000000"))


def _pack_signs(matrix: np.ndarray) -> np.ndarray:
    """(n, dim) float -> (n, ceil(dim/32)) uint32 sign bitmap."""
    bits = (matrix >= 0).astype(np.uint8)
    pad = (-bits.shape[1]) % 32
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    return (
        np.packbits(bits, axis=1, bitorder="little")
        .reshape(bits.shape[0], -1, 4)
        .view(np.uint32)
        .reshape(bits.shape[0], -1)
    )


def _build_lock(store: IndexStore) -> threading.Lock:
    """The store's lock around building a VectorSearcher's state."""
    lock = getattr(store, "_vector_searcher_lock", None)
    if lock is None:
        with _STORE_LOCKS:
            lock = getattr(store, "_vector_searcher_lock", None)
            if lock is None:
                lock = store._vector_searcher_lock = threading.Lock()
    return lock


class VectorSearcher:
    """Per-(index, embedder) exact/IVF search, on the store's device."""

    def __init__(self, store: IndexStore, embedder: str):
        self.store = store
        self.embedder = embedder
        self.device = store.device
        # one build of a generation's state, however many threads ask for it
        # (the scheduler's warm-up, `App.warm_devices`, searches): each would
        # otherwise start its own resident map, the last to finish would
        # replace the others in the cache, and the uploads made into the
        # others would be lost to the next searcher
        with _build_lock(store):
            self._build(store, embedder)

    def _build(self, store: IndexStore, embedder: str) -> None:
        self.generation = store.generation
        # cached on the store itself (an id(store)-keyed global dict would
        # serve stale matrices when a freed store's id is reused)
        caches = getattr(store, "_vector_searcher_cache", None)
        if caches is None:
            caches = {}
            store._vector_searcher_cache = caches
        cached = caches.get(embedder)
        if cached and cached[0] == self.generation:
            (
                self.docids,
                self.matrix,
                self.norms,
                self.quantized,
                self.dim,
                self._ivf,
                self._device,
            ) = cached[1]
            return
        per_doc = store.vectors.get(embedder, {})
        conf = store.settings.embedders.get(embedder, {})
        self.quantized = bool(conf.get("binaryQuantized"))
        docids = []
        rows = []
        for docid in sorted(per_doc):
            for row in per_doc[docid]:
                docids.append(docid)
                rows.append(row)
        self.docids = np.asarray(docids, dtype=np.int64)
        self.dim = len(rows[0]) if rows else 0
        if rows:
            matrix = np.stack(rows).astype(np.float32)
            if self.quantized:
                self.matrix = _pack_signs(matrix)  # (n, dim/32) uint32
                self.norms = None
            else:
                self.matrix = matrix
                norms = np.linalg.norm(matrix, axis=1)
                norms[norms == 0] = 1.0
                self.norms = norms
        else:
            self.matrix = np.zeros((0, 0), dtype=np.float32)
            self.norms = np.zeros(0)
        self._ivf = self._build_ivf()
        self._device = {}  # residents: (name, device) -> (tensor, n)
        caches[embedder] = (
            self.generation,
            (
                self.docids,
                self.matrix,
                self.norms,
                self.quantized,
                self.dim,
                self._ivf,
                self._device,
            ),
        )

    def on_device_legs(self) -> bool:
        """Whether searches run the device legs over a resident matrix:
        the store is bound to a device, the matrix has at least
        DEVICE_MIN_ROWS rows and no IVF lists."""
        return (self.device is not None and self.matrix.shape[0] >= DEVICE_MIN_ROWS
                and self._ivf is None)

    # -- IVF --------------------------------------------------------------

    def _build_ivf(self):
        """K-means lists over the (float or sign-unpacked) vectors when the
        corpus is past the exact-scan budget. Returns (centroids (c, dim),
        order (n,), offsets (c+1,)) or None."""
        n = self.matrix.shape[0]
        if n < _ivf_threshold():
            return None
        feats = self._as_float(self.matrix)
        nlist = max(16, int(np.sqrt(n)))
        rng = np.random.default_rng(42)
        sample = feats[rng.choice(n, size=min(n, nlist * 32), replace=False)]
        centroids = sample[rng.choice(len(sample), size=nlist, replace=False)]
        assign = None
        for _ in range(4):  # Lloyd iterations on the sample
            sims = sample @ centroids.T
            assign = np.argmax(sims, axis=1)
            for c in range(nlist):
                members = sample[assign == c]
                if len(members):
                    centroids[c] = members.mean(axis=0)
        cn = np.linalg.norm(centroids, axis=1)
        cn[cn == 0] = 1.0
        centroids /= cn[:, None]
        # full assignment in chunks (n can be millions)
        full_assign = np.empty(n, dtype=np.int32)
        for s in range(0, n, 65536):
            chunk = feats[s : s + 65536]
            full_assign[s : s + 65536] = np.argmax(chunk @ centroids.T, axis=1)
        order = np.argsort(full_assign, kind="stable")
        counts = np.bincount(full_assign, minlength=nlist)
        offsets = np.zeros(nlist + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return centroids, order, offsets

    def _as_float(self, m: np.ndarray) -> np.ndarray:
        if not self.quantized:
            return m
        bits = np.unpackbits(
            m.view(np.uint8), axis=1, bitorder="little"
        )[:, : self.dim]
        return (bits.astype(np.float32) * 2.0 - 1.0) / np.sqrt(self.dim)

    def dimension(self) -> Optional[int]:
        return self.dim or None

    # -- scoring ------------------------------------------------------------

    def _cosine_rows(self, rows_idx, q: np.ndarray):
        """Cosine of the unit query against rows (None = all rows)."""
        on_device = (
            self.device is not None
            and rows_idx is None
            and self.matrix.shape[0] >= DEVICE_MIN_ROWS
        )
        m = self.matrix if rows_idx is None else self.matrix[rows_idx]
        if self.quantized:
            qbits = _pack_signs(q[None, :])[0]
            if on_device:
                with _counted():
                    ham = _device_hamming(self, qbits)
            else:
                ham = np.bitwise_count(m ^ qbits[None, :]).sum(axis=1)
            # sign vectors: dot = dim - 2h; ||a||=||b||=sqrt(dim)
            return (self.dim - 2.0 * ham.astype(np.float32)) / self.dim
        if on_device:
            with _counted():
                return _device_cosine(self, q)
        return (m @ q) / (self.norms if rows_idx is None else self.norms[rows_idx])

    def search(
        self, query: np.ndarray, k: int, universe: Optional[set] = None
    ) -> list[tuple[int, float]]:
        """Top-k by cosine similarity. Returns [(docid, similarity)] with
        similarity = (1+cos)/2 in [0,1] (the arroy cosine-distance
        complement, vector_sort.rs:86 `1.0 - distance`)."""
        return self.search_async(query, k, universe)()

    def search_async(
        self, query: np.ndarray, k: int, universe: Optional[set] = None
    ):
        """Dispatch the device-side similarity work NOW, return a closure
        that completes the search. The device work is queued on the
        current stream, so the hybrid path overlaps it with the host
        keyword search (the reference runs ANN then keyword serially,
        hybrid.rs:87-104). With no universe the device leg also selects
        the top-k on the device, so the readback is a few KB instead of
        the full (n,) similarity column."""
        if self.matrix.size == 0:
            return lambda: []
        q = np.asarray(query, dtype=np.float32)
        qn = np.linalg.norm(q)
        q = q / (qn if qn else 1.0)

        if universe is None and self.on_device_legs():
            with _counted():
                pending = _device_topk_dispatch(self, q, k)

            def finish():
                with _counted():
                    out = _device_topk_collect(self, pending, k)
                if out is not None:
                    return out
                # per-doc dedup exhausted the fetch bucket: the exact
                # answer needs the full column
                return self._search_sync(q, k, universe)

            return finish
        return lambda: self._search_sync(q, k, universe)

    def _search_sync(
        self, q: np.ndarray, k: int, universe
    ) -> list[tuple[int, float]]:
        """Full-column scoring path (IVF probes, filtered universes, tiny
        corpora, device-top-k dedup shortfall). `q` is unit-normalized."""

        rows_idx = None
        if self._ivf is not None:
            centroids, order, offsets = self._ivf
            nlist = len(offsets) - 1
            nprobe = max(1, int(os.environ.get("MEILI_TPU_IVF_NPROBE", "0"))
                         or max(8, nlist // 16))
            top_lists = np.argsort(-(centroids @ q))[:nprobe]
            rows_idx = np.concatenate(
                [order[offsets[c] : offsets[c + 1]] for c in top_lists]
            )
            if not len(rows_idx):
                return []

        cos = self._cosine_rows(rows_idx, q)
        sims = (1.0 + cos) / 2.0
        docids = self.docids if rows_idx is None else self.docids[rows_idx]

        if universe is not None:
            if not isinstance(universe, np.ndarray):
                universe = (
                    np.fromiter(universe, dtype=np.int64, count=len(universe))
                    if universe
                    else np.empty(0, dtype=np.int64)
                )
            if len(universe):
                keep = np.isin(docids, universe)
            else:
                keep = np.zeros(len(docids), dtype=bool)
            sims = np.where(keep, sims, -np.inf)

        # multiple vectors per doc: keep the best one
        order_ = np.argsort(-sims, kind="stable")
        out = []
        seen = set()
        for i in order_:
            if sims[i] == -np.inf:
                break
            docid = int(docids[i])
            if docid in seen:
                continue
            seen.add(docid)
            out.append((docid, float(np.clip(sims[i], 0.0, 1.0))))
            if len(out) >= k:
                break
        return out


@contextmanager
def _counted():
    """Count a raise of the device legs in serving_stats' device_errors."""
    from ..search.device_batch import _stats_add

    try:
        yield
    except Exception:
        _stats_add(device_errors=1)
        raise


def warm_vector_kernels(store: IndexStore) -> None:
    """Upload each embedder's matrix to the store's device OFF the serving
    path (and build the kernels: the first query would otherwise pay
    both), for every embedder whose searches take the device legs
    (`VectorSearcher.on_device_legs`). Raises when an upload or a leg
    fails, or when such an embedder's matrix is not resident after it in
    the state the next searcher of the same generation reads."""
    if store.device is None:
        return
    for name in store.settings.embedders or {}:
        s = VectorSearcher(store, name)
        if not s.on_device_legs():
            continue
        q = np.zeros(s.dim, np.float32)
        q[0] = 1.0
        s.search_async(q, 10)()
        generation, state = store._vector_searcher_cache[name]
        if generation == s.generation and ("matrix", s.device) not in state[-1]:
            raise RuntimeError(
                f"index `{store.uid}`: embedder `{name}`'s matrix is not resident on"
                f" {s.device} after its warm-up (generation {generation})"
            )


def _resident(searcher: VectorSearcher, name: str, host_array: np.ndarray, fill=0):
    """Device-resident copy of a per-generation array on the searcher's
    device, uploaded once and padded with `fill` rows to a pow2 bucket of
    at least DEVICE_MIN_ROWS rows, so every query of the generation sees
    one shape. Returns (tensor, n real rows). uint32 sign words go up as
    int32 (their bit pattern)."""
    key = (name, searcher.device)
    dev = searcher._device.get(key)
    if dev is None:
        with _RESIDENT_LOCK:
            dev = searcher._device.get(key)
            if dev is None:
                if host_array.dtype == np.uint32:
                    host_array = host_array.view(np.int32)
                host = torch.from_numpy(np.ascontiguousarray(host_array))
                n = host.shape[0]
                n_pad = max(DEVICE_MIN_ROWS, 1 << (n - 1).bit_length())
                buf = torch.full(
                    (n_pad,) + tuple(host.shape[1:]), fill,
                    dtype=host.dtype, device=searcher.device,
                )
                buf[:n].copy_(host)
                dev = (buf, n)
                searcher._device[key] = dev
    return dev


def _cos_column(searcher: VectorSearcher, m_dev, unit_query: np.ndarray):
    """The float leg over the resident padded matrix: (n_pad,) float32
    (M @ q) / norms, in full float32."""
    if m_dev.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the vector float leg needs full float32 matmuls:"
            " torch.backends.cuda.matmul.allow_tf32 is True"
        )
    n_dev, _ = _resident(searcher, "norms", searcher.norms, fill=1.0)
    q = torch.from_numpy(np.ascontiguousarray(unit_query, np.float32))
    FLOAT_LEGS.add()
    return torch.matmul(m_dev, _upload(q, m_dev.device)) / n_dev


def _upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A small host tensor on `device`. To a CUDA device it is copied from
    pinned memory without waiting for the stream: a blocking copy waits
    for all the work queued before it, so the dispatch would stall."""
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _query_words(query_bits: np.ndarray, device: torch.device) -> torch.Tensor:
    """The query's sign words on `device`, int32 (their bit pattern)."""
    q = torch.from_numpy(np.ascontiguousarray(query_bits).view(np.int32))
    return _upload(q, device)


def _device_cosine(searcher, unit_query):
    """The full similarity column (M @ q) / norms on the device, read back."""
    m_dev, n = _resident(searcher, "matrix", searcher.matrix)
    return _cos_column(searcher, m_dev, unit_query)[:n].cpu().numpy()


def _topk_desc(vals: torch.Tensor, kb: int):
    """`lax.top_k(vals, kb)` of a float32 vector: the kb largest values in
    descending order, equal values lower index first, +0.0 above -0.0 (a
    total order on the bits). `torch.topk` alone orders ties otherwise, so
    it selects on `topk_key`. Returns (values, index)."""
    return _topk_from_key(vals, topk_key(vals), kb)


def _topk_from_key(vals: torch.Tensor, key: torch.Tensor, kb: int):
    """The top-k of `vals` by its unique int64 `key` (`topk_key`, or K4h's
    keyed mode): the kb largest keys, the index decoded from each key's
    low word. Returns (values, index)."""
    idx = 0xFFFFFFFF - (torch.topk(key, kb, sorted=True).values & 0xFFFFFFFF)
    return vals[idx], idx


def _device_topk_dispatch(searcher, q: np.ndarray, k: int):
    """Queue the matmul/hamming + the on-device top-k over the resident
    matrix on the current stream. Returns (vals, idx, kb, n_live) device
    tensors. The fetch bucket kb is a pow2 >= 4k so per-doc dedup
    (multiple vectors per document) almost never falls back to the full
    column; padded and beyond-n rows are masked to -2 (< any cosine) so
    they sort past every real row."""
    m_dev, n = _resident(searcher, "matrix", searcher.matrix)
    n_pad = m_dev.shape[0]
    kb = 1 << (max(4 * k, 64) - 1).bit_length()
    if kb > n_pad:
        kb = n_pad
    if searcher.quantized:
        qw = _query_words(_pack_signs(q[None, :])[0], m_dev.device)
        cos, key = hamming_keyed(m_dev, qw, searcher.dim, n)
        vals, idx = _topk_from_key(cos, key, kb)
    else:
        cos = _cos_column(searcher, m_dev, q)
        cos[n:] = -2.0
        vals, idx = _topk_desc(cos, kb)
    return vals, idx, kb, n


def _device_topk_collect(searcher, pending, k):
    """Read back the dispatched top-k, dedup to per-document hits. None =
    the kb bucket ran out before k distinct documents while live rows
    remained (caller re-runs the full column)."""
    vals_d, idx_d, kb, n = pending
    vals = vals_d.cpu().numpy()
    idx = idx_d.cpu().numpy()
    out: list[tuple[int, float]] = []
    seen: set = set()
    consumed = 0
    for v, i in zip(vals, idx):
        if v <= -1.5:  # masked pad row: every later entry is one too
            consumed = n  # all live rows were ranked before the pads
            break
        consumed += 1
        docid = int(searcher.docids[i])
        if docid in seen:
            continue
        seen.add(docid)
        out.append((docid, float(np.clip((1.0 + v) / 2.0, 0.0, 1.0))))
        if len(out) >= k:
            return out
    if consumed >= n:
        return out
    return None


def _device_hamming(searcher, query_bits):
    """XOR + popcount (K4h) over the live rows of the resident packed sign
    matrix, read back."""
    m_dev, n = _resident(searcher, "matrix", searcher.matrix)
    return hamming_rows(m_dev[:n], _query_words(query_bits, m_dev.device)).cpu().numpy()
