"""Vector store: exact nearest-neighbor search + IVF at scale (host legs).

Reference behavior: milli/src/vector/store.rs — arroy (random-projection
trees) / hannoy (HNSW, M=16/M0=32/efC=125) ANN over LMDB, with a
linear-scan fallback below 300k items or <10% filter ratio (store.rs:22-27).

Design:
  * an exact dot-product top-k over a per-(embedder, index generation)
    matrix, recall 1.0. The device legs of the JAX package (the resident
    matrix, the device matmul / hamming top-k: K4) are a later slice of
    the port; every search here runs the numpy pass, as the JAX package
    does with no accelerator.
  * binaryQuantized stores SIGN BITS packed 32/word (32x smaller than the
    f32 matrix; the reference's BQ exists for exactly this memory cut,
    store.rs hamming path). Scoring is hamming via XOR+popcount:
    for sign vectors dot = dim - 2*hamming, so the returned similarity
    (1+cos)/2 equals the exact cosine of the quantized vectors.
  * IVF partitioning above MEILI_TPU_IVF_THRESHOLD vectors (default 1M):
    k-means centroids (nlist ~ sqrt(n)), lists contiguous in a reordered
    matrix; a query scans the nprobe nearest lists exactly. Same API,
    recall reported by tests against the exact path.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..index.store import IndexStore

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


class VectorSearcher:
    """Per-(index, embedder) exact/IVF search."""

    def __init__(self, store: IndexStore, embedder: str):
        self.store = store
        self.embedder = embedder
        # cached on the store itself (an id(store)-keyed global dict would
        # serve stale matrices when a freed store's id is reused)
        caches = getattr(store, "_vector_searcher_cache", None)
        if caches is None:
            caches = {}
            store._vector_searcher_cache = caches
        cached = caches.get(embedder)
        if cached and cached[0] == store.generation:
            (
                self.docids,
                self.matrix,
                self.norms,
                self.quantized,
                self.dim,
                self._ivf,
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
        caches[embedder] = (
            store.generation,
            (
                self.docids,
                self.matrix,
                self.norms,
                self.quantized,
                self.dim,
                self._ivf,
            ),
        )

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
        m = self.matrix if rows_idx is None else self.matrix[rows_idx]
        if self.quantized:
            qbits = _pack_signs(q[None, :])[0]
            ham = np.bitwise_count(m ^ qbits[None, :]).sum(axis=1)
            # sign vectors: dot = dim - 2h; ||a||=||b||=sqrt(dim)
            return (self.dim - 2.0 * ham.astype(np.float32)) / self.dim
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
        """A closure that completes the search: the hybrid path calls it
        after its keyword search (the device leg that overlapped the two is
        a later slice)."""
        if self.matrix.size == 0:
            return lambda: []
        q = np.asarray(query, dtype=np.float32)
        qn = np.linalg.norm(q)
        q = q / (qn if qn else 1.0)
        return lambda: self._search_sync(q, k, universe)

    def _search_sync(
        self, q: np.ndarray, k: int, universe
    ) -> list[tuple[int, float]]:
        """Full-column scoring (IVF probes, filtered universes). `q` is
        unit-normalized."""

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
