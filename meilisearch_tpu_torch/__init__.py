"""meilisearch_tpu_torch — the PyTorch/CUDA port of meilisearch_tpu.

A search engine with Meilisearch's HTTP API and ranking semantics, whose
device path runs on an NVIDIA H100 through torch and hand-written CUDA
kernels. The package stands alone: it imports `torch`, never `jax`, and
nothing of the JAX package (`meilisearch_tpu`), which stays the reference
it is tested against. Its sub-packages mirror the reference's layout:

  api      — HTTP routes, server, /multi-search federation
  engine   — task queue, scheduler, index registry, search batcher
  types    — settings, tasks, error DTOs
  index    — the store, postings, packed snapshots, the device plane pool
  search   — query terms (typo pass), graph, scorer, filters, facets, the
             batched device search (search/device_batch.py)
  vector   — embedders and vector search (host legs)
  ops      — the kernels and their plain torch versions: K1 chain keys
             (csrc/chain_keys.cu), K3 whole-vocabulary OSA (csrc/osa.cu),
             the selection tail (arena_scorer.py), the host OSA pass
             (levenshtein.py), the nvcc build (_build.py)
"""

__version__ = "0.1.0"


def _tune_malloc() -> None:
    """Keep large heap blocks pooled instead of mmap'd per allocation.

    On lazily-backed VM memory (Firecracker and friends), every fresh
    mmap'd page faults in at single-digit MB/s while rewrites of touched
    pages run at GB/s — measured here: a 200 MB numpy copy costs 24 s on
    first-touch pages vs 0.15 s into reused ones. glibc malloc mmaps (and
    munmaps!) every block over 128 KB, so each large numpy temporary pays
    first-touch again. Raising the mmap/trim thresholds turns those into
    heap reuse. No-op on non-glibc platforms."""
    import ctypes

    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:
        pass


_tune_malloc()
