"""meilisearch_tpu_torch — the PyTorch/CUDA port of meilisearch_tpu.

The JAX package (`meilisearch_tpu`) stays the reference. This package
serves the keyword-search device path on an NVIDIA H100 and shares every
host module of the reference by import; it imports `torch` and never
`jax`.

Layer map (port-owned modules only; the rest is `meilisearch_tpu`):
  api/app.py, api/server.py    — App + server entry with the port batcher
  engine/batcher.py            — drains into the port's perform_search_many
  search/perform.py            — perform_search_many on the port search_many
  search/device_batch.py       — device half of keyword search
  index/device_arena.py        — the plane pool as a torch tensor
  ops/arena_scorer.py          — planes_chain_topk (K1 + torch selection)
  ops/chain_keys.py + csrc/    — K1, the hand-written chain-DP kernel
  ops/arena_host.py            — jax-free copies of the host merge helpers
  _hooks.py                    — routes shared host code away from jax
"""

__version__ = "0.1.0"
