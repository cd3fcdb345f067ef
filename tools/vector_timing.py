#!/usr/bin/env python3
"""The vector legs' timing of `chip_smoke.py`, without its serving phases.

    python3 tools/vector_timing.py

Run from the root of the repository on a machine with a CUDA device. It
fills two stores of hn150k-bge768's shape (150,000 documents of 768
dimensions, every 7th with two vectors: 171,429 rows, 2^18 on the card)
with seeded normal vectors, one float and one binary-quantized, writing
`store.vectors` directly (no HTTP ingest, a minute less), uploads both
matrices through a search, and runs `chip_smoke.vector_timing` on them:
K4h per launch cold and warm with its plain version and bound, the float
leg's device work and its `torch.matmul`, both legs' kernels, and both
`search_async` calls beside their numpy host passes. It ends with K1 per
launch, cold and warm (`chip_smoke.repeated_launch_ms`, D = 2^20, B = 32,
T = 3).
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("vector_timing: no CUDA device", file=sys.stderr)
        return 2
    from meilisearch_tpu_torch._hooks import block_jax

    block_jax()
    from meilisearch_tpu_torch.index.store import IndexStore
    from meilisearch_tpu_torch.ops import _build
    from meilisearch_tpu_torch.ops.chain_keys import chain_keys
    from meilisearch_tpu_torch.ops.synthetic import kernel_args, scorer_inputs
    from meilisearch_tpu_torch.vector.store import VectorSearcher

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    card = chip_smoke.card_line()
    chip_smoke.say(card)
    rng = np.random.default_rng(0)
    legs = {}
    for quantized in (False, True):
        store = IndexStore("vec", primary_key="id")
        conf = {"source": "userProvided", "dimensions": chip_smoke.VEC_DIM}
        if quantized:
            conf["binaryQuantized"] = True
        store.settings.apply_json({"embedders": {"default": conf}})
        store.vectors["default"] = {
            i: rng.standard_normal((2 if i % 7 == 0 else 1, chip_smoke.VEC_DIM), dtype=np.float32)
            for i in range(chip_smoke.VEC_DOCS)
        }
        store.device = dev
        searcher = VectorSearcher(store, "default")
        searcher.search(np.ones(chip_smoke.VEC_DIM, np.float32), 10)  # uploads
        legs["binary" if quantized else "float"] = searcher
    q = rng.standard_normal(chip_smoke.VEC_DIM).astype(np.float32)
    legs["query"] = q / np.linalg.norm(q)
    chip_smoke.say(f"K4h line: {chip_smoke.vector_timing(card, legs)}")
    args = kernel_args(scorer_inputs(3, 1 << 20, 32, seed=7), dev)
    k1 = chip_smoke.repeated_launch_ms(chip_smoke.K1_KERNEL, lambda: chain_keys(*args, T=3), dev)
    chip_smoke.say(f"K1 per launch D=2^20 B=32 T=3 on {card}: {k1}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
