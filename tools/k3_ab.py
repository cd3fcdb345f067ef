#!/usr/bin/env python3
"""K3 of several checkouts of this repository, timed on one card by
chip_smoke.py's timer.

    python3 tools/k3_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (for example a `git archive` of a
commit). In the order given (for an A/B: parent, change, change, parent)
one process per TREE puts that tree's `meilisearch_tpu_torch` first on
the path, packs the typo path's vocabulary
(utils/synthetic.py::generate_large_vocab at 2^20 words, sorted as the
store sorts its base vocabulary) and, for every query word and
adjacent-word pair of the typo queries of 5 letters or more (the terms
that get a typo budget), at max_dist 2, calls the tree's
`ops.device_osa.osa_distances_device`, the typo pass's own entry point:
  - its answer must equal the tree's plain version on the rows it uploaded;
  - K3 is timed per launch by this checkout's `chip_smoke.launch_ms`,
    10 calls cold (the L2 cache flushed before each) and 10 warm.
It prints the card's name and power limit, one JSON line per run with the
means over the words, and a last JSON line with all runs.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

VOCAB_WORDS = 1 << 20
MIN_TYPO_LEN = 5
CHIP_SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Store:
    """What `osa_distances_device` needs of an index store (trees before
    the vector slice name the attribute `osa_device`)."""

    def __init__(self, device):
        self.device = self.osa_device = device


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from meilisearch_tpu_torch._hooks import block_jax

    block_jax()
    from meilisearch_tpu_torch.ops import _build
    from meilisearch_tpu_torch.ops import device_osa as osa
    from meilisearch_tpu_torch.ops.levenshtein import MAX_LEN, pack_words
    from meilisearch_tpu_torch.utils.synthetic import generate_large_vocab

    if not Path(osa.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {osa.__file__}, not the tree {tree}")
    timer = _chip_smoke()
    store = _Store(torch.device("cuda", 0))
    _build.load_library()
    vocab, _docs, queries = generate_large_vocab(VOCAB_WORDS)
    del _docs
    mat, lens = pack_words(sorted(set(vocab)))
    words = set()
    for q in queries:
        parts = q["q"].split()
        words.update(parts)
        words.update(a + b for a, b in zip(parts, parts[1:]))
    words = sorted(w for w in words if len(w) >= MIN_TYPO_LEN)

    runs = []
    for word in words:
        full, prefix = osa.osa_distances_device(store, mat, lens, word)
        dv = store._device_vocab[1]
        q = torch.zeros(MAX_LEN, dtype=torch.int32)
        cps = [ord(c) for c in word[:MAX_LEN]]
        q[: len(cps)] = torch.tensor(cps, dtype=torch.int32)
        want = osa.osa_device_torch(dv.mat, dv.lens, q.to(dv.device), len(cps), 2)
        for got, w in zip((full, prefix), want):
            if not np.array_equal(got, w[: dv.n_real].cpu().numpy()):
                raise AssertionError(f"K3 disagrees with its plain version on {word!r}")

        def call(word=word):
            osa.osa_distances_device(store, mat, lens, word)

        runs += [(call, 10, True), (call, 10, False)]
    traced = timer.launch_ms(timer.K3_KERNEL, runs, store.device)
    rows = [{"word": w, "m": len(w), "cold_ms": statistics.median(traced[2 * k]),
             "warm_ms": statistics.median(traced[2 * k + 1])} for k, w in enumerate(words)]
    return {
        "tree": tree, "words": len(rows),
        "cold_ms": statistics.fmean(r["cold_ms"] for r in rows),
        "warm_ms": statistics.fmean(r["warm_ms"] for r in rows),
        "rows": rows,
    }


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = _chip_smoke().card_line()
    print(card, flush=True)
    runs = []
    for tree in sys.argv[1:]:
        out = subprocess.run(
            [sys.executable, __file__, "--measure", tree],
            capture_output=True, text=True, timeout=900,
        )
        if out.returncode != 0:
            print(out.stdout[-2000:] + out.stderr[-4000:], file=sys.stderr)
            return 1
        run = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({k: v for k, v in run.items() if k != "rows"}), flush=True)
        runs.append(run)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
