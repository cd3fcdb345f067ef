#!/usr/bin/env python3
"""The ASCII table of the port's `Precompiled` normalizer against its
grapheme walk, on the host, over hn50k-me5base-hf's texts.

    python3 tools/precompiled_ab.py [--docs N]

`models/unigram.py::Precompiled.__call__` sends a text of ASCII without CR
through one `str.translate` table and every other text through
`Precompiled.walk`, the grapheme-by-grapheme lookup. This script builds
chip_smoke.py's XLM-R character map (`e5_charsmap`), renders the first N
(default 50,000, all of them) of that phase's synthetic hackernews
documents with Meilisearch's default documentTemplate, as the embedder
does at indexing, adds the phase's multilingual check texts, and times,
each after a warm pass over the first 1,000 texts:
  - `Precompiled(text)` (the table where it applies, else the walk);
  - `Precompiled.walk(text)` on every text;
and checks that both give the same strings. It prints the card's name and
power limit (the host it ran beside) and one JSON line with the seconds
of each pass, the texts that took the table, and whether they agree.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

CHIP_SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"
sys.path.insert(0, str(CHIP_SMOKE.parent))
WARM = 1_000


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    smoke = _chip_smoke()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--docs", type=int, default=smoke.E5_DOCS)
    opts = parser.parse_args()

    from meilisearch_tpu_torch.models.unigram import Precompiled
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    print(smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    blob = smoke.e5_charsmap()
    build_s = time.perf_counter() - t0
    searchable = set(smoke.VEC_SETTINGS["searchableAttributes"])
    docs = generate_hackernews_like(opts.docs, seed=smoke.E5_SEED)
    texts = [render_document_template(None, d, searchable) for d in docs]
    texts += smoke.E5_CHECK_TEXT

    norm = Precompiled(blob)
    out = {"texts": len(texts), "charsmap_bytes": len(blob), "charsmap_build_s": build_s,
           "table_texts": sum(t.isascii() and "\r" not in t for t in texts)}
    results = {}
    for name, fn in (("call", norm), ("walk", norm.walk)):
        for t in texts[:WARM]:
            fn(t)
        t0 = time.perf_counter()
        results[name] = [fn(t) for t in texts]
        out[f"{name}_s"] = time.perf_counter() - t0
    out["equal"] = results["call"] == results["walk"]
    print(json.dumps(out), flush=True)
    return 0 if out["equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
