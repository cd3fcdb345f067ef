#!/usr/bin/env python3
"""The WordPiece tokenizer of several checkouts, in turns, on phase 7's texts.

    python3 tools/wordpiece_ab.py TREE [TREE ...] [--docs N] [--passes P]

Each TREE is the root of a checkout (a `git archive` unpacked anywhere).
For each tree in the order given, a fresh process imports that tree's
`meilisearch_tpu_torch.models.wordpiece`, builds chip_smoke.py's
bge-base vocabulary (`bge_vocab`, taken from this checkout), renders the
first N (default 20,000) of phase 7's synthetic hackernews documents with
Meilisearch's default documentTemplate, as the embedder does at
indexing, and tokenizes them in chunks of 256 texts P times (default 3;
the first pass fills the word cache). It prints one JSON line per tree
with each pass's seconds on the host clock and a digest of the ids, which
must be equal across trees. Run the parent and the change as P C C P.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def run_one(tree: str, docs: int, passes: int) -> dict:
    sys.path.insert(0, tree)
    import importlib.util

    import meilisearch_tpu_torch
    from meilisearch_tpu_torch.models.wordpiece import WordPiece
    from meilisearch_tpu_torch.utils.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.vector.templates import render_document_template

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    searchable = set(chip_smoke.VEC_SETTINGS["searchableAttributes"])
    texts = [render_document_template(None, d, searchable)
             for d in generate_hackernews_like(docs, seed=chip_smoke.ENC_SEED)]
    wp = WordPiece(chip_smoke.bge_vocab())
    seconds, digest = [], hashlib.sha256()
    for p in range(passes):
        t = time.perf_counter()
        for i in range(0, len(texts), 256):
            ids, _mask = wp(texts[i:i + 256], 512)
            if p == 0:
                digest.update(ids.numpy().tobytes())
        seconds.append(time.perf_counter() - t)
    return {"tree": tree, "package": meilisearch_tpu_torch.__file__, "texts": len(texts),
            "seconds": seconds, "ids_sha256": digest.hexdigest()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="*")
    parser.add_argument("--docs", type=int, default=20_000)
    parser.add_argument("--passes", type=int, default=3)
    parser.add_argument("--one", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if opts.one:
        print(json.dumps(run_one(opts.one, opts.docs, opts.passes)), flush=True)
        return 0
    digests = set()
    for tree in opts.trees:
        out = subprocess.run([sys.executable, __file__, "--one", str(Path(tree).resolve()),
                              "--docs", str(opts.docs), "--passes", str(opts.passes)],
                             check=True, capture_output=True, text=True).stdout
        print(out.strip(), flush=True)
        digests.add(json.loads(out)["ids_sha256"])
    if len(digests) > 1:
        print("the trees' ids differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
