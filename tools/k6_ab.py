#!/usr/bin/env python3
"""K6 and chain_query_topk of several checkouts of this repository, timed
on one card by chip_smoke.py's timers.

    python3 tools/k6_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (for example a `git archive` of a
commit). In the order given (for an A/B: parent, change, change, parent)
one process per TREE puts that tree's `meilisearch_tpu_torch` first on
the path and makes the same inputs: `chip_smoke.py::dp_inputs` at T = 4
and N = 355,439 (the candidates of the executor's broadest query), seed
700. For that tree it gives:
  - K6 per launch, cold (the L2 cache flushed before each) and warm, by
    this checkout's `chip_smoke.repeated_launch_ms`, in every mode the
    tree has, each first held equal to the tree's plain version: on the
    unpadded (T, 3, N) layout, and where the tree's wrappers take `n`,
    on the callers' padded layout too (the bulk path);
  - the whole `chain_query_topk` at k = 10 by CUDA events
    (`chip_smoke._median_ms`, median of 50): kernel and sort together.
It prints the card's name and power limit, one JSON line per run, and a
last JSON line with all runs and each mode's bound (`chip_smoke.k6_bound_ms`).
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

CHIP_SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"
T, SEED = 4, 700


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _launches(timer, call, plain, dev) -> dict:
    """`call` must equal `plain` bit for bit; then its kernel per launch,
    cold and warm."""
    import torch

    got, want = call(), plain()
    torch.cuda.synchronize()
    got, want = (list(x) if isinstance(x, tuple) else [x] for x in (got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("K6 differs from its plain version on the A/B's inputs")
    return timer.repeated_launch_ms(timer.K6_KERNEL, call, dev)


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from meilisearch_tpu_torch._hooks import block_jax

    block_jax()
    from meilisearch_tpu_torch.ops import _build
    from meilisearch_tpu_torch.ops import device_scorer as ds

    if not Path(ds.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {ds.__file__}, not the tree {tree}")
    timer = _chip_smoke()
    dev = torch.device("cuda", 0)
    _build.load_library()
    n, k = timer.K6_BROAD_N, timer.K6_TOPK
    flat, flat_cost = timer.dp_inputs(T, n, SEED, dev)
    runs = {
        "cost": (lambda: ds.chain_cost_matrix(*flat[:4], flat_cost),
                 lambda: ds.chain_cost_matrix_torch(*flat[:4], flat_cost)),
        "keys": (lambda: ds.chain_query_keys(*flat), lambda: ds.chain_query_keys_torch(*flat)),
    }
    calls = {"chain_query_topk": lambda: ds.chain_query_topk(*flat, k=k)}
    if hasattr(ds, "aligned_width"):  # trees whose wrappers take the padded layout
        wide, wide_cost = timer.dp_inputs(T, n, SEED, dev, ds.aligned_width(n))
        runs.update({
            "cost padded": (lambda: ds.chain_cost_matrix(*wide[:4], wide_cost, n=n),
                            runs["cost"][1]),
            "keys padded": (lambda: ds.chain_query_keys(*wide, n=n), runs["keys"][1]),
            "topk padded": (lambda: ds.chain_query_topk(*wide, k=k, n=n),
                            lambda: ds.chain_query_topk_torch(*flat, k=k)),
        })
        calls["chain_query_topk padded"] = lambda: ds.chain_query_topk(*wide, k=k, n=n)
    out = {"tree": tree, "n": n, "k": k}
    for label, (call, plain) in runs.items():
        out[label] = _launches(timer, call, plain, dev)
        out[label]["path"] = getattr(ds, "LAST_PATH", {}).get("path")
    want = ds.chain_query_topk_torch(*flat, k=k)
    for label, call in calls.items():
        if not all(torch.equal(g, w) for g, w in zip(call(), want)):
            raise AssertionError(f"{label} differs from its plain version")
        out[label] = {"events_ms": timer._median_ms(call, reps=50)}
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    timer = _chip_smoke()
    card = timer.card_line()
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
        lines = out.stdout.strip().splitlines()
        print("\n".join(lines[:-1]), flush=True)
        run = json.loads(lines[-1])
        print(json.dumps(run), flush=True)
        runs.append(run)
    n = timer.K6_BROAD_N
    bounds = {mode: timer.k6_bound_ms(T, n, mode) for mode in ("cost", "keys", "topk")}
    print(json.dumps({"card": card, "bounds": bounds, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
