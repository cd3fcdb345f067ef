#!/usr/bin/env python3
"""K4h and the binary leg of several checkouts of this repository, timed
on one card by chip_smoke.py's timers.

    python3 tools/k4h_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (for example a `git archive` of a
commit). In the order given (for an A/B: parent, change, change, parent)
one process per TREE puts that tree's `meilisearch_tpu_torch` first on
the path and makes the same inputs: hn150k-bge768's resident sign words
(171,429 rows drawn as chip_smoke.py draws that corpus's vectors, around
512 seeded centres, packed to W = 24 words and padded to 2^18 rows by the
tree's `vector/store.py::_resident`) and one seeded 768-dimension query.
For that tree it gives:
  - K4h mode ham (`ops.hamming.hamming_rows` on the padded matrix), equal
    to the tree's plain version, per launch cold (the L2 cache flushed
    before each) and warm by this checkout's `chip_smoke.repeated_launch_ms`;
  - K4h mode keyed (`hamming_keyed`, the first n_live rows live), equal
    to `hamming_keyed_torch`, timed the same way, where the tree has it;
  - the binary leg, the tree's `vector.store._device_topk_dispatch` at
    k = 30: its kernels' device time and launches per call
    (`chip_smoke.leg_breakdown`) and its time per call by CUDA events
    (`chip_smoke._median_ms`, median of 50);
  - a yardstick that reads the same bytes: torch's `amax` over the padded
    matrix, per launch cold and warm (it computes another function; no
    PyTorch call computes K4h's).
It prints the card's name and power limit, one JSON line per run, and a
last JSON line with all runs and each mode's bound (`chip_smoke.k4h_bound_ms`).
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

CHIP_SMOKE = Path(__file__).resolve().parent.parent / "chip_smoke.py"
N_LIVE = 150_000 + (150_000 + 6) // 7  # hn150k-bge768's rows: every 7th document two
K = 30  # offset + limit of chip_smoke.py's paged vector requests
CHUNK = 1 << 14  # rows drawn at a time


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Searcher:
    """What `_device_topk_dispatch` reads of a binary-quantized searcher."""

    def __init__(self, packed, dim, device):
        self.matrix, self.dim, self.quantized = packed, dim, True
        self.device, self._device = device, {}


def _inputs(timer, pack_signs):
    """The sign words of N_LIVE seeded vectors around VEC_CENTRES centres
    (noise 0.5 a dimension) and one unit query near a stored vector."""
    import numpy as np

    rng = np.random.default_rng(timer.VEC_SEED)
    centres = rng.standard_normal((timer.VEC_CENTRES, timer.VEC_DIM), dtype=np.float32)
    packed = []
    for start in range(0, N_LIVE, CHUNK):
        rows = centres[rng.integers(0, timer.VEC_CENTRES, min(CHUNK, N_LIVE - start))]
        packed.append(pack_signs(rows + 0.5 * rng.standard_normal(rows.shape, dtype=np.float32)))
    q = centres[7] + 0.5 * rng.standard_normal(timer.VEC_DIM, dtype=np.float32)
    return np.concatenate(packed), q / np.linalg.norm(q)


def _launches(timer, call, plain, dev) -> dict:
    """`call` must equal `plain` bit for bit; then its kernel per launch,
    cold and warm."""
    import torch

    got = call()
    torch.cuda.synchronize()
    timer.k4h_err(got, plain(), "the A/B's inputs")
    return timer.repeated_launch_ms(timer.K4H_KERNEL, call, dev)


def measure(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from meilisearch_tpu_torch._hooks import block_jax

    block_jax()
    from meilisearch_tpu_torch.ops import _build, hamming
    from meilisearch_tpu_torch.vector import store as vs

    if not Path(hamming.__file__).resolve().is_relative_to(Path(tree).resolve()):
        raise RuntimeError(f"imported {hamming.__file__}, not the tree {tree}")
    timer = _chip_smoke()
    dev = torch.device("cuda", 0)
    _build.load_library()
    packed, q = _inputs(timer, vs._pack_signs)
    searcher = _Searcher(packed, timer.VEC_DIM, dev)
    m_dev, n = vs._resident(searcher, "matrix", packed)
    qd = torch.from_numpy(vs._pack_signs(q[None, :])[0].view(np.int32)).to(dev)
    out = {"tree": tree, "n_pad": m_dev.shape[0], "n_live": n, "w": m_dev.shape[1]}
    out["ham"] = _launches(timer, lambda: hamming.hamming_rows(m_dev, qd),
                           lambda: hamming.hamming_rows_torch(m_dev, qd), dev)
    if hasattr(hamming, "hamming_keyed"):  # trees before the keyed mode lack it
        dim = timer.VEC_DIM
        out["keyed"] = _launches(timer, lambda: hamming.hamming_keyed(m_dev, qd, dim, n),
                                 lambda: hamming.hamming_keyed_torch(m_dev, qd, dim, n), dev)
    else:
        out["keyed"] = None

    def leg():
        return vs._device_topk_dispatch(searcher, q, K)

    out["amax"] = timer.repeated_launch_ms("reduce_kernel", m_dev.amax, dev)
    device_ms, launches = timer.leg_breakdown("the binary leg", leg, dev)
    out["leg"] = {"device_ms": device_ms, "launches": launches,
                  "events_ms": timer._median_ms(leg, reps=50)}
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
    n_pad, w, n_live = runs[0]["n_pad"], runs[0]["w"], runs[0]["n_live"]
    bounds = {"ham": timer.k4h_bound_ms(n_pad, w), "keyed": timer.k4h_bound_ms(n_pad, w, n_live)}
    print(json.dumps({"card": card, "bounds": bounds, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
