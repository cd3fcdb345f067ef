#!/usr/bin/env python3
"""Where a device drain of the port spends its time, on one GPU.

    python3 tools/profile_drain.py [--docs N] [--drains K]

Run from the root of the repository on a machine with a CUDA device. It
boots the port's App, ingests N synthetic hackernews documents as
`chip_smoke.py` does (default 1,000,000), registers the planes with one
forced drain, then runs 32-query drains of `chip_smoke.QUERIES` forced
onto the device (`perform_search_many(force_device=True)`), three times
K drains:
  1. untraced: the wall of each drain;
  2. under torch.profiler: the device time of each kernel and copy, and
     the device's busy share of the untraced median drain wall;
  3. under cProfile: the host functions by cumulative time (cProfile
     inflates host time; read the shares, not the totals).
This is a one-drain breakdown, not a serving-loop measurement: the
batcher, its hold and the client threads are not in it.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

BATCH = 32


def _device_us(avg) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(avg, attr):
            return float(getattr(avg, attr))
    return 0.0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--docs", type=int, default=1_000_000)
    parser.add_argument("--drains", type=int, default=5)
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_drain: no CUDA device", file=sys.stderr)
        return 2
    from meilisearch_tpu_torch._hooks import block_jax

    block_jax()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from meilisearch_tpu_torch.api.app import App, TestClient
    from meilisearch_tpu_torch.search.device_batch import warm_kernels
    from meilisearch_tpu_torch.search.perform import perform_search_many

    device = torch.device("cuda", 0)
    chip_smoke.say(chip_smoke.card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    app = App(device=device)
    try:
        store = chip_smoke.ingest(app, TestClient(app), opts.docs)
        if not warm_kernels(store, device, wait=True):
            raise AssertionError("the bucket's kernels did not warm")
        queries = [chip_smoke.QUERIES[i % len(chip_smoke.QUERIES)] for i in range(BATCH)]

        def drain():
            perform_search_many(
                store, [dict(q) for q in queries], device=device, force_device=True
            )
            torch.cuda.synchronize()

        drain()  # plane registration
        walls = []
        for _ in range(opts.drains):
            t0 = time.perf_counter()
            drain()
            walls.append(time.perf_counter() - t0)
        wall_med = statistics.median(walls)
        print(f"untraced drain walls (ms): {[round(w * 1e3, 3) for w in walls]},"
              f" median {wall_med * 1e3:.3f}")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(opts.drains):
                drain()
            traced = time.perf_counter() - t0
        avgs = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
        device_us = sum(_device_us(a) for a in avgs)
        per_drain_ms = device_us / 1e3 / opts.drains
        print(f"traced: {opts.drains} drains in {traced * 1e3:.3f} ms;"
              f" device time {device_us / 1e3:.3f} ms in all,"
              f" {per_drain_ms:.3f} ms per drain;"
              f" busy share of the untraced median drain"
              f" {per_drain_ms / (wall_med * 1e3):.4f}")
        for a in sorted(avgs, key=_device_us, reverse=True)[:12]:
            print(f"  {_device_us(a) / 1e3:9.3f} ms  {100 * _device_us(a) / device_us:5.1f}%"
                  f"  x{a.count:<4d} {a.key[:90]}")

        cprof = cProfile.Profile()
        cprof.enable()
        for _ in range(opts.drains):
            drain()
        cprof.disable()
        text = io.StringIO()
        pstats.Stats(cprof, stream=text).sort_stats("cumulative").print_stats(30)
        print(f"host functions over {opts.drains} drains (cProfile):")
        print(text.getvalue())
    finally:
        app.search_batcher.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
