#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (meilisearch_tpu_torch) on one GPU.

    python3 chip_smoke.py [--docs N]

Run from the root of the repository, on a machine with a CUDA device.
Phases, each fatal on failure:
  1. build K1 (csrc/chain_keys.cu) with nvcc;
  2. kernel: K1 against its plain torch version on the card, bit for bit,
     for every T of the ladder at D = 2^14 and 2^20, B = 32;
  3. main path: the port's App ingests N synthetic hackernews documents
     (default 1,000,000, so D = 2^20) over POST /indexes/hn/documents,
     then 32 client threads send a fixed query set to
     POST /indexes/hn/search; every response must equal the host scorer
     (the reference's, shared by the port; it needs no jax), K1 must have
     launched, and the device path must have served with no device error;
  4. timing: K1 and its plain version at D = 2^20, B = 32, T = 3.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time

K1_SOURCE = "meilisearch_tpu_torch/csrc/chain_keys.cu"
K1_REPLACES = "meilisearch_tpu/ops/pallas_scorer.py:256"
THREADS = 32
SETTINGS = {
    "searchableAttributes": ["title", "url", "author"],
    "filterableAttributes": ["author", "points", "num_comments"],
    "sortableAttributes": ["points", "created_at"],
}
QUERIES = [
    {"q": "rust"},  # one word
    {"q": "machine learning", "limit": 20},  # multi-word
    {"q": "open source database"},
    {"q": "deep neural network training"},
    {"q": "searhc engine"},  # typo
    {"q": "kubernets"},  # typo
    {"q": "performance benchark memory"},  # typo in a chain
    {"q": '"machine learning" model'},  # phrase
    {"q": "rust", "filter": "points > 1000"},  # filter
    {"q": "python web", "filter": "num_comments < 100", "limit": 30},
    {"q": "ai", "facets": ["author"]},  # facets
    {"q": "cloud", "facets": ["points"], "filter": "points > 2500"},
    {"q": "database", "sort": ["points:desc"]},  # sort
    {"q": "google", "sort": ["created_at:asc"], "limit": 15},
    {"q": "distributed systems", "matchingStrategy": "all"},
    {"q": "security privacy encryption", "matchingStrategy": "all"},
    {"q": "quantum research paper", "showRankingScore": True},
    {"q": "show tell", "showRankingScore": True, "offset": 5, "limit": 10},
]
COMPARED = ("estimatedTotalHits", "facetDistribution")


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def build_phase() -> None:
    from meilisearch_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    say(f"K1 build: {time.perf_counter() - t0:.3f} s"
        f" (nvcc {_build.build_seconds:.3f} s; 0 = already built)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")


def kernel_phase(device) -> int:
    """K1 against chain_keys_torch on the card; returns the max abs error
    (0 when bit-exact; anything else raises)."""
    import torch

    from meilisearch_tpu_torch.ops.chain_keys import chain_keys, chain_keys_torch
    from meilisearch_tpu_torch.ops.synthetic import kernel_args, scorer_inputs
    from meilisearch_tpu_torch.search.device_batch import T_LADDER

    worst = 0
    for D in (1 << 14, 1 << 20):
        for T in T_LADDER:
            args = kernel_args(scorer_inputs(T, D, 32, seed=1000 + T), device)
            got = chain_keys(*args, T=T)
            torch.cuda.synchronize()
            want = chain_keys_torch(*args, T=T)
            torch.cuda.synchronize()
            err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            say(f"kernel D={D} B=32 T={T}: keys/candw/counts bit-exact={same}"
                f" max_abs_err={err} candidates={int(got[2].sum())}")
            if not same:
                raise AssertionError(f"K1 disagrees with chain_keys_torch at D={D} T={T}")
            worst = max(worst, err)
    return worst


def _strip(res: dict) -> dict:
    hits = res["hits"]
    out = {
        "ids": [h["id"] for h in hits],
        "scores": [h.get("_rankingScore") for h in hits],
    }
    for key in COMPARED:
        out[key] = res.get(key)
    return out


def ingest(app, client, n_docs: int):
    """Index `n_docs` synthetic hackernews documents as "hn" over
    POST /indexes/hn/documents; returns the index's store."""
    from meilisearch_tpu_torch.ops.synthetic import generate_hackernews_like
    from meilisearch_tpu_torch.search.device_batch import _plane_docs

    client.update_settings("hn", SETTINGS)
    t0 = time.perf_counter()
    docs = generate_hackernews_like(n_docs)
    say(f"corpus: {n_docs} docs generated in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    uid = None
    for i in range(0, n_docs, 100_000):
        res = client.post("/indexes/hn/documents", body=docs[i : i + 100_000])
        if res.status != 202:
            raise AssertionError(f"ingest refused: {res.status} {res.json}")
        uid = res.json["taskUid"]
    del docs
    task = app.scheduler.wait_for_task(uid, timeout=900.0)
    ingest_s = time.perf_counter() - t0
    if task.to_json()["status"] != "succeeded":
        raise AssertionError(f"ingest failed: {task.to_json()}")
    store = app.scheduler.index("hn")
    say(f"ingest: {n_docs} docs over HTTP in {ingest_s:.3f} s"
        f" ({n_docs / ingest_s:.1f} docs/s), plane width D={_plane_docs(store)}")
    return store


def main_path_phase(device, n_docs: int) -> dict:
    """Boot the port's App, ingest, serve QUERIES from THREADS clients and
    hold every response against the host scorer."""
    from meilisearch_tpu_torch.api.app import App, TestClient
    from meilisearch_tpu_torch.ops.chain_keys import LAUNCHES
    from meilisearch_tpu_torch.search.device_batch import serving_stats, warm_kernels
    from meilisearch_tpu_torch.search.perform import perform_search, perform_search_many

    app = App(device=device)
    try:
        client = TestClient(app)
        store = ingest(app, client, n_docs)
        t0 = time.perf_counter()
        if not warm_kernels(store, app.device, wait=True):
            raise AssertionError("the bucket's kernels did not warm")
        say(f"warm: {time.perf_counter() - t0:.3f} s")

        t0 = time.perf_counter()
        expected = [_strip(perform_search(store, dict(q))) for q in QUERIES]
        say(f"host reference answers: {time.perf_counter() - t0:.3f} s")
        # one forced device drain registers every query's planes in the pool
        t0 = time.perf_counter()
        first = perform_search_many(
            store, [dict(q) for q in QUERIES], device=app.device, force_device=True
        )
        if [_strip(r) for r in first] != expected:
            raise AssertionError("the first device drain differs from the host scorer")
        say(f"first device drain (row registration): {time.perf_counter() - t0:.3f} s")

        serving_stats(reset=True)
        LAUNCHES.reset()
        answers: list = []
        latencies: list = []
        errors: list = []
        lock = threading.Lock()

        def client_loop(k: int) -> None:
            try:
                for r in range(2):
                    for j in range(len(QUERIES)):
                        qi = (j + k + r) % len(QUERIES)
                        t = time.perf_counter()
                        res = client.search("hn", dict(QUERIES[qi]))
                        dt = time.perf_counter() - t
                        with lock:
                            answers.append((qi, res.status, res.json))
                            latencies.append(dt)
            except BaseException as err:  # noqa: BLE001 — reported below
                with lock:
                    errors.append(repr(err))

        threads = [threading.Thread(target=client_loop, args=(k,)) for k in range(THREADS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = LAUNCHES.value
        stats = serving_stats()
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"client threads failed: {errors[:3]}")
        lat = sorted(latencies)
        say(f"served {len(answers)} searches from {THREADS} threads in {wall:.3f} s:"
            f" {len(answers) / wall:.2f} QPS, p50 {lat[len(lat) // 2] * 1e3:.3f} ms,"
            f" p99 {lat[int(len(lat) * 0.99)] * 1e3:.3f} ms")
        say(f"serving stats: {json.dumps(stats)}")
        say(f"K1 launches during the main path: {launches}")

        bad = 0
        for qi, status, body in answers:
            if status != 200 or _strip(body) != expected[qi]:
                bad += 1
                if bad <= 3:
                    say(f"MISMATCH {QUERIES[qi]}: status {status}")
        say(f"responses equal to the host scorer: {len(answers) - bad}/{len(answers)}")
        if bad:
            raise AssertionError(f"{bad} responses differ from the host scorer")
        if launches <= 0:
            raise AssertionError("K1 was not launched on the main path")
        if stats["device_served"] <= 0 or stats["device_errors"] != 0:
            raise AssertionError(f"device path did not serve cleanly: {stats}")
        return {"launches": launches, "qps": len(answers) / wall}
    finally:
        app.search_batcher.stop()


def _median_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timing_phase(device, card: str) -> tuple[float, float]:
    from meilisearch_tpu_torch.ops.chain_keys import chain_keys, chain_keys_torch
    from meilisearch_tpu_torch.ops.synthetic import kernel_args, scorer_inputs

    args = kernel_args(scorer_inputs(3, 1 << 20, 32, seed=7), device)
    # plain, kernel, kernel, plain: both sides see the same card state
    plain = [_median_ms(lambda: chain_keys_torch(*args, T=3), reps=5)]
    kernel = [_median_ms(lambda: chain_keys(*args, T=3), reps=30)]
    kernel.append(_median_ms(lambda: chain_keys(*args, T=3), reps=30))
    plain.append(_median_ms(lambda: chain_keys_torch(*args, T=3), reps=5))
    k_ms, p_ms = statistics.median(kernel), statistics.median(plain)
    say(f"timing D=2^20 B=32 T=3 on {card}: K1 {k_ms:.4f} ms (runs {kernel}),"
        f" chain_keys_torch {p_ms:.4f} ms (runs {plain})")
    return k_ms, p_ms


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--docs", type=int, default=1_000_000)
    opts = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from meilisearch_tpu_torch._hooks import block_jax
    except ImportError:
        print("chip_smoke: run it from the root of the repository", file=sys.stderr)
        return 2
    block_jax()  # the port runs without jax, even where jax is installed
    device = torch.device("cuda", 0)

    card = card_line()
    say(card)
    build_phase()
    err = kernel_phase(device)
    served = main_path_phase(device, opts.docs)
    k_ms, p_ms = timing_phase(device, card)
    leaked = [
        m for m, mod in sys.modules.items()
        if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "flax")
    ]
    if leaked:
        raise AssertionError(f"jax was imported: {leaked[:5]}")
    print(json.dumps({"kernels": [{
        "name": "chain_keys", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": served["launches"],
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
