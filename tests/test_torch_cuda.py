"""Tests that need the card (marked `cuda`; they skip without a GPU).

This file imports no jax, so it runs where jax is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(`--noconftest`: tests/conftest.py sets up jax for the reference's
tests.) K1 is held against its plain torch version bit for bit, a refused
launch must raise, and the port's search path on the card must answer
exactly as the host scorer."""

import sys

import numpy as np
import pytest
import torch

from meilisearch_tpu.search.device_batch import T_LADDER
from meilisearch_tpu_torch._hooks import block_jax
from meilisearch_tpu_torch.ops import _build
from meilisearch_tpu_torch.ops import chain_keys as ck
from meilisearch_tpu_torch.ops.synthetic import kernel_args, scorer_inputs

pytestmark = pytest.mark.cuda
B = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if "jax" not in sys.modules:  # run alone: without jax, as the server runs
        block_jax()
    return torch.device("cuda", 0)


@pytest.mark.parametrize("D", [1024, 1 << 14])
@pytest.mark.parametrize("T", T_LADDER)
def test_kernel_matches_plain(cuda_device, T, D):
    args = kernel_args(scorer_inputs(T, D, B, seed=300 + T), cuda_device)
    before = ck.LAUNCHES.value
    got = ck.chain_keys(*args, T=T)
    torch.cuda.synchronize()
    assert ck.LAUNCHES.value == before + 1
    want = ck.chain_keys_torch(*args, T=T)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_refused_launch_raises(cuda_device):
    args = kernel_args(scorer_inputs(1, 1024, B, seed=4), cuda_device)
    lib = _build.load_library()
    keys = torch.empty((B, 1024), dtype=torch.int32, device=cuda_device)
    candw = torch.empty((B, 32), dtype=torch.int32, device=cuda_device)
    counts = torch.zeros(B, dtype=torch.int32, device=cuda_device)
    rc = lib.mst_chain_keys(
        *[a.data_ptr() for a in args], keys.data_ptr(), candw.data_ptr(),
        counts.data_ptr(), B, 1, 32, 48, torch.cuda.current_stream().cuda_stream,
    )
    assert rc != 0  # a block of 48 threads does not divide the bitmap
    with pytest.raises(RuntimeError):
        ck.check_launch(rc)


def test_search_path_on_the_card_matches_host(cuda_device):
    from meilisearch_tpu.index.store import IndexStore
    from meilisearch_tpu.search.perform import perform_search
    from meilisearch_tpu_torch.search.device_batch import serving_stats
    from meilisearch_tpu_torch.search.perform import perform_search_many

    words = ["quick", "brown", "fox", "lazy", "dog", "rust", "search", "engine"]
    rng = np.random.default_rng(3)
    store = IndexStore("card", primary_key="id")
    store.settings.apply_json(
        {"filterableAttributes": ["points"], "sortableAttributes": ["points"]}
    )
    store.add_documents([
        {"id": i, "title": " ".join(rng.choice(words, size=5)),
         "points": int(rng.integers(0, 100))}
        for i in range(3000)
    ])
    queries = [
        {"q": "quick brown fox"}, {"q": "serch engne"},
        {"q": "rust", "filter": "points > 50", "sort": ["points:desc"]},
        {"q": "lazy dog", "facets": ["points"], "showRankingScore": True},
        {"q": '"brown fox" rust', "matchingStrategy": "all"},
    ]
    before = ck.LAUNCHES.value
    served = serving_stats()["device_served"]
    got = perform_search_many(
        store, [dict(q) for q in queries], device=cuda_device, strict=True
    )
    assert ck.LAUNCHES.value > before
    assert serving_stats()["device_served"] - served == len(queries)
    for q, g in zip(queries, got):
        w = perform_search(store, dict(q))
        assert [h["id"] for h in g["hits"]] == [h["id"] for h in w["hits"]], q
        assert [h.get("_rankingScore") for h in g["hits"]] == [
            h.get("_rankingScore") for h in w["hits"]
        ], q
        for key in ("estimatedTotalHits", "facetDistribution"):
            assert g.get(key) == w.get(key), (key, q)


def test_server_entry_serves_on_the_card(cuda_device, tmp_path):
    """`python -m meilisearch_tpu_torch.api.server`: boot, ingest, search
    over a real socket, then a clean SIGTERM."""
    import json
    import os
    import signal
    import socket
    import subprocess
    import time
    import urllib.request
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    proc = subprocess.Popen(
        [sys.executable, "-m", "meilisearch_tpu_torch.api.server",
         "--port", str(port), "--db-path", str(tmp_path / "db")],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )

    def req(method, path, body=None):
        r = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(r, timeout=30) as resp:
            return json.loads(resp.read() or b"null")

    try:
        deadline = time.time() + 120
        while True:
            try:
                req("GET", "/health")
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
                assert time.time() < deadline, "server did not come up"
                time.sleep(0.5)
        words = ["quick", "brown", "fox", "lazy", "dog"]
        docs = [{"id": i, "title": " ".join(words[(i + j) % 5] for j in range(3))}
                for i in range(500)]
        uid = req("POST", "/indexes/hn/documents", docs)["taskUid"]
        while req("GET", f"/tasks/{uid}")["status"] not in ("succeeded", "failed"):
            time.sleep(0.2)
        assert req("GET", f"/tasks/{uid}")["status"] == "succeeded"
        res = req("POST", "/indexes/hn/search", {"q": "quick brwn", "limit": 5})
        assert len(res["hits"]) == 5 and res["estimatedTotalHits"] > 0
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
