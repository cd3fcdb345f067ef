"""The port's SearchBatcher: drains reach the port's device path, and
drain_wall_s is recorded on every drain, host mode included (the JAX
package's batcher adds it only in device mode, so host-mode runs read 0
after any number of drains), and a broken kernel fails the search
instead of being answered by the host scorer. The port's answers are held
against the JAX package's, each package on its own store built from the
same documents."""

import time

import numpy as np
import pytest
import torch

from meilisearch_tpu.index.store import IndexStore as JaxStore
from meilisearch_tpu.search.perform import perform_search as jax_perform_search
from meilisearch_tpu_torch.engine import batcher as batcher_mod
from meilisearch_tpu_torch.engine.batcher import SearchBatcher
from meilisearch_tpu_torch.index.store import IndexStore
from meilisearch_tpu_torch.ops import _build
from meilisearch_tpu_torch.search import device_batch as db
from meilisearch_tpu_torch.search.device_batch import _plane_docs, serving_stats
from meilisearch_tpu_torch.search.perform import perform_search_many as port_search_many

WORDS = ["quick", "brown", "fox", "lazy", "dog", "rust", "search", "engine"]


def _build_store(cls):
    rng = np.random.default_rng(11)
    s = cls("batch", primary_key="id")
    s.settings.apply_json({"filterableAttributes": ["points"]})
    s.add_documents([
        {"id": i, "title": " ".join(rng.choice(WORDS, size=4)),
         "points": int(rng.integers(0, 100))}
        for i in range(300)
    ])
    return s


@pytest.fixture(scope="module")
def store():
    return _build_store(IndexStore)


@pytest.fixture(scope="module")
def jax_store():
    return _build_store(JaxStore)


@pytest.mark.parametrize("strict", [False, True])
def test_every_drain_records_wall_time(store, jax_store, strict):
    batcher = SearchBatcher(torch.device("cpu"), strict=strict)
    try:
        before = serving_stats()
        queries = [{"q": "quick fox"}, {"q": "rust", "filter": "points > 50"},
                   {"q": "lazy dgo"}]
        for q in queries:
            got = batcher.submit(store, dict(q))
            want = jax_perform_search(jax_store, dict(q))
            assert [h["id"] for h in got["hits"]] == [h["id"] for h in want["hits"]]
        after = serving_stats()
    finally:
        batcher.stop()
    drains = after["host_mode_drains"] - before["host_mode_drains"]
    assert batcher.mode == "host" and drains == len(queries)
    assert after["drain_wall_s"] > before["drain_wall_s"]
    served = after["device_served"] - before["device_served"]
    # lone queries stay on the host unless strict sends them to the device
    assert served == (len(queries) if strict else 0)


# A CUDA batcher whose K1 is broken answers no search, not even a lone one
# that the controller routes to the host. Nothing here touches a card: the
# failure is met before any tensor is made.
CUDA = torch.device("cuda", 0)


def _refused():
    raise RuntimeError("nvcc failed (2): error: refused")


def test_lone_search_fails_when_k1_failed_to_build(store, monkeypatch):
    monkeypatch.setattr(_build, "load_library", _refused)
    batcher = SearchBatcher(CUDA)
    try:
        before = serving_stats()
        for q in ({"q": "quick fox"}, {"q": "lazy dgo"}):
            with pytest.raises(RuntimeError, match="nvcc failed"):
                batcher.submit(store, dict(q))
        after = serving_stats()
    finally:
        batcher.stop()
    assert batcher.mode == "host"
    assert after["device_errors"] - before["device_errors"] == 2
    assert after["host_mode_served"] == before["host_mode_served"]


@pytest.mark.parametrize("loaded", [False, True])
def test_failed_warmup_reaches_the_callers(store, monkeypatch, loaded):
    """Host mode: the drain's kernel check raises. Under load: the
    controller's device question raises, before any drain runs."""
    monkeypatch.setattr(_build, "load_library", lambda: None)
    monkeypatch.setitem(
        db._WARM_STATE, (str(CUDA), _plane_docs(store)),
        RuntimeError("warm launch refused"),
    )
    drained = []
    monkeypatch.setattr(
        batcher_mod, "perform_search_many",
        lambda *a, **k: drained.append(1) or port_search_many(*a, **k),
    )
    batcher = SearchBatcher(CUDA)
    try:
        if loaded:
            now = time.monotonic()
            with batcher.lock:
                batcher._drains = [4] * 16
                batcher._arrivals = [now] * 8
        before = serving_stats()["device_errors"]
        with pytest.raises(RuntimeError, match="warm-up failed") as err:
            batcher.submit(store, {"q": "quick fox"})
        assert "warm launch refused" in str(err.value.__cause__)
        assert serving_stats()["device_errors"] > before
    finally:
        batcher.stop()
    assert drained == ([] if loaded else [1])


def test_http_search_fails_when_k1_failed_to_build(monkeypatch):
    """The port's App on a (faked) CUDA device with a compiler that
    refuses: the search answers 500, never 200 from the host scorer."""
    from meilisearch_tpu_torch.api.app import App, TestClient

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "load_library", _refused)
    app = App(device=CUDA)
    try:
        client = TestClient(app)
        docs = [{"id": i, "title": f"quick fox {i}"} for i in range(50)]
        assert client.add_documents("k", docs)["status"] == "succeeded"
        res = client.search("k", {"q": "quick"})
        assert res.status == 500, res.json
    finally:
        app.search_batcher.stop()


def test_boot_warm_raises_when_the_kernels_failed_to_build(monkeypatch):
    """The server's synchronous boot warm (`App.warm_devices`) builds the
    kernels and warms every index; a refused build raises there, before
    the socket opens. On the CPU it warms with nothing to build."""
    from meilisearch_tpu_torch.api.app import App, TestClient

    cpu_app = App(device="cpu")
    try:
        docs = [{"id": i, "title": f"quick fox {i}"} for i in range(50)]
        assert TestClient(cpu_app).add_documents("k", docs)["status"] == "succeeded"
        cpu_app.warm_devices()
    finally:
        cpu_app.search_batcher.stop()
        cpu_app.scheduler.stop()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "load_library", _refused)
    app = App(device=CUDA)
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            app.warm_devices()
    finally:
        app.search_batcher.stop()
        app.scheduler.stop()
