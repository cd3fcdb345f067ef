"""The port's scheduler warms the device after each write and on a store's
(re)load, as the JAX package's `_kick_warm` does.

Stores are bound to the CPU (`App(device="cpu")`), where the vector legs
keep their "resident" matrix as a CPU tensor: the upload of a new
generation is observable without a card. Every wait is on
`IndexScheduler.wait_device_warm`, never on a sleep."""

import threading

import numpy as np
import pytest
import torch

from meilisearch_tpu_torch.api.app import App, TestClient
from meilisearch_tpu_torch.engine import scheduler as sched
from meilisearch_tpu_torch.search.device_batch import serving_stats
from meilisearch_tpu_torch.vector import store as vs

CPU = torch.device("cpu")
DIM = 16
N = vs.DEVICE_MIN_ROWS + 200  # above the device legs' gate


def _docs(start, n, seed):
    rng = np.random.default_rng(seed)
    return [
        {"id": start + i, "title": f"doc {start + i}",
         "_vectors": {"e": rng.standard_normal(DIM).tolist()}}
        for i in range(n)
    ]


def _settings(quantized=False):
    conf = {"source": "userProvided", "dimensions": DIM}
    if quantized:
        conf["binaryQuantized"] = True
    return {"embedders": {"e": conf}}


def _resident(store):
    """The current generation's matrix is on the store's device, without
    a search having asked for it."""
    return vs.VectorSearcher(store, "e")._device.get(("matrix", store.device)) is not None


@pytest.fixture
def app():
    a = App(device="cpu")
    yield a
    a.search_batcher.stop()
    a.scheduler.stop()


def _post(app, client, docs):
    res = client.post("/indexes/w/documents", body=docs)
    assert res.status == 202
    task = app.scheduler.wait_for_task(res.json["taskUid"], timeout=120.0)
    assert task.to_json()["status"] == "succeeded", task.to_json()


def test_a_write_leaves_the_new_generation_resident(app):
    client = TestClient(app)
    client.update_settings("w", _settings())
    _post(app, client, _docs(0, N, seed=1))
    assert app.scheduler.wait_device_warm(timeout=120.0)
    store = app.scheduler.index("w")
    assert store.device == CPU
    assert _resident(store)
    first = vs.VectorSearcher(store, "e")._device[("matrix", CPU)][0]
    gen = store.generation

    _post(app, client, _docs(N, 1, seed=2))
    assert app.scheduler.wait_device_warm(timeout=120.0)
    assert store.generation != gen
    assert _resident(store)  # before any search of the new generation
    assert vs.VectorSearcher(store, "e")._device[("matrix", CPU)][0] is not first
    res = client.post("/indexes/w/search", body={"vector": [1.0] * DIM, "limit": 3,
                                                 "hybrid": {"semanticRatio": 1.0, "embedder": "e"}})
    assert res.status == 200 and res.json["hits"]


def test_an_index_with_queued_tasks_is_not_warmed(app, monkeypatch):
    """The first write's batch ends while a second write to the same index
    is queued: only the second batch warms, once, at the last generation."""
    warmed = []
    monkeypatch.setattr(
        sched, "_device_warm",
        lambda stores: warmed.append([(s.uid, s.generation) for s in stores]),
    )
    client = TestClient(app)
    client.update_settings("w", _settings())
    created, release = threading.Event(), threading.Event()

    def hook(stage):
        if stage == "batch_created" and not created.is_set():
            created.set()
            assert release.wait(60.0)

    app.scheduler.breakpoint_hook = hook
    first = client.post("/indexes/w/documents", body=_docs(0, 50, seed=3))
    assert created.wait(60.0)  # the first batch holds the scheduler
    second = client.post("/indexes/w/documents", body=_docs(50, 50, seed=4))
    release.set()
    for res in (first, second):
        assert app.scheduler.wait_for_task(res.json["taskUid"], 60.0).to_json()["status"] == "succeeded"
    assert app.scheduler.wait_device_warm(timeout=60.0)
    store = app.scheduler.index("w")
    assert warmed == [[("w", store.generation)]]


def test_a_failed_warm_is_counted_and_the_next_search_raises(app, monkeypatch):
    def broken(*args):
        raise RuntimeError("hamming kernel launch failed: cudaError_t 1")

    monkeypatch.setattr(vs, "hamming_keyed", broken)  # the top-k leg
    monkeypatch.setattr(vs, "hamming_rows", broken)  # the full column
    client = TestClient(app)
    client.update_settings("w", _settings(quantized=True))
    before = serving_stats()["device_errors"]
    _post(app, client, _docs(0, N, seed=5))
    assert app.scheduler.wait_device_warm(timeout=120.0)
    assert serving_stats()["device_errors"] == before + 1  # the warm's
    res = client.post("/indexes/w/search", body={"vector": [1.0] * DIM, "limit": 3,
                                                 "hybrid": {"semanticRatio": 1.0, "embedder": "e"}})
    assert res.status == 500  # not answered by the host pass
    assert serving_stats()["device_errors"] == before + 2


def test_a_loaded_store_is_warmed_and_an_unbound_one_is_not(app):
    from meilisearch_tpu_torch.index.store import IndexStore

    stores = []
    for device in (CPU, None):
        store = IndexStore("l", primary_key="id")
        store.settings.apply_json(_settings())
        store.add_documents(_docs(0, N, seed=6))
        store.device = device
        stores.append(store)
    for store in stores:
        app.scheduler._setup_loaded_store(store)
    assert app.scheduler.wait_device_warm(timeout=120.0)
    assert _resident(stores[0])
    assert not vs.VectorSearcher(stores[1], "e")._device
