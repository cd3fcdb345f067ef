"""The device warm-up of the vector legs (`App.warm_devices`,
`vector/store.py::warm_vector_kernels`) on an App bound to the CPU.

A write's task reads finished only once its batch has committed (the
bulk scope's run merge and generation bump), so the warm-up that follows
it and every later searcher see one generation; searchers of one
generation built at once share one resident map; and `warm_devices`
raises when an embedder that takes the device legs is left without its
resident matrix. Sizes are small: 12,000 documents of 4-dimension
vectors (past the scheduler's 10,000-document bulk threshold), the
device legs' row floor lowered where a test needs fewer rows."""

import threading
import time

import numpy as np
import pytest
import torch

from meilisearch_tpu_torch.api.app import App, TestClient
from meilisearch_tpu_torch.index.store import IndexStore
from meilisearch_tpu_torch.vector import store as vs

CPU = torch.device("cpu")
DIM = 4
SETTINGS = {"embedders": {"default": {"source": "userProvided", "dimensions": DIM}}}
BULK_DOCS = 6_000  # a task; two in one batch pass the scheduler's 10,000
COMMIT_S = 0.5  # how long a bulk commit is made to take


def _docs(start, n, seed):
    rng = np.random.default_rng(seed)
    return [{"id": start + i, "title": f"doc {start + i}",
             "_vectors": {"default": rng.standard_normal(DIM).tolist()}} for i in range(n)]


@pytest.fixture
def app():
    app = App(device=CPU)
    try:
        yield app
    finally:
        app.search_batcher.stop()
        app.scheduler.stop()


@pytest.fixture
def slow_commit(monkeypatch):
    """Each bulk commit sleeps COMMIT_S first: a task published before its
    batch's commit then reads finished a generation early."""
    orig = IndexStore.end_bulk

    def end_bulk(self):
        time.sleep(COMMIT_S)
        orig(self)

    monkeypatch.setattr(IndexStore, "end_bulk", end_bulk)


def _bulk_write(app) -> int:
    """Two tasks of BULK_DOCS documents each, processed as one batch (the
    scheduler is held at its first batch, a settings task, while they are
    enqueued); returns the second task's uid."""
    client = TestClient(app)
    held, release = threading.Event(), threading.Event()

    def hook(stage):
        if stage == "batch_created" and not held.is_set():
            held.set()
            release.wait(30.0)

    app.scheduler.breakpoint_hook = hook
    first = client.patch("/indexes/v/settings", body=SETTINGS).json["taskUid"]
    assert held.wait(30.0)
    uid = None
    for start in (0, BULK_DOCS):
        res = client.post("/indexes/v/documents", body=_docs(start, BULK_DOCS, start))
        assert res.status == 202, res.json
        uid = res.json["taskUid"]
    release.set()
    assert app.scheduler.wait_for_task(first, 60.0).to_json()["status"] == "succeeded"
    task = app.scheduler.wait_for_task(uid, 120.0).to_json()
    assert task["status"] == "succeeded", task
    assert task["batchUid"] == app.scheduler.queue.tasks[uid - 1].batch_uid
    return uid


def test_a_task_reads_finished_only_after_its_batch_committed(app, slow_commit):
    """Once a bulk write's last task reads succeeded, its batch has
    committed: the generation does not move after it, and a search finds
    the last document."""
    _bulk_write(app)
    store = app.scheduler.index("v")
    generation = store.generation
    assert app.scheduler.wait_device_warm(60.0)  # the batch and its warm-up have ended
    assert store.generation == generation
    res = TestClient(app).post("/indexes/v/search", body={"q": f"doc {2 * BULK_DOCS - 1}"})
    assert res.status == 200 and res.json["hits"][0]["id"] == 2 * BULK_DOCS - 1


def test_warm_devices_leaves_the_matrix_resident_after_a_bulk_write(app, slow_commit):
    """phase 5's read: after a bulk write and `warm_devices`, the next
    searcher finds the float matrix on the App's device."""
    _bulk_write(app)
    app.warm_devices()
    store = app.scheduler.index("v")
    searcher = vs.VectorSearcher(store, "default")
    assert searcher.on_device_legs() and searcher.matrix.shape[0] == 2 * BULK_DOCS
    m_dev, n = searcher._device[("matrix", CPU)]
    assert n == 2 * BULK_DOCS and m_dev.shape[0] >= n


def test_searchers_built_at_once_share_one_resident_map(monkeypatch):
    """Two threads asking for a generation's searcher at once get one
    state: the first to build holds the store's lock, the second reads
    the cache (without it, each starts a resident map of its own and the
    last to finish replaces the other's in the cache)."""
    monkeypatch.setattr(vs, "DEVICE_MIN_ROWS", 64)
    store = IndexStore("v", primary_key="id")
    store.settings.apply_json(SETTINGS)
    store.add_documents(_docs(0, 200, 1))
    store.device = CPU
    builds, both = [], threading.Event()
    orig = vs.VectorSearcher._build_ivf

    def build_ivf(self):
        builds.append(threading.current_thread().name)
        if len(builds) == 2:
            both.set()
        both.wait(0.5)  # long enough for a second thread to arrive
        return orig(self)

    monkeypatch.setattr(vs.VectorSearcher, "_build_ivf", build_ivf)
    got = {}

    def build(name):
        got[name] = vs.VectorSearcher(store, "default")

    threads = [threading.Thread(target=build, args=(n,), name=n) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
        assert not t.is_alive()
    assert len(builds) == 1
    assert got["a"]._device is got["b"]._device
    vs.warm_vector_kernels(store)
    assert ("matrix", CPU) in got["b"]._device


def test_warm_devices_raises_when_a_matrix_is_left_off_the_device(app, monkeypatch):
    """An embedder that takes the device legs and whose matrix is not
    resident after the warm-up (an upload forgotten, here forged) makes
    `warm_devices` raise, naming it."""
    monkeypatch.setattr(vs, "DEVICE_MIN_ROWS", 64)
    client = TestClient(app)
    client.update_settings("v", SETTINGS)
    assert client.add_documents("v", _docs(0, 200, 2))["status"] == "succeeded"
    assert app.scheduler.wait_device_warm(60.0)
    app.warm_devices()
    orig = vs._resident

    def forgetful(searcher, name, host_array, fill=0):
        out = orig(searcher, name, host_array, fill)
        searcher._device.pop((name, searcher.device))
        return out

    monkeypatch.setattr(vs, "_resident", forgetful)
    vs.VectorSearcher(app.scheduler.index("v"), "default")._device.clear()
    with pytest.raises(RuntimeError, match="embedder `default`'s matrix is not resident"):
        app.warm_devices()
