"""The keyword-search slice end to end: the port's search_many (torch, on
the CPU) against the reference's device search_many (jax, STRICT), on the
store and queries of tests/test_device_batch.py plus facet and
showRankingScore cases, before and after minor writes (the delta overlay
of tests/test_incremental.py); then one HTTP-level case, port App against
reference App. Docids, totals, facet distributions and _rankingScore must
be exactly equal."""

import numpy as np
import pytest
import torch

from meilisearch_tpu.api.app import App as RefApp
from meilisearch_tpu.api.app import TestClient
from meilisearch_tpu.index.store import IndexStore
from meilisearch_tpu.search.perform import perform_search_many as ref_search_many
from meilisearch_tpu_torch.api.app import App
from meilisearch_tpu_torch.search.device_batch import serving_stats
from meilisearch_tpu_torch.search.perform import perform_search_many

CPU = torch.device("cpu")
WORDS = [
    "quick", "brown", "fox", "jumps", "lazy", "dog", "salad", "green",
    "movie", "prince", "little", "women", "database", "rust", "search",
]
SETTINGS = {
    "searchableAttributes": ["title", "body"],
    "filterableAttributes": ["points", "category"],
    "sortableAttributes": ["points", "category"],
}


def _docs():
    rng = np.random.default_rng(7)
    docs = []
    for i in range(400):
        n = int(rng.integers(1, 9))
        title = " ".join(rng.choice(WORDS, size=n))
        body = " ".join(rng.choice(WORDS, size=int(rng.integers(0, 12))))
        docs.append(
            {"id": i, "title": title, "body": body, "points": int(rng.integers(0, 100))}
        )
    docs += [
        {"id": 400, "title": "the quik brown fx", "points": 5},
        {"id": 401, "title": "databse rust serch", "points": 6},
        {"id": 402, "title": "quick brown fox", "points": 7},
    ]
    for i, d in enumerate(docs):
        if i % 7 != 0:
            d["category"] = ["red", "green", "blue", "cyan"][i % 4]
    return docs


QUERIES = [
    {"q": "quick brown fox"},
    {"q": "quick"},
    {"q": "databse rust"},
    {"q": "green salad movie", "limit": 50},
    {"q": "little prince", "offset": 3, "limit": 7},
    {"q": "fox", "filter": "points > 50"},
    {"q": "lazy dog", "filter": "points 10 TO 60"},
    {"q": "quick -brown"},
    {"q": '"quick brown" fox'},
    {"q": '"quick brown fox"'},
    {"q": 'lazy "quick brown"'},
    {"q": '"databse rust" quick'},
    {"q": "rust", "page": 1, "hitsPerPage": 5},
    {"q": "quick", "offset": 120, "limit": 30},
    {"q": "fox", "distinct": "category"},
    {"q": "quick brown fox", "matchingStrategy": "all"},
    {"q": "databse rust", "matchingStrategy": "all"},
    {"q": '"quick brown" fox', "matchingStrategy": "all"},
    {"q": "fox lazy", "matchingStrategy": "all", "filter": "points > 20"},
    {"q": "green salad", "matchingStrategy": "all", "sort": ["points:desc"]},
    # facets and showRankingScore, which the list above lacks
    {"q": "quick", "facets": ["points", "category"]},
    {"q": "green salad", "facets": ["category"], "filter": "points > 30"},
    {"q": "quick brown fox", "showRankingScore": True},
    {"q": "databse rust", "showRankingScore": True, "sort": ["points:desc"]},
    {"q": "fox", "showRankingScore": True, "facets": ["category"], "limit": 30},
    {"q": "zzznovel quick", "showRankingScore": True},
]
KEYS = ("estimatedTotalHits", "totalHits", "totalPages", "facetDistribution",
        "facetStats")


def _assert_same(want, got, queries):
    for q, a, b in zip(queries, want, got):
        assert [h["id"] for h in a["hits"]] == [h["id"] for h in b["hits"]], q
        assert [h.get("_rankingScore") for h in a["hits"]] == [
            h.get("_rankingScore") for h in b["hits"]
        ], q
        for key in KEYS:
            assert a.get(key) == b.get(key), (key, q)


@pytest.fixture
def strict_reference(monkeypatch):
    monkeypatch.setenv("MEILI_TPU_DEVICE_BATCH", "1")
    monkeypatch.setenv("MEILI_TPU_DEVICE_STRICT", "1")


def _check(store):
    before = serving_stats()
    want = ref_search_many(store, [dict(q) for q in QUERIES])
    got = perform_search_many(store, [dict(q) for q in QUERIES], device=CPU, strict=True)
    _assert_same(want, got, QUERIES)
    after = serving_stats()
    assert after["device_served"] - before["device_served"] >= len(QUERIES) - 2
    assert after["device_errors"] == before["device_errors"]


def test_search_many_matches_reference_through_minor_writes(strict_reference):
    store = IndexStore("parity", primary_key="id")
    store.settings.apply_json(SETTINGS)
    store.add_documents(_docs())
    _check(store)
    base_gen = store.base_generation

    rng = np.random.default_rng(9)
    store.add_documents([
        {"id": 1000 + j, "title": "zzznovel " + " ".join(rng.choice(WORDS, size=3)),
         "points": int(rng.integers(0, 100)), "category": "red"}
        for j in range(3)
    ])
    store.add_documents([  # edits reuse docids
        {"id": int(i), "title": " ".join(rng.choice(WORDS, size=4)),
         "points": int(rng.integers(0, 100))}
        for i in rng.integers(0, 400, size=2)
    ])
    store.delete_documents([str(int(rng.integers(0, 400)))])
    assert store.base_generation == base_gen and store.delta_docids
    _check(store)


def test_http_search_matches_reference_app(monkeypatch):
    monkeypatch.delenv("MEILI_TPU_DEVICE_STRICT", raising=False)
    ref_app, app = RefApp(), App(device="cpu", strict=True)
    try:
        clients = [TestClient(ref_app), TestClient(app)]
        for c in clients:
            c.update_settings("hn", SETTINGS)
            assert c.add_documents("hn", _docs())["status"] == "succeeded"
        before = serving_stats()["device_served"]
        for q in QUERIES:
            want, got = (c.search("hn", dict(q)) for c in clients)
            assert want.status == got.status == 200, (q, got.json)
            _assert_same([want.json], [got.json], [q])
        assert serving_stats()["device_served"] - before >= len(QUERIES) - 2
    finally:
        ref_app.search_batcher.stop()
        app.search_batcher.stop()
