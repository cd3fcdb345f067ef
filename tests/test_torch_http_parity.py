"""HTTP parity on the CPU: the same documents, settings and requests go to
the JAX package's App and to the port's `App(device="cpu", strict=True)`,
and the JSON responses must be equal (`processingTimeMs` and the random
`requestUid` aside). The JAX App answers on its host paths; the port's
App sends every eligible query through its device route, K1 and the
selection tail in their plain versions, so the formatting, facets and
scores of device-served hits are held against the host scorer's."""

import numpy as np
import pytest

from meilisearch_tpu.api.app import App as JaxApp
from meilisearch_tpu.api.app import TestClient as JaxClient
from meilisearch_tpu_torch.api.app import App, TestClient
from meilisearch_tpu_torch.search.device_batch import serving_stats

WORDS = [
    "quick", "brown", "fox", "jumps", "lazy", "dog", "salad", "green",
    "movie", "prince", "little", "women", "database", "rust", "search",
]
SETTINGS = {
    "searchableAttributes": ["title", "body"],
    "filterableAttributes": ["points", "category"],
    "sortableAttributes": ["points"],
}


def _docs():
    rng = np.random.default_rng(17)
    docs = []
    for i in range(300):
        docs.append({
            "id": i,
            "title": " ".join(rng.choice(WORDS, size=int(rng.integers(1, 8)))),
            "body": " ".join(rng.choice(WORDS, size=int(rng.integers(0, 14)))),
            "points": int(rng.integers(0, 100)),
            "category": ["red", "green", "blue"][i % 3],
        })
    docs.append({"id": 300, "title": "the quik brown fx", "points": 5})
    return docs


UNCOMPARED = ("processingTimeMs", "requestUid")


def _drop_times(x):
    if isinstance(x, dict):
        return {k: _drop_times(v) for k, v in x.items() if k not in UNCOMPARED}
    if isinstance(x, list):
        return [_drop_times(v) for v in x]
    return x


def _pair():
    apps = [JaxApp(), App(device="cpu", strict=True)]
    clients = [JaxClient(apps[0]), TestClient(apps[1])]
    for c in clients:
        c.update_settings("docs", SETTINGS)
        assert c.add_documents("docs", _docs())["status"] == "succeeded"
    return apps, clients


def _close(apps):
    for a in apps:
        a.search_batcher.stop()
        a.scheduler.stop()


@pytest.fixture(scope="module")
def clients():
    apps, clients = _pair()
    yield clients
    _close(apps)


def _same(clients, method, path, body=None):
    want, got = (c.request(method, path, body=body) for c in clients)
    assert got.status == want.status, (path, body, got.json, want.json)
    assert _drop_times(got.json) == _drop_times(want.json), (path, body)
    return got


SEARCHES = {
    "typo": {"q": "quikc brwn"},
    "phrase": {"q": '"quick brown" fox'},
    "filter": {"q": "fox", "filter": "points > 50 AND category = red"},
    "facets": {"q": "quick", "facets": ["points", "category"]},
    "sort": {"q": "lazy dog", "sort": ["points:desc"], "limit": 30},
    "distinct": {"q": "fox", "distinct": "category"},
    "highlight_crop": {
        "q": "green salad", "attributesToHighlight": ["title"],
        "attributesToCrop": ["body"], "cropLength": 4,
    },
    "ranking_score": {"q": "quick brown fox", "showRankingScore": True},
    "matching_all": {"q": "database rust", "matchingStrategy": "all"},
}


@pytest.mark.parametrize("case", sorted(SEARCHES))
def test_search_response_equal(clients, case):
    before = serving_stats()["device_served"]
    _same(clients, "POST", "/indexes/docs/search", SEARCHES[case])
    # the port's answer came from its device route
    assert serving_stats()["device_served"] > before


@pytest.mark.parametrize("federated", [False, True], ids=["multi", "federated"])
def test_multi_search_response_equal(clients, federated):
    queries = [
        {"indexUid": "docs", "q": "quick fox"},
        {"indexUid": "docs", "q": "lazy dgo", "filter": "points < 40"},
    ]
    body = {"queries": queries}
    if federated:
        body["federation"] = {"limit": 15}
    _same(clients, "POST", "/multi-search", body)


def _wait(clients, res_list):
    for c, res in zip(clients, res_list):
        assert res.status == 202, res.json
        assert c.wait_for_task(res.json["taskUid"])["status"] == "succeeded"


def test_settings_update_then_search():
    apps, clients = _pair()
    try:
        _wait(clients, [c.patch("/indexes/docs/settings", body={
            "rankingRules": [
                "words", "typo", "sort", "proximity", "attribute", "exactness",
            ],
            "synonyms": {"fox": ["dog"]},
        }) for c in clients])
        _same(clients, "GET", "/indexes/docs/settings")
        for body in ({"q": "fox"}, {"q": "quick fox", "sort": ["points:asc"]}):
            _same(clients, "POST", "/indexes/docs/search", body)
    finally:
        _close(apps)


def test_document_delete_then_search():
    apps, clients = _pair()
    try:
        _wait(clients, [c.delete("/indexes/docs/documents/300") for c in clients])
        _wait(clients, [
            c.post("/indexes/docs/documents/delete", body={"filter": "points > 90"})
            for c in clients
        ])
        for body in ({"q": "quik brown"}, {"q": "fox", "facets": ["category"]}):
            _same(clients, "POST", "/indexes/docs/search", body)
        _same(clients, "GET", "/indexes/docs/documents/300")
    finally:
        _close(apps)
