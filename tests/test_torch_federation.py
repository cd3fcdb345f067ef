"""`/multi-search` on the port: federated queries run through the port's
`perform_search_many` on the App's device, and the port's copy of
`api/federation.py` has neither of the JAX package's two federation
faults. The four scenarios are the JAX package's own tests
(tests/golden/test_document_join_http.py, tests/test_replica_failover.py),
which pass at the commit before those faults came in and fail on the JAX
package since: a per-query foreign-filter error is wrapped once (or, for a
field that is not a foreign key, not at all), and a shard query for an
index this node does not hold is proxied to a replica, not refused."""

import threading
from http.server import ThreadingHTTPServer

import pytest
from golden.test_document_join_http import FOREIGN_FILTER, seed, seed_profiles, set_features

from meilisearch_tpu_torch.api import federation as fed_mod
from meilisearch_tpu_torch.api.app import App, TestClient
from meilisearch_tpu_torch.api.server import make_handler
from meilisearch_tpu_torch.search import device_batch


@pytest.fixture
def client():
    app = App(device="cpu")
    c = TestClient(app)
    yield c
    app.search_batcher.stop()
    app.scheduler.stop()


def test_federated_search_with_foreign_filter(client):
    set_features(client, True)
    seed_profiles(client)
    params = {
        "federation": {},
        "queries": [
            {
                "indexUid": "books",
                "q": "",
                "filter": FOREIGN_FILTER,
                "attributesToRetrieve": ["title", "author", "related_authors", "genres"],
            },
            {
                "indexUid": "books",
                "q": "",
                "filter": (
                    'genres = classic AND (_foreign(author, birthday STARTS'
                    ' WITH "198") OR _foreign(related_authors, birthday'
                    ' STARTS WITH "198"))'
                ),
                "attributesToRetrieve": ["title", "author", "related_authors", "genres"],
            },
        ],
    }
    res = client.post("/multi-search", body=params)
    assert res.status == 200, res.json
    titles = [h["title"] for h in res.json["hits"]]
    assert sorted(titles) == [
        "Captain Marvel story",
        "The Great Gatsby",
        "To Kill a Mockingbird",
    ]
    for hit in res.json["hits"]:
        assert isinstance(hit["author"], dict), hit
        assert all(isinstance(a, dict) for a in hit["related_authors"])

    set_features(client, False)
    res = client.post("/multi-search", body=params)
    assert res.status == 400
    assert res.json["code"] == "feature_not_enabled"
    assert res.json["message"].startswith(
        "Inside `.queries[0]`: using a foreign filter requires enabling"
        " the `foreign_keys` experimental feature."
    )


def test_foreign_filter_rejects_field_not_in_foreign_keys(client):
    set_features(client, True)
    seed(client)
    params = {"q": "", "filter": "_foreign(title, id = a1)"}
    res = client.search("books", params)
    assert res.status == 400
    assert res.json == {
        "message": "Index `books`: Field `title` is not a foreign key",
        "code": "invalid_search_filter",
        "type": "invalid_request",
        "link": "https://docs.meilisearch.com/errors#invalid_search_filter",
    }

    res = client.post(
        "/multi-search",
        body={"queries": [{"indexUid": "books", **params}], "federation": {}},
    )
    assert res.status == 400
    assert res.json["message"] == "Index `books`: Field `title` is not a foreign key"


@pytest.fixture
def cluster():
    """ms0 (router) + ms1/ms2 (replicas of shard s1, same documents)."""
    ms0, ms1, ms2 = (App(device="cpu") for _ in range(3))
    servers = []
    ports = []
    for app in (ms1, ms2):
        srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
        ports.append(srv.server_address[1])
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
    c0, c1, c2 = TestClient(ms0), TestClient(ms1), TestClient(ms2)
    c0.patch("/experimental-features", body={"network": True})
    c0.patch(
        "/network",
        body={
            "self": "ms0",
            "remotes": {
                "ms1": {"url": f"http://127.0.0.1:{ports[0]}"},
                "ms2": {"url": f"http://127.0.0.1:{ports[1]}"},
            },
        },
    )
    # one shard, two replicas; replicas hold identical documents
    c0.patch(
        "/network",
        body={"shards": {"s1": {"remotes": ["ms1", "ms2"]}}},
    )
    docs = [
        {"id": 1, "title": "alpha shard doc"},
        {"id": 2, "title": "beta shard doc"},
    ]
    for name, c in (("ms1", c1), ("ms2", c2)):
        # replicas share the topology: one shard owning every document
        c.patch("/experimental-features", body={"network": True})
        c.patch(
            "/network",
            body={
                "self": name,
                "remotes": {
                    "ms1": {"url": f"http://127.0.0.1:{ports[0]}"},
                    "ms2": {"url": f"http://127.0.0.1:{ports[1]}"},
                },
            },
        )
        c.patch(
            "/network",
            body={"shards": {"s1": {"remotes": ["ms1", "ms2"]}}},
        )
        c.add_documents("movies", docs)
    yield c0, servers, ports
    for srv in servers:
        srv.shutdown()
    for app in (ms0, ms1, ms2):
        app.scheduler.stop()


def _shard_query():
    return {
        "federation": {},
        "queries": [
            {
                "indexUid": "movies",
                "q": "shard",
                "federationOptions": {"shard": "s1"},
            }
        ],
    }


def _shard_query():
    return {
        "federation": {},
        "queries": [
            {
                "indexUid": "movies",
                "q": "shard",
                "federationOptions": {"shard": "s1"},
            }
        ],
    }


def test_single_replica_serves_and_no_duplicates(cluster):
    c0, _servers, _ports = cluster
    res = c0.post("/multi-search", body=_shard_query())
    assert res.status == 200
    ids = [h["id"] for h in res.json["hits"]]
    # ONE replica answered: no duplicate hits from fanning to both
    assert sorted(ids) == [1, 2]
    assert not res.json.get("remoteErrors")


def test_dead_replica_fails_over(cluster):
    c0, servers, _ports = cluster
    # fresh backoff state: other tests may have poisoned these URLs
    fed_mod.REMOTE_AVAILABILITY._state.clear()
    # kill ms1 (the lexicographically-first replica the router prefers)
    servers[0].shutdown()
    res = c0.post("/multi-search", body=_shard_query())
    assert res.status == 200
    ids = sorted(h["id"] for h in res.json["hits"])
    # the shard still serves completely via ms2
    assert ids == [1, 2], res.json
    # the dead replica's failure is not surfaced as a loss
    assert not res.json.get("remoteErrors"), res.json.get("remoteErrors")


def test_multi_search_runs_on_the_port_device_path(client, monkeypatch):
    """Non-federated /multi-search queries drain through the port's
    perform_search_many on the App's device."""
    seen = []
    real = device_batch.search_many
    monkeypatch.setattr(
        device_batch, "search_many",
        lambda store, searches, device, **kw: seen.append(device)
        or real(store, searches, device, **kw),
    )
    docs = [{"id": i, "title": f"shard doc {i}"} for i in range(20)]
    client.add_documents("movies", docs)
    res = client.post("/multi-search", body={"queries": [
        {"indexUid": "movies", "q": "shard"}, {"indexUid": "movies", "q": "doc 3"},
    ]})
    assert res.status == 200, res.json
    assert [len(r["hits"]) for r in res.json["results"]] == [20, 20]
    assert seen == [client.app.device]
