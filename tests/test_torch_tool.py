"""The port's offline ops CLI (`meilisearch_tpu_torch/tool.py`) and
`search/logger.py::explain_query` against the JAX package's.

One instance (two indexes, settings, a filter, tasks) is written once as
a snapshot, a dump and a packed db path. Each of the nine subcommands runs
through both packages' `tool.main`, each on its own copy of the input, and
prints the same output (paths and dump uids aside, which differ by
construction); what a command writes is read back and compared too. The
`openapi` command builds an App: the port's on the CPU here, the card by
default."""

import io
import json
import os
import shutil
import tempfile
from contextlib import redirect_stdout

import pytest
import torch

from meilisearch_tpu import tool as jax_tool
from meilisearch_tpu.api.app import App as JaxApp
from meilisearch_tpu.api.app import TestClient as JaxClient
from meilisearch_tpu.engine.dumps import create_dump, create_packed_checkpoint, create_snapshot
from meilisearch_tpu.index.store import IndexStore as JaxStore
from meilisearch_tpu.search.logger import explain_query as jax_explain_query
from meilisearch_tpu_torch import tool
from meilisearch_tpu_torch.index.store import IndexStore
from meilisearch_tpu_torch.search.logger import explain_query

MOVIES = [
    {"id": i, "title": f"movie {i} {w} quick brown fox", "year": 1990 + i}
    for i, w in enumerate(["alpha", "beta", "gamma", "delta", "epsilon"] * 4)
]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A snapshot, a dump and a packed db path of one instance."""
    root = tmp_path_factory.mktemp("tool")
    app = JaxApp()
    client = JaxClient(app)
    try:
        client.update_settings("movies", {"filterableAttributes": ["year"],
                                          "sortableAttributes": ["year"]})
        client.add_documents("movies", MOVIES)
        client.add_documents("books", [{"id": "b1", "title": "lazy dog"},
                                       {"id": "b2", "title": "the quick fox"}])
        client.delete("/indexes/movies/documents/3")
        app.scheduler.wait_for_all_tasks()
        snap = create_snapshot(app.scheduler, str(root / "snap"))
        create_dump(app.scheduler, str(root / "dumps"))
        create_packed_checkpoint(app.scheduler, str(root / "db"))
    finally:
        app.scheduler.stop()
    (dump,) = (root / "dumps").iterdir()
    return {"root": root, "snapshot": snap, "dump": str(dump), "db": str(root / "db")}


def _run(mod, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main(argv)
    return buf.getvalue()


def _copies(inputs, key, tmp_path):
    """Each package's own copy of one input: {"jax": path, "port": path}."""
    src = inputs[key]
    out = {}
    for side in ("jax", "port"):
        dst = tmp_path / side / os.path.basename(src)
        dst.parent.mkdir()
        if os.path.isdir(src):
            shutil.copytree(src, dst)
        else:
            shutil.copy(src, dst)
        out[side] = str(dst)
    return out


def _both(argv_of) -> dict:
    """The output of `argv_of(side)` through each package's tool."""
    return {"jax": _run(jax_tool, argv_of("jax")), "port": _run(tool, argv_of("port"))}


def _documents(path, index):
    return _run(tool, ["export-documents", "--snapshot", path, "--index", index])


def _stats(path):
    return _run(tool, ["stats", "--snapshot", path])


@pytest.mark.parametrize("index", ["movies", "books"])
def test_export_documents(inputs, tmp_path, index):
    paths = _copies(inputs, "snapshot", tmp_path)
    out = _both(lambda s: ["export-documents", "--snapshot", paths[s], "--index", index])
    assert out["port"] == out["jax"]
    assert len(out["port"].splitlines()) == (19 if index == "movies" else 2)


@pytest.mark.parametrize("key", ["snapshot", "dump"])
def test_stats(inputs, tmp_path, key):
    paths = _copies(inputs, key, tmp_path)
    out = _both(lambda s: ["stats", "--snapshot", paths[s]])
    assert out["port"] == out["jax"]
    assert json.loads(out["port"])["indexes"]["movies"]["numberOfDocuments"] == 19


def test_export_dump(inputs, tmp_path):
    paths = _copies(inputs, "snapshot", tmp_path)
    outs = {s: str(tmp_path / s / "out") for s in paths}
    out = _both(lambda s: ["export-dump", "--snapshot", paths[s], "--out", outs[s]])
    dumps = {}
    for side, text in out.items():
        assert text.startswith("dump created: ")
        (dumps[side],) = (os.path.join(outs[side], n) for n in os.listdir(outs[side]))
        assert os.path.basename(dumps[side]) == text.split(": ")[1].strip() + ".dump"
    # both dumps hold the same instance
    assert _stats(dumps["port"]) == _stats(dumps["jax"])
    for index in ("movies", "books"):
        assert _documents(dumps["port"], index) == _documents(dumps["jax"], index)


def test_import_dump(inputs, tmp_path):
    paths = _copies(inputs, "dump", tmp_path)
    outs = {s: str(tmp_path / s / "out") for s in paths}
    out = _both(lambda s: ["import-dump", "--dump", paths[s], "--out", outs[s]])
    snaps = {}
    for side, text in out.items():
        snaps[side] = os.path.join(outs[side], "data.ms.snapshot")
        assert text == f"snapshot written: {snaps[side]}\n"
    assert _stats(snaps["port"]) == _stats(snaps["jax"])
    for index in ("movies", "books"):
        assert _documents(snaps["port"], index) == _documents(snaps["jax"], index)


def test_clear_tasks(inputs, tmp_path, monkeypatch):
    """Both tools drop every task and write the snapshot to the default
    snapshot directory (under the temporary directory)."""
    paths = _copies(inputs, "snapshot", tmp_path)
    out, snaps = {}, {}
    for side, mod in (("jax", jax_tool), ("port", tool)):
        tmp = tmp_path / side / "tmp"
        tmp.mkdir()
        monkeypatch.setattr(tempfile, "tempdir", str(tmp))
        out[side] = _run(mod, ["clear-tasks", "--snapshot", paths[side]])
        snaps[side] = str(tmp / "meili_tpu_snapshots" / "data.ms.snapshot")
    monkeypatch.undo()
    assert out["port"] == out["jax"]
    assert out["port"].startswith("cleared ") and out["port"] != "cleared 0 tasks\n"
    assert _stats(snaps["port"]) == _stats(snaps["jax"])
    assert _documents(snaps["port"], "movies") == _documents(snaps["jax"], "movies")


def _tree(path):
    """Relative path -> bytes of every file under a db path."""
    out = {}
    for root, _dirs, files in os.walk(path):
        for name in files:
            full = os.path.join(root, name)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, path)] = fh.read()
    return out


def test_hair_dryer(inputs, tmp_path):
    paths = _copies(inputs, "db", tmp_path)
    out = _both(lambda s: ["hair-dryer", "--db-path", paths[s]])
    assert out["port"].replace(paths["port"], "DB") == out["jax"].replace(paths["jax"], "DB")
    assert out["port"].startswith("warmed ") and not out["port"].startswith("warmed 0 ")
    assert _tree(paths["port"]) == _tree(paths["jax"])  # it reads only


def test_offline_upgrade(inputs, tmp_path):
    """The packed checkpoint rewritten at the current formats: the same
    message, the same files, and an instance that loads to the same state."""
    paths = _copies(inputs, "db", tmp_path)
    out = _both(lambda s: ["offline-upgrade", "--db-path", paths[s]])
    assert out["port"].replace(paths["port"], "DB") == out["jax"].replace(paths["jax"], "DB")
    assert "rewritten at the current engine formats" in out["port"]
    assert sorted(_tree(paths["port"])) == sorted(_tree(paths["jax"]))
    from meilisearch_tpu_torch.engine.dumps import load_packed_checkpoint
    from meilisearch_tpu_torch.engine.scheduler import IndexScheduler

    docs = {}
    for side, path in paths.items():
        scheduler = IndexScheduler(autobatching_enabled=False)
        try:
            assert load_packed_checkpoint(scheduler, path)
            store = scheduler.index("movies")
            docs[side] = [store.documents[d] for d in sorted(store.documents)]
        finally:
            scheduler.stop()
    assert docs["port"] == docs["jax"] and len(docs["port"]) == 19


def test_offline_upgrade_without_a_checkpoint(tmp_path):
    out = _both(lambda s: ["offline-upgrade", "--db-path", str(tmp_path / s)])
    assert out["port"] == out["jax"] == "no packed checkpoint found at that db path\n"


@pytest.mark.parametrize("query", ['quick "brown fox" movi', "qick brwn", "alpha beta gamma", "-lazy dog"])
@pytest.mark.parametrize("dot_only", [False, True])
def test_explain_query_command(inputs, tmp_path, query, dot_only):
    paths = _copies(inputs, "snapshot", tmp_path)
    extra = ["--dot-only"] if dot_only else []
    out = _both(lambda s: ["explain-query", "--snapshot", paths[s], "--index", "movies",
                           "--query", query, *extra])
    assert out["port"] == out["jax"]
    assert ("digraph QueryGraph" in out["port"]) and (out["port"].startswith("digraph") == dot_only)


def test_openapi(capsys):
    """The route set, each route's operation, security and path
    parameters, and the components equal the JAX package's spec."""
    want = jax_tool.generate_openapi()
    got = tool.generate_openapi("cpu")
    assert sorted(got["paths"]) == sorted(want["paths"])
    assert got == want
    tool.main(["openapi", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == want


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is present")
def test_openapi_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        tool.generate_openapi()
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        tool.main(["openapi"])


# -- explain_query on tests/test_tracing.py's store ---------------------------


def _tracing_stores():
    docs = [{"id": 1, "t": "quick brown fox"}, {"id": 2, "t": "lazy dog"}]
    jax_store, store = JaxStore("t", primary_key="id"), IndexStore("t", primary_key="id")
    jax_store.add_documents([dict(d) for d in docs])
    store.add_documents([dict(d) for d in docs])
    return jax_store, store


@pytest.mark.parametrize(
    "query", ['quick "brown fox"', "quikc brown", "lazy do", "brownfox dog", "-quick fox", ""]
)
def test_explain_query_matches_jax(query):
    jax_store, store = _tracing_stores()
    got, want = explain_query(store, query), jax_explain_query(jax_store, query)
    assert got == want
    if query == 'quick "brown fox"':
        assert [t["phrase"] for t in got["terms"] if t["phrase"]] == [["brown", "fox"]]
