"""The port's declarative workload runner (`meilisearch_tpu_torch/xtask.py`):
the checked-in workloads pass end to end through the port's App on the
CPU, restart and upgrade chains included, as tests/test_xtask.py runs them
through the JAX package; the bench mode replays a generated corpus over
the port's HTTP server; and the card is the default device."""

import glob
import json
import os

import pytest
import torch

from meilisearch_tpu_torch import xtask

ROOT = os.path.join(os.path.dirname(__file__), "..", "workloads")
WORKLOADS = sorted(glob.glob(os.path.join(ROOT, "tests", "*.json")))


def test_workloads_exist():
    assert len(WORKLOADS) == 7


@pytest.mark.parametrize("path", WORKLOADS, ids=[os.path.basename(p) for p in WORKLOADS])
def test_workload(path):
    xtask.run_workload(path, verbose=False, device="cpu")


def test_a_failing_expectation_fails_the_workload(tmp_path):
    """The runner is not vacuous: a wrong expected response raises."""
    path = tmp_path / "wrong.json"
    path.write_text(json.dumps({"type": "test", "name": "wrong", "commands": [
        {"route": "indexes", "method": "POST", "body": {"inline": {"uid": "x"}},
         "expectedStatus": 202, "synchronous": "WaitForTask"},
        {"route": "indexes/x", "method": "GET", "expectedResponse": {"uid": "y"}},
    ]}))
    with pytest.raises(xtask.WorkloadError, match="expected 'y', got 'x'"):
        xtask.run_workload(str(path), verbose=False, device="cpu")


def test_run_bench_on_a_generated_corpus(tmp_path, capsys):
    """A bench workload with the `hackernews` generator asset, over the
    port's HTTP server with the profile feed: every command runs and the
    indexing and search spans are reported."""
    path = tmp_path / "bench.json"
    path.write_text(json.dumps({
        "type": "bench", "name": "hn-small",
        "assets": {"hn": {"generator": "hackernews", "count": 300}},
        "commands": [
            {"route": "indexes/hn/settings", "method": "PATCH",
             "body": {"inline": {"filterableAttributes": ["points"]}},
             "synchronous": "WaitForTask"},
            {"route": "indexes/hn/documents", "method": "POST",
             "body": {"asset": "hn"}, "synchronous": "WaitForTask"},
            {"route": "indexes/hn/search", "method": "POST",
             "body": {"inline": {"q": "rust compiler"}}},
            {"route": "indexes/hn/search", "method": "POST",
             "body": {"inline": {"q": "databse", "filter": "points > 50"}}},
        ],
    }))
    report = xtask.run_bench(str(path), device="cpu")
    assert report["workload"] == "hn-small"
    assert report["commands"] == 4
    assert report["span_counts"].get("indexing::documents", 0) >= 1
    assert report["span_counts"].get("search::query", 0) == 2
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report


def test_main_runs_the_workloads_on_the_cpu(capsys):
    xtask.main(["test", os.path.join(ROOT, "tests", "movies.json"), "--device", "cpu"])
    assert "workload `movies`" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is present")
def test_the_card_is_the_default_and_raises_without_one():
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        xtask.run_workload(WORKLOADS[0], verbose=False)
    with pytest.raises(RuntimeError, match="CUDA was asked for"):
        xtask.run_workload(WORKLOADS[0], verbose=False, device="cuda")
    with pytest.raises(SystemExit) as err:
        xtask.main(["test", WORKLOADS[0]])
    assert err.value.code == 1
