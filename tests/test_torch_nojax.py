"""The port where jax cannot be imported.

A subprocess makes `jax`, `jaxlib` and `flax` unimportable — either as if
they were not installed (a meta-path finder refusing them) or with the
port's own `block_jax`, which process entry points call where jax is
installed — then boots the port's App on the CPU, ingests ~2,000
synthetic documents and serves a typo query, a showRankingScore query and
a query after a minor write. Each must answer 200 and jax must never
load. Without the port's aliases the shared typo pass imports the
jax-only device OSA module and the first typo query answers 500. Last,
the port's server entry must refuse to start where CUDA is missing."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

NOT_INSTALLED = r'''
import importlib.abc, sys

class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return None

sys.meta_path.insert(0, _Refuse())
'''
BLOCKED = r'''
from meilisearch_tpu_torch._hooks import block_jax

block_jax()
'''

CHILD = r'''
import sys

from meilisearch_tpu.utils.synthetic import generate_hackernews_like
from meilisearch_tpu_torch.api.app import App, TestClient
from meilisearch_tpu_torch.ops import device_osa_stub
from meilisearch_tpu_torch.search.device_batch import serving_stats

app = App(device="cpu", strict=True)
c = TestClient(app)
c.update_settings("hn", {"filterableAttributes": ["points"],
                         "sortableAttributes": ["points"]})
task = c.add_documents("hn", generate_hackernews_like(2000, seed=5))
assert task["status"] == "succeeded", task
for body in ({"q": "searhc engine"},
             {"q": "rust database", "showRankingScore": True},
             {"q": "kubernets", "filter": "points > 100", "sort": ["points:desc"]}):
    r = c.search("hn", body)
    assert r.status == 200, (body, r.json)
    assert r.json["hits"], body
task = c.add_documents("hn", [{"id": 99999, "title": "searhc engine zzfresh"}])
assert task["status"] == "succeeded", task
r = c.search("hn", {"q": "zzfresh", "showRankingScore": True})
assert r.status == 200 and [h["id"] for h in r.json["hits"]] == [99999], r.json
assert not [m for m, mod in sys.modules.items()
            if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "flax")]
st = serving_stats()
assert st["device_served"] >= 4 and st["device_errors"] == 0, st
assert device_osa_stub.calls > 0
app.search_batcher.stop()
print("NOJAX_OK")
'''


@pytest.mark.parametrize("prelude", [NOT_INSTALLED, BLOCKED], ids=["absent", "blocked"])
def test_port_serves_without_jax(tmp_path, prelude):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env.pop("MEILI_TPU_DEVICE_STRICT", None)
    proc = subprocess.run(
        [sys.executable, "-c", prelude + CHILD],
        cwd=tmp_path,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0 and "NOJAX_OK" in proc.stdout, (
        proc.stdout[-2000:] + proc.stderr[-4000:]
    )


def test_server_refuses_to_start_without_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "meilisearch_tpu_torch.api.server",
         "--port", "7791", "--db-path", str(tmp_path / "db")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
