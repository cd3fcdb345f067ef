"""The declarative workloads (workloads/tests/*.json) through the port's
xtask runner with device routing forced (`xtask.device_routing_forced`):
every store of theirs sits under the device thresholds, so without the
forcing the batcher answers every search on the host. On the CPU the
device legs run their plain versions (`_warm` is ready at once there,
the vector legs take `store.device`; the typo pass stays on the host,
whose device gate is CUDA's), the same route as `chip_smoke.py`'s phase
10 on the card. Each workload must meet its expectations unchanged, with
no device error; those whose keyword searches the device half accepts
must show `device_served` rising, and `embeddings.json` the float leg."""

import glob
import os

import pytest

from meilisearch_tpu_torch import xtask
from meilisearch_tpu_torch.ops import device_osa
from meilisearch_tpu_torch.search.device_batch import serving_stats
from meilisearch_tpu_torch.vector import store as vstore

ROOT = os.path.join(os.path.dirname(__file__), "..", "workloads", "tests")
WORKLOADS = sorted(glob.glob(os.path.join(ROOT, "*.json")))
# workloads with a keyword search the device half serves; dsr.json's index
# holds a dynamic search rule, which the device half leaves to the host,
# and network.json sends no search
DEVICE_SERVED = ("api-keys.json", "movies.json", "task-queue-compaction.json", "upgrade.json")
FLOAT_LEG = ("embeddings.json",)


@pytest.mark.parametrize("path", WORKLOADS, ids=[os.path.basename(p) for p in WORKLOADS])
def test_workload_passes_under_forced_device_routing(path):
    name = os.path.basename(path)
    before, legs = serving_stats(), vstore.FLOAT_LEGS.value
    with xtask.device_routing_forced():
        xtask.run_workload(path, verbose=False, device="cpu")
    after = serving_stats()
    assert after["device_errors"] == before["device_errors"]
    if name in DEVICE_SERVED:
        assert after["device_served"] > before["device_served"], name
    if name in FLOAT_LEG:
        assert vstore.FLOAT_LEGS.value > legs, name


def test_the_named_workloads_exist():
    names = {os.path.basename(p) for p in WORKLOADS}
    assert len(WORKLOADS) == 7 and set(DEVICE_SERVED + FLOAT_LEG) <= names


def test_the_forcing_is_undone_on_exit(monkeypatch):
    monkeypatch.delenv(xtask.MIN_BATCH_ENV, raising=False)
    rows, vocab = vstore.DEVICE_MIN_ROWS, device_osa.MIN_DEVICE_VOCAB
    with pytest.raises(RuntimeError, match="inside"):
        with xtask.device_routing_forced():
            assert os.environ[xtask.MIN_BATCH_ENV] == "1"
            assert vstore.DEVICE_MIN_ROWS == device_osa.MIN_DEVICE_VOCAB == 1
            raise RuntimeError("inside")
    assert xtask.MIN_BATCH_ENV not in os.environ
    assert (vstore.DEVICE_MIN_ROWS, device_osa.MIN_DEVICE_VOCAB) == (rows, vocab)
    monkeypatch.setenv(xtask.MIN_BATCH_ENV, "7")
    with xtask.device_routing_forced():
        pass
    assert os.environ[xtask.MIN_BATCH_ENV] == "7"
