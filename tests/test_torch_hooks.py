"""`rebind_globals` copies a reference function with a few module-level
names pointed at the port's objects. The copy's globals are a snapshot,
so these tests pin every other global each copy uses to the reference
module's own object: a copy that drifted from its reference fails here."""

import types

import pytest
import torch

from meilisearch_tpu.api import server as ref_server
from meilisearch_tpu.engine import batcher as ref_batcher
from meilisearch_tpu.search import device_batch as ref_db
from meilisearch_tpu_torch._hooks import rebind_globals
from meilisearch_tpu_torch.api import server
from meilisearch_tpu_torch.api.app import App
from meilisearch_tpu_torch.engine.batcher import SearchBatcher
from meilisearch_tpu_torch.index.device_arena import get_arena
from meilisearch_tpu_torch.search import device_batch


def _names(code: types.CodeType) -> set:
    """Every name the code (and the functions nested in it) looks up."""
    out = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            out |= _names(const)
    return out


def _case(name: str):
    """(the port's copy, its reference module, the names it rebinds)"""
    if name == "build_descriptor":
        return device_batch.build_descriptor, ref_db, {"get_arena": get_arena}
    if name == "server_main":
        return server._serve_main, ref_server, {"App": App}
    batcher = SearchBatcher(torch.device("cpu"))
    batcher.stop()
    return (
        batcher._update_mode.__func__,
        ref_batcher,
        {"_device_ready": batcher._device_ready},
    )


@pytest.mark.parametrize("case", ["build_descriptor", "server_main", "update_mode"])
def test_rebound_copies_share_the_reference_globals(case):
    fn, module, rebound = _case(case)
    used = _names(fn.__code__) & fn.__globals__.keys()
    assert set(rebound) <= used
    for name, obj in rebound.items():
        assert fn.__globals__[name] == obj and vars(module)[name] is not obj
    shared = used - set(rebound)
    drifted = [n for n in shared if fn.__globals__[n] is not vars(module)[n]]
    assert not drifted, drifted


def test_rebind_is_a_snapshot():
    mod = types.ModuleType("toy")
    exec("A = 1\nB = 2\ndef f():\n    return A + B\n", vars(mod))
    g = rebind_globals(mod.f, B=10)
    assert (mod.f(), g()) == (3, 11)
    mod.A = 100  # a later rebinding in the module does not reach the copy
    assert (mod.f(), g()) == (102, 11)
