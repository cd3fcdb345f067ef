"""The port's plane pool (a torch tensor) against the reference's jax
pool: after the same register/prepare sequence — appends across chunk
boundaries, cached rows, reset_rows, a reset at capacity and a generation
change — the two pools hold the same words and the same row ids."""

import numpy as np
import torch

from meilisearch_tpu.index.device_arena import DeviceArena as RefArena
from meilisearch_tpu_torch.index.device_arena import DeviceArena, get_arena

D = 1024
CAP = 256  # small capacity, so the sequence reaches it


class _Store:
    base_generation = 0


def _plane(rng):
    return rng.integers(-128, 128, size=D).astype(np.int8)


def test_pool_matches_reference_through_resets():
    rng = np.random.default_rng(5)
    store = _Store()
    ref, port = RefArena(store, D), DeviceArena(store, D, torch.device("cpu"))
    ref.byte_cap = port.byte_cap = CAP
    planes: dict = {}

    def register(keys):
        for key in keys:
            plane = planes.setdefault(key, _plane(rng))
            r1 = ref.byte_row(key, lambda p=plane: p)
            r2 = port.byte_row(key, lambda p=plane: p)
            assert r1 == r2, key

    def prepare_and_compare():
        want = np.asarray(ref.prepare_batch())
        got = port.prepare_batch()
        assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert port.byte_used == ref.byte_used

    register(range(70))  # spans two APPEND_ROWS chunks
    prepare_and_compare()
    register(list(range(60, 80)))  # 60..69 are cached
    prepare_and_compare()

    ref.reset_rows()
    port.reset_rows()
    register(range(100, 110))  # overwrites rows stale above the watermark
    prepare_and_compare()

    # fill to capacity, then reset as search_many does
    key = 200
    while ref.has_room(22):
        assert port.has_room(22)
        register(range(key, key + 22))
        key += 22
        prepare_and_compare()
    assert not port.has_room(22)
    ref.reset_rows()
    port.reset_rows()
    register(range(key, key + 30))
    prepare_and_compare()

    # a new base generation drops every registered row
    store.base_generation += 1
    register(range(5))
    prepare_and_compare()
    assert ref.byte_used == port.byte_used == 6


def test_get_arena_is_the_ports_own():
    store = _Store()
    store._device_arena = "reference arena"
    cpu = torch.device("cpu")
    arena = get_arena(store, D, cpu)
    assert store._torch_arena is arena and store._device_arena == "reference arena"
    assert get_arena(store, D) is arena  # as build_descriptor asks
    assert get_arena(store, 2 * D, cpu) is not arena
