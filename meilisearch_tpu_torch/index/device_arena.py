"""The per-generation plane pool as a torch tensor on an explicit device.

Row registration, capacity and generation tracking are the reference's
(`meilisearch_tpu/index/device_arena.py::DeviceArena`, which touches jax
only in `prepare_batch`); so are the packers and the (rows, D/4) int32
lane-blocked layout. This module replaces `prepare_batch`: staged rows
land in the resident pool by a slice copy, in the reference's fixed
APPEND_ROWS chunks (padding rows of -1 included), so the pool's contents
match the reference's row for row.

The arena lives on the store as `_torch_arena`, apart from the
reference's `_device_arena`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from meilisearch_tpu.index import device_arena as _ref
from meilisearch_tpu.index.device_arena import APPEND_ROWS


class DeviceArena(_ref.DeviceArena):
    """Row pool for one store at one plane width D on one device."""

    def __init__(self, store, D: int, device: torch.device):
        super().__init__(store, D)
        self.device = torch.device(device)

    def prepare_batch(self) -> torch.Tensor:
        """Flush staged rows into the resident pool; returns the pool."""
        self._reset_if_stale()
        D4 = self.D // 4
        if self.byte_pool is None or self.byte_pool.shape[0] != self.byte_cap:
            self.byte_pool = torch.full(
                (self.byte_cap, D4), -1, dtype=torch.int32, device=self.device
            )
            self.byte_used = 1
        staged = self._staged_bytes
        for start in range(0, len(staged), APPEND_ROWS):
            chunk = staged[start : start + APPEND_ROWS]
            buf = np.full((APPEND_ROWS, D4), -1, dtype=np.int32)
            buf[: len(chunk)] = np.stack(chunk)
            at = self.byte_used + start
            if at + APPEND_ROWS > self.byte_cap:
                raise RuntimeError("plane pool overflow: has_room was not asked")
            # padding rows land above the watermark and are overwritten by
            # the next append (the reference's append_rows contract)
            self.byte_pool[at : at + APPEND_ROWS].copy_(torch.from_numpy(buf))
        self.byte_used += len(staged)
        self._staged_bytes = []
        return self.byte_pool


def get_arena(store, D: int, device: Optional[torch.device] = None) -> DeviceArena:
    """The store's port arena at width D. `device` None keeps the device of
    the arena already there (the reference's `build_descriptor` asks with
    (store, D) only, after `search_many` made the arena)."""
    arena = getattr(store, "_torch_arena", None)
    if device is None:
        if arena is None:
            raise RuntimeError("no port arena on this store: name a device")
        device = arena.device
    if arena is None or arena.D != D or arena.device != torch.device(device):
        arena = DeviceArena(store, D, device)
        store._torch_arena = arena
    return arena
