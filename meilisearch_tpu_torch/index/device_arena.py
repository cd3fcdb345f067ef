"""Per-generation device-resident index planes, as one torch tensor.

The device index is NOT posting id lists: it is dense per-document
planes, one int8 ROW per cached posting structure, each structure family
packed into a single plane (K1 streams these rows, so fewer and denser
rows is the whole game):

  * term planes, one per (term, typo-class): -1 = class absent; else
    bit 7 = exact-original-word flag (class-0 plane only), bits 4-6 =
    min field weight, bits 0-3 = min position cost;
  * pair planes, one per (term edge, left-class): 2-bit min pair
    proximity cost per right-class at bits 0-1/2-3/4-5, fill 0b111111;
  * ExactAttribute rank planes per words level (0/1, -1 -> rank 2);
  * sort planes, one per (field, direction): the doc's sort rank over
    the field's value order quantized to 255 buckets, stored as
    rank - 128 (so row 0's constant -1 means "no sort": plain docid
    tie-break on device).

A query descriptor is then a handful of ROW INDICES in fixed-shape
matrices; the kernel is pure dense row gathers + the chain DP. Rows are
built on host once per (generation, structure), uploaded once, resident
until the store generation changes (the atomic-snapshot-swap model of
SURVEY §7; the reference's LMDB-page-cache role).

Row 0 of the pool is reserved as the identity row (all -1 = the
per-structure "absent" sentinel) so absent structures need no branches.

Pool capacity is FIXED per plane width D, staged rows land in the pool
by a slice copy in fixed APPEND_ROWS chunks, and filter universes never
enter the pool. If the pool ever fills, the arena resets and rows
re-register on demand from the host caches — a cache flush, not a
failure. The layout and the limits (`POOL_MAX_ELEMENTS`, int32 storage of
the int8 planes) are the JAX package's, so both pools hold the same words
row for row; they were set for the TPU compiler and are still to be
re-derived for the H100.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# fixed fresh-row chunk of the pool's appends
APPEND_ROWS = 64

# the pool is stored as (rows, D/4) int32 — four doc-bytes per element —
# because the backend's compile time explodes on int8 operands past
# ~2^28 ELEMENTS (ops/arena_scorer.py docstring; measured: a trivial
# gather over a 512 MB int8 operand compiles >10 min, the same bytes as
# int32 in <1 s). Element budget 2^28 = a 1 GiB pool.
POOL_MAX_ELEMENTS = 1 << 28
MAX_BYTE_ROWS = 8192


def byte_capacity(D: int) -> int:
    return int(min(MAX_BYTE_ROWS, max(192, POOL_MAX_ELEMENTS // (D // 4))))


def pack_plane(row: np.ndarray) -> np.ndarray:
    """(D,) int8 byte plane -> (D/4,) int32, lane-BLOCKED: lane j of word
    w holds doc j*D/4 + w (the kernel's _unpack_lanes inverse). Blocked
    rather than interleaved because the device unpack then CONCATENATES
    four (D/4,) lane arrays — an interleave needs a (..., D/4, 4) temp
    whose trailing dim pads 32x on TPU tile layouts (measured: the
    interleaved kernel moved 727 GB per batch at D=2^20)."""
    q = len(row) // 4
    blocked = np.ascontiguousarray(
        row.astype(np.int8).reshape(4, q).T
    )
    return blocked.view(np.int32).reshape(q)


def pack_bitmap(ids: np.ndarray, D: int) -> np.ndarray:
    """Sorted docids -> (D/32,) int32 bit-BLOCKED bitmap row: bit j of
    word w holds doc j*D/32 + w (used for the per-query filter-universe
    kernel inputs; blocked for the same tile-padding reason as
    pack_plane)."""
    mask = np.zeros(D, dtype=bool)
    if len(ids):
        mask[ids] = True
    rows = mask.reshape(32, D // 32).astype(np.uint32)
    return (
        (rows << np.arange(32, dtype=np.uint32)[:, None])
        .sum(axis=0, dtype=np.uint32)
        .astype(np.int32)
    )


def unpack_bitmap(words: np.ndarray, D: int) -> np.ndarray:
    """(D/32,) int32 row -> (D,) bool mask (inverse of pack_bitmap and of
    the kernel's candwords packing — bit-blocked order)."""
    w = words.astype(np.int64) & 0xFFFFFFFF
    bits = (w[None, :] >> np.arange(32, dtype=np.int64)[:, None]) & 1
    return bits.reshape(D).astype(bool)


def byte_plane(parts, D: int, fill: int) -> np.ndarray:
    """[(ids, value)] -> (D,) int8 row with `fill` as the default.

    Parts are assigned in descending value order so overlapping ids keep
    the MINIMUM value (the merge the round-1 kernel did with scatter-min —
    but once, on host, instead of per query on device)."""
    plane = np.full(D, fill, dtype=np.int8)
    for ids, value in sorted(parts, key=lambda p: -p[1]):
        if len(ids):
            plane[ids] = np.int8(value)
    return plane


def term_plane(
    D: int, class_ids, fid_parts, pos_parts, exact_ids=None
) -> np.ndarray:
    """Packed (exact | fid | pos) plane for one (term, typo-class).

    class_ids: sorted docids present in the class; fid_parts/pos_parts:
    [(ids, value)] min-merged as in byte_plane; exact_ids: docids
    containing the exact original word (class-0 planes only)."""
    fid = np.zeros(D, dtype=np.int16)
    for ids, value in sorted(fid_parts, key=lambda p: -p[1]):
        if len(ids):
            fid[ids] = value
    pos = np.zeros(D, dtype=np.int16)
    for ids, value in sorted(pos_parts, key=lambda p: -p[1]):
        if len(ids):
            pos[ids] = value
    packed = (np.minimum(fid, 7) << 4) | np.minimum(pos, 15)
    if exact_ids is not None and len(exact_ids):
        exact = np.zeros(D, dtype=np.int16)
        exact[exact_ids] = 0x80
        packed |= exact
    plane = packed.astype(np.uint8).view(np.int8)
    mask = np.zeros(D, dtype=bool)
    if len(class_ids):
        mask[class_ids] = True
    plane[~mask] = -1
    return plane


def pair_plane(D: int, parts_by_class) -> np.ndarray:
    """Packed 2-bit-per-right-class pair-proximity plane for one
    (term edge, left-class). parts_by_class: three [(ids, cost)] lists."""
    combined = np.zeros(D, dtype=np.int8)
    for cls, parts in enumerate(parts_by_class):
        combined |= byte_plane(parts, D, 3) << (2 * cls)
    return combined


def sort_plane(D: int, ordered_id_groups) -> np.ndarray:
    """Quantized sort-rank plane for one (field, direction).

    ordered_id_groups: iterable of docid arrays in ascending rank order
    (each group = one distinct sort value; docs absent from every group
    rank LAST). Value groups quantize to 0..253 (equal values stay equal,
    order preserved); missing-field docs get the reserved rank 254 so
    they never collide with a value bucket; stored as rank - 128
    (int8)."""
    plane = np.full(D, 126, dtype=np.int8)  # 126 + 128 = 254: missing last
    groups = [g for g in ordered_id_groups if len(g)]
    n = len(groups)
    if n:
        for i, ids in enumerate(groups):
            q = min((i * 254) // n, 253)
            plane[ids] = np.int8(q - 128)
    return plane


class DeviceArena:
    """Row pool for one store at one plane width D on one device. Fixed
    capacity; a full pool resets (rows re-register lazily from host
    caches)."""

    def __init__(self, store, D: int, device: torch.device):
        self.store = store
        self.D = D
        self.device = torch.device(device)
        # anchored to the BASE generation: minor writes (store._bump with
        # delta_ids) keep every resident row valid — delta docids are
        # excluded from the device live mask and served by the host
        # overlay (search/device_batch.py score_delta)
        self.generation = store.base_generation
        self.byte_cap = byte_capacity(D)
        self.byte_pool = None  # (byte_cap, D/4) int32 tensor on self.device
        self.byte_used = 1  # row 0 reserved (all-(-1) sentinel)
        self._byte_rows: dict = {}  # cache key -> row index
        self._staged_bytes: list[np.ndarray] = []

    def _reset_rows(self) -> None:
        self.byte_used = 1
        self._byte_rows.clear()
        self._staged_bytes = []

    def _reset_if_stale(self) -> None:
        if self.generation != self.store.base_generation:
            self.generation = self.store.base_generation
            self._reset_rows()

    def has_room(self, byte_rows_needed: int) -> bool:
        """Whether `byte_rows_needed` more rows fit without overflowing the
        pool (APPEND_ROWS headroom covers append-chunk padding)."""
        self._reset_if_stale()
        return (
            self.byte_used + len(self._staged_bytes) + byte_rows_needed
            <= self.byte_cap - APPEND_ROWS
        )

    def reset_rows(self) -> None:
        """Drop every registered row (a cache flush: rows re-register from
        the host caches on demand). Callers must not hold row indices
        across this — execute pending batches first."""
        self._reset_rows()

    def footprint(self) -> int:
        return self.byte_cap * self.D

    # -- row registration ---------------------------------------------------

    def byte_row(self, key, build) -> int:
        """Row index for a plane; build() -> (D,) int8 row (packed to
        int32 lanes at staging)."""
        self._reset_if_stale()
        row = self._byte_rows.get(key)
        if row is None:
            row = self.byte_used + len(self._staged_bytes)
            self._staged_bytes.append(pack_plane(build()))
            self._byte_rows[key] = row
        return row

    # -- batch I/O ---------------------------------------------------------------

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
            # the next append
            self.byte_pool[at : at + APPEND_ROWS].copy_(torch.from_numpy(buf))
        self.byte_used += len(staged)
        self._staged_bytes = []
        return self.byte_pool


def get_arena(store, D: int, device: Optional[torch.device] = None) -> DeviceArena:
    """The store's arena at width D. `device` None keeps the device of the
    arena already there (`build_descriptor` asks with (store, D) only,
    after `search_many` made the arena on its device)."""
    arena = getattr(store, "_device_arena", None)
    if device is None:
        if arena is None:
            raise RuntimeError("no arena on this store: name a device")
        device = arena.device
    if arena is None or arena.D != D or arena.device != torch.device(device):
        arena = DeviceArena(store, D, device)
        store._device_arena = arena
    return arena
