"""Batched device execution of chain queries on torch: the device half of
`meilisearch_tpu/search/device_batch.py`.

The host half is the reference's, shared by import: descriptors
(`build_descriptor`, padded by `_pad_descriptor`), the minor-write delta
overlay (`score_delta`), the exact merge and finish (`_finish_device_result`)
and the ladders. This module owns what touches the device: the plane pool
(`index/device_arena.py`), the resident live and filter-universe bitmaps,
one `planes_chain_topk` execute per drain, the readback, and the routing.

Differences from the reference, by design:
  * the device is an argument, never probed;
  * a device error propagates (and is counted in `device_errors`); the
    reference re-ran the whole chunk on the host. The per-query host
    re-run of a page the merge cannot prove exact stays: that is
    semantics, counted in `host_fallbacks`;
  * `strict=True` sends every eligible query to the device, where the
    reference read MEILI_TPU_DEVICE_STRICT.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from meilisearch_tpu.index.arrays import EMPTY, docids_array
from meilisearch_tpu.index.device_arena import pack_bitmap
from meilisearch_tpu.search import device_batch as _ref
from meilisearch_tpu.search.device_batch import (  # noqa: F401  (host half)
    B_LADDER,
    MAX_BATCH,
    MAX_PLANE_DOCS,
    MAX_T,
    T_LADDER,
    TOPK,
    ChainDescriptor,
    _delta_ids_array,
    _empty_descriptor,
    _finish_device_result,
    _ladder_B,
    _ladder_T,
    _pad_descriptor,
    _plane_docs,
    _sort_plane_host,
    score_delta,
)

from .._hooks import rebind_globals
from ..index.device_arena import get_arena
from ..ops import _build
from ..ops.arena_host import MASK_SLOTS, merge_topk_host, merge_topk_sort_host
from ..ops.arena_scorer import planes_chain_topk

# the reference's build_descriptor, registering rows in the port's arena
build_descriptor = rebind_globals(_ref.build_descriptor, get_arena=get_arena)

# conservative per-descriptor staged-row bound (cold, nothing cached)
_MAX_BYTE_ROWS_PER_QUERY = _ref._MAX_BYTE_ROWS_PER_QUERY
_LRU_ROWS = 256


def _assemble_universe(store, D: int, B: int, filt, device: torch.device):
    """(B, D/32) packed filter-universe stack on the device: a cached
    all-zeros base plus one uploaded row per distinct filter (rows cached
    by identity per generation). `filt` is [(slot, packed_row)]."""
    zkey = (store.generation, D, B, device)
    cached = getattr(store, "_torch_universe_zeros", None)
    if cached is None or cached[0] != zkey:
        cached = (zkey, torch.zeros((B, D // 32), dtype=torch.int32, device=device))
        store._torch_universe_zeros = cached
    base = cached[1]
    if not filt:
        return base
    rows_lru = getattr(store, "_torch_universe_rows", None)
    if rows_lru is None or rows_lru[0] != (store.generation, D, device):
        rows_lru = ((store.generation, D, device), OrderedDict())
        store._torch_universe_rows = rows_lru
    lru = rows_lru[1]
    dev_rows = []
    for _slot, row in filt:
        ent = lru.get(id(row))
        # the keepalive reference in the entry keeps id() unique
        if ent is None or ent[0] is not row:
            ent = (row, torch.from_numpy(np.ascontiguousarray(row)).to(device))
            lru[id(row)] = ent
            if len(lru) > _LRU_ROWS:
                lru.popitem(last=False)
        else:
            lru.move_to_end(id(row))
        dev_rows.append(ent[1])
    slots = torch.tensor([i for i, _ in filt], dtype=torch.int64, device=device)
    return base.index_copy(0, slots, torch.stack(dev_rows))


def _live_mask(store, D: int, device: torch.device) -> torch.Tensor:
    """Packed (D/32,) bit-blocked live bitmap on the device. Delta docids
    are not live here: the host overlay (score_delta) serves them."""
    cached = getattr(store, "_torch_live_cache", None)
    if cached is not None and cached[0] == (store.generation, D, device):
        return cached[1]
    ids = docids_array(store)
    if store.delta_docids:
        delta = np.fromiter(store.delta_docids, np.int64, len(store.delta_docids))
        ids = np.setdiff1d(ids, delta)
    dev = torch.from_numpy(pack_bitmap(ids, D)).to(device)
    store._torch_live_cache = ((store.generation, D, device), dev)
    return dev


def execute_device_batch(
    store, descriptors: list[ChainDescriptor], device: torch.device, T: int = MAX_T
) -> list:
    """One device execute for a batch of descriptors, padded to the B and
    T ladders. Entries come back None where the query must re-run on the
    host scorer (a page the merge cannot prove exact)."""
    D = _plane_docs(store)
    arena = get_arena(store, D, device)
    n_real = len(descriptors)
    real = descriptors
    B = _ladder_B(n_real)
    descriptors = [_pad_descriptor(d, T) for d in descriptors]
    descriptors = descriptors + [
        _empty_descriptor(T, descriptors[0].search) for _ in range(B - n_real)
    ]

    use_valid = np.zeros(B, dtype=bool)
    filt = []
    for i, d in enumerate(descriptors):
        if d.universe_ids is not None:
            use_valid[i] = True
            if len(d.universe_ids):
                filt.append((
                    i,
                    d.universe_packed
                    if d.universe_packed is not None
                    else pack_bitmap(d.universe_ids, D),
                ))

    want = [i for i in range(n_real) if descriptors[i].want_mask]
    mask_sel = np.zeros(MASK_SLOTS, np.int32)
    for slot, i in enumerate(want[:MASK_SLOTS]):
        mask_sel[slot] = i

    try:
        byte_pool = arena.prepare_batch()
        out, candw, masks = planes_chain_topk(
            byte_pool,
            np.stack([d.term_rows for d in descriptors]),
            np.stack([d.pair_rows for d in descriptors]),
            np.stack([d.ea_rows for d in descriptors]),
            np.array([d.sort_row for d in descriptors], np.int32),
            np.array([bool(d.sort_criteria) for d in descriptors], bool),
            _assemble_universe(store, D, B, filt, device),
            use_valid,
            np.stack([d.adj for d in descriptors]),
            np.stack([d.mand for d in descriptors]),
            _live_mask(store, D, device),
            T=T,
            D=D,
            k=TOPK,
            mask_sel=mask_sel,
        )
    except Exception:
        # a half-written pool must not serve: rebuild from the host caches
        store._torch_arena = None
        raise

    # the launches above are asynchronous; the .cpu() copies below wait for
    # them. The store lock is not needed meanwhile, so release it and let a
    # second executor prepare the next drain: its pool writes are queued on
    # the same CUDA stream, behind this drain's reads. Formatting after
    # re-acquire tolerates concurrent deletes.
    lock = store._lock
    released = False
    if lock._is_owned():
        lock.release()
        if lock._is_owned():
            # a re-entrant caller held the RLock at depth > 1: restore the
            # depth and keep it held for the readback
            lock.acquire()
        else:
            released = True
    try:
        out = out.cpu().numpy()
        mask_rows: dict[int, np.ndarray] = {}
        if want:
            rows = (masks if len(want) <= MASK_SLOTS else candw).cpu().numpy()
            for slot, i in enumerate(want):
                mask_rows[i] = rows[slot] if len(want) <= MASK_SLOTS else rows[i]
    finally:
        if released:
            lock.acquire()

    k = TOPK
    idx1, key1 = out[:, :k], out[:, k : 2 * k]
    idx2, key2 = out[:, 2 * k : 3 * k], out[:, 3 * k : 4 * k]
    counts = out[:, 4 * k]

    delta_live = _delta_ids_array(store) if store.delta_docids else EMPTY
    results: list = []
    for i in range(n_real):
        d = real[i]
        count = int(counts[i])
        d_ids, d_keys = EMPTY, None
        if len(delta_live):
            d_ids, d_keys = score_delta(store, d, delta_live, T)
        want_keys = bool(d.search.compute_scores)
        rkeys = None
        if d.sort_criteria:
            search = d.search

            def sort_key_rows(cand, search=search, d=d):
                rows: list[np.ndarray] = []
                for f, asc in d.sort_criteria:
                    rows.extend(search._sort_field_rows(f, asc, cand))
                return rows

            f0, asc0 = d.sort_criteria[0]
            plane = _sort_plane_host(store, f0, asc0)

            def qsort_of(cand, plane=plane):
                return plane[cand].astype(np.int32) + 128

            got = merge_topk_sort_host(
                idx1[i], key1[i], idx2[i], key2[i], count, TOPK, T,
                sort_key_rows, qsort_of,
                delta_ids=d_ids, delta_keys=d_keys, return_keys=want_keys,
            )
        else:
            got = merge_topk_host(
                idx1[i], key1[i], idx2[i], key2[i], count, TOPK,
                delta_ids=d_ids, delta_keys=d_keys, return_keys=want_keys,
            )
        if want_keys:
            ranked, n_exact, total, rkeys = got
        else:
            ranked, n_exact, total = got
        results.append(
            _finish_device_result(
                store, d, ranked, total, n_exact, mask_rows.get(i),
                delta_matches=d_ids, keys=rkeys, T=T,
            )
        )
    return results


def device_batch_enabled() -> bool:
    """The plane-resident path is on unless MEILI_TPU_DEVICE_BATCH=0."""
    return os.environ.get("MEILI_TPU_DEVICE_BATCH", "1") == "1"


_WARM_LOCK = threading.Lock()
_WARM_STATE: dict = {}  # (device, D) -> "pending" | "ready" | exception


def warm_kernels(store, device: torch.device, wait: bool = False) -> bool:
    """Build K1 and launch it once at this store's bucket width, off the
    serving path. Returns True when the bucket is ready. On the CPU there
    is nothing to build. A failed build or launch raises here, on this
    call or the next, and every raise is counted in `device_errors`."""
    try:
        return _warm(store, device, wait)
    except Exception:
        _stats_add(device_errors=1)
        raise


def _warm(store, device: torch.device, wait: bool) -> bool:
    D = _plane_docs(store)
    if D > MAX_PLANE_DOCS:
        return False
    if device.type == "cpu":
        return True
    key = (str(device), D)
    with _WARM_LOCK:
        state = _WARM_STATE.get(key)
        if state is None:
            _WARM_STATE[key] = "pending"
    if isinstance(state, BaseException):
        raise RuntimeError(f"kernel warm-up failed for D={D}") from state

    def warm_now():
        try:
            z = np.zeros
            B = B_LADDER[0]
            pool = torch.full((2, D // 4), -1, dtype=torch.int32, device=device)
            out, _candw, _masks = planes_chain_topk(
                pool, z((B, 1, 3), np.int32), z((B, 1, 3), np.int32),
                z((B, 2), np.int32), z(B, np.int32), z(B, bool),
                torch.zeros((B, D // 32), dtype=torch.int32, device=device),
                z(B, bool), z((B, 1), bool), np.ones((B, 1), bool),
                torch.zeros(D // 32, dtype=torch.int32, device=device),
                T=1, D=D, k=TOPK,
            )
            out.cpu()
            _WARM_STATE[key] = "ready"
        except BaseException as err:
            _WARM_STATE[key] = err
            raise

    if state is None:
        if wait:
            warm_now()
        else:
            threading.Thread(
                target=warm_now, name=f"kernel-warm-{D}", daemon=True
            ).start()
    elif wait:
        while _WARM_STATE.get(key) == "pending":
            time.sleep(0.05)
        if isinstance(_WARM_STATE.get(key), BaseException):
            raise RuntimeError(f"kernel warm-up failed for D={D}") from _WARM_STATE[key]
    return _WARM_STATE.get(key) == "ready"


def _check_kernels(store, device: torch.device) -> None:
    """Build K1 (once per process) and start this bucket's warm-up; raise,
    counted in `device_errors`, when either has failed."""
    try:
        _build.load_library()
    except Exception:
        _stats_add(device_errors=1)
        raise
    warm_kernels(store, device, wait=False)


def _device_worthwhile(
    store, n_eligible: int, device: torch.device, force_device: bool = False
) -> bool:
    """The reference's routing: a lone query goes to the host unless the
    batcher forces device mode, and only a warm bucket serves. (The
    MEILI_TPU_DEVICE_MIN_BATCH threshold was measured on a TPU; it is kept
    until the H100 is measured.)"""
    min_batch = int(os.environ.get("MEILI_TPU_DEVICE_MIN_BATCH", "4"))
    if not force_device and n_eligible < min_batch:
        return False
    return warm_kernels(store, device, wait=False)


_exec_stats = threading.local()
_SERVING_STATS_LOCK = threading.Lock()
_SERVING_STATS = {
    "drains": 0,  # device drains executed
    "device_served": 0,  # queries answered from a device result
    "host_fallbacks": 0,  # device ran but page unproven -> host re-run
    "device_errors": 0,  # K1 builds, warm-ups and device executes that raised
    "device_exec_s": 0.0,  # wall time inside execute_device_batch
    "drain_wall_s": 0.0,  # the batcher's whole-drain wall, every drain
    "host_mode_served": 0,  # queries the batcher served in host mode
    "host_mode_drains": 0,
}


def _stats_add(**kv) -> None:
    with _SERVING_STATS_LOCK:
        for k, v in kv.items():
            _SERVING_STATS[k] += v


def serving_stats(reset: bool = False) -> dict:
    """Snapshot (optionally reset) the serving attribution counters. (The
    reference's inexact_flags / exact_flag_rate count the approx selection,
    which is not ported.)"""
    with _SERVING_STATS_LOCK:
        snap = dict(_SERVING_STATS)
        if reset:
            for k in _SERVING_STATS:
                _SERVING_STATS[k] = 0
    return snap


def consume_device_exec_s() -> float:
    """Device-execute wall time recorded on this thread since the last
    call, then reset (0.0: no device execute ran)."""
    s = getattr(_exec_stats, "s", 0.0)
    _exec_stats.s = 0.0
    return s


def search_many(
    store,
    searches: list,
    device: torch.device,
    force_device: bool = False,
    strict: bool = False,
) -> list:
    """Execute a batch: chain-compatible queries in grouped device executes
    on `device`, the rest on the host scorer. Order-preserving. On a CUDA
    device no search is answered, on the device or the host, while K1's
    build or this bucket's warm-up stands failed: that raises."""
    results: list = [None] * len(searches)
    if device_batch_enabled() and device.type == "cuda":
        _check_kernels(store, device)

    def run_chunk(chunk: list, T: int) -> None:
        t0 = time.monotonic()
        try:
            batch_results = execute_device_batch(
                store, [d for _i, d in chunk], device, T
            )
        except Exception:
            _stats_add(device_errors=1)
            raise
        dt_exec = time.monotonic() - t0
        _exec_stats.s = getattr(_exec_stats, "s", 0.0) + dt_exec
        n_fell = sum(1 for r in batch_results if r is None)
        _stats_add(
            drains=1,
            device_exec_s=dt_exec,
            device_served=len(batch_results) - n_fell,
            host_fallbacks=n_fell,
        )
        for (i, _d), res in zip(chunk, batch_results):
            results[i] = res if res is not None else searches[i].execute()

    if device_batch_enabled():
        eligible = [
            (i, s)
            for i, s in enumerate(searches)
            if _plane_docs(s.store) <= MAX_PLANE_DOCS
        ]
        if eligible and (
            strict or _device_worthwhile(store, len(eligible), device, force_device)
        ):
            arena = get_arena(store, _plane_docs(store), device)
            pending: list = []

            def flush():
                nonlocal pending
                if pending:
                    run_chunk(pending, _ladder_T(max(d.T for _i, d in pending)))
                    pending = []

            for i, s in eligible:
                if not arena.has_room(_MAX_BYTE_ROWS_PER_QUERY):
                    # pool full: execute what we have (its row ids are
                    # still live), then let rows re-register
                    flush()
                    arena.reset_rows()
                try:
                    d = build_descriptor(s)
                except Exception:
                    d = None  # the host scorer answers (or re-raises) it
                if d is not None:
                    pending.append((i, d))
                    if len(pending) == MAX_BATCH:
                        flush()
            flush()
    for i, s in enumerate(searches):
        if results[i] is None:
            results[i] = s.execute()
    return results
