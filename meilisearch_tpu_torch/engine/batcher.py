"""Continuous micro-batching of concurrent searches onto the port.

The reference's `SearchBatcher` (`meilisearch_tpu/engine/batcher.py`)
with its host/device A/B controller, queue and hold policy unchanged. The
port's batcher differs in three places:
  * drains call the port's `perform_search_many` on this batcher's device;
  * the controller's "is the device ready" question asks the port, and a
    failed K1 warm-up it meets is raised to the drain's callers (the
    reference answered False and went on serving on the host);
  * `drain_wall_s` is recorded on every drain (the reference recorded it
    only for device-mode drains, so host-mode runs read 0).
"""

from __future__ import annotations

import time as _time
import types

import torch

from meilisearch_tpu.engine import batcher as _ref
from meilisearch_tpu.engine.batcher import MAX_BATCH

from .._hooks import rebind_globals
from ..search.device_batch import (
    _stats_add,
    consume_device_exec_s,
    device_batch_enabled,
    warm_kernels,
)
from ..search.perform import perform_search_many


class SearchBatcher(_ref.SearchBatcher):
    def __init__(self, device: torch.device, strict: bool = False):
        super().__init__()
        self.device = device
        self.strict = strict
        # the reference controller, asking this batcher's device
        self._update_mode = types.MethodType(
            rebind_globals(
                _ref.SearchBatcher._update_mode, _device_ready=self._device_ready
            ),
            self,
        )

    def _device_ready(self, store) -> bool:
        """Raises (counted in `device_errors`) when K1's warm-up failed;
        `_run` relays that to the drain's callers."""
        return device_batch_enabled() and warm_kernels(
            store, self.device, wait=False
        )

    def _hold(self) -> None:
        """The reference's pre-drain hold in device mode: wait in small
        slices while the batch is still filling, up to HOLD_FRACTION of one
        measured drain."""
        if self.mode != "device" or len(self.queue) >= MAX_BATCH:
            return
        cap = min(self._drain_s * self.HOLD_FRACTION, self.HOLD_MAX_S)
        deadline = _time.monotonic() + max(cap, self.WINDOW_S)
        prev_len = len(self.queue)
        while _time.monotonic() < deadline:
            _time.sleep(self.WINDOW_S)
            cur_len = len(self.queue)
            if cur_len >= MAX_BATCH or cur_len <= prev_len:
                break
            prev_len = cur_len

    def _drain(self, entries: list, failed: BaseException | None = None) -> None:
        """Serve one store's share of a drain and wake its callers, or
        raise `failed` (the controller's device check) to them."""
        try:
            if failed is not None:
                raise failed
            device_mode = self.mode == "device"
            consume_device_exec_s()  # reset this thread's counter
            t_drain = _time.monotonic()
            results = perform_search_many(
                entries[0].store,
                [e.body for e in entries],
                entries[0].features,
                device=self.device,
                force_device=device_mode,
                strict=self.strict,
            )
            wall = _time.monotonic() - t_drain
            if device_mode:
                _stats_add(drain_wall_s=wall)
            else:
                _stats_add(
                    drain_wall_s=wall,
                    host_mode_served=len(entries),
                    host_mode_drains=1,
                )
            # the hold EWMA only learns from drains where a device execute
            # ran (a forced-device drain can still serve on the host)
            if device_mode and len(entries) > 1 and consume_device_exec_s() > 0.0:
                self._drain_s = 0.7 * self._drain_s + 0.3 * wall
            for e, r in zip(entries, results):
                e.result = r
        except BaseException as err:  # noqa: BLE001 — relayed to callers
            for e in entries:
                e.error = err
        done_at = _time.monotonic()
        for e in entries:
            e.event.set()
            self._served.append(done_at)

    def _run(self):
        while not self._stop:
            self.wake.wait(timeout=1.0)
            with self.lock:
                if not self.queue:
                    self.wake.clear()
                    continue
                now = _time.monotonic()
                recent = sum(
                    1 for t in self._arrivals if now - t <= self.RATE_WINDOW_S
                )
                # under self.lock: the executors share one controller
                asked, failed = self.queue[0].store, None
                try:
                    self._update_mode(now, recent, asked)
                except Exception as err:  # K1's warm-up failed
                    failed = err
            if failed is None:
                self._hold()
            with self.lock:
                if not self.queue:
                    self.wake.clear()
                    continue
                batch = self.queue[:MAX_BATCH]
                del self.queue[: len(batch)]
                if not self.queue:
                    self.wake.clear()
            self._drains.append(len(batch))
            if len(self._drains) > 256:
                del self._drains[:128]
            by_store: dict[int, list] = {}
            for e in batch:
                by_store.setdefault(id(e.store), []).append(e)
            for entries in by_store.values():
                self._drain(entries, failed if entries[0].store is asked else None)
            if len(self._served) > 4096:
                del self._served[:2048]
