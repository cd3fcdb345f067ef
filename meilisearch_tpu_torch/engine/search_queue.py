"""Bounded search concurrency permits.

Reference: crates/meilisearch/src/search_queue.rs — `parallelism` permits
run concurrently (one per core); excess requests WAIT in a queue bounded
by `capacity`. When the queue is full, a RANDOM waiter is bumped with
`too_many_search_requests` (503 + Retry-After: 10), and a freed permit is
handed to a RANDOM waiter (search_queue.rs:135,162: rng.gen_range +
swap_remove — randomness avoids starving any arrival position under
sustained overload). A zero capacity refuses any waiting immediately. Waiters also abort after `drop_after_s`
(--experimental-drop-search-after). Semantics pinned by
tests/golden/test_search_queue.py (port of search/search_queue.rs).
"""

from __future__ import annotations

import os
import random
import threading
from contextlib import contextmanager

from ..types.errors import EngineError, ErrorCode


class _Waiter:
    __slots__ = ("event", "granted", "bumped")

    def __init__(self):
        self.event = threading.Event()
        self.granted = False
        self.bumped = False


class SearchQueue:
    def __init__(
        self,
        capacity: int | None = None,
        parallelism: int | None = None,
        drop_after_s: float = 60.0,
    ):
        if parallelism is None:
            parallelism = max(os.cpu_count() or 2, 2)
        if capacity is None:
            capacity = 1000  # reference default experimental_search_queue_size
        self.capacity = capacity
        self.parallelism = max(1, parallelism)
        self.drop_after_s = drop_after_s
        self._lock = threading.Lock()
        self._running = 0
        self._waiters: list[_Waiter] = []

    def _error(self) -> EngineError:
        return EngineError(
            ErrorCode.TOO_MANY_SEARCH_REQUESTS,
            "Too many search requests running at the same time:"
            f" {self.capacity}. Retry after 10s.",
        )

    def try_acquire(self) -> "_Waiter | None":
        """Take a permit or join the wait queue. Returns None when the
        permit was taken immediately, else the waiter to block on.
        Raises when the queue cannot hold this request (capacity 0)."""
        with self._lock:
            if self._running < self.parallelism:
                self._running += 1
                return None
            if self.capacity == 0:
                raise self._error()
            if len(self._waiters) >= self.capacity:
                # bump a RANDOM waiter (search_queue.rs:162 swap_remove)
                old = self._swap_remove(random.randrange(len(self._waiters)))
                old.bumped = True
                old.event.set()
            w = _Waiter()
            self._waiters.append(w)
            return w

    def _swap_remove(self, i: int) -> "_Waiter":
        w = self._waiters[i]
        self._waiters[i] = self._waiters[-1]
        self._waiters.pop()
        return w

    def release(self) -> None:
        with self._lock:
            # hand the permit to a random waiter, else free the slot
            while self._waiters:
                w = self._swap_remove(random.randrange(len(self._waiters)))
                if w.bumped:
                    continue
                w.granted = True
                w.event.set()
                return
            self._running = max(0, self._running - 1)

    @contextmanager
    def permit(self):
        w = self.try_acquire()
        if w is not None:
            if not w.event.wait(timeout=self.drop_after_s) or not w.granted:
                with self._lock:
                    try:
                        self._waiters.remove(w)
                    except ValueError:
                        pass
                if w.granted:
                    # granted in the race window right after the timeout:
                    # the permit is ours after all
                    pass
                else:
                    raise self._error()
        try:
            yield
        finally:
            self.release()
