"""Tracing spans and the /logs/stream profile feed.

Reference: the engine annotates every pipeline stage with tracing spans
(targets like `search::universe`, `search::query`, `indexing::documents` —
milli search/new/mod.rs:303,322,337, bucket_sort.rs:22) and exposes them
live over HTTP via `/logs/stream` with `LogMode::Profile`
(meilisearch routes/logs.rs:29-56); the benchmark runner sums span
durations by name (BENCHMARKS.md:9-17).

This implements the same model: `span("search::query")` context managers
emit JSON-line records to any attached subscribers; `profile_totals()`
aggregates durations per span for the bench path.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from contextlib import contextmanager
from typing import Optional

_lock = threading.Lock()
_subscribers: list["queue.Queue"] = []
_totals: dict[str, tuple[int, float]] = {}
_collect_totals = False


def subscribe(filter_target: Optional[str] = None) -> "queue.Queue":
    """Attach a live span feed (the /logs/stream subscriber)."""
    q: queue.Queue = queue.Queue(maxsize=10000)
    q.filter_target = filter_target
    with _lock:
        _subscribers.append(q)
    return q


def unsubscribe(q) -> None:
    with _lock:
        if q in _subscribers:
            _subscribers.remove(q)


def set_collect_totals(on: bool) -> None:
    global _collect_totals
    with _lock:
        _collect_totals = on
        if on:
            _totals.clear()


def profile_totals() -> dict[str, dict]:
    """Per-span {calls, totalMs} — the span-duration aggregation the
    reference bench runner computes from the profile stream."""
    with _lock:
        return {
            name: {"calls": n, "totalMs": round(ms, 3)}
            for name, (n, ms) in sorted(_totals.items())
        }


def _emit(record: dict) -> None:
    line = None
    with _lock:
        subs = list(_subscribers)
    for q in subs:
        ft = getattr(q, "filter_target", None)
        if ft and not record["target"].startswith(ft.rstrip("=").rstrip(":")):
            continue
        if line is None:
            line = json.dumps(record)
        try:
            q.put_nowait(line)
        except queue.Full:
            pass


def _active() -> bool:
    return bool(_subscribers) or _collect_totals


@contextmanager
def span(target: str, **attrs):
    """`with span("search::query", q=q):` — no-op cost when nothing
    listens."""
    if not _active():
        yield
        return
    start = time.perf_counter()
    try:
        yield
    finally:
        dur_ms = (time.perf_counter() - start) * 1000.0
        if _collect_totals:
            with _lock:
                n, ms = _totals.get(target, (0, 0.0))
                _totals[target] = (n + 1, ms + dur_ms)
        if _subscribers:
            _emit(
                {
                    "type": "span",
                    "target": target,
                    "durationMs": round(dur_ms, 3),
                    "timestamp": time.time(),
                    **attrs,
                }
            )
