"""Durable task journal (write-ahead log) + boot replay.

Reference: crates/index-scheduler/src/queue/ keeps the task queue in LMDB,
so an acknowledged task survives any crash; a crash mid-batch leaves its
tasks enqueued and the index wtxn uncommitted, and restart simply
reprocesses them (SURVEY §5 "tasks are durable and idempotent-by-replay",
lib.rs:772 register semantics).

Here the journal IS the durable queue:

  * `register` appends the full task (including its payload — the
    file-store/update_files analogue) and fsyncs BEFORE the HTTP 202 ack.
  * terminal transitions append a `fin` record (history fidelity; replay
    correctness never depends on them being flushed).
  * boot: load the latest snapshot, then replay — every journaled task
    that is not terminal *in the snapshot* is re-enqueued with its payload
    and reprocessed. Index mutations are deterministic, so reprocessing
    reconstructs exactly the state the crash lost; side-effecting kinds
    (export, dumpCreation) re-run with at-least-once semantics.
  * a snapshot checkpoint rotates the journal: registrations of tasks that
    are still unfinished at snapshot time are carried into the fresh
    segment, everything older is deleted (the snapshot already embeds
    those tasks' effects and views).

Torn tails (a crash mid-append) are tolerated: replay stops a segment at
the first undecodable line.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from .tasks import Task, TaskStatus, TaskType

TERMINAL = (TaskStatus.SUCCEEDED, TaskStatus.FAILED, TaskStatus.CANCELED)

# journal size that triggers an automatic snapshot + rotation
DEFAULT_MAX_BYTES = 128 * 1024 * 1024


class TaskJournal:
    def __init__(self, db_path: str, fsync: bool = True):
        self.db_path = db_path
        self.dir = os.path.join(db_path, "wal")
        os.makedirs(self.dir, exist_ok=True)
        self.fsync = fsync
        self.lock = threading.Lock()
        self.suspended = False  # replay injects without re-journaling
        self.max_bytes = int(
            os.environ.get("MEILI_TPU_WAL_MAX_BYTES", DEFAULT_MAX_BYTES)
        )
        segs = self._segments()
        self._seq = segs[-1] if segs else 0
        self._file = open(self._segment_path(self._seq), "a", encoding="utf-8")

    # -- segment bookkeeping ------------------------------------------------

    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"wal-{seq:08d}.jsonl")

    def _segments(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("wal-") and name.endswith(".jsonl"):
                try:
                    out.append(int(name[4:-6]))
                except ValueError:
                    pass
        return sorted(out)

    def size(self) -> int:
        total = 0
        for seq in self._segments():
            try:
                total += os.path.getsize(self._segment_path(seq))
            except OSError:
                pass
        return total

    # -- appends --------------------------------------------------------------

    def _append(self, record: dict, sync: bool) -> None:
        if self.suspended:
            return
        line = json.dumps(record, separators=(",", ":"), default=str)
        with self.lock:
            self._file.write(line + "\n")
            self._file.flush()
            if sync and self.fsync:
                os.fsync(self._file.fileno())

    def log_register(self, task: Task) -> None:
        """Called before the write route acks: fsync'd registration."""
        self._append(
            {
                "t": "reg",
                "uid": task.uid,
                "type": task.type.value,
                "indexUid": task.index_uid,
                "details": task.details,
                "content": task.content,
                "enqueuedAt": task.enqueued_at,
            },
            sync=True,
        )

    def log_finish(self, task: Task) -> None:
        self._append(
            {
                "t": "fin",
                "uid": task.uid,
                "status": task.status.value,
                "details": task.details,
                "error": task.error,
                "canceledBy": task.canceled_by,
                "startedAt": task.started_at,
                "finishedAt": task.finished_at,
            },
            sync=False,
        )

    # -- reads ---------------------------------------------------------------

    def records(self):
        """All records across segments in order; a torn tail ends its
        segment silently (crash-mid-append is expected, not corruption)."""
        for seq in self._segments():
            try:
                fh = open(self._segment_path(seq), "r", encoding="utf-8")
            except OSError:
                continue
            with fh:
                for line in fh:
                    try:
                        yield json.loads(line)
                    except (json.JSONDecodeError, ValueError):
                        break

    # -- rotation --------------------------------------------------------------

    def rotate(self, carry_tasks: Optional[list[Task]] = None) -> None:
        """Start a fresh segment after a successful snapshot; registrations
        of still-unfinished tasks are carried over so their payloads stay
        replayable, then old segments are removed."""
        with self.lock:
            self._seq += 1
            new_file = open(
                self._segment_path(self._seq), "a", encoding="utf-8"
            )
            for task in carry_tasks or []:
                rec = {
                    "t": "reg",
                    "uid": task.uid,
                    "type": task.type.value,
                    "indexUid": task.index_uid,
                    "details": task.details,
                    "content": task.content,
                    "enqueuedAt": task.enqueued_at,
                }
                new_file.write(
                    json.dumps(rec, separators=(",", ":"), default=str) + "\n"
                )
            new_file.flush()
            os.fsync(new_file.fileno())
            old = self._file
            self._file = new_file
            old.close()
            for seq in self._segments():
                if seq < self._seq:
                    try:
                        os.remove(self._segment_path(seq))
                    except OSError:
                        pass

    def clear(self) -> None:
        """Fresh-start (explicit dump/snapshot import): drop all history."""
        self.rotate(carry_tasks=None)

    def close(self) -> None:
        with self.lock:
            try:
                self._file.close()
            except Exception:
                pass


# -- boot replay ---------------------------------------------------------------


def replay_journal(scheduler, journal: TaskJournal) -> int:
    """Re-enqueue journaled tasks whose effects are not in the loaded
    snapshot. Returns the number of replayed tasks.

    Rule: a task terminal in the snapshot's own task table already
    contributed to the snapshot's index state (single writer) — skip it.
    Everything else (absent, enqueued, or processing at snapshot time)
    is re-enqueued, in uid order, with its journaled payload.
    """
    regs: dict[int, dict] = {}
    for rec in journal.records():
        if rec.get("t") == "reg":
            regs[int(rec["uid"])] = rec
    replayed = 0
    with scheduler.lock:
        for uid in sorted(regs):
            rec = regs[uid]
            snap_task = scheduler.queue.tasks.get(uid)
            if snap_task is not None and snap_task.status in TERMINAL:
                continue
            try:
                ttype = TaskType(rec["type"])
            except ValueError:
                continue
            task = Task(
                uid=uid,
                type=ttype,
                index_uid=rec.get("indexUid"),
                details=rec.get("details") or {},
                content=rec.get("content"),
            )
            if rec.get("enqueuedAt"):
                task.enqueued_at = rec["enqueuedAt"]
            task.status = TaskStatus.ENQUEUED
            scheduler.queue.tasks[uid] = task
            replayed += 1
        if regs:
            scheduler.queue._next_uid = max(
                scheduler.queue._next_uid, max(regs) + 1
            )
    if replayed:
        with scheduler.wake:
            scheduler.wake.notify_all()
    return replayed
