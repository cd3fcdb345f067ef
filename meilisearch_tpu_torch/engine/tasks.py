"""Task and batch models.

Reference: crates/meilisearch-types/src/tasks/mod.rs (KindWithContent,
TaskView) and crates/index-scheduler/src/queue/ (status/kind/date secondary
indexes, task views).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from enum import Enum
from typing import Any, Optional


def now_iso() -> str:
    return (
        datetime.now(timezone.utc)
        .isoformat(timespec="microseconds")
        .replace("+00:00", "Z")
    )


class TaskStatus(str, Enum):
    ENQUEUED = "enqueued"
    PROCESSING = "processing"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    CANCELED = "canceled"


class TaskType(str, Enum):
    INDEX_CREATION = "indexCreation"
    INDEX_UPDATE = "indexUpdate"
    INDEX_DELETION = "indexDeletion"
    INDEX_SWAP = "indexSwap"
    INDEX_COMPACTION = "indexCompaction"
    DOCUMENT_ADDITION_OR_UPDATE = "documentAdditionOrUpdate"
    DOCUMENT_EDITION = "documentEdition"
    DOCUMENT_DELETION = "documentDeletion"
    SETTINGS_UPDATE = "settingsUpdate"
    DUMP_CREATION = "dumpCreation"
    SNAPSHOT_CREATION = "snapshotCreation"
    TASK_CANCELATION = "taskCancelation"
    TASK_DELETION = "taskDeletion"
    UPGRADE_DATABASE = "upgradeDatabase"
    EXPORT = "export"
    NETWORK_TOPOLOGY_CHANGE = "networkTopologyChange"
    DSR_UPDATE = "dynamicSearchRuleUpdate"
    DSR_DELETION = "dynamicSearchRuleDeletion"
    DSR_CLEAR = "dynamicSearchRuleClear"


@dataclass
class Task:
    uid: int
    type: TaskType
    index_uid: Optional[str] = None
    status: TaskStatus = TaskStatus.ENQUEUED
    details: dict = field(default_factory=dict)
    error: Optional[dict] = None
    canceled_by: Optional[int] = None
    batch_uid: Optional[int] = None
    enqueued_at: str = field(default_factory=now_iso)
    started_at: Optional[str] = None
    finished_at: Optional[str] = None
    # payload for processing (documents, settings patch, filter, ...)
    content: Any = None
    network: Optional[dict] = None

    def duration(self) -> Optional[str]:
        if not (self.started_at and self.finished_at):
            return None
        fmt = "%Y-%m-%dT%H:%M:%S.%f"
        try:
            s = datetime.strptime(self.started_at.rstrip("Z"), fmt)
            f = datetime.strptime(self.finished_at.rstrip("Z"), fmt)
            secs = (f - s).total_seconds()
            return f"PT{secs:.9f}S"
        except ValueError:
            return None

    def to_json(self) -> dict:
        out = {
            "uid": self.uid,
            "batchUid": self.batch_uid,
            "indexUid": self.index_uid,
            "status": self.status.value,
            "type": self.type.value,
            "canceledBy": self.canceled_by,
            "details": self.details or None,
            "error": self.error,
            "duration": self.duration(),
            "enqueuedAt": self.enqueued_at,
            "startedAt": self.started_at,
            "finishedAt": self.finished_at,
        }
        if self.network is not None:
            # cross-instance provenance (reference: TaskView network field,
            # tasks/network.rs Origin)
            out["network"] = self.network
        return out

    def summary(self) -> dict:
        """The enqueued-task summary returned by write routes
        (reference: SummarizedTaskView)."""
        return {
            "taskUid": self.uid,
            "indexUid": self.index_uid,
            "status": self.status.value,
            "type": self.type.value,
            "enqueuedAt": self.enqueued_at,
        }


@dataclass
class Batch:
    uid: int
    task_uids: list[int] = field(default_factory=list)
    details: dict = field(default_factory=dict)
    stats: dict = field(default_factory=dict)
    started_at: Optional[str] = None
    finished_at: Optional[str] = None
    progress: Optional[dict] = None

    def to_json(self) -> dict:
        return {
            "uid": self.uid,
            "progress": self.progress,
            "details": self.details,
            "stats": self.stats,
            "duration": None,
            "startedAt": self.started_at,
            "finishedAt": self.finished_at,
            "batchStrategy": self.stats.get("batchStrategy", ""),
        }


class TaskQueue:
    """In-memory durable-semantics task queue (the LMDB queue twin)."""

    def __init__(self) -> None:
        self.tasks: dict[int, Task] = {}
        self.batches: dict[int, Batch] = {}
        self._next_uid = 0
        self._next_batch_uid = 0
        self.lock = threading.RLock()

    def register(self, task_type: TaskType, index_uid=None, details=None, content=None) -> Task:
        with self.lock:
            task = Task(
                uid=self._next_uid,
                type=task_type,
                index_uid=index_uid,
                details=details or {},
                content=content,
            )
            self._next_uid += 1
            self.tasks[task.uid] = task
            return task

    def new_batch(self) -> Batch:
        with self.lock:
            batch = Batch(uid=self._next_batch_uid)
            self._next_batch_uid += 1
            self.batches[batch.uid] = batch
            return batch

    def filtered(
        self,
        uids: Optional[list[int]] = None,
        statuses: Optional[list[str]] = None,
        types: Optional[list[str]] = None,
        index_uids: Optional[list[str]] = None,
        canceled_by: Optional[list[int]] = None,
        batch_uids: Optional[list[int]] = None,
        before_enqueued_at: Optional[str] = None,
        after_enqueued_at: Optional[str] = None,
        before_started_at: Optional[str] = None,
        after_started_at: Optional[str] = None,
        before_finished_at: Optional[str] = None,
        after_finished_at: Optional[str] = None,
    ) -> list[Task]:
        with self.lock:
            out = []
            for task in self.tasks.values():
                if uids is not None and task.uid not in uids:
                    continue
                if statuses is not None and task.status.value not in statuses:
                    continue
                if types is not None and task.type.value not in types:
                    continue
                if index_uids is not None and (
                    task.index_uid is None or task.index_uid not in index_uids
                ):
                    continue
                if canceled_by is not None and task.canceled_by not in canceled_by:
                    continue
                if batch_uids is not None and task.batch_uid not in batch_uids:
                    continue
                if before_enqueued_at and not task.enqueued_at < before_enqueued_at:
                    continue
                if after_enqueued_at and not task.enqueued_at > after_enqueued_at:
                    continue
                if before_started_at and not (
                    task.started_at and task.started_at < before_started_at
                ):
                    continue
                if after_started_at and not (
                    task.started_at and task.started_at > after_started_at
                ):
                    continue
                if before_finished_at and not (
                    task.finished_at and task.finished_at < before_finished_at
                ):
                    continue
                if after_finished_at and not (
                    task.finished_at and task.finished_at > after_finished_at
                ):
                    continue
                out.append(task)
            out.sort(key=lambda t: -t.uid)
            return out
