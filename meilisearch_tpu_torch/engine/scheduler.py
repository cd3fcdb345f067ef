"""Index scheduler: the task queue run loop + index registry.

Reference: crates/index-scheduler/src/ —
  - register + wake-up signal            (lib.rs:772, run loop lib.rs:485)
  - batch priorities                     (scheduler/create_batch.rs:524):
    taskCancelation > taskDeletion > snapshotCreation > dumpCreation >
    upgradeDatabase > per-index tasks (round-robin)
  - autobatching of consecutive same-index tasks (scheduler/autobatcher.rs)
  - panic containment: a crashed batch marks its tasks failed, the loop
    keeps running (lib.rs:501 catch_unwind)
  - index registry mapping uid -> index  (index_mapper/)

The single scheduler thread is the reference's concurrency model: one writer,
many MVCC readers — searches here read frozen index snapshots the same way.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import traceback
import uuid

log = logging.getLogger("meilisearch_tpu.scheduler")
from typing import Callable, Optional

from ..index.store import IndexStore
from ..types.errors import EngineError, ErrorCode
from .tasks import Batch, Task, TaskQueue, TaskStatus, TaskType, now_iso

VALID_INDEX_UID = re.compile(r"^[a-zA-Z0-9_-]{1,400}$")

INDEX_TASK_TYPES = {
    TaskType.INDEX_CREATION,
    TaskType.INDEX_UPDATE,
    TaskType.INDEX_DELETION,
    TaskType.INDEX_COMPACTION,
    TaskType.DOCUMENT_ADDITION_OR_UPDATE,
    TaskType.DOCUMENT_EDITION,
    TaskType.DOCUMENT_DELETION,
    TaskType.SETTINGS_UPDATE,
}

# Settings whose change requires re-deriving the posting tables
# (reference: update/settings.rs expensive path).
REINDEX_SETTINGS = {
    "searchable_attributes",
    "filterable_attributes",
    "sortable_attributes",
    "distinct_attribute",
    "stop_words",
    "non_separator_tokens",
    "separator_tokens",
    "dictionary",
    "typo_tolerance",
    "exact_attributes",
    "proximity_precision",
    "ranking_rules",
    # per-field locale rules change how fields tokenize (locales.rs
    # settings_change: re-index with the new pipelines)
    "localized_attributes",
}


def _host_warm(stores) -> None:
    """Warm the host query caches of freshly (re)loaded stores: the
    packed-v3 boot is ~0.3 s at 1M docs, which moves the vocabulary pack /
    typo-pass build to the FIRST query (measured 41 s cold at a
    600k-word vocabulary). It must NOT run after every drained ingest
    batch: packing the growing vocabulary on a thread steals the GIL from
    the next chunk (measured 3x slower HTTP ingest at 1M). The device half
    is `_device_warm`. Never raises."""
    for store in stores:
        try:
            from ..search.perform import perform_search

            # a two-word query walks tokenize -> derivations (packs the
            # whole base vocabulary) -> scorer caches
            perform_search(store, {"q": "warm up", "limit": 1})
        except Exception:
            pass


def _device_warm(stores) -> None:
    """Warm each store's device off the serving path, as the JAX package's
    `_kick_warm` does: build K1 and launch it at the store's plane bucket
    (search/device_batch.py::warm_kernels), and upload every embedder's
    matrix (vector/store.py::warm_vector_kernels), so the first search of a
    new generation finds it resident. A store bound to no device is
    skipped. A failure is logged and counted in `device_errors` (by the
    warm-up itself); the next search of that store on the device meets it
    again and raises, nothing is served from the host."""
    from ..search.device_batch import device_batch_enabled, warm_kernels
    from ..vector.store import warm_vector_kernels

    for store in stores:
        if store.device is None:
            continue
        try:
            if device_batch_enabled():
                warm_kernels(store, store.device, wait=True)
            warm_vector_kernels(store)
        except Exception:
            log.exception("device warm of index `%s` failed", store.uid)


class IndexScheduler:
    def __init__(self, autobatching_enabled: bool = True) -> None:
        self.queue = TaskQueue()
        # memory-budgeted registry (reference IndexMapper): deferred loads
        # + LRU eviction once a db path is attached (engine/index_map.py)
        from .index_map import IndexMap

        self.indexes = IndexMap()
        self.indexes.on_load = self._setup_loaded_store
        # durable write-ahead journal; attached by the server when a db
        # path exists (engine/journal.py — the LMDB task-queue analogue)
        self.journal = None
        self.lock = threading.RLock()
        self.wake = threading.Condition(self.lock)
        self.autobatching_enabled = autobatching_enabled
        # reference: index-scheduler lib.rs — queue capacity guard; finished
        # tasks beyond this are garbage-collected, registrations refused
        self.max_number_of_tasks = 1_000_000
        self._must_stop = threading.Event()
        self._abort_requested_by: Optional[int] = None
        self._stop = False
        self.webhooks: dict[str, dict] = {}
        self.runtime_features = {
            "metrics": False,
            "logsRoute": False,
            "editDocumentsByFunction": False,
            "containsFilter": False,
            "network": False,
            "getTaskDocumentsRoute": False,
            "compositeEmbedders": False,
            "chatCompletions": False,
            "multimodal": False,
            "taskQueueCompactionRoute": False,
            # document joins: `_foreign(..)` filters + result hydration
            # (reference features.rs:25 foreign_keys)
            "foreignKeys": False,
        }
        # reference shape: meilisearch-types/src/network.rs:13-24 —
        # {self, remotes, shards, leader, version}
        self.network = {
            "self": None,
            "remotes": {},
            "shards": {},
            "leader": None,
            "version": str(uuid.uuid4()),
        }
        from ..search.dynamic_rules import DynamicSearchRules
        from .analytics import Analytics

        self.dsr = DynamicSearchRules()
        self.analytics = Analytics(enabled=False)
        # test-only breakpoint hook: called with stage names so deterministic
        # interleaving tests can lock-step the scheduler thread
        # (reference: index-scheduler/src/test_utils.rs:25 Breakpoint channel)
        self.breakpoint_hook: Optional[Callable[[str], None]] = None
        # test-only fault injection (reference test_utils.rs FailureLocation)
        self.failure_locations: set[str] = set()
        self.on_task_finished: Optional[Callable[[Task], None]] = None
        # the device warm-ups started (`wait_device_warm` joins them) and
        # whether a batch is between its start and its warm-up
        self._warm_threads: list[threading.Thread] = []
        self._in_batch = False
        self._thread = threading.Thread(
            target=self._run, name="scheduler", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------
    # public API

    def register(
        self, task_type: TaskType, index_uid=None, details=None, content=None
    ) -> Task:
        if index_uid is not None and not VALID_INDEX_UID.match(index_uid):
            raise EngineError(
                ErrorCode.INVALID_INDEX_UID,
                # NB: the limit enforced is 400 bytes but the reference's
                # message says 512 (index_uid.rs:58 vs :99) — match it
                f"`{index_uid}` is not a valid index uid. Index uid can be an"
                " integer or a string containing only alphanumeric characters,"
                " hyphens (-) and underscores (_), and can not be more than"
                " 512 bytes.",
            )
        # queue self-protection (reference lib.rs:809 NoSpaceLeftInTaskQueue):
        # past the limit only task deletions are accepted, so users can free
        # space
        if (
            len(self.queue.tasks) >= self.max_number_of_tasks
            and task_type != TaskType.TASK_DELETION
        ):
            raise EngineError(
                ErrorCode.NO_SPACE_LEFT_ON_DEVICE,
                "Meilisearch cannot receive write operations because the"
                " limit of the task database has been reached. Please delete"
                " tasks to continue performing write operations.",
            )
        with self.wake:
            task = self.queue.register(task_type, index_uid, details, content)
            if self.journal is not None:
                # fsync the registration BEFORE the route acks 202: an
                # acknowledged task survives kill -9 (reference lib.rs:772
                # registers into LMDB within a committed wtxn)
                self.journal.log_register(task)
            if task_type == TaskType.TASK_CANCELATION:
                # cooperative abort of the in-flight batch when the
                # cancelation matches a processing task (reference
                # must_stop_processing.rs)
                try:
                    matched = self.queue.filtered(
                        **(content or {}).get("filters", {})
                    )
                    if any(
                        t.status == TaskStatus.PROCESSING for t in matched
                    ):
                        self._abort_requested_by = task.uid
                        self._must_stop.set()
                except Exception:
                    pass
            self.wake.notify_all()
            return task

    def cleanup_task_queue(self) -> int:
        """Deletes the oldest finished tasks when the queue is at capacity
        (reference queue/mod.rs:289 cleanup_task_queue)."""
        with self.lock:
            if len(self.queue.tasks) < self.max_number_of_tasks:
                return 0
            finished = sorted(
                uid
                for uid, t in self.queue.tasks.items()
                if t.status
                in (TaskStatus.SUCCEEDED, TaskStatus.FAILED, TaskStatus.CANCELED)
            )
            for uid in finished[:100_000]:
                del self.queue.tasks[uid]
            return len(finished[:100_000])

    def _setup_loaded_store(self, store) -> None:
        """Per-store wiring applied after any (re)load from a packed
        directory — deferred boot restore or post-eviction reload."""
        store.dynamic_rules = self.dsr
        if self.network.get("shards") and store.shard_topology is None:
            store.set_shard_topology(sorted(self.network["shards"]))
        # the packed-v3 open is O(1); warm the host query caches (vocab
        # pack, scorer tables) and the device off the serving path
        threading.Thread(
            target=_host_warm, args=([store],), daemon=True
        ).start()
        self._kick_device_warm([store])

    def _kick_device_warm(self, stores) -> None:
        """Start `_device_warm(stores)` on a thread `wait_device_warm` joins."""
        stores = [s for s in stores if s.device is not None]
        if not stores:
            return
        th = threading.Thread(
            target=_device_warm, args=(stores,), name="device-warm", daemon=True
        )
        with self.lock:
            self._warm_threads = [t for t in self._warm_threads if t.is_alive()]
            self._warm_threads.append(th)
        th.start()

    def wait_device_warm(self, timeout: float = 60.0) -> bool:
        """Wait until the batch in progress, if any, has started its device
        warm-up and every warm-up started so far has ended. Returns False
        when `timeout` seconds pass first. After `wait_for_task` of a write
        this returns once that write's warm-up is done."""
        import time

        deadline = time.monotonic() + timeout
        with self.wake:
            while self._in_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self.wake.wait(left)
            threads = list(self._warm_threads)
        for th in threads:
            th.join(max(0.0, deadline - time.monotonic()))
        return not any(th.is_alive() for th in threads)

    def index(self, uid: str) -> IndexStore:
        with self.lock:
            store = self.indexes.get(uid)
            if store is None:
                raise EngineError(
                    ErrorCode.INDEX_NOT_FOUND, f"Index `{uid}` not found."
                )
            return store

    def index_exists(self, uid: str) -> bool:
        with self.lock:
            return uid in self.indexes

    def list_indexes(self) -> list[IndexStore]:
        with self.lock:
            return sorted(self.indexes.values(), key=lambda s: s.uid)

    def boot_warm_sync(self) -> float:
        """Synchronous boot warm (--experimental-boot-warm-sync): the host
        query caches of every loaded index are built before the caller
        opens the serving socket. The device half of the boot warm-up is
        the App's (`App.warm_devices`). Returns the wall seconds spent;
        never raises."""
        import time as _t

        t0 = _t.monotonic()
        _host_warm(self.list_indexes())
        return _t.monotonic() - t0

    def wait_for_task(self, uid: int, timeout: float = 30.0) -> Task:
        import time

        deadline = time.time() + timeout
        while time.time() < deadline:
            with self.lock:
                task = self.queue.tasks.get(uid)
                if task and task.status in (
                    TaskStatus.SUCCEEDED,
                    TaskStatus.FAILED,
                    TaskStatus.CANCELED,
                ):
                    return task
            with self.wake:
                self.wake.wait(0.02)
        raise TimeoutError(f"task {uid} did not finish")

    def wait_for_all_tasks(self, timeout: float = 60.0) -> None:
        import time

        deadline = time.time() + timeout
        while time.time() < deadline:
            with self.lock:
                pending = [
                    t
                    for t in self.queue.tasks.values()
                    if t.status in (TaskStatus.ENQUEUED, TaskStatus.PROCESSING)
                ]
                if not pending:
                    return
            with self.wake:
                self.wake.wait(0.02)
        raise TimeoutError("tasks did not drain")

    def stop(self):
        with self.wake:
            self._stop = True
            self.wake.notify_all()
        self._thread.join(timeout=2)

    # ------------------------------------------------------------------
    # durability checkpoints

    def checkpoint(self) -> None:
        """Snapshot the instance to the db path and rotate the journal.

        Registrations pause for the duration (we hold the scheduler lock),
        mirroring the reference's single-writer snapshot semantics; the
        journal rotation carries every still-unfinished task so its payload
        stays replayable."""
        if self.journal is None:
            return
        from .dumps import create_packed_checkpoint
        from .journal import TERMINAL

        # packed columnar format: boot restore slices mmap'd arrays back
        # into postings instead of re-indexing (index/packed.py)
        tasks_snapshot = create_packed_checkpoint(self, self.journal.db_path)
        terminal_uids = {
            int(t["uid"])
            for t in tasks_snapshot
            if TaskStatus(t.get("status", "enqueued")) in TERMINAL
        }
        with self.lock:
            # carry tasks by the SNAPSHOT's view: anything that finished
            # after it must replay against the checkpointed state
            unfinished = [
                t
                for t in self.queue.tasks.values()
                if t.uid not in terminal_uids
            ]
            self.journal.rotate(carry_tasks=unfinished)

    def _maybe_checkpoint(self) -> None:
        """Size-triggered checkpoint after a batch: keeps the journal (and
        boot replay time) bounded without waiting for a scheduled
        snapshot."""
        j = self.journal
        if j is None:
            return
        try:
            if j.size() > j.max_bytes:
                self.checkpoint()
        except Exception:
            pass  # a failed checkpoint must never take down the run loop

    # ------------------------------------------------------------------
    # the run loop

    def _run(self):
        while True:
            with self.wake:
                if self._stop:
                    return
                try:
                    self.cleanup_task_queue()
                    batch_tasks = self._create_next_batch()
                except Exception:
                    # unrecoverable scheduling error: fail every enqueued task
                    # instead of dying (the reference backs off and retries,
                    # lib.rs:505; failing keeps the loop deterministic here)
                    tb = traceback.format_exc()
                    for task in self._enqueued():
                        task.status = TaskStatus.FAILED
                        task.error = {
                            "message": tb.splitlines()[-1],
                            "code": "internal",
                            "type": "internal",
                            "link": "https://docs.meilisearch.com/errors#internal",
                        }
                        task.finished_at = now_iso()
                        if self.journal is not None:
                            self.journal.log_finish(task)
                    self.wake.notify_all()
                    continue
                if not batch_tasks:
                    self.wake.wait(0.1)
                    continue
            try:
                self._process_batch(batch_tasks)
            except Exception:  # the catch_unwind twin
                tb = traceback.format_exc()
                with self.lock:
                    for task in batch_tasks:
                        if task.status == TaskStatus.PROCESSING:
                            task.status = TaskStatus.FAILED
                            task.error = {
                                "message": f"An unexpected crash occurred when processing the task: {tb.splitlines()[-1]}",
                                "code": "internal",
                                "type": "internal",
                                "link": "https://docs.meilisearch.com/errors#internal",
                            }
                            task.finished_at = now_iso()
                            if self.journal is not None:
                                self.journal.log_finish(task)
            self._maybe_checkpoint()
            with self.wake:
                self._in_batch = False
                self.wake.notify_all()

    def _enqueued(self) -> list[Task]:
        return sorted(
            (
                t
                for t in self.queue.tasks.values()
                if t.status == TaskStatus.ENQUEUED
            ),
            key=lambda t: t.uid,
        )

    def _create_next_batch(self) -> list[Task]:
        """Reference: scheduler/create_batch.rs:524 create_next_batch."""
        enqueued = self._enqueued()
        if not enqueued:
            return []
        # global priorities
        for task_type in (
            TaskType.TASK_CANCELATION,
            TaskType.TASK_DELETION,
            TaskType.SNAPSHOT_CREATION,
            TaskType.DUMP_CREATION,
            TaskType.UPGRADE_DATABASE,
            TaskType.EXPORT,
            TaskType.NETWORK_TOPOLOGY_CHANGE,
        ):
            matching = [t for t in enqueued if t.type == task_type]
            if matching:
                if task_type in (TaskType.TASK_CANCELATION,):
                    return [matching[0]]
                return matching if task_type == TaskType.TASK_DELETION else [matching[0]]
        # index swap is standalone
        swaps = [t for t in enqueued if t.type == TaskType.INDEX_SWAP]
        if swaps:
            return [swaps[0]]
        # index tasks: take the first enqueued task's index, batch its tasks
        first = enqueued[0]
        if not self.autobatching_enabled:
            return [first]
        return self._autobatch(
            [t for t in enqueued if t.index_uid == first.index_uid]
        )

    def _autobatch(self, tasks: list[Task]) -> list[Task]:
        """Merge consecutive compatible tasks on one index
        (reference: scheduler/autobatcher.rs BatchKind::accumulate;
        `max_batched_tasks` = --experimental-max-number-of-batched-tasks,
        option.rs:471)."""
        if not tasks:
            return []
        limit = getattr(self, "max_batched_tasks", None)
        if limit:
            tasks = tasks[:limit]
        batch = [tasks[0]]
        kind = tasks[0].type
        if kind in (
            TaskType.INDEX_CREATION,
            TaskType.INDEX_UPDATE,
            TaskType.INDEX_DELETION,
            TaskType.INDEX_COMPACTION,
            TaskType.DOCUMENT_EDITION,
        ):
            return batch
        method = (tasks[0].content or {}).get("method")
        for task in tasks[1:]:
            if kind == TaskType.DOCUMENT_ADDITION_OR_UPDATE:
                if (
                    task.type == TaskType.DOCUMENT_ADDITION_OR_UPDATE
                    and (task.content or {}).get("method") == method
                ):
                    batch.append(task)
                    continue
                break
            if kind == TaskType.DOCUMENT_DELETION:
                if task.type == TaskType.DOCUMENT_DELETION:
                    batch.append(task)
                    continue
                break
            if kind == TaskType.SETTINGS_UPDATE:
                if task.type == TaskType.SETTINGS_UPDATE:
                    batch.append(task)
                    continue
                break
            break
        return batch

    def _process_network_topology_change(self, content) -> tuple[int, int]:
        """Move documents to their new owning shard's remotes after a
        topology change, then drop the local copies (reference:
        scheduler/enterprise_edition/network.rs:680 NetworkTopologyChange;
        exports carry an Origin header so receivers record provenance,
        tasks/network.rs Origin). Documents export BEFORE local deletion:
        a failed push fails the task and leaves the copy — the federated
        dual-query window (previousShards) keeps them findable."""
        import json as _json
        import urllib.request

        from ..parallel.rendezvous import rendezvous_shard
        from ..utils.http_policy import guarded_urlopen

        with self.lock:
            net = self.network
            shards = {k: dict(v) for k, v in (net.get("shards") or {}).items()}
            remotes = {k: dict(v) for k, v in (net.get("remotes") or {}).items()}
            self_name = net.get("self")
            stores = list(self.indexes.values())
        new_topo = sorted(shards)

        def serves(shard_name) -> bool:
            ent = shards.get(shard_name) or {}
            r = ent.get("remotes") or []
            return not r or self_name is None or self_name in r

        moved = deleted = 0
        for store in stores:
            to_remote: dict[str, list] = {}
            to_delete: list[str] = []
            with store._lock:
                items = list(store.external_to_internal.items())
                for ext, docid in items:
                    if not new_topo:
                        continue
                    new_shard = rendezvous_shard(ext, new_topo)
                    if serves(new_shard):
                        continue
                    doc = store.documents.get(docid)
                    if doc is None:
                        continue
                    for rname in (shards.get(new_shard) or {}).get(
                        "remotes"
                    ) or []:
                        if rname == self_name:
                            continue
                        to_remote.setdefault(rname, []).append(doc)
                    to_delete.append(ext)
            for rname, docs in to_remote.items():
                remote = remotes.get(rname)
                if remote is None or not remote.get("url"):
                    raise EngineError(
                        ErrorCode.BAD_REQUEST,
                        f"Cannot move documents to shard remote `{rname}`:"
                        " remote is not registered with a URL.",
                    )
                url = remote["url"].rstrip("/")
                api_key = remote.get("writeApiKey") or remote.get(
                    "searchApiKey"
                )
                for i in range(0, len(docs), 1000):
                    data = _json.dumps(docs[i : i + 1000]).encode("utf-8")
                    push = urllib.request.Request(
                        f"{url}/indexes/{store.uid}/documents",
                        data=data,
                        method="POST",
                        headers={
                            "Content-Type": "application/json",
                            # reference tasks/network.rs Origin metadata
                            "Meili-Task-Origin": self_name or "reshard",
                        },
                    )
                    if api_key:
                        push.add_header("Authorization", f"Bearer {api_key}")
                    with guarded_urlopen(push, timeout=30):
                        pass
                moved += len(docs)
            if to_delete:
                deleted += store.delete_documents(to_delete)
        return moved, deleted

    # ------------------------------------------------------------------
    # batch processing

    def _breakpoint(self, stage: str):
        if self.breakpoint_hook is not None:
            self.breakpoint_hook(stage)
        if stage in self.failure_locations:
            raise RuntimeError(f"planned failure at `{stage}`")

    def _process_batch(self, tasks: list[Task]):
        self._breakpoint("batch_created")
        batch = self.queue.new_batch()
        batch.started_at = now_iso()
        batch.progress = {"steps": [{"currentStep": "processing tasks",
                                     "finished": 0, "total": len(tasks)}],
                          "percentage": 0.0}
        with self.lock:
            self._in_batch = True
            for task in tasks:
                task.status = TaskStatus.PROCESSING
                task.started_at = batch.started_at
                task.batch_uid = batch.uid
                batch.task_uids.append(task.uid)

        from ..index.store import AbortedProcessing

        self._must_stop.clear()
        # a homogeneous document-addition batch commits through ONE bulk
        # scope: runs merge + generation bumps once at batch end, like the
        # reference's autobatched tasks sharing a single wtxn
        # (index-scheduler/src/scheduler/process_batch.rs)
        from contextlib import ExitStack

        with ExitStack() as bulk_scope:
            uids = {t.index_uid for t in tasks}
            if (
                len(tasks) > 1
                and len(uids) == 1
                and all(
                    t.type == TaskType.DOCUMENT_ADDITION_OR_UPDATE
                    for t in tasks
                )
                # small autobatches stay on the per-task minor-write path
                # (delta overlay keeps the device arena anchored); only a
                # genuine bulk load is worth one deferred major commit
                and sum(
                    len((t.content or {}).get("documents") or ())
                    for t in tasks
                )
                > 10_000
            ):
                try:
                    bulk_scope.enter_context(
                        self._get_or_create_index(next(iter(uids))).bulk()
                    )
                except Exception:
                    pass
            outcomes = self._run_batch_tasks(tasks, batch)
        # the bulk scope has committed the batch (its runs merged, the
        # generation bumped): only now do its tasks read finished, so a
        # caller that waited for one sees its write, and the warm-up below
        # runs at the generation searches will read
        self._finish_tasks(tasks, outcomes)
        batch.finished_at = now_iso()
        batch.progress = None  # progress views only exist while processing
        # build-side memory budget (reference BalancedCaches spill,
        # update/new/extract/cache.rs): past the budget, posting docids
        # re-serialize as mmap'd columns — RSS becomes evictable page
        # cache and corpus-size ingest stops being RAM-bound
        spill_budget = int(
            os.environ.get("MEILI_TPU_BUILD_SPILL_BYTES", "0") or 0
        )
        if spill_budget > 0:
            from .index_map import estimate_store_bytes

            for uid in {t.index_uid for t in tasks if t.index_uid}:
                store = self.indexes.get(uid)
                if store is None or not store.documents:
                    continue
                if estimate_store_bytes(store) > spill_budget:
                    import tempfile

                    base = self.journal.db_path if self.journal else None
                    directory = os.path.join(
                        base or tempfile.gettempdir(), "spill", uid
                    )
                    try:
                        moved = store.spill_postings(directory)
                        if moved:
                            log.info(
                                "spilled %d MB of postings for `%s`",
                                moved >> 20,
                                uid,
                            )
                    except Exception:
                        pass
        # warm the device of every index this batch wrote, off the serving
        # path, except an index with more tasks queued (the JAX package's
        # rule: that warm-up would be outgrown at once and would compete
        # with the ingest)
        with self.lock:
            pending = {t.index_uid for t in self._enqueued() if t.index_uid}
        warm = []
        for uid in sorted({t.index_uid for t in tasks if t.index_uid} - pending):
            store = self.indexes.get(uid)
            if store is not None and store.documents:
                warm.append(store)
        self._kick_device_warm(warm)
        self._breakpoint("batch_processed")
        statuses: dict[str, int] = {}
        types: dict[str, int] = {}
        index_uids: dict[str, int] = {}
        for task in tasks:
            statuses[task.status.value] = statuses.get(task.status.value, 0) + 1
            types[task.type.value] = types.get(task.type.value, 0) + 1
            if task.index_uid:
                index_uids[task.index_uid] = index_uids.get(task.index_uid, 0) + 1
            for k, v in (task.details or {}).items():
                batch.details.setdefault(k, v)
        batch.stats = {
            "totalNbTasks": len(tasks),
            "status": statuses,
            "types": types,
            "indexUids": index_uids,
        }

    def _get_or_create_index(self, uid: str, primary_key=None) -> IndexStore:
        with self.lock:
            store = self.indexes.get(uid)
            if store is None:
                store = IndexStore(uid, primary_key=primary_key)
                store.dynamic_rules = self.dsr
                if self.network["shards"]:
                    store.set_shard_topology(sorted(self.network["shards"]))
                self.indexes[uid] = store
            elif primary_key and store.primary_key is None:
                store.primary_key = primary_key
            return store

    def _run_batch_tasks(self, tasks: list[Task], batch) -> list:
        """Process each task of the batch; returns each one's outcome
        (its status and the fields that go with it), which `_finish_tasks`
        publishes once the batch has committed."""
        from ..index.store import AbortedProcessing

        outcomes = []
        for i, task in enumerate(tasks):
            try:
                if self._must_stop.is_set():
                    raise AbortedProcessing()
                self._breakpoint("inside_process_batch")
                self._process_task(task)
                outcomes.append((TaskStatus.SUCCEEDED, {}))
                batch.progress["steps"][0]["finished"] = i + 1
                batch.progress["percentage"] = 100.0 * (i + 1) / len(tasks)
            except AbortedProcessing:
                outcomes.append((TaskStatus.CANCELED, {"canceled_by": self._abort_requested_by}))
            except EngineError as err:
                outcomes.append((TaskStatus.FAILED, {"error": err.to_json()}))
            except Exception as err:  # unexpected
                outcomes.append((TaskStatus.FAILED, {"error": {
                    "message": str(err),
                    "code": "internal",
                    "type": "internal",
                    "link": "https://docs.meilisearch.com/errors#internal",
                }}))
        return outcomes

    def _finish_tasks(self, tasks: list[Task], outcomes: list) -> None:
        """Publish each task's outcome: its status, journal entry, callback
        and webhooks."""
        for task, (status, fields) in zip(tasks, outcomes):
            task.status = status
            for name, value in fields.items():
                setattr(task, name, value)
            task.finished_at = now_iso()
            if self.journal is not None:
                self.journal.log_finish(task)
            if self.on_task_finished:
                try:
                    self.on_task_finished(task)
                except Exception:
                    pass
            self._notify_webhooks(task)

    def _process_task(self, task: Task):
        t = task.type
        content = task.content or {}
        if t == TaskType.INDEX_CREATION:
            with self.lock:
                if task.index_uid in self.indexes:
                    raise EngineError(
                        ErrorCode.INDEX_ALREADY_EXISTS,
                        f"Index `{task.index_uid}` already exists.",
                    )
                store = IndexStore(
                    task.index_uid, primary_key=content.get("primaryKey")
                )
                store.dynamic_rules = self.dsr
                if self.network["shards"]:
                    store.set_shard_topology(sorted(self.network["shards"]))
                self.indexes[task.index_uid] = store
            task.details = {"primaryKey": content.get("primaryKey")}
        elif t == TaskType.INDEX_UPDATE:
            store = self.index(task.index_uid)
            pk = content.get("primaryKey")
            if pk is not None:
                if store.documents and store.primary_key and store.primary_key != pk:
                    raise EngineError(
                        ErrorCode.INVALID_STATE,
                        f"Index `{store.uid}`: Index already has a primary key:"
                        f" `{store.primary_key}`.",
                    )
                store.primary_key = pk
            task.details = {"primaryKey": pk}
        elif t == TaskType.INDEX_DELETION:
            with self.lock:
                store = self.indexes.pop(task.index_uid, None)
            if store is None:
                raise EngineError(
                    ErrorCode.INDEX_NOT_FOUND,
                    f"Index `{task.index_uid}` not found.",
                )
            task.details = {"deletedDocuments": len(store.documents)}
        elif t == TaskType.INDEX_SWAP:
            swaps = content.get("swaps", [])
            with self.lock:
                for swap in swaps:
                    a, b = swap["indexes"]
                    if a not in self.indexes or b not in self.indexes:
                        missing = [u for u in (a, b) if u not in self.indexes]
                        raise EngineError(
                            ErrorCode.INDEX_NOT_FOUND,
                            f"Indexes `{', '.join(missing)}` not found.",
                        )
                    sa, sb = self.indexes[a], self.indexes[b]
                    sa.uid, sb.uid = b, a
                    self.indexes[a], self.indexes[b] = sb, sa
                    # swap task history (reference: swap_index_uid_in_task)
                    for other in self.queue.tasks.values():
                        if other.uid == task.uid:
                            continue
                        if other.index_uid == a:
                            other.index_uid = b
                        elif other.index_uid == b:
                            other.index_uid = a
            task.details = {"swaps": swaps}
        elif t == TaskType.DOCUMENT_ADDITION_OR_UPDATE:
            store = self._get_or_create_index(
                task.index_uid, content.get("primaryKey")
            )
            if content.get("primaryKey") and store.primary_key and content[
                "primaryKey"
            ] != store.primary_key and store.documents:
                raise EngineError(
                    ErrorCode.INVALID_STATE,
                    f"Index `{store.uid}`: Index already has a primary key:"
                    f" `{store.primary_key}`.",
                )
            if content.get("primaryKey") and not store.documents:
                store.primary_key = content["primaryKey"]
            docs = content.get("documents", [])
            method = content.get("method", "replace")
            received, indexed = store.add_documents(
                docs, method=method, must_stop=self._must_stop
            )
            from ..vector.embedders import ensure_document_embeddings

            ensure_document_embeddings(store)
            task.details = {
                "receivedDocuments": task.details.get(
                    "receivedDocuments", received
                ),
                "indexedDocuments": indexed,
            }
        elif t == TaskType.DOCUMENT_DELETION:
            store = self._get_or_create_index(task.index_uid)
            if "filter" in content and content["filter"] is not None:
                from ..search.filters import evaluate_filter

                docids = evaluate_filter(
                    store,
                    content["filter"],
                    code=ErrorCode.INVALID_DOCUMENT_FILTER,
                )
                external = [
                    store.internal_to_external[d]
                    for d in (docids or set())
                    if d in store.internal_to_external
                ]
                deleted = store.delete_documents(external)
                task.details = {
                    "originalFilter": str(content["filter"]),
                    "deletedDocuments": deleted,
                }
            elif content.get("clear_all"):
                deleted = store.delete_all_documents()
                task.details = {"deletedDocuments": deleted}
            else:
                ids = [str(i) for i in content.get("ids", [])]
                deleted = store.delete_documents(ids)
                task.details = {
                    "providedIds": len(ids),
                    "deletedDocuments": deleted,
                }
        elif t == TaskType.SETTINGS_UPDATE:
            if content.get("is_deletion"):
                # a settings reset/delete never creates the index
                # (reference: error_delete_settings_unexisting_index fails)
                store = self.index(task.index_uid)
            else:
                store = self._get_or_create_index(task.index_uid)
            patch = content.get("settings", {})
            with store._lock:  # readers never see a half-applied patch
                changed = store.settings.apply_json(patch)
                if changed & REINDEX_SETTINGS and store.documents:
                    store.reindex()
                else:
                    store._bump()
            if "embedders" in changed and store.documents:
                # a new/changed embedder (re)embeds existing documents
                # (reference: update/settings.rs EmbedderAction)
                from ..vector.embedders import ensure_document_embeddings

                ensure_document_embeddings(store)
            det = dict(patch)
            det.pop("is_deletion", None)
            if isinstance(det.get("embedders"), dict):
                from ..types.settings import masked_embedders

                det["embedders"] = masked_embedders(det["embedders"])
            task.details = det
        elif t == TaskType.TASK_CANCELATION:
            query = content.get("query", "")
            filters = content.get("filters", {})
            with self.lock:
                matched = self.queue.filtered(**filters)
                canceled = 0
                for other in matched:
                    if other.uid == task.uid:
                        continue
                    if other.status in (TaskStatus.ENQUEUED, TaskStatus.PROCESSING):
                        other.status = TaskStatus.CANCELED
                        other.canceled_by = task.uid
                        other.finished_at = now_iso()
                        canceled += 1
                task.details = {
                    "matchedTasks": len([m for m in matched if m.uid != task.uid]),
                    "canceledTasks": canceled,
                    "originalFilter": query,
                }
        elif t == TaskType.TASK_DELETION:
            query = content.get("query", "")
            filters = content.get("filters", {})
            with self.lock:
                matched = self.queue.filtered(**filters)
                deleted = 0
                for other in matched:
                    if other.uid == task.uid:
                        continue
                    if other.status in (
                        TaskStatus.SUCCEEDED,
                        TaskStatus.FAILED,
                        TaskStatus.CANCELED,
                    ):
                        del self.queue.tasks[other.uid]
                        deleted += 1
                task.details = {
                    "matchedTasks": len([m for m in matched if m.uid != task.uid]),
                    "deletedTasks": deleted,
                    "originalFilter": query,
                }
        elif t == TaskType.DUMP_CREATION:
            from .dumps import create_dump

            path = create_dump(
                self, content.get("path"), auth=getattr(self, "auth_ref", None)
            )
            task.details = {"dumpUid": path}
        elif t == TaskType.SNAPSHOT_CREATION:
            from .dumps import create_snapshot

            snap_path = create_snapshot(self, content.get("path"))
            task.details = {}
            if getattr(self, "s3_opts", None) is not None:
                # EE parity: scheduler/enterprise_edition/s3.rs
                # process_snapshot_to_s3 — the snapshot lands in the
                # bucket as {prefix}/data.ms.snapshot
                from .s3_snapshot import upload_snapshot_to_s3

                key = upload_snapshot_to_s3(snap_path, self.s3_opts)
                task.details = {"s3Object": key}
        elif t == TaskType.NETWORK_TOPOLOGY_CHANGE:
            moved, deleted = self._process_network_topology_change(content)
            task.details = {
                "movedDocuments": moved,
                "deletedDocuments": deleted,
            }
            with self.lock:
                # standalone (no leader): the local move IS the whole
                # reshard, so the dual-query window closes on success. With
                # a leader, the window closes when the leader confirms the
                # cluster-wide completion (PATCH /network previousShards:
                # null); a failed move keeps previousShards either way so
                # federated queries still reach the yet-unmoved documents
                if self.network.get("leader") is None:
                    self.network.pop("previousShards", None)
        elif t == TaskType.EXPORT:
            # push settings + documents to a remote instance
            # (reference: scheduler/process_export.rs)
            import json as _json
            import urllib.request

            from ..utils.http_policy import guarded_urlopen

            url = content["url"].rstrip("/")
            api_key = content.get("apiKey")
            patterns = content.get("indexes") or {"*": {}}

            def _post(path, payload, method="POST"):
                data = _json.dumps(payload).encode("utf-8")
                req = urllib.request.Request(
                    url + path, data=data, method=method,
                    headers={"Content-Type": "application/json"},
                )
                if api_key:
                    req.add_header("Authorization", f"Bearer {api_key}")
                with guarded_urlopen(req, timeout=30) as resp:
                    return _json.loads(resp.read().decode("utf-8"))

            exported = 0
            with self.lock:
                stores = list(self.indexes.values())
            for store in stores:
                spec = None
                for pattern, pspec in patterns.items():
                    if pattern == "*" or store.uid == pattern or (
                        pattern.endswith("*")
                        and store.uid.startswith(pattern[:-1])
                    ):
                        spec = pspec or {}
                        break
                if spec is None:
                    continue
                _post(f"/indexes/{store.uid}/settings", store.settings.to_json(), "PATCH")
                docs = [store.documents[d] for d in sorted(store.documents)]
                if spec.get("filter"):
                    from ..search.filters import evaluate_filter

                    allowed = evaluate_filter(store, spec["filter"])
                    docs = [
                        store.documents[d]
                        for d in sorted(store.documents)
                        if d in allowed
                    ]
                for i in range(0, len(docs), 1000):
                    _post(f"/indexes/{store.uid}/documents", docs[i : i + 1000])
                exported += len(docs)
            task.details = {
                "url": content["url"],
                "indexes": patterns,
                "exportedDocuments": exported,
            }
        elif t == TaskType.DSR_UPDATE:
            rule = self.dsr.update_or_create(content["uid"], content.get("patch", {}))
            task.details = {"ruleUid": content["uid"], "active": rule.get("active")}
        elif t == TaskType.DSR_DELETION:
            self.dsr.delete(content["uid"])
            task.details = {"ruleUid": content["uid"]}
        elif t == TaskType.DSR_CLEAR:
            n = len(self.dsr.rules)
            self.dsr.rules.clear()
            task.details = {"deletedRules": n}
        elif t == TaskType.UPGRADE_DATABASE:
            # the live instance is always current-format (migrations run at
            # snapshot load); the upgrade task re-checkpoints the on-disk
            # snapshot at the current format version (reference:
            # index-scheduler/src/upgrade/ + process_upgrade.rs)
            from .versioning import SNAPSHOT_FORMAT_VERSION

            self.checkpoint()
            task.details = {
                "upgradeFrom": content.get("from"),
                "upgradeTo": f"v{SNAPSHOT_FORMAT_VERSION}",
            }
        elif t == TaskType.INDEX_COMPACTION:
            store = self.index(task.index_uid)
            pre, post = store.compact()
            task.details = {
                "preCompactionSize": pre,
                "postCompactionSize": post,
            }
        elif t == TaskType.DOCUMENT_EDITION:
            store = self.index(task.index_uid)
            if not self.runtime_features.get("editDocumentsByFunction"):
                raise EngineError(
                    ErrorCode.FEATURE_NOT_ENABLED,
                    "Modifying documents with a function requires enabling the"
                    " `edit documents by function` experimental feature. See"
                    " https://github.com/orgs/meilisearch/discussions/762",
                )
            from .edit_function import edit_documents_by_function

            edited, matched = edit_documents_by_function(
                store,
                content.get("function", ""),
                content.get("filter"),
                content.get("context"),
            )
            task.details = {
                "deletedDocuments": 0,
                "editedDocuments": edited,
                "originalFilter": str(content.get("filter"))
                if content.get("filter")
                else None,
                "context": content.get("context"),
                "function": content.get("function", ""),
            }
        else:
            raise AssertionError(t)

    def _notify_webhooks(self, task: Task):
        """POST the gzip'd task view (NDJSON) to every registered webhook
        (reference: index-scheduler webhook notification in utils.rs)."""
        if not self.webhooks:
            return
        import gzip
        import json as _json
        import urllib.request

        from ..utils.http_policy import guarded_urlopen

        payload = gzip.compress(
            (_json.dumps(task.to_json()) + "\n").encode("utf-8")
        )
        for hook in list(self.webhooks.values()):
            try:
                req = urllib.request.Request(
                    hook["url"],
                    data=payload,
                    headers={
                        "Content-Type": "application/x-ndjson",
                        "Content-Encoding": "gzip",
                        **(hook.get("headers") or {}),
                    },
                )
                guarded_urlopen(req, timeout=5)
            except Exception:
                pass  # webhook failures never fail tasks

    # ------------------------------------------------------------------

    def stats(self) -> dict:
        with self.lock:
            indexes = {
                uid: store.stats() for uid, store in self.indexes.items()
            }
            return {
                "databaseSize": sum(
                    s.documents.approx_bytes() for s in self.indexes.values()
                ),
                "usedDatabaseSize": 0,
                "lastUpdate": max(
                    (
                        t.finished_at
                        for t in self.queue.tasks.values()
                        if t.finished_at
                    ),
                    default=None,
                ),
                "indexes": indexes,
            }
