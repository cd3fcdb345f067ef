"""Dumps and snapshots.

Reference: crates/dump (logical, version-independent export: metadata, keys,
tasks, per-index settings + documents) and
index-scheduler/src/scheduler/process_snapshot_creation.rs (physical copy).

Both serialize to a single archive; dumps can be re-imported across versions.
"""

from __future__ import annotations

import gzip
import json
import os
import tarfile
import tempfile
import time
from datetime import datetime, timezone
from io import BytesIO
from typing import Optional

DUMP_VERSION = "V6"


def _dump_uid() -> str:
    return datetime.now(timezone.utc).strftime("%Y%m%d-%H%M%S%f")[:-3]


def serialize_instance(scheduler) -> dict:
    """Logical export of the whole instance."""
    indexes = {}
    with scheduler.lock:
        for uid, store in scheduler.indexes.items():
            vectors_meta = {}
            for emb, per_doc in store.vectors.items():
                vectors_meta[emb] = {
                    str(docid): arr.tolist() for docid, arr in per_doc.items()
                }
            indexes[uid] = {
                "uid": uid,
                "primaryKey": store.primary_key,
                "createdAt": store.created_at,
                "updatedAt": store.updated_at,
                "settings": store.settings.to_json(),
                "documents": [
                    store.documents[d]
                    for d in sorted(store.documents.keys())
                ],
            }
        tasks = [t.to_json() for t in scheduler.queue.tasks.values()]
    from .versioning import SNAPSHOT_FORMAT_VERSION

    return {
        "dumpVersion": DUMP_VERSION,
        "dbVersion": "1.50.0-tpu",
        "formatVersion": SNAPSHOT_FORMAT_VERSION,
        "engineVersion": _engine_version(),
        "dumpDate": time.time(),
        "indexes": indexes,
        "tasks": tasks,
        "network": scheduler.network,
        "features": scheduler.runtime_features,
        # reference persists both in the scheduler env (features.rs,
        # routes/webhooks.rs; DSR rules in milli dynamic_search_rules.rs)
        "dynamicSearchRules": dict(scheduler.dsr.rules),
        "webhooks": dict(scheduler.webhooks),
    }


def _engine_version() -> str:
    from .. import __version__

    return __version__


def _tar_add_bytes(tar, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, BytesIO(data))


def create_dump(scheduler, path: Optional[str] = None, auth=None) -> str:
    """Write a dump in the reference's V6 archive layout
    (crates/dump/README.md: metadata.json, instance_uid.uuid, keys.jsonl,
    tasks/queue.jsonl, batches/queue.jsonl, indexes/{uid}/{metadata.json,
    documents.jsonl, settings.json}) — importable by the reference and
    vice versa."""
    uid = _dump_uid()
    directory = path or os.path.join(tempfile.gettempdir(), "meili_tpu_dumps")
    os.makedirs(directory, exist_ok=True)
    file_path = os.path.join(directory, f"{uid}.dump")

    def rfc3339(ts: float) -> str:
        return (
            datetime.fromtimestamp(ts, tz=timezone.utc)
            .isoformat()
            .replace("+00:00", "Z")
        )

    with scheduler.lock:
        with tarfile.open(file_path, "w:gz") as tar:
            metadata = {
                "dumpVersion": "V6",
                "dbVersion": "1.50.0",
                "dumpDate": rfc3339(time.time()),
            }
            _tar_add_bytes(
                tar, "metadata.json", json.dumps(metadata).encode("utf-8")
            )
            _tar_add_bytes(
                tar,
                "instance_uid.uuid",
                getattr(scheduler, "instance_uid", "00000000-0000-0000-0000-000000000000").encode(),
            )
            keys_lines = b""
            if auth is not None:
                keys_lines = b"".join(
                    (json.dumps(k.to_json()) + "\n").encode("utf-8")
                    for k in auth.list_keys()
                )
            _tar_add_bytes(tar, "keys.jsonl", keys_lines)
            tasks_lines = b"".join(
                (json.dumps(t.to_json()) + "\n").encode("utf-8")
                for t in scheduler.queue.tasks.values()
            )
            _tar_add_bytes(tar, "tasks/queue.jsonl", tasks_lines)
            batch_lines = b"".join(
                (json.dumps(b.to_json()) + "\n").encode("utf-8")
                for b in getattr(scheduler.queue, "batches", {}).values()
            )
            _tar_add_bytes(tar, "batches/queue.jsonl", batch_lines)
            for index_uid, store in scheduler.indexes.items():
                base = f"indexes/{index_uid}"
                meta = {
                    "uid": index_uid,
                    "primaryKey": store.primary_key,
                    "createdAt": rfc3339(store.created_at),
                    "updatedAt": rfc3339(store.updated_at),
                }
                _tar_add_bytes(
                    tar, f"{base}/metadata.json", json.dumps(meta).encode()
                )
                docs = BytesIO()
                for docid in sorted(store.documents):
                    doc = dict(store.documents[docid])
                    vectors = {}
                    for emb, per_doc in store.vectors.items():
                        if docid in per_doc:
                            vectors[emb] = {
                                "embeddings": per_doc[docid].tolist(),
                                "regenerate": store.vector_regenerate.get(
                                    emb, {}
                                ).get(docid, False),
                            }
                    if vectors:
                        doc["_vectors"] = vectors
                    docs.write((json.dumps(doc) + "\n").encode("utf-8"))
                _tar_add_bytes(tar, f"{base}/documents.jsonl", docs.getvalue())
                _tar_add_bytes(
                    tar,
                    f"{base}/settings.json",
                    json.dumps(store.settings.to_json()).encode("utf-8"),
                )
    return uid


def load_dump(scheduler, file_path: str, auth=None) -> None:
    """Import a dump: the reference's V6 tar.gz layout, or this engine's
    legacy gzip-JSON format."""
    if tarfile.is_tarfile(file_path):
        _load_v6_dump(scheduler, file_path, auth)
        return
    with gzip.open(file_path, "rb") as f:
        data = json.loads(f.read().decode("utf-8"))
    # dumps are version-independent: the migration chain always applies
    # (reference dump/src/reader compat shims v1..v6)
    from .versioning import check_and_migrate

    data = check_and_migrate(data, allow_upgrade=True)
    import_instance(scheduler, data)


def _load_v6_dump(scheduler, file_path: str, auth=None) -> None:
    from ..index.store import IndexStore

    with tarfile.open(file_path, "r:gz") as tar:
        names = tar.getnames()

        def read(name: str) -> Optional[bytes]:
            try:
                f = tar.extractfile(name)
            except KeyError:
                return None
            return f.read() if f is not None else None

        meta_raw = read("metadata.json")
        if meta_raw is None:
            raise ValueError("not a meilisearch dump: missing metadata.json")
        meta = json.loads(meta_raw)
        version = meta.get("dumpVersion")
        if version in ("V1", "V2", "V3", "V4", "V5"):
            # historical formats import through the compat readers
            # (reference: dump/src/reader/mod.rs:33 open() chains
            # V1Reader.to_v2()...to_v6(); here the per-version layouts
            # normalize straight to the current model)
            return _import_legacy_dump(
                scheduler, auth, read, names, version, meta
            )
        if version != "V6":
            raise ValueError(
                f"unsupported dump version `{version}`: V1-V6 dumps can be"
                " imported."
            )

        index_uids = sorted(
            {
                n.split("/")[1]
                for n in names
                if n.startswith("indexes/") and len(n.split("/")) >= 3
            }
        )
        with scheduler.lock:
            for index_uid in index_uids:
                imeta = json.loads(
                    read(f"indexes/{index_uid}/metadata.json") or b"{}"
                )
                store = IndexStore(
                    index_uid, primary_key=imeta.get("primaryKey")
                )
                settings_raw = read(f"indexes/{index_uid}/settings.json")
                if settings_raw:
                    settings = json.loads(settings_raw)
                    known = set(store.settings.to_json())
                    store.settings.apply_json(
                        {k: v for k, v in settings.items() if k in known}
                    )
                docs_raw = read(f"indexes/{index_uid}/documents.jsonl")
                if docs_raw:
                    docs = [
                        json.loads(line)
                        for line in docs_raw.decode("utf-8").splitlines()
                        if line.strip()
                    ]
                    if docs:
                        store.add_documents(docs)
                scheduler.indexes[index_uid] = store

        if auth is not None:
            keys_raw = read("keys.jsonl") or b""
            for line in keys_raw.decode("utf-8").splitlines():
                if not line.strip():
                    continue
                try:
                    body = json.loads(line)
                    if body.get("uid") in (k.uid for k in auth.list_keys()):
                        continue
                    auth.create_key(
                        {
                            k: v
                            for k, v in body.items()
                            if k in ("uid", "name", "description", "actions",
                                     "indexes", "expiresAt")
                        }
                    )
                except Exception:
                    continue  # key rows are best-effort (default keys exist)


_LEGACY_RULE_NAMES = {
    "typo": "typo",
    "words": "words",
    "proximity": "proximity",
    "attribute": "attribute",
    "attributeRank": "attributeRank",
    "wordsPosition": "wordPosition",  # v1/v2 name (v1/settings.rs:54)
    "wordPosition": "wordPosition",
    "exactness": "exactness",
    "sort": "sort",
}


def _normalize_legacy_rules(rules) -> list:
    """v1 `dsc(field)` / v2 `desc(field)` custom criteria become the
    modern `field:desc` form; unknown rules are skipped, as the reference
    compat chain does (compat/v1_to_v2.rs:121-130)."""
    import re

    out = []
    for r in rules or []:
        if not isinstance(r, str):
            continue
        m = re.fullmatch(r"(asc|desc|dsc)\(([\w.\-]+)\)", r.strip())
        if m:
            direction = "asc" if m.group(1) == "asc" else "desc"
            out.append(f"{m.group(2)}:{direction}")
        elif r in _LEGACY_RULE_NAMES:
            out.append(_LEGACY_RULE_NAMES[r])
        elif ":" in r:
            out.append(r)  # already modern field:asc/desc
    return out


def _snake_to_camel(k: str) -> str:
    parts = k.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def _normalize_legacy_settings(raw: dict) -> dict:
    """Map a v1-v5 settings object onto the current DTO: snake/camel keys
    unify, attributesForFaceting becomes filterableAttributes
    (compat/v2_to_v3.rs), ranking rules translate per
    _normalize_legacy_rules."""
    if not isinstance(raw, dict):
        return {}
    camel = {_snake_to_camel(k): v for k, v in raw.items()}
    out: dict = {}
    for key in (
        "displayedAttributes", "searchableAttributes", "stopWords",
        "synonyms", "distinctAttribute", "filterableAttributes",
        "sortableAttributes", "typoTolerance", "faceting", "pagination",
    ):
        if camel.get(key) is not None:
            out[key] = camel[key]
    faceted = camel.get("attributesForFaceting") or camel.get(
        "facetedAttributes"
    )
    if faceted and "filterableAttributes" not in out:
        out["filterableAttributes"] = (
            sorted(faceted) if isinstance(faceted, dict) else list(faceted)
        )
    if camel.get("rankingRules") is not None:
        rules = _normalize_legacy_rules(camel["rankingRules"])
        if rules:
            out["rankingRules"] = rules
    return out


def _import_legacy_dump(scheduler, auth, read, names, version, meta) -> None:
    """Readers for the V1-V5 dump layouts (reference dump/src/reader/v1-v5):

    V1: metadata.json `indexes: [{name, uid}]`; `<uid>/documents.jsonl`
        + `<uid>/settings.json`                       (v1/mod.rs:89-99)
    V2: `index_uuids/data.jsonl` {uid, uuid};
        `indexes/index-<uuid>/meta.json` + documents  (v2/mod.rs:72-111)
    V3: same, `indexes/<uuid>/`                       (v3/mod.rs:78-115)
    V4/V5: `index_uuids/data.jsonl` {uid, index_meta:{uuid}};
        `indexes/<uuid>/`; `keys` jsonl               (v4/mod.rs, v5/mod.rs)
    """
    from ..index.store import IndexStore

    entries: list[tuple[str, str, Optional[str]]] = []  # (uid, docs, meta)
    if version == "V1":
        for idx in meta.get("indexes", []):
            uid = idx.get("uid") or idx.get("name")
            if uid:
                entries.append(
                    (uid, f"{uid}/documents.jsonl", f"{uid}/settings.json")
                )
    else:
        uuids_raw = read("index_uuids/data.jsonl") or b""
        for line in uuids_raw.decode("utf-8").splitlines():
            if not line.strip():
                continue
            row = json.loads(line)
            uid = row.get("uid")
            uuid_ = row.get("uuid") or (row.get("index_meta") or {}).get(
                "uuid"
            )
            if not uid or not uuid_:
                continue
            base = (
                f"indexes/index-{uuid_}" if version == "V2"
                else f"indexes/{uuid_}"
            )
            entries.append(
                (uid, f"{base}/documents.jsonl", f"{base}/meta.json")
            )

    with scheduler.lock:
        for uid, docs_name, meta_name in entries:
            primary_key = None
            settings_json: dict = {}
            meta_raw = read(meta_name) if meta_name else None
            if meta_raw:
                imeta = json.loads(meta_raw)
                if version == "V1":
                    settings_json = _normalize_legacy_settings(imeta)
                    primary_key = imeta.get("primaryKey")
                else:
                    primary_key = imeta.get("primaryKey") or imeta.get(
                        "primary_key"
                    )
                    settings_json = _normalize_legacy_settings(
                        imeta.get("settings") or {}
                    )
            store = IndexStore(uid, primary_key=primary_key)
            known = set(store.settings.to_json())
            store.settings.apply_json(
                {k: v for k, v in settings_json.items() if k in known}
            )
            docs_raw = read(docs_name)
            if docs_raw:
                docs = [
                    json.loads(line)
                    for line in docs_raw.decode("utf-8").splitlines()
                    if line.strip()
                ]
                if docs:
                    store.add_documents(docs)
            scheduler.indexes[uid] = store

    if auth is not None and version in ("V4", "V5"):
        keys_raw = read("keys") or b""
        for line in keys_raw.decode("utf-8").splitlines():
            if not line.strip():
                continue
            try:
                body = json.loads(line)
                auth.create_key(
                    {
                        k: v
                        for k, v in body.items()
                        if k in ("uid", "name", "description", "actions",
                                 "indexes", "expiresAt")
                    }
                )
            except Exception:
                continue  # key rows are best-effort (default keys exist)


def import_instance(scheduler, data: dict) -> None:
    from ..index.store import IndexStore

    with scheduler.lock:
        # cross-cutting state first: _setup_loaded_store wires each
        # store's dynamic-rules pointer and shard topology from it
        scheduler.network = data.get("network", scheduler.network)
        for k, v in (data.get("features") or {}).items():
            if k in scheduler.runtime_features:
                scheduler.runtime_features[k] = v
        scheduler.dsr.rules.update(data.get("dynamicSearchRules") or {})
        scheduler.webhooks.update(data.get("webhooks") or {})
        for uid, idx in data.get("indexes", {}).items():
            store = IndexStore(uid, primary_key=idx.get("primaryKey"))
            store.settings.apply_json(idx.get("settings", {}))
            if idx.get("documents"):
                store.add_documents(idx["documents"])
            scheduler.indexes[uid] = store
            scheduler._setup_loaded_store(store)
        # restore the task history. Only terminal tasks: their effects are
        # already in the serialized index state (single writer), and the
        # journal replay rule keys off exactly this — anything non-terminal
        # here is re-enqueued from its WAL registration with its payload.
        from .journal import TERMINAL
        from .tasks import Task, TaskStatus, TaskType

        max_uid = -1
        for tj in data.get("tasks", []):
            try:
                uid = int(tj["uid"])
                ttype = TaskType(tj["type"])
                status = TaskStatus(tj.get("status", "enqueued"))
            except (KeyError, ValueError, TypeError):
                continue
            max_uid = max(max_uid, uid)
            if status not in TERMINAL:
                continue
            task = Task(uid=uid, type=ttype, index_uid=tj.get("indexUid"))
            task.status = status
            task.details = tj.get("details") or {}
            task.error = tj.get("error")
            task.canceled_by = tj.get("canceledBy")
            task.batch_uid = tj.get("batchUid")
            if tj.get("enqueuedAt"):
                task.enqueued_at = tj["enqueuedAt"]
            task.started_at = tj.get("startedAt")
            task.finished_at = tj.get("finishedAt")
            scheduler.queue.tasks[uid] = task
        if max_uid >= 0:
            scheduler.queue._next_uid = max(
                scheduler.queue._next_uid, max_uid + 1
            )


def create_snapshot(scheduler, path: Optional[str] = None) -> str:
    """Physical-style snapshot: one tar.gz with the logical state (our device
    snapshots are rebuilt from it at import; the reference tars the LMDB
    envs, process_snapshot_creation.rs:81)."""
    directory = path or os.path.join(tempfile.gettempdir(), "meili_tpu_snapshots")
    os.makedirs(directory, exist_ok=True)
    payload = json.dumps(serialize_instance(scheduler)).encode("utf-8")
    file_path = os.path.join(directory, "data.ms.snapshot")
    # write-then-rename: a crash mid-write never corrupts the previous
    # snapshot (the journal rotation that follows a snapshot relies on it)
    tmp_path = file_path + ".tmp"
    buf = BytesIO(payload)
    with tarfile.open(tmp_path, "w:gz") as tar:
        info = tarfile.TarInfo("instance.json")
        info.size = len(payload)
        tar.addfile(info, buf)
    os.replace(tmp_path, file_path)
    return file_path


def create_packed_checkpoint(scheduler, db_path: str) -> None:
    """Durability checkpoint in the PACKED format (index/packed.py):
    one columnar directory per index plus a small instance.json for
    tasks/network/features. Boot restore slices mmap'd arrays back into
    postings instead of re-indexing documents — the SURVEY §7 P0 packed
    index format & loader on the db path. The portable tar.gz snapshot
    (create_snapshot) remains the interchange format."""
    import shutil

    from ..index.packed import save_index
    from .versioning import SNAPSHOT_FORMAT_VERSION

    idx_dir = os.path.join(db_path, "indexes")
    os.makedirs(idx_dir, exist_ok=True)
    # task statuses snapshot BEFORE the store saves: a task finishing
    # mid-checkpoint is then recorded non-terminal here AND carried by
    # the journal rotation, so boot replays it (idempotent-by-replay)
    # instead of trusting a packed store that may predate its effects
    with scheduler.lock:
        all_uids = list(scheduler.indexes)
        # deferred (never-loaded) indexes already live as packed dirs;
        # saving them again would force a pointless load
        loaded = dict(getattr(scheduler.indexes, "_loaded", None) or {})
        if not hasattr(scheduler.indexes, "_loaded"):
            loaded = dict(scheduler.indexes)
        tasks_snapshot = [
            t.to_json() for t in scheduler.queue.tasks.values()
        ]
        data = {
            "formatVersion": SNAPSHOT_FORMAT_VERSION,
            "engineVersion": _engine_version(),
            "checkpointDate": time.time(),
            "indexes": sorted(all_uids),
            "tasks": tasks_snapshot,
            "network": scheduler.network,
            "features": scheduler.runtime_features,
            "dynamicSearchRules": dict(scheduler.dsr.rules),
            "webhooks": dict(scheduler.webhooks),
        }
    live = set()
    for uid, store in loaded.items():
        with store._lock:
            save_index(store, os.path.join(idx_dir, uid + ".packed"))
            store._persisted_generation = store.generation
        live.add(uid + ".packed")
    for uid in all_uids:
        live.add(uid + ".packed")
    for name in os.listdir(idx_dir):
        if name.endswith(".packed") and name not in live:
            shutil.rmtree(os.path.join(idx_dir, name), ignore_errors=True)
    tmp = os.path.join(db_path, "instance.json.tmp")
    with open(tmp, "w") as fh:
        json.dump(data, fh)
    os.replace(tmp, os.path.join(db_path, "instance.json"))
    return tasks_snapshot


def load_packed_checkpoint(scheduler, db_path: str) -> bool:
    """Restore from a packed checkpoint; returns False when none exists."""
    from ..index.packed import load_index

    meta_path = os.path.join(db_path, "instance.json")
    if not os.path.exists(meta_path):
        return False
    with open(meta_path) as fh:
        data = json.load(fh)
    with scheduler.lock:
        for uid in data.get("indexes", []):
            directory = os.path.join(db_path, "indexes", uid + ".packed")
            if hasattr(scheduler.indexes, "register_deferred"):
                # boot is O(#indexes): each index loads lazily on first
                # access through the v2 packed loader (VERDICT r2 #3)
                scheduler.indexes.register_deferred(uid, directory)
            else:
                store = load_index(directory)
                scheduler.indexes[uid] = store
                scheduler._setup_loaded_store(store)
    # tasks/network/features restore through the shared logical importer
    payload = {"indexes": {}, "tasks": data.get("tasks", [])}
    for key in ("network", "features", "dynamicSearchRules", "webhooks"):
        if data.get(key):
            payload[key] = data[key]
    import_instance(scheduler, payload)
    return True


def load_snapshot(scheduler, file_path: str, allow_upgrade: bool = False) -> None:
    """Open a snapshot, enforcing the version gate (engine/versioning.py):
    same format opens, newer always refuses, older migrates only when
    `allow_upgrade` (--upgrade-db or an upgradeDatabase task)."""
    from .versioning import check_and_migrate

    with tarfile.open(file_path, "r:gz") as tar:
        member = tar.getmember("instance.json")
        data = json.loads(tar.extractfile(member).read().decode("utf-8"))
    data = check_and_migrate(data, allow_upgrade=allow_upgrade)
    import_instance(scheduler, data)
