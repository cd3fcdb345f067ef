"""Top-level routes: health, version, stats, tasks, batches, keys, dumps,
snapshots, swap-indexes, multi-search, experimental features, network,
webhooks, metrics, logs.

Reference: crates/meilisearch/src/routes/ (mod.rs, tasks.rs, batches.rs,
api_key.rs, dump.rs, snapshot.rs, swap_indexes.rs, multi_search.rs,
features.rs, network.rs, webhooks.rs, metrics.rs, logs.rs).
"""

from __future__ import annotations

import uuid
from typing import Optional

from ..engine.tasks import TaskStatus, TaskType
from ..types.errors import EngineError, ErrorCode


def _parse_csv(value) -> Optional[list[str]]:
    if value is None:
        return None
    if isinstance(value, list):
        return value
    return [v.strip() for v in str(value).split(",") if v.strip()]


def _task_filters(query: dict) -> dict:
    filters = {}
    if query.get("uids"):
        filters["uids"] = [int(u) for u in _parse_csv(query["uids"])]
    if query.get("statuses"):
        statuses = _parse_csv(query["statuses"])
        valid = {s.value for s in TaskStatus}
        for s in statuses:
            if s not in valid:
                raise EngineError(
                    ErrorCode.BAD_REQUEST,
                    f"Invalid value at `.statuses`: `{s}` is not a valid task status."
                    f" Available statuses are {', '.join(sorted(valid))}.",
                )
        filters["statuses"] = statuses
    if query.get("types"):
        types = _parse_csv(query["types"])
        valid = {t.value for t in TaskType}
        for t in types:
            if t not in valid:
                raise EngineError(
                    ErrorCode.BAD_REQUEST,
                    f"Invalid value at `.types`: `{t}` is not a valid task type.",
                )
        filters["types"] = types
    if query.get("indexUids"):
        filters["index_uids"] = _parse_csv(query["indexUids"])
    if query.get("canceledBy"):
        filters["canceled_by"] = [int(u) for u in _parse_csv(query["canceledBy"])]
    if query.get("batchUids"):
        filters["batch_uids"] = [int(u) for u in _parse_csv(query["batchUids"])]
    for qk, fk in (
        ("beforeEnqueuedAt", "before_enqueued_at"),
        ("afterEnqueuedAt", "after_enqueued_at"),
        ("beforeStartedAt", "before_started_at"),
        ("afterStartedAt", "after_started_at"),
        ("beforeFinishedAt", "before_finished_at"),
        ("afterFinishedAt", "after_finished_at"),
    ):
        if query.get(qk):
            filters[fk] = query[qk]
    return filters


def register_misc_routes(app):
    from .app import Response

    # -- health / version / stats ----------------------------------------

    def health(app_, req):
        return {"status": "available"}

    app.add("GET", "/health", "public", health)

    def version(app_, req):
        from .app import VERSION

        return {
            "commitSha": "unknown",
            "commitDate": "unknown",
            "pkgVersion": VERSION,
        }

    app.add("GET", "/version", "version", version)

    def stats(app_, req):
        return app_.scheduler.stats()

    app.add("GET", "/stats", "stats.get", stats)

    # -- tasks ----------------------------------------------------------------

    def list_tasks(app_, req):
        filters = _task_filters(req.query)
        limit = int(req.query.get("limit", 20))
        from_uid = req.query.get("from")
        tasks = app_.scheduler.queue.filtered(**filters)
        if from_uid is not None:
            tasks = [t for t in tasks if t.uid <= int(from_uid)]
        reverse = req.query.get("reverse") in ("true", True)
        if reverse:
            tasks = list(reversed(tasks))
        page = tasks[: limit + 1]
        next_from = page[limit].uid if len(page) > limit else None
        page = page[:limit]
        return {
            "results": [t.to_json() for t in page],
            "total": len(tasks),
            "limit": limit,
            "from": page[0].uid if page else None,
            "next": next_from,
        }

    app.add("GET", "/tasks", "tasks.get", list_tasks)

    def get_task(app_, req):
        try:
            uid = int(req.params["task_uid"])
        except ValueError:
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                f"Invalid value in parameter `taskUid`: could not parse"
                f" `{req.params['task_uid']}` as a positive integer.",
            )
        task = app_.scheduler.queue.tasks.get(uid)
        if task is None:
            raise EngineError(
                ErrorCode.TASK_NOT_FOUND, f"Task `{uid}` not found."
            )
        return task.to_json()

    app.add("GET", "/tasks/{task_uid}", "tasks.get", get_task)

    def cancel_tasks(app_, req):
        filters = _task_filters(req.query)
        if not filters:
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                "Query deserialize error: missing task filters. Available"
                " filters are `uids`, `indexUids`, `statuses`, `types`,"
                " `canceledBy`, `beforeEnqueuedAt`, `afterEnqueuedAt`,"
                " `beforeStartedAt`, `afterStartedAt`, `beforeFinishedAt`,"
                " `afterFinishedAt`.",
            )
        import urllib.parse

        original = urllib.parse.urlencode(
            {k: v for k, v in req.query.items()}
        )
        task = app_.scheduler.register(
            TaskType.TASK_CANCELATION,
            content={"query": "?" + original, "filters": filters},
        )
        return Response(200, json=task.summary())

    app.add("POST", "/tasks/cancel", "tasks.cancel", cancel_tasks)

    def delete_tasks(app_, req):
        filters = _task_filters(req.query)
        if not filters:
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                "Query deserialize error: missing task filters.",
            )
        import urllib.parse

        original = urllib.parse.urlencode({k: v for k, v in req.query.items()})
        task = app_.scheduler.register(
            TaskType.TASK_DELETION,
            content={"query": "?" + original, "filters": filters},
        )
        return Response(200, json=task.summary())

    app.add("DELETE", "/tasks", "tasks.delete", delete_tasks)

    def compact_tasks(app_, req):
        """Task-queue compaction (reference POST /tasks/compact behind the
        `taskQueueCompactionRoute` experimental feature): drop terminal
        tasks beyond the retention window and rotate the journal so the
        on-disk queue shrinks — the LMDB copy-compact analogue."""
        _check_feature(app_, "taskQueueCompactionRoute")
        sched = app_.scheduler
        from ..engine.tasks import TaskStatus

        with sched.lock:
            before = len(sched.queue.tasks)
            finished = sorted(
                uid
                for uid, t in sched.queue.tasks.items()
                if t.status
                in (
                    TaskStatus.SUCCEEDED,
                    TaskStatus.FAILED,
                    TaskStatus.CANCELED,
                )
            )
            # keep the most recent 1k terminal tasks for the /tasks views
            for uid in finished[:-1000] if len(finished) > 1000 else []:
                del sched.queue.tasks[uid]
            after = len(sched.queue.tasks)
        try:
            sched.checkpoint()  # rotate the journal: reclaim disk
        except Exception:
            pass
        return {"previousTasks": before, "remainingTasks": after}

    app.add("POST", "/tasks/compact", "tasks.compact", compact_tasks)

    # -- batches ------------------------------------------------------------

    def list_batches(app_, req):
        limit = int(req.query.get("limit", 20))
        batches = sorted(
            app_.scheduler.queue.batches.values(), key=lambda b: -b.uid
        )
        return {
            "results": [b.to_json() for b in batches[:limit]],
            "total": len(batches),
            "limit": limit,
            "from": batches[0].uid if batches else None,
            "next": None,
        }

    app.add("GET", "/batches", "tasks.get", list_batches)

    def get_batch(app_, req):
        uid = int(req.params["batch_uid"])
        batch = app_.scheduler.queue.batches.get(uid)
        if batch is None:
            raise EngineError(
                ErrorCode.BATCH_NOT_FOUND, f"Batch `{uid}` not found."
            )
        return batch.to_json()

    app.add("GET", "/batches/{batch_uid}", "tasks.get", get_batch)

    # -- swap indexes ------------------------------------------------------

    def swap_indexes(app_, req):
        body = req.body or []
        if not isinstance(body, list):
            raise EngineError(
                ErrorCode.BAD_REQUEST, "Invalid swap body: expected an array."
            )
        seen = set()
        for swap in body:
            indexes = swap.get("indexes") if isinstance(swap, dict) else None
            if not indexes or len(indexes) != 2:
                raise EngineError(
                    ErrorCode.INVALID_SWAP_INDEXES,
                    "Two indexes must be given for each swap.",
                )
            for uid in indexes:
                if uid in seen:
                    raise EngineError(
                        ErrorCode.INVALID_SWAP_INDEXES,
                        f"Indexes must be declared only once during a swap."
                        f" `{uid}` was specified several times.",
                    )
                seen.add(uid)
        task = app_.scheduler.register(
            TaskType.INDEX_SWAP, content={"swaps": body}
        )
        return Response(202, json=task.summary())

    app.add("POST", "/swap-indexes", "indexes.swap", swap_indexes)

    # -- dumps / snapshots ----------------------------------------------------

    def create_dump(app_, req):
        task = app_.scheduler.register(
            TaskType.DUMP_CREATION,
            content={"path": getattr(app_.scheduler, "dump_dir", None)},
        )
        return Response(202, json=task.summary())

    app.add("POST", "/dumps", "dumps.create", create_dump)

    def create_snapshot(app_, req):
        task = app_.scheduler.register(TaskType.SNAPSHOT_CREATION, content={})
        return Response(202, json=task.summary())

    app.add("POST", "/snapshots", "snapshots.create", create_snapshot)

    # -- keys -------------------------------------------------------------------

    def create_key(app_, req):
        key = app_.auth.create_key(req.body or {})
        return Response(201, json=key.to_json())

    app.add("POST", "/keys", "keys.create", create_key)

    def list_keys(app_, req):
        limit = int(req.query.get("limit", 20))
        offset = int(req.query.get("offset", 0))
        keys = app_.auth.list_keys()
        return {
            "results": [k.to_json() for k in keys[offset : offset + limit]],
            "offset": offset,
            "limit": limit,
            "total": len(keys),
        }

    app.add("GET", "/keys", "keys.get", list_keys)

    def get_key(app_, req):
        return app_.auth.get_key(req.params["key"]).to_json()

    app.add("GET", "/keys/{key}", "keys.get", get_key)

    def patch_key(app_, req):
        return app_.auth.update_key(req.params["key"], req.body or {}).to_json()

    app.add("PATCH", "/keys/{key}", "keys.update", patch_key)

    def delete_key(app_, req):
        app_.auth.delete_key(req.params["key"])
        return Response(204)

    app.add("DELETE", "/keys/{key}", "keys.delete", delete_key)

    # -- multi search -------------------------------------------------------------

    def multi_search(app_, req):
        from .federation import perform_multi_search

        return perform_multi_search(app_, req)

    app.add("POST", "/multi-search", "search", multi_search)

    # -- experimental features -----------------------------------------------------

    def get_features(app_, req):
        return dict(app_.scheduler.runtime_features)

    app.add("GET", "/experimental-features", "experimental.get", get_features)

    def patch_features(app_, req):
        body = req.body or {}
        for k, v in body.items():
            if k not in app_.scheduler.runtime_features:
                raise EngineError(
                    ErrorCode.BAD_REQUEST,
                    f"Unknown field `{k}`: expected one of"
                    f" {', '.join(sorted(app_.scheduler.runtime_features))}",
                )
            if v is not None:
                app_.scheduler.runtime_features[k] = bool(v)
        return dict(app_.scheduler.runtime_features)

    app.add("PATCH", "/experimental-features", "experimental.update", patch_features)

    # -- network -----------------------------------------------------------------

    def get_network(app_, req):
        _check_feature(app_, "network")
        return dict(app_.scheduler.network)

    app.add("GET", "/network", "network.get", get_network)

    def patch_network(app_, req):
        """Merge-PATCH of the network topology (reference:
        routes/network/mod.rs + network.rs:13-24 {self, remotes, shards,
        leader, version}). A shards change is the local analogue of the
        EE NetworkTopologyChange task: every index's rendezvous ownership
        is re-derived lazily against the new shard set, and the previous
        shard map is returned as `previousShards` so callers can dual-query
        during resharding (tasks/network.rs previousShards semantics)."""
        _check_feature(app_, "network")
        body = req.body or {}
        network = app_.scheduler.network
        changed = False
        if "self" in body:
            network["self"] = body["self"]
            changed = True
        if "leader" in body:
            network["leader"] = body["leader"]
            changed = True
        if "remotes" in body and body["remotes"] is not None:
            for name, remote in body["remotes"].items():
                if remote is None:
                    network["remotes"].pop(name, None)
                else:
                    network["remotes"][name] = {
                        "url": remote.get("url"),
                        "searchApiKey": remote.get("searchApiKey"),
                        "writeApiKey": remote.get("writeApiKey"),
                    }
            changed = True
        if body.get("sharding") is True and "shards" not in body:
            # reference network API shorthand (routes/network/mod.rs
            # `sharding: true`): derive one shard per remote — the
            # rendezvous topology over every configured instance
            names = set(network["remotes"]) | (
                {network["self"]} if network.get("self") else set()
            )
            body = dict(body)
            body["shards"] = {n: {"remotes": [n]} for n in sorted(names)}
        previous_shards = None
        reshard_task_uid = None
        if body.get("previousShards", "__absent__") is None:
            # explicit close of the resharding dual-query window — with a
            # leader, the leader issues this once every instance's
            # networkTopologyChange task has succeeded (reference: the
            # leader publishes the post-reshard network version)
            network.pop("previousShards", None)
            changed = True
        if "shards" in body and body["shards"] is not None:
            import uuid as _uuid

            previous_shards = dict(network["shards"])
            for name, shard in body["shards"].items():
                if shard is None:
                    network["shards"].pop(name, None)
                    continue
                remotes = shard.get("remotes") or []
                unknown = [
                    r
                    for r in remotes
                    if r not in network["remotes"] and r != network["self"]
                ]
                if unknown:
                    raise EngineError(
                        ErrorCode.BAD_REQUEST,
                        f"Shard `{name}` references unknown remotes:"
                        f" {', '.join(sorted(unknown))}.",
                    )
                network["shards"][name] = {"remotes": sorted(remotes)}
            network["version"] = str(_uuid.uuid4())
            topo = sorted(network["shards"])
            for store in app_.scheduler.list_indexes():
                store.set_shard_topology(topo)
            changed = True
            if previous_shards != network["shards"]:
                # live resharding (reference enterprise_edition/network.rs
                # NetworkTopologyChange): a task moves documents to their
                # new owning remotes; until it succeeds, previousShards
                # stays in the topology so federated queries dual-fan
                from ..engine.tasks import TaskType

                network["previousShards"] = previous_shards
                task = app_.scheduler.register(
                    TaskType.NETWORK_TOPOLOGY_CHANGE,
                    None,
                    content={"previousShards": previous_shards},
                )
                reshard_task_uid = task.uid
        if changed and network["leader"] is not None:
            known = set(network["remotes"]) | (
                {network["self"]} if network["self"] else set()
            )
            if network["leader"] not in known:
                raise EngineError(
                    ErrorCode.BAD_REQUEST,
                    f"Leader `{network['leader']}` is not `self` or a"
                    " declared remote.",
                )
        out = dict(network)
        if previous_shards is not None:
            out["previousShards"] = previous_shards
        if reshard_task_uid is not None:
            out["taskUid"] = reshard_task_uid
        return out

    app.add("PATCH", "/network", "network.update", patch_network)

    # -- webhooks ------------------------------------------------------------------

    def list_webhooks(app_, req):
        return {
            "results": [
                {"uuid": k, **v} for k, v in app_.scheduler.webhooks.items()
            ]
        }

    app.add("GET", "/webhooks", "webhooks.get", list_webhooks)

    def create_webhook(app_, req):
        body = req.body or {}
        if not body.get("url"):
            raise EngineError(
                ErrorCode.BAD_REQUEST, "The `url` field is mandatory."
            )
        wid = str(uuid.uuid4())
        app_.scheduler.webhooks[wid] = {
            "url": body["url"],
            "headers": body.get("headers") or {},
            "isEditable": True,
        }
        return Response(201, json={"uuid": wid, **app_.scheduler.webhooks[wid]})

    app.add("POST", "/webhooks", "webhooks.create", create_webhook)

    def get_webhook(app_, req):
        wid = req.params["uuid"]
        hook = app_.scheduler.webhooks.get(wid)
        if hook is None:
            raise EngineError(
                ErrorCode.NOT_FOUND, f"Webhook `{wid}` not found."
            )
        return {"uuid": wid, **hook}

    app.add("GET", "/webhooks/{uuid}", "webhooks.get", get_webhook)

    def patch_webhook(app_, req):
        wid = req.params["uuid"]
        hook = app_.scheduler.webhooks.get(wid)
        if hook is None:
            raise EngineError(ErrorCode.NOT_FOUND, f"Webhook `{wid}` not found.")
        body = req.body or {}
        if "url" in body and body["url"]:
            hook["url"] = body["url"]
        if "headers" in body and body["headers"] is not None:
            hook["headers"] = body["headers"]
        return {"uuid": wid, **hook}

    app.add("PATCH", "/webhooks/{uuid}", "webhooks.update", patch_webhook)

    def delete_webhook(app_, req):
        wid = req.params["uuid"]
        if wid not in app_.scheduler.webhooks:
            raise EngineError(ErrorCode.NOT_FOUND, f"Webhook `{wid}` not found.")
        del app_.scheduler.webhooks[wid]
        return Response(204)

    app.add("DELETE", "/webhooks/{uuid}", "webhooks.delete", delete_webhook)

    # -- metrics (prometheus text format) --------------------------------------------

    def metrics(app_, req):
        _check_feature(app_, "metrics")
        lines = []
        stats = app_.scheduler.stats()
        lines.append("# TYPE meilisearch_index_count gauge")
        lines.append(f"meilisearch_index_count {len(stats['indexes'])}")
        lines.append("# TYPE meilisearch_index_docs_count gauge")
        for uid, s in stats["indexes"].items():
            lines.append(
                f'meilisearch_index_docs_count{{index="{uid}"}} {s["numberOfDocuments"]}'
            )
        nb_tasks = {}
        for t in app_.scheduler.queue.tasks.values():
            key = (t.type.value, t.status.value)
            nb_tasks[key] = nb_tasks.get(key, 0) + 1
        lines.append("# TYPE meilisearch_nb_tasks gauge")
        for (kind, status), count in sorted(nb_tasks.items()):
            lines.append(
                f'meilisearch_nb_tasks{{kind="{kind}",value="{status}"}} {count}'
            )
        hm = getattr(app_, "http_metrics", None)
        if hm:
            lines.append("# TYPE meilisearch_http_requests_total counter")
            for (method, pattern, status), count in sorted(hm["requests"].items()):
                lines.append(
                    "meilisearch_http_requests_total"
                    f'{{method="{method}",path="{pattern}",status="{status}"}}'
                    f" {count}"
                )
            lines.append(
                "# TYPE meilisearch_http_response_time_seconds histogram"
            )
            cumulative = 0
            for b in hm["buckets"]:
                cumulative = hm["histogram"].get(b, 0)
                lines.append(
                    f'meilisearch_http_response_time_seconds_bucket{{le="{b}"}}'
                    f" {cumulative}"
                )
            lines.append(
                'meilisearch_http_response_time_seconds_bucket{le="+Inf"}'
                f" {hm['time_count']}"
            )
            lines.append(
                f"meilisearch_http_response_time_seconds_sum {hm['time_sum']:.6f}"
            )
            lines.append(
                f"meilisearch_http_response_time_seconds_count {hm['time_count']}"
            )
            lines.append("# TYPE meilisearch_degraded_search_requests gauge")
            lines.append(
                f"meilisearch_degraded_search_requests {hm['degraded']}"
            )
        # currently-running batch progress (reference metrics.rs:77
        # MEILISEARCH_BATCH_RUNNING_PROGRESS_TRACE)
        lines.append("# TYPE meilisearch_batch_running_progress_trace gauge")
        for batch in app_.scheduler.queue.batches.values():
            progress = getattr(batch, "progress", None)
            if progress:
                for step in progress.get("steps", []):
                    lines.append(
                        "meilisearch_batch_running_progress_trace"
                        f'{{batch_uid="{batch.uid}",step="{step["currentStep"]}"}}'
                        f' {step["finished"] / max(step["total"], 1):.4f}'
                    )
        text = "\n".join(lines) + "\n"
        return Response(
            200,
            body=text.encode("utf-8"),
            headers={"Content-Type": "text/plain; version=0.0.4"},
        )

    app.add("GET", "/metrics", "metrics.get", metrics)

    # -- logs: live span stream (reference routes/logs.rs:29-56) -------------

    def logs_stream(app_, req):
        _check_feature(app_, "logsRoute")
        body = req.body or {}
        mode = body.get("mode", "human")
        if mode not in ("human", "json", "profile"):
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                f"Invalid value at `.mode`: `{mode}`, expected one of"
                " `human`, `json`, `profile`.",
            )
        target = body.get("target")
        from ..utils import tracing

        if getattr(app_, "_logs_stream_active", False):
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                "The `/logs/stream` route is currently in use by someone"
                " else.",
            )
        app_._logs_stream_active = True
        sub = tracing.subscribe(target)

        def gen():
            import queue as _q

            try:
                while getattr(app_, "_logs_stream_active", False):
                    try:
                        line = sub.get(timeout=0.5)
                    except _q.Empty:
                        continue
                    yield (line + "\n").encode("utf-8")
                # stream stopped: drain what was already recorded
                while True:
                    try:
                        line = sub.get_nowait()
                    except _q.Empty:
                        break
                    yield (line + "\n").encode("utf-8")
            finally:
                tracing.unsubscribe(sub)
                app_._logs_stream_active = False

        return Response(200, stream=gen(), headers={"Content-Type": "application/x-ndjson"})

    def logs_stream_stop(app_, req):
        _check_feature(app_, "logsRoute")
        app_._logs_stream_active = False
        return Response(204, json=None)

    app.add("POST", "/logs/stream", "public", logs_stream)
    app.add("DELETE", "/logs/stream", "public", logs_stream_stop)

    def logs_stderr(app_, req):
        _check_feature(app_, "logsRoute")
        return Response(200, json=None)

    app.add("POST", "/logs/stderr", "public", logs_stderr)


    # -- dynamic search rules (reference routes/dynamic_search_rules.rs) -------

    def list_dsr(app_, req):
        body = req.body or {}
        offset = int(body.get("offset", 0) or 0)
        limit = int(body.get("limit", 20) or 20)
        flt = body.get("filter") or {}
        rules = app_.scheduler.dsr.list(flt.get("query"), flt.get("active"))
        return {
            "results": rules[offset : offset + limit],
            "offset": offset,
            "limit": limit,
            "total": len(rules),
        }

    app.add("POST", "/dynamic-search-rules", "settings.get", list_dsr)

    def clear_dsr(app_, req):
        task = app_.scheduler.register(TaskType.DSR_CLEAR, content={})
        return Response(202, json=task.summary())

    app.add("DELETE", "/dynamic-search-rules", "settings.update", clear_dsr)

    def get_dsr(app_, req):
        rule = app_.scheduler.dsr.rules.get(req.params["uid"])
        if rule is None:
            raise EngineError(
                ErrorCode.NOT_FOUND,
                f"Dynamic search rule `{req.params['uid']}` not found.",
            )
        return rule

    app.add("GET", "/dynamic-search-rules/{uid}", "settings.get", get_dsr)

    def patch_dsr(app_, req):
        # validate eagerly on a scratch store (400 on bad payloads)
        from ..search.dynamic_rules import DynamicSearchRules

        scratch = DynamicSearchRules()
        existing = app_.scheduler.dsr.rules.get(req.params["uid"])
        if existing:
            scratch.rules[req.params["uid"]] = dict(existing)
        scratch.update_or_create(req.params["uid"], req.body or {})
        task = app_.scheduler.register(
            TaskType.DSR_UPDATE,
            content={"uid": req.params["uid"], "patch": req.body or {}},
        )
        return Response(202, json=task.summary())

    app.add("PATCH", "/dynamic-search-rules/{uid}", "settings.update", patch_dsr)

    def delete_dsr(app_, req):
        task = app_.scheduler.register(
            TaskType.DSR_DELETION, content={"uid": req.params["uid"]}
        )
        return Response(202, json=task.summary())

    app.add("DELETE", "/dynamic-search-rules/{uid}", "settings.update", delete_dsr)

    # -- chats (OpenAI-compatible workspaces; reference routes/chats/) --------

    def list_chats(app_, req):
        _check_feature(app_, "chatCompletions")
        workspaces = getattr(app_.scheduler, "chat_workspaces", {})
        return {
            "results": [{"uid": uid} for uid in sorted(workspaces)],
            "offset": 0,
            "limit": 20,
            "total": len(workspaces),
        }

    app.add("GET", "/chats", "chats.get", list_chats)

    def get_chat_settings(app_, req):
        _check_feature(app_, "chatCompletions")
        workspaces = getattr(app_.scheduler, "chat_workspaces", {})
        ws = workspaces.get(req.params["workspace"])
        if ws is None:
            raise EngineError(
                ErrorCode.NOT_FOUND,
                f"Chat `{req.params['workspace']}` not found",
            )
        redacted = dict(ws)
        if redacted.get("apiKey"):
            # reference features.rs hide_secret: keep a length-scaled
            # prefix, then a fixed per-bucket run of X's (3/4/5/6)
            secret = str(redacted["apiKey"])
            n = len(secret)
            keep = 0 if n < 10 else 2 if n < 20 else 3 if n < 30 else 5
            xs = 3 if keep == 0 else 6 if keep == 5 else keep + 2
            redacted["apiKey"] = secret[:keep] + "X" * xs + "..."
        return redacted

    app.add("GET", "/chats/{workspace}/settings", "chatsSettings.get", get_chat_settings)

    def put_chat_settings(app_, req):
        _check_feature(app_, "chatCompletions")
        if not hasattr(app_.scheduler, "chat_workspaces"):
            app_.scheduler.chat_workspaces = {}
        body = req.body or {}
        source = body.get("source", "openAi")
        if source not in ("openAi", "azureOpenAi", "mistral", "vLlm"):
            raise EngineError(
                ErrorCode.BAD_REQUEST,
                f"Unknown value `{source}` at `.source`: expected one of"
                " `openAi`, `azureOpenAi`, `mistral`, `vLlm`",
            )
        from ..engine.chat import validate_workspace_settings

        validate_workspace_settings(body)
        app_.scheduler.chat_workspaces[req.params["workspace"]] = body
        return body

    app.add("PUT", "/chats/{workspace}/settings", "chatsSettings.update", put_chat_settings)
    app.add("PATCH", "/chats/{workspace}/settings", "chatsSettings.update", put_chat_settings)

    def delete_chat_settings(app_, req):
        _check_feature(app_, "chatCompletions")
        workspaces = getattr(app_.scheduler, "chat_workspaces", {})
        if req.params["workspace"] not in workspaces:
            raise EngineError(
                ErrorCode.NOT_FOUND,
                f"Chat `{req.params['workspace']}` not found",
            )
        del workspaces[req.params["workspace"]]
        return Response(204)

    app.add("DELETE", "/chats/{workspace}/settings", "chatsSettings.update", delete_chat_settings)

    def chat_completions(app_, req):
        _check_feature(app_, "chatCompletions")
        workspaces = getattr(app_.scheduler, "chat_workspaces", {})
        ws = workspaces.get(req.params["workspace"])
        if ws is None:
            raise EngineError(
                ErrorCode.NOT_FOUND,
                f"Chat `{req.params['workspace']}` not found",
            )
        from ..engine.chat import (
            execute_chat_completion,
            execute_chat_completion_stream,
        )

        body = req.body or {}
        if body.get("stream"):
            # token-level passthrough: upstream deltas forward as they
            # arrive, tool calls run between upstream streams
            return Response(
                200,
                stream=execute_chat_completion_stream(
                    app_.scheduler, ws, body
                ),
                headers={"Content-Type": "text/event-stream"},
            )
        return execute_chat_completion(app_.scheduler, ws, body)

    app.add(
        "POST",
        "/chats/{workspace}/chat/completions",
        "chatCompletions",
        chat_completions,
    )

    # -- export (push documents+settings to a remote instance) ------------------

    def export(app_, req):
        body = req.body or {}
        url = body.get("url")
        if not url:
            raise EngineError(ErrorCode.BAD_REQUEST, "Missing field `url`")
        task = app_.scheduler.register(
            TaskType.EXPORT,
            content={
                "url": url,
                "apiKey": body.get("apiKey"),
                "payloadSize": body.get("payloadSize"),
                "indexes": body.get("indexes"),
            },
            details={"url": url, "indexes": body.get("indexes") or {"*": {}}},
        )
        return Response(202, json=task.summary())

    app.add("POST", "/export", "export", export)

    # -- render template (reference routes/indexes/render.rs) -------------------

    def render_template(app_, req):
        raise EngineError(
            ErrorCode.FEATURE_NOT_ENABLED,
            "The render-template route requires the `multimodal` experimental"
            " feature."
            if not app_.scheduler.runtime_features.get("multimodal")
            else "Template rendering is not implemented yet.",
        )

    app.add("POST", "/render-template", "settings.get", render_template)


def _check_feature(app_, name: str):
    if not app_.scheduler.runtime_features.get(name, False):
        raise EngineError(
            ErrorCode.FEATURE_NOT_ENABLED,
            f"Modifying `{name}` requires enabling the `{name}` experimental"
            " feature. See /experimental-features",
        )
