"""Offline ops CLI — the meilitool equivalent
(reference: crates/meilitool/src/main.rs: clear task queue, export dumps and
documents, offline upgrade, compaction).

Usage:
  python -m meilisearch_tpu_torch.tool export-dump --snapshot data.ms.snapshot --out dir/
  python -m meilisearch_tpu_torch.tool import-dump --dump file.dump --out data.ms.snapshot
  python -m meilisearch_tpu_torch.tool export-documents --snapshot data.ms.snapshot --index movies
  python -m meilisearch_tpu_torch.tool clear-tasks --snapshot data.ms.snapshot
  python -m meilisearch_tpu_torch.tool stats --snapshot data.ms.snapshot
  python -m meilisearch_tpu_torch.tool openapi [--device cpu]

Every command but `openapi` reads and writes through an `IndexScheduler`
with no device bound, so it touches no card. `openapi` builds the port's
App, which serves on a torch device: the card by default (raising without
one), or the one `--device` names.
"""

from __future__ import annotations

import argparse
import json
import sys


def _load_instance(path):
    from .engine.dumps import load_dump, load_snapshot
    from .engine.scheduler import IndexScheduler

    scheduler = IndexScheduler(autobatching_enabled=False)
    if path.endswith(".dump"):
        load_dump(scheduler, path)
    else:
        load_snapshot(scheduler, path)
    return scheduler


def main(argv=None):
    parser = argparse.ArgumentParser(prog="meilisearch-tpu-torch-tool")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("export-dump", help="write a logical dump")
    p.add_argument("--snapshot", required=True)
    p.add_argument("--out", default=None)

    p = sub.add_parser("import-dump", help="load a dump and write a snapshot")
    p.add_argument("--dump", required=True)
    p.add_argument("--out", default=None)

    p = sub.add_parser("export-documents", help="print an index's documents as NDJSON")
    p.add_argument("--snapshot", required=True)
    p.add_argument("--index", required=True)

    p = sub.add_parser("clear-tasks", help="drop all finished tasks")
    p.add_argument("--snapshot", required=True)

    p = sub.add_parser("stats", help="print instance stats")
    p.add_argument("--snapshot", required=True)

    p = sub.add_parser("openapi", help="print the OpenAPI spec for the route tree")
    p.add_argument(
        "--device", default=None,
        help="torch device of the App whose routes are read (default: the card)",
    )

    p = sub.add_parser(
        "offline-upgrade",
        help="upgrade a db path's packed checkpoint to the current engine"
        " version without starting the server (meilitool OfflineUpgrade)",
    )
    p.add_argument("--db-path", required=True)

    p = sub.add_parser(
        "hair-dryer",
        help="touch every packed column of a db path so the page cache is"
        " warm before serving (meilitool hair-dryer, main.rs:160-175)",
    )
    p.add_argument("--db-path", required=True)

    p = sub.add_parser(
        "explain-query",
        help="render the query graph + derivations (VisualSearchLogger)",
    )
    p.add_argument("--snapshot", required=True)
    p.add_argument("--index", required=True)
    p.add_argument("--query", required=True)
    p.add_argument("--dot-only", action="store_true")

    args = parser.parse_args(argv)

    if args.command == "openapi":
        print(json.dumps(generate_openapi(args.device), indent=2))
        return

    if args.command == "export-dump":
        scheduler = _load_instance(args.snapshot)
        from .engine.dumps import create_dump

        uid = create_dump(scheduler, args.out)
        print(f"dump created: {uid}")
        scheduler.stop()
    elif args.command == "import-dump":
        scheduler = _load_instance(args.dump)
        from .engine.dumps import create_snapshot

        path = create_snapshot(scheduler, args.out)
        print(f"snapshot written: {path}")
        scheduler.stop()
    elif args.command == "export-documents":
        scheduler = _load_instance(args.snapshot)
        store = scheduler.index(args.index)
        for docid in sorted(store.documents):
            sys.stdout.write(json.dumps(store.documents[docid]) + "\n")
        scheduler.stop()
    elif args.command == "clear-tasks":
        scheduler = _load_instance(args.snapshot)
        n = len(scheduler.queue.tasks)
        scheduler.queue.tasks.clear()
        from .engine.dumps import create_snapshot

        create_snapshot(scheduler, None)
        print(f"cleared {n} tasks")
        scheduler.stop()
    elif args.command == "stats":
        scheduler = _load_instance(args.snapshot)
        print(json.dumps(scheduler.stats(), indent=2, default=str))
        scheduler.stop()
    elif args.command == "offline-upgrade":
        # load through the version gate/migration chain (engine/versioning
        # check_and_migrate runs inside the loaders), then rewrite the
        # checkpoint in the CURRENT formats — packed v2 columns, current
        # snapshot version (reference: meilitool OfflineUpgrade)
        from .engine.dumps import (
            create_packed_checkpoint,
            load_packed_checkpoint,
        )
        from .engine.scheduler import IndexScheduler

        scheduler = IndexScheduler(autobatching_enabled=False)
        if not load_packed_checkpoint(scheduler, args.db_path):
            print("no packed checkpoint found at that db path")
            return
        # force every deferred index through the (possibly v1) loader so
        # the rewrite below lands in the current packed format
        for _uid, _store in scheduler.indexes.items():
            pass
        create_packed_checkpoint(scheduler, args.db_path)
        print(f"{args.db_path} rewritten at the current engine formats")
        scheduler.stop()
    elif args.command == "hair-dryer":
        import os

        touched = 0
        for root, _dirs, files in os.walk(args.db_path):
            for name in files:
                if not name.endswith((".npy", ".jsonl", ".json")):
                    continue
                path = os.path.join(root, name)
                with open(path, "rb", buffering=1 << 20) as fh:
                    while fh.read(1 << 22):
                        pass
                touched += 1
        print(f"warmed {touched} files under {args.db_path}")
    elif args.command == "explain-query":
        scheduler = _load_instance(args.snapshot)
        from .search.logger import explain_query

        info = explain_query(scheduler.index(args.index), args.query)
        if args.dot_only:
            print(info["dot"])
        else:
            print(json.dumps(info, indent=2, ensure_ascii=False))
        scheduler.stop()


def generate_openapi(device=None) -> dict:
    """Emit an OpenAPI spec from the live route table
    (reference: crates/openapi-generator emits openapi.json from the route
    tree; here the dispatcher IS the route tree so the spec cannot drift).
    The App is built on `device` (None: the card)."""
    from .api.app import App, VERSION

    app = App(device=device)
    try:
        paths: dict = {}
        for route in app.routes:
            path = route.pattern
            entry = paths.setdefault(path, {})
            entry[route.method.lower()] = {
                "operationId": f"{route.method.lower()}_{path.strip('/').replace('/', '_').replace('{', '').replace('}', '') or 'root'}",
                "security": []
                if route.action == "public"
                else [{"apiKey": [route.action]}],
                "responses": {"default": {"description": "JSON response"}},
                "parameters": [
                    {
                        "name": name,
                        "in": "path",
                        "required": True,
                        "schema": {"type": "string"},
                    }
                    for name in route.param_names
                ],
            }
        return {
            "openapi": "3.1.0",
            "info": {"title": "meilisearch-tpu", "version": VERSION},
            "paths": dict(sorted(paths.items())),
            "components": {
                "securitySchemes": {
                    "apiKey": {"type": "http", "scheme": "bearer"}
                }
            },
        }
    finally:
        app.search_batcher.stop()
        app.scheduler.stop()


if __name__ == "__main__":
    main()
