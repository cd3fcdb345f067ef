"""HTTP server binding the route dispatcher to a socket.

Run: `python -m meilisearch_tpu_torch.api.server --port 7700 [--master-key KEY]`
(the reference binary's `meilisearch --http-addr ...` equivalent,
crates/meilisearch/src/main.rs). It serves on CUDA, refuses to start
without a GPU, and never loads jax.
"""

from __future__ import annotations

import argparse
import json
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .app import App, Request


def make_handler(app: App, payload_limit: int | None = None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # keep-alive + small JSON responses: Nagle vs delayed-ACK adds a
        # flat ~40 ms to every request on a persistent connection
        disable_nagle_algorithm = True

        def _dispatch(self, method: str):
            # split on `?` only — `#` travels raw in a request-target
            raw_path, _, raw_query = self.path.partition("?")
            query = {
                k: v[0] if len(v) == 1 else v
                for k, v in urllib.parse.parse_qs(raw_query).items()
            }
            length = int(self.headers.get("Content-Length") or 0)
            if payload_limit is not None and length > payload_limit:
                # reference: http_payload_size_limit (option.rs:269) ->
                # 413 payload_too_large
                self.rfile.read(length)
                self._send(
                    413,
                    {
                        "message": "The provided payload reached the size"
                        f" limit. The maximum accepted payload size is"
                        f" {payload_limit} bytes.",
                        "code": "payload_too_large",
                        "type": "invalid_request",
                        "link": "https://docs.meilisearch.com/errors#payload_too_large",
                    },
                )
                return
            raw = self.rfile.read(length) if length else b""
            body = None
            content_type = (self.headers.get("Content-Type") or "").split(";")[0]
            if raw and content_type in ("application/json", ""):
                try:
                    body = json.loads(raw.decode("utf-8"))
                except json.JSONDecodeError as err:
                    self._send(
                        400,
                        {
                            "message": f"The json payload provided is malformed. `{err}`.",
                            "code": "malformed_payload",
                            "type": "invalid_request",
                            "link": "https://docs.meilisearch.com/errors#malformed_payload",
                        },
                    )
                    return
            req = Request(
                method=method,
                path=raw_path,
                query=query,
                body=body,
                headers={k.lower(): v for k, v in self.headers.items()},
                raw_body=raw or None,
            )
            res = app.handle(req)
            if getattr(res, "stream", None) is not None:
                self.send_response(res.status)
                for k, v in res.headers.items():
                    self.send_header(k, v)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for chunk in res.stream:
                        self.wfile.write(
                            f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n"
                        )
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
                return
            if res.body is not None:
                self.send_response(res.status)
                for k, v in res.headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(res.body)))
                self.end_headers()
                self.wfile.write(res.body)
            else:
                self._send(res.status, res.json, res.headers)

        def _send(self, status: int, payload, headers=None):
            data = b"" if payload is None else json.dumps(payload).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            if data:
                self.wfile.write(data)

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def do_PUT(self):
            self._dispatch("PUT")

        def do_PATCH(self):
            self._dispatch("PATCH")

        def do_DELETE(self):
            self._dispatch("DELETE")

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(
    host: str = "127.0.0.1",
    port: int = 7700,
    master_key=None,
    app=None,
    payload_limit: int | None = None,
    ssl_cert: str | None = None,
    ssl_key: str | None = None,
    ssl_require_auth: bool = False,
    ssl_auth_path: str | None = None,
):
    app = app or App(master_key=master_key)
    server = ThreadingHTTPServer(
        (host, port), make_handler(app, payload_limit=payload_limit)
    )
    scheme = "http"
    if ssl_cert and ssl_key:
        # reference: option.rs get_ssl_config (rustls); here the stdlib TLS
        # stack serves the same certificate options
        import ssl as _ssl

        ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(ssl_cert, ssl_key)
        if ssl_auth_path:
            ctx.load_verify_locations(capath=None, cafile=ssl_auth_path)
            ctx.verify_mode = (
                _ssl.CERT_REQUIRED if ssl_require_auth else _ssl.CERT_OPTIONAL
            )
        server.socket = ctx.wrap_socket(server.socket, server_side=True)
        scheme = "https"
    print(f"meilisearch-tpu listening on {scheme}://{host}:{port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


def main():
    import atexit
    import os

    from .._hooks import block_jax

    block_jax()  # the port never loads jax, even where it is installed

    from ..engine.dumps import create_snapshot, load_dump, load_snapshot
    from ..option import load_options

    opt = load_options()
    app = App(
        master_key=opt.master_key,
        personalization_api_key=opt.experimental_personalization_api_key,
    )
    # runtime features and tunables from the option surface
    # (reference: lib.rs:219 setup_meilisearch wiring)
    feats = app.scheduler.runtime_features
    if opt.experimental_enable_metrics:
        feats["metrics"] = True
    if opt.experimental_contains_filter:
        feats["containsFilter"] = True
    if opt.experimental_enable_logs_route:
        feats["logsRoute"] = True
    app.scheduler.dump_dir = opt.dump_dir
    if opt.experimental_docs_on_disk:
        # new indexes spill document bodies to disk (index/docs.py)
        os.environ["MEILI_TPU_DOCS_SPILL"] = "1"
    from ..engine.s3_snapshot import S3SnapshotOpts

    app.scheduler.s3_opts = S3SnapshotOpts.from_options(opt)
    if opt.experimental_max_number_of_batched_tasks:
        app.scheduler.max_batched_tasks = (
            opt.experimental_max_number_of_batched_tasks
        )
    from ..engine.search_queue import SearchQueue
    from ..option import parse_byte_size

    app.search_queue = SearchQueue(
        capacity=opt.experimental_search_queue_size,
        parallelism=max(
            1,
            (os.cpu_count() or 1) * opt.experimental_nb_searches_per_core,
        ),
        drop_after_s=float(opt.experimental_drop_search_after),
    )
    if opt.experimental_allowed_ip_networks:
        os.environ.setdefault(
            "MEILI_EXPERIMENTAL_ALLOWED_IP_NETWORKS",
            opt.experimental_allowed_ip_networks,
        )
    if opt.task_webhook_url:
        import uuid as _uuid

        headers = {}
        if opt.task_webhook_authorization_header:
            headers["Authorization"] = opt.task_webhook_authorization_header
        app.scheduler.webhooks[str(_uuid.uuid4())] = {
            "url": opt.task_webhook_url,
            "headers": headers,
            "isEditable": False,  # CLI-defined (reference webhooks route)
        }

    # boot-time state restore: explicit imports win over the db-path snapshot
    # (reference: lib.rs open_or_create_database --import-dump/--import-snapshot)
    from ..engine.journal import TaskJournal, replay_journal

    os.makedirs(opt.db_path, exist_ok=True)
    journal = TaskJournal(opt.db_path)
    db_snapshot = os.path.join(opt.db_path, "data.ms.snapshot")
    db_exists = os.path.exists(db_snapshot) or os.path.exists(
        os.path.join(opt.db_path, "instance.json")
    )

    def resolve_import(path, kind, ignore_missing, ignore_if_db_exists):
        """--import-{dump,snapshot} with the reference's ignore flags
        (option.rs:318,331,356,365): returns the path to import or None."""
        if not path or (ignore_if_db_exists and db_exists):
            return None
        if not os.path.exists(path):
            if ignore_missing:
                return None
            raise SystemExit(f"error: {kind} file `{path}` not found")
        return path

    dump_path = resolve_import(
        opt.import_dump, "dump", opt.ignore_missing_dump,
        opt.ignore_dump_if_db_exists,
    )
    snap_path = resolve_import(
        opt.import_snapshot, "snapshot", opt.ignore_missing_snapshot,
        opt.ignore_snapshot_if_db_exists,
    )
    if dump_path:
        load_dump(app.scheduler, dump_path, auth=app.auth)
        journal.clear()  # explicit import = fresh history
    elif snap_path:
        load_snapshot(app.scheduler, snap_path)
        journal.clear()
    else:
        from ..engine.dumps import load_packed_checkpoint

        if load_packed_checkpoint(app.scheduler, opt.db_path):
            pass  # packed columnar checkpoint (fast mmap'd restore)
        elif db_exists:
            load_snapshot(
                app.scheduler, db_snapshot, allow_upgrade=opt.upgrade_db
            )
        # crash recovery: acknowledged-but-unsnapshotted tasks re-enqueue
        # from the WAL and reprocess (idempotent-by-replay, SURVEY §5)
        replayed = replay_journal(app.scheduler, journal)
        if replayed:
            print(f"replayed {replayed} journaled task(s) from the WAL")
    app.scheduler.journal = journal
    app.scheduler.indexes.db_dir = os.path.join(opt.db_path, "indexes")

    def persist():
        try:
            app.scheduler.checkpoint()
        except Exception:
            pass

    atexit.register(persist)
    # SIGTERM (systemd/docker/timeout stop) bypasses atexit by default;
    # checkpoint directly and exit hard (raising SystemExit instead
    # deadlocks in serve()'s finally: server.shutdown() waits for a
    # serve_forever loop that already unwound). A SIGKILL crash is
    # covered by WAL replay instead (engine/journal.py).
    import signal

    def _graceful_term(signum, frame):
        persist()
        os._exit(0)

    try:
        signal.signal(signal.SIGTERM, _graceful_term)
    except ValueError:
        pass  # not the main thread (embedded use)

    if opt.schedule_snapshot:
        import threading

        def snapshot_loop():
            import time as _t

            while True:
                _t.sleep(opt.schedule_snapshot)
                try:
                    os.makedirs(opt.snapshot_dir, exist_ok=True)
                    create_snapshot(app.scheduler, opt.snapshot_dir)
                    # a scheduled snapshot is also a durability checkpoint
                    app.scheduler.checkpoint()
                except Exception:
                    pass

        threading.Thread(target=snapshot_loop, daemon=True).start()

    if opt.experimental_boot_warm_sync:
        # ready-or-silent contract: the socket below only opens once every
        # loaded index serves warm (host caches + device kernels) — a
        # connection refused IS the "not healthy yet" signal
        import time as _t

        t0 = _t.monotonic()
        app.scheduler.boot_warm_sync()
        app.warm_devices()
        print(f"boot warm (sync) completed in {_t.monotonic() - t0:.1f}s")

    serve(
        opt.host,
        opt.port,
        app=app,
        payload_limit=parse_byte_size(opt.http_payload_size_limit),
        ssl_cert=opt.ssl_cert_path,
        ssl_key=opt.ssl_key_path,
        ssl_require_auth=opt.ssl_require_auth,
        ssl_auth_path=opt.ssl_auth_path,
    )


if __name__ == "__main__":
    main()
