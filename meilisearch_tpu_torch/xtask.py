"""Declarative workload runner — the `cargo xtask test` / `xtask bench`
equivalent (reference: crates/xtask/src/test/ + /src/bench/, TESTING.md,
workloads/*.json).

Two modes over the same JSON shape:

  python -m meilisearch_tpu_torch.xtask test 'workloads/tests/*.json' [--device cpu]
  python -m meilisearch_tpu_torch.xtask bench workloads/hackernews-10k.json [--device cpu]

A workload is `{"type": "test"|"bench", "name": ..., "assets": {...},
"commands": [...]}`. Commands mirror the reference command schema
(xtask/src/test/): `route`, `method`, `body` ({"inline": ...} or
{"asset": name}), `expectedStatus`, `expectedResponse` (recursive subset
match; `"[ignore]"` skips a value), `register` (capture response values
by JSON pointer into template vars, used later as `{{ var }}`), and
`synchronous` (`WaitForTask` | `WaitForResponse` | `DontWait`).

Where the reference chains *released binaries* to test upgrades
(`"binary": {...}` steps relaunch a different meilisearch build), this
engine has one binary but versioned on-disk formats — a
`{"restart": {...}}` step snapshots the instance, optionally restamps
the snapshot's format version to an OLDER one (`"formatVersion": N`),
and boots a FRESH instance from it through the version gate + migration
chain (engine/versioning.py). That exercises the same contract: state
written by version N-1 must serve correctly under version N.

Assets are local-only (zero-egress image): `{"local_location": path}`
or `{"generator": "hackernews", "count": N}` which synthesizes the
benchmark corpus (utils/synthetic.py) — the reference's hackernews
asset download, minus the network.

Bench mode runs the commands against a real HTTP server while tailing
`/logs/stream?mode=profile` (utils/tracing.py), then reports per-span
total durations — the reference's span-duration benchmark model
(BENCHMARKS.md:9-17) rather than wall-clock only.

Every instance is the port's App on one torch device: `device=None` (the
CLI's default) is the card and raises without one, as the App does;
`"cpu"` serves with every kernel's plain version. After each
`WaitForTask` step and each restart the runner also waits for the
scheduler's device warm-up, so a search meets the device as it would
after a pause. Under `device_routing_forced()` the workloads' small
stores take the device legs too.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import re
import shutil
import sys
import tempfile
import time


class WorkloadError(AssertionError):
    pass


# the batch size under which the batcher sends a search to the host
# (search/device_batch.py::_device_worthwhile)
MIN_BATCH_ENV = "MEILI_TPU_DEVICE_MIN_BATCH"
WARM_TIMEOUT_S = 600.0


@contextlib.contextmanager
def device_routing_forced():
    """Route every search the port can put on its device there, however
    small the index, and restore the thresholds on exit: a lone keyword
    search takes a warm K1 bucket (MIN_BATCH_ENV 1), every vector matrix
    the device legs (vector/store.py's DEVICE_MIN_ROWS 1) and, on a CUDA
    device, every typo pass K3 (ops/device_osa.py's MIN_DEVICE_VOCAB 1).
    For runs over small stores, such as the declarative workloads', whose
    data and expectations stay as they are. The thresholds are the
    process's: not for use beside other serving threads."""
    from .ops import device_osa
    from .vector import store as vstore

    saved = (os.environ.get(MIN_BATCH_ENV), vstore.DEVICE_MIN_ROWS,
             device_osa.MIN_DEVICE_VOCAB)
    os.environ[MIN_BATCH_ENV] = "1"
    vstore.DEVICE_MIN_ROWS = 1
    device_osa.MIN_DEVICE_VOCAB = 1
    try:
        yield
    finally:
        if saved[0] is None:
            os.environ.pop(MIN_BATCH_ENV, None)
        else:
            os.environ[MIN_BATCH_ENV] = saved[0]
        vstore.DEVICE_MIN_ROWS, device_osa.MIN_DEVICE_VOCAB = saved[1:]


def _subst(obj, variables):
    """Replace {{ var }} templates in strings, recursively."""
    if isinstance(obj, str):
        def repl(m):
            name = m.group(1).strip()
            if name not in variables:
                raise WorkloadError(f"unregistered template var `{name}`")
            return str(variables[name])

        return re.sub(r"\{\{([^}]+)\}\}", repl, obj)
    if isinstance(obj, dict):
        return {k: _subst(v, variables) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_subst(v, variables) for v in obj]
    return obj


def _pointer(doc, pointer: str):
    """JSON-pointer-ish lookup: /a/0/b."""
    cur = doc
    for part in pointer.strip("/").split("/"):
        if isinstance(cur, list):
            cur = cur[int(part)]
        else:
            cur = cur[part]
    return cur


def _subset_match(expected, actual, path="$"):
    """Recursive subset equality; `"[ignore]"` matches anything."""
    if expected == "[ignore]":
        return
    if isinstance(expected, dict):
        if not isinstance(actual, dict):
            raise WorkloadError(f"{path}: expected object, got {actual!r}")
        for k, v in expected.items():
            if k not in actual:
                if v == "[ignore]":
                    continue  # ignored values may also be absent
                raise WorkloadError(f"{path}.{k}: missing in response")
            _subset_match(v, actual[k], f"{path}.{k}")
        return
    if isinstance(expected, list):
        if not isinstance(actual, list) or len(expected) != len(actual):
            raise WorkloadError(
                f"{path}: expected list of {len(expected)}, got {actual!r}"
            )
        for i, (e, a) in enumerate(zip(expected, actual)):
            _subset_match(e, a, f"{path}[{i}]")
        return
    if expected != actual:
        raise WorkloadError(f"{path}: expected {expected!r}, got {actual!r}")


def _load_asset(workload, name, base_dir):
    spec = (workload.get("assets") or {}).get(name)
    if spec is None:
        raise WorkloadError(f"unknown asset `{name}`")
    if spec.get("generator") == "hackernews":
        from .utils.synthetic import generate_hackernews_like

        return generate_hackernews_like(int(spec.get("count", 10000)))
    loc = spec.get("local_location")
    if not loc:
        raise WorkloadError(f"asset `{name}` has no local_location")
    path = loc if os.path.isabs(loc) else os.path.join(base_dir, loc)
    with open(path) as fh:
        if path.endswith(".ndjson") or path.endswith(".jsonl"):
            return [json.loads(line) for line in fh if line.strip()]
        return json.load(fh)


class _Instance:
    """One in-process engine instance behind a TestClient, on `device`."""

    def __init__(self, import_snapshot=None, allow_upgrade=False,
                 master_key=None, device=None):
        from .api.app import App, TestClient

        self.master_key = master_key
        self.app = App(master_key=master_key, device=device)
        self.device = self.app.device
        if import_snapshot is not None:
            # boot-style import: through the version gate + migrations
            from .engine.dumps import load_snapshot

            load_snapshot(
                self.app.scheduler,
                import_snapshot,
                allow_upgrade=allow_upgrade,
            )
        self.client = TestClient(self.app, api_key=master_key)

    def stop(self):
        self.app.search_batcher.stop()
        self.app.scheduler.stop()


def _wait_warm(inst: _Instance, name: str) -> None:
    if not inst.app.scheduler.wait_device_warm(timeout=WARM_TIMEOUT_S):
        raise WorkloadError(f"{name}: the device warm-up did not end in {WARM_TIMEOUT_S} s")


def run_workload(path: str, verbose: bool = True, device=None) -> None:
    with open(path) as fh:
        workload = json.load(fh)
    base_dir = os.path.dirname(os.path.abspath(path))
    name = workload.get("name", os.path.basename(path))
    variables: dict = {}
    inst = _Instance(master_key=workload.get("masterKey"), device=device)
    executed = 0
    try:
        for step in workload.get("commands", []):
            if "restart" in step:
                spec = step["restart"] or {}
                inst = _restart(inst, spec)
                _wait_warm(inst, name)
                variables["__restarts"] = variables.get("__restarts", 0) + 1
                continue
            step = _subst(step, variables)
            route = step["route"].lstrip("/")
            method = step.get("method", "GET").upper()
            body = step.get("body")
            payload = None
            if body is not None:
                if "inline" in body:
                    payload = body["inline"]
                elif "asset" in body:
                    payload = _load_asset(workload, body["asset"], base_dir)
            headers = {}
            if step.get("apiKeyVariable"):
                headers["Authorization"] = (
                    f"Bearer {variables[step['apiKeyVariable']]}"
                )
            res = inst.client.request(
                method, "/" + route, body=payload, headers=headers or None
            )
            expected = step.get("expectedStatus")
            if expected is not None and res.status != expected:
                raise WorkloadError(
                    f"{name}: {method} /{route} -> {res.status}"
                    f" (expected {expected}): {res.json}"
                )
            sync = step.get("synchronous", "WaitForResponse")
            if sync == "WaitForTask":
                inst.app.scheduler.wait_for_all_tasks()
                _wait_warm(inst, name)
                uid = (res.json or {}).get("taskUid")
                if uid is not None:
                    task = inst.client.get(f"/tasks/{uid}").json
                    if task.get("status") != "succeeded" and not step.get(
                        "expectFailedTask"
                    ):
                        raise WorkloadError(
                            f"{name}: task {uid} for {method} /{route}"
                            f" ended {task.get('status')}:"
                            f" {task.get('error')}"
                        )
            if "expectedResponse" in step:
                _subset_match(step["expectedResponse"], res.json)
            for var, pointer in (step.get("register") or {}).items():
                variables[var] = _pointer(res.json, pointer)
            executed += 1
        if verbose:
            print(f"workload `{name}`: {executed} commands OK")
    finally:
        inst.stop()


def _restart(inst: _Instance, spec: dict) -> _Instance:
    """Snapshot -> (optional format-version restamp) -> fresh instance
    booted through the version gate + migration chain, on the same device."""
    from .engine.dumps import create_snapshot

    tmp = tempfile.mkdtemp(prefix="xtask_restart_")
    try:
        snap = create_snapshot(inst.app.scheduler, tmp)
        inst.stop()
        return _boot(inst, spec, tmp, snap)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _boot(inst: _Instance, spec: dict, tmp: str, snap: str) -> _Instance:
    """A fresh instance from the snapshot, restamped first when `spec`
    names a formatVersion (its copy goes in `tmp`)."""
    import io
    import tarfile

    stamp = spec.get("formatVersion")
    if stamp is not None:
        # restamp the snapshot as an OLDER on-disk format so boot takes
        # the migration chain (the cross-version upgrade contract)
        restamped = os.path.join(tmp, "restamped.snapshot")
        with tarfile.open(snap) as tar, tarfile.open(
            restamped, "w:gz"
        ) as out:
            for member in tar.getmembers():
                data = tar.extractfile(member).read()
                if member.name.endswith("instance.json"):
                    meta = json.loads(data)
                    meta["formatVersion"] = stamp
                    data = json.dumps(meta).encode()
                    member.size = len(data)
                out.addfile(member, io.BytesIO(data))
        snap = restamped
    return _Instance(
        import_snapshot=snap,
        allow_upgrade=spec.get("upgradeDb", stamp is not None),
        master_key=inst.master_key,
        device=inst.device,
    )


def run_bench(path: str, device=None) -> dict:
    """Replay a bench workload over a real HTTP server, collecting span
    durations from /logs/stream profile mode (the reference's
    span-duration model)."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from .api.app import App
    from .api.server import make_handler

    with open(path) as fh:
        workload = json.load(fh)
    base_dir = os.path.dirname(os.path.abspath(path))
    app = App(device=device)
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(app))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()

    spans: dict[str, float] = {}
    counts: dict[str, int] = {}
    stop_tail = threading.Event()

    def tail():
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/logs/stream",
            data=json.dumps({"mode": "profile"}).encode(),
            method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                for line in resp:
                    if stop_tail.is_set():
                        break
                    try:
                        ev = json.loads(line)
                    except Exception:
                        continue
                    if ev.get("type") == "span" and "durationMs" in ev:
                        t = ev.get("target", ev.get("name", "?"))
                        spans[t] = spans.get(t, 0.0) + ev["durationMs"]
                        counts[t] = counts.get(t, 0) + 1
        except Exception:
            pass

    def http(method, route, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/{route.lstrip('/')}",
            data=data,
            method=method,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read() or b"null")

    # the reference bench runner enables the logs route before attaching
    # to /logs/stream (xtask/src/bench/, BENCHMARKS.md:30-46)
    http("PATCH", "experimental-features", {"logsRoute": True})
    tailer = threading.Thread(target=tail, daemon=True)
    tailer.start()
    time.sleep(0.2)  # let the profile subscriber attach

    t0 = time.perf_counter()
    n = 0
    for step in workload.get("commands", []):
        body = step.get("body") or {}
        payload = (
            body.get("inline")
            if "inline" in body
            else _load_asset(workload, body["asset"], base_dir)
            if "asset" in body
            else None
        )
        res = http(step.get("method", "GET").upper(), step["route"], payload)
        if step.get("synchronous", "WaitForResponse") == "WaitForTask":
            uid = (res or {}).get("taskUid")
            deadline = time.time() + 600
            while uid is not None and time.time() < deadline:
                task = http("GET", f"tasks/{uid}")
                if task["status"] in ("succeeded", "failed"):
                    break
                time.sleep(0.2)
        n += 1
    wall_s = time.perf_counter() - t0
    try:
        http("DELETE", "logs/stream")  # flush + close the profile feed
    except Exception:
        pass
    tailer.join(timeout=5)
    stop_tail.set()
    server.shutdown()
    app.search_batcher.stop()
    app.scheduler.stop()
    report = {
        "workload": workload.get("name", os.path.basename(path)),
        "commands": n,
        "wall_s": round(wall_s, 3),
        "spans_ms": {
            k: round(v, 1)
            for k, v in sorted(spans.items(), key=lambda kv: -kv[1])
        },
        "span_counts": counts,
    }
    print(json.dumps(report))
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(prog="meilisearch-tpu-torch-xtask")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, text in (("test", "run declarative test workloads"),
                       ("bench", "replay a bench workload, span-timed")):
        p = sub.add_parser(name, help=text)
        p.add_argument("paths", nargs="+")
        p.add_argument(
            "--device", default=None,
            help="torch device of every instance (default: the card; `cpu`"
            " runs the kernels' plain versions)",
        )
    args = parser.parse_args(argv)

    paths = []
    for pat in args.paths:
        paths.extend(sorted(glob.glob(pat)) or [pat])
    failed = 0
    for path in paths:
        if args.command == "test":
            try:
                run_workload(path, device=args.device)
            except Exception as e:  # noqa: BLE001 — reported per workload
                failed += 1
                print(f"workload FAILED: {path}: {e}", file=sys.stderr)
        else:
            run_bench(path, device=args.device)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
