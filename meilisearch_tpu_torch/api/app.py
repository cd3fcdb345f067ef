"""HTTP application: the full route tree with an in-process dispatcher.

The App serves on an explicit torch device: `POST /indexes/{uid}/search`
drains through `app.search_batcher` and `/multi-search` through
`perform_search_many`, both on `app.device`; the typo pass of every
index runs its whole-vocabulary OSA on that device (K3) where the
vocabulary is large enough, and its vector searches keep their matrices
there (K4h for binary-quantized embedders).

Reference: crates/meilisearch/src/routes/mod.rs:87-110 (top-level scopes) and
routes/indexes/mod.rs:42-54 (per-index sub-routes). The app object dispatches
(method, path) to handlers; `TestClient` exercises it in-process exactly like
the reference's actix `init_service` test pattern
(crates/meilisearch/tests/common/service.rs:190), and api/server.py binds the
same dispatcher to a socket.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.parse
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Union

import torch

from ..engine.auth import AuthController
from ..engine.scheduler import IndexScheduler
from ..engine.tasks import TaskStatus, TaskType
from ..types.errors import EngineError, ErrorCode
from ..ops.backend_probe import resolve_device
from ..types.settings import Settings
from .routes_indexes import register_index_routes
from .routes_misc import register_misc_routes

VERSION = "1.50.0"


@dataclass
class Request:
    method: str
    path: str
    query: dict = field(default_factory=dict)
    body: Any = None
    headers: dict = field(default_factory=dict)
    params: dict = field(default_factory=dict)
    raw_body: Optional[bytes] = None

    @property
    def auth_token(self) -> Optional[str]:
        header = self.headers.get("authorization") or self.headers.get(
            "Authorization"
        )
        if header is None:
            return None
        if header.startswith("Bearer "):
            return header[len("Bearer ") :]
        return header


@dataclass
class Response:
    status: int
    json: Any = None
    headers: dict = field(default_factory=dict)
    body: Optional[bytes] = None
    # generator of bytes chunks for streaming routes (/logs/stream); the
    # socket server sends them with chunked transfer encoding
    stream: Any = None


class Route:
    def __init__(self, method: str, pattern: str, action: str, handler):
        self.method = method
        self.pattern = pattern
        self.action = action
        self.handler = handler
        regex = "^"
        self.param_names = []
        for part in pattern.strip("/").split("/"):
            regex += "/"
            if part.startswith("{") and part.endswith("}"):
                name = part[1:-1]
                self.param_names.append(name)
                regex += f"(?P<{name}>[^/]+)"
            else:
                regex += re.escape(part)
        if pattern == "/":
            regex = "^/"
        regex += "$"
        self.regex = re.compile(regex)


def _batcher_handles(req) -> bool:
    """Whether this request is served through the SearchBatcher, in which
    case it must NOT consume a search-queue permit: batched requests wait
    inside the batcher (not on a core) and execute as one grouped device
    batch. The permit's capacity is per-core (reference search_queue.rs:31
    bounds CPU-bound searches) — on a 1-core host it is 2, and gating the
    batcher behind it capped drains at 2, which silently disabled device
    serving under load."""
    if req.method != "POST":
        return False
    if getattr(req, "_route_pattern", None) != "/indexes/{index_uid}/search":
        return False
    from ..engine.batcher import microbatch_enabled

    return (
        microbatch_enabled()
        and (req.body or {}).get("personalize") is None
    )


class App:
    """`device` None means CUDA (and raises without it). `strict` sends
    every eligible query to the device path, whatever the batch size, and
    every typo term to the device OSA pass, whatever the vocabulary
    size."""

    def __init__(
        self,
        scheduler: Optional[IndexScheduler] = None,
        master_key: Optional[str] = None,
        personalization_api_key: Optional[str] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
        strict: bool = False,
    ):
        self.device = resolve_device(device)
        self.strict = strict
        self.scheduler = scheduler or IndexScheduler()
        self.scheduler.indexes.bind_device(self.device, strict)
        self.auth = AuthController(master_key)
        self.routes: list[Route] = []
        self.started_at = time.time()
        from ..engine.search_queue import SearchQueue
        from ..vector.personalization import PersonalizationService

        self.search_queue = SearchQueue()
        from ..engine.batcher import SearchBatcher

        self.search_batcher = SearchBatcher(self.device, strict=strict)
        self.personalization = PersonalizationService(personalization_api_key)
        # dumps created by scheduler tasks include the API keys
        self.scheduler.auth_ref = self.auth
        # request metrics (reference metrics.rs histogram buckets)
        self.http_metrics = {
            "requests": {},
            "histogram": {},
            "buckets": [0.0005, 0.0008, 0.001, 0.005, 0.01, 0.025, 0.05,
                        0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0],
            "time_sum": 0.0,
            "time_count": 0,
            "degraded": 0,
        }
        register_misc_routes(self)
        register_index_routes(self)
        if self.device.type == "cuda":
            # build the kernels (K1, K3 and K4h, one library) while documents
            # are ingested, off the serving path
            from ..ops._build import load_library

            threading.Thread(
                target=load_library, name="kernel-build", daemon=True
            ).start()

    def warm_devices(self) -> None:
        """Build the kernels, warm every loaded index's plane bucket and
        upload its embedders' vector matrices on this App's device,
        waiting for all of it (the server's synchronous boot warm). Raises
        when a build, a warm-up or an upload fails."""
        from ..search.device_batch import warm_kernels
        from ..vector.store import warm_vector_kernels

        if self.device.type == "cuda":
            from ..ops._build import load_library

            load_library()
        for store in self.scheduler.list_indexes():
            warm_kernels(store, self.device, wait=True)
            warm_vector_kernels(store)

    # -- route registration ----------------------------------------------

    def route(self, method: str, pattern: str, action: str):
        def decorator(fn):
            self.routes.append(Route(method, pattern, action, fn))
            return fn

        return decorator

    def add(self, method: str, pattern: str, action: str, fn):
        self.routes.append(Route(method, pattern, action, fn))

    # -- dispatch -----------------------------------------------------------

    def handle(self, req: Request) -> Response:
        """Dispatch + the Prometheus request instrumentation
        (reference metrics.rs: MEILISEARCH_HTTP_REQUESTS_TOTAL,
        MEILISEARCH_HTTP_RESPONSE_TIME_SECONDS,
        MEILISEARCH_DEGRADED_SEARCH_REQUESTS)."""
        started = time.perf_counter()
        res = self._dispatch(req)
        try:
            pattern = getattr(req, "_route_pattern", req.path)
            key = (req.method, pattern, res.status)
            self.http_metrics["requests"][key] = (
                self.http_metrics["requests"].get(key, 0) + 1
            )
            elapsed = time.perf_counter() - started
            for b in self.http_metrics["buckets"]:
                if elapsed <= b:
                    self.http_metrics["histogram"][b] = (
                        self.http_metrics["histogram"].get(b, 0) + 1
                    )
            self.http_metrics["time_sum"] += elapsed
            self.http_metrics["time_count"] += 1
            if isinstance(res.json, dict) and res.json.get("degraded"):
                self.http_metrics["degraded"] += 1
        except Exception:
            pass
        return res

    # document-payload routes accept json/ndjson/csv and do their own
    # content-type validation (routes_indexes.parse_documents_payload)
    _DOCS_PAYLOAD_ROUTE = re.compile(r"^/indexes/[^/]+/documents$")

    def _check_content_type(self, req: Request, path: str):
        """Strict-JSON content-type enforcement on body-bearing routes
        (reference: actix JSON extractor; tests/content_type.rs pins 415
        with these exact messages). Payload-less requests (e.g. POST
        /dumps) pass through; documents payload routes accept more types
        and validate themselves."""
        if req.method not in ("POST", "PUT", "PATCH"):
            return None
        has_payload = bool(req.raw_body) or req.body is not None
        if not has_payload:
            return None
        if req.method in ("POST", "PUT") and self._DOCS_PAYLOAD_ROUTE.match(
            path
        ):
            return None
        ct = None
        for k, v in req.headers.items():
            if k.lower() == "content-type":
                ct = v
                break
        if not ct:
            return Response(
                415,
                {
                    "message": "A Content-Type header is missing. Accepted"
                    " values for the Content-Type header are:"
                    " `application/json`",
                    "code": "missing_content_type",
                    "type": "invalid_request",
                    "link": "https://docs.meilisearch.com/errors#missing_content_type",
                },
            )
        if ct.split(";")[0].strip() != "application/json":
            return Response(
                415,
                {
                    "message": f"The Content-Type `{ct}` is invalid."
                    " Accepted values for the Content-Type header are:"
                    " `application/json`",
                    "code": "invalid_content_type",
                    "type": "invalid_request",
                    "link": "https://docs.meilisearch.com/errors#invalid_content_type",
                },
            )
        return None

    def _dispatch(self, req: Request) -> Response:
        try:
            path = req.path.rstrip("/") or "/"
            ct_error = self._check_content_type(req, path)
            if ct_error is not None:
                return ct_error
            matched_path = False
            for route in self.routes:
                m = route.regex.match(path)
                if not m:
                    continue
                matched_path = True
                if route.method != req.method:
                    continue
                req._route_pattern = route.pattern
                # percent-decode each captured segment AFTER routing, like
                # actix match_info (so an encoded `/` in a document id does
                # not split the path)
                req.params = {
                    k: urllib.parse.unquote(v) if isinstance(v, str) else v
                    for k, v in m.groupdict().items()
                }
                index_uid = req.params.get("index_uid")
                auth_ctx = {}
                if route.action != "public":
                    auth_ctx = self.auth.authenticate(
                        req.auth_token, route.action, index_uid
                    )
                req.params["_auth"] = auth_ctx
                if route.action == "search" and not _batcher_handles(req):
                    with self.search_queue.permit():
                        result = route.handler(self, req)
                else:
                    result = route.handler(self, req)
                if isinstance(result, Response):
                    return result
                return Response(200, json=result)
            if matched_path:
                return Response(
                    405,
                    json={
                        "message": f"Method `{req.method}` is not allowed on"
                        f" route `{path}`.",
                        "code": "bad_request",
                        "type": "invalid_request",
                        "link": "https://docs.meilisearch.com/errors#bad_request",
                    },
                )
            return Response(
                404,
                json={
                    "message": f"Route `{req.method} {path}` not found.",
                    "code": "not_found",
                    "type": "invalid_request",
                    "link": "https://docs.meilisearch.com/errors#not_found",
                },
            )
        except EngineError as err:
            headers = {}
            if err.code is ErrorCode.TOO_MANY_SEARCH_REQUESTS:
                # reference search_queue.rs: bumped requests carry a
                # Retry-After header (pinned by search_queue.rs snapshots)
                headers["Retry-After"] = "10"
            return Response(
                getattr(err, "status", None) or err.code.http_status,
                json=err.to_json(),
                headers=headers,
            )
        except Exception as err:  # internal
            import traceback

            traceback.print_exc()
            return Response(
                500,
                json={
                    "message": str(err),
                    "code": "internal",
                    "type": "internal",
                    "link": "https://docs.meilisearch.com/errors#internal",
                },
            )


class TestClient:
    """In-process client (the actix test::init_service twin)."""

    __test__ = False  # not a pytest class

    def __init__(self, app: App, api_key: Optional[str] = None):
        self.app = app
        self.api_key = api_key

    def request(
        self,
        method: str,
        path: str,
        body: Any = None,
        headers: Optional[dict] = None,
        raw_body: Optional[bytes] = None,
    ) -> Response:
        # split on `?` only: `#` is NOT a fragment delimiter in an HTTP
        # request-target, it travels raw to the server (urlparse would
        # silently drop `#...` and mis-route uids containing `#`)
        raw_path, _, raw_query = path.partition("?")
        query = {
            k: v[0] if len(v) == 1 else v
            for k, v in urllib.parse.parse_qs(raw_query).items()
        }
        hdrs = dict(headers or {})
        if self.api_key and "authorization" not in {
            k.lower() for k in hdrs
        }:
            hdrs["Authorization"] = f"Bearer {self.api_key}"
        if body is not None and "content-type" not in {
            k.lower() for k in hdrs
        }:
            # in-process tests ship parsed bodies; default the header the
            # way a real JSON client would. raw_body callers control
            # their own headers (content_type.rs enforcement).
            hdrs["Content-Type"] = "application/json"
        req = Request(
            method=method,
            path=raw_path,
            query=query,
            body=body,
            headers=hdrs,
            raw_body=raw_body,
        )
        return self.app.handle(req)

    def get(self, path, **kw):
        return self.request("GET", path, **kw)

    def post(self, path, body=None, **kw):
        return self.request("POST", path, body=body, **kw)

    def put(self, path, body=None, **kw):
        return self.request("PUT", path, body=body, **kw)

    def patch(self, path, body=None, **kw):
        return self.request("PATCH", path, body=body, **kw)

    def delete(self, path, **kw):
        return self.request("DELETE", path, **kw)

    # -- helpers mirroring the reference test server ------------------------

    def wait_for_task(self, task_uid: int):
        task = self.app.scheduler.wait_for_task(task_uid)
        return task.to_json()

    def add_documents(self, index_uid: str, docs, primary_key=None):
        path = f"/indexes/{index_uid}/documents"
        if primary_key:
            path += f"?primaryKey={primary_key}"
        res = self.post(path, body=docs)
        assert res.status == 202, res.json
        return self.wait_for_task(res.json["taskUid"])

    def update_settings(self, index_uid: str, settings: dict):
        res = self.patch(f"/indexes/{index_uid}/settings", body=settings)
        assert res.status == 202, res.json
        return self.wait_for_task(res.json["taskUid"])

    def search(self, index_uid: str, query: dict):
        res = self.post(f"/indexes/{index_uid}/search", body=query)
        return res
