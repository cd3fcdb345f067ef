"""S3 snapshot upload — EE parity with the reference's snapshot-to-S3
pipeline (index-scheduler/src/scheduler/enterprise_edition/s3.rs, options
option.rs:892-982).

The reference streams a tarball through presigned rusty_s3 URLs:
CreateMultipartUpload -> UploadPart x N (bounded in-flight) ->
CompleteMultipartUpload, falling back to abort on failure. This module
reproduces that flow over stdlib only: SigV4 *query* signing (presigned
URLs, UNSIGNED-PAYLOAD) and urllib for transport, with a single presigned
PUT for archives under the part size. Web-identity STS federation
(s3.rs:15 assume_role_with_web_identity) is accepted in options but needs
egress to sts.amazonaws.com; it raises a clear error in this zero-egress
build.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import os
import time
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Optional

# reference option.rs:102-105
DEFAULT_MAX_IN_FLIGHT_PARTS = 10
DEFAULT_SIGNATURE_DURATION_S = 8 * 3600
DEFAULT_PART_SIZE = 375 * 1024 * 1024  # 375 MiB


@dataclasses.dataclass
class S3SnapshotOpts:
    """reference option.rs:892 S3SnapshotOpts (clap group `requires_all`)."""

    bucket_url: str
    bucket_region: str
    bucket_name: str
    snapshot_prefix: str
    access_key: Optional[str] = None
    secret_key: Optional[str] = None
    session_token: Optional[str] = None
    signature_duration_s: int = DEFAULT_SIGNATURE_DURATION_S
    part_size: int = DEFAULT_PART_SIZE
    max_in_flight_parts: int = DEFAULT_MAX_IN_FLIGHT_PARTS

    @classmethod
    def from_options(cls, opt) -> Optional["S3SnapshotOpts"]:
        """Build from the Opt namespace; None unless the required group is
        complete (clap: requires_all on url/region/name/prefix/auth)."""
        required = (
            getattr(opt, "s3_bucket_url", None),
            getattr(opt, "s3_bucket_region", None),
            getattr(opt, "s3_bucket_name", None),
            getattr(opt, "s3_snapshot_prefix", None),
        )
        if not all(required):
            return None
        if getattr(opt, "experimental_s3_role_arn", None) and not getattr(
            opt, "s3_access_key", None
        ):
            raise RuntimeError(
                "S3 web-identity federation requires egress to "
                "sts.amazonaws.com, which this build does not have; "
                "provide --s3-access-key/--s3-secret-key instead"
            )
        return cls(
            bucket_url=required[0].rstrip("/"),
            bucket_region=required[1],
            bucket_name=required[2],
            snapshot_prefix=required[3].strip("/"),
            access_key=getattr(opt, "s3_access_key", None),
            secret_key=getattr(opt, "s3_secret_key", None),
            signature_duration_s=int(
                getattr(opt, "experimental_s3_signature_duration_seconds", None)
                or DEFAULT_SIGNATURE_DURATION_S
            ),
            part_size=_parse_part_size(
                getattr(opt, "experimental_s3_multipart_part_size", None)
            ),
            max_in_flight_parts=int(
                getattr(opt, "experimental_s3_max_in_flight_parts", None)
                or DEFAULT_MAX_IN_FLIGHT_PARTS
            ),
        )


def _parse_part_size(value) -> int:
    if value is None:
        return DEFAULT_PART_SIZE
    if isinstance(value, int):
        return value
    from ..option import parse_byte_size

    return parse_byte_size(value) or DEFAULT_PART_SIZE


def _uri_encode(value: str, encode_slash: bool = True) -> str:
    """AWS SigV4 URI encoding (RFC 3986 unreserved set)."""
    safe = "-._~" if encode_slash else "-._~/"
    return urllib.parse.quote(value, safe=safe)


def _signing_key(secret_key: str, date: str, region: str, service: str) -> bytes:
    k = hmac.new(("AWS4" + secret_key).encode(), date.encode(), hashlib.sha256).digest()
    k = hmac.new(k, region.encode(), hashlib.sha256).digest()
    k = hmac.new(k, service.encode(), hashlib.sha256).digest()
    return hmac.new(k, b"aws4_request", hashlib.sha256).digest()


def presign(
    method: str,
    endpoint: str,
    region: str,
    path: str,
    query: dict,
    access_key: str,
    secret_key: str,
    session_token: Optional[str] = None,
    expires: int = DEFAULT_SIGNATURE_DURATION_S,
    now: Optional[time.struct_time] = None,
) -> str:
    """Presigned-URL SigV4 (query parameters, UNSIGNED-PAYLOAD) — the
    rusty_s3 `action.sign(duration)` equivalent. `path` is the absolute
    key path on the endpoint host (path-style bucket addressing)."""
    if now is None:
        now = time.gmtime()
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", now)
    date = amz_date[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    parsed = urllib.parse.urlparse(endpoint)
    host = parsed.netloc

    q = dict(query)
    q["X-Amz-Algorithm"] = "AWS4-HMAC-SHA256"
    q["X-Amz-Credential"] = f"{access_key}/{scope}"
    q["X-Amz-Date"] = amz_date
    q["X-Amz-Expires"] = str(expires)
    if session_token is not None:
        q["X-Amz-Security-Token"] = session_token
    q["X-Amz-SignedHeaders"] = "host"

    canonical_query = "&".join(
        f"{_uri_encode(k)}={_uri_encode(str(v))}" for k, v in sorted(q.items())
    )
    canonical_request = "\n".join(
        [
            method,
            _uri_encode(path, encode_slash=False),
            canonical_query,
            f"host:{host}\n",
            "host",
            "UNSIGNED-PAYLOAD",
        ]
    )
    string_to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical_request.encode()).hexdigest(),
        ]
    )
    signature = hmac.new(
        _signing_key(secret_key, date, region, "s3"),
        string_to_sign.encode(),
        hashlib.sha256,
    ).hexdigest()
    return (
        f"{parsed.scheme}://{host}{_uri_encode(path, encode_slash=False)}"
        f"?{canonical_query}&X-Amz-Signature={signature}"
    )


def _request(method: str, url: str, body: Optional[bytes] = None, retries: int = 3):
    """One signed S3 call with the reference's retry posture (s3.rs:577
    retries the complete call; parts retry on transport errors)."""
    from ..utils.http_policy import check_url_policy

    check_url_policy(url)
    last: Optional[Exception] = None
    for attempt in range(retries):
        try:
            req = urllib.request.Request(url, data=body, method=method)
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as err:  # status errors do not retry
            raise RuntimeError(
                f"S3 {method} failed with {err.code}: {err.read()[:200]!r}"
            ) from err
        except Exception as err:  # noqa: BLE001 — transport: retry
            last = err
            time.sleep(0.2 * (attempt + 1))
    raise RuntimeError(f"S3 {method} failed after {retries} tries: {last}")


def upload_snapshot_to_s3(
    archive_path: str, opts: S3SnapshotOpts, db_name: str = "data.ms"
) -> str:
    """Upload a snapshot archive; returns the object key.

    Mirrors s3.rs:382 multipart_stream_to_s3: path-style object
    `{prefix}/{db_name}.snapshot`, multipart above one part size."""
    if not opts.access_key or not opts.secret_key:
        raise RuntimeError("S3 snapshot upload requires access and secret keys")
    key = f"{opts.snapshot_prefix}/{db_name}.snapshot"
    path = f"/{opts.bucket_name}/{key}"
    size = os.path.getsize(archive_path)

    def sign(method: str, query: dict) -> str:
        return presign(
            method,
            opts.bucket_url,
            opts.bucket_region,
            path,
            query,
            opts.access_key,
            opts.secret_key,
            opts.session_token,
            opts.signature_duration_s,
        )

    with open(archive_path, "rb") as fh:
        if size <= opts.part_size:
            _request("PUT", sign("PUT", {}), fh.read())
            return key
        _, body, _ = _request("POST", sign("POST", {"uploads": ""}))
        upload_id = _parse_xml_field(body, "UploadId")
        etags: list[str] = []
        part_number = 1
        try:
            while True:
                chunk = fh.read(opts.part_size)
                if not chunk:
                    break
                _, _, headers = _request(
                    "PUT",
                    sign(
                        "PUT",
                        {"partNumber": str(part_number), "uploadId": upload_id},
                    ),
                    chunk,
                )
                etags.append(headers.get("ETag", "").strip())
                part_number += 1
            parts_xml = "".join(
                f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{etag}</ETag></Part>"
                for i, etag in enumerate(etags)
            )
            complete = (
                "<CompleteMultipartUpload>" + parts_xml + "</CompleteMultipartUpload>"
            )
            _request(
                "POST", sign("POST", {"uploadId": upload_id}), complete.encode()
            )
        except Exception:
            try:
                _request("DELETE", sign("DELETE", {"uploadId": upload_id}))
            except Exception:
                pass  # abort is best-effort; the original error matters
            raise
    return key


def _parse_xml_field(body: bytes, tag: str) -> str:
    root = ET.fromstring(body)
    # namespace-agnostic: S3 responses use the AWS namespace
    for el in root.iter():
        if el.tag.endswith(tag):
            return el.text or ""
    raise RuntimeError(f"S3 response missing <{tag}>: {body[:200]!r}")
