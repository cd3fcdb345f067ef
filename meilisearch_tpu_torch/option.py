"""Server configuration: CLI flags > MEILI_* env vars > config.toml.

Reference: crates/meilisearch/src/option.rs (the `Opt` struct, 82 public
fields across Opt/IndexerOpts/S3SnapshotOpts, env prefix mapping at
option.rs:28-108). Fields are declared once in _FIELDS with their type and
wired where the engine has the behavior; the rest are accepted, surfaced
on `Opt`, and honestly rejected or warned about when they require a
capability this build does not have (e.g. S3 multipart upload under zero
egress). Unknown config keys are kept in `extra` so workload configs parse.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass, field, fields as dc_fields
from typing import Any, Optional

# name, python type ("str" | "int" | "bool" | "float"), default
# env var = MEILI_ + NAME.upper() (the reference's mapping, option.rs:28-108)
_FIELDS = [
    ("db_path", "str", "./data.ms"),
    ("http_addr", "str", "localhost:7700"),
    ("master_key", "str", None),
    ("env", "str", "development"),
    ("task_webhook_url", "str", None),
    ("task_webhook_authorization_header", "str", None),
    ("no_analytics", "bool", True),
    ("max_index_size", "str", "2 TiB"),
    ("max_task_db_size", "str", "20 GiB"),
    ("http_payload_size_limit", "str", "100 MB"),
    ("ssl_cert_path", "str", None),
    ("ssl_key_path", "str", None),
    ("ssl_auth_path", "str", None),
    ("ssl_ocsp_path", "str", None),
    ("ssl_require_auth", "bool", False),
    ("ssl_resumption", "bool", False),
    ("ssl_tickets", "bool", False),
    ("import_snapshot", "str", None),
    ("ignore_missing_snapshot", "bool", False),
    ("ignore_snapshot_if_db_exists", "bool", False),
    ("snapshot_dir", "str", "snapshots/"),
    ("schedule_snapshot", "int", None),  # seconds; flag sans value = 86400
    ("import_dump", "str", None),
    ("ignore_missing_dump", "bool", False),
    ("ignore_dump_if_db_exists", "bool", False),
    ("dump_dir", "str", "dumps/"),
    ("log_level", "str", "INFO"),
    ("experimental_contains_filter", "bool", False),
    ("experimental_enable_metrics", "bool", False),
    ("experimental_legacy_search_default", "bool", False),
    ("experimental_search_queue_size", "int", 1000),
    ("experimental_drop_search_after", "int", 60),
    ("experimental_nb_searches_per_core", "int", 4),
    ("experimental_logs_mode", "str", "human"),
    ("upgrade_db", "bool", False),
    ("experimental_enable_logs_route", "bool", False),
    ("experimental_reduce_indexing_memory_usage", "bool", False),
    ("experimental_max_number_of_batched_tasks", "int", 1_000_000),
    ("experimental_limit_batched_tasks_total_size", "str", None),
    ("experimental_embedding_cache_entries", "int", 0),
    ("experimental_personalization_api_key", "str", None),
    ("experimental_allowed_ip_networks", "str", None),  # comma-separated CIDRs
    # sync boot warm: socket opens only after host caches + device kernel
    # compiles finish, so a fresh pod never silently serves host-mode
    ("experimental_boot_warm_sync", "bool", False),
    # IndexerOpts (option.rs:799-823)
    ("max_indexing_memory", "str", None),
    ("max_indexing_threads", "int", None),
    ("skip_index_budget", "bool", False),
    ("experimental_no_edition_2024_for_settings", "bool", False),
    ("experimental_docs_on_disk", "bool", False),
    # S3SnapshotOpts (option.rs:896-982): snapshotCreation uploads via
    # SigV4 presigned URLs when the group is complete (engine/s3_snapshot.py)
    ("s3_bucket_url", "str", None),
    ("s3_bucket_region", "str", None),
    ("s3_bucket_name", "str", None),
    ("s3_snapshot_prefix", "str", None),
    ("s3_access_key", "str", None),
    ("s3_secret_key", "str", None),
    ("experimental_s3_role_arn", "str", None),
    ("experimental_s3_web_identity_token_file", "str", None),
    ("experimental_s3_max_in_flight_parts", "int", 10),
    ("experimental_s3_compression_level", "int", 0),
    ("experimental_s3_signature_duration_seconds", "int", 28800),
    ("experimental_s3_multipart_part_size", "str", "375 MiB"),
    ("config_file_path", "str", None),
]

_TYPES = {name: typ for name, typ, _default in _FIELDS}


def parse_byte_size(text: Optional[str]) -> Optional[int]:
    """'100 MB' / '2 TiB' / '1048576' -> bytes (reference: byte_unit)."""
    if text is None:
        return None
    if isinstance(text, int):
        return text
    s = str(text).strip().replace(" ", "")
    units = {
        "b": 1,
        "kb": 10**3, "mb": 10**6, "gb": 10**9, "tb": 10**12,
        "kib": 2**10, "mib": 2**20, "gib": 2**30, "tib": 2**40,
    }
    low = s.lower()
    for unit in sorted(units, key=len, reverse=True):
        if low.endswith(unit):
            try:
                return int(float(low[: -len(unit)]) * units[unit])
            except ValueError:
                return None
    try:
        return int(low)
    except ValueError:
        return None


def _make_opt_class():
    ns: dict[str, Any] = {"__annotations__": {}}
    for name, typ, default in _FIELDS:
        py = {"str": Optional[str], "int": Optional[int], "bool": bool,
              "float": Optional[float]}[typ]
        ns["__annotations__"][name] = py
        ns[name] = default
    ns["__annotations__"]["extra"] = dict
    ns["extra"] = field(default_factory=dict)

    @property
    def host(self) -> str:
        return self.http_addr.rsplit(":", 1)[0] or "127.0.0.1"

    @property
    def port(self) -> int:
        try:
            return int(self.http_addr.rsplit(":", 1)[1])
        except (IndexError, ValueError):
            return 7700

    ns["host"] = host
    ns["port"] = port
    return dataclass(type("Opt", (), ns))


Opt = _make_opt_class()


def _coerce(name: str, value: Any) -> Any:
    typ = _TYPES.get(name)
    if value is None or typ is None:
        return value
    if typ == "bool":
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("1", "true", "yes", "on")
    if typ == "int":
        try:
            return int(value)
        except (TypeError, ValueError):
            return None
    return value


def load_options(argv: Optional[list[str]] = None) -> Opt:
    parser = argparse.ArgumentParser(prog="meilisearch-tpu")
    parser.add_argument("--host")  # convenience split form
    parser.add_argument("--port", type=int)
    for name, typ, _default in _FIELDS:
        flag = "--" + name.replace("_", "-")
        if name == "schedule_snapshot":
            parser.add_argument(flag, type=int, nargs="?", const=86400)
        elif typ == "bool":
            parser.add_argument(flag, action="store_true", default=None)
        elif typ == "int":
            parser.add_argument(flag, type=int)
        else:
            parser.add_argument(flag)
    args = parser.parse_args(argv)

    opt = Opt()

    # 1. config.toml (lowest precedence)
    config_path = args.config_file_path or os.environ.get(
        "MEILI_CONFIG_FILE_PATH", "./config.toml"
    )
    if os.path.exists(config_path):
        import tomllib

        with open(config_path, "rb") as f:
            data = tomllib.load(f)
        for key, value in data.items():
            attr = key.replace("-", "_")
            if hasattr(opt, attr) and attr != "extra":
                setattr(opt, attr, _coerce(attr, value))
            else:
                opt.extra[key] = value

    # 2. MEILI_* env vars (reference mapping: MEILI_ + field name upper)
    for name, _typ, _default in _FIELDS:
        value = os.environ.get("MEILI_" + name.upper())
        if value is None:
            continue
        coerced = _coerce(name, value)
        if coerced is not None:
            setattr(opt, name, coerced)

    # 3. CLI flags (highest precedence)
    for name, typ, _default in _FIELDS:
        value = getattr(args, name, None)
        if value is not None:
            setattr(opt, name, value if typ == "bool" else _coerce(name, value))
    if args.host or args.port:
        opt.http_addr = f"{args.host or opt.host}:{args.port or opt.port}"

    if opt.env not in ("development", "production"):
        raise SystemExit(
            f"error: Invalid environment `{opt.env}`: expected one of"
            " `development`, `production`"
        )
    if opt.env == "production" and not opt.master_key:
        raise SystemExit(
            "error: In production mode, the environment variable"
            " MEILI_MASTER_KEY is mandatory"
        )
    if opt.s3_bucket_url:
        print(
            "warning: S3 snapshot options are accepted for config parity"
            " but this build has no egress; snapshots stay local",
            file=sys.stderr,
        )
    return opt
