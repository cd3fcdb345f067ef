"""Snapshot/database format versioning + in-place migration chain.

Reference: crates/meilisearch/src/lib.rs versioning check at boot ("Your
database version (X) is incompatible..."), milli/src/update/upgrade/ (the
per-version migration functions, e.g. v1_32, v1_37) and the
UpgradeDatabase task (index-scheduler/src/upgrade/).

The on-disk unit here is the logical instance snapshot (engine/dumps.py).
Every snapshot is stamped with `formatVersion` (int) and `engineVersion`
(the package version). Opening rules mirror the reference:
  * SAME format: open.
  * NEWER format than this engine: always refuse — downgrades are not
    supported (versioning.rs).
  * OLDER format: refuse unless the upgrade was requested (--upgrade-db /
    an UpgradeDatabase task), then run the migration chain one version at
    a time — exactly how upgrade/v1_37.rs chains from the previous step.
"""

from __future__ import annotations

from typing import Callable

from ..types.errors import EngineError, ErrorCode

# v1: round-1 snapshots (no formatVersion stamp; network carried a
#     boolean `sharding` flag and no shards/leader/version fields)
# v2: network gained `shards` (map name -> {remotes}), `leader`, `version`
#     (reference network.rs:13-24); the legacy `sharding` bool is dropped
# v3: instance state gained `dynamicSearchRules` and `webhooks` (round 3 —
#     both persist across restarts like the reference's scheduler env)
SNAPSHOT_FORMAT_VERSION = 3

_MIGRATIONS: dict[int, Callable[[dict], dict]] = {}


def migration(from_version: int):
    def register(fn):
        _MIGRATIONS[from_version] = fn
        return fn

    return register


@migration(1)
def _v1_to_v2(data: dict) -> dict:
    """Network topology shape change (this round's /network shards+leader)."""
    import uuid

    network = data.get("network") or {}
    network.pop("sharding", None)
    network.setdefault("shards", {})
    network.setdefault("leader", None)
    network.setdefault("version", str(uuid.uuid4()))
    data["network"] = network
    data["formatVersion"] = 2
    return data


@migration(2)
def _v2_to_v3(data: dict) -> dict:
    """Dynamic search rules + webhooks joined the instance state."""
    data.setdefault("dynamicSearchRules", {})
    data.setdefault("webhooks", {})
    data["formatVersion"] = 3
    return data


def snapshot_version(data: dict) -> int:
    return int(data.get("formatVersion") or 1)


def check_and_migrate(data: dict, allow_upgrade: bool) -> dict:
    """Gate + migration chain for a deserialized instance snapshot."""
    version = snapshot_version(data)
    if version == SNAPSHOT_FORMAT_VERSION:
        return data
    if version > SNAPSHOT_FORMAT_VERSION:
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            f"Your database version ({version}) is newer than this engine's"
            f" format ({SNAPSHOT_FORMAT_VERSION}); downgrades are not"
            " supported.",
        )
    if not allow_upgrade:
        raise EngineError(
            ErrorCode.BAD_REQUEST,
            f"Your database version ({version}) is older than this engine's"
            f" format ({SNAPSHOT_FORMAT_VERSION}). Start with --upgrade-db"
            " or register an upgradeDatabase task to migrate it.",
        )
    while version < SNAPSHOT_FORMAT_VERSION:
        migrate = _MIGRATIONS.get(version)
        if migrate is None:
            raise EngineError(
                ErrorCode.INTERNAL,
                f"No migration registered from format version {version}.",
            )
        data = migrate(data)
        new_version = snapshot_version(data)
        assert new_version > version, (version, new_version)
        version = new_version
    return data
