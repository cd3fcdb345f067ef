"""Rendezvous (highest-random-weight) hashing of documents to shards.

Reference: crates/milli/src/sharding/enterprise_edition.rs:43 — for each
candidate shard, hash (shard_name, doc_key); the highest hash owns the
document. Stable, no coordination, minimal movement on topology change.
"""

from __future__ import annotations

import hashlib


def rendezvous_shard(doc_key: str, shard_names: list[str]) -> str:
    """The shard owning `doc_key` (highest hash wins)."""
    best = None
    for name in shard_names:
        h = hashlib.sha256((name + "\0" + doc_key).encode()).digest()
        score = int.from_bytes(h[:8], "big")
        if best is None or score > best[0]:
            best = (score, name)
    return best[1]
