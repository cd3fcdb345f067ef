"""`perform_search_many` on the port's device path.

Request parsing, host fallback and response formatting are the
reference's (`meilisearch_tpu/search/perform.py::_perform_search_many_locked`);
only the batch executor is the port's `search_many`. `perform_search`, the
single-query host path, is the reference's, re-exported.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from meilisearch_tpu.search.perform import (  # noqa: F401
    _perform_search_many_locked,
    perform_search,
)

from .device_batch import search_many


def perform_search_many(
    store,
    queries: list[dict],
    features: Optional[dict] = None,
    *,
    device: torch.device,
    force_device: bool = False,
    strict: bool = False,
) -> list[dict]:
    """Execute a batch of search requests against one index; responses are
    order-aligned with `queries`. `force_device` is the batcher's
    device-mode signal; `strict` sends every eligible query to `device`."""
    with store._lock:
        return _perform_search_many_locked(
            store,
            queries,
            features,
            functools.partial(
                search_many, device=device, force_device=force_device, strict=strict
            ),
        )
