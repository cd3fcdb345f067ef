"""The reference HTTP application with the port's search batcher.

Routes, auth, the scheduler and every host module are the reference's
(`meilisearch_tpu/api/app.py`). `POST /indexes/{uid}/search` reaches
`app.search_batcher` (routes_indexes.py), which here drains into the
port's device path on `device`. `/multi-search` still calls the
reference's executor and serves on the host.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from meilisearch_tpu.api import app as _ref
from meilisearch_tpu.api.app import Request, Response, TestClient  # noqa: F401

from .._hooks import install_jaxfree_aliases
from ..engine.batcher import SearchBatcher
from ..ops.backend_probe import resolve_device


class App(_ref.App):
    """`device` None means CUDA (and raises without it). `strict` sends
    every eligible query to the device path, whatever the batch size."""

    def __init__(
        self,
        scheduler=None,
        master_key: Optional[str] = None,
        personalization_api_key: Optional[str] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
        strict: bool = False,
    ):
        install_jaxfree_aliases()
        self.device = resolve_device(device)
        super().__init__(scheduler, master_key, personalization_api_key)
        # the reference batcher starts its threads at its first submit,
        # which never comes: stop it so none can start
        self.search_batcher.stop()
        self.search_batcher = SearchBatcher(self.device, strict=strict)
        if self.device.type == "cuda":
            # build K1 while documents are ingested, off the serving path
            from ..ops._build import load_library

            threading.Thread(
                target=load_library, name="kernel-build", daemon=True
            ).start()
