"""Stand-in for `meilisearch_tpu.ops.device_osa` where jax is absent.

The reference's typo pass asks `device_osa_available` before running the
whole-vocabulary OSA DP on the device; below `MIN_DEVICE_VOCAB` it runs on
the host (`ops/levenshtein.py`). Until the OSA kernel is ported, the port
answers False for every vocabulary, so the typo pass always takes that
host route. `calls` counts the questions, so a run can show the gate was
reached.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
calls = 0


def device_osa_available(store, n_words: int) -> bool:
    global calls
    with _lock:
        calls += 1
    return False
