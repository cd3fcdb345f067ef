"""Product analytics aggregation.

Reference: crates/meilisearch/src/analytics/segment_analytics.rs — opt-out
telemetry aggregated hourly and posted to Segment. This deployment has zero
egress, so events aggregate in memory only; the collector exists so call
sites and the opt-out surface match the reference (MEILI_NO_ANALYTICS).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict


class Analytics:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.events: dict[str, int] = defaultdict(int)
        self.aggregates: dict[str, dict] = defaultdict(dict)
        self.started_at = time.time()
        self._lock = threading.Lock()

    def publish(self, event_name: str, aggregate: dict | None = None) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.events[event_name] += 1
            if aggregate:
                bucket = self.aggregates[event_name]
                for key, value in aggregate.items():
                    if isinstance(value, (int, float)):
                        bucket[key] = bucket.get(key, 0) + value
                    else:
                        bucket[key] = value

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "events": dict(self.events),
                "aggregates": {k: dict(v) for k, v in self.aggregates.items()},
            }
