"""Live serving metrics: streaming latency histograms and the snapshot
schema version.

The port's copy of ``transmogrifai_tpu/observability/metrics.py``:
per-tenant request-latency histograms on the fixed-memory
:class:`~..utils.histogram.StreamingHistogram` (bounded bins, so a
long-lived serving process holds constant memory), and the answered and
failed counts that ``ServingServer.metrics_snapshot`` reports.
"""
from __future__ import annotations

import threading
import time
from typing import Dict

from ..utils.histogram import StreamingHistogram

__all__ = ["METRICS_SCHEMA_VERSION", "LatencyHistogram", "ServeMetrics"]

#: the JAX package's snapshot schema version; the port's snapshot keeps
#: its keys and reports ``{"enabled": false}`` for the admission block
METRICS_SCHEMA_VERSION = 4


class LatencyHistogram:
    """Streaming latency sketch: fixed-size bins, exact count/min/max,
    interpolated quantiles."""

    def __init__(self, max_bins: int = 64):
        self._hist = StreamingHistogram(max_bins=max_bins)
        self.count = 0
        self.min = float("inf")
        self.max = 0.0

    def observe_many(self, seconds_batch) -> None:
        """One histogram merge for a whole batch of latencies (the
        serving loop observes per dispatch, not per request)."""
        ms = [s * 1000.0 for s in seconds_batch]
        if not ms:
            return
        self._hist.update(ms)
        self.count += len(ms)
        self.min = min(self.min, min(ms))
        self.max = max(self.max, max(ms))

    def to_json(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "p50_ms": round(self._hist.quantile(0.50), 3),
            "p95_ms": round(self._hist.quantile(0.95), 3),
            "p99_ms": round(self._hist.quantile(0.99), 3),
            "min_ms": round(self.min, 3),
            "max_ms": round(self.max, 3),
        }


class ServeMetrics:
    """The serving loop's live accumulators: per-tenant latency
    histograms and answered/failed counts, one instance per
    :class:`~..serving.server.ServingServer`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._latency: Dict[str, LatencyHistogram] = {}
        self.started_at = time.time()
        self.answered = 0
        self.failed = 0

    def observe_batch(self, tenant: str, seconds_batch) -> None:
        with self._lock:
            hist = self._latency.get(tenant)
            if hist is None:
                hist = self._latency[tenant] = LatencyHistogram()
            hist.observe_many(seconds_batch)
            self.answered += len(seconds_batch)

    def note_failure(self) -> None:
        with self._lock:
            self.failed += 1

    def latency_json(self) -> Dict[str, dict]:
        with self._lock:
            return {t: h.to_json() for t, h in
                    sorted(self._latency.items())}

    def uptime_seconds(self) -> float:
        return time.time() - self.started_at
