"""Streaming (Ben-Haim/Tom-Tov) histogram.

The port's copy of ``transmogrifai_tpu/utils/histogram.py`` (reference
utils/src/main/java/com/salesforce/op/utils/stats/
StreamingHistogram.java:36): a fixed number of (centroid, count) bins,
updated in batches (sort + merge) and queried for quantiles by
interpolation. The serving metrics keep their latency sketches in it; the
rest of its API (merges, densities, JSON) waits for the drift sentinel.
The JAX package merges oversized bin sets in a C++ kernel when one is
built; the port always takes that package's numpy merge, which has the
same closest-pair semantics.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

__all__ = ["StreamingHistogram"]


class StreamingHistogram:
    """Fixed-size histogram of (centroid, count) bins supporting merge and
    interpolated sum/quantile queries."""

    def __init__(self, max_bins: int = 100):
        if max_bins < 2:
            raise ValueError("max_bins must be >= 2")
        self.max_bins = max_bins
        self.centroids = np.zeros(0, dtype=np.float64)
        self.counts = np.zeros(0, dtype=np.float64)

    # -- updates -----------------------------------------------------------
    def update(self, points: Iterable[float],
               counts: Optional[Iterable[float]] = None
               ) -> "StreamingHistogram":
        pts = np.asarray(list(points) if not isinstance(points, np.ndarray)
                         else points, dtype=np.float64)
        cts = np.ones_like(pts) if counts is None else \
            np.asarray(list(counts), dtype=np.float64)
        if cts.shape != pts.shape:
            raise ValueError(
                f"counts shape {cts.shape} != points shape {pts.shape}")
        keep = ~np.isnan(pts)  # drop NaN points and their counts together
        pts, cts = pts[keep], cts[keep]
        if pts.size == 0:
            return self
        # presort and collapse duplicates, then merge with existing bins
        order = np.argsort(pts)
        pts, cts = pts[order], cts[order]
        uniq, inv = np.unique(pts, return_inverse=True)
        agg = np.zeros_like(uniq)
        np.add.at(agg, inv, cts)
        self._merge_arrays(uniq, agg)
        return self

    def _merge_arrays(self, cents: np.ndarray, cnts: np.ndarray) -> None:
        c = np.concatenate([self.centroids, cents])
        n = np.concatenate([self.counts, cnts])
        order = np.argsort(c)
        c, n = np.ascontiguousarray(c[order]), np.ascontiguousarray(n[order])
        # rescan for the closest pair each round
        while c.size > self.max_bins:
            gaps = np.diff(c)
            i = int(np.argmin(gaps))
            tot = n[i] + n[i + 1]
            c[i] = (c[i] * n[i] + c[i + 1] * n[i + 1]) / tot
            n[i] = tot
            c = np.delete(c, i + 1)
            n = np.delete(n, i + 1)
        self.centroids, self.counts = c, n

    # -- queries -----------------------------------------------------------
    def quantile(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        c, n = self.centroids, self.counts
        if c.size == 0:
            return float("nan")
        target = q * n.sum()
        cum = np.cumsum(n) - n / 2.0
        i = int(np.searchsorted(cum, target))
        if i == 0:
            return float(c[0])
        if i >= c.size:
            return float(c[-1])
        frac = (target - cum[i - 1]) / (cum[i] - cum[i - 1])
        return float(c[i - 1] + (c[i] - c[i - 1]) * frac)
