"""Streaming (Ben-Haim/Tom-Tov) histogram.

The port's copy of ``transmogrifai_tpu/utils/histogram.py`` (reference
utils/src/main/java/com/salesforce/op/utils/stats/
StreamingHistogram.java:36): a fixed number of (centroid, count) bins,
updated in batches (sort + merge) and queried for quantiles by
interpolation. The serving metrics keep their latency sketches in it; the
raw feature filter and the drift sentinel compare two of them through
``density`` (``checkers/raw_feature_filter.numeric_histogram_js``), and the
sentinel saves them in the JAX package's JSON form (``to_json``).

Oversized bin sets merge their closest adjacent pair until ``max_bins``
remain, ties to the leftmost pair. The JAX package does this in a C++
kernel (``native/streaming_histogram.cpp``: a min-heap of (gap, left
index) with lazy deletion, O(k log k)) or, without it, by rescanning the
gaps each round, O(k^2); the port runs the heap in Python with the same
arithmetic, which the raw feature filter needs for columns of 1e5 distinct
values.
"""
from __future__ import annotations

import heapq
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["StreamingHistogram"]


def _merge_closest(c: List[float], n: List[float], max_bins: int
                   ) -> Tuple[List[float], List[float]]:
    """Merge the closest adjacent pair of the sorted bins ``(c, n)`` until
    ``max_bins`` remain, as the JAX package's ``hist_merge`` does: a
    min-heap of (gap, left index) over linked neighbours, a popped entry
    skipped when its bins are gone or its gap is no longer theirs; ties go
    to the lower index, numpy argmin's first occurrence. Returns the
    surviving bins in order."""
    size = len(c)
    nxt = list(range(1, size)) + [-1]
    prv = list(range(-1, size - 1))
    dead = [False] * size
    heap = [(c[i + 1] - c[i], i) for i in range(size - 1)]
    heapq.heapify(heap)
    remaining = size
    while remaining > max_bins and heap:
        gap, i = heapq.heappop(heap)
        if dead[i]:
            continue
        j = nxt[i]
        if j < 0 or dead[j] or c[j] - c[i] != gap:
            continue
        tot = n[i] + n[j]
        c[i] = (c[i] * n[i] + c[j] * n[j]) / tot
        n[i] = tot
        dead[j] = True
        k = nxt[j]
        nxt[i] = k
        if k >= 0:
            prv[k] = i
            heapq.heappush(heap, (c[k] - c[i], i))
        p = prv[i]
        if p >= 0:
            heapq.heappush(heap, (c[i] - c[p], p))
        remaining -= 1
    live = [i for i in range(size) if not dead[i]]
    return [c[i] for i in live], [n[i] for i in live]


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
        c, n = c[order], n[order]
        if c.size > self.max_bins:
            c, n = _merge_closest(c.tolist(), n.tolist(), self.max_bins)
        self.centroids = np.ascontiguousarray(c, dtype=np.float64)
        self.counts = np.ascontiguousarray(n, dtype=np.float64)

    # -- queries -----------------------------------------------------------
    @property
    def total(self) -> float:
        return float(self.counts.sum())

    def sum_upto(self, b: float) -> float:
        """Estimated number of points <= b (StreamingHistogram.java sum())."""
        return float(self._sums_upto(np.array([b], dtype=np.float64))[0])

    def density(self, breakpoints: Sequence[float]) -> np.ndarray:
        """Estimated counts falling in intervals defined by breakpoints:
        ``sum_upto`` at every breakpoint at once."""
        sums = self._sums_upto(np.asarray(breakpoints, dtype=np.float64))
        return np.diff(np.concatenate([[0.0], sums, [self.total]]))

    def _sums_upto(self, b: np.ndarray) -> np.ndarray:
        """``sum_upto`` at each of ``b``: the counts of the centroids
        below, half the count of the one at or below, and the trapezoid
        up to the next. The counts are integers (each point counts one,
        a merge adds them), so the running sum is exact."""
        c, n = self.centroids, self.counts
        out = np.zeros(b.shape, dtype=np.float64)
        if c.size == 0 or b.size == 0:
            return out
        prefix = np.concatenate([[0.0], np.cumsum(n)])
        i = np.searchsorted(c, b, side="right") - 1
        last = c.size - 1
        mid = (b >= c[0]) & (b < c[-1])
        edge = mid & (i == last)
        inner = mid & (i < last)
        ie = i[edge]
        out[edge] = prefix[ie] + n[ie] / 2.0
        ii = i[inner]
        ci, ci1, ni, ni1 = c[ii], c[ii + 1], n[ii], n[ii + 1]
        gap = ci1 - ci
        frac = np.where(gap > 0, (b[inner] - ci) / np.where(gap > 0, gap,
                                                           1.0), 0.0)
        mb = ni + (ni1 - ni) * frac
        s = (ni + mb) * frac / 2.0
        out[inner] = prefix[ii] + ni / 2.0 + s
        out[b >= c[-1]] = float(n.sum())
        return out

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

    def to_json(self) -> dict:
        return {"maxBins": self.max_bins,
                "centroids": self.centroids.tolist(),
                "counts": self.counts.tolist()}

    @staticmethod
    def from_json(d: dict) -> "StreamingHistogram":
        h = StreamingHistogram(d["maxBins"])
        h.centroids = np.asarray(d["centroids"], dtype=np.float64)
        h.counts = np.asarray(d["counts"], dtype=np.float64)
        return h
