"""IsotonicRegressionCalibrator: monotone score calibration.

Counterpart of ``transmogrifai_tpu/models/isotonic.py`` (the reference's
IsotonicRegressionCalibrator over MLlib's IsotonicRegression): the fit
runs Pool-Adjacent-Violators (``pava``, host numpy as in the JAX package)
over (score, label) pairs and keeps the compressed (boundary,
prediction) pairs; a prediction interpolates linearly between
boundaries and clamps at the ends, as MLlib's IsotonicRegressionModel
does. The fitted model's ``raw_arrays`` is that interpolation on the
model's device (a ``searchsorted`` and a lerp), so a compiled scoring
plan runs it there.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device, working_dtype
from .base import Predictor, RegressionModel

__all__ = ["IsotonicRegressionCalibrator",
           "IsotonicRegressionCalibratorModel", "pava"]


def pava(x: np.ndarray, y: np.ndarray,
         w: Optional[np.ndarray] = None,
         increasing: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted isotonic fit: returns (boundaries, predictions), the
    compressed representation MLlib stores (adjacent equal fitted values
    merged; duplicate x pooled by weight)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    w = np.ones_like(y) if w is None else np.asarray(w, dtype=np.float64)
    if not increasing:
        b, p = pava(-x, y, w, increasing=True)
        return -b[::-1], p[::-1]
    order = np.lexsort((y, x))
    xs, ys, ws = x[order], y[order], w[order]
    # pool duplicate scores first (one block per distinct x)
    ux, inv = np.unique(xs, return_inverse=True)
    wsum = np.bincount(inv, weights=ws)
    ysum = np.bincount(inv, weights=ws * ys)
    means = ysum / wsum
    # the PAVA stack: blocks of (weight, weighted mean, x_lo, x_hi)
    blocks: List[List[float]] = []
    for i in range(len(ux)):
        blocks.append([wsum[i], means[i], ux[i], ux[i]])
        while len(blocks) > 1 and blocks[-2][1] >= blocks[-1][1]:
            w2, m2, lo2, hi2 = blocks.pop()
            w1, m1, lo1, hi1 = blocks.pop()
            wt = w1 + w2
            blocks.append([wt, (w1 * m1 + w2 * m2) / wt, lo1, hi2])
    boundaries: List[float] = []
    preds: List[float] = []
    for wt, m, lo, hi in blocks:
        if preds and preds[-1] == m:
            boundaries[-1] = hi       # merge equal-valued neighbours
            continue
        if lo == hi:
            boundaries.append(lo)
            preds.append(m)
        else:
            boundaries.extend([lo, hi])
            preds.extend([m, m])
    return np.asarray(boundaries), np.asarray(preds)


def _host(X) -> np.ndarray:
    if isinstance(X, torch.Tensor):
        return X.detach().cpu().numpy().astype(np.float64)
    return np.asarray(X, dtype=np.float64)


class IsotonicRegressionCalibrator(Predictor):
    """Calibrate a score against a label monotonically (reference
    IsotonicRegressionCalibrator.scala; input 1 the RealNN label, input 2
    an OPVector whose ``feature_index`` column carries the score, MLlib's
    featureIndex)."""

    def __init__(self, isotonic: bool = True, feature_index: int = 0,
                 device="cuda", uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.isotonic = isotonic
        self.feature_index = feature_index
        self.device = resolve_device(device)

    def fit_arrays(self, X, y) -> "IsotonicRegressionCalibratorModel":
        scores = _host(X)
        if scores.ndim == 2:
            scores = scores[:, self.feature_index]
        b, p = pava(scores, y, increasing=self.isotonic)
        return IsotonicRegressionCalibratorModel(
            boundaries=b, predictions=p, feature_index=self.feature_index,
            device=self.device)


class IsotonicRegressionCalibratorModel(RegressionModel):
    """Piecewise-linear monotone map (MLlib's IsotonicRegressionModel:
    linear interpolation between boundaries, clamped outside). The pairs
    live on ``device``; ``calibrate`` is the host numpy form."""

    def __init__(self, boundaries=None, predictions=None,
                 feature_index: int = 0, device="cuda",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.boundaries = np.asarray(boundaries, dtype=np.float64)
        self.predictions = np.asarray(predictions, dtype=np.float64)
        self.feature_index = int(feature_index)
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device)
        self._b = torch.from_numpy(self.boundaries.copy()).to(self.device,
                                                             self.dtype)
        self._p = torch.from_numpy(self.predictions.copy()).to(self.device,
                                                              self.dtype)

    def calibrate(self, scores: np.ndarray) -> np.ndarray:
        b, p = self.boundaries, self.predictions
        if b.size == 0:
            return np.zeros_like(scores)
        if b.size == 1:
            return np.full_like(scores, p[0])
        out = np.interp(scores, b, p)
        return np.clip(out, min(p[0], p[-1]), max(p[0], p[-1]))

    def raw_arrays(self, X: torch.Tensor) -> torch.Tensor:
        """(n,) calibrated scores of ``X``'s ``feature_index`` column (or
        of ``X`` itself, 1-D): numpy ``interp``'s segment and slope."""
        x = X[:, self.feature_index] if X.dim() == 2 else X
        b, p = self._b.to(x.dtype), self._p.to(x.dtype)
        if b.numel() == 0:
            return torch.zeros_like(x)
        if b.numel() == 1:
            return torch.full_like(x, float(self.predictions[0]))
        j = torch.clamp(torch.searchsorted(b, x.contiguous(), right=True) - 1,
                        0, b.numel() - 2)
        slope = (p[j + 1] - p[j]) / (b[j + 1] - b[j])
        out = slope * (x - b[j]) + p[j]
        out = torch.where(x <= b[0], p[0], out)
        out = torch.where(x >= b[-1], p[-1], out)
        lo = min(self.predictions[0], self.predictions[-1])
        hi = max(self.predictions[0], self.predictions[-1])
        return torch.clamp(out, lo, hi)
