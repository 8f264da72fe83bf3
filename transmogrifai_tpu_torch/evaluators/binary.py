"""Binary classification metrics (host side, numpy).

Counterpart of ``transmogrifai_tpu/evaluators/binary.py``
(``binary_metrics``, ``BinaryClassificationEvaluator``, the curves and the
calibration bins of ``BinScoreEvaluator``; reference
OpBinaryClassificationEvaluator.scala:56,179 and
OpBinScoreEvaluator.scala:52). Curve metrics follow Spark's
``BinaryClassificationMetrics``: thresholds are the distinct scores, AuROC
is the trapezoidal area over the ROC curve with (0,0)/(1,1) endpoints,
AuPR prepends (recall=0, precision=first-point precision). Point metrics
come from the hard predicted labels. The selector's search computes the
same AuPR and AuROC on the device (``device_metrics.binary_metric``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..features.columns import PredictionColumn
from .base import EvaluationMetrics, Evaluator

__all__ = ["BinaryClassificationMetrics", "BinaryClassificationEvaluator",
           "BinScoreMetrics", "BinScoreEvaluator", "binary_metrics",
           "roc_curve", "pr_curve", "au_roc", "au_pr",
           "positive_class_score"]


def positive_class_score(pred: PredictionColumn) -> Optional[np.ndarray]:
    """Positive-class ranking score: column 1 of a 2+-class probability
    matrix, a single-column probability as-is, then the same over raw
    predictions."""
    for arr in (pred.probability, pred.raw_prediction):
        if arr.shape[1] >= 2:
            return arr[:, 1]
        if arr.shape[1] == 1:
            return arr[:, 0]
    return None


def _curve_points(y: np.ndarray, score: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float,
                             float]:
    """(thresholds, tp, fp, n_pos, n_neg): the distinct score thresholds
    (descending), the cumulative TP/FP counts predicted positive at each,
    and the positive and negative totals. Empty arrays for empty input."""
    if len(score) == 0:
        z = np.zeros(0, dtype=np.float64)
        return z, z, z, 0.0, 0.0
    order = np.argsort(-score, kind="stable")
    y_sorted = y[order]
    s_sorted = score[order]
    tp_cum = np.cumsum(y_sorted == 1)
    fp_cum = np.cumsum(y_sorted != 1)
    # last index of each distinct-score run
    last = np.r_[np.nonzero(np.diff(s_sorted))[0], len(s_sorted) - 1]
    return (s_sorted[last], tp_cum[last].astype(np.float64),
            fp_cum[last].astype(np.float64),
            float(np.sum(y == 1)), float(np.sum(y != 1)))


def roc_curve(y: np.ndarray, score: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(fpr, tpr) points including the (0,0) and (1,1) endpoints."""
    _, tp, fp, n_pos, n_neg = _curve_points(y, score)
    tpr = tp / max(n_pos, 1.0)
    fpr = fp / max(n_neg, 1.0)
    return (np.r_[0.0, fpr, 1.0], np.r_[0.0, tpr, 1.0])


def pr_curve(y: np.ndarray, score: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """(recall, precision) points, prepending (0, first precision) as
    Spark's BinaryClassificationMetrics.pr does."""
    _, tp, fp, n_pos, _ = _curve_points(y, score)
    recall = tp / max(n_pos, 1.0)
    precision = tp / np.maximum(tp + fp, 1.0)
    first_p = precision[0] if precision.size else 1.0
    return (np.r_[0.0, recall], np.r_[first_p, precision])


def _trapezoid(x: np.ndarray, ys: np.ndarray) -> float:
    return float(np.sum(np.diff(x) * (ys[1:] + ys[:-1]) / 2.0))


def au_roc(y: np.ndarray, score: np.ndarray) -> float:
    return _trapezoid(*roc_curve(y, score))


def au_pr(y: np.ndarray, score: np.ndarray) -> float:
    return _trapezoid(*pr_curve(y, score))


@dataclass
class BinaryClassificationMetrics(EvaluationMetrics):
    Precision: float = 0.0
    Recall: float = 0.0
    F1: float = 0.0
    AuROC: float = 0.0
    AuPR: float = 0.0
    Error: float = 0.0
    TP: float = 0.0
    TN: float = 0.0
    FP: float = 0.0
    FN: float = 0.0
    #: the threshold curves, recorded on request (``record_curves``)
    thresholds: List[float] = field(default_factory=list)
    precision_by_threshold: List[float] = field(default_factory=list)
    recall_by_threshold: List[float] = field(default_factory=list)
    false_positive_rate_by_threshold: List[float] = field(
        default_factory=list)


def binary_metrics(y: np.ndarray, pred_label: np.ndarray,
                   score: Optional[np.ndarray] = None,
                   record_curves: bool = False
                   ) -> BinaryClassificationMetrics:
    y = np.asarray(y, dtype=np.float64)
    pred_label = np.asarray(pred_label, dtype=np.float64)
    tp = float(np.sum((pred_label == 1) & (y == 1)))
    tn = float(np.sum((pred_label != 1) & (y != 1)))
    fp = float(np.sum((pred_label == 1) & (y != 1)))
    fn = float(np.sum((pred_label != 1) & (y == 1)))
    n = max(len(y), 1)
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    m = BinaryClassificationMetrics(
        Precision=precision, Recall=recall, F1=f1,
        Error=(fp + fn) / n, TP=tp, TN=tn, FP=fp, FN=fn)
    if score is not None and len(np.unique(y)) > 1:
        # one sort serves ROC, PR and the threshold curves
        thr, tp_c, fp_c, n_pos, n_neg = _curve_points(y, np.asarray(score))
        tpr = tp_c / max(n_pos, 1.0)
        fpr = fp_c / max(n_neg, 1.0)
        prec = tp_c / np.maximum(tp_c + fp_c, 1.0)
        m.AuROC = _trapezoid(np.r_[0.0, fpr, 1.0], np.r_[0.0, tpr, 1.0])
        m.AuPR = _trapezoid(np.r_[0.0, tpr], np.r_[prec[0], prec])
        if record_curves:
            m.thresholds = thr.tolist()
            m.precision_by_threshold = prec.tolist()
            m.recall_by_threshold = tpr.tolist()
            m.false_positive_rate_by_threshold = fpr.tolist()
    return m


class BinaryClassificationEvaluator(Evaluator):
    """Binary evaluator; ranks by AuPR unless told otherwise."""

    def __init__(self, label_col: Optional[str] = None,
                 prediction_col: Optional[str] = None,
                 default_metric: str = "AuPR",
                 record_curves: bool = False):
        super().__init__(label_col, prediction_col)
        self.default_metric = default_metric
        self.is_larger_better = default_metric != "Error"
        self.record_curves = record_curves

    def evaluate_arrays(self, y: np.ndarray, pred: PredictionColumn
                        ) -> BinaryClassificationMetrics:
        return binary_metrics(y, pred.data, positive_class_score(pred),
                              record_curves=self.record_curves)

    def device_metric_spec(self):
        from .device_metrics import BINARY_METRICS
        return self._device_spec(BinaryClassificationEvaluator,
                                 BINARY_METRICS, "binary")


@dataclass
class BinScoreMetrics(EvaluationMetrics):
    """Calibration-bin metrics (reference OpBinScoreEvaluator.scala:52)."""
    BinCenters: List[float] = field(default_factory=list)
    NumberOfDataPoints: List[int] = field(default_factory=list)
    AverageScore: List[float] = field(default_factory=list)
    AverageConversionRate: List[float] = field(default_factory=list)
    BrierScore: float = 0.0


class BinScoreEvaluator(Evaluator):
    """Score-calibration evaluator (reference OpBinScoreEvaluator.scala:142):
    scores binned uniformly on [0, 1], each bin's average score against
    its label conversion rate, and the overall Brier score."""

    default_metric = "BrierScore"
    is_larger_better = False

    def __init__(self, num_bins: int = 100, label_col: Optional[str] = None,
                 prediction_col: Optional[str] = None):
        super().__init__(label_col, prediction_col)
        if num_bins <= 0:
            raise ValueError("num_bins must be positive")
        self.num_bins = num_bins

    def evaluate_arrays(self, y: np.ndarray, pred: PredictionColumn
                        ) -> BinScoreMetrics:
        score = positive_class_score(pred)
        if score is None:
            score = pred.data
        score = np.clip(np.asarray(score, dtype=np.float64), 0.0, 1.0)
        bins = np.minimum((score * self.num_bins).astype(int),
                          self.num_bins - 1)
        counts = np.bincount(bins, minlength=self.num_bins)
        sum_score = np.bincount(bins, weights=score, minlength=self.num_bins)
        sum_label = np.bincount(bins, weights=y, minlength=self.num_bins)
        nz = counts > 0
        centers = (np.arange(self.num_bins) + 0.5) / self.num_bins
        with np.errstate(invalid="ignore"):
            avg_score = np.where(nz, sum_score / np.maximum(counts, 1), 0.0)
            avg_conv = np.where(nz, sum_label / np.maximum(counts, 1), 0.0)
        return BinScoreMetrics(
            BinCenters=centers.tolist(),
            NumberOfDataPoints=counts.tolist(),
            AverageScore=avg_score.tolist(),
            AverageConversionRate=avg_conv.tolist(),
            BrierScore=float(np.mean((score - y) ** 2)) if len(y) else 0.0)
