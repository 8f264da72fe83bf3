"""Binary classification metrics (host side, numpy).

Counterpart of ``transmogrifai_tpu/evaluators/binary.py``
(``binary_metrics``, ``BinaryClassificationEvaluator``). Curve metrics
follow Spark's ``BinaryClassificationMetrics``: thresholds are the distinct
scores, AuROC is the trapezoidal area over the ROC curve with (0,0)/(1,1)
endpoints, AuPR prepends (recall=0, precision=first-point precision).
Point metrics come from the hard predicted labels.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..features.columns import PredictionColumn
from .base import EvaluationMetrics, Evaluator

__all__ = ["BinaryClassificationMetrics", "BinaryClassificationEvaluator",
           "binary_metrics", "positive_class_score"]


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
                  ) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Cumulative TP/FP at each distinct score threshold (descending),
    with the positive and negative totals."""
    order = np.argsort(-score, kind="stable")
    y_sorted = y[order]
    s_sorted = score[order]
    tp_cum = np.cumsum(y_sorted == 1)
    fp_cum = np.cumsum(y_sorted != 1)
    # last index of each distinct-score run
    last = np.r_[np.nonzero(np.diff(s_sorted))[0], len(s_sorted) - 1]
    return (tp_cum[last].astype(np.float64), fp_cum[last].astype(np.float64),
            float(np.sum(y == 1)), float(np.sum(y != 1)))


def _trapezoid(x: np.ndarray, ys: np.ndarray) -> float:
    return float(np.sum(np.diff(x) * (ys[1:] + ys[:-1]) / 2.0))


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
    #: the curves the JAX package records on request; the port records
    #: none, and keeps the fields so saved summaries have its keys
    thresholds: List[float] = field(default_factory=list)
    precision_by_threshold: List[float] = field(default_factory=list)
    recall_by_threshold: List[float] = field(default_factory=list)
    false_positive_rate_by_threshold: List[float] = field(
        default_factory=list)


def binary_metrics(y: np.ndarray, pred_label: np.ndarray,
                   score: Optional[np.ndarray] = None
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
        tp_c, fp_c, n_pos, n_neg = _curve_points(y, np.asarray(score))
        tpr = tp_c / max(n_pos, 1.0)
        fpr = fp_c / max(n_neg, 1.0)
        prec = tp_c / np.maximum(tp_c + fp_c, 1.0)
        m.AuROC = _trapezoid(np.r_[0.0, fpr, 1.0], np.r_[0.0, tpr, 1.0])
        m.AuPR = _trapezoid(np.r_[0.0, tpr], np.r_[prec[0], prec])
    return m


class BinaryClassificationEvaluator(Evaluator):
    """Binary evaluator; ranks by AuPR unless told otherwise."""

    def __init__(self, label_col: Optional[str] = None,
                 prediction_col: Optional[str] = None,
                 default_metric: str = "AuPR"):
        super().__init__(label_col, prediction_col)
        self.default_metric = default_metric
        self.is_larger_better = default_metric != "Error"

    def evaluate_arrays(self, y: np.ndarray, pred: PredictionColumn
                        ) -> BinaryClassificationMetrics:
        return binary_metrics(y, pred.data, positive_class_score(pred))

    def device_metric_spec(self):
        from .device_metrics import BINARY_METRICS
        return self._device_spec(BinaryClassificationEvaluator,
                                 BINARY_METRICS, "binary")
