"""Multiclass classification metrics (host side, numpy).

Counterpart of ``transmogrifai_tpu/evaluators/multiclass.py``
(``MultiClassificationMetrics``, ``ThresholdMetrics``, ``_weighted_prf``,
``threshold_metrics``, ``multiclass_metrics``,
``MultiClassificationEvaluator``): label-frequency weighted precision,
recall and F1 over the classes present in the labels, the error rate, and
per top-N, per confidence-bin correct/incorrect counts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..features.columns import PredictionColumn
from .base import EvaluationMetrics, Evaluator

__all__ = ["MultiClassificationMetrics", "ThresholdMetrics",
           "MultiClassificationEvaluator", "multiclass_metrics",
           "threshold_metrics"]


@dataclass
class ThresholdMetrics(EvaluationMetrics):
    """Per top-N, per confidence-bin counts."""
    topNs: List[int] = field(default_factory=list)
    thresholds: List[float] = field(default_factory=list)
    correct_counts: Dict[int, List[int]] = field(default_factory=dict)
    incorrect_counts: Dict[int, List[int]] = field(default_factory=dict)
    no_prediction_counts: Dict[int, List[int]] = field(default_factory=dict)

    @staticmethod
    def _decode_json_kwargs(kwargs: dict) -> dict:
        """JSON turns the int top-N keys of the count dicts into strings;
        :func:`~.base.metrics_from_json` calls this to turn them back."""
        for name in ("correct_counts", "incorrect_counts",
                     "no_prediction_counts"):
            v = kwargs.get(name)
            if isinstance(v, dict):
                kwargs[name] = {int(k): x for k, x in v.items()}
        return kwargs


@dataclass
class MultiClassificationMetrics(EvaluationMetrics):
    """Label-frequency weighted Precision/Recall/F1 (Spark
    MulticlassMetrics' weighted variants) and the error rate."""
    Precision: float = 0.0
    Recall: float = 0.0
    F1: float = 0.0
    Error: float = 0.0
    ThresholdMetrics: Optional[ThresholdMetrics] = None


def _weighted_prf(y: np.ndarray, pred: np.ndarray
                  ) -> Tuple[float, float, float]:
    labels = np.unique(y)
    n = len(y)
    w_p = w_r = w_f = 0.0
    for lbl in labels:
        weight = float(np.sum(y == lbl)) / n
        tp = float(np.sum((pred == lbl) & (y == lbl)))
        fp = float(np.sum((pred == lbl) & (y != lbl)))
        fn = float(np.sum((pred != lbl) & (y == lbl)))
        p = tp / (tp + fp) if tp + fp > 0 else 0.0
        r = tp / (tp + fn) if tp + fn > 0 else 0.0
        f = 2 * p * r / (p + r) if p + r > 0 else 0.0
        w_p += weight * p
        w_r += weight * r
        w_f += weight * f
    return w_p, w_r, w_f


def threshold_metrics(y: np.ndarray, prob: np.ndarray,
                      top_ns: Sequence[int] = (1, 3),
                      n_bins: int = 10) -> ThresholdMetrics:
    """For each top-N and confidence threshold: the rows whose label is
    among the N most probable classes (correct), is not (incorrect), or
    whose largest probability lies below the threshold (no
    prediction)."""
    thresholds = np.linspace(0.0, 1.0, n_bins, endpoint=False)
    max_conf = prob.max(axis=1) if prob.size else np.zeros(len(y))
    order = np.argsort(-prob, axis=1) if prob.size else \
        np.zeros((len(y), 1), dtype=int)
    correct: Dict[int, List[int]] = {}
    incorrect: Dict[int, List[int]] = {}
    nopred: Dict[int, List[int]] = {}
    for top_n in top_ns:
        in_top = np.any(order[:, :top_n] == y[:, None].astype(int), axis=1)
        c, i, np_ = [], [], []
        for t in thresholds:
            above = max_conf >= t
            c.append(int(np.sum(above & in_top)))
            i.append(int(np.sum(above & ~in_top)))
            np_.append(int(np.sum(~above)))
        correct[top_n], incorrect[top_n], nopred[top_n] = c, i, np_
    return ThresholdMetrics(
        topNs=list(top_ns), thresholds=thresholds.tolist(),
        correct_counts=correct, incorrect_counts=incorrect,
        no_prediction_counts=nopred)


def multiclass_metrics(y: np.ndarray, pred: np.ndarray,
                       prob: Optional[np.ndarray] = None,
                       top_ns: Sequence[int] = (1, 3),
                       n_bins: int = 10) -> MultiClassificationMetrics:
    y = np.asarray(y, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    p, r, f1 = _weighted_prf(y, pred)
    err = float(np.mean(pred != y)) if len(y) else 0.0
    tm = (threshold_metrics(y, prob, top_ns, n_bins)
          if prob is not None and prob.size else None)
    return MultiClassificationMetrics(Precision=p, Recall=r, F1=f1,
                                      Error=err, ThresholdMetrics=tm)


class MultiClassificationEvaluator(Evaluator):
    """Multiclass evaluator; ranks by weighted F1 unless told otherwise
    (Error is the one smaller-better metric)."""

    default_metric = "F1"
    is_larger_better = True

    def __init__(self, label_col: Optional[str] = None,
                 prediction_col: Optional[str] = None,
                 default_metric: str = "F1",
                 top_ns: Sequence[int] = (1, 3), n_bins: int = 10):
        super().__init__(label_col, prediction_col)
        self.default_metric = default_metric
        self.is_larger_better = default_metric != "Error"
        self.top_ns = tuple(top_ns)
        self.n_bins = n_bins

    def evaluate_arrays(self, y: np.ndarray, pred: PredictionColumn
                        ) -> MultiClassificationMetrics:
        prob = pred.probability if pred.probability.shape[1] else None
        return multiclass_metrics(y, pred.data, prob,
                                  top_ns=self.top_ns, n_bins=self.n_bins)

    def device_metric_spec(self):
        from .device_metrics import MULTICLASS_METRICS
        return self._device_spec(MultiClassificationEvaluator,
                                 MULTICLASS_METRICS, "multiclass")
