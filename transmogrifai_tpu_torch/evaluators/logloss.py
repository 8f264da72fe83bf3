"""Logarithmic-loss evaluator (host side, numpy).

Counterpart of ``transmogrifai_tpu/evaluators/logloss.py`` (reference
core/src/main/scala/com/salesforce/op/stages/impl/evaluator/
OPLogLoss.scala:41-62): LogLoss is the mean over rows of
``-log(probability[label])``, for binary and multiclass problems alike
(the reference's binaryLogLoss and multiLogLoss share the function).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..features.columns import PredictionColumn
from .base import EvaluationMetrics, Evaluator

__all__ = ["LogLossEvaluator", "LogLossMetrics", "log_loss"]

_EPS = 1e-15


@dataclass
class LogLossMetrics(EvaluationMetrics):
    LogLoss: float = 0.0


def log_loss(y: np.ndarray, probabilities: np.ndarray) -> float:
    """mean(-log p_label), the probabilities clipped away from 0 so that
    one confident miss does not return inf."""
    y = np.asarray(y)
    if len(y) == 0:
        raise ValueError("log loss cannot be calculated on no rows")
    idx = y.astype(int)
    if probabilities.ndim != 2 or probabilities.shape[1] == 0:
        raise ValueError("log loss requires class probabilities")
    if idx.min() < 0 or idx.max() >= probabilities.shape[1]:
        raise ValueError(
            f"label index out of range for {probabilities.shape[1]} "
            f"probability columns")
    p = np.clip(probabilities[np.arange(len(y)), idx], _EPS, 1.0)
    return float(np.mean(-np.log(p)))


class LogLossEvaluator(Evaluator):
    """(reference OPLogLoss binaryLogLoss / multiLogLoss)"""

    default_metric = "LogLoss"
    is_larger_better = False

    def __init__(self, label_col: Optional[str] = None,
                 prediction_col: Optional[str] = None):
        super().__init__(label_col, prediction_col)

    def evaluate_arrays(self, y: np.ndarray, pred: PredictionColumn
                        ) -> LogLossMetrics:
        return LogLossMetrics(LogLoss=log_loss(y, pred.probability))
