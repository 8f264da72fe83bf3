"""Regression metrics (host side, numpy).

Counterpart of ``transmogrifai_tpu/evaluators/regression.py``
(``RegressionMetrics``, ``regression_metrics``, ``RegressionEvaluator``):
RMSE, MSE, R² and MAE; the selector ranks by RMSE, smaller better.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..features.columns import PredictionColumn
from .base import EvaluationMetrics, Evaluator

__all__ = ["RegressionMetrics", "RegressionEvaluator", "regression_metrics"]


@dataclass
class RegressionMetrics(EvaluationMetrics):
    RootMeanSquaredError: float = 0.0
    MeanSquaredError: float = 0.0
    R2: float = 0.0
    MeanAbsoluteError: float = 0.0


def regression_metrics(y: np.ndarray, pred: np.ndarray) -> RegressionMetrics:
    y = np.asarray(y, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    if len(y) == 0:
        return RegressionMetrics()
    err = pred - y
    mse = float(np.mean(err ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    r2 = 1.0 - float(np.sum(err ** 2)) / ss_tot if ss_tot > 0 else 0.0
    return RegressionMetrics(
        RootMeanSquaredError=float(np.sqrt(mse)), MeanSquaredError=mse,
        R2=r2, MeanAbsoluteError=float(np.mean(np.abs(err))))


class RegressionEvaluator(Evaluator):
    """Regression evaluator; ranks by RMSE unless told otherwise (R² is
    the one larger-better metric)."""

    default_metric = "RootMeanSquaredError"
    is_larger_better = False

    def __init__(self, label_col: Optional[str] = None,
                 prediction_col: Optional[str] = None,
                 default_metric: str = "RootMeanSquaredError"):
        super().__init__(label_col, prediction_col)
        self.default_metric = default_metric
        self.is_larger_better = default_metric == "R2"

    def evaluate_arrays(self, y: np.ndarray, pred: PredictionColumn
                        ) -> RegressionMetrics:
        return regression_metrics(y, pred.data)

    def device_metric_spec(self):
        from .device_metrics import REGRESSION_METRICS
        return self._device_spec(RegressionEvaluator, REGRESSION_METRICS,
                                 "regression")
