"""Evaluator base and metric record (host side, numpy).

Counterpart of ``transmogrifai_tpu/evaluators/base.py``: the array-level
contract the selector uses (``evaluate_arrays``: label vector and
``PredictionColumn`` in, metrics record out; ``metric_from``; the
device-metric spec) and the Dataset adapters the workflow uses
(``label_col``, ``prediction_col``, ``evaluate_all``, ``evaluate``). The
metrics' JSON round trip is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..features.columns import Dataset, PredictionColumn

__all__ = ["EvaluationMetrics", "Evaluator"]


@dataclass
class EvaluationMetrics:
    """Base metric record."""


class Evaluator:
    """Base evaluator: ``evaluate_arrays`` is the kernel; ``evaluate`` /
    ``evaluate_all`` adapt a Dataset by column name."""

    #: name of the metric the selector ranks by
    default_metric: str = ""
    is_larger_better: bool = True

    def __init__(self, label_col: Optional[str] = None,
                 prediction_col: Optional[str] = None):
        self.label_col = label_col
        self.prediction_col = prediction_col

    def evaluate_arrays(self, y: np.ndarray, pred: PredictionColumn
                        ) -> EvaluationMetrics:
        raise NotImplementedError

    def evaluate_all(self, ds: Dataset) -> EvaluationMetrics:
        """Metrics of the ``prediction_col`` column against the
        ``label_col`` column of ``ds``."""
        y = np.asarray(ds[self.label_col].data, dtype=np.float64)
        pred = ds[self.prediction_col]
        if not isinstance(pred, PredictionColumn):
            raise TypeError(f"column {self.prediction_col!r} holds "
                            f"{pred.ftype.__name__} values, not predictions")
        return self.evaluate_arrays(y, pred)

    def evaluate(self, ds: Dataset) -> float:
        return self.metric_from(self.evaluate_all(ds))

    def metric_from(self, metrics: EvaluationMetrics) -> float:
        return float(getattr(metrics, self.default_metric))

    def device_metric_spec(self):
        """(kind, metric name) for the on-device metric, or None when the
        metric cannot be computed there."""
        return None

    def _device_spec(self, base_cls, supported, kind):
        """Shared ``device_metric_spec`` body: a subclass that overrides
        evaluation keeps the host path (the device metric cannot see the
        override), and the metric must be one the device computes."""
        cls = type(self)
        if (cls.metric_from is not Evaluator.metric_from
                or cls.evaluate_arrays is not base_cls.evaluate_arrays):
            return None
        if self.default_metric in supported:
            return (kind, self.default_metric)
        return None
