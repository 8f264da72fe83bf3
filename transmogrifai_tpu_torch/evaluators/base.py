"""Evaluator base and metric record (host side, numpy).

Counterpart of ``transmogrifai_tpu/evaluators/base.py``, restricted to the
array-level contract the selector uses: ``evaluate_arrays`` (label vector
and ``PredictionColumn`` in, metrics record out), ``metric_from`` and the
device-metric spec. The Dataset adapters are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.base import PredictionColumn

__all__ = ["EvaluationMetrics", "Evaluator"]


@dataclass
class EvaluationMetrics:
    """Base metric record."""


class Evaluator:
    """Base evaluator: ``evaluate_arrays`` is the kernel."""

    #: name of the metric the selector ranks by
    default_metric: str = ""
    is_larger_better: bool = True

    def evaluate_arrays(self, y: np.ndarray, pred: PredictionColumn
                        ) -> EvaluationMetrics:
        raise NotImplementedError

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
