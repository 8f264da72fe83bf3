"""Evaluator base and metric record (host side, numpy).

Counterpart of ``transmogrifai_tpu/evaluators/base.py``: the array-level
contract the selector uses (``evaluate_arrays``: label vector and
``PredictionColumn`` in, metrics record out; ``metric_from``; the
device-metric spec) and the Dataset adapters the workflow uses
(``label_col``, ``prediction_col``, ``evaluate_all``, ``evaluate``), and
the metrics' JSON round trip that a saved selector summary carries
(``EvaluationMetrics.to_json``, ``metrics_from_json``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from ..features.columns import Dataset, PredictionColumn

__all__ = ["EvaluationMetrics", "Evaluator", "RawMetrics", "SingleMetric",
           "MultiMetrics", "metrics_from_json"]


@dataclass
class EvaluationMetrics:
    """Base metric record (reference EvaluationMetrics.scala)."""

    def to_json(self) -> Dict[str, Any]:
        def conv(v):
            if isinstance(v, np.ndarray):
                return v.tolist()
            if isinstance(v, (np.floating, np.integer)):
                return v.item()
            if isinstance(v, EvaluationMetrics):
                return v.to_json()
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            return v
        return {f.name: conv(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    def to_map(self) -> Dict[str, Any]:
        return self.to_json()


def metrics_from_json(class_name: str, d: Dict[str, Any]
                      ) -> "Optional[EvaluationMetrics]":
    """Rebuild a metrics dataclass from ``to_json`` output by class name
    (model load of ``ModelSelectorSummary``). Nested metric dataclass
    fields rebuild recursively from their annotations; a class that is
    not importable here comes back as a :class:`RawMetrics` holder with
    the full payload and the original name."""
    def walk(cls):
        for sub in cls.__subclasses__():
            yield sub
            yield from walk(sub)

    def field_cls(f) -> "Optional[type]":
        t = f.type
        if isinstance(t, str):       # from __future__ annotations
            t = t.replace("Optional[", "").rstrip("]")
            return next((s for s in walk(EvaluationMetrics)
                         if s.__name__ == t), None)
        if isinstance(t, type):
            return t if issubclass(t, EvaluationMetrics) else None
        import typing
        for a in typing.get_args(t):     # Optional[X] and friends
            if isinstance(a, type) and issubclass(a, EvaluationMetrics):
                return a
        return None

    for sub in walk(EvaluationMetrics):
        if sub is RawMetrics:
            # a recorded "RawMetrics" name keeps its payload through the
            # fallback below instead of rebuilding an empty holder
            continue
        if sub.__name__ == class_name and dataclasses.is_dataclass(sub):
            kwargs = {}
            for f in dataclasses.fields(sub):
                if f.name not in d:
                    continue
                v = d[f.name]
                nested = field_cls(f)
                if nested is not None and isinstance(v, dict):
                    v = metrics_from_json(nested.__name__, v)
                kwargs[f.name] = v
            hook = getattr(sub, "_decode_json_kwargs", None)
            if hook is not None:
                kwargs = hook(kwargs)
            return sub(**kwargs)
    return RawMetrics(class_name=class_name, data=dict(d))


@dataclass
class RawMetrics(EvaluationMetrics):
    """Holder for a persisted metrics payload whose class is not
    importable at load time: keeps the full dict and the original class
    name, so a re-save loses nothing."""
    class_name: str = ""
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return dict(self.data)


@dataclass
class SingleMetric(EvaluationMetrics):
    """One named metric value (reference SingleMetric)."""
    name: str
    value: float


@dataclass
class MultiMetrics(EvaluationMetrics):
    """Named collection of metric records (reference MultiMetrics)."""
    metrics: Dict[str, EvaluationMetrics]


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
