"""Predictor and prediction-model bases (array-level contract).

Counterpart of ``transmogrifai_tpu/models/base.py`` restricted to what the
selector search uses: ``Predictor.fit_arrays`` / ``with_params``,
``ClassifierModel.predict_arrays`` / ``raw_to_probability``, and a minimal
``PredictionColumn`` (the counterpart of
``transmogrifai_tpu/features/columns.py`` ``PredictionColumn``). The
stage/DAG base classes are not ported yet. Arrays cross the public
boundary as numpy; the models compute on their ``device``.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["PredictionColumn", "Predictor", "PredictionModel",
           "ClassifierModel", "num_classes", "subset_grid"]


def _uid(cls) -> str:
    return f"{cls.__name__}_{uuid.uuid4().hex[:12]}"


@dataclass
class PredictionColumn:
    """Batch of predictions: ``data`` the (n,) predicted labels,
    ``probability`` and ``raw_prediction`` the (n, k) per-class arrays."""
    data: np.ndarray
    probability: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), dtype=np.float64))
    raw_prediction: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), dtype=np.float64))

    @staticmethod
    def from_arrays(prediction: np.ndarray,
                    probability: Optional[np.ndarray] = None,
                    raw_prediction: Optional[np.ndarray] = None
                    ) -> "PredictionColumn":
        pred = np.asarray(prediction, dtype=np.float64).reshape(-1)
        n = pred.shape[0]
        prob = (np.zeros((n, 0)) if probability is None
                else np.asarray(probability, dtype=np.float64).reshape(n, -1))
        raw = (np.zeros((n, 0)) if raw_prediction is None
               else np.asarray(raw_prediction, dtype=np.float64).reshape(n, -1))
        return PredictionColumn(data=pred, probability=prob,
                                raw_prediction=raw)


def num_classes(y) -> int:
    """Class count for integer-coded labels: max+1 with a floor of 2."""
    return max(2, int(np.max(y)) + 1 if len(y) else 2)


def subset_grid(grid, cand_idx):
    """The grid points ``cand_idx`` selects (all of them for None)."""
    grid = list(grid) or [{}]
    if cand_idx is None:
        return grid
    return [grid[int(i)] for i in np.asarray(cand_idx).ravel()]


class Predictor:
    """Estimator over (label vector, feature matrix). Subclasses list
    their constructor parameters in ``param_names``."""

    param_names: Tuple[str, ...] = ()

    def __init__(self, uid: Optional[str] = None):
        self.uid = uid or _uid(type(self))

    def get_params(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.param_names}

    def fit_arrays(self, X: np.ndarray, y: np.ndarray) -> "PredictionModel":
        raise NotImplementedError

    def with_params(self, **params) -> "Predictor":
        """A copy with constructor parameters overridden (the grid-point
        expansion primitive)."""
        kwargs = self.get_params()
        kwargs.update(params)
        return type(self)(**kwargs)


class PredictionModel:
    """Fitted model: feature matrix in, ``PredictionColumn`` out."""

    def __init__(self, uid: Optional[str] = None):
        self.uid = uid or _uid(type(self))

    def predict_arrays(self, X: np.ndarray) -> PredictionColumn:
        raise NotImplementedError


class ClassifierModel(PredictionModel):
    """Probabilistic classifier: prediction + raw prediction +
    probability."""

    def predict_raw(self, X: np.ndarray) -> np.ndarray:
        """(n, k) raw margins/scores."""
        raise NotImplementedError

    def raw_to_probability(self, raw: np.ndarray) -> np.ndarray:
        """Default: max-shifted softmax over the raw margins."""
        raw = raw - np.max(raw, axis=1, keepdims=True)
        e = np.exp(raw)
        return e / np.sum(e, axis=1, keepdims=True)

    def prediction_from_raw(self, raw: np.ndarray) -> PredictionColumn:
        raw = np.asarray(raw, dtype=np.float64)
        prob = np.asarray(self.raw_to_probability(raw), dtype=np.float64)
        pred = np.argmax(prob, axis=1).astype(np.float64)
        return PredictionColumn.from_arrays(pred, probability=prob,
                                            raw_prediction=raw)

    def predict_arrays(self, X: np.ndarray) -> PredictionColumn:
        return self.prediction_from_raw(self.predict_raw(X))
