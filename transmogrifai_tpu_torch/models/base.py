"""Predictor / PredictionModel stage bases — the model-zoo kernel.

Counterpart of ``transmogrifai_tpu/models/base.py``. A ``Predictor`` is a
binary estimator stage over (RealNN label, OPVector features) ->
Prediction, and a ``PredictionModel`` the binary model it fits:
``fit_arrays`` consumes the label vector and the feature matrix and
``predict_arrays`` returns a ``PredictionColumn``. The feature matrix may be
a numpy array or a tensor on the model's device (the prepare plan hands
the selector the matrix it computed there); predictions come back to the
host as numpy. ``raw_arrays`` is the device kernel: feature tensor in, raw
margins or votes tensor out.

Input contract as in the reference: input 1 is the RealNN label (must be
a response), input 2 the OPVector feature matrix (must not be) —
core/src/main/scala/com/salesforce/op/stages/impl/CheckIsResponseValues.scala.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from ..features.columns import FeatureColumn, PredictionColumn
from ..stages.base import BinaryEstimator, BinaryModel
from ..types import OPVector, Prediction, RealNN
from ..utils.device import working_dtype

__all__ = ["PredictionColumn", "Predictor", "PredictionModel",
           "ClassifierModel", "RegressionModel", "FamilyPreconditionError",
           "check_fold_classes", "check_is_response_values", "num_classes",
           "subset_grid"]


class FamilyPreconditionError(ValueError):
    """The data violates a model family's preconditions (NaiveBayes on
    negative features). A ValueError, so the per-candidate validation
    path scores the candidate NaN on the fold instead of failing the
    search."""


def check_is_response_values(label, features) -> None:
    """Reference CheckIsResponseValues: in1 must be a response, in2 must
    not be."""
    if not label.is_response:
        raise ValueError(
            f"Label input {label.name!r} must be a response feature")
    if features.is_response:
        raise ValueError(
            f"Feature-vector input {features.name!r} must not be a response")


def num_classes(y) -> int:
    """Class count for integer-coded labels: max+1 with a floor of 2."""
    return max(2, int(np.max(y)) + 1 if len(y) else 2)


def subset_grid(grid, cand_idx):
    """The grid points ``cand_idx`` selects (all of them for None)."""
    grid = list(grid) or [{}]
    if cand_idx is None:
        return grid
    return [grid[int(i)] for i in np.asarray(cand_idx).ravel()]


def check_fold_classes(y, masks) -> None:
    """The fold x grid searches size their class-dependent arrays (one-hot
    statistics, K-class parameters) from all of ``y``, while a fit on one
    fold's rows sizes them from that fold's labels: when a fold's train
    rows miss a class the two differ, so raise NotImplementedError and let
    the validator fit that family candidate by candidate."""
    y = np.asarray(y)
    n_all = len(np.unique(y))
    for row in np.asarray(masks):
        if len(np.unique(y[row > 0])) != n_all:
            raise NotImplementedError(
                "a fold's train split lacks a label class; per-fold "
                "architectures would differ")


def _features(col: FeatureColumn):
    """A feature-vector column's values: its tensor as it is, or its host
    values as float64 numpy."""
    if col.on_device:
        return col.data
    return np.asarray(col.data, dtype=np.float64)


class Predictor(BinaryEstimator):
    """Estimator over (RealNN label, OPVector features) -> Prediction."""

    input_types = (RealNN, OPVector)
    output_type = Prediction
    device_inputs = True

    def check_input_constraints(self, features) -> None:
        check_is_response_values(*features)

    def fit_columns(self, cols: List[FeatureColumn]) -> "PredictionModel":
        y = np.asarray(cols[0].data, dtype=np.float64)
        model = self.fit_arrays(_features(cols[1]), y)
        model.vector_metadata = cols[1].metadata
        return model

    def fit_arrays(self, X, y: np.ndarray) -> "PredictionModel":
        raise NotImplementedError

    def fit_arrays_guarded(self, X, y: np.ndarray) -> "PredictionModel":
        """``fit_arrays`` behind the fault-injection site ``family:<class>:
        fit`` (``runtime/faults.py``): the validator's candidate-by-
        candidate path fits through here, so a host fit can be failed on
        purpose like a device dispatch. Free when no plan is active."""
        from ..runtime.faults import maybe_inject
        maybe_inject("family", type(self).__name__, "fit")
        return self.fit_arrays(X, y)

    def with_params(self, **params) -> "Predictor":
        """A copy with constructor parameters overridden (the grid-point
        expansion primitive)."""
        kwargs = self.get_params()
        kwargs.pop("uid", None)
        kwargs.update(params)
        return type(self)(**kwargs)


class PredictionModel(BinaryModel):
    """Fitted model: OPVector batch -> PredictionColumn. Scoring uses only
    the feature-vector input; the label column (wired for uid/DAG
    symmetry with the estimator) is ignored."""

    input_types = (RealNN, OPVector)
    output_type = Prediction
    device_inputs = True
    #: vector metadata of the training feature matrix
    vector_metadata = None

    def check_input_constraints(self, features) -> None:
        check_is_response_values(*features)

    def transform_columns(self, cols: List[FeatureColumn]) -> PredictionColumn:
        return self.predict_arrays(_features(cols[-1]))

    def predict_arrays(self, X) -> PredictionColumn:
        raise NotImplementedError

    def transform_value(self, *values: Any) -> Prediction:
        vec = values[-1]
        arr = np.asarray(vec.value if hasattr(vec, "value") else vec,
                         dtype=np.float64).reshape(1, -1)
        return self.predict_arrays(arr).boxed(0)

    # -- device lowering ---------------------------------------------------
    def raw_arrays(self, X: torch.Tensor) -> torch.Tensor:
        """This model's raw output (margins or votes, (n, k)) from a
        feature tensor on its device, computed there."""
        raise NotImplementedError(
            f"{type(self).__name__} has no array predict kernel")

    def supports_arrays(self) -> bool:
        return type(self).raw_arrays is not PredictionModel.raw_arrays

    def transform_arrays(self, arrays):
        """``raw_arrays`` of the feature vector in the working dtype (the
        cast ``predict_arrays`` makes of a float64 host matrix)."""
        X = arrays[-1]
        return self.raw_arrays(X.to(working_dtype(X.device)))


class ClassifierModel(PredictionModel):
    """Probabilistic classifier: prediction + raw prediction +
    probability. Subclasses set ``device`` and ``dtype`` and implement
    ``raw_arrays``."""

    def predict_raw(self, X) -> np.ndarray:
        """(n, k) raw margins/scores on the host."""
        Xt = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        return self.raw_arrays(Xt).cpu().numpy().astype(np.float64)

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

    def predict_arrays(self, X) -> PredictionColumn:
        return self.prediction_from_raw(self.predict_raw(X))


class RegressionModel(PredictionModel):
    """Regressor: prediction only. Subclasses set ``device`` and ``dtype``
    and implement ``raw_arrays`` (the (n,) predicted values)."""

    def predict_values(self, X) -> np.ndarray:
        """(n,) predicted values on the host."""
        Xt = torch.as_tensor(X, dtype=self.dtype, device=self.device)
        return self.raw_arrays(Xt).cpu().numpy().astype(np.float64)

    def prediction_from_raw(self, raw: np.ndarray) -> PredictionColumn:
        return PredictionColumn.from_arrays(np.asarray(raw,
                                                       dtype=np.float64))

    def predict_arrays(self, X) -> PredictionColumn:
        return self.prediction_from_raw(self.predict_values(X))
