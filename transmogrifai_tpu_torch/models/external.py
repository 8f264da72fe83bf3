"""External-estimator adapter: any host estimator as a stage of the DAG.

Counterpart of ``transmogrifai_tpu/models/external.py`` (the reference's
generic Spark-wrapper layer, SparkWrapperParams / SwBinaryEstimator):
:func:`wrap_estimator` turns a pair of plain functions into a
:class:`Predictor` that works with the model selector (grids through
``with_params``), the workflow DAG and save and load. It is a host
stage, as in the JAX package: it takes host columns (``device_inputs``
off) and a tensor handed to it directly is copied to the host.

Persistence: the fitted ``state`` must be a dict of numpy arrays and
JSON-able scalars, and the fit and predict functions must be importable
(``module:qualname``), the rule the rest of the package applies to
functions. Nothing is pickled.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..features.columns import PredictionColumn
from .base import PredictionModel, Predictor

__all__ = ["ExternalEstimator", "ExternalModel", "wrap_estimator"]


def _host(X) -> np.ndarray:
    if isinstance(X, torch.Tensor):
        return X.detach().cpu().numpy().astype(np.float64)
    return np.asarray(X)


class ExternalModel(PredictionModel):
    """Fitted external model: ``predict_fn(state, X)`` scores.

    ``kind`` "classification": ``predict_fn`` returns (n, k) class
    probabilities (clipped at 0 and renormalized per row); "regression":
    (n,) values."""

    device_inputs = False

    def __init__(self, state: Dict = None, predict_fn: Callable = None,
                 kind: str = "classification",
                 uid: Optional[str] = None):
        super().__init__(operation_name="externalModel", uid=uid)
        self.state = dict(state or {})
        self.predict_fn = predict_fn
        self.kind = kind

    def predict_arrays(self, X) -> PredictionColumn:
        if self.predict_fn is None:
            raise ValueError(
                "ExternalModel has no predict_fn (was it importable at "
                "save time? see workflow/persistence.py encode_value)")
        out = np.asarray(self.predict_fn(self.state, _host(X)),
                         dtype=np.float64)
        if self.kind == "regression":
            return PredictionColumn.from_arrays(out.reshape(-1))
        if out.ndim != 2:
            raise ValueError(
                f"classification predict_fn must return (n, k) "
                f"probabilities; got shape {out.shape}")
        prob = np.clip(out, 0.0, None)
        prob = prob / np.maximum(prob.sum(axis=1, keepdims=True), 1e-12)
        pred = np.argmax(prob, axis=1).astype(np.float64)
        # raw = log-probabilities (monotone in prob, finite)
        raw = np.log(np.maximum(prob, 1e-12))
        return PredictionColumn.from_arrays(pred, probability=prob,
                                            raw_prediction=raw)


class ExternalEstimator(Predictor):
    """See the module docstring. ``params`` are the hyperparameters handed
    to ``fit_fn``; a selector's grid point overrides them through
    ``with_params`` (merged, not replaced), so an external family competes
    in the search as a native one does."""

    device_inputs = False

    def __init__(self, fit_fn: Callable = None,
                 predict_fn: Callable = None,
                 kind: str = "classification",
                 params: Dict = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        if kind not in ("classification", "regression"):
            raise ValueError(f"kind must be classification|regression, "
                             f"got {kind!r}")
        self.fit_fn = fit_fn
        self.predict_fn = predict_fn
        self.kind = kind
        self.params = dict(params or {})

    def with_params(self, **params) -> "ExternalEstimator":
        merged = dict(self.params)
        merged.update(params)
        return type(self)(fit_fn=self.fit_fn, predict_fn=self.predict_fn,
                          kind=self.kind, params=merged)

    def fit_arrays(self, X, y) -> ExternalModel:
        if self.fit_fn is None:
            raise ValueError("ExternalEstimator requires fit_fn")
        state = self.fit_fn(_host(X), np.asarray(y), **self.params)
        if not isinstance(state, dict):
            raise ValueError(
                f"external fit_fn must return a dict state (got "
                f"{type(state).__name__}): arrays and JSON-able scalars, "
                f"the persistable contract")
        return ExternalModel(state=state, predict_fn=self.predict_fn,
                             kind=self.kind)


def wrap_estimator(fit_fn: Callable, predict_fn: Callable,
                   kind: str = "classification",
                   **params) -> ExternalEstimator:
    """Wrap ``fit_fn(X, y, **params) -> state`` and
    ``predict_fn(state, X) -> scores`` into a typed, persistable
    Predictor stage (the SwUnaryTransformer role)::

        est = wrap_estimator(my_fit, my_predict, kind="regression",
                             alpha=0.1)
        pred = est.set_input(label, features).get_output()

    Only importable functions and dict-of-array states survive save and
    load."""
    return ExternalEstimator(fit_fn=fit_fn, predict_fn=predict_fn,
                             kind=kind, params=params)
