"""Carry fitted models across from the JAX package.

The JAX package's fitted ``GBTClassifierModel`` holds numpy arrays
(``feats``, ``thrs``, ``leaves``, ``depth``, ``base``, ``n_features``), and
its ``TreeEnsembleClassifierModel`` (random forests, decision trees) the
same without ``base``; its binary ``LogisticRegressionModel`` and
``LinearSVCModel`` hold ``coefficients`` (d,) and ``intercept``. The
port's models built from them predict the same probabilities and labels.
"""
from __future__ import annotations

import numpy as np

from .linear import LinearSVCModel, LogisticRegressionModel
from .trees import GBTClassifierModel, TreeEnsembleClassifierModel

__all__ = ["forest_from_numpy", "gbt_from_numpy", "logistic_from_numpy",
           "svc_from_numpy"]


def gbt_from_numpy(feats: np.ndarray, thrs: np.ndarray, leaves: np.ndarray,
                   depth: int, base: float, n_features: int,
                   device="cuda") -> GBTClassifierModel:
    """Port-side ``GBTClassifierModel`` from the reference model's arrays:
    ``feats`` (R, 2^depth - 1) split features, ``thrs`` the same shape
    split thresholds, ``leaves`` (R, 2^depth) leaf margins."""
    return GBTClassifierModel(np.asarray(feats, dtype=np.int32),
                              np.asarray(thrs, dtype=np.float64),
                              np.asarray(leaves, dtype=np.float64),
                              depth=int(depth), base=float(base),
                              n_features=int(n_features), device=device)


def forest_from_numpy(feats: np.ndarray, thrs: np.ndarray,
                      leaves: np.ndarray, depth: int, n_features: int,
                      device="cuda") -> TreeEnsembleClassifierModel:
    """Port-side ``TreeEnsembleClassifierModel`` from the reference
    model's arrays: ``feats`` and ``thrs`` (T, 2^depth - 1), ``leaves``
    (T, 2^depth, K) leaf class distributions."""
    return TreeEnsembleClassifierModel(np.asarray(feats, dtype=np.int32),
                                       np.asarray(thrs, dtype=np.float64),
                                       np.asarray(leaves, dtype=np.float64),
                                       depth=int(depth),
                                       n_features=int(n_features),
                                       device=device)


def logistic_from_numpy(coefficients: np.ndarray, intercept,
                        device="cuda") -> LogisticRegressionModel:
    """Port-side binary ``LogisticRegressionModel`` from the reference
    model's ``coefficients`` (d,) and ``intercept``."""
    return LogisticRegressionModel(coefficients, intercept, device=device)


def svc_from_numpy(coefficients: np.ndarray, intercept,
                   device="cuda") -> LinearSVCModel:
    """Port-side ``LinearSVCModel`` from the reference model's
    ``coefficients`` (d,) and ``intercept``."""
    return LinearSVCModel(coefficients, intercept, device=device)
