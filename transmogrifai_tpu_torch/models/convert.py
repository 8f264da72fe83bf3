"""Carry fitted models across from the JAX package.

The JAX package's fitted ``GBTClassifierModel`` holds numpy arrays
(``feats``, ``thrs``, ``leaves``, ``depth``, ``base``, ``n_features``);
the port's model built from them predicts the same probabilities.
"""
from __future__ import annotations

import numpy as np

from .trees import GBTClassifierModel

__all__ = ["gbt_from_numpy"]


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
