"""Fold x grid fitting and scoring of the linear family in one batch.

Counterpart of ``transmogrifai_tpu/parallel/cv.py`` (``LINEAR_KERNELS``:
logistic, squared and SVC; ``fit_linear_fold_grid``,
``eval_linear_fold_grid``, ``_candidate_fit``, ``_candidate_eval``), local
path only: every (fold, grid point) candidate is one row of the batched
fit cores of ``models/linear.py``, fold-major (candidate ``f * G + g``),
with the F fold masks as row weights and never repeated per grid point.
Each candidate runs FISTA with a fixed trip count, as in the JAX search
(the squared loss without an L1 term in the grid solves its normal
equations). ``eval_linear_fold_grid`` then computes each validation
metric on the device, and only the (F, G) metric matrix reaches the
host; ``fit_linear_fold_grid`` returns the candidates' parameters (the
validator's host-metric path). The mesh path (models x data sharding)
is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..evaluators.device_metrics import binary_from_raw_pair, metric_fn
from ..models.linear import (binary_logistic_core, linear_regression_core,
                             linear_svc_core)
from ..utils.device import resolve_device, working_dtype

__all__ = ["LINEAR_KERNELS", "eval_linear_fold_grid", "fit_linear_fold_grid"]

#: kind -> weighted fit core, all with the signature (X, y, W, reg, alpha,
#: *, fit_intercept, standardize, max_iter, solver, device)
LINEAR_KERNELS = {
    "logistic": binary_logistic_core,
    "squared": linear_regression_core,
    "svc": linear_svc_core,
}


def fit_linear_fold_grid(kind: str, X, y, masks, grid, *,
                         fit_intercept: bool = True, standardize: bool = True,
                         max_iter: int = 100, device="cuda") -> np.ndarray:
    """Fit every (fold, grid point) candidate of one linear family on
    ``device``: masks (F, n) 0/1 train-row masks over X (n, d), grid
    (G, 2) [reg, alpha] rows. Returns (F, G, d + 1) float64 parameters on
    the host, [..., :d] the coefficients and [..., d] the intercept, in
    the original feature space."""
    if kind not in LINEAR_KERNELS:
        raise ValueError(f"unknown linear kind {kind!r} (kinds: "
                         f"{sorted(LINEAR_KERNELS)})")
    dev = resolve_device(device)
    grid = np.asarray(grid, dtype=np.float64).reshape(-1, 2)
    F, G = np.asarray(masks).shape[0], grid.shape[0]
    coef, b = _candidate_fit(kind, X, y, masks, np.tile(grid[:, 0], F),
                             np.tile(grid[:, 1], F),
                             fit_intercept=fit_intercept,
                             standardize=standardize, max_iter=max_iter,
                             device=dev)
    params = torch.cat([coef, b[:, None]], dim=1)
    return params.cpu().numpy().astype(np.float64).reshape(F, G, -1)


def eval_linear_fold_grid(kind: str, X, y, masks, grid, X_val, y_val,
                          spec: tuple, *, fit_intercept: bool = True,
                          standardize: bool = True, max_iter: int = 100,
                          device="cuda") -> np.ndarray:
    """Fit and evaluate every (fold, grid point) candidate on ``device``,
    returning only the (F, G) validation-metric matrix.

    masks : (F, n) 0/1 train-row masks of the folds over X (n, d)
    grid  : (G, 2) [reg, alpha] rows
    X_val : (F, nv, d) stacked validation folds (numpy, or a tensor on
            ``device``, as X may be); y_val (F, nv)
    spec  : (kind, metric) for ``evaluators.device_metrics.metric_fn``
    """
    if kind not in LINEAR_KERNELS:
        raise ValueError(f"unknown linear kind {kind!r} (kinds: "
                         f"{sorted(LINEAR_KERNELS)})")
    dev = resolve_device(device)
    dtype = working_dtype(dev)
    grid = np.asarray(grid, dtype=np.float64).reshape(-1, 2)
    F, G = np.asarray(masks).shape[0], grid.shape[0]
    coef, b = _candidate_fit(kind, X, y, masks, np.tile(grid[:, 0], F),
                             np.tile(grid[:, 1], F),
                             fit_intercept=fit_intercept,
                             standardize=standardize, max_iter=max_iter,
                             device=dev)
    Xv = torch.as_tensor(X_val, dtype=dtype, device=dev)
    yv = torch.from_numpy(np.asarray(y_val, dtype=np.float64)).to(
        dev, dtype)
    mm = torch.empty((F, G), dtype=dtype, device=dev)
    for f in range(F):
        cols = slice(f * G, (f + 1) * G)
        margins = Xv[f] @ coef[cols].T + b[cols]          # (nv, G)
        for g in range(G):
            mm[f, g] = _candidate_eval(kind, spec, margins[:, g], yv[f])
    return mm.cpu().numpy().astype(np.float64)


def _candidate_fit(kind: str, X, y, masks, regs, alphas, *,
                   fit_intercept: bool, standardize: bool, max_iter: int,
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coefficients (C, d), intercepts (C,)) of the C = F * G candidates.
    solver="fista": a fixed trip count, as the JAX search runs it."""
    return LINEAR_KERNELS[kind](
        X, y, masks, regs, alphas, fit_intercept=fit_intercept,
        standardize=standardize, max_iter=max_iter, solver="fista",
        device=device)


def _candidate_eval(kind: str, spec: tuple, m: torch.Tensor,
                    yv: torch.Tensor) -> torch.Tensor:
    """One candidate's validation metric from its margins ``m``, with the
    host model's score semantics: logistic ranks by the softmax
    probability of the [-m, m] pair, SVC by the raw margin (no
    probability, as in MLlib) with the margin's sign as its label, a
    regression metric takes the predicted values."""
    if spec[0] == "regression":
        scores = m
    elif kind == "svc":
        scores = (m, (m > 0).to(m.dtype))
    else:
        scores = binary_from_raw_pair(torch.stack([-m, m], dim=1))
    return metric_fn(*spec)(yv, scores)
