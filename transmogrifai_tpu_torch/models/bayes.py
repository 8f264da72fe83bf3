"""Naive Bayes classifier in PyTorch.

Counterpart of ``transmogrifai_tpu/models/bayes.py`` (``_nb_closed_form``,
``_fit_nb``, the masked fold x grid fit and the fused fit and metric
``_nb_eval_body``, ``NaiveBayes``, ``NaiveBayesModel``): multinomial or
Bernoulli naive Bayes with additive smoothing (MLlib's formulas), a
closed form of class counts and per-class feature sums. Those are matrix
products here: the label one-hot (times each fold's row mask) transposed
against the feature matrix, so one product gives the sums of every fold of
a search at once. Features must be non-negative, as in MLlib.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device, working_dtype
from .base import (ClassifierModel, FamilyPreconditionError, Predictor,
                   check_fold_classes, num_classes, subset_grid)

__all__ = ["NaiveBayes", "NaiveBayesModel"]

_MODEL_TYPES = ("multinomial", "bernoulli")


def _nb_closed_form(X: torch.Tensor, onehot: torch.Tensor,
                    masks: torch.Tensor, smoothing: torch.Tensor,
                    model_type: str):
    """(pi (C, K), theta (C, K, d)) of C candidates, candidate c fitted on
    the rows of ``masks[c]`` (C, n) with ``smoothing[c]``: mask-weighted
    class counts and feature sums. ``X`` (n, d) must already be binarized
    for the Bernoulli model type; ``onehot`` is the (n, K) label one-hot."""
    C = masks.shape[0]
    K = onehot.shape[1]
    counts = masks @ onehot                                     # (C, K)
    pi = torch.log(counts) - torch.log(torch.sum(counts, dim=1,
                                                 keepdim=True))
    weighted = (onehot[None, :, :] * masks[:, :, None])         # (C, n, K)
    feat = (weighted.transpose(1, 2).reshape(C * K, -1) @ X).view(C, K, -1)
    sm = smoothing[:, None, None]
    if model_type == "bernoulli":
        theta = torch.log(feat + sm) - torch.log(counts[:, :, None]
                                                 + 2.0 * sm)
    else:
        theta = (torch.log(feat + sm)
                 - torch.log(torch.sum(feat, dim=2, keepdim=True)
                             + sm * X.shape[1]))
    return pi, theta


def _feature_order(X: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """(n, K) products of each row of ``X`` with each class row of
    ``theta`` (K, d), added in feature order, so that a row's log-joint
    does not depend on the batch it is scored in."""
    return torch.cumsum(X.t()[:, :, None] * theta.t()[:, None, :],
                        dim=0)[-1]


def _nb_raw(pi: torch.Tensor, theta: torch.Tensor, X: torch.Tensor,
            model_type: str) -> torch.Tensor:
    """(n, K) log-joint scores of one model (pi (K,), theta (K, d))."""
    if model_type == "bernoulli":
        Xb = (X != 0).to(theta.dtype)
        neg = torch.log1p(-torch.clamp(torch.exp(theta), max=1 - 1e-12))
        return pi + _feature_order(Xb, theta) + _feature_order(1.0 - Xb,
                                                               neg)
    return pi + _feature_order(X, theta)


def _check_non_negative(X) -> None:
    neg = bool((X < 0).any()) if isinstance(X, torch.Tensor) \
        else bool((np.asarray(X) < 0).any())
    if neg:
        raise FamilyPreconditionError(
            "NaiveBayes requires non-negative features")


class NaiveBayesModel(ClassifierModel):
    """Fitted naive Bayes: raw predictions are the (n, K) log-joints, whose
    softmax is the probability."""

    def __init__(self, pi, theta, model_type: str = "multinomial",
                 device="cuda", uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device)
        self.pi = torch.from_numpy(np.array(pi, dtype=np.float64)).to(
            self.device, self.dtype)
        self.theta = torch.from_numpy(np.array(theta, dtype=np.float64)).to(
            self.device, self.dtype)
        self.model_type = model_type

    def raw_arrays(self, X: torch.Tensor) -> torch.Tensor:
        return _nb_raw(self.pi, self.theta, X, self.model_type)


class NaiveBayes(Predictor):
    """Multinomial or Bernoulli naive Bayes (reference OpNaiveBayes.scala).
    Requires non-negative features, as in MLlib."""

    def __init__(self, smoothing: float = 1.0,
                 model_type: str = "multinomial", device="cuda",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        if model_type not in _MODEL_TYPES:
            raise ValueError(f"model_type must be one of {_MODEL_TYPES}")
        self.smoothing = smoothing
        self.model_type = model_type
        self.device = resolve_device(device)

    def _inputs(self, X, y, k: int):
        """(X, one-hot labels) on the device in the working dtype, X
        binarized for the Bernoulli model type."""
        dtype = working_dtype(self.device)
        Xt = torch.as_tensor(X, dtype=dtype, device=self.device)
        if self.model_type == "bernoulli":
            Xt = (Xt != 0).to(dtype)
        eye = torch.eye(k, dtype=dtype, device=self.device)
        labels = torch.as_tensor(np.asarray(y), device=self.device).long()
        return Xt, eye[labels]

    def fit_arrays(self, X, y) -> NaiveBayesModel:
        _check_non_negative(X)
        Xt, onehot = self._inputs(X, y, num_classes(y))
        ones = torch.ones((1, Xt.shape[0]), dtype=Xt.dtype, device=Xt.device)
        sm = torch.full((1,), float(self.smoothing), dtype=Xt.dtype,
                        device=Xt.device)
        pi, theta = _nb_closed_form(Xt, onehot, ones, sm, self.model_type)
        return NaiveBayesModel(pi[0].cpu().numpy(), theta[0].cpu().numpy(),
                               model_type=self.model_type,
                               device=self.device)

    def _fold_grid(self, X, y, masks, grid):
        """Every (fold, grid point) candidate's closed form: yields
        (fold, grid index, model type, pi (K,), theta (K, d)) of each, one
        batch of products per model type. Raises FamilyPreconditionError
        on a negative feature, NotImplementedError for a grid parameter
        the batch cannot vary or a fold that lacks a class."""
        _check_non_negative(X)
        grid = [dict(p) for p in (list(grid) or [{}])]
        for p in grid:
            extra = set(p) - {"smoothing", "model_type"}
            if extra:
                raise NotImplementedError(
                    f"the NaiveBayes search cannot vary {sorted(extra)}")
        masks = np.asarray(masks, dtype=np.float64)
        check_fold_classes(y, masks)
        k = num_classes(y)
        F = masks.shape[0]
        dtype = working_dtype(self.device)
        masks_t = torch.as_tensor(masks, dtype=dtype, device=self.device)
        groups = {}
        for gi, p in enumerate(grid):
            cand = self.with_params(**p)
            groups.setdefault(cand.model_type, []).append((gi, cand))
        for model_type, members in groups.items():
            Xt, onehot = members[0][1]._inputs(X, y, k)
            gk = len(members)
            sm = torch.as_tensor([float(c.smoothing) for _, c in members]
                                 * F, dtype=dtype, device=self.device)
            pi, theta = _nb_closed_form(
                Xt, onehot, masks_t.repeat_interleave(gk, dim=0), sm,
                model_type)
            for f in range(F):
                for j, (gi, _) in enumerate(members):
                    c = f * gk + j
                    yield f, gi, model_type, pi[c], theta[c]

    def fit_fold_grid_arrays(self, X, y, masks, grid):
        """Every (fold, grid point) candidate fitted as the search fits
        it, (F, G) models out. A negative feature raises
        FamilyPreconditionError, so the validator falls back to fits
        candidate by candidate, which score that family NaN."""
        F = np.asarray(masks).shape[0]
        models = [[None] * len(list(grid) or [{}]) for _ in range(F)]
        for f, gi, model_type, pi, theta in self._fold_grid(X, y, masks,
                                                            grid):
            models[f][gi] = NaiveBayesModel(
                pi.cpu().numpy(), theta.cpu().numpy(),
                model_type=model_type, device=self.device)
        return models

    def eval_fold_grid_arrays(self, X, y, masks, grid, X_val, y_val, spec,
                              cand_idx=None) -> np.ndarray:
        """Device-resident search: every (fold, grid point) candidate's
        closed form from one batch of products, then its validation
        metric; (F, G) matrix out. ``model_type`` groups candidates,
        ``smoothing`` varies within a group."""
        from ..evaluators.device_metrics import (binary_from_raw_pair,
                                                 metric_fn,
                                                 softmax_probability)
        if spec[0] not in ("binary", "multiclass"):
            raise NotImplementedError(
                "NaiveBayes device eval needs a classification metric")
        _check_non_negative(X)
        if spec[0] == "binary" and num_classes(y) != 2:
            raise NotImplementedError(
                "binary device eval needs binary labels")
        grid = subset_grid(grid, cand_idx)
        F = np.asarray(masks).shape[0]
        mfn = metric_fn(*spec)
        dtype = working_dtype(self.device)
        Xv = torch.as_tensor(X_val, dtype=dtype, device=self.device)
        yv = torch.as_tensor(np.asarray(y_val), dtype=dtype,
                             device=self.device)
        mm = torch.full((F, len(grid)), torch.nan, dtype=dtype,
                        device=self.device)
        for f, gi, model_type, pi, theta in self._fold_grid(X, y, masks,
                                                            grid):
            raw = _nb_raw(pi, theta, Xv[f], model_type)
            scores = (binary_from_raw_pair(raw) if spec[0] == "binary"
                      else softmax_probability(raw))
            mm[f, gi] = mfn(yv[f], scores)
        return mm.cpu().numpy().astype(np.float64)
