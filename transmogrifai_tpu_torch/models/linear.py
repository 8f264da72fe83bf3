"""Linear family in PyTorch: logistic regression (binomial and
multinomial), linear regression and linear SVC.

Counterpart of ``transmogrifai_tpu/models/linear.py``. The weighted fit
cores, the
standardization and its inverse, the elastic-net and squared-hinge
objectives and the solver choice are the JAX package's; how they run
differs:

- every array has a leading candidate axis: F fold weight rows ``W``
  (F, n), each shared by G consecutive candidates (fold-major, candidate
  ``c`` on fold ``c // G``), so a fold x grid search is one batch and a
  single fit is F = G = 1;
- standardization is implicit. ``X`` is centred once by its global mean
  on the device (``_prep``), and each fold's weighted mean and scale act
  through the products (``Xs v = X (v/s) - mu.(v/s)``, ``Xs^T r = (X^T r
  - mu sum(r)) / s``), so no per-candidate standardized copy of X exists;
- gradients are closed-form, one ``X @ V`` and one ``X^T @ R`` product
  for all candidates per solver iteration (``models/solvers.py``).

Multinomial logistic regression (K > 2 labels) fits one model at a time,
its K class rows standing in for the candidate axis of the same products
(``_fit_multinomial_logistic``); as in the JAX package, its fold x grid
search is validated candidate by candidate. Linear regression solves the
ridge normal equations, or runs FISTA when an L1 term is set
(``linear_regression_core``).

Numbers: float32 on CUDA (TF32 off), float64 on the CPU
(``utils/device.py``). ``fit_fold_grid_arrays`` is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device, working_dtype
from .base import (ClassifierModel, PredictionColumn, Predictor,
                   RegressionModel, subset_grid)
from .solvers import design_lipschitz, fista_minimize, lbfgs_minimize

__all__ = ["LogisticRegression", "LogisticRegressionModel", "LinearSVC",
           "LinearSVCModel", "LinearRegression", "LinearRegressionModel",
           "binary_logistic_core", "linear_regression_core",
           "linear_svc_core"]


# ---------------------------------------------------------------------------
# implicit standardization
# ---------------------------------------------------------------------------

@dataclass
class _Design:
    """A feature matrix on its device, centred by its global mean, with
    per-fold weighted statistics. ``Xc`` (n, d) = X - ``gmean``; ``W`` (F,
    n) row weights; ``wsum`` (F,); ``mu`` (F, d) each fold's mean in
    centred coordinates and ``mu_orig`` in X's; ``sigma`` (F, d) the safe
    scales (1 where a column is constant or standardization is off)."""
    Xc: torch.Tensor
    gmean: torch.Tensor
    W: torch.Tensor
    wsum: torch.Tensor
    mu: torch.Tensor
    mu_orig: torch.Tensor
    sigma: torch.Tensor

    def matvec(self, V: torch.Tensor) -> torch.Tensor:
        """(n, C) margins ``Xs_c v_c`` of C = F * G parameter rows V (C, d),
        row c standardized with fold c // G's statistics."""
        G = V.shape[0] // self.W.shape[0]
        mu = self.mu.repeat_interleave(G, dim=0)
        Vs = V / self.sigma.repeat_interleave(G, dim=0)
        return self.Xc @ Vs.T - torch.sum(Vs * mu, dim=1)

    def rmatvec(self, R: torch.Tensor) -> torch.Tensor:
        """(C, d) products ``Xs_c^T r_c`` of the columns of R (n, C)."""
        G = R.shape[1] // self.W.shape[0]
        mu = self.mu.repeat_interleave(G, dim=0)
        sigma = self.sigma.repeat_interleave(G, dim=0)
        return ((self.Xc.T @ R).T - mu * torch.sum(R, dim=0)[:, None]) / sigma

    def fold_rows(self, R: torch.Tensor, per_row: torch.Tensor
                  ) -> torch.Tensor:
        """R (n, C) times ``per_row`` (n, F), candidate c by column c // G:
        the fold weights applied without an (n, C) copy of them."""
        n, C = R.shape
        F = per_row.shape[1]
        return (R.view(n, F, C // F) * per_row[:, :, None]).view(n, C)


def _weighted_standardize(Xc: torch.Tensor, gmean: torch.Tensor,
                          W: torch.Tensor):
    """Per-fold weighted mean and scale of the centred ``Xc`` (subset
    statistics when W holds 0/1 masks), with the JAX package's relative
    floor: a column whose scale is at most 1e-9 * max(|mean|, 1) is
    treated as constant (scale 1). Returns (mu, mu_orig, sigma, wsum)."""
    wsum = torch.clamp(torch.sum(W, dim=1), min=1e-12)
    mu = (W @ Xc) / wsum[:, None]
    var = torch.stack([W[f] @ (Xc - mu[f]) ** 2 for f in range(W.shape[0])]
                      ) / wsum[:, None]
    sigma = torch.sqrt(var)
    mu_orig = mu + gmean
    floor = 1e-9 * torch.clamp(torch.abs(mu_orig), min=1.0)
    safe = torch.where(sigma > floor, sigma, 1.0)
    return mu, mu_orig, safe, wsum


def _unstandardize_coefs(wv: torch.Tensor, b: torch.Tensor,
                         mu_orig: torch.Tensor, sigma: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coefficients fitted on standardized X mapped back to X's space,
    row by row: wv / sigma, b - (wv / sigma).mu."""
    w_orig = wv / sigma
    return w_orig, b - torch.sum(w_orig * mu_orig, dim=1)


def _prep(X, W, standardize: bool, device: torch.device) -> _Design:
    """``X`` (n, d; numpy, or a tensor already on ``device``) and fold
    weights ``W`` (F, n) on ``device`` in the working dtype, X centred by
    its global mean there (so the per-fold mean corrections of the
    implicit standardization stay small in float32)."""
    dtype = working_dtype(device)
    # a copy: the centring below works in place
    Xc = torch.as_tensor(X, dtype=dtype, device=device).clone()
    Wt = torch.as_tensor(W, dtype=dtype, device=device)
    gmean = torch.mean(Xc, dim=0)
    Xc.sub_(gmean)
    if standardize:
        mu, mu_orig, sigma, wsum = _weighted_standardize(Xc, gmean, Wt)
    else:
        F, d = Wt.shape[0], Xc.shape[1]
        wsum = torch.clamp(torch.sum(Wt, dim=1), min=1e-12)
        mu = (-gmean).expand(F, d)
        mu_orig = torch.zeros((F, d), dtype=dtype, device=device)
        sigma = torch.ones((F, d), dtype=dtype, device=device)
    return _Design(Xc, gmean, Wt, wsum, mu, mu_orig, sigma)


# ---------------------------------------------------------------------------
# weighted fit cores
# ---------------------------------------------------------------------------

def _objective(kind: str, design: _Design, y: torch.Tensor, l2: torch.Tensor,
               fit_intercept: bool):
    """(value_and_grad, grad) of the smooth objective for C parameter rows
    (C, d + 1): the logistic loss sum(w log(1 + e^(-s m))) / sum(w), or
    the squared hinge sum(w max(0, 1 - s m)^2) / sum(w), plus l2/2 |wv|^2,
    with s = 2y - 1 and m the standardized margin. Gradients in closed
    form: -s sigmoid(-s m) w / sum(w), or -2 s max(0, 1 - s m) w / sum(w),
    through Xs^T, plus l2 wv."""
    d = design.Xc.shape[1]
    s = (2.0 * y - 1.0)[:, None]
    per_row = design.W.T / design.wsum             # (n, F): w / sum(w)

    def margins(Z):
        m = design.matvec(Z[:, :d])
        return m + Z[:, d] if fit_intercept else m

    def dloss(m):                                  # d loss / d m, unweighted
        if kind == "logistic":
            return -s * torch.sigmoid(-s * m)
        return -2.0 * s * torch.clamp(1.0 - s * m, min=0.0)

    def finish(Z, R):
        g = torch.empty_like(Z)
        g[:, :d] = design.rmatvec(R) + l2[:, None] * Z[:, :d]
        g[:, d] = torch.sum(R, dim=0) if fit_intercept else 0.0
        return g

    def grad(Z):
        return finish(Z, design.fold_rows(dloss(margins(Z)), per_row))

    def value_and_grad(Z):
        m = margins(Z)
        if kind == "logistic":
            loss = torch.logaddexp(-s * m, torch.zeros((), dtype=m.dtype,
                                                       device=m.device))
        else:
            loss = torch.clamp(1.0 - s * m, min=0.0) ** 2
        wv = Z[:, :d]
        value = (torch.sum(design.fold_rows(loss, per_row), dim=0)
                 + 0.5 * l2 * torch.sum(wv * wv, dim=1))
        return value, finish(Z, design.fold_rows(dloss(m), per_row))

    return value_and_grad, grad


def _linear_core(kind: str, X, y, W, l2: np.ndarray, l1: np.ndarray,
                 curvature: float, *, fit_intercept: bool, standardize: bool,
                 max_iter: int, fista: bool, tol: float, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fits of C = len(l2) candidates over the F rows of ``W`` (candidate
    c on row c // (C / F)): the loss ``kind`` ("logistic" or "svc") plus
    l2/2 |wv|^2 + l1 |wv|_1 in the standardized space, whose loss
    curvature is at most ``curvature``. With ``fista``, FISTA for 5 *
    ``max_iter`` iterations (stopping at a step below ``tol`` when tol >
    0); else L-BFGS, which fits one candidate. Returns (coefficients (C,
    d), intercepts (C,)) in X's space."""
    dev = resolve_device(device)
    design = _prep(X, W, standardize, dev)
    dtype = design.Xc.dtype
    d = design.Xc.shape[1]
    F = design.W.shape[0]
    l2 = torch.as_tensor(l2, dtype=dtype).to(dev)
    l1 = torch.as_tensor(l1, dtype=dtype).to(dev)
    C = l2.shape[0]
    G = C // F
    if C != F * G:
        raise ValueError(f"{C} candidates do not split over {F} folds")
    y_t = torch.as_tensor(np.asarray(y), dtype=dtype).to(dev)
    value_and_grad, grad = _objective(kind, design, y_t, l2, fit_intercept)
    w0 = torch.zeros((C, d + 1), dtype=dtype, device=dev)
    if fista:
        # the bound depends on the fold only: one power iteration a fold
        lip_fold = design_lipschitz(design.Xc, 0.0, curvature, w=design.W,
                                    mu=design.mu, sigma=design.sigma)
        lip = lip_fold.repeat_interleave(G) + l2 + curvature
        mask = torch.ones(d + 1, dtype=dtype, device=dev)
        mask[d] = 0.0                              # no L1 on the intercept
        params, _ = fista_minimize(grad, l1, w0, lip, max_iter=max_iter * 5,
                                   tol=tol, l1_mask=mask)
    else:
        if C != 1:
            raise ValueError(f"L-BFGS fits one candidate, not {C}; the "
                             f"batched search runs FISTA")

        def vg(z):
            value, g = value_and_grad(z[None, :])
            return value[0], g[0]
        params = lbfgs_minimize(vg, w0[0], max_iter=max_iter)[0][None, :]
    wv = params[:, :d]
    b = params[:, d] if fit_intercept else torch.zeros_like(params[:, d])
    fold = torch.arange(C, device=dev) // G
    return _unstandardize_coefs(wv, b, design.mu_orig[fold],
                                design.sigma[fold])


def _candidates(v) -> np.ndarray:
    return np.atleast_1d(np.asarray(v, dtype=np.float64))


def binary_logistic_core(X, y, W, reg, alpha, *, fit_intercept: bool = True,
                         standardize: bool = True, max_iter: int = 100,
                         solver: str = "auto", device="cuda"):
    """Weighted binomial logistic fits -> (coefficients (C, d), intercepts
    (C,)) in X's space, for C = len(reg) candidates over the F rows of
    ``W`` (candidate c on row c // (C / F)), with the elastic-net penalty
    l2 = reg (1 - alpha), l1 = reg alpha. ``solver="fista"`` runs FISTA
    with a fixed trip count of 5 * ``max_iter`` (the search); ``"auto"``
    runs FISTA to tol 1e-7 when an L1 term is set, else L-BFGS (single
    fits)."""
    reg, alpha = _candidates(reg), _candidates(alpha)
    l1 = reg * alpha
    return _linear_core("logistic", X, y, W, reg * (1.0 - alpha), l1, 0.25,
                        fit_intercept=fit_intercept, standardize=standardize,
                        max_iter=max_iter,
                        fista=solver == "fista" or bool(np.any(l1 > 0)),
                        tol=0.0 if solver == "fista" else 1e-7,
                        device=device)


def linear_svc_core(X, y, W, reg, alpha=0.0, *, fit_intercept: bool = True,
                    standardize: bool = True, max_iter: int = 100,
                    solver: str = "auto", device="cuda"):
    """Weighted L2 squared-hinge SVM fits -> (coefficients (C, d),
    intercepts (C,)), shaped as :func:`binary_logistic_core`. ``alpha``
    is accepted for a uniform signature (no L1 in LinearSVC); ``"auto"``
    is L-BFGS, ``"fista"`` the fixed-trip FISTA."""
    reg = _candidates(reg)
    return _linear_core("svc", X, y, W, reg, np.zeros_like(reg), 2.0,
                        fit_intercept=fit_intercept, standardize=standardize,
                        max_iter=max_iter, fista=solver == "fista", tol=0.0,
                        device=device)


def linear_regression_core(X, y, W, reg, alpha, *,
                           fit_intercept: bool = True,
                           standardize: bool = True, max_iter: int = 100,
                           solver: str = "auto", device="cuda"):
    """Weighted least squares with the elastic-net penalty l2 = reg (1 -
    alpha), l1 = reg alpha on the standardized design, shaped as
    :func:`binary_logistic_core`: (coefficients (C, d), intercepts (C,))
    for C = len(reg) candidates over the F rows of ``W``. The label is
    centred on each fold's weighted mean (with an intercept). Without an
    L1 term in the batch, each candidate solves its ridge normal equations;
    with one, every candidate runs FISTA on the half mean squared error
    for 5 * ``max_iter`` iterations (``solver="fista"``, the search) or to
    a step below 1e-7."""
    reg, alpha = _candidates(reg), _candidates(alpha)
    l2_np, l1_np = reg * (1.0 - alpha), reg * alpha
    dev = resolve_device(device)
    design = _prep(X, W, standardize, dev)
    dtype = design.Xc.dtype
    d = design.Xc.shape[1]
    F = design.W.shape[0]
    C = len(reg)
    G = C // F
    if C != F * G:
        raise ValueError(f"{C} candidates do not split over {F} folds")
    fold = torch.arange(C, device=dev) // G
    y_t = torch.as_tensor(np.asarray(y), dtype=dtype).to(dev)
    ybar = (design.W @ y_t) / design.wsum if fit_intercept else \
        torch.zeros(F, dtype=dtype, device=dev)
    l2 = torch.as_tensor(l2_np, dtype=dtype).to(dev)
    if not np.any(l1_np > 0):
        wv = torch.empty((C, d), dtype=dtype, device=dev)
        eye = torch.eye(d, dtype=dtype, device=dev)
        for f in range(F):
            Xs = (design.Xc - design.mu[f]) / design.sigma[f]
            wr = design.W[f] / design.wsum[f]
            A = Xs.T @ (wr[:, None] * Xs)
            rhs = Xs.T @ (wr * (y_t - ybar[f]))
            for c in range(f * G, (f + 1) * G):
                # a singular system leaves LAPACK's non-finite solution
                # (as jnp.linalg.solve does) instead of raising
                wv[c] = torch.linalg.solve_ex(A + l2[c] * eye, rhs)[0]
    else:
        yc = y_t[:, None] - ybar[None, :]          # (n, F)
        per_row = design.W.T / design.wsum         # (n, F)

        def grad(V):
            r = design.matvec(V) - yc.repeat_interleave(G, dim=1)
            return design.rmatvec(design.fold_rows(r, per_row)) \
                + l2[:, None] * V

        lip_fold = design_lipschitz(design.Xc, 0.0, 1.0, w=design.W,
                                    mu=design.mu, sigma=design.sigma)
        lip = lip_fold.repeat_interleave(G) + l2 + 1e-3
        l1 = torch.as_tensor(l1_np, dtype=dtype).to(dev)
        wv, _ = fista_minimize(
            grad, l1, torch.zeros((C, d), dtype=dtype, device=dev), lip,
            max_iter=max_iter * 5, tol=0.0 if solver == "fista" else 1e-7)
    w_orig = wv / design.sigma[fold]
    if not fit_intercept:
        return w_orig, torch.zeros(C, dtype=dtype, device=dev)
    return w_orig, ybar[fold] - torch.sum(w_orig * design.mu_orig[fold],
                                          dim=1)


def _fit_multinomial_logistic(X, y, reg: float, alpha: float, *, k: int,
                              fit_intercept: bool, standardize: bool,
                              max_iter: int, device):
    """Multinomial (softmax) logistic fit on every row of ``X`` ->
    (coefficients (k, d), intercepts (k,)) in X's space: the mean negative
    log-likelihood plus l2/2 |W|^2, L-BFGS, or FISTA to a step below 1e-7
    when ``reg * alpha`` > 0. The k class rows take the candidate axis of
    the implicitly standardized design, so one ``X @ V`` and one ``X^T @
    R`` give every class's margins and gradient."""
    dev = resolve_device(device)
    n = len(y)
    design = _prep(X, np.ones((1, n)), standardize, dev)
    dtype = design.Xc.dtype
    d = design.Xc.shape[1]
    eye = torch.eye(k, dtype=dtype, device=dev)
    onehot = eye[torch.as_tensor(np.asarray(y), device=dev).long()]
    l2, l1 = float(reg) * (1.0 - float(alpha)), float(reg) * float(alpha)

    def margins(Z):                                # Z (k, d + 1) -> (n, k)
        m = design.matvec(Z[:, :d])
        return m + Z[:, d] if fit_intercept else m

    def finish(Z, R):
        g = torch.empty_like(Z)
        g[:, :d] = design.rmatvec(R) + l2 * Z[:, :d]
        g[:, d] = torch.sum(R, dim=0) if fit_intercept else 0.0
        return g

    def grad(Z):
        return finish(Z, (torch.softmax(margins(Z), dim=1) - onehot) / n)

    W0 = torch.zeros((k, d + 1), dtype=dtype, device=dev)
    if l1 > 0:
        lam = design_lipschitz(design.Xc, 0.0, 0.5, w=design.W,
                               mu=design.mu, sigma=design.sigma)
        mask = torch.ones((k, d + 1), dtype=dtype, device=dev)
        mask[:, d] = 0.0                           # no L1 on the intercepts
        flat, _ = fista_minimize(
            lambda z: grad(z.view(k, d + 1)).reshape(1, -1), l1,
            W0.reshape(1, -1), lam + l2 + 0.5, max_iter=max_iter * 5,
            tol=1e-7, l1_mask=mask.reshape(-1))
        params = flat.view(k, d + 1)
    else:
        def vg(z):
            Z = z.view(k, d + 1)
            m = margins(Z)
            logp = torch.log_softmax(m, dim=1)
            value = (-torch.sum(onehot * logp) / n
                     + 0.5 * l2 * torch.sum(Z[:, :d] ** 2))
            R = (torch.exp(logp) - onehot) / n
            return value, finish(Z, R).reshape(-1)
        params = lbfgs_minimize(vg, W0.reshape(-1),
                                max_iter=max_iter)[0].view(k, d + 1)
    wv = params[:, :d]
    b = params[:, d] if fit_intercept else torch.zeros(k, dtype=dtype,
                                                       device=dev)
    return _unstandardize_coefs(wv, b, design.mu_orig[0], design.sigma[0])


def _grid_to_reg_alpha(estimator, grid,
                       allowed=("reg_param", "elastic_net_param")
                       ) -> np.ndarray:
    """(G, 2) [reg, alpha] from grid dicts; a parameter a dict omits is
    the estimator's own (what ``with_params`` would give). Raises
    NotImplementedError for a parameter the batched search cannot vary."""
    out = np.zeros((len(grid), 2))
    for i, params in enumerate(grid):
        extra = set(params) - set(allowed)
        if extra:
            raise NotImplementedError(
                f"batched kernel cannot vary {sorted(extra)}")
        out[i, 0] = params.get("reg_param", getattr(estimator, "reg_param",
                                                    0.0))
        out[i, 1] = params.get("elastic_net_param",
                               getattr(estimator, "elastic_net_param", 0.0))
    return out


# ---------------------------------------------------------------------------
# estimators and models
# ---------------------------------------------------------------------------

#: rows a batch is padded to before its running sum: the serving plan's
#: smallest bucket, from which on the card's scan kernel added every
#: batch size measured (8 to 8,192 rows) in one order
_SCAN_MIN_ROWS = 8


def _feature_order_margins(X: torch.Tensor, coef: torch.Tensor
                           ) -> torch.Tensor:
    """Each row's products with ``coef`` (d,) or with each row of ``coef``
    (k, d), added in feature order (the last row of a running sum over the
    features): (n,) or (n, k). A row's margin is then the same bit for bit
    whatever batch it is scored in; a matrix product lets the card's BLAS
    pick its kernel, and so its order of additions, by the batch's size
    (up to 8 float32 ulps apart between buckets of the serving plan). A
    batch of fewer than _SCAN_MIN_ROWS rows (one served record) is padded
    with zero rows, so that the scan runs as for a plan's bucket."""
    n = X.shape[0]
    if n < _SCAN_MIN_ROWS:
        X = torch.cat([X, X.new_zeros((_SCAN_MIN_ROWS - n, X.shape[1]))])
    if coef.dim() == 1:
        return torch.cumsum((X * coef).t(), dim=0)[-1][:n]
    return torch.cumsum(X.t()[:, :, None] * coef.t()[:, None, :],
                        dim=0)[-1][:n]


class _LinearModel(ClassifierModel):
    """Binary linear classifier: margins X.coef + intercept, raw
    prediction [-m, m]; the coefficients live on ``device``."""

    def __init__(self, coefficients, intercept, device="cuda",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device)
        self.coefficients = torch.from_numpy(
            np.array(coefficients, dtype=np.float64).reshape(-1)).to(
                self.device, self.dtype)
        self.intercept = float(np.asarray(intercept).reshape(()))

    def raw_arrays(self, X: torch.Tensor) -> torch.Tensor:
        """(n, 2) raw pair [-m, m] of the margins m, added in feature
        order (``_feature_order_margins``)."""
        m = _feature_order_margins(X, self.coefficients) + self.intercept
        return torch.stack([-m, m], dim=1)


class LogisticRegressionModel(_LinearModel):
    """Logistic model: softmax probability of the raw margins. Binary
    models hold ``coefficients`` (d,) and raw pairs [-m, m]; multinomial
    ones (k, d) coefficients and (k,) intercepts, raw margins X W^T + b."""

    def __init__(self, coefficients, intercept, device="cuda",
                 uid: Optional[str] = None):
        coef = np.asarray(coefficients, dtype=np.float64)
        if coef.ndim == 1:
            super().__init__(coef, intercept, device=device, uid=uid)
            return
        ClassifierModel.__init__(self, uid=uid)
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device)
        self.coefficients = torch.from_numpy(np.array(coef)).to(
            self.device, self.dtype)
        self.intercept = torch.from_numpy(
            np.array(intercept, dtype=np.float64).reshape(-1)).to(
                self.device, self.dtype)

    def raw_arrays(self, X: torch.Tensor) -> torch.Tensor:
        if self.coefficients.dim() == 1:
            return super().raw_arrays(X)
        return (_feature_order_margins(X, self.coefficients)
                + self.intercept)


class LinearSVCModel(_LinearModel):
    """SVC model: raw prediction only, no probability (as in MLlib); the
    label is the margin's sign."""

    def prediction_from_raw(self, raw: np.ndarray) -> PredictionColumn:
        raw = np.asarray(raw, dtype=np.float64)
        pred = (raw[:, 1] > 0).astype(np.float64)
        return PredictionColumn.from_arrays(pred, raw_prediction=raw)


class _LinearEstimator(Predictor):
    """``tol`` is accepted for the reference's API and, as there, read by
    no solver: L-BFGS stops at a gradient norm below 1e-6, the L1 refit's
    FISTA at a step below 1e-7."""
    kind = ""
    grid_params: Tuple[str, ...] = ()
    core = None

    def fit_arrays(self, X, y):
        k = int(np.max(y)) + 1 if len(y) else 2
        if k > 2:
            if self.kind != "logistic":
                raise ValueError(f"{type(self).__name__} takes binary "
                                 f"labels only")
            coef, b = _fit_multinomial_logistic(
                X, y, self.reg_param, self.elastic_net_param, k=k,
                fit_intercept=self.fit_intercept,
                standardize=self.standardization, max_iter=self.max_iter,
                device=self.device)
            return self.model_type(coef.cpu().numpy(), b.cpu().numpy(),
                                   device=self.device)
        coef, b = self.core(
            X, y, np.ones((1, len(y))), self.reg_param,
            getattr(self, "elastic_net_param", 0.0),
            fit_intercept=self.fit_intercept,
            standardize=self.standardization, max_iter=self.max_iter,
            device=self.device)
        # the JAX package hands its logistic model a 0-d intercept array
        # and its SVC model a float, and saves them so
        b0 = b[0].cpu().numpy()
        return self.model_type(coef[0].cpu().numpy(),
                               b0 if self.kind == "logistic" else float(b0),
                               device=self.device)

    def fit_fold_grid_arrays(self, X, y, masks, grid):
        """Every (fold, grid point) candidate fitted as the search fits
        it (fixed-trip FISTA, see ``parallel/cv.fit_linear_fold_grid``),
        (F, G) models out. Binary labels only, as in the JAX package: the
        multinomial search fits candidate by candidate."""
        if len(y) and int(np.max(y)) + 1 > 2:
            raise NotImplementedError("batched kernel is binary-only")
        from ..parallel.cv import fit_linear_fold_grid
        ga = _grid_to_reg_alpha(self, grid, allowed=self.grid_params)
        params = fit_linear_fold_grid(
            self.kind, X, y, masks, ga, fit_intercept=self.fit_intercept,
            standardize=self.standardization, max_iter=self.max_iter,
            device=self.device)
        d = X.shape[1]
        # the JAX package's intercept types: a 0-d array for the logistic
        # model, a float for the SVC
        return [[self.model_type(
            p[:d], p[d] if self.kind == "logistic" else float(p[d]),
            device=self.device) for p in row] for row in params]

    def eval_fold_grid_arrays(self, X, y, masks, grid, X_val, y_val, spec,
                              cand_idx=None) -> np.ndarray:
        """Device-resident search: fit and validation metric of every
        (fold, grid point) candidate, (F, G) matrix out (see
        ``parallel/cv.eval_linear_fold_grid``)."""
        if spec[0] != "binary":
            raise NotImplementedError(
                f"{type(self).__name__} device eval is binary-only")
        if len(y) and int(np.max(y)) + 1 > 2:
            # the multinomial search is validated candidate by candidate,
            # as in the JAX package
            raise NotImplementedError("batched kernel is binary-only")
        from ..parallel.cv import eval_linear_fold_grid
        ga = _grid_to_reg_alpha(self, subset_grid(grid, cand_idx),
                                allowed=self.grid_params)
        return eval_linear_fold_grid(
            self.kind, X, y, masks, ga, X_val, y_val, spec,
            fit_intercept=self.fit_intercept,
            standardize=self.standardization, max_iter=self.max_iter,
            device=self.device)


class LogisticRegression(_LinearEstimator):
    """Binomial logistic regression with an elastic-net penalty
    reg * (alpha L1 + (1 - alpha)/2 L2) in the standardized space
    (reference OpLogisticRegression.scala:45). ``tol`` is accepted and
    ignored (see ``_LinearEstimator``)."""

    kind = "logistic"
    core = staticmethod(binary_logistic_core)
    grid_params = ("reg_param", "elastic_net_param")
    model_type = LogisticRegressionModel

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 100, tol: float = 1e-6,
                 fit_intercept: bool = True, standardization: bool = True,
                 device="cuda", uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.reg_param = reg_param
        self.elastic_net_param = elastic_net_param
        self.max_iter = max_iter
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.standardization = standardization
        self.device = resolve_device(device)


class LinearSVC(_LinearEstimator):
    """Linear support-vector classifier on the squared hinge with an L2
    penalty (reference OpLinearSVC.scala; the JAX package's documented
    smooth variant of MLlib's hinge). ``tol`` is accepted and ignored
    (see ``_LinearEstimator``)."""

    kind = "svc"
    core = staticmethod(linear_svc_core)
    grid_params = ("reg_param",)
    model_type = LinearSVCModel

    def __init__(self, reg_param: float = 0.0, max_iter: int = 100,
                 tol: float = 1e-6, fit_intercept: bool = True,
                 standardization: bool = True, device="cuda",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.reg_param = reg_param
        self.max_iter = max_iter
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.standardization = standardization
        self.device = resolve_device(device)


class LinearRegressionModel(RegressionModel):
    """Linear regression model: X.coef + intercept, added in feature order
    (``_feature_order_margins``); the coefficients live on ``device``."""

    def __init__(self, coefficients, intercept: float = 0.0, device="cuda",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device)
        self.coefficients = torch.from_numpy(
            np.array(coefficients, dtype=np.float64).reshape(-1)).to(
                self.device, self.dtype)
        self.intercept = float(intercept)

    def raw_arrays(self, X: torch.Tensor) -> torch.Tensor:
        return _feature_order_margins(X, self.coefficients) + self.intercept


class LinearRegression(Predictor):
    """OLS / ridge / elastic-net linear regression (reference
    OpLinearRegression.scala). ``tol`` is accepted for the reference's API
    and read by no solver, as there."""

    def __init__(self, reg_param: float = 0.0, elastic_net_param: float = 0.0,
                 max_iter: int = 100, tol: float = 1e-6,
                 fit_intercept: bool = True, standardization: bool = True,
                 device="cuda", uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.reg_param = reg_param
        self.elastic_net_param = elastic_net_param
        self.max_iter = max_iter
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.standardization = standardization
        self.device = resolve_device(device)

    def fit_arrays(self, X, y) -> LinearRegressionModel:
        coef, b = linear_regression_core(
            X, y, np.ones((1, len(y))), self.reg_param,
            self.elastic_net_param, fit_intercept=self.fit_intercept,
            standardize=self.standardization, max_iter=self.max_iter,
            device=self.device)
        return LinearRegressionModel(coef[0].cpu().numpy(),
                                     float(b[0].cpu()), device=self.device)

    def fit_fold_grid_arrays(self, X, y, masks, grid):
        """Every (fold, grid point) candidate fitted as the search fits
        it (see ``parallel/cv.fit_linear_fold_grid``), (F, G) models
        out."""
        from ..parallel.cv import fit_linear_fold_grid
        ga = _grid_to_reg_alpha(self, grid)
        params = fit_linear_fold_grid(
            "squared", X, y, masks, ga, fit_intercept=self.fit_intercept,
            standardize=self.standardization, max_iter=self.max_iter,
            device=self.device)
        d = X.shape[1]
        return [[LinearRegressionModel(p[:d], float(p[d]),
                                       device=self.device) for p in row]
                for row in params]

    def eval_fold_grid_arrays(self, X, y, masks, grid, X_val, y_val, spec,
                              cand_idx=None) -> np.ndarray:
        """Device-resident search (see ``parallel/cv``); predicted values
        feed the regression metric."""
        if spec[0] != "regression":
            raise NotImplementedError(
                "linear-regression device eval needs a regression metric")
        from ..parallel.cv import eval_linear_fold_grid
        ga = _grid_to_reg_alpha(self, subset_grid(grid, cand_idx))
        return eval_linear_fold_grid(
            "squared", X, y, masks, ga, X_val, y_val, spec,
            fit_intercept=self.fit_intercept,
            standardize=self.standardization, max_iter=self.max_iter,
            device=self.device)
