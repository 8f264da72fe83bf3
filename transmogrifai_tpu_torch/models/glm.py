"""Generalized linear regression by IRLS in PyTorch.

Counterpart of ``transmogrifai_tpu/models/glm.py`` (the masked IRLS core
``_glm_irls_core`` with its tolerance loop, the fold x grid fit and eval,
``GeneralizedLinearRegression`` with its grid groups,
``GeneralizedLinearRegressionModel``): families gaussian, binomial,
poisson, gamma and tweedie with their canonical or explicit links and an
L2 penalty on the coefficients (not the intercept). Each IRLS iteration
is one weighted (d+1, d+1) ridge solve. A search runs every (fold, grid
point) candidate of a (family, link) group as one batch: fold masks are
row weights (a masked row carries zero IRLS weight and never reaches the
link's nonlinearity in the gram matrix), and each candidate stops at its
own iteration, as the JAX package's vmapped ``while_loop`` freezes each
lane.

Numbers: the IRLS runs in float64 on every device. The design is not
standardized, so the gram matrix of raw features (tax in the hundreds
beside 0/1 indicators) is too ill-conditioned for float32 solves; on the
card the n x (d+1) products are float64 too.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device, working_dtype
from .base import Predictor, RegressionModel, subset_grid

__all__ = ["GeneralizedLinearRegression", "GeneralizedLinearRegressionModel"]

_DEFAULT_LINK = {"gaussian": "identity", "binomial": "logit",
                 "poisson": "log", "gamma": "inverse", "tweedie": "log"}

_EPS = 1e-10


def _link_fns(link: str):
    """(g(mu), g^-1(eta), g'(mu))"""
    if link == "identity":
        return (lambda mu: mu, lambda eta: eta,
                lambda mu: torch.ones_like(mu))
    if link == "log":
        return (lambda mu: torch.log(torch.clamp(mu, min=_EPS)),
                torch.exp,
                lambda mu: 1.0 / torch.clamp(mu, min=_EPS))
    if link == "logit":
        return (lambda mu: torch.log(mu / (1 - mu)),
                torch.sigmoid,
                lambda mu: 1.0 / torch.clamp(mu * (1 - mu), min=_EPS))
    if link == "inverse":
        return (lambda mu: 1.0 / torch.clamp(mu, min=_EPS),
                lambda eta: 1.0 / torch.where(torch.abs(eta) > _EPS, eta,
                                              _EPS),
                lambda mu: -1.0 / torch.clamp(mu * mu, min=_EPS))
    if link == "sqrt":
        return (lambda mu: torch.sqrt(torch.clamp(mu, min=0.0)),
                lambda eta: eta * eta,
                lambda mu: 0.5 / torch.sqrt(torch.clamp(mu, min=_EPS)))
    raise ValueError(f"Unknown link {link!r}")


def _variance_fn(family: str, var_power):
    if family == "gaussian":
        return torch.ones_like
    if family == "binomial":
        return lambda mu: torch.clamp(mu * (1 - mu), min=_EPS)
    if family == "poisson":
        return lambda mu: torch.clamp(mu, min=_EPS)
    if family == "gamma":
        return lambda mu: torch.clamp(mu * mu, min=_EPS)
    if family == "tweedie":
        return lambda mu: torch.clamp(mu, min=_EPS) ** var_power
    raise ValueError(f"Unknown family {family!r}")


def _init_mu(family: str, y: torch.Tensor) -> torch.Tensor:
    if family == "binomial":
        return (y + 0.5) / 2.0
    if family in ("poisson", "gamma", "tweedie"):
        return torch.clamp(y, min=0.1)
    return y


def _weighted_gram(Xa: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(C, p, p) ``Xa^T diag(w_c) Xa`` of each column of ``w`` (n, C)."""
    return torch.stack([(Xa * w[:, c:c + 1]).T @ Xa
                        for c in range(w.shape[1])])


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``A x = b`` by LU; a singular system gives the non-finite
    solution LAPACK leaves (as ``jnp.linalg.solve`` does), not an error,
    so its candidate scores NaN instead of stopping the search."""
    return torch.linalg.solve_ex(A, b)[0]


def _glm_irls(X: torch.Tensor, y: torch.Tensor, masks: torch.Tensor,
              regs: torch.Tensor, var_powers: torch.Tensor, tol: float, *,
              family: str, link: str, max_iter: int, fit_intercept: bool):
    """Masked weighted IRLS of C candidates: ``masks`` (C, n) 0/1 rows,
    ``regs`` and ``var_powers`` (C,). Starts from the masked least-squares
    fit of g(mu0), then iterates each candidate while its iteration count
    is 0, or below ``max_iter`` with a relative step of at least ``tol``.
    Returns (coefficients (C, d), intercepts (C,))."""
    n, d = X.shape
    C = masks.shape[0]
    dt, dev = X.dtype, X.device
    g, ginv, gprime = _link_fns(link)
    msum = torch.clamp(torch.sum(masks, dim=1), min=1.0)          # (C,)
    if fit_intercept:
        Xa = torch.cat([X, torch.ones((n, 1), dtype=dt, device=dev)], 1)
        pen = torch.cat([regs[:, None].expand(C, d),
                         torch.zeros((C, 1), dtype=dt, device=dev)], 1)
    else:
        Xa, pen = X, regs[:, None].expand(C, d)
    M = masks.T                                                    # (n, C)
    live = M > 0

    def solve(w, z, extra):
        A = _weighted_gram(Xa, w) / msum[:, None, None] + torch.diag_embed(
            extra)
        b = (Xa.T @ (w * z)).T / msum[:, None]
        return _solve(A, b)

    eta0 = torch.where(live, g(_init_mu(family, y))[:, None], 0.0)
    beta = solve(M, eta0, pen + _EPS)                              # (C, p)
    active = torch.arange(C, device=dev)
    it = 0
    while len(active):
        var = _variance_fn(family, var_powers[active][None, :])
        eta = Xa @ beta[active].T                                  # (n, A)
        mu = ginv(eta)
        gp = gprime(mu)
        z = eta + (y[:, None] - mu) * gp
        w = M[:, active] / torch.clamp(var(mu) * gp * gp, min=_EPS)
        # a held-out row may overflow the link (exp under a log link);
        # zero it explicitly so 0 * inf never poisons the gram matrix
        lv = live[:, active]
        w = torch.where(lv, w, 0.0)
        z = torch.where(lv, z, 0.0)
        A = (_weighted_gram(Xa, w) / msum[active][:, None, None]
             + torch.diag_embed(pen[active]))
        nxt = _solve(A, (Xa.T @ (w * z)).T / msum[active][:, None])
        delta = (torch.linalg.vector_norm(nxt - beta[active], dim=1)
                 / torch.clamp(torch.linalg.vector_norm(beta[active], dim=1),
                               min=1.0))
        beta[active] = nxt
        it += 1
        if it >= max_iter:
            break
        active = active[delta >= tol]
    if fit_intercept:
        return beta[:, :d], beta[:, d]
    return beta, torch.zeros(C, dtype=dt, device=dev)


def _glm_predict(beta: torch.Tensor, intercept, link: str,
                 X: torch.Tensor) -> torch.Tensor:
    """g^-1 of the margins, each row's products added in feature order
    (a row's prediction does not depend on its batch)."""
    _, ginv, _ = _link_fns(link)
    eta = torch.cumsum((X * beta).t(), dim=0)[-1] + intercept
    return ginv(eta)


class GeneralizedLinearRegressionModel(RegressionModel):
    """Fitted GLM: g^-1(X.coef + intercept). The coefficients live on
    ``device`` in its working dtype."""

    def __init__(self, coefficients, intercept: float = 0.0,
                 link: str = "identity", device="cuda",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device)
        self.coefficients = torch.from_numpy(
            np.array(coefficients, dtype=np.float64).reshape(-1)).to(
                self.device, self.dtype)
        self.intercept = float(intercept)
        self.link = link

    def raw_arrays(self, X: torch.Tensor) -> torch.Tensor:
        return _glm_predict(self.coefficients, self.intercept, self.link, X)


class GeneralizedLinearRegression(Predictor):
    """GLM by IRLS (reference OpGeneralizedLinearRegression.scala)."""

    _GRID_ALLOWED = {"family", "link", "reg_param", "variance_power"}

    def __init__(self, family: str = "gaussian", link: Optional[str] = None,
                 reg_param: float = 0.0, max_iter: int = 25,
                 tol: float = 1e-6, fit_intercept: bool = True,
                 variance_power: float = 1.5, device="cuda",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.family = family
        self.link = link or _DEFAULT_LINK[family]
        self.reg_param = reg_param
        self.max_iter = max_iter
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.variance_power = variance_power
        self.device = resolve_device(device)

    def _tensors(self, X, y):
        """X and y on the device in float64 (see the module note)."""
        return (torch.as_tensor(X, device=self.device).to(torch.float64),
                torch.as_tensor(np.asarray(y, dtype=np.float64),
                                device=self.device))

    def _irls(self, X, y, masks, regs, vps, family, link, max_iter,
              fit_intercept):
        f64 = dict(dtype=torch.float64, device=self.device)
        return _glm_irls(X, y, torch.as_tensor(masks, **f64),
                         torch.as_tensor(regs, **f64),
                         torch.as_tensor(vps, **f64), float(self.tol),
                         family=family, link=link, max_iter=int(max_iter),
                         fit_intercept=bool(fit_intercept))

    def fit_arrays(self, X, y) -> GeneralizedLinearRegressionModel:
        Xt, yt = self._tensors(X, y)
        w, b = self._irls(Xt, yt, np.ones((1, len(y))), [self.reg_param],
                          [self.variance_power], self.family, self.link,
                          self.max_iter, self.fit_intercept)
        return GeneralizedLinearRegressionModel(
            w[0].cpu().numpy(), float(b[0].cpu()), link=self.link,
            device=self.device)

    def _grid_groups(self, grid):
        """Grid points grouped by their static (family, link, intercept,
        max_iter); reg_param and variance_power vary within a group."""
        grid = [dict(p) for p in (list(grid) or [{}])]
        for p in grid:
            extra = set(p) - self._GRID_ALLOWED
            if extra:
                raise NotImplementedError(
                    f"the GLM search cannot vary {sorted(extra)}")
        groups = {}
        for gi, p in enumerate(grid):
            cand = self.with_params(**p)
            key = (cand.family, cand.link, cand.fit_intercept,
                   cand.max_iter)
            groups.setdefault(key, []).append((gi, cand))
        return grid, groups

    def _fold_grid(self, X, y, masks, grid):
        """The masked IRLS of every (fold, grid point) candidate, one batch
        a (family, link, intercept, max_iter) group: yields (fold, grid
        index, link, coefficients (d,), intercept 0-d) of each."""
        masks = np.asarray(masks, dtype=np.float64)
        F = masks.shape[0]
        Xt, yt = self._tensors(X, y)
        for (family, link, fit_int, mi), members in self._grid_groups(
                grid)[1].items():
            gk = len(members)
            W, B = self._irls(
                Xt, yt, np.repeat(masks, gk, axis=0),
                np.tile([float(c.reg_param) for _, c in members], F),
                np.tile([float(c.variance_power) for _, c in members], F),
                family, link, mi, fit_int)
            for f in range(F):
                for j, (gi, _) in enumerate(members):
                    yield f, gi, link, W[f * gk + j], B[f * gk + j]

    def fit_fold_grid_arrays(self, X, y, masks, grid):
        """Every (fold, grid point) candidate fitted as the search fits
        it, (F, G) models out."""
        grid = self._grid_groups(grid)[0]
        models = [[None] * len(grid) for _ in range(np.asarray(masks)
                                                    .shape[0])]
        for f, gi, link, w, b in self._fold_grid(X, y, masks, grid):
            models[f][gi] = GeneralizedLinearRegressionModel(
                w.cpu().numpy(), float(b.cpu()), link=link,
                device=self.device)
        return models

    def eval_fold_grid_arrays(self, X, y, masks, grid, X_val, y_val, spec,
                              cand_idx=None) -> np.ndarray:
        """Device-resident search: the masked IRLS of every (fold, grid
        point) candidate of a group as one batch, then its validation
        metric; (F, G) matrix out."""
        from ..evaluators.device_metrics import metric_fn
        if spec[0] != "regression":
            raise NotImplementedError(
                "GLM device eval needs a regression metric")
        grid = self._grid_groups(subset_grid(grid, cand_idx))[0]
        Xv = torch.as_tensor(X_val, device=self.device).to(torch.float64)
        yv = torch.as_tensor(np.asarray(y_val, dtype=np.float64),
                             device=self.device)
        mfn = metric_fn(*spec)
        mm = torch.full((np.asarray(masks).shape[0], len(grid)), torch.nan,
                        dtype=torch.float64, device=self.device)
        for f, gi, link, w, b in self._fold_grid(X, y, masks, grid):
            mm[f, gi] = mfn(yv[f], _glm_predict(w, b, link, Xv[f]))
        return mm.cpu().numpy()
