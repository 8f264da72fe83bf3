"""Multilayer perceptron classifier in PyTorch.

Counterpart of ``transmogrifai_tpu/models/mlp.py`` (the reference's
OpMultilayerPerceptronClassifier, MLlib's feed-forward network: sigmoid
hidden layers, a softmax output, cross-entropy): ``_group_mlp_grid``,
``_init_params``, ``_forward``, the sequential fit ``_fit_mlp`` (L-BFGS,
``models/solvers.lbfgs_minimize``, over the per-layer (W, b) flattened in
the JAX pytree's leaf order W0, b0, W1, b1, ...), the batched fold fit
``_mlp_batched_fit`` (fixed-trip mini-batch Adam under a cosine decay
of the step, the search's solver), ``fit_fold_grid_arrays``,
``eval_fold_grid_arrays`` and the model.

Adam and its schedule are written out as optax defines them (b1 0.9, b2
0.999, eps 1e-8, the bias corrections at the incremented count, the
step ``-0.03 * 0.5 (1 + cos(pi t / steps))`` read at the count before
the increment), not taken from ``torch.optim``, so that a step compares
with the JAX package's step for step. The folds of one grid point share
its draws (the JAX package vmaps one key over the fold masks), so they
run as lanes of one batch: every layer's weights carry a leading fold
axis and each product is one batched ``matmul``. The gradients come
from autograd. The products are plain matrix products, as the JAX
package computes them outside any Pallas kernel.

Draws (the initial weights and the search's row permutation) come from a
provider, ``TorchMLPDraws`` by default; a test hands in one that replays
the JAX package's keys.
"""
from __future__ import annotations

import logging
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device, working_dtype
from .base import (ClassifierModel, Predictor, check_fold_classes,
                   num_classes, subset_grid)
from .draws import _mix
from .linear import _feature_order_margins
from .solvers import lbfgs_minimize

__all__ = ["MultilayerPerceptronClassifier",
           "MultilayerPerceptronClassifierModel", "TorchMLPDraws"]

_log = logging.getLogger(__name__)

#: mini-batch size / steps per max_iter of the batched fold solver
_MB_BATCH = 512
_MB_STEPS_PER_ITER = 6
#: Adam (optax defaults) and the peak of its cosine-decayed step
_B1, _B2, _EPS, _PEAK_STEP = 0.9, 0.999, 1e-8, 0.03
#: grid parameters the batched paths take
_GRID_ALLOWED = {"hidden_layers", "max_iter", "tol", "seed"}


class TorchMLPDraws:
    """The port's MLP draws from a CPU ``torch.Generator`` per (seed,
    stream): ``init(sizes, fold)`` gives each layer's (fan_in, fan_out)
    weights, uniform in +-sqrt(6 / (fan_in + fan_out)) (MLlib's scaled
    init; the sequential fit's for ``fold`` False, the fold fits' for
    True), ``permutation(n)`` the fold fits' row order. Float64 on the
    CPU, so a card and the CPU fed by one provider start alike."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def _gen(self, *words: int) -> torch.Generator:
        return torch.Generator().manual_seed(_mix(self.seed, *words))

    def init(self, sizes: Sequence[int], fold: bool) -> List[torch.Tensor]:
        out = []
        for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:])):
            scale = math.sqrt(6.0 / (fi + fo))
            u = torch.rand((fi, fo), generator=self._gen(int(fold), i),
                           dtype=torch.float64)
            out.append(u * (2 * scale) - scale)
        return out

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(int(n), generator=self._gen(2))


def _group_mlp_grid(grid, with_params):
    """Grid points grouped by (hidden_layers, max_iter, seed): ``tol``
    only stops the sequential L-BFGS, so points that differ in it alone
    share one fixed-trip batched fit (logged, as in the JAX package)."""
    groups = {}
    for gi, p in enumerate(grid):
        cand = with_params(**p)
        key = (cand.hidden_layers, cand.max_iter, cand.seed)
        groups.setdefault(key, []).append(gi)
    for key, gis in groups.items():
        if len(gis) > 1:
            _log.info("MLP batched CV: grid points %s differ only in tol "
                      "and share one fixed-trip fit (hidden=%s, "
                      "max_iter=%s)", gis, key[0], key[1])
    return groups


def _init_params(weights: Sequence[torch.Tensor], dtype, device
                 ) -> List[torch.Tensor]:
    """[W0, b0, W1, b1, ...] from the drawn weights, zero biases."""
    params = []
    for W in weights:
        W = torch.as_tensor(np.array(W) if isinstance(W, np.ndarray)
                            else W).to(device=device, dtype=dtype)
        params += [W, torch.zeros(W.shape[-1], dtype=dtype, device=device)]
    return params


def _affine(h: torch.Tensor, W: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    return torch.matmul(h, W) + (b[:, None, :] if b.dim() > 1 else b)


def _forward(params: Sequence[torch.Tensor], X: torch.Tensor
             ) -> torch.Tensor:
    """Sigmoid hidden layers, raw logits at the top (MLlib's topology);
    ``params`` [W0, b0, ...], each optionally with a leading lane axis
    (then ``X`` is shared and the logits are (lanes, n, K))."""
    h = X
    for W, b in zip(params[0:-2:2], params[1:-2:2]):
        h = torch.sigmoid(_affine(h, W, b))
    return _affine(h, params[-2], params[-1])


def _fit_mlp(X: torch.Tensor, onehot: torch.Tensor, weights, *,
             max_iter: int, tol: float) -> Tuple[List[torch.Tensor], int]:
    """The sequential fit: L-BFGS on the mean cross-entropy from the
    drawn ``weights``. Returns ([W0, b0, ...], iterations)."""
    params0 = _init_params(weights, X.dtype, X.device)
    shapes = [p.shape for p in params0]
    sizes = [p.numel() for p in params0]

    def unflatten(w):
        return [t.view(s) for t, s in zip(torch.split(w, sizes), shapes)]

    def value_and_grad(w):
        w = w.detach().requires_grad_(True)
        logits = _forward(unflatten(w), X)
        loss = -torch.mean(torch.sum(
            onehot * torch.log_softmax(logits, dim=1), dim=1))
        (grad,) = torch.autograd.grad(loss, w)
        return loss.detach(), grad

    w0 = torch.cat([p.reshape(-1) for p in params0])
    w, iterations = lbfgs_minimize(value_and_grad, w0, max_iter=max_iter,
                                   tol=tol)
    return [t.detach() for t in unflatten(w)], iterations


def _mlp_batched_fit(X: torch.Tensor, onehot: torch.Tensor,
                     masks: torch.Tensor, perm: torch.Tensor, weights,
                     max_iter: int) -> List[torch.Tensor]:
    """The fold fits of one grid point, one lane a fold (``masks`` (F,
    n)): fixed-trip mini-batch Adam, 6 steps per ``max_iter``, over
    windows of 512 rows of the permuted rows (step i starts at
    ``i * 512 mod (n - 511)``), each lane's loss its masked mean
    cross-entropy. The search only ranks grid points with these fits;
    the winner's refit is the L-BFGS of ``_fit_mlp``. Returns [W0, b0,
    ...] with a leading fold axis."""
    n = X.shape[0]
    F = masks.shape[0]
    batch = min(_MB_BATCH, n)
    steps = _MB_STEPS_PER_ITER * int(max_iter)
    span = max(n - batch + 1, 1)
    Xp, ohp, mp = X[perm], onehot[perm], masks[:, perm]
    params = [p.expand(F, *p.shape).clone().requires_grad_(True)
              for p in _init_params(weights, X.dtype, X.device)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    for i in range(steps):
        start = (i * batch) % span
        xb, ob = Xp[start:start + batch], ohp[start:start + batch]
        mb = mp[:, start:start + batch]
        ll = torch.sum(ob * torch.log_softmax(_forward(params, xb), dim=2),
                       dim=2)                                   # (F, B)
        loss = -torch.sum(mb * ll, dim=1) / torch.clamp(
            torch.sum(mb, dim=1), min=1.0)
        grads = torch.autograd.grad(torch.sum(loss), params)
        count = i + 1
        bc1, bc2 = 1 - _B1 ** count, 1 - _B2 ** count
        step = -(_PEAK_STEP * (0.5 * (1 + math.cos(
            math.pi * min(i, steps) / steps))))
        with torch.no_grad():
            for p, g, m, v in zip(params, grads, mu, nu):
                m.copy_((1 - _B1) * g + _B1 * m)
                v.copy_((1 - _B2) * (g * g) + _B2 * v)
                p.add_(step * ((m / bc1) / (torch.sqrt(v / bc2) + _EPS)))
    return [p.detach() for p in params]


class MultilayerPerceptronClassifierModel(ClassifierModel):
    """Fitted MLP: raw predictions are the (n, K) logits, whose softmax is
    the probability. The weights live on ``device`` (transposed copies
    for the feature-order products)."""

    def __init__(self, weights, biases, device="cuda",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device)
        self.weights = [torch.as_tensor(np.asarray(W, dtype=np.float64)).to(
            self.device, self.dtype) for W in weights]
        self.biases = [torch.as_tensor(np.asarray(b, dtype=np.float64)).to(
            self.device, self.dtype) for b in biases]

    def raw_arrays(self, X: torch.Tensor) -> torch.Tensor:
        """Sigmoid hidden layers as 1 / (1 + exp(-z)), logits on top; each
        row's products added in feature order (``linear.
        _feature_order_margins``), so that a row scores the same bit for
        bit in any batch: a served record as in its batch, a compiled
        plan's bucket as the columnar path."""
        h = X
        for W, b in zip(self.weights[:-1], self.biases[:-1]):
            h = 1.0 / (1.0 + torch.exp(-(_feature_order_margins(h, W.t())
                                         + b)))
        return _feature_order_margins(h, self.weights[-1].t()) \
            + self.biases[-1]


class MultilayerPerceptronClassifier(Predictor):
    """Feed-forward classifier (reference
    OpMultilayerPerceptronClassifier.scala:48). ``hidden_layers`` are the
    intermediate widths; the input and output widths come from the data.
    ``draws``: optional factory ``draws(seed)`` of the initial weights and
    the search's permutation (TorchMLPDraws when None)."""

    def __init__(self, hidden_layers: Sequence[int] = (10,),
                 max_iter: int = 100, tol: float = 1e-6, seed: int = 42,
                 device="cuda", draws=None, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.hidden_layers = tuple(int(h) for h in hidden_layers)
        self.max_iter = max_iter
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.draws = draws

    def _inputs(self, X, y, k: int):
        dtype = working_dtype(self.device)
        Xt = torch.as_tensor(X, dtype=dtype, device=self.device)
        labels = torch.as_tensor(np.asarray(y), device=self.device).long()
        return Xt, torch.eye(k, dtype=dtype, device=self.device)[labels]

    def _draws(self, seed: int):
        return (self.draws or TorchMLPDraws)(seed)

    def fit_arrays(self, X, y) -> MultilayerPerceptronClassifierModel:
        k = num_classes(y)
        Xt, onehot = self._inputs(X, y, k)
        sizes = (Xt.shape[1],) + self.hidden_layers + (k,)
        params, _ = _fit_mlp(
            Xt, onehot, self._draws(self.seed).init(sizes, False),
            max_iter=int(self.max_iter), tol=float(self.tol))
        return MultilayerPerceptronClassifierModel(
            [W.cpu().numpy() for W in params[0::2]],
            [b.cpu().numpy() for b in params[1::2]], device=self.device)

    def _fold_fits(self, X, y, masks, grid):
        """The batched fold fits of every (hidden, max_iter, seed) group:
        yields (grid indices of the group, [W0, b0, ...] with a leading
        fold axis). NotImplementedError for a grid parameter it cannot
        batch or a fold that lacks a class."""
        grid = [dict(p) for p in (list(grid) or [{}])]
        for p in grid:
            extra = set(p) - _GRID_ALLOWED
            if extra:
                raise NotImplementedError(
                    f"batched MLP kernel cannot vary {sorted(extra)}")
        masks = np.asarray(masks, dtype=np.float64)
        check_fold_classes(y, masks)
        k = num_classes(y)
        Xt, onehot = self._inputs(X, y, k)
        m_t = torch.as_tensor(masks, dtype=Xt.dtype, device=self.device)
        for (hidden, mi, seed), gis in _group_mlp_grid(
                grid, self.with_params).items():
            sizes = (Xt.shape[1],) + tuple(hidden) + (k,)
            draws = self._draws(seed)
            perm = torch.as_tensor(draws.permutation(Xt.shape[0]),
                                   device=self.device).long()
            yield gis, _mlp_batched_fit(Xt, onehot, m_t, perm,
                                        draws.init(sizes, True), int(mi))

    def fit_fold_grid_arrays(self, X, y, masks, grid):
        """Every (fold, grid point) candidate fitted as the search fits
        it (``_mlp_batched_fit``), (F, G) models out; grid points of one
        group share their models."""
        F = np.asarray(masks).shape[0]
        models = [[None] * len(list(grid) or [{}]) for _ in range(F)]
        for gis, params in self._fold_fits(X, y, masks, grid):
            host = [p.cpu().numpy() for p in params]
            for f in range(F):
                model = MultilayerPerceptronClassifierModel(
                    [W[f] for W in host[0::2]], [b[f] for b in host[1::2]],
                    device=self.device)
                for gi in gis:
                    models[f][gi] = model
        return models

    def eval_fold_grid_arrays(self, X, y, masks, grid, X_val, y_val, spec,
                              cand_idx=None) -> np.ndarray:
        """Device-resident search: the batched fold fits, then each
        fold's logits on its validation rows, scored by the softmax
        (binary: its positive share and the argmax), (F, G) matrix out."""
        from ..evaluators.device_metrics import (binary_from_raw_pair,
                                                 metric_fn,
                                                 softmax_probability)
        if spec[0] not in ("binary", "multiclass"):
            raise NotImplementedError(
                "MLP device eval needs a classification metric")
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
        for gis, params in self._fold_fits(X, y, masks, grid):
            for f in range(F):
                logits = _forward([p[f] for p in params], Xv[f])
                scores = (binary_from_raw_pair(logits) if spec[0] == "binary"
                          else softmax_probability(logits))
                metric = mfn(yv[f], scores)
                for gi in gis:
                    mm[f, gi] = metric
        return mm.cpu().numpy().astype(np.float64)
