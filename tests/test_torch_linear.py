"""Logistic regression and LinearSVC of the PyTorch port against the JAX
package, in float64 on the CPU: the solvers (power iteration, FISTA in both
modes, optax's L-BFGS), the fold x grid search, single fits and the models
carried across. Inputs are made with numpy from seeds; the design has a
constant column (the scale floor) and a column with a mean of 1e4 (the
port's centring and implicit standardization)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import optax.tree_utils as otu
import pytest
import torch

from transmogrifai_tpu.models import linear as jl
from transmogrifai_tpu.models import solvers as js
from transmogrifai_tpu.parallel import cv as jcv
from transmogrifai_tpu_torch.models import linear as tl
from transmogrifai_tpu_torch.models import solvers as ts
from transmogrifai_tpu_torch.models.convert import (logistic_from_numpy,
                                                    svc_from_numpy)
from transmogrifai_tpu_torch.parallel import cv as tcv

GRID = np.array([[0.001, 0.1], [0.1, 0.5], [0.01, 0.0]])


def _data(n=480, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    X[:, 3] = 5.0                                  # constant: sigma floor
    X[:, 4] += 1e4                                 # large mean: centring
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.7 * rng.logistic(size=n) > 0
         ).astype(float)
    return X, y


def _folds(n, F=3, seed=1):
    assign = np.random.default_rng(seed).permutation(np.arange(n) % F)
    return assign, np.stack([(assign != f).astype(float) for f in range(F)])


# ---------------------------------------------------------------------------
# (a) power iteration and FISTA
# ---------------------------------------------------------------------------

def test_power_iteration_and_lipschitz_match_jax():
    """Implicit standardization (X - mu_b) / sigma_b with fold weights
    against the JAX package on the explicitly standardized matrix:
    relative 1e-12."""
    X = _data(n=200)[0][:, :4]
    _, W = _folds(200, F=2)
    rng = np.random.default_rng(5)
    mu = rng.normal(size=(2, 4))
    sigma = rng.uniform(0.5, 2.0, size=(2, 4))
    Xt = torch.from_numpy(X)
    got = ts._power_iteration_sq_norm(Xt, w=torch.from_numpy(W),
                                      mu=torch.from_numpy(mu),
                                      sigma=torch.from_numpy(sigma))
    l2 = torch.tensor([0.1, 0.2], dtype=Xt.dtype)
    lip = ts.design_lipschitz(Xt, l2, 0.25, w=torch.from_numpy(W),
                              mu=torch.from_numpy(mu),
                              sigma=torch.from_numpy(sigma))
    for b in range(2):
        Xs = jnp.asarray((X - mu[b]) / sigma[b])
        ref = js._power_iteration_sq_norm(Xs, w=jnp.asarray(W[b]))
        np.testing.assert_allclose(float(got[b]), float(ref), rtol=1e-12)
        ref_lip = js.design_lipschitz(Xs, 0.1 * (b + 1), 0.25,
                                      w=jnp.asarray(W[b]))
        np.testing.assert_allclose(float(lip[b]), float(ref_lip), rtol=1e-12)
    plain = ts._power_iteration_sq_norm(Xt)
    np.testing.assert_allclose(
        float(plain[0]), float(js._power_iteration_sq_norm(jnp.asarray(X))),
        rtol=1e-12)


@pytest.fixture(scope="module")
def lasso():
    """An L1-penalized logistic problem on plain X (n = 300, d = 3 +
    intercept) with two candidates of different L1 strength, as a JAX
    loss and as the port's closed-form batched gradient."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 3))
    y = (X[:, 0] + 0.3 * rng.logistic(size=300) > 0).astype(float)
    s = 2.0 * y - 1.0
    Xj, sj = jnp.asarray(X), jnp.asarray(s)
    Xt, st = torch.from_numpy(X), torch.from_numpy(s)[:, None]

    def smooth(p):
        m = Xj @ p[:3] + p[3]
        return (jnp.mean(jnp.logaddexp(0.0, -sj * m))
                + 0.5 * 0.01 * jnp.sum(p[:3] * p[:3]))

    def grad(Z):                                   # (B, 4) -> (B, 4)
        m = Xt @ Z[:, :3].T + Z[:, 3]
        r = -st * torch.sigmoid(-st * m) / 300.0
        return torch.cat([(Xt.T @ r).T + 0.01 * Z[:, :3],
                          r.sum(0)[:, None]], dim=1)

    mask = np.array([1.0, 1.0, 1.0, 0.0])
    lip = float(js.design_lipschitz(Xj, 0.01)) + 0.25
    return smooth, grad, mask, lip, (0.02, 0.05)


def test_fista_fixed_trip_matches_jax(lasso):
    """tol <= 0: exactly max_iter iterations for both rows; within 1e-12
    of the JAX package's fori_loop."""
    smooth, grad, mask, lip, l1s = lasso
    got, iters = ts.fista_minimize(
        grad, torch.tensor(l1s, dtype=torch.float64),
        torch.zeros((2, 4), dtype=torch.float64),
        torch.full((2,), lip, dtype=torch.float64), max_iter=40, tol=0.0,
        l1_mask=torch.from_numpy(mask))
    assert iters.tolist() == [40, 40]
    for b, l1 in enumerate(l1s):
        ref = js.fista_minimize(smooth, l1, jnp.zeros(4), lip, max_iter=40,
                                tol=0.0, l1_mask=jnp.asarray(mask))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-12)


def test_fista_tol_matches_jax_while_loop(lasso):
    """tol > 0: each row is the JAX while_loop's iterate (1e-12) after the
    same number of iterations N: JAX with max_iter = N gives the same
    result, with max_iter = N - 1 a different one. The two rows stop at
    different iterations, so one freezes while the other runs on."""
    smooth, grad, mask, lip, l1s = lasso
    got, iters = ts.fista_minimize(
        grad, torch.tensor(l1s, dtype=torch.float64),
        torch.zeros((2, 4), dtype=torch.float64),
        torch.full((2,), lip, dtype=torch.float64), max_iter=400, tol=1e-7,
        l1_mask=torch.from_numpy(mask))
    counts = iters.tolist()
    assert counts[0] != counts[1] and max(counts) < 400

    def jax_fista(l1, max_iter):
        return np.asarray(js.fista_minimize(
            smooth, l1, jnp.zeros(4), lip, max_iter=max_iter, tol=1e-7,
            l1_mask=jnp.asarray(mask)))

    for b, l1 in enumerate(l1s):
        ref = jax_fista(l1, 400)
        np.testing.assert_allclose(got[b].numpy(), ref, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(jax_fista(l1, counts[b]), ref)
        assert np.abs(jax_fista(l1, counts[b] - 1) - ref).max() > 0


# ---------------------------------------------------------------------------
# (b) L-BFGS against optax
# ---------------------------------------------------------------------------

def _optax_lbfgs(loss, w0, max_iter, tol=1e-6):
    """optax.lbfgs under the JAX package's loop condition, with the
    iteration count (``transmogrifai_tpu.models.solvers.lbfgs_minimize``
    returns the same parameters, checked below, but not the count)."""
    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(loss)

    def step(carry):
        params, state = carry
        value, grad = value_and_grad(params, state=state)
        updates, state = opt.update(grad, state, params, value=value,
                                    grad=grad, value_fn=loss)
        return optax.apply_updates(params, updates), state

    def continuing(carry):
        count = otu.tree_get(carry[1], "count")
        err = otu.tree_norm(otu.tree_get(carry[1], "grad"))
        return (count == 0) | ((count < max_iter) & (err >= tol))

    params, state = jax.lax.while_loop(continuing, step,
                                       (w0, opt.init(w0)))
    return np.asarray(params), int(otu.tree_get(state, "count"))


@pytest.mark.parametrize("objective", ["logistic", "squared_hinge"])
@pytest.mark.parametrize("max_iter", [3, 50])
def test_lbfgs_matches_optax(objective, max_iter):
    """Same iteration count as optax (capped at 3, converged at 50), and
    parameters within 1e-7 (tolerance of the test)."""
    X, y = _data(n=300, seed=4)
    X = X[:, :3]
    n = len(y)
    s = 2.0 * y - 1.0
    Xj, sj = jnp.asarray(X), jnp.asarray(s)
    Xt, st = torch.from_numpy(X), torch.from_numpy(s)

    def jloss(p):
        m = Xj @ p[:3] + p[3]
        data = (jnp.logaddexp(0.0, -sj * m) if objective == "logistic"
                else jnp.maximum(0.0, 1.0 - sj * m) ** 2)
        return jnp.mean(data) + 0.5 * 0.01 * jnp.sum(p[:3] * p[:3])

    def value_and_grad(p):
        m = Xt @ p[:3] + p[3]
        if objective == "logistic":
            data = torch.logaddexp(-st * m, torch.zeros((),
                                                        dtype=m.dtype))
            r = -st * torch.sigmoid(-st * m) / n
        else:
            viol = torch.clamp(1.0 - st * m, min=0.0)
            data, r = viol ** 2, -2.0 * st * viol / n
        value = torch.mean(data) + 0.5 * 0.01 * torch.sum(p[:3] * p[:3])
        return value, torch.cat([Xt.T @ r + 0.01 * p[:3], r.sum()[None]])

    ref, count = _optax_lbfgs(jloss, jnp.zeros(4), max_iter)
    np.testing.assert_array_equal(
        ref, np.asarray(js.lbfgs_minimize(jloss, jnp.zeros(4),
                                          max_iter=max_iter)))
    got, iters = ts.lbfgs_minimize(value_and_grad,
                                   torch.zeros(4, dtype=torch.float64),
                                   max_iter=max_iter)
    assert iters == count and (count == 3) == (max_iter == 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# (c) the fold x grid search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["logistic", "svc"])
@pytest.mark.parametrize("standardize", [True, False])
def test_eval_linear_fold_grid_matches_jax(kind, standardize):
    """(F, G) validation AuPR of every candidate within 1e-9 of the JAX
    package's eval_linear_fold_grid (mesh=None)."""
    X, y = _data()
    assign, masks = _folds(len(y))
    X_val = np.stack([X[assign == f] for f in range(3)])
    y_val = np.stack([y[assign == f] for f in range(3)])
    spec = ("binary", "AuPR")
    ref = jcv.eval_linear_fold_grid(kind, X, y, masks, GRID, X_val, y_val,
                                    spec, mesh=None, standardize=standardize,
                                    max_iter=20)
    got = tcv.eval_linear_fold_grid(kind, X, y, masks, GRID, X_val, y_val,
                                    spec, standardize=standardize,
                                    max_iter=20, device="cpu")
    assert got.shape == (3, 3) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)


def test_eval_fold_grid_entry_points():
    """The estimators' search entry point equals the kernel's, on a grid
    subset; an unknown kind is named."""
    X, y = _data(n=240)
    assign, masks = _folds(len(y))
    X_val = np.stack([X[assign == f] for f in range(3)])
    y_val = np.stack([y[assign == f] for f in range(3)])
    grid = [{"reg_param": r} for r in (0.01, 0.1, 0.2)]
    spec = ("binary", "AuROC")
    est = tl.LinearSVC(max_iter=10, device="cpu")
    got = est.eval_fold_grid_arrays(X, y, masks, grid, X_val, y_val, spec,
                                    cand_idx=[2, 0])
    direct = tcv.eval_linear_fold_grid(
        "svc", X, y, masks, [[0.2, 0.0], [0.01, 0.0]], X_val, y_val, spec,
        max_iter=10, device="cpu")
    np.testing.assert_array_equal(got, direct)
    with pytest.raises(ValueError, match="unknown linear kind 'hinge'"):
        tcv.eval_linear_fold_grid("hinge", X, y, masks, [[0.1, 0.0]],
                                  X_val, y_val, spec, device="cpu")
    with pytest.raises(NotImplementedError, match="elastic_net_param"):
        est.eval_fold_grid_arrays(X, y, masks, [{"elastic_net_param": 0.5}],
                                  X_val, y_val, spec)


# ---------------------------------------------------------------------------
# (d) single fits and models carried across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fit_data():
    return _data(n=400, seed=6)


@pytest.mark.parametrize("family,params,tol", [
    ("LogisticRegression", {"reg_param": 0.01, "elastic_net_param": 0.5},
     1e-8),                                        # FISTA, tol 1e-7
    ("LogisticRegression", {"reg_param": 0.01}, 1e-7),        # L-BFGS
    ("LinearSVC", {"reg_param": 0.01}, 1e-7),                 # L-BFGS
])
def test_single_fit_matches_jax(fit_data, family, params, tol):
    """Coefficients and intercept within 1e-8 (FISTA) or 1e-7 (L-BFGS) of
    the JAX package's fit_arrays; the port's model predicts what the JAX
    model predicts, and so does the JAX model carried across."""
    X, y = fit_data
    ref = getattr(jl, family)(max_iter=50, **params).fit_arrays(X, y)
    got = getattr(tl, family)(max_iter=50, device="cpu",
                              **params).fit_arrays(X, y)
    np.testing.assert_allclose(got.coefficients.numpy(), ref.coefficients,
                               rtol=0, atol=tol)
    # the intercept carries the 1e4-mean column's coefficient times 1e4
    assert abs(got.intercept - float(ref.intercept)) <= tol * 1e4
    convert = (logistic_from_numpy if family == "LogisticRegression"
               else svc_from_numpy)
    carried = convert(ref.coefficients, ref.intercept, device="cpu")
    a, b = ref.predict_arrays(X), carried.predict_arrays(X)
    np.testing.assert_array_equal(b.data, np.asarray(a.data))
    np.testing.assert_allclose(b.raw_prediction, np.asarray(a.raw_prediction),
                               rtol=1e-12, atol=1e-9)
    assert b.probability.shape == np.asarray(a.probability).shape
    np.testing.assert_allclose(b.probability, np.asarray(a.probability),
                               rtol=0, atol=1e-12)
    mine = got.predict_arrays(X)
    assert np.mean(mine.data == np.asarray(a.data)) == 1.0


def test_fista_single_fit_iterate_count(fit_data, monkeypatch):
    """The L1 refit's FISTA stops at the iteration the JAX package's
    while_loop stops at: its core with FISTA capped at the port's count N
    gives the uncapped coefficients, capped at N - 1 other ones."""
    X, y = fit_data
    counts = []
    real = ts.fista_minimize

    def counting(*args, **kwargs):
        w, iters = real(*args, **kwargs)
        counts.append(int(iters[0]))
        return w, iters
    monkeypatch.setattr(tl, "fista_minimize", counting)
    tl.LogisticRegression(reg_param=0.01, elastic_net_param=0.5,
                          max_iter=50, device="cpu").fit_arrays(X, y)
    assert len(counts) == 1 and counts[0] < 250
    jax_fista = js.fista_minimize

    def jax_core(cap):
        def capped(*args, **kwargs):
            return jax_fista(*args, **dict(kwargs, max_iter=cap))
        monkeypatch.setattr(jl, "fista_minimize", capped)
        coef, _ = jl.binary_logistic_core(
            jnp.asarray(X), jnp.asarray(y), jnp.ones(len(y)), 0.01, 0.5,
            fit_intercept=True, standardize=True, max_iter=50, use_l1=True)
        return np.asarray(coef)

    full = jax_core(250)
    np.testing.assert_array_equal(jax_core(counts[0]), full)
    assert np.abs(jax_core(counts[0] - 1) - full).max() > 0


def test_multinomial_and_fold_grid_models_are_named():
    """Three classes fit the multinomial model ((3, d) coefficients, its
    parity is in test_torch_multiclass.py); the fold x grid path that
    returns models is binary-only, as in the JAX package, and names that
    for three classes (its binary parity is in
    test_torch_fold_grid_fit.py)."""
    X, y = _data(n=60)
    y3 = np.arange(60) % 3.0
    model = tl.LogisticRegression(device="cpu").fit_arrays(X, y3)
    assert tuple(model.coefficients.shape) == (3, X.shape[1])
    assert model.predict_arrays(X).probability.shape == (60, 3)
    with pytest.raises(NotImplementedError, match="binary-only"):
        tl.LinearSVC(device="cpu").fit_fold_grid_arrays(
            X, y3, np.ones((1, 60)), [{}])
