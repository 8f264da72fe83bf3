"""The multilayer perceptron, run by the JAX package and by the PyTorch
port (float64, CPU) on the same numpy inputs, the port's draws replaying
the JAX package's keys (``JaxMLPDraws``): the forward pass within 1e-12,
the batched mini-batch Adam fold fits within 1e-8, the sequential L-BFGS
fit with the JAX package's iteration count and within 1e-6, the fold x
grid models and the search's metric matrix; then the model saves,
reloads and scores through a compiled plan in a workflow."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import optax.tree_utils as otu
import pytest
import torch

from transmogrifai_tpu.models import mlp as jm
from transmogrifai_tpu_torch.models import mlp as tm

CPU = torch.device("cpu")


class JaxMLPDraws:
    """The JAX package's MLP draws: the sequential fit's initial weights
    from ``PRNGKey(seed)``, the fold fits' from the second half of its
    split and their permutation from the first."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def init(self, sizes, fold):
        key = jax.random.split(self.key)[1] if fold else self.key
        return [np.asarray(W) for W, _ in jm._init_params(
            key, tuple(sizes), jnp.float64)]

    def permutation(self, n):
        return np.array(jax.random.permutation(
            jax.random.split(self.key)[0], n))


def _data(n=640, d=5, k=3, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    z = X[:, 0] - X[:, 1] + 0.5 * rng.normal(size=n)
    y = np.digitize(z, np.quantile(z, np.linspace(0, 1, k + 1)[1:-1]))
    return X, y.astype(float)


def _masks(n, F=3):
    masks = np.ones((F, n))
    for f in range(F):
        masks[f, f::F] = 0.0
    return masks


def _onehot(y, k):
    return torch.eye(k, dtype=torch.float64)[torch.as_tensor(y).long()]


def test_forward_matches_jax():
    X, _ = _data(n=50)
    sizes = (5, 7, 4, 3)
    weights = JaxMLPDraws(3).init(sizes, False)
    jparams = [(jnp.asarray(W), jnp.linspace(-0.5, 0.5, W.shape[1]))
               for W in weights]
    tparams = []
    for W, b in jparams:
        tparams += [torch.tensor(np.asarray(W)), torch.tensor(np.asarray(b))]
    ref = np.asarray(jm._forward(jparams, jnp.asarray(X)))
    got = tm._forward(tparams, torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("hidden", [(6,), (6, 4)])
def test_batched_adam_fit_matches_jax(hidden):
    """The fold fits (3 lanes, 640 rows: the 512-row window slides) at
    max_iter 4, i.e. 24 Adam steps, from the same initial weights and
    permutation: every layer within 1e-8."""
    X, y = _data()
    masks = _masks(len(y))
    sizes = (X.shape[1],) + hidden + (3,)
    ref = jm._fit_mlp_folds(jnp.asarray(X), jnp.asarray(y),
                            jnp.asarray(masks), jax.random.PRNGKey(11),
                            sizes=sizes, max_iter=4)
    draws = JaxMLPDraws(11)
    got = tm._mlp_batched_fit(
        torch.as_tensor(X), _onehot(y, 3), torch.as_tensor(masks),
        torch.as_tensor(draws.permutation(len(y))), draws.init(sizes, True),
        4)
    flat = [np.asarray(a) for W, b in ref for a in (W, b)]
    assert len(flat) == len(got)
    for r, g in zip(flat, got):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-8)


def _optax_lbfgs(loss, w0, max_iter, tol):
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

    params, state = jax.lax.while_loop(continuing, step, (w0, opt.init(w0)))
    return params, int(otu.tree_get(state, "count"))


def test_lbfgs_fit_matches_jax():
    """The sequential fit at max_iter 40: optax's L-BFGS over the JAX
    package's pytree stops at the same iteration as the port's over the
    flattened parameters, the weights within 1e-6; the estimator's
    ``fit_arrays`` gives the JAX estimator's probabilities within 1e-6."""
    X, y = _data(n=300)
    sizes = (5, 6, 3)
    Xj = jnp.asarray(X)
    onehot = jax.nn.one_hot(jnp.asarray(y).astype(jnp.int32), 3,
                            dtype=jnp.float64)

    def loss(params):
        logits = jm._forward(params, Xj)
        return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits),
                                 axis=1))
    params0 = jm._init_params(jax.random.PRNGKey(5), sizes, jnp.float64)
    ref, count = _optax_lbfgs(loss, params0, 40, 1e-6)
    got, iterations = tm._fit_mlp(
        torch.as_tensor(X), _onehot(y, 3),
        JaxMLPDraws(5).init(sizes, False), max_iter=40, tol=1e-6)
    assert iterations == count
    for r, g in zip([a for W, b in ref for a in (W, b)], got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)
    jest = jm.MultilayerPerceptronClassifier(hidden_layers=(6,),
                                             max_iter=40, seed=5)
    test = tm.MultilayerPerceptronClassifier(hidden_layers=(6,),
                                             max_iter=40, seed=5,
                                             device="cpu",
                                             draws=JaxMLPDraws)
    np.testing.assert_allclose(
        test.fit_arrays(X, y).predict_arrays(X).probability,
        jest.fit_arrays(X, y).predict_arrays(X).probability,
        rtol=0, atol=1e-6)


GRID = [{"hidden_layers": (4,)}, {"hidden_layers": (4,), "tol": 1e-3},
        {"hidden_layers": (5, 3)}]


@pytest.fixture(scope="module")
def searches():
    X, y = _data(n=639)
    masks = _masks(len(y))
    Xv = np.stack([X[masks[f] == 0] for f in range(3)])
    yv = np.stack([y[masks[f] == 0] for f in range(3)])
    jest = jm.MultilayerPerceptronClassifier(max_iter=3, seed=9)
    test = tm.MultilayerPerceptronClassifier(max_iter=3, seed=9,
                                             device="cpu",
                                             draws=JaxMLPDraws)
    out = {"fit": (jest.fit_fold_grid_arrays(X, y, masks, GRID, mesh=None),
                   test.fit_fold_grid_arrays(X, y, masks, GRID))}
    spec = ("multiclass", "F1")
    out["multiclass"] = (
        jest.eval_fold_grid_arrays(X, y, masks, GRID, Xv, yv, spec,
                                   mesh=None),
        test.eval_fold_grid_arrays(X, y, masks, GRID, Xv, yv, spec))
    yb, yvb = (y > 0).astype(float), (yv > 0).astype(float)
    spec = ("binary", "AuPR")
    out["binary"] = (
        jest.eval_fold_grid_arrays(X, yb, masks, GRID, Xv, yvb, spec,
                                   mesh=None),
        test.eval_fold_grid_arrays(X, yb, masks, GRID, Xv, yvb, spec))
    return out


def test_fold_grid_models_match_jax(searches):
    """(F, G) models: the weights within 1e-8; grid points that differ in
    ``tol`` alone share one fit (the same model object)."""
    ref, got = searches["fit"]
    for rrow, grow in zip(ref, got):
        assert grow[0] is grow[1] and grow[0] is not grow[2]
        for r, g in zip(rrow, grow):
            for a, b in zip(r.weights + r.biases, g.weights + g.biases):
                np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-8)


@pytest.mark.parametrize("kind", ["multiclass", "binary"])
def test_eval_matrix_matches_jax(searches, kind):
    ref, got = searches[kind]
    assert got.shape == (3, len(GRID))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got[:, 0], got[:, 1])


def test_mlp_workflow_saves_reloads_and_compiles():
    """The Iris example with the opt-in MLP grid on the CPU: the search
    and refit run, the model saves and reloads, the reload scores as the
    trained model, and the compiled plan covers the MLP stage (no host
    fallback) within 1e-6 of the columnar path."""
    from transmogrifai_tpu_torch.examples import iris
    from transmogrifai_tpu_torch.local import load_score_function
    from transmogrifai_tpu_torch.models.registry import (
        default_multiclass_extra_models)
    from transmogrifai_tpu_torch.workflow.persistence import save_model
    models = [(est.with_params(max_iter=5), grid)
              for est, grid in default_multiclass_extra_models("cpu")
              if type(est).__name__ == "MultilayerPerceptronClassifier"]
    assert [g for _, g in models] == [[{"hidden_layers": (10,)},
                                       {"hidden_layers": (32, 16)}]]
    run = iris.run(iris.synthetic_iris(240, seed=3), device="cpu",
                   models=models)
    assert run.model.result_features[0].origin_stage.summary \
        .best_model_name == "MultilayerPerceptronClassifier"
    holdout = run.holdout
    name = run.prediction.name
    columnar = run.model.score(holdout)[name].probability
    compiled = run.model.score(holdout, engine="compiled")[name].probability
    np.testing.assert_allclose(compiled, columnar, rtol=0, atol=1e-6)
    coverage = run.model.scoring_plan().describe()["coverage"]
    assert "SelectedModel" in str(coverage["lowered"]), coverage
    assert not coverage["fallback"], coverage
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model")
        save_model(run.model, path)
        score = load_score_function(path, device="cpu")
        rows = score.score_batch(holdout[:5], engine="records")
    probs = np.array([[r[name][f"probability_{c}"] for c in range(3)]
                      for r in rows])
    np.testing.assert_allclose(probs, columnar[:5], rtol=0, atol=1e-12)
