"""The fold x grid fits that return models (``fit_fold_grid_arrays``) of
every family, the batched tree scoring (``batch_predict_raw``) and
``TX_TREE_EDGES=fold``, run by the JAX package and by the PyTorch port
(float64, CPU) on the same numpy inputs: linear parameters within 1e-9
(the eval path's metric tolerance), naive Bayes and the GLM within
1e-10, trees exact (the forests' draws replayed with JaxDraws)."""
import numpy as np
import pytest
import torch

from test_torch_forest import JaxDraws
from transmogrifai_tpu.models import bayes as jb
from transmogrifai_tpu.models import glm as jg
from transmogrifai_tpu.models import linear as jl
from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu_torch.models import bayes as tb
from transmogrifai_tpu_torch.models import glm as tg
from transmogrifai_tpu_torch.models import linear as tl
from transmogrifai_tpu_torch.models import trees as tt
from transmogrifai_tpu_torch.models.base import FamilyPreconditionError

CPU = "cpu"


def _data(n=240, d=6, seed=4, k=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    X[:, -1] = rng.integers(0, 3, size=n)
    z = X[:, 0] - 0.8 * X[:, 2] + 0.5 * rng.logistic(size=n)
    if k == 2:
        y = (z > 0).astype(float)
    else:
        y = np.digitize(z, np.quantile(z, np.linspace(0, 1, k + 1)[1:-1]))
        y = y.astype(float)
    return X, y


def _masks(n, F=3):
    masks = np.ones((F, n))
    for f in range(F):
        masks[f, f::F] = 0.0
    return masks


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------------------
# linear, naive Bayes, GLM
# ---------------------------------------------------------------------------

LINEAR = {
    "logistic": (jl.LogisticRegression, tl.LogisticRegression,
                 [{"reg_param": r, "elastic_net_param": e}
                  for r in (0.01, 0.1) for e in (0.0, 0.5)]),
    "squared": (jl.LinearRegression, tl.LinearRegression,
                [{"reg_param": r, "elastic_net_param": e}
                 for r in (0.01, 0.1) for e in (0.0, 0.5)]),
    "svc": (jl.LinearSVC, tl.LinearSVC,
            [{"reg_param": r} for r in (0.01, 0.1)]),
}


@pytest.mark.parametrize("kind", sorted(LINEAR))
def test_linear_fold_grid_fits_match_jax(kind):
    """(F, G) models of the fixed-trip FISTA search: coefficients and
    intercepts within 1e-9, the models' predictions too."""
    jcls, tcls, grid = LINEAR[kind]
    X, y = _data()
    if kind == "squared":
        y = X[:, 1] * 2.0 + y
    masks = _masks(len(y))
    ref = jcls(max_iter=30).fit_fold_grid_arrays(X, y, masks, grid,
                                                 mesh=None)
    got = tcls(max_iter=30, device=CPU).fit_fold_grid_arrays(X, y, masks,
                                                            grid)
    assert len(got) == 3 and all(len(row) == len(grid) for row in got)
    for rrow, grow in zip(ref, got):
        for r, g in zip(rrow, grow):
            assert type(g).__name__ == type(r).__name__
            np.testing.assert_allclose(_np(g.coefficients),
                                       np.asarray(r.coefficients),
                                       rtol=0, atol=1e-9)
            assert abs(float(g.intercept) - float(r.intercept)) <= 1e-9
    r, g = ref[1][-1], got[1][-1]
    if kind == "squared":
        np.testing.assert_allclose(g.predict_arrays(X).data,
                                   r.predict_arrays(X).data,
                                   rtol=0, atol=1e-9)
    else:
        np.testing.assert_allclose(g.predict_arrays(X).raw_prediction,
                                   r.predict_arrays(X).raw_prediction,
                                   rtol=0, atol=1e-9)


def test_bayes_and_glm_fold_grid_fits_match_jax():
    """Naive Bayes (both model types, two smoothings, three classes) and
    the GLM (gaussian and poisson) within 1e-10; a negative feature
    raises FamilyPreconditionError, as in the JAX package."""
    X, y = _data(k=3)
    Xp = np.abs(X)
    masks = _masks(len(y))
    grid = [{"smoothing": s, "model_type": t}
            for t in ("multinomial", "bernoulli") for s in (0.5, 1.0)]
    ref = jb.NaiveBayes().fit_fold_grid_arrays(Xp, y, masks, grid,
                                               mesh=None)
    got = tb.NaiveBayes(device=CPU).fit_fold_grid_arrays(Xp, y, masks, grid)
    for rrow, grow in zip(ref, got):
        for r, g in zip(rrow, grow):
            assert g.model_type == r.model_type
            np.testing.assert_allclose(_np(g.pi), r.pi, rtol=0, atol=1e-10)
            np.testing.assert_allclose(_np(g.theta), r.theta, rtol=0,
                                       atol=1e-10)
    with pytest.raises(FamilyPreconditionError):
        tb.NaiveBayes(device=CPU).fit_fold_grid_arrays(X, y, masks, grid)
    yr = np.exp(0.3 * X[:, 0] - 0.2 * X[:, 1]) + 0.1
    grid = [{"family": f, "reg_param": r}
            for f in ("gaussian", "poisson") for r in (0.001, 0.1)]
    ref = jg.GeneralizedLinearRegression().fit_fold_grid_arrays(
        X, yr, masks, grid, mesh=None)
    got = tg.GeneralizedLinearRegression(device=CPU).fit_fold_grid_arrays(
        X, yr, masks, grid)
    for rrow, grow in zip(ref, got):
        for r, g in zip(rrow, grow):
            assert g.link == r.link
            np.testing.assert_allclose(_np(g.coefficients), r.coefficients,
                                       rtol=0, atol=1e-10)
            assert abs(g.intercept - r.intercept) <= 1e-10


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

FOREST_GRID = [{"max_depth": d, "min_instances_per_node": m}
               for d in (2, 3) for m in (1, 10)]
GBT_GRID = [{"max_depth": d, "min_child_weight": m}
            for d in (2, 3) for m in (1.0, 5.0)]

TREES = {
    "rf-cls": (lambda: jt.RandomForestClassifier(num_trees=3),
               lambda: tt.RandomForestClassifier(num_trees=3, device=CPU,
                                                 draws=JaxDraws),
               FOREST_GRID, 2),
    "rf-reg": (lambda: jt.RandomForestRegressor(num_trees=3),
               lambda: tt.RandomForestRegressor(num_trees=3, device=CPU,
                                                draws=JaxDraws),
               FOREST_GRID, 0),
    "dt-cls": (lambda: jt.DecisionTreeClassifier(),
               lambda: tt.DecisionTreeClassifier(device=CPU),
               FOREST_GRID[:2], 3),
    "gbt-cls": (lambda: jt.GBTClassifier(num_rounds=3),
                lambda: tt.GBTClassifier(num_rounds=3, device=CPU),
                GBT_GRID, 2),
    "gbt-reg": (lambda: jt.GBTRegressor(num_rounds=3),
                lambda: tt.GBTRegressor(num_rounds=3, device=CPU),
                GBT_GRID[:2], 0),
    "xgb-softmax": (lambda: jt.XGBoostClassifier(num_round=2, max_bins=32),
                    lambda: tt.XGBoostClassifier(num_round=2, max_bins=32,
                                                 device=CPU),
                    [{"max_depth": 2}, {"max_depth": 3, "eta": 0.1}], 3),
}


def _tree_inputs(k):
    X, y = _data(k=max(k, 2))
    if k == 0:
        y = X[:, 1] + 2.0 * y
    return X, y, _masks(len(y))


def _assert_trees_equal(r, g):
    assert type(g).__name__ == type(r).__name__
    assert g.depth == r.depth
    np.testing.assert_array_equal(g.feats.numpy(), np.asarray(r.feats))
    np.testing.assert_array_equal(g.thrs.numpy(), np.asarray(r.thrs))
    np.testing.assert_allclose(g.leaves.numpy(), np.asarray(r.leaves),
                               rtol=0, atol=1e-12)
    if hasattr(r, "base"):
        np.testing.assert_allclose(_np(g.base), np.asarray(r.base), rtol=0,
                                   atol=1e-12)


@pytest.fixture(scope="module")
def tree_fits():
    out = {}
    for name, (jmk, tmk, grid, k) in TREES.items():
        X, y, masks = _tree_inputs(k)
        out[name] = (jmk().fit_fold_grid_arrays(X, y, masks, grid,
                                                mesh=None),
                     tmk().fit_fold_grid_arrays(X, y, masks, grid), X)
    return out


@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_fold_grid_fits_match_jax(tree_fits, name):
    """Every (fold, grid point) model: the same split features and
    thresholds, leaves within 1e-12 (the boosters' base too)."""
    ref, got, _ = tree_fits[name]
    assert len(got) == len(ref) == 3
    for rrow, grow in zip(ref, got):
        assert len(grow) == len(rrow)
        for r, g in zip(rrow, grow):
            _assert_trees_equal(r, g)


@pytest.mark.parametrize("name", ["rf-cls", "rf-reg", "dt-cls", "gbt-cls",
                                  "gbt-reg"])
def test_batch_predict_raw_equals_each_model(tree_fits, name):
    """One stacked traversal per static shape gives each model's own raw
    prediction bit for bit, and the JAX package's batch within 1e-12;
    the softmax booster's models are not batched, as in the JAX
    package."""
    ref, got, X = tree_fits[name]
    Xv = X[:50]
    models = [m for row in got for m in row]
    raw = tt.batch_predict_raw(models, Xv)
    jraw = jt.batch_predict_raw([m for row in ref for m in row], Xv)
    assert sorted(raw) == sorted(jraw) == list(range(len(models)))
    for i, m in enumerate(models):
        own = (m.predict_raw(Xv) if hasattr(m, "predict_raw")
               else m.predict_values(Xv))
        np.testing.assert_array_equal(raw[i], own)
        np.testing.assert_allclose(raw[i], jraw[i], rtol=0, atol=1e-12)
    softmax = [m for row in tree_fits["xgb-softmax"][1] for m in row]
    assert tt.batch_predict_raw(softmax, Xv) == {}


@pytest.mark.parametrize("name", ["rf-cls", "gbt-reg"])
def test_fold_edges_match_jax(monkeypatch, name):
    """TX_TREE_EDGES=fold: each fold bins with edges from its train rows
    (one design a fold); the fit mode's models equal the JAX package's,
    the eval mode's metric matrix too, and the edges differ from the
    whole matrix's (one depth of the grid: each is a JAX compile)."""
    jmk, tmk, grid, k = TREES[name]
    grid = grid[:2]
    X, y, masks = _tree_inputs(k)
    Xv = np.stack([X[masks[f] == 0][:60] for f in range(3)])
    yv = np.stack([y[masks[f] == 0][:60] for f in range(3)])
    spec = ("regression", "RootMeanSquaredError") if k == 0 else (
        "binary", "AuROC")
    tt.clear_design_cache()
    matrix = tmk().eval_fold_grid_arrays(X, y, masks, grid, Xv, yv, spec)
    monkeypatch.setenv("TX_TREE_EDGES", "fold")
    ref = jmk().fit_fold_grid_arrays(X, y, masks, grid, mesh=None)
    got = tmk().fit_fold_grid_arrays(X, y, masks, grid)
    for rrow, grow in zip(ref, got):
        for r, g in zip(rrow, grow):
            _assert_trees_equal(r, g)
    ref_mm = jmk().eval_fold_grid_arrays(X, y, masks, grid, Xv, yv, spec,
                                         mesh=None)
    got_mm = tmk().eval_fold_grid_arrays(X, y, masks, grid, Xv, yv, spec)
    np.testing.assert_allclose(got_mm, ref_mm, rtol=0, atol=1e-12)
    assert np.abs(got_mm - matrix).max() > 0
    d0 = tt._design_args(X, 32, torch.device(CPU),
                         np.nonzero(masks[0])[0])
    d1 = tt._design_args(X, 32, torch.device(CPU),
                         np.nonzero(masks[1])[0])
    assert not torch.equal(d0.packed_thr, d1.packed_thr)
