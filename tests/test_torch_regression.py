"""The regression problem type of the PyTorch port against the JAX package,
in float64 on the CPU: the regression metrics (host and device), the
DataSplitter, LinearRegression (normal equations and FISTA, single fits
and the fold x grid search), the GLM's IRLS (single fits and the batched
search, masked rows kept out of the log link), the regression forests and
the GBT regressor under replayed draws, racing over a regression pool,
the models carried across, and the output guard on regression values.
Inputs are made with numpy from seeds."""
import numpy as np
import pytest
import torch

from test_torch_forest import JaxDraws, _heaps_equal
from transmogrifai_tpu.evaluators import RegressionEvaluator as JaxEvaluator
from transmogrifai_tpu.evaluators import device_metrics as jdm
from transmogrifai_tpu.evaluators import regression as jrm
from transmogrifai_tpu.models import glm as jg
from transmogrifai_tpu.models import linear as jl
from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu.parallel import cv as jcv
from transmogrifai_tpu.selector import splitters as jsp
from transmogrifai_tpu.selector.racing import (
    RacingCrossValidation as JaxRacing)
from transmogrifai_tpu_torch.evaluators import RegressionEvaluator
from transmogrifai_tpu_torch.evaluators import device_metrics as tdm
from transmogrifai_tpu_torch.evaluators import regression as trm
from transmogrifai_tpu_torch.models import glm as tg
from transmogrifai_tpu_torch.models import linear as tl
from transmogrifai_tpu_torch.models import trees as tt
from transmogrifai_tpu_torch.models.convert import from_jax_model
from transmogrifai_tpu_torch.parallel import cv as tcv
from transmogrifai_tpu_torch.selector import RacingCrossValidation
from transmogrifai_tpu_torch.selector import splitters as tsp


def _data(n=300, d=6, seed=0):
    """Positive labels (the poisson GLM takes them) with a nonlinear
    term; a constant column and one with a large mean."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    X[:, 3] = 2.0
    X[:, 4] = X[:, 4] * 10.0 + 300.0
    y = np.clip(20.0 + 3.0 * X[:, 0] - 2.0 * X[:, 1] + X[:, 2] ** 2
                + 0.05 * (X[:, 4] - 300.0) + rng.normal(size=n), 1.0, None)
    return X, y


def _folds(n, F=3, seed=1):
    assign = np.random.default_rng(seed).permutation(np.arange(n) % F)
    masks = np.stack([(assign != f).astype(float) for f in range(F)])
    Xv_idx = [np.nonzero(assign == f)[0] for f in range(F)]
    return masks, Xv_idx


def _fold_arrays(X, y, idx):
    return np.stack([X[i] for i in idx]), np.stack([y[i] for i in idx])


SPEC = ("regression", "RootMeanSquaredError")


# ---------------------------------------------------------------------------
# metrics and the DataSplitter
# ---------------------------------------------------------------------------

def test_regression_host_metrics_match_jax():
    y, pred = _data(200)[1], _data(200, seed=5)[1]
    assert trm.regression_metrics(y, pred) == \
        trm.RegressionMetrics(**jrm.regression_metrics(y, pred).to_json())
    assert trm.regression_metrics(y[:0], pred[:0]) == trm.RegressionMetrics()


@pytest.mark.parametrize("metric", tdm.REGRESSION_METRICS)
def test_regression_device_metric_matches_host(metric):
    y, pred = _data(200)[1], _data(200, seed=5)[1]
    host = getattr(trm.regression_metrics(y, pred), metric)
    got = float(tdm.regression_metric(torch.from_numpy(y),
                                      torch.from_numpy(pred), metric))
    import jax.numpy as jnp
    ref = float(jdm.regression_metric(jnp.asarray(y), jnp.asarray(pred),
                                      metric))
    assert abs(got - host) <= 1e-12 and abs(got - ref) <= 1e-12


def test_regression_evaluator_is_smaller_better():
    assert not RegressionEvaluator().is_larger_better
    assert RegressionEvaluator(default_metric="R2").is_larger_better
    assert RegressionEvaluator().device_metric_spec() == SPEC


@pytest.mark.parametrize("frac", [0.0, 0.2, 0.35])
def test_data_splitter_matches_jax(frac):
    y = _data(301)[1]
    ref = jsp.DataSplitter(reserve_test_fraction=frac, seed=3)
    got = tsp.DataSplitter(reserve_test_fraction=frac, seed=3)
    for a, b in zip(ref.split(y), got.split(y)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ref.prepare(y), got.prepare(y))


# ---------------------------------------------------------------------------
# LinearRegression and the GLM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reg,en,std", [(0.001, 0.0, True), (0.1, 0.0, True),
                                        (0.1, 0.5, True), (0.01, 0.1, False),
                                        (0.1, 0.0, False)])
def test_linear_regression_matches_jax(reg, en, std):
    """Normal equations without an L1 term, FISTA to a step below 1e-7
    with one: coefficients and intercept within 1e-9."""
    X, y = _data()
    ref = jl.LinearRegression(reg_param=reg, elastic_net_param=en,
                              standardization=std).fit_arrays(X, y)
    got = tl.LinearRegression(reg_param=reg, elastic_net_param=en,
                              standardization=std,
                              device="cpu").fit_arrays(X, y)
    np.testing.assert_allclose(got.coefficients.numpy(), ref.coefficients,
                               rtol=0, atol=1e-9)
    assert abs(got.intercept - ref.intercept) <= 1e-9
    np.testing.assert_allclose(got.predict_arrays(X).data,
                               ref.predict_arrays(X).data, rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("grid", [[[0.001, 0.1], [0.1, 0.5], [0.2, 0.1]],
                                  [[0.001, 0.0], [0.1, 0.0]]])
def test_linear_regression_search_matches_jax(grid):
    """The "squared" kind of the batched search: FISTA at a fixed trip
    count when the grid has an L1 term, the normal equations when not;
    the (F, G) RMSE matrix within 1e-9."""
    X, y = _data()
    masks, idx = _folds(len(y))
    Xv, yv = _fold_arrays(X, y, idx)
    ref = jcv.eval_linear_fold_grid("squared", X, y, masks, np.array(grid),
                                    Xv, yv, SPEC, mesh=None, max_iter=20)
    got = tcv.eval_linear_fold_grid("squared", X, y, masks, grid, Xv, yv,
                                    SPEC, max_iter=20, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    est = tl.LinearRegression(max_iter=20, device="cpu")
    sub = est.eval_fold_grid_arrays(
        X, y, masks, [{"reg_param": r, "elastic_net_param": e}
                      for r, e in grid], Xv, yv, SPEC, cand_idx=[1])
    np.testing.assert_allclose(sub[:, 0], ref[:, 1], rtol=0, atol=1e-9)


@pytest.mark.parametrize("family,reg", [("gaussian", 0.001),
                                        ("gaussian", 0.1),
                                        ("poisson", 0.01), ("gamma", 0.01),
                                        ("tweedie", 0.01)])
def test_glm_matches_jax(family, reg):
    X, y = _data()
    ref = jg.GeneralizedLinearRegression(family=family,
                                         reg_param=reg).fit_arrays(X, y)
    got = tg.GeneralizedLinearRegression(
        family=family, reg_param=reg, device="cpu").fit_arrays(X, y)
    np.testing.assert_allclose(got.coefficients.numpy(), ref.coefficients,
                               rtol=0, atol=1e-9)
    assert abs(got.intercept - ref.intercept) <= 1e-9
    np.testing.assert_allclose(got.predict_arrays(X).data,
                               ref.predict_arrays(X).data, rtol=1e-10,
                               atol=0)


def test_glm_search_matches_jax():
    """The default grid (gaussian and poisson at three reg_params): the
    fold x grid RMSE matrix within 1e-9 relative."""
    X, y = _data()
    masks, idx = _folds(len(y))
    Xv, yv = _fold_arrays(X, y, idx)
    grid = [{"family": f, "reg_param": r} for f in ("gaussian", "poisson")
            for r in (0.001, 0.01, 0.1)]
    ref = jg.GeneralizedLinearRegression().eval_fold_grid_arrays(
        X, y, masks, grid, Xv, yv, SPEC)
    got = tg.GeneralizedLinearRegression(device="cpu").eval_fold_grid_arrays(
        X, y, masks, grid, Xv, yv, SPEC)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)


def test_glm_masked_rows_do_not_poison_log_link():
    """A held-out row whose feature overflows exp under the log link
    (x = 400) leaves the masked poisson lane finite, equal to the JAX
    package's lane and to a fit without the row."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(120, 3))
    X[0, 0] = 400.0
    y = np.maximum(np.exp(np.clip(0.3 * X[:, 0], -5, 5))
                   + 0.05 * rng.normal(size=120), 0.01)
    masks = np.ones((1, 120))
    masks[0, 0] = 0.0
    grid = [{"family": "poisson", "reg_param": 0.01}]
    Xv, yv = X[None, 1:61], y[None, 1:61]
    ref = jg.GeneralizedLinearRegression().eval_fold_grid_arrays(
        X, y, masks, grid, Xv, yv, SPEC)
    got = tg.GeneralizedLinearRegression(device="cpu").eval_fold_grid_arrays(
        X, y, masks, grid, Xv, yv, SPEC)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)
    seq = tg.GeneralizedLinearRegression(family="poisson", reg_param=0.01,
                                         device="cpu").fit_arrays(X[1:], y[1:])
    rmse = np.sqrt(np.mean((seq.predict_arrays(Xv[0]).data - yv[0]) ** 2))
    assert abs(rmse - got[0, 0]) <= 1e-9 * rmse


# ---------------------------------------------------------------------------
# regression forests and the GBT regressor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(7)
    X = np.concatenate([rng.normal(size=(399, 8)),
                        (rng.uniform(size=(399, 4)) < 0.3).astype(float)], 1)
    y = 3.0 * X[:, 0] + X[:, 1] ** 2 - 2.0 * X[:, -1] + rng.normal(size=399)
    return X, y


def test_forest_regressor_matches_jax(wide):
    """Bagged variance trees under replayed draws (a third of the features
    a node, a per-tree pool): equal split heaps, leaf means within
    1e-12."""
    X, y = wide
    kw = dict(num_trees=3, max_depth=4, min_instances_per_node=3, seed=5)
    ref = jt.RandomForestRegressor(**kw).fit_arrays(X, y)
    got = tt.RandomForestRegressor(**kw, device="cpu",
                                   draws=JaxDraws).fit_arrays(X, y)
    _heaps_equal(ref, got)
    np.testing.assert_allclose(got.predict_arrays(X).data,
                               ref.predict_arrays(X).data, rtol=0,
                               atol=1e-12)


def test_decision_tree_regressor_matches_jax(wide):
    X, y = wide
    ref = jt.DecisionTreeRegressor(max_depth=5,
                                   min_info_gain=0.01).fit_arrays(X, y)
    got = tt.DecisionTreeRegressor(max_depth=5, min_info_gain=0.01,
                                   device="cpu").fit_arrays(X, y)
    _heaps_equal(ref, got)


@pytest.mark.parametrize("cls", ["GBTRegressor", "XGBoostRegressor"])
def test_gbt_regressor_matches_jax(wide, cls):
    """The squared objective's trees equal, leaves and base within
    1e-12; the XGBoost facade takes eta and num_round."""
    X, y = wide
    kw = (dict(num_rounds=4, max_depth=4, step_size=0.3)
          if cls == "GBTRegressor"
          else dict(num_round=4, max_depth=4, eta=0.3, max_bins=32))
    ref = getattr(jt, cls)(**kw).fit_arrays(X, y)
    got = getattr(tt, cls)(**kw, device="cpu").fit_arrays(X, y)
    _heaps_equal(ref, got)
    assert abs(got.base - ref.base) <= 1e-12
    np.testing.assert_allclose(got.predict_arrays(X).data,
                               ref.predict_arrays(X).data, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("family", ["RandomForestRegressor", "GBTRegressor"])
def test_tree_regressor_search_matches_jax(wide, family):
    """The tree regressors' fold x grid searches: RMSE within 1e-12."""
    X, y = wide
    masks, idx = _folds(len(y))
    Xv, yv = _fold_arrays(X, y, idx)
    if family == "RandomForestRegressor":
        grid = [{"max_depth": d, "min_instances_per_node": m}
                for d in (3, 4) for m in (5, 40)]
        ref_est = jt.RandomForestRegressor(num_trees=3)
        est = tt.RandomForestRegressor(num_trees=3, device="cpu",
                                       draws=JaxDraws)
    else:
        grid = [{"max_depth": d, "min_child_weight": m, "gamma": 0.01}
                for d in (3, 4) for m in (1.0, 10.0)]
        ref_est = jt.GBTRegressor(num_rounds=4)
        est = tt.GBTRegressor(num_rounds=4, device="cpu")
    ref = ref_est.eval_fold_grid_arrays(X, y, masks, grid, Xv, yv, SPEC)
    got = est.eval_fold_grid_arrays(X, y, masks, grid, Xv, yv, SPEC)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# racing over a regression pool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raced():
    """The default eta 3 from 1/9 over LinearRegression (4 points),
    GBTRegressor (3 rounds, depths 2-4) and the GLM (4 points): RMSE,
    smaller better."""
    X, y = _data(n=600, seed=3)
    lr = [{"reg_param": r, "elastic_net_param": e}
          for r in (0.001, 0.1) for e in (0.1, 0.5)]
    gbt = [{"max_depth": d} for d in (2, 3, 4)]
    glm = [{"family": f, "reg_param": r} for f in ("gaussian", "poisson")
           for r in (0.001, 0.1)]
    jax_pool = [(jl.LinearRegression(max_iter=20), lr),
                (jt.GBTRegressor(num_rounds=3), gbt),
                (jg.GeneralizedLinearRegression(), glm)]
    port_pool = [(tl.LinearRegression(max_iter=20, device="cpu"), lr),
                 (tt.GBTRegressor(num_rounds=3, device="cpu"), gbt),
                 (tg.GeneralizedLinearRegression(device="cpu"), glm)]
    ref_v = JaxRacing(JaxEvaluator(), num_folds=3, eta=3, min_fidelity=1 / 9,
                      mesh=None)
    got_v = RacingCrossValidation(RegressionEvaluator(), num_folds=3, eta=3,
                                  min_fidelity=1 / 9)
    return (ref_v.validate(jax_pool, X, y), got_v.validate(port_pool, X, y),
            ref_v, got_v)


def test_regression_racing_matches_jax(raced):
    """The same rung decisions (pruned-at rung, rung and budget of every
    candidate; the rung reports), the finalists' RMSE within 1e-9 and the
    same winner: the smallest RMSE."""
    ref, got, ref_v, got_v = raced

    def trajectory(results):
        return [(r.model_name, r.grid_index, r.rung, r.pruned_at,
                 r.budget_spent, len(r.metric_values)) for r in results]
    assert trajectory(got.results) == trajectory(ref.results)
    drop = {"searchSeconds"}
    assert ({k: v for k, v in got_v.last_report.items() if k not in drop}
            == {k: v for k, v in ref_v.last_report.items() if k not in drop})
    finalists = [(a, b) for a, b in zip(ref.results, got.results)
                 if a.pruned_at is None]
    assert finalists
    for a, b in finalists:
        np.testing.assert_allclose(b.metric_values, a.metric_values,
                                   rtol=1e-9, atol=0)
    assert (got.name, got.params) == (ref.name, ref.params)
    assert got.metric == min(b.mean_metric for _, b in finalists)


# ---------------------------------------------------------------------------
# models carried across; the output guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["LinearRegressionModel",
                                    "GeneralizedLinearRegressionModel",
                                    "TreeEnsembleRegressorModel",
                                    "GBTRegressorModel"])
def test_regression_models_carry_across(wide, family):
    X, y = wide
    y = y - y.min() + 1.0
    est = {"LinearRegressionModel": jl.LinearRegression(),
           "GeneralizedLinearRegressionModel":
               jg.GeneralizedLinearRegression(family="poisson"),
           "TreeEnsembleRegressorModel": jt.DecisionTreeRegressor(
               max_depth=3),
           "GBTRegressorModel": jt.GBTRegressor(num_rounds=2,
                                                max_depth=2)}[family]
    ref = est.fit_arrays(X, y)
    got = from_jax_model(ref, device="cpu")
    assert type(got).__name__ == family
    np.testing.assert_allclose(got.predict_arrays(X).data,
                               ref.predict_arrays(X).data, rtol=1e-12,
                               atol=1e-12)


def test_output_guard_checks_regression_values_for_nan_only():
    """A regression prediction has no probability: the guard flags its
    NaN/Inf rows and nothing else, as the JAX package's guard does."""
    from transmogrifai_tpu_torch.features.columns import (Dataset,
                                                          PredictionColumn)
    from transmogrifai_tpu_torch.serving.guard import OutputGuard
    col = PredictionColumn.from_arrays(np.array([25.0, np.nan, -3.0,
                                                 np.inf, 1e6]))
    ds = Dataset({"p": col})
    out, reasons = OutputGuard().check(ds, ["p"])
    assert sorted(r.row for r in reasons) == [1, 3]
    assert all(r.code == "output_non_finite" for r in reasons)
    assert out["p"].data[0] == 25.0 and out["p"].data[4] == 1e6
