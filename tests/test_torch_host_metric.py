"""The validator's host path, under evaluators without a device metric
(the log loss, an AuPR evaluator whose ``metric_from`` a user overrides),
run by the JAX package and by the PyTorch port (float64, CPU) on the same
data over the default binary pool's four families (cut small; the
forests' draws replayed with JaxDraws). Every family's candidates are
fitted by its batched fold x grid fit on the whole matrix under the fold
masks, the tree models of a fold score in one batch, and the evaluator
runs on the host: the metric matrices agree within 1e-9 and the same
grid point wins. Fitted candidate by candidate on each fold's rows (the
only host path the port had before), the matrix differs from the JAX
package's; workflow-level CV takes the batched fits one fold at a
time."""
import numpy as np
import pytest

from test_torch_forest import JaxDraws
from transmogrifai_tpu.evaluators import (
    BinaryClassificationEvaluator as JaxBinaryEvaluator)
from transmogrifai_tpu.evaluators import LogLossEvaluator as JaxLogLoss
from transmogrifai_tpu.models import linear as jl
from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu.selector.factories import (
    BinaryClassificationModelSelector as JaxSelector)
from transmogrifai_tpu_torch.evaluators import (
    BinaryClassificationEvaluator, LogLossEvaluator)
from transmogrifai_tpu_torch.models import linear as tl
from transmogrifai_tpu_torch.models import trees as tt
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, CrossValidation)

LR_GRID = [{"reg_param": r, "elastic_net_param": 0.1}
           for r in (0.001, 0.1)]
RF_GRID = [{"max_depth": 3, "min_instances_per_node": m} for m in (1, 10)]
GBT_GRID = [{"max_depth": 3, "min_child_weight": m} for m in (1.0, 5.0)]
SVC_GRID = [{"reg_param": 0.01}]


class JaxOwnAuPR(JaxBinaryEvaluator):
    """A user's evaluator: AuPR through its own ``metric_from``."""

    def metric_from(self, metrics):
        return float(metrics.AuPR)


class OwnAuPR(BinaryClassificationEvaluator):
    def metric_from(self, metrics):
        return float(metrics.AuPR)


def _data(n=480, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    X[:, 5] = rng.integers(0, 4, size=n)
    y = (X[:, 0] - 0.6 * X[:, 1] + 0.3 * X[:, 5]
         + 0.8 * rng.logistic(size=n) > 0.5).astype(float)
    return X, y


def _jax_models():
    return [(jl.LogisticRegression(max_iter=30), LR_GRID),
            (jt.RandomForestClassifier(num_trees=3), RF_GRID),
            (jt.GBTClassifier(num_rounds=3), GBT_GRID),
            (jl.LinearSVC(max_iter=30), SVC_GRID)]


def _port_models():
    return [(tl.LogisticRegression(max_iter=30, device="cpu"), LR_GRID),
            (tt.RandomForestClassifier(num_trees=3, device="cpu",
                                       draws=JaxDraws), RF_GRID),
            (tt.GBTClassifier(num_rounds=3, device="cpu"), GBT_GRID),
            (tl.LinearSVC(max_iter=30, device="cpu"), SVC_GRID)]


def _matrix(selected):
    return np.array([r.metric_values
                     for r in selected.summary.validation_results]).T


EVALUATORS = {"logloss": (JaxLogLoss, LogLossEvaluator),
              "own-aupr": (JaxOwnAuPR, OwnAuPR)}


@pytest.fixture(scope="module")
def searches():
    X, y = _data()
    out = {}
    for name, (jev, tev) in EVALUATORS.items():
        assert tev().device_metric_spec() is None
        ref = JaxSelector.with_cross_validation(
            num_folds=3, seed=5, evaluator=jev(), models=_jax_models(),
            mesh=None).fit_arrays(X, y)
        got = BinaryClassificationModelSelector.with_cross_validation(
            num_folds=3, seed=5, evaluator=tev(), models=_port_models(),
            device="cpu").fit_arrays(X, y)
        per_candidate = BinaryClassificationModelSelector \
            .with_cross_validation(num_folds=3, seed=5, evaluator=tev(),
                                   models=_port_models(), device="cpu")
        per_candidate.validator._use_batched_kernel = lambda est: False
        out[name] = (ref, got, per_candidate.fit_arrays(X, y))
    return out


@pytest.mark.parametrize("name", sorted(EVALUATORS))
def test_per_candidate_path_differs_from_jax(searches, name):
    """The candidate-by-candidate fits (fold rows, the refit solvers, the
    fold's own bin edges) give another matrix than the JAX package's
    batched host path."""
    ref, _, per_candidate = searches[name]
    a, b = _matrix(ref), _matrix(per_candidate)
    finite = np.isfinite(a)
    assert np.array_equal(finite, np.isfinite(b))
    assert np.abs(a[finite] - b[finite]).max() > 1e-6


@pytest.mark.parametrize("name", sorted(EVALUATORS))
def test_host_metric_search_matches_jax(searches, name):
    """The batched host path: the (3, 7) matrix within 1e-9 (the SVC's
    log loss NaN on both, it has no probabilities), the same winner and
    mean metric."""
    ref, got, _ = searches[name]
    a, b = _matrix(ref), _matrix(got)
    assert a.shape == b.shape == (3, 7)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-9)
    assert got.summary.best_model_name == ref.summary.best_model_name
    assert got.summary.best_model_params == ref.summary.best_model_params
    assert abs(got.summary.best_validation_metric
               - ref.summary.best_validation_metric) <= 1e-9


def test_batched_host_path_scores_trees_in_one_batch(monkeypatch):
    """Under the log loss every family takes its batched fit; each fold's
    tree models score through one ``batch_predict_raw`` call (a call a
    fold and family: the two models of a tree family in one batch, none
    of a linear one); a failing batch propagates instead of falling back
    to per-model predictions."""
    X, y = _data(n=240)
    calls = []
    real = tt.batch_predict_raw

    def spy(models, Xv):
        out = real(models, Xv)
        calls.append(len(out))
        return out
    monkeypatch.setattr(tt, "batch_predict_raw", spy)
    validator = CrossValidation(LogLossEvaluator(), num_folds=3, seed=5)
    fits = []
    best = validator.validate(_port_models_of(fits), X, y)
    assert fits == ["LogisticRegression", "RandomForestClassifier",
                    "GBTClassifier", "LinearSVC"]
    assert calls == [0] * 3 + [2] * 3 + [2] * 3 + [0] * 3
    assert np.isfinite(best.metric)

    def broken(models, Xv):
        raise RuntimeError("kernel fault")
    monkeypatch.setattr(tt, "batch_predict_raw", broken)
    with pytest.raises(RuntimeError, match="kernel fault"):
        validator.validate(_port_models()[1:2], X, y)


def _port_models_of(fits):
    models = _port_models()
    for est, _ in models:
        real_fit = est.fit_fold_grid_arrays

        def counted(*a, _real=real_fit, _name=type(est).__name__):
            fits.append(_name)
            return _real(*a)
        est.fit_fold_grid_arrays = counted
    return models


def test_workflow_cv_host_path_fits_each_fold_batched():
    """``validate_prepared`` (workflow-level CV) under the log loss: one
    single-mask batched fit a fold and family, the same matrix as the
    per-candidate fits of the linear families' fixed-trip batch would
    give on those rows (the folds' own matrices)."""
    X, y = _data(n=240)
    rng = np.random.default_rng(0)
    idx = rng.permutation(len(y))
    folds = []
    for f in range(2):
        va = np.sort(idx[f::2])
        tr = np.setdiff1d(np.arange(len(y)), va)
        folds.append((X[tr], y[tr], X[va], y[va]))
    validator = CrossValidation(LogLossEvaluator(), num_folds=2, seed=5)
    fits = []
    best = validator.validate_prepared(_port_models_of(fits), folds)
    assert fits.count("GBTClassifier") == 2
    assert fits.count("LogisticRegression") == 2
    lr = next(r for r in best.results
              if r.model_name == "LogisticRegression")
    for f, (Xt, yt, Xv, yv) in enumerate(folds):
        model = tl.LogisticRegression(max_iter=30, device="cpu") \
            .fit_fold_grid_arrays(Xt, yt, np.ones((1, len(yt))),
                                  LR_GRID)[0][lr.grid_index]
        expect = LogLossEvaluator().evaluate_arrays(
            yv, model.predict_arrays(Xv)).LogLoss
        assert lr.metric_values[f] == expect
