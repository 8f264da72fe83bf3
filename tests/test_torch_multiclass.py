"""The multiclass problem type of the PyTorch port against the JAX package,
in float64 on the CPU: the multiclass metrics (host and device), the
DataCutter, NaiveBayes, multinomial logistic regression (with optax's
L-BFGS iteration count), the K-class forests and the softmax booster
under replayed draws, K1's statistic blocks and the models carried
across. The Iris example's workflow is in
``test_torch_problem_examples.py``. Inputs are made with numpy from
seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_forest import JaxDraws, _heaps_equal
from test_torch_linear import _optax_lbfgs
from transmogrifai_tpu.evaluators import device_metrics as jdm
from transmogrifai_tpu.evaluators import multiclass as jmc
from transmogrifai_tpu.models import bayes as jb
from transmogrifai_tpu.models import linear as jl
from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu.selector import splitters as jsp
from transmogrifai_tpu_torch.evaluators import device_metrics as tdm
from transmogrifai_tpu_torch.evaluators import multiclass as tmc
from transmogrifai_tpu_torch.models import bayes as tb
from transmogrifai_tpu_torch.models import linear as tl
from transmogrifai_tpu_torch.models import trees as tt
from transmogrifai_tpu_torch.models.convert import from_jax_model
from transmogrifai_tpu_torch.models.hist_kernel import (HistPlan,
                                                        level_hist_plain)
from transmogrifai_tpu_torch.selector import splitters as tsp


def _data(n=240, d=6, k=3, seed=0):
    """Non-negative features (NaiveBayes takes them), a k-class label
    from noisy linear scores."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(size=(n, d - 2)) * 3.0,
                        (rng.uniform(size=(n, 2)) < 0.3).astype(float)], 1)
    W = rng.normal(size=(d, k)) * 2.0
    y = np.argmax((X - X.mean(axis=0)) @ W + rng.gumbel(size=(n, k)),
                  axis=1).astype(float)
    assert len(np.unique(y)) == k
    return X, y


def _folds(n, F=3, seed=1):
    assign = np.random.default_rng(seed).permutation(np.arange(n) % F)
    masks = np.stack([(assign != f).astype(float) for f in range(F)])
    return assign, masks


def _fold_arrays(X, y, assign, F=3):
    return (np.stack([X[assign == f] for f in range(F)]),
            np.stack([y[assign == f] for f in range(F)]))


# ---------------------------------------------------------------------------
# metrics and the DataCutter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scored():
    """Labels with class 3 absent from the rows, and probabilities with
    ties (argmax takes the first index)."""
    rng = np.random.default_rng(3)
    y = rng.choice([0.0, 1.0, 2.0, 4.0], size=300, p=[0.5, 0.3, 0.15, 0.05])
    prob = rng.dirichlet(np.ones(5), size=300)
    prob[:20] = 0.2                                # five-way ties
    return y, prob


def test_multiclass_host_metrics_match_jax(scored):
    y, prob = scored
    pred = np.argmax(prob, axis=1).astype(float)
    ref = jmc.multiclass_metrics(y, pred, prob)
    got = tmc.multiclass_metrics(y, pred, prob)
    assert got.to_json() == ref.to_json()


@pytest.mark.parametrize("metric", tdm.MULTICLASS_METRICS)
def test_multiclass_device_metric_matches_host_and_jax(scored, metric):
    """Weighted over all K classes with absent classes at zero weight:
    the host loop over the present labels within 1e-12, and the JAX
    package's device metric."""
    y, prob = scored
    host = getattr(tmc.multiclass_metrics(
        y, np.argmax(prob, axis=1).astype(float), prob), metric)
    got = float(tdm.multiclass_metric(torch.from_numpy(y),
                                      torch.from_numpy(prob), metric))
    ref = float(jdm.multiclass_metric(jnp.asarray(y), jnp.asarray(prob),
                                      metric))
    assert abs(got - host) <= 1e-12 and abs(got - ref) <= 1e-12


def test_metrics_json_round_trip(scored):
    """The nested ThresholdMetrics comes back with its int top-N keys."""
    from transmogrifai_tpu_torch.evaluators.base import metrics_from_json
    y, prob = scored
    m = tmc.multiclass_metrics(y, np.argmax(prob, axis=1).astype(float),
                               prob)
    import json
    back = metrics_from_json("MultiClassificationMetrics",
                             json.loads(json.dumps(m.to_json())))
    assert back == m and isinstance(back.ThresholdMetrics,
                                    tmc.ThresholdMetrics)


@pytest.mark.parametrize("min_frac,max_cats", [(0.0, 100), (0.06, 100),
                                               (0.0, 2)])
def test_data_cutter_matches_jax(scored, min_frac, max_cats):
    y = scored[0]
    ref = jsp.DataCutter(min_label_fraction=min_frac,
                         max_label_categories=max_cats,
                         reserve_test_fraction=0.2, seed=7)
    got = tsp.DataCutter(min_label_fraction=min_frac,
                         max_label_categories=max_cats,
                         reserve_test_fraction=0.2, seed=7)
    for a, b in zip(ref.split(y), got.split(y)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ref.prepare(y), got.prepare(y))
    np.testing.assert_array_equal(ref.labels_kept, got.labels_kept)
    assert got.summary.to_json() == ref.summary.to_json()


# ---------------------------------------------------------------------------
# NaiveBayes and multinomial logistic regression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_type", ["multinomial", "bernoulli"])
def test_naive_bayes_matches_jax(model_type):
    """pi and theta within 1e-12; the fold x grid search's metric matrix
    within 1e-12."""
    X, y = _data()
    ref = jb.NaiveBayes(smoothing=0.5, model_type=model_type).fit_arrays(X, y)
    got = tb.NaiveBayes(smoothing=0.5, model_type=model_type,
                        device="cpu").fit_arrays(X, y)
    np.testing.assert_allclose(got.pi.numpy(), ref.pi, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.theta.numpy(), ref.theta, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got.predict_arrays(X).probability,
                               ref.predict_arrays(X).probability, rtol=0,
                               atol=1e-12)
    assign, masks = _folds(len(y))
    Xv, yv = _fold_arrays(X, y, assign)
    grid = [{"smoothing": s} for s in (1.0, 0.2)]
    spec = ("multiclass", "F1")
    mm_ref = jb.NaiveBayes(model_type=model_type).eval_fold_grid_arrays(
        X, y, masks, grid, Xv, yv, spec)
    mm = tb.NaiveBayes(model_type=model_type,
                       device="cpu").eval_fold_grid_arrays(
        X, y, masks, grid, Xv, yv, spec)
    np.testing.assert_allclose(mm, mm_ref, rtol=0, atol=1e-12)


def test_naive_bayes_rejects_negative_features():
    from transmogrifai_tpu_torch.models.base import FamilyPreconditionError
    X, y = _data(n=60)
    X[0, 0] = -1.0
    with pytest.raises(FamilyPreconditionError):
        tb.NaiveBayes(device="cpu").fit_arrays(X, y)


@pytest.mark.parametrize("reg,en", [(0.01, 0.0), (0.1, 0.0), (0.05, 0.5)])
def test_multinomial_logistic_matches_jax(reg, en, monkeypatch):
    """Coefficients and intercepts within 1e-6 of the JAX package's fit;
    without an L1 term L-BFGS takes optax's iteration count on the same
    standardized objective; with one, FISTA to tol 1e-7."""
    X, y = _data(n=300, seed=4)
    k, n, d = 3, len(y), X.shape[1]
    counts = []
    real = tl.lbfgs_minimize

    def spy(*a, **kw):
        out = real(*a, **kw)
        counts.append(out[1])
        return out
    monkeypatch.setattr(tl, "lbfgs_minimize", spy)
    ref = jl.LogisticRegression(reg_param=reg, elastic_net_param=en,
                                max_iter=50).fit_arrays(X, y)
    got = tl.LogisticRegression(reg_param=reg, elastic_net_param=en,
                                max_iter=50, device="cpu").fit_arrays(X, y)
    assert got.coefficients.shape == (k, d)
    np.testing.assert_allclose(got.coefficients.numpy(), ref.coefficients,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.intercept.numpy(), ref.intercept, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.predict_arrays(X).probability,
                               ref.predict_arrays(X).probability, rtol=0,
                               atol=1e-6)
    if en == 0.0:
        Xs, _, _, _ = jl._prep(jnp.asarray(X), jnp.ones(n), True, None)
        onehot = jax.nn.one_hot(jnp.asarray(y, jnp.int32), k,
                                dtype=Xs.dtype)

        def smooth(p):
            logits = Xs @ p[:, :d].T + p[:, d]
            ll = jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), 1))
            return -ll + 0.5 * reg * jnp.sum(p[:, :d] ** 2)
        _, count = _optax_lbfgs(smooth, jnp.zeros((k, d + 1)), 50)
        assert counts == [count]
    else:
        assert counts == []


def test_multinomial_search_is_validated_per_candidate():
    """As in the JAX package, the batched linear search is binary-only:
    a multiclass label leaves LogisticRegression to the per-candidate
    path."""
    X, y = _data(n=90)
    assign, masks = _folds(len(y))
    Xv, yv = _fold_arrays(X, y, assign)
    with pytest.raises(NotImplementedError):
        tl.LogisticRegression(device="cpu").eval_fold_grid_arrays(
            X, y, masks, [{}], Xv, yv, ("binary", "AuPR"))


# ---------------------------------------------------------------------------
# K-class forests and the softmax booster
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def multi():
    return _data(n=300, d=8, k=3, seed=9)


def test_forest_classifier_k3_matches_jax(multi):
    """A 3-class random forest under replayed draws: equal split heaps,
    leaf class distributions within 1e-12."""
    X, y = multi
    kw = dict(num_trees=3, max_depth=4, min_instances_per_node=2, seed=11)
    ref = jt.RandomForestClassifier(**kw).fit_arrays(X, y)
    got = tt.RandomForestClassifier(**kw, device="cpu",
                                    draws=JaxDraws).fit_arrays(X, y)
    assert got.leaves.shape[-1] == 3
    _heaps_equal(ref, got)


def test_decision_tree_k5_matches_jax():
    """Five classes (S = 5: more statistics than K1 takes in a launch)."""
    X, y = _data(n=300, d=6, k=5, seed=12)
    ref = jt.DecisionTreeClassifier(max_depth=5).fit_arrays(X, y)
    got = tt.DecisionTreeClassifier(max_depth=5, device="cpu").fit_arrays(
        X, y)
    _heaps_equal(ref, got)


def test_softmax_xgboost_matches_jax(multi):
    """XGBoostClassifier on three classes: the softmax booster's (R, K, H)
    trees equal, leaves and base margins within 1e-12."""
    X, y = multi
    kw = dict(num_round=4, max_depth=3, eta=0.3, min_child_weight=1.0)
    ref = jt.XGBoostClassifier(**kw).fit_arrays(X, y)
    got = tt.XGBoostClassifier(**kw, device="cpu").fit_arrays(X, y)
    assert type(got).__name__ == "GBTMulticlassClassifierModel"
    assert tuple(got.feats.shape) == (4, 3, 7)
    _heaps_equal(ref, got)
    np.testing.assert_allclose(got.base.numpy(), ref.base, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got.predict_arrays(X).probability,
                               ref.predict_arrays(X).probability, rtol=0,
                               atol=1e-12)


def test_gbt_classifier_stays_binary(multi):
    X, y = multi
    with pytest.raises(ValueError, match="binary"):
        tt.GBTClassifier(device="cpu").fit_arrays(X, y)
    with pytest.raises(NotImplementedError):
        tt.GBTClassifier(device="cpu").eval_fold_grid_arrays(
            X, y, np.ones((1, len(y))), [{}], X[None], y[None],
            ("multiclass", "F1"))


@pytest.mark.parametrize("S,blocks", [(2, [2]), (4, [4]), (5, [3, 2]),
                                      (7, [4, 3]), (9, [3, 3, 3])])
def test_stat_blocks_split_wide_statistics(S, blocks):
    """More than four statistics launch K1 once per block of balanced
    widths; the blocks' plain histograms, concatenated, are the whole."""
    widths = [4, 32, 2, 8]
    plan = HistPlan(widths, S, torch.device("cpu"))
    got = plan.stat_blocks()
    assert [b - a for a, b, _ in got] == blocks
    assert got[0][0] == 0 and got[-1][1] == S
    assert all(sub.S == b - a for a, b, sub in got)
    rng = np.random.default_rng(S)
    n = 64
    local = np.stack([rng.integers(0, w, n) for w in widths], 1)
    from transmogrifai_tpu_torch.models.hist_kernel import compact_ids
    ids, offsets = compact_ids(torch.as_tensor(local, dtype=torch.int32),
                               widths)
    slot = torch.as_tensor(rng.integers(0, 3, n), dtype=torch.int32)
    st = torch.as_tensor(rng.normal(size=(n, S)))
    whole = level_hist_plain(ids, offsets, slot, st, 3, sum(widths))
    parts = torch.cat([level_hist_plain(ids, offsets, slot,
                                        st[:, a:b].contiguous(), 3,
                                        sum(widths))
                       for a, b, _ in got], dim=2)
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("family", ["LogisticRegressionModel",
                                    "NaiveBayesModel",
                                    "TreeEnsembleClassifierModel",
                                    "GBTMulticlassClassifierModel"])
def test_multiclass_models_carry_across(multi, family):
    """``convert.from_jax_model`` of each fitted JAX multiclass model
    predicts its probabilities within 1e-12 (LR's multinomial (K, d)
    coefficients and (K,) intercepts, NaiveBayes's pi and theta, the
    forest's (T, L, K) leaves, the softmax booster's (R, K, H) trees)."""
    X, y = multi
    est = {"LogisticRegressionModel": jl.LogisticRegression(max_iter=20),
           "NaiveBayesModel": jb.NaiveBayes(),
           "TreeEnsembleClassifierModel": jt.DecisionTreeClassifier(
               max_depth=3),
           "GBTMulticlassClassifierModel": jt.XGBoostClassifier(
               num_round=2, max_depth=2)}[family]
    ref = est.fit_arrays(X, y)
    got = from_jax_model(ref, device="cpu")
    assert type(got).__name__ == family
    np.testing.assert_allclose(got.predict_arrays(X).probability,
                               ref.predict_arrays(X).probability, rtol=0,
                               atol=1e-12)
