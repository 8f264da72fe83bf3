"""The evaluation and selection surface the PyTorch port adds beside its
device metrics, against the JAX package on the same seeded numpy inputs
(CPU): the ROC and PR curves and their areas, the binary metrics with
their threshold curves, log loss, the calibration bins, the
``Evaluators`` factory and ``RandomParamBuilder``. Every value is the same
float64 numpy arithmetic in both packages, so it must be equal, or
within 1e-12 where a sum could run in another order."""
import numpy as np
import pytest

import transmogrifai_tpu.evaluators as jev
from transmogrifai_tpu.features.columns import (
    PredictionColumn as JaxPredictionColumn)
from transmogrifai_tpu.selector.random_params import (
    RandomParamBuilder as JaxRandomParams)
import transmogrifai_tpu_torch.evaluators as tev
from transmogrifai_tpu_torch.evaluators.base import metrics_from_json
from transmogrifai_tpu_torch.features.columns import PredictionColumn
from transmogrifai_tpu_torch.selector import RandomParamBuilder

TOL = 1e-12


def _binary(n=400, seed=3, ties=True):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(np.float64)
    score = np.clip(0.3 * y + 0.7 * rng.random(n), 0.0, 1.0)
    if ties:
        score = np.round(score, 2)            # tied thresholds
    return y, score


def _pred(cls, y, score):
    prob = np.stack([1.0 - score, score], axis=1)
    return cls.from_arrays((score > 0.5).astype(np.float64), prob,
                           np.log(prob + 1e-9))


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "distinct"])
@pytest.mark.parametrize("fn", ["roc_curve", "pr_curve"])
def test_curves_match_jax(fn, ties):
    y, score = _binary(ties=ties)
    got = getattr(tev, fn)(y, score)
    want = getattr(jev, fn)(y, score)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fn", ["au_roc", "au_pr"])
def test_areas_match_jax(fn):
    for seed in range(4):
        y, score = _binary(seed=seed)
        assert abs(getattr(tev, fn)(y, score)
                   - getattr(jev, fn)(y, score)) <= TOL
    y = np.zeros(0)
    assert getattr(tev, fn)(y, y) == getattr(jev, fn)(y, y)


def test_binary_metrics_record_curves():
    y, score = _binary()
    label = (score > 0.5).astype(np.float64)
    got = tev.binary_metrics(y, label, score, record_curves=True)
    want = jev.binary_metrics(y, label, score, record_curves=True)
    assert got.to_json() == want.to_json()
    assert len(got.thresholds) > 10
    ev = tev.BinaryClassificationEvaluator(record_curves=True)
    assert ev.evaluate_arrays(y, _pred(PredictionColumn, y, score)
                              ).to_json() == want.to_json()
    assert abs(got.AuPR - tev.au_pr(y, score)) <= TOL


@pytest.mark.parametrize("k", [2, 4])
def test_log_loss_matches_jax(k):
    rng = np.random.default_rng(k)
    n = 300
    y = rng.integers(0, k, n).astype(np.float64)
    raw = rng.normal(size=(n, k))
    prob = np.exp(raw) / np.exp(raw).sum(axis=1, keepdims=True)
    prob[0, int(y[0])] = 0.0                    # a confident miss: clipped
    assert tev.log_loss(y, prob) == jev.log_loss(y, prob)
    pred_t = PredictionColumn.from_arrays(prob.argmax(1), prob, raw)
    pred_j = JaxPredictionColumn.from_arrays(prob.argmax(1), prob, raw)
    got = tev.LogLossEvaluator().evaluate_arrays(y, pred_t)
    want = jev.LogLossEvaluator().evaluate_arrays(y, pred_j)
    assert got.to_json() == want.to_json()
    assert not tev.LogLossEvaluator.is_larger_better
    for bad in (np.zeros(0), np.full(n, float(k))):
        with pytest.raises(ValueError):
            tev.log_loss(bad, prob[:len(bad)] if len(bad) == 0 else prob)


@pytest.mark.parametrize("bins", [10, 100])
def test_bin_score_matches_jax(bins):
    y, score = _binary(ties=False)
    got = tev.BinScoreEvaluator(num_bins=bins).evaluate_arrays(
        y, _pred(PredictionColumn, y, score))
    want = jev.BinScoreEvaluator(num_bins=bins).evaluate_arrays(
        y, _pred(JaxPredictionColumn, y, score))
    g, w = got.to_json(), want.to_json()
    assert g.keys() == w.keys()
    assert g["NumberOfDataPoints"] == w["NumberOfDataPoints"]
    for key in ("BinCenters", "AverageScore", "AverageConversionRate"):
        np.testing.assert_allclose(g[key], w[key], rtol=0, atol=TOL)
    assert abs(g["BrierScore"] - w["BrierScore"]) <= TOL
    back = metrics_from_json("BinScoreMetrics", g)
    assert isinstance(back, tev.BinScoreMetrics) and back.to_json() == g
    with pytest.raises(ValueError):
        tev.BinScoreEvaluator(num_bins=0)


def _factory_methods():
    out = []
    for group in ("BinaryClassification", "MultiClassification",
                  "Regression"):
        cls = getattr(jev.Evaluators, group)
        out += [(group, m) for m in sorted(vars(cls))
                if not m.startswith("_")]
    return out


@pytest.mark.parametrize("group,method", _factory_methods(),
                         ids=lambda v: str(v))
def test_evaluators_factory_matches_jax(group, method):
    got = getattr(getattr(tev.Evaluators, group), method)(
        label_col="y", prediction_col="p")
    want = getattr(getattr(jev.Evaluators, group), method)(
        label_col="y", prediction_col="p")
    assert type(got).__name__ == type(want).__name__
    assert got.default_metric == want.default_metric
    assert got.is_larger_better == want.is_larger_better
    assert (got.label_col, got.prediction_col) == ("y", "p")
    # the selector's search computes the same metric on the device where
    # the device computes it
    spec = got.device_metric_spec()
    assert spec is None or spec[1] == got.default_metric


def test_factory_evaluator_scores_a_dataset():
    from transmogrifai_tpu_torch.features.columns import (Dataset,
                                                          FeatureColumn)
    from transmogrifai_tpu_torch.types import RealNN
    y, score = _binary()
    ds = Dataset({"y": FeatureColumn(RealNN, y),
                  "p": _pred(PredictionColumn, y, score)})
    ev = tev.Evaluators.BinaryClassification.au_pr(label_col="y",
                                                   prediction_col="p")
    assert abs(ev.evaluate(ds) - jev.au_pr(y, score)) <= TOL
    assert ev.device_metric_spec() == ("binary", "AuPR")


def _param_builders(cls, seed):
    return (cls(seed=seed).uniform("reg_param", 0.001, 1.0)
            .uniform("max_depth", 2, 12, integer=True)
            .exponential("step_size", 1e-4, 1.0)
            .subset("impurity", ["gini", "entropy"]))


@pytest.mark.parametrize("seed", [0, 42])
def test_random_params_match_jax(seed):
    got = _param_builders(RandomParamBuilder, seed).build(25)
    want = _param_builders(JaxRandomParams, seed).build(25)
    assert got == want
    assert len({d["reg_param"] for d in got}) == 25
    with pytest.raises(ValueError):
        RandomParamBuilder().uniform("x", 1.0, 1.0)
    with pytest.raises(ValueError):
        RandomParamBuilder().exponential("x", 0.0, 1.0)
    with pytest.raises(ValueError):
        RandomParamBuilder().subset("x", [])
    with pytest.raises(ValueError):
        RandomParamBuilder().build(1)
