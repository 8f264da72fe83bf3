"""The isotonic calibrator and the external-estimator adapter, run by the
JAX package and by the PyTorch port (float64, CPU) on the same numpy
inputs: ``pava`` equal, the calibrated scores within 1e-12 (host numpy
and the model's tensor form); an external family races in a selector
with the JAX package's metrics; both fit in a workflow, save, reload and
score as trained, the calibrator through the compiled plan on the
model's device and the external family as a host stage."""
import os
import tempfile

import numpy as np
import pytest
import torch

from transmogrifai_tpu.evaluators import (
    BinaryClassificationEvaluator as JaxBinaryEvaluator)
from transmogrifai_tpu.models import isotonic as ji
from transmogrifai_tpu.models import wrap_estimator as jax_wrap
from transmogrifai_tpu.selector.validator import CrossValidation as JaxCV
from transmogrifai_tpu_torch.evaluators import BinaryClassificationEvaluator
from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.local import load_score_function
from transmogrifai_tpu_torch.models import (
    ExternalEstimator, ExternalModel, IsotonicRegressionCalibrator,
    IsotonicRegressionCalibratorModel, pava, wrap_estimator)
from transmogrifai_tpu_torch.ops import transmogrify
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, CrossValidation)
from transmogrifai_tpu_torch.serving import ScoringPlan
from transmogrifai_tpu_torch.types import Real, RealNN
from transmogrifai_tpu_torch.workflow import Workflow
from transmogrifai_tpu_torch.workflow.persistence import save_model


# a host estimator, nearest shrunken centroid; module-level functions, so
# a save can name them (the adapter's persistence rule)
def centroid_fit(X, y, shrink=0.0):
    classes = np.unique(y)
    cents = np.stack([X[y == c].mean(axis=0) for c in classes])
    return {"classes": classes, "centroids": cents * (1.0 - shrink)}


def centroid_predict(state, X):
    d2 = ((X[:, None, :] - state["centroids"][None, :, :]) ** 2).sum(-1)
    e = np.exp(-d2 + d2.min(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _scores(n=400, seed=1):
    rng = np.random.default_rng(seed)
    raw = np.round(rng.uniform(0, 1, n), 2)            # ties
    y = (rng.uniform(0, 1, n) < raw ** 2).astype(float)
    return raw, y


@pytest.mark.parametrize("increasing", [True, False])
def test_pava_and_calibrator_match_jax(increasing):
    raw, y = _scores()
    w = np.linspace(0.5, 1.5, len(y))
    for a, b in zip(pava(raw, y, w, increasing), ji.pava(raw, y, w,
                                                         increasing)):
        np.testing.assert_array_equal(a, b)
    ref = ji.IsotonicRegressionCalibrator(isotonic=increasing).fit_arrays(
        raw, y)
    got = IsotonicRegressionCalibrator(isotonic=increasing,
                                       device="cpu").fit_arrays(raw, y)
    np.testing.assert_array_equal(got.boundaries, ref.boundaries)
    np.testing.assert_array_equal(got.predictions, ref.predictions)
    probe = np.concatenate([[-1.0, 0.0, 0.005, 1.0, 2.0],
                            np.linspace(-0.1, 1.1, 97), raw[:50]])
    np.testing.assert_array_equal(got.calibrate(probe),
                                  ref.calibrate(probe))
    np.testing.assert_allclose(got.predict_values(probe),
                               ref.predict_values(probe), rtol=0, atol=1e-12)
    X = np.stack([np.zeros_like(probe), probe], axis=1)
    two = IsotonicRegressionCalibrator(feature_index=1, device="cpu") \
        .fit_arrays(np.stack([np.zeros_like(raw), raw], 1), y)
    np.testing.assert_allclose(
        two.raw_arrays(torch.as_tensor(X)).numpy(),
        ji.IsotonicRegressionCalibrator(feature_index=1).fit_arrays(
            np.stack([np.zeros_like(raw), raw], 1), y).predict_values(X),
        rtol=0, atol=1e-12)
    for b, p in (([], []), ([0.5], [0.25])):
        one = IsotonicRegressionCalibratorModel(b, p, device="cpu")
        np.testing.assert_array_equal(
            one.predict_values(probe),
            ji.IsotonicRegressionCalibratorModel(b, p).predict_values(probe))


def _data(n=150, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    X[:, 0] += y
    return X, y


def test_external_family_races_as_in_jax():
    """An external family and its grid in the validator, beside a native
    one: its candidates are fitted one by one on the folds' rows (it has
    no batched fit), with the JAX package's metrics to 1e-12; its grid
    points reach ``fit_fn`` through ``with_params``."""
    X, y = _data()
    grid = [{"shrink": s} for s in (0.0, 0.3)]
    ref = JaxCV(JaxBinaryEvaluator(), num_folds=3, stratify=True,
                mesh=None).validate(
        [(jax_wrap(centroid_fit, centroid_predict), grid)], X, y)
    got = CrossValidation(BinaryClassificationEvaluator(), num_folds=3,
                          stratify=True).validate(
        [(wrap_estimator(centroid_fit, centroid_predict), grid)], X, y)
    for r, g in zip(ref.results, got.results):
        assert g.model_name == "ExternalEstimator" and g.params == r.params
        np.testing.assert_allclose(g.metric_values, r.metric_values,
                                   rtol=0, atol=1e-12)
    assert got.params == ref.params
    est = wrap_estimator(centroid_fit, centroid_predict, shrink=0.1)
    assert est.with_params(shrink=0.2).params == {"shrink": 0.2}
    assert not hasattr(ExternalEstimator, "fit_fold_grid_arrays")
    model = est.fit_arrays(torch.as_tensor(X), y)
    assert isinstance(model, ExternalModel)
    np.testing.assert_allclose(
        model.predict_arrays(X).probability,
        jax_wrap(centroid_fit, centroid_predict, shrink=0.1).fit_arrays(
            X, y).predict_arrays(X).probability, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="classification|regression"):
        wrap_estimator(centroid_fit, centroid_predict, kind="ranking")


def _records(n=240, seed=2):
    X, y = _data(n, seed=seed)
    return [{"a": float(r[0]), "b": float(r[1]), "c": float(r[2]),
             "label": float(t)} for r, t in zip(X, y)]


def _features():
    feats = [FeatureBuilder.of(k, Real).extract(
        lambda r, k=k: r.get(k)).as_predictor() for k in "abc"]
    label = FeatureBuilder.of("label", RealNN).extract(
        lambda r: r.get("label")).as_response()
    return feats, label


def _saved_scores(model, records, name):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model")
        save_model(model, path)
        score = load_score_function(path, device="cpu")
        return [row[name] for row in score.score_batch(records,
                                                       engine="records")]


def test_external_and_calibrator_workflows_save_and_reload():
    """An external family selected in a workflow and a calibrator fitted
    in one: both save, reload and score as trained; the compiled plan
    runs the calibrator on the model's device and keeps the external
    family a host stage."""
    records = _records()
    feats, label = _features()
    vector = transmogrify(feats)
    sel = BinaryClassificationModelSelector.with_cross_validation(
        models=[(wrap_estimator(centroid_fit, centroid_predict),
                 [{"shrink": 0.0}, {"shrink": 0.2}])], device="cpu")
    pred = sel.set_input(label, vector).get_output()
    model = Workflow(device="cpu").set_result_features(pred) \
        .set_input_records(records).train()
    want = model.score(records[:6])[pred.name]
    got = _saved_scores(model, records[:6], pred.name)
    for i, row in enumerate(got):
        assert row["probability_1"] == pytest.approx(
            want.probability[i, 1], abs=1e-12)
    plan = ScoringPlan(model, device="cpu").compile()
    coverage = plan.describe()["coverage"]
    assert "SelectedModel" in str(coverage["fallback"]), coverage
    np.testing.assert_allclose(
        plan.score(records[:6])[pred.name].probability, want.probability,
        rtol=0, atol=1e-12)
    feats, label = _features()
    vector = transmogrify(feats[:1])
    cal = IsotonicRegressionCalibrator(device="cpu")
    out = cal.set_input(label, vector).get_output()
    model = Workflow(device="cpu").set_result_features(out) \
        .set_input_records(records).train()
    want = model.score(records)[out.name].data
    compiled = model.score(records, engine="compiled")[out.name].data
    np.testing.assert_allclose(compiled, want, rtol=0, atol=1e-12)
    coverage = model.scoring_plan().describe()["coverage"]
    assert "IsotonicRegressionCalibratorModel" in str(coverage["lowered"])
    assert not coverage["fallback"], coverage
    got = _saved_scores(model, records[:6], out.name)
    np.testing.assert_allclose([r["prediction"] for r in got], want[:6],
                               rtol=0, atol=1e-12)
