"""The text workflow (``examples/text.py``: tokens into TF-IDF, Word2Vec and
LDA; language, length, name entities, n-gram similarity, e-mail and URL
domains, phone validity and a string index, through ``transmogrify``) run
by the JAX package and by the PyTorch port (float64, CPU) on the same 320
records and the same stratified 75/25 split, each trained once with a
two-family search (LR and GBT):

- the prepared matrix: shape and column metadata equal; Word2Vec's and
  LDA's columns (float SGD and fixed-point iterations) within 1e-9, every
  other column bitwise;
- the (folds, grid) metric matrix within 1e-9, the same winner, the
  holdout's AuPR, log loss and Brier score within 1e-9;
- the port's model saves with ``drift-fingerprints.json``, reloads, and
  serves the holdout through a default ``ServeConfig()`` server (the
  drift sentinel on) within 1e-9 of its offline guarded rows, and its
  compiled plan within 1e-9 of the columnar path."""
import os
import re

import numpy as np
import pytest
import torch

import transmogrifai_tpu.features.builder as jb
import transmogrifai_tpu.ops as jops
import transmogrifai_tpu.types as jtypes
from transmogrifai_tpu.evaluators import (BinScoreEvaluator as JaxBinScore,
                                          Evaluators as JaxEvaluators,
                                          LogLossEvaluator as JaxLogLoss)
from transmogrifai_tpu.models import LogisticRegression as JaxLR
from transmogrifai_tpu.models.trees import GBTClassifier as JaxGBT
from transmogrifai_tpu.selector import SelectedModel as JaxSelected
from transmogrifai_tpu.selector.factories import (
    BinaryClassificationModelSelector as JaxSelector)
from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
from transmogrifai_tpu_torch.examples import text
from transmogrifai_tpu_torch.examples.titanic import stratified_split
from transmogrifai_tpu_torch.models import GBTClassifier, LogisticRegression
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, SelectedModel)
from transmogrifai_tpu_torch.serving import (ScoringPlan, ServeConfig,
                                             serve_in_process)
from transmogrifai_tpu_torch.serving.sentinel import DRIFT_FINGERPRINTS_FILE
from transmogrifai_tpu_torch.utils import uid as torch_uid
from transmogrifai_tpu_torch.workflow.persistence import load_model

RECORDS = 320
LR_GRID = [{"reg_param": 0.01}, {"reg_param": 0.1}]
GBT_GRID = [{"max_depth": 3}]
#: Word2Vec's and LDA's columns: float64 iterations summed in another order
FLOAT_TOL = 1e-9
#: the search's metrics and the holdout's: computed on those columns
METRIC_TOL = 1e-9


def _norm(s):
    return None if s is None else re.sub(r"[0-9a-f]{12}", "UID", s)


def _metas(meta):
    return [(_norm(c.parent_feature_name), c.parent_feature_type,
             _norm(c.grouping), c.indicator_value, c.descriptor_value)
            for c in meta.columns]


def _jax_dag():
    """The example's DAG built from the JAX package's classes."""
    def raw(name, ftype):
        return jb.FeatureBuilder.of(name, ftype).extract(
            lambda r, k=name: r.get(k)).as_predictor()

    body, title = raw("body", jtypes.Text), raw("title", jtypes.Text)
    email, url = raw("email", jtypes.Email), raw("url", jtypes.URL)
    phone, category = raw("phone", jtypes.Phone), raw("category",
                                                      jtypes.Text)
    label = jb.FeatureBuilder.of("label", jtypes.RealNN).extract(
        lambda r: r.get("label")).as_response()
    tokens = body.tokenize()
    derived = [
        jops.TfIdfVectorizer().set_input(tokens).get_output(),
        jops.Word2Vec().set_input(tokens).get_output(),
        tokens.lda(),
        jops.LangDetector().set_input(body).get_output(),
        jops.TextLenTransformer().set_input(body).get_output(),
        jops.NameEntityRecognizer().set_input(body).get_output(),
        jops.NGramSimilarity().set_input(title, body).get_output(),
        jops.EmailToPickList().set_input(email).get_output(),
        jops.UrlToPickList().set_input(url).get_output(),
        jops.PhoneNumberParser().set_input(phone).get_output(),
        jops.StringIndexer().set_input(category).get_output(),
    ]
    return label, jops.transmogrify(derived)


def _matrix(selected):
    return np.array([r.metric_values
                     for r in selected.summary.validation_results]).T


@pytest.fixture(scope="module")
def trained():
    records = text.synthetic_text(RECORDS)
    train, test = stratified_split(records, label_key="label")
    label, vector = _jax_dag()
    selector = JaxSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, mesh=None,
        models=[(JaxLR(max_iter=30), LR_GRID),
                (JaxGBT(num_rounds=3), GBT_GRID)])
    prediction = selector.set_input(label, vector).get_output()
    ref = (JaxWorkflow().set_result_features(label, prediction)
           .set_input_records(train).train(validate="off"))
    scored = ref.score(test)
    ref_metrics = [
        ev(label_col="label", prediction_col=prediction.name)
        .evaluate_all(scored) for ev in (
            JaxEvaluators.BinaryClassification.au_pr, JaxLogLoss,
            JaxBinScore)]

    torch_uid.reset(deterministic=True)
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, device="cpu",
        models=[(LogisticRegression(max_iter=30, device="cpu"), LR_GRID),
                (GBTClassifier(num_rounds=3, device="cpu"), GBT_GRID)])
    got = text.run(records, device="cpu", model_stage=selector)
    return {"ref": ref, "ref_vector": vector, "ref_metrics": ref_metrics,
            "got": got}


def test_prepared_matrix_matches_jax(trained):
    ref_col = trained["ref"].train_dataset[trained["ref_vector"].name]
    got_col = trained["got"].model.train_dataset[trained["got"].vector.name]
    assert isinstance(got_col.data, torch.Tensor)
    a = np.asarray(ref_col.data, dtype=np.float64)
    b = got_col.data.numpy()
    assert a.shape == b.shape == (240, b.shape[1]) and b.shape[1] > 500
    metas = _metas(got_col.metadata)
    assert metas == _metas(ref_col.metadata)
    floats = np.array([bool(re.match(r"^(w2v|topic)_", m[4] or ""))
                       for m in metas])
    assert floats.sum() == 32 + 10
    np.testing.assert_array_equal(b[:, ~floats], a[:, ~floats])
    np.testing.assert_allclose(b[:, floats], a[:, floats], rtol=0,
                               atol=FLOAT_TOL)
    parents = {m[1] for m in metas}
    assert {"TextList", "PickList", "MultiPickListMap", "Integral",
            "RealNN", "Binary"} <= parents


def test_plan_fits_word2vec_and_lda_on_the_workflow_device(trained):
    plan = trained["got"].workflow.last_prepare_plan
    fits = {k.split("(")[0] for k in plan.fit_seconds}
    assert {"Word2Vec", "LDA", "TfIdfVectorizer", "StringIndexer"} <= fits
    lda = next(s for s in trained["got"].model.stages()
               if type(s).__name__ == "LDAModel")
    assert lda.device.type == "cpu"
    host = {label.split("(")[0] for label, _ in plan.coverage.fallback}
    assert {"LDAModel", "Word2VecModel", "TfIdfVectorizerModel",
            "NameEntityRecognizer", "LangDetector"} <= host


def test_metric_matrix_winner_and_holdout_match_jax(trained):
    ref = next(s for s in trained["ref"].stages()
               if isinstance(s, JaxSelected))
    got = next(s for s in trained["got"].model.stages()
               if isinstance(s, SelectedModel))
    np.testing.assert_allclose(_matrix(got), _matrix(ref), rtol=0,
                               atol=METRIC_TOL)
    assert got.summary.best_model_name == ref.summary.best_model_name
    assert got.summary.best_model_params == ref.summary.best_model_params
    run = trained["got"]
    want_pr, want_ll, want_bin = trained["ref_metrics"]
    assert abs(run.metrics.AuPR - want_pr.AuPR) <= METRIC_TOL
    assert abs(run.metrics.AuROC - want_pr.AuROC) <= METRIC_TOL
    assert abs(run.log_loss.LogLoss - want_ll.LogLoss) <= METRIC_TOL
    assert abs(run.bin_score.BrierScore - want_bin.BrierScore) <= METRIC_TOL
    assert run.bin_score.NumberOfDataPoints == want_bin.NumberOfDataPoints


def test_saved_text_model_serves_under_default_config(trained, tmp_path):
    run = trained["got"]
    path = str(tmp_path / "model")
    run.model.save(path)
    assert os.path.exists(os.path.join(path, DRIFT_FINGERPRINTS_FILE))
    model = load_model(path, device="cpu")
    name = run.prediction.name
    holdout = [dict(r) for r in run.holdout]
    compiled = model.score(holdout, engine="compiled")[name]
    columnar = model.score(holdout)[name]
    np.testing.assert_allclose(compiled.probability, columnar.probability,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(columnar.probability,
                               run.scored[name].probability, rtol=0,
                               atol=1e-9)
    offline = ScoringPlan(model).compile().with_guardrails(
        sentinel=False).score_guarded(holdout).scored[name]
    server, client = serve_in_process({"text": model}, ServeConfig(),
                                      device="cpu")
    try:
        rows = client.score_many(holdout)
        lanes = server.metrics_snapshot()["sentinels"]
    finally:
        server.stop()
    # a coalesced batch's LDA E-step sums its products over other row
    # counts than the whole holdout's: within 1e-9, not bitwise
    for i, row in enumerate(rows):
        want = dict(offline.boxed(i).value)
        assert set(row[name]) == set(want)
        for k, v in want.items():
            assert abs(row[name][k] - v) <= 1e-9
    (lane,) = lanes.values()
    assert lane["rowsSeen"] == len(holdout)
    assert {"body", "title", "email", "url", "phone",
            "category"} == set(lane["features"])
