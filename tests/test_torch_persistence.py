"""Model persistence and local scoring of the PyTorch port, on small
hand-built fitted stages: the JAX package's ``tests/test_persistence.py``
contract — the value codec, the feature-type round trip, atomic saves, the
refusal of partial directories — plus what is the port's own: tensors
saved as host arrays, device arguments never written, the load device,
and the parts that raise by name. Last, a Titanic model with a
SanityChecker trained behind a raw feature filter by both packages: its
save carries the filter's results and reloads, and serves a record
without a label as the JAX package's does."""
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.evaluators.binary import (
    BinaryClassificationMetrics)
from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.local import (ScoreFunction, load_score_function,
                                           score_function_for)
from transmogrifai_tpu_torch.models import LogisticRegression
from transmogrifai_tpu_torch.models.linear import LogisticRegressionModel
from transmogrifai_tpu_torch.ops.numeric import RealVectorizerModel
from transmogrifai_tpu_torch.selector import (ModelSelectorSummary,
                                              SelectedModel, ValidationResult)
from transmogrifai_tpu_torch.stages.base import UnaryTransformer
from transmogrifai_tpu_torch.types import Real
from transmogrifai_tpu_torch.workflow import WorkflowModel
from transmogrifai_tpu_torch.workflow import persistence
from transmogrifai_tpu_torch.workflow.persistence import (
    decode_value, encode_value, load_model, stage_to_json)

RECORDS = [{"x": v, "label": float(v is not None and v > 0.5)}
           for v in (0.1, None, 0.9, 0.7, None, 0.3, 2.0, -1.0)]


def _summary():
    return ModelSelectorSummary(
        validation_type="CrossValidation",
        validation_parameters={"numFolds": 3, "seed": 42,
                               "stratify": True},
        evaluation_metric="AuPR", problem_type="BinaryClassification",
        best_model_name="LogisticRegression", best_model_uid="lr_1",
        best_model_params={"reg_param": 0.1}, best_validation_metric=0.75,
        validation_results=[
            ValidationResult("LogisticRegression", "lr_1", 0,
                             {"reg_param": 0.1}, [0.7, 0.8]),
            ValidationResult("GBTClassifier", "gbt_1", 0,
                             {"max_depth": 3}, [0.6, 0.5])],
        train_evaluation=BinaryClassificationMetrics(AuPR=0.8, TP=3.0),
        holdout_evaluation=None, timings={"validate": 1.5})


def _model(selected: bool = True) -> WorkflowModel:
    """label, x -> RealVectorizerModel -> logistic model (inside a
    SelectedModel), all fitted by hand on the CPU."""
    x = FeatureBuilder.real("x").extract(lambda r: r["x"]).as_predictor()
    label = FeatureBuilder.real_nn("label").extract(
        lambda r: r["label"]).as_response()
    vec = RealVectorizerModel(fill_values=[0.5]).set_input(x).get_output()
    inner = LogisticRegressionModel(np.array([2.0, -1.0]), -0.5,
                                    device="cpu")
    stage = SelectedModel(inner, _summary()) if selected else inner
    return WorkflowModel(result_features=(stage.set_input(label, vec)
                                          .get_output(),))


def _scores(model, records=RECORDS):
    name = model.result_features[0].name
    return model.score(records)[name].probability


@pytest.fixture
def saved(tmp_path):
    model = _model()
    path = str(tmp_path / "model")
    model.save(path)
    return model, path


class _Scaled(UnaryTransformer):
    """A stage with a torch.device argument."""
    input_types = (Real,)
    output_type = Real

    def __init__(self, factor=2.0, where=torch.device("cpu"), uid=None):
        super().__init__(operation_name="scaled", uid=uid)
        self.factor = factor
        self.where = where


def test_value_codec_round_trip():
    arrays = {}
    v = {"a": 1, "b": [1.5, None, "x"], "c": np.arange(3.0),
         "d": (True, np.ones((2, 2))),
         "t": torch.arange(4, dtype=torch.float64)}
    enc = encode_value(v, arrays, "k")
    json.dumps(enc)                               # JSON-safe
    assert enc["$dict"]["t"] == {"$array": "k/t"}
    dec = decode_value(enc, arrays)
    assert dec["a"] == 1 and dec["b"] == [1.5, None, "x"]
    np.testing.assert_array_equal(dec["c"], np.arange(3.0))
    assert isinstance(dec["d"], tuple) and dec["d"][0] is True
    np.testing.assert_array_equal(dec["d"][1], np.ones((2, 2)))
    assert isinstance(dec["t"], np.ndarray)
    np.testing.assert_array_equal(dec["t"], np.arange(4.0))


def test_feature_type_round_trip():
    assert decode_value(encode_value(Real, {}, "t"), {}) is Real


def test_device_arguments_are_not_written():
    arrays = {}
    d = stage_to_json(_Scaled(3.0, where=torch.device("cpu")), arrays)
    assert d["ctorArgs"] == {"factor": 3.0}
    d = stage_to_json(LogisticRegressionModel(
        torch.tensor([1.0, 2.0], dtype=torch.float64), 0.5, device="cpu"),
        arrays)
    assert set(d["ctorArgs"]) == {"coefficients", "intercept"}
    assert arrays[d["ctorArgs"]["coefficients"]["$array"]].dtype == \
        np.float64


def test_round_trip_scores_match(saved):
    model, path = saved
    assert sorted(os.listdir(path)) == ["arrays.npz", "op-model.json"]
    loaded = load_model(path, device="cpu")
    assert [f.uid for f in loaded.result_features] == \
        [f.uid for f in model.result_features]
    assert [type(s).__name__ for s in loaded.stages()] == \
        [type(s).__name__ for s in model.stages()]
    np.testing.assert_array_equal(_scores(loaded), _scores(model))
    inner = next(s for s in loaded.stages()
                 if isinstance(s, SelectedModel)).inner
    assert inner.coefficients.device == torch.device("cpu")
    assert inner.coefficients.dtype == torch.float64


def test_load_device_is_the_callers(saved):
    """A load names its device; the default, the card, raises here."""
    _, path = saved
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default load succeeds")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WorkflowModel.load(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_score_function(path)


def test_saved_summary_keeps_the_jax_keys(saved):
    model, path = saved
    with open(os.path.join(path, "op-model.json")) as fh:
        doc = json.load(fh)
    assert doc["formatVersion"] == persistence.MODEL_FORMAT_VERSION
    sel = next(s for s in doc["stages"] if s["className"] == "SelectedModel")
    summ = sel["ctorArgs"]["summary"]["$selsummary"]
    assert "timings" not in summ
    assert summ["trainEvaluationClass"] == "BinaryClassificationMetrics"
    assert sel["ctorArgs"]["inner"]["$stage"]["className"] == \
        "LogisticRegressionModel"


def test_summary_json_round_trip_and_pretty():
    s = _summary()
    back = ModelSelectorSummary.from_json(json.loads(json.dumps(
        s.to_json())))
    assert back.to_json() == s.to_json()
    assert back.timings == {}
    assert isinstance(back.train_evaluation, BinaryClassificationMetrics)
    assert back.train_evaluation.AuPR == 0.8
    text = s.pretty()
    assert text.startswith("Selected model: LogisticRegression (AuPR=0.7500")
    lines = text.splitlines()
    assert lines[3].startswith("  LogisticRegression[0]")  # best first


def test_save_unfitted_raises(tmp_path):
    x = FeatureBuilder.real("x").extract(lambda r: r["x"]).as_predictor()
    label = FeatureBuilder.real_nn("label").extract(
        lambda r: r["label"]).as_response()
    vec = RealVectorizerModel(fill_values=[0.0]).set_input(x).get_output()
    pred = LogisticRegression(device="cpu").set_input(label, vec).get_output()
    with pytest.raises(ValueError, match="unfitted"):
        WorkflowModel(result_features=(pred,)).save(str(tmp_path / "bad"))


def test_failed_save_leaves_no_target(tmp_path, monkeypatch):
    model = _model()
    path = str(tmp_path / "fresh")

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(persistence.np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        model.save(path)
    assert not os.path.exists(path)
    staged = [p for p in os.listdir(tmp_path)
              if p.startswith("fresh.tmp-save")]
    assert staged
    with pytest.raises(ValueError, match="partial|interrupted"):
        load_model(str(tmp_path / staged[0]), device="cpu")


def test_failed_overwrite_keeps_old_model(saved, monkeypatch):
    model, path = saved
    before = _scores(load_model(path, device="cpu"))

    def broken(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(persistence.np, "savez", broken)
    with pytest.raises(OSError):
        _model(selected=False).save(path)
    monkeypatch.undo()
    loaded = load_model(path, device="cpu")
    assert any(isinstance(s, SelectedModel) for s in loaded.stages())
    np.testing.assert_array_equal(_scores(loaded), before)


def test_resave_over_existing_model(saved, tmp_path):
    model, path = saved
    model.save(path)
    assert not [p for p in os.listdir(tmp_path)
                if "tmp-save" in p or "old-save" in p]
    np.testing.assert_array_equal(
        _scores(load_model(path, device="cpu")), _scores(model))


def test_load_rejects_non_model_dir(tmp_path):
    with pytest.raises(ValueError, match="not a saved model"):
        load_model(str(tmp_path / "missing"), device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="not a saved model"):
        load_model(str(tmp_path / "empty"), device="cpu")


def test_load_rejects_missing_arrays(saved):
    _, path = saved
    os.remove(os.path.join(path, "arrays.npz"))
    with pytest.raises(ValueError, match="partial|interrupted"):
        load_model(path, device="cpu")


def test_load_rejects_truncated_json(saved):
    _, path = saved
    jp = os.path.join(path, "op-model.json")
    with open(jp) as fh:
        text = fh.read()
    with open(jp, "w") as fh:
        fh.write(text[:len(text) // 2])
    with pytest.raises(ValueError, match="corrupt|truncated"):
        load_model(path, device="cpu")


def test_unimportable_lambda_transformer_raises_on_load(tmp_path):
    x = FeatureBuilder.real("x").extract(lambda r: r["x"]).as_predictor()
    out = x.map(lambda v: v, Real)
    path = str(tmp_path / "lambda")
    WorkflowModel(result_features=(out,)).save(path)
    with pytest.raises(ValueError, match="not importable"):
        load_model(path, device="cpu")


def test_score_function_serves_records(saved):
    model, path = saved
    score = load_score_function(path, device="cpu")
    name = model.result_features[0].name
    rows = score.score_batch(RECORDS, engine="records")
    expect = _scores(model)
    for row, p in zip(rows, expect):
        assert row[name]["probability_1"] == pytest.approx(p[1], abs=1e-12)
    assert score(dict(RECORDS[0])) == rows[0]
    assert score_function_for(model)(dict(RECORDS[0])) == rows[0]


def test_score_function_unported_parts_raise(saved):
    """The compiled batch engine (the default) and the guardrails, with
    the drift sentinel that ``guardrails=True`` turns on by default (off
    here: the model has no training data), serve the records' rows; an
    unknown engine raises."""
    model, _ = saved
    score = score_function_for(model)
    name = model.result_features[0].name
    rows = score.score_batch(RECORDS)
    loop = score.score_batch(RECORDS, engine="records")
    for got, want in zip(rows, loop):
        assert got[name] == pytest.approx(want[name], abs=1e-12)
    with pytest.raises(ValueError, match="engine must be"):
        score.score_batch(RECORDS, engine="fast")
    guarded = ScoreFunction(model, guardrails=True)
    assert guarded.score_batch(RECORDS) == rows
    # a model fitted by hand has no training data to fingerprint: the
    # default sentinel is unavailable, and the plan serves without it
    assert not os.path.exists(os.path.join(
        model.model_dir, "drift-fingerprints.json"))
    assert guarded._compiled_plan.drift_report() == {"enabled": False}
    unwatched = ScoreFunction(model, guardrails={"sentinel": False})
    assert unwatched.score_batch(RECORDS) == rows


def _tree_arrays(rng, trees, depth, leaf_shape):
    feats = rng.integers(0, 3, size=(trees, 2 ** depth - 1)).astype(np.int32)
    thrs = rng.normal(size=(trees, 2 ** depth - 1))
    leaves = rng.uniform(size=(trees, 2 ** depth) + leaf_shape)
    return feats, thrs, leaves


@pytest.mark.parametrize("kind", ["gbt", "forest", "svc"])
def test_model_layout_matches_jax(kind, tmp_path):
    """A fitted model's saved record has the JAX model's class name,
    constructor keys and array shapes; reloaded, it predicts as before."""
    from transmogrifai_tpu.models import linear as jl
    from transmogrifai_tpu.models import trees as jt
    from transmogrifai_tpu.workflow.persistence import (
        stage_to_json as jax_stage_to_json)
    from transmogrifai_tpu_torch.models import linear as tl
    from transmogrifai_tpu_torch.models import trees as tt
    from transmogrifai_tpu_torch.workflow.persistence import stage_from_json
    rng = np.random.default_rng(4)
    if kind == "gbt":
        args = _tree_arrays(rng, 4, 3, ())
        ref = jt.GBTClassifierModel(*args, depth=3, base=0.25, n_features=3)
        got = tt.GBTClassifierModel(*args, depth=3, base=0.25, n_features=3,
                                    device="cpu")
    elif kind == "forest":
        args = _tree_arrays(rng, 4, 3, (2,))
        ref = jt.TreeEnsembleClassifierModel(*args, depth=3, n_features=3)
        got = tt.TreeEnsembleClassifierModel(*args, depth=3, n_features=3,
                                             device="cpu")
    else:
        ref = jl.LinearSVCModel(rng.normal(size=3), 0.5)
        got = tl.LinearSVCModel(rng.normal(size=3), 0.5, device="cpu")
    ref_arrays, got_arrays = {}, {}
    a = jax_stage_to_json(ref, ref_arrays)
    b = stage_to_json(got, got_arrays)
    assert b["className"] == a["className"]
    assert set(b["ctorArgs"]) == set(a["ctorArgs"])
    assert [v.shape for v in got_arrays.values()] == \
        [v.shape for v in ref_arrays.values()]
    back = stage_from_json(json.loads(json.dumps(b)), got_arrays,
                           torch.device("cpu"))
    X = rng.normal(size=(20, 3))
    np.testing.assert_array_equal(back.predict_raw(X), got.predict_raw(X))


def checked_filtered_models(root):
    """The Titanic DAG with a SanityChecker before a fixed logistic stage,
    trained by each package on the same 300 records' 75 % split behind a
    raw feature filter (min_fill 0.3, which drops the 77 %-empty cabin;
    scored against the holdout): (jax served row of ``demo_serve``, port
    model, the port's save directory). The JAX save leaves out its AOT
    export and plan fingerprint, which only add files."""
    from unittest import mock

    from examples import titanic as jax_titanic
    from transmogrifai_tpu.checkers import RawFeatureFilter as JaxRFF
    from transmogrifai_tpu.models import LogisticRegression as JaxLR
    from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
    from transmogrifai_tpu_torch.checkers import RawFeatureFilter
    from transmogrifai_tpu_torch.examples import titanic
    from transmogrifai_tpu_torch.workflow import Workflow

    train, test = titanic.stratified_split(
        titanic.synthetic_titanic(400, seed=29))
    out = {}
    for pkg, wf, lr, rff in (
            (jax_titanic, JaxWorkflow(), JaxLR(reg_param=0.01, max_iter=30),
             JaxRFF(min_fill=0.3)),
            (titanic, Workflow(device="cpu"),
             LogisticRegression(reg_param=0.01, max_iter=30, device="cpu"),
             RawFeatureFilter(min_fill=0.3))):
        label, vector = pkg.build_features()
        pred = lr.set_input(label, vector.sanity_check(label)).get_output()
        wf = (wf.set_result_features(label, pred).set_input_records(train)
              .with_raw_feature_filter(rff, score_data=test))
        out[pkg is titanic] = wf.train(
            **({} if pkg is titanic else {"validate": "off"}))
    with mock.patch.dict(os.environ, {"TX_AOT_EXPORT": "off",
                                      "TX_PLAN_FINGERPRINT": "off"}):
        ref_row = jax_titanic.demo_serve(out[False], str(root / "jax"))
    path = str(root / "port")
    out[True].save(path)
    return ref_row, out[True], path


@pytest.fixture(scope="module")
def checked(tmp_path_factory):
    return checked_filtered_models(tmp_path_factory.mktemp("checked"))


def test_checked_filtered_model_round_trip(checked):
    """A model with a SanityChecker stage and raw feature filter results
    saves in the JAX package's layout and reloads: the filter's results
    and blacklist, the checker's kept indices and output metadata."""
    _, model, path = checked
    assert model.blacklisted_feature_names == ["cabin"]
    with open(os.path.join(path, "op-model.json")) as fh:
        doc = json.load(fh)
    assert doc["blacklistedFeatureNames"] == ["cabin"]
    assert [e["name"] for e in doc["rawFeatureFilterResults"]
            ["exclusions"]] == ["cabin"]
    stage = next(s for s in doc["stages"]
                 if s["className"] == "SanityCheckerModel")
    assert set(stage["ctorArgs"]) == {"kept_indices", "output_metadata"}
    loaded = load_model(path, device="cpu")
    assert loaded.blacklisted_feature_names == ["cabin"]
    assert loaded.raw_feature_filter_results.to_json() == \
        model.raw_feature_filter_results.to_json()
    checker = [next(s for s in m.stages()
                    if type(s).__name__ == "SanityCheckerModel")
               for m in (model, loaded)]
    assert checker[1].kept_indices == checker[0].kept_indices
    assert checker[1].output_metadata == checker[0].output_metadata
    assert "cabin" not in [f.name for f in loaded.raw_features()]


def test_checked_model_serves_a_label_less_record_like_jax(checked):
    """The reloaded model serves ``SAMPLE_PASSENGER``, which has no label,
    through ``load_score_function``: the checker's label input is fed as
    a placeholder and never read; the answer is the JAX package's
    ``demo_serve`` answer within 1e-9."""
    from transmogrifai_tpu_torch.examples import titanic
    ref_row, model, path = checked
    score = load_score_function(path, device="cpu")
    pred = next(f.name for f in model.result_features
                if f.name != "survived")
    row = score(dict(titanic.SAMPLE_PASSENGER))[pred]
    assert row["prediction"] == ref_row["prediction"]
    for key in ("probability_0", "probability_1", "rawPrediction_1"):
        assert row[key] == pytest.approx(ref_row[key], abs=1e-9)
