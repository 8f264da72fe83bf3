"""The Titanic workflow, run by the JAX package and by the PyTorch port
(float64, CPU) on the same synthetic records and the same stratified
75/25 split, each trained once: the prepared matrix (shape, column
metadata, bitwise indicator / one-hot / hash / integer columns, float
columns within 1e-12), the selector's (folds, grid) metric matrix within
1e-9 and its winner, the holdout scores and metrics of
``score_and_evaluate`` within 1e-9, and the port's selector receiving the
prepared matrix as a tensor on the workflow's device. Then each package
saves its model and reloads it: the two saved documents have one layout,
and the served records agree within 1e-9. Both trains report to a
listener, whose stage rows must agree."""
import json
import os
import re
import unittest.mock as mock

import numpy as np
import pytest
import torch

from examples import titanic as jax_titanic
from transmogrifai_tpu.evaluators import (
    BinaryClassificationEvaluator as JaxEvaluator)
from transmogrifai_tpu.models import LogisticRegression as JaxLR
from transmogrifai_tpu.models.trees import GBTClassifier as JaxGBT
from transmogrifai_tpu.selector import SelectedModel as JaxSelected
from transmogrifai_tpu.local import load_score_function as jax_load_score
from transmogrifai_tpu.selector import validator as jax_validator
from transmogrifai_tpu.selector.factories import (
    BinaryClassificationModelSelector as JaxSelector)
from transmogrifai_tpu.selector.selector import (
    models_x_folds as jax_models_x_folds)
from transmogrifai_tpu.utils.listener import (
    WorkflowListener as JaxListener)
from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
from transmogrifai_tpu_torch.examples import titanic
from transmogrifai_tpu_torch.local import load_score_function
from transmogrifai_tpu_torch.models import GBTClassifier, LogisticRegression
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, ModelSelector, SelectedModel,
    models_x_folds, validator)
from transmogrifai_tpu_torch.utils import uid as torch_uid
from transmogrifai_tpu_torch.utils.listener import WorkflowListener
from transmogrifai_tpu_torch.workflow import Workflow

LR_GRID = [{"reg_param": 0.01}, {"reg_param": 0.1}]
GBT_GRID = [{"max_depth": 3}]
#: RealVectorizer value columns of Real / RealNN parents: means, sums and
#: z-scores, whose last bits depend on the order of a reduction
FLOAT_PARENTS = ("Real", "RealNN")


def _norm(s):
    """A name with its 12-hex stage uids masked (the two packages count
    uids separately)."""
    return None if s is None else re.sub(r"[0-9a-f]{12}", "UID", s)


def _metas(meta):
    return [(_norm(c.parent_feature_name), c.parent_feature_type,
             _norm(c.grouping), c.indicator_value, c.descriptor_value)
            for c in meta.columns]


def _selected(model, cls):
    return next(s for s in model.stages() if isinstance(s, cls))


def _matrix(selected):
    return np.array([r.metric_values
                     for r in selected.summary.validation_results]).T


@pytest.fixture(scope="module")
def trained():
    records = jax_titanic.synthetic_titanic(300, seed=11)
    train, test = jax_titanic.stratified_split(records)

    label, vector = jax_titanic.build_features()
    selector = JaxSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, mesh=None,
        models=[(JaxLR(max_iter=30), LR_GRID),
                (JaxGBT(num_rounds=3), GBT_GRID)])
    prediction = selector.set_input(label, vector).get_output()
    ref_listener = JaxListener()
    jax_validator.reset_family_profile()
    ref = (JaxWorkflow().set_result_features(label, prediction)
           .set_input_records(train).with_listener(ref_listener)
           .train(validate="off"))
    ref_families = jax_validator.family_profile()
    ref_scored, ref_metrics = ref.score_and_evaluate(
        test, JaxEvaluator(label_col="survived",
                           prediction_col=prediction.name))

    torch_uid.reset(deterministic=True)
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, device="cpu",
        models=[(LogisticRegression(max_iter=30, device="cpu"), LR_GRID),
                (GBTClassifier(num_rounds=3, device="cpu"), GBT_GRID)])
    seen = {}
    real = ModelSelector.fit_arrays

    def spy(self, X, y):
        seen["X"] = X
        return real(self, X, y)

    listener = WorkflowListener()
    validator.reset_family_profile()
    with mock.patch.object(ModelSelector, "fit_arrays", spy):
        got = titanic.run(records, device="cpu", model_stage=selector,
                          listener=listener)
    return {"ref": ref, "ref_vector": vector, "ref_prediction": prediction,
            "ref_scored": ref_scored, "ref_metrics": ref_metrics,
            "got": got, "seen": seen, "test": test,
            "ref_listener": ref_listener, "listener": listener,
            "ref_families": ref_families,
            "families": validator.family_profile()}


@pytest.fixture(scope="module")
def saved(trained, tmp_path_factory):
    """Each package's model saved by its ``demo_serve`` (which reloads it
    in its own package and serves ``SAMPLE_PASSENGER``); the JAX save
    without its AOT export and plan fingerprint, which only add files."""
    root = tmp_path_factory.mktemp("saved")
    ref_path, got_path = str(root / "jax"), str(root / "port")
    with mock.patch.dict(os.environ, {"TX_AOT_EXPORT": "off",
                                      "TX_PLAN_FINGERPRINT": "off"}):
        ref_row = jax_titanic.demo_serve(trained["ref"], ref_path)
    got_row = titanic.demo_serve(trained["got"].model, got_path,
                                 device="cpu")
    return {"ref_path": ref_path, "got_path": got_path,
            "ref_row": ref_row, "got_row": got_row}


def test_split_is_the_examples(trained):
    records = jax_titanic.synthetic_titanic(60, seed=3)
    assert titanic.stratified_split(records) == \
        jax_titanic.stratified_split(records)


def test_prepared_matrix_matches_jax(trained):
    ref_col = trained["ref"].train_dataset[trained["ref_vector"].name]
    got_col = trained["got"].model.train_dataset[trained["got"].vector.name]
    assert isinstance(got_col.data, torch.Tensor)
    assert got_col.data.dtype == torch.float64
    a = np.asarray(ref_col.data, dtype=np.float64)
    b = got_col.data.numpy()
    assert a.shape == b.shape and a.shape[0] == 225 and a.shape[1] > 500
    metas = _metas(got_col.metadata)
    assert metas == _metas(ref_col.metadata)
    floats = np.array([m[1] in FLOAT_PARENTS and m[3] is None
                       for m in metas])
    assert 0 < floats.sum() < 10
    np.testing.assert_array_equal(b[:, ~floats], a[:, ~floats])
    np.testing.assert_allclose(b[:, floats], a[:, floats], rtol=1e-12,
                               atol=1e-12)


def test_selector_received_a_device_tensor(trained):
    X = trained["seen"]["X"]
    assert isinstance(X, torch.Tensor)
    assert X.device == trained["got"].workflow.device
    got_col = trained["got"].model.train_dataset[trained["got"].vector.name]
    assert X.shape[1] == got_col.data.shape[1]


def test_metric_matrix_and_winner_match_jax(trained):
    ref = _selected(trained["ref"], JaxSelected)
    got = _selected(trained["got"].model, SelectedModel)
    a, b = _matrix(ref), _matrix(got)
    assert a.shape == b.shape == (3, 3)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-9)
    assert got.summary.best_model_name == ref.summary.best_model_name
    assert got.summary.best_model_params == ref.summary.best_model_params


def test_holdout_scores_and_metrics_match_jax(trained):
    name_ref = trained["ref_prediction"].name
    name_got = trained["got"].prediction.name
    a = trained["ref_scored"][name_ref]
    b = trained["got"].scored[name_got]
    assert b.n_rows == len(trained["test"]) == 75
    np.testing.assert_array_equal(b.data, a.data)
    np.testing.assert_allclose(b.probability, a.probability, rtol=0,
                               atol=1e-9)
    for metric in ("AuPR", "AuROC", "F1", "Error"):
        assert abs(getattr(trained["got"].metrics, metric)
                   - getattr(trained["ref_metrics"], metric)) <= 1e-9


def test_plan_records_host_stages(trained):
    """The stages without a device kernel, and the prediction column, run
    on the host and are recorded with the reason; the vectorizer models,
    the DSL stages and the combiner run on the device."""
    plan = trained["got"].workflow.last_prepare_plan
    host = {label.split("(")[0]: why for label, why in
            plan.coverage.fallback}
    assert set(host) == {"LambdaTransformer", "AliasTransformer",
                         "SmartTextVectorizerModel", "SelectedModel"}
    assert "no array kernel" in host["SmartTextVectorizerModel"]
    lowered = {label.split("(")[0] for label in plan.coverage.lowered}
    assert {"OneHotVectorizerModel", "RealVectorizerModel",
            "VectorsCombiner", "StandardScalerModel",
            "FillMissingWithMeanModel", "NumericBinaryTransformer"} <= lowered
    where = {label.split("(")[0]: w for label, w, _ in plan.fit_placements}
    assert where["ModelSelector"] == "device"
    assert where["StandardScaler"] == "host"


def test_selector_on_another_device_raises(trained):
    """A selector computing elsewhere than the workflow is refused before
    any data moves."""
    label, vector = titanic.build_features()
    sel = BinaryClassificationModelSelector.with_cross_validation(
        device="cpu", models=[(LogisticRegression(device="cpu"), LR_GRID)])
    pred = sel.set_input(label, vector).get_output()
    sel.device = torch.device("cuda", 0)
    wf = Workflow(device="cpu").set_result_features(label, pred)
    with pytest.raises(ValueError, match="computes on cuda:0"):
        wf.set_input_records(trained["test"]).train()


def test_failing_device_kernel_propagates():
    """A stage whose device kernel raises fails the train: it is not
    moved to its host path."""
    from transmogrifai_tpu_torch.features import FeatureBuilder
    from transmogrifai_tpu_torch.ops import NumericScalarTransformer

    class Broken(NumericScalarTransformer):
        def transform_arrays(self, arrays):
            raise RuntimeError("kernel failed")

    x = FeatureBuilder.real("x").extract(lambda r: r["x"]).as_predictor()
    out = Broken(op="add", scalar=1.0).set_input(x).get_output()
    wf = Workflow(device="cpu").set_result_features(out)
    with pytest.raises(RuntimeError, match="kernel failed"):
        wf.set_input_records([{"x": 1.0}, {"x": None}]).train()


def test_dataset_input_matches_records(trained):
    """``set_input_dataset`` with the raw columns gives the matrix that
    ``set_input_records`` gives; scoring without the label works."""
    from transmogrifai_tpu_torch.features import Dataset
    records = trained["test"]
    label, vector = titanic.build_features()
    raw = Workflow(device="cpu").set_result_features(label, vector)
    a = raw.set_input_records(records).train()
    ds = Dataset({f.name: f.origin_stage.extract_column(records)
                  for f in raw.raw_features()})
    b = raw.set_input_dataset(ds).train()
    assert torch.equal(a.train_dataset[vector.name].data,
                       b.train_dataset[vector.name].data)
    unlabeled = [{k: v for k, v in r.items() if k != "survived"}
                 for r in records]
    scored = a.score(unlabeled)
    assert np.isnan(scored["survived"].data).all()
    assert scored[vector.name].data.shape == \
        a.train_dataset[vector.name].data.shape


def _assert_rows_close(got: dict, ref: dict, atol: float = 1e-9) -> None:
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=atol), k


def test_demo_serve_matches_jax(saved):
    assert titanic.SAMPLE_PASSENGER == jax_titanic.SAMPLE_PASSENGER
    assert "probability_1" in saved["got_row"]
    _assert_rows_close(saved["got_row"], saved["ref_row"])


def test_served_holdout_matches_jax_and_score(trained, saved):
    """Each holdout record served alone from the reloaded port model
    equals the JAX package's ``ScoreFunction`` and the port's batch
    ``model.score``."""
    ref_fn = jax_load_score(saved["ref_path"])
    got_fn = load_score_function(saved["got_path"], device="cpu")
    name_ref = trained["ref_prediction"].name
    name_got = trained["got"].prediction.name
    batch = trained["got"].scored[name_got]
    for i, record in enumerate(trained["test"]):
        got = got_fn(dict(record))[name_got]
        _assert_rows_close(got, ref_fn(dict(record))[name_ref])
        _assert_rows_close(got, dict(batch.boxed(i).value), atol=1e-12)


def _doc(path):
    with open(os.path.join(path, "op-model.json")) as fh:
        doc = json.load(fh)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {_norm(k): z[k] for k in z.files}
    return doc, arrays


def _same(a, b, where="doc"):
    """Equal JSON values, strings compared with uids masked and numbers
    within 1e-9."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, str):
        assert _norm(a) == _norm(b), where
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=1e-9), where
    else:
        assert a == b, where


def test_saved_layout_matches_jax(saved):
    """One layout: stage classes in order, constructor keys, array keys
    and shapes, the model arrays within 1e-9, the selector summary; the
    port writes no device."""
    ref, ref_arrays = _doc(saved["ref_path"])
    got, got_arrays = _doc(saved["got_path"])
    assert set(got) == set(ref)
    assert got["formatVersion"] == ref["formatVersion"]
    assert [s["className"] for s in got["stages"]] == \
        [s["className"] for s in ref["stages"]]
    for gs, rs in zip(got["stages"], ref["stages"]):
        assert set(gs["ctorArgs"]) == set(rs["ctorArgs"]), gs["className"]
        assert "device" not in json.dumps(gs["ctorArgs"])
    assert {k: v.shape for k, v in got_arrays.items()} == \
        {k: v.shape for k, v in ref_arrays.items()}
    for k, v in ref_arrays.items():
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got_arrays[k], v, rtol=0, atol=1e-9,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got_arrays[k], v, err_msg=k)
    sel = [(gs, rs) for gs, rs in zip(got["stages"], ref["stages"])
           if gs["className"] == "SelectedModel"]
    assert len(sel) == 1
    gs, rs = sel[0]
    _same(gs["ctorArgs"]["summary"]["$selsummary"],
          rs["ctorArgs"]["summary"]["$selsummary"])
    assert gs["ctorArgs"]["inner"]["$stage"]["className"] == \
        rs["ctorArgs"]["inner"]["$stage"]["className"]


def test_listener_matches_jax(trained):
    """The same stage rows (name, phase, rows), models x folds and
    searched families as the JAX package's listener and profile."""
    def rows(listener):
        return sorted((_norm(m.stage_name), m.phase, m.n_rows)
                      for m in listener.metrics.stage_metrics)
    got, ref = rows(trained["listener"]), rows(trained["ref_listener"])
    assert got == ref and len(got) > 10
    assert trained["listener"].metrics.end_time is not None
    assert trained["listener"].metrics.fault_events == []
    assert "Stage profile" in \
        trained["listener"].metrics.profile_pretty(top=3)
    assert models_x_folds(trained["got"].model) == \
        jax_models_x_folds(trained["ref"]) == 9
    assert [r["family"] for r in trained["families"]] and \
        sorted(r["family"] for r in trained["families"]) == \
        sorted(r["family"] for r in trained["ref_families"])
    assert all(r["calls"] >= 1 for r in trained["families"])
