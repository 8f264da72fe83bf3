"""The workflow over every ``transmogrify`` feature family
(``examples/families.py``: the JAX package's family DAG of
``tests/test_scoring_plan.py`` with a geolocation, ``blurb.tokenize()``
and the two bucketizers) run by the JAX package and by the PyTorch port
(float64, CPU) on the same 400 testkit records and the same stratified
75/25 split, each trained once with a two-family search (LR and GBT):

- the prepared matrix: shape, column metadata, every column bitwise
  except the ones computed in floating point on the device (unit-circle
  sin and cos, means) within 1e-12;
- the (folds, grid) metric matrix within 1e-12 and the same winner;
- the compiled plan against the columnar path at batch sizes 1, 7, 8, 9
  and 400 within 1e-9, with every new device stage in the plan;
- a save, a reload and one served record against the JAX package's
  ``model.score`` within 1e-9."""
import os
import re

import numpy as np
import pytest
import torch

import transmogrifai_tpu.features.builder as jb
import transmogrifai_tpu.ops as jops
import transmogrifai_tpu.types as jtypes
from transmogrifai_tpu.models import LogisticRegression as JaxLR
from transmogrifai_tpu.models.trees import GBTClassifier as JaxGBT
from transmogrifai_tpu.selector import SelectedModel as JaxSelected
from transmogrifai_tpu.selector.factories import (
    BinaryClassificationModelSelector as JaxSelector)
from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
from transmogrifai_tpu_torch.examples import families
from transmogrifai_tpu_torch.examples.titanic import stratified_split
from transmogrifai_tpu_torch.local import load_score_function
from transmogrifai_tpu_torch.models import GBTClassifier, LogisticRegression
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, SelectedModel)
from transmogrifai_tpu_torch.serving import ScoringPlan
from transmogrifai_tpu_torch.utils import uid as torch_uid

RECORDS = 400
LR_GRID = [{"reg_param": 0.01}, {"reg_param": 0.1}]
GBT_GRID = [{"max_depth": 3}]
#: columns computed in floating point: the unit-circle projections (sin
#: and cos on each package's device) and the mean-filled reals
FLOAT_DESCRIPTORS = re.compile(r"^(sin|cos)")
FLOAT_PARENTS = ("Real", "RealMap")


def _norm(s):
    return None if s is None else re.sub(r"[0-9a-f]{12}", "UID", s)


def _metas(meta):
    return [(_norm(c.parent_feature_name), c.parent_feature_type,
             _norm(c.grouping), c.indicator_value, c.descriptor_value)
            for c in meta.columns]


def _jax_dag():
    """The example's DAG built from the JAX package's classes."""
    raw = {name: jb.FeatureBuilder.of(name, getattr(jtypes, ftype.__name__))
           .extract(lambda r, k=name: r.get(k)).as_predictor()
           for name, (ftype, _) in families.family_generators().items()}
    raw["geo"] = jb.FeatureBuilder.of("geo", jtypes.Geolocation).extract(
        lambda r: r.get("geo")).as_predictor()
    label = jb.FeatureBuilder.of("label", jtypes.RealNN).extract(
        lambda r: r.get("label")).as_response()
    tokens = raw["blurb"].tokenize()
    auto = raw["real"].auto_bucketize(label)
    fixed = raw["integral"].bucketize(list(families.BUCKET_SPLITS))
    vector = jops.transmogrify(list(raw.values()) + [tokens, auto, fixed])
    return label, vector


def _selected(model, cls):
    return next(s for s in model.stages() if isinstance(s, cls))


def _matrix(selected):
    return np.array([r.metric_values
                     for r in selected.summary.validation_results]).T


@pytest.fixture(scope="module")
def trained():
    records = families.synthetic_families(RECORDS)
    train, test = stratified_split(records, label_key="label")
    label, vector = _jax_dag()
    selector = JaxSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, mesh=None,
        models=[(JaxLR(max_iter=30), LR_GRID),
                (JaxGBT(num_rounds=3), GBT_GRID)])
    prediction = selector.set_input(label, vector).get_output()
    ref = (JaxWorkflow().set_result_features(label, prediction)
           .set_input_records(train).train(validate="off"))

    torch_uid.reset(deterministic=True)
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, device="cpu",
        models=[(LogisticRegression(max_iter=30, device="cpu"), LR_GRID),
                (GBTClassifier(num_rounds=3, device="cpu"), GBT_GRID)])
    got = families.run(records, device="cpu", model_stage=selector)
    return {"ref": ref, "ref_vector": vector, "ref_prediction": prediction,
            "got": got, "test": test}


def test_prepared_matrix_matches_jax(trained):
    ref_col = trained["ref"].train_dataset[trained["ref_vector"].name]
    got_col = trained["got"].model.train_dataset[trained["got"].vector.name]
    assert isinstance(got_col.data, torch.Tensor)
    a = np.asarray(ref_col.data, dtype=np.float64)
    b = got_col.data.numpy()
    assert a.shape == b.shape == (300, b.shape[1]) and b.shape[1] > 1000
    metas = _metas(got_col.metadata)
    assert metas == _metas(ref_col.metadata)
    parents = {m[1] for m in metas}
    assert {"Date", "DateList", "Geolocation", "TextList", "RealMap",
            "PickListMap", "MultiPickListMap", "DateMap", "Real",
            "Integral"} <= parents
    floats = np.array([m[3] is None and (
        bool(FLOAT_DESCRIPTORS.match(m[4] or ""))
        or m[1] in FLOAT_PARENTS) for m in metas])
    assert 0 < floats.sum() < 20
    np.testing.assert_array_equal(b[:, ~floats], a[:, ~floats])
    np.testing.assert_allclose(b[:, floats], a[:, floats], rtol=1e-12,
                               atol=1e-12)


def test_plan_runs_the_new_device_stages(trained):
    """The new families' device kernels run in the prepare plan; the
    tokenizer, the hashing, the date-list pivots and the bucketizers run
    on the host, recorded with their reason."""
    plan = trained["got"].workflow.last_prepare_plan
    lowered = {label.split("(")[0] for label in plan.coverage.lowered}
    assert {"DateToUnitCircleVectorizer", "GeolocationVectorizerModel",
            "RealMapVectorizerModel", "TextMapPivotVectorizerModel",
            "_MultiPickListMapModel", "DateMapToUnitCircleVectorizerModel",
            "VectorsCombiner"} <= lowered
    host = {label.split("(")[0]: why for label, why in
            plan.coverage.fallback}
    assert {"TextTokenizer", "TextListHashVectorizer", "DateListVectorizer",
            "DecisionTreeNumericBucketizerModel", "NumericBucketizer",
            "SmartTextVectorizerModel", "SelectedModel"} == set(host)
    assert all("no array kernel" in why for name, why in host.items()
               if name != "SelectedModel")


def test_metric_matrix_and_winner_match_jax(trained):
    ref = _selected(trained["ref"], JaxSelected)
    got = _selected(trained["got"].model, SelectedModel)
    a, b = _matrix(ref), _matrix(got)
    assert a.shape == b.shape == (3, 3)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
    assert got.summary.best_model_name == ref.summary.best_model_name
    assert got.summary.best_model_params == ref.summary.best_model_params


@pytest.mark.parametrize("n", [1, 7, 8, 9, 400])
def test_compiled_equals_columnar(trained, n):
    """The compiled plan (every device stage in one program at the
    bucket's rows) against the columnar path, at batch sizes around the
    smallest bucket and a whole batch of fresh records."""
    model, name = trained["got"].model, trained["got"].prediction.name
    batch = families.synthetic_families(n, seed0=999)
    truth = model.score(batch)[name]
    comp = model.score(batch, engine="compiled")[name]
    np.testing.assert_allclose(comp.data, truth.data, rtol=0, atol=1e-9)
    np.testing.assert_allclose(comp.probability, truth.probability, rtol=0,
                               atol=1e-9)
    plan = model.scoring_plan()
    lowered = {label.split("(")[0] for label in plan.coverage.lowered}
    assert {"DateToUnitCircleVectorizer", "GeolocationVectorizerModel",
            "RealMapVectorizerModel", "TextMapPivotVectorizerModel",
            "_MultiPickListMapModel",
            "DateMapToUnitCircleVectorizerModel"} <= lowered
    assert plan.fallbacks() == 6


def test_saved_and_served_matches_jax(trained, tmp_path):
    """The port's model saved, reloaded on the CPU and serving one record
    gives the JAX package's ``model.score`` row; the reloaded bucketizer
    keeps its infinite outer split points."""
    path = str(tmp_path / "model")
    trained["got"].model.save(path)
    with open(os.path.join(path, "op-model.json")) as fh:
        assert "-Infinity" in fh.read()
    record = dict(trained["test"][0])
    served = load_score_function(path, device="cpu")(record)
    got = served[trained["got"].prediction.name]
    ref_scored = trained["ref"].score([record])
    ref = dict(ref_scored[trained["ref_prediction"].name].boxed(0).value)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-9), k
    plan = ScoringPlan(load_score_function(path, device="cpu").model)
    assert plan.compile().fallbacks() == 6


def test_failing_family_kernel_raises_by_name(trained, monkeypatch):
    """A new stage whose device part fails stops the plan with a
    PlanCompileError naming the stage: nothing carries on on the host."""
    from transmogrifai_tpu_torch.ops.maps import RealMapVectorizerModel
    from transmogrifai_tpu_torch.serving import PlanCompileError

    def broken(self, arrays):
        raise RuntimeError("kernel failed")
    monkeypatch.setattr(RealMapVectorizerModel, "transform_arrays", broken)
    with pytest.raises(PlanCompileError, match="RealMapVectorizerModel"):
        ScoringPlan(trained["got"].model).compile()
