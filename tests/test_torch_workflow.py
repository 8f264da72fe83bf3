"""The Titanic workflow, run by the JAX package and by the PyTorch port
(float64, CPU) on the same synthetic records and the same stratified
75/25 split, each trained once: the prepared matrix (shape, column
metadata, bitwise indicator / one-hot / hash / integer columns, float
columns within 1e-12), the selector's (folds, grid) metric matrix within
1e-9 and its winner, the holdout scores and metrics of
``score_and_evaluate`` within 1e-9, and the port's selector receiving the
prepared matrix as a tensor on the workflow's device."""
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
from transmogrifai_tpu.selector.factories import (
    BinaryClassificationModelSelector as JaxSelector)
from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
from transmogrifai_tpu_torch.examples import titanic
from transmogrifai_tpu_torch.models import GBTClassifier, LogisticRegression
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, ModelSelector, SelectedModel)
from transmogrifai_tpu_torch.utils import uid as torch_uid
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
    ref = (JaxWorkflow().set_result_features(label, prediction)
           .set_input_records(train).train(validate="off"))
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

    with mock.patch.object(ModelSelector, "fit_arrays", spy):
        got = titanic.run(records, device="cpu", model_stage=selector)
    return {"ref": ref, "ref_vector": vector, "ref_prediction": prediction,
            "ref_scored": ref_scored, "ref_metrics": ref_metrics,
            "got": got, "seen": seen, "test": test}


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
