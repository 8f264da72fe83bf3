"""The PyTorch port's explainability against the JAX package on the same
seeded numpy inputs (float64, CPU):

- ``feature_importances`` of the five tree model classes, each converted
  from a JAX fit (``models/convert.py``): exact;
- RecordInsightsLOCO on binary, multiclass and regression models: the
  TextMaps equal string for string, the per-group diffs within 1e-12;
- RecordInsightsCorr under Pearson and Spearman, min-max and z norms:
  correlations within 1e-12 and NaN where the JAX package has NaN,
  normalizers within 1e-12, the TextMaps equal; its model's constructor
  arguments and RecordInsightsLOCO round-trip through a save;
- one Titanic workflow per package (transmogrify, the SanityChecker, the
  raw feature filter, LR and a 3-round GBT): ``model_insights().to_json()``,
  ``summary()`` and ``summary_pretty()`` equal to the JAX package's after
  ``uid.reset(deterministic=True)`` in both (numbers within 1e-12, text
  exactly); ``compute_data_up_to`` and a save and reload of the insight
  stages."""
import json
import math

import numpy as np
import pytest
import torch

from examples import titanic as jax_titanic
from transmogrifai_tpu.checkers import RawFeatureFilter as JaxRFF
from transmogrifai_tpu.features.columns import FeatureColumn as JaxColumn
from transmogrifai_tpu.features.columns import (
    PredictionColumn as JaxPredictionColumn)
from transmogrifai_tpu.insights import RecordInsightsCorr as JaxCorr
from transmogrifai_tpu.insights import RecordInsightsLOCO as JaxLOCO
from transmogrifai_tpu.models import LogisticRegression as JaxLR
from transmogrifai_tpu.models import trees as jtrees
from transmogrifai_tpu.selector.factories import (
    BinaryClassificationModelSelector as JaxSelector)
from transmogrifai_tpu.utils.uid import reset as jax_reset
from transmogrifai_tpu.utils.vector_meta import (
    VectorColumnMetadata as JaxColumnMeta)
from transmogrifai_tpu.utils.vector_meta import VectorMetadata as JaxMeta
from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
from transmogrifai_tpu_torch.checkers import RawFeatureFilter
from transmogrifai_tpu_torch.examples import titanic
from transmogrifai_tpu_torch.features.columns import (FeatureColumn,
                                                      PredictionColumn)
from transmogrifai_tpu_torch.insights import (RecordInsightsCorr,
                                              RecordInsightsCorrModel,
                                              RecordInsightsLOCO,
                                              parse_insights)
from transmogrifai_tpu_torch.models import GBTClassifier, LogisticRegression
from transmogrifai_tpu_torch.models.convert import from_jax_model
from transmogrifai_tpu_torch.selector import BinaryClassificationModelSelector
from transmogrifai_tpu_torch.types import TextMap
from transmogrifai_tpu_torch.utils.uid import reset as port_reset
from transmogrifai_tpu_torch.utils.vector_meta import (VectorColumnMetadata,
                                                       VectorMetadata)
from transmogrifai_tpu_torch.workflow import Workflow, WorkflowModel

TOL = 1e-12
GROUPS = ("a", "a", "b", "c", "c", "c", "d")


def _design(n=160, d=len(GROUPS), seed=0, k=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    X[:, 3] = np.round(X[:, 3])                       # ties for ranks
    logit = X[:, 0] - 0.8 * X[:, 2] + 0.5 * X[:, 4]
    if k == 2:
        y = (logit + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    elif k > 2:
        y = np.digitize(logit, np.quantile(logit, [1 / 3, 2 / 3])) \
            .astype(np.float64)
    else:
        y = logit + 0.1 * rng.normal(size=n)
    return X, y


def _metas():
    cols = [dict(parent_feature_name=g, parent_feature_type="Real",
                 grouping=g, descriptor_value=f"v{i}")
            for i, g in enumerate(GROUPS)]
    return (JaxMeta(name="fv", columns=[JaxColumnMeta(**c) for c in cols]),
            VectorMetadata(name="fv",
                           columns=[VectorColumnMetadata(**c)
                                    for c in cols]))


# ---------------------------------------------------------------------------
# tree feature importances
# ---------------------------------------------------------------------------

TREE_FITS = {
    "GBTClassifierModel": (lambda: jtrees.GBTClassifier(num_rounds=4,
                                                        max_depth=3), 2),
    "GBTRegressorModel": (lambda: jtrees.GBTRegressor(num_rounds=4,
                                                      max_depth=3), 0),
    "GBTMulticlassClassifierModel": (
        lambda: jtrees.XGBoostClassifier(num_round=3, max_depth=3), 3),
    "TreeEnsembleClassifierModel": (
        lambda: jtrees.RandomForestClassifier(num_trees=4, max_depth=4), 2),
    "TreeEnsembleRegressorModel": (
        lambda: jtrees.RandomForestRegressor(num_trees=4, max_depth=4), 0),
}


@pytest.fixture(scope="module")
def tree_models():
    out = {}
    for name, (make, k) in TREE_FITS.items():
        X, y = _design(seed=1, k=k)
        jm = make().fit_arrays(X, y)
        assert type(jm).__name__ == name
        out[name] = (jm, from_jax_model(jm, device="cpu"), X, y)
    return out


@pytest.mark.parametrize("name", sorted(TREE_FITS))
def test_feature_importances_exact(tree_models, name):
    jm, pm, _, _ = tree_models[name]
    got, want = pm.feature_importances, jm.feature_importances
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert np.array_equal(got, want)
    assert got.shape == (len(GROUPS),) and math.isclose(got.sum(), 1.0)


def test_feature_importances_without_splits():
    """A tree with no real split (every threshold +inf) gives zeros."""
    jm = jtrees.GBTClassifierModel(
        feats=np.zeros((2, 3), np.int32), thrs=np.full((2, 3), np.inf),
        leaves=np.zeros((2, 4)), depth=2, n_features=5)
    pm = from_jax_model(jm, device="cpu")
    assert np.array_equal(pm.feature_importances, jm.feature_importances)
    assert not pm.feature_importances.any()


# ---------------------------------------------------------------------------
# LOCO
# ---------------------------------------------------------------------------

def _diffs(loco, X, meta):
    """The JAX stage's per-group diffs, from its own scoring method (the
    algorithm of its ``transform_columns``)."""
    out = loco.model.predict_arrays(X)
    base_cls = out.data if out.probability.shape[1] > 2 else None
    base = loco._score(X, base_cls)
    groups = loco._groups(meta, X.shape[1])
    diffs = np.zeros((X.shape[0], len(groups)))
    for g, (_, idxs) in enumerate(groups):
        Xz = X.copy()
        Xz[:, idxs] = 0.0
        diffs[:, g] = base - loco._score(Xz, base_cls)
    return diffs


@pytest.fixture(scope="module")
def loco_models(tree_models):
    X, y = _design(seed=2)
    lr = JaxLR(reg_param=0.01).fit_arrays(X, y)
    return {"lr": (lr, from_jax_model(lr, device="cpu")),
            "gbt": tree_models["GBTClassifierModel"][:2],
            "softmax": tree_models["GBTMulticlassClassifierModel"][:2],
            "regressor": tree_models["TreeEnsembleRegressorModel"][:2]}


@pytest.mark.parametrize("which", ["lr", "gbt", "softmax", "regressor"])
@pytest.mark.parametrize("top_k", [2, 20])
def test_loco_equals_jax(loco_models, which, top_k):
    jm, pm = loco_models[which]
    X, _ = _design(n=60, seed=9)
    jmeta, pmeta = _metas()
    jloco = JaxLOCO(model=jm, top_k=top_k)
    ploco = RecordInsightsLOCO(model=pm, top_k=top_k)
    want = jloco.transform_columns([JaxColumn.vector(X, jmeta)])
    got = ploco.transform_columns([FeatureColumn.vector(X, pmeta)])
    assert [v for v in got.data] == [v for v in want.data]
    assert all(len(v) == min(top_k, 4) for v in got.data)
    # the diffs behind them
    groups, diffs = ploco.group_diffs(FeatureColumn.vector(X, pmeta))
    assert [g for g, _ in groups] == list("abcd")
    np.testing.assert_allclose(diffs, _diffs(jloco, X, jmeta), rtol=0,
                               atol=TOL)


def test_loco_leaves_its_input_alone(loco_models):
    X, _ = _design(n=20, seed=3)
    col = FeatureColumn.vector(X.copy(), _metas()[1])
    RecordInsightsLOCO(model=loco_models["lr"][1]).transform_columns([col])
    assert np.array_equal(col.data, X)
    col = FeatureColumn.vector(torch.from_numpy(X.copy()), _metas()[1])
    RecordInsightsLOCO(model=loco_models["lr"][1]).transform_columns([col])
    assert torch.equal(col.data, torch.from_numpy(X))


def test_loco_requires_a_model():
    with pytest.raises(ValueError, match="fitted model"):
        RecordInsightsLOCO().transform_columns(
            [FeatureColumn.vector(np.zeros((2, 1)), VectorMetadata(
                name="v", columns=[VectorColumnMetadata("x", "Real")]))])


# ---------------------------------------------------------------------------
# Corr
# ---------------------------------------------------------------------------

def _corr_inputs(seed=4):
    X, y = _design(n=80, seed=seed)
    X[:, 6] = 2.0                                      # constant: NaN corr
    rng = np.random.default_rng(seed)
    p = 1 / (1 + np.exp(-(X[:, 0] + 0.2 * rng.normal(size=80))))
    prob = np.stack([1 - p, p], axis=1)
    jmeta, pmeta = _metas()
    return (X, prob,
            [JaxPredictionColumn.from_arrays((p > 0.5) * 1.0,
                                             probability=prob),
             JaxColumn.vector(X, jmeta)],
            [PredictionColumn.from_arrays((p > 0.5) * 1.0,
                                          probability=prob),
             FeatureColumn.vector(X, pmeta)])


@pytest.mark.parametrize("corr_type", ["pearson", "spearman"])
@pytest.mark.parametrize("norm", ["minmax", "znorm"])
def test_corr_equals_jax(corr_type, norm):
    _, _, jcols, pcols = _corr_inputs()
    kw = dict(top_k=3, norm_type=norm, correlation_type=corr_type)
    jm = JaxCorr(**kw).fit_columns(jcols)
    pm = RecordInsightsCorr(**kw).fit_columns(pcols)
    np.testing.assert_allclose(pm.score_corr, jm.score_corr, rtol=0,
                               atol=TOL)
    assert np.array_equal(np.isnan(pm.score_corr), np.isnan(jm.score_corr))
    assert np.isnan(pm.score_corr[:, 6]).all()
    for a in ("norm_shift", "norm_scale"):
        np.testing.assert_allclose(getattr(pm, a), getattr(jm, a), rtol=0,
                                   atol=TOL)
    got = pm.transform_columns(pcols)
    want = jm.transform_columns(jcols)
    assert list(got.data) == list(want.data)
    parsed = [parse_insights(TextMap(v)) for v in got.data]
    assert all(len(r) >= 3 for r in parsed)


def test_corr_model_round_trip():
    """The model's constructor arguments survive the persistence codec
    and give the same insights (the JAX package's own check)."""
    from transmogrifai_tpu_torch.workflow.persistence import (decode_value,
                                                              encode_value)
    _, _, _, pcols = _corr_inputs(seed=6)
    model = RecordInsightsCorr(top_k=4).fit_columns(pcols)
    arrays = {}
    enc = {k: encode_value(v, arrays, k)
           for k, v in model._ctor_args.items()}
    clone = RecordInsightsCorrModel(**{k: decode_value(v, arrays)
                                       for k, v in enc.items()})
    assert clone.metadata.columns[0].parent_feature_name == "a"
    assert list(clone.transform_columns(pcols).data) == \
        list(model.transform_columns(pcols).data)


def test_corr_validates_arguments():
    with pytest.raises(ValueError):
        RecordInsightsCorr(norm_type="l2")
    with pytest.raises(ValueError):
        RecordInsightsCorr(correlation_type="kendall")


# ---------------------------------------------------------------------------
# model insights, summaries, compute_data_up_to, persistence
# ---------------------------------------------------------------------------

LR_GRID = [{"reg_param": 0.01}, {"reg_param": 0.1}]
GBT_GRID = [{"max_depth": 3}]


@pytest.fixture(scope="module")
def trained():
    """The Titanic DAG behind the SanityChecker and the raw feature filter,
    LR and a 3-round GBT under 3-fold CV, once per package."""
    records = jax_titanic.synthetic_titanic(300, seed=11)
    train, test = jax_titanic.stratified_split(records)
    jax_reset(deterministic=True)
    label, vector = jax_titanic.build_features()
    sel = JaxSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, mesh=None,
        models=[(JaxLR(max_iter=30), LR_GRID),
                (jtrees.GBTClassifier(num_rounds=3), GBT_GRID)])
    pred = sel.set_input(label, vector.sanity_check(label)).get_output()
    ref = (JaxWorkflow().set_result_features(label, pred)
           .set_input_records(train)
           .with_raw_feature_filter(JaxRFF(), score_data=test)
           .train(validate="off"))
    port_reset(deterministic=True)
    plabel, pvector = titanic.build_features()
    psel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, device="cpu",
        models=[(LogisticRegression(max_iter=30, device="cpu"), LR_GRID),
                (GBTClassifier(num_rounds=3, device="cpu"), GBT_GRID)])
    ppred = psel.set_input(plabel, pvector.sanity_check(plabel)).get_output()
    got = (Workflow(device="cpu").set_result_features(plabel, ppred)
           .set_input_records(train)
           .with_raw_feature_filter(RawFeatureFilter(), score_data=test)
           .train())
    return {"ref": ref, "got": got, "test": test, "vector": pvector,
            "ref_vector": vector, "prediction": ppred}


def _assert_close(a, b, path="$"):
    """Equal JSON documents, numbers within TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _assert_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, (int, float)) \
            and not isinstance(b, bool):
        assert (math.isnan(a) and math.isnan(b)) or \
            abs(a - b) <= TOL * max(1.0, abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_model_insights_equal_jax(trained):
    got = trained["got"].model_insights()
    want = trained["ref"].model_insights()
    doc = got.to_json()
    _assert_close(doc, want.to_json())
    assert got.selected_model["bestModelName"] in ("LogisticRegression",
                                                   "GBTClassifier")
    dropped = [d for f in got.features for d in f.derived if d.is_dropped]
    assert dropped and all(d.dropped_reasons for d in dropped)
    assert any(f.distributions for f in got.features)
    assert any(d.contribution for f in got.features for d in f.derived)


def test_summaries_equal_jax(trained):
    _assert_close(json.loads(trained["got"].summary()),
                  json.loads(trained["ref"].summary()))
    assert trained["got"].summary_pretty() == \
        trained["ref"].summary_pretty()
    assert trained["got"].model_insights().pretty() in \
        trained["got"].summary_pretty()


def test_compute_data_up_to(trained):
    got = trained["got"].compute_data_up_to(trained["vector"],
                                            trained["test"])
    want = trained["ref"].compute_data_up_to(trained["ref_vector"],
                                             trained["test"])
    name = trained["vector"].name
    assert got.n_rows == want.n_rows == len(trained["test"])
    np.testing.assert_allclose(np.asarray(got[name].data),
                               np.asarray(want[trained["ref_vector"].name]
                                          .data), rtol=0, atol=TOL)
    assert trained["prediction"].name not in got.column_names
    with pytest.raises(KeyError, match="not part of this workflow"):
        from transmogrifai_tpu_torch.features.builder import FeatureBuilder
        trained["got"].compute_data_up_to(
            FeatureBuilder.real("zz").extract(lambda r: 1.0)
            .as_predictor(), trained["test"])


def test_insight_stages_save_and_reload(trained, tmp_path):
    """A workflow whose results are the LOCO and Corr insights of the
    trained model saves and reloads through the JAX package's layout;
    the reloaded stages give the same TextMaps."""
    model = trained["got"]
    prediction = model._resolve(trained["prediction"])
    selected = prediction.origin_stage
    checked = selected.input_features[1]
    loco = RecordInsightsLOCO(model=selected, top_k=3).set_input(
        checked).get_output()
    corr = RecordInsightsCorr(top_k=2).set_input(prediction, checked)
    data = model.compute_data_up_to(prediction, trained["test"])
    corr_model = corr.fit(data)
    corr_out = corr_model.get_output()
    wm = WorkflowModel(result_features=(loco, corr_out))
    wm.save(str(tmp_path / "m"))
    back = WorkflowModel.load(str(tmp_path / "m"), device="cpu")
    doc = json.load(open(tmp_path / "m" / "op-model.json"))
    names = {s["className"] for s in doc["stages"]}
    assert {"RecordInsightsLOCO", "RecordInsightsCorrModel"} <= names
    for f in (loco, corr_out):
        new = back._resolve(f)
        cols = [data[p.name] for p in f.origin_stage.input_features]
        new_cols = [data[p.name] for p in new.origin_stage.input_features]
        assert list(new.origin_stage.transform_columns(new_cols).data) == \
            list(f.origin_stage.transform_columns(cols).data)
