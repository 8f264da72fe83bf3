"""The Iris and Boston examples of the PyTorch port against the JAX
package's ``examples/iris.py`` and ``examples/boston.py``, in float64 on
the CPU, on the same 600 synthetic records: both workflows (typed
features, transmogrify, the selector's holdout cut, the search, the
winner's refit and holdout evaluation) with the example's pool at test
size (forests at 3 trees under replayed draws, boosters at 3 rounds,
every grid whole): each family's fold x grid metrics, the winner and the
holdout metrics equal the JAX package's; the port's model saved,
reloaded and scored record by record, in batch and through the compiled
plan within 1e-9 of the JAX package's ``model.score``; the selector
summary, with the splitter's record and the new metric classes, survives
the round trip."""
import numpy as np
import pytest

from test_torch_forest import JaxDraws
from transmogrifai_tpu.models import registry as jax_registry
from transmogrifai_tpu.selector import splitters as jsp
from transmogrifai_tpu_torch.examples import boston, iris
from transmogrifai_tpu_torch.local import load_score_function
from transmogrifai_tpu_torch.workflow.persistence import load_model

#: test-size forests and boosters
TREES, ROUNDS = 3, 3
RECORDS = 600


def _cut(est, port: bool):
    """``est`` with its trees or rounds cut to test size (a port forest
    replays the JAX package's draws)."""
    name = type(est).__name__
    if name.startswith("RandomForest"):
        kw = {"num_trees": TREES}
        if port:
            kw["draws"] = JaxDraws
        return est.with_params(**kw)
    if name.startswith("XGBoost"):
        return est.with_params(num_round=ROUNDS)
    if name.startswith("GBT"):
        return est.with_params(num_rounds=ROUNDS)
    return est


def _jax_workflow(example, selector_cls, splitter, pool, records):
    """The JAX example's DAG and selector (``mesh=None``, one program per
    tree family: ``TX_TREE_DEPTH=mask``, which gives the static mode's
    metrics) trained on ``records``."""
    from transmogrifai_tpu.ops import transmogrify
    from transmogrifai_tpu.workflow import Workflow
    feats, label = example.build_features()
    sel = selector_cls.with_cross_validation(
        num_folds=3, seed=42, mesh=None, splitter=splitter,
        models=[(_cut(e, False), g) for e, g in pool])
    pred = sel.set_input(label, transmogrify(feats)).get_output()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TX_TREE_DEPTH", "mask")
        model = (Workflow().set_result_features(pred)
                 .set_input_records(records).train())
    return model, pred


@pytest.fixture(scope="module", params=["iris", "boston"])
def runs(request):
    """(name, records, JAX model, JAX prediction feature, port run)."""
    from examples import boston as jboston
    from examples import iris as jiris
    from transmogrifai_tpu.selector import (
        MultiClassificationModelSelector, RegressionModelSelector)
    if request.param == "iris":
        records = iris.synthetic_iris(RECORDS, seed=3)
        pool = (jax_registry.default_multiclass_models()
                + jax_registry.default_multiclass_extra_models()[:1])
        jmodel, jpred = _jax_workflow(
            jiris, MultiClassificationModelSelector,
            jsp.DataCutter(reserve_test_fraction=0.2, seed=42), pool,
            records)
        example = iris
    else:
        records = boston.synthetic_boston(RECORDS, seed=3)
        jmodel, jpred = _jax_workflow(
            jboston, RegressionModelSelector,
            jsp.DataSplitter(reserve_test_fraction=0.2, seed=42),
            jax_registry.default_regression_models(), records)
        example = boston
    models = [(_cut(e, True), g)
              for e, g in example.default_selector("cpu").models]
    run = example.run(records, device="cpu", models=models)
    return request.param, records, jmodel, jpred, run


def _summaries(runs):
    _, _, jmodel, _, run = runs
    return (jmodel.result_features[0].origin_stage.summary,
            run.model.result_features[0].origin_stage.summary)


#: family -> tolerance of its fold x grid metrics against the JAX
#: package's (the linear solvers' float64 roundings differ; the trees'
#: and NaiveBayes's sums are the JAX package's)
TOL = {"LogisticRegression": 1e-6, "LinearRegression": 1e-9,
       "GeneralizedLinearRegression": 1e-9}


def test_pool_matches_the_examples(runs):
    name, _, _, _, _ = runs
    ref, got = _summaries(runs)
    families = list(dict.fromkeys(r.model_name
                                  for r in got.validation_results))
    assert families == list(dict.fromkeys(r.model_name
                                          for r in ref.validation_results))
    if name == "iris":
        assert families == list(iris.IRIS_FAMILIES)
        assert len(got.validation_results) == 54
        assert got.problem_type == "MultiClassification"
    else:
        assert families == ["LinearRegression", "RandomForestRegressor",
                            "GBTRegressor", "GeneralizedLinearRegression"]
        assert len(got.validation_results) == 50
        assert got.problem_type == "Regression"


def test_search_matches_jax(runs):
    """Each candidate's fold metrics: 1e-12 for trees and NaiveBayes,
    1e-6 for the multinomial LR, 1e-9 for LinearRegression and the GLM
    (relative for RMSE)."""
    name = runs[0]
    ref, got = _summaries(runs)
    assert len(ref.validation_results) == len(got.validation_results)
    for a, b in zip(ref.validation_results, got.validation_results):
        assert (a.model_name, a.params) == (b.model_name, b.params)
        tol = TOL.get(a.model_name, 1e-12)
        np.testing.assert_allclose(
            b.metric_values, a.metric_values,
            rtol=tol if name == "boston" else 0,
            atol=0 if name == "boston" else tol,
            err_msg=f"{a.model_name} {a.params}")


def test_winner_and_holdout_match_jax(runs):
    """The JAX package's winner and its holdout metrics (within 1e-9)."""
    ref, got = _summaries(runs)
    assert (got.best_model_name, got.best_model_params) == (
        ref.best_model_name, ref.best_model_params)
    assert got.metric_larger_better == ref.metric_larger_better
    assert got.data_prep_results == ref.data_prep_results
    for k, v in ref.holdout_evaluation.to_json().items():
        if isinstance(v, float):
            assert abs(getattr(got.holdout_evaluation, k) - v) <= 1e-9 * max(
                1.0, abs(v)), k


def test_pretty_ranks_winner_first(runs):
    """The summary lists the winner first, by the metric's direction
    (RMSE smaller better)."""
    _, got = _summaries(runs)
    lines = got.pretty().splitlines()
    assert lines[3].strip().startswith(
        f"{got.best_model_name}[") and str(got.best_model_params) in lines[3]


def test_save_serve_and_compiled_scores_match_jax(runs, tmp_path):
    """The port's model saved and reloaded on the CPU: its summary JSON
    unchanged; the holdout scored in batch and through the compiled plan,
    and records served one at a time, within 1e-9 of the JAX package's
    ``model.score``."""
    name, _, jmodel, jpred, run = runs
    holdout = run.holdout
    ref = jmodel.score(holdout)[jpred.name]
    path = str(tmp_path / "model")
    run.model.save(path)
    loaded = load_model(path, device="cpu")
    assert (loaded.result_features[0].origin_stage.summary.to_json()
            == run.model.result_features[0].origin_stage.summary.to_json())
    pred = run.prediction.name
    for engine in ("columnar", "compiled"):
        col = loaded.score(holdout, engine=engine)[pred]
        np.testing.assert_allclose(col.data, ref.data, rtol=1e-9,
                                   atol=1e-9)
        np.testing.assert_allclose(col.probability, ref.probability,
                                   rtol=0, atol=1e-9)
    fn = load_score_function(path, device="cpu")
    for i in range(0, len(holdout), len(holdout) // 5):
        row = fn(dict(holdout[i]))[pred]
        assert abs(row["prediction"] - ref.data[i]) <= 1e-9 * max(
            1.0, abs(ref.data[i]))
        for c in range(ref.probability.shape[1]):
            assert abs(row[f"probability_{c}"] - ref.probability[i, c]) \
                <= 1e-9


def test_holdout_records_are_the_selectors(runs):
    """``holdout_records`` gives the rows the selector's splitter reserved:
    the holdout metrics recomputed from them equal the summary's."""
    name, _, _, _, run = runs
    _, got = _summaries(runs)
    scored = run.model.score(run.holdout)[run.prediction.name]
    if name == "iris":
        from transmogrifai_tpu_torch.evaluators import (
            MultiClassificationEvaluator as Ev)
        y = np.array([r["label"] for r in run.holdout])
    else:
        from transmogrifai_tpu_torch.evaluators import RegressionEvaluator as Ev
        y = np.array([r["medv"] for r in run.holdout])
    again = Ev().evaluate_arrays(y, scored)
    for k, v in got.holdout_evaluation.to_json().items():
        if isinstance(v, float):
            assert abs(getattr(again, k) - v) <= 1e-12, k
