"""Rules of the PyTorch port as a package: it runs on CUDA unless the caller
asks for the CPU, it imports neither JAX nor the JAX package, every part
of the JAX package's workflow and serving surface it has not ported
raises NotImplementedError naming the JAX module it waits for, and the
feature families, feature-validation and selection options it has ported
run."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch
from transmogrifai_tpu_torch.models.linear import (
    LinearSVC, LinearSVCModel, LogisticRegression, LogisticRegressionModel)
from transmogrifai_tpu_torch.models.trees import (
    DecisionTreeClassifier, GBTClassifier, GBTClassifierModel,
    RandomForestClassifier, TreeEnsembleClassifierModel)
from transmogrifai_tpu_torch.checkers import RawFeatureFilter
from transmogrifai_tpu_torch.examples import titanic
from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.local import ScoreFunction, load_score_function
from transmogrifai_tpu_torch.ops import transmogrify
from transmogrifai_tpu_torch.plans import PreparePlan
from transmogrifai_tpu_torch.readers import DataReaders
from transmogrifai_tpu_torch import serving
from transmogrifai_tpu_torch.ops.numeric import RealVectorizerModel
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, ModelSelector)
from transmogrifai_tpu_torch.serving import (PlanCache, ScoringPlan,
                                             ServeConfig, ServingServer,
                                             serve_in_process)
from transmogrifai_tpu_torch.types import (DateList, Geolocation, OPVector,
                                           PickList, Real, RealMap, Date,
                                           TextList)
from transmogrifai_tpu_torch.utils.device import resolve_device, working_dtype
from transmogrifai_tpu_torch.workflow import Workflow, WorkflowModel
from transmogrifai_tpu_torch.workflow.persistence import load_model

PKG = Path(transmogrifai_tpu_torch.__file__).resolve().parent
REPO = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "transmogrifai_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _feature(ftype, name):
    return FeatureBuilder.of(name, ftype).extract(
        lambda r: r[name]).as_predictor()


def _event_log_run(**kw):
    from transmogrifai_tpu_torch.examples import dataprep
    sends, clicks = dataprep.synthetic_event_log(20)
    return dataprep.run(sends, clicks, dataprep.START_MS,
                        dataprep.START_MS + dataprep.DAY_MS, **kw)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: GBTClassifier(),
    lambda: GBTClassifierModel(np.zeros((1, 1)), np.zeros((1, 1)),
                               np.zeros((1, 2)), depth=1),
    lambda: ModelSelector(),
    lambda: BinaryClassificationModelSelector.with_cross_validation(
        model_types_to_use=["GBTClassifier"]),
    lambda: RandomForestClassifier(),
    lambda: DecisionTreeClassifier(),
    lambda: TreeEnsembleClassifierModel(np.zeros((1, 1)), np.zeros((1, 1)),
                                        np.zeros((1, 2, 2)), depth=1),
    lambda: BinaryClassificationModelSelector.with_cross_validation(
        model_types_to_use=["RandomForestClassifier", "GBTClassifier"]),
    lambda: LogisticRegression(),
    lambda: LinearSVC(),
    lambda: LogisticRegressionModel(np.zeros(2), 0.0),
    lambda: LinearSVCModel(np.zeros(2), 0.0),
    lambda: BinaryClassificationModelSelector.with_cross_validation(),
    lambda: Workflow(),
    lambda: PreparePlan([_feature(Real, "x")]),
    lambda: titanic.default_selector(),
    lambda: titanic.default_selector(validation="racing"),
    lambda: BinaryClassificationModelSelector.with_train_validation_split(),
    lambda: titanic.run(titanic.synthetic_titanic(40)),
    lambda: WorkflowModel.load("model"),
    lambda: load_model("model"),
    lambda: load_score_function("model"),
    lambda: ScoringPlan(WorkflowModel((_feature(Real, "x"),))),
    lambda: PlanCache(),
    lambda: ServingServer(ServeConfig()),
    lambda: serve_in_process({}, ServeConfig()),
    lambda: _event_log_run(),
    lambda: _event_log_run(models=[]),
])
def test_default_device_needs_a_card(entry, monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_explicit_cpu_and_dtype_policy(monkeypatch):
    _no_card(monkeypatch)
    dev = resolve_device("cpu")
    assert dev.type == "cpu" and working_dtype(dev) == torch.float64
    assert working_dtype(torch.device("cuda")) == torch.float32
    assert GBTClassifier(device="cpu").device == dev
    assert torch.backends.cuda.matmul.allow_tf32 is False
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_device_stages_run_where_their_inputs_are():
    """transform_arrays computes on its inputs' device in the working
    dtype: a CPU tensor stays on the CPU as float64; the plan only ever
    hands a stage tensors on the workflow's device, which defaults to the
    card."""
    from transmogrifai_tpu_torch.ops import OneHotVectorizerModel
    model = OneHotVectorizerModel(categories=[["a"]])
    out = model.transform_arrays([torch.tensor([0, 1, 2])])
    assert out.device.type == "cpu" and out.dtype == torch.float64


def _cpu_model():
    """x -> RealVectorizerModel -> a logistic model, fitted by hand on the
    CPU."""
    label = FeatureBuilder.real_nn("label").extract(
        lambda r: r["label"]).as_response()
    vec = RealVectorizerModel(fill_values=[0.0]).set_input(
        _feature(Real, "x")).get_output()
    lr = LogisticRegressionModel(np.zeros(2), 0.0, device="cpu")
    return WorkflowModel((lr.set_input(label, vec).get_output(),))


def _cpu_server(**config):
    return ServingServer(ServeConfig(**config), device="cpu")


def _resumed_workflow():
    """A tiny selector workflow trained with ``resume_from``: the search
    journals into a temporary directory."""
    import tempfile
    label = FeatureBuilder.real_nn("label").extract(
        lambda r: r["label"]).as_response()
    sel = ModelSelector(
        models=[(LogisticRegression(device="cpu"), [{}])],
        validator=BinaryClassificationModelSelector.with_cross_validation(
            device="cpu").validator, device="cpu")
    pred = sel.set_input(label, transmogrify([_feature(Real, "x")])
                         ).get_output()
    rng = np.random.default_rng(0)
    records = [{"x": float(v), "label": float(v > 0)}
               for v in rng.normal(size=40)]
    with tempfile.TemporaryDirectory() as ckpt:
        return (Workflow(device="cpu").set_result_features(pred)
                .set_input_records(records).train(resume_from=ckpt))


def _load_filtered_model():
    """Load a saved model whose document carries raw feature filter
    results (the JAX package writes them when its filter ran)."""
    import json
    import tempfile
    with tempfile.TemporaryDirectory() as path:
        with open(os.path.join(path, "op-model.json"), "w") as fh:
            json.dump({"formatVersion": 2, "stages": [], "features": [],
                       "resultFeatureUids": [],
                       "rawFeatureFilterResults": {"exclusions": []}}, fh)
        return load_model(path, device="cpu")


#: (entry point, the JAX module its error must name)
UNPORTED = [
    (lambda: ScoringPlan(_cpu_model(), lattice=[8, 24]),
     "tuning/lattice.py"),
    (lambda: Workflow(device="cpu").train(validate="warn"), "lint/"),
    (lambda: Workflow(device="cpu").train(validate="strict"), "lint/"),
    (lambda: _cpu_server(admission_control=object()),
     "serving/admission.py"),
    (lambda: _cpu_server(coalesce_policy="predicted_cost"),
     "tuning/policy.py"),
    (lambda: ScoringPlan(_cpu_model()).attach_artifacts({}),
     "artifacts/"),
    (lambda: serving.TcpServingClient, "serving/client.py"),
    (lambda: serving.StateManager, "serving/state.py"),
    (lambda: serving.ReplicaManager, "serving/fleet.py"),
    (lambda: serving.FleetRouter, "serving/router.py"),
    (lambda: serving.AdmissionController, "serving/admission.py"),
]


#: the numbers the PORTED entries take in the test ids, which UNPORTED and
#: PORTED number in one sequence
_PORTED_AT = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 17, 18, 19,
              20, 21, 23, 24, 32, 33)
_UNPORTED_IDS = [m + f"-{i}" for i, (_, m) in zip(
    (i for i in range(len(UNPORTED) + len(_PORTED_AT))
     if i not in _PORTED_AT), UNPORTED)]


@pytest.mark.parametrize("entry,module", UNPORTED, ids=_UNPORTED_IDS)
def test_unported_parts_raise_by_name(entry, module):
    with pytest.raises(NotImplementedError,
                       match=f"transmogrifai_tpu/{re.escape(module)}"):
        entry()


def _checked_label():
    return FeatureBuilder.real_nn("y").extract(
        lambda r: r["y"]).as_response()


#: (entry point, the JAX module it ports): each runs and returns
PORTED = [
    (lambda: transmogrify([_feature(Date, "d")]), "ops/date.py"),
    (lambda: transmogrify([_feature(DateList, "d")]), "ops/date.py"),
    (lambda: transmogrify([_feature(Geolocation, "g")]), "ops/geo.py"),
    (lambda: transmogrify([_feature(TextList, "t")]), "ops/text.py"),
    (lambda: transmogrify([_feature(RealMap, "m")]), "ops/maps.py"),
    (lambda: transmogrify([_feature(Real, "x")]).sanity_check(
        _checked_label()), "checkers/sanity_checker.py"),
    (lambda: _feature(Real, "x").bucketize([0.0, 1.0]),
     "ops/bucketizers.py"),
    (lambda: _feature(Real, "x").auto_bucketize(_checked_label(),
                                                device="cpu"),
     "ops/bucketizers.py"),
    (lambda: _feature(PickList, "x").tokenize(), "ops/text.py"),
    (lambda: _feature(TextList, "x").lda(), "ops/text_advanced.py"),
    (lambda: Workflow(device="cpu").with_workflow_cv(),
     "workflow/workflow.py"),
    (lambda: Workflow(device="cpu").with_raw_feature_filter(
        RawFeatureFilter()), "checkers/raw_feature_filter.py"),
    (lambda: Workflow(device="cpu").set_reader(
        DataReaders.Simple.custom([{"x": 1.0}])), "readers/data_readers.py"),
    (lambda: _resumed_workflow(), "runtime/journal.py"),
    (lambda: BinaryClassificationModelSelector.with_cross_validation(
        validation="racing", device="cpu").validator, "selector/racing.py"),
    (lambda: ScoreFunction(_cpu_model(), guardrails=True).score_batch(
        [{"x": 1.0}]), "serving/sentinel.py"),
    (lambda: _load_filtered_model().raw_feature_filter_results,
     "checkers/raw_feature_filter.py"),
    (lambda: _cpu_server(), "serving/sentinel.py"),
    (lambda: ScoringPlan(_cpu_model()).with_guardrails(),
     "serving/sentinel.py"),
    (lambda: _cpu_server(lifecycle=serving.LifecycleConfig()),
     "serving/lifecycle.py"),
    (lambda: _cpu_server(lifecycle=serving.LifecycleConfig())
     .register_refit("m"), "serving/lifecycle.py"),
    (lambda: serving.DriftSentinel, "serving/sentinel.py"),
    (lambda: serving.ModelLifecycle, "serving/lifecycle.py"),
    (lambda: BinaryClassificationModelSelector.with_train_validation_split(
        device="cpu").validator, "selector/validator.py"),
]


@pytest.mark.parametrize("entry,module", PORTED, ids=[
    m + f"-{i}" for i, (_, m) in zip(_PORTED_AT + (len(UNPORTED)
                                                  + len(_PORTED_AT),),
                                     PORTED)])
def test_ported_options_run(entry, module):
    """The feature families, the feature-validation and the selection
    options run where they raised by name: ``transmogrify`` of a date,
    date list, geolocation, text list or map feature, both bucketizers and
    ``lda`` give a predictor vector from the ported stage, ``tokenize`` a
    text list; the checker's output is a predictor, the racing and split
    validators are the ported classes, a save with raw feature filter
    results loads them; the default guardrails (with the drift sentinel)
    serve a batch, a default ``ServeConfig()`` server and guarded plan
    stand up, and ``serving.DriftSentinel`` is the ported class; a
    workflow trains with ``resume_from``, a server with a
    ``LifecycleConfig`` has its manager and takes ``register_refit``, and
    ``serving.ModelLifecycle`` is the ported class."""
    from transmogrifai_tpu_torch.checkers import RawFeatureFilterResults
    from transmogrifai_tpu_torch.selector import (RacingCrossValidation,
                                                  TrainValidationSplit)
    out = entry()
    vector = lambda o: (issubclass(o.ftype, OPVector)  # noqa: E731
                        and not o.is_response)
    expect = {"checkers/sanity_checker.py": lambda o: not o.is_response,
              "ops/date.py": vector, "ops/geo.py": vector,
              "ops/maps.py": vector, "ops/bucketizers.py": vector,
              "ops/text_advanced.py": vector,
              "ops/text.py": lambda o: not o.is_response and (
                  issubclass(o.ftype, OPVector)
                  or issubclass(o.ftype, TextList)),
              "workflow/workflow.py": lambda o: isinstance(o, Workflow),
              "readers/data_readers.py": lambda o: isinstance(o, Workflow),
              "selector/racing.py":
                  lambda o: isinstance(o, RacingCrossValidation),
              "selector/validator.py":
                  lambda o: isinstance(o, TrainValidationSplit)}
    from transmogrifai_tpu_torch.serving.lifecycle import ModelLifecycle
    from transmogrifai_tpu_torch.serving.sentinel import DriftSentinel
    if module == "runtime/journal.py":
        assert isinstance(out, WorkflowModel)
    elif module == "serving/lifecycle.py":
        assert out is ModelLifecycle or isinstance(
            out.lifecycle, ModelLifecycle)
    elif module == "checkers/raw_feature_filter.py":
        assert isinstance(out, (Workflow, RawFeatureFilterResults))
    elif module == "serving/sentinel.py":
        if isinstance(out, list):
            (pred,) = (v for k, v in out[0].items() if k != "label")
            assert pred["prediction"] in (0.0, 1.0)
        elif isinstance(out, ServingServer):
            assert out.config.sentinel and out.config.guardrails
        elif isinstance(out, ScoringPlan):
            assert out.guard is not None
        else:
            assert out is DriftSentinel
    else:
        assert expect[module](out)


def test_sources_import_no_jax():
    """Walk every module's AST: no import of jax or the JAX package."""
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    names = {str(p.relative_to(PKG)) for p in files[:-1]}
    assert {"workflow/workflow.py", "plans/prepare.py", "plans/common.py",
            "ops/transmogrify.py", "ops/categorical.py", "ops/text.py",
            "ops/numeric.py", "ops/dsl.py", "ops/combiner.py",
            "stages/base.py", "features/feature.py", "features/columns.py",
            "types/maps.py", "utils/uid.py", "utils/vector_meta.py",
            "examples/titanic.py", "workflow/persistence.py",
            "local/scoring.py", "utils/listener.py", "utils/table.py",
            "utils/version.py", "utils/ref_math.py", "serving/plan.py",
            "serving/guard.py", "serving/server.py", "serving/__init__.py",
            "runtime/errors.py", "runtime/retry.py", "runtime/telemetry.py",
            "observability/trace.py", "observability/metrics.py",
            "tuning/registry.py", "utils/compile_time.py",
            "utils/histogram.py", "utils/stats.py", "checkers/__init__.py",
            "checkers/sanity_checker.py", "checkers/raw_feature_filter.py",
            "selector/racing.py", "selector/validator.py", "ops/date.py",
            "ops/geo.py", "ops/maps.py", "ops/bucketizers.py",
            "testkit/random_data.py", "testkit/spec.py",
            "examples/families.py", "serving/sentinel.py",
            "evaluators/logloss.py", "selector/random_params.py",
            "utils/text_lang.py", "utils/text_ner.py", "ops/ner.py",
            "ops/derived.py", "ops/index.py", "ops/text_advanced.py",
            "examples/text.py", "features/aggregators.py",
            "utils/avro_io.py", "readers/__init__.py",
            "readers/data_readers.py", "readers/joined.py",
            "readers/streaming.py", "insights/__init__.py",
            "insights/corr.py", "insights/loco.py",
            "insights/model_insights.py", "examples/dataprep.py",
            "runtime/faults.py", "runtime/journal.py", "runtime/context.py",
            "runtime/refit.py", "serving/lifecycle.py"} <= names
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_imports_with_jax_package_hidden():
    """Import every module of the port, and chip_smoke, in a fresh
    interpreter where importing jax or transmogrifai_tpu fails."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PKG.rglob("*.py"))
    code = f"""
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in {FORBIDDEN!r}):
            raise ImportError("hidden: " + name)
sys.meta_path.insert(0, Block())
for m in {modules!r} + ["chip_smoke"]:
    importlib.import_module(m.replace(".__init__", ""))
bad = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}]
assert not bad, bad
print("ok", len({modules!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _problem_entries():
    """The multiclass and regression entry points: the new families, their
    models, the two selector factories and the examples."""
    from transmogrifai_tpu_torch.examples import boston, iris
    from transmogrifai_tpu_torch.models import (
        DecisionTreeRegressor, GBTMulticlassClassifierModel, GBTRegressor,
        GBTRegressorModel, GeneralizedLinearRegression,
        GeneralizedLinearRegressionModel, LinearRegression,
        LinearRegressionModel, NaiveBayes, NaiveBayesModel,
        RandomForestRegressor, TreeEnsembleRegressorModel,
        XGBoostClassifier, XGBoostRegressor)
    from transmogrifai_tpu_torch.selector import (
        MultiClassificationModelSelector, RegressionModelSelector)
    return [
        lambda: NaiveBayes(),
        lambda: NaiveBayesModel(np.zeros(3), np.zeros((3, 2))),
        lambda: GeneralizedLinearRegression(),
        lambda: GeneralizedLinearRegressionModel(np.zeros(2), 0.0),
        lambda: LinearRegression(),
        lambda: LinearRegressionModel(np.zeros(2), 0.0),
        lambda: LogisticRegressionModel(np.zeros((3, 2)), np.zeros(3)),
        lambda: RandomForestRegressor(),
        lambda: DecisionTreeRegressor(),
        lambda: GBTRegressor(),
        lambda: XGBoostClassifier(),
        lambda: XGBoostRegressor(),
        lambda: TreeEnsembleRegressorModel(np.zeros((1, 1)),
                                           np.zeros((1, 1)),
                                           np.zeros((1, 2)), depth=1),
        lambda: GBTRegressorModel(np.zeros((1, 1)), np.zeros((1, 1)),
                                  np.zeros((1, 2)), depth=1),
        lambda: GBTMulticlassClassifierModel(
            np.zeros((1, 3, 1)), np.zeros((1, 3, 1)), np.zeros((1, 3, 2)),
            depth=1, base=np.zeros(3)),
        lambda: MultiClassificationModelSelector.with_cross_validation(),
        lambda: MultiClassificationModelSelector
        .with_train_validation_split(),
        lambda: RegressionModelSelector.with_cross_validation(),
        lambda: RegressionModelSelector.with_cross_validation(
            validation="racing"),
        lambda: iris.default_selector(),
        lambda: boston.default_selector(),
        lambda: iris.run(iris.synthetic_iris(30)),
        lambda: boston.run(boston.synthetic_boston(30)),
    ]


@pytest.mark.parametrize("i", range(23))
def test_problem_entries_need_a_card(i, monkeypatch):
    """Every multiclass and regression entry point defaults to CUDA and
    raises without a card."""
    entries = _problem_entries()
    assert len(entries) == 23
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        entries[i]()


def test_problem_sources_are_walked():
    """The modules this slice added are among those the AST walk and the
    hidden-package import cover."""
    names = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert {"evaluators/multiclass.py", "evaluators/regression.py",
            "models/bayes.py", "models/glm.py", "models/registry.py",
            "examples/iris.py", "examples/boston.py",
            "models/convert.py"} <= names


def test_unported_family_raises_by_name():
    """The JAX package's multiclass opt-in MLP, which raised by name
    until it was ported, is picked by name now: the filter keeps it
    after the softmax XGBoost, in the opt-in pool's order, on the
    selector's device; its module is among those the AST walk covers,
    and its default device is the card, which raises without one."""
    from transmogrifai_tpu_torch.models.mlp import (
        MultilayerPerceptronClassifier)
    from transmogrifai_tpu_torch.selector import (
        MultiClassificationModelSelector)
    sel = MultiClassificationModelSelector.with_cross_validation(
        model_types_to_use=["XGBoostClassifier",
                            "MultilayerPerceptronClassifier"],
        device="cpu")
    assert [type(e).__name__ for e, _ in sel.models] == [
        "XGBoostClassifier", "MultilayerPerceptronClassifier"]
    assert sel.models[1][0].device.type == "cpu"
    assert "models/mlp.py" in {str(p.relative_to(PKG))
                               for p in PKG.rglob("*.py")}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MultilayerPerceptronClassifier()


#: names of a JAX subpackage's ``__all__`` that wait for a later slice,
#: with the JAX module each waits for
WAITING = {
    "workflow": {"OpParams": "workflow/runner.py",
                 "RunResult": "workflow/runner.py",
                 "RunType": "workflow/runner.py",
                 "WorkflowRunner": "workflow/runner.py"},
    "serving": {
        **dict.fromkeys(("AdmissionConfig", "AdmissionController",
                         "ServeShed"), "serving/admission.py"),
        **dict.fromkeys(("TcpServingClient", "ServingUnavailable"),
                        "serving/client.py"),
        **dict.fromkeys(("ServingStateSnapshot", "StateManager",
                         "SNAPSHOT_SCHEMA"), "serving/state.py"),
        **dict.fromkeys(("ReplicaManager", "ReplicaSpec",
                         "wait_port_ready"), "serving/fleet.py"),
        **dict.fromkeys(("FleetRouter", "RouterConfig", "ReplicaHandle",
                         "BackendUnavailable", "merge_admission"),
                        "serving/router.py")},
}


@pytest.mark.parametrize("subpackage", ["selector", "readers", "insights",
                                        "features", "workflow", "models",
                                        "runtime", "serving"])
def test_public_names_match_jax(subpackage):
    """Every name of the JAX subpackage's ``__all__`` is in the port's
    ``__all__`` and importable there, but the ones WAITING lists, whose
    JAX modules are not ported (the port may export more)."""
    import importlib
    jax_names = set(importlib.import_module(
        f"transmogrifai_tpu.{subpackage}").__all__)
    port = importlib.import_module(f"transmogrifai_tpu_torch.{subpackage}")
    waiting = WAITING.get(subpackage, {})
    assert not set(waiting) - jax_names
    assert jax_names - set(waiting) <= set(port.__all__), \
        sorted(jax_names - set(waiting) - set(port.__all__))
    assert all(hasattr(port, n) for n in port.__all__)
    assert not set(waiting) & set(port.__all__)
    for module in set(waiting.values()):
        rel = module.replace("/", ".").removesuffix(".py")
        with pytest.raises(ImportError):
            importlib.import_module(f"transmogrifai_tpu_torch.{rel}")


def test_runs_without_pandas():
    """The card's machine has neither pandas nor pyarrow: with both
    hidden, the port imports, a workflow trains on an aggregate reader on
    the CPU and scores through it; the Parquet reader and
    ``from_dataframe`` raise ImportError naming pandas."""
    code = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pandas", "pyarrow"):
            raise ImportError("No module named " + repr(name))
sys.meta_path.insert(0, Block())
import transmogrifai_tpu_torch
from transmogrifai_tpu_torch.examples import dataprep
from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.models import LogisticRegression
from transmogrifai_tpu_torch.readers import DataReaders
sends, clicks = dataprep.synthetic_event_log(80, seed=1)
cut = dataprep.START_MS + 14 * dataprep.DAY_MS
run = dataprep.run(sends, clicks, cut, cut + 7 * dataprep.DAY_MS,
                   device="cpu", models=[(LogisticRegression(device="cpu"),
                                          [{"reg_param": 0.1}])])
assert run.scored.n_rows > 0 and run.metrics.AuPR >= 0
for call in (lambda: DataReaders.Simple.parquet("x.parquet").read_records(),
             lambda: FeatureBuilder.from_dataframe(object(), "y")):
    try:
        call()
    except ImportError as e:
        assert "pandas" in str(e), e
    else:
        raise AssertionError("no ImportError")
bad = [m for m in sys.modules if m.split(".")[0] in ("pandas", "pyarrow")]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
