"""The workflow engine: fit a feature DAG, score with the fitted model.

Counterpart of ``transmogrifai_tpu/workflow/workflow.py`` (reference
core/src/main/scala/com/salesforce/op/{OpWorkflow.scala:332,
OpWorkflowModel.scala:253} and core/.../utils/stages/
FitStagesUtil.scala:173-305). A ``Workflow`` computes on one ``device``
(default the CUDA card; it raises without one):

- ``train`` runs the prepare plan (``plans/prepare.py``): the fitted DAG's
  device stages run as torch ops there, so the selector searches a
  training matrix born on the device;
- ``WorkflowModel.score`` runs the JAX package's columnar host path, layer
  by layer through each stage's ``transform_columns``, with the winner's
  ``predict_arrays`` on the device; ``engine="compiled"`` runs the
  serving ``ScoringPlan`` instead (``serving/plan.py``: the DAG's device
  stages composed into one program, one CUDA graph per row bucket on the
  card), compiled once per model and cached;
- ``WorkflowModel.save`` and ``load`` (``workflow/persistence.py``) write
  and read the JAX package's directory layout; a load names the device
  the models predict on;
- a listener (``with_listener``) collects every stage's seconds and rows.

Estimator -> fitted-model DAG rewiring uses ``Feature.copy_with_new_stages``
as the reference does (OpWorkflow.scala:347). Workflow-level CV, the raw
feature filter, readers, resumed searches and the lint pre-flight are not
ported and raise.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..evaluators.base import EvaluationMetrics, Evaluator
from ..features.columns import Dataset, FeatureColumn
from ..features.feature import Feature, topo_layers
from ..features.generator import FeatureGeneratorStage
from ..plans.prepare import PreparePlan, raw_features as _unique_raw_features
from ..stages.base import Estimator, PipelineStage, Transformer
from ..utils.device import resolve_device
from ..utils.ported import not_ported

__all__ = ["Workflow", "WorkflowModel"]


def _generate_raw_data(raw_features: Sequence[Feature], data: Any,
                       require_responses: bool) -> Dataset:
    """Materialize raw feature columns from a Dataset or record iterable
    (reference generateRawData, OpWorkflow.scala:222).

    At score time (``require_responses=False``) absent response features
    become all-NaN columns so non-nullable label types don't block
    label-free scoring.
    """
    if isinstance(data, Dataset):
        n = data.n_rows
        cols: Dict[str, FeatureColumn] = {}
        for f in raw_features:
            if f.name in data:
                cols[f.name] = data[f.name]
            elif f.is_response and not require_responses:
                cols[f.name] = FeatureColumn(
                    ftype=f.ftype, data=np.full(n, np.nan, dtype=np.float64))
            else:
                raise KeyError(
                    f"Raw feature {f.name!r} not present in input dataset")
        return Dataset(cols)

    records = list(data)
    cols = {}
    for f in raw_features:
        gen = f.origin_stage
        if not isinstance(gen, FeatureGeneratorStage):
            raise TypeError(
                f"Raw feature {f.name!r} has no generator stage")
        if f.is_response and not require_responses:
            # user extract fns may KeyError/None on label-free score data
            def safe(r, fn=gen.extract_fn):
                try:
                    return fn(r)
                except (KeyError, AttributeError, TypeError):
                    return None
            vals = [safe(r) for r in records]
            if all(v is None for v in vals):
                cols[f.name] = FeatureColumn(
                    ftype=f.ftype,
                    data=np.full(len(records), np.nan, dtype=np.float64))
                continue
        cols[f.name] = gen.extract_column(records)
    return Dataset(cols)


def _fit_and_transform_layers(layers: List[List[PipelineStage]],
                              ds: Dataset) -> Dataset:
    """Layer-by-layer host execution of a fitted DAG (reference
    FitStagesUtil.fitAndTransformDAG:213 / fitAndTransformLayer:254, the
    JAX package's ``fit=False`` path): every stage's ``transform_columns``.
    Training runs the prepare plan instead."""
    for layer in layers:
        for stage in layer:
            if isinstance(stage, FeatureGeneratorStage):
                continue  # raw features are already materialized
            if isinstance(stage, Estimator):
                raise RuntimeError(
                    f"Unfitted estimator {stage!r} in scoring DAG — "
                    "train the workflow first")
            if not isinstance(stage, Transformer):
                raise TypeError(f"Cannot execute stage {stage!r}")
            ds = stage.transform_dataset(ds)
    return ds


def _validate_distinct_uids(result_features: Sequence[Feature]) -> None:
    """Every stage in the DAG must have a unique uid — duplicate uids
    silently alias fitted models during DAG rewiring (reference
    OpWorkflow.scala:305 validation)."""
    seen: Dict[str, PipelineStage] = {}
    for layer in topo_layers(result_features):
        for stage in layer:
            other = seen.get(stage.uid)
            if other is not None and other is not stage:
                raise ValueError(
                    f"Duplicate stage uid {stage.uid!r}: "
                    f"{type(other).__name__} and {type(stage).__name__}. "
                    f"Each stage instance needs its own uid — don't reuse "
                    f"one stage object with different inputs")
            seen[stage.uid] = stage


class Workflow:
    """Declare result features + input data, then ``train()`` on
    ``device`` (reference OpWorkflow.scala:59)."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.result_features: Tuple[Feature, ...] = ()
        self._input_data: Any = None
        #: the PreparePlan of the most recent train (coverage, fit
        #: placements, seconds)
        self.last_prepare_plan: Optional[PreparePlan] = None
        #: host seconds of the most recent train by phase
        self.last_train_seconds: Dict[str, float] = {}
        self._listener = None

    # -- configuration -----------------------------------------------------
    def set_result_features(self, *features: Feature) -> "Workflow":
        """(reference setResultFeatures:85; stages are derived from the
        feature DAG via topological sort, setStagesDAG:195)"""
        if not features:
            raise ValueError("At least one result feature required")
        self.result_features = tuple(features)
        return self

    def set_input_dataset(self, ds: Dataset) -> "Workflow":
        """(reference setInputDataset:136)"""
        self._input_data = ds
        return self

    def set_input_records(self, records: Iterable[Any]) -> "Workflow":
        """Row records (dicts/objects); raw features are extracted with
        their generator stages (reference setInputRDD)."""
        self._input_data = list(records)
        return self

    def set_reader(self, reader) -> "Workflow":
        raise not_ported("Workflow.set_reader", "readers/data_readers.py")

    def with_listener(self, listener) -> "Workflow":
        """Attach a WorkflowListener collecting per-stage metrics
        (reference OpSparkListener wiring, OpWorkflowRunner.scala:326)."""
        self._listener = listener
        return self

    def with_raw_feature_filter(self, rff,
                                score_data: Any = None) -> "Workflow":
        raise not_ported("Workflow.with_raw_feature_filter",
                         "checkers/raw_feature_filter.py")

    def with_workflow_cv(self) -> "Workflow":
        raise not_ported("Workflow.with_workflow_cv (cut_dag and "
                         "validate_prepared)", "workflow/workflow.py")

    # -- introspection -----------------------------------------------------
    def raw_features(self) -> List[Feature]:
        return _unique_raw_features(self.result_features)

    def stages(self) -> List[PipelineStage]:
        return [s for layer in topo_layers(self.result_features)
                for s in layer if not isinstance(s, FeatureGeneratorStage)]

    # -- training ----------------------------------------------------------
    def train(self, validate: str = "off",
              resume_from: Optional[str] = None) -> "WorkflowModel":
        """Fit all estimators and return the fitted model (reference
        OpWorkflow.train:332). The JAX package's lint pre-flight
        (``validate="warn"`` or ``"strict"``) and resumed searches
        (``resume_from``) raise; the default runs neither."""
        if validate != "off":
            raise not_ported(f"Workflow.train(validate={validate!r}), the "
                             f"lint pre-flight", "lint/")
        if resume_from is not None:
            raise not_ported("Workflow.train(resume_from=...)",
                             "runtime/journal.py")
        if not self.result_features:
            raise ValueError("No result features set")
        if self._input_data is None:
            raise ValueError("No input data set")
        _validate_distinct_uids(self.result_features)
        for stage in self.stages():
            dev = getattr(stage, "device", None)
            if dev is not None and dev != self.device:
                raise ValueError(
                    f"{type(stage).__name__} computes on {dev}, the "
                    f"workflow on {self.device}")
        t0 = time.perf_counter()
        ds = _generate_raw_data(self.raw_features(), self._input_data,
                                require_responses=True)
        t1 = time.perf_counter()
        plan = PreparePlan(self.result_features, device=self.device,
                           listener=self._listener)
        train_ds, fitted = plan.execute(ds)
        self.last_prepare_plan = plan
        self.last_train_seconds = {"raw_extraction": t1 - t0,
                                   "prepare_and_fit": time.perf_counter() - t1}
        result = tuple(f.copy_with_new_stages(fitted)
                       for f in self.result_features)
        if self._listener is not None:
            self._listener.on_application_end()
        return WorkflowModel(result_features=result, train_dataset=train_ds)


class WorkflowModel:
    """A fitted workflow: every origin stage in the result-feature DAG is a
    transformer (reference OpWorkflowModel.scala:58)."""

    def __init__(self, result_features: Tuple[Feature, ...],
                 train_dataset: Optional[Dataset] = None):
        self.result_features = tuple(result_features)
        #: transformed training data (all intermediate columns; those the
        #: prepare plan computed on the device hold tensors there)
        self.train_dataset = train_dataset

    def raw_features(self) -> List[Feature]:
        return _unique_raw_features(self.result_features)

    def stages(self) -> List[PipelineStage]:
        return [s for layer in topo_layers(self.result_features)
                for s in layer if not isinstance(s, FeatureGeneratorStage)]

    # -- scoring -----------------------------------------------------------
    def score(self, data: Any = None, keep_intermediate: bool = False,
              engine: str = "columnar") -> Dataset:
        """Transform new data through the fitted DAG (reference
        OpWorkflowModel.score:253). ``data`` is a Dataset or record
        iterable; response features may be absent. ``engine``:

        - ``"columnar"`` (default): every stage's host ``transform_columns``,
          layer by layer; the model stage predicts on its device;
        - ``"compiled"``: the serving :class:`ScoringPlan` on the model's
          device (``scoring_plan()``), compiled once and cached.
        """
        if engine not in ("columnar", "compiled"):
            raise ValueError(
                f"engine must be 'columnar' or 'compiled', got {engine!r}")
        if engine == "compiled":
            if keep_intermediate:
                raise ValueError(
                    "keep_intermediate is not supported with "
                    "engine='compiled' (intermediates stay inside the "
                    "device program)")
            return self.scoring_plan().score(data)
        raw = self.raw_features()
        ds = _generate_raw_data(raw, data, require_responses=False)
        layers = topo_layers(self.result_features)
        scored = _fit_and_transform_layers(layers, ds)
        if keep_intermediate:
            return scored
        keep = [f.name for f in raw if f.name in scored] + \
               [f.name for f in self.result_features]
        return scored.select(list(dict.fromkeys(keep)))

    def scoring_plan(self):
        """The compiled serving plan of this model (``serving/plan.py``),
        built and compiled on first use and cached on the model."""
        if getattr(self, "_scoring_plan", None) is None:
            from ..serving import ScoringPlan
            self._scoring_plan = ScoringPlan(self).compile()
        return self._scoring_plan

    def score_and_evaluate(self, data: Any, evaluator: Evaluator,
                           label_feature: Optional[Feature] = None,
                           prediction_feature: Optional[Feature] = None
                           ) -> Tuple[Dataset, EvaluationMetrics]:
        """(reference scoreAndEvaluate:290)"""
        scored = self.score(data)
        self._wire_evaluator(evaluator, label_feature, prediction_feature)
        return scored, evaluator.evaluate_all(scored)

    def evaluate(self, data: Any, evaluator: Evaluator,
                 label_feature: Optional[Feature] = None,
                 prediction_feature: Optional[Feature] = None
                 ) -> EvaluationMetrics:
        """(reference evaluate:318)"""
        return self.score_and_evaluate(
            data, evaluator, label_feature, prediction_feature)[1]

    def _wire_evaluator(self, evaluator: Evaluator,
                        label_feature: Optional[Feature],
                        prediction_feature: Optional[Feature]) -> None:
        if evaluator.label_col is None:
            if label_feature is None:
                responses = [f for f in self.raw_features() if f.is_response]
                if len(responses) != 1:
                    raise ValueError(
                        "Cannot infer label column; pass label_feature")
                label_feature = responses[0]
            evaluator.label_col = label_feature.name
        if evaluator.prediction_col is None:
            pred = (prediction_feature if prediction_feature is not None
                    else self.result_features[-1])
            evaluator.prediction_col = pred.name

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        """Persist the fitted DAG to a directory, atomically
        (reference OpWorkflowModel.save:218)."""
        from .persistence import save_model
        save_model(self, path)

    @staticmethod
    def load(path: str, device="cuda") -> "WorkflowModel":
        """The model saved at ``path``, its models predicting on
        ``device`` (default the CUDA card; raises without one)
        (reference OpWorkflow.loadModel)."""
        from .persistence import load_model
        return load_model(path, device=device)
