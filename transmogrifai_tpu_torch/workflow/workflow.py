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
- a listener (``with_listener``) collects every stage's seconds and rows;
- ``with_raw_feature_filter`` excludes raw features before any fit
  (``checkers/raw_feature_filter.py``, host numpy over the raw columns)
  and rewires the DAG without them;
- ``with_workflow_cv`` refits the selector's label-consuming ancestors
  (the SanityChecker) inside every CV fold: the prepare plan runs the
  ancestors outside that segment once, the folds are row gathers of its
  device matrix, the segment is refit per fold on the device, and the
  selector searches each fold's matrix (``validate_prepared``).

- a reader (``set_reader``, ``readers/``) supplies the raw data, keyed and
  aggregated around a cutoff where it is an aggregate reader; a model
  scores a reader as it scores records;
- ``WorkflowModel.model_insights``, ``summary`` and ``summary_pretty``
  explain the fitted model (``insights/``).

- ``train(resume_from=DIR)`` points the DAG's ModelSelector at a search
  journal (``runtime/journal.py``): a search killed part way replays its
  journaled family evaluations and dispatches only the rest.

Estimator -> fitted-model DAG rewiring uses ``Feature.copy_with_new_stages``
as the reference does (OpWorkflow.scala:347). The lint pre-flight is not
ported and raises.
"""
from __future__ import annotations

import json
import logging
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..evaluators.base import EvaluationMetrics, Evaluator
from ..features.columns import Dataset, FeatureColumn, host_column
from ..features.feature import Feature, topo_layers
from ..features.generator import FeatureGeneratorStage
from ..plans.prepare import PreparePlan, raw_features as _unique_raw_features
from ..stages.base import Estimator, PipelineStage, Transformer
from ..utils.device import resolve_device, take_rows
from ..utils.ported import not_ported

__all__ = ["Workflow", "WorkflowModel", "cut_dag"]

_log = logging.getLogger(__name__)


def _nan_column(f: Feature, n: int) -> FeatureColumn:
    return FeatureColumn(ftype=f.ftype,
                         data=np.full(n, np.nan, dtype=np.float64))


def _generate_raw_data(raw_features: Sequence[Feature], data: Any,
                       require_responses: bool) -> Dataset:
    """Materialize raw feature columns from a DataReader, a Dataset or a
    record iterable (reference generateRawData, OpWorkflow.scala:222 +
    DataReader.generateDataFrame, readers/.../DataReader.scala:173).

    At score time (``require_responses=False``) absent response features
    become all-NaN columns so non-nullable label types don't block
    label-free scoring.
    """
    from ..readers.data_readers import DataReader
    if isinstance(data, DataReader):
        # (reference reader.generateDataFrame, Reader.scala:168)
        try:
            data = data.generate_dataset(raw_features)
        except Exception:
            if require_responses:
                raise
            # label-free scoring: a response column the data can't
            # produce becomes all-NaN instead of failing extraction (one
            # reading of the data when every column can be produced)
            predictors = [f for f in raw_features if not f.is_response]
            ds0 = data.generate_dataset(predictors)
            cols0 = {f.name: ds0[f.name] for f in predictors}
            for f in raw_features:
                if not f.is_response:
                    continue
                try:
                    cols0[f.name] = data.generate_dataset([f])[f.name]
                except Exception as e:
                    _log.warning(
                        "response %r not extractable from score data "
                        "(%s); substituting an all-NaN column", f.name, e)
                    cols0[f.name] = _nan_column(f, ds0.n_rows)
            data = Dataset(cols0)
    if isinstance(data, Dataset):
        n = data.n_rows
        cols: Dict[str, FeatureColumn] = {}
        for f in raw_features:
            if f.name in data:
                cols[f.name] = data[f.name]
            elif f.is_response and not require_responses:
                cols[f.name] = _nan_column(f, n)
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
                cols[f.name] = _nan_column(f, len(records))
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


def _stage_columns(stage: PipelineStage, ds: Dataset) -> List[FeatureColumn]:
    """``stage``'s input columns: a device column as it is for a stage
    that takes tensors (``device_inputs``), a host copy otherwise."""
    return [ds[f.name] if stage.device_inputs else host_column(ds[f.name])
            for f in stage.input_features]


def _fit_segment(layers: List[List[PipelineStage]], ds: Dataset
                 ) -> Tuple[Dataset, Dict[str, PipelineStage]]:
    """Fit and transform a DAG segment over ``ds`` (the workflow-CV fold
    refit; reference FitStagesUtil.fitAndTransformDAG:213): a stage that
    takes tensors fits and transforms on the device columns it is given.
    Returns the transformed Dataset and the fitted models by uid."""
    fitted: Dict[str, PipelineStage] = {}
    for layer in layers:
        for stage in layer:
            if isinstance(stage, Estimator):
                model = stage.fit(Dataset(
                    {f.name: c for f, c in zip(stage.input_features,
                                               _stage_columns(stage, ds))}))
                fitted[stage.uid] = model
                ds = ds.with_column(stage.get_output().name,
                                    model.transform_columns(
                                        _stage_columns(model, ds)))
            else:
                ds = ds.with_column(stage.get_output().name,
                                    stage.transform_columns(
                                        _stage_columns(stage, ds)))
    return ds, fitted


def _transform_with_fitted(layers: List[List[PipelineStage]],
                           fitted: Dict[str, PipelineStage],
                           ds: Dataset) -> Dataset:
    """Apply already-fitted stages to new rows (the validation side of a
    workflow-CV fold; reference FittedDAG.transformers application,
    FitStagesUtil.scala:254-292)."""
    for layer in layers:
        for stage in layer:
            stage = fitted.get(stage.uid, stage)
            ds = ds.with_column(stage.get_output().name,
                                stage.transform_columns(
                                    _stage_columns(stage, ds)))
    return ds


def cut_dag(result_features: Sequence[Feature]):
    """Split the DAG around the ModelSelector for leakage-free
    workflow-level CV (reference FitStagesUtil.cutDAG:305).

    Returns (selector, during_layers) where ``during_layers`` are the
    selector-ancestor layers from the first stage whose inputs mix a
    response with predictors (e.g. SanityChecker) onward: the stages whose
    full-data fit would leak validation-fold label information into model
    selection. Empty when there is no selector or no label-consuming
    ancestor. Raises on more than one selector (reference "at most 1
    Model Selector").
    """
    from ..selector.selector import ModelSelector
    layers = topo_layers(result_features)
    selectors = [s for layer in layers for s in layer
                 if isinstance(s, ModelSelector)]
    if len(selectors) > 1:
        raise ValueError(
            f"Workflow can contain at most 1 ModelSelector for "
            f"workflow-level CV; found {len(selectors)}")
    if not selectors:
        return None, []
    ms = selectors[0]
    anc_layers = topo_layers(list(ms.input_features))
    first = None
    for i, layer in enumerate(anc_layers):
        for s in layer:
            if isinstance(s, FeatureGeneratorStage):
                continue
            ins = getattr(s, "input_features", ())
            if (any(f.is_response for f in ins)
                    and any(not f.is_response for f in ins)):
                first = i
                break
        if first is not None:
            break
    if first is None:
        return ms, []
    during = [[s for s in layer if not isinstance(s, FeatureGeneratorStage)]
              for layer in anc_layers[first:]]
    return ms, [l for l in during if l]


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
        self._raw_feature_filter = None
        self._rff_score_data: Any = None
        self._workflow_cv = False
        #: raw features removed by the RawFeatureFilter (reference
        #: blacklistedFeatures on OpWorkflow)
        self.blacklisted_features: Tuple[Feature, ...] = ()
        #: RawFeatureFilterResults after train() (reference
        #: getRawFeatureFilterResults)
        self.raw_feature_filter_results = None
        #: the most recent workflow-CV pre-pass and fold search: seconds
        #: of the pre-pass, of each fold's segment refit and of the
        #: search, and each fold's train matrix width (empty without one)
        self.last_workflow_cv: Dict[str, Any] = {}

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
        """A DataReader supplies (and possibly aggregates) the raw data
        (reference setReader, OpWorkflow.scala:122)."""
        self._input_data = reader
        return self

    def with_listener(self, listener) -> "Workflow":
        """Attach a WorkflowListener collecting per-stage metrics
        (reference OpSparkListener wiring, OpWorkflowRunner.scala:326)."""
        self._listener = listener
        return self

    def with_raw_feature_filter(self, rff,
                                score_data: Any = None) -> "Workflow":
        """Enable pre-DAG raw-feature exclusion during ``train()``
        (reference withRawFeatureFilter on OpWorkflow). ``score_data``
        (records or a Dataset) optionally supplies scoring-time data for
        the distribution-shift checks; a DataReader too."""
        self._raw_feature_filter = rff
        self._rff_score_data = score_data
        return self

    def with_workflow_cv(self) -> "Workflow":
        """Leakage-free workflow-level CV (reference withWorkflowCV,
        OpWorkflowCore.scala:109 + OpWorkflow.scala:388-440): during
        model selection every label-consuming ancestor stage of the
        ModelSelector (e.g. SanityChecker) is refit inside each CV fold on
        that fold's training rows only. The winner is then refit on the
        full data."""
        self._workflow_cv = True
        return self

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
        (``validate="warn"`` or ``"strict"``) raises; the default runs
        none.

        ``resume_from`` points the DAG's ModelSelectors at a search
        checkpoint directory: the family evaluations a previous, perhaps
        killed, ``train()`` of the same search journaled there replay from
        disk, only the missing work is dispatched, and the resumed search
        picks the identical winner. The directory is written to as well,
        so retrying ``train(resume_from=d)`` after crashes converges; the
        same as ``ModelSelector(checkpoint_dir=...)``."""
        if validate != "off":
            raise not_ported(f"Workflow.train(validate={validate!r}), the "
                             f"lint pre-flight", "lint/")
        if not self.result_features:
            raise ValueError("No result features set")
        if self._input_data is None:
            raise ValueError("No input data set")
        if resume_from is not None:
            from ..selector.selector import ModelSelector
            selectors = [s for s in self.stages()
                         if isinstance(s, ModelSelector)]
            if not selectors:
                raise ValueError(
                    "resume_from requires a ModelSelector in the "
                    "workflow DAG: there is no search to resume")
            for s in selectors:
                s.checkpoint_dir = resume_from
        _validate_distinct_uids(self.result_features)
        for stage in self.stages():
            dev = getattr(stage, "device", None)
            if dev is not None and dev != self.device:
                raise ValueError(
                    f"{type(stage).__name__} computes on {dev}, the "
                    f"workflow on {self.device}")
        t0 = time.perf_counter()
        raw = self.raw_features()
        ds = _generate_raw_data(raw, self._input_data,
                                require_responses=True)
        t1 = time.perf_counter()
        seconds = {"raw_extraction": t1 - t0}
        result_features = self.result_features
        self.blacklisted_features = ()
        self.raw_feature_filter_results = None
        self.last_workflow_cv = {}
        if self._raw_feature_filter is not None:
            result_features = self._filter_raw(raw, ds)
            seconds["raw_feature_filter"] = time.perf_counter() - t1
            _validate_distinct_uids(result_features)
        prefitted = None
        if self._workflow_cv:
            t2 = time.perf_counter()
            prefitted = self._find_best_with_workflow_cv(result_features, ds)
            seconds["workflow_cv"] = time.perf_counter() - t2
        t3 = time.perf_counter()
        plan = PreparePlan(result_features, device=self.device,
                           listener=self._listener)
        train_ds, fitted = plan.execute(ds, prefitted=prefitted)
        self.last_prepare_plan = plan
        seconds["prepare_and_fit"] = time.perf_counter() - t3
        self.last_train_seconds = seconds
        result = tuple(f.copy_with_new_stages(fitted)
                       for f in result_features)
        if self._listener is not None:
            self._listener.on_application_end()
        return WorkflowModel(
            result_features=result, train_dataset=train_ds,
            raw_feature_filter_results=self.raw_feature_filter_results,
            blacklisted_feature_names=[f.name for f
                                       in self.blacklisted_features])

    def _filter_raw(self, raw: List[Feature], ds: Dataset
                    ) -> Tuple[Feature, ...]:
        """Run the raw feature filter over the training (and scoring) raw
        columns and rewire the DAG without the excluded features
        (reference generateRawData -> RawFeatureFilter
        .generateFilteredRaw, OpWorkflow.scala:222)."""
        from ..checkers import rewire_without
        score_ds = None
        if self._rff_score_data is not None:
            score_ds = _generate_raw_data(raw, self._rff_score_data,
                                          require_responses=False)
        responses = [f for f in raw if f.is_response]
        label = None
        if len(responses) == 1 and responses[0].name in ds \
                and ds[responses[0].name].kind == "numeric":
            # non-numeric labels skip the null-label correlation check
            label = np.asarray(ds[responses[0].name].data, dtype=np.float64)
        results = self._raw_feature_filter.compute_exclusions(
            raw, ds, score_ds, label=label)
        self.raw_feature_filter_results = results
        if not results.excluded_names:
            return self.result_features
        result_features, removed = rewire_without(
            self.result_features, results.excluded_names)
        self.blacklisted_features = tuple(removed)
        return tuple(result_features)

    def _find_best_with_workflow_cv(self, result_features, ds: Dataset
                                    ) -> Optional[Dict[str, PipelineStage]]:
        """Leakage-free model selection (reference OpWorkflow.scala:
        388-440 + OpValidator.applyDAG:228): refit the in-CV DAG segment
        per fold, validate the candidates on the per-fold matrices, preset
        the winner on the selector. Returns the models the pre-pass
        fitted (the selector's ancestors outside the segment, on the full
        data) so that the final prepare plan reuses them; the segment
        itself is refit on the full data there.

        The pre-pass is a PreparePlan on the workflow's device over those
        ancestors, so the fold matrices are row gathers of its device
        matrix; the segment is refit per fold on the device. As in the
        JAX package, the selector's splitter reserves the holdout before
        folding, estimates one resampling plan from the search labels and
        resamples each fold's train and validation rows with it after the
        refit."""
        selector, during = cut_dag(result_features)
        if selector is None or not during:
            return None  # nothing label-consuming feeds the selector
        during_uids = {s.uid for layer in during for s in layer}
        label_f, features_f = selector.input_features
        t0 = time.perf_counter()
        # 1. the segment's outside inputs (and the label), fitted once on
        #    the full data: the reference's nonCVTS DAG
        outside = [f for layer in during for s in layer
                   for f in s.input_features
                   if f.origin_stage is None
                   or f.origin_stage.uid not in during_uids]
        if label_f.origin_stage is None \
                or label_f.origin_stage.uid not in during_uids:
            outside.append(label_f)
        outside = list({f.uid: f for f in outside}.values())
        pre, prefitted = PreparePlan(outside, device=self.device
                                     ).execute(ds)
        if label_f.name not in pre:
            return prefitted
        # 2. reserve the holdout before folding so that the search never
        #    sees it; the indices are preset on the selector so that its
        #    final fit reuses this split
        y_pre = host_column(pre[label_f.name]).data.astype(np.float64)
        splitter = selector.splitter
        reserved = None
        if splitter is not None:
            splitter.reset_plan()
            tr_idx, te_idx = splitter.split(y_pre)
            reserved = (tr_idx, te_idx)
            if len(te_idx):
                pre, y_pre = pre.take(tr_idx), y_pre[tr_idx]
            est = getattr(splitter, "estimate", None)
            if est is not None:   # one global resampling plan
                est(y_pre)
        t1 = time.perf_counter()
        # 3. per fold: refit the segment on the fold's train rows,
        #    transform its validation rows with those fitted stages, then
        #    apply the splitter's resampling plan to both
        validator = selector.validator
        folds, refit_s = [], []
        for train_idx, val_idx in validator._splits(y_pre):
            tf = time.perf_counter()
            tr_ds, fitted_cv = _fit_segment(during, pre.take(train_idx))
            val_ds = _transform_with_fitted(during, fitted_cv,
                                            pre.take(val_idx))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            refit_s.append(time.perf_counter() - tf)
            fold = [tr_ds[features_f.name].data,
                    host_column(tr_ds[label_f.name]).data,
                    val_ds[features_f.name].data,
                    host_column(val_ds[label_f.name]).data]
            if splitter is not None:
                ridx = splitter.prepare(fold[1])
                vidx = splitter.prepare(fold[3])
                fold = [take_rows(fold[0], ridx), fold[1][ridx],
                        take_rows(fold[2], vidx), fold[3][vidx]]
            folds.append(tuple(fold))
        t2 = time.perf_counter()
        selector.best_estimator = validator.validate_prepared(
            selector.models, folds)
        # preset only once the search succeeded
        if reserved is not None:
            selector.preset_split = reserved
        self.last_workflow_cv = {
            "prepass_seconds": t1 - t0, "fold_refit_seconds": refit_s,
            "fold_widths": [int(f[0].shape[1]) for f in folds],
            "fold_train_rows": [int(f[0].shape[0]) for f in folds],
            "search_seconds": time.perf_counter() - t2}
        return prefitted


class WorkflowModel:
    """A fitted workflow: every origin stage in the result-feature DAG is a
    transformer (reference OpWorkflowModel.scala:58)."""

    def __init__(self, result_features: Tuple[Feature, ...],
                 train_dataset: Optional[Dataset] = None,
                 raw_feature_filter_results=None,
                 blacklisted_feature_names=()):
        self.result_features = tuple(result_features)
        #: transformed training data (all intermediate columns; those the
        #: prepare plan computed on the device hold tensors there)
        self.train_dataset = train_dataset
        #: RawFeatureFilterResults carried into the fitted model and the
        #: saved op-model.json (reference OpWorkflowModelWriter:75-120)
        self.raw_feature_filter_results = raw_feature_filter_results
        self.blacklisted_feature_names = list(blacklisted_feature_names)
        #: the directory the model was saved to or loaded from: the
        #: drift sentinel reads its training fingerprints there
        self.model_dir: Optional[str] = None

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

    def compute_data_up_to(self, feature: Feature, data: Any) -> Dataset:
        """Materialize all columns needed to produce ``feature``
        (reference computeDataUpTo:105). ``feature`` may be the
        pre-training handle; it is resolved into the fitted DAG by uid."""
        feature = self._resolve(feature)
        ds = _generate_raw_data(_unique_raw_features([feature]), data,
                                require_responses=False)
        return _fit_and_transform_layers(topo_layers([feature]), ds)

    def _resolve(self, feature: Feature) -> Feature:
        """The fitted-DAG feature with ``feature``'s uid (features keep
        their uid through copy_with_new_stages)."""
        found: List[Feature] = []

        def visit(f: Feature):
            if f.uid == feature.uid:
                found.append(f)

        for rf in self.result_features:
            rf.traverse(visit)
            if found:
                return found[0]
        raise KeyError(
            f"Feature {feature.name!r} is not part of this workflow model")

    # -- explainability ----------------------------------------------------
    def model_insights(self):
        """Post-hoc explainability report
        (reference OpWorkflowModel.modelInsights:162)."""
        from ..insights import extract_model_insights
        return extract_model_insights(self)

    def summary(self) -> str:
        """JSON summary of all stage metadata (reference summary:182)."""
        return json.dumps(self.model_insights().to_json(), indent=1,
                          default=str)

    def summary_pretty(self) -> str:
        """(reference summaryPretty:204): the insights, then the model
        selector's summary."""
        insights = self.model_insights()
        parts = [insights.pretty()]
        if insights.selected_model:
            from ..selector.selector import SelectedModel
            for s in self.stages():
                if isinstance(s, SelectedModel) and s.summary:
                    parts.append(s.summary.pretty())
                    break
        return "\n\n".join(parts)

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
