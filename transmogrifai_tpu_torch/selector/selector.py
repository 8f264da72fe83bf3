"""ModelSelector: automated model selection over the ported families.

Counterpart of ``transmogrifai_tpu/selector/selector.py``
(``ModelSelector.fit_arrays`` and ``fit_columns``, ``SelectedModel``,
``ModelSelectorSummary`` with its JSON round trip, racing record and
``pretty``, ``models_x_folds``): prepare the data with the splitter
(holdout reserve, balancing), validate every candidate (family x grid
point) under cross-validation, racing or a train/validation split, refit
the winner on the full prepared training set (behind the retry policy),
and evaluate it on the training set and the holdout. The runtime's knobs
(``checkpoint_dir``, ``retry_policy``, ``family_deadline``) pass to the
validator for each search; the families it quarantined are named in
``summary.quarantined``. Workflow-level CV presets the winner and
the holdout split (``best_estimator``, ``preset_split``). As a workflow
stage the selector receives the prepared feature matrix as the tensor the
prepare plan computed on the device (``Predictor.fit_columns``) and
searches it there.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..evaluators.base import EvaluationMetrics
from ..models.base import PredictionColumn, PredictionModel, Predictor
from ..utils.device import resolve_device, take_rows
from .splitters import Splitter, SplitterSummary
from .validator import (BestEstimator, CrossValidation, ValidationResult,
                        _ValidatorBase)

__all__ = ["ModelSelector", "SelectedModel", "ModelSelectorSummary",
           "models_x_folds"]


@dataclass
class ModelSelectorSummary:
    """Full validation record."""
    validation_type: str = ""
    validation_parameters: Dict = field(default_factory=dict)
    data_prep_parameters: Dict = field(default_factory=dict)
    data_prep_results: Dict = field(default_factory=dict)
    evaluation_metric: str = ""
    problem_type: str = ""
    best_model_name: str = ""
    best_model_uid: str = ""
    best_model_params: Dict = field(default_factory=dict)
    best_validation_metric: float = 0.0
    validation_results: List[ValidationResult] = field(default_factory=list)
    train_evaluation: Optional[EvaluationMetrics] = None
    holdout_evaluation: Optional[EvaluationMetrics] = None
    metric_larger_better: bool = True
    #: multi-fidelity racing record (``RacingCrossValidation.last_report``:
    #: rung schedule, budgets, pruned counts); empty, and absent from the
    #: JSON, under exact validation
    racing: Dict = field(default_factory=dict)
    #: quarantine ledger (``runtime/errors.QuarantineRecord.to_json``
    #: rows): families removed from this search and why (a CUDA
    #: out-of-memory, a family fault, poisoned metrics, a deadline);
    #: empty, and absent from the JSON, on a fault-free search
    quarantined: List[Dict] = field(default_factory=list)
    #: host seconds of each stage of ``fit_arrays`` (prepare, validate,
    #: refit, evaluate); each stage ends in a read-back from the device.
    #: Kept in memory only: ``to_json`` writes the JAX package's keys
    timings: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> dict:
        def metrics_class(m):
            # a RawMetrics holder re-records the class it was loaded as
            return (getattr(m, "class_name", "") or type(m).__name__
                    if m else None)
        out = {
            "validationType": self.validation_type,
            "validationParameters": self.validation_parameters,
            "dataPrepParameters": self.data_prep_parameters,
            "dataPrepResults": self.data_prep_results,
            "evaluationMetric": self.evaluation_metric,
            "problemType": self.problem_type,
            "bestModelName": self.best_model_name,
            "bestModelUID": self.best_model_uid,
            "bestModelParams": self.best_model_params,
            "bestValidationMetric": self.best_validation_metric,
            "validationResults": [r.to_json()
                                  for r in self.validation_results],
            "metricLargerBetter": self.metric_larger_better,
            "trainEvaluation": (self.train_evaluation.to_json()
                                if self.train_evaluation else None),
            "trainEvaluationClass": metrics_class(self.train_evaluation),
            "holdoutEvaluation": (self.holdout_evaluation.to_json()
                                  if self.holdout_evaluation else None),
            "holdoutEvaluationClass": metrics_class(
                self.holdout_evaluation),
        }
        if self.racing:
            out["racing"] = self.racing
        if self.quarantined:
            out["quarantined"] = self.quarantined
        return out

    @classmethod
    def from_json(cls, d: dict) -> "ModelSelectorSummary":
        """Inverse of :meth:`to_json` (model load)."""
        from ..evaluators.base import metrics_from_json

        def metrics(which: str):
            payload = d.get(which)
            name = d.get(which + "Class")
            return (metrics_from_json(name, payload)
                    if payload is not None and name else None)

        return cls(
            validation_type=d.get("validationType", ""),
            validation_parameters=d.get("validationParameters") or {},
            data_prep_parameters=d.get("dataPrepParameters") or {},
            data_prep_results=d.get("dataPrepResults") or {},
            evaluation_metric=d.get("evaluationMetric", ""),
            problem_type=d.get("problemType", ""),
            best_model_name=d.get("bestModelName", ""),
            best_model_uid=d.get("bestModelUID", ""),
            best_model_params=d.get("bestModelParams") or {},
            best_validation_metric=d.get("bestValidationMetric", 0.0),
            validation_results=[ValidationResult.from_json(r)
                                for r in d.get("validationResults", [])],
            train_evaluation=metrics("trainEvaluation"),
            holdout_evaluation=metrics("holdoutEvaluation"),
            metric_larger_better=d.get("metricLargerBetter", True),
            racing=d.get("racing") or {},
            quarantined=d.get("quarantined") or [],
        )

    def pretty(self) -> str:
        """Human summary (reference summaryPretty,
        OpWorkflowModel.scala:204): the winner, then every grid point's
        mean metric, best first; a raced candidate says where it was
        pruned or that it is a finalist; then the quarantined families."""
        lines = [
            f"Selected model: {self.best_model_name} "
            f"({self.evaluation_metric}={self.best_validation_metric:.4f} "
            f"under {self.validation_type})",
            f"Best params: {self.best_model_params}",
            "Validation results (mean metric per grid point):",
        ]
        sign = -1.0 if self.metric_larger_better else 1.0

        def rank(r):  # non-finite metrics sort last
            m = r.mean_metric
            return sign * m if np.isfinite(m) else np.inf

        for r in sorted(self.validation_results, key=rank):
            # a pruned candidate's low-fidelity mean is not comparable to
            # a full-CV one
            racing = ""
            if r.rung is not None:
                racing = (f"  [pruned@rung{r.pruned_at}]"
                          if r.pruned_at is not None else "  [finalist]")
            lines.append(f"  {r.model_name}[{r.grid_index}] "
                         f"{r.params} -> {r.mean_metric:.4f}{racing}")
        if self.quarantined:
            lines.append("Quarantined families (search degraded to "
                         "survivors):")
            for q in self.quarantined:
                retries = (f" after {q.get('retries')} retries"
                           if q.get("retries") else "")
                lines.append(f"  {q.get('family')}: [{q.get('kind')}] "
                             f"{q.get('reason')}{retries}")
        return "\n".join(lines)


class SelectedModel(PredictionModel):
    """The winning fitted model with its selection summary; prediction
    delegates to the winner. The defaults let the model loader rebuild
    it from its saved constructor arguments."""

    def __init__(self, inner: PredictionModel = None,
                 summary: Optional[ModelSelectorSummary] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="modelSelector", uid=uid)
        self.inner = inner
        self.summary = summary

    @property
    def device(self) -> Optional[torch.device]:
        """The winner's device (None before it is set)."""
        return getattr(self.inner, "device", None)

    def predict_arrays(self, X) -> PredictionColumn:
        return self.inner.predict_arrays(X)

    def raw_arrays(self, X: torch.Tensor) -> torch.Tensor:
        return self.inner.raw_arrays(X)

    def supports_arrays(self) -> bool:
        return self.inner is not None and self.inner.supports_arrays()

    def prediction_from_raw(self, raw: np.ndarray) -> PredictionColumn:
        return self.inner.prediction_from_raw(raw)


def models_x_folds(model) -> int:
    """Total (candidate, fold) evaluations recorded by the selectors of a
    fitted workflow model: the unit of the search's throughput."""
    return sum(
        len(r.metric_values)
        for s in model.stages()
        if isinstance(s, SelectedModel) and s.summary is not None
        for r in s.summary.validation_results)


class ModelSelector(Predictor):
    """Run candidates x grids under a validator and pick the winner. Every
    candidate must compute on the selector's ``device``.
    ``validation="racing"`` turns a ``CrossValidation`` validator into its
    ``RacingCrossValidation`` twin (``selector/racing.py``: the same folds,
    seed and evaluator under successive halving, ``eta`` and
    ``min_fidelity`` its schedule)."""

    def __init__(self,
                 models: Sequence[Tuple[Predictor, Sequence[Dict]]] = (),
                 validator: Optional[_ValidatorBase] = None,
                 splitter: Optional[Splitter] = None,
                 problem_type: str = "", device="cuda",
                 validation: str = "exact", eta: Optional[int] = None,
                 min_fidelity: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None,
                 retry_policy=None,
                 family_deadline: Optional[float] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        if validation not in ("exact", "racing"):
            raise ValueError(f"validation must be 'exact' or 'racing', got "
                             f"{validation!r}")
        if validation == "racing" and validator is not None:
            from .racing import RacingCrossValidation
            if isinstance(validator, RacingCrossValidation):
                pass
            elif isinstance(validator, CrossValidation):
                validator = RacingCrossValidation.from_cross_validation(
                    validator, eta=eta, min_fidelity=min_fidelity)
            else:
                raise ValueError(
                    "validation='racing' requires a CrossValidation "
                    "validator (train/validation split has a single "
                    "fold — nothing to race)")
        self.device = resolve_device(device)
        for est, _ in models:
            est_dev = getattr(est, "device", None)
            if est_dev is not None and est_dev != self.device:
                raise ValueError(
                    f"{type(est).__name__} computes on {est_dev}, the "
                    f"selector on {self.device}")
        self.models = list(models)
        self.validator = validator
        self.splitter = splitter
        self.problem_type = problem_type
        #: journal completed (family, candidates, rung) evaluations under
        #: this directory, so an interrupted search resumes through
        #: ``Workflow.train(resume_from=...)`` without dispatching them
        self.checkpoint_dir = checkpoint_dir
        #: RetryPolicy of transient dispatch failures (None: the
        #: TX_RETRY_* environment defaults)
        self.retry_policy = retry_policy
        #: a family's search deadline in wall-clock seconds (None: off;
        #: also TX_FAMILY_DEADLINE_S)
        self.family_deadline = family_deadline
        #: winner found by workflow-level CV (reference findBestEstimator,
        #: ModelSelector.scala:113): when set, the fit skips validation
        #: and refits it on the full data; consumed by that fit
        self.best_estimator: Optional[BestEstimator] = None
        #: (train_idx, test_idx) reserved by workflow-level CV before its
        #: fold search, so that search and final fit share one split;
        #: consumed by the next fit
        self.preset_split = None

    def fit_arrays(self, X, y: np.ndarray) -> SelectedModel:
        """Search, refit and evaluate on ``X`` (n, d): numpy, or a tensor
        that stays where it is (row gathers, validation folds and every
        family's search run on its device; only metric matrices and
        predictions come back)."""
        if not self.models:
            raise ValueError("ModelSelector has no candidate models")
        if self.validator is None:
            raise ValueError("ModelSelector requires a validator")
        if isinstance(X, torch.Tensor):
            if X.device != self.device:
                raise ValueError(f"the feature matrix lies on {X.device}, "
                                 f"the selector computes on {self.device}")
        else:
            X = np.asarray(X)
        y = np.asarray(y, dtype=np.float64)

        timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        # 1. data prep: reserve a holdout, then resample the training part
        prep_params: Dict = {}
        prep_results: Dict = {}
        X_hold = y_hold = None
        if self.splitter is not None:
            if self.preset_split is not None:
                # workflow-level CV reserved the holdout already; reuse
                # its indices (and its estimated resampling plan)
                train_idx, test_idx = self.preset_split
                self.preset_split = None
            else:
                self.splitter.reset_plan()
                train_idx, test_idx = self.splitter.split(y)
            if len(test_idx):
                X_hold, y_hold = take_rows(X, test_idx), y[test_idx]
            X_tr, y_tr = take_rows(X, train_idx), y[train_idx]
            idx = self.splitter.prepare(y_tr)
            Xp, yp = take_rows(X_tr, idx), y_tr[idx]
            kept = getattr(self.splitter, "labels_kept", None)
            if kept is not None and X_hold is not None:
                # the refit model cannot predict the labels the cutter
                # dropped: the holdout keeps only the kept ones
                hold = np.nonzero(np.isin(y_hold, kept))[0]
                X_hold, y_hold = take_rows(X_hold, hold), y_hold[hold]
                if not len(y_hold):
                    X_hold = y_hold = None
            summ = self.splitter.summary or SplitterSummary()
            prep_params = summ.parameters
            prep_results = summ.results
        else:
            Xp, yp = X, y

        t1 = time.perf_counter()
        timings["prepare"] = t1 - t0
        # 2. validation, unless workflow-level CV found the winner
        # (ModelSelector.scala:136 bestEstimator.getOrElse); the preset is
        # consumed, so a reused selector validates its new data
        best: BestEstimator
        if self.best_estimator is not None:
            best, self.best_estimator = self.best_estimator, None
        else:
            # the runtime's knobs for this search: journal, retry, deadline
            v = self.validator
            if self.checkpoint_dir is not None:
                v.checkpoint_dir = self.checkpoint_dir
            if self.retry_policy is not None:
                v.retry_policy = self.retry_policy
            if self.family_deadline is not None:
                v.family_deadline = self.family_deadline
            best = self.validator.validate(self.models, Xp, yp)
        rt = getattr(self.validator, "last_runtime", None)
        quarantined = ([r.to_json() for r in rt.quarantined]
                       if rt is not None else [])
        t2 = time.perf_counter()
        timings["validate"] = t2 - t1

        # 3. refit the winner on the full prepared training set, behind
        # the retry policy: a transient error in the refit must not
        # discard the (journaled) search
        from ..runtime.retry import RetryPolicy
        retry = (self.retry_policy
                 or getattr(self.validator, "retry_policy", None)
                 or RetryPolicy.from_env())
        inner = retry.call(lambda: best.estimator.fit_arrays(Xp, yp),
                           description=f"winner-refit:{best.name}")
        t3 = time.perf_counter()
        timings["refit"] = t3 - t2

        # 4. training-set and holdout evaluation
        evaluator = self.validator.evaluator
        train_eval = evaluator.evaluate_arrays(yp, inner.predict_arrays(Xp))
        holdout_eval = None
        if X_hold is not None:
            holdout_eval = evaluator.evaluate_arrays(
                y_hold, inner.predict_arrays(X_hold))
        timings["evaluate"] = time.perf_counter() - t3

        summary = ModelSelectorSummary(
            validation_type=type(self.validator).__name__,
            validation_parameters=self.validator.get_params(),
            racing=dict(getattr(self.validator, "last_report", {}) or {}),
            quarantined=quarantined,
            data_prep_parameters=prep_params,
            data_prep_results=prep_results,
            evaluation_metric=evaluator.default_metric,
            problem_type=self.problem_type,
            best_model_name=best.name,
            best_model_uid=best.estimator.uid,
            best_model_params=best.params,
            best_validation_metric=best.metric,
            validation_results=best.results,
            train_evaluation=train_eval,
            holdout_evaluation=holdout_eval,
            metric_larger_better=evaluator.is_larger_better,
            timings=timings,
        )
        return SelectedModel(inner=inner, summary=summary)
