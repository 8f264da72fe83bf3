"""Local (engine-free) scoring: model -> plain ``dict -> dict`` function.

The port's copy of ``transmogrifai_tpu/local/scoring.py`` (reference
local/src/main/scala/com/salesforce/op/local/
{OpWorkflowModelLocal.scala:52,88-120, OpWorkflowRunnerLocal.scala:41}):
a saved workflow model becomes a scoring closure that folds one record's
values through every stage's row-level ``transform_value`` path in DAG
order. The vectorizers run on the host; the model stage predicts on the
device its model was loaded on (``predict_arrays`` copies the record's
vector there and runs ``raw_arrays``).

Batch scoring (``score_batch``) runs through the compiled ``ScoringPlan``
(``serving/plan.py``: one CUDA graph per row bucket on the card) by
default; ``engine="records"`` loops the per-record path. With
``guardrails`` set, batches go through the plan's guarded path. Unlike the
JAX package, a plan that cannot compile raises instead of falling back to
the record loop.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..features.feature import Feature, topo_layers
from ..features.generator import FeatureGeneratorStage
from ..types import FeatureType, Prediction

_log = logging.getLogger(__name__)

__all__ = ["ScoreFunction", "load_score_function", "score_function_for"]


def _unbox(value: Any) -> Any:
    if isinstance(value, Prediction):
        return dict(value.value)
    if isinstance(value, FeatureType):
        v = value.value
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, (set, frozenset)):
            try:
                return sorted(v)
            except TypeError:
                # mixed-type members are unorderable: a repr ordering
                return sorted(v, key=repr)
        return v
    return value


class ScoreFunction:
    """``fn(record: dict) -> dict`` over the fitted DAG
    (reference model.scoreFunction, OpWorkflowModelLocal.scala:88)."""

    def __init__(self, model, result_features: Optional[Sequence[Feature]]
                 = None, guardrails: Any = False):
        self.model = model
        self.result_features = list(result_features
                                    or model.result_features)
        self.raw_features = model.raw_features()
        self._plan = [s for layer in topo_layers(self.result_features)
                      for s in layer
                      if not isinstance(s, FeatureGeneratorStage)]
        #: extraction failures observed so far (an extract fn raising on
        #: a record nulls that field instead of failing the request; the
        #: count and the per-feature breakdown make that visible)
        self.extract_errors = 0
        self.extract_error_fields: Dict[str, int] = {}
        #: serving guardrails: False = off, True = defaults, or a dict of
        #: ``ScoringPlan.with_guardrails`` kwargs (the defaults include the
        #: drift sentinel). Guarded batches attach a ``"_guard"`` entry to quarantined or invalidated rows and keep
        #: the ledger on ``last_guard_result``.
        self.guardrails = guardrails
        self.last_guard_result = None
        self._compiled_plan = None

    def _extract_raw(self, record: Dict[str, Any]
                     ) -> Dict[str, FeatureType]:
        """One record -> boxed raw feature values, with the serving
        edge's error policy: a raising extract fn nulls the field (and
        is counted), a missing response gets an ignored placeholder."""
        values: Dict[str, FeatureType] = {}
        for f in self.raw_features:
            gen = f.origin_stage
            if isinstance(gen, FeatureGeneratorStage):
                try:
                    raw = gen.extract_fn(record)
                except Exception:
                    raw = None
                    self._note_extract_error(f.name)
            else:
                raw = record.get(f.name)
            if raw is None and f.is_response:
                # label-free scoring: prediction stages ignore the label
                # value, so any placeholder works (NaN for non-nullables)
                try:
                    values[f.name] = f.ftype.from_any(None)
                except Exception:
                    values[f.name] = f.ftype(0.0)
                continue
            values[f.name] = raw if isinstance(raw, FeatureType) \
                else f.ftype.from_any(raw)
        return values

    def _note_extract_error(self, feature_name: str) -> None:
        self.extract_errors += 1
        count = self.extract_error_fields.get(feature_name, 0) + 1
        self.extract_error_fields[feature_name] = count
        if count == 1:  # one warning per feature, not per record
            _log.warning(
                "extract fn for raw feature %r raised; the field is "
                "scored as missing (see ScoreFunction.extract_errors)",
                feature_name)

    def __call__(self, record: Dict[str, Any]) -> Dict[str, Any]:
        values = self._extract_raw(record)
        for stage in self._plan:
            ins = [values[f.name] for f in stage.input_features]
            out = stage.get_output()
            values[out.name] = stage.transform_value(*ins)
        return {f.name: _unbox(values[f.name])
                for f in self.result_features}

    # -- batch path --------------------------------------------------------
    def _scoring_plan(self):
        """The compiled ScoringPlan for this model, built once: a guarded
        one of its own (guarded scoring keeps breaker state), else the
        model's cached plan."""
        if self._compiled_plan is None:
            from ..serving import ScoringPlan
            if self.guardrails:
                kwargs = (self.guardrails
                          if isinstance(self.guardrails, dict) else {})
                self._compiled_plan = ScoringPlan(
                    self.model).compile().with_guardrails(**kwargs)
            else:
                builder = getattr(self.model, "scoring_plan", None)
                self._compiled_plan = builder() if callable(builder) \
                    else ScoringPlan(self.model).compile()
        return self._compiled_plan

    def score_batch(self, records: Sequence[Dict[str, Any]],
                    engine: str = "compiled") -> List[Dict[str, Any]]:
        """Score many records in one shot. ``engine="compiled"`` (the
        default) runs the whole batch through the plan, one graph replay
        per chunk on the card; ``engine="records"`` loops the per-record
        path."""
        if engine not in ("compiled", "records"):
            raise ValueError(
                f"engine must be 'compiled' or 'records', got {engine!r}")
        records = list(records)
        if engine == "records" or not records:
            return [self(r) for r in records]
        plan = self._scoring_plan()
        if self.guardrails:
            return self._score_batch_guarded(plan, records)
        from ..features.columns import Dataset, FeatureColumn
        boxed = [self._extract_raw(r) for r in records]
        ds = Dataset({
            f.name: FeatureColumn.from_values(
                f.ftype, [b[f.name] for b in boxed])
            for f in self.raw_features})
        scored = plan.score_raw_dataset(ds)
        cols = [scored[f.name] for f in self.result_features]
        return [{f.name: _unbox(col.boxed(i))
                 for f, col in zip(self.result_features, cols)}
                for i in range(len(records))]

    def _score_batch_guarded(self, plan, records
                             ) -> List[Dict[str, Any]]:
        """Guarded batch path: admission, output guards and the breaker.
        Quarantined or invalidated rows carry a ``"_guard"`` entry with
        machine-readable reasons instead of NaN scores."""
        result = plan.score_guarded(records)
        self.last_guard_result = result
        return result.boxed_rows([f.name for f in self.result_features])


def score_function_for(model) -> ScoreFunction:
    """Build a local scoring closure from an in-memory fitted model."""
    return ScoreFunction(model)


def load_score_function(path: str, device="cuda") -> ScoreFunction:
    """Load a saved model directory into a scoring closure whose model
    stage predicts on ``device`` (default the CUDA card; raises without
    one) (reference OpWorkflowRunnerLocal:41)."""
    from ..workflow.persistence import load_model
    return ScoreFunction(load_model(path, device=device))
