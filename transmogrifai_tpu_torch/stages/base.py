"""Stage kernel: pipeline stages, transformers, estimators.

The port's copy of ``transmogrifai_tpu/stages/base.py`` (reference
features/src/main/scala/com/salesforce/op/stages/{OpPipelineStages.scala:56,
base/*}). Key differences from the Spark design:

- The row-level ``OpTransformer.transformKeyValue`` interface
  (OpPipelineStages.scala:592) is replaced by a **columnar** batch interface
  ``transform_columns`` operating on numpy-backed ``FeatureColumn``s, and
  an array interface ``transform_arrays`` of plain torch ops on tensors,
  which the prepare plan runs on the workflow's device. A derived
  row-level path (``transform_value``) remains for local serving
  (``local/scoring.py``) and contract tests.
- The reference's reflective ctor-args capture for persistence
  (OpPipelineStageWriter.scala:78-120) becomes automatic-but-explicit ctor
  binding: every stage's ``__init__`` kwargs are recorded at construction
  and round-tripped through ``get_params`` / class registry lookup
  (``workflow/persistence.py``). The record holds references, not copies:
  a fitted model's tensors are the ones the model keeps.

Arity conventions mirror the reference: Unary/Binary/Ternary/Quaternary
plus Sequence (N same-typed inputs) and BinarySequence (1 + N).
"""
from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, ClassVar, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from ..types import FeatureType, OPVector
from ..utils.uid import uid as make_uid

if False:  # TYPE_CHECKING without importing typing's guard at runtime:
    from ..features.columns import Dataset, FeatureColumn  # noqa: F401
    from ..features.feature import Feature  # noqa: F401

__all__ = [
    "PipelineStage", "AllowLabelAsInput", "Transformer", "Estimator", "Model",
    "UnaryTransformer", "UnaryEstimator", "UnaryModel",
    "BinaryTransformer", "BinaryEstimator", "BinaryModel",
    "TernaryTransformer", "QuaternaryTransformer",
    "SequenceTransformer", "SequenceEstimator", "SequenceModel",
    "BinarySequenceTransformer", "BinarySequenceEstimator",
    "LambdaTransformer", "stage_class_by_name", "register_stage_class",
]

_STAGE_REGISTRY: Dict[str, type] = {}


def register_stage_class(cls):
    _STAGE_REGISTRY[cls.__name__] = cls
    return cls


def stage_class_by_name(name: str):
    """Resolve a stage class for deserialization, importing the checkers,
    insights, ops, models and selector packages first so their classes
    register (reference OpPipelineStageReader class-for-name,
    OpPipelineStageReader.scala:89-135)."""
    if name in _STAGE_REGISTRY:
        return _STAGE_REGISTRY[name]
    from .. import checkers as _checkers  # noqa: F401
    from .. import insights as _insights  # noqa: F401
    from .. import models as _models  # noqa: F401
    from .. import ops as _ops  # noqa: F401
    from .. import selector as _selector  # noqa: F401
    if name in _STAGE_REGISTRY:
        return _STAGE_REGISTRY[name]
    raise KeyError(f"Unknown stage class {name!r}")


class PipelineStage:
    """Base of all stages (reference OpPipelineStageBase,
    OpPipelineStages.scala:56)."""

    #: expected input feature types; None entries accept any FeatureType.
    #: For sequence stages this is the per-element type.
    input_types: ClassVar[Optional[Tuple[Optional[type], ...]]] = None
    #: produced output feature type
    output_type: ClassVar[Type[FeatureType]] = OPVector
    #: minimum number of inputs for sequence stages
    min_inputs: ClassVar[int] = 1
    #: whether ``fit_columns`` / ``transform_columns`` take a column whose
    #: values are a device tensor as it is; the prepare plan copies such
    #: columns to the host for every other stage
    device_inputs: ClassVar[bool] = False

    def __init__(self, operation_name: Optional[str] = None,
                 uid: Optional[str] = None):
        self.operation_name = operation_name or type(self).__name__
        self.uid = uid or make_uid(type(self))
        self.input_features: Tuple[Feature, ...] = ()
        self._output_feature: Optional["Feature"] = None

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        register_stage_class(cls)
        orig = cls.__init__
        if getattr(orig, "_captures_ctor", False):
            return
        try:
            sig = inspect.signature(orig)
        except (TypeError, ValueError):  # pragma: no cover
            return

        @functools.wraps(orig)
        def wrapper(self, *args, **kwargs):
            if not hasattr(self, "_ctor_args"):
                try:
                    bound = sig.bind(self, *args, **kwargs)
                    bound.apply_defaults()
                    captured = {}
                    for name, val in bound.arguments.items():
                        if name == "self":
                            continue
                        p = sig.parameters[name]
                        if p.kind == inspect.Parameter.VAR_KEYWORD:
                            captured.update(val)
                        elif p.kind == inspect.Parameter.VAR_POSITIONAL:
                            captured[name] = list(val)
                        else:
                            captured[name] = val
                    self._ctor_args = captured
                except TypeError:
                    self._ctor_args = {}
            orig(self, *args, **kwargs)

        wrapper._captures_ctor = True
        cls.__init__ = wrapper

    # -- wiring ------------------------------------------------------------
    def set_input(self, *features: "Feature") -> "PipelineStage":
        """Typed input wiring (reference OpPipelineStages.setInput:80)."""
        self._check_input_types(features)
        self.check_input_constraints(features)
        self.input_features = tuple(features)
        self._output_feature = None  # re-wiring invalidates the output
        return self

    def _check_input_types(self, features: Sequence[Feature]) -> None:
        expected = self.expected_input_types(len(features))
        if len(features) != len(expected):
            raise ValueError(
                f"{type(self).__name__} expects {len(expected)} inputs, "
                f"got {len(features)}")
        for i, (f, t) in enumerate(zip(features, expected)):
            if t is not None and not issubclass(f.ftype, t):
                raise TypeError(
                    f"{type(self).__name__} input {i} ({f.name!r}) must be "
                    f"{t.__name__}, got {f.ftype.__name__}")

    def expected_input_types(self, n: int) -> List[Optional[type]]:
        if self.input_types is None:
            return [None] * n
        if getattr(self, "is_sequence", False):
            if n < self.min_inputs:
                raise ValueError(
                    f"{type(self).__name__} needs >= {self.min_inputs} inputs")
            fixed = list(self.input_types[:-1])
            elem = self.input_types[-1]
            return fixed + [elem] * (n - len(fixed))
        return list(self.input_types)

    def check_input_constraints(self, features: Sequence[Feature]) -> None:
        """Hook for semantic checks, e.g. response/predictor constraints
        (reference CheckIsResponseValues)."""

    # -- static type metadata ---------------------------------------------
    def static_output_type(self) -> Type[FeatureType]:
        """The declared output feature type (instance attribute aware —
        e.g. LambdaTransformer's per-instance output_type)."""
        return self.output_type

    # -- output ------------------------------------------------------------
    def output_is_response(self) -> bool:
        """A feature derived from any response is itself a response, so it
        can never silently re-enter the predictor matrix (label-leakage
        guard; reference OpPipelineStages.scala:56 `exists(_.isResponse)`).
        Stages that consume the label to produce predictors (the
        SanityChecker) mix in ``AllowLabelAsInput``."""
        return (len(self.input_features) > 0
                and any(f.is_response for f in self.input_features))

    def output_feature_name(self) -> str:
        names = [f.name for f in self.input_features]
        base = "-".join(names[:3]) + (f"-{len(names) - 3}more"
                                      if len(names) > 3 else "")
        suffix = self.uid.rsplit("_", 1)[-1]
        return f"{base}_{self.operation_name}_{suffix}" if base \
            else f"{self.operation_name}_{suffix}"

    def get_output(self) -> "Feature":
        """The (lazy) output feature (reference getOutput). Idempotent:
        repeated calls return the same Feature (same uid) until the stage
        is re-wired with ``set_input``."""
        from ..features.feature import Feature
        if self.input_features == () and not isinstance(self, _ZeroInput):
            raise ValueError(
                f"{type(self).__name__}.get_output() before set_input()")
        if self._output_feature is not None:
            return self._output_feature
        self._output_feature = Feature(
            name=self.output_feature_name(),
            ftype=self.output_type,
            is_response=self.output_is_response(),
            origin_stage=self,
            parents=self.input_features,
        )
        return self._output_feature

    # -- persistence -------------------------------------------------------
    def stage_name(self) -> str:
        return f"{type(self).__name__}_{self.operation_name}"

    def get_params(self) -> Dict[str, Any]:
        """Constructor kwargs captured at instantiation — JSON/npz
        round-trippable (replaces reflective ctor capture,
        OpPipelineStageWriter.scala:78-120)."""
        return dict(getattr(self, "_ctor_args", {}))

    def __repr__(self) -> str:
        ins = ", ".join(f.name for f in self.input_features)
        return f"{type(self).__name__}(uid={self.uid}, inputs=[{ins}])"


class _ZeroInput:
    """Marker for stages with no inputs (feature generators)."""


class AllowLabelAsInput:
    """Mixin for stages allowed to consume the label while producing
    predictor outputs (reference AllowLabelAsInput; the SanityChecker and
    its model). Output is a response only if *every* input is."""

    def output_is_response(self) -> bool:
        return (len(self.input_features) > 0
                and all(f.is_response for f in self.input_features))


class Transformer(PipelineStage):
    """A fitted/stateless row-batch transformation
    (reference OpTransformer, OpPipelineStages.scala:592)."""

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        raise NotImplementedError

    # -- device lowering (plans/prepare.py) ---------------------------------
    def transform_arrays(self, arrays: List[Any]) -> Any:
        """Array-level kernel: one tensor per wired input slot (as
        produced by ``encode_input_column`` or an upstream stage's
        kernel, on the workflow's device), ONE tensor out, computed with
        torch ops on that device. Stages without a lowering keep this
        default; the plan then runs their host ``transform_columns``
        and records it in its coverage."""
        raise NotImplementedError(
            f"{type(self).__name__} has no array lowering")

    def supports_arrays(self) -> bool:
        """Whether this stage lowers to an array kernel (plan coverage
        probe). Default: ``transform_arrays`` overridden somewhere below
        ``Transformer``."""
        return type(self).transform_arrays is not Transformer.transform_arrays

    def encodes_input(self, i: int) -> bool:
        """True when input slot ``i`` needs a stage-specific host
        encoder (``encode_input_column`` override) rather than the
        identity numeric/vector encoding — e.g. a trained
        category->index lookup. The plan only lowers such a stage when
        that input is host-materialized (raw or host-stage output),
        never when it is produced on the device."""
        return False

    def encode_input_column(self, i: int, col: "FeatureColumn") -> np.ndarray:
        """Host-side boundary encoder: FeatureColumn -> the dense
        numeric array input slot ``i`` of ``transform_arrays`` expects.
        The default is the identity encoding for numeric/vector columns
        (so in-graph arrays and host-encoded arrays are
        interchangeable); object columns must be encoded by a
        stage-specific override (``encodes_input`` -> True)."""
        kind = col.kind
        if kind == "numeric":
            return np.asarray(col.data, dtype=np.float64)
        if kind == "vector":
            return np.asarray(col.data, dtype=np.float64)
        raise TypeError(
            f"{type(self).__name__} input {i} ({col.ftype.__name__}, "
            f"kind={kind!r}) has no default array encoding")

    def transform_dataset(self, ds: Dataset) -> Dataset:
        out = self.get_output()
        cols = [ds[f.name] for f in self.input_features]
        return ds.with_column(out.name, self.transform_columns(cols))

    def transform_value(self, *values: Any) -> FeatureType:
        """Row-level path (reference transformKeyValue). Default
        implementation routes a single-row column batch through
        ``transform_columns``."""
        from ..features.columns import FeatureColumn
        cols = []
        for f, v in zip(self.input_features, values):
            fv = v if isinstance(v, FeatureType) else f.ftype(v)
            cols.append(FeatureColumn.from_values(f.ftype, [fv]))
        return self.transform_columns(cols).boxed(0)


class Estimator(PipelineStage):
    """A stage that must be fitted to produce a Model
    (reference base/unary/UnaryEstimator.scala:56 et al.)."""

    def fit_columns(self, cols: List[FeatureColumn]) -> "Model":
        raise NotImplementedError

    def fit(self, ds: Dataset) -> "Model":
        cols = [ds[f.name] for f in self.input_features]
        model = self.fit_columns(cols)
        #: back-pointer so downstream stages executing mid-training can
        #: resolve the fitted model before the DAG swap (e.g.
        #: PredictionDeIndexer reading StringIndexer labels). Only valid
        #: during the train() that set it — after training, the swapped
        #: DAG points at the fitted model directly, so consumers must
        #: prefer the origin stage itself over this pointer.
        self.fitted_model = model
        return self._wire_model(model)

    def _wire_model(self, model: "Model") -> "Model":
        """Fitted model inherits the estimator's uid, wiring and operation
        name so DAG stage-swapping by uid works
        (reference: models share the estimator uid)."""
        model.uid = self.uid
        model.operation_name = self.operation_name
        model.input_features = self.input_features
        model.parent_estimator_class = type(self).__name__
        return model


class Model(Transformer):
    """A fitted transformer produced by an Estimator."""
    parent_estimator_class: Optional[str] = None


# ---------------------------------------------------------------------------
# Arity-specific bases (reference base/{unary,binary,ternary,quaternary,
# sequence}/)
# ---------------------------------------------------------------------------

class UnaryTransformer(Transformer):
    """1 input -> 1 output (reference base/unary/UnaryTransformer.scala:75)."""


class UnaryModel(Model, UnaryTransformer):
    pass


class UnaryEstimator(Estimator):
    pass


class BinaryTransformer(Transformer):
    pass


class BinaryModel(Model, BinaryTransformer):
    pass


class BinaryEstimator(Estimator):
    pass


class TernaryTransformer(Transformer):
    pass


class QuaternaryTransformer(Transformer):
    pass


class _SequenceMixin:
    is_sequence: ClassVar[bool] = True


class SequenceTransformer(_SequenceMixin, Transformer):
    """N same-typed inputs -> 1 output."""


class SequenceModel(_SequenceMixin, Model):
    pass


class SequenceEstimator(_SequenceMixin, Estimator):
    """The vectorizer workhorse (reference
    base/sequence/SequenceEstimator.scala:57)."""


class BinarySequenceTransformer(_SequenceMixin, Transformer):
    """1 distinguished input + N same-typed inputs."""


class BinarySequenceEstimator(_SequenceMixin, Estimator):
    pass


class LambdaTransformer(UnaryTransformer):
    """Generic ``.map``-style transformer over boxed values (reference
    RichFeature.map / lambda transformers). The function operates on boxed
    feature values row-wise — intended for user extract-style logic, not
    hot paths. Not serializable unless the function is importable."""

    def __init__(self, fn: Callable[[FeatureType], FeatureType],
                 output_type: Type[FeatureType],
                 operation_name: str = "lambda",
                 uid: Optional[str] = None):
        super().__init__(operation_name=operation_name, uid=uid)
        self.fn = fn
        self.output_type = output_type  # instance attr shadows classvar

    def transform_columns(self, cols: List["FeatureColumn"]) -> "FeatureColumn":
        from ..features.columns import FeatureColumn
        col = cols[0]
        out = [self.fn(col.boxed(i)) for i in range(col.n_rows)]
        return FeatureColumn.from_values(self.output_type, out)
