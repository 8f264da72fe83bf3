"""Serving guardrails: schema admission, output guards, circuit breaker.

The port's copy of ``transmogrifai_tpu/serving/guard.py``. Three pieces,
all off by default (a plan without a guard runs the unguarded path, so
the default ``score()`` output is unchanged):

- :class:`SchemaGuard` validates and coerces each incoming record
  against the model's raw-feature schema before vectorization.
  Malformed rows (missing required fields, uncoercible types, NaN/Inf
  numerics, out-of-vocab categoricals, unknown fields under a strict
  policy) are quarantined with a machine-readable reason while the rest
  of the batch scores: the bad rows are sanitized to placeholder values
  and masked out of the padded device batch, so no shape changes and no
  graph is captured again.
- :class:`OutputGuard` checks scored outputs for NaN/Inf and
  probabilities outside [0, 1]; a bad row is invalidated (its outputs
  overwritten with NaN) with a reason.
- :class:`CircuitBreaker` is a closed -> open -> half-open breaker over
  device dispatch: repeated device failures trip it; while open,
  batches score through the host columnar path at once; after a
  cooldown one probe batch tests recovery. Its clock is injectable.

Telemetry (``runtime/telemetry.py``) counts ``serving_rows_scored`` /
``serving_rows_quarantined`` / ``serving_rows_invalidated`` and every
breaker transition (``breaker_trips`` / ``breaker_half_open`` /
``breaker_recoveries``).
"""
from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from ..features.columns import (ColumnKind, Dataset, FeatureColumn,
                                PredictionColumn)
from ..runtime import telemetry as _telemetry
from ..runtime.errors import BUG, classify_error
from ..types import FeatureType, OPNumeric, Prediction

_log = logging.getLogger(__name__)

__all__ = ["AdmissionPolicy", "SchemaGuard", "OutputGuard",
           "CircuitBreaker", "BreakerOpenError", "GuardReason",
           "GuardedScoreResult", "ServingGuard", "fall_back_to_host",
           "REASON_MISSING_FIELD", "REASON_WRONG_TYPE",
           "REASON_NON_FINITE", "REASON_OUT_OF_VOCAB",
           "REASON_EXTRA_FIELD", "REASON_OUTPUT_NON_FINITE",
           "REASON_PROBABILITY_RANGE"]

# -- machine-readable reason codes (the admission matrix the tests walk) --
REASON_MISSING_FIELD = "missing_field"
REASON_WRONG_TYPE = "wrong_type"
REASON_NON_FINITE = "non_finite"
REASON_OUT_OF_VOCAB = "out_of_vocab"
REASON_EXTRA_FIELD = "extra_field"
REASON_OUTPUT_NON_FINITE = "output_non_finite"
REASON_PROBABILITY_RANGE = "probability_out_of_range"


@dataclass(frozen=True)
class GuardReason:
    """Why one row was quarantined (admission) or invalidated
    (output guard) — ``code`` is machine-readable, ``detail`` human."""
    row: int
    code: str
    feature: str = ""
    detail: str = ""

    def to_json(self) -> dict:
        return {"row": self.row, "code": self.code,
                "feature": self.feature, "detail": self.detail}


@dataclass
class AdmissionPolicy:
    """Knobs for :class:`SchemaGuard`.

    The defaults quarantine rows that would otherwise crash or
    silently mis-score (missing required fields, uncoercible values,
    non-finite numerics) and let the vectorizers' own OTHER/NULL
    handling absorb unseen categoricals and unknown record keys."""
    #: quarantine when a NON-NULLABLE predictor is missing/null
    require_fields: bool = True
    #: quarantine on NaN/±Inf in a numeric predictor value
    reject_non_finite: bool = True
    #: quarantine categorical values outside the model's fitted vocab
    #: (off: the one-hot OTHER column absorbs them, as at train time)
    reject_out_of_vocab: bool = False
    #: quarantine records carrying keys no raw feature extracts
    reject_extra_fields: bool = False
    #: cap on reasons recorded per batch (the ledger, not the masking —
    #: every bad row is masked regardless)
    max_reasons: int = 10_000


def _harvest_vocab(model) -> Dict[str, Set[str]]:
    """Fitted per-raw-feature category vocabularies, harvested from the
    one-hot family (``categories`` per input slot). Only raw features
    directly feeding a vectorizer get a vocab entry — derived columns
    are the model's own business."""
    vocab: Dict[str, Set[str]] = {}
    for stage in model.stages():
        cats = getattr(stage, "categories", None)
        if not isinstance(cats, list):
            continue
        for f, c in zip(getattr(stage, "input_features", ()), cats):
            if getattr(f, "is_raw", False) and isinstance(c, (list, set)):
                vocab.setdefault(f.name, set()).update(str(v) for v in c)
    return vocab


class SchemaGuard:
    """Admission control for one model's raw-feature schema."""

    def __init__(self, model, policy: Optional[AdmissionPolicy] = None):
        self.policy = policy or AdmissionPolicy()
        self.raw_features = model.raw_features()
        self.predictors = [f for f in self.raw_features
                           if not f.is_response]
        self.vocab = _harvest_vocab(model)
        self._known_keys = {f.name for f in self.raw_features}

    # -- record-level admission -------------------------------------------
    def admit_records(self, records: Sequence[Dict[str, Any]]
                      ) -> Tuple[Dataset, List[GuardReason]]:
        """Validate/coerce raw record dicts and materialize the raw
        Dataset in one pass. Every record survives — bad FIELDS are
        replaced with boxable placeholders (so vectorization cannot
        crash) and the row carries >= 1 machine-readable reason; the
        caller masks those rows out of the padded device batch."""
        from ..features.generator import FeatureGeneratorStage
        reasons: List[GuardReason] = []
        values: Dict[str, List[Any]] = {f.name: []
                                        for f in self.raw_features}
        for i, rec in enumerate(records):
            if self.policy.reject_extra_fields and isinstance(rec, dict):
                for k in sorted(rec):
                    if k not in self._known_keys:
                        self._note(reasons, GuardReason(
                            i, REASON_EXTRA_FIELD, k,
                            f"record key {k!r} matches no raw feature"))
            for f in self.raw_features:
                gen = f.origin_stage
                raw: Any = None
                failed: Optional[Tuple[str, str, bool]] = None
                if isinstance(gen, FeatureGeneratorStage):
                    try:
                        raw = gen.extract_fn(rec)
                    except Exception as e:
                        failed = _quarantine_reason(
                            REASON_WRONG_TYPE,
                            f"extract fn raised "
                            f"{type(e).__name__}: {e}")
                elif isinstance(rec, dict):
                    raw = rec.get(f.name)
                if f.is_response:
                    # label-free scoring: responses are never
                    # quarantine evidence; unextractable -> placeholder
                    values[f.name].append(
                        raw if failed is None else None)
                    continue
                if failed is not None:
                    code, detail = failed[0], failed[1]
                    stored = _placeholder_value(f)
                else:
                    stored, code, detail = self._admit_value(f, raw)
                if code is not None:
                    self._note(reasons, GuardReason(i, code, f.name,
                                                    detail))
                values[f.name].append(stored)
        cols = {f.name: _boxed_column(f, values[f.name])
                for f in self.raw_features}
        return Dataset(cols), reasons

    def _admit_value(self, f, raw: Any
                     ) -> Tuple[Any, Optional[str], str]:
        """One predictor value -> (stored value, reason code or None,
        detail). The stored value is safe for the column builder: a
        boxed FeatureType for admitted values, a missing-placeholder
        for rejected/sanitized ones."""
        numeric = issubclass(f.ftype, OPNumeric)
        value = raw.value if isinstance(raw, FeatureType) else raw
        if value is None:
            if not f.ftype.is_nullable:
                if self.policy.require_fields:
                    return (_placeholder_value(f), REASON_MISSING_FIELD,
                            f"required {f.ftype.__name__} field is "
                            f"missing")
                return _placeholder_value(f), None, ""   # lenient
            return None, None, ""
        if numeric and isinstance(value, (int, float, np.floating,
                                          np.integer)):
            fv = float(value)
            if math.isnan(fv):
                if f.ftype.is_nullable:
                    return None, None, ""    # NaN = missing, by column
                if self.policy.reject_non_finite:       # convention
                    return (_placeholder_value(f), REASON_NON_FINITE,
                            f"NaN in required {f.ftype.__name__} field")
                return _placeholder_value(f), None, ""
            if math.isinf(fv) and self.policy.reject_non_finite:
                return (_placeholder_value(f), REASON_NON_FINITE,
                        f"non-finite value {fv!r}")
        boxed = raw
        if not isinstance(raw, FeatureType):
            try:
                boxed = f.ftype.from_any(raw)
            except Exception as e:
                code, detail, _ = _quarantine_reason(
                    REASON_WRONG_TYPE,
                    f"cannot coerce {type(raw).__name__} to "
                    f"{f.ftype.__name__}: {e}")
                return _placeholder_value(f), code, detail
        if self.policy.reject_out_of_vocab:
            vocab = self.vocab.get(f.name)
            if vocab:
                for item in self._categorical_items(value):
                    if item not in vocab:
                        return (_placeholder_value(f),
                                REASON_OUT_OF_VOCAB,
                                f"value {item!r} not in the fitted "
                                f"vocabulary ({len(vocab)} categories)")
        return boxed, None, ""

    @staticmethod
    def _categorical_items(value: Any) -> List[str]:
        if isinstance(value, (set, frozenset, list, tuple)):
            return [str(v) for v in value]
        if isinstance(value, dict):
            return [str(k) for k in value]
        return [str(value)]

    # -- columnar admission ------------------------------------------------
    def admit_dataset(self, ds: Dataset
                      ) -> Tuple[Dataset, List[GuardReason]]:
        """Columnar admission over an already-materialized raw Dataset:
        non-finite numerics, missing non-nullables and out-of-vocab
        categoricals. Returns (sanitized dataset, reasons)."""
        reasons: List[GuardReason] = []
        cols = {n: ds[n] for n in ds.column_names}
        for f in self.predictors:
            if f.name not in cols:
                continue
            col = cols[f.name]
            if col.kind == ColumnKind.NUMERIC:
                data = np.asarray(col.data, dtype=np.float64)
                bad_inf = np.isinf(data) if self.policy.reject_non_finite \
                    else np.zeros(len(data), dtype=bool)
                bad_nan = (np.isnan(data)
                           if (self.policy.require_fields
                               and not f.ftype.is_nullable)
                           else np.zeros(len(data), dtype=bool))
                bad = bad_inf | bad_nan
                if bad.any():
                    for i in np.flatnonzero(bad):
                        code = (REASON_NON_FINITE if bad_inf[i]
                                else REASON_MISSING_FIELD)
                        detail = (f"non-finite value {data[i]!r}"
                                  if bad_inf[i] else
                                  f"required {f.ftype.__name__} field "
                                  f"is missing")
                        self._note(reasons, GuardReason(
                            int(i), code, f.name, detail))
                    data = data.copy()
                    data[bad] = np.nan
                    cols[f.name] = FeatureColumn(
                        ftype=col.ftype, data=data,
                        metadata=col.metadata)
            elif self.policy.reject_out_of_vocab \
                    and col.kind in (ColumnKind.TEXT, ColumnKind.OBJECT):
                vocab = self.vocab.get(f.name)
                if not vocab:
                    continue
                data = col.data
                bad_rows = []
                for i, v in enumerate(data):
                    if v is None:
                        continue
                    oov = [x for x in self._categorical_items(v)
                           if x not in vocab]
                    if oov:
                        bad_rows.append(i)
                        self._note(reasons, GuardReason(
                            i, REASON_OUT_OF_VOCAB, f.name,
                            f"value {oov[0]!r} not in the fitted "
                            f"vocabulary ({len(vocab)} categories)"))
                if bad_rows:
                    data = data.copy()
                    for i in bad_rows:
                        data[i] = None
                    cols[f.name] = FeatureColumn(
                        ftype=col.ftype, data=data,
                        metadata=col.metadata)
        return Dataset(cols), reasons

    def _note(self, reasons: List[GuardReason], r: GuardReason) -> None:
        if len(reasons) < self.policy.max_reasons:
            reasons.append(r)


def _quarantine_reason(code: str, detail: str,
                       sanitize: bool = True) -> Tuple[str, str, bool]:
    """One quarantine verdict for a swallowed per-field exception —
    an absorbed error must surface as a
    recorded, machine-readable reason, never vanish."""
    return code, detail, sanitize


def _placeholder_value(f) -> Any:
    """A value that boxes under ``f.ftype`` and reads as "missing":
    NaN for numerics (non-nullables cannot hold None), None otherwise."""
    if issubclass(f.ftype, OPNumeric):
        return math.nan
    return None


def _boxed_column(f, vals: List[Any]) -> FeatureColumn:
    """Mirror of ``FeatureGeneratorStage.extract_column`` over
    already-admitted values. Numeric columns are built directly
    (placeholder NaNs for quarantined non-nullables must not re-enter
    boxing, which rejects them); response columns degrade to all-NaN
    when the label cannot box (label-free scoring, same as
    ``_generate_raw_data``)."""
    from ..features.columns import ColumnKind, column_kind
    if column_kind(f.ftype) == ColumnKind.NUMERIC:
        data = np.empty(len(vals), dtype=np.float64)
        for i, v in enumerate(vals):
            if isinstance(v, FeatureType):
                v = v.value
            try:
                data[i] = math.nan if v is None else float(v)
            except (TypeError, ValueError):
                if not f.is_response:
                    raise
                data[i] = math.nan   # unboxable label: score label-free
        return FeatureColumn(ftype=f.ftype, data=data)
    try:
        return FeatureColumn.from_values(f.ftype, vals)
    except Exception:
        if f.is_response:
            return FeatureColumn(
                ftype=f.ftype,
                data=np.full(len(vals), np.nan, dtype=np.float64))
        raise


# ---------------------------------------------------------------------------
# output guard
# ---------------------------------------------------------------------------

class OutputGuard:
    """NaN/Inf/probability-range checks on scored result columns: a
    failing row is invalidated (outputs overwritten with NaN) with a
    recorded reason instead of being emitted as-is."""

    def __init__(self, probability_tolerance: float = 1e-6):
        self.probability_tolerance = float(probability_tolerance)

    def check(self, scored: Dataset, result_names: Sequence[str],
              skip_rows: Optional[np.ndarray] = None
              ) -> Tuple[Dataset, List[GuardReason]]:
        """Returns (scored with bad rows NaN'd, reasons). ``skip_rows``
        marks rows already quarantined at admission — their outputs are
        garbage by construction and are not double-reported."""
        reasons: List[GuardReason] = []
        n = scored.n_rows
        skip = (np.zeros(n, dtype=bool) if skip_rows is None
                else np.asarray(skip_rows, dtype=bool))
        bad = np.zeros(n, dtype=bool)
        tol = self.probability_tolerance
        for name in result_names:
            if name not in scored:
                continue
            col = scored[name]
            if isinstance(col, PredictionColumn):
                finite = np.isfinite(col.data)
                if col.raw_prediction.shape[1]:
                    finite &= np.isfinite(col.raw_prediction).all(axis=1)
                row_bad = ~finite & ~skip
                for i in np.flatnonzero(row_bad):
                    reasons.append(GuardReason(
                        int(i), REASON_OUTPUT_NON_FINITE, name,
                        "prediction is NaN/Inf"))
                if col.probability.shape[1]:
                    p = col.probability
                    pfinite = np.isfinite(p).all(axis=1)
                    in_range = pfinite & ((p >= -tol) & (p <= 1 + tol)
                                          ).all(axis=1)
                    prow_bad = ~in_range & ~skip & ~row_bad
                    for i in np.flatnonzero(~pfinite & ~skip & ~row_bad):
                        reasons.append(GuardReason(
                            int(i), REASON_OUTPUT_NON_FINITE, name,
                            "class probability is NaN/Inf"))
                    for i in np.flatnonzero(prow_bad & pfinite):
                        reasons.append(GuardReason(
                            int(i), REASON_PROBABILITY_RANGE, name,
                            f"class probability outside [0, 1]: "
                            f"{p[i].tolist()}"))
                    row_bad |= prow_bad
                bad |= row_bad
            elif col.kind == ColumnKind.NUMERIC \
                    and not issubclass(col.ftype, Prediction):
                data = np.asarray(col.data, dtype=np.float64)
                row_bad = np.isinf(data) & ~skip
                for i in np.flatnonzero(row_bad):
                    reasons.append(GuardReason(
                        int(i), REASON_OUTPUT_NON_FINITE, name,
                        f"non-finite output {data[i]!r}"))
                bad |= row_bad
        if bad.any():
            scored = _invalidate_rows(scored, result_names, bad)
        return scored, reasons


def _invalidate_rows(scored: Dataset, result_names: Sequence[str],
                     bad: np.ndarray) -> Dataset:
    """Overwrite result columns of flagged rows with NaN (the
    invalidate-with-reason policy: never emit garbage)."""
    for name in result_names:
        if name not in scored:
            continue
        col = scored[name]
        if isinstance(col, PredictionColumn):
            data = col.data.copy()
            data[bad] = np.nan
            prob = col.probability.copy()
            raw = col.raw_prediction.copy()
            if prob.shape[1]:
                prob[bad] = np.nan
            if raw.shape[1]:
                raw[bad] = np.nan
            scored = scored.with_column(name, PredictionColumn(
                ftype=col.ftype, data=data, metadata=col.metadata,
                probability=prob, raw_prediction=raw))
        elif col.kind == ColumnKind.NUMERIC:
            data = np.asarray(col.data, dtype=np.float64).copy()
            data[bad] = np.nan
            scored = scored.with_column(name, FeatureColumn(
                ftype=col.ftype, data=data, metadata=col.metadata))
        elif col.kind == ColumnKind.VECTOR:
            data = np.asarray(col.data, dtype=np.float64).copy()
            data[bad, :] = np.nan
            scored = scored.with_column(name, FeatureColumn(
                ftype=col.ftype, data=data, metadata=col.metadata))
        else:
            data = col.data.copy()
            for i in np.flatnonzero(bad):
                data[i] = None
            scored = scored.with_column(name, FeatureColumn(
                ftype=col.ftype, data=data, metadata=col.metadata))
    return scored


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class BreakerOpenError(RuntimeError):
    """Raised by :meth:`CircuitBreaker.before_dispatch` while the
    breaker is open — the caller routes to the host fallback without
    touching the device."""


class CircuitBreaker:
    """Closed -> open -> half-open breaker over device dispatch.

    - **closed**: every batch dispatches; ``failure_threshold``
      *consecutive* failures trip to open (telemetry
      ``breaker_trips``).
    - **open**: dispatch short-circuits to the host fallback for
      ``cooldown_seconds`` — no device attempt, no retry latency.
    - **half-open**: after the cooldown, ONE probe batch dispatches;
      success closes the breaker (``breaker_recoveries``), failure
      re-opens it and restarts the cooldown.

    ``clock`` is injectable so tests step time deterministically."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, failure_threshold: int = 3,
                 cooldown_seconds: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_seconds = float(cooldown_seconds)
        self.clock = clock
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        #: (from_state, to_state) transition log for tests/debugging
        self.transitions: List[Tuple[str, str]] = []

    def _move(self, to: str) -> None:
        if to != self.state:
            self.transitions.append((self.state, to))
            _telemetry.event("breaker", transition=f"{self.state}->{to}")
            if to == self.OPEN:
                _telemetry.count("breaker_trips")
            elif to == self.HALF_OPEN:
                _telemetry.count("breaker_half_open")
            elif to == self.CLOSED:
                _telemetry.count("breaker_recoveries")
            self.state = to

    def before_dispatch(self) -> None:
        """Gate one device dispatch. Raises :class:`BreakerOpenError`
        while open; transitions open -> half-open once the cooldown
        elapses (that call becomes the probe)."""
        if self.state == self.OPEN:
            if self.opened_at is not None and \
                    self.clock() - self.opened_at >= self.cooldown_seconds:
                self._move(self.HALF_OPEN)
                return
            raise BreakerOpenError(
                f"scoring circuit breaker is open "
                f"({self.consecutive_failures} consecutive device "
                f"failures); host fallback until the "
                f"{self.cooldown_seconds}s cooldown elapses")

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state in (self.HALF_OPEN, self.OPEN):
            self._move(self.CLOSED)

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == self.HALF_OPEN \
                or self.consecutive_failures >= self.failure_threshold:
            self.opened_at = self.clock()
            self._move(self.OPEN)

    def describe(self) -> dict:
        return {"state": self.state,
                "consecutiveFailures": self.consecutive_failures,
                "failureThreshold": self.failure_threshold,
                "cooldownSeconds": self.cooldown_seconds,
                "transitions": [list(t) for t in self.transitions]}


# ---------------------------------------------------------------------------
# the aggregate guard a plan carries
# ---------------------------------------------------------------------------

@dataclass
class GuardedScoreResult:
    """What a guarded ``score`` returns: the scored Dataset (full row
    count — quarantined/invalidated rows carry NaN outputs) plus the
    machine-readable ledger."""
    scored: Dataset
    quarantined: List[GuardReason] = field(default_factory=list)
    invalidated: List[GuardReason] = field(default_factory=list)
    #: True when this batch scored through the host columnar fallback
    #: (breaker open, or device dispatch failed after retries)
    used_host_fallback: bool = False
    breaker_state: str = CircuitBreaker.CLOSED

    @property
    def quarantined_rows(self) -> List[int]:
        return sorted({r.row for r in self.quarantined})

    @property
    def invalidated_rows(self) -> List[int]:
        return sorted({r.row for r in self.invalidated})

    @property
    def n_rows(self) -> int:
        return self.scored.n_rows

    @property
    def n_valid(self) -> int:
        return self.n_rows - len(set(self.quarantined_rows)
                                 | set(self.invalidated_rows))

    def boxed_rows(self, names: Sequence[str]) -> List[dict]:
        """One plain dict per row over the result columns ``names``: a
        quarantined or invalidated row carries ``None`` outputs and a
        ``"_guard"`` list of its machine-readable reasons instead."""
        from ..local.scoring import _unbox
        by_row: Dict[int, List[dict]] = {}
        for r in self.quarantined:
            by_row.setdefault(r.row, []).append(
                {"kind": "quarantined", **r.to_json()})
        for r in self.invalidated:
            by_row.setdefault(r.row, []).append(
                {"kind": "invalidated", **r.to_json()})
        cols = [self.scored[nm] for nm in names]
        rows: List[dict] = []
        for i in range(self.n_rows):
            if i in by_row:
                row: dict = {nm: None for nm in names}
                row["_guard"] = by_row[i]
            else:
                row = {nm: _unbox(col.boxed(i))
                       for nm, col in zip(names, cols)}
            rows.append(row)
        return rows

    def to_json(self) -> dict:
        return {
            "nRows": self.n_rows,
            "nValid": self.n_valid,
            "quarantined": [r.to_json() for r in self.quarantined],
            "invalidated": [r.to_json() for r in self.invalidated],
            "usedHostFallback": self.used_host_fallback,
            "breakerState": self.breaker_state,
        }


def fall_back_to_host(breaker: Optional[CircuitBreaker],
                      exc: BaseException, where: str) -> bool:
    """Book a guarded device dispatch that raised ``exc``. True when the
    batch goes to the host columnar path: the breaker was open, or the
    failure classifies as transient or family (``runtime/errors.py``) and
    trips the breaker one step. False when ``exc`` must propagate: there is
    no breaker, or it is a bug, which includes a ``PlanCompileError`` and a
    sticky CUDA error. The plan's and the server's guarded paths both
    decide here."""
    if isinstance(exc, BreakerOpenError):
        _telemetry.count("serving_breaker_short_circuits")
        _log.warning("%s: breaker open; host fallback: %s", where, exc)
        return True
    if breaker is None or classify_error(exc) == BUG:
        return False
    breaker.record_failure()
    _telemetry.count("serving_device_failures")
    _telemetry.event("serving_fallback", error=f"{type(exc).__name__}: {exc}",
                     breaker=breaker.state)
    _log.warning("%s failed (%s: %s); host fallback (breaker %s)", where,
                 type(exc).__name__, exc, breaker.state)
    return True


class ServingGuard:
    """Aggregate guard a :class:`~..serving.ScoringPlan` carries:
    admission + output checks + breaker + per-batch deadline. Built via
    ``plan.with_guardrails(...)`` (serving/plan.py)."""

    def __init__(self, model,
                 admission: Optional[AdmissionPolicy] = None,
                 output_guard: Optional[OutputGuard] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 deadline_seconds: Optional[float] = None):
        self.schema = SchemaGuard(model, admission)
        self.output = output_guard or OutputGuard()
        self.breaker = breaker or CircuitBreaker()
        #: per-batch device-dispatch deadline (None = no deadline)
        self.deadline_seconds = deadline_seconds
