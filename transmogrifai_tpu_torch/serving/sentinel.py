"""Online drift sentinel: train/serve distribution-shift detection.

The port's copy of ``transmogrifai_tpu/serving/sentinel.py``. The raw
feature filter prunes features whose train and score distributions
diverge, but only at train time; the sentinel watches the traffic a saved
model scores:

- at save time the training data's per-feature distributions (the raw
  feature filter's hashed bucket counts, and the numeric
  ``StreamingHistogram`` sketches) are written into the model directory as
  ``drift-fingerprints.json`` (``workflow/persistence.py``);
- at serve time a :class:`DriftSentinel` keeps streaming per-feature
  sketches over the scored traffic (the same binning, the same md5
  hashing) and reports the Jensen-Shannon divergence against the training
  fingerprints (``ScoringPlan.drift_report``, the server's metrics
  snapshot), through the same ``FeatureDistribution.js_divergence`` the
  train-time filter uses.

Per feature, JS >= ``warn`` marks it (and the report) ``warn``; >=
``degrade`` marks it ``degrade``. A report over fewer than ``min_rows``
observed rows stays ``ok``. The file's schema and layout are the JAX
package's (``FINGERPRINT_SCHEMA``), so a file saved by either package
loads in the other. Host numpy throughout, as in the JAX package: it
launches nothing on a device.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..checkers.raw_feature_filter import (FeatureDistribution,
                                           numeric_histogram_js)
from ..features.columns import ColumnKind, Dataset, host_column
from ..ops.vector_utils import stable_hash as _stable_hash
from ..runtime import telemetry as _telemetry
from ..types import OPNumeric
from ..utils.histogram import StreamingHistogram

__all__ = ["DriftSentinel", "FeatureFingerprint", "DriftThresholds",
           "FingerprintSchemaError", "compute_fingerprints",
           "save_fingerprints", "load_fingerprints",
           "load_fingerprint_doc", "DRIFT_FINGERPRINTS_FILE",
           "FINGERPRINT_SCHEMA",
           "STATUS_OK", "STATUS_WARN", "STATUS_DEGRADE"]

DRIFT_FINGERPRINTS_FILE = "drift-fingerprints.json"
FINGERPRINT_FORMAT_VERSION = 1
#: schema identity of the fingerprint document: a model must not be
#: compared against fingerprints written under another schema, so a load
#: rejects a mismatch (FingerprintSchemaError)
FINGERPRINT_SCHEMA = "tx-drift-fingerprints/1"


class FingerprintSchemaError(ValueError):
    """drift-fingerprints.json was written under an incompatible schema;
    ``DriftSentinel.for_model`` lets it propagate."""


STATUS_OK = "ok"
STATUS_WARN = "warn"
STATUS_DEGRADE = "degrade"
_STATUS_ORDER = {STATUS_OK: 0, STATUS_WARN: 1, STATUS_DEGRADE: 2}


@dataclass(frozen=True)
class DriftThresholds:
    """JS-divergence thresholds (the train-time filter excludes at 0.90;
    a serving report is advisory and warns far earlier)."""
    warn: float = 0.25
    degrade: float = 0.50
    #: a report over fewer observed rows than this stays "ok"
    min_rows: int = 50

    def status_for(self, js: float, rows: int) -> str:
        if rows < self.min_rows:
            return STATUS_OK
        if js >= self.degrade:
            return STATUS_DEGRADE
        if js >= self.warn:
            return STATUS_WARN
        return STATUS_OK


@dataclass
class FeatureFingerprint:
    """One raw feature's training distribution: numeric features carry
    the streaming-histogram sketch, the others the hashed ``bins``-bucket
    counts (FeatureDistribution.scala:58 semantics)."""
    name: str
    is_numeric: bool
    count: int = 0
    nulls: int = 0
    bins: int = 100
    #: hashed bucket counts (categorical); empty for numeric
    counts: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.float64))
    #: streaming histogram (numeric); None for categorical
    histogram: Optional[StreamingHistogram] = None

    def to_json(self) -> dict:
        return {
            "name": self.name, "isNumeric": self.is_numeric,
            "count": self.count, "nulls": self.nulls, "bins": self.bins,
            "counts": self.counts.tolist(),
            "histogram": (self.histogram.to_json()
                          if self.histogram is not None else None),
        }

    @classmethod
    def from_json(cls, d: dict) -> "FeatureFingerprint":
        return cls(
            name=d["name"], is_numeric=d["isNumeric"],
            count=d.get("count", 0), nulls=d.get("nulls", 0),
            bins=d.get("bins", 100),
            counts=np.asarray(d.get("counts", []), dtype=np.float64),
            histogram=(StreamingHistogram.from_json(d["histogram"])
                       if d.get("histogram") else None))


def _hash_counts(col, missing: np.ndarray, bins: int) -> np.ndarray:
    """``bins`` md5 bucket counts of a non-numeric column's present
    values: each element of a list or set, each key of a map."""
    counts = np.zeros(bins, dtype=np.float64)
    for v, miss in zip(col.data, missing):
        if miss:
            continue
        if isinstance(v, (set, frozenset, list, tuple)):
            for e in v:
                counts[_stable_hash(str(e), bins)] += 1
        elif isinstance(v, dict):
            for k in v:
                counts[_stable_hash(str(k), bins)] += 1
        else:
            counts[_stable_hash(str(v), bins)] += 1
    return counts


def _finite(col) -> np.ndarray:
    vals = np.asarray(host_column(col).data, dtype=np.float64)
    return vals[np.isfinite(vals)]


class _Sketch:
    """Streaming serve-side counterpart of one fingerprint."""

    def __init__(self, fp: FeatureFingerprint):
        self.fp = fp
        self.rows = 0
        self.nulls = 0
        if fp.is_numeric:
            self.histogram = StreamingHistogram(
                fp.histogram.max_bins if fp.histogram is not None
                else fp.bins)
            self.counts = np.zeros(0, dtype=np.float64)
        else:
            self.histogram = None
            self.counts = np.zeros(fp.bins, dtype=np.float64)

    def observe_column(self, col) -> None:
        self.rows += col.n_rows
        if self.fp.is_numeric:
            finite = _finite(col)
            self.nulls += int(col.n_rows - finite.size)
            if finite.size:
                self.histogram.update(finite)
        else:
            missing = col.is_missing()
            self.nulls += int(missing.sum())
            self.counts += _hash_counts(col, missing, self.fp.bins)

    def js_vs_train(self) -> float:
        if self.fp.is_numeric:
            return numeric_histogram_js(self.fp.histogram, self.histogram,
                                        self.fp.bins)
        if self.counts.size != self.fp.counts.size:
            return 0.0
        a = FeatureDistribution(name=self.fp.name,
                                distribution=self.fp.counts)
        b = FeatureDistribution(name=self.fp.name,
                                distribution=self.counts)
        return a.js_divergence(b)

    @property
    def fill_rate(self) -> float:
        return 1.0 - self.nulls / self.rows if self.rows else 0.0

    # -- warm-restart serialization ---------------------------------------
    def to_state(self) -> dict:
        return {
            "rows": self.rows, "nulls": self.nulls,
            "counts": self.counts.tolist(),
            "histogram": (self.histogram.to_json()
                          if self.histogram is not None else None),
        }

    def load_state(self, d: dict) -> None:
        self.rows = int(d.get("rows", 0))
        self.nulls = int(d.get("nulls", 0))
        counts = np.asarray(d.get("counts", []), dtype=np.float64)
        if counts.size == self.counts.size:
            self.counts = counts
        if d.get("histogram") and self.fp.is_numeric:
            self.histogram = StreamingHistogram.from_json(d["histogram"])


# ---------------------------------------------------------------------------
# fingerprint computation + persistence
# ---------------------------------------------------------------------------

def compute_fingerprints(raw_features: Sequence, ds: Dataset,
                         bins: int = 100) -> List[FeatureFingerprint]:
    """Training fingerprints of every raw predictor present in ``ds``
    (the RawFeatureFilter's distributions, kept in their streaming form
    so the serve-side comparison shares breakpoints)."""
    out: List[FeatureFingerprint] = []
    for f in raw_features:
        if f.is_response or f.name not in ds:
            continue
        col = ds[f.name]
        if col.kind == ColumnKind.VECTOR:
            continue
        numeric = issubclass(f.ftype, OPNumeric)
        fp = FeatureFingerprint(name=f.name, is_numeric=numeric,
                                count=col.n_rows, bins=bins)
        if numeric:
            finite = _finite(col)
            fp.nulls = int(col.n_rows - finite.size)
            fp.histogram = StreamingHistogram(bins).update(finite)
        else:
            missing = col.is_missing()
            fp.nulls = int(missing.sum())
            fp.counts = _hash_counts(col, missing, bins)
        out.append(fp)
    return out


def _atomic_write_json(path: str, doc: dict) -> None:
    """Write ``doc`` to ``path`` as the JAX package writes it (sorted
    keys, a final newline) through a fsync'd sibling temp file and
    ``os.replace``: a reader sees the old file or the whole new one."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".tmp-", suffix=".json")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(doc, fh, indent=0, sort_keys=True)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_fingerprints(fingerprints: Sequence[FeatureFingerprint],
                      model_dir: str, trained_at: int = 0) -> str:
    """Write ``drift-fingerprints.json`` into ``model_dir``. ``trained_at``
    is the model generation the fingerprints belong to (0: the original
    train); a loaded sentinel carries it."""
    path = os.path.join(model_dir, DRIFT_FINGERPRINTS_FILE)
    _atomic_write_json(
        path,
        {"formatVersion": FINGERPRINT_FORMAT_VERSION,
         "schema": FINGERPRINT_SCHEMA,
         "trainedAt": int(trained_at),
         "features": [fp.to_json() for fp in fingerprints]})
    return path


def load_fingerprint_doc(model_dir: str
                         ) -> Optional[Tuple[List[FeatureFingerprint],
                                             dict]]:
    """(fingerprints, metadata) from a model directory, or None when it
    has no fingerprint file. Metadata carries ``schema`` and
    ``trainedAt``. Raises :class:`FingerprintSchemaError` on a schema
    mismatch; a document without ``schema`` predates versioning and reads
    as the v1 schema."""
    path = os.path.join(model_dir, DRIFT_FINGERPRINTS_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        doc = json.load(fh)
    schema = doc.get("schema", FINGERPRINT_SCHEMA)
    if schema != FINGERPRINT_SCHEMA:
        raise FingerprintSchemaError(
            f"{path} was written under fingerprint schema {schema!r}; "
            f"this build reads {FINGERPRINT_SCHEMA!r}: refusing to "
            f"compare live traffic against incompatible fingerprints "
            f"(re-save the model to regenerate them)")
    if doc.get("formatVersion", 1) > FINGERPRINT_FORMAT_VERSION:
        raise FingerprintSchemaError(
            f"{path} uses fingerprint format "
            f"{doc['formatVersion']}; this build reads up to "
            f"{FINGERPRINT_FORMAT_VERSION}")
    fps = [FeatureFingerprint.from_json(d)
           for d in doc.get("features", [])]
    return fps, {"schema": schema,
                 "trainedAt": int(doc.get("trainedAt", 0))}


def load_fingerprints(model_dir: str
                      ) -> Optional[List[FeatureFingerprint]]:
    loaded = load_fingerprint_doc(model_dir)
    return None if loaded is None else loaded[0]


# ---------------------------------------------------------------------------
# the sentinel
# ---------------------------------------------------------------------------

class DriftSentinel:
    """Streaming train/serve drift monitor for one model.

    >>> sentinel = DriftSentinel.for_model(model)
    >>> sentinel.observe_dataset(raw_batch)      # per scored batch
    >>> sentinel.drift_report()["status"]        # "ok"|"warn"|"degrade"
    """

    def __init__(self, fingerprints: Sequence[FeatureFingerprint],
                 thresholds: Optional[DriftThresholds] = None):
        self.thresholds = thresholds or DriftThresholds()
        self.fingerprints = list(fingerprints)
        self._sketches = {fp.name: _Sketch(fp)
                          for fp in self.fingerprints}
        self.rows_seen = 0
        #: the status each feature has been reported at (one telemetry
        #: event per feature per escalation, not per batch)
        self._reported: Dict[str, str] = {}
        #: model generation the fingerprints were computed against
        self.generation = 0

    # -- construction ------------------------------------------------------
    @classmethod
    def for_model(cls, model,
                  thresholds: Optional[DriftThresholds] = None,
                  bins: int = 100) -> Optional["DriftSentinel"]:
        """A sentinel from the best training source the model has: its
        directory's ``drift-fingerprints.json`` (a loaded model), its
        in-memory ``train_dataset`` (a freshly trained one), or the raw
        feature filter's train distributions. None when it has none (the
        caller serves without one, and says so). A fingerprint file of
        another schema raises :class:`FingerprintSchemaError`."""
        model_dir = getattr(model, "model_dir", None)
        if model_dir:
            try:
                loaded = load_fingerprint_doc(model_dir)
            except FingerprintSchemaError:
                raise
            except (OSError, ValueError, KeyError):
                loaded = None
            if loaded and loaded[0]:
                sentinel = cls(loaded[0], thresholds)
                sentinel.generation = loaded[1].get("trainedAt", 0)
                return sentinel
        train_ds = getattr(model, "train_dataset", None)
        if train_ds is not None:
            return cls(compute_fingerprints(model.raw_features(),
                                            train_ds, bins=bins),
                       thresholds)
        rff = getattr(model, "raw_feature_filter_results", None)
        if rff is not None and rff.train_distributions:
            fps = [FeatureFingerprint(
                name=d.name, is_numeric=d.is_numeric,
                count=d.count, nulls=d.nulls,
                bins=max(d.distribution.size, 2),
                counts=(np.zeros(0) if d.is_numeric else d.distribution),
                histogram=getattr(d, "_histogram", None))
                for d in rff.train_distributions]
            return cls(fps, thresholds)
        return None

    # -- observation -------------------------------------------------------
    def observe_dataset(self, ds: Dataset) -> None:
        """Fold one scored batch's raw feature columns (the values the
        model scored, after admission) into the serve-side sketches."""
        self.rows_seen += ds.n_rows
        for name, sketch in self._sketches.items():
            if name in ds:
                sketch.observe_column(ds[name])
        self._emit_escalations()

    def observe_records(self, records: Sequence[Dict[str, Any]]) -> None:
        """The record-dict form of :meth:`observe_dataset`."""
        from ..features.columns import FeatureColumn
        from ..types import FeatureTypeError
        cols = {}
        for fp in self.fingerprints:
            vals = [r.get(fp.name) if isinstance(r, dict) else None
                    for r in records]
            try:
                cols[fp.name] = FeatureColumn.from_values(
                    _ftype_for(fp), vals)
            except (FeatureTypeError, TypeError, ValueError):
                # unconvertible raw values: the feature sits out the
                # batch, and the telemetry counts it
                _telemetry.count("sentinel_skipped_feature_batches")
                continue
        if cols:
            self.observe_dataset(Dataset(cols))

    def _emit_escalations(self) -> None:
        for name, sketch in self._sketches.items():
            js = sketch.js_vs_train()
            status = self.thresholds.status_for(js, sketch.rows)
            prev = self._reported.get(name, STATUS_OK)
            if _STATUS_ORDER[status] > _STATUS_ORDER[prev]:
                self._reported[name] = status
                _telemetry.count(f"drift_{status}")
                _telemetry.event("drift", feature=name,
                                 status=status, js=round(js, 4),
                                 rows=sketch.rows)

    # -- warm-restart serialization ---------------------------------------
    def state_dict(self) -> dict:
        """The serve-side state a restarted process continues from: the
        sketches, rows seen, each feature's reported status and the
        fingerprint generation. The fingerprints themselves reload from
        the model directory."""
        return {
            "rowsSeen": self.rows_seen,
            "generation": self.generation,
            "reported": dict(self._reported),
            "sketches": {name: sk.to_state()
                         for name, sk in self._sketches.items()},
        }

    def load_state(self, d: dict) -> None:
        """Restore :meth:`state_dict`. A snapshot's feature that the
        current fingerprints lack is dropped: the fingerprints on disk
        decide."""
        self.rows_seen = int(d.get("rowsSeen", 0))
        self.generation = int(d.get("generation", self.generation))
        self._reported = {str(k): str(v)
                          for k, v in (d.get("reported") or {}).items()}
        for name, state in (d.get("sketches") or {}).items():
            sketch = self._sketches.get(name)
            if sketch is not None:
                sketch.load_state(state)

    # -- reporting ---------------------------------------------------------
    def drift_report(self) -> dict:
        """Per-feature JS divergence against training, and the worst
        status."""
        features = []
        worst = STATUS_OK
        for fp in self.fingerprints:
            sketch = self._sketches[fp.name]
            js = sketch.js_vs_train()
            status = self.thresholds.status_for(js, sketch.rows)
            if _STATUS_ORDER[status] > _STATUS_ORDER[worst]:
                worst = status
            features.append({
                "feature": fp.name,
                "isNumeric": fp.is_numeric,
                "jsDivergence": round(js, 6),
                "status": status,
                "rowsObserved": sketch.rows,
                "serveFillRate": round(sketch.fill_rate, 4),
                "trainFillRate": round(
                    1.0 - fp.nulls / fp.count if fp.count else 0.0, 4),
            })
        features.sort(key=lambda d: -d["jsDivergence"])
        return {
            "status": worst,
            "rowsSeen": self.rows_seen,
            "warnThreshold": self.thresholds.warn,
            "degradeThreshold": self.thresholds.degrade,
            "minRows": self.thresholds.min_rows,
            "features": features,
        }


def _ftype_for(fp: FeatureFingerprint):
    from ..types import Real, Text
    return Real if fp.is_numeric else Text
