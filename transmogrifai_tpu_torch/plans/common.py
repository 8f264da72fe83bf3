"""Plan machinery shared by the serving ScoringPlan and the train-time
PreparePlan.

Counterpart of ``transmogrifai_tpu/plans/common.py``:

- **row bucketing**: incoming row counts pad up to power-of-two buckets
  (``bucket_for`` / ``pad_rows``, on numpy arrays and on tensors), so
  any batch size hits one of a handful of shapes. The serving plan
  captures one CUDA graph per bucket, the port's counterpart of the JAX
  package's one compiled program per bucket; the prepare plan runs
  eagerly at the dataset's own row count and does not bucket;
- **zero-row metadata probe**: a stage run over zero rows through the
  numpy path (``probe_stage``) gives its output column's type, width and
  metadata without device work;
- **stage classification**: ``lowering_reason`` says whether a stage
  joins the device program: it needs an array kernel, and every input
  must be on the device already or host-materialized and encodable;
- **compile counters**: namespaced (plan, bucket) counters
  (``record_compile`` / ``compiles``): a repeated same-bucket batch
  adds zero; and the per-dispatch rows (``record_rows``) and per-bucket
  cost sections (``bucket_section`` / ``bucket_profile``) the serving
  coalescer reads.

The JAX package's non-power-of-two bucket lattices (``tuning/lattice.py``)
are not ported: a ``lattice`` argument raises.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..features.columns import Dataset, FeatureColumn, PredictionColumn
from ..features.feature import Feature
from ..stages.base import Transformer
from ..tuning.registry import STATIC_DEFAULTS as _TUNABLES
from ..types import Prediction
from ..utils.ported import not_ported

__all__ = ["DEFAULT_MIN_BUCKET", "DEFAULT_MAX_BUCKET", "bucket_for",
           "bucket_ladder", "pad_rows", "record_rows", "row_histogram",
           "PlanCompileError", "PlanStep",
           "PlanCoverage", "empty_raw_dataset", "probe_stage",
           "lowering_reason", "fallback_reason", "record_compile",
           "compiles", "plan_seq", "bucket_section", "bucket_profile"]

#: smallest padded batch: single-record requests share one graph
DEFAULT_MIN_BUCKET = int(_TUNABLES["serving.min_bucket"])
#: largest padded batch: bigger inputs are chunked, so a plan holds at
#: most log2(max/min)+1 graphs
DEFAULT_MAX_BUCKET = int(_TUNABLES["serving.max_bucket"])

#: distinct (plan, bucket) programs per namespace ("score" for the
#: ScoringPlan's captured graphs)
_COMPILE_KEYS: Dict[str, set] = {}
_PLAN_IDS = itertools.count()


def plan_seq() -> int:
    """Process-unique plan id (shared sequence across plan kinds)."""
    return next(_PLAN_IDS)


def record_compile(namespace: str, key) -> None:
    _COMPILE_KEYS.setdefault(namespace, set()).add(key)


def compiles(namespace: str) -> int:
    """Distinct programs recorded under ``namespace`` so far in this
    process."""
    return len(_COMPILE_KEYS.get(namespace, ()))


def bucket_for(n: int, min_bucket: int = DEFAULT_MIN_BUCKET,
               max_bucket: int = DEFAULT_MAX_BUCKET,
               lattice: Optional[Sequence[int]] = None) -> int:
    """Smallest power-of-two bucket >= n from ``min_bucket`` (clamped to
    ``max_bucket``); n beyond the largest bucket is the caller's cue to
    chunk."""
    if lattice:
        raise not_ported("bucket_for(lattice=...), the tuned bucket "
                         "lattices", "tuning/lattice.py")
    b = min_bucket
    while b < n and b < max_bucket:
        b *= 2
    return min(b, max_bucket)


def bucket_ladder(min_bucket: int = DEFAULT_MIN_BUCKET,
                  max_bucket: int = DEFAULT_MAX_BUCKET) -> Tuple[int, ...]:
    """Every bucket ``bucket_for`` can return: doubling from
    ``min_bucket``, capped by a final ``max_bucket`` (the JAX package's
    ``default_lattice``)."""
    lo = max(int(min_bucket), 1)
    hi = max(int(max_bucket), lo)
    out: List[int] = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


#: process-local occupancy histograms: {namespace: {real_rows: calls}}
_ROW_HIST: Dict[str, Dict[int, int]] = {}


def record_rows(namespace: str, rows: int) -> None:
    """Record one dispatch's real (pre-padding) row count."""
    h = _ROW_HIST.setdefault(namespace, {})
    r = int(rows)
    h[r] = h.get(r, 0) + 1


def row_histogram(namespace: str) -> Dict[int, int]:
    """This process's recorded rows-per-dispatch histogram."""
    return dict(_ROW_HIST.get(namespace, {}))


def pad_rows(arr, bucket: int):
    """Pad the leading (row) axis up to ``bucket`` with zeros. A numpy
    array pads on the host; a tensor pads on its own device."""
    n = arr.shape[0]
    if isinstance(arr, torch.Tensor):
        if n == bucket:
            return arr
        pad = arr.new_zeros((bucket - n,) + tuple(arr.shape[1:]))
        return torch.cat([arr, pad], dim=0)
    if n == bucket:
        return np.ascontiguousarray(arr)
    pad = [(0, bucket - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(np.ascontiguousarray(arr), pad)


def _bucket_label(namespace: str, plan_id: int, bucket: int) -> str:
    return f"{namespace}:{plan_id}:b{bucket}"


def bucket_section(namespace: str, plan_id: int, bucket: int):
    """A ``utils/compile_time.section`` labelled for one (plan, bucket)
    dispatch: the per-bucket cost ledger the serving coalescer reads
    (``bucket_profile``)."""
    from ..utils.compile_time import section
    return section(_bucket_label(namespace, plan_id, bucket))


def bucket_profile(namespace: str, plan_id: int,
                   rows_by_bucket: Optional[Dict[int, int]] = None
                   ) -> Dict[int, dict]:
    """Per-bucket dispatch cost observed so far for one plan:
    ``{bucket: {calls, wall_seconds, compile_seconds, execute_seconds,
    rows}}``. ``compile_seconds`` is the bucket's graph capture (warm-up
    runs included); ``execute_seconds`` the wall time without it."""
    from ..utils.compile_time import seconds_by_section
    prefix = f"{namespace}:{plan_id}:b"
    out: Dict[int, dict] = {}
    for label, rec in seconds_by_section(prefix).items():
        bucket = int(label[len(prefix):])
        out[bucket] = {
            "calls": int(rec["calls"]),
            "wall_seconds": rec["seconds"],
            "compile_seconds": rec["compile"],
            "execute_seconds": max(rec["seconds"] - rec["compile"], 0.0),
            "rows": int((rows_by_bucket or {}).get(bucket, 0)),
        }
    return out


class PlanCompileError(RuntimeError):
    """The feature DAG could not be frozen into a plan: a stage failed
    the zero-row probe, or a stage's kernel failed when the plan first
    ran it or captured it. The error names the stage; the port demotes
    no stage to the host in its place."""


@dataclass
class PlanStep:
    """One stage of a plan in execution order."""
    stage: Transformer
    out_name: str
    input_names: Tuple[str, ...]
    phase: str          # "pre" | "device" | "post"
    reason: str = ""    # why a host stage did not lower


@dataclass
class PlanCoverage:
    """Which stages ran on the device and which ran on the host (with
    the reason)."""
    lowered: List[str] = field(default_factory=list)
    fallback: List[Tuple[str, str]] = field(default_factory=list)

    @property
    def total(self) -> int:
        return len(self.lowered) + len(self.fallback)

    @property
    def lowered_fraction(self) -> float:
        return len(self.lowered) / self.total if self.total else 1.0

    def to_json(self) -> dict:
        return {"lowered": list(self.lowered),
                "fallback": [list(f) for f in self.fallback],
                "lowered_fraction": round(self.lowered_fraction, 3)}


def empty_raw_dataset(raw_features: Sequence[Feature]) -> Dataset:
    """Zero-row typed dataset for the metadata probe."""
    return Dataset({f.name: FeatureColumn.from_values(f.ftype, [])
                    for f in raw_features})


def probe_stage(stage: Transformer, proto: Dataset,
                out_name: str) -> Dataset:
    """Run ONE stage over the zero-row proto dataset through the numpy
    path, capturing its output column's type/width/metadata under the
    DAG handle's name ``out_name``. Prediction outputs are stubbed (they
    carry no metadata)."""
    if issubclass(stage.static_output_type(), Prediction):
        return proto.with_column(
            out_name, PredictionColumn.from_arrays(np.zeros(0)))
    cols = [proto[f.name] for f in stage.input_features]
    return proto.with_column(out_name, stage.transform_columns(cols))


def fallback_reason(what: str, e: Exception) -> str:
    """One-line reason for a coverage record."""
    return f"{what}: {type(e).__name__}: {e}"


def lowering_reason(stage: Transformer, input_names: Sequence[str],
                    producer: Dict[str, str],
                    proto_cols: Callable[[str], FeatureColumn]) -> str:
    """Empty string when ``stage`` can run on the device; otherwise the
    human-readable reason it runs its host ``transform_columns``. A stage
    runs on the device when it has an array kernel AND every input is
    either produced on the device already or host-materialized and
    encodable (its encoder accepts the input's zero-row proto column).
    An input produced by a host stage downstream of the device program
    ("post", the serving plan's phase) blocks lowering: the device
    program runs once."""
    if not stage.supports_arrays():
        return "no array kernel (transform_arrays)"
    for i, name in enumerate(input_names):
        src = producer.get(name, "host")
        if src == "post":
            return (f"input {name!r} is produced by a host fallback "
                    f"downstream of the device graph")
        if src == "device":
            if stage.encodes_input(i):
                return (f"input {name!r} needs host encoding but is "
                        f"produced on device")
            continue
        try:
            stage.encode_input_column(i, proto_cols(name))
        except (TypeError, ValueError) as e:
            return fallback_reason(f"input {name!r} not encodable", e)
    return ""
