"""Plan machinery of the prepare plan: coverage record, zero-row metadata
probe, stage classification.

Counterpart of the parts of ``transmogrifai_tpu/plans/common.py`` the
prepare plan uses (``PlanCoverage``, ``empty_raw_dataset``,
``probe_stage``, ``lowering_reason``, ``fallback_reason``). Row buckets,
padding and compile counters have no counterpart: the port runs each
stage's torch ops eagerly at the dataset's own row count.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from ..features.columns import Dataset, FeatureColumn, PredictionColumn
from ..features.feature import Feature
from ..stages.base import Transformer
from ..types import Prediction

__all__ = ["PlanCoverage", "empty_raw_dataset", "probe_stage",
           "lowering_reason", "fallback_reason"]


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
    encodable (its encoder accepts the input's zero-row proto column)."""
    if not stage.supports_arrays():
        return "no array kernel (transform_arrays)"
    for i, name in enumerate(input_names):
        if producer.get(name, "host") == "device":
            if stage.encodes_input(i):
                return (f"input {name!r} needs host encoding but is "
                        f"produced on device")
            continue
        try:
            stage.encode_input_column(i, proto_cols(name))
        except (TypeError, ValueError) as e:
            return fallback_reason(f"input {name!r} not encodable", e)
    return ""
