"""Date/time vectorization: unit-circle projection and date-list pivots.

Counterpart of ``transmogrifai_tpu/ops/date.py``, the reference
DateToUnitCircleTransformer and DateListVectorizer
(core/src/main/scala/com/salesforce/op/stages/impl/feature/
{DateToUnitCircleTransformer.scala, DateListVectorizer.scala}): a
timestamp's periodic component (hour of day, day of week, ...) is mapped
to (sin, cos) on the unit circle so midnight and 23:59 are close in
feature space. Timestamps are epoch milliseconds UTC, as in the reference
(joda DateTimeUtils).

The calendar arithmetic is int64 epoch math in numpy on the host (a
current epoch in float32 on the card would lose ~1e5 ms), shared by the
columnar path and the device encoder, so the phases are the JAX
package's bit for bit; the device part is the sin/cos projection.
``DateListVectorizer`` is host only, as there.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..features.columns import FeatureColumn
from ..stages.base import SequenceTransformer
from ..types import Date, DateList, OPVector
from .vector_utils import NULL_INDICATOR, VectorColumnMetadata, vector_output

__all__ = ["DateToUnitCircleVectorizer", "DateListVectorizer",
           "TIME_PERIODS", "DateListPivot"]

_MS_PER_HOUR = 3600 * 1000
_MS_PER_DAY = 24 * _MS_PER_HOUR

#: period -> (extractor of phase in [0, 1), period name)
TIME_PERIODS = {
    "HourOfDay": lambda ms: (ms % _MS_PER_DAY) / _MS_PER_DAY,
    # epoch day 0 (1970-01-01) was a Thursday = ISO day-of-week 4
    "DayOfWeek": lambda ms: (((ms // _MS_PER_DAY) + 3) % 7) / 7.0,
    "DayOfMonth": lambda ms: _day_of_month_phase(ms),
    "MonthOfYear": lambda ms: _month_phase(ms),
}


def _civil_from_ms(ms: np.ndarray):
    days = ms // _MS_PER_DAY
    # days-from-civil inverse (Howard Hinnant's algorithm), vectorized
    z = days + 719468
    era = np.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    return m.astype(np.int64), d.astype(np.int64)


def _day_of_month_phase(ms: np.ndarray) -> np.ndarray:
    _, d = _civil_from_ms(ms)
    return (d - 1) / 31.0


def _month_phase(ms: np.ndarray) -> np.ndarray:
    m, _ = _civil_from_ms(ms)
    return (m - 1) / 12.0


def date_phases(vals: np.ndarray, time_period: str) -> np.ndarray:
    """[0, 1) phases of float epoch-ms ``vals`` (NaN = missing, kept NaN)
    in int64 numpy: the host half of the unit-circle encoders."""
    ok = ~np.isnan(vals)
    ms = np.where(ok, vals, 0.0).astype(np.int64)
    phase = np.asarray(TIME_PERIODS[time_period](ms), dtype=np.float64)
    return np.where(ok, phase, np.nan)


def unit_circle_block(phases: np.ndarray) -> np.ndarray:
    """(sin, cos) of ``2 pi`` times each phase, (0, 0) where missing; a
    (n,) phase column gives (n, 2), an (n, k) matrix (n, 2k) with sin and
    cos interleaved per column: the numpy twin of
    :func:`_unit_circle_kernel`."""
    p = phases[:, None] if phases.ndim == 1 else phases
    ok = ~np.isnan(p)
    ang = 2.0 * np.pi * np.where(ok, p, 0.0)
    block = np.stack([np.where(ok, np.sin(ang), 0.0),
                      np.where(ok, np.cos(ang), 0.0)], axis=-1)
    return block.reshape(p.shape[0], 2 * p.shape[1])


def _unit_circle_kernel(arrays):
    """(sin, cos) projection of host-encoded [0, 1) phases, NaN =
    missing -> (0, 0); one (n,) or (n, k) phase tensor per input, 2 (or
    2k, interleaved sin/cos per key) output columns each."""
    blocks = []
    for p in arrays:
        ok = ~torch.isnan(p)
        ang = (2.0 * math.pi) * torch.where(ok, p, torch.zeros_like(p))
        zero = torch.zeros_like(ang)
        sin = torch.where(ok, torch.sin(ang), zero)
        cos = torch.where(ok, torch.cos(ang), zero)
        block = torch.stack([sin, cos], dim=-1)
        blocks.append(block.flatten(1))
    return torch.cat(blocks, dim=1)


class DateListPivot:
    """(reference DateListPivot enum in DateListVectorizer.scala)"""
    SINCE_FIRST = "SinceFirst"
    SINCE_LAST = "SinceLast"
    MODE_DAY = "ModeDay"
    MODE_MONTH = "ModeMonth"
    MODE_HOUR = "ModeHour"
    ALL = (SINCE_FIRST, SINCE_LAST, MODE_DAY, MODE_MONTH, MODE_HOUR)


_DAYS = ["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"]
_MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
           "Oct", "Nov", "Dec"]


class DateListVectorizer(SequenceTransformer):
    """DateList -> pivoted columns (reference DateListVectorizer.scala):
    SinceFirst/SinceLast = days between the earliest/latest date and
    ``reference_date_ms``; ModeDay/ModeMonth/ModeHour = one-hot of the
    most frequent day-of-week / month / hour across the list. Host only
    (a sort and a mode per row), as in the JAX package."""

    input_types = (DateList,)
    output_type = OPVector

    def __init__(self, pivot: str = DateListPivot.SINCE_FIRST,
                 reference_date_ms: int = 1_500_000_000_000,
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="dateListPivot", uid=uid)
        if pivot not in DateListPivot.ALL:
            raise ValueError(f"Unknown pivot {pivot!r}")
        self.pivot = pivot
        self.reference_date_ms = reference_date_ms
        self.track_nulls = track_nulls

    def _one_hot(self, picks, n_levels, labels, f):
        n = len(picks)
        block = np.zeros((n, n_levels))
        isnull = np.zeros(n)
        for i, p in enumerate(picks):
            if p is None:
                isnull[i] = 1.0
            else:
                block[i, p] = 1.0
        blocks = [block]
        metas = [VectorColumnMetadata(
            parent_feature_name=f.name,
            parent_feature_type=f.ftype.__name__, grouping=f.name,
            indicator_value=lab) for lab in labels]
        if self.track_nulls:
            blocks.append(isnull)
            metas.append(VectorColumnMetadata(
                parent_feature_name=f.name,
                parent_feature_type=f.ftype.__name__, grouping=f.name,
                indicator_value=NULL_INDICATOR))
        return blocks, metas

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col in zip(self.input_features, cols):
            lists = [sorted(v) if v else None for v in col.data]
            if self.pivot in (DateListPivot.SINCE_FIRST,
                              DateListPivot.SINCE_LAST):
                pick = 0 if self.pivot == DateListPivot.SINCE_FIRST else -1
                days = np.zeros(len(lists))
                isnull = np.zeros(len(lists))
                for i, v in enumerate(lists):
                    if v is None:
                        isnull[i] = 1.0
                    else:
                        days[i] = (self.reference_date_ms - v[pick]) \
                            / _MS_PER_DAY
                blocks.append(days)
                metas.append(VectorColumnMetadata(
                    parent_feature_name=f.name,
                    parent_feature_type=f.ftype.__name__,
                    descriptor_value=self.pivot))
                if self.track_nulls:
                    blocks.append(isnull)
                    metas.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.ftype.__name__,
                        indicator_value=NULL_INDICATOR))
                continue
            picks = []
            for v in lists:
                if v is None:
                    picks.append(None)
                    continue
                ms = np.asarray(v, dtype=np.int64)
                if self.pivot == DateListPivot.MODE_DAY:
                    units = ((ms // _MS_PER_DAY) + 3) % 7
                elif self.pivot == DateListPivot.MODE_MONTH:
                    units, _ = _civil_from_ms(ms)
                    units = units - 1
                else:  # MODE_HOUR
                    units = (ms % _MS_PER_DAY) // _MS_PER_HOUR
                vals, counts = np.unique(units, return_counts=True)
                picks.append(int(vals[np.argmax(counts)]))
            if self.pivot == DateListPivot.MODE_DAY:
                b, m = self._one_hot(picks, 7, _DAYS, f)
            elif self.pivot == DateListPivot.MODE_MONTH:
                b, m = self._one_hot(picks, 12, _MONTHS, f)
            else:
                b, m = self._one_hot(picks, 24,
                                     [f"{h:02d}h" for h in range(24)], f)
            blocks.extend(b)
            metas.extend(m)
        return vector_output(self.get_output().name, blocks, metas)


class DateToUnitCircleVectorizer(SequenceTransformer):
    """Date(s) -> [sin, cos] per time period, null-safe (missing -> 0,0)."""

    input_types = (Date,)
    output_type = OPVector

    def __init__(self, time_period: str = "HourOfDay",
                 uid: Optional[str] = None):
        super().__init__(operation_name="toUnitCircle", uid=uid)
        if time_period not in TIME_PERIODS:
            raise ValueError(
                f"Unknown time period {time_period!r}; "
                f"choose from {sorted(TIME_PERIODS)}")
        self.time_period = time_period

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col in zip(self.input_features, cols):
            blocks.append(unit_circle_block(date_phases(
                np.asarray(col.data, dtype=np.float64), self.time_period)))
            for trig in ("sin", "cos"):
                metas.append(VectorColumnMetadata(
                    parent_feature_name=f.name,
                    parent_feature_type=f.ftype.__name__,
                    descriptor_value=f"{trig}({self.time_period})"))
        return vector_output(self.get_output().name, blocks, metas)

    # -- device lowering: the encoder computes the [0, 1) phase on the
    # host in the same numpy code as transform_columns (int64 epoch
    # math); the kernel is the trig projection.
    def encodes_input(self, i: int) -> bool:
        return True

    def encode_input_column(self, i: int, col: FeatureColumn) -> np.ndarray:
        return date_phases(np.asarray(col.data, dtype=np.float64),
                           self.time_period)

    def transform_arrays(self, arrays):
        return _unit_circle_kernel(arrays)
