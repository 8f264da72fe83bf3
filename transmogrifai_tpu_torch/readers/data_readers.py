"""Typed data readers: simple, aggregate, and conditional ingestion.

The port's own copy of ``transmogrifai_tpu/readers/data_readers.py``
(reference readers/src/main/scala/com/salesforce/op/readers/
{Reader.scala:96,168, DataReader.scala:57,173,206,252,288,351,
DataReaders.scala:44}). A reader loads raw records (CSV, Avro, Parquet or
in memory), optionally groups them by key and monoid-aggregates each
feature's dated events around a cutoff time, and materializes the
raw-feature Dataset the workflow trains on. All of it is host Python, as
in the JAX package: the workflow moves the prepared matrix to its device.

- :class:`DataReader` — one record = one row (simple readers).
- :class:`AggregateDataReader` — groupBy(key); predictors aggregate
  events strictly before the cutoff, responses at/after it, with the
  reference's exact boundaries (FeatureAggregator.scala:114-122).
- :class:`ConditionalDataReader` — per-key cutoff from a target
  condition (e.g. "first purchase"); predictors aggregate before the
  key's own event, responses within a window after
  (ConditionalParams:351).

The aggregate readers group the records once and read each record's
event time once; a feature's extract function runs on the events its
window keeps. The datasets equal the JAX package's (keys sorted as
strings, the same values in the same order).
"""
from __future__ import annotations

import csv as _csv
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..features.aggregators import CutOffTime, Event, default_aggregator
from ..features.columns import Dataset, FeatureColumn
from ..features.feature import Feature
from ..features.generator import FeatureGeneratorStage
from ..types import OPNumeric
from ..types.base import NonNullable

__all__ = ["DataReader", "AggregateDataReader", "ConditionalDataReader",
           "CSVProductReader", "CSVAutoReader", "ParquetProductReader",
           "DataReaders"]


def _zero_filled(ftype, values: List[Any]) -> List[Any]:
    """Aggregated values, non-nullable numeric types getting the monoid
    zero for keys with no surviving events (reference: RealNN monoid zero
    is 0.0, MonoidAggregatorDefaults.scala)."""
    if issubclass(ftype, NonNullable) and issubclass(ftype, OPNumeric):
        return [0.0 if v is None else v for v in values]
    return values


def _box_aggregated(ftype, values: List[Any]) -> List[Any]:
    """Boxed aggregated values (``_zero_filled``, then each through the
    feature type)."""
    return [ftype.from_any(v) for v in _zero_filled(ftype, values)]


class DataReader:
    """Batch reader over in-memory records or a file
    (reference DataReader.scala:57; key fn per ReaderKey.scala:74-94)."""

    def __init__(self, records: Optional[Iterable[Any]] = None,
                 key_fn: Optional[Callable[[Any], str]] = None,
                 source: Optional["DataReader"] = None):
        self._records = list(records) if records is not None else None
        self._source = source
        self.key_fn = key_fn

    # -- loading -----------------------------------------------------------
    def read_records(self) -> List[Any]:
        if self._records is not None:
            return self._records
        if self._source is not None:
            return self._source.read_records()  # lazy file I/O
        raise ValueError(f"{type(self).__name__} has no data source")

    # -- materialization (reference generateDataFrame:173) -----------------
    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        records = self.read_records()
        return Dataset({f.name: self._generator(f).extract_column(records)
                        for f in raw_features})

    @staticmethod
    def _generator(f: Feature) -> FeatureGeneratorStage:
        gen = f.origin_stage
        if not isinstance(gen, FeatureGeneratorStage):
            raise TypeError(f"Feature {f.name!r} has no generator stage")
        return gen


class _KeyedEvents:
    """Records grouped by ``str(key_fn(record))`` with each record's event
    time, read once for every feature; the events a window keeps are
    found once for every feature with that window."""

    def __init__(self, records: List[Any], key_fn, timestamp_fn):
        self.groups: Dict[str, List[Any]] = {}
        for r in records:
            self.groups.setdefault(str(key_fn(r)), []).append(r)
        self.times = {k: [int(timestamp_fn(r)) for r in rs]
                      for k, rs in self.groups.items()}
        self._kept: Dict[tuple, Dict[str, Optional[List[int]]]] = {}

    def kept(self, keys: Sequence[str], window_key: tuple,
             keep: Callable[[str, List[int]], Optional[List[int]]]
             ) -> Dict[str, Optional[List[int]]]:
        """Each key's kept event positions (None: all of them) under the
        window ``window_key`` names, ``keep(key, times)`` computing them
        the first time."""
        hit = self._kept.get(window_key)
        if hit is None:
            hit = self._kept[window_key] = {
                k: keep(k, self.times[k]) for k in keys}
        return hit

    def aggregate(self, f: Feature, gen: FeatureGeneratorStage,
                  keys: Sequence[str],
                  kept: Dict[str, Optional[List[int]]]) -> FeatureColumn:
        """``f``'s column over ``keys``: each key's ``kept`` events folded
        by the feature's aggregator."""
        agg = gen.aggregator or default_aggregator(f.ftype)
        by_events = hasattr(agg, "reduce_events")
        fn = gen.extract_fn
        values: List[Any] = []
        for k in keys:
            rs, idx = self.groups[k], kept[k]
            if idx is None:
                idx = range(len(rs))
            if by_events:
                ts = self.times[k]
                v = agg.reduce_events([Event(ts[i], fn(rs[i]), f.is_response)
                                       for i in idx])
            else:
                v = agg.reduce([fn(rs[i]) for i in idx])
            values.append(v.value if hasattr(v, "value") else v)
        # from_values boxes each value through the feature type, as
        # _box_aggregated does in the JAX package
        return FeatureColumn.from_values(f.ftype,
                                         _zero_filled(f.ftype, values))


def _window_filter(is_response: bool, cutoff: int,
                   window: Optional[int]) -> Callable[[List[int]], List[int]]:
    """Positions of the event times a feature keeps (reference
    FeatureAggregator.filterByDateWithCutoff, FeatureAggregator.scala:
    114-122): responses ``cutoff <= t <= cutoff + window``, predictors
    ``cutoff - window <= t < cutoff``; no window leaves that side open."""
    if is_response:
        hi = None if window is None else cutoff + window
        return lambda ts: [i for i, t in enumerate(ts)
                           if t >= cutoff and (hi is None or t <= hi)]
    lo = None if window is None else cutoff - window
    return lambda ts: [i for i, t in enumerate(ts)
                       if t < cutoff and (lo is None or t >= lo)]


class AggregateDataReader(DataReader):
    """GroupBy-key + monoid aggregation with a cutoff
    (reference AggregateDataReader, DataReader.scala:252).

    ``timestamp_fn`` extracts each record's event time (ms). Predictor
    features aggregate events with ``cutoff - window <= time < cutoff``
    (window set per feature on the builder); response features
    aggregate events with ``cutoff <= time <= cutoff + window``, a
    feature's own window winning over the reader's
    ``response_window_ms`` (FeatureAggregator.scala:114-122).
    """

    def __init__(self, records: Optional[Iterable[Any]] = None,
                 key_fn: Optional[Callable[[Any], str]] = None,
                 timestamp_fn: Optional[Callable[[Any], int]] = None,
                 cutoff_time: Optional[CutOffTime] = None,
                 response_window_ms: Optional[int] = None,
                 source: Optional[DataReader] = None):
        super().__init__(records, key_fn, source=source)
        if key_fn is None:
            raise ValueError("AggregateDataReader requires key_fn")
        self.timestamp_fn = timestamp_fn or (lambda r: 0)
        self.cutoff_time = cutoff_time or CutOffTime.no_cutoff()
        self.response_window_ms = response_window_ms

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        events = _KeyedEvents(self.read_records(), self.key_fn,
                              self.timestamp_fn)
        keys = sorted(events.groups)
        cutoff = self.cutoff_time.time_ms
        cols: Dict[str, FeatureColumn] = {}
        for f in raw_features:
            gen = self._generator(f)
            window = gen.aggregate_window_ms
            if f.is_response and window is None:
                # the feature's own window first (reference
                # specialTimeWindow.orElse(timeWindow))
                window = self.response_window_ms
            keep = (None if cutoff is None
                    else _window_filter(f.is_response, cutoff, window))
            kept = events.kept(
                keys, (f.is_response, window),
                lambda k, ts: None if keep is None else keep(ts))
            cols[f.name] = events.aggregate(f, gen, keys, kept)
        ds = Dataset(cols)
        ds.keys = keys  # row identity (reference KeyFieldName column)
        return ds


class ConditionalDataReader(AggregateDataReader):
    """Per-key cutoff from a target condition
    (reference ConditionalDataReader, DataReader.scala:288 +
    ConditionalParams:351): each key's cutoff is the time of its first
    record matching ``target_condition``; keys with no match are dropped
    (``drop_if_no_target=True``) or, when kept, contribute all events to
    predictors and none to responses (no label without a target event).
    The same boundaries as the aggregate filter, with the key's target
    time as the cutoff; a feature without a window of its own takes
    ``predictor_window_ms`` or ``response_window_ms``."""

    def __init__(self, records: Optional[Iterable[Any]] = None,
                 key_fn: Optional[Callable[[Any], str]] = None,
                 timestamp_fn: Optional[Callable[[Any], int]] = None,
                 target_condition: Optional[Callable[[Any], bool]] = None,
                 response_window_ms: Optional[int] = None,
                 predictor_window_ms: Optional[int] = None,
                 drop_if_no_target: bool = True,
                 source: Optional[DataReader] = None):
        super().__init__(records, key_fn, timestamp_fn,
                         CutOffTime.no_cutoff(), response_window_ms,
                         source=source)
        if target_condition is None:
            raise ValueError("ConditionalDataReader requires "
                             "target_condition")
        self.target_condition = target_condition
        self.predictor_window_ms = predictor_window_ms
        self.drop_if_no_target = drop_if_no_target

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        events = _KeyedEvents(self.read_records(), self.key_fn,
                              self.timestamp_fn)
        cutoffs: Dict[str, int] = {}
        for k, rs in events.groups.items():
            times = [t for r, t in zip(rs, events.times[k])
                     if self.target_condition(r)]
            if times:
                cutoffs[k] = min(times)
        keys = sorted(cutoffs if self.drop_if_no_target else events.groups)

        cols: Dict[str, FeatureColumn] = {}
        for f in raw_features:
            gen = self._generator(f)
            window = gen.aggregate_window_ms
            if window is None:
                window = (self.response_window_ms if f.is_response
                          else self.predictor_window_ms)

            def keep(k, ts, is_response=f.is_response, window=window):
                cutoff = cutoffs.get(k)
                if cutoff is None:
                    # no target event: every event a predictor, no label
                    return [] if is_response else None
                return _window_filter(is_response, cutoff, window)(ts)
            kept = events.kept(keys, (f.is_response, window), keep)
            cols[f.name] = events.aggregate(f, gen, keys, kept)
        ds = Dataset(cols)
        ds.keys = keys
        return ds


# ---------------------------------------------------------------------------
# file-format readers (reference CSVReaders.scala / CSVAutoReaders.scala /
# AvroReaders.scala / ParquetProductReader.scala)
# ---------------------------------------------------------------------------

def _parse_cell(v: str):
    if v is None or v == "":
        return None
    return v


class CSVProductReader(DataReader):
    """Header CSV -> dict records, raw strings (reference csvCase readers;
    typed conversion happens in feature extract fns)."""

    def __init__(self, path: str,
                 key_fn: Optional[Callable[[Any], str]] = None):
        super().__init__(records=None, key_fn=key_fn)
        self.path = path

    def read_records(self) -> List[Dict[str, Any]]:
        with open(self.path, newline="") as fh:
            return [{k: _parse_cell(v) for k, v in row.items()}
                    for row in _csv.DictReader(fh)]


class CSVAutoReader(CSVProductReader):
    """CSV with schema inference: numeric-looking cells become floats/ints
    (reference CSVAutoReaders.scala + spark-csv inference)."""

    def read_records(self) -> List[Dict[str, Any]]:
        rows = super().read_records()
        if not rows:
            return rows
        casts: Dict[str, Callable] = {}
        for c in rows[0].keys():
            vals = [r[c] for r in rows if r[c] is not None]
            if vals and all(_is_number(v) for v in vals):
                casts[c] = float if any("." in v or "e" in v.lower()
                                        for v in vals) else int
        for r in rows:
            for c, cast in casts.items():
                if r[c] is not None:
                    # int columns cast directly (no float round-trip, so
                    # ids > 2^53 stay exact)
                    r[c] = cast(r[c])
        return rows


def _is_number(v: str) -> bool:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return False
    # 'nan'/'inf' cells are not numeric data (common export artifacts)
    return bool(np.isfinite(f))


class AvroProductReader(DataReader):
    """Avro object container file(s) -> dict records (reference
    AvroReaders.scala; decoding via ``utils/avro_io.py``). ``path`` may be
    a file or a glob, read in name order."""

    def __init__(self, path: str,
                 key_fn: Optional[Callable[[Any], str]] = None):
        super().__init__(records=None, key_fn=key_fn)
        self.path = path

    def read_records(self) -> List[Dict[str, Any]]:
        import glob as _glob
        from ..utils.avro_io import read_avro
        out: List[Dict[str, Any]] = []
        for p in sorted(_glob.glob(self.path)) or [self.path]:
            out.extend(read_avro(p))
        return out


class ParquetProductReader(DataReader):
    """Parquet via pandas/pyarrow (reference ParquetProductReader.scala);
    raises ImportError where pandas is absent."""

    def __init__(self, path: str,
                 key_fn: Optional[Callable[[Any], str]] = None):
        super().__init__(records=None, key_fn=key_fn)
        self.path = path

    def read_records(self) -> List[Dict[str, Any]]:
        import pandas as pd
        recs = pd.read_parquet(self.path).to_dict(orient="records")
        for r in recs:
            for k, v in r.items():
                if isinstance(v, float) and np.isnan(v):
                    r[k] = None
        return recs


class DataReaders:
    """Factory namespace (reference DataReaders.scala:44)."""

    class Simple:
        @staticmethod
        def csv(path: str, key_fn=None) -> CSVProductReader:
            return CSVProductReader(path, key_fn)

        @staticmethod
        def csv_auto(path: str, key_fn=None) -> CSVAutoReader:
            return CSVAutoReader(path, key_fn)

        @staticmethod
        def avro(path: str, key_fn=None) -> AvroProductReader:
            return AvroProductReader(path, key_fn)

        @staticmethod
        def parquet(path: str, key_fn=None) -> ParquetProductReader:
            return ParquetProductReader(path, key_fn)

        @staticmethod
        def custom(records, key_fn=None) -> DataReader:
            return DataReader(records, key_fn)

    class Aggregate:
        @staticmethod
        def csv(path: str, key_fn, timestamp_fn, cutoff_time=None,
                response_window_ms=None) -> AggregateDataReader:
            return AggregateDataReader(
                source=CSVProductReader(path),
                key_fn=key_fn, timestamp_fn=timestamp_fn,
                cutoff_time=cutoff_time,
                response_window_ms=response_window_ms)

        @staticmethod
        def custom(records, key_fn, timestamp_fn, cutoff_time=None,
                   response_window_ms=None) -> AggregateDataReader:
            return AggregateDataReader(records, key_fn, timestamp_fn,
                                       cutoff_time, response_window_ms)

    class Conditional:
        @staticmethod
        def custom(records, key_fn, timestamp_fn, target_condition,
                   response_window_ms=None, predictor_window_ms=None,
                   drop_if_no_target=True) -> ConditionalDataReader:
            return ConditionalDataReader(
                records, key_fn, timestamp_fn, target_condition,
                response_window_ms, predictor_window_ms, drop_if_no_target)
