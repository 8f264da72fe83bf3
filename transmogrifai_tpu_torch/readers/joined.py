"""Joined readers: combine two readers on their keys.

The port's own copy of ``transmogrifai_tpu/readers/joined.py`` (host
Python, as there), from the reference reader algebra
(readers/src/main/scala/com/salesforce/op/readers/JoinedDataReader.scala:
83,119,251): ``left.outer_join(right)`` / ``inner_join`` produce a
reader whose records merge the two sides' fields per key; features
extract from the merged record. A secondary aggregation can run after
the join (JoinedAggregateDataReader:251) via ``with_aggregation``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..features.columns import ColumnKind, Dataset, FeatureColumn
from ..features.feature import Feature
from .data_readers import AggregateDataReader, DataReader, _box_aggregated

__all__ = ["JoinedDataReader", "JoinedAggregateReaders", "JoinKeys"]


class JoinKeys:
    """(reference JoinKeys, JoinedDataReader.scala:83)"""

    def __init__(self, left_key: Callable[[Any], str],
                 right_key: Callable[[Any], str]):
        self.left_key = left_key
        self.right_key = right_key


class JoinedDataReader(DataReader):
    """Join two readers' records by key (reference JoinedReader:119).

    ``join_type``: "leftOuter" keeps all left keys (right fields None
    when absent); "inner" keeps only matched keys. Colliding field
    names take the left side's value (right accessible via
    ``right_prefix``).
    """

    def __init__(self, left: DataReader, right: DataReader,
                 join_keys: JoinKeys, join_type: str = "leftOuter",
                 right_prefix: str = "right_"):
        super().__init__(records=None, key_fn=None)
        if join_type not in ("leftOuter", "inner"):
            raise ValueError("join_type must be 'leftOuter' or 'inner'")
        self.left = left
        self.right = right
        self.join_keys = join_keys
        self.join_type = join_type
        self.right_prefix = right_prefix
        self._aggregation: Optional[AggregateDataReader] = None

    # -- reader algebra (reference innerJoin/leftOuterJoin) -----------------
    @staticmethod
    def left_outer(left: DataReader, right: DataReader,
                   left_key, right_key) -> "JoinedDataReader":
        return JoinedDataReader(left, right,
                                JoinKeys(left_key, right_key), "leftOuter")

    @staticmethod
    def inner(left: DataReader, right: DataReader,
              left_key, right_key) -> "JoinedDataReader":
        return JoinedDataReader(left, right,
                                JoinKeys(left_key, right_key), "inner")

    def with_aggregation(self, key_fn, timestamp_fn, cutoff_time=None,
                         response_window_ms=None) -> AggregateDataReader:
        """Secondary aggregation after the join
        (reference JoinedAggregateDataReader:251)."""
        return AggregateDataReader(
            source=self, key_fn=key_fn, timestamp_fn=timestamp_fn,
            cutoff_time=cutoff_time,
            response_window_ms=response_window_ms)

    # -- materialization ----------------------------------------------------
    def read_records(self) -> List[Dict[str, Any]]:
        left_records = self.left.read_records()
        right_records = self.right.read_records()
        by_key: Dict[str, List[Any]] = {}
        for r in right_records:
            by_key.setdefault(str(self.join_keys.right_key(r)), []).append(r)

        def fields(rec) -> Dict[str, Any]:
            return dict(rec) if isinstance(rec, dict) else {
                k: getattr(rec, k) for k in dir(rec)
                if not k.startswith("_")}

        out: List[Dict[str, Any]] = []
        for l in left_records:
            key = str(self.join_keys.left_key(l))
            matches = by_key.get(key)
            if not matches:
                if self.join_type == "inner":
                    continue
                out.append(fields(l))
                continue
            for r in matches:
                merged = fields(r)
                merged.update({f"{self.right_prefix}{k}": v
                               for k, v in merged.items()})
                merged.update(fields(l))  # left wins on collision
                out.append(merged)
        return out


class JoinedAggregateReaders(DataReader):
    """Key-join of two KEYED readers' PREPARED datasets — the
    reference's actual join semantics (JoinedDataReader.scala:119 joins
    the sides' generated dataframes on their key columns, after each
    side aggregated its own features).

    Features bind to a side with ``FeatureBuilder...from_source(name)``
    (the reference encodes the side in FeatureBuilder[T]'s reader type
    parameter); untagged features default to the left side. For
    "leftOuter" the row keys are the left side's keys and right-side
    columns are empty (None) for keys absent from the right DATA —
    distinct from the monoid zero a present-but-filtered key aggregates
    to, matching the reference's null-vs-0.0 output. "inner" keeps the
    key intersection (left order).
    """

    def __init__(self, left: DataReader, right: DataReader,
                 left_name: str = "left", right_name: str = "right",
                 join_type: str = "leftOuter"):
        super().__init__(records=None, key_fn=None)
        if join_type not in ("leftOuter", "inner"):
            raise ValueError("join_type must be 'leftOuter' or 'inner'")
        self.left = left
        self.right = right
        self.left_name = left_name
        self.right_name = right_name
        self.join_type = join_type

    def _split(self, raw_features: Sequence[Feature]):
        lf, rf = [], []
        for f in raw_features:
            src = getattr(f.origin_stage, "source_name", None)
            if src == self.right_name:
                rf.append(f)
            elif src in (None, self.left_name):
                lf.append(f)
            else:
                raise ValueError(
                    f"feature {f.name!r} is bound to unknown source "
                    f"{src!r}; sides are {self.left_name!r} / "
                    f"{self.right_name!r}")
        dup = {f.name for f in lf} & {f.name for f in rf}
        if dup:
            raise ValueError(
                f"feature names {sorted(dup)} appear on both join "
                f"sides; rename one side's features")
        return lf, rf

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        lf, rf = self._split(raw_features)
        lds = self.left.generate_dataset(lf)
        rds = self.right.generate_dataset(rf)
        lkeys = getattr(lds, "keys", None)
        rkeys = getattr(rds, "keys", None)
        if lkeys is None or rkeys is None:
            raise ValueError(
                "JoinedAggregateReaders requires keyed sides (readers "
                "whose datasets carry per-row keys, e.g. aggregate/"
                "conditional readers)")
        if self.join_type == "inner":
            rset = set(rkeys)
            keys = [k for k in lkeys if k in rset]
        else:
            keys = list(lkeys)
        lpos = {k: i for i, k in enumerate(lkeys)}
        rpos = {k: i for i, k in enumerate(rkeys)}
        cols = {}
        for f, ds, side_keys, pos in ([(f, lds, lkeys, lpos) for f in lf]
                                      + [(f, rds, rkeys, rpos) for f in rf]):
            cols[f.name] = _rows_by_key(f, ds[f.name], side_keys, pos, keys)
        out = Dataset(cols)
        out.keys = keys
        return out


def _rows_by_key(f: Feature, col: FeatureColumn, side_keys: List[str],
                 pos: Dict[str, int], keys: List[str]) -> FeatureColumn:
    """``col``'s rows in the order of ``keys``. A key absent from the
    side gets null for nullable types and the monoid zero for NonNullable
    numerics (RealNN cannot hold null — the rule ``_box_aggregated``
    applies to empty aggregations). The side's values were boxed when it
    aggregated them, so they are taken as they are (the JAX package boxes
    them again, to the same values)."""
    if list(side_keys) == list(keys):
        return col
    idx = np.asarray([pos.get(k, -1) for k in keys], dtype=np.int64)
    absent = FeatureColumn.from_values(f.ftype,
                                       _box_aggregated(f.ftype, [None]))
    if col.kind == ColumnKind.NUMERIC:
        data = np.where(idx >= 0, col.data[np.maximum(idx, 0)],
                        absent.data[0])
    else:
        data = np.empty(len(keys), dtype=object)
        for i, j in enumerate(idx):
            data[i] = col.data[j] if j >= 0 else \
                f.ftype.from_any(absent.data[0]).value
    return FeatureColumn(f.ftype, data, col.metadata)
