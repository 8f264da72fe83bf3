"""Columnar batch representation of typed features.

Counterpart of ``transmogrifai_tpu/features/columns.py``. Host columns are
the JAX package's:

- numeric family  -> float64 numpy array, NaN encodes missing
- text family     -> object numpy array of ``str | None``
- list/set/map    -> object numpy array of tuples / frozensets / dicts
- OPVector        -> dense 2-D float array + ``VectorMetadata``

A numeric or vector column that a stage computed on the workflow's device
holds a ``torch.Tensor`` there instead (float32 on a card, float64 on the
CPU). Host consumers never convert one implicitly: the prepare plan
copies a device column to the host (``host_column``) where a host stage
needs its values, and records it. Boxed values (``boxed``) serve
row-wise stages such as ``LambdaTransformer``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Type

import numpy as np
import torch

from ..types import FeatureType, Integral, Binary, OPNumeric, OPVector, \
    Prediction, Text
from ..utils.device import take_rows
from ..utils.vector_meta import VectorMetadata

__all__ = ["FeatureColumn", "PredictionColumn", "Dataset", "column_kind",
           "ColumnKind", "host_column"]


class ColumnKind:
    NUMERIC = "numeric"
    TEXT = "text"
    OBJECT = "object"   # lists / sets / maps / geolocations
    VECTOR = "vector"


def column_kind(ftype: Type[FeatureType]) -> str:
    if issubclass(ftype, OPVector):
        return ColumnKind.VECTOR
    if issubclass(ftype, OPNumeric):
        return ColumnKind.NUMERIC
    if issubclass(ftype, Text):
        return ColumnKind.TEXT
    return ColumnKind.OBJECT


@dataclass
class FeatureColumn:
    """A column of ``n_rows`` values of one feature type."""
    ftype: Type[FeatureType]
    data: Any
    metadata: Optional[VectorMetadata] = None

    @property
    def kind(self) -> str:
        return column_kind(self.ftype)

    @property
    def n_rows(self) -> int:
        return int(self.data.shape[0])

    @property
    def on_device(self) -> bool:
        """True when the values are a tensor (a device-computed column)."""
        return isinstance(self.data, torch.Tensor)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_values(ftype: Type[FeatureType], values: Iterable[Any],
                    metadata: Optional[VectorMetadata] = None
                    ) -> "FeatureColumn":
        """Build a column from raw python values (each is boxed-converted
        through the feature type for validation/normalization)."""
        kind = column_kind(ftype)
        boxed = [v.value if isinstance(v, FeatureType) else ftype(v).value
                 for v in values]
        if kind == ColumnKind.NUMERIC:
            arr = np.asarray(
                [math.nan if b is None else float(b) for b in boxed],
                dtype=np.float64)
        elif kind == ColumnKind.VECTOR:
            if len(boxed) == 0:
                arr = np.zeros((0, 0), dtype=np.float64)
            else:
                arr = np.stack([np.asarray(b, dtype=np.float64)
                                for b in boxed])
        else:
            arr = np.empty(len(boxed), dtype=object)
            arr[:] = boxed
        return FeatureColumn(ftype=ftype, data=arr, metadata=metadata)

    @staticmethod
    def vector(data, metadata: VectorMetadata) -> "FeatureColumn":
        """An OPVector column of a 2-D numpy array (as float64) or tensor
        (as it is)."""
        if not isinstance(data, torch.Tensor):
            data = np.asarray(data, dtype=np.float64)
        if data.ndim != 2:
            raise ValueError(f"vector column requires 2-D data, got {data.ndim}-D")
        if metadata.size != data.shape[1]:
            raise ValueError(
                f"metadata size {metadata.size} != vector width {data.shape[1]}")
        return FeatureColumn(ftype=OPVector, data=data, metadata=metadata)

    # -- access ------------------------------------------------------------
    def boxed(self, i: int) -> FeatureType:
        """Boxed value at row ``i`` (edge-of-system only)."""
        v = self.data[i]
        if self.kind == ColumnKind.NUMERIC:
            v = None if (v != v) else float(v)
            if issubclass(self.ftype, (Integral, Binary)) and v is not None:
                v = int(v) if issubclass(self.ftype, Integral) else bool(v)
        return self.ftype(v)

    def is_missing(self) -> np.ndarray:
        """Boolean mask of empty rows (host columns)."""
        k = self.kind
        if k == ColumnKind.NUMERIC:
            return np.isnan(np.asarray(self.data, dtype=np.float64))
        if k == ColumnKind.TEXT:
            # empty string is *present* (reference: Text(Some("")) non-empty)
            return np.asarray([v is None for v in self.data], dtype=bool)
        if k == ColumnKind.VECTOR:
            return np.zeros(self.n_rows, dtype=bool)
        return np.asarray([v is None or len(v) == 0 for v in self.data],
                          dtype=bool)

    def take(self, idx: np.ndarray) -> "FeatureColumn":
        return FeatureColumn(self.ftype, take_rows(self.data, idx),
                             self.metadata)

    def __len__(self) -> int:
        return self.n_rows


def host_column(col: FeatureColumn) -> FeatureColumn:
    """``col`` with its values on the host as float64 numpy (a copy from
    the device for a tensor column; the column itself otherwise)."""
    if not col.on_device:
        return col
    data = col.data.detach().to("cpu", torch.float64).numpy()
    return FeatureColumn(col.ftype, data, col.metadata)


@dataclass
class PredictionColumn(FeatureColumn):
    """Columnar batch of ``Prediction`` values: ``data`` holds the (n,)
    predicted values and ``probability`` / ``raw_prediction`` the (n, k)
    per-class arrays (k = 0 when absent), all numpy on the host. Boxed
    ``Prediction`` dicts are synthesized only at the row-level scoring
    edge."""
    probability: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), dtype=np.float64))
    raw_prediction: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), dtype=np.float64))

    @staticmethod
    def from_arrays(prediction: np.ndarray,
                    probability: Optional[np.ndarray] = None,
                    raw_prediction: Optional[np.ndarray] = None
                    ) -> "PredictionColumn":
        pred = np.asarray(prediction, dtype=np.float64).reshape(-1)
        n = pred.shape[0]
        prob = (np.zeros((n, 0)) if probability is None
                else np.asarray(probability, dtype=np.float64).reshape(n, -1))
        raw = (np.zeros((n, 0)) if raw_prediction is None
               else np.asarray(raw_prediction, dtype=np.float64).reshape(n, -1))
        return PredictionColumn(ftype=Prediction, data=pred,
                                probability=prob, raw_prediction=raw)

    def boxed(self, i: int) -> Prediction:
        return Prediction.build(
            float(self.data[i]),
            raw_prediction=self.raw_prediction[i]
            if self.raw_prediction.shape[1] else None,
            probability=self.probability[i]
            if self.probability.shape[1] else None)

    def is_missing(self) -> np.ndarray:
        return np.zeros(self.n_rows, dtype=bool)

    def take(self, idx: np.ndarray) -> "PredictionColumn":
        return PredictionColumn(
            ftype=self.ftype, data=self.data[idx], metadata=self.metadata,
            probability=self.probability[idx],
            raw_prediction=self.raw_prediction[idx])


class Dataset:
    """Named collection of equal-length feature columns — the framework's
    DataFrame equivalent (reference RichDataset, features/.../utils/spark/
    RichDataset.scala:60)."""

    def __init__(self, columns: Optional[Dict[str, FeatureColumn]] = None):
        self._columns: Dict[str, FeatureColumn] = dict(columns or {})
        lens = {c.n_rows for c in self._columns.values()}
        if len(lens) > 1:
            raise ValueError(f"Column length mismatch: {lens}")

    # -- core --------------------------------------------------------------
    @property
    def n_rows(self) -> int:
        for c in self._columns.values():
            return c.n_rows
        return 0

    @property
    def column_names(self) -> List[str]:
        return list(self._columns.keys())

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __getitem__(self, name: str) -> FeatureColumn:
        try:
            return self._columns[name]
        except KeyError:
            raise KeyError(
                f"No column {name!r}; have {sorted(self._columns)}") from None

    def with_column(self, name: str, col: FeatureColumn) -> "Dataset":
        if self._columns and col.n_rows != self.n_rows:
            raise ValueError(
                f"Column {name!r} has {col.n_rows} rows, dataset has {self.n_rows}")
        new = dict(self._columns)
        new[name] = col
        return Dataset(new)

    def select(self, names: Sequence[str]) -> "Dataset":
        return Dataset({n: self[n] for n in names})

    def drop(self, names: Sequence[str]) -> "Dataset":
        drop = set(names)
        return Dataset({n: c for n, c in self._columns.items()
                        if n not in drop})

    def take(self, idx: np.ndarray) -> "Dataset":
        """Rows ``idx`` of every column (a tensor column gathers on its
        own device)."""
        return Dataset({n: c.take(idx) for n, c in self._columns.items()})

    def rows(self, names: Optional[Sequence[str]] = None):
        """Iterate boxed row dicts — local-scoring edge only (a tensor
        column is copied to the host once)."""
        names = list(names) if names is not None else self.column_names
        cols = {n: host_column(self._columns[n]) for n in names}
        for i in range(self.n_rows):
            yield {n: cols[n].boxed(i) for n in names}

    # -- conversion (pandas is imported here only) -------------------------
    @staticmethod
    def from_pandas(df, schema: Dict[str, Type[FeatureType]]) -> "Dataset":
        import pandas as pd
        cols = {}
        for name, ftype in schema.items():
            values = [None if (v is None or (not isinstance(v, (list, tuple, set, frozenset, dict, np.ndarray))
                               and pd.isna(v))) else v
                      for v in df[name].tolist()]
            cols[name] = FeatureColumn.from_values(ftype, values)
        return Dataset(cols)

    def to_pandas(self, names: Optional[Sequence[str]] = None):
        import pandas as pd
        names = list(names) if names is not None else self.column_names
        out = {}
        for n in names:
            c = host_column(self._columns[n])
            if c.kind == ColumnKind.VECTOR:
                out[n] = [np.asarray(row) for row in c.data]
            else:
                out[n] = c.data
        return pd.DataFrame(out)

    def __repr__(self) -> str:
        parts = ", ".join(f"{n}: {c.ftype.__name__}"
                          for n, c in self._columns.items())
        return f"Dataset({self.n_rows} rows; {parts})"
