"""Numeric vectorizers: Real / Integral / Binary -> OPVector.

Counterpart of ``transmogrifai_tpu/ops/numeric.py``, the reference numeric
vectorizer family
(core/src/main/scala/com/salesforce/op/stages/impl/feature/
{RealVectorizer, IntegralVectorizer, BinaryVectorizer}; dispatched from
Transmogrifier.scala:116-340). Semantics preserved:

- Real family imputes missing with the training mean (or a constant),
  Integral with the training mode, Binary fills ``false``.
- ``track_nulls`` (TransmogrifierDefaults.TrackNulls = true) appends one
  0/1 null-indicator column per input feature.

Columnar execution: each input feature is one float64 numpy column with
NaN as missing (host path) or one tensor on the workflow's device
(``transform_arrays``); the output matrix is assembled in one shot.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..features.columns import FeatureColumn
from ..stages.base import SequenceEstimator, SequenceModel, SequenceTransformer
from ..types import Binary, Integral, OPNumeric, OPVector
from .vector_utils import NULL_INDICATOR, VectorColumnMetadata, vector_output

__all__ = ["RealVectorizer", "RealVectorizerModel", "IntegralVectorizer",
           "BinaryVectorizer"]


def _numeric_kernel(arrays, fills: List[float], track_nulls: bool):
    """Device counterpart of ``_numeric_blocks``: one (n,) tensor per
    input, NaN = missing; same column order as the numpy path (value,
    then null indicator, per input)."""
    cols = []
    for x, fill in zip(arrays, fills):
        isnan = torch.isnan(x)
        cols.append(torch.where(isnan, fill, x))
        if track_nulls:
            cols.append(isnan.to(x.dtype))
    return torch.stack(cols, dim=1)


def _numeric_blocks(stage, cols: List[FeatureColumn], fills: List[float],
                    track_nulls: bool):
    blocks, metas = [], []
    for f, col, fill in zip(stage.input_features, cols, fills):
        vals = np.asarray(col.data, dtype=np.float64)
        isnan = np.isnan(vals)
        blocks.append(np.where(isnan, fill, vals))
        metas.append(VectorColumnMetadata(
            parent_feature_name=f.name,
            parent_feature_type=f.ftype.__name__))
        if track_nulls:
            blocks.append(isnan.astype(np.float64))
            metas.append(VectorColumnMetadata(
                parent_feature_name=f.name,
                parent_feature_type=f.ftype.__name__,
                indicator_value=NULL_INDICATOR))
    return blocks, metas


class RealVectorizerModel(SequenceModel):
    input_types = (OPNumeric,)
    output_type = OPVector

    def __init__(self, fill_values: List[float], track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="vecReal", uid=uid)
        self.fill_values = [float(v) for v in np.asarray(fill_values)]
        self.track_nulls = track_nulls

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = _numeric_blocks(self, cols, self.fill_values,
                                        self.track_nulls)
        return vector_output(self.get_output().name, blocks, metas)

    def transform_arrays(self, arrays):
        return _numeric_kernel(arrays, self.fill_values, self.track_nulls)


class RealVectorizer(SequenceEstimator):
    """Impute-with-mean (or constant) + null tracking for the Real family
    (reference RealVectorizer / FillMissingWithMean)."""

    input_types = (OPNumeric,)
    output_type = OPVector

    def __init__(self, fill_with_mean: bool = True, fill_value: float = 0.0,
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="vecReal", uid=uid)
        self.fill_with_mean = fill_with_mean
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def fit_columns(self, cols: List[FeatureColumn]) -> RealVectorizerModel:
        fills = []
        for col in cols:
            vals = np.asarray(col.data, dtype=np.float64)
            ok = ~np.isnan(vals)
            if self.fill_with_mean and ok.any():
                fills.append(float(np.mean(vals[ok])))
            else:
                fills.append(float(self.fill_value))
        return RealVectorizerModel(fill_values=fills,
                                   track_nulls=self.track_nulls)


class IntegralVectorizer(SequenceEstimator):
    """Impute-with-mode + null tracking for Integral features
    (reference IntegralVectorizer)."""

    input_types = (Integral,)
    output_type = OPVector

    def __init__(self, fill_with_mode: bool = True, fill_value: float = 0.0,
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="vecIntegral", uid=uid)
        self.fill_with_mode = fill_with_mode
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def fit_columns(self, cols: List[FeatureColumn]) -> RealVectorizerModel:
        fills = []
        for col in cols:
            vals = np.asarray(col.data, dtype=np.float64)
            ok = vals[~np.isnan(vals)]
            if self.fill_with_mode and len(ok):
                uniq, counts = np.unique(ok, return_counts=True)
                fills.append(float(uniq[np.argmax(counts)]))
            else:
                fills.append(float(self.fill_value))
        return RealVectorizerModel(fill_values=fills,
                                   track_nulls=self.track_nulls)


class BinaryVectorizer(SequenceTransformer):
    """Binary -> {0,1} with false-fill + null tracking
    (reference BinaryVectorizer; stateless, so a Transformer)."""

    input_types = (Binary,)
    output_type = OPVector

    def __init__(self, fill_value: bool = False, track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="vecBinary", uid=uid)
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        fills = [float(self.fill_value)] * len(cols)
        blocks, metas = _numeric_blocks(self, cols, fills, self.track_nulls)
        return vector_output(self.get_output().name, blocks, metas)

    def transform_arrays(self, arrays):
        return _numeric_kernel(arrays, [float(self.fill_value)] * len(arrays),
                               self.track_nulls)
