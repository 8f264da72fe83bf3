"""Geolocation vectorizer: (lat, lon, accuracy) triples -> OPVector.

Counterpart of ``transmogrifai_tpu/ops/geo.py``, the reference
GeolocationVectorizer
(core/src/main/scala/com/salesforce/op/stages/impl/feature/
GeolocationVectorizer.scala): missing locations fill with the training
data's geographic midpoint (unit-vector average, the reference's Lucene
spatial3d computation; the port keeps its own copy of the JAX package's
``GeolocationMidpoint`` aggregator, ``geolocation_midpoint``), plus
optional null tracking. The triples are object values, so the encoder
walks them on the host and emits the dense block; the device part is the
concatenation.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..features.columns import FeatureColumn
from ..stages.base import SequenceEstimator, SequenceModel
from ..types import Geolocation, OPVector
from .vector_utils import NULL_INDICATOR, VectorColumnMetadata, vector_output

__all__ = ["GeolocationVectorizer", "GeolocationVectorizerModel",
           "geolocation_midpoint"]


def geolocation_midpoint(points: Sequence[Sequence[float]]
                         ) -> Optional[List[float]]:
    """Geographic midpoint of (lat, lon[, accuracy]) points via the 3-D
    unit-vector average, summed in the points' order (the JAX package's
    ``features/aggregators.GeolocationMidpoint().reduce``); None when
    there is no point."""
    acc = None
    for v in points:
        if v is None:
            continue
        lat, lon = math.radians(v[0]), math.radians(v[1])
        p = [math.cos(lat) * math.cos(lon), math.cos(lat) * math.sin(lon),
             math.sin(lat), 1.0, v[2] if len(v) > 2 else 1.0]
        acc = p if acc is None else [x + y for x, y in zip(acc, p)]
    if acc is None or acc[3] == 0:
        return None
    x, y, z = (c / acc[3] for c in acc[:3])
    lon = math.degrees(math.atan2(y, x))
    lat = math.degrees(math.atan2(z, math.hypot(x, y)))
    return [lat, lon, acc[4] / acc[3]]


def _geo_block(col: FeatureColumn, fill: List[float],
               track_nulls: bool) -> List[np.ndarray]:
    """[lat/lon/acc block, null indicator?] for one geolocation column
    — shared by the columnar path and the plans' encoder, so parity is
    structural."""
    n = col.n_rows
    block = np.tile(np.asarray(fill), (n, 1))
    isnull = np.ones(n)
    for i, v in enumerate(col.data):
        if v is not None and len(v):
            block[i, :] = [v[0], v[1], v[2] if len(v) > 2 else 0.0]
            isnull[i] = 0.0
    return [block, isnull] if track_nulls else [block]


class GeolocationVectorizerModel(SequenceModel):
    input_types = (Geolocation,)
    output_type = OPVector

    def __init__(self, fill_values: List[List[float]],
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="vecGeo", uid=uid)
        self.fill_values = [[float(x) for x in f] for f in fill_values]
        self.track_nulls = track_nulls

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col, fill in zip(self.input_features, cols,
                                self.fill_values):
            blocks.extend(_geo_block(col, fill, self.track_nulls))
            for p in ("lat", "lon", "acc"):
                metas.append(VectorColumnMetadata(
                    parent_feature_name=f.name,
                    parent_feature_type=f.ftype.__name__,
                    descriptor_value=p))
            if self.track_nulls:
                metas.append(VectorColumnMetadata(
                    parent_feature_name=f.name,
                    parent_feature_type=f.ftype.__name__,
                    indicator_value=NULL_INDICATOR))
        return vector_output(self.get_output().name, blocks, metas)

    # -- device lowering: the (lat, lon, acc) extraction from object
    # triples is a host walk, so the encoder emits the dense block
    # (exactly _geo_block) and the kernel is the concat.
    def encodes_input(self, i: int) -> bool:
        return True

    def encode_input_column(self, i: int, col: FeatureColumn) -> np.ndarray:
        parts = _geo_block(col, self.fill_values[i], self.track_nulls)
        return np.concatenate(
            [p if p.ndim == 2 else p[:, None] for p in parts], axis=1)

    def transform_arrays(self, arrays):
        return torch.cat(arrays, dim=1)


class GeolocationVectorizer(SequenceEstimator):
    """(reference GeolocationVectorizer.scala)"""

    input_types = (Geolocation,)
    output_type = OPVector

    def __init__(self, track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="vecGeo", uid=uid)
        self.track_nulls = track_nulls

    def fit_columns(self, cols: List[FeatureColumn]
                    ) -> GeolocationVectorizerModel:
        fills = []
        for col in cols:
            pts = [v for v in col.data if v is not None and len(v)]
            mid = geolocation_midpoint(pts) if pts else None
            fills.append([float(x) for x in (mid or [0.0, 0.0, 0.0])])
        return GeolocationVectorizerModel(fill_values=fills,
                                          track_nulls=self.track_nulls)
