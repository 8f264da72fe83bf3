"""Map vectorizers: typed ``str -> value`` maps -> OPVector.

Counterpart of ``transmogrifai_tpu/ops/maps.py``, the reference map
vectorizer family
(core/src/main/scala/com/salesforce/op/stages/impl/feature/
{OPMapVectorizer.scala, TextMapPivotVectorizer.scala,
MultiPickListMapVectorizer.scala, GeolocationMapVectorizer.scala,
SmartTextMapVectorizer.scala}): fit learns the key universe per input
map feature (the reference's ``allowedKeys``/whitelist pass), then each
(feature, key) pair becomes a fixed slot of the output vector with the
same impute/track-null semantics as the scalar vectorizers, and
``grouping`` metadata set to the key so SanityChecker prunes per-key
groups.

Device lowering, as in the JAX package: the per-key dict walks run on the
host (a NaN-missing value matrix, an int32 level index matrix, or a dense
multi-hot / geolocation block); the fill and (value, null) interleave,
the per-key one-hot expansion, the unit-circle projection and the
concatenations run as torch ops on the workflow's device.
SmartTextMapVectorizer (host hashing), FilterMap and the text-map length
and null estimators stay on the host.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..features.columns import FeatureColumn
from ..stages.base import (SequenceEstimator, SequenceModel,
                           UnaryTransformer)
from ..types import (BinaryMap, DateMap, GeolocationMap, MultiPickListMap,
                     OPMap, OPVector, TextMap)
from ..utils.device import working_dtype
from .categorical import _pivot_block, _top_categories
from .date import (TIME_PERIODS, _unit_circle_kernel, date_phases,
                   unit_circle_block)
from .geo import geolocation_midpoint
from .text import _hash_block, tokenize
from .vector_utils import (NULL_INDICATOR, OTHER_INDICATOR,
                           VectorColumnMetadata, vector_output)

__all__ = ["RealMapVectorizer", "RealMapVectorizerModel",
           "BinaryMapVectorizer", "TextMapPivotVectorizer",
           "TextMapPivotVectorizerModel", "MultiPickListMapVectorizer",
           "GeolocationMapVectorizer", "GeolocationMapVectorizerModel",
           "SmartTextMapVectorizer", "SmartTextMapVectorizerModel",
           "DateMapToUnitCircleVectorizer",
           "DateMapToUnitCircleVectorizerModel", "FilterMap",
           "TextMapLenEstimator", "TextMapNullEstimator"]


def _sorted_keys(cols: List[FeatureColumn],
                 allow_keys: Optional[Sequence[str]] = None
                 ) -> List[List[str]]:
    out = []
    for col in cols:
        keys = set()
        for m in col.data:
            if m:
                keys.update(m.keys())
        if allow_keys is not None:
            keys &= set(allow_keys)
        out.append(sorted(keys))
    return out


def _map_values_matrix(col: FeatureColumn, keys: Sequence[str]
                       ) -> np.ndarray:
    """(n, len(keys)) float matrix of map values, NaN = key absent.
    Walks each row's ENTRIES rather than the key union — real maps are
    sparse (a few entries against a wide fitted key set), so this is
    O(rows x entries), the encoder's train-prepare hot-loop bound."""
    out = np.full((col.n_rows, len(keys)), np.nan)
    pos = {k: j for j, k in enumerate(keys)}
    get = pos.get
    for r, m in enumerate(col.data):
        if m:
            for k, v in m.items():
                j = get(k)
                if j is not None and v is not None:
                    out[r, j] = float(v)
    return out


def _key_pivot_block(col: FeatureColumn, key: str, levels: List[str],
                     track_nulls: bool, multi: bool) -> np.ndarray:
    """One key's [levels..., OTHER, NULL?] block: the key's value (a set
    of values when ``multi``) pivoted by its string form; an absent key
    (or an empty set) is a null."""
    rows = []
    for m in col.data:
        v = m.get(key) if m else None
        if multi:
            rows.append(tuple(str(x) for x in v) if v else None)
        else:
            rows.append(None if v is None else (str(v),))
    return _pivot_block(rows, levels, track_nulls)


def _key_pivot_metas(feature, key: str, levels: List[str],
                     track_nulls: bool) -> List[VectorColumnMetadata]:
    """Metadata of ``_key_pivot_block``'s columns, grouped by the key."""
    values = list(levels) + [OTHER_INDICATOR] + (
        [NULL_INDICATOR] if track_nulls else [])
    return [VectorColumnMetadata(
        parent_feature_name=feature.name,
        parent_feature_type=feature.ftype.__name__,
        grouping=key, indicator_value=v) for v in values]


class RealMapVectorizerModel(SequenceModel):
    input_types = (OPMap,)  # NumericMap | IntegralMap | DateMap
    output_type = OPVector

    def __init__(self, keys: List[List[str]],
                 fill_values: List[List[float]], track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="vecRealMap", uid=uid)
        self.keys = [list(k) for k in keys]
        self.fill_values = [[float(v) for v in f] for f in fill_values]
        self.track_nulls = track_nulls
        self._fills_by_device: Dict[tuple, List[torch.Tensor]] = {}

    def _fills_on(self, device: torch.device,
                  dtype: torch.dtype) -> List[torch.Tensor]:
        """The per-key fill values as tensors on ``device``, made once: a
        graph capture replays the fill without a copy up."""
        key = (device, dtype)
        if key not in self._fills_by_device:
            self._fills_by_device[key] = [
                torch.tensor(f, dtype=dtype, device=device)
                for f in self.fill_values]
        return self._fills_by_device[key]

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col, keys, fills in zip(self.input_features, cols,
                                       self.keys, self.fill_values):
            mat = _map_values_matrix(col, keys)
            for j, (k, fill) in enumerate(zip(keys, fills)):
                isnan = np.isnan(mat[:, j])
                blocks.append(np.where(isnan, fill, mat[:, j]))
                metas.append(VectorColumnMetadata(
                    parent_feature_name=f.name,
                    parent_feature_type=f.ftype.__name__, grouping=k))
                if self.track_nulls:
                    blocks.append(isnan.astype(np.float64))
                    metas.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.ftype.__name__, grouping=k,
                        indicator_value=NULL_INDICATOR))
        return vector_output(self.get_output().name, blocks, metas,
                             n_rows=cols[0].n_rows if cols else 0)

    # -- device lowering: the per-key dict walk runs on the host
    # (one (n, n_keys) NaN-missing matrix per input); impute + null
    # tracking run on the device.
    def encodes_input(self, i: int) -> bool:
        return True

    def encode_input_column(self, i: int, col: FeatureColumn) -> np.ndarray:
        return _map_values_matrix(col, self.keys[i])

    def transform_arrays(self, arrays):
        outs = []
        for mat, fills in zip(arrays, self._fills_on(arrays[0].device,
                                                     arrays[0].dtype)):
            isnan = torch.isnan(mat)
            filled = torch.where(isnan, fills, mat)
            # interleave (value, null) per key — the numpy column order
            outs.append(torch.stack([filled, isnan.to(mat.dtype)],
                                    dim=2).flatten(1)
                        if self.track_nulls else filled)
        return torch.cat(outs, dim=1)


class RealMapVectorizer(SequenceEstimator):
    """Numeric maps -> per-key columns, mean-imputed
    (reference OPMapVectorizer.scala RealMapVectorizer)."""

    input_types = (OPMap,)  # NumericMap | IntegralMap | DateMap
    output_type = OPVector

    def __init__(self, fill_with_mean: bool = True, fill_value: float = 0.0,
                 track_nulls: bool = True,
                 allow_keys: Optional[Sequence[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="vecRealMap", uid=uid)
        self.fill_with_mean = fill_with_mean
        self.fill_value = fill_value
        self.track_nulls = track_nulls
        self.allow_keys = list(allow_keys) if allow_keys else None

    def fit_columns(self, cols: List[FeatureColumn]
                    ) -> RealMapVectorizerModel:
        keys = _sorted_keys(cols, self.allow_keys)
        fills = []
        for col, ks in zip(cols, keys):
            per_key = []
            for k in ks:
                vals = [float(m[k]) for m in col.data
                        if m and k in m and m[k] is not None]
                if self.fill_with_mean and vals:
                    per_key.append(float(np.mean(vals)))
                else:
                    per_key.append(float(self.fill_value))
            fills.append(per_key)
        return RealMapVectorizerModel(keys=keys, fill_values=fills,
                                      track_nulls=self.track_nulls)


class BinaryMapVectorizer(RealMapVectorizer):
    """Boolean maps -> per-key 0/1 columns, false-filled
    (reference BinaryMapVectorizer in OPMapVectorizer.scala)."""

    input_types = (BinaryMap,)

    def __init__(self, track_nulls: bool = True,
                 allow_keys: Optional[Sequence[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(fill_with_mean=False, fill_value=0.0,
                         track_nulls=track_nulls, allow_keys=allow_keys,
                         uid=uid)
        self.operation_name = "vecBinaryMap"


class TextMapPivotVectorizerModel(SequenceModel):
    input_types = (TextMap,)
    output_type = OPVector
    #: whether each key holds a set of values (MultiPickListMap)
    multi = False

    def __init__(self, keys: List[List[str]],
                 categories: List[Dict[str, List[str]]],
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="pivotTextMap", uid=uid)
        self.keys = [list(k) for k in keys]
        self.categories = [dict(c) for c in categories]
        self.track_nulls = track_nulls

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col, keys, cats in zip(self.input_features, cols,
                                      self.keys, self.categories):
            for k in keys:
                levels = cats.get(k, [])
                blocks.append(_key_pivot_block(col, k, levels,
                                               self.track_nulls, self.multi))
                metas.extend(_key_pivot_metas(f, k, levels,
                                              self.track_nulls))
        return vector_output(self.get_output().name, blocks, metas,
                             n_rows=cols[0].n_rows if cols else 0)

    # -- device lowering: per-key level->index lookup on the host
    # ((n, n_keys) int32), per-key one-hot expansion on device. Index
    # layout per key: [0..L-1] levels, L = OTHER, L+1 = NULL.
    def encodes_input(self, i: int) -> bool:
        return True

    def encode_input_column(self, i: int, col: FeatureColumn) -> np.ndarray:
        keys, cats = self.keys[i], self.categories[i]
        kpos = {k: j for j, k in enumerate(keys)}
        indexes = [{c: q for q, c in enumerate(cats.get(k, []))}
                   for k in keys]
        others = [len(cats.get(k, [])) for k in keys]
        # every slot starts at its key's NULL index; one sparse pass
        # over each row's ENTRIES fills the present keys (see
        # _map_values_matrix for the hot-loop rationale)
        null_row = np.asarray(
            [o + 1 if self.track_nulls else -1 for o in others],
            dtype=np.int32)
        out = np.tile(null_row, (col.n_rows, 1))
        kget = kpos.get
        for r, m in enumerate(col.data):
            if m:
                for k, v in m.items():
                    j = kget(k)
                    if j is not None and v is not None:
                        out[r, j] = indexes[j].get(str(v), others[j])
        return out

    def transform_arrays(self, arrays):
        # a comparison with the column indices, as OneHotVectorizerModel's:
        # index -1 (an untracked null) gives an all-zero block
        dtype = working_dtype(arrays[0].device)
        blocks = []
        for idx, keys, cats in zip(arrays, self.keys, self.categories):
            for j, k in enumerate(keys):
                width = len(cats.get(k, [])) + 1 \
                    + (1 if self.track_nulls else 0)
                cols = torch.arange(width, device=idx.device,
                                    dtype=idx.dtype)
                blocks.append((idx[:, j, None] == cols).to(dtype))
        if not blocks:
            return torch.zeros((arrays[0].shape[0], 0), dtype=dtype,
                               device=arrays[0].device)
        return torch.cat(blocks, dim=1)


class TextMapPivotVectorizer(SequenceEstimator):
    """Text maps -> per-key top-K one-hot pivot
    (reference TextMapPivotVectorizer.scala)."""

    input_types = (TextMap,)
    output_type = OPVector

    def __init__(self, top_k: int = 20, min_support: int = 10,
                 track_nulls: bool = True,
                 allow_keys: Optional[Sequence[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="pivotTextMap", uid=uid)
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls
        self.allow_keys = list(allow_keys) if allow_keys else None

    def fit_columns(self, cols: List[FeatureColumn]
                    ) -> TextMapPivotVectorizerModel:
        keys = _sorted_keys(cols, self.allow_keys)
        categories = []
        for col, ks in zip(cols, keys):
            per_key: Dict[str, List[str]] = {}
            for k in ks:
                counts: Dict[str, int] = {}
                for m in col.data:
                    v = m.get(k) if m else None
                    if v is not None:
                        counts[str(v)] = counts.get(str(v), 0) + 1
                per_key[k] = _top_categories(counts, self.top_k,
                                             self.min_support)
            categories.append(per_key)
        return TextMapPivotVectorizerModel(
            keys=keys, categories=categories, track_nulls=self.track_nulls)


class MultiPickListMapVectorizer(TextMapPivotVectorizer):
    """Set-valued maps -> per-key multi-hot pivot
    (reference MultiPickListMapVectorizer.scala)."""

    input_types = (MultiPickListMap,)

    def fit_columns(self, cols: List[FeatureColumn]
                    ) -> TextMapPivotVectorizerModel:
        keys = _sorted_keys(cols, self.allow_keys)
        categories = []
        for col, ks in zip(cols, keys):
            per_key: Dict[str, List[str]] = {}
            for k in ks:
                counts: Dict[str, int] = {}
                for m in col.data:
                    vals = m.get(k) if m else None
                    if vals:
                        for v in vals:
                            counts[str(v)] = counts.get(str(v), 0) + 1
                per_key[k] = _top_categories(counts, self.top_k,
                                             self.min_support)
            categories.append(per_key)
        return _MultiPickListMapModel(
            keys=keys, categories=categories, track_nulls=self.track_nulls)


class _MultiPickListMapModel(TextMapPivotVectorizerModel):
    input_types = (MultiPickListMap,)
    multi = True

    # -- device lowering: like MultiPickListVectorizer, the per-key
    # multi-hot is a host dict walk, so the encoder emits the per-key
    # blocks of transform_columns and the device kernel is the concat.
    def encode_input_column(self, i: int, col: FeatureColumn) -> np.ndarray:
        keys, cats = self.keys[i], self.categories[i]
        blocks = [_key_pivot_block(col, k, cats.get(k, []),
                                   self.track_nulls, True) for k in keys]
        return (np.concatenate(blocks, axis=1) if blocks
                else np.zeros((col.n_rows, 0)))

    def transform_arrays(self, arrays):
        return torch.cat(arrays, dim=1)


def _geo_map_block(col: FeatureColumn, key: str, fill: List[float],
                   track_nulls: bool) -> np.ndarray:
    """One key's (lat, lon, acc[, null]) columns, an absent key filled
    with ``fill``."""
    n = col.n_rows
    block = np.tile(np.asarray(fill, dtype=np.float64), (n, 1))
    isnull = np.ones(n)
    for i, m in enumerate(col.data):
        v = m.get(key) if m else None
        if v:
            block[i, :] = [v[0], v[1], v[2] if len(v) > 2 else 0.0]
            isnull[i] = 0.0
    return np.concatenate([block, isnull[:, None]], axis=1) \
        if track_nulls else block


class GeolocationMapVectorizerModel(SequenceModel):
    input_types = (GeolocationMap,)
    output_type = OPVector

    def __init__(self, keys: List[List[str]],
                 fill_values: List[Dict[str, List[float]]],
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="vecGeoMap", uid=uid)
        self.keys = [list(k) for k in keys]
        self.fill_values = [dict(f) for f in fill_values]
        self.track_nulls = track_nulls

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col, keys, fills in zip(self.input_features, cols,
                                       self.keys, self.fill_values):
            for k in keys:
                blocks.append(_geo_map_block(
                    col, k, fills.get(k, [0.0, 0.0, 0.0]),
                    self.track_nulls))
                for p in ("lat", "lon", "acc"):
                    metas.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.ftype.__name__,
                        grouping=k, descriptor_value=p))
                if self.track_nulls:
                    metas.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.ftype.__name__,
                        grouping=k, indicator_value=NULL_INDICATOR))
        return vector_output(self.get_output().name, blocks, metas,
                             n_rows=cols[0].n_rows if cols else 0)

    # -- device lowering: per-key triple extraction is a host dict walk,
    # so the encoder emits the dense per-key blocks of transform_columns
    # and the kernel is the concat.
    def encodes_input(self, i: int) -> bool:
        return True

    def encode_input_column(self, i: int, col: FeatureColumn) -> np.ndarray:
        keys, fills = self.keys[i], self.fill_values[i]
        blocks = [_geo_map_block(col, k, fills.get(k, [0.0, 0.0, 0.0]),
                                 self.track_nulls) for k in keys]
        return (np.concatenate(blocks, axis=1) if blocks
                else np.zeros((col.n_rows, 0)))

    def transform_arrays(self, arrays):
        return torch.cat(arrays, dim=1)


class GeolocationMapVectorizer(SequenceEstimator):
    """Geolocation maps -> per-key (lat, lon, acc), midpoint-imputed
    (reference GeolocationMapVectorizer.scala)."""

    input_types = (GeolocationMap,)
    output_type = OPVector

    def __init__(self, track_nulls: bool = True,
                 allow_keys: Optional[Sequence[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="vecGeoMap", uid=uid)
        self.track_nulls = track_nulls
        self.allow_keys = list(allow_keys) if allow_keys else None

    def fit_columns(self, cols: List[FeatureColumn]
                    ) -> GeolocationMapVectorizerModel:
        keys = _sorted_keys(cols, self.allow_keys)
        fills = []
        for col, ks in zip(cols, keys):
            per_key: Dict[str, List[float]] = {}
            for k in ks:
                pts = [m[k] for m in col.data
                       if m and k in m and m[k] is not None and len(m[k])]
                mid = geolocation_midpoint(pts) if pts else None
                per_key[k] = [float(x) for x in (mid or [0.0, 0.0, 0.0])]
            fills.append(per_key)
        return GeolocationMapVectorizerModel(
            keys=keys, fill_values=fills, track_nulls=self.track_nulls)


class SmartTextMapVectorizerModel(SequenceModel):
    input_types = (TextMap,)
    output_type = OPVector

    def __init__(self, keys: List[List[str]],
                 strategies: List[Dict[str, tuple]],
                 num_hashes: int = 512, track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="smartTxtMapVec", uid=uid)
        self.keys = [list(k) for k in keys]
        #: per feature: {key: ("pivot", [categories]) | ("hash", None)}
        self.strategies = [{k: tuple(v) for k, v in s.items()}
                           for s in strategies]
        self.num_hashes = num_hashes
        self.track_nulls = track_nulls

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col, keys, strat in zip(self.input_features, cols,
                                       self.keys, self.strategies):
            for k in keys:
                kind, cats = strat.get(k, ("hash", None))
                if kind == "pivot":
                    levels = list(cats or [])
                    blocks.append(_key_pivot_block(
                        col, k, levels, self.track_nulls, False))
                    metas.extend(_key_pivot_metas(f, k, levels,
                                                  self.track_nulls))
                    continue
                vals = [(m.get(k) if m else None) for m in col.data]
                blocks.append(_hash_block(vals, self.num_hashes,
                                          self.track_nulls))
                metas.extend(VectorColumnMetadata(
                    parent_feature_name=f.name,
                    parent_feature_type=f.ftype.__name__,
                    grouping=k, descriptor_value=f"hash_{j}")
                    for j in range(self.num_hashes))
                if self.track_nulls:
                    metas.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.ftype.__name__,
                        grouping=k, indicator_value=NULL_INDICATOR))
        return vector_output(self.get_output().name, blocks, metas,
                             n_rows=cols[0].n_rows if cols else 0)


class SmartTextMapVectorizer(SequenceEstimator):
    """Per-KEY pivot-or-hash decision for text maps (reference
    SmartTextMapVectorizer.scala): a key whose value cardinality stays
    within ``max_cardinality`` pivots into top-K one-hot columns, a
    free-text key falls back to the hashing trick — the map analogue of
    SmartTextVectorizer's per-feature decision."""

    input_types = (TextMap,)
    output_type = OPVector

    def __init__(self, max_cardinality: int = 30, top_k: int = 20,
                 min_support: int = 10, num_hashes: int = 512,
                 track_nulls: bool = True,
                 allow_keys: Optional[Sequence[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="smartTxtMapVec", uid=uid)
        self.max_cardinality = max_cardinality
        self.top_k = top_k
        self.min_support = min_support
        self.num_hashes = num_hashes
        self.track_nulls = track_nulls
        self.allow_keys = list(allow_keys) if allow_keys else None

    def fit_columns(self, cols: List[FeatureColumn]
                    ) -> SmartTextMapVectorizerModel:
        keys = _sorted_keys(cols, self.allow_keys)
        strategies = []
        for col, ks in zip(cols, keys):
            per_key: Dict[str, tuple] = {}
            for k in ks:
                counts: Dict[str, int] = {}
                for m in col.data:
                    v = m.get(k) if m else None
                    if v is not None:
                        counts[str(v)] = counts.get(str(v), 0) + 1
                if len(counts) <= self.max_cardinality:
                    per_key[k] = ("pivot", _top_categories(
                        counts, self.top_k, self.min_support))
                else:
                    per_key[k] = ("hash", None)
            strategies.append(per_key)
        return SmartTextMapVectorizerModel(
            keys=keys, strategies=strategies, num_hashes=self.num_hashes,
            track_nulls=self.track_nulls)


class DateMapToUnitCircleVectorizerModel(SequenceModel):
    input_types = (DateMap,)
    output_type = OPVector

    def __init__(self, keys: List[List[str]],
                 time_period: str = "HourOfDay",
                 uid: Optional[str] = None):
        super().__init__(operation_name="dateMapToUnitCircle", uid=uid)
        self.keys = [list(k) for k in keys]
        self.time_period = time_period

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col, keys in zip(self.input_features, cols, self.keys):
            # (sin, cos) interleaved per key, in key order
            blocks.append(unit_circle_block(date_phases(
                _map_values_matrix(col, keys), self.time_period)))
            for k in keys:
                for trig in ("sin", "cos"):
                    metas.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.ftype.__name__, grouping=k,
                        descriptor_value=f"{trig}_{self.time_period}"))
        return vector_output(self.get_output().name, blocks, metas,
                             n_rows=cols[0].n_rows if cols else 0)

    # -- device lowering: the host encodes (n, n_keys) phases
    # (int64 epoch math stays on host), device projects sin/cos per key
    def encodes_input(self, i: int) -> bool:
        return True

    def encode_input_column(self, i: int, col: FeatureColumn) -> np.ndarray:
        return date_phases(_map_values_matrix(col, self.keys[i]),
                           self.time_period)

    def transform_arrays(self, arrays):
        return _unit_circle_kernel(arrays)


class DateMapToUnitCircleVectorizer(SequenceEstimator):
    """Date maps -> per-key [sin, cos] of the chosen time period
    (reference DateMapToUnitCircleVectorizer.scala); missing -> (0, 0),
    the circle's center — equidistant from every phase."""

    input_types = (DateMap,)
    output_type = OPVector

    def __init__(self, time_period: str = "HourOfDay",
                 allow_keys: Optional[Sequence[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="dateMapToUnitCircle", uid=uid)
        if time_period not in TIME_PERIODS:
            raise ValueError(
                f"Unknown time period {time_period!r}; "
                f"choose from {sorted(TIME_PERIODS)}")
        self.time_period = time_period
        self.allow_keys = list(allow_keys) if allow_keys else None

    def fit_columns(self, cols: List[FeatureColumn]
                    ) -> DateMapToUnitCircleVectorizerModel:
        return DateMapToUnitCircleVectorizerModel(
            keys=_sorted_keys(cols, self.allow_keys),
            time_period=self.time_period)


class FilterMap(UnaryTransformer):
    """Key whitelist/blacklist filtering of any map feature
    (reference FilterMap.scala:45 with MapPivotParams white/blacklist)."""

    input_types = (OPMap,)
    output_type = OPMap

    def __init__(self, allow_keys: Optional[Sequence[str]] = None,
                 block_keys: Optional[Sequence[str]] = None,
                 clean_keys: bool = False, uid: Optional[str] = None):
        super().__init__(operation_name="filterMap", uid=uid)
        self.allow_keys = list(allow_keys) if allow_keys else None
        self.block_keys = list(block_keys) if block_keys else None
        self.clean_keys = clean_keys

    def set_input(self, *features):
        # output type mirrors the concrete input map type
        out = super().set_input(*features)
        self.output_type = features[0].ftype
        return out

    def _clean(self, k: str) -> str:
        return "".join(ch for ch in str(k) if ch.isalnum()) \
            if self.clean_keys else str(k)

    def transform_value(self, value):
        m = value.value if hasattr(value, "value") else value
        allow = {self._clean(k) for k in self.allow_keys} \
            if self.allow_keys else None
        block = {self._clean(k) for k in self.block_keys} \
            if self.block_keys else set()
        out = {}
        for k, v in (m or {}).items():
            ck = self._clean(k)
            if (allow is None or ck in allow) and ck not in block:
                out[ck] = v
        return self.output_type(out)

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        return FeatureColumn.from_values(
            self.output_type,
            [self.transform_value(v) for v in cols[0].data])


class TextMapLenEstimator(SequenceEstimator):
    """Text maps -> per-key total token length columns
    (reference TextMapLenEstimator.scala:44)."""

    input_types = (TextMap,)
    output_type = OPVector

    def __init__(self, allow_keys: Optional[Sequence[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="textLenMap", uid=uid)
        self.allow_keys = list(allow_keys) if allow_keys else None

    def fit_columns(self, cols: List[FeatureColumn]) -> "_TextMapLenModel":
        return _TextMapLenModel(keys=_sorted_keys(cols, self.allow_keys))


class _TextMapLenModel(SequenceModel):
    input_types = (TextMap,)
    output_type = OPVector

    def __init__(self, keys: List[List[str]], uid: Optional[str] = None):
        super().__init__(operation_name="textLenMap", uid=uid)
        self.keys = [list(k) for k in keys]

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col, keys in zip(self.input_features, cols, self.keys):
            n = col.n_rows
            for k in keys:
                vals = np.zeros(n)
                for i, m in enumerate(col.data):
                    v = m.get(k) if m else None
                    if v is not None:
                        vals[i] = float(sum(len(t) for t in tokenize(v)))
                blocks.append(vals)
                metas.append(VectorColumnMetadata(
                    parent_feature_name=f.name,
                    parent_feature_type=f.ftype.__name__, grouping=k,
                    descriptor_value="textLen"))
        return vector_output(self.get_output().name, blocks, metas,
                             n_rows=cols[0].n_rows if cols else 0)


class TextMapNullEstimator(SequenceEstimator):
    """Text maps -> per-key null-indicator columns
    (reference TextMapNullEstimator in TextMapLenEstimator.scala)."""

    input_types = (TextMap,)
    output_type = OPVector

    def __init__(self, allow_keys: Optional[Sequence[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="textNullMap", uid=uid)
        self.allow_keys = list(allow_keys) if allow_keys else None

    def fit_columns(self, cols: List[FeatureColumn]) -> "_TextMapNullModel":
        return _TextMapNullModel(keys=_sorted_keys(cols, self.allow_keys))


class _TextMapNullModel(SequenceModel):
    input_types = (TextMap,)
    output_type = OPVector

    def __init__(self, keys: List[List[str]], uid: Optional[str] = None):
        super().__init__(operation_name="textNullMap", uid=uid)
        self.keys = [list(k) for k in keys]

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col, keys in zip(self.input_features, cols, self.keys):
            n = col.n_rows
            for k in keys:
                isnull = np.array(
                    [0.0 if (m and m.get(k) is not None) else 1.0
                     for m in col.data])
                blocks.append(isnull)
                metas.append(VectorColumnMetadata(
                    parent_feature_name=f.name,
                    parent_feature_type=f.ftype.__name__, grouping=k,
                    indicator_value=NULL_INDICATOR))
        return vector_output(self.get_output().name, blocks, metas,
                             n_rows=cols[0].n_rows if cols else 0)
