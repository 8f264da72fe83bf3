"""Categorical one-hot vectorizers: PickList / text pivot / MultiPickList.

Counterpart of ``transmogrifai_tpu/ops/categorical.py``, the reference
one-hot family
(core/src/main/scala/com/salesforce/op/stages/impl/feature/
OpOneHotVectorizer.scala and its OpSetVectorizer / OpTextPivotVectorizer
subclasses). Semantics preserved:

- fit counts category occurrences per input feature, keeps the top-K
  (TransmogrifierDefaults.TopK = 20) with count >= min_support (= 10),
- transform pivots each value into [cat_1 .. cat_K, OTHER, NULL] columns;
  unseen/overflow categories light the OTHER column, empties the NULL one,
- vector metadata records each category as an ``indicator_value`` grouped
  by the parent feature, which is what SanityChecker's Cramér's V and
  group-aware pruning key off.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..features.columns import FeatureColumn
from ..stages.base import SequenceEstimator, SequenceModel
from ..types import OPSet, OPVector, Text
from ..utils.device import working_dtype
from .vector_utils import (NULL_INDICATOR, OTHER_INDICATOR,
                           VectorColumnMetadata, vector_output)

__all__ = ["OneHotVectorizer", "OneHotVectorizerModel",
           "MultiPickListVectorizer", "MultiPickListVectorizerModel"]


def _top_categories(counts: dict, top_k: int, min_support: int) -> List[str]:
    items = [(c, v) for c, v in counts.items() if v >= min_support]
    # count desc, then lexical for determinism (reference sorts by count)
    items.sort(key=lambda cv: (-cv[1], cv[0]))
    return [c for c, _ in items[:top_k]]


def _pivot_block(values_per_row: List[Optional[Sequence[str]]],
                 cats: List[str], track_nulls: bool) -> np.ndarray:
    """values_per_row: None = missing, else iterable of category strings."""
    n = len(values_per_row)
    width = len(cats) + 1 + (1 if track_nulls else 0)
    block = np.zeros((n, width), dtype=np.float64)
    index = {c: i for i, c in enumerate(cats)}
    other_col = len(cats)
    null_col = len(cats) + 1
    for i, vals in enumerate(values_per_row):
        if vals is None or len(vals) == 0:
            if track_nulls:
                block[i, null_col] = 1.0
            continue
        for v in vals:
            j = index.get(v)
            if j is None:
                block[i, other_col] = 1.0
            else:
                block[i, j] = 1.0
    return block


def _pivot_metas(feature, cats: List[str], track_nulls: bool
                 ) -> List[VectorColumnMetadata]:
    metas = [VectorColumnMetadata(
        parent_feature_name=feature.name,
        parent_feature_type=feature.ftype.__name__,
        grouping=feature.name, indicator_value=c) for c in cats]
    metas.append(VectorColumnMetadata(
        parent_feature_name=feature.name,
        parent_feature_type=feature.ftype.__name__,
        grouping=feature.name, indicator_value=OTHER_INDICATOR))
    if track_nulls:
        metas.append(VectorColumnMetadata(
            parent_feature_name=feature.name,
            parent_feature_type=feature.ftype.__name__,
            grouping=feature.name, indicator_value=NULL_INDICATOR))
    return metas


class OneHotVectorizerModel(SequenceModel):
    input_types = (Text,)
    output_type = OPVector

    def __init__(self, categories: List[List[str]], track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="pivotText", uid=uid)
        self.categories = [list(c) for c in categories]
        self.track_nulls = track_nulls

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col, cats in zip(self.input_features, cols, self.categories):
            rows = [None if v is None else (v,) for v in col.data]
            blocks.append(_pivot_block(rows, cats, self.track_nulls))
            metas.extend(_pivot_metas(f, cats, self.track_nulls))
        return vector_output(self.get_output().name, blocks, metas)

    # -- device lowering (plans/prepare.py): the trained category->index
    # lookup runs on host, the one-hot expansion on device. Index layout:
    # [0..K-1] categories, K = OTHER, K+1 = NULL (or -1 = all-zero row
    # when nulls are untracked).
    def encodes_input(self, i: int) -> bool:
        return True

    def encode_input_column(self, i: int, col: FeatureColumn) -> np.ndarray:
        cats = self.categories[i]
        index = {c: j for j, c in enumerate(cats)}
        other = len(cats)
        null = other + 1 if self.track_nulls else -1
        get = index.get
        # one C-allocated pass (np.fromiter) — this encoder is the
        # train-prepare hot loop for wide categorical data
        return np.fromiter(
            (null if v is None else get(v, other) for v in col.data),
            dtype=np.int32, count=col.n_rows)

    def transform_arrays(self, arrays):
        # a comparison with the column indices, not one_hot: index -1 (an
        # untracked null) must give an all-zero row
        blocks = []
        for idx, cats in zip(arrays, self.categories):
            width = len(cats) + 1 + (1 if self.track_nulls else 0)
            cols = torch.arange(width, device=idx.device, dtype=idx.dtype)
            blocks.append((idx[:, None] == cols).to(
                working_dtype(idx.device)))
        return torch.cat(blocks, dim=1)


class OneHotVectorizer(SequenceEstimator):
    """Top-K one-hot pivot for categorical text features
    (reference OpOneHotVectorizer.scala / OpTextPivotVectorizer)."""

    input_types = (Text,)
    output_type = OPVector

    def __init__(self, top_k: int = 20, min_support: int = 10,
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="pivotText", uid=uid)
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls

    def fit_columns(self, cols: List[FeatureColumn]) -> OneHotVectorizerModel:
        categories = []
        for col in cols:
            counts: dict = {}
            for v in col.data:
                if v is not None:
                    counts[v] = counts.get(v, 0) + 1
            categories.append(
                _top_categories(counts, self.top_k, self.min_support))
        return OneHotVectorizerModel(categories=categories,
                                     track_nulls=self.track_nulls)


class MultiPickListVectorizerModel(SequenceModel):
    input_types = (OPSet,)
    output_type = OPVector

    def __init__(self, categories: List[List[str]], track_nulls: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="pivotSet", uid=uid)
        self.categories = [list(c) for c in categories]
        self.track_nulls = track_nulls

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        blocks, metas = [], []
        for f, col, cats in zip(self.input_features, cols, self.categories):
            rows = [None if v is None else tuple(v) for v in col.data]
            blocks.append(_pivot_block(rows, cats, self.track_nulls))
            metas.extend(_pivot_metas(f, cats, self.track_nulls))
        return vector_output(self.get_output().name, blocks, metas)

    # -- device lowering: set membership is inherently a host dict walk,
    # so the encoder emits the multi-hot block directly (EXACTLY
    # _pivot_block, so parity is structural) and the kernel is the
    # concatenation.
    def encodes_input(self, i: int) -> bool:
        return True

    def encode_input_column(self, i: int, col: FeatureColumn) -> np.ndarray:
        rows = [None if v is None else tuple(v) for v in col.data]
        return _pivot_block(rows, self.categories[i], self.track_nulls)

    def transform_arrays(self, arrays):
        return torch.cat(arrays, dim=1)


class MultiPickListVectorizer(SequenceEstimator):
    """Top-K multi-hot pivot for set features
    (reference OpSetVectorizer in OpOneHotVectorizer.scala)."""

    input_types = (OPSet,)
    output_type = OPVector

    def __init__(self, top_k: int = 20, min_support: int = 10,
                 track_nulls: bool = True, uid: Optional[str] = None):
        super().__init__(operation_name="pivotSet", uid=uid)
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls

    def fit_columns(self, cols: List[FeatureColumn]
                    ) -> MultiPickListVectorizerModel:
        categories = []
        for col in cols:
            counts: dict = {}
            for vals in col.data:
                if vals:
                    for v in vals:
                        counts[v] = counts.get(v, 0) + 1
            categories.append(
                _top_categories(counts, self.top_k, self.min_support))
        return MultiPickListVectorizerModel(categories=categories,
                                            track_nulls=self.track_nulls)
