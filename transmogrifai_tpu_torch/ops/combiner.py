"""VectorsCombiner: concatenate OPVector features into one.

Counterpart of ``transmogrifai_tpu/ops/combiner.py`` (reference
core/src/main/scala/com/salesforce/op/stages/impl/feature/
VectorsCombiner.scala:51,85): concatenates vector columns and flattens
their metadata. On the device it is one ``torch.cat``, which gives the
prepared matrix of the selector search its home there.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..features.columns import FeatureColumn
from ..stages.base import SequenceTransformer
from ..types import OPVector
from ..utils.vector_meta import VectorColumnMetadata, VectorMetadata

__all__ = ["VectorsCombiner"]


class VectorsCombiner(SequenceTransformer):
    input_types = (OPVector,)
    output_type = OPVector

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="combineVector", uid=uid)

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        mats, metas = [], []
        out_name = self.get_output().name
        for f, col in zip(self.input_features, cols):
            if col.kind != "vector":
                raise TypeError(
                    f"VectorsCombiner input {f.name!r} is not a vector")
            mats.append(col.data)
            meta = col.metadata
            if meta is None or meta.size != col.data.shape[1]:
                # raw vectors (no vectorizer provenance) get anonymous
                # per-column records so flatten stays index-consistent
                meta = VectorMetadata(name=f.name, columns=tuple(
                    VectorColumnMetadata(parent_feature_name=f.name,
                                         parent_feature_type="OPVector",
                                         index=i)
                    for i in range(col.data.shape[1])))
            metas.append(meta)
        mat = (np.concatenate(mats, axis=1) if mats
               else np.zeros((0, 0), dtype=np.float64))
        return FeatureColumn.vector(
            mat, VectorMetadata.flatten(out_name, metas))

    def transform_arrays(self, arrays):
        return torch.cat(arrays, dim=1)
