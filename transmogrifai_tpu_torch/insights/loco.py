"""RecordInsightsLOCO: per-row leave-one-feature-out attributions.

The port's own copy of ``transmogrifai_tpu/insights/loco.py`` (reference
RecordInsightsLOCO, core/src/main/scala/com/salesforce/op/stages/impl/
insights/RecordInsightsLOCO.scala:54,68): for every row, zero out each
column group of the feature vector (groups = columns sharing a parent raw
feature, from the vector metadata), re-run the model, and report the
top-K score deltas.

The feature matrix goes to the model's device once; each group's
counterfactual is a batch prediction there, on one working copy whose
group columns are zeroed and then restored. The per-group scores come
back to the host, where the diffs are ranked with the JAX package's own
``np.argsort`` (not stable), so on the CPU the TextMaps equal its
string for string.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..features.columns import FeatureColumn
from ..models.base import PredictionModel
from ..stages.base import UnaryTransformer
from ..types import OPVector, TextMap
from ..utils.device import working_dtype
from ..utils.vector_meta import VectorMetadata

__all__ = ["RecordInsightsLOCO"]


class RecordInsightsLOCO(UnaryTransformer):
    """(reference RecordInsightsLOCO.scala:54)"""

    input_types = (OPVector,)
    output_type = TextMap
    device_inputs = True

    def __init__(self, model: Optional[PredictionModel] = None,
                 top_k: int = 20, uid: Optional[str] = None):
        super().__init__(operation_name="recordInsightsLOCO", uid=uid)
        self.model = model
        self.top_k = top_k

    def _score(self, X: torch.Tensor,
               base_cls: Optional[np.ndarray] = None) -> np.ndarray:
        """Scalar score per row: probability of class 1 for binary
        classifiers, predicted value otherwise (reference diffs the
        prediction vector). ``base_cls`` fixes the class index scored for
        multiclass so counterfactuals are compared at the BASE
        prediction's class, not their own argmax."""
        out = self.model.predict_arrays(X)
        if out.probability.shape[1] == 2:
            return out.probability[:, 1]
        if out.probability.shape[1] > 2:
            cls = (out.data if base_cls is None else base_cls).astype(int)
            return out.probability[np.arange(len(out.data)), cls]
        return out.data

    def _groups(self, meta: Optional[VectorMetadata], d: int
                ) -> List[Tuple[str, List[int]]]:
        if meta is not None and meta.size == d:
            return list(meta.parent_groups().items())
        return [(f"column_{j}", [j]) for j in range(d)]

    def _working_copy(self, data) -> torch.Tensor:
        """The feature matrix as a fresh tensor on the model's device in
        its working dtype."""
        device = self.model.device
        return torch.as_tensor(data, device=device,
                               dtype=working_dtype(device)).clone()

    def group_diffs(self, vec: FeatureColumn
                    ) -> Tuple[List[Tuple[str, List[int]]], np.ndarray]:
        """The column groups of the feature vector ``vec`` and, per row,
        the base score less the score with each group zeroed ((n, groups)
        float64), the predictions made on the model's device."""
        if self.model is None:
            raise ValueError("RecordInsightsLOCO requires a fitted model")
        Xz = self._working_copy(vec.data)
        n, d = Xz.shape
        meta = vec.metadata or getattr(self.model, "vector_metadata", None)
        base_out = self.model.predict_arrays(Xz)
        base_cls = base_out.data if base_out.probability.shape[1] > 2 \
            else None
        base = self._score(Xz, base_cls)
        groups = self._groups(meta, d)
        diffs = np.zeros((n, len(groups)))
        for g, (_, idxs) in enumerate(groups):
            cols_g = torch.as_tensor(idxs, device=Xz.device)
            saved = Xz[:, cols_g].clone()
            Xz[:, cols_g] = 0.0
            diffs[:, g] = base - self._score(Xz, base_cls)
            Xz[:, cols_g] = saved
        return groups, diffs

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        groups, diffs = self.group_diffs(cols[0])
        k = min(self.top_k, len(groups))
        # top-K by |diff| per row, ranked on the host as the JAX package
        # ranks them
        order = np.argsort(-np.abs(diffs), axis=1)[:, :k]
        values = []
        for i in range(diffs.shape[0]):
            row: Dict[str, str] = {}
            for g in order[i]:
                row[groups[g][0]] = json.dumps(round(float(diffs[i, g]), 9))
            values.append(TextMap(row))
        return FeatureColumn.from_values(TextMap, values)
