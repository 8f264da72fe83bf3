"""String indexing and de-indexing.

The port's copy of ``transmogrifai_tpu/ops/index.py``, the reference's
index family (core/src/main/scala/com/salesforce/op/stages/impl/feature/
{OpStringIndexer.scala, OpStringIndexerNoFilter.scala,
OpIndexToString.scala, OpIndexToStringNoFilter.scala} and
core/.../preparators/PredictionDeIndexer.scala): labels index by training
frequency (ties lexical); an unseen value maps to the trailing "unseen"
index (NoFilter semantics) or raises (error semantics). Host passes, as in
the JAX package.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..features.columns import FeatureColumn, PredictionColumn
from ..stages.base import (AllowLabelAsInput, BinaryTransformer, UnaryEstimator,
                           UnaryModel, UnaryTransformer)
from ..types import Prediction, RealNN, Text

__all__ = ["StringIndexer", "StringIndexerModel", "IndexToString",
           "PredictionDeIndexer"]

UNSEEN_NAME = "UnseenLabel"


class StringIndexerModel(UnaryModel):
    input_types = (Text,)
    output_type = RealNN

    def __init__(self, labels: Sequence[str], handle_invalid: str = "keep",
                 uid: Optional[str] = None):
        super().__init__(operation_name="strIdx", uid=uid)
        self.labels = [str(l) for l in labels]
        self.handle_invalid = handle_invalid
        self._index = {l: i for i, l in enumerate(self.labels)}

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        out = np.zeros(cols[0].n_rows, dtype=np.float64)
        unseen = float(len(self.labels))
        for i, v in enumerate(cols[0].data):
            j = self._index.get(v if v is not None else None)
            if j is None:
                if self.handle_invalid == "error":
                    raise ValueError(f"Unseen label {v!r} at row {i}")
                out[i] = unseen
            else:
                out[i] = float(j)
        return FeatureColumn(ftype=RealNN, data=out)


class StringIndexer(UnaryEstimator):
    """(reference OpStringIndexer / NoFilter variant; handle_invalid in
    {"keep", "error"} — "keep" is the NoFilter behavior)"""

    input_types = (Text,)
    output_type = RealNN

    def __init__(self, handle_invalid: str = "keep",
                 uid: Optional[str] = None):
        super().__init__(operation_name="strIdx", uid=uid)
        if handle_invalid not in ("keep", "error"):
            raise ValueError("handle_invalid must be 'keep' or 'error'")
        self.handle_invalid = handle_invalid

    def fit_columns(self, cols: List[FeatureColumn]) -> StringIndexerModel:
        counts: dict = {}
        for v in cols[0].data:
            if v is not None:
                counts[v] = counts.get(v, 0) + 1
        labels = sorted(counts, key=lambda k: (-counts[k], k))
        return StringIndexerModel(labels=labels,
                                  handle_invalid=self.handle_invalid)


class IndexToString(UnaryTransformer):
    """(reference OpIndexToString / NoFilter variant)"""

    input_types = (RealNN,)
    output_type = Text

    def __init__(self, labels: Sequence[str], unseen_name: str = UNSEEN_NAME,
                 uid: Optional[str] = None):
        super().__init__(operation_name="idx2str", uid=uid)
        self.labels = [str(l) for l in labels]
        self.unseen_name = unseen_name

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        vals = np.asarray(cols[0].data, dtype=np.float64)
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            j = int(v) if np.isfinite(v) else -1
            out[i] = self.labels[j] if 0 <= j < len(self.labels) \
                else self.unseen_name
        return FeatureColumn(ftype=Text, data=out)


class PredictionDeIndexer(AllowLabelAsInput, BinaryTransformer):
    """Turn a Prediction back into the original label string using the
    indexer that produced the response (reference
    core/.../preparators/PredictionDeIndexer.scala). Input 1: the indexed
    response feature (its origin must be a StringIndexer model);
    input 2: the prediction."""

    input_types = (RealNN, Prediction)
    output_type = Text

    def __init__(self, labels: Optional[Sequence[str]] = None,
                 unseen_name: str = UNSEEN_NAME, uid: Optional[str] = None):
        super().__init__(operation_name="predDeIdx", uid=uid)
        self.labels = [str(l) for l in labels] if labels else None
        self.unseen_name = unseen_name

    def _labels(self) -> List[str]:
        if self.labels is not None:
            return self.labels
        origin = self.input_features[0].origin_stage
        if isinstance(origin, StringIndexerModel):
            return origin.labels
        fitted = getattr(origin, "fitted_model", None)
        if isinstance(fitted, StringIndexerModel):
            return fitted.labels
        raise ValueError(
            "PredictionDeIndexer needs labels= or a response produced by "
            "a fitted StringIndexer")

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        pred_col = cols[-1]
        preds = pred_col.data if isinstance(pred_col, PredictionColumn) \
            else np.asarray([p["prediction"] for p in pred_col.data])
        labels = self._labels()
        out = np.empty(len(preds), dtype=object)
        for i, v in enumerate(np.asarray(preds, dtype=np.float64)):
            j = int(v) if np.isfinite(v) else -1
            out[i] = labels[j] if 0 <= j < len(labels) else self.unseen_name
        return FeatureColumn(ftype=Text, data=out)
