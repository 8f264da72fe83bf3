"""RecordInsightsCorr: correlation-based per-record insights + parser.

The port's own copy of ``transmogrifai_tpu/insights/corr.py`` (reference
RecordInsightsCorr, core/src/main/scala/com/salesforce/op/stages/impl/
insights/RecordInsightsCorr.scala:56-160, and RecordInsightsParser.scala:
46-90):

- fit: correlate every feature-vector column against every prediction
  column (Pearson or Spearman) over the training batch, and record a
  per-column normalizer (min-max or z) from the column stats. The
  centred product runs where the feature vector lives (the workflow's
  device), in the working dtype there; ranks for Spearman are taken on
  the host, as the JAX package takes them;
- transform: importance[p, j] = corr[p, j] * normalized_feature[j]
  (NaN -> 0), computed for the whole batch on the feature vector's
  device; the top-K per prediction column are ranked on the host with the
  JAX package's ``np.argsort`` and land in a TextMap keyed by the
  column-metadata JSON, valued by ``[[pred_index, importance]]`` JSON —
  the parser-compatible wire format of the reference.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..features.columns import FeatureColumn, PredictionColumn
from ..stages.base import AllowLabelAsInput, BinaryEstimator, BinaryModel
from ..types import OPVector, Prediction, TextMap
from ..utils.device import working_dtype
from ..utils.vector_meta import VectorMetadata

__all__ = ["RecordInsightsCorr", "RecordInsightsCorrModel",
           "parse_insights"]


def _prediction_matrix(col: FeatureColumn) -> np.ndarray:
    """(n, p) score matrix from a Prediction/OPVector column: the class
    probabilities when available, else the raw predictions."""
    if isinstance(col, PredictionColumn):
        if col.probability.shape[1]:
            return np.asarray(col.probability, dtype=np.float64)
        return np.asarray(col.data, dtype=np.float64).reshape(-1, 1)
    arr = _host(col.data)
    return arr if arr.ndim == 2 else arr.reshape(-1, 1)


def _host(data) -> np.ndarray:
    """``data`` (a tensor or an array) as float64 numpy."""
    if isinstance(data, torch.Tensor):
        return data.detach().to("cpu", torch.float64).numpy()
    return np.asarray(data, dtype=np.float64)


def _features(col: FeatureColumn) -> torch.Tensor:
    """The feature vector as a tensor on its own device (the CPU for a
    host column) in that device's working dtype."""
    data = col.data
    device = data.device if isinstance(data, torch.Tensor) else \
        torch.device("cpu")
    return torch.as_tensor(data, device=device, dtype=working_dtype(device))


def _rankdata(X: np.ndarray) -> np.ndarray:
    """Column-wise average ranks (Spearman support)."""
    order = np.argsort(X, axis=0, kind="stable")
    ranks = np.empty_like(X)
    n = X.shape[0]
    rng = np.arange(n, dtype=np.float64)
    for j in range(X.shape[1]):
        r = np.empty(n)
        r[order[:, j]] = rng
        # average ties
        _, inv = np.unique(X[:, j], return_inverse=True)
        r = (np.bincount(inv, weights=r) / np.bincount(inv))[inv]
        ranks[:, j] = r
    return ranks


def _corr_block(P: torch.Tensor, F: torch.Tensor) -> np.ndarray:
    """(p, d) Pearson correlations of the columns of ``P`` (n, p) and
    ``F`` (n, d), one centred product on their device; NaN where a
    column is constant."""
    Pc = P - P.mean(dim=0)
    Fc = F - F.mean(dim=0)
    num = Pc.t() @ Fc
    den = torch.outer(torch.sqrt((Pc ** 2).sum(dim=0)),
                      torch.sqrt((Fc ** 2).sum(dim=0)))
    corr = torch.where(den > 0, num / den,
                       torch.full_like(num, float("nan")))
    return _host(corr)


class RecordInsightsCorr(AllowLabelAsInput, BinaryEstimator):
    """(reference RecordInsightsCorr.scala:56). Input 1 the prediction
    (response side), input 2 the feature vector."""

    input_types = (Prediction, OPVector)
    output_type = TextMap
    device_inputs = True

    def __init__(self, top_k: int = 20, norm_type: str = "minmax",
                 correlation_type: str = "pearson",
                 uid: Optional[str] = None):
        super().__init__(operation_name="recordInsightsCorr", uid=uid)
        if norm_type not in ("minmax", "znorm"):
            raise ValueError(f"norm_type must be minmax|znorm, "
                             f"got {norm_type!r}")
        if correlation_type not in ("pearson", "spearman"):
            raise ValueError(f"correlation_type must be pearson|spearman, "
                             f"got {correlation_type!r}")
        self.top_k = top_k
        self.norm_type = norm_type
        self.correlation_type = correlation_type

    def fit_columns(self, cols: List[FeatureColumn]
                    ) -> "RecordInsightsCorrModel":
        F = _features(cols[1])
        P = _prediction_matrix(cols[0])
        on = dict(device=F.device, dtype=F.dtype)
        if self.correlation_type == "spearman":
            corr = _corr_block(torch.as_tensor(_rankdata(P), **on),
                               torch.as_tensor(_rankdata(_host(F)), **on))
        else:
            corr = _corr_block(torch.as_tensor(P, **on), F)
        # the normalizers are the features' own, under either correlation
        if self.norm_type == "minmax":
            lo, hi = (_host(v) for v in torch.aminmax(F, dim=0))
            shift, scale = lo, np.where(hi > lo, hi - lo, 1.0)
        else:
            mu = _host(F.mean(dim=0))
            sd = _host(F.std(dim=0, correction=0))
            shift, scale = mu, np.where(sd > 0, sd, 1.0)
        return RecordInsightsCorrModel(
            score_corr=corr, norm_shift=shift, norm_scale=scale,
            top_k=self.top_k, metadata=cols[1].metadata)


class RecordInsightsCorrModel(AllowLabelAsInput, BinaryModel):
    input_types = (Prediction, OPVector)
    output_type = TextMap
    device_inputs = True

    def __init__(self, score_corr=None, norm_shift=None, norm_scale=None,
                 top_k: int = 20, metadata: Optional[VectorMetadata] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="recordInsightsCorr", uid=uid)
        self.score_corr = np.asarray(score_corr, dtype=np.float64)
        self.norm_shift = np.asarray(norm_shift, dtype=np.float64)
        self.norm_scale = np.asarray(norm_scale, dtype=np.float64)
        self.top_k = int(top_k)
        self.metadata = metadata

    def _column_keys(self, d: int) -> List[str]:
        meta = self.metadata
        if meta is not None and meta.size == d:
            return [json.dumps(c.to_json(), sort_keys=True)
                    for c in meta.columns]
        return [json.dumps({"index": j, "parentFeatureName": f"column_{j}"},
                           sort_keys=True) for j in range(d)]

    def importances(self, F: torch.Tensor) -> np.ndarray:
        """(n, p, d) importances of the rows of ``F``: the correlations
        times the normalized features, on ``F``'s device."""
        on = dict(device=F.device, dtype=F.dtype)
        corr = torch.as_tensor(np.nan_to_num(self.score_corr, nan=0.0), **on)
        normed = (F - torch.as_tensor(self.norm_shift, **on)) \
            / torch.as_tensor(self.norm_scale, **on)
        return _host(corr[None, :, :] * normed[:, None, :])

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        imp = self.importances(_features(cols[1]))
        n, p, d = imp.shape
        keys = self._column_keys(d)
        # per row and prediction column, the top K by |importance|, ranked
        # on the host as the JAX package ranks them
        top = np.argsort(-np.abs(imp), axis=2)[:, :, :self.top_k]
        values = []
        for i in range(n):
            per_col: Dict[int, List[Tuple[int, float]]] = {}
            for q in range(p):
                for j in top[i, q]:
                    per_col.setdefault(int(j), []).append(
                        (q, float(imp[i, q, j])))
            row = {keys[j]: json.dumps([[q, round(v, 9)] for q, v in seq])
                   for j, seq in per_col.items()}
            values.append(TextMap(row))
        return FeatureColumn.from_values(TextMap, values)


def parse_insights(insights: TextMap) -> Dict[str, List[Tuple[int, float]]]:
    """Parse an insights TextMap back into
    {column-info-json: [(prediction_index, importance)]}
    (reference RecordInsightsParser.parseInsights)."""
    out: Dict[str, List[Tuple[int, float]]] = {}
    value = insights.value if hasattr(insights, "value") else insights
    for k, v in (value or {}).items():
        out[k] = [(int(q), float(s)) for q, s in json.loads(v)]
    return out
