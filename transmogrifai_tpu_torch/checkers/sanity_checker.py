"""SanityChecker: automated feature validation and pruning.

Counterpart of ``transmogrifai_tpu/checkers/sanity_checker.py`` (reference
core/src/main/scala/com/salesforce/op/stages/impl/preparators/
SanityChecker.scala:236, fitFn:535, params :61-206, metadata
SanityCheckerMetadata.scala): a binary estimator over (RealNN label,
OPVector features) that computes per-column statistics, label
correlations and categorical association statistics, prunes problematic
columns and records the full summary.

The fit runs where the feature matrix lies. Inside ``Workflow.train`` the
prepare plan hands it the matrix as the tensor it computed on the card
(``device_inputs``): the row sample is gathered there, the moments and
label correlations run there in float64 (``utils/stats.py``), and every
indicator group's (level x label) contingency table comes from one float64
product ``Xind.T @ onehot_label`` there (its 0/1 entries make the counts
exact in any order). Only the d-length statistic vectors and the small
tables come back to the host; the matrix never does.

Pruning rules (the reference defaults):

- variance < ``min_variance``                       -> drop column
- |corr(label)| > ``max_correlation``               -> drop (leakage)
- |corr(label)| < ``min_correlation``               -> drop (noise)
- group Cramér's V > ``max_cramers_v``              -> drop whole group
- association rule confidence >= ``max_rule_confidence`` with support
  >= ``min_required_rule_support``                  -> drop whole group

The fitted model is a column gather by the kept indices: ``index_select``
on the device in the prepare and scoring plans, a numpy slice on the host.
Its label input rides along unread, so serving feeds it as NaN.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..features.columns import FeatureColumn
from ..stages.base import AllowLabelAsInput, BinaryEstimator, BinaryModel
from ..types import OPVector, RealNN
from ..utils.device import take_rows
from ..utils.stats import col_stats, contingency_stats, correlation_with_label
from ..utils.vector_meta import VectorColumnMetadata, VectorMetadata

__all__ = ["SanityChecker", "SanityCheckerModel", "SanityCheckerSummary",
           "ColumnStatistics", "MAX_LABEL_CARDINALITY"]

#: labels with more distinct values than this are treated as continuous and
#: categorical association stats are skipped (reference categoricalLabel
#: heuristic in SanityChecker.fitFn)
MAX_LABEL_CARDINALITY = 100


@dataclass
class ColumnStatistics:
    """Per-column record in the summary (reference SanityCheckerMetadata)."""
    name: str
    column_index: int
    variance: float
    mean: float
    min: float
    max: float
    corr_label: float
    cramers_v: Optional[float] = None
    max_rule_confidence: Optional[float] = None
    support: Optional[float] = None
    is_dropped: bool = False
    reasons: List[str] = field(default_factory=list)
    #: provenance from the vector metadata (stable across index
    #: renumbering after pruning)
    parent_feature_name: Optional[str] = None
    grouping: Optional[str] = None
    indicator_value: Optional[str] = None
    descriptor_value: Optional[str] = None

    def provenance_key(self) -> tuple:
        return (self.parent_feature_name, self.grouping,
                self.indicator_value, self.descriptor_value)

    def to_json(self) -> dict:
        return {"name": self.name, "columnIndex": self.column_index,
                "variance": self.variance, "mean": self.mean,
                "min": self.min, "max": self.max,
                "corrLabel": self.corr_label, "cramersV": self.cramers_v,
                "maxRuleConfidence": self.max_rule_confidence,
                "support": self.support, "isDropped": self.is_dropped,
                "reasons": list(self.reasons),
                "parentFeatureName": self.parent_feature_name,
                "grouping": self.grouping,
                "indicatorValue": self.indicator_value,
                "descriptorValue": self.descriptor_value}


@dataclass
class SanityCheckerSummary:
    """(reference SanityCheckerSummary metadata)"""
    column_stats: List[ColumnStatistics] = field(default_factory=list)
    dropped: List[str] = field(default_factory=list)
    kept_indices: List[int] = field(default_factory=list)
    sample_size: int = 0

    def to_json(self) -> dict:
        return {"columnStats": [c.to_json() for c in self.column_stats],
                "dropped": list(self.dropped),
                "keptIndices": list(self.kept_indices),
                "sampleSize": self.sample_size}


def _host_labels(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        return data.detach().to("cpu", torch.float64).numpy()
    return np.asarray(data, dtype=np.float64)


class SanityChecker(AllowLabelAsInput, BinaryEstimator):
    """(reference SanityChecker.scala:236)"""

    input_types = (RealNN, OPVector)
    output_type = OPVector
    device_inputs = True

    def __init__(self, check_sample: float = 1.0, sample_seed: int = 42,
                 sample_limit: int = 100_000, max_correlation: float = 0.95,
                 min_correlation: float = 0.0, min_variance: float = 1e-5,
                 max_cramers_v: float = 0.95,
                 min_required_rule_support: float = 0.001,
                 max_rule_confidence: float = 1.0,
                 remove_bad_features: bool = True,
                 uid: Optional[str] = None):
        super().__init__(operation_name="sanityChecker", uid=uid)
        self.check_sample = check_sample
        self.sample_seed = sample_seed
        self.sample_limit = sample_limit
        self.max_correlation = max_correlation
        self.min_correlation = min_correlation
        self.min_variance = min_variance
        self.max_cramers_v = max_cramers_v
        self.min_required_rule_support = min_required_rule_support
        self.max_rule_confidence = max_rule_confidence
        self.remove_bad_features = remove_bad_features

    def check_input_constraints(self, features) -> None:
        label, vec = features
        if not label.is_response:
            raise ValueError("SanityChecker input 1 must be the response")
        if vec.is_response:
            raise ValueError("SanityChecker input 2 must not be a response")

    # -- fitting -----------------------------------------------------------
    def fit_columns(self, cols: List[FeatureColumn]) -> "SanityCheckerModel":
        """Fit on the label column and the feature vector, whose values may
        be a tensor on a device (the statistics then run there)."""
        meta = cols[1].metadata or VectorMetadata(name="features")
        return self._fit_stats(_host_labels(cols[0].data), cols[1].data,
                               meta)

    def _fit_stats(self, y: np.ndarray, X, meta: VectorMetadata
                   ) -> "SanityCheckerModel":
        n, d = X.shape
        # sampling (reference checkSample/sampleLimit, fitFn:535)
        target = min(int(np.ceil(n * self.check_sample)), self.sample_limit)
        if target < n:
            rng = np.random.default_rng(self.sample_seed)
            idx = np.sort(rng.choice(n, target, replace=False))
            Xs, ys = take_rows(X, idx), y[idx]
            sample_size = int(target)
        else:
            Xs, ys = X, y
            sample_size = int(n)
        Xs = (Xs.to(torch.float64) if isinstance(Xs, torch.Tensor)
              else torch.as_tensor(np.asarray(Xs, dtype=np.float64)))

        stats = col_stats(Xs)
        corr = correlation_with_label(Xs, ys)

        names = meta.column_names() if meta.size == d else \
            [f"f{i}" for i in range(d)]
        col_recs = []
        for j in range(d):
            rec = ColumnStatistics(
                name=names[j], column_index=j,
                variance=float(stats.variance[j]), mean=float(stats.mean[j]),
                min=float(stats.min[j]), max=float(stats.max[j]),
                corr_label=float(corr[j]))
            if meta.size == d:
                mc = meta.columns[j]
                rec.parent_feature_name = mc.parent_feature_name
                rec.grouping = mc.grouping
                rec.indicator_value = mc.indicator_value
                rec.descriptor_value = mc.descriptor_value
            col_recs.append(rec)

        def drop(j: int, reason: str):
            col_recs[j].is_dropped = True
            col_recs[j].reasons.append(reason)

        # per-column rules
        for j in range(d):
            if col_recs[j].variance < self.min_variance:
                drop(j, f"variance {col_recs[j].variance:.3g} below "
                        f"minVariance {self.min_variance}")
            c = col_recs[j].corr_label
            if np.isfinite(c):
                if abs(c) > self.max_correlation:
                    drop(j, f"label correlation {c:.3f} above "
                            f"maxCorrelation {self.max_correlation}")
                elif abs(c) < self.min_correlation:
                    drop(j, f"label correlation {c:.3f} below "
                            f"minCorrelation {self.min_correlation}")

        # categorical association rules per indicator group
        labels = np.unique(ys)
        if meta.size == d and 2 <= len(labels) <= MAX_LABEL_CARDINALITY:
            groups = meta.indicator_groups()
            all_idx = sorted({j for idxs in groups.values() for j in idxs})
            local = {j: k for k, j in enumerate(all_idx)}
            tables_all = self._contingency_tables(Xs, ys, labels, all_idx)
            for indices in groups.values():
                # contingency: level rows x label cols
                table = tables_all[[local[j] for j in indices], :]
                cs = contingency_stats(table)
                for k, j in enumerate(indices):
                    col_recs[j].cramers_v = cs.cramers_v
                    col_recs[j].max_rule_confidence = \
                        float(cs.max_rule_confidences[k]) \
                        if k < len(cs.max_rule_confidences) else None
                    col_recs[j].support = float(cs.supports[k]) \
                        if k < len(cs.supports) else None
                group_bad = []
                if np.isfinite(cs.cramers_v) and \
                        cs.cramers_v > self.max_cramers_v:
                    group_bad.append(
                        f"group Cramér's V {cs.cramers_v:.3f} above "
                        f"maxCramersV {self.max_cramers_v}")
                strong_rule = (
                    (cs.max_rule_confidences >= self.max_rule_confidence)
                    & (cs.supports >= self.min_required_rule_support))
                if strong_rule.any():
                    group_bad.append(
                        "association rule confidence above "
                        f"maxRuleConfidence {self.max_rule_confidence}")
                for reason in group_bad:
                    for j in indices:
                        drop(j, reason)

        kept = [j for j in range(d) if not col_recs[j].is_dropped] \
            if self.remove_bad_features else list(range(d))
        if not kept:
            raise ValueError(
                "SanityChecker dropped every feature column — relax the "
                "thresholds (minVariance/maxCorrelation/maxCramersV)")
        summary = SanityCheckerSummary(
            column_stats=col_recs,
            dropped=[col_recs[j].name for j in range(d)
                     if col_recs[j].is_dropped],
            kept_indices=kept, sample_size=sample_size)
        model = SanityCheckerModel(
            kept_indices=kept,
            output_metadata=(meta.select(kept) if meta.size == d else None))
        model.summary = summary
        return model

    @staticmethod
    def _contingency_tables(Xs: torch.Tensor, ys: np.ndarray,
                            labels: np.ndarray,
                            all_idx: Sequence[int]) -> np.ndarray:
        """Every indicator column's label counts, (len(all_idx), labels),
        from one float64 product on the matrix's device: the 0/1 entries
        make every count an exact integer in any summation order. Only
        the table comes back to the host."""
        if not all_idx:
            return np.zeros((0, len(labels)))
        dev = Xs.device
        cols = torch.as_tensor(np.asarray(all_idx, dtype=np.int64),
                               device=dev)
        onehot = torch.as_tensor(
            (ys[:, None] == labels[None, :]).astype(np.float64), device=dev)
        return (Xs.index_select(1, cols).T @ onehot).cpu().numpy()


class SanityCheckerModel(AllowLabelAsInput, BinaryModel):
    """Vector slice by kept indices (reference: the fitted SanityChecker
    model behaves like DropIndicesByTransformer)."""

    input_types = (RealNN, OPVector)
    output_type = OPVector
    device_inputs = True
    #: the fit's summary; in memory only, as in the JAX package, whose
    #: saved layout keeps the constructor arguments
    summary: Optional[SanityCheckerSummary] = None

    def __init__(self, kept_indices: Sequence[int],
                 output_metadata: Optional[VectorMetadata] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name="sanityChecker", uid=uid)
        self.kept_indices = [int(i) for i in kept_indices]
        self.output_metadata = output_metadata
        self._kept_by_device: Dict[torch.device, torch.Tensor] = {}

    def _kept_on(self, device: torch.device) -> torch.Tensor:
        """The kept indices as an int64 tensor on ``device``, made once:
        a graph capture replays the gather without a copy up."""
        t = self._kept_by_device.get(device)
        if t is None:
            t = torch.as_tensor(np.asarray(self.kept_indices, np.int64),
                                device=device)
            self._kept_by_device[device] = t
        return t

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        vec = cols[-1]
        if vec.on_device:
            data = vec.data.index_select(1, self._kept_on(vec.data.device))
        else:
            data = np.asarray(vec.data,
                              dtype=np.float64)[:, self.kept_indices]
        meta = self.output_metadata
        if meta is None:
            src = vec.metadata
            meta = (src.select(self.kept_indices) if src is not None
                    and src.size == vec.data.shape[1] else None)
        if meta is None:
            meta = VectorMetadata(
                name=self.get_output().name if self.input_features else "v",
                columns=tuple(VectorColumnMetadata(
                    parent_feature_name="features",
                    parent_feature_type="OPVector")
                    for _ in self.kept_indices))
        return FeatureColumn.vector(data, meta)

    def transform_value(self, *values):
        vec = values[-1]
        arr = np.asarray(vec.value if hasattr(vec, "value") else vec,
                         dtype=np.float64).reshape(1, -1)
        return OPVector(arr[0, self.kept_indices])

    def transform_arrays(self, arrays):
        # a column gather by the kept indices; the (ignored) label lane
        # rides along, so a serve-time NaN label never touches the output
        X = arrays[-1]
        return X.index_select(1, self._kept_on(X.device))
