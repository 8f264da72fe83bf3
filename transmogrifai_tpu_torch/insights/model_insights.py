"""ModelInsights: post-hoc explainability report for a fitted workflow.

The port's own copy of ``transmogrifai_tpu/insights/model_insights.py``
(the same report and JSON), from the reference ModelInsights
(core/src/main/scala/com/salesforce/op/ModelInsights.scala:72,291,336,
390,435): walks the fitted DAG extracting

- label summary (name, distinct values / moments),
- per derived feature column: provenance (parent feature, indicator),
  sanity-checker statistics (variance, label correlation, Cramér's V,
  dropped + reasons), and model contribution (feature importances or
  coefficient magnitudes),
- the selected model's summary (winner, params, every validation
  result) when a ModelSelector produced the prediction.

``WorkflowModel.model_insights()`` is the user entry point (reference
OpWorkflowModel.modelInsights:162).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..features.columns import host_column

__all__ = ["ModelInsights", "LabelSummary", "FeatureInsights",
           "DerivedFeatureInsight", "extract_model_insights"]


@dataclass
class LabelSummary:
    """(reference ModelInsights label summary)"""
    name: str = ""
    is_response: bool = True
    distinct_count: Optional[int] = None
    mean: Optional[float] = None
    variance: Optional[float] = None
    sample_size: Optional[int] = None

    def to_json(self) -> dict:
        return {"name": self.name, "distinctCount": self.distinct_count,
                "mean": self.mean, "variance": self.variance,
                "sampleSize": self.sample_size}


@dataclass
class DerivedFeatureInsight:
    """One column of the final feature vector
    (reference Insights per derived feature)."""
    name: str
    index: int
    grouping: Optional[str] = None
    indicator_value: Optional[str] = None
    variance: Optional[float] = None
    corr_label: Optional[float] = None
    cramers_v: Optional[float] = None
    contribution: Optional[float] = None
    is_dropped: bool = False
    dropped_reasons: List[str] = field(default_factory=list)

    def to_json(self) -> dict:
        return {"name": self.name, "index": self.index,
                "grouping": self.grouping,
                "indicatorValue": self.indicator_value,
                "variance": self.variance, "corrLabel": self.corr_label,
                "cramersV": self.cramers_v,
                "contribution": self.contribution,
                "isDropped": self.is_dropped,
                "droppedReasons": list(self.dropped_reasons)}


@dataclass
class FeatureInsights:
    """All derived columns of one raw parent feature
    (reference FeatureInsights)."""
    feature_name: str
    feature_type: str = ""
    derived: List[DerivedFeatureInsight] = field(default_factory=list)
    #: RawFeatureFilter train/score distributions for this raw feature
    #: (reference ModelInsights feature distributions)
    distributions: List[dict] = field(default_factory=list)
    #: RawFeatureFilter exclusion reasons (non-empty = feature was
    #: blacklisted before training)
    exclusion_reasons: List[str] = field(default_factory=list)

    @property
    def total_contribution(self) -> float:
        return float(sum(abs(d.contribution or 0.0) for d in self.derived))

    def to_json(self) -> dict:
        return {"featureName": self.feature_name,
                "featureType": self.feature_type,
                "derivedFeatures": [d.to_json() for d in self.derived],
                "distributions": list(self.distributions),
                "exclusionReasons": list(self.exclusion_reasons)}


@dataclass
class ModelInsights:
    """(reference ModelInsights.scala:72)"""
    label: LabelSummary = field(default_factory=LabelSummary)
    features: List[FeatureInsights] = field(default_factory=list)
    selected_model: Optional[dict] = None
    stage_info: Dict[str, dict] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"label": self.label.to_json(),
                "features": [f.to_json() for f in self.features],
                "selectedModelInfo": self.selected_model,
                "stageInfo": self.stage_info}

    def pretty(self) -> str:
        """(reference summaryPretty via Table)"""
        lines = [f"Label: {self.label.name} "
                 f"(distinct={self.label.distinct_count}, "
                 f"mean={self.label.mean})"]
        if self.selected_model:
            lines.append(
                f"Model: {self.selected_model.get('bestModelName', '?')} "
                f"params={self.selected_model.get('bestModelParams', {})}")
        ranked = sorted(self.features, key=lambda f: -f.total_contribution)
        lines.append("Top feature contributions:")
        for f in ranked[:20]:
            lines.append(f"  {f.feature_name}: "
                         f"{f.total_contribution:.4f}")
        return "\n".join(lines)


def _model_contributions(model) -> Optional[np.ndarray]:
    """Per-column contribution from the inner prediction model:
    feature importances for trees, |coefficients| for linear models
    (reference Insights contribution extraction); the coefficients are
    read from the model's device."""
    inner = getattr(model, "inner", model)
    imp = getattr(inner, "feature_importances", None)
    if imp is not None and np.size(imp):
        return np.asarray(imp, dtype=np.float64)
    coef = getattr(inner, "coefficients", None)
    if coef is not None:
        if isinstance(coef, torch.Tensor):
            coef = coef.detach().to("cpu", torch.float64).numpy()
        c = np.asarray(coef, dtype=np.float64)
        return np.abs(c) if c.ndim == 1 else np.abs(c).sum(axis=0)
    return None


def extract_model_insights(wf_model) -> ModelInsights:
    """(reference ModelInsights.extractFromStages:435)"""
    from ..checkers.sanity_checker import SanityCheckerModel
    from ..models.base import PredictionModel
    from ..selector.selector import SelectedModel

    insights = ModelInsights()
    stages = wf_model.stages()

    # label
    responses = [f for f in wf_model.raw_features() if f.is_response]
    if responses:
        lbl = responses[0]
        insights.label.name = lbl.name
        ds = getattr(wf_model, "train_dataset", None)
        if ds is not None and lbl.name in ds:
            y = np.asarray(host_column(ds[lbl.name]).data,
                           dtype=np.float64)
            y = y[np.isfinite(y)]
            if y.size:
                insights.label.distinct_count = int(len(np.unique(y)))
                insights.label.mean = float(np.mean(y))
                insights.label.variance = float(np.var(y))
                insights.label.sample_size = int(y.size)

    checker: Optional[SanityCheckerModel] = None
    pred_model: Optional[PredictionModel] = None
    for s in stages:
        if isinstance(s, SanityCheckerModel):
            checker = s
        if isinstance(s, PredictionModel):
            pred_model = s
        info = {"className": type(s).__name__, "uid": s.uid}
        summ = getattr(s, "summary", None)
        if summ is not None and hasattr(summ, "to_json"):
            info["summary"] = summ.to_json()
        insights.stage_info[s.stage_name()] = info

    # derived feature columns: metadata of the matrix the model trained on
    meta = getattr(pred_model, "vector_metadata", None) if pred_model \
        else None
    contributions = _model_contributions(pred_model) if pred_model else None
    # checker stats matched by provenance (parent/grouping/indicator/
    # descriptor), which is stable across the index renumbering that
    # pruning applies to the model-side metadata
    checker_by_prov = {}
    checker_cols = []
    if checker is not None and checker.summary is not None:
        checker_cols = checker.summary.column_stats
        checker_by_prov = {c.provenance_key(): c for c in checker_cols
                           if c.parent_feature_name is not None}

    by_parent: Dict[str, FeatureInsights] = {}
    if meta is not None:
        for col in meta.columns:
            fi = by_parent.setdefault(
                col.parent_feature_name,
                FeatureInsights(feature_name=col.parent_feature_name,
                                feature_type=col.parent_feature_type))
            d = DerivedFeatureInsight(
                name=col.column_name(meta.name), index=col.index,
                grouping=col.grouping, indicator_value=col.indicator_value)
            if contributions is not None and col.index < contributions.size:
                d.contribution = float(contributions[col.index])
            cs = checker_by_prov.get(
                (col.parent_feature_name, col.grouping,
                 col.indicator_value, col.descriptor_value))
            if cs is not None:
                d.variance = cs.variance
                d.corr_label = cs.corr_label
                d.cramers_v = cs.cramers_v
            fi.derived.append(d)
    # columns the checker dropped never reach the model matrix — record them
    for cs in checker_cols:
        if cs.is_dropped:
            parent = cs.parent_feature_name or cs.name
            fi = by_parent.setdefault(
                parent, FeatureInsights(feature_name=parent))
            fi.derived.append(DerivedFeatureInsight(
                name=cs.name, index=cs.column_index,
                grouping=cs.grouping, indicator_value=cs.indicator_value,
                variance=cs.variance, corr_label=cs.corr_label,
                cramers_v=cs.cramers_v, is_dropped=True,
                dropped_reasons=list(cs.reasons)))
    insights.features = list(by_parent.values())

    # RawFeatureFilter results (reference ModelInsights.scala:72 —
    # distributions + exclusion reasons per raw feature; excluded
    # features have no derived columns but still appear)
    rff = getattr(wf_model, "raw_feature_filter_results", None)
    if rff is not None:
        by_name = {fi.feature_name: fi for fi in insights.features}

        def entry(name: str) -> FeatureInsights:
            if name not in by_name:
                by_name[name] = FeatureInsights(feature_name=name)
                insights.features.append(by_name[name])
            return by_name[name]

        for dist in rff.train_distributions:
            entry(dist.name).distributions.append(
                dict(dist.to_json(), split="train"))
        for dist in rff.score_distributions:
            entry(dist.name).distributions.append(
                dict(dist.to_json(), split="score"))
        for exc in rff.exclusions:
            entry(exc.name).exclusion_reasons.append(exc.reason)

    if isinstance(pred_model, SelectedModel) and pred_model.summary:
        insights.selected_model = pred_model.summary.to_json()
    return insights
