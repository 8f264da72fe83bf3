"""Explainability of the PyTorch port (the JAX package's ``insights/``;
reference core/.../ModelInsights.scala:72,
core/.../insights/RecordInsightsLOCO.scala:54)."""
from .corr import (RecordInsightsCorr, RecordInsightsCorrModel,
                   parse_insights)
from .loco import RecordInsightsLOCO
from .model_insights import (DerivedFeatureInsight, FeatureInsights,
                             LabelSummary, ModelInsights,
                             extract_model_insights)

__all__ = ["RecordInsightsLOCO", "RecordInsightsCorr",
           "RecordInsightsCorrModel", "parse_insights", "ModelInsights", "LabelSummary",
           "FeatureInsights", "DerivedFeatureInsight",
           "extract_model_insights"]
