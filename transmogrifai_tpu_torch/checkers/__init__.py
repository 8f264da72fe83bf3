"""Automated feature validation (SURVEY §2.6; core/.../preparators/
SanityChecker.scala:236, core/.../filters/RawFeatureFilter.scala:87).

Counterpart of ``transmogrifai_tpu/checkers/``."""
from .raw_feature_filter import (ExclusionReason, FeatureDistribution,
                                 RawFeatureFilter, RawFeatureFilterResults,
                                 numeric_histogram_js, rewire_without)
from .sanity_checker import (ColumnStatistics, SanityChecker,
                             SanityCheckerModel, SanityCheckerSummary)

__all__ = ["SanityChecker", "SanityCheckerModel", "SanityCheckerSummary",
           "ColumnStatistics", "RawFeatureFilter", "RawFeatureFilterResults",
           "FeatureDistribution", "ExclusionReason", "numeric_histogram_js",
           "rewire_without"]
