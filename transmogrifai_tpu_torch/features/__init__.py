"""Typed features, their DAG and columnar datasets (the port's copy of
``transmogrifai_tpu/features/``)."""
from .columns import (ColumnKind, Dataset, FeatureColumn, PredictionColumn,
                      column_kind)
from .feature import (Feature, FeatureCycleError, FeatureHistory,
                      parent_stages, topo_layers)
from .builder import FeatureBuilder, FeatureBuilderWithExtract, infer_schema
from .generator import FeatureGeneratorStage

__all__ = [
    "ColumnKind", "Dataset", "FeatureColumn", "PredictionColumn",
    "column_kind", "Feature", "FeatureCycleError", "FeatureHistory",
    "parent_stages", "topo_layers", "FeatureBuilder",
    "FeatureBuilderWithExtract", "infer_schema", "FeatureGeneratorStage",
]
