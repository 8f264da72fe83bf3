"""Evaluators of the PyTorch port: binary, multiclass and regression."""
from .base import EvaluationMetrics, Evaluator
from .binary import (BinaryClassificationEvaluator,
                     BinaryClassificationMetrics, binary_metrics)
from .multiclass import (MultiClassificationEvaluator,
                         MultiClassificationMetrics, ThresholdMetrics,
                         multiclass_metrics)
from .regression import (RegressionEvaluator, RegressionMetrics,
                         regression_metrics)

__all__ = ["EvaluationMetrics", "Evaluator", "BinaryClassificationEvaluator",
           "BinaryClassificationMetrics", "binary_metrics",
           "MultiClassificationEvaluator", "MultiClassificationMetrics",
           "ThresholdMetrics", "multiclass_metrics", "RegressionEvaluator",
           "RegressionMetrics", "regression_metrics"]
