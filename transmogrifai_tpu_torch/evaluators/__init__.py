"""Evaluators of the PyTorch port (binary classification so far)."""
from .base import EvaluationMetrics, Evaluator
from .binary import (BinaryClassificationEvaluator,
                     BinaryClassificationMetrics, binary_metrics)

__all__ = ["EvaluationMetrics", "Evaluator", "BinaryClassificationEvaluator",
           "BinaryClassificationMetrics", "binary_metrics"]
