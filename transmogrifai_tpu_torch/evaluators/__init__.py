"""Evaluators of the PyTorch port: model-quality metrics for every problem
type, and the ``Evaluators`` factory (counterparts of
``transmogrifai_tpu/evaluators/``; reference
core/src/main/scala/com/salesforce/op/evaluators/Evaluators.scala:40).

The factory's evaluators are the classes below. Where the device computes
their default metric (``device_metrics.py``: AuPR, AuROC, Precision,
Recall, F1 and Error of the binary and multiclass evaluators, RMSE, MSE,
R2 and MAE of the regression one), a selector's search computes it on the
device of its predictions; the others run on the host.
"""
from .base import EvaluationMetrics, Evaluator, MultiMetrics, SingleMetric
from .binary import (BinaryClassificationEvaluator,
                     BinaryClassificationMetrics, BinScoreEvaluator,
                     BinScoreMetrics, au_pr, au_roc, binary_metrics,
                     pr_curve, roc_curve)
from .logloss import LogLossEvaluator, LogLossMetrics, log_loss
from .multiclass import (MultiClassificationEvaluator,
                         MultiClassificationMetrics, ThresholdMetrics,
                         multiclass_metrics)
from .regression import (RegressionEvaluator, RegressionMetrics,
                         regression_metrics)

__all__ = [
    "EvaluationMetrics", "Evaluator", "SingleMetric", "MultiMetrics",
    "BinaryClassificationEvaluator", "BinaryClassificationMetrics",
    "BinScoreEvaluator", "BinScoreMetrics", "binary_metrics", "au_pr",
    "au_roc", "roc_curve", "pr_curve",
    "MultiClassificationEvaluator", "MultiClassificationMetrics",
    "LogLossEvaluator", "LogLossMetrics", "log_loss",
    "ThresholdMetrics", "multiclass_metrics",
    "RegressionEvaluator", "RegressionMetrics", "regression_metrics",
    "Evaluators",
]


class Evaluators:
    """Factory namespace (reference Evaluators.scala:40):
    ``Evaluators.BinaryClassification.au_pr()`` etc."""

    class BinaryClassification:
        @staticmethod
        def au_pr(**kw) -> BinaryClassificationEvaluator:
            return BinaryClassificationEvaluator(default_metric="AuPR", **kw)

        @staticmethod
        def au_roc(**kw) -> BinaryClassificationEvaluator:
            return BinaryClassificationEvaluator(default_metric="AuROC", **kw)

        @staticmethod
        def precision(**kw) -> BinaryClassificationEvaluator:
            return BinaryClassificationEvaluator(
                default_metric="Precision", **kw)

        @staticmethod
        def recall(**kw) -> BinaryClassificationEvaluator:
            return BinaryClassificationEvaluator(default_metric="Recall", **kw)

        @staticmethod
        def f1(**kw) -> BinaryClassificationEvaluator:
            return BinaryClassificationEvaluator(default_metric="F1", **kw)

        @staticmethod
        def error(**kw) -> BinaryClassificationEvaluator:
            return BinaryClassificationEvaluator(default_metric="Error", **kw)

        @staticmethod
        def log_loss(**kw) -> LogLossEvaluator:
            return LogLossEvaluator(**kw)

    class MultiClassification:
        @staticmethod
        def f1(**kw) -> MultiClassificationEvaluator:
            return MultiClassificationEvaluator(default_metric="F1", **kw)

        @staticmethod
        def precision(**kw) -> MultiClassificationEvaluator:
            return MultiClassificationEvaluator(
                default_metric="Precision", **kw)

        @staticmethod
        def recall(**kw) -> MultiClassificationEvaluator:
            return MultiClassificationEvaluator(default_metric="Recall", **kw)

        @staticmethod
        def log_loss(**kw) -> LogLossEvaluator:
            return LogLossEvaluator(**kw)

        @staticmethod
        def error(**kw) -> MultiClassificationEvaluator:
            return MultiClassificationEvaluator(default_metric="Error", **kw)

    class Regression:
        @staticmethod
        def rmse(**kw) -> RegressionEvaluator:
            return RegressionEvaluator(
                default_metric="RootMeanSquaredError", **kw)

        @staticmethod
        def mse(**kw) -> RegressionEvaluator:
            return RegressionEvaluator(default_metric="MeanSquaredError", **kw)

        @staticmethod
        def mae(**kw) -> RegressionEvaluator:
            return RegressionEvaluator(
                default_metric="MeanAbsoluteError", **kw)

        @staticmethod
        def r2(**kw) -> RegressionEvaluator:
            return RegressionEvaluator(default_metric="R2", **kw)
