"""Models of the PyTorch port (the binary GBT family so far)."""
from .base import ClassifierModel, PredictionColumn, PredictionModel, Predictor
from .trees import GBTClassifier, GBTClassifierModel

__all__ = ["ClassifierModel", "PredictionColumn", "PredictionModel",
           "Predictor", "GBTClassifier", "GBTClassifierModel"]
