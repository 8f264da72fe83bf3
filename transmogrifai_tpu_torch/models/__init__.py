"""Models of the PyTorch port (the binary tree families so far)."""
from .base import ClassifierModel, PredictionColumn, PredictionModel, Predictor
from .trees import (DecisionTreeClassifier, GBTClassifier, GBTClassifierModel,
                    RandomForestClassifier, TreeEnsembleClassifierModel)

__all__ = ["ClassifierModel", "PredictionColumn", "PredictionModel",
           "Predictor", "DecisionTreeClassifier", "GBTClassifier",
           "GBTClassifierModel", "RandomForestClassifier",
           "TreeEnsembleClassifierModel"]
