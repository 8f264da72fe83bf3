"""Models of the PyTorch port (the binary default pool's families)."""
from .base import ClassifierModel, PredictionColumn, PredictionModel, Predictor
from .linear import (LinearSVC, LinearSVCModel, LogisticRegression,
                     LogisticRegressionModel)
from .trees import (DecisionTreeClassifier, GBTClassifier, GBTClassifierModel,
                    RandomForestClassifier, TreeEnsembleClassifierModel)

__all__ = ["ClassifierModel", "PredictionColumn", "PredictionModel",
           "Predictor", "DecisionTreeClassifier", "GBTClassifier",
           "GBTClassifierModel", "LinearSVC", "LinearSVCModel",
           "LogisticRegression", "LogisticRegressionModel",
           "RandomForestClassifier", "TreeEnsembleClassifierModel"]
