"""Models of the PyTorch port: the linear, naive Bayes, GLM and tree
families of the three problem types."""
from .base import (ClassifierModel, PredictionColumn, PredictionModel,
                   Predictor, RegressionModel)
from .bayes import NaiveBayes, NaiveBayesModel
from .glm import GeneralizedLinearRegression, GeneralizedLinearRegressionModel
from .linear import (LinearRegression, LinearRegressionModel, LinearSVC,
                     LinearSVCModel, LogisticRegression,
                     LogisticRegressionModel)
from .trees import (DecisionTreeClassifier, DecisionTreeRegressor,
                    GBTClassifier, GBTClassifierModel,
                    GBTMulticlassClassifierModel, GBTRegressor,
                    GBTRegressorModel, RandomForestClassifier,
                    RandomForestRegressor, TreeEnsembleClassifierModel,
                    TreeEnsembleRegressorModel, XGBoostClassifier,
                    XGBoostRegressor)

__all__ = ["ClassifierModel", "PredictionColumn", "PredictionModel",
           "Predictor", "RegressionModel", "NaiveBayes", "NaiveBayesModel",
           "GeneralizedLinearRegression", "GeneralizedLinearRegressionModel",
           "LinearRegression", "LinearRegressionModel", "LinearSVC",
           "LinearSVCModel", "LogisticRegression", "LogisticRegressionModel",
           "DecisionTreeClassifier", "DecisionTreeRegressor",
           "GBTClassifier", "GBTClassifierModel",
           "GBTMulticlassClassifierModel", "GBTRegressor",
           "GBTRegressorModel", "RandomForestClassifier",
           "RandomForestRegressor", "TreeEnsembleClassifierModel",
           "TreeEnsembleRegressorModel", "XGBoostClassifier",
           "XGBoostRegressor"]
