"""Models of the PyTorch port: the linear, naive Bayes, GLM, tree and MLP
families of the three problem types, the isotonic calibrator and the
external-estimator adapter."""
from .base import (ClassifierModel, PredictionColumn, PredictionModel,
                   Predictor, RegressionModel, check_is_response_values)
from .bayes import NaiveBayes, NaiveBayesModel
from .external import ExternalEstimator, ExternalModel, wrap_estimator
from .glm import GeneralizedLinearRegression, GeneralizedLinearRegressionModel
from .isotonic import (IsotonicRegressionCalibrator,
                       IsotonicRegressionCalibratorModel, pava)
from .linear import (LinearRegression, LinearRegressionModel, LinearSVC,
                     LinearSVCModel, LogisticRegression,
                     LogisticRegressionModel)
from .mlp import (MultilayerPerceptronClassifier,
                  MultilayerPerceptronClassifierModel)
from .trees import (DecisionTreeClassifier, DecisionTreeRegressor,
                    GBTClassifier, GBTClassifierModel,
                    GBTMulticlassClassifierModel, GBTRegressor,
                    GBTRegressorModel, RandomForestClassifier,
                    RandomForestRegressor, TreeEnsembleClassifierModel,
                    TreeEnsembleRegressorModel, XGBoostClassifier,
                    XGBoostRegressor)

__all__ = ["ClassifierModel", "PredictionColumn", "PredictionModel",
           "Predictor", "RegressionModel", "check_is_response_values",
           "NaiveBayes", "NaiveBayesModel",
           "ExternalEstimator", "ExternalModel", "wrap_estimator",
           "GeneralizedLinearRegression", "GeneralizedLinearRegressionModel",
           "IsotonicRegressionCalibrator",
           "IsotonicRegressionCalibratorModel", "pava",
           "LinearRegression", "LinearRegressionModel", "LinearSVC",
           "LinearSVCModel", "LogisticRegression", "LogisticRegressionModel",
           "MultilayerPerceptronClassifier",
           "MultilayerPerceptronClassifierModel",
           "DecisionTreeClassifier", "DecisionTreeRegressor",
           "GBTClassifier", "GBTClassifierModel",
           "GBTMulticlassClassifierModel", "GBTRegressor",
           "GBTRegressorModel", "RandomForestClassifier",
           "RandomForestRegressor", "TreeEnsembleClassifierModel",
           "TreeEnsembleRegressorModel", "XGBoostClassifier",
           "XGBoostRegressor"]
