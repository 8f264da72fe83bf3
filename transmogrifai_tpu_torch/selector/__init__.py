"""Model selection of the PyTorch port."""
from .factories import BinaryClassificationModelSelector
from .selector import (ModelSelector, ModelSelectorSummary, SelectedModel,
                       models_x_folds)
from .racing import RacingCrossValidation, search_compiles
from .splitters import DataBalancer, Splitter, stratified_split
from .validator import (BestEstimator, CrossValidation, TrainValidationSplit,
                        ValidationResult)

__all__ = ["BinaryClassificationModelSelector", "ModelSelector",
           "ModelSelectorSummary", "SelectedModel", "DataBalancer",
           "Splitter", "stratified_split", "BestEstimator",
           "CrossValidation", "RacingCrossValidation",
           "TrainValidationSplit", "ValidationResult", "models_x_folds",
           "search_compiles"]
