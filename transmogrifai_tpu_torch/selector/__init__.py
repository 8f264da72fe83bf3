"""Model selection of the PyTorch port."""
from .factories import (BinaryClassificationModelSelector,
                        MultiClassificationModelSelector,
                        RegressionModelSelector)
from .selector import (ModelSelector, ModelSelectorSummary, SelectedModel,
                       models_x_folds)
from .racing import RacingCrossValidation, search_compiles
from .random_params import RandomParamBuilder
from .splitters import (DataBalancer, DataCutter, DataSplitter, Splitter,
                        SplitterSummary, stratified_split)
from .validator import (BestEstimator, CrossValidation, TrainValidationSplit,
                        ValidationResult)

__all__ = ["BinaryClassificationModelSelector",
           "MultiClassificationModelSelector", "RegressionModelSelector",
           "ModelSelector", "ModelSelectorSummary", "SelectedModel",
           "DataBalancer", "DataCutter", "DataSplitter",
           "Splitter", "SplitterSummary", "stratified_split", "BestEstimator",
           "CrossValidation", "RacingCrossValidation",
           "TrainValidationSplit", "ValidationResult", "models_x_folds",
           "search_compiles", "RandomParamBuilder"]
