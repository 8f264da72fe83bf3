"""Stage kernel of the PyTorch port (counterpart of
``transmogrifai_tpu/stages/``)."""
from .base import (BinaryEstimator, BinaryModel, BinarySequenceEstimator,
                   BinarySequenceTransformer, BinaryTransformer, Estimator,
                   LambdaTransformer, Model, PipelineStage,
                   QuaternaryTransformer, SequenceEstimator, SequenceModel,
                   SequenceTransformer, TernaryTransformer, Transformer,
                   UnaryEstimator, UnaryModel, UnaryTransformer)

__all__ = [
    "PipelineStage", "Transformer", "Estimator", "Model",
    "UnaryTransformer", "UnaryEstimator", "UnaryModel",
    "BinaryTransformer", "BinaryEstimator", "BinaryModel",
    "TernaryTransformer", "QuaternaryTransformer",
    "SequenceTransformer", "SequenceEstimator", "SequenceModel",
    "BinarySequenceTransformer", "BinarySequenceEstimator",
    "LambdaTransformer",
]
