"""Feature-engineering stages of the PyTorch port: the vectorizers, the
DSL stages and ``transmogrify`` of the Titanic DAG (counterparts of
``transmogrifai_tpu/ops/``)."""
from .categorical import (MultiPickListVectorizer,
                          MultiPickListVectorizerModel, OneHotVectorizer,
                          OneHotVectorizerModel)
from .combiner import VectorsCombiner
from .dsl import (AliasTransformer, FillMissingWithMean,
                  FillMissingWithMeanModel, NumericBinaryTransformer,
                  NumericScalarTransformer, StandardScaler,
                  StandardScalerModel)
from .numeric import (BinaryVectorizer, IntegralVectorizer, RealVectorizer,
                      RealVectorizerModel)
from .text import (SmartTextVectorizer, SmartTextVectorizerModel,
                   TextHashVectorizer, tokenize)
from .transmogrify import TransmogrifierDefaults, transmogrify

__all__ = [
    "MultiPickListVectorizer", "MultiPickListVectorizerModel",
    "OneHotVectorizer", "OneHotVectorizerModel", "VectorsCombiner",
    "AliasTransformer", "FillMissingWithMean", "FillMissingWithMeanModel",
    "NumericBinaryTransformer", "NumericScalarTransformer", "StandardScaler",
    "StandardScalerModel", "BinaryVectorizer", "IntegralVectorizer",
    "RealVectorizer", "RealVectorizerModel", "SmartTextVectorizer",
    "SmartTextVectorizerModel", "TextHashVectorizer", "tokenize",
    "TransmogrifierDefaults", "transmogrify",
]
