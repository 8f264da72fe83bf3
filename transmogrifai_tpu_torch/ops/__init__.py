"""Feature-engineering stages of the PyTorch port: the vectorizers of every
``transmogrify`` family, the bucketizers, the DSL stages and
``transmogrify`` (counterparts of ``transmogrifai_tpu/ops/``)."""
from .bucketizers import (DecisionTreeNumericBucketizer,
                          DecisionTreeNumericBucketizerModel,
                          DecisionTreeNumericMapBucketizer,
                          DecisionTreeNumericMapBucketizerModel,
                          DescalerTransformer, NumericBucketizer,
                          PercentileCalibrator, PercentileCalibratorModel,
                          ScalerTransformer, ScalingType)
from .categorical import (MultiPickListVectorizer,
                          MultiPickListVectorizerModel, OneHotVectorizer,
                          OneHotVectorizerModel)
from .combiner import VectorsCombiner
from .date import (DateListPivot, DateListVectorizer,
                   DateToUnitCircleVectorizer)
from .dsl import (AliasTransformer, FillMissingWithMean,
                  FillMissingWithMeanModel, NumericBinaryTransformer,
                  NumericScalarTransformer, StandardScaler,
                  StandardScalerModel)
from .geo import GeolocationVectorizer, GeolocationVectorizerModel
from .maps import (BinaryMapVectorizer, DateMapToUnitCircleVectorizer,
                   DateMapToUnitCircleVectorizerModel, FilterMap,
                   GeolocationMapVectorizer, GeolocationMapVectorizerModel,
                   MultiPickListMapVectorizer, RealMapVectorizer,
                   RealMapVectorizerModel, SmartTextMapVectorizer,
                   SmartTextMapVectorizerModel, TextMapLenEstimator,
                   TextMapNullEstimator, TextMapPivotVectorizer,
                   TextMapPivotVectorizerModel)
from .numeric import (BinaryVectorizer, IntegralVectorizer, RealVectorizer,
                      RealVectorizerModel)
from .text import (SmartTextVectorizer, SmartTextVectorizerModel,
                   TextHashVectorizer, TextListHashVectorizer,
                   TextListNullTransformer, TextTokenizer, tokenize)
from .transmogrify import TransmogrifierDefaults, transmogrify

__all__ = [
    "MultiPickListVectorizer", "MultiPickListVectorizerModel",
    "OneHotVectorizer", "OneHotVectorizerModel", "VectorsCombiner",
    "AliasTransformer", "FillMissingWithMean", "FillMissingWithMeanModel",
    "NumericBinaryTransformer", "NumericScalarTransformer", "StandardScaler",
    "StandardScalerModel", "BinaryVectorizer", "IntegralVectorizer",
    "RealVectorizer", "RealVectorizerModel", "SmartTextVectorizer",
    "SmartTextVectorizerModel", "TextHashVectorizer",
    "TextListHashVectorizer", "TextListNullTransformer", "TextTokenizer",
    "tokenize", "TransmogrifierDefaults", "transmogrify",
    "DateToUnitCircleVectorizer", "DateListVectorizer", "DateListPivot",
    "GeolocationVectorizer", "GeolocationVectorizerModel",
    "RealMapVectorizer", "RealMapVectorizerModel", "BinaryMapVectorizer",
    "TextMapPivotVectorizer", "TextMapPivotVectorizerModel",
    "MultiPickListMapVectorizer", "GeolocationMapVectorizer",
    "GeolocationMapVectorizerModel", "SmartTextMapVectorizer",
    "SmartTextMapVectorizerModel", "DateMapToUnitCircleVectorizer",
    "DateMapToUnitCircleVectorizerModel", "FilterMap",
    "TextMapLenEstimator", "TextMapNullEstimator",
    "NumericBucketizer", "DecisionTreeNumericBucketizer",
    "DecisionTreeNumericBucketizerModel", "DecisionTreeNumericMapBucketizer",
    "DecisionTreeNumericMapBucketizerModel", "PercentileCalibrator",
    "PercentileCalibratorModel", "ScalerTransformer", "DescalerTransformer",
    "ScalingType",
]
