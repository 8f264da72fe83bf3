"""Feature-engineering stages of the PyTorch port: the vectorizers of every
``transmogrify`` family, the bucketizers, the DSL stages, the derived-value,
indexing and name-entity stages, the advanced text stages (count
vectorizer, TF-IDF, Word2Vec, LDA) and ``transmogrify`` (counterparts of
``transmogrifai_tpu/ops/``)."""
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
from .derived import (CollectionTransformer, DropIndicesByTransformer,
                      EmailToPickList, JaccardSimilarity, LangDetector,
                      MimeTypeDetector, NGramSimilarity, PhoneNumberParser,
                      TextLenTransformer, ToOccurTransformer, UrlToPickList)
from .dsl import (AliasTransformer, FillMissingWithMean,
                  FillMissingWithMeanModel, NumericBinaryTransformer,
                  NumericScalarTransformer, StandardScaler,
                  StandardScalerModel)
from .geo import GeolocationVectorizer, GeolocationVectorizerModel
from .index import (IndexToString, PredictionDeIndexer, StringIndexer,
                    StringIndexerModel)
from .maps import (BinaryMapVectorizer, DateMapToUnitCircleVectorizer,
                   DateMapToUnitCircleVectorizerModel, FilterMap,
                   GeolocationMapVectorizer, GeolocationMapVectorizerModel,
                   MultiPickListMapVectorizer, RealMapVectorizer,
                   RealMapVectorizerModel, SmartTextMapVectorizer,
                   SmartTextMapVectorizerModel, TextMapLenEstimator,
                   TextMapNullEstimator, TextMapPivotVectorizer,
                   TextMapPivotVectorizerModel)
from .ner import NameEntityRecognizer
from .numeric import (BinaryVectorizer, IntegralVectorizer, RealVectorizer,
                      RealVectorizerModel)
from .text import (SmartTextVectorizer, SmartTextVectorizerModel,
                   TextHashVectorizer, TextListHashVectorizer,
                   TextListNullTransformer, TextTokenizer, tokenize)
from .text_advanced import (LDA, CountVectorizer, CountVectorizerModel,
                            LDAModel, TfIdfVectorizer, TfIdfVectorizerModel,
                            Word2Vec, Word2VecModel)
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
    "ScalingType", "NameEntityRecognizer",
    "StringIndexer", "StringIndexerModel", "IndexToString",
    "PredictionDeIndexer",
    "PhoneNumberParser", "EmailToPickList", "UrlToPickList",
    "MimeTypeDetector", "LangDetector", "TextLenTransformer",
    "NGramSimilarity", "JaccardSimilarity", "ToOccurTransformer",
    "CollectionTransformer", "DropIndicesByTransformer",
    "CountVectorizer", "CountVectorizerModel", "TfIdfVectorizer",
    "TfIdfVectorizerModel", "Word2Vec", "Word2VecModel", "LDA", "LDAModel",
]
