"""Typed feature value system (45 concrete types): the port's own copy of
``transmogrifai_tpu/types/``.

Reference type hierarchy: features/src/main/scala/com/salesforce/op/features/types/.
"""
from .base import (Categorical, FeatureType, FeatureTypeError, Location,
                   MultiResponse, NonNullable, SingleResponse,
                   all_feature_types, feature_type_by_name,
                   register_feature_type)
from .numerics import (Binary, Currency, Date, DateTime, Integral, OPNumeric,
                       Percent, Real, RealNN)
from .text import (ID, URL, Base64, City, ComboBox, Country, Email, Phone,
                   PickList, PostalCode, State, Street, Text, TextArea)
from .collections import (DateList, DateTimeList, Geolocation, MultiPickList,
                          OPCollection, OPList, OPSet, OPVector, TextList)
from .maps import (Base64Map, BinaryMap, CityMap, ComboBoxMap, CountryMap,
                   CurrencyMap, DateMap, DateTimeMap, EmailMap,
                   GeolocationMap, IDMap, IntegralMap, MultiPickListMap,
                   NumericMap, OPMap, PercentMap, PhoneMap, PickListMap,
                   PostalCodeMap, Prediction, RealMap, StateMap, StreetMap,
                   TextAreaMap, TextMap, URLMap)

from .conversions import *  # noqa: F401,F403
from . import conversions as _conv

__all__ = _conv.__all__ + [  # noqa: F405
    # kernel
    "FeatureType", "FeatureTypeError", "NonNullable", "SingleResponse",
    "MultiResponse", "Categorical", "Location", "register_feature_type",
    "feature_type_by_name", "all_feature_types",
    # numerics
    "OPNumeric", "Real", "RealNN", "Binary", "Integral", "Percent",
    "Currency", "Date", "DateTime",
    # text
    "Text", "Email", "Base64", "Phone", "ID", "URL", "TextArea", "PickList",
    "ComboBox", "Country", "State", "PostalCode", "City", "Street",
    # collections
    "OPCollection", "OPVector", "OPList", "TextList", "DateList",
    "DateTimeList", "OPSet", "MultiPickList", "Geolocation",
    # maps
    "OPMap", "TextMap", "EmailMap", "Base64Map", "PhoneMap", "IDMap",
    "URLMap", "TextAreaMap", "PickListMap", "ComboBoxMap", "BinaryMap",
    "IntegralMap", "NumericMap", "RealMap", "PercentMap", "CurrencyMap",
    "DateMap", "DateTimeMap", "MultiPickListMap", "CountryMap", "StateMap",
    "CityMap", "PostalCodeMap", "StreetMap", "GeolocationMap", "Prediction",
]
