"""Map feature types (String -> V) and the universal ``Prediction`` output type.

Reference: features/src/main/scala/com/salesforce/op/features/types/Maps.scala:38-357.
22 map types keyed by string; ``Prediction`` (Maps.scala:302-357) is a
non-nullable RealMap holding ``prediction`` plus ``rawPrediction_i`` /
``probability_i`` keys — every model in the framework outputs it.
"""
from __future__ import annotations

import math
import numbers
from typing import Any, Dict, Optional

import numpy as np

from .base import (Categorical, FeatureType, FeatureTypeError, Location,
                   MultiResponse, NonNullable, SingleResponse,
                   register_feature_type)

__all__ = [
    "OPMap", "TextMap", "EmailMap", "Base64Map", "PhoneMap", "IDMap",
    "URLMap", "TextAreaMap", "PickListMap", "ComboBoxMap", "BinaryMap",
    "IntegralMap", "RealMap", "PercentMap", "CurrencyMap", "DateMap",
    "DateTimeMap", "MultiPickListMap", "CountryMap", "StateMap", "CityMap",
    "PostalCodeMap", "StreetMap", "GeolocationMap", "Prediction",
]


class OPMap(FeatureType):
    """Base map type (reference OPMap.scala:38). Value is a dict[str, V]."""
    __slots__ = ()
    _value_convert = staticmethod(lambda x: x)

    @classmethod
    def _convert(cls, value: Any) -> Dict[str, Any]:
        if value is None:
            return {}
        if isinstance(value, dict):
            out = {}
            for k, v in value.items():
                cv = cls._value_convert(v)
                if cv is not None:
                    out[str(k)] = cv
            return out
        raise FeatureTypeError(f"Cannot convert {value!r} to {cls.__name__}")

    def __len__(self) -> int:
        return len(self._value)

    def __contains__(self, k) -> bool:
        return k in self._value

    def __getitem__(self, k):
        return self._value[k]

    def get(self, k, default=None):
        return self._value.get(k, default)

    def keys(self):
        return self._value.keys()

    def items(self):
        return self._value.items()


def _to_str(v):
    if v is None:
        return None
    return str(v)


def _to_real(v):
    if v is None:
        return None
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, numbers.Real):
        f = float(v)
        return None if math.isnan(f) else f
    raise FeatureTypeError(f"Cannot convert map value {v!r} to float")


def _to_int(v):
    if v is None:
        return None
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, float) and v.is_integer():
        return int(v)
    raise FeatureTypeError(f"Cannot convert map value {v!r} to int")


def _to_bool(v):
    if v is None:
        return None
    if isinstance(v, bool):
        return v
    if isinstance(v, numbers.Real) and float(v) in (0.0, 1.0):
        return bool(v)
    raise FeatureTypeError(f"Cannot convert map value {v!r} to bool")


def _to_strset(v):
    if v is None:
        return None
    if isinstance(v, (set, frozenset, list, tuple)):
        return frozenset(str(x) for x in v)
    raise FeatureTypeError(f"Cannot convert map value {v!r} to set")


def _to_geo(v):
    from .collections import Geolocation
    if v is None:
        return None
    return Geolocation(v).value or None


@register_feature_type
class TextMap(OPMap):
    """Map of strings (Maps.scala:40)."""
    __slots__ = ()
    _value_convert = staticmethod(_to_str)


@register_feature_type
class EmailMap(TextMap):
    """(Maps.scala:51)"""
    __slots__ = ()


@register_feature_type
class Base64Map(TextMap):
    """(Maps.scala:62)"""
    __slots__ = ()


@register_feature_type
class PhoneMap(TextMap):
    """(Maps.scala:73)"""
    __slots__ = ()


@register_feature_type
class IDMap(TextMap):
    """(Maps.scala:84)"""
    __slots__ = ()


@register_feature_type
class URLMap(TextMap):
    """(Maps.scala:95)"""
    __slots__ = ()


@register_feature_type
class TextAreaMap(TextMap):
    """(Maps.scala:106)"""
    __slots__ = ()


@register_feature_type
class PickListMap(Categorical, TextMap):
    """(Maps.scala:117)"""
    __slots__ = ()


@register_feature_type
class ComboBoxMap(Categorical, TextMap):
    """(Maps.scala:128)"""
    __slots__ = ()


@register_feature_type
class BinaryMap(OPMap):
    """Map of booleans (Maps.scala:139)."""
    __slots__ = ()
    _value_convert = staticmethod(_to_bool)


@register_feature_type
class IntegralMap(OPMap):
    """Map of longs (Maps.scala:152)."""
    __slots__ = ()
    _value_convert = staticmethod(_to_int)


class NumericMap(OPMap):
    """Base for real-valued maps (Maps.scala:49 NumericMap trait)."""
    __slots__ = ()


@register_feature_type
class RealMap(NumericMap):
    """Map of doubles (Maps.scala:165)."""
    __slots__ = ()
    _value_convert = staticmethod(_to_real)


@register_feature_type
class PercentMap(RealMap):
    """(Maps.scala:178)"""
    __slots__ = ()


@register_feature_type
class CurrencyMap(RealMap):
    """(Maps.scala:189)"""
    __slots__ = ()


@register_feature_type
class DateMap(IntegralMap):
    """(Maps.scala:200)"""
    __slots__ = ()


@register_feature_type
class DateTimeMap(DateMap):
    """(Maps.scala:211)"""
    __slots__ = ()


@register_feature_type
class MultiPickListMap(Categorical, MultiResponse, OPMap):
    """Map of string sets (Maps.scala:222)."""
    __slots__ = ()
    _value_convert = staticmethod(_to_strset)


@register_feature_type
class CountryMap(Location, TextMap):
    """(Maps.scala:233)"""
    __slots__ = ()


@register_feature_type
class StateMap(Location, TextMap):
    """(Maps.scala:244)"""
    __slots__ = ()


@register_feature_type
class CityMap(Location, TextMap):
    """(Maps.scala:255)"""
    __slots__ = ()


@register_feature_type
class PostalCodeMap(Location, TextMap):
    """(Maps.scala:266)"""
    __slots__ = ()


@register_feature_type
class StreetMap(Location, TextMap):
    """(Maps.scala:277)"""
    __slots__ = ()


@register_feature_type
class GeolocationMap(Location, OPMap):
    """Map of (lat, lon, accuracy) triples (Maps.scala:288)."""
    __slots__ = ()
    _value_convert = staticmethod(_to_geo)


@register_feature_type
class Prediction(NonNullable, RealMap):
    """Universal model output (Maps.scala:302-357).

    Required key: ``prediction``. Optional vector keys ``rawPrediction_i``
    and ``probability_i``.
    """
    __slots__ = ()

    KEY_PREDICTION = "prediction"
    KEY_RAW = "rawPrediction"
    KEY_PROB = "probability"

    @classmethod
    def _convert(cls, value: Any) -> Dict[str, float]:
        out = super()._convert(value)
        if cls.KEY_PREDICTION not in out:
            raise FeatureTypeError(
                "Prediction must contain a 'prediction' key; got keys "
                f"{sorted(out)}")
        for k in out:
            if k == cls.KEY_PREDICTION:
                continue
            prefix, _, suffix = k.rpartition("_")
            if prefix not in (cls.KEY_RAW, cls.KEY_PROB) \
                    or not suffix.isdigit():
                raise FeatureTypeError(
                    f"Prediction contains invalid key {k!r}; allowed: "
                    "'prediction', 'rawPrediction_<i>', 'probability_<i>' "
                    "(reference Maps.scala:302-357)")
        return out

    @classmethod
    def build(cls, prediction: float, raw_prediction=None,
              probability=None) -> "Prediction":
        d = {cls.KEY_PREDICTION: float(prediction)}
        if raw_prediction is not None:
            for i, rv in enumerate(np.asarray(raw_prediction).ravel()):
                d[f"{cls.KEY_RAW}_{i}"] = float(rv)
        if probability is not None:
            for i, pv in enumerate(np.asarray(probability).ravel()):
                d[f"{cls.KEY_PROB}_{i}"] = float(pv)
        return cls(d)

    def _vector(self, prefix: str) -> np.ndarray:
        items = sorted(
            ((int(k.rsplit("_", 1)[1]), v) for k, v in self._value.items()
             if k.startswith(prefix + "_")),
            key=lambda kv: kv[0])
        return np.asarray([v for _, v in items], dtype=np.float64)

    @property
    def prediction(self) -> float:
        return self._value[self.KEY_PREDICTION]

    @property
    def raw_prediction(self) -> np.ndarray:
        return self._vector(self.KEY_RAW)

    @property
    def probability(self) -> np.ndarray:
        return self._vector(self.KEY_PROB)
