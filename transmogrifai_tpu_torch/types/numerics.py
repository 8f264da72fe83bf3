"""Numeric feature types.

Reference: features/src/main/scala/com/salesforce/op/features/types/Numerics.scala:40-147
and OPNumeric.scala:39. ``Date``/``DateTime`` are integral epoch values
(millis for DateTime, per reference convention).
"""
from __future__ import annotations

import math
import numbers
from typing import Any, Optional

from .base import (FeatureType, FeatureTypeError, NonNullable, SingleResponse,
                   register_feature_type)

__all__ = ["OPNumeric", "Real", "RealNN", "Binary", "Integral", "Percent",
           "Currency", "Date", "DateTime"]


class OPNumeric(FeatureType):
    """Base for numeric types (reference OPNumeric.scala:39)."""
    __slots__ = ()

    def to_double(self) -> Optional[float]:
        v = self.value
        return None if v is None else float(v)


@register_feature_type
class Real(OPNumeric):
    """Optional double (reference Numerics.scala:40)."""
    __slots__ = ()

    @classmethod
    def _convert(cls, value: Any) -> Optional[float]:
        if value is None:
            return None
        if isinstance(value, bool):
            return 1.0 if value else 0.0
        if isinstance(value, numbers.Real):
            f = float(value)
            return None if math.isnan(f) else f
        raise FeatureTypeError(f"Cannot convert {value!r} to {cls.__name__}")


@register_feature_type
class RealNN(NonNullable, Real):
    """Non-nullable real — the canonical label type (Numerics.scala:59)."""
    __slots__ = ()


@register_feature_type
class Binary(SingleResponse, OPNumeric):
    """Optional boolean (Numerics.scala:73)."""
    __slots__ = ()

    @classmethod
    def _convert(cls, value: Any) -> Optional[bool]:
        if value is None:
            return None
        if isinstance(value, bool):
            return value
        if isinstance(value, numbers.Real):
            f = float(value)
            if math.isnan(f):
                return None
            if f in (0.0, 1.0):
                return bool(f)
        raise FeatureTypeError(f"Cannot convert {value!r} to {cls.__name__}")

    def to_double(self) -> Optional[float]:
        v = self.value
        return None if v is None else (1.0 if v else 0.0)


@register_feature_type
class Integral(OPNumeric):
    """Optional long (Numerics.scala:90)."""
    __slots__ = ()

    @classmethod
    def _convert(cls, value: Any) -> Optional[int]:
        if value is None:
            return None
        if isinstance(value, bool):
            return int(value)
        if isinstance(value, numbers.Integral):
            return int(value)
        if isinstance(value, float):
            if math.isnan(value):
                return None
            if value.is_integer():
                return int(value)
        raise FeatureTypeError(f"Cannot convert {value!r} to {cls.__name__}")


@register_feature_type
class Percent(Real):
    """Real subtype for percentages (Numerics.scala:105)."""
    __slots__ = ()


@register_feature_type
class Currency(Real):
    """Real subtype for currency (Numerics.scala:119)."""
    __slots__ = ()


@register_feature_type
class Date(Integral):
    """Epoch time value (Numerics.scala:133)."""
    __slots__ = ()


@register_feature_type
class DateTime(Date):
    """Epoch millis (Numerics.scala:147)."""
    __slots__ = ()
