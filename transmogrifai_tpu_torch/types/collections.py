"""Collection feature types: vectors, lists, sets, geolocation.

Reference: features/src/main/scala/com/salesforce/op/features/types/
{OPVector.scala:41, Lists.scala:38-64, Sets.scala:38, Geolocation.scala:47,130,
OPCollection.scala:37}.

``OPVector`` wraps a 1-D numpy array instead of a Spark ml Vector; the batch
representation is a dense 2-D device matrix (see features/columns.py), so the
boxed form here is only used at row-level scoring edges.
"""
from __future__ import annotations

import math
from typing import Any, Iterable, Optional, Sequence

import numpy as np

from .base import (Categorical, FeatureType, FeatureTypeError, Location,
                   MultiResponse, register_feature_type)

__all__ = ["OPCollection", "OPList", "OPSet", "OPVector", "TextList",
           "DateList", "DateTimeList", "MultiPickList", "Geolocation"]


class OPCollection(FeatureType):
    """Base for collection types (OPCollection.scala:37)."""
    __slots__ = ()


@register_feature_type
class OPVector(OPCollection):
    """Dense numeric vector (OPVector.scala:41). Empty = zero-length array."""
    __slots__ = ()

    @classmethod
    def _convert(cls, value: Any) -> np.ndarray:
        if value is None:
            return np.zeros((0,), dtype=np.float64)
        arr = np.asarray(value, dtype=np.float64)
        if arr.ndim != 1:
            raise FeatureTypeError(f"OPVector requires 1-D data, got {arr.ndim}-D")
        return arr

    @property
    def is_empty(self) -> bool:
        return self._value.size == 0

    def __eq__(self, other: Any) -> bool:
        return (type(self) is type(other)
                and np.array_equal(self._value, other._value))

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._value.tobytes()))

    def combine(self, *others: "OPVector") -> "OPVector":
        """Concatenate vectors (reference RichVectorFeature ``.combine``)."""
        return OPVector(np.concatenate([self._value] + [o._value for o in others]))


class OPList(OPCollection):
    """Base list type (OPList.scala:40)."""
    __slots__ = ()
    _element_convert = staticmethod(lambda x: x)

    @classmethod
    def _convert(cls, value: Any) -> tuple:
        if value is None:
            return ()
        if isinstance(value, (list, tuple)):
            return tuple(cls._element_convert(v) for v in value)
        raise FeatureTypeError(f"Cannot convert {value!r} to {cls.__name__}")

    def __len__(self) -> int:
        return len(self._value)

    def __iter__(self):
        return iter(self._value)


@register_feature_type
class TextList(OPList):
    """List of strings (Lists.scala:38)."""
    __slots__ = ()
    _element_convert = staticmethod(str)


@register_feature_type
class DateList(OPList):
    """List of epoch times (Lists.scala:51)."""
    __slots__ = ()
    _element_convert = staticmethod(int)


@register_feature_type
class DateTimeList(DateList):
    """List of epoch millis (Lists.scala:64)."""
    __slots__ = ()


class OPSet(OPCollection):
    """Base set type (OPSet.scala:39)."""
    __slots__ = ()

    @classmethod
    def _convert(cls, value: Any) -> frozenset:
        if value is None:
            return frozenset()
        if isinstance(value, (set, frozenset, list, tuple)):
            return frozenset(str(v) for v in value)
        raise FeatureTypeError(f"Cannot convert {value!r} to {cls.__name__}")

    def __len__(self) -> int:
        return len(self._value)

    def __iter__(self):
        return iter(self._value)


@register_feature_type
class MultiPickList(Categorical, MultiResponse, OPSet):
    """Multi-select categorical (Sets.scala:38)."""
    __slots__ = ()


@register_feature_type
class Geolocation(Location, OPList):
    """(lat, lon, accuracy) triple (Geolocation.scala:47).

    Accuracy is an integer code (reference GeolocationAccuracy enum,
    Geolocation.scala:130); 0 = unknown.
    """
    __slots__ = ()

    @classmethod
    def _convert(cls, value: Any) -> tuple:
        if value is None:
            return ()
        if isinstance(value, (list, tuple)):
            if len(value) == 0:
                return ()
            if len(value) != 3:
                raise FeatureTypeError(
                    f"Geolocation requires (lat, lon, accuracy), got {value!r}")
            lat, lon, acc = float(value[0]), float(value[1]), float(value[2])
            if math.isnan(lat) or math.isnan(lon):
                return ()
            if not (-90.0 <= lat <= 90.0):
                raise FeatureTypeError(f"Latitude out of range: {lat}")
            if not (-180.0 <= lon <= 180.0):
                raise FeatureTypeError(f"Longitude out of range: {lon}")
            return (lat, lon, acc)
        raise FeatureTypeError(f"Cannot convert {value!r} to Geolocation")

    @property
    def lat(self) -> Optional[float]:
        return self._value[0] if self._value else None

    @property
    def lon(self) -> Optional[float]:
        return self._value[1] if self._value else None

    @property
    def accuracy(self) -> Optional[float]:
        return self._value[2] if self._value else None

    def to_unit_sphere(self) -> Optional[tuple]:
        """(x, y, z) on the unit sphere — used for midpoint aggregation
        (reference Geolocation.scala midpoint via spatial3d)."""
        if not self._value:
            return None
        lat, lon = math.radians(self._value[0]), math.radians(self._value[1])
        return (math.cos(lat) * math.cos(lon),
                math.cos(lat) * math.sin(lon),
                math.sin(lat))

    @staticmethod
    def from_unit_sphere(x: float, y: float, z: float,
                         accuracy: float = 0.0) -> "Geolocation":
        lon = math.degrees(math.atan2(y, x))
        hyp = math.sqrt(x * x + y * y)
        lat = math.degrees(math.atan2(z, hyp))
        return Geolocation((lat, lon, accuracy))
