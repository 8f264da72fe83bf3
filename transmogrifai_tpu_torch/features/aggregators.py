"""Monoid aggregators for keyed/time-windowed feature extraction.

The port's own copy of ``transmogrifai_tpu/features/aggregators.py``
(host Python, as there), from the reference aggregators
(features/src/main/scala/com/salesforce/op/aggregators/
{MonoidAggregatorDefaults.scala:41,52, Event.scala:44,
TimeBasedAggregator.scala:38,61,70, CustomMonoidAggregator} and the
CutOffTime types): every FeatureType has a default monoid used by
aggregate readers to fold a key's event stream into one value —
numerics sum, text concatenates, sets/lists union, maps merge,
geolocation takes the geographic midpoint.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Type

from ..types import (Binary, FeatureType, Geolocation, MultiPickList,
                     OPList, OPMap, OPNumeric, OPSet, OPVector, Text)

__all__ = ["Event", "CutOffTime", "MonoidAggregator",
           "CustomMonoidAggregator", "SumNumeric", "MinNumeric",
           "MaxNumeric", "MeanNumeric", "LogicalOr", "LogicalAnd",
           "ConcatText", "UnionList", "UnionSet", "UnionMap",
           "GeolocationMidpoint", "LastAggregator", "FirstAggregator",
           "default_aggregator"]


@dataclass(frozen=True)
class Event:
    """A dated raw value (reference Event.scala:44)."""
    date_ms: int
    value: Any
    is_response: bool = False


@dataclass(frozen=True)
class CutOffTime:
    """Predictor/response cutoff (reference CutOffTime types): events at or
    before ``time_ms`` feed predictors; events after feed responses."""
    time_ms: Optional[int] = None

    @staticmethod
    def unix_ms(t: int) -> "CutOffTime":
        return CutOffTime(time_ms=t)

    @staticmethod
    def no_cutoff() -> "CutOffTime":
        return CutOffTime(time_ms=None)


class MonoidAggregator:
    """zero + plus over prepared values; ``prepare`` unboxes, ``present``
    reboxes (reference algebird MonoidAggregator usage)."""

    def prepare(self, value: Any) -> Any:
        return value

    def zero(self) -> Any:
        return None

    def plus(self, a: Any, b: Any) -> Any:
        raise NotImplementedError

    def present(self, acc: Any) -> Any:
        return acc

    def reduce(self, values: List[Any]) -> Any:
        acc = self.zero()
        for v in values:
            if v is None:
                continue
            acc = self.plus(acc, self.prepare(v))
        return self.present(acc)


class _NullSkipping(MonoidAggregator):
    def plus(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return self.combine(a, b)

    def combine(self, a, b):
        raise NotImplementedError


class SumNumeric(_NullSkipping):
    """(reference SumNumeric / SumReal)"""

    def combine(self, a, b):
        return a + b


class MinNumeric(_NullSkipping):
    def combine(self, a, b):
        return min(a, b)


class MaxNumeric(_NullSkipping):
    def combine(self, a, b):
        return max(a, b)


class MeanNumeric(_NullSkipping):
    """(reference MeanDouble — tracked as (sum, count))"""

    def prepare(self, value):
        return (float(value), 1)

    def combine(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def present(self, acc):
        return None if acc is None or acc[1] == 0 else acc[0] / acc[1]


class LogicalOr(_NullSkipping):
    def combine(self, a, b):
        return bool(a or b)


class LogicalAnd(_NullSkipping):
    def combine(self, a, b):
        return bool(a and b)


class ConcatText(_NullSkipping):
    """(reference ConcatTextWithSeparator)"""

    def __init__(self, separator: str = " "):
        self.separator = separator

    def combine(self, a, b):
        return f"{a}{self.separator}{b}"


class UnionList(_NullSkipping):
    def prepare(self, value):
        return list(value)

    def combine(self, a, b):
        return a + b


class UnionSet(_NullSkipping):
    def prepare(self, value):
        return set(value)

    def combine(self, a, b):
        return a | b


class UnionMap(_NullSkipping):
    """Map merge; numeric values under the same key sum, others keep the
    last (reference UnionMap semigroup semantics)."""

    def prepare(self, value):
        return dict(value)

    def combine(self, a, b):
        out = dict(a)
        for k, v in b.items():
            if k in out and isinstance(out[k], (int, float)) \
                    and isinstance(v, (int, float)) \
                    and not isinstance(out[k], bool):
                out[k] = out[k] + v
            else:
                out[k] = v
        return out


class GeolocationMidpoint(_NullSkipping):
    """Geographic midpoint via 3-D unit-vector average
    (reference Geolocation aggregator using lucene spatial3d)."""

    def prepare(self, value):
        lat, lon = math.radians(value[0]), math.radians(value[1])
        acc = value[2] if len(value) > 2 else 1.0
        return [math.cos(lat) * math.cos(lon),
                math.cos(lat) * math.sin(lon),
                math.sin(lat), 1.0, acc]

    def combine(self, a, b):
        return [x + y for x, y in zip(a, b)]

    def present(self, acc):
        if acc is None or acc[3] == 0:
            return None
        x, y, z = (c / acc[3] for c in acc[:3])
        lon = math.degrees(math.atan2(y, x))
        lat = math.degrees(math.atan2(z, math.hypot(x, y)))
        return [lat, lon, acc[4] / acc[3]]


class LastAggregator(MonoidAggregator):
    """Keep the latest non-null event value
    (reference TimeBasedAggregator.scala:61). Requires (date, value)
    prepared tuples — aggregate readers call ``reduce_events``."""

    def reduce_events(self, events: List[Event]) -> Any:
        dated = [e for e in events if e.value is not None]
        return max(dated, key=lambda e: e.date_ms).value if dated else None

    def reduce(self, values: List[Any]) -> Any:
        live = [v for v in values if v is not None]
        return live[-1] if live else None


class FirstAggregator(MonoidAggregator):
    """(reference TimeBasedAggregator.scala:70)"""

    def reduce_events(self, events: List[Event]) -> Any:
        dated = [e for e in events if e.value is not None]
        return min(dated, key=lambda e: e.date_ms).value if dated else None

    def reduce(self, values: List[Any]) -> Any:
        live = [v for v in values if v is not None]
        return live[0] if live else None


class CustomMonoidAggregator(MonoidAggregator):
    """(reference CustomMonoidAggregator)"""

    def __init__(self, zero: Any, combine: Callable[[Any, Any], Any]):
        self._zero = zero
        self._combine = combine

    def zero(self):
        return self._zero

    def plus(self, a, b):
        return self._combine(a, b)


def default_aggregator(ftype: Type[FeatureType]) -> MonoidAggregator:
    """Default monoid per feature type
    (reference MonoidAggregatorDefaults.scala:52)."""
    if issubclass(ftype, Binary):
        return LogicalOr()
    if issubclass(ftype, OPNumeric):
        return SumNumeric()
    if issubclass(ftype, Geolocation):
        return GeolocationMidpoint()
    if issubclass(ftype, (OPSet, MultiPickList)):
        return UnionSet()
    if issubclass(ftype, OPList):
        return UnionList()
    if issubclass(ftype, OPMap):
        return UnionMap()
    if issubclass(ftype, OPVector):
        return LastAggregator()
    if issubclass(ftype, Text):
        return ConcatText()
    return LastAggregator()
