"""Transmogrifier: automated feature engineering — pillar #1.

Counterpart of ``transmogrifai_tpu/ops/transmogrify.py`` (reference
core/src/main/scala/com/salesforce/op/stages/impl/feature/
Transmogrifier.scala:91-340): group a heterogeneous bag of typed features
by feature type, dispatch each group to its default vectorizer, and
combine everything into one OPVector via VectorsCombiner. Defaults mirror
``TransmogrifierDefaults`` (Transmogrifier.scala:52): TopK=20,
MinSupport=10, 512 hash features, TrackNulls=true, MaxCardinality=30.

Every family of the JAX package's dispatch: dates, numerics, text (one-hot
pivot or pivot-or-hash), sets, geolocations, date and text lists, and
every map type.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Type

from ..features.feature import Feature
from ..types import (Binary, BinaryMap, Date, DateList, DateMap,
                     FeatureType, Geolocation, GeolocationMap, Integral,
                     MultiPickListMap, OPMap, OPSet, OPVector, Real, Text,
                     TextList, TextMap)
from .categorical import MultiPickListVectorizer, OneHotVectorizer
from .combiner import VectorsCombiner
from .date import DateListVectorizer, DateToUnitCircleVectorizer
from .geo import GeolocationVectorizer
from .maps import (BinaryMapVectorizer, DateMapToUnitCircleVectorizer,
                   GeolocationMapVectorizer, MultiPickListMapVectorizer,
                   RealMapVectorizer, SmartTextMapVectorizer,
                   TextMapPivotVectorizer)
from .numeric import BinaryVectorizer, IntegralVectorizer, RealVectorizer
from .text import SmartTextVectorizer, TextListHashVectorizer

__all__ = ["TransmogrifierDefaults", "transmogrify"]


@dataclass
class TransmogrifierDefaults:
    """Reference Transmogrifier.scala:52."""
    top_k: int = 20
    min_support: int = 10
    num_hashes: int = 512
    track_nulls: bool = True
    max_cardinality: int = 30
    date_time_period: str = "HourOfDay"


#: categorical text subtypes pivoted directly (reference dispatches
#: PickList/ComboBox/ID/Country/State/... to one-hot, Transmogrifier.scala:116)
_PIVOT_TEXT_NAMES = {"PickList", "ComboBox", "ID", "Country", "State",
                     "PostalCode", "City", "Street", "Email", "Phone", "URL"}


def _dispatch_group(ftype: Type[FeatureType],
                    defaults: TransmogrifierDefaults):
    """Default vectorizer stage for a concrete feature type."""
    if issubclass(ftype, Date):  # Date/DateTime before Integral (subclass)
        return DateToUnitCircleVectorizer(
            time_period=defaults.date_time_period)
    if issubclass(ftype, Binary):
        return BinaryVectorizer(track_nulls=defaults.track_nulls)
    if issubclass(ftype, Integral):
        return IntegralVectorizer(track_nulls=defaults.track_nulls)
    if issubclass(ftype, Real):
        return RealVectorizer(track_nulls=defaults.track_nulls)
    if issubclass(ftype, Text):
        if ftype.__name__ in _PIVOT_TEXT_NAMES:
            return OneHotVectorizer(top_k=defaults.top_k,
                                    min_support=defaults.min_support,
                                    track_nulls=defaults.track_nulls)
        return SmartTextVectorizer(
            max_cardinality=defaults.max_cardinality,
            top_k=defaults.top_k, min_support=defaults.min_support,
            num_hashes=defaults.num_hashes,
            track_nulls=defaults.track_nulls)
    if issubclass(ftype, OPSet):
        return MultiPickListVectorizer(top_k=defaults.top_k,
                                       min_support=defaults.min_support,
                                       track_nulls=defaults.track_nulls)
    if issubclass(ftype, Geolocation):
        return GeolocationVectorizer(track_nulls=defaults.track_nulls)
    if issubclass(ftype, DateList):
        return DateListVectorizer(track_nulls=defaults.track_nulls)
    if issubclass(ftype, TextList):
        return TextListHashVectorizer(num_hashes=defaults.num_hashes,
                                      track_nulls=defaults.track_nulls)
    if issubclass(ftype, GeolocationMap):
        return GeolocationMapVectorizer(track_nulls=defaults.track_nulls)
    if issubclass(ftype, MultiPickListMap):
        return MultiPickListMapVectorizer(
            top_k=defaults.top_k, min_support=defaults.min_support,
            track_nulls=defaults.track_nulls)
    if issubclass(ftype, BinaryMap):
        return BinaryMapVectorizer(track_nulls=defaults.track_nulls)
    if issubclass(ftype, TextMap):
        # categorical map subtypes pivot directly; free-text maps get the
        # per-key pivot-or-hash decision (SmartTextMapVectorizer.scala)
        if ftype.__name__.replace("Map", "") in _PIVOT_TEXT_NAMES:
            return TextMapPivotVectorizer(
                top_k=defaults.top_k, min_support=defaults.min_support,
                track_nulls=defaults.track_nulls)
        return SmartTextMapVectorizer(
            max_cardinality=defaults.max_cardinality,
            top_k=defaults.top_k, min_support=defaults.min_support,
            num_hashes=defaults.num_hashes,
            track_nulls=defaults.track_nulls)
    if issubclass(ftype, DateMap):  # before the numeric-map catch-all
        return DateMapToUnitCircleVectorizer(
            time_period=defaults.date_time_period)
    if issubclass(ftype, OPMap):  # numeric/integral maps
        return RealMapVectorizer(track_nulls=defaults.track_nulls)
    raise TypeError(
        f"transmogrify: no default vectorizer for {ftype.__name__}")


def transmogrify(features: Sequence[Feature],
                 defaults: TransmogrifierDefaults = None) -> Feature:
    """Turn typed features into a single OPVector feature
    (reference RichFeaturesCollection.transmogrify, core/.../dsl/
    RichFeaturesCollection.scala:69 -> Transmogrifier.scala:101).
    """
    if not features:
        raise ValueError("transmogrify requires at least one feature")
    defaults = defaults or TransmogrifierDefaults()

    vectors: List[Feature] = []
    groups: Dict[type, List[Feature]] = {}
    for f in features:
        if issubclass(f.ftype, OPVector):
            vectors.append(f)  # already vectorized — pass through
        else:
            groups.setdefault(f.ftype, []).append(f)

    for ftype in sorted(groups, key=lambda t: t.__name__):
        group = groups[ftype]
        stage = _dispatch_group(ftype, defaults)
        vectors.append(stage.set_input(*group).get_output())

    if len(vectors) == 1:
        return vectors[0]
    return VectorsCombiner().set_input(*vectors).get_output()
