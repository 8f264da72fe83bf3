"""Transmogrifier: automated feature engineering — pillar #1.

Counterpart of ``transmogrifai_tpu/ops/transmogrify.py`` (reference
core/src/main/scala/com/salesforce/op/stages/impl/feature/
Transmogrifier.scala:91-340): group a heterogeneous bag of typed features
by feature type, dispatch each group to its default vectorizer, and
combine everything into one OPVector via VectorsCombiner. Defaults mirror
``TransmogrifierDefaults`` (Transmogrifier.scala:52): TopK=20,
MinSupport=10, 512 hash features, TrackNulls=true, MaxCardinality=30.

Ported families: Binary, Integral, Real, text (one-hot pivot or
pivot-or-hash) and sets. Dates, geolocations, lists and maps raise until
their vectorizers are ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Type

from ..features.feature import Feature
from ..types import (Binary, Date, DateList, FeatureType, Geolocation,
                     Integral, OPMap, OPSet, OPVector, Real, Text, TextList)
from ..utils.ported import not_ported
from .categorical import MultiPickListVectorizer, OneHotVectorizer
from .combiner import VectorsCombiner
from .numeric import BinaryVectorizer, IntegralVectorizer, RealVectorizer
from .text import SmartTextVectorizer

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
    what = f"transmogrify of a {ftype.__name__} feature"
    if issubclass(ftype, Date):  # Date/DateTime before Integral (subclass)
        raise not_ported(f"{what} (DateToUnitCircleVectorizer)",
                         "ops/date.py")
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
        raise not_ported(f"{what} (GeolocationVectorizer)", "ops/geo.py")
    if issubclass(ftype, DateList):
        raise not_ported(f"{what} (DateListVectorizer)", "ops/date.py")
    if issubclass(ftype, TextList):
        raise not_ported(f"{what} (TextListHashVectorizer)", "ops/text.py")
    if issubclass(ftype, OPMap):
        raise not_ported(f"{what} (the map vectorizers)", "ops/maps.py")
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
