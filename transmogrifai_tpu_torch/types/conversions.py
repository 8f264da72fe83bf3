"""Value → feature-type conversion syntax.

Python equivalent of the reference's implicit enrichment package
(reference: features/src/main/scala/com/salesforce/op/features/types/package.scala:42-152),
whose ``"abc".toText`` / ``1.0.toReal`` / ``Some(2L).toIntegral`` forms
are used throughout extract functions. Here they are plain None-safe
functions — ``to_real(row.get("age"))`` — accepting either a raw value
or another feature-type instance (unwrapped first), so re-typing a
value is the same one call.
"""
from __future__ import annotations

import numbers
from typing import Any, Optional

import numpy as np

from .base import FeatureType, FeatureTypeError
from . import numerics as _n
from . import text as _t
from . import collections as _c

__all__ = [
    "to_text", "to_email", "to_base64", "to_phone", "to_id", "to_url",
    "to_text_area", "to_pick_list", "to_combo_box", "to_country",
    "to_state", "to_postal_code", "to_city", "to_street",
    "to_real", "to_real_nn", "to_currency", "to_percent", "to_integral",
    "to_date", "to_date_time", "to_binary",
    "to_multi_pick_list", "to_text_list", "to_date_list",
    "to_date_time_list", "to_geolocation", "to_op_vector",
]


def _raw(v: Any) -> Any:
    return v.value if isinstance(v, FeatureType) else v


def _make(cls, name: str):
    def convert(v: Any = None):
        return cls(_raw(v))
    convert.__name__ = name
    convert.__doc__ = f"Convert a raw value (or feature) to {cls.__name__}."
    return convert


# text family (StringConversions / OptStringConversions, package.scala:42-73)
to_text = _make(_t.Text, "to_text")
to_email = _make(_t.Email, "to_email")
to_base64 = _make(_t.Base64, "to_base64")
to_phone = _make(_t.Phone, "to_phone")
to_id = _make(_t.ID, "to_id")
to_url = _make(_t.URL, "to_url")
to_text_area = _make(_t.TextArea, "to_text_area")
to_pick_list = _make(_t.PickList, "to_pick_list")
to_combo_box = _make(_t.ComboBox, "to_combo_box")
to_country = _make(_t.Country, "to_country")
to_state = _make(_t.State, "to_state")
to_postal_code = _make(_t.PostalCode, "to_postal_code")
to_city = _make(_t.City, "to_city")
to_street = _make(_t.Street, "to_street")

# numerics (JDouble/JFloat/JInteger/JLong + Option variants, :76-127)
to_real = _make(_n.Real, "to_real")
to_currency = _make(_n.Currency, "to_currency")
to_percent = _make(_n.Percent, "to_percent")
to_integral = _make(_n.Integral, "to_integral")
to_date = _make(_n.Date, "to_date")
to_date_time = _make(_n.DateTime, "to_date_time")

# collections
to_multi_pick_list = _make(_c.MultiPickList, "to_multi_pick_list")
to_text_list = _make(_c.TextList, "to_text_list")
to_date_list = _make(_c.DateList, "to_date_list")
to_date_time_list = _make(_c.DateTimeList, "to_date_time_list")
to_geolocation = _make(_c.Geolocation, "to_geolocation")
to_op_vector = _make(_c.OPVector, "to_op_vector")


def to_real_nn(v: Any = None, default: Optional[float] = None) -> "_n.RealNN":
    """``Option[Double].toRealNN(default)`` (package.scala:103): RealNN
    is non-nullable, so an empty input needs a default (or raises)."""
    v = _raw(v)
    if v is None:
        if default is None:
            raise FeatureTypeError(
                "to_real_nn of an empty value requires a default")
        v = default
    return _n.RealNN(v)


def to_binary(v: Any = None) -> "_n.Binary":
    """Boolean passes through; numbers map to ``v != 0``
    (JDoubleConversions.toBinary, package.scala:106)."""
    v = _raw(v)
    if v is None or isinstance(v, (bool, np.bool_)):
        return _n.Binary(None if v is None else bool(v))
    if isinstance(v, numbers.Real):       # incl. numpy scalars
        return _n.Binary(bool(v != 0))
    return _n.Binary(v)
