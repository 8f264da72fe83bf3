"""Text feature types: ``Text`` plus 13 semantic subtypes.

Reference: features/src/main/scala/com/salesforce/op/features/types/Text.scala:48-305.
"""
from __future__ import annotations

import base64 as _b64
from typing import Any, Optional

from .base import (Categorical, FeatureType, FeatureTypeError, Location,
                   SingleResponse, register_feature_type)

__all__ = ["Text", "Email", "Base64", "Phone", "ID", "URL", "TextArea",
           "PickList", "ComboBox", "Country", "State", "PostalCode", "City",
           "Street"]


@register_feature_type
class Text(FeatureType):
    """Optional string (reference Text.scala:48).

    Matching the reference, ``Text(Some(""))`` is *non-empty*: only ``None``
    encodes a missing value, so fill rates and null indicators treat the
    empty string as present.
    """
    __slots__ = ()

    @classmethod
    def _convert(cls, value: Any) -> Optional[str]:
        if value is None:
            return None
        if isinstance(value, str):
            return value
        raise FeatureTypeError(f"Cannot convert {value!r} to {cls.__name__}")

    @property
    def is_empty(self) -> bool:
        return self._value is None


class _CoerceNumeric:
    """Mixin for categorical text types: numeric category codes (e.g. CSV
    "pclass" 1/2/3) stringify, as the reference's .toPickList enrichment
    does. Semantic types (Email, URL, ...) stay strict."""

    @classmethod
    def _convert(cls, value: Any) -> Optional[str]:
        if isinstance(value, bool):
            raise FeatureTypeError(
                f"Cannot convert {value!r} to {cls.__name__}")
        if isinstance(value, (int, float)):
            if isinstance(value, float) and value.is_integer():
                return str(int(value))
            return str(value)
        return Text._convert.__func__(cls, value)


@register_feature_type
class Email(Text):
    """Email address (Text.scala:65); exposes prefix/domain accessors."""
    __slots__ = ()

    @property
    def prefix(self) -> Optional[str]:
        p = self._split()
        return p[0] if p else None

    @property
    def domain(self) -> Optional[str]:
        p = self._split()
        return p[1] if p else None

    def _split(self):
        v = self.value
        if not v or v.count("@") != 1:
            return None
        pre, dom = v.split("@")
        return (pre, dom) if pre and dom else None


@register_feature_type
class Base64(Text):
    """Base64-encoded binary (Text.scala:101)."""
    __slots__ = ()

    def as_bytes(self) -> Optional[bytes]:
        if self.is_empty:
            return None
        try:
            return _b64.b64decode(self.value)
        except Exception:
            return None

    def as_string(self) -> Optional[str]:
        b = self.as_bytes()
        if b is None:
            return None
        try:
            return b.decode("utf-8")
        except UnicodeDecodeError:
            return None


@register_feature_type
class Phone(Text):
    """Phone number (Text.scala:139)."""
    __slots__ = ()


@register_feature_type
class ID(_CoerceNumeric, Text):
    """Entity id (Text.scala:153)."""
    __slots__ = ()


@register_feature_type
class URL(Text):
    """URL (Text.scala:167); validity + protocol/domain accessors."""
    __slots__ = ()

    _PROTOCOLS = ("http", "https", "ftp")

    @property
    def is_valid(self) -> bool:
        from urllib.parse import urlparse
        if self.is_empty:
            return False
        try:
            p = urlparse(self.value)
        except ValueError:
            return False
        return p.scheme in self._PROTOCOLS and bool(p.hostname)

    @property
    def domain(self) -> Optional[str]:
        from urllib.parse import urlparse
        if not self.is_valid:
            return None
        return urlparse(self.value).hostname

    @property
    def protocol(self) -> Optional[str]:
        from urllib.parse import urlparse
        if not self.is_valid:
            return None
        return urlparse(self.value).scheme


@register_feature_type
class TextArea(Text):
    """Long free-form text (Text.scala:201)."""
    __slots__ = ()


@register_feature_type
class PickList(_CoerceNumeric, Categorical, SingleResponse, Text):
    """Single-select categorical (Text.scala:215)."""
    __slots__ = ()


@register_feature_type
class ComboBox(_CoerceNumeric, Categorical, Text):
    """Categorical with free-form entry allowed (Text.scala:228)."""
    __slots__ = ()


@register_feature_type
class Country(Location, Text):
    """Country name (Text.scala:242)."""
    __slots__ = ()


@register_feature_type
class State(Location, Text):
    """State name (Text.scala:256)."""
    __slots__ = ()


@register_feature_type
class PostalCode(Location, Text):
    """Postal code (Text.scala:270)."""
    __slots__ = ()


@register_feature_type
class City(Location, Text):
    """City name (Text.scala:284)."""
    __slots__ = ()


@register_feature_type
class Street(Location, Text):
    """Street address (Text.scala:298)."""
    __slots__ = ()
