"""Root of the typed feature value hierarchy.

The port's own copy of ``transmogrifai_tpu/types/base.py`` (the type
lattice is pure host Python, shared by both packages in behaviour, not in
code). Reference: features/src/main/scala/com/salesforce/op/features/types/
FeatureType.scala:44. Boxed values exist only at the edges (row-level
scoring, extract functions); bulk data lives in columnar buffers
(``features/columns.py``) that feed torch tensors.

Marker traits from the reference (FeatureType.scala:122-176) are mixin classes:
``NonNullable``, ``SingleResponse``, ``MultiResponse``, ``Categorical``,
``Location``.
"""
from __future__ import annotations

from typing import Any, ClassVar, Iterator

__all__ = [
    "FeatureType", "NonNullable", "SingleResponse", "MultiResponse",
    "Categorical", "Location", "FeatureTypeError", "register_feature_type",
    "feature_type_by_name", "all_feature_types",
]


class FeatureTypeError(TypeError):
    """Raised when a raw value cannot be converted into a feature type."""


_REGISTRY: dict[str, type["FeatureType"]] = {}


def register_feature_type(cls: type["FeatureType"]) -> type["FeatureType"]:
    """Register a concrete feature type by simple name (typeName registry,
    reference FeatureType.scala:267)."""
    _REGISTRY[cls.__name__] = cls
    return cls


def feature_type_by_name(name: str) -> type["FeatureType"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise FeatureTypeError(f"Unknown feature type name: {name!r}") from None


def all_feature_types() -> list[type["FeatureType"]]:
    return list(_REGISTRY.values())


class FeatureType:
    """A typed, possibly-empty feature value.

    Subclasses define ``_convert`` to normalize/validate raw python values.
    ``value`` is the canonical payload; ``None`` encodes an empty value for
    nullable types.
    """

    __slots__ = ("_value",)

    #: nullable unless the NonNullable mixin is present
    is_nullable: ClassVar[bool] = True

    def __init__(self, value: Any = None):
        self._value = self._convert(value)
        if self._value is None and not self.is_nullable:
            raise FeatureTypeError(
                f"{type(self).__name__} cannot be empty (non-nullable)")

    # -- abstract-ish ------------------------------------------------------
    @classmethod
    def _convert(cls, value: Any) -> Any:
        return value

    # -- core API (FeatureType.scala:44-120) -------------------------------
    @property
    def value(self) -> Any:
        return self._value

    @property
    def v(self) -> Any:  # short alias, like the reference's `v`
        return self._value

    @property
    def is_empty(self) -> bool:
        v = self._value
        if v is None:
            return True
        if isinstance(v, (str, dict, list, tuple, set, frozenset)):
            return len(v) == 0
        return False

    @property
    def non_empty(self) -> bool:
        return not self.is_empty

    def exists(self, pred) -> bool:
        return self.non_empty and bool(pred(self._value))

    @classmethod
    def type_name(cls) -> str:
        return cls.__name__

    @classmethod
    def empty(cls) -> "FeatureType":
        """The default (empty) instance
        (reference FeatureTypeDefaults.scala)."""
        return cls(None)

    @classmethod
    def from_any(cls, value: Any) -> "FeatureType":
        """Runtime construction from an arbitrary python value
        (reference FeatureTypeFactory.scala)."""
        if isinstance(value, cls):
            return value
        if isinstance(value, FeatureType):
            value = value.value
        return cls(value)

    # -- dunder ------------------------------------------------------------
    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other) and self._value == other._value

    def __hash__(self) -> int:
        v = self._value
        if isinstance(v, dict):
            v = tuple(sorted(v.items()))
        elif isinstance(v, list):
            v = tuple(v)
        return hash((type(self).__name__, v))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._value!r})"

    def __bool__(self) -> bool:
        return self.non_empty


class NonNullable:
    """Marker: the value can never be empty (FeatureType.scala:122)."""
    is_nullable: ClassVar[bool] = False

    @classmethod
    def empty(cls):  # pragma: no cover - misuse guard
        raise FeatureTypeError(
            f"{cls.__name__} is non-nullable and has no empty instance")


class SingleResponse:
    """Marker: usable as a single-response label (FeatureType.scala:145)."""


class MultiResponse:
    """Marker: usable as a multi-response label (FeatureType.scala:155)."""


class Categorical:
    """Marker: categorical feature (FeatureType.scala:176)."""


class Location:
    """Marker: location-valued feature (FeatureType.scala:140)."""
