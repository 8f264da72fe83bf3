"""Vector column provenance metadata — the framework's metadata spine.

The port's own copy of ``transmogrifai_tpu/utils/vector_meta.py``, the
reference's ``OpVectorMetadata`` /
``OpVectorColumnMetadata`` (features/src/main/scala/com/salesforce/op/utils/
spark/OpVectorMetadata.scala:49, OpVectorColumnMetadata.scala). Every
vectorizer records, per output column: the parent raw feature, its type,
optional grouping (e.g. map key or categorical group), optional indicator
value (one-hot level) and descriptor value (e.g. "sin(HourOfDay)").
SanityChecker, ModelInsights and LOCO all key off this record.

Unlike the reference, metadata travels attached to the in-memory
``FeatureColumn`` rather than hidden in Spark column metadata.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterable, Optional, Sequence

__all__ = ["VectorColumnMetadata", "VectorMetadata", "NULL_INDICATOR",
           "OTHER_INDICATOR"]

#: indicator value used for null-tracking columns
NULL_INDICATOR = "NullIndicatorValue"
#: indicator value used for the one-hot "other" bucket
OTHER_INDICATOR = "OTHER"


@dataclass(frozen=True)
class VectorColumnMetadata:
    """Provenance of a single column in a feature vector."""
    parent_feature_name: str
    parent_feature_type: str
    grouping: Optional[str] = None
    indicator_value: Optional[str] = None
    descriptor_value: Optional[str] = None
    index: int = 0

    @property
    def is_null_indicator(self) -> bool:
        return self.indicator_value == NULL_INDICATOR

    @property
    def is_other_indicator(self) -> bool:
        return self.indicator_value == OTHER_INDICATOR

    def grouping_key(self) -> tuple:
        """Key identifying the indicator group this column belongs to
        (reference OpVectorColumnMetadata.grouping semantics): one-hot
        columns of the same parent+grouping form one categorical group."""
        return (self.parent_feature_name, self.grouping)

    def column_name(self, vector_name: str) -> str:
        parts = [self.parent_feature_name]
        if self.grouping is not None:
            parts.append(self.grouping)
        if self.descriptor_value is not None:
            parts.append(self.descriptor_value)
        if self.indicator_value is not None:
            parts.append(self.indicator_value)
        return "_".join(parts) + f"_{self.index}"

    def to_json(self) -> dict:
        return {
            "parentFeatureName": self.parent_feature_name,
            "parentFeatureType": self.parent_feature_type,
            "grouping": self.grouping,
            "indicatorValue": self.indicator_value,
            "descriptorValue": self.descriptor_value,
            "index": self.index,
        }

    @staticmethod
    def from_json(d: dict) -> "VectorColumnMetadata":
        return VectorColumnMetadata(
            parent_feature_name=d["parentFeatureName"],
            parent_feature_type=d["parentFeatureType"],
            grouping=d.get("grouping"),
            indicator_value=d.get("indicatorValue"),
            descriptor_value=d.get("descriptorValue"),
            index=d.get("index", 0),
        )


@dataclass(frozen=True)
class VectorMetadata:
    """Metadata for a whole feature vector (OpVectorMetadata.scala:49)."""
    name: str
    columns: tuple[VectorColumnMetadata, ...] = ()

    def __post_init__(self):
        # a column already at its index is kept (the records are frozen):
        # per-record scoring rebuilds vectors thousands of columns wide
        object.__setattr__(self, "columns", tuple(
            c if c.index == i else replace(c, index=i)
            for i, c in enumerate(self.columns)))

    @property
    def size(self) -> int:
        return len(self.columns)

    def column_names(self) -> list[str]:
        return [c.column_name(self.name) for c in self.columns]

    def indicator_groups(self) -> dict[tuple, list[int]]:
        """Group column indices by (parent feature, grouping) for columns that
        are categorical indicators — used by SanityChecker's Cramér's V and
        group-aware pruning (reference OpVectorMetadata.getColumnHistory:120)."""
        groups: dict[tuple, list[int]] = {}
        for c in self.columns:
            if c.indicator_value is not None:
                groups.setdefault(c.grouping_key(), []).append(c.index)
        return groups

    def parent_groups(self) -> dict[str, list[int]]:
        """Column indices grouped by parent raw feature name."""
        groups: dict[str, list[int]] = {}
        for c in self.columns:
            groups.setdefault(c.parent_feature_name, []).append(c.index)
        return groups

    def select(self, indices: Sequence[int], name: Optional[str] = None
               ) -> "VectorMetadata":
        """Metadata for a column subset (vector surgery / pruning)."""
        return VectorMetadata(
            name=name or self.name,
            columns=tuple(self.columns[i] for i in indices))

    @staticmethod
    def flatten(name: str, metas: Iterable["VectorMetadata"]
                ) -> "VectorMetadata":
        """Concatenate vector metadatas (OpVectorMetadata.flatten:242)."""
        cols: list[VectorColumnMetadata] = []
        for m in metas:
            cols.extend(m.columns)
        return VectorMetadata(name=name, columns=tuple(cols))

    def to_json(self) -> dict:
        return {"name": self.name,
                "columns": [c.to_json() for c in self.columns]}

    @staticmethod
    def from_json(d: dict) -> "VectorMetadata":
        return VectorMetadata(
            name=d["name"],
            columns=tuple(VectorColumnMetadata.from_json(c)
                          for c in d["columns"]))
