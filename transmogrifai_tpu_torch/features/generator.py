"""Raw-feature origin stage (the port's own copy of
``transmogrifai_tpu/features/generator.py``).

Reference: features/src/main/scala/com/salesforce/op/stages/
FeatureGeneratorStage.scala:61 — a zero-input stage holding the extract
function applied to each raw record, plus an optional monoid aggregator and
time window used by aggregate readers.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Type

from ..types import FeatureType
from .columns import FeatureColumn
from .feature import Feature
from ..stages.base import PipelineStage, _ZeroInput

__all__ = ["FeatureGeneratorStage"]


class FeatureGeneratorStage(PipelineStage, _ZeroInput):
    """Holds ``extract_fn: record -> value`` for one raw feature."""

    def __init__(self, name: str, ftype: Type[FeatureType],
                 extract_fn: Optional[Callable[[Any], Any]] = None,
                 is_response: bool = False,
                 aggregator: Optional[object] = None,
                 aggregate_window_ms: Optional[int] = None,
                 source_name: Optional[str] = None,
                 uid: Optional[str] = None):
        super().__init__(operation_name=f"generate_{name}", uid=uid)
        self.name = name
        self.ftype = ftype
        self.extract_fn = extract_fn or (lambda rec: _dict_get(rec, name))
        self.is_response = is_response
        #: monoid aggregator for keyed/aggregate readers
        #: (reference aggregators/MonoidAggregatorDefaults.scala:41)
        self.aggregator = aggregator
        self.aggregate_window_ms = aggregate_window_ms
        #: which side of a joined reader this feature extracts from
        #: (reference: the reader type parameter of FeatureBuilder[T];
        #: used by readers.joined.JoinedAggregateReaders)
        self.source_name = source_name

    def get_output(self) -> Feature:
        if self._output_feature is None:
            self._output_feature = Feature(
                name=self.name, ftype=self.ftype,
                is_response=self.is_response, origin_stage=self, parents=())
        return self._output_feature

    def extract_column(self, records) -> FeatureColumn:
        """Apply the extract function over records into a column."""
        return FeatureColumn.from_values(
            self.ftype, [self.extract_fn(r) for r in records])


def _dict_get(rec, name):
    if isinstance(rec, dict):
        return rec.get(name)
    return getattr(rec, name, None)
