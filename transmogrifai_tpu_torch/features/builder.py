"""FeatureBuilder: the user-facing entry point for declaring raw features.

The port's own copy of ``transmogrifai_tpu/features/builder.py``
(reference: features/src/main/scala/com/salesforce/op/features/
FeatureBuilder.scala:47-130). Usage:

    age  = FeatureBuilder.real("age").extract(lambda r: r["age"]).as_predictor()
    y    = FeatureBuilder.real_nn("survived").extract(...).as_response()
    y, xs = FeatureBuilder.from_dataframe(df, response="survived")

``from_dataframe`` (reference FeatureBuilder.fromDataFrame:190-217) infers a
typed feature per column from a pandas DataFrame schema; pandas is
imported only there, so the package runs without it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import numpy as np

from .. import types as T
from ..types import FeatureType
from .feature import Feature
from .generator import FeatureGeneratorStage

__all__ = ["FeatureBuilder", "FeatureBuilderWithExtract", "infer_schema"]


class FeatureBuilderWithExtract:
    """Builder holding name + type + extract fn
    (reference FeatureBuilderWithExtract)."""

    def __init__(self, name: str, ftype: Type[FeatureType],
                 extract_fn: Callable[[Any], Any],
                 aggregator=None, window_ms: Optional[int] = None,
                 source_name: Optional[str] = None):
        self.name = name
        self.ftype = ftype
        self.extract_fn = extract_fn
        self.aggregator = aggregator
        self.window_ms = window_ms
        self.source_name = source_name

    def aggregate(self, aggregator) -> "FeatureBuilderWithExtract":
        """Set the monoid aggregator used by aggregate readers
        (reference FeatureBuilder.aggregate)."""
        self.aggregator = aggregator
        return self

    def window(self, window_ms: int) -> "FeatureBuilderWithExtract":
        self.window_ms = window_ms
        return self

    def from_source(self, source_name: str) -> "FeatureBuilderWithExtract":
        """Bind this feature to one side of a joined reader by name
        (the reference encodes this in FeatureBuilder[T]'s reader type
        parameter; see readers.joined.JoinedAggregateReaders)."""
        self.source_name = source_name
        return self

    def _build(self, is_response: bool) -> Feature:
        stage = FeatureGeneratorStage(
            name=self.name, ftype=self.ftype, extract_fn=self.extract_fn,
            is_response=is_response, aggregator=self.aggregator,
            aggregate_window_ms=self.window_ms,
            source_name=self.source_name)
        return stage.get_output()

    def as_predictor(self) -> Feature:
        return self._build(is_response=False)

    def as_response(self) -> Feature:
        return self._build(is_response=True)


class _FeatureBuilderFor:
    def __init__(self, name: str, ftype: Type[FeatureType]):
        self.name = name
        self.ftype = ftype

    def extract(self, fn: Callable[[Any], Any]) -> FeatureBuilderWithExtract:
        return FeatureBuilderWithExtract(self.name, self.ftype, fn)


def _snake(name: str) -> str:
    import re
    return re.sub(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])",
                  "_", name).lower()


class _FeatureBuilderMeta(type):
    """Generates one entry point per feature type
    (reference FeatureBuilder.scala:51-130 lists all 45)."""

    _lookup: Optional[Dict[str, Type[FeatureType]]] = None

    _lookup_size: int = -1  # registry size when _lookup was built

    @staticmethod
    def _rebuild_lookup() -> Dict[str, Type[FeatureType]]:
        from ..types import all_feature_types
        types = all_feature_types()
        lk: Dict[str, Type[FeatureType]] = {}
        for ft in types:
            lk[_snake(ft.__name__)] = ft
            lk[ft.__name__.lower()] = ft
        _FeatureBuilderMeta._lookup = lk
        _FeatureBuilderMeta._lookup_size = len(types)
        return lk

    def __getattr__(cls, item: str):
        lk = _FeatureBuilderMeta._lookup
        if lk is None:
            lk = _FeatureBuilderMeta._rebuild_lookup()
        ftype = lk.get(item.lower())
        if ftype is None:
            # user-registered feature types may have landed since the cache
            # was built; rebuild only if the registry actually grew (misses
            # on an unchanged registry — hasattr probes, typos — stay cheap)
            from ..types import all_feature_types
            if len(all_feature_types()) != _FeatureBuilderMeta._lookup_size:
                ftype = _FeatureBuilderMeta._rebuild_lookup().get(item.lower())
        if ftype is None:
            raise AttributeError(f"FeatureBuilder has no builder {item!r}")
        return lambda name: _FeatureBuilderFor(name, ftype)


class FeatureBuilder(metaclass=_FeatureBuilderMeta):
    """``FeatureBuilder.<type>(name).extract(fn).as_predictor()``."""

    @staticmethod
    def of(name: str, ftype: Type[FeatureType]) -> _FeatureBuilderFor:
        return _FeatureBuilderFor(name, ftype)

    @staticmethod
    def from_dataframe(df, response: str,
                       response_type: Type[FeatureType] = T.RealNN,
                       schema: Optional[Dict[str, Type[FeatureType]]] = None,
                       ) -> Tuple[Feature, List[Feature]]:
        """Infer one typed feature per DataFrame column
        (reference FeatureBuilder.fromDataFrame:190-217)."""
        inferred = schema or infer_schema(df)
        if response not in df.columns:
            raise ValueError(f"Response column {response!r} not in DataFrame")
        feats: List[Feature] = []
        resp: Optional[Feature] = None
        for name in df.columns:
            ftype = response_type if name == response \
                else inferred.get(name, T.Text)
            builder = FeatureBuilderWithExtract(
                name, ftype, _make_column_extract(name))
            if name == response:
                resp = builder.as_response()
            else:
                feats.append(builder.as_predictor())
        return resp, feats


def _make_column_extract(name: str):
    return lambda rec: rec.get(name) if isinstance(rec, dict) \
        else getattr(rec, name, None)


def infer_schema(df, categorical_max_card: int = 100
                 ) -> Dict[str, Type[FeatureType]]:
    """Pandas dtype -> feature type inference. Low-cardinality strings map
    to PickList, integer {0,1} to Binary (mirrors the intent of the
    reference's CSV auto-readers, readers/.../CSVAutoReaders.scala)."""
    import pandas as pd
    out: Dict[str, Type[FeatureType]] = {}
    for name in df.columns:
        s = df[name]
        dt = s.dtype
        if pd.api.types.is_bool_dtype(dt):
            out[name] = T.Binary
        elif pd.api.types.is_integer_dtype(dt) or pd.api.types.is_float_dtype(dt):
            vals = s.dropna().unique()
            if len(vals) <= 2 and set(np.asarray(vals, dtype=float)) <= {0.0, 1.0}:
                out[name] = T.Binary
            elif pd.api.types.is_integer_dtype(dt):
                out[name] = T.Integral
            else:
                out[name] = T.Real
        elif pd.api.types.is_datetime64_any_dtype(dt):
            out[name] = T.DateTime
        else:
            non_null = s.dropna()
            nunique = non_null.nunique()
            if 0 < nunique <= min(categorical_max_card,
                                  max(2, len(non_null) // 2)):
                out[name] = T.PickList
            else:
                out[name] = T.Text
    return out
