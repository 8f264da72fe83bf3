"""Feature DSL enrichments: arithmetic, map, normalize, pivot.

Counterpart of ``transmogrifai_tpu/ops/dsl.py``, the reference DSL
implicit classes
(core/src/main/scala/com/salesforce/op/dsl/{RichNumericFeature.scala,
RichTextFeature.scala, RichFeature.scala}): ``sibSp + parCh + 1``,
``age.fillMissingWithMean().zNormalize()``, ``sex.pivot()``,
``feature.map(fn)``. The arithmetic/normalization transformers run
columnar (NaN propagates missing values exactly like the reference's
empty-Option propagation on numeric binary ops).

Wired onto :class:`~..features.feature.Feature` as dunder operators and
methods (see features/feature.py). Each transformer and fitted model has a
device lowering (``transform_arrays``, torch ops); the estimators fit on
host columns.
"""
from __future__ import annotations

from typing import List, Optional, Type

import numpy as np
import torch

from ..features.columns import FeatureColumn
from ..stages.base import (BinaryTransformer, UnaryEstimator, UnaryModel,
                           UnaryTransformer)
from ..types import FeatureType, OPNumeric, Real, RealNN

__all__ = ["NumericBinaryTransformer", "NumericScalarTransformer",
           "FillMissingWithMean", "FillMissingWithMeanModel",
           "StandardScaler", "StandardScalerModel"]

_OPS = {
    "add": np.add, "sub": np.subtract, "mul": np.multiply,
    "div": np.divide,
}


_TORCH_OPS = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
}


def _arith_kernel(op: str, a, b):
    """Device counterpart of the numpy arithmetic, incl. the inf -> NaN
    missing-propagation rule (a scalar operand is a Python float)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    out = _TORCH_OPS[op](a, b)
    return torch.where(torch.isinf(out), torch.nan, out)


class NumericBinaryTransformer(BinaryTransformer):
    """Elementwise arithmetic of two numeric features; missing (NaN) in
    either operand propagates (reference RichNumericFeature ``/``, ``*``,
    ``+``, ``-`` semantics: empty if either side is empty)."""

    input_types = (OPNumeric, OPNumeric)
    output_type = Real

    def __init__(self, op: str = "add", uid: Optional[str] = None):
        super().__init__(operation_name=op, uid=uid)
        if op not in _OPS:
            raise ValueError(f"Unknown op {op!r}")
        self.op = op

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        a = np.asarray(cols[0].data, dtype=np.float64)
        b = np.asarray(cols[1].data, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = _OPS[self.op](a, b)
        out = np.where(np.isinf(out), np.nan, out)
        return FeatureColumn(ftype=Real, data=out)

    def transform_arrays(self, arrays):
        return _arith_kernel(self.op, arrays[0], arrays[1])


class NumericScalarTransformer(UnaryTransformer):
    """Feature <op> scalar (reference RichNumericFeature scalar ops)."""

    input_types = (OPNumeric,)
    output_type = Real

    def __init__(self, op: str = "add", scalar: float = 0.0,
                 swapped: bool = False, uid: Optional[str] = None):
        super().__init__(operation_name=f"{op}Scalar", uid=uid)
        if op not in _OPS:
            raise ValueError(f"Unknown op {op!r}")
        self.op = op
        self.scalar = float(scalar)
        self.swapped = swapped

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        a = np.asarray(cols[0].data, dtype=np.float64)
        args = (self.scalar, a) if self.swapped else (a, self.scalar)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = _OPS[self.op](*args)
        out = np.where(np.isinf(out), np.nan, out)
        return FeatureColumn(ftype=Real, data=out)

    def transform_arrays(self, arrays):
        a = arrays[0]
        x, y = (self.scalar, a) if self.swapped else (a, self.scalar)
        return _arith_kernel(self.op, x, y)


class AliasTransformer(UnaryTransformer):
    """Identity stage that renames its input feature
    (reference core/.../feature/AliasTransformer.scala)."""

    input_types = (None,)

    def __init__(self, alias: str, output_type: Type[FeatureType] = Real,
                 uid: Optional[str] = None):
        super().__init__(operation_name="alias", uid=uid)
        self.alias = alias
        self.output_type = output_type  # instance attr shadows classvar

    def output_feature_name(self) -> str:
        return self.alias

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        return cols[0]

    def transform_arrays(self, arrays):
        # identity; lowers only when the input is numerically encodable
        # (object-typed aliases fail the plan's encoder probe and run on
        # the host — same rename)
        return arrays[0]


class FillMissingWithMeanModel(UnaryModel):
    input_types = (OPNumeric,)
    output_type = RealNN

    def __init__(self, fill_value: float = 0.0, uid: Optional[str] = None):
        super().__init__(operation_name="fillWithMean", uid=uid)
        self.fill_value = float(fill_value)

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        vals = np.asarray(cols[0].data, dtype=np.float64)
        return FeatureColumn(
            ftype=RealNN, data=np.where(np.isnan(vals), self.fill_value, vals))

    def transform_arrays(self, arrays):
        return torch.where(torch.isnan(arrays[0]), self.fill_value,
                           arrays[0])


class FillMissingWithMean(UnaryEstimator):
    """Real -> RealNN mean imputation (reference
    core/.../feature/FillMissingWithMean.scala)."""

    input_types = (OPNumeric,)
    output_type = RealNN

    def __init__(self, default_value: float = 0.0, uid: Optional[str] = None):
        super().__init__(operation_name="fillWithMean", uid=uid)
        self.default_value = default_value

    def fit_columns(self, cols: List[FeatureColumn]) -> FillMissingWithMeanModel:
        vals = np.asarray(cols[0].data, dtype=np.float64)
        ok = ~np.isnan(vals)
        fill = float(np.mean(vals[ok])) if ok.any() else self.default_value
        return FillMissingWithMeanModel(fill_value=fill)


class StandardScalerModel(UnaryModel):
    input_types = (OPNumeric,)
    output_type = RealNN

    def __init__(self, mean: float = 0.0, std: float = 1.0,
                 uid: Optional[str] = None):
        super().__init__(operation_name="stdScaled", uid=uid)
        self.mean = float(mean)
        self.std = float(std)

    def transform_columns(self, cols: List[FeatureColumn]) -> FeatureColumn:
        vals = np.asarray(cols[0].data, dtype=np.float64)
        std = self.std if self.std > 0 else 1.0
        return FeatureColumn(ftype=RealNN, data=(vals - self.mean) / std)

    def transform_arrays(self, arrays):
        std = self.std if self.std > 0 else 1.0
        return (arrays[0] - self.mean) / std


class StandardScaler(UnaryEstimator):
    """z-normalization (reference OpScalarStandardScaler,
    RichNumericFeature.zNormalize:325)."""

    input_types = (OPNumeric,)
    output_type = RealNN

    def __init__(self, uid: Optional[str] = None):
        super().__init__(operation_name="stdScaled", uid=uid)

    def fit_columns(self, cols: List[FeatureColumn]) -> StandardScalerModel:
        vals = np.asarray(cols[0].data, dtype=np.float64)
        ok = ~np.isnan(vals)
        mean = float(np.mean(vals[ok])) if ok.any() else 0.0
        std = float(np.std(vals[ok])) if ok.any() else 1.0
        return StandardScalerModel(mean=mean, std=std)
