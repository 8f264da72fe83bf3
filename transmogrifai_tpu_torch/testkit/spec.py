"""Contract spec bases for stage tests.

The port's copy of ``transmogrifai_tpu/testkit/spec.py``, the reference
contract specs
(features/src/main/scala/com/salesforce/op/test/{OpTransformerSpec.scala:51,
OpEstimatorSpec.scala:55, OpPipelineStageSpec.scala}): every stage test
inherits a battery asserting the three core invariants

1. **batch == row**: the columnar path (``transform_columns``) and the
   row-level serving path (``transform_value``) agree on every row,
2. **save/load round-trip**: serializing the (fitted) stage through the
   persistence layer and back yields identical outputs,
3. **params round-trip**: ``get_params`` reconstructs an equivalent stage.

Usage: subclass in a pytest file and implement ``build()``::

    class TestMyVectorizer(StageSpecBase):
        def build(self):
            f = FeatureBuilder.real("x").as_predictor()
            ds = Dataset({"x": FeatureColumn.from_values(Real, [...])})
            return MyVectorizer().set_input(f), ds
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..features.columns import Dataset, FeatureColumn
from ..stages.base import Estimator, Model, PipelineStage, Transformer

__all__ = ["StageSpecBase"]


def _values_equal(a, b) -> bool:
    """Boxed FeatureType equality with float tolerance."""
    va = getattr(a, "value", a)
    vb = getattr(b, "value", b)
    if va is None or vb is None:
        return va is vb
    if isinstance(va, dict) and isinstance(vb, dict):
        return (set(va) == set(vb)
                and all(_values_equal(va[k], vb[k]) for k in va))
    try:
        aa = np.asarray(va, dtype=np.float64)
        bb = np.asarray(vb, dtype=np.float64)
        if aa.shape != bb.shape:
            return False
        return bool(np.allclose(aa, bb, equal_nan=True))
    except (TypeError, ValueError):
        return va == vb


class StageSpecBase:
    """Inherit + implement ``build`` to get the contract battery."""

    #: rows checked in the batch==row comparison (all if fewer)
    n_check_rows = 10

    def build(self) -> Tuple[PipelineStage, Dataset]:
        """Return (stage wired via set_input to features matching the
        dataset columns, dataset)."""
        raise NotImplementedError

    # -- helpers -----------------------------------------------------------
    def _fitted(self) -> Tuple[Transformer, Dataset]:
        stage, ds = self.build()
        if isinstance(stage, Estimator):
            model = stage.fit(ds)
            assert isinstance(model, Model), \
                f"{type(stage).__name__}.fit must return a Model"
            assert model.uid == stage.uid, \
                "fitted model must inherit the estimator uid"
        else:
            model = stage
        return model, ds

    def _input_cols(self, model, ds):
        return [ds[f.name] for f in model.input_features]

    # -- the battery -------------------------------------------------------
    def test_transforms(self):
        model, ds = self._fitted()
        out = model.transform_columns(self._input_cols(model, ds))
        assert isinstance(out, FeatureColumn)
        assert out.n_rows == ds.n_rows
        assert out.ftype is model.output_type or \
            issubclass(out.ftype, model.output_type)

    def test_batch_equals_row(self):
        """(reference OpTransformerSpec: DataFrame path == transformKeyValue
        path)"""
        model, ds = self._fitted()
        cols = self._input_cols(model, ds)
        batch = model.transform_columns(cols)
        n = min(self.n_check_rows, ds.n_rows)
        for i in range(n):
            row_vals = [c.boxed(i) for c in cols]
            row_out = model.transform_value(*row_vals)
            assert _values_equal(batch.boxed(i), row_out), (
                f"row {i}: batch={batch.boxed(i)!r} row={row_out!r}")

    def test_save_load_round_trip(self):
        """(reference OpTransformerSpec save/load assertion)"""
        from ..workflow.persistence import stage_from_json, stage_to_json
        model, ds = self._fitted()
        arrays: dict = {}
        doc = stage_to_json(model, arrays)
        model2 = stage_from_json(doc, arrays)
        assert type(model2) is type(model)
        assert model2.uid == model.uid
        model2.input_features = model.input_features
        model2._output_feature = getattr(model, "_output_feature", None)
        cols = self._input_cols(model, ds)
        out1 = model.transform_columns(cols)
        out2 = model2.transform_columns(cols)
        n = min(self.n_check_rows, ds.n_rows)
        for i in range(n):
            assert _values_equal(out1.boxed(i), out2.boxed(i)), (
                f"row {i} differs after save/load")

    def test_params_round_trip(self):
        stage, _ = self.build()
        params = stage.get_params()
        clone = type(stage)(**params)
        assert clone.get_params() == params
