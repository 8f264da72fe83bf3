"""The SanityChecker and the RawFeatureFilter of the PyTorch port against the
JAX package's, in float64 on the CPU, on the same numpy inputs: kept
indices, dropped names and reasons equal, every column statistic within
1e-12 of the reference, relative to max(1, |reference|), since the moments
of a column like estimatedCostOfTickets (variance ~2.8e3) differ between
the two packages' reductions in the last bit (NaN where the reference has
NaN), on the JAX package's own checker
cases and on the Titanic DAG's prepared matrix (``synthetic_titanic(891,
seed=5)``, the 668 x 547 matrix of ``tests/test_torch_gbt_titanic.py``)
whole and sampled; the filter's exclusions and distributions equal exactly,
on the JAX cases and on the Titanic raw columns against holdout records;
``rewire_without`` rebuilding the same DAGs; and the checker as a stage
whose output is a predictor."""
import math
import re

import numpy as np
import pytest
import torch

from transmogrifai_tpu.checkers import RawFeatureFilter as JaxRFF
from transmogrifai_tpu.checkers import SanityChecker as JaxChecker
from transmogrifai_tpu.checkers import rewire_without as jax_rewire
from transmogrifai_tpu.features.builder import FeatureBuilder as JaxBuilder
from transmogrifai_tpu.features.columns import Dataset as JaxDataset
from transmogrifai_tpu.features.columns import FeatureColumn as JaxColumn
from transmogrifai_tpu.ops import transmogrify as jax_transmogrify
from transmogrifai_tpu import types as jtypes
from transmogrifai_tpu.utils.vector_meta import VectorMetadata as JaxMeta
from transmogrifai_tpu_torch import types
from transmogrifai_tpu_torch.checkers import (RawFeatureFilter, SanityChecker,
                                              SanityCheckerModel,
                                              rewire_without)
from transmogrifai_tpu_torch.examples import titanic
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.features.columns import Dataset, FeatureColumn
from transmogrifai_tpu_torch.ops import transmogrify
from transmogrifai_tpu_torch.utils.vector_meta import (VectorColumnMetadata,
                                                       VectorMetadata)
from transmogrifai_tpu_torch.workflow import Workflow

#: column statistics of the two packages, relative to max(1, |reference|)
STATS_TOL = 1e-12


def _norm(s):
    """A name with its 12-hex stage uids masked (the two packages count
    uids separately)."""
    return re.sub(r"[0-9a-f]{12}", "UID", s)


def _feats(name, ftype, response=False):
    """The same raw feature in both packages: (jax, port)."""
    out = []
    for builder, mod in ((JaxBuilder, jtypes), (FeatureBuilder, types)):
        b = builder.of(name, getattr(mod, ftype)).extract(
            lambda r, n=name: r.get(n))
        out.append(b.as_response() if response else b.as_predictor())
    return out


def _meta(specs, name="features"):
    """Port metadata from (parent, type, grouping, indicator) specs."""
    if specs is None:
        return None
    return VectorMetadata(name=name, columns=tuple(
        VectorColumnMetadata(parent_feature_name=p, parent_feature_type=t,
                             grouping=g, indicator_value=iv)
        for p, t, g, iv in specs))


def _fit_both(X, y, meta=None, **params):
    """Fit each package's checker on (y, X, meta): (jax model, port model,
    jax output column, port output column)."""
    (jl, pl), (jv, pv) = (_feats("label", "RealNN", True),
                          _feats("features", "OPVector"))
    jmeta = None if meta is None else JaxMeta.from_json(meta.to_json())
    jds = JaxDataset({
        "label": JaxColumn(ftype=jtypes.RealNN, data=np.asarray(y)),
        "features": JaxColumn(ftype=jtypes.OPVector, data=np.asarray(X),
                              metadata=jmeta)})
    pds = Dataset({
        "label": FeatureColumn(types.RealNN, np.asarray(y)),
        "features": FeatureColumn(types.OPVector, torch.as_tensor(X),
                                  meta)})
    jm = JaxChecker(**params).set_input(jl, jv).fit(jds)
    pm = SanityChecker(**params).set_input(pl, pv).fit(pds)
    jout = jm.transform_columns([jds["label"], jds["features"]])
    pout = pm.transform_columns([pds["label"], pds["features"]])
    return jm, pm, jout, pout


def _same_float(a, b):
    if a is None or b is None:
        return a is None and b is None
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return abs(a - b) <= STATS_TOL * max(1.0, abs(a))


def _assert_same_fit(jm, pm, jout, pout):
    assert pm.kept_indices == jm.kept_indices
    assert pm.summary.dropped == jm.summary.dropped
    assert pm.summary.kept_indices == jm.summary.kept_indices
    assert pm.summary.sample_size == jm.summary.sample_size
    assert len(pm.summary.column_stats) == len(jm.summary.column_stats)
    for a, b in zip(jm.summary.column_stats, pm.summary.column_stats):
        assert (b.name, b.column_index, b.is_dropped, b.reasons,
                b.provenance_key()) == \
            (a.name, a.column_index, a.is_dropped, a.reasons,
             a.provenance_key())
        for key in ("variance", "mean", "min", "max", "corr_label",
                    "cramers_v", "max_rule_confidence", "support"):
            assert _same_float(getattr(a, key), getattr(b, key)), \
                (a.name, key, getattr(a, key), getattr(b, key))
    assert isinstance(pout.data, torch.Tensor)     # the gather stays put
    np.testing.assert_array_equal(pout.data.numpy(),
                                  np.asarray(jout.data, dtype=np.float64))
    assert pout.metadata.to_json()["columns"] == \
        jout.metadata.to_json()["columns"]
    assert _norm(pout.metadata.name) == _norm(jout.metadata.name)


def _low_variance():
    rng = np.random.default_rng(0)
    n = 200
    y = (rng.uniform(size=n) < 0.5).astype(float)
    return np.stack([rng.normal(size=n), np.full(n, 3.0)], axis=1), y, \
        None, {}


def _leakage():
    rng = np.random.default_rng(1)
    n = 300
    y = (rng.uniform(size=n) < 0.5).astype(float)
    leaky = y + 0.001 * rng.normal(size=n)
    honest = rng.normal(size=n) + 0.3 * y
    return np.stack([honest, leaky], axis=1), y, None, {}


def _cramers_v():
    rng = np.random.default_rng(2)
    n = 400
    y = (rng.uniform(size=n) < 0.5).astype(float)
    X = np.stack([rng.normal(size=n), (y == 1).astype(float),
                  (y == 0).astype(float)], axis=1)
    meta = _meta([("num", "Real", None, None),
                  ("cat", "PickList", "cat", "a"),
                  ("cat", "PickList", "cat", "b")])
    return X, y, meta, {"max_correlation": 2.0}


def _metadata():
    rng = np.random.default_rng(4)
    n = 200
    y = (rng.uniform(size=n) < 0.5).astype(float)
    X = np.stack([rng.normal(size=n), np.zeros(n), rng.normal(size=n)],
                 axis=1)
    meta = _meta([("a", "Real", None, None), ("b", "Real", None, None),
                  ("c", "Real", None, None)])
    return X, y, meta, {}


def _rule_confidence():
    """A group with a level whose every row has one label (confidence 1)
    and a noise column; min_correlation drops weak columns."""
    rng = np.random.default_rng(6)
    n = 500
    y = (rng.uniform(size=n) < 0.4).astype(float)
    level = rng.integers(0, 3, size=n)
    level[y == 0] = np.where(level[y == 0] == 2, 0, level[y == 0])
    X = np.stack([(level == k).astype(float) for k in range(3)]
                 + [rng.normal(size=n), y * 0.5 + rng.normal(size=n)],
                 axis=1)
    meta = _meta([("c", "PickList", "c", str(k)) for k in range(3)]
                 + [("n", "Real", None, None), ("m", "Real", None, None)])
    return X, y, meta, {"min_correlation": 0.05}


CASES = {"low_variance": _low_variance, "leakage": _leakage,
         "cramers_v_group": _cramers_v, "metadata_after_pruning": _metadata,
         "rule_confidence": _rule_confidence}


@pytest.mark.parametrize("case", sorted(CASES))
def test_checker_cases_match_jax(case):
    X, y, meta, params = CASES[case]()
    jm, pm, jout, pout = _fit_both(X, y, meta, **params)
    _assert_same_fit(jm, pm, jout, pout)
    assert len(pm.kept_indices) < X.shape[1]       # each case prunes


def test_all_dropped_raises_in_both():
    rng = np.random.default_rng(3)
    y = (rng.uniform(size=100) < 0.5).astype(float)
    for pkg in ("jax", "port"):
        with pytest.raises(ValueError, match="dropped every"):
            _fit_both(np.zeros((100, 2)), y) if pkg == "port" else \
                JaxChecker().set_input(
                    *(f[0] for f in (_feats("label", "RealNN", True),
                                     _feats("features", "OPVector")))
                ).fit(JaxDataset({
                    "label": JaxColumn(ftype=jtypes.RealNN, data=y),
                    "features": JaxColumn(ftype=jtypes.OPVector,
                                          data=np.zeros((100, 2)))}))


@pytest.fixture(scope="module")
def titanic_matrix():
    """(X, y, metadata): the port's prepared Titanic training matrix."""
    train, _ = titanic.stratified_split(titanic.synthetic_titanic(891,
                                                                  seed=5))
    label, vector = titanic.build_features()
    model = (Workflow(device="cpu").set_result_features(label, vector)
             .set_input_records(train).train())
    col = model.train_dataset[vector.name]
    y = np.asarray(model.train_dataset[label.name].data, dtype=np.float64)
    return col.data.numpy(), y, col.metadata


@pytest.mark.parametrize("limit", [None, 400])
def test_titanic_matrix_matches_jax(titanic_matrix, limit):
    """The default checker on the Titanic matrix, whole and on a
    ``sample_limit`` sample below its 668 rows: the same sample, kept
    columns, reasons and statistics."""
    X, y, meta = titanic_matrix
    assert X.shape == (668, 547)
    params = {} if limit is None else {"sample_limit": limit}
    jm, pm, jout, pout = _fit_both(X, y, meta, **params)
    _assert_same_fit(jm, pm, jout, pout)
    assert pm.summary.sample_size == (668 if limit is None else limit)
    assert 0 < len(pm.summary.dropped) < 547
    groups = [c for c in pm.summary.column_stats if c.cramers_v is not None]
    assert groups                     # the indicator groups were tested


def test_checker_stage_output_is_a_predictor():
    """AllowLabelAsInput: the checker's output is a response only if every
    input is, so the selector accepts it; its model gathers columns on the
    device and serves a record without reading the label."""
    label = FeatureBuilder.real_nn("y").extract(
        lambda r: r["y"]).as_response()
    x = FeatureBuilder.real("x").extract(lambda r: r["x"]).as_predictor()
    checked = transmogrify([x]).sanity_check(label, min_variance=0.5)
    assert not checked.is_response
    assert isinstance(checked.origin_stage, SanityChecker)
    model = SanityCheckerModel([1], uid="m")
    assert model.get_params()["kept_indices"] == [1]
    X = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    out = model.transform_arrays([torch.full((2,), float("nan")), X])
    assert torch.equal(out, X[:, [1]])
    assert model.transform_value(None, types.OPVector(
        np.array([5.0, 6.0, 7.0]))).value.tolist() == [6.0]


# ---------------------------------------------------------------------------
# raw feature filter
# ---------------------------------------------------------------------------

def _datasets(columns):
    """``{name: (type name, values)}`` as (jax Dataset, port Dataset)."""
    return (JaxDataset({n: JaxColumn.from_values(getattr(jtypes, t), v)
                        for n, (t, v) in columns.items()}),
            Dataset({n: FeatureColumn.from_values(getattr(types, t), v)
                     for n, (t, v) in columns.items()}))


def _rff_case(name):
    rng = np.random.default_rng(7)
    n = 500
    if name == "low_fill":
        cols = {"ok": ("Real", list(rng.normal(size=n))),
                "sparse": ("Real", [None] * (n - 1) + [1.0])}
        return cols, None, {"min_fill": 0.01}
    if name == "numeric_shift":
        return ({"x": ("Real", list(rng.normal(0, 1, size=800)))},
                {"x": ("Real", list(rng.normal(30, 1, size=800)))},
                {"max_js_divergence": 0.5})
    if name == "no_shift":
        return ({"x": ("Real", list(rng.normal(0, 1, size=800)))},
                {"x": ("Real", list(rng.normal(0, 1, size=800)))},
                {"max_js_divergence": 0.5})
    if name == "text_shift":
        return ({"t": ("PickList", ["a"] * 200 + ["b"] * 200)},
                {"t": ("PickList", ["zzz"] * 400)},
                {"max_js_divergence": 0.5})
    if name == "protected":
        return ({"sparse": ("Real", [None] * 99 + [1.0])}, None,
                {"min_fill": 0.5, "protected_features": ("sparse",)})
    if name == "fill_difference":
        return ({"x": ("Real", list(rng.normal(size=300)))},
                {"x": ("Real", [None] * 299 + [1.0])},
                {"max_fill_difference": 0.5})
    raise KeyError(name)


RFF_CASES = ["low_fill", "numeric_shift", "no_shift", "text_shift",
             "protected", "fill_difference"]


@pytest.mark.parametrize("case", RFF_CASES)
def test_rff_cases_match_jax(case):
    train_cols, score_cols, params = _rff_case(case)
    jtrain, ptrain = _datasets(train_cols)
    jscore, pscore = (_datasets(score_cols) if score_cols is not None
                      else (None, None))
    feats = [_feats(n, t) for n, (t, _) in train_cols.items()]
    ref = JaxRFF(**params).compute_exclusions([f[0] for f in feats], jtrain,
                                              jscore)
    got = RawFeatureFilter(**params).compute_exclusions(
        [f[1] for f in feats], ptrain, pscore)
    assert got.to_json() == ref.to_json()
    expect_excluded = {"low_fill": ["sparse"], "numeric_shift": ["x"],
                       "no_shift": [], "text_shift": ["t"],
                       "protected": [], "fill_difference": ["x"]}[case]
    assert got.excluded_names == expect_excluded


def test_rff_titanic_records_match_jax():
    """The default filter over the Titanic DAG's raw features, trained on
    the example's split and scored against its holdout (the name hashed
    into 100 buckets, the numeric histograms, the null-label check)."""
    from examples import titanic as jax_titanic
    records = titanic.synthetic_titanic(600, seed=13)
    train, test = titanic.stratified_split(records)
    label = np.asarray([r["survived"] for r in train], dtype=np.float64)
    out = []
    for pkg, rff in ((jax_titanic, JaxRFF()), (titanic, RawFeatureFilter())):
        y, vec = pkg.build_features()
        raw = sorted({f.uid: f for f in vec.raw_features() + [y]}.values(),
                     key=lambda f: f.name)
        ds_cls = JaxDataset if pkg is jax_titanic else Dataset
        train_ds = ds_cls({f.name: f.origin_stage.extract_column(train)
                           for f in raw})
        test_ds = ds_cls({f.name: f.origin_stage.extract_column(test)
                          for f in raw if not f.is_response})
        out.append(rff.compute_exclusions(raw, train_ds, test_ds,
                                          label=label).to_json())
    assert out[1] == out[0]
    assert len(out[1]["trainDistributions"]) == 10


def test_rewire_without_matches_jax():
    """A sequence stage loses a blacklisted input, an untouched DAG is
    shared as it is, and a fixed-arity stage raises, in both packages."""
    for rewire, tf in ((jax_rewire, jax_transmogrify),
                       (rewire_without, transmogrify)):
        port = rewire is rewire_without
        a, b = (f[1 if port else 0] for f in (_feats("a", "Real"),
                                              _feats("b", "Real")))
        vec = tf([a, b])
        new, removed = rewire([vec], ["b"])
        assert [f.name for f in removed] == ["b"]
        assert [f.name for f in new[0].raw_features()] == ["a"]
        assert (new[0].name, new[0].uid) == (vec.name, vec.uid)
        same, none = rewire([vec], ["zzz"])
        assert same[0] is vec and none == []
        with pytest.raises(ValueError, match="non-sequence"):
            rewire([a + b], ["b"])
