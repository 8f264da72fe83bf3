"""Each ported vectorizer and DSL stage against its JAX counterpart
(float64, CPU): the same raw values, fitted by each package's estimator on
host columns, give the same fitted state, the same output (bitwise; means
and z-scores within 1e-12) and the same column metadata; the port's device
kernel (``transform_arrays`` on the encoded inputs) equals its host path.
Then ``transmogrify``'s column order and matrix over every ported family,
through each package's workflow, and ``tokenize``."""
import re

import numpy as np
import pytest
import torch

import transmogrifai_tpu.features.builder as jb
import transmogrifai_tpu.features.columns as jc
import transmogrifai_tpu.ops as jops
import transmogrifai_tpu.ops.dsl as jdsl
import transmogrifai_tpu.ops.text as jtext
import transmogrifai_tpu.types as jtypes
from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
import transmogrifai_tpu_torch.features.builder as tb
import transmogrifai_tpu_torch.features.columns as tc
import transmogrifai_tpu_torch.ops as tops
import transmogrifai_tpu_torch.ops.dsl as tdsl
import transmogrifai_tpu_torch.ops.text as ttext
import transmogrifai_tpu_torch.types as ttypes
from transmogrifai_tpu_torch.workflow import Workflow

RNG = np.random.default_rng(5)
N = 60


def _reals(p_missing=0.2):
    v = RNG.normal(3.0, 2.0, N)
    return [None if m else float(x)
            for x, m in zip(v, RNG.uniform(size=N) < p_missing)]


def _ints():
    return [None if m else int(x) for x, m in
            zip(RNG.poisson(2.0, N), RNG.uniform(size=N) < 0.15)]


def _bools():
    return [None if m else bool(x) for x, m in
            zip(RNG.uniform(size=N) < 0.4, RNG.uniform(size=N) < 0.1)]


def _picks(cats=("a", "b", "c", "d", "e"), p=(0.4, 0.3, 0.15, 0.1, 0.05)):
    return [None if m else str(x) for x, m in
            zip(RNG.choice(cats, N, p=p), RNG.uniform(size=N) < 0.1)]


def _texts():
    words = ["alpha", "Beta", "gamma!", "δέλτα", "東京都", "x_y", "z"]
    return [None if RNG.uniform() < 0.1 else
            " ".join(RNG.choice(words, int(RNG.integers(1, 5))))
            for _ in range(N)]


def _sets():
    return [None if RNG.uniform() < 0.15 else
            frozenset(RNG.choice(["p", "q", "r", "s"],
                                 int(RNG.integers(0, 3)), replace=False))
            for _ in range(N)]


#: name -> (feature type name, values) of the raw inputs
RAW = {"r1": ("Real", _reals()), "r2": ("Real", _reals(0.0)),
       "k1": ("Integral", _ints()), "k2": ("Integral", _ints()),
       "b1": ("Binary", _bools()), "p1": ("PickList", _picks()),
       "p2": ("PickList", _picks(("u", "v"), (0.7, 0.3))),
       "t1": ("Text", _texts()), "t2": ("Text", _picks()),
       "s1": ("MultiPickList", _sets())}


def _side(types, columns, builder, names):
    """(features, Dataset) of the raw inputs ``names`` in one package."""
    feats, cols = [], {}
    for n in names:
        ftype = getattr(types, RAW[n][0])
        feats.append(builder.FeatureBuilder.of(n, ftype).extract(
            lambda r, n=n: r[n]).as_predictor())
        cols[n] = columns.FeatureColumn.from_values(ftype, RAW[n][1])
    return feats, columns.Dataset(cols)


def _norm(s):
    return None if s is None else re.sub(r"[0-9a-f]{12}", "UID", s)


def _metas(col):
    return [(_norm(c.parent_feature_name), c.parent_feature_type,
             _norm(c.grouping), c.indicator_value, c.descriptor_value)
            for c in col.metadata.columns]


def _apply(stage, feats, ds):
    """Wire, fit if an estimator, and transform on host columns: (fitted
    stage, output column)."""
    stage.set_input(*feats)
    model = stage.fit(ds) if hasattr(stage, "fit") else stage
    return model, model.transform_columns([ds[f.name] for f in feats])


def _device_path(model, feats, ds):
    """The port's device kernel on the encoded inputs (CPU tensors)."""
    arrays = []
    for i, f in enumerate(feats):
        arr = np.asarray(model.encode_input_column(i, ds[f.name]))
        arrays.append(torch.from_numpy(arr))
    return model.transform_arrays(arrays)


#: (id, stage factory taking the ops module, raw inputs, output is float)
CASES = [
    ("real", lambda m: m.RealVectorizer(), ["r1", "r2"], True),
    ("real-constant", lambda m: m.RealVectorizer(fill_with_mean=False,
                                                 fill_value=-1.0,
                                                 track_nulls=False),
     ["r1"], False),
    ("integral", lambda m: m.IntegralVectorizer(), ["k1", "k2"], False),
    ("binary", lambda m: m.BinaryVectorizer(), ["b1"], False),
    ("onehot", lambda m: m.OneHotVectorizer(top_k=3, min_support=2),
     ["p1", "p2"], False),
    ("onehot-untracked-nulls",
     lambda m: m.OneHotVectorizer(top_k=3, min_support=2,
                                  track_nulls=False), ["p1", "p2"], False),
    ("multipicklist", lambda m: m.MultiPickListVectorizer(min_support=3),
     ["s1"], False),
    ("smarttext", lambda m: m.SmartTextVectorizer(max_cardinality=6,
                                                  num_hashes=16,
                                                  min_support=2),
     ["t1", "t2"], False),
    ("texthash", lambda m: m.TextHashVectorizer(num_hashes=8,
                                                binary_freq=True),
     ["t1"], False),
    ("fill-mean", lambda m: m.FillMissingWithMean(), ["r1"], True),
    ("z-normalize", lambda m: m.StandardScaler(), ["r1"], True),
    ("divide", lambda m: m.NumericBinaryTransformer(op="div"),
     ["r1", "k1"], True),
    ("subtract", lambda m: m.NumericBinaryTransformer(op="sub"),
     ["k1", "r2"], True),
    ("scalar-swapped", lambda m: m.NumericScalarTransformer(
        op="div", scalar=2.0, swapped=True), ["k1"], True),
    ("alias", lambda m: m.AliasTransformer(alias="renamed"), ["r1"], False),
]


@pytest.mark.parametrize("make,names,floats",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_stage_matches_jax(make, names, floats):
    jf, jds = _side(jtypes, jc, jb, names)
    tf, tds = _side(ttypes, tc, tb, names)
    _, ref = _apply(make(jops), jf, jds)
    model, got = _apply(make(tops), tf, tds)
    a = np.asarray(ref.data, dtype=np.float64)
    b = np.asarray(got.data, dtype=np.float64)
    assert a.shape == b.shape and a.shape[0] == N
    if floats:
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(b, a)
    if got.kind == "vector":
        assert _metas(got) == _metas(ref)
    if model.supports_arrays():
        dev = _device_path(model, tf, tds)
        assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float64
        np.testing.assert_array_equal(dev.numpy().reshape(b.shape), b)


def test_division_by_zero_is_missing():
    """x / 0 and 0 / 0 are NaN (missing), not +-inf, on both paths."""
    stage = tdsl.NumericBinaryTransformer(op="div")
    a = torch.tensor([1.0, 0.0, -2.0, 3.0])
    b = torch.tensor([0.0, 0.0, 0.0, 2.0])
    out = stage.transform_arrays([a, b])
    assert torch.isnan(out[:3]).all() and out[3] == 1.5
    ref = jdsl.NumericBinaryTransformer(op="div").transform_columns(
        [jc.FeatureColumn(jtypes.Real, a.numpy()),
         jc.FeatureColumn(jtypes.Real, b.numpy())])
    np.testing.assert_array_equal(out.numpy(), ref.data)


def test_untracked_null_one_hot_is_a_zero_row():
    """Index -1 (a missing value with track_nulls=False) one-hots to an
    all-zero row, as jax.nn.one_hot gives it; torch's one_hot would
    raise."""
    model = tops.OneHotVectorizerModel(categories=[["a", "b"]],
                                       track_nulls=False)
    col = tc.FeatureColumn.from_values(ttypes.PickList, ["b", None, "z"])
    idx = model.encode_input_column(0, col)
    assert idx.tolist() == [1, -1, 2]
    out = model.transform_arrays([torch.from_numpy(idx)])
    assert out.tolist() == [[0, 1, 0], [0, 0, 0], [0, 0, 1]]


@pytest.mark.parametrize("text", [
    "Hello, World! hello_world", "东京都 大阪", "a  b\tc", "", None,
    "Ünïcödé ß straße 123abc", "カタカナ and ひらがな", "한국어 텍스트"])
def test_tokenize_matches_jax(text):
    assert ttext.tokenize(text) == jtext.tokenize(text)
    assert ttext.tokenize(text, min_token_length=3, to_lowercase=False) \
        == jtext.tokenize(text, min_token_length=3, to_lowercase=False)


def test_stable_hash_matches_jax():
    from transmogrifai_tpu.ops.vector_utils import stable_hash as jh
    from transmogrifai_tpu_torch.ops.vector_utils import stable_hash as th
    for tok in ["a", "passenger", "東京", "mr", "12345"]:
        for buckets in (7, 512):
            assert th(tok, buckets) == jh(tok, buckets)


def _transmogrified(types, builder, ops, workflow, **kw):
    names = list(RAW)
    feats = [builder.FeatureBuilder.of(n, getattr(types, RAW[n][0]))
             .extract(lambda r, n=n: r[n]).as_predictor() for n in names]
    vec = ops.transmogrify(feats)
    records = [{n: RAW[n][1][i] for n in names} for i in range(N)]
    model = workflow(**kw).set_result_features(vec).set_input_records(
        records).train(**({"validate": "off"}))
    return model.train_dataset[vec.name]


def test_transmogrify_matches_jax():
    """Every ported family through each package's workflow: groups in type
    name order, the same columns, metadata and values."""
    ref = _transmogrified(jtypes, jb, jops, JaxWorkflow)
    got = _transmogrified(ttypes, tb, tops, Workflow, device="cpu")
    assert isinstance(got.data, torch.Tensor)
    assert _metas(got) == _metas(ref)
    parents = [m[1] for m in _metas(got)]
    assert parents.index("Binary") < parents.index("Integral") \
        < parents.index("MultiPickList") < parents.index("PickList") \
        < parents.index("Real") < parents.index("Text")
    a = np.asarray(ref.data, dtype=np.float64)
    np.testing.assert_allclose(got.data.numpy(), a, rtol=1e-12, atol=0)
