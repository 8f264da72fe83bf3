"""Every vectorizer family of the port's ``transmogrify`` beyond the
numeric, categorical and text ones (dates, date lists, geolocations, text
lists, every map type) and the bucketizers, against the JAX package on
the CPU (float64).

The same raw values (the testkit's, from seeds) go through each package's
stage, fitted on host columns: the fitted state (fill values, keys,
categories, split points: the constructor arguments a save writes) is
equal, the output is equal with the same vector metadata, and the port's
device kernel (``transform_arrays`` on its own ``encode_input_column``)
equals its host path. Tolerances: bitwise for indicator, one-hot, hash
and count columns and for every host-path output; 1e-12 for the
unit-circle columns of the device kernel (torch's sin and cos against
numpy's; they differ by at most 1.2e-16 here). A fitted stage saved by the JAX
package (its ``stage_to_json``) loads in the port and transforms alike,
infinite split points and nested key dicts included. Last, ``transmogrify``
dispatches every feature type to the same stage class."""
import importlib
import json
import re

import numpy as np
import pytest
import torch

import transmogrifai_tpu.features.builder as jb
import transmogrifai_tpu.features.columns as jc
import transmogrifai_tpu.ops as jops
import transmogrifai_tpu.types as jtypes
import transmogrifai_tpu.workflow.persistence as jp
import transmogrifai_tpu_torch.features.builder as tb
import transmogrifai_tpu_torch.features.columns as tc
import transmogrifai_tpu_torch.ops as tops
import transmogrifai_tpu_torch.types as ttypes
import transmogrifai_tpu_torch.workflow.persistence as tp
from transmogrifai_tpu_torch import testkit as tk
from transmogrifai_tpu_torch.ops.date import TIME_PERIODS

N = 300
#: the transmogrify modules (the packages' ``transmogrify`` function
#: shadows the module's name as an attribute of ``ops``)
jtm = importlib.import_module("transmogrifai_tpu.ops.transmogrify")
ttm = importlib.import_module("transmogrifai_tpu_torch.ops.transmogrify")


def _geo(seed, p_empty=0.15):
    rng = np.random.default_rng(seed)
    return [None if rng.uniform() < p_empty else
            [float(rng.uniform(-60, 60)), float(rng.uniform(-180, 180)),
             float(rng.integers(1, 11))] for _ in range(N)]


def _geo_maps(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N):
        if rng.uniform() < 0.2:
            out.append(None)
            continue
        out.append({f"g{j}": [float(rng.uniform(-60, 60)),
                              float(rng.uniform(-180, 180)),
                              float(rng.integers(1, 11))]
                    for j in range(int(rng.integers(1, 4)))})
    return out


def _take(gen):
    return [v.value for v in gen.take(N)]


def _label(seed):
    rng = np.random.default_rng(seed)
    x = np.asarray(RAW["real"][1], dtype=float)
    return [float(v) for v in
            (np.nan_to_num(x) + 0.5 * rng.normal(size=N) > 0.3)]


#: name -> (feature type name, raw values)
RAW = {
    "when": ("Date", _take(tk.RandomIntegral.dates(seed=1)
                           .with_probability_of_empty(0.2))),
    "at": ("DateTime", _take(tk.RandomIntegral.datetimes(seed=2)
                             .with_probability_of_empty(0.1))),
    "dates": ("DateList", _take(tk.RandomList(
        tk.RandomIntegral.dates(seed=3), min_size=1, max_size=4,
        ftype=ttypes.DateList, seed=4).with_probability_of_empty(0.3))),
    "geo": ("Geolocation", _geo(5)),
    "geo2": ("Geolocation", _geo(6, p_empty=0.0)),
    "nums": ("NumericMap", _take(tk.RandomMap(
        tk.RandomReal.uniform(0, 5, seed=7), ttypes.NumericMap, min_size=1,
        max_size=3, seed=8).with_probability_of_empty(0.2))),
    "counts": ("IntegralMap", _take(tk.RandomMap(
        tk.RandomIntegral.integers(0, 9, seed=9), ttypes.IntegralMap,
        key_prefix="c", max_size=2, seed=10))),
    "flags": ("BinaryMap", _take(tk.RandomMap(
        tk.RandomBinary(0.3, seed=11), ttypes.BinaryMap, key_prefix="f",
        max_size=3, seed=12).with_probability_of_empty(0.1))),
    "words": ("PickListMap", _take(tk.RandomMap(
        tk.RandomText.picklists(["p", "q", "r", "s"], seed=13),
        ttypes.PickListMap, min_size=1, max_size=3, seed=14)
        .with_probability_of_empty(0.2))),
    "notes": ("TextMap", _take(tk.RandomMap(
        tk.RandomText.strings(seed=15), ttypes.TextMap, key_prefix="t",
        min_size=1, max_size=2, seed=16).with_probability_of_empty(0.1))),
    "sets": ("MultiPickListMap", _take(tk.RandomMap(
        tk.RandomSet(["m", "n", "o"], seed=17), ttypes.MultiPickListMap,
        min_size=1, max_size=2, seed=18).with_probability_of_empty(0.2))),
    "whens": ("DateMap", _take(tk.RandomMap(
        tk.RandomIntegral.dates(seed=19), ttypes.DateMap, min_size=1,
        max_size=2, seed=20).with_probability_of_empty(0.2))),
    "places": ("GeolocationMap", _geo_maps(21)),
    "blurb": ("Text", _take(tk.RandomText.strings(seed=22)
                            .with_probability_of_empty(0.1))),
    "toks": ("TextList", _take(tk.RandomList(
        tk.RandomText.picklists(["ab", "cd", "ef", "gh", "ij"], seed=23),
        max_size=4, seed=24))),
    "real": ("Real", _take(tk.RandomReal.normal(0, 2, seed=25)
                           .with_probability_of_empty(0.2))),
    "pos": ("Real", _take(tk.RandomReal.lognormal(0, 1, seed=26))),
    "integral": ("Integral", _take(tk.RandomIntegral.integers(0, 50,
                                                              seed=27))),
}
RAW["label"] = ("RealNN", _label(28))
# a label that key k0 of ``nums`` predicts, for the per-key trees
RAW["key_label"] = ("RealNN", [
    float((m or {}).get("k0", 2.5) + z > 2.5) for m, z in zip(
        RAW["nums"][1], np.random.default_rng(29).normal(0, 0.5, N))])
# a text map with a pivoted key (t0: 4 levels) and a hashed one (t1: ~N)
RAW["mixed"] = ("TextMap", [
    {k: v for k, v in (("t0", next(iter(p.values())) if p else None),
                       ("t1", w)) if v is not None} or None
    for p, w in zip(RAW["words"][1], RAW["blurb"][1])])


def _side(types, columns, builder, names):
    """(features, Dataset) of the raw inputs ``names`` in one package."""
    feats, cols = [], {}
    for n in names:
        ftype = getattr(types, RAW[n][0])
        f = builder.FeatureBuilder.of(n, ftype).extract(
            lambda r, n=n: r[n])
        feats.append(f.as_response() if n.endswith("label")
                     else f.as_predictor())
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
    """The port's device kernel on its encoded inputs (CPU tensors)."""
    arrays = [torch.from_numpy(np.asarray(
        model.encode_input_column(i, ds[f.name])))
        for i, f in enumerate(feats)]
    return model.transform_arrays(arrays)


def _params(stage):
    """The fitted state as its save writes it: constructor arguments,
    ``device`` and ``uid`` aside."""
    return {k: v for k, v in stage.get_params().items()
            if k not in ("uid", "device")}


def _values(col):
    """A column's values: a float64 matrix or vector, or python values."""
    if col.kind in ("numeric", "vector"):
        return np.asarray(col.data, dtype=np.float64)
    return [getattr(v, "value", v) for v in col.data]


#: (id, stage factory taking (ops module, device kwargs), raw inputs,
#: device kernel output holds unit-circle floats)
CASES = [
    *[(f"date-{p}", lambda m, d, p=p: m.DateToUnitCircleVectorizer(p),
       ["when", "at"], True) for p in sorted(TIME_PERIODS)],
    *[(f"date-list-{p}", lambda m, d, p=p: m.DateListVectorizer(pivot=p),
       ["dates"], False) for p in ("SinceFirst", "SinceLast", "ModeDay",
                                   "ModeMonth", "ModeHour")],
    ("date-list-untracked", lambda m, d: m.DateListVectorizer(
        pivot="ModeDay", track_nulls=False), ["dates"], False),
    ("geolocation", lambda m, d: m.GeolocationVectorizer(),
     ["geo", "geo2"], False),
    ("geolocation-untracked", lambda m, d: m.GeolocationVectorizer(
        track_nulls=False), ["geo"], False),
    ("real-map", lambda m, d: m.RealMapVectorizer(), ["nums", "counts"],
     False),
    ("real-map-constant", lambda m, d: m.RealMapVectorizer(
        fill_with_mean=False, fill_value=-1.0, track_nulls=False,
        allow_keys=["k0", "k2"]), ["nums"], False),
    ("binary-map", lambda m, d: m.BinaryMapVectorizer(), ["flags"], False),
    ("text-map-pivot", lambda m, d: m.TextMapPivotVectorizer(
        top_k=3, min_support=5), ["words"], False),
    ("text-map-pivot-untracked", lambda m, d: m.TextMapPivotVectorizer(
        top_k=2, min_support=5, track_nulls=False), ["words"], False),
    ("multipicklist-map", lambda m, d: m.MultiPickListMapVectorizer(
        min_support=5), ["sets"], False),
    ("geolocation-map", lambda m, d: m.GeolocationMapVectorizer(),
     ["places"], False),
    ("smart-text-map", lambda m, d: m.SmartTextMapVectorizer(
        max_cardinality=5, num_hashes=16, min_support=3),
     ["mixed", "words"], False),
    *[(f"date-map-{p}", lambda m, d, p=p: m.DateMapToUnitCircleVectorizer(
        time_period=p), ["whens"], True) for p in ("HourOfDay",
                                                   "MonthOfYear")],
    ("filter-map", lambda m, d: m.FilterMap(allow_keys=["k0", "k1"],
                                            block_keys=["k1"]),
     ["nums"], False),
    ("text-map-len", lambda m, d: m.TextMapLenEstimator(), ["notes"],
     False),
    ("text-map-null", lambda m, d: m.TextMapNullEstimator(
        allow_keys=["t0"]), ["notes"], False),
    ("tokenizer", lambda m, d: m.TextTokenizer(), ["blurb"], False),
    ("tokenizer-options", lambda m, d: m.TextTokenizer(
        min_token_length=6, to_lowercase=False), ["blurb"], False),
    ("text-list-hash", lambda m, d: m.TextListHashVectorizer(
        num_hashes=16), ["toks"], False),
    ("text-list-hash-binary", lambda m, d: m.TextListHashVectorizer(
        num_hashes=4, binary_freq=True, track_nulls=False), ["toks"],
     False),
    ("text-list-null", lambda m, d: m.TextListNullTransformer(), ["toks"],
     False),
    ("bucketize", lambda m, d: m.NumericBucketizer([-2.0, 0.0, 1.5, 4.0]),
     ["real"], False),
    ("bucketize-labels", lambda m, d: m.NumericBucketizer(
        [0.0, 10.0, 25.0, 50.0], bucket_labels=["lo", "mid", "hi"],
        track_nulls=False), ["integral"], False),
    ("auto-bucketize", lambda m, d: m.DecisionTreeNumericBucketizer(**d),
     ["label", "real"], False),
    ("auto-bucketize-deep", lambda m, d: m.DecisionTreeNumericBucketizer(
        max_depth=4, max_bins=16, min_info_gain=0.0, **d),
     ["label", "pos"], False),
    ("auto-bucketize-map", lambda m, d: m.DecisionTreeNumericMapBucketizer(
        **d), ["key_label", "nums"], False),
    ("percentile", lambda m, d: m.PercentileCalibrator(buckets=10),
     ["real"], False),
    ("scaler-linear", lambda m, d: m.ScalerTransformer(
        slope=2.5, intercept=-1.0), ["real"], False),
    ("scaler-log", lambda m, d: m.ScalerTransformer("logarithmic"),
     ["pos"], False),
]
_DEVICE = {jops: {}, tops: {"device": "cpu"}}


@pytest.mark.parametrize("make,names,circle", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_stage_matches_jax(make, names, circle):
    jf, jds = _side(jtypes, jc, jb, names)
    tf, tds = _side(ttypes, tc, tb, names)
    jm, ref = _apply(make(jops, _DEVICE[jops]), jf, jds)
    model, got = _apply(make(tops, _DEVICE[tops]), tf, tds)
    assert type(model).__name__ == type(jm).__name__
    assert _params(model) == _params(jm)
    a, b = _values(ref), _values(got)
    if isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.shape[0] == N
        np.testing.assert_array_equal(b, a)
    else:
        assert got.ftype.__name__ == ref.ftype.__name__ and b == a
    if got.kind == "vector":
        assert _metas(got) == _metas(ref)
    if model.supports_arrays():
        dev = _device_path(model, tf, tds)
        assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float64
        if circle:
            np.testing.assert_allclose(dev.numpy(), b, rtol=0, atol=1e-12)
        else:
            np.testing.assert_array_equal(dev.numpy(), b)


def test_descaler_finds_its_scaler():
    """The descaler inverts the scaler it finds through its second
    input's origin stage, in both packages; without a scaler there it
    raises by name."""
    outs = []
    for types, columns, builder, ops in ((jtypes, jc, jb, jops),
                                         (ttypes, tc, tb, tops)):
        (f,), ds = _side(types, columns, builder, ["pos"])
        scaler = ops.ScalerTransformer("logarithmic").set_input(f)
        scaled = scaler.get_output()
        ds = ds.with_column(scaled.name,
                            scaler.transform_columns([ds["pos"]]))
        descaler = ops.DescalerTransformer().set_input(scaled, scaled)
        outs.append(descaler.transform_columns([ds[scaled.name]] * 2).data)
        if ops is tops:
            with pytest.raises(ValueError, match="ScalerTransformer"):
                ops.DescalerTransformer().set_input(f, f).transform_columns(
                    [ds["pos"]] * 2)
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_allclose(outs[1], RAW["pos"][1], rtol=1e-14)


def test_descaler_survives_save_and_load(tmp_path):
    """A DAG of scaler and descaler saved and reloaded: the descaler
    finds the reloaded scaler through its input's origin stage and gives
    back the raw values."""
    from transmogrifai_tpu_torch.workflow import Workflow
    from transmogrifai_tpu_torch.workflow.persistence import load_model
    x = tb.FeatureBuilder.of("pos", ttypes.Real).extract(
        lambda r: r["pos"]).as_predictor()
    scaled = tops.ScalerTransformer("linear", slope=4.0,
                                    intercept=1.5).set_input(x).get_output()
    back = tops.DescalerTransformer().set_input(scaled,
                                                scaled).get_output()
    records = [{"pos": v} for v in RAW["pos"][1]]
    model = (Workflow(device="cpu").set_result_features(back)
             .set_input_records(records).train())
    path = str(tmp_path / "model")
    model.save(path)
    loaded = load_model(path, device="cpu")
    stage = loaded.result_features[0].origin_stage
    assert type(stage).__name__ == "DescalerTransformer"
    assert type(stage._scaler()).__name__ == "ScalerTransformer"
    assert stage._scaler().slope == 4.0
    got = loaded.score(records)[back.name].data
    np.testing.assert_allclose(got, RAW["pos"][1], rtol=1e-15)


def _jax_fitted(case_id):
    make, names, _ = next(c[1:] for c in CASES if c[0] == case_id)
    jf, jds = _side(jtypes, jc, jb, names)
    model, ref = _apply(make(jops, _DEVICE[jops]), jf, jds)
    return model, ref, names


@pytest.mark.parametrize("case_id", [
    "auto-bucketize", "auto-bucketize-map", "smart-text-map",
    "text-map-pivot", "geolocation-map", "real-map", "date-map-HourOfDay",
    "geolocation", "bucketize-labels", "percentile"])
def test_jax_saved_stage_loads(case_id):
    """A stage fitted and written by the JAX package (``stage_to_json``
    and its arrays) loads in the port: the same class and constructor
    arguments, non-finite split points and per-key dicts included, and
    the same output. The port writes the same document back."""
    jm, ref, names = _jax_fitted(case_id)
    arrays: dict = {}
    doc = json.loads(json.dumps(jp.stage_to_json(jm, arrays)))
    loaded = tp.stage_from_json(doc, arrays, torch.device("cpu"))
    assert type(loaded).__name__ == type(jm).__name__
    assert _params(loaded) == _params(jm)
    tf, tds = _side(ttypes, tc, tb, names)
    loaded.input_features = tuple(tf)
    got = loaded.transform_columns([tds[n] for n in names])
    np.testing.assert_array_equal(_values(got), _values(ref))
    again: dict = {}
    assert json.loads(json.dumps(tp.stage_to_json(loaded, again))) == doc
    if case_id.startswith("auto-bucketize"):
        text = json.dumps(doc)
        assert "-Infinity" in text and "Infinity" in text


def _dispatchable():
    out = []
    for t in ttypes.all_feature_types():
        if issubclass(t, (ttypes.OPVector, ttypes.Prediction)):
            continue
        out.append(t.__name__)
    return sorted(out)


@pytest.mark.parametrize("name", _dispatchable())
def test_transmogrify_dispatches_like_jax(name):
    """Each feature type goes to the stage class the JAX package picks,
    with the same defaults; a type it cannot vectorize raises in both."""
    d_j, d_t = jtm.TransmogrifierDefaults(), ttm.TransmogrifierDefaults()
    try:
        ref = jtm._dispatch_group(getattr(jtypes, name), d_j)
    except TypeError:
        with pytest.raises(TypeError):
            ttm._dispatch_group(getattr(ttypes, name), d_t)
        return
    got = ttm._dispatch_group(getattr(ttypes, name), d_t)
    assert type(got).__name__ == type(ref).__name__
    assert _params(got) == _params(ref)


def test_no_family_left_unported():
    """The port's transmogrify module names no unported part."""
    import inspect
    assert "not_ported" not in inspect.getsource(ttm)


@pytest.mark.parametrize("case_id,names", [
    ("auto-bucketize", ["label", "real"]),
    ("auto-bucketize-map", ["key_label", "nums"])])
def test_tree_bucketizer_fits_on_the_workflow_device(case_id, names):
    """A tree bucketizer given no device fits on the device of the
    workflow that trains it (the CPU here): the JAX package's split
    points, and the stage left without a device after the fit. Outside
    a workflow it needs a card, which is absent here."""
    from transmogrifai_tpu_torch.workflow import Workflow
    jm, _, _ = _jax_fitted(case_id)
    make = next(c[1] for c in CASES if c[0] == case_id)
    feats, ds = _side(ttypes, tc, tb, names)
    stage = make(tops, {})
    out = stage.set_input(*feats).get_output()
    assert stage.device is None
    records = [{n: RAW[n][1][i] for n in names} for i in range(N)]
    model = (Workflow(device="cpu").set_result_features(feats[0], out)
             .set_input_records(records).train())
    fitted = next(s for s in model.stages()
                  if type(s).__name__ == type(jm).__name__)
    assert fitted.split_points == jm.split_points
    assert stage.device is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stage.fit(ds)
