"""The PyTorch port's ingestion (``features/aggregators.py``, ``readers/``,
``utils/avro_io.py``, ``examples/dataprep.py``) against the JAX package
on the same seeded records:

- every aggregator on the JAX package's own cases;
- aggregate and conditional readers: keys in the same order and every
  column bitwise equal, with events exactly at the cutoff and at
  cutoff ± window;
- the CSV, CSV-auto, Avro, Parquet and DataFrame paths; Avro bytes equal
  under both codecs, each package reading the other's files;
- the joined readers' null against zero rule, and their refusals;
- streaming batches and a short directory tail;
- a workflow trained through an aggregate-joined reader on 300 keys (LR
  and a 5-round GBT): metric matrices within 1e-12, the same winner, and
  label-free scoring through a reader with both engines; the raw feature
  filter's scoring data through a reader;
- the README's Quick start with the port's imports on a seeded CSV."""
import filecmp
import json
import os
import threading
import time

import numpy as np
import pytest

import transmogrifai_tpu.features.aggregators as jagg
import transmogrifai_tpu.readers as jreaders
import transmogrifai_tpu.types as jtypes
import transmogrifai_tpu.utils.avro_io as javro
from transmogrifai_tpu.features.builder import FeatureBuilder as JaxBuilder
from transmogrifai_tpu.features.columns import Dataset as JaxDataset
import transmogrifai_tpu_torch.features.aggregators as tagg
import transmogrifai_tpu_torch.readers as treaders
import transmogrifai_tpu_torch.types as ttypes
import transmogrifai_tpu_torch.utils.avro_io as tavro
from transmogrifai_tpu_torch.examples import dataprep
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.features.columns import Dataset

JAX = (JaxBuilder, jtypes, jagg, jreaders)
PORT = (FeatureBuilder, ttypes, tagg, treaders)
CUTOFF = 1_000
WINDOW = 100


# ---------------------------------------------------------------------------
# aggregators
# ---------------------------------------------------------------------------

def _geo(agg):
    return agg.GeolocationMidpoint().reduce([[0.0, 0.0, 1.0],
                                             [0.0, 90.0, 1.0]])


AGGREGATOR_CASES = {
    "sum": lambda a: a.SumNumeric().reduce([1.0, None, 2.5]),
    "sum-empty": lambda a: a.SumNumeric().reduce([None, None]),
    "mean": lambda a: a.MeanNumeric().reduce([1.0, 2.0, None, 6.0]),
    "min": lambda a: a.MinNumeric().reduce([3, 9, 4]),
    "max": lambda a: a.MaxNumeric().reduce([3, 9, 4]),
    "or": lambda a: a.LogicalOr().reduce([False, None, True]),
    "and": lambda a: a.LogicalAnd().reduce([True, None, False]),
    "concat": lambda a: a.ConcatText(",").reduce(["a", None, "b"]),
    "union-list": lambda a: a.UnionList().reduce([["a"], None, ["b", "a"]]),
    "union-set": lambda a: a.UnionSet().reduce([{"a"}, {"b"}, None]),
    "union-map": lambda a: a.UnionMap().reduce([{"x": 1.0},
                                                {"x": 2.0, "y": "s"}]),
    "geolocation": _geo,
    "last": lambda a: a.LastAggregator().reduce_events(
        [a.Event(30, "c"), a.Event(10, "a"), a.Event(20, "b")]),
    "first": lambda a: a.FirstAggregator().reduce_events(
        [a.Event(30, "c"), a.Event(10, "a"), a.Event(20, "b")]),
    "last-tie": lambda a: a.LastAggregator().reduce_events(
        [a.Event(30, "c"), a.Event(30, "d"), a.Event(None and 0, None)]),
    "custom": lambda a: a.CustomMonoidAggregator(
        1.0, lambda x, y: x * y).reduce([2.0, None, 3.0]),
}


@pytest.mark.parametrize("case", sorted(AGGREGATOR_CASES))
def test_aggregators(case):
    assert AGGREGATOR_CASES[case](tagg) == AGGREGATOR_CASES[case](jagg)


@pytest.mark.parametrize("ftype", ["Real", "RealNN", "Integral", "Binary",
                                   "Text", "PickList", "MultiPickList",
                                   "TextList", "RealMap", "Geolocation",
                                   "OPVector", "Date"])
def test_default_aggregator(ftype):
    assert type(tagg.default_aggregator(getattr(ttypes, ftype))).__name__ \
        == type(jagg.default_aggregator(getattr(jtypes, ftype))).__name__


# ---------------------------------------------------------------------------
# aggregate and conditional readers
# ---------------------------------------------------------------------------

def _event_records(n_users=40, seed=3):
    """Dated events of every field kind; each user has one event exactly
    at the cutoff and at cutoff - WINDOW and cutoff + WINDOW."""
    rng = np.random.default_rng(seed)
    out = []
    for u in range(n_users):
        times = list(rng.integers(CUTOFF - 3 * WINDOW, CUTOFF + 3 * WINDOW,
                                  rng.integers(1, 7)))
        times += [CUTOFF, CUTOFF - WINDOW, CUTOFF + WINDOW][:u % 4]
        for t in times:
            out.append({
                "user": f"u{u % 13}-{u}" if u % 5 else u,   # int keys too
                "t": int(t),
                "amount": None if rng.uniform() < 0.2
                else float(np.round(rng.gamma(2.0, 3.0), 3)),
                "clicked": bool(rng.uniform() < 0.4),
                "label": float(rng.uniform() < 0.5),
                "campaign": str(rng.choice(["a", "b", "c"])),
                "tags": [str(x) for x in rng.choice(["x", "y", "z"],
                                                    rng.integers(0, 3))],
                "note": str(rng.choice(["hi", "yo", "ok"])),
                "lat": float(rng.uniform(-60, 60)),
                "lon": float(rng.uniform(-170, 170)),
                "counts": {"k": float(rng.integers(0, 3))},
                "target": bool(rng.uniform() < 0.2),
            })
    return out


def _features(pkg, windows=True):
    """One feature per aggregator and field kind, predictors and
    responses, with and without their own windows."""
    B, T, A, _ = pkg

    def f(name, ftype, fn, agg=None, window=None, response=False):
        b = B.of(name, getattr(T, ftype)).extract(fn)
        if agg is not None:
            b = b.aggregate(agg)
        if window is not None and windows:
            b = b.window(window)
        return b.as_response() if response else b.as_predictor()
    return [
        f("amount", "Real", lambda r: r["amount"]),
        f("amountWin", "Real", lambda r: r["amount"], A.SumNumeric(),
          WINDOW),
        f("amountNN", "RealNN", lambda r: r["amount"], A.SumNumeric(),
          WINDOW),
        f("meanAmount", "Real", lambda r: r["amount"], A.MeanNumeric()),
        f("clicked", "Binary", lambda r: r["clicked"]),
        f("lastCampaign", "PickList", lambda r: r["campaign"],
          A.LastAggregator(), WINDOW),
        f("firstCampaign", "PickList", lambda r: r["campaign"],
          A.FirstAggregator()),
        f("tags", "MultiPickList", lambda r: r["tags"]),
        f("notes", "Text", lambda r: r["note"], None, WINDOW),
        f("where", "Geolocation", lambda r: [r["lat"], r["lon"], 1.0]),
        f("counts", "RealMap", lambda r: r["counts"]),
        f("label", "RealNN", lambda r: r["label"], A.MaxNumeric(),
          WINDOW, response=True),
        f("labelOpen", "Real", lambda r: r["label"], A.SumNumeric(),
          response=True),
    ]


def _column_values(col):
    if col.kind == "numeric":
        return np.asarray(col.data, dtype=np.float64)
    return list(col.data)


def _assert_same_dataset(port, jax):
    assert port.column_names == jax.column_names
    assert getattr(port, "keys", None) == getattr(jax, "keys", None)
    for name in jax.column_names:
        a, b = port[name], jax[name]
        assert a.ftype.__name__ == b.ftype.__name__, name
        va, vb = _column_values(a), _column_values(b)
        if isinstance(va, np.ndarray):
            assert np.array_equal(va, vb, equal_nan=True), name
            assert np.array_equal(np.signbit(va), np.signbit(vb)), name
        else:
            assert va == vb, name


def _aggregate_reader(pkg, records, **kw):
    return pkg[3].AggregateDataReader(
        records=records, key_fn=lambda r: r["user"],
        timestamp_fn=lambda r: r["t"], **kw)


@pytest.mark.parametrize("kind", ["cutoff", "cutoff-response-window",
                                  "no-feature-windows", "no-cutoff"])
def test_aggregate_reader_equals_jax(kind):
    records = _event_records()
    ds = []
    for pkg in (PORT, JAX):
        kw = {}
        if kind != "no-cutoff":
            kw["cutoff_time"] = pkg[2].CutOffTime.unix_ms(CUTOFF)
        if kind == "cutoff-response-window":
            kw["response_window_ms"] = WINDOW // 2
        reader = _aggregate_reader(pkg, records, **kw)
        ds.append(reader.generate_dataset(
            _features(pkg, windows=kind != "no-feature-windows")))
    _assert_same_dataset(*ds)
    # keys sorted as strings, int keys included
    assert ds[0].keys == sorted(ds[0].keys) and "0" in ds[0].keys


def test_aggregate_window_boundaries():
    """An event at cutoff - window is a predictor, one at the cutoff a
    response, one at cutoff + window a response; one just past either
    bound is neither."""
    recs = [{"user": "a", "t": t, "amount": float(v), "label": float(v)}
            for t, v in ((CUTOFF - WINDOW - 1, 1), (CUTOFF - WINDOW, 2),
                         (CUTOFF - 1, 4), (CUTOFF, 8), (CUTOFF + WINDOW, 16),
                         (CUTOFF + WINDOW + 1, 32))]
    for pkg in (PORT, JAX):
        B, T, A, R = pkg
        x = B.of("x", T.Real).extract(lambda r: r["amount"]).window(
            WINDOW).as_predictor()
        y = B.of("y", T.Real).extract(lambda r: r["label"]).aggregate(
            A.SumNumeric()).window(WINDOW).as_response()
        ds = _aggregate_reader(pkg, recs, cutoff_time=A.CutOffTime.unix_ms(
            CUTOFF)).generate_dataset([x, y])
        assert ds["x"].data[0] == 6.0 and ds["y"].data[0] == 24.0


@pytest.mark.parametrize("drop", [True, False])
def test_conditional_reader_equals_jax(drop):
    records = _event_records(seed=5)
    ds = []
    for pkg in (PORT, JAX):
        reader = pkg[3].ConditionalDataReader(
            records=records, key_fn=lambda r: r["user"],
            timestamp_fn=lambda r: r["t"],
            target_condition=lambda r: r["target"],
            response_window_ms=WINDOW, predictor_window_ms=2 * WINDOW,
            drop_if_no_target=drop)
        ds.append(reader.generate_dataset(_features(pkg)))
    _assert_same_dataset(*ds)
    assert len(ds[0].keys) > 0


def test_dataprep_pipelines_equal_jax():
    """The reference's two data-prep pipelines (``examples/dataprep.py``)
    on a seeded log: the port's rows equal the same readers' rows in the
    JAX package."""
    sends, clicks = dataprep.synthetic_event_log(60, seed=2, days=10)
    cutoff = dataprep.START_MS + 6 * dataprep.DAY_MS
    rows = dataprep.joins_and_aggregates(sends, clicks, cutoff,
                                         device="cpu")
    day = dataprep.DAY_MS
    B, T, A, R = JAX
    cyd = (B.real("numClicksYday").extract(lambda c: 1.0)
           .aggregate(A.SumNumeric()).window(day).from_source("clicks")
           .as_predictor())
    slw = (B.real("numSendsLastWeek").extract(lambda s: 1.0)
           .aggregate(A.SumNumeric()).window(7 * day).from_source("sends")
           .as_predictor())
    ctm = (B.real("numClicksTomorrow").extract(lambda c: 1.0)
           .aggregate(A.SumNumeric()).window(day).from_source("clicks")
           .as_response())
    cut = A.CutOffTime.unix_ms(cutoff)
    jreader = R.JoinedAggregateReaders(
        R.AggregateDataReader(sends, key_fn=lambda r: r["userId"],
                              timestamp_fn=lambda r: r["timeStamp"],
                              cutoff_time=cut),
        R.AggregateDataReader(clicks, key_fn=lambda r: r["userId"],
                              timestamp_fn=lambda r: r["timeStamp"],
                              cutoff_time=cut, response_window_ms=day),
        left_name="sends", right_name="clicks")
    jds = jreader.generate_dataset([cyd, slw, ctm])
    assert list(rows) == jds.keys
    for i, k in enumerate(jds.keys):
        for name in ("numClicksYday", "numSendsLastWeek",
                     "numClicksTomorrow"):
            assert rows[k][name] == jds[name].boxed(i).value
        a, b = rows[k]["numClicksYday"], rows[k]["numSendsLastWeek"]
        assert rows[k]["ctr"] == (None if a is None or b is None
                                  else a / (b + 1.0))
    visits = [{"userId": f"v{i % 7}", "url": ("http://www.amazon.com/SaveBig"
                                              if i % 5 == 0 else "x"),
               "productId": "p" if i % 3 == 0 else None,
               "timestamp": dataprep.START_MS + i * 3 * 3600 * 1000}
              for i in range(80)]
    rows = dataprep.conditional_aggregation(visits)
    vwp = (B.real_nn("numVisitsWeekPrior").extract(lambda v: 1.0)
           .aggregate(A.SumNumeric()).window(7 * day).as_predictor())
    pnd = (B.real_nn("numPurchasesNextDay")
           .extract(lambda v: 1.0 if v["productId"] else None)
           .aggregate(A.SumNumeric()).window(day).as_response())
    jds = R.ConditionalDataReader(
        visits, key_fn=lambda v: v["userId"],
        timestamp_fn=lambda v: v["timestamp"],
        target_condition=lambda v: v["url"]
        == "http://www.amazon.com/SaveBig",
        response_window_ms=day, predictor_window_ms=7 * day
    ).generate_dataset([vwp, pnd])
    assert list(rows) == jds.keys
    for i, k in enumerate(jds.keys):
        assert rows[k] == {"numVisitsWeekPrior": jds[vwp.name].data[i],
                           "numPurchasesNextDay": jds[pnd.name].data[i]}


# ---------------------------------------------------------------------------
# file readers and Avro
# ---------------------------------------------------------------------------

CSV_TEXT = ("id,age,name,score,big,odd\n"
            "1,30,alice,0.5,9007199254740993,nan\n"
            "2,,bob,1.5,9007199254740995,inf\n"
            "3,41,,2.5e1,1,x\n")


@pytest.mark.parametrize("reader", ["csv", "csv_auto"])
def test_csv_readers_equal_jax(tmp_path, reader):
    p = tmp_path / "data.csv"
    p.write_text(CSV_TEXT)
    port = getattr(treaders.DataReaders.Simple, reader)(str(p))
    jax = getattr(jreaders.DataReaders.Simple, reader)(str(p))
    a, b = port.read_records(), jax.read_records()
    assert a == b and [type(v) for r in a for v in r.values()] == \
        [type(v) for r in b for v in r.values()]
    if reader == "csv_auto":
        # integers without a float round trip; nan and inf kept as text
        assert a[0]["big"] == 9007199254740993 and a[0]["odd"] == "nan"


def _avro_records(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return [{"id": i, "name": None if i % 7 == 0 else f"n{i}",
             "x": float(rng.normal()), "flag": bool(i % 2),
             "big": int(2 ** 40 + i) * (-1) ** i} for i in range(n)]


NESTED_SCHEMA = {"type": "record", "name": "Row", "fields": [
    {"name": "id", "type": "long"},
    {"name": "tags", "type": {"type": "array", "items": "string"}},
    {"name": "m", "type": {"type": "map", "values": ["null", "double"]}},
    {"name": "color", "type": {"type": "enum", "name": "Color",
                               "symbols": ["RED", "GREEN"]}},
    {"name": "inner", "type": ["null", {
        "type": "record", "name": "Inner", "fields": [
            {"name": "f", "type": "float"},
            {"name": "b", "type": "bytes"}]}]},
    {"name": "h", "type": {"type": "fixed", "name": "H", "size": 2}}]}


def _nested_records():
    return [{"id": i, "tags": ["a", "b"][:i % 3],
             "m": {"k": float(i), "z": None} if i % 2 else {},
             "color": "GREEN" if i % 2 else "RED",
             "inner": None if i % 3 == 0 else {"f": 0.5 * i,
                                               "b": bytes([i, 1])},
             "h": bytes([i, 2])} for i in range(20)]


@pytest.mark.parametrize("codec", ["null", "deflate"])
@pytest.mark.parametrize("shape", ["flat", "nested"])
def test_avro_bytes_equal_jax(tmp_path, codec, shape):
    records = _avro_records() if shape == "flat" else _nested_records()
    schema = None if shape == "flat" else NESTED_SCHEMA
    pa, pj = str(tmp_path / "port.avro"), str(tmp_path / "jax.avro")
    assert tavro.write_avro(pa, records, schema=schema, codec=codec) == \
        javro.write_avro(pj, records, schema=schema, codec=codec)
    assert filecmp.cmp(pa, pj, shallow=False)
    assert tavro.read_avro(pj) == javro.read_avro(pa) == \
        javro.read_avro(pj)
    assert tavro.infer_avro_schema(records) == \
        javro.infer_avro_schema(records)


def test_avro_product_reader_glob(tmp_path):
    recs = _avro_records(30, seed=1)
    for i in range(3):
        javro.write_avro(str(tmp_path / f"part-{i}.avro"),
                         recs[10 * i:10 * (i + 1)], codec="deflate")
    glob = str(tmp_path / "part-*.avro")
    assert treaders.DataReaders.Simple.avro(glob).read_records() == \
        jreaders.DataReaders.Simple.avro(glob).read_records() == recs


def test_avro_errors(tmp_path):
    p = tmp_path / "bad.avro"
    p.write_bytes(b"nope")
    with pytest.raises(tavro.AvroError):
        tavro.read_avro(str(p))
    with pytest.raises(tavro.AvroError):
        tavro.write_avro(str(tmp_path / "x.avro"), [{"a": 1}], codec="snappy")
    with pytest.raises(tavro.AvroError):
        tavro.write_avro(str(tmp_path / "y.avro"), [{"a": [1]}],
                         schema={"type": "record", "name": "R", "fields": [
                             {"name": "a", "type": ["null", "long"]}]})


def test_parquet_and_dataframe_equal_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    from transmogrifai_tpu.features.builder import infer_schema as jinfer
    from transmogrifai_tpu_torch.features.builder import infer_schema
    df = pd.DataFrame({"age": [30.0, None, 41.0, 22.0],
                       "sex": ["f", "m", None, "f"],
                       "n": [1, 2, 3, 4], "flag": [0, 1, 1, 0],
                       "y": [1.0, 0.0, 1.0, 0.0]})
    path = str(tmp_path / "d.parquet")
    df.to_parquet(path)
    assert treaders.DataReaders.Simple.parquet(path).read_records() == \
        jreaders.DataReaders.Simple.parquet(path).read_records()
    assert {k: v.__name__ for k, v in infer_schema(df).items()} == \
        {k: v.__name__ for k, v in jinfer(df).items()}
    y, xs = FeatureBuilder.from_dataframe(df, response="y")
    jy, jxs = JaxBuilder.from_dataframe(df, response="y")
    assert [(f.name, f.ftype.__name__, f.is_response) for f in [y] + xs] \
        == [(f.name, f.ftype.__name__, f.is_response) for f in [jy] + jxs]
    schema = {"age": ttypes.Real, "sex": ttypes.PickList}
    ds = Dataset.from_pandas(df, schema)
    jds = JaxDataset.from_pandas(df, {"age": jtypes.Real,
                                      "sex": jtypes.PickList})
    _assert_same_dataset(ds, jds)
    assert ds.to_pandas().equals(jds.to_pandas())
    assert [{k: v.value for k, v in r.items()} for r in ds.rows()] == \
        [{k: v.value for k, v in r.items()} for r in jds.rows()]
    assert ds.drop(["age"]).column_names == ["sex"]


# ---------------------------------------------------------------------------
# joined readers
# ---------------------------------------------------------------------------

def _joined(pkg, join_type="leftOuter"):
    left = [{"user": "a", "t": 1, "x": 1.0}, {"user": "b", "t": 1, "x": 2.0},
            {"user": "c", "t": 1, "x": 4.0}]
    right = [{"user": "a", "t": 1, "y": 10.0},
             {"user": "c", "t": 5_000, "y": 30.0},   # filtered out
             {"user": "d", "t": 1, "y": 40.0}]
    mk = lambda recs: pkg[3].AggregateDataReader(  # noqa: E731
        recs, key_fn=lambda r: r["user"], timestamp_fn=lambda r: r["t"],
        cutoff_time=pkg[2].CutOffTime.unix_ms(CUTOFF))
    return pkg[3].JoinedAggregateReaders(mk(left), mk(right),
                                         left_name="l", right_name="r",
                                         join_type=join_type)


def _side_features(pkg, ytype="Real", xname="x", yname="y"):
    B, T, A, _ = pkg
    fx = (B.of(xname, T.Real).extract(lambda r: r.get("x"))
          .aggregate(A.SumNumeric()).from_source("l").as_predictor())
    fy = (B.of(yname, getattr(T, ytype)).extract(lambda r: r.get("y"))
          .aggregate(A.SumNumeric()).from_source("r").as_predictor())
    fz = (B.of("tags", T.MultiPickList).extract(lambda r: ["t"])
          .from_source("r").as_predictor())
    return [fx, fy, fz]


@pytest.mark.parametrize("join_type,ytype", [("leftOuter", "Real"),
                                             ("leftOuter", "RealNN"),
                                             ("inner", "Real")])
def test_joined_readers_equal_jax(join_type, ytype):
    ds = [_joined(pkg, join_type).generate_dataset(
        _side_features(pkg, ytype)) for pkg in (PORT, JAX)]
    _assert_same_dataset(*ds)
    y = ds[0]["y"].data
    if join_type == "inner":
        assert ds[0].keys == ["a", "c"]
    elif ytype == "Real":
        # b is absent from the right side: null; c present but filtered
        # out: the monoid's empty value, null for Real too
        assert ds[0].keys == ["a", "b", "c"] and y[0] == 10.0 \
            and np.isnan(y[1]) and np.isnan(y[2])
    else:
        # RealNN cannot hold null: the monoid zero either way
        assert list(y) == [10.0, 0.0, 0.0]


@pytest.mark.parametrize("bad", ["duplicate", "unknown-source"])
def test_joined_readers_refuse(bad):
    for pkg in (PORT, JAX):
        B, T, A, _ = pkg
        if bad == "duplicate":
            feats = _side_features(pkg, yname="x")
        else:
            feats = [B.of("z", T.Real).extract(lambda r: r.get("z"))
                     .from_source("nope").as_predictor()]
        with pytest.raises(ValueError):
            _joined(pkg).generate_dataset(feats)


def test_joined_data_reader_left_wins():
    left = [{"k": "a", "v": 1, "w": 5}, {"k": "b", "v": 2, "w": 6}]
    right = [{"k": "a", "v": 10, "z": 7}]
    out = []
    for R in (treaders, jreaders):
        for how in ("left_outer", "inner"):
            out.append(getattr(R.JoinedDataReader, how)(
                R.DataReader(left), R.DataReader(right),
                lambda r: r["k"], lambda r: r["k"]).read_records())
    assert out[:2] == out[2:]
    assert out[0][0]["v"] == 1 and out[0][0]["right_v"] == 10


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

def test_streaming_batches_equal_jax(tmp_path):
    recs = _avro_records(23)
    for R in (treaders, jreaders):
        batches = list(R.StreamingReader.from_records(recs, batch_size=10))
        assert [len(b) for b in batches] == [10, 10, 3]
        assert list(R.StreamingReaders.Simple.custom(recs, 5)) == \
            [recs[i:i + 5] for i in range(0, 23, 5)]
        assert list(R.StreamingReader.from_batches([recs[:2], recs[2:4]])) \
            == [recs[:2], recs[2:4]]
    for i in range(2):
        javro.write_avro(str(tmp_path / f"b{i}.avro"), recs[10 * i:10 * i + 10])
    (tmp_path / "c0.csv").write_text(CSV_TEXT)
    for kind, pattern in (("avro", "b*.avro"), ("csv", "c*.csv")):
        glob = str(tmp_path / pattern)
        assert list(getattr(treaders.StreamingReaders.Simple, kind)(glob)) \
            == list(getattr(jreaders.StreamingReaders.Simple, kind)(glob))


def test_tail_directory(tmp_path):
    """Files present at the start, one that lands while tailing, an
    unreadable one skipped; the tail ends at its idle timeout."""
    recs = _avro_records(6)
    tavro.write_avro(str(tmp_path / "a.avro"), recs[:3])
    (tmp_path / "bad.avro").write_bytes(b"garbage")

    def later():
        time.sleep(0.2)
        tavro.write_avro(str(tmp_path / "b.avro.tmp"), recs[3:])
        os.replace(tmp_path / "b.avro.tmp", tmp_path / "b.avro")
    th = threading.Thread(target=later)
    th.start()
    t0 = time.monotonic()
    got = list(treaders.StreamingReader.tail_directory(
        str(tmp_path / "*.avro"), poll_interval_s=0.05, idle_timeout_s=0.6,
        on_error="skip"))
    th.join()
    assert got == [recs[:3], recs[3:]]
    assert time.monotonic() - t0 < 2.5
    with pytest.raises(tavro.AvroError):
        list(treaders.StreamingReader.tail_directory(
            str(tmp_path / "bad.avro"), poll_interval_s=0.05,
            idle_timeout_s=0.3))
    with pytest.raises(ValueError):
        treaders.StreamingReader.tail_directory("x", on_error="nope")


# ---------------------------------------------------------------------------
# a workflow through an aggregate-joined reader
# ---------------------------------------------------------------------------

def _metric_matrix(model, selected_cls):
    sel = next(s for s in model.stages() if isinstance(s, selected_cls))
    return np.array([r.metric_values for r in
                     sel.summary.validation_results]).T, sel.summary


@pytest.fixture(scope="module")
def event_runs():
    """One event-log workflow trained per package through the joined
    reader on 300 users, LR and a 5-round GBT under 3-fold CV."""
    from transmogrifai_tpu.models import LogisticRegression as JaxLR
    from transmogrifai_tpu.models.trees import GBTClassifier as JaxGBT
    from transmogrifai_tpu.ops import transmogrify as jtransmogrify
    from transmogrifai_tpu.selector import SelectedModel as JaxSelected
    from transmogrifai_tpu.selector.factories import (
        BinaryClassificationModelSelector as JaxSelector)
    from transmogrifai_tpu.utils.uid import reset as jax_reset
    from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
    from transmogrifai_tpu_torch.models import (GBTClassifier,
                                                LogisticRegression)
    from transmogrifai_tpu_torch.selector import SelectedModel
    from transmogrifai_tpu_torch.utils.uid import reset as port_reset
    sends, clicks = dataprep.synthetic_event_log(300, seed=4)
    cut = dataprep.START_MS + 14 * dataprep.DAY_MS
    grids = ([{"reg_param": 0.01}, {"reg_param": 0.1}], [{"max_depth": 3}])
    port_reset(deterministic=True)
    port = dataprep.run(
        sends, clicks, cut, cut + 7 * dataprep.DAY_MS, device="cpu",
        models=[(LogisticRegression(device="cpu"), grids[0]),
                (GBTClassifier(num_rounds=5, device="cpu"), grids[1])])
    # the JAX package: the same features and readers from its own classes
    jax_reset(deterministic=True)
    label, preds = _jax_event_features()
    vec = jtransmogrify(preds)
    sel = JaxSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True,
        models=[(JaxLR(), grids[0]), (JaxGBT(num_rounds=5), grids[1])])
    pred = sel.set_input(label, vec).get_output()
    jmodel = (JaxWorkflow().set_result_features(label, pred)
              .set_reader(_jax_event_reader(sends, clicks, cut)).train())
    return {"port": port, "jax": jmodel, "jax_pred": pred,
            "selected": (SelectedModel, JaxSelected), "cut": cut,
            "sends": sends, "clicks": clicks}


def _jax_event_reader(sends, clicks, cutoff):
    """``dataprep.event_reader`` built from the JAX package's classes."""
    c = jagg.CutOffTime.unix_ms(cutoff)
    side = lambda recs: jreaders.AggregateDataReader(  # noqa: E731
        recs, key_fn=lambda r: r["userId"],
        timestamp_fn=lambda r: r["timeStamp"], cutoff_time=c)
    return jreaders.JoinedAggregateReaders(
        side(sends), side(clicks), left_name="sends", right_name="clicks")


def _jax_event_features():
    """``dataprep.event_features`` built from the JAX package's classes."""
    B, T, A, _ = JAX
    day = dataprep.DAY_MS

    def agg(name, ftype, fn, aggregator, source, window=None):
        b = B.of(name, getattr(T, ftype)).extract(fn).aggregate(aggregator)
        if window is not None:
            b = b.window(window)
        return b.from_source(source)
    preds = [
        agg("sendsLastDay", "Real", lambda s: 1.0, A.SumNumeric(), "sends",
            day),
        agg("sendsLastWeek", "Real", lambda s: 1.0, A.SumNumeric(), "sends",
            7 * day),
        agg("lastCampaign", "PickList", lambda s: s["campaign"],
            A.LastAggregator(), "sends"),
        agg("subjects", "Text", lambda s: s["subject"], A.ConcatText(),
            "sends", 7 * day),
        agg("clicksLastDay", "Real", lambda c: 1.0, A.SumNumeric(),
            "clicks", day),
        agg("clicksLastWeek", "Real", lambda c: 1.0, A.SumNumeric(),
            "clicks", 7 * day),
        agg("meanDwell", "Real", lambda c: c["dwellSeconds"],
            A.MeanNumeric(), "clicks"),
        agg("anyMobile", "Binary", lambda c: c["mobile"], A.LogicalOr(),
            "clicks"),
        agg("topics", "MultiPickList", lambda c: c["topics"], A.UnionSet(),
            "clicks"),
        agg("clickLocation", "Geolocation",
            lambda c: None if c["lat"] is None else [c["lat"], c["lon"], 1.0],
            A.GeolocationMidpoint(), "clicks"),
    ]
    label = agg("clickedNextDay", "RealNN", lambda c: 1.0, A.MaxNumeric(),
                "clicks", day).as_response()
    return label, [b.as_predictor() for b in preds]


def test_event_reader_dataset_equals_jax(event_runs):
    label, preds = dataprep.event_features()
    jlabel, jpreds = _jax_event_features()
    args = (event_runs["sends"], event_runs["clicks"], event_runs["cut"])
    _assert_same_dataset(
        dataprep.event_reader(*args).generate_dataset(preds + [label]),
        _jax_event_reader(*args).generate_dataset(jpreds + [jlabel]))


class _PredictorsOnly(treaders.JoinedAggregateReaders):
    """A reader whose data holds no response."""

    def generate_dataset(self, raw_features):
        if any(f.is_response for f in raw_features):
            raise ValueError("this data holds no response")
        return super().generate_dataset(raw_features)


def test_event_workflow_equals_jax(event_runs):
    port, jmodel = event_runs["port"], event_runs["jax"]
    sel, jsel = event_runs["selected"]
    mp, sp = _metric_matrix(port.model, sel)
    mj, sj = _metric_matrix(jmodel, jsel)
    assert mp.shape == mj.shape == (3, 3)
    np.testing.assert_allclose(mp, mj, rtol=0, atol=1e-12)
    assert sp.best_model_name == sj.best_model_name
    assert sp.best_model_params == sj.best_model_params


@pytest.mark.parametrize("engine", ["columnar", "compiled"])
def test_event_workflow_scores_a_reader(event_runs, engine):
    """Scoring at the later cutoff through a reader: with responses within
    1e-9 of the JAX package's score of its own reader, the labels equal;
    through a reader that cannot produce the response, the label column
    all NaN and the predictions those of the reader with responses."""
    run = event_runs["port"]
    later = event_runs["cut"] + 7 * dataprep.DAY_MS
    args = (event_runs["sends"], event_runs["clicks"], later)
    scored = run.model.score(dataprep.event_reader(*args), engine=engine)
    jscored = event_runs["jax"].score(_jax_event_reader(*args))
    name, jname = run.prediction.name, event_runs["jax_pred"].name
    p = np.asarray(scored[name].probability)[:, 1]
    np.testing.assert_allclose(
        p, np.asarray(jscored[jname].probability)[:, 1], rtol=0, atol=1e-9)
    assert np.array_equal(scored[run.label.name].data,
                          jscored["clickedNextDay"].data)
    joined = dataprep.event_reader(*args)
    free = run.model.score(_PredictorsOnly(joined.left, joined.right,
                                           "sends", "clicks"),
                           engine=engine)
    assert np.all(np.isnan(free[run.label.name].data))
    assert np.array_equal(np.asarray(free[name].probability)[:, 1], p)


def test_event_workflow_summary(event_runs):
    run = event_runs["port"]
    doc = json.loads(run.model.summary())
    assert doc["label"]["name"] == "clickedNextDay"
    assert "Selected model:" in run.model.summary_pretty()
    assert run.metrics.AuPR > 0.1


def test_readme_quick_start(tmp_path, monkeypatch):
    """The README's Quick start with the port's imports and
    ``device="cpu"`` on a seeded 300-record Titanic CSV, its pool narrowed
    to LR and a 3-round GBT: it trains through ``csv_auto``, prints both
    summaries, saves and serves a record."""
    import csv
    from transmogrifai_tpu_torch.examples import titanic
    from transmogrifai_tpu_torch.models import (GBTClassifier,
                                                LogisticRegression)
    records = titanic.synthetic_titanic(300, seed=3)
    with open(tmp_path / "titanic.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["survived", "age", "sex", "name"])
        for r in records:
            w.writerow(["" if r[c] is None else r[c]
                        for c in ("survived", "age", "sex", "name")])
    monkeypatch.chdir(tmp_path)
    pool = [(LogisticRegression(device="cpu"), [{"reg_param": 0.01}]),
            (GBTClassifier(num_rounds=3, device="cpu"), [{"max_depth": 3}])]

    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.ops import transmogrify
    from transmogrifai_tpu_torch.readers import DataReaders
    from transmogrifai_tpu_torch.selector import (
        BinaryClassificationModelSelector)
    from transmogrifai_tpu_torch.types import PickList, Real, RealNN
    from transmogrifai_tpu_torch.workflow import Workflow

    age = FeatureBuilder.of("age", Real).extract(
        lambda r: r.get("age")).as_predictor()
    sex = FeatureBuilder.of("sex", PickList).extract(
        lambda r: r.get("sex")).as_predictor()
    y = FeatureBuilder.of("survived", RealNN).extract(
        lambda r: r.get("survived")).as_response()
    features = transmogrify([age, sex])
    checked = features.sanity_check(y)
    pred = (BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, device="cpu", models=pool)
        .set_input(y, checked).get_output())
    model = (Workflow(device="cpu").set_result_features(pred)
             .set_reader(DataReaders.Simple.csv_auto("titanic.csv"))
             .train())
    summary = model.summary_pretty()
    insights = model.model_insights().pretty()
    model.save(str(tmp_path / "titanic-model"))

    from transmogrifai_tpu_torch.local import load_score_function
    score = load_score_function(str(tmp_path / "titanic-model"),
                                device="cpu")
    served = score({"age": 29.0, "sex": "female"})[pred.name]
    assert "Selected model:" in summary and insights in summary
    assert "  sex: " in insights and "  age: " in insights
    assert 0.0 <= served["probability_1"] <= 1.0
    assert model.model_insights().label.sample_size == 300


def test_raw_feature_filter_scores_a_reader():
    """``with_raw_feature_filter(score_data=<reader>)``: the filter reads
    the scoring distributions through the reader, as the JAX package's
    does, with the same results."""
    from transmogrifai_tpu.checkers import RawFeatureFilter as JaxRFF
    from transmogrifai_tpu.ops import transmogrify as jtransmogrify
    from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
    from transmogrifai_tpu_torch.checkers import RawFeatureFilter
    from transmogrifai_tpu_torch.ops import transmogrify
    from transmogrifai_tpu_torch.workflow import Workflow
    sends, clicks = dataprep.synthetic_event_log(150, seed=6)
    cut = dataprep.START_MS + 14 * dataprep.DAY_MS
    later = cut + 7 * dataprep.DAY_MS
    label, preds = dataprep.event_features()
    port = (Workflow(device="cpu")
            .set_result_features(label, transmogrify(preds))
            .set_reader(dataprep.event_reader(sends, clicks, cut))
            .with_raw_feature_filter(RawFeatureFilter(), score_data=(
                dataprep.event_reader(sends, clicks, later))))
    port.train()
    jlabel, jpreds = _jax_event_features()
    jax = (JaxWorkflow()
           .set_result_features(jlabel, jtransmogrify(jpreds))
           .set_reader(_jax_event_reader(sends, clicks, cut))
           .with_raw_feature_filter(JaxRFF(), score_data=(
               _jax_event_reader(sends, clicks, later))))
    jax.train(validate="off")
    got = port.raw_feature_filter_results.to_json()
    assert got == jax.raw_feature_filter_results.to_json()
    assert len(got["scoreDistributions"]) == len(preds)
