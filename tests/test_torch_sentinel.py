"""The drift sentinel of the PyTorch port against the JAX package's, on
the same Titanic-shaped records (CPU):

- training fingerprints: the same features, counts and nulls, the
  categorical bucket counts exactly, the numeric histograms within 1e-12;
- drift reports over an unshifted holdout of 1,000 records and over the
  same records shifted (every ``age`` + 40, ``sex`` constant): the same
  statuses, JS within 1e-12, ``ok`` on the holdout and ``warn`` or
  ``degrade`` on the shift;
- ``drift-fingerprints.json`` written by either package loads in the
  other (the two writers give the same bytes); a file of another schema
  raises ``FingerprintSchemaError`` in the load and in ``for_model``;
- the sentinel's serve-side state round-trips, and its record path equals
  the JAX package's; the histogram density every JS reads and
  ``sum_upto`` (all breakpoints at once in the port) are bitwise the JAX
  package's breakpoint-by-breakpoint ones with whole counts, and within
  rounding of the total (4 ulps) with fractional weights;
- a saved model carries the fingerprints and serves under a default
  ``ServeConfig()`` and default ``with_guardrails()``, its drift state in
  the metrics snapshot."""
import json
import os

import numpy as np
import pytest

from examples import titanic as jax_titanic
from transmogrifai_tpu.serving import sentinel as jax_sentinel
from transmogrifai_tpu.utils.histogram import (
    StreamingHistogram as JaxHistogram)
from transmogrifai_tpu.workflow.workflow import (
    _generate_raw_data as jax_raw_data)
from transmogrifai_tpu_torch.examples import titanic
from transmogrifai_tpu_torch.models import LogisticRegression
from transmogrifai_tpu_torch.serving import (DriftSentinel, ScoringPlan,
                                             ServeConfig,
                                             serve_in_process)
from transmogrifai_tpu_torch.serving import sentinel
from transmogrifai_tpu_torch.utils.histogram import StreamingHistogram
from transmogrifai_tpu_torch.workflow.persistence import load_model
from transmogrifai_tpu_torch.workflow.workflow import _generate_raw_data

#: tolerance of the numeric sketches and JS divergences: both packages run
#: the same float64 numpy arithmetic, so only summation order could differ
TOL = 1e-12


def _shift(records):
    return [dict(r, age=(r["age"] or 30.0) + 40.0, sex="male")
            for r in records]


@pytest.fixture(scope="module")
def data():
    records = jax_titanic.synthetic_titanic(4000, seed=11)
    train, test = jax_titanic.stratified_split(records)
    _, jvec = jax_titanic.build_features()
    _, tvec = titanic.build_features()
    jraw, traw = jvec.raw_features(), tvec.raw_features()
    return {"train": train, "test": test, "jraw": jraw, "traw": traw,
            "jfps": jax_sentinel.compute_fingerprints(
                jraw, jax_raw_data(jraw, train, require_responses=False)),
            "tfps": sentinel.compute_fingerprints(
                traw, _generate_raw_data(traw, train,
                                         require_responses=False))}


def _assert_same_fingerprints(got, want):
    assert [f.name for f in got] == [f.name for f in want]
    for g, w in zip(got, want):
        assert (g.is_numeric, g.count, g.nulls, g.bins) == \
            (w.is_numeric, w.count, w.nulls, w.bins)
        np.testing.assert_array_equal(g.counts, w.counts)
        if w.histogram is None:
            assert g.histogram is None
        else:
            assert g.histogram.max_bins == w.histogram.max_bins
            np.testing.assert_allclose(g.histogram.centroids,
                                       w.histogram.centroids, rtol=TOL,
                                       atol=TOL)
            np.testing.assert_allclose(g.histogram.counts,
                                       w.histogram.counts, rtol=TOL,
                                       atol=TOL)


def test_fingerprints_match_jax(data):
    tfps, jfps = data["tfps"], data["jfps"]
    assert {f.name for f in tfps} >= {"age", "sex", "fare", "cabin"}
    assert any(f.is_numeric for f in tfps)
    assert any(not f.is_numeric for f in tfps)
    _assert_same_fingerprints(tfps, jfps)


def _reports(data, records):
    jsen = jax_sentinel.DriftSentinel(data["jfps"])
    tsen = DriftSentinel(data["tfps"])
    jsen.observe_dataset(jax_raw_data(data["jraw"], records,
                                      require_responses=False))
    tsen.observe_dataset(_generate_raw_data(data["traw"], records,
                                            require_responses=False))
    return tsen, tsen.drift_report(), jsen.drift_report()


@pytest.mark.parametrize("shifted", [False, True],
                         ids=["holdout", "shifted"])
def test_drift_report_matches_jax(data, shifted):
    records = _shift(data["test"]) if shifted else data["test"]
    _, got, want = _reports(data, records)
    assert got["status"] == want["status"]
    if not shifted:
        assert got["status"] == "ok"
    else:
        assert got["status"] in ("warn", "degrade")
        by = {f["feature"]: f for f in got["features"]}
        assert by["age"]["status"] in ("warn", "degrade")
    assert got["rowsSeen"] == want["rowsSeen"] == len(records)
    gf = {f["feature"]: f for f in got["features"]}
    wf = {f["feature"]: f for f in want["features"]}
    assert set(gf) == set(wf)
    for name, w in wf.items():
        g = gf[name]
        assert g["status"] == w["status"]
        assert abs(g["jsDivergence"] - w["jsDivergence"]) <= TOL
        for key in ("rowsObserved", "serveFillRate", "trainFillRate",
                    "isNumeric"):
            assert g[key] == w[key]


def test_fingerprint_files_load_across_packages(data, tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(a)
    os.makedirs(b)
    jax_sentinel.save_fingerprints(data["jfps"], a, trained_at=3)
    sentinel.save_fingerprints(data["tfps"], b, trained_at=3)
    name = sentinel.DRIFT_FINGERPRINTS_FILE
    with open(os.path.join(a, name), "rb") as fa, \
            open(os.path.join(b, name), "rb") as fb:
        assert fa.read() == fb.read()
    got, meta = sentinel.load_fingerprint_doc(a)
    assert meta == {"schema": sentinel.FINGERPRINT_SCHEMA, "trainedAt": 3}
    _assert_same_fingerprints(got, data["jfps"])
    _assert_same_fingerprints(jax_sentinel.load_fingerprints(b),
                              data["tfps"])
    assert sentinel.load_fingerprints(str(tmp_path)) is None


def test_schema_mismatch_raises(data, tmp_path):
    path = str(tmp_path)
    sentinel.save_fingerprints(data["tfps"], path)
    doc_path = os.path.join(path, sentinel.DRIFT_FINGERPRINTS_FILE)
    with open(doc_path) as fh:
        doc = json.load(fh)
    doc["schema"] = "tx-drift-fingerprints/2"
    with open(doc_path, "w") as fh:
        json.dump(doc, fh)
    with pytest.raises(sentinel.FingerprintSchemaError, match="schema"):
        sentinel.load_fingerprint_doc(path)

    class _Model:
        model_dir = path
        train_dataset = None

    with pytest.raises(sentinel.FingerprintSchemaError):
        DriftSentinel.for_model(_Model())


def test_state_and_records_path_match_jax(data):
    tsen, report, _ = _reports(data, _shift(data["test"][:120]))
    again = DriftSentinel(data["tfps"])
    again.load_state(json.loads(json.dumps(tsen.state_dict())))
    assert again.drift_report() == report
    jsen = jax_sentinel.DriftSentinel(data["jfps"])
    tsen = DriftSentinel(data["tfps"])
    recs = data["test"][:80]
    jsen.observe_records(recs)
    tsen.observe_records(recs)
    got, want = tsen.drift_report(), jsen.drift_report()
    assert [(f["feature"], f["status"]) for f in got["features"]] == \
        [(f["feature"], f["status"]) for f in want["features"]]
    for g, w in zip(got["features"], want["features"]):
        assert abs(g["jsDivergence"] - w["jsDivergence"]) <= TOL


def test_default_serve_config_serves_a_saved_model(data, tmp_path):
    """A trained model saves its fingerprints; reloaded, a default
    ``with_guardrails()`` plan and a default ``ServeConfig()`` server
    watch its traffic with the fingerprints from disk."""
    run = titanic.run(data["train"][:300], device="cpu",
                      model_stage=LogisticRegression(max_iter=30,
                                                     device="cpu"))
    path = str(tmp_path / "model")
    run.model.save(path)
    assert os.path.exists(os.path.join(path,
                                       sentinel.DRIFT_FINGERPRINTS_FILE))
    model = load_model(path, device="cpu")
    assert model.model_dir == path
    plan = ScoringPlan(model).compile().with_guardrails()
    plan.score(_shift(data["test"]))
    report = plan.drift_report()
    assert report["enabled"] and report["status"] in ("warn", "degrade")
    name = run.prediction.name
    batch = [dict(r) for r in data["test"][:64]]
    offline = ScoringPlan(model).compile().with_guardrails(
        sentinel=False).score_guarded(batch).scored[name]
    server, client = serve_in_process({"t": model}, ServeConfig(),
                                      device="cpu")
    try:
        rows = client.score_many(batch)
        lanes = server.metrics_snapshot()["sentinels"]
    finally:
        server.stop()
    for i, row in enumerate(rows):
        assert row[name] == dict(offline.boxed(i).value)
    (lane,) = lanes.values()
    assert lane["rowsSeen"] == len(batch)
    assert set(lane["features"]) == {f.name for f in model.raw_features()
                                     if not f.is_response}


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unit-counts", "fractional-counts"])
def test_histogram_density_is_bitwise_jax(weighted):
    rng = np.random.default_rng(7 + weighted)
    for trial in range(60):
        bins = int(rng.integers(2, 40))
        hist, ref = StreamingHistogram(bins), JaxHistogram(bins)
        for _ in range(int(rng.integers(1, 4))):
            m = int(rng.integers(1, 300))
            pts = np.round(rng.normal(size=m) * rng.choice([1e-3, 1, 50]),
                           int(rng.integers(0, 4)))
            cts = rng.uniform(0.1, 3.0, m) if weighted else None
            hist.update(pts, cts)
            ref.update(pts, cts)
        c = ref.centroids
        breaks = np.concatenate([
            np.linspace(c.min() - 1, c.max() + 1, int(rng.integers(1, 120))),
            c[:3], c[-1:]])
        np.testing.assert_array_equal(hist.centroids, ref.centroids)
        ours = np.append(hist.density(breaks),
                         [hist.sum_upto(b) for b in breaks])
        theirs = np.append(ref.density(breaks),
                           [ref.sum_upto(b) for b in breaks])
        if weighted:
            # the port's prefix is a running sum, the JAX package's a
            # pairwise sum of each prefix: equal for whole counts, within
            # rounding of the total for fractional weights
            np.testing.assert_allclose(
                ours, theirs, rtol=0,
                atol=4 * np.finfo(np.float64).eps * ref.counts.sum())
        else:
            np.testing.assert_array_equal(ours, theirs)

