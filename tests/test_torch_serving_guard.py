"""The serving guardrails of the PyTorch port against the JAX package's
(float64, CPU): each package fits the same small model (a nullable Real
``x``, a required RealNN ``z``, a PickList ``cat`` -> logistic
regression) on the same records, and malformed records must give the same
quarantine reasons on the same rows, guarded scores within 1e-9 and NaN
where a row was quarantined; the CircuitBreaker walks closed -> open ->
half-open -> closed under an injected clock exactly as the JAX one does;
the guarded path trips, falls back to the host columnar path, recovers,
lets bugs propagate and orphans a hung dispatch at its deadline; the
runtime's error classifier names torch's errors; the tracer is off by
default."""
import numpy as np
import pytest

from transmogrifai_tpu.features.builder import FeatureBuilder as JaxBuilder
from transmogrifai_tpu.models import LogisticRegression as JaxLR
from transmogrifai_tpu.ops import transmogrify as jax_transmogrify
from transmogrifai_tpu.runtime import telemetry as jax_telemetry
from transmogrifai_tpu.runtime.errors import classify_error as jax_classify
from transmogrifai_tpu.runtime.retry import RetryPolicy as JaxRetry
from transmogrifai_tpu.serving import AdmissionPolicy as JaxPolicy
from transmogrifai_tpu.serving import CircuitBreaker as JaxBreaker
from transmogrifai_tpu.serving import ScoringPlan as JaxPlan
from transmogrifai_tpu.types import PickList as JaxPickList
from transmogrifai_tpu.types import Real as JaxReal
from transmogrifai_tpu.types import RealNN as JaxRealNN
from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.features.columns import (Dataset,
                                                      FeatureColumn,
                                                      PredictionColumn)
from transmogrifai_tpu_torch.local import ScoreFunction
from transmogrifai_tpu_torch.models import LogisticRegression
from transmogrifai_tpu_torch.observability import trace
from transmogrifai_tpu_torch.ops import transmogrify
from transmogrifai_tpu_torch.runtime import telemetry
from transmogrifai_tpu_torch.runtime.errors import (BUG, FAMILY, TRANSIENT,
                                                    classify_error)
from transmogrifai_tpu_torch.runtime.retry import RetryPolicy
from transmogrifai_tpu_torch.serving import (AdmissionPolicy,
                                             BreakerOpenError,
                                             CircuitBreaker, OutputGuard,
                                             PlanCompileError, ScoringPlan,
                                             plan_compiles)
from transmogrifai_tpu_torch.types import PickList, Real, RealNN
from transmogrifai_tpu_torch.workflow import Workflow


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    jax_telemetry.reset()
    yield
    telemetry.reset()
    jax_telemetry.reset()


def _records(n=120, seed=3):
    rng = np.random.default_rng(seed)
    cats = ["a", "b", "c"]
    recs = []
    for _ in range(n):
        x = float(rng.normal())
        recs.append({"x": x, "z": float(rng.uniform(0, 4)),
                     "cat": cats[int(rng.integers(0, len(cats)))],
                     "label": float(x + 0.5 * rng.normal() > 0)})
    return recs


RECS = _records()


@pytest.fixture(scope="module")
def trained():
    """The same model fitted by each package: (JAX model, port model,
    prediction names)."""
    x = JaxBuilder.of("x", JaxReal).extract(
        lambda r: r.get("x")).as_predictor()
    z = JaxBuilder.of("z", JaxRealNN).extract(
        lambda r: r.get("z")).as_predictor()
    cat = JaxBuilder.of("cat", JaxPickList).extract(
        lambda r: r.get("cat")).as_predictor()
    label = JaxBuilder.of("label", JaxRealNN).extract(
        lambda r: r.get("label")).as_response()
    ref_pred = JaxLR(reg_param=0.01, max_iter=30).set_input(
        label, jax_transmogrify([x, z, cat])).get_output()
    ref = (JaxWorkflow().set_result_features(ref_pred)
           .set_input_records(RECS).train(validate="off"))
    x = FeatureBuilder.of("x", Real).extract(
        lambda r: r.get("x")).as_predictor()
    z = FeatureBuilder.of("z", RealNN).extract(
        lambda r: r.get("z")).as_predictor()
    cat = FeatureBuilder.of("cat", PickList).extract(
        lambda r: r.get("cat")).as_predictor()
    label = FeatureBuilder.of("label", RealNN).extract(
        lambda r: r.get("label")).as_response()
    pred = LogisticRegression(reg_param=0.01, max_iter=30,
                              device="cpu").set_input(
        label, transmogrify([x, z, cat])).get_output()
    got = (Workflow(device="cpu").set_result_features(pred)
           .set_input_records(RECS).train())
    return ref, got, ref_pred.name, pred.name


#: (case, records, policy kwargs) of the admission matrix
_NOT_A_DICT = object()
CASES = [
    ("wrong_type", [RECS[0], {**RECS[1], "x": "not-a-number"}], {}),
    ("missing_field", [{k: v for k, v in RECS[0].items() if k != "z"},
                       RECS[1]], {}),
    ("non_finite", [{**RECS[0], "x": float("inf")},
                    {**RECS[1], "z": float("nan")}, RECS[2]], {}),
    ("nan_in_nullable", [{**RECS[0], "x": float("nan")}, RECS[1]], {}),
    ("out_of_vocab", [RECS[0], {**RECS[1], "cat": "zz-never-seen"}],
     {"reject_out_of_vocab": True}),
    ("out_of_vocab_absorbed", [{**RECS[0], "cat": "zz-never-seen"}], {}),
    ("extra_field", [{**RECS[0], "rogue_key": 1}, RECS[1]],
     {"reject_extra_fields": True}),
    ("raising_extract_fn", [RECS[0], _NOT_A_DICT, RECS[2]], {}),
    ("mixed", [RECS[0], {**RECS[1], "x": "junk"}, RECS[2],
               {**RECS[3], "z": float("inf")}, RECS[4]], {}),
]


@pytest.mark.parametrize("records,policy", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_admission_matches_jax(trained, records, policy):
    ref, got, ref_name, name = trained
    a = JaxPlan(ref).compile().with_guardrails(
        admission=JaxPolicy(**policy)).score_guarded(records)
    b = ScoringPlan(got).compile().with_guardrails(
        admission=AdmissionPolicy(**policy)).score_guarded(records)
    assert [(r.row, r.code, r.feature) for r in b.quarantined] == \
        [(r.row, r.code, r.feature) for r in a.quarantined]
    assert b.quarantined_rows == a.quarantined_rows
    assert b.invalidated == [] and a.invalidated == []
    pa, pb = a.scored[ref_name], b.scored[name]
    np.testing.assert_array_equal(np.isnan(pb.data), np.isnan(pa.data))
    np.testing.assert_allclose(pb.probability, pa.probability, rtol=0,
                               atol=1e-9, equal_nan=True)
    assert b.n_valid == a.n_valid and not b.used_host_fallback


def test_clean_guarded_batch_equals_unguarded(trained):
    """Well-formed traffic through the guard gives the unguarded plan's
    bytes, and malformed rows cost no new program."""
    _, got, _, name = trained
    plain = ScoringPlan(got).compile().score(RECS[:33])[name]
    plan = ScoringPlan(got).compile().with_guardrails()
    res = plan.score_guarded(RECS[:33])
    assert res.quarantined == [] and res.invalidated == []
    np.testing.assert_array_equal(res.scored[name].probability,
                                  plain.probability)
    c0 = plan_compiles()
    bad = plan.score_guarded([{**r, "x": "junk"} for r in RECS[:33]])
    assert plan_compiles() == c0 and bad.n_valid == 0
    assert np.isnan(bad.scored[name].probability).all()
    assert telemetry.counters()["serving_rows_quarantined"] == 33


def test_columnar_admission_and_score_function(trained):
    """Dataset input is admitted column-wise; ``ScoreFunction`` with
    guardrails attaches the reasons to the row."""
    _, got, _, name = trained
    plan = ScoringPlan(got).compile().with_guardrails()
    ds = Dataset({
        "x": FeatureColumn.from_values(Real, [0.1, float("inf")]),
        "z": FeatureColumn.from_values(RealNN, [1.0, 2.0]),
        "cat": FeatureColumn.from_values(PickList, ["a", "b"]),
    })
    res = plan.score_guarded(ds)
    assert [(r.row, r.code, r.feature) for r in res.quarantined] == \
        [(1, "non_finite", "x")]
    fn = ScoreFunction(got, guardrails=True)
    rows = fn.score_batch([RECS[0], {**RECS[1], "x": "junk"}])
    assert "_guard" not in rows[0] and rows[1][name] is None
    assert rows[1]["_guard"][0]["code"] == "wrong_type"
    assert rows[1]["_guard"][0]["kind"] == "quarantined"
    assert fn.last_guard_result.quarantined_rows == [1]


def test_output_guard_matches_jax():
    """NaN and out-of-range probabilities are invalidated with the JAX
    package's reasons."""
    from transmogrifai_tpu.features.columns import (
        Dataset as JaxDataset, PredictionColumn as JaxPredictionColumn)
    from transmogrifai_tpu.serving import OutputGuard as JaxOutputGuard
    pred = np.array([1.0, 0.0, np.nan, 1.0])
    prob = np.array([[0.2, 0.8], [1.7, -0.7], [0.5, 0.5], [np.inf, 0.0]])
    a, ra = JaxOutputGuard().check(JaxDataset(
        {"p": JaxPredictionColumn.from_arrays(pred, probability=prob)}),
        ["p"])
    b, rb = OutputGuard().check(Dataset(
        {"p": PredictionColumn.from_arrays(pred, probability=prob)}), ["p"])
    assert [(r.row, r.code) for r in rb] == [(r.row, r.code) for r in ra]
    assert {r.code for r in rb} == {"probability_out_of_range",
                                    "output_non_finite"}
    np.testing.assert_array_equal(b["p"].data, a["p"].data)


def _walk(breaker_cls, clock):
    """One scripted walk of a breaker: (state, transitions) after each
    step; the clock is stepped by the script."""
    b = breaker_cls(failure_threshold=2, cooldown_seconds=10.0,
                    clock=lambda: clock["t"])
    seen = [b.state]
    b.record_failure()
    seen.append(b.state)
    b.record_failure()
    seen.append(b.state)
    try:
        b.before_dispatch()
        seen.append("dispatched")
    except (BreakerOpenError, RuntimeError) as e:
        seen.append(type(e).__name__)
    clock["t"] = 10.5
    b.before_dispatch()                 # cooldown elapsed: the probe
    seen.append(b.state)
    b.record_failure()                  # probe failed: open again
    seen.append(b.state)
    clock["t"] = 21.0
    b.before_dispatch()
    seen.append(b.state)
    b.record_success()                  # probe succeeded: closed
    seen.append(b.state)
    return seen, b.transitions, b.describe()


def test_breaker_walk_matches_jax():
    got = _walk(CircuitBreaker, {"t": 0.0})
    ref = _walk(JaxBreaker, {"t": 0.0})
    assert got == ref
    assert got[0] == ["closed", "closed", "open", "BreakerOpenError",
                      "half_open", "open", "half_open", "closed"]
    counters = telemetry.counters()
    assert counters["breaker_trips"] == 2
    assert counters["breaker_half_open"] == 2
    assert counters["breaker_recoveries"] == 1


def test_trip_fallback_and_recovery(trained, monkeypatch):
    """Persistent device failures trip the breaker; the batches are served
    by the host columnar path (counted), and after the cooldown a
    half-open probe recovers."""
    monkeypatch.setenv("TX_RETRY_MAX_ATTEMPTS", "1")
    _, got, _, name = trained
    clock = {"t": 0.0}
    breaker = CircuitBreaker(failure_threshold=2, cooldown_seconds=30.0,
                             clock=lambda: clock["t"])
    plan = ScoringPlan(got).compile().with_guardrails(breaker=breaker)
    batch = RECS[:7]
    expected = got.score(batch)[name].probability
    real = plan._run_bucket

    def oom(*args):
        raise RuntimeError("CUDA error: out of memory")
    monkeypatch.setattr(plan, "_run_bucket", oom)
    results = [plan.score_guarded(batch) for _ in range(3)]
    assert all(r.used_host_fallback for r in results)
    assert results[2].breaker_state == "open"
    for r in results:
        np.testing.assert_allclose(r.scored[name].probability, expected,
                                   rtol=0, atol=1e-12)
    counters = telemetry.counters()
    assert counters["breaker_trips"] == 1
    assert counters["serving_device_failures"] == 2
    assert counters["serving_breaker_short_circuits"] == 1
    assert counters["serving_host_fallback_batches"] == 3
    monkeypatch.setattr(plan, "_run_bucket", real)
    clock["t"] = 31.0
    r4 = plan.score_guarded(batch)
    assert not r4.used_host_fallback and breaker.state == "closed"
    assert telemetry.counters()["breaker_recoveries"] == 1


def test_bug_errors_propagate(trained, monkeypatch):
    """A code defect is not absorbed into the host fallback."""
    _, got, _, _ = trained
    plan = ScoringPlan(got).compile().with_guardrails()

    def boom(*args):
        raise KeyError("genuine bug")
    monkeypatch.setattr(plan, "_run_bucket", boom)
    with pytest.raises(KeyError):
        plan.score_guarded(RECS[:4])


@pytest.mark.parametrize("exc", [
    PlanCompileError("stage LogisticRegressionModel(p) failed CUDA graph "
                     "capture at bucket 8: KeyError: 'x'"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["capture", "sticky"])
def test_device_program_faults_propagate(trained, monkeypatch, exc):
    """A kernel failing at capture, or a sticky CUDA error, propagates out
    of the guarded path: no host fallback, no breaker step."""
    _, got, _, _ = trained
    plan = ScoringPlan(got).compile().with_guardrails()

    def fail(*args):
        raise exc
    monkeypatch.setattr(plan, "_run_bucket", fail)
    with pytest.raises(type(exc), match=str(exc)[:20]):
        plan.score_guarded(RECS[:4])
    assert plan.guard.breaker.state == "closed"
    counters = telemetry.counters()
    assert counters.get("serving_host_fallback_batches", 0) == 0
    assert counters.get("serving_device_failures", 0) == 0


def test_deadline_orphans_a_hung_dispatch(trained, monkeypatch):
    """A dispatch still running at the deadline is abandoned and the
    batch served by the host path."""
    import threading
    monkeypatch.setenv("TX_RETRY_MAX_ATTEMPTS", "1")
    _, got, _, name = trained
    plan = ScoringPlan(got).compile().with_guardrails(
        deadline_seconds=0.1)
    release = threading.Event()

    def hang(*args):
        release.wait(5.0)
        raise RuntimeError("released")
    monkeypatch.setattr(plan, "_run_bucket", hang)
    try:
        res = plan.score_guarded(RECS[:5])
    finally:
        release.set()
    assert res.used_host_fallback
    assert telemetry.counters()["serving_deadline_exceeded"] == 1
    assert np.isfinite(res.scored[name].probability).all()


CLASSIFY = [
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     TRANSIENT),
    (RuntimeError("CUDA error: out of memory"), TRANSIENT),
    (RuntimeError("CUDA error: the launch timed out and was terminated"),
     BUG),
    (RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or "
                  "unavailable"), TRANSIENT),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     BUG),
    (RuntimeError("CUDA error: unspecified launch failure"), BUG),
    (RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling "
                  "cublasSgemv"), FAMILY),
    (RuntimeError("operation not permitted when stream is capturing"),
     BUG),
    (TimeoutError("DEADLINE_EXCEEDED: device scoring batch"), TRANSIENT),
    (RuntimeError("RESOURCE_EXHAUSTED: out of HBM"), TRANSIENT),
    (RuntimeError("INVALID_ARGUMENT: bad shape"), FAMILY),
    (MemoryError(), FAMILY),
    (KeyError("x"), BUG),
    (ValueError("bad input"), BUG),
    (PlanCompileError("stage LogisticRegressionModel(p) failed CUDA graph "
                      "capture at bucket 8: RuntimeError: CUDA error: "
                      "out of memory"), BUG),
    (RuntimeError("CUDA error: device-side assert triggered"), BUG),
    (RuntimeError("CUDA error: misaligned address"), BUG),
    (RuntimeError("CUDA error: invalid argument"), FAMILY),
]


@pytest.mark.parametrize("exc,kind", CLASSIFY,
                         ids=[f"{type(e).__name__}-{i}"
                              for i, (e, _) in enumerate(CLASSIFY)])
def test_classify_error(exc, kind):
    assert classify_error(exc) == kind
    if "CUDA" not in str(exc) and "CUBLAS" not in str(exc) \
            and "capturing" not in str(exc) \
            and not isinstance(exc, PlanCompileError):
        assert jax_classify(exc) == kind        # the shared status names


def test_oom_type_is_transient():
    import torch
    assert classify_error(torch.cuda.OutOfMemoryError("CUDA OOM")) == \
        TRANSIENT


def test_retry_policy_matches_jax(monkeypatch):
    """Same backoff delays as the JAX package's; a transient error retries
    and a bug does not."""
    got, ref = RetryPolicy(seed=3), JaxRetry(seed=3)
    for attempt in range(4):
        assert got.delay_for(attempt, "plan-dispatch") == \
            ref.delay_for(attempt, "plan-dispatch")
    monkeypatch.setattr("time.sleep", lambda s: None)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("CUDA error: out of memory")
        return "ok"
    assert got.call(flaky, description="t") == "ok" and len(calls) == 3
    assert telemetry.counters()["retries"] == 2
    with pytest.raises(KeyError):
        got.call(lambda: {}["missing"])


def test_telemetry_ring_and_tracer_off_by_default(monkeypatch):
    """The event ring drops its oldest events and says so; the tracer is
    off unless configured, and then records the plan's spans."""
    monkeypatch.setenv("TX_TELEMETRY_EVENTS_CAP", "16")
    mark = telemetry.events_mark()
    for i in range(20):
        telemetry.event("e", i=i)
    assert telemetry.events_dropped() == 4
    since = telemetry.events_since(mark)
    assert since[0] == {"event": telemetry.OVERFLOW_EVENT, "dropped": 4}
    assert [e["i"] for e in since[1:]] == list(range(4, 20))
    assert not trace.enabled()
    assert trace.span("x") is trace.span("y")     # one shared no-op
    trace.configure(True)
    try:
        trace.reset()
        with trace.span("outer"):
            with trace.span("inner", rows=3):
                pass
        names = [s["name"] for s in trace.spans()]
        assert names == ["inner", "outer"]
        assert trace.spans()[0]["parent"] == trace.spans()[1]["sid"]
    finally:
        trace.configure(False)
        trace.reset()
