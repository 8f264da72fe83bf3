"""The micro-batching serving loop of the PyTorch port (float64, CPU):
``serve_in_process`` answers concurrent single-record requests bitwise as
the offline ``ScoringPlan.score_guarded`` rows, with no new program after
warm-up, and within 1e-9 of the JAX package's server on the same model and
records (``TX_TUNE=off`` there, the static defaults the port takes);
deadline-or-full coalescing counts its dispatches right under a fixed
``target_batch``; quarantine reasons ride on the answers; one tenant's
breaker routes its batches to the host fallback while another tenant's
dispatch; a hung dispatch is orphaned at its deadline; the plan cache
evicts under its budget; the options whose modules are not ported raise by
name."""
import threading
import time

import numpy as np
import pytest

from transmogrifai_tpu.features.builder import FeatureBuilder as JaxBuilder
from transmogrifai_tpu.models import LogisticRegression as JaxLR
from transmogrifai_tpu.ops import transmogrify as jax_transmogrify
from transmogrifai_tpu.runtime import telemetry as jax_telemetry
from transmogrifai_tpu.serving import ServeConfig as JaxConfig
from transmogrifai_tpu.serving import serve_in_process as jax_serve
from transmogrifai_tpu.types import PickList as JaxPickList
from transmogrifai_tpu.types import Real as JaxReal
from transmogrifai_tpu.types import RealNN as JaxRealNN
from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.models import LogisticRegression
from transmogrifai_tpu_torch.ops import transmogrify
from transmogrifai_tpu_torch.runtime import telemetry
from transmogrifai_tpu_torch.serving import (CircuitBreaker,
                                             PlanCompileError, ScoringPlan,
                                             ServeConfig, ServeRejected,
                                             ServingServer, plan_compiles,
                                             serve_in_process)
from transmogrifai_tpu_torch.types import PickList, Real, RealNN
from transmogrifai_tpu_torch.workflow import Workflow


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


def _records(n=160, seed=5):
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


def _port_model():
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
    model = (Workflow(device="cpu").set_result_features(pred)
             .set_input_records(RECS).train())
    return model, pred.name


@pytest.fixture(scope="module")
def trained():
    return _port_model()


def _serve(model, **config):
    return serve_in_process({"m": model}, ServeConfig(**config),
                            device="cpu")


def _warm(server, up_to=64):
    """Run every bucket a batch of up to ``up_to`` rows can hit through
    the server's own resident plan."""
    plan = server.plans.get("m").plan
    size = 1
    while size <= up_to:
        plan.score(RECS[:size])
        size *= 2
    return plan


def test_concurrent_requests_bitwise_and_jax_parity(trained, monkeypatch):
    """64 concurrent requests: every answer is bitwise the offline
    ``score_guarded`` row and within 1e-9 of the JAX server's answer;
    no program is added after warm-up; the requests coalesced."""
    model, name = trained
    batch = [dict(r) for r in RECS[:64]]
    offline = (ScoringPlan(model).compile().with_guardrails()
               .score_guarded(batch).scored[name])
    server, client = _serve(model, max_wait_ms=10.0)
    try:
        _warm(server)
        client.score_many(batch[:16])
        c0 = plan_compiles()
        rows = client.score_many(batch)
        assert plan_compiles() == c0
        d = server.describe()
    finally:
        server.stop()
    for i, row in enumerate(rows):
        assert row[name] == dict(offline.boxed(i).value)
    assert d["requests"] == 80 and d["rows"] == 80
    assert d["mean_batch_occupancy"] > 2.0
    assert 0.0 <= d["dispatch_saturation"] <= 1.0

    monkeypatch.setenv("TX_TUNE", "off")
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
    jax_server, jax_client = jax_serve(
        {"m": ref}, JaxConfig(max_wait_ms=10.0))
    try:
        ref_rows = jax_client.score_many(batch)
        ref_snapshot = jax_server.metrics_snapshot()
    finally:
        jax_server.stop()
        jax_telemetry.reset()
    for row, ref_row in zip(rows, ref_rows):
        got, want = row[name], ref_row[ref_pred.name]
        assert got["prediction"] == want["prediction"]
        for key in want:
            assert got[key] == pytest.approx(want[key], abs=1e-9)
    # the live metrics document keeps the JAX package's keys
    server, client = _serve(model)
    try:
        client.score(dict(RECS[0]))
        snapshot = server.metrics_snapshot()
    finally:
        server.stop()
    assert set(snapshot) == set(ref_snapshot)
    assert set(snapshot["process"]) == set(ref_snapshot["process"])
    assert snapshot["latency_ms"]["default"]["count"] == 1
    assert snapshot["breakers"] == {"m/default": "closed"}


def test_deadline_or_full(trained):
    """Under a fixed ``target_batch`` of 4: 2 requests wait for the
    deadline; 8 fill the target and dispatch early."""
    model, _ = trained
    server, client = _serve(model, max_wait_ms=60.0, target_batch=4)
    try:
        _warm(server, up_to=8)
        t0 = time.perf_counter()
        client.score_many(RECS[:2])
        assert time.perf_counter() - t0 >= 0.055
        assert server.stats["deadline_dispatches"] == 1
        assert server.stats["full_dispatches"] == 0
        t0 = time.perf_counter()
        client.score_many(RECS[:8])
        assert server.stats["full_dispatches"] >= 1
        assert time.perf_counter() - t0 < 0.5
        assert server.stats["requests"] == 10 and server.stats["rows"] == 10
        assert server.stats["batches"] == server.stats["full_dispatches"] \
            + server.stats["deadline_dispatches"]
    finally:
        server.stop()


def test_quarantine_reasons_per_request(trained):
    model, name = trained
    bad = {"x": "not-a-number", "z": None, "cat": "a"}
    server, client = _serve(model, max_wait_ms=10.0)
    try:
        rows = client.score_many([dict(r) for r in RECS[:6]] + [bad])
    finally:
        server.stop()
    assert all("_guard" not in r for r in rows[:6])
    assert rows[6][name] is None
    assert {g["code"] for g in rows[6]["_guard"]} == {"wrong_type",
                                                      "missing_field"}
    assert telemetry.counters()["serving_rows_quarantined"] == 1


def test_breaker_isolates_tenants(trained, monkeypatch):
    """Tenant A's device failures trip its breaker: its batches go to the
    host fallback while tenant B's dispatch to the device; after the
    cooldown a probe recovers A."""
    monkeypatch.setenv("TX_RETRY_MAX_ATTEMPTS", "1")
    model, name = trained
    clock = {"t": 0.0}
    failing = {"on": False}
    real = ScoringPlan._run_bucket

    def flaky(self, *args):
        if failing["on"]:
            raise RuntimeError("CUDA error: out of memory")
        return real(self, *args)
    monkeypatch.setattr(ScoringPlan, "_run_bucket", flaky)
    server, client = _serve(
        model, breaker_factory=lambda: CircuitBreaker(
            failure_threshold=2, cooldown_seconds=30.0,
            clock=lambda: clock["t"]))
    r = dict(RECS[0])
    try:
        failing["on"] = True
        a1 = client.score(r, tenant="A")
        a2 = client.score(r, tenant="A")
        failing["on"] = False
        assert a1["_host_fallback"] and a2["_host_fallback"]
        assert a1[name]["prediction"] in (0.0, 1.0)
        fa = client.submit(r, tenant="A")
        fb = [client.submit(dict(RECS[i]), tenant="B") for i in range(4)]
        assert fa.result(timeout=30)["_host_fallback"]
        assert all("_host_fallback" not in f.result(timeout=30)
                   for f in fb)
        counters = telemetry.counters()
        assert counters["breaker_trips"] == 1
        assert counters["serving_device_failures"] == 2
        assert counters["serving_breaker_short_circuits"] == 1
        clock["t"] = 31.0
        assert "_host_fallback" not in client.score(r, tenant="A")
        assert telemetry.counters()["breaker_recoveries"] == 1
        breakers = server.metrics_snapshot()["breakers"]
        assert breakers == {"m/A": "closed", "m/B": "closed"}
    finally:
        server.stop()


def test_capture_failure_propagates_to_the_request(trained, monkeypatch):
    """A bucket whose graph fails to capture fails its requests with the
    PlanCompileError: the batch is not served on the host, and the
    tenant's breaker does not move."""
    model, _ = trained
    fail = {"on": True}
    real = ScoringPlan._run_bucket

    def capture_fails(self, bucket, *args):
        if fail["on"]:
            raise PlanCompileError(
                f"stage LogisticRegressionModel(p) failed CUDA graph "
                f"capture at bucket {bucket}: KeyError: 'x'")
        return real(self, bucket, *args)
    monkeypatch.setattr(ScoringPlan, "_run_bucket", capture_fails)
    server, client = _serve(model)
    try:
        with pytest.raises(PlanCompileError, match="graph capture"):
            client.score(dict(RECS[0]))
        counters = telemetry.counters()
        assert counters.get("serving_host_fallback_batches", 0) == 0
        assert counters.get("serving_device_failures", 0) == 0
        assert counters["serve_batch_failures"] == 1
        assert server.metrics_snapshot()["breakers"] == {
            "m/default": "closed"}
        fail["on"] = False
        assert "_host_fallback" not in client.score(dict(RECS[1]))
    finally:
        server.stop()


def test_hung_dispatch_is_orphaned(trained, monkeypatch):
    """A dispatch still running at the deadline is abandoned: the request
    is answered by the host fallback before the hang ends, and the next
    batch dispatches on a fresh device executor."""
    monkeypatch.setenv("TX_RETRY_MAX_ATTEMPTS", "1")
    model, name = trained
    release = threading.Event()
    hang = {"once": True}
    real = ScoringPlan._run_bucket

    def stuck(self, *args):
        if hang.pop("once", False):
            release.wait(5.0)
        return real(self, *args)
    monkeypatch.setattr(ScoringPlan, "_run_bucket", stuck)
    server, client = _serve(model, deadline_seconds=0.25)
    try:
        t0 = time.perf_counter()
        row = client.score(dict(RECS[0]))
        elapsed = time.perf_counter() - t0
        assert row["_host_fallback"] and elapsed < 2.0
        assert server.stats["orphaned_dispatches"] == 1
        assert telemetry.counters()["serving_deadline_exceeded"] == 1
        assert "_host_fallback" not in client.score(dict(RECS[1]))
    finally:
        release.set()
        server.stop()


def test_plan_cache_lru_eviction(trained):
    """Two models under a budget of one: each switch evicts the other
    (counted) and recompiles it on next use; both keep answering."""
    model, name = trained
    server = ServingServer(ServeConfig(plan_budget=1, max_wait_ms=1.0),
                           device="cpu")
    server.add_model("a", model).add_model("b", model)
    client = server.start_background()
    try:
        for m in ("a", "b", "a"):
            assert client.score(dict(RECS[0]), model=m)[name]
        assert server.plans.evictions == 2 and server.plans.misses == 3
        assert server.describe()["plan_cache"]["resident"] == 1
        with pytest.raises(ServeRejected, match="unknown model"):
            client.score(dict(RECS[0]), model="nope")
    finally:
        server.stop()


def test_target_from_profile_and_prewarm(trained):
    """With no explicit target the coalescer takes the largest bucket
    whose recorded dispatch cost fits the wait budget; ``prewarm`` runs
    the named buckets before traffic (none by default)."""
    model, _ = trained
    server = ServingServer(ServeConfig(max_batch=32, max_wait_ms=1000.0),
                           device="cpu")
    server.add_model("m", model)
    assert server.prewarm() == {}
    warmed = server.prewarm(buckets=[8, 16, 32, 64])
    assert sorted(warmed["m"]) == [8, 16, 32]
    plan = server.plans.get("m").plan
    assert server._target_batch(plan) == 32        # nothing dispatched
    plan.score(RECS[:16])
    assert server._target_batch(plan) == 16
    server.config.max_wait_ms = 0.0
    assert server._target_batch(plan) == 32        # the static default
    server.config.target_batch = 4
    assert server._target_batch(plan) == 4


def test_drain_refuses_new_requests(trained):
    import asyncio
    from transmogrifai_tpu_torch.serving import ServeDraining
    model, _ = trained
    server, client = _serve(model)
    try:
        client.score(dict(RECS[0]))
        out = asyncio.run_coroutine_threadsafe(
            server.drain(timeout=5.0), server.loop).result(10)
        assert out["drained"] and out["inflight"] == 0
        with pytest.raises(ServeDraining):
            client.score(dict(RECS[1]))
    finally:
        server.stop()


def test_sentinel_default_raises_by_name(trained):
    """``ServeConfig()`` keeps the JAX package's ``sentinel=True`` and
    serves: each tenant's drift sentinel observes the answered rows and
    reports in the metrics snapshot; ``guardrails=False`` serves with no
    sentinel."""
    model, name = trained
    server, client = serve_in_process({"m": model}, ServeConfig(),
                                      device="cpu")
    try:
        rows = client.score_many([dict(r) for r in RECS[:60]])
        lanes = server.metrics_snapshot()["sentinels"]
    finally:
        server.stop()
    assert all(r[name]["prediction"] in (0.0, 1.0) for r in rows)
    (lane,) = lanes.values()
    assert lane["rowsSeen"] == 60 and set(lane["features"]) == {
        "x", "z", "cat"}
    server, client = serve_in_process(
        {"m": model}, ServeConfig(guardrails=False), device="cpu")
    try:
        row = client.score(dict(RECS[0]))
        assert server.metrics_snapshot()["sentinels"] == {}
    finally:
        server.stop()
    assert row[name]["prediction"] in (0.0, 1.0) and "_guard" not in row
