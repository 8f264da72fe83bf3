"""Self-healing serving of the PyTorch port (``serving/lifecycle.py``,
``runtime/refit.py``, ``PlanCache.swap_entry`` / ``rollback``) through the
drills of ``tests/test_lifecycle.py`` on the CPU, each held against the
JAX package's outcome on the same records:

- heal then roll back: a drifted stream degrades the sentinel, the
  background retrain's candidate passes the canary and hot-swaps with no
  request dropped and no compile after the prewarm, the other tenant
  keeps its original entry object and its answers; a post-swap fault
  rolls the swap back at once; the lane's transitions are the JAX
  drill's;
- a retrain OOM quarantines the lane and the old model serves on; a
  canary fault rejects the candidate; both with the JAX package's
  counters for the same plan and ring;
- a refit of the same window trains the candidate the JAX package trains
  (scores within 1e-6);
- without ``ServeConfig.lifecycle`` no manager exists and
  ``register_refit`` raises; ``register_refit`` round-trips its spec.

One small trained model serves the module (the JAX side trains its twin
once); its refits reuse the same small records.
"""
import collections
import time

import numpy as np
import pytest

from transmogrifai_tpu.features.builder import FeatureBuilder as JaxFB
from transmogrifai_tpu.models import LogisticRegression as JaxLR
from transmogrifai_tpu.ops import transmogrify as jax_transmogrify
from transmogrifai_tpu.runtime import FaultInjector as JaxFaultInjector
from transmogrifai_tpu.runtime import telemetry as jax_telemetry
from transmogrifai_tpu.runtime.context import (
    RuntimeContext as JaxRuntimeContext)
from transmogrifai_tpu.runtime.refit import run_refit as jax_run_refit
from transmogrifai_tpu.runtime.retry import RetryPolicy as JaxRetryPolicy
from transmogrifai_tpu.serving import LifecycleConfig as JaxLifecycleConfig
from transmogrifai_tpu.serving import ServeConfig as JaxServeConfig
from transmogrifai_tpu.serving import serve_in_process as jax_serve
from transmogrifai_tpu.types import PickList as JaxPickList
from transmogrifai_tpu.types import Real as JaxReal
from transmogrifai_tpu.types import RealNN as JaxRealNN
from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.models import LogisticRegression
from transmogrifai_tpu_torch.observability import trace
from transmogrifai_tpu_torch.ops import transmogrify
from transmogrifai_tpu_torch.runtime import FaultInjector, telemetry
from transmogrifai_tpu_torch.runtime.context import RuntimeContext
from transmogrifai_tpu_torch.runtime.refit import (
    RefitUnavailableError, labeled_rows, rebuild_training_workflow,
    run_refit)
from transmogrifai_tpu_torch.runtime.retry import RetryPolicy
from transmogrifai_tpu_torch.serving import (
    DriftThresholds, LifecycleConfig, ServeConfig, plan_compiles,
    serve_in_process)
from transmogrifai_tpu_torch.serving.lifecycle import ST_IDLE
from transmogrifai_tpu_torch.types import PickList, Real, RealNN
from transmogrifai_tpu_torch.workflow import Workflow

#: a refit's scores in the two packages (the same L-BFGS fit in float64)
REFIT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    jax_telemetry.reset()
    yield
    telemetry.reset()
    jax_telemetry.reset()


def _records(n=160, seed=5, shift=0.0):
    rng = np.random.default_rng(seed)
    cats = ["a", "b", "c"]
    recs = []
    for _ in range(n):
        x = float(rng.normal()) + shift
        z = float(rng.uniform(0, 4))
        recs.append({"x": x, "z": z,
                     "cat": cats[int(rng.integers(0, len(cats)))],
                     "label": float(x - shift + 0.5 * rng.normal() > 0)})
    return recs


def _dag(fb, real, real_nn, pick, tm, lr):
    x = fb.of("x", real).extract(lambda r: r.get("x")).as_predictor()
    z = fb.of("z", real_nn).extract(lambda r: r.get("z")).as_predictor()
    cat = fb.of("cat", pick).extract(lambda r: r.get("cat")).as_predictor()
    label = fb.of("label", real_nn).extract(
        lambda r: r.get("label")).as_response()
    return lr.set_input(label, tm([x, z, cat])).get_output()


@pytest.fixture(scope="module")
def trained():
    """(port model, records, prediction name, JAX model) on the same
    records."""
    recs = _records()
    pred = _dag(FeatureBuilder, Real, RealNN, PickList, transmogrify,
                LogisticRegression(reg_param=0.01, device="cpu"))
    model = (Workflow(device="cpu").set_result_features(pred)
             .set_input_records(recs).train())
    jpred = _dag(JaxFB, JaxReal, JaxRealNN, JaxPickList, jax_transmogrify,
                 JaxLR(reg_param=0.01))
    jmodel = (JaxWorkflow().set_result_features(jpred)
              .set_input_records(recs).train(validate="off"))
    return model, recs, pred.name, jmodel


def _drill_config(lifecycle_cls=LifecycleConfig, serve_cls=ServeConfig,
                  **overrides):
    """Aggressive thresholds and small batches so a drill converges fast:
    degrade after ~24 drifted rows, a short watch window, no cooldown
    inside one phase (the JAX drill's settings)."""
    lc = lifecycle_cls(
        retrain_budget_seconds=90.0, canary_rows=48, metric_slack=0.30,
        watch_batches=2, cooldown_seconds=300.0, **overrides)
    return serve_cls(max_wait_ms=5.0, max_batch=32, sentinel=True,
                     drift_thresholds=DriftThresholds(warn=0.2, degrade=0.5,
                                                      min_rows=24),
                     lifecycle=lc)


def _wait_counter(name, minimum=1, deadline=120.0, tick=None):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline:
        if telemetry.counters().get(name, 0) >= minimum:
            return True
        if tick is not None:
            tick()
        time.sleep(0.05)
    return False


def test_prediction_matches_jax(trained):
    """The served model and its JAX twin score the records alike, so the
    drills below start from the same model in both packages."""
    model, recs, pred, jmodel = trained
    got = np.asarray(model.score(recs[:32])[pred].probability)
    want = np.asarray(jmodel.score(recs[:32])[
        jmodel.result_features[0].name].probability)
    np.testing.assert_allclose(got, want, rtol=0, atol=REFIT_TOL)


class TestRefit:
    def test_rebuild_and_retrain_generically(self, trained):
        model, recs, pred, _ = trained
        wf = rebuild_training_workflow(model)
        assert wf.device.type == "cpu"
        fresh = wf.set_input_records([dict(r) for r in recs]).train()
        scored = fresh.score([dict(r) for r in recs[:16]])
        assert pred in scored and scored.n_rows == 16

    def test_labeled_rows_filters_unlabeled(self, trained):
        model, recs, _, _ = trained
        half = [dict(r) for r in recs[:8]]
        for r in half[:4]:
            r.pop("label")
        assert len(labeled_rows(model, half)) == 4

    def test_no_labeled_rows_is_refit_unavailable(self, trained):
        model, recs, _, _ = trained
        bare = [{k: v for k, v in r.items() if k != "label"}
                for r in recs[:8]]
        with pytest.raises(RefitUnavailableError, match="no labeled"):
            run_refit(model, bare, name="m")

    def test_refit_matches_jax(self, trained):
        """The same window refits the same candidate in both packages,
        stamped with its generation."""
        model, recs, pred, jmodel = trained
        window = [dict(r) for r in recs[:64]]
        result = run_refit(model, window, name="m", generation=7,
                           retry=RetryPolicy(max_attempts=1))
        ref = jax_run_refit(jmodel, window, name="m", generation=7,
                            retry=JaxRetryPolicy(max_attempts=1))
        assert result.model.trained_generation == 7
        assert (result.rows, result.resumed) == (ref.rows, ref.resumed)
        assert result.seconds > 0.0
        got = np.asarray(result.model.score(recs[64:96])[pred].probability)
        want = np.asarray(ref.model.score(recs[64:96])[
            jmodel.result_features[0].name].probability)
        np.testing.assert_allclose(got, want, rtol=0, atol=REFIT_TOL)


#: the lane's transitions through a heal and a rolled-back second cycle,
#: as the JAX package's drill walks them
HEAL_THEN_ROLLBACK = ["detect", "retrain_start", "retrain_end",
                      "canary_pass", "swap", "commit", "detect",
                      "retrain_start", "retrain_end", "canary_pass", "swap",
                      "rollback"]


class TestSelfHealDrill:
    def test_end_to_end_heal_then_fault_rollback(self, trained):
        model, recs, pred, _ = trained
        drifted = _records(n=96, seed=11, shift=5.0)
        server, client = serve_in_process({"m": model}, _drill_config(),
                                          device="cpu")
        trace.configure(True)
        answered = [0]

        def score(batch, tenant="a"):
            rows = client.score_many(batch, tenant=tenant)
            for row in rows:
                assert pred in row, f"dropped or failed request: {row}"
            answered[0] += len(rows)
            return rows

        try:
            entry0 = server.plans.get("m")
            warm = [dict(r) for r in recs[:32]]
            for size in (8, 16, 32):
                entry0.plan.score(warm[:size])
            baseline_b = score([dict(r) for r in recs[:16]], tenant="b")

            i = [0]

            def drift_tick():
                batch = [dict(r) for r in (drifted * 4)[i[0]:i[0] + 16]]
                i[0] += 16
                if i[0] >= len(drifted) * 4 - 16:
                    i[0] = 0
                score(batch)

            drift_tick()
            drift_tick()
            assert _wait_counter("lifecycle_detect", tick=drift_tick)
            assert _wait_counter("lifecycle_swaps", tick=drift_tick)
            c_after_swap = plan_compiles()
            assert _wait_counter("lifecycle_commits", tick=drift_tick)
            drift_tick()
            drift_tick()
            assert plan_compiles() == c_after_swap

            counters = telemetry.counters()
            for c in ("lifecycle_detect", "lifecycle_retrain_started",
                      "lifecycle_retrain_completed",
                      "lifecycle_canary_pass", "lifecycle_swaps",
                      "lifecycle_commits"):
                assert counters.get(c, 0) >= 1, c
            assert counters.get("lifecycle_rollbacks", 0) == 0
            span_names = {s["name"] for s in trace.spans()}
            assert {"lifecycle.retrain", "lifecycle.canary",
                    "lifecycle.swap"} <= span_names

            # the drifted tenant serves the swapped entry; tenant b and
            # the shared cache keep the original object and its answers
            assert server.plans.entry_for("m", "a") is not entry0
            assert server.plans.entry_for("m", "b") is entry0
            assert server.plans.get("m") is entry0
            assert server.plans.entry_for(
                "m", "a").model.trained_generation >= 1
            rows_b = score([dict(r) for r in recs[:16]], tenant="b")
            for row0, row1 in zip(baseline_b, rows_b):
                assert row0[pred] == row1[pred]
            snap = server.metrics_snapshot()
            assert snap["lifecycle"]["states"].get("m/a") == ST_IDLE
            assert snap["sentinels"]["m/a"]["rowsSeen"] > 0
            assert snap["counters"]["lifecycle_swaps"] >= 1

            # drift again (the fresh sentinel fingerprinted the shifted
            # window, so the original distribution now reads as drift)
            # with a post-swap fault armed: rollback
            healed = server.plans.entry_for("m", "a")
            server.lifecycle._cooldown_until.clear()
            mark = telemetry.events_mark()
            j = [0]

            def revert_tick():
                batch = [dict(r) for r in (recs * 4)[j[0]:j[0] + 16]]
                j[0] += 16
                if j[0] >= len(recs) * 4 - 16:
                    j[0] = 0
                score(batch)

            with FaultInjector.plan("lifecycle:m:postswap:1=bug"):
                assert _wait_counter("lifecycle_swaps", minimum=2,
                                     tick=revert_tick)
                assert _wait_counter("lifecycle_rollbacks",
                                     tick=revert_tick)
            assert server.plans.entry_for("m", "a") is healed
            ev = [e for e in telemetry.events_since(mark)
                  if e["event"] == "lifecycle"
                  and e.get("phase") == "rollback"]
            assert ev and "InjectedFamilyBug" in ev[0]["reason"]
            assert ev[0]["restored"] is True
            assert any(s["name"] == "lifecycle.rollback"
                       for s in trace.spans())
            phases = [h["phase"] for h in server.lifecycle.history
                      if h.get("tenant") == "a"]
            assert phases == HEAL_THEN_ROLLBACK
            score([dict(r) for r in recs[:16]])
            assert answered[0] >= 100
            assert server.describe()["requests"] == answered[0]
            assert server.metrics_snapshot()["failed_batches"] == 0
        finally:
            trace.configure(False)
            trace.reset()
            server.stop()


def _armed(model, recs, serve, config, runtime_cls, retry_cls, **kw):
    server, _client = serve({"m": model}, config, **kw)
    lc = server.lifecycle
    lc.runtime = runtime_cls(retry=retry_cls(max_attempts=2,
                                             base_delay=0.01,
                                             max_delay=0.02))
    key = ("m", "a")
    lc._rings[key] = collections.deque([dict(r) for r in recs[:32]],
                                       maxlen=48)
    return server, lc, key


LIFECYCLE_COUNTERS = ("lifecycle_retrain_failures",
                      "lifecycle_retrain_completed",
                      "lifecycle_canary_fail", "lifecycle_canary_pass",
                      "lifecycle_swaps")


@pytest.mark.parametrize("plan", ["lifecycle:m:retrain:*=oom",
                                  "lifecycle:m:canary:1=bug"])
def test_failure_drill_matches_jax(plan, trained):
    """A retrain OOM (retries exhausted) quarantines the lane and a canary
    fault rejects the candidate; in both the old entry keeps serving and
    the lane returns to idle, with the JAX package's counters and
    quarantine ledger for the same plan and ring."""
    model, recs, _, jmodel = trained
    outcome = {}
    for tag, m, serve, cfg, rt, retry, inj, tel, kw in (
            ("port", model, serve_in_process, _drill_config(),
             RuntimeContext, RetryPolicy, FaultInjector, telemetry,
             {"device": "cpu"}),
            ("jax", jmodel, jax_serve,
             _drill_config(JaxLifecycleConfig, JaxServeConfig),
             JaxRuntimeContext, JaxRetryPolicy, JaxFaultInjector,
             jax_telemetry, {})):
        server, lc, key = _armed(m, recs, serve, cfg, rt, retry, **kw)
        try:
            entry0 = server.plans.get("m")
            with inj.plan(plan):
                lc._heal(key, entry0, gen=1)
            assert server.plans.entry_for("m", "a") is entry0
            assert lc._states[key] == ST_IDLE
            counters = tel.counters()
            outcome[tag] = (
                {c: counters.get(c, 0) for c in LIFECYCLE_COUNTERS},
                [(r.family, r.kind) for r in lc.runtime.quarantined],
                server.metrics_snapshot()["lifecycle"]["quarantined"])
        finally:
            server.stop()
    assert outcome["port"] == outcome["jax"]
    counters, ledger, _ = outcome["port"]
    if "retrain" in plan:
        assert counters["lifecycle_retrain_failures"] == 1
        assert ledger == [("m/a", "transient")]
    else:
        assert counters["lifecycle_canary_fail"] == 1
        assert counters["lifecycle_retrain_completed"] == 1
    assert counters["lifecycle_swaps"] == 0


def test_canary_verdicts(trained):
    model, recs, _, _ = trained
    server, lc, _key = _armed(model, recs, serve_in_process,
                              _drill_config(), RuntimeContext, RetryPolicy,
                              device="cpu")
    try:
        entry0 = server.plans.get("m")
        empty = lc._canary("m", entry0, entry0.model, [])
        same = lc._canary("m", entry0, model, [dict(r) for r in recs[:24]])
    finally:
        server.stop()
    assert empty["pass"] is False and "empty" in empty["reason"]
    assert same["pass"] is True
    assert same["new_metric"] == same["old_metric"]


class TestOffByDefault:
    def test_no_lifecycle_config_means_no_manager(self, trained):
        model, _, _, _ = trained
        server, _client = serve_in_process(
            {"m": model}, ServeConfig(max_wait_ms=5.0, sentinel=False),
            device="cpu")
        try:
            assert server.lifecycle is None
            assert server.metrics_snapshot()["lifecycle"] is None
            with pytest.raises(ValueError, match="lifecycle"):
                server.register_refit("m")
        finally:
            server.stop()

    def test_swap_policy_validated(self):
        with pytest.raises(ValueError, match="swap_policy"):
            LifecycleConfig(swap_policy="global")

    def test_register_refit_round_trip(self, trained):
        model, recs, _, _ = trained
        server, _client = serve_in_process({"m": model}, _drill_config(),
                                           device="cpu")
        try:
            assert server.register_refit("m", base_records=recs[:8]) \
                is server
            spec = server.lifecycle.spec_for("m")
            assert len(spec.base_records) == 8
            assert server.lifecycle.spec_for("other").base_records is None
        finally:
            server.stop()
