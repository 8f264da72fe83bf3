"""The fault-tolerant search runtime of the PyTorch port
(``transmogrifai_tpu_torch/runtime/``, the validator, racing, the
selector and ``Workflow.train(resume_from=...)``) held to the contracts of
``tests/test_resilience.py`` and against the JAX package on the same
seeded numpy inputs, in float64 on the CPU.

- the classifier, the retry policy, the injector and the journal's units;
- the same fault plans quarantine the same families with the same kinds
  and retries in both packages, and the survivors' metric vectors agree
  within 1e-9 with the same winner; all-failed searches raise one
  ``AllFamiliesFailedError`` naming every family in both;
- kill and resume under exact CV and racing: the resumed winner and every
  metric vector equal the clean run's bit for bit, and no journaled
  (family, rung) entry is dispatched again;
- retry-then-succeed equals a clean run; a hung family is abandoned at its
  deadline; the ``workflow:save:save`` crash leaves the old model
  reloadable; a summary without faults has the pre-runtime keys, the
  same bytes twice;
- the port's ``search_fingerprint`` is the JAX package's hex digest for the
  same pool, validator and float64 arrays, and a journal the JAX package
  wrote resumes the port's search with zero dispatches and its winner.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from transmogrifai_tpu.evaluators import (
    BinaryClassificationEvaluator as JaxEvaluator)
from transmogrifai_tpu.models import LinearSVC as JaxSVC
from transmogrifai_tpu.models import LogisticRegression as JaxLR
from transmogrifai_tpu.runtime import FaultInjector as JaxFaultInjector
from transmogrifai_tpu.runtime import RetryPolicy as JaxRetryPolicy
from transmogrifai_tpu.runtime import telemetry as jax_telemetry
from transmogrifai_tpu.runtime.errors import (
    AllFamiliesFailedError as JaxAllFailed)
from transmogrifai_tpu.runtime.journal import (
    search_fingerprint as jax_search_fingerprint)
from transmogrifai_tpu.selector import CrossValidation as JaxCV
from transmogrifai_tpu.selector import RacingCrossValidation as JaxRacing
from transmogrifai_tpu_torch.evaluators import BinaryClassificationEvaluator
from transmogrifai_tpu_torch.features import FeatureBuilder
from transmogrifai_tpu_torch.models import LinearSVC, LogisticRegression
from transmogrifai_tpu_torch.ops import transmogrify
from transmogrifai_tpu_torch.runtime import (
    AllFamiliesFailedError, FaultInjector, KillPoint, QuarantineRecord,
    RetryPolicy, classify_error, read_journal, telemetry)
from transmogrifai_tpu_torch.runtime.faults import (
    InjectedFamilyBug, InjectedOom, InjectedPreemption, maybe_inject)
from transmogrifai_tpu_torch.runtime.journal import (
    JOURNAL_NAME, SearchJournal, search_fingerprint)
from transmogrifai_tpu_torch.selector import (
    CrossValidation, ModelSelector, RacingCrossValidation, SelectedModel)
from transmogrifai_tpu_torch.types import Real, RealNN
from transmogrifai_tpu_torch.utils.listener import WorkflowListener
from transmogrifai_tpu_torch.workflow import Workflow
from transmogrifai_tpu_torch.workflow.persistence import load_model

#: the two packages' survivors' metrics on the same fault plan
METRIC_TOL = 1e-9
LR_GRID = [{"reg_param": 0.001}, {"reg_param": 0.01}, {"reg_param": 1.0}]
SVC_GRID = [{"reg_param": 0.01}, {"reg_param": 10.0}]


def _binary(seed=42, n=300, d=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = ((X[:, 0] * 2 - X[:, 1] + rng.logistic(size=n) * 0.5) > 0
         ).astype(float)
    return X, y


def _pool():
    return [(LogisticRegression(device="cpu"), LR_GRID),
            (LinearSVC(device="cpu"), SVC_GRID)]


def _jax_pool():
    return [(JaxLR(), LR_GRID), (JaxSVC(), SVC_GRID)]


def _cv(**kw):
    return CrossValidation(BinaryClassificationEvaluator(), num_folds=3,
                           seed=7, **kw)


def _jax_cv():
    return JaxCV(JaxEvaluator(), num_folds=3, seed=7)


def _racing():
    return RacingCrossValidation(BinaryClassificationEvaluator(),
                                 num_folds=3, seed=7, eta=2,
                                 min_fidelity=0.25)


def _by_key(results):
    return {(r.model_name, r.grid_index): r.metric_values for r in results}


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    jax_telemetry.reset()
    yield
    telemetry.reset()
    jax_telemetry.reset()


@pytest.fixture(scope="module")
def clean():
    """The port's and the JAX package's clean exact searches."""
    X, y = _binary()
    return _cv().validate(_pool(), X, y), _jax_cv().validate(
        _jax_pool(), X, y)


# ---------------------------------------------------------------------------
# units: classifier, retry, injector, journal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exc,kind", [
    (InjectedOom("x"), "transient"),
    (InjectedPreemption("x"), "transient"),
    (ConnectionError("reset"), "transient"),
    (RuntimeError("RESOURCE_EXHAUSTED: oom"), "transient"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory."), "transient"),
    (InjectedFamilyBug("x"), "family"),
    (MemoryError(), "family"),
    (FloatingPointError("nan"), "family"),
    (RuntimeError("CUDA error: an illegal memory access was "
                  "encountered"), "bug"),
    (KeyError("oops"), "bug"),
    (TypeError("bad arg"), "bug"),
])
def test_classifier(exc, kind):
    """The fault kinds classify as their real counterparts; an injected
    OOM is a torch.cuda.OutOfMemoryError; a sticky CUDA error is a bug,
    never quarantined."""
    assert classify_error(exc) == kind
    assert isinstance(InjectedOom("x"), torch.cuda.OutOfMemoryError)


def test_family_precondition_is_family():
    from transmogrifai_tpu_torch.models.base import FamilyPreconditionError
    assert classify_error(FamilyPreconditionError("neg")) == "family"


class TestRetryAndInjector:
    def test_retries_transient_then_succeeds(self):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise InjectedPreemption("t")
            return "ok"

        seen = []
        p = RetryPolicy(max_attempts=3, base_delay=0.001)
        assert p.call(flaky, on_retry=lambda a, e: seen.append(a)) == "ok"
        assert calls["n"] == 3 and seen == [0, 1]

    def test_does_not_retry_bugs(self):
        calls = {"n": 0}

        def bug():
            calls["n"] += 1
            raise KeyError("bug")

        with pytest.raises(KeyError):
            RetryPolicy(max_attempts=5, base_delay=0.001).call(bug)
        assert calls["n"] == 1

    def test_jitter_matches_jax(self):
        p, q = RetryPolicy(seed=3), JaxRetryPolicy(seed=3)
        assert p.delay_for(1, "x") == q.delay_for(1, "x")
        assert p.delay_for(1, "x") != p.delay_for(1, "y")

    def test_plan_parse_rejects_garbage(self):
        with pytest.raises(ValueError):
            FaultInjector("nonsense")
        with pytest.raises(ValueError):
            FaultInjector("family:A:dispatch:0=oom")

    def test_fires_at_exact_nth_occurrence(self):
        with FaultInjector.plan("family:A:dispatch:2=oom") as inj:
            assert inj.check("family", "A", "dispatch") is None
            with pytest.raises(InjectedOom):
                inj.check("family", "A", "dispatch")
            assert inj.check("family", "A", "dispatch") is None

    def test_wildcards_and_caller_handled_faults(self):
        with FaultInjector.plan("family:*:metric:*=nan,"
                                "state:m:snapshot:1=torn,"
                                "admission:m:enqueue:1=burst:64") as inj:
            assert inj.check("family", "Z", "metric") == "nan"
            assert inj.check("family", "Z", "dispatch") is None
            assert inj.check("state", "m", "snapshot") == "torn"
            assert inj.check("admission", "m", "enqueue") == "burst:64"

    def test_kill_is_not_an_exception(self):
        with FaultInjector.plan("rung:0:boundary:1=kill"):
            with pytest.raises(KillPoint):
                maybe_inject("rung", "0", "boundary")
        assert not issubclass(KillPoint, Exception)

    def test_env_plan_activation(self, monkeypatch):
        monkeypatch.setenv("TX_FAULT_PLAN", "family:E:metric:1=nan")
        assert maybe_inject("family", "E", "metric") == "nan"
        monkeypatch.delenv("TX_FAULT_PLAN")
        assert maybe_inject("family", "E", "metric") is None


class TestSearchJournal:
    def test_round_trip_is_bit_exact(self, tmp_path):
        j = SearchJournal(str(tmp_path)).open("fp1")
        vals = [[0.1 + 1e-17, float("nan")], [2.0 / 3.0, 0.953267196814]]
        j.record("0:LR", "rung0", [0, 2], vals, folds=2)
        j.close()
        j2 = SearchJournal(str(tmp_path)).open("fp1")
        got = j2.lookup("0:LR", "rung0", [0, 2])
        assert got[0][0] == vals[0][0] and np.isnan(got[0][1])
        assert got[1] == vals[1]
        assert j2.lookup("0:LR", "rung0", [0, 1]) is None
        j2.close()

    def test_fingerprint_mismatch_rotates_stale(self, tmp_path):
        j = SearchJournal(str(tmp_path)).open("fp1")
        j.record("0:LR", "exact", [0], [[1.0]], folds=1)
        j.close()
        j2 = SearchJournal(str(tmp_path)).open("fp2")
        assert j2.lookup("0:LR", "exact", [0]) is None
        assert os.path.exists(j2.path + ".stale")
        j2.close()

    def test_torn_tail_is_dropped(self, tmp_path):
        j = SearchJournal(str(tmp_path)).open("fp1")
        j.record("0:LR", "exact", [0], [[1.0]], folds=1)
        j.close()
        with open(j.path, "a") as fh:
            fh.write('{"kind": "eval", "family": "1:SVC", "ru')
        j2 = SearchJournal(str(tmp_path)).open("fp1")
        assert j2.lookup("0:LR", "exact", [0]) == [[1.0]]
        assert j2.lookup("1:SVC", "exact", [0]) is None
        j2.close()

    def test_fingerprint_sensitivity_and_jax_digest(self):
        """The port's fingerprint reacts to the pool, the protocol and the
        data, and equals the JAX package's hex digest on float64 arrays,
        for numpy and for a CPU tensor alike; a float32 matrix (the
        card's) fingerprints otherwise."""
        X, y = _binary()
        p = {"numFolds": 3, "seed": 7, "stratify": False,
             "validationType": "CrossValidation"}
        fp = search_fingerprint(_pool(), p, X, y)
        assert fp == jax_search_fingerprint(_jax_pool(), dict(p), X, y)
        assert fp == search_fingerprint(_pool(), p, torch.from_numpy(X), y)
        assert fp != search_fingerprint(_pool(), p,
                                        torch.from_numpy(X).float(), y)
        assert fp != search_fingerprint(_pool(), dict(p, seed=8), X, y)
        assert fp != search_fingerprint(_pool(), p, X, 1.0 - y)
        assert fp != search_fingerprint(_pool()[:1], p, X, y)

    def test_validator_fingerprints_match_jax(self, tmp_path):
        """The exact and racing validators key their journals with the
        JAX package's fingerprint of the same search."""
        X, y = _binary()
        for port_v, jax_v in (
                (_cv(), _jax_cv()),
                (_racing(), JaxRacing(JaxEvaluator(), num_folds=3, seed=7,
                                      eta=2, min_fidelity=0.25))):
            for v in (port_v, jax_v):
                v.checkpoint_dir = str(tmp_path / type(v).__module__)
            port_v._begin_runtime(_pool(), X, y).close_journal()
            jax_v._begin_runtime(_jax_pool(), X, y).close_journal()
            assert port_v.last_runtime.journal.fingerprint == \
                jax_v.last_runtime.journal.fingerprint


# ---------------------------------------------------------------------------
# quarantine, retry, deadline: the port against the JAX package
# ---------------------------------------------------------------------------

PLANS = [("family:LinearSVC:dispatch:*=oom", 2),
         ("family:LinearSVC:metric:1=nan", 1),
         ("family:LogisticRegression:dispatch:*=bug", 1),
         ("family:LogisticRegression:dispatch:1=preempt", 3)]


@pytest.mark.parametrize("plan,attempts", PLANS,
                         ids=[p for p, _ in PLANS])
def test_quarantine_matches_jax(plan, attempts):
    """The same plan quarantines the same families with the same kinds,
    error classes and retries in both packages; the survivors'
    metric vectors agree within METRIC_TOL, with the same winner."""
    X, y = _binary()
    port_v, jax_v = _cv(), _jax_cv()
    port_v.retry_policy = RetryPolicy(max_attempts=attempts,
                                      base_delay=0.001)
    jax_v.retry_policy = JaxRetryPolicy(max_attempts=attempts,
                                        base_delay=0.001)
    with FaultInjector.plan(plan):
        port = port_v.validate(_pool(), X, y)
    with JaxFaultInjector.plan(plan):
        ref = jax_v.validate(_jax_pool(), X, y)

    def ledger(v):
        return [(r.family, r.kind, r.error_type, r.retries, r.rung)
                for r in v.last_runtime.quarantined]

    assert ledger(port_v) == ledger(jax_v)
    assert port.name == ref.name and port.params == ref.params
    want_m = _by_key(ref.results)
    assert set(_by_key(port.results)) == set(want_m)
    for key, vals in _by_key(port.results).items():
        np.testing.assert_allclose(vals, want_m[key], rtol=0,
                                   atol=METRIC_TOL)
    if "preempt" in plan:
        assert telemetry.counters()["retries"] == 1
        assert port_v.last_runtime.quarantined == []


def test_all_families_failed_matches_jax():
    X, y = _binary()
    port_v, jax_v = _cv(), _jax_cv()
    port_v.retry_policy = RetryPolicy(max_attempts=1)
    jax_v.retry_policy = JaxRetryPolicy(max_attempts=1)
    with pytest.raises(AllFamiliesFailedError) as port_err:
        with FaultInjector.plan("family:*:dispatch:*=oom"):
            port_v.validate(_pool(), X, y)
    with pytest.raises(JaxAllFailed) as jax_err:
        with JaxFaultInjector.plan("family:*:dispatch:*=oom"):
            jax_v.validate(_jax_pool(), X, y)
    assert sorted(r.family for r in port_err.value.records) == \
        sorted(r.family for r in jax_err.value.records) == \
        ["LinearSVC", "LogisticRegression"]
    assert {r.kind for r in port_err.value.records} == {"transient"}
    msg = str(port_err.value)
    assert "LogisticRegression" in msg and "LinearSVC" in msg


def test_retry_then_succeed_matches_clean_run(clean):
    X, y = _binary()
    port_clean, jax_clean = clean
    v = _cv()
    v.retry_policy = RetryPolicy(max_attempts=3, base_delay=0.001)
    with FaultInjector.plan("family:LogisticRegression:dispatch:1=preempt"):
        best = v.validate(_pool(), X, y)
    assert telemetry.counters()["retries"] == 1
    assert v.last_runtime.quarantined == []
    assert (best.name, best.params, best.metric) == \
        (port_clean.name, port_clean.params, port_clean.metric)
    assert best.name == jax_clean.name
    assert abs(best.metric - jax_clean.metric) <= METRIC_TOL


def test_deadline_abandons_hung_family(tmp_path):
    """The hung family is quarantined at its deadline; its worker thread,
    which ends after it, reaches neither the results nor the journal."""
    X, y = _binary()
    pool = _pool()
    lr_only = _cv().validate(pool[:1], X, y)
    v = _cv()
    v.checkpoint_dir = str(tmp_path)
    # a deadline with room for LR's search on a loaded host, and a hang
    # well past it
    v.family_deadline = 1.5
    v.retry_policy = RetryPolicy(max_attempts=1)
    t0 = time.perf_counter()
    with FaultInjector.plan("family:LinearSVC:dispatch:*=hang:4"):
        best = v.validate(pool, X, y)
    wall = time.perf_counter() - t0
    recs = v.last_runtime.quarantined
    assert [(r.family, r.kind) for r in recs] == [("LinearSVC", "deadline")]
    assert "deadline" in recs[0].reason
    assert wall < 3.9
    assert (best.name, best.metric) == (lr_only.name, lr_only.metric)
    assert all(r.model_name != "LinearSVC" for r in best.results)
    # the abandoned worker sleeps on; let it end before the process does
    for th in threading.enumerate():
        if th.name == "tx-family-deadline":
            th.join(timeout=10.0)
            assert not th.is_alive()
    assert [e["family"] for e in read_journal(str(tmp_path))["entries"]] \
        == ["0:LogisticRegression"]


def test_bug_propagates(monkeypatch):
    X, y = _binary()

    def broken(self, *a, **k):
        raise TypeError("genuine kernel bug")

    monkeypatch.setattr(LogisticRegression, "eval_fold_grid_arrays", broken)
    with pytest.raises(TypeError, match="genuine kernel bug"):
        _cv().validate(_pool(), X, y)


def test_host_path_fit_fault_quarantines():
    """The ``fit`` site covers the candidate-by-candidate host path."""

    class SeqLR(LogisticRegression):
        def fit_fold_grid_arrays(self, *a, **k):
            raise NotImplementedError

        def eval_fold_grid_arrays(self, *a, **k):
            raise NotImplementedError

    X, y = _binary()
    v = _cv()
    v.retry_policy = RetryPolicy(max_attempts=1)
    pool = [(SeqLR(device="cpu"), [{"reg_param": 0.01}]),
            (LinearSVC(device="cpu"), [{"reg_param": 0.01}])]
    with FaultInjector.plan("family:SeqLR:fit:*=oom"):
        best = v.validate(pool, X, y)
    assert [r.family for r in v.last_runtime.quarantined] == ["SeqLR"]
    assert best.name == "LinearSVC"


def test_quarantine_record_json_round_trip():
    rec = QuarantineRecord("GBTClassifier", "CUDA out of memory",
                           kind="transient", error_type="OutOfMemoryError",
                           rung=1, retries=2)
    d = rec.to_json()
    assert set(d) == {"family", "reason", "kind", "errorType", "retries",
                      "rung"}
    assert QuarantineRecord.from_json(d) == rec
    assert "after 2 retries" in str(rec)


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------

def _journaled_keys(ckpt):
    return {(e["family"], e["rung"])
            for e in read_journal(str(ckpt))["entries"]}


def _assert_bitwise(resumed, ref, racing=False):
    assert (resumed.name, resumed.params) == (ref.name, ref.params)
    assert resumed.metric == ref.metric
    want = {(r.model_name, r.grid_index): (r.metric_values, r.rung,
                                           r.pruned_at)
            for r in ref.results}
    assert len(resumed.results) == len(want)
    for r in resumed.results:
        vals, rung, pruned = want[(r.model_name, r.grid_index)]
        assert r.metric_values == vals
        if racing:
            assert (r.rung, r.pruned_at) == (rung, pruned)


@pytest.mark.parametrize("validation", ["exact", "racing"])
def test_kill_and_resume_bitwise(validation, tmp_path, clean):
    X, y = _binary()
    make = _cv if validation == "exact" else _racing
    ref = clean[0] if validation == "exact" else make().validate(
        _pool(), X, y)
    kill = ("family:LinearSVC:dispatch:1=kill" if validation == "exact"
            else "rung:1:boundary:1=kill")
    ckpt = str(tmp_path / "ckpt")
    v1 = make()
    v1.checkpoint_dir = ckpt
    with pytest.raises(KillPoint):
        with FaultInjector.plan(kill):
            v1.validate(_pool(), X, y)
    journaled = _journaled_keys(ckpt)
    assert journaled
    if validation == "racing":
        assert all(rung == "rung0" for _, rung in journaled)
    telemetry.reset()
    v2 = make()
    v2.checkpoint_dir = ckpt
    resumed = v2.validate(_pool(), X, y)
    _assert_bitwise(resumed, ref, racing=validation == "racing")
    redispatched = {(k, rung) for k, rung, _, _ in telemetry.dispatch_log()}
    assert redispatched and redispatched.isdisjoint(journaled)
    assert telemetry.counters()["journal_hits"] >= len(journaled)
    if validation == "exact":
        assert resumed.name == clean[1].name


def test_completed_journal_dispatches_nothing(tmp_path):
    X, y = _binary()
    ckpt = str(tmp_path / "ckpt")
    v1 = _cv()
    v1.checkpoint_dir = ckpt
    first = v1.validate(_pool(), X, y)
    info = read_journal(ckpt)
    assert info["resumeSavedFoldFits"] == (len(LR_GRID) + len(SVC_GRID)) * 3
    telemetry.reset()
    v2 = _cv()
    v2.checkpoint_dir = ckpt
    again = v2.validate(_pool(), X, y)
    assert telemetry.dispatch_log() == []
    assert again.metric == first.metric


def test_stale_journal_is_not_replayed(tmp_path):
    X, y = _binary()
    ckpt = str(tmp_path / "ckpt")
    v1 = _cv()
    v1.checkpoint_dir = ckpt
    v1.validate(_pool(), X, y)
    telemetry.reset()
    v2 = CrossValidation(BinaryClassificationEvaluator(), num_folds=3,
                         seed=8)
    v2.checkpoint_dir = ckpt
    v2.validate(_pool(), X, y)
    assert telemetry.counters().get("journal_hits", 0) == 0
    assert telemetry.dispatch_log()


def test_jax_journal_resumes_port_search(tmp_path, clean):
    """A journal the JAX package wrote on the CPU resumes the port's
    search with zero dispatches, to the JAX package's winner and metrics
    bit for bit (the replayed vectors are the JAX package's)."""
    X, y = _binary()
    ckpt = str(tmp_path / "ckpt")
    jax_v = _jax_cv()
    jax_v.checkpoint_dir = ckpt
    ref = jax_v.validate(_jax_pool(), X, y)
    assert os.path.exists(os.path.join(ckpt, JOURNAL_NAME))
    v = _cv()
    v.checkpoint_dir = ckpt
    resumed = v.validate(_pool(), X, y)
    assert telemetry.dispatch_log() == []
    assert telemetry.counters()["journal_hits"] == 2
    _assert_bitwise(resumed, ref)


# ---------------------------------------------------------------------------
# the workflow: train(resume_from=...), summaries, listener, atomic save
# ---------------------------------------------------------------------------

def _records(n=150, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n):
        a, b = rng.normal(), rng.normal()
        recs.append({"a": float(a), "b": float(b),
                     "label": float(a * 2 - b + rng.logistic() * 0.5 > 0)})
    return recs


def _features():
    a = FeatureBuilder.of("a", Real).extract(
        lambda r: r.get("a")).as_predictor()
    b = FeatureBuilder.of("b", Real).extract(
        lambda r: r.get("b")).as_predictor()
    label = FeatureBuilder.of("label", RealNN).extract(
        lambda r: r.get("label")).as_response()
    return label, transmogrify([a, b])


def _workflow(validation="exact", checkpoint_dir=None):
    label, feats = _features()
    selector = ModelSelector(
        models=_pool(), validator=_cv(), validation=validation, eta=2,
        min_fidelity=0.25, checkpoint_dir=checkpoint_dir, device="cpu",
        retry_policy=RetryPolicy(max_attempts=2, base_delay=0.001))
    pred = selector.set_input(label, feats).get_output()
    return (Workflow(device="cpu").set_result_features(pred)
            .set_input_records(_records()))


def _summary(model):
    for s in model.stages():
        if isinstance(s, SelectedModel) and s.summary is not None:
            return s.summary
    raise AssertionError("no SelectedModel in the trained workflow")


@pytest.fixture(scope="module")
def wf_clean():
    return {v: _summary(_workflow(validation=v).train())
            for v in ("exact", "racing")}


@pytest.mark.parametrize("validation", ["exact", "racing"])
def test_train_resume_from_bitwise_winner(validation, tmp_path, wf_clean):
    ref = wf_clean[validation]
    ckpt = str(tmp_path / "ckpt")
    kill = ("family:LinearSVC:dispatch:1=kill" if validation == "exact"
            else "rung:1:boundary:1=kill")
    with pytest.raises(KillPoint):
        with FaultInjector.plan(kill):
            _workflow(validation=validation, checkpoint_dir=ckpt).train()
    journaled = _journaled_keys(ckpt)
    assert journaled
    telemetry.reset()
    resumed = _summary(_workflow(validation=validation).train(
        resume_from=ckpt))
    assert (resumed.best_model_name, resumed.best_model_params,
            resumed.best_validation_metric) == \
        (ref.best_model_name, ref.best_model_params,
         ref.best_validation_metric)
    want = {(r.model_name, r.grid_index): r.metric_values
            for r in ref.validation_results}
    for r in resumed.validation_results:
        assert r.metric_values == want[(r.model_name, r.grid_index)]
    redispatched = {(k, rung) for k, rung, _, _ in telemetry.dispatch_log()}
    assert redispatched.isdisjoint(journaled)
    assert telemetry.counters()["journal_hits"] >= 1


def test_train_names_quarantine_and_listener_events():
    """``train()`` completes with the survivors; the summary, its JSON,
    ``pretty()`` and ``model_insights()`` name the quarantined family,
    and the listener collects the retry and quarantine events."""
    wf = _workflow()
    listener = WorkflowListener()
    wf.with_listener(listener)
    with FaultInjector.plan("family:LinearSVC:dispatch:*=oom"):
        model = wf.train()
    summ = _summary(model)
    assert summ.best_model_name == "LogisticRegression"
    assert [(q["family"], q["kind"], q["retries"])
            for q in summ.quarantined] == [("LinearSVC", "transient", 1)]
    assert "CUDA out of memory" in summ.quarantined[0]["reason"]
    assert "quarantined" in summ.to_json()
    assert "Quarantined families" in summ.pretty()
    sel = model.model_insights().selected_model
    assert [q["family"] for q in sel["quarantined"]] == ["LinearSVC"]
    kinds = {e["event"] for e in listener.metrics.fault_events}
    assert {"quarantine", "retry"} <= kinds
    assert "faultEvents" in listener.metrics.to_json()


def test_no_fault_summary_byte_identical():
    from transmogrifai_tpu_torch.utils.uid import reset as reset_uids
    reset_uids(deterministic=True)
    s1 = json.dumps(_summary(_workflow().train()).to_json(), sort_keys=True)
    reset_uids(deterministic=True)
    s2 = json.dumps(_summary(_workflow().train()).to_json(), sort_keys=True)
    assert s1 == s2
    assert '"quarantined"' not in s1 and '"faultEvents"' not in s1
    assert set(json.loads(s1)) == {
        "validationType", "validationParameters", "dataPrepParameters",
        "dataPrepResults", "evaluationMetric", "problemType",
        "bestModelName", "bestModelUID", "bestModelParams",
        "bestValidationMetric", "validationResults", "metricLargerBetter",
        "trainEvaluation", "trainEvaluationClass", "holdoutEvaluation",
        "holdoutEvaluationClass"}


def test_resume_from_without_selector_raises():
    label, feats = _features()
    pred = LogisticRegression(device="cpu").set_input(
        label, feats).get_output()
    wf = (Workflow(device="cpu").set_result_features(pred)
          .set_input_records(_records()))
    with pytest.raises(ValueError, match="resume_from"):
        wf.train(resume_from="/nonexistent")


def test_crash_mid_save_keeps_old_model(tmp_path):
    """``workflow:save:save`` kills between the fingerprints and the
    arrays: a fresh target is never created (the staging directory is
    refused on load), an overwritten one keeps its old model, which
    reloads and scores as before."""
    label, feats = _features()
    pred = LogisticRegression(device="cpu").set_input(
        label, feats).get_output()
    model = (Workflow(device="cpu").set_result_features(pred)
             .set_input_records(_records()).train())
    fresh = str(tmp_path / "fresh")
    with pytest.raises(KillPoint):
        with FaultInjector.plan("workflow:save:save:1=kill"):
            model.save(fresh)
    assert not os.path.exists(fresh)
    staged = [p for p in os.listdir(str(tmp_path))
              if p.startswith("fresh.tmp-save")]
    assert staged
    with pytest.raises(ValueError, match="partial|interrupted"):
        load_model(str(tmp_path / staged[0]), device="cpu")
    path = str(tmp_path / "overwrite")
    model.save(path)
    before = load_model(path, device="cpu").score(_records(20, seed=3))
    with pytest.raises(KillPoint):
        with FaultInjector.plan("workflow:save:save:1=kill"):
            model.save(path)
    after = load_model(path, device="cpu").score(_records(20, seed=3))
    np.testing.assert_array_equal(after[pred.name].data,
                                  before[pred.name].data)
