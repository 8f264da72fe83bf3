"""Self-healing serving: the detect -> retrain -> canary -> swap ->
watch -> rollback loop over the live micro-batching loop.

The port's copy of ``transmogrifai_tpu/serving/lifecycle.py``. The drift
sentinel (``sentinel.py``) detects trouble; this module makes the serving
loop recover from it, per (model, tenant):

- **detect**: every finished batch feeds a ring of recently admitted raw
  records and polls the tenant's sentinel; a feature escalated to
  ``degrade`` arms the loop (once; a cooldown guards against thrash).
- **retrain**: a background warm-start refit (``runtime/refit.py``) on the
  lifecycle's worker thread: base records and the labeled live window,
  journal-resumed when the workflow carries a ModelSelector, retried under
  the runtime's RetryPolicy, bounded by a wall-clock budget. On the card
  the retrain's search (K1 included) shares the device with live serving.
  A failed retrain quarantines the lane (ledger and counters) and the old
  model keeps serving.
- **canary**: the candidate shadow-scores the ring against the live model:
  no ``OutputGuard`` invalidation, then the labeled-accuracy floor
  (candidate >= live - ``metric_slack``) or, unlabeled, prediction
  agreement >= ``min_agreement``. A rejected candidate is dropped.
- **swap**: the candidate's ``ScoringPlan`` is built straight from it at
  the server's bucket range, every bucket a batch can reach is scored
  once before the swap (on the card that captures each bucket's CUDA
  graph, on this thread: ``capture_error_mode="thread_local"`` lets the
  serving threads keep replaying theirs), fresh drift fingerprints come
  from the live window, and the ``PlanCache`` entry is replaced between
  batches (``PlanCache.swap_entry``): in-flight batches finish on the
  entry they hold, no request is dropped, and under the default
  ``tenant`` policy every other tenant keeps the original entry object.
- **watch / rollback**: the previous entry stays pinned for a watch
  window of batches served by the new entry (a batch prepared before the
  swap finishes on the old entry and is not counted); a post-swap fault,
  a breaker trip or a fresh degrade rolls it back at once
  (``PlanCache.rollback``), a clean window commits the swap.

Every transition lands in ``lifecycle_*`` telemetry counters,
``lifecycle`` events, the spans ``lifecycle.retrain`` / ``.canary`` /
``.swap`` / ``.rollback`` and ``ServingServer.metrics_snapshot()``; every
path is drillable through the ``TX_FAULT_PLAN`` sites
``lifecycle:<model>:retrain|canary|postswap``. Off by default:
``ServeConfig.lifecycle is None`` builds no manager. The JAX package's
AOT artifacts (``artifacts/loader.py``) and its warm-restart state
(``serving/state.py``: the manager's ``state_dict`` and ``load_state``,
a snapshot on commit) wait for their ports: the candidate's plan is
built here.
"""
from __future__ import annotations

import collections
import concurrent.futures as _cf
import itertools
import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..observability import trace as _trace
from ..runtime import telemetry as _telemetry
from ..runtime.context import RuntimeContext
from ..runtime.errors import classify_error
from ..runtime.faults import maybe_inject
from ..runtime.refit import RefitSpec, run_refit
from .guard import OutputGuard

_log = logging.getLogger(__name__)

__all__ = ["LifecycleConfig", "ModelLifecycle",
           "ST_IDLE", "ST_RETRAINING", "ST_CANARY", "ST_WATCH"]

ST_IDLE = "idle"
ST_RETRAINING = "retraining"
ST_CANARY = "canary"
ST_WATCH = "watch"


@dataclass
class LifecycleConfig:
    """Knobs of the self-healing loop (the JAX package's fields and
    defaults)."""
    enabled: bool = True
    #: wall-clock budget for one background retrain (None = unbounded)
    retrain_budget_seconds: Optional[float] = 120.0
    #: retained ring of recent admitted records per (model, tenant) —
    #: the canary validation set and the live refit window
    canary_rows: int = 64
    #: "tenant" swaps only the drifted tenant's entry (other tenants
    #: keep the original object, bitwise unaffected); "model" replaces
    #: the shared entry for every tenant of the model
    swap_policy: str = "tenant"
    #: canary metric floor: candidate labeled accuracy may trail the
    #: live model's by at most this much
    metric_slack: float = 0.02
    #: unlabeled canary floor: old/new prediction agreement
    min_agreement: float = 0.98
    #: batches the previous entry stays pinned after a swap; a fault in
    #: the window rolls back, a clean window commits
    watch_batches: int = 3
    #: seconds after a completed cycle before the same lane may arm
    #: again
    cooldown_seconds: float = 30.0
    #: default journal/save locations for models without a registered
    #: RefitSpec
    checkpoint_dir: Optional[str] = None
    save_dir: Optional[str] = None

    def __post_init__(self):
        if self.swap_policy not in ("tenant", "model"):
            raise ValueError(
                f"swap_policy must be 'tenant' or 'model', "
                f"got {self.swap_policy!r}")


class ModelLifecycle:
    """One server's lifecycle manager. Hot-path cost when idle: a dict
    lookup and a ring append per finished batch; everything heavy runs
    on the single dedicated worker thread."""

    def __init__(self, server, config: LifecycleConfig):
        self.server = server
        self.config = config
        self._pool = _cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tx-lifecycle")
        self._lock = threading.Lock()
        #: (model, tenant) -> ring of recent admitted raw records
        self._rings: Dict[Tuple[str, str],
                          "collections.deque[dict]"] = {}
        self._states: Dict[Tuple[str, str], str] = {}
        self._watch: Dict[Tuple[str, str], dict] = {}
        self._cooldown_until: Dict[Tuple[str, str], float] = {}
        self._specs: Dict[str, RefitSpec] = {}
        self._generations = itertools.count(1)
        #: the retry/quarantine runtime the refits run under; failed
        #: retrains land in its quarantine ledger
        self.runtime = RuntimeContext()
        #: transition log (bounded), surfaced in metrics_snapshot()
        self.history: "collections.deque[dict]" = collections.deque(
            maxlen=64)

    # -- registration ------------------------------------------------------
    def register(self, name: str, spec: RefitSpec) -> None:
        self._specs[name] = spec

    def spec_for(self, name: str) -> RefitSpec:
        spec = self._specs.get(name)
        if spec is not None:
            return spec
        return RefitSpec(checkpoint_dir=self.config.checkpoint_dir,
                         save_dir=self.config.save_dir)

    # -- hot-path hook (device/fallback pool threads) ----------------------
    def note_batch(self, prep) -> None:
        """Called by ``ServingServer._finish_batch`` after the sentinel
        observed the batch. Feeds the ring, ticks an active post-swap
        watch, and arms the heal cycle on a degrade escalation."""
        key = (prep.model, prep.tenant)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = collections.deque(
                maxlen=max(1, int(self.config.canary_rows)))
        qmask = prep.qmask
        for i, req in enumerate(prep.requests):
            if not qmask[i]:
                ring.append(dict(req.record))
        watch = self._watch.get(key)
        if watch is not None:
            # only a batch served by the swapped-in entry judges it: one
            # prepared before the swap finishes on the entry (and the
            # guards) it captured, and says nothing of the candidate
            if prep.entry is watch["entry"]:
                self._watch_tick(key, prep, watch)
            return
        if self._states.get(key, ST_IDLE) != ST_IDLE:
            return
        sentinel = prep.guards.sentinel
        if sentinel is None:
            return
        reported = getattr(sentinel, "_reported", None) or {}
        if not any(s == "degrade" for s in reported.values()):
            return
        if time.monotonic() < self._cooldown_until.get(key, 0.0):
            return
        self._arm(key)

    def _arm(self, key: Tuple[str, str]) -> None:
        with self._lock:
            if self._states.get(key, ST_IDLE) != ST_IDLE:
                return
            self._states[key] = ST_RETRAINING
        name, tenant = key
        gen = next(self._generations)
        self._note("detect", counter="lifecycle_detect", model=name,
                   tenant=tenant, generation=gen)
        entry = self.server.plans.entry_for(
            name, tenant,
            buckets=getattr(self.server, "plan_buckets", (None, None)))
        self._pool.submit(self._heal, key, entry, gen)

    # -- the heal cycle (lifecycle worker thread) --------------------------
    def _heal(self, key: Tuple[str, str], entry, gen: int) -> None:
        name, tenant = key
        cfg = self.config
        ring = [dict(r) for r in self._rings.get(key, ())]
        self._note("retrain_start", counter="lifecycle_retrain_started",
                   model=name, tenant=tenant, generation=gen)
        try:
            with _trace.span("lifecycle.retrain", model=name,
                             tenant=tenant, generation=gen):
                result = run_refit(
                    entry.model, ring, spec=self.spec_for(name),
                    budget_seconds=cfg.retrain_budget_seconds,
                    name=name, retry=self.runtime.retry,
                    generation=gen)
        except Exception as e:
            kind = classify_error(e)
            self.runtime.quarantine(
                f"{name}/{tenant}", kind=kind,
                reason=f"{type(e).__name__}: {e}",
                error_type=type(e).__name__)
            self._note("retrain_failed",
                       counter="lifecycle_retrain_failures",
                       model=name, tenant=tenant, generation=gen,
                       kind=kind, error=f"{type(e).__name__}: {e}")
            self._finish(key, "retrain_failed")
            return
        self._note("retrain_end", counter="lifecycle_retrain_completed",
                   model=name, tenant=tenant, generation=gen,
                   seconds=round(result.seconds, 3), rows=result.rows,
                   resumed=result.resumed)
        with self._lock:
            self._states[key] = ST_CANARY
        try:
            with _trace.span("lifecycle.canary", model=name,
                             tenant=tenant, generation=gen):
                verdict = self._canary(name, entry, result.model, ring)
        except Exception as e:
            verdict = {"pass": False, "kind": classify_error(e),
                       "reason": f"{type(e).__name__}: {e}"}
        if not verdict.get("pass"):
            self._note("canary_fail", counter="lifecycle_canary_fail",
                       model=name, tenant=tenant, generation=gen,
                       **{k: v for k, v in verdict.items()
                          if k != "pass"})
            self._finish(key, "canary_rejected")
            return
        self._note("canary_pass", counter="lifecycle_canary_pass",
                   model=name, tenant=tenant, generation=gen,
                   **{k: v for k, v in verdict.items() if k != "pass"})
        try:
            with _trace.span("lifecycle.swap", model=name,
                             tenant=tenant, generation=gen,
                             policy=cfg.swap_policy):
                new_entry = self._build_entry(key, result.model, ring)
                scope = tenant if cfg.swap_policy == "tenant" else None
                self.server.plans.swap_entry(
                    name, new_entry, tenant=scope,
                    buckets=getattr(self.server, "plan_buckets",
                                    (None, None)))
        except Exception as e:
            # a candidate that cannot compile or prewarm is rejected like
            # a canary failure: the classified reason is recorded and the
            # old model keeps serving
            self._note("swap_failed", counter="lifecycle_swap_failures",
                       model=name, tenant=tenant, generation=gen,
                       kind=classify_error(e),
                       error=f"{type(e).__name__}: {e}")
            self._finish(key, "swap_failed")
            return
        with self._lock:
            self._states[key] = ST_WATCH
            self._watch[key] = {
                "batches_left": max(1, int(cfg.watch_batches)),
                "generation": gen, "scope": scope, "entry": new_entry}
        self._note("swap", counter="lifecycle_swaps", model=name,
                   tenant=tenant, generation=gen,
                   policy=cfg.swap_policy)

    # -- canary validation -------------------------------------------------
    def _canary(self, name: str, entry, candidate,
                ring: List[dict]) -> dict:
        """Shadow-score the retained ring through the live and the
        candidate model (the columnar path: the candidate's plan is only
        built after a pass) and compare under the OutputGuard and the
        metric floor."""
        # the deterministic canary drill site
        maybe_inject("lifecycle", name, "canary")
        if not ring:
            return {"pass": False, "reason": "empty canary ring"}
        names = [f.name for f in candidate.result_features]
        new_scored = candidate.score([dict(r) for r in ring])
        old_scored = entry.model.score([dict(r) for r in ring])
        _, invalidated = OutputGuard().check(new_scored, names)
        if invalidated:
            return {"pass": False, "rows": len(ring),
                    "invalidated": len({r.row for r in invalidated}),
                    "reason": "candidate rows failed the output guard"}
        pred = names[0]
        new_vals = np.asarray(new_scored[pred].data, dtype=np.float64)
        old_vals = np.asarray(old_scored[pred].data, dtype=np.float64)
        responses = [f.name for f in candidate.raw_features()
                     if f.is_response]
        labels = None
        if len(responses) == 1:
            vals = [r.get(responses[0]) for r in ring]
            if all(v is not None for v in vals):
                labels = np.asarray(vals, dtype=np.float64)
        if labels is not None:
            old_acc = float(np.mean(np.round(old_vals) == labels))
            new_acc = float(np.mean(np.round(new_vals) == labels))
            ok = new_acc >= old_acc - self.config.metric_slack
            return {"pass": ok, "rows": len(ring),
                    "old_metric": round(old_acc, 4),
                    "new_metric": round(new_acc, 4),
                    **({} if ok else
                       {"reason": "candidate accuracy below the "
                                  "metric floor"})}
        agreement = float(np.mean(np.round(new_vals)
                                  == np.round(old_vals)))
        ok = agreement >= self.config.min_agreement
        return {"pass": ok, "rows": len(ring),
                "agreement": round(agreement, 4),
                **({} if ok else
                   {"reason": "old/new prediction agreement below "
                              "min_agreement"})}

    # -- candidate entry: prewarm + fresh guards ---------------------------
    def _build_entry(self, key: Tuple[str, str], candidate,
                     ring: List[dict]):
        from .plan import ScoringPlan
        from .server import _CacheEntry, _TenantGuards
        name, tenant = key
        # the candidate's plan on its own device at the server's bucket
        # range, every reachable bucket run (captured, on the card) before
        # the swap: plan_compiles() stays flat after it
        kwargs = {}
        pb = getattr(self.server, "plan_buckets", (None, None))
        if pb[0] is not None:
            kwargs["min_bucket"] = pb[0]
        if pb[1] is not None:
            kwargs["max_bucket"] = pb[1]
        plan = ScoringPlan(candidate, **kwargs).compile()
        self._prewarm(plan, ring)
        entry = _CacheEntry(
            model=candidate, plan=plan,
            result_names=[f.name for f in candidate.result_features])
        guards = _TenantGuards(candidate, self.server.config)
        if guards.sentinel is not None and ring:
            fresh = self._live_fingerprints(candidate, ring)
            if fresh:
                from .sentinel import DriftSentinel
                sentinel = DriftSentinel(
                    fresh,
                    thresholds=self.server.config.drift_thresholds)
                sentinel.generation = getattr(
                    candidate, "trained_generation", 0)
                guards.sentinel = sentinel
        entry.guards[tenant] = guards
        return entry

    def _prewarm(self, plan, ring: List[dict]) -> None:
        """Run every bucket a post-swap batch can reach before the swap
        (capturing its graph on the card), so steady state stays at zero
        compiles."""
        rows = [dict(r) for r in ring] or [{}]
        cap = int(self.server.config.max_batch)
        for bucket in plan.buckets():
            if bucket > cap:
                break
            batch = list(itertools.islice(itertools.cycle(rows),
                                          bucket))
            plan.score(batch)

    def _live_fingerprints(self, candidate, ring: List[dict]):
        """Fresh drift fingerprints from the live window: the new sentinel
        compares future traffic against the distribution the candidate
        was validated on, not the stale train-time fingerprints."""
        from ..workflow.workflow import _generate_raw_data
        from .sentinel import compute_fingerprints
        try:
            ds = _generate_raw_data(candidate.raw_features(),
                                    [dict(r) for r in ring],
                                    require_responses=False)
            return compute_fingerprints(candidate.raw_features(), ds)
        except Exception as e:
            # no fingerprints is a degraded (loud) sentinel, not a
            # failed swap
            _log.warning("live-window fingerprints unavailable "
                         "(%s: %s)", type(e).__name__,
                         classify_error(e))
            return None

    # -- post-swap watch (device/fallback pool threads) --------------------
    def _watch_tick(self, key: Tuple[str, str], prep, watch: dict
                    ) -> None:
        name, tenant = key
        fault = None
        try:
            # the deterministic post-swap drill site
            maybe_inject("lifecycle", name, "postswap")
        except Exception as e:
            fault = f"{type(e).__name__}: {e} " \
                    f"({classify_error(e)})"
        breaker = prep.guards.breaker
        tripped = breaker is not None and breaker.state == "open"
        sentinel = prep.guards.sentinel
        reported = getattr(sentinel, "_reported", None) or {}
        regressed = any(s == "degrade" for s in reported.values())
        if fault or tripped or regressed:
            reason = fault or ("breaker_open" if tripped
                               else "drift_regression")
            self._rollback(key, watch, reason)
            return
        watch["batches_left"] -= 1
        if watch["batches_left"] <= 0:
            self._commit(key, watch)

    def _rollback(self, key: Tuple[str, str], watch: dict,
                  reason: str) -> None:
        name, tenant = key
        t0 = time.monotonic()
        restored = self.server.plans.rollback(
            name, tenant=watch["scope"],
            buckets=getattr(self.server, "plan_buckets", (None, None)))
        with self._lock:
            self._watch.pop(key, None)
        self._note("rollback", counter="lifecycle_rollbacks",
                   model=name, tenant=tenant,
                   generation=watch["generation"], reason=reason,
                   restored=restored)
        if _trace.enabled():
            _trace.add_span("lifecycle.rollback", t0, time.monotonic(),
                            attrs={"model": name, "tenant": tenant,
                                   "generation": watch["generation"],
                                   "reason": reason})
        self._finish(key, "rolled_back")

    def _commit(self, key: Tuple[str, str], watch: dict) -> None:
        name, tenant = key
        self.server.plans.commit(name, tenant=watch["scope"])
        with self._lock:
            self._watch.pop(key, None)
        self._note("commit", counter="lifecycle_commits", model=name,
                   tenant=tenant, generation=watch["generation"])
        self._finish(key, "healthy")

    def _finish(self, key: Tuple[str, str], outcome: str) -> None:
        _log.info("lifecycle cycle for %s/%s finished: %s", key[0],
                  key[1], outcome)
        with self._lock:
            self._states[key] = ST_IDLE
            self._cooldown_until[key] = (
                time.monotonic() + self.config.cooldown_seconds)

    # -- bookkeeping -------------------------------------------------------
    def _note(self, phase: str, counter: Optional[str] = None,
              **fields) -> None:
        if counter:
            _telemetry.count(counter)
        _telemetry.event("lifecycle", phase=phase, **fields)
        with self._lock:
            self.history.append({"phase": phase, **fields})

    def snapshot(self) -> dict:
        """The lifecycle slice of ``metrics_snapshot()``."""
        with self._lock:
            return {
                "states": {"/".join(k): v
                           for k, v in sorted(self._states.items())},
                "watch": {"/".join(k): dict(batches_left=w[
                    "batches_left"], generation=w["generation"])
                    for k, w in sorted(self._watch.items())},
                "ring_rows": {"/".join(k): len(r)
                              for k, r in sorted(self._rings.items())},
                "quarantined": list(
                    self.runtime.quarantined_families()),
                "history": list(self.history),
            }

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)
