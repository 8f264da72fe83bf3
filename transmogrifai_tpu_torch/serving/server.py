"""Async micro-batching serving loop: live requests -> bucketed dispatches
of the compiled plan under latency SLOs.

The port's copy of ``transmogrifai_tpu/serving/server.py``. Concurrent
single-record requests are coalesced into the :class:`~.plan.ScoringPlan`
buckets, whose graphs a batch of one would otherwise replay for one row:

- **Deadline-or-full coalescing.** Requests queue per (model, tenant)
  lane; a lane dispatches when its queue reaches the coalescer's target
  batch or the oldest request has waited ``max_wait_ms``, whichever comes
  first. The target is picked from the plan's recorded per-bucket
  dispatch costs (:meth:`~.plan.ScoringPlan.bucket_profile`), else the
  static default of ``tuning/registry.py``.
- **Double buffering.** Host-side admission, boxing and encoding of batch
  k+1 (the encode pool) overlaps batch k's dispatch (the device pool); a
  semaphore bounds the pipeline at one in-flight dispatch, which also
  keeps one dispatch at a time on a bucket's static graph buffers.
- **Per-tenant guardrails.** Each tenant carries its own schema
  admission, output guard and circuit breaker, with an optional per-batch
  deadline around device dispatch and the host columnar fallback. One
  tenant's breaker trip routes its batches to the fallback pool while
  another tenant's queue keeps dispatching to the device pool. A hung
  dispatch is orphaned at the deadline: its executor is abandoned and
  replaced, so the event loop never waits behind it.
- **Multi-model plan cache.** Fitted models stay resident under an LRU
  budget keyed by (model, bucket range); an evicted model reloads and
  recompiles on next use.

Steady state captures no graph, and each answer is bitwise the row that
an offline ``score_guarded()`` gives, but for a model with an LDA stage:
its E-step's products over the batch round by the batch's size, so its
answers agree within 1e-6 (ROADMAP's known divergences). Entry points: :class:`ServingServer`
on an event loop of the caller's, or on a background thread through
:meth:`ServingServer.start_background` and :class:`ServingClient`
(``serve_in_process``). Each tenant has its own drift sentinel
(``sentinel.py``) over the batches it scores, reported in
``metrics_snapshot()``. With ``ServeConfig.lifecycle`` a
:class:`~.lifecycle.ModelLifecycle` retrains a drifted tenant's model in
the background and hot-swaps it between batches
(:meth:`PlanCache.swap_entry`, :meth:`PlanCache.rollback`;
``register_refit`` says how to retrain a model). Not ported, and raising
by name: overload admission (``admission_control``), the predicted-cost
coalescer, the state snapshots, the AOT artifacts and the TCP front end
(``cli/serve.py``).
"""
from __future__ import annotations

import asyncio
import collections
import concurrent.futures as _cf
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..observability import trace as _trace
from ..observability.metrics import METRICS_SCHEMA_VERSION, ServeMetrics
from ..runtime import telemetry as _telemetry
from ..runtime.errors import classify_error
from ..tuning.registry import STATIC_DEFAULTS as _TUNABLES
from ..utils.device import resolve_device
from ..utils.ported import not_ported
from .guard import (AdmissionPolicy, CircuitBreaker, GuardReason,
                    OutputGuard, SchemaGuard, fall_back_to_host)
from .plan import EncodedScoreBatch, ScoringPlan, plan_compiles


__all__ = ["ServeConfig", "ServingServer", "ServingClient", "PlanCache",
           "ServeRejected", "ServeDraining", "serve_in_process"]

#: coalescer target when no bucket profile has been recorded yet
_DEFAULT_TARGET = int(_TUNABLES["serving.target_batch"])


class ServeRejected(RuntimeError):
    """A request was refused before scoring (queue over its backpressure
    limit, unknown model, or server shutdown)."""


class ServeDraining(ServeRejected):
    """The loop is draining toward a graceful shutdown: queued and
    in-flight requests are still answered, new ones are refused."""


@dataclass
class ServeConfig:
    """Knobs of the serving loop (the JAX package's fields and defaults)."""
    #: SLO half of deadline-or-full: a request waits at most this long in
    #: the coalescing queue before its lane dispatches
    max_wait_ms: float = 5.0
    #: coalescer target batch; None derives it per lane from the plan's
    #: recorded ``bucket_profile()`` (the largest bucket whose warm
    #: per-dispatch cost fits inside max_wait_ms)
    target_batch: Optional[int] = None
    #: hard cap on rows per dispatch (<= the plan's max bucket)
    max_batch: int = 256
    #: per-lane backpressure: requests beyond this are rejected with
    #: ServeRejected instead of growing the queue without bound
    queue_limit: int = 4096
    #: LRU budget of the multi-model plan cache (resident plans)
    plan_budget: int = 4
    #: per-tenant guardrails (admission, output guard, breaker);
    #: False = raw dispatch (no quarantine, no breaker)
    guardrails: bool = True
    admission: Optional[AdmissionPolicy] = None
    #: the drift sentinel per tenant (requires guardrails)
    sentinel: bool = True
    drift_thresholds: Any = None
    #: per-batch device dispatch deadline; a dispatch still running at
    #: the deadline is orphaned (executor abandoned and replaced) and the
    #: batch falls back to the host columnar path
    deadline_seconds: Optional[float] = None
    #: per-tenant breaker parameters (breaker_factory overrides them,
    #: e.g. to inject a test clock)
    breaker_failures: int = 3
    breaker_cooldown_seconds: float = 30.0
    breaker_factory: Optional[Callable[[], CircuitBreaker]] = None
    #: the self-healing lifecycle (``serving/lifecycle.LifecycleConfig``);
    #: None (the default) builds no manager: the loop is the one without
    #: drift-triggered retraining
    lifecycle: Any = None
    #: overload admission control: not ported, must be None
    admission_control: Any = None
    #: coalescer split policy: None or "deadline_or_full" (the
    #: predicted-cost split is not ported)
    coalesce_policy: Optional[str] = None


def _check_ported(config: ServeConfig) -> None:
    """Raise by name for each option of ``config`` whose JAX module the
    port does not have yet."""
    if config.admission_control is not None:
        raise not_ported("ServeConfig.admission_control, overload "
                         "admission", "serving/admission.py")
    if config.coalesce_policy == "predicted_cost":
        raise not_ported("ServeConfig(coalesce_policy='predicted_cost'), "
                         "the cost-model coalescer", "tuning/policy.py")
    if config.coalesce_policy not in (None, "deadline_or_full"):
        raise ValueError(f"unknown coalesce_policy "
                         f"{config.coalesce_policy!r}")


@dataclass
class _Request:
    record: dict
    future: asyncio.Future
    arrived: float
    #: request id, generated at admission and carried enqueue ->
    #: coalesce -> encode -> dispatch -> reply; the trace id of the
    #: request's span tree
    rid: str = ""


@dataclass
class _CacheEntry:
    model: Any
    plan: ScoringPlan
    result_names: List[str]
    guards: Dict[str, "_TenantGuards"] = field(default_factory=dict)


class _TenantGuards:
    """One tenant's guard stack over a shared compiled plan. The plan
    itself stays unguarded (``plan.guard is None``); the breaker and the
    drift sentinel's sketches live here, per tenant, so tenants fail,
    recover and drift independently."""

    def __init__(self, model, config: ServeConfig):
        self.schema: Optional[SchemaGuard] = None
        self.output: Optional[OutputGuard] = None
        self.breaker: Optional[CircuitBreaker] = None
        self.sentinel = None
        if not config.guardrails:
            return
        self.schema = SchemaGuard(model, policy=config.admission)
        self.output = OutputGuard()
        self.breaker = (config.breaker_factory()
                        if config.breaker_factory is not None else
                        CircuitBreaker(
                            failure_threshold=config.breaker_failures,
                            cooldown_seconds=(
                                config.breaker_cooldown_seconds)))
        if config.sentinel:
            from .sentinel import DriftSentinel
            self.sentinel = DriftSentinel.for_model(
                model, thresholds=config.drift_thresholds)


#: pinned when a tenant swap had no previous override (a rollback must
#: remove the override, not restore a None entry)
_NO_OVERRIDE = object()


class PlanCache:
    """LRU of compiled ScoringPlans keyed by (model name, bucket range):
    one process serves several models. Eviction drops the plan (and its
    captured graphs) but keeps the loader, so an evicted model reloads and
    recompiles on next use; hits, misses and evictions are counted. A
    saved model directory loads on ``device``; an in-memory model keeps
    its own device, which must be ``device``.

    Hot swaps go through :meth:`swap_entry` and :meth:`rollback` only: the
    replacement is one dict assignment, atomic between batches (a batch
    that holds the old entry finishes on it, the next resolves the new
    one), and the previous entry stays pinned until :meth:`commit` or
    :meth:`rollback`."""

    def __init__(self, budget: int = 4, device="cuda"):
        if budget < 1:
            raise ValueError("plan cache budget must be >= 1")
        self.budget = int(budget)
        self.device = resolve_device(device)
        #: name -> loader (model dir string, or an in-memory model)
        self._loaders: Dict[str, Any] = {}
        self._entries: "collections.OrderedDict[Tuple, _CacheEntry]" = \
            collections.OrderedDict()
        #: (name, tenant) -> swapped-in entry (tenant-scoped hot swaps;
        #: resolution: the override, then the shared LRU entry)
        self._overrides: Dict[Tuple[str, str], _CacheEntry] = {}
        #: the previous entry of each swap scope, until commit or rollback
        self._pinned: Dict[Tuple[str, Optional[str]], Any] = {}
        self.evictions = 0
        self.hits = 0
        self.misses = 0

    def register(self, name: str, model_or_dir: Any) -> None:
        self._loaders[name] = model_or_dir

    def names(self) -> List[str]:
        return sorted(self._loaders)

    def get(self, name: str,
            buckets: Tuple[Optional[int], Optional[int]] = (None, None)
            ) -> _CacheEntry:
        """Resident entry for ``name`` (LRU-bumped), loading the model and
        compiling its plan on a miss. Blocking: call from an executor,
        never from the event loop."""
        if name not in self._loaders:
            raise ServeRejected(f"unknown model {name!r}; registered: "
                                f"{self.names()}")
        key = (name, buckets)
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            _telemetry.count("serve_plan_cache_hits")
            return entry
        self.misses += 1
        _telemetry.count("serve_plan_cache_misses")
        loader = self._loaders[name]
        if isinstance(loader, str):
            from ..workflow.persistence import load_model
            model = load_model(loader, device=self.device)
        else:
            model = loader
        kwargs = {}
        if buckets[0] is not None:
            kwargs["min_bucket"] = buckets[0]
        if buckets[1] is not None:
            kwargs["max_bucket"] = buckets[1]
        plan = ScoringPlan(model, device=self.device, **kwargs).compile()
        entry = _CacheEntry(
            model=model, plan=plan,
            result_names=[f.name for f in model.result_features])
        self._entries[key] = entry
        while len(self._entries) > self.budget:
            old_key, _old = self._entries.popitem(last=False)
            self.evictions += 1
            _telemetry.count("serve_plan_cache_evictions")
            _telemetry.event("serve_plan_evicted", model=old_key[0])
        return entry

    def resident_entries(self) -> List[Tuple[Tuple, _CacheEntry]]:
        """Resident (key, entry) pairs, least recently used first."""
        return list(self._entries.items())

    # -- hot swap ----------------------------------------------------------
    def entry_for(self, name: str, tenant: str,
                  buckets: Tuple[Optional[int], Optional[int]] = (None,
                                                                  None)
                  ) -> _CacheEntry:
        """Tenant-aware resolution: a tenant-scoped swapped-in entry wins;
        every other tenant resolves the shared LRU entry, which a
        ``tenant``-policy swap leaves untouched."""
        override = self._overrides.get((name, tenant))
        if override is not None:
            self.hits += 1
            _telemetry.count("serve_plan_cache_hits")
            return override
        return self.get(name, buckets)

    def swap_entry(self, name: str, new_entry: _CacheEntry,
                   tenant: Optional[str] = None,
                   buckets: Tuple[Optional[int], Optional[int]] = (None,
                                                                   None)
                   ) -> None:
        """Replace the live entry of ``name`` in one dict assignment
        (batches holding the old entry finish on it; the next
        ``entry_for`` resolves ``new_entry``), pinning the previous entry
        until :meth:`commit` or :meth:`rollback`. ``tenant=None`` swaps
        the shared entry for every tenant, a tenant name only that
        tenant's resolution."""
        if name not in self._loaders:
            raise ServeRejected(f"unknown model {name!r}; registered: "
                                f"{self.names()}")
        if tenant is not None:
            self._pinned[(name, tenant)] = self._overrides.get(
                (name, tenant), _NO_OVERRIDE)
            self._overrides[(name, tenant)] = new_entry
        else:
            key = (name, buckets)
            self._pinned[(name, None)] = self._entries.get(key)
            self._entries[key] = new_entry
        _telemetry.count("serve_plan_swaps")
        _telemetry.event("serve_plan_swapped", model=name,
                         tenant=tenant or "*")

    def rollback(self, name: str, tenant: Optional[str] = None,
                 buckets: Tuple[Optional[int], Optional[int]] = (None,
                                                                 None)
                 ) -> bool:
        """Restore the entry pinned by the last :meth:`swap_entry` of this
        scope at once; False when nothing is pinned (committed, or never
        swapped)."""
        pin = (name, tenant)
        if pin not in self._pinned:
            return False
        prev = self._pinned.pop(pin)
        key = (name, buckets)
        if tenant is not None:
            if prev is _NO_OVERRIDE:
                self._overrides.pop((name, tenant), None)
            else:
                self._overrides[(name, tenant)] = prev
        elif prev is not None:
            self._entries[key] = prev
        else:
            self._entries.pop(key, None)
        return True

    def commit(self, name: str, tenant: Optional[str] = None) -> None:
        """Unpin the previous entry after a healthy watch window: the swap
        is permanent and the old plan (its graphs) may be released."""
        self._pinned.pop((name, tenant), None)

    def swapped_entries(self) -> Dict[Tuple[str, str], _CacheEntry]:
        """Live tenant-scoped overrides."""
        return dict(self._overrides)


class _Lane:
    """One (model, tenant) coalescing queue and its collector task."""

    def __init__(self, model_name: str, tenant: str,
                 queue_limit: int = 4096):
        self.model_name = model_name
        self.tenant = tenant
        #: bounded at the backpressure limit: the enqueue edge rejects
        #: before appending, so the maxlen never silently drops
        self.queue: "collections.deque[_Request]" = collections.deque(
            maxlen=max(int(queue_limit), 1))
        self.wakeup: Optional[asyncio.Event] = None   # built on the loop
        self.full: Optional[asyncio.Event] = None
        #: the collector's current deadline-or-full threshold; the enqueue
        #: edge signals ``full`` when the queue reaches it, so the
        #: collector wakes once per batch, not once per request
        self.target: int = _DEFAULT_TARGET
        self.task: Optional[asyncio.Task] = None


@dataclass
class _PreparedBatch:
    """Everything the dispatch stage needs, produced host-side in the
    encode pool (the double-buffered half)."""
    entry: _CacheEntry
    guards: _TenantGuards
    requests: List[_Request]
    enc: EncodedScoreBatch
    ds: Any
    quarantined: List[GuardReason]
    qmask: np.ndarray
    #: (model, tenant) lane and batch sequence number: span attributes
    model: str = ""
    tenant: str = ""
    seq: int = 0
    #: monotonic marks of the batch's pipeline stages
    #: (encode_t0/encode_t1/guard_t0/guard_t1, fallback flag)
    marks: Dict[str, float] = field(default_factory=dict)
    #: set when the per-batch deadline orphaned this batch's dispatch: the
    #: batch was answered through the host fallback, so a hung device
    #: thread that wakes later must not run the finish stage
    abandoned: bool = False


class ServingServer:
    """The asyncio micro-batching scorer. Typical in-process use::

        server = ServingServer(ServeConfig(max_wait_ms=2.0))
        server.add_model("titanic", model)       # or a saved model dir
        client = server.start_background()
        row = client.score({"age": 31.0, ...}, model="titanic")
        server.stop()

    ``device`` (default the card; raises without one) is where saved model
    directories load and where every plan computes.
    """

    def __init__(self, config: Optional[ServeConfig] = None, device="cuda"):
        self.config = config or ServeConfig()
        _check_ported(self.config)
        self.device = resolve_device(device)
        self.plans = PlanCache(budget=self.config.plan_budget,
                               device=self.device)
        self._lanes: Dict[Tuple[str, str], _Lane] = {}
        self._default_model: Optional[str] = None
        self._running = False
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._encode_pool = _cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tx-serve-encode")
        self._device_pool = _cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tx-serve-device")
        self._fallback_pool = _cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tx-serve-fallback")
        self._dispatch_sem: Optional[asyncio.Semaphore] = None
        #: dispatch tasks in flight (the loop holds tasks weakly)
        self._tasks: set = set()
        #: live metrics: per-tenant latency histograms, answered/failed
        self.metrics = ServeMetrics()
        self._batch_seq = itertools.count(1)
        #: float accumulators (occupancy and saturation)
        self.stats: Dict[str, float] = {
            "requests": 0, "batches": 0, "rows": 0,
            "full_dispatches": 0, "deadline_dispatches": 0,
            "dispatch_seconds": 0.0, "orphaned_dispatches": 0,
        }
        self._first_dispatch_at: Optional[float] = None
        self._last_dispatch_at: Optional[float] = None
        self._draining = False
        self._inflight = 0
        self._drain_event: Optional[asyncio.Event] = None
        #: the bucket range the plan cache compiles plans at (the plans'
        #: defaults); a lifecycle candidate's plan is built at it too
        self.plan_buckets: Tuple[Optional[int], Optional[int]] = (None,
                                                                   None)
        #: the self-healing lifecycle manager: None unless
        #: ``config.lifecycle`` is an enabled LifecycleConfig
        self.lifecycle = None
        lc = self.config.lifecycle
        if lc is not None and getattr(lc, "enabled", False):
            from .lifecycle import ModelLifecycle
            self.lifecycle = ModelLifecycle(self, lc)

    # -- registry ----------------------------------------------------------
    def add_model(self, name: str, model_or_dir: Any,
                  default: bool = False) -> "ServingServer":
        """Register a fitted model (in-memory ``WorkflowModel`` or a saved
        model directory). The first registered model is the default for
        requests that name none."""
        self.plans.register(name, model_or_dir)
        if default or self._default_model is None:
            self._default_model = name
        return self

    def register_refit(self, name: str, workflow_factory=None,
                       base_records: Optional[List[dict]] = None,
                       checkpoint_dir: Optional[str] = None,
                       save_dir: Optional[str] = None) -> "ServingServer":
        """How to retrain ``name`` when its sentinel degrades:
        ``workflow_factory`` returns a fresh unfitted workflow (the exact
        estimators and hyperparameters); without one the workflow is
        rebuilt from the fitted model (``runtime/refit.py``). Requires an
        enabled ``ServeConfig.lifecycle``."""
        if self.lifecycle is None:
            raise ValueError(
                "register_refit requires an enabled "
                "ServeConfig.lifecycle (serving/lifecycle."
                "LifecycleConfig)")
        from ..runtime.refit import RefitSpec
        self.lifecycle.register(name, RefitSpec(
            workflow_factory=workflow_factory,
            base_records=base_records, checkpoint_dir=checkpoint_dir,
            save_dir=save_dir))
        return self

    def prewarm(self, names: Optional[List[str]] = None,
                buckets: Optional[Sequence[int]] = None
                ) -> Dict[str, Dict[int, float]]:
        """Capture each registered model's bucket graphs before traffic,
        so no request pays a capture in band (buckets above ``max_batch``,
        which no dispatch reaches, are skipped). ``buckets`` defaults to the
        static ``serving.prewarm`` set, which is empty (as the JAX
        package's tuning policy decides with an empty store): pass the
        buckets to capture. Returns ``{model: {bucket: capture
        seconds}}``. Blocking: call before traffic."""
        if buckets is None:
            buckets = _TUNABLES["serving.prewarm"]
        warmed: Dict[str, Dict[int, float]] = {}
        if not buckets:
            return warmed
        for name in (names if names is not None else self.plans.names()):
            plan = self.plans.get(name).plan
            top = min(plan.max_bucket, self.config.max_batch)
            warmed[name] = plan.prewarm(
                [b for b in buckets if plan.min_bucket <= b <= top])
            _telemetry.event("serve_prewarmed", model=name,
                             buckets=sorted(warmed[name]))
        return warmed

    # -- async request edge ------------------------------------------------
    async def score_async(self, record: dict, model: Optional[str] = None,
                          tenant: str = "default") -> dict:
        """Enqueue one record; resolves with the scored row dict (result
        features by name, plus a ``"_guard"`` reason list for quarantined
        or invalidated rows). The request id, made here, is the trace id
        of the request's spans."""
        if self._draining:
            _telemetry.count("serve_draining_rejections")
            raise ServeDraining(
                "serving loop is draining for shutdown; retry against "
                "the next incarnation")
        if not self._running:
            raise ServeRejected("serving loop is not running")
        name = model or self._default_model
        if name is None:
            raise ServeRejected("no model registered")
        lane = self._lane(name, tenant)
        if len(lane.queue) >= self.config.queue_limit:
            _telemetry.count("serve_queue_rejections")
            raise ServeRejected(
                f"lane {name}/{tenant} queue is at its backpressure "
                f"limit ({self.config.queue_limit})")
        loop = asyncio.get_running_loop()
        req = _Request(record=record, future=loop.create_future(),
                       arrived=time.monotonic(),
                       rid=_trace.new_request_id())
        lane.queue.append(req)
        self.stats["requests"] += 1
        _telemetry.count("serve_requests")
        if len(lane.queue) == 1:
            lane.wakeup.set()               # lane was idle: start timer
        if len(lane.queue) >= lane.target:
            lane.full.set()                 # bucket filled: fire early
        self._inflight += 1
        try:
            return await req.future
        finally:
            self._inflight -= 1
            if self._inflight == 0 and self._drain_event is not None:
                self._drain_event.set()

    def _lane(self, model_name: str, tenant: str) -> _Lane:
        key = (model_name, tenant)
        lane = self._lanes.get(key)
        if lane is None:
            lane = self._lanes[key] = _Lane(
                model_name, tenant, queue_limit=self.config.queue_limit)
            lane.wakeup = asyncio.Event()
            lane.full = asyncio.Event()
            lane.task = asyncio.get_running_loop().create_task(
                self._lane_loop(lane),
                name=f"tx-serve-lane-{model_name}-{tenant}")
        return lane

    # -- the coalescing collector ------------------------------------------
    def _target_batch(self, plan: ScoringPlan) -> int:
        """Deadline-or-full's "full": explicit config wins; otherwise the
        largest bucket whose recorded warm per-dispatch cost still fits
        inside the wait budget; with no profile yet, the static
        default."""
        cfg = self.config
        if cfg.target_batch:
            return max(1, min(cfg.target_batch, cfg.max_batch))
        budget_s = cfg.max_wait_ms / 1000.0
        best = 0
        for bucket, rec in plan.bucket_profile().items():
            if rec["calls"] < 1 or bucket > cfg.max_batch:
                continue
            per_dispatch = rec["execute_seconds"] / rec["calls"]
            if per_dispatch <= budget_s and bucket > best:
                best = bucket
        if best:
            return best
        return max(1, min(_DEFAULT_TARGET, cfg.max_batch))

    async def _collect(self, lane: _Lane, target: int
                       ) -> List[_Request]:
        """Deadline-or-full: wait for the first request, then one timer
        until the lane holds ``target`` requests (the enqueue edge fires
        ``lane.full``) or the oldest request has waited ``max_wait_ms``,
        whichever comes first."""
        lane.target = max(1, target)
        while not lane.queue:
            lane.wakeup.clear()
            await lane.wakeup.wait()
            if not self._running:
                return []
        deadline = lane.queue[0].arrived + self.config.max_wait_ms / 1000.0
        while len(lane.queue) < lane.target:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            lane.full.clear()
            try:
                await asyncio.wait_for(lane.full.wait(), remaining)
            except asyncio.TimeoutError:
                break
        n = min(len(lane.queue), self.config.max_batch)
        batch = [lane.queue.popleft() for _ in range(n)]
        key = ("full_dispatches" if n >= lane.target
               else "deadline_dispatches")
        self.stats[key] += 1
        _telemetry.count(f"serve_{key}")
        return batch

    async def _lane_loop(self, lane: _Lane) -> None:
        """One lane's collector: coalesce -> host-encode (encode pool) ->
        spawn the dispatch stage. The semaphore is acquired here and
        released when the dispatch completes, so one batch is on the
        device while this loop coalesces and encodes the next one: the
        double buffer."""
        loop = asyncio.get_running_loop()
        target = max(1, min(_DEFAULT_TARGET, self.config.max_batch))
        while self._running:
            batch: List[_Request] = []
            try:
                batch = await self._collect(lane, target)
                if not batch:
                    continue
                prep = await loop.run_in_executor(
                    self._encode_pool, self._prepare_batch, lane, batch)
                target = self._target_batch(prep.entry.plan)
                await self._dispatch_sem.acquire()
                task = loop.create_task(self._dispatch_resolve(prep))
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a failed prepare fails this batch's requests with the
                # recorded, classified reason; the lane keeps serving
                _telemetry.count("serve_batch_failures")
                _telemetry.event("serve_batch_failed", lane=lane.tenant,
                                 model=lane.model_name,
                                 kind=classify_error(e),
                                 error=f"{type(e).__name__}: {e}")
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

    # -- host-side batch prep (encode pool thread) -------------------------
    def _prepare_batch(self, lane: _Lane, batch: List[_Request]
                       ) -> _PreparedBatch:
        """Blocking host work: plan-cache lookup (may reload and recompile
        an evicted model), schema admission with per-row quarantine
        reasons, raw-Dataset boxing, and bucket encoding and padding."""
        marks = {"encode_t0": time.monotonic()}
        entry = self.plans.entry_for(lane.model_name, lane.tenant,
                                     self.plan_buckets)
        guards = entry.guards.get(lane.tenant)
        if guards is None:
            guards = entry.guards[lane.tenant] = _TenantGuards(
                entry.model, self.config)
        records = [r.record for r in batch]
        n = len(records)
        if guards.schema is not None:
            ds, quarantined = guards.schema.admit_records(records)
        else:
            from ..workflow.workflow import _generate_raw_data
            ds = _generate_raw_data(entry.model.raw_features(), records,
                                    require_responses=False)
            quarantined = []
        qmask = np.zeros(n, dtype=bool)
        for r in quarantined:
            if 0 <= r.row < n:
                qmask[r.row] = True
        enc = entry.plan.encode_raw_dataset(
            ds, valid_mask=(~qmask).astype(np.float64))
        marks["encode_t1"] = time.monotonic()
        return _PreparedBatch(entry=entry, guards=guards, requests=batch,
                              enc=enc, ds=ds, quarantined=quarantined,
                              qmask=qmask, model=lane.model_name,
                              tenant=lane.tenant,
                              seq=next(self._batch_seq), marks=marks)

    # -- device dispatch and guarded resolution ----------------------------
    async def _dispatch_resolve(self, prep: _PreparedBatch) -> None:
        try:
            rows = await self._dispatch_guarded(prep)
            now = time.monotonic()
            for req, row in zip(prep.requests, rows):
                if not req.future.done():
                    req.future.set_result(row)
            self.metrics.observe_batch(
                prep.tenant, [now - req.arrived for req in prep.requests])
            if _trace.enabled():
                self._emit_request_spans(prep, now)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # classified-bug dispatches (and finish-stage crashes) fail
            # the batch's requests with the recorded reason
            _telemetry.count("serve_batch_failures")
            self.metrics.note_failure()
            _telemetry.event("serve_batch_failed", kind=classify_error(e),
                             error=f"{type(e).__name__}: {e}")
            if _trace.enabled():
                self._emit_request_spans(prep, time.monotonic(),
                                         error=f"{type(e).__name__}: {e}")
            for req in prep.requests:
                if not req.future.done():
                    req.future.set_exception(e)
        finally:
            self._dispatch_sem.release()

    def _emit_request_spans(self, prep: _PreparedBatch, resolved: float,
                            error: Optional[str] = None) -> None:
        """Each request's span tree, rebuilt from the batch's monotonic
        marks at resolve time: root ``serve.request`` (trace id = request
        id) with contiguous children wait / encode / dispatch / guard."""
        m = prep.marks
        enc0 = m.get("encode_t0")
        enc1 = m.get("encode_t1", enc0)
        guard0 = m.get("guard_t0", resolved)
        attrs = {"model": prep.model, "tenant": prep.tenant,
                 "batch": prep.seq, "batch_rows": len(prep.requests)}
        if m.get("fallback"):
            attrs["host_fallback"] = True
        if error is not None:
            attrs["status"], attrs["error"] = "error", error
        for req in prep.requests:
            root = _trace.add_span("serve.request", req.arrived, resolved,
                                   trace_id=req.rid, attrs=attrs)
            parent = (req.rid, root)
            if enc0 is None:
                continue
            _trace.add_span("serve.wait", req.arrived, enc0, parent=parent)
            _trace.add_span("serve.encode", enc0, enc1, parent=parent)
            _trace.add_span("serve.dispatch", enc1, guard0, parent=parent,
                            attrs={"fallback": bool(m.get("fallback"))})
            _trace.add_span("serve.guard", guard0, resolved, parent=parent,
                            attrs={"boxing_seconds": round(
                                max(m.get("guard_t1", guard0) - guard0,
                                    0.0), 6)})

    async def _dispatch_guarded(self, prep: _PreparedBatch) -> List[dict]:
        """Breaker-gated device dispatch with the per-batch deadline and
        the host columnar fallback: the per-tenant serving half of
        ``ScoringPlan.score_guarded`` over a shared unguarded plan.
        Dispatch and the finish stage run in one executor hop
        (``_device_batch``)."""
        loop = asyncio.get_running_loop()
        breaker = prep.guards.breaker
        t0 = time.monotonic()
        try:
            if breaker is not None:
                breaker.before_dispatch()
            fut = self._device_pool.submit(self._device_batch, prep)
            aw = asyncio.wrap_future(fut)
            deadline = self.config.deadline_seconds
            if deadline is not None:
                try:
                    rows = await asyncio.wait_for(aw, deadline)
                except asyncio.TimeoutError:
                    # the device thread may be wedged in a replay, which
                    # cannot be killed: orphan its executor (a new one
                    # takes the next batch) rather than queue behind it
                    prep.abandoned = True
                    self._orphan_device_pool()
                    _telemetry.count("serving_deadline_exceeded")
                    raise TimeoutError(
                        f"DEADLINE_EXCEEDED: serve batch exceeded the "
                        f"{deadline}s device dispatch deadline") from None
            else:
                rows = await aw
            if breaker is not None:
                breaker.record_success()
            self._note_dispatch(prep, t0)
            return rows
        except Exception as e:
            if not fall_back_to_host(breaker, e, "serve lane dispatch"):
                raise
        # breaker open or a classified device failure: the tenant's batch
        # scores through the host columnar path in the fallback pool; the
        # device pool stays free for healthy tenants
        rows = await loop.run_in_executor(
            self._fallback_pool, self._fallback_batch, prep)
        self._note_dispatch(prep, t0)
        return rows

    def _device_batch(self, prep: _PreparedBatch) -> List[dict]:
        """Device-pool thread: the plan's dispatch and the guarded finish
        in one hop. An abandoned batch skips both."""
        if prep.abandoned:
            return []
        scored = prep.entry.plan.dispatch_encoded(prep.enc)
        if prep.abandoned:
            return []
        return self._finish_batch(prep, scored, used_fallback=False)

    def _fallback_batch(self, prep: _PreparedBatch) -> List[dict]:
        """Fallback-pool thread: host columnar scoring and the guarded
        finish for a tenant whose device path is unavailable."""
        scored = prep.entry.plan.score_host_columnar(prep.ds)
        return self._finish_batch(prep, scored, used_fallback=True)

    def _note_dispatch(self, prep: _PreparedBatch, t0: float) -> None:
        now = time.monotonic()
        self.stats["batches"] += 1
        self.stats["rows"] += len(prep.requests)
        self.stats["dispatch_seconds"] += now - t0
        if self._first_dispatch_at is None:
            self._first_dispatch_at = t0
        self._last_dispatch_at = now
        _telemetry.count("serve_batches")
        _telemetry.count("serve_rows", len(prep.requests))

    def _finish_batch(self, prep: _PreparedBatch, scored,
                      used_fallback: bool) -> List[dict]:
        """Blocking post-dispatch host work: the plan's guarded finish
        (``ScoringPlan.resolve_guarded``) with the tenant's guards and
        drift sentinel, and per-request row boxing."""
        prep.marks["guard_t0"] = time.monotonic()
        prep.marks["fallback"] = used_fallback
        result = prep.entry.plan.resolve_guarded(
            scored, prep.quarantined, prep.qmask, prep.guards.output,
            used_fallback, prep.guards.breaker, raw=prep.ds,
            sentinel=prep.guards.sentinel)
        if self.lifecycle is not None:
            # ring feed, drift poll and post-swap watch (lifecycle.py);
            # a dict lookup when idle
            self.lifecycle.note_batch(prep)
        rows = result.boxed_rows(prep.entry.result_names)
        if used_fallback:
            for row in rows:
                row["_host_fallback"] = True
        prep.marks["guard_t1"] = time.monotonic()
        return rows

    def _orphan_device_pool(self) -> None:
        """Abandon a wedged device executor (its thread may be stuck in a
        replay forever) and stand up a fresh one, so the loop keeps
        dispatching."""
        self.stats["orphaned_dispatches"] += 1
        old = self._device_pool
        self._device_pool = _cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tx-serve-device")
        old.shutdown(wait=False)

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        """Arm the loop-bound primitives (call from the event loop the
        server will live on)."""
        self.loop = asyncio.get_running_loop()
        self._dispatch_sem = asyncio.Semaphore(1)
        self._running = True

    async def drain(self, timeout: float = 30.0) -> dict:
        """Graceful shutdown: new requests refuse with
        :class:`ServeDraining`, then wait up to ``timeout`` seconds for
        every queued and in-flight request to resolve. Returns
        ``{"drained", "inflight", "seconds"}``."""
        t0 = time.monotonic()
        self._draining = True
        self._drain_event = asyncio.Event()
        _telemetry.count("serve_drains")
        _telemetry.event("serve_draining", inflight=self._inflight)
        if self._inflight == 0:
            self._drain_event.set()
        try:
            await asyncio.wait_for(self._drain_event.wait(), timeout)
            drained = True
        except asyncio.TimeoutError:
            drained = False
            _telemetry.count("serve_drain_timeouts")
        out = {"drained": drained, "inflight": self._inflight,
               "seconds": round(time.monotonic() - t0, 4)}
        _telemetry.event("serve_drained", **out)
        return out

    async def shutdown(self) -> None:
        self._running = False
        for lane in self._lanes.values():
            if lane.wakeup is not None:
                lane.wakeup.set()
            if lane.task is not None:
                lane.task.cancel()
            for req in lane.queue:
                if not req.future.done():
                    req.future.set_exception(
                        ServeRejected("serving loop stopped"))
            lane.queue.clear()

    def start_background(self) -> "ServingClient":
        """Run the server on a daemon-thread event loop and return a sync
        :class:`ServingClient`: the in-process entry point."""
        if self._thread is not None:
            return ServingClient(self)
        ready = threading.Event()

        def runner():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            loop.run_until_complete(self.start())
            ready.set()
            loop.run_forever()
            loop.run_until_complete(self.shutdown())
            loop.close()

        self._thread = threading.Thread(target=runner, daemon=True,
                                        name="tx-serve-loop")
        self._thread.start()
        if not ready.wait(timeout=30):
            raise RuntimeError("serving loop did not start within 30 s")
        return ServingClient(self)

    def stop(self) -> None:
        """Stop the background loop and shut every executor down."""
        if self._thread is None:
            return
        self._running = False
        if self.loop is not None:
            self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=30)
        self._thread = None
        self._encode_pool.shutdown(wait=False)
        self._device_pool.shutdown(wait=False)
        self._fallback_pool.shutdown(wait=False)
        if self.lifecycle is not None:
            self.lifecycle.shutdown()

    # -- introspection -----------------------------------------------------
    def describe(self) -> dict:
        """Loop stats: occupancy (mean rows a dispatch) and device-lane
        saturation (the share of wall time a dispatch was in flight)."""
        batches = self.stats["batches"] or 1
        wall = None
        if self._first_dispatch_at is not None:
            wall = max((self._last_dispatch_at or 0)
                       - self._first_dispatch_at, 1e-9)
        return {
            "requests": int(self.stats["requests"]),
            "batches": int(self.stats["batches"]),
            "rows": int(self.stats["rows"]),
            "mean_batch_occupancy": self.stats["rows"] / batches,
            "full_dispatches": int(self.stats["full_dispatches"]),
            "deadline_dispatches": int(self.stats["deadline_dispatches"]),
            "orphaned_dispatches": int(self.stats["orphaned_dispatches"]),
            "dispatch_saturation": (
                self.stats["dispatch_seconds"] / wall
                if wall is not None else 0.0),
            "plan_cache": {"budget": self.plans.budget,
                           "resident": len(self.plans.resident_entries()),
                           "evictions": self.plans.evictions},
            "models": self.plans.names(),
            "lanes": sorted("/".join(k) for k in self._lanes),
        }

    def process_block(self) -> dict:
        """The ``process`` slice of :meth:`metrics_snapshot`: uptime,
        draining and in-flight requests, and the JAX package's restart
        fields at their values for a process that restores no state
        (restarts and snapshots are not ported)."""
        return {
            "uptime_seconds": round(self.metrics.uptime_seconds(), 3),
            "restart_generation": 0,
            "draining": self._draining,
            "ready": True,
            "inflight": self._inflight,
            "last_snapshot_age_seconds": None,
        }

    def metrics_snapshot(self) -> dict:
        """The live metrics document (the JAX package's schema): loop
        counters, per-tenant latency quantiles, per-lane queue depth,
        plan-cache hits and evictions, per-tenant breaker state, the
        compile count, each tenant's drift state (per-feature JS against
        the warn and degrade thresholds, rows observed), the lifecycle's
        states, watch windows, ring sizes, quarantined lanes and history
        (None without one) and the serving slice of the process
        telemetry. The blocks of modules the port does not have
        (admission, AOT artifacts) report them off."""
        entries = self.plans.resident_entries()
        live = [(name, entry) for (name, _buckets), entry in entries]
        live += [(name, entry) for (name, _tenant), entry
                 in self.plans.swapped_entries().items()]
        breakers, sentinels = {}, {}
        for name, entry in live:
            for tenant, guards in list(entry.guards.items()):
                lane = f"{name}/{tenant}"
                if guards.breaker is not None:
                    breakers[lane] = guards.breaker.state
                if guards.sentinel is not None:
                    report = guards.sentinel.drift_report()
                    sentinels[lane] = {
                        "status": report["status"],
                        "rowsSeen": report["rowsSeen"],
                        "warnThreshold": report["warnThreshold"],
                        "degradeThreshold": report["degradeThreshold"],
                        "generation": guards.sentinel.generation,
                        "features": {
                            f["feature"]: {
                                "jsDivergence": f["jsDivergence"],
                                "status": f["status"],
                                "rowsObserved": f["rowsObserved"],
                            } for f in report["features"]},
                    }
        serving_counters = {
            k: v for k, v in _telemetry.counters().items()
            if k.startswith(("serve_", "serving_", "breaker_", "drift_",
                             "lifecycle_"))}
        lanes = sorted(self._lanes.items())
        return {
            "schema": METRICS_SCHEMA_VERSION,
            "uptime_seconds": round(self.metrics.uptime_seconds(), 3),
            "running": self._running,
            "process": self.process_block(),
            "requests": int(self.stats["requests"]),
            "answered": self.metrics.answered,
            "failed_batches": self.metrics.failed,
            "batches": int(self.stats["batches"]),
            "rows": int(self.stats["rows"]),
            "mean_batch_occupancy": round(
                self.stats["rows"] / (self.stats["batches"] or 1), 3),
            "full_dispatches": int(self.stats["full_dispatches"]),
            "deadline_dispatches": int(self.stats["deadline_dispatches"]),
            "orphaned_dispatches": int(self.stats["orphaned_dispatches"]),
            "queue_depth": {"/".join(k): len(lane.queue)
                            for k, lane in lanes},
            "admission": {"enabled": False},
            "latency_ms": self.metrics.latency_json(),
            "plan_cache": {"budget": self.plans.budget,
                           "resident": len(entries),
                           "hits": self.plans.hits,
                           "misses": self.plans.misses,
                           "evictions": self.plans.evictions},
            "plan_compiles": plan_compiles(),
            "aot": {name: None for (name, _b), _e in entries},
            "breakers": breakers,
            "sentinels": sentinels,
            "lifecycle": (self.lifecycle.snapshot()
                          if self.lifecycle is not None else None),
            "counters": serving_counters,
            "trace": {"enabled": _trace.enabled(),
                      "path": _trace.trace_path()},
        }


class ServingClient:
    """Synchronous in-process facade over a background-thread
    :class:`ServingServer`. ``submit`` returns a concurrent future for
    open-loop load generation; ``score`` blocks for one row."""

    def __init__(self, server: ServingServer):
        self.server = server

    def submit(self, record: dict, model: Optional[str] = None,
               tenant: str = "default") -> "_cf.Future":
        if self.server.loop is None:
            raise ServeRejected("server not started")
        return asyncio.run_coroutine_threadsafe(
            self.server.score_async(record, model=model, tenant=tenant),
            self.server.loop)

    def score(self, record: dict, model: Optional[str] = None,
              tenant: str = "default", timeout: float = 60.0) -> dict:
        return self.submit(record, model=model, tenant=tenant).result(
            timeout)

    def score_many(self, records: Sequence[dict],
                   model: Optional[str] = None, tenant: str = "default",
                   timeout: float = 120.0) -> List[dict]:
        """Submit every record concurrently (they coalesce into shared
        bucket dispatches) and return rows in request order."""
        futs = [self.submit(r, model=model, tenant=tenant)
                for r in records]
        return [f.result(timeout) for f in futs]


def serve_in_process(models: Dict[str, Any],
                     config: Optional[ServeConfig] = None, device="cuda"
                     ) -> Tuple[ServingServer, ServingClient]:
    """One-call setup: register ``models`` (name -> fitted model or saved
    directory) on a server computing on ``device`` (default the card;
    raises without one), start the loop on a background thread, return
    (server, client). The caller owns ``server.stop()``."""
    server = ServingServer(config, device=device)
    for name, m in models.items():
        server.add_model(name, m)
    client = server.start_background()
    return server, client
