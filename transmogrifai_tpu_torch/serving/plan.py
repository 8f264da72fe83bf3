"""ScoringPlan: freeze a fitted DAG into batched, shape-bucketed device
programs, one CUDA graph per row bucket on the card.

The port's copy of ``transmogrifai_tpu/serving/plan.py``. Instead of
walking the DAG stage by stage on host columns per batch (the columnar
path of ``workflow.py``) or record by record (``local/scoring.py``), a
plan:

1. **Composes the DAG once.** ``topo_layers`` is walked and every fitted
   stage is asked for its array kernel (``Transformer.transform_arrays``,
   torch ops). The stages that lower are composed into one function
   ``run(inputs, mask)``; the others run their host ``transform_columns``
   before (``pre``) or after (``post``) it, with the reason in
   ``coverage``. A stage whose kernel fails when the plan first runs it,
   or when a bucket's graph is captured, raises :class:`PlanCompileError`
   naming the stage: the port demotes no stage to the host in its place
   (the JAX package's demotion loop is not ported), but for the drill
   ``plan:<Stage>:compile`` (``runtime/faults.py``), whose injected fault
   sends the stage to the host with the fault as its reason, as there.
   The other drill sites are the bucket dispatch (``plan:device:dispatch``,
   inside the retry policy) and ``serving:output:guard`` (a ``nan`` fault
   poisons the first valid row of a guarded batch).
2. **Buckets batch shapes.** Batches pad up to power-of-two row buckets
   with a validity mask; batches beyond the largest bucket are chunked.
3. **Captures one CUDA graph per bucket on the card.** At a bucket's
   first dispatch (or at :meth:`prewarm`) the plan allocates static input
   tensors of the bucket's shape on the card (one per host input, and the
   mask), runs ``run`` a few times on a side stream to warm up, and
   captures it with ``torch.cuda.graph``. Each chunk then
   copies its encoded arrays into the static inputs from pinned staging
   buffers, replays the graph, and copies the outputs back: one launch of
   the whole program per chunk, the counterpart of the JAX package's one
   jitted XLA program per bucket. On the CPU ``run`` executes eagerly at
   the bucket's shape (float64).

``plan_compiles()`` counts distinct (plan, bucket) programs, which on the
card are the captured graphs: a repeated same-bucket batch adds zero.

Precision follows the columnar path's. Float inputs go up in float64 and
the vectorizers' arithmetic runs in float64 on the card, as numpy runs it;
the model stage casts its feature vector to the working dtype (float32 on
the card), as ``predict_arrays`` casts the columnar path's float64 vector.
So the card's vector equals the columnar one bit for bit; computed in
float32 instead, a feature value rounded otherwise could meet a tree's
threshold and route its row through another branch. Outputs come back
to the host and are widened to float64 before the model's
``prediction_from_raw``.
"""
from __future__ import annotations

import concurrent.futures as _cf
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..features.columns import Dataset, FeatureColumn, PredictionColumn
from ..features.feature import topo_layers
from ..features.generator import FeatureGeneratorStage
from ..observability import trace as _trace
from ..plans.common import (DEFAULT_MAX_BUCKET, DEFAULT_MIN_BUCKET,
                            PlanCompileError, PlanCoverage, PlanStep,
                            bucket_for, bucket_ladder,
                            bucket_profile as _shared_bucket_profile,
                            bucket_section as _bucket_section, compiles,
                            empty_raw_dataset, lowering_reason,
                            pad_rows as _pad_rows, plan_seq, record_compile,
                            record_rows)
from ..runtime import telemetry as _telemetry
from ..runtime.faults import maybe_inject
from ..runtime.retry import RetryPolicy
from ..stages.base import Transformer
from ..types import Prediction
from ..utils.compile_time import note_compile
from ..utils.device import resolve_device, working_dtype
from ..utils.ported import not_ported
from .guard import (AdmissionPolicy, CircuitBreaker, GuardedScoreResult,
                    GuardReason, OutputGuard, ServingGuard,
                    _invalidate_rows, fall_back_to_host)

__all__ = ["ScoringPlan", "EncodedScoreBatch", "PlanCoverage",
           "PlanCompileError", "plan_compiles", "bucket_for",
           "DEFAULT_MIN_BUCKET", "DEFAULT_MAX_BUCKET"]

_log = logging.getLogger(__name__)

#: runs of the composed program on a side stream before a capture (lazy
#: initialization, e.g. of the cuBLAS handle, must not happen inside it)
_WARMUP_RUNS = 3


def plan_compiles() -> int:
    """Distinct scoring programs (captured graphs on the card) so far in
    this process."""
    return compiles("score")


@dataclass
class EncodedScoreBatch:
    """A raw Dataset host-encoded, chunked, padded and masked: ready for
    device dispatch. Splitting :meth:`ScoringPlan.score_raw_dataset` into
    :meth:`~ScoringPlan.encode_raw_dataset` and
    :meth:`~ScoringPlan.dispatch_encoded` lets the serving loop
    double-buffer: batch k+1's host encoding overlaps batch k's dispatch
    (serving/server.py)."""
    #: raw Dataset after the plan's "pre"-phase host stages ran
    ds: Dataset
    n_rows: int
    #: (bucket, padded input arrays, validity mask, live rows) per chunk
    chunks: List[Tuple[int, tuple, np.ndarray, int]] = \
        field(default_factory=list)


def _model_device(model, device) -> torch.device:
    """The device of ``model``'s stages (those that have one must agree);
    ``device``, when given, must be it. A DAG without a device stage
    computes on ``device`` (default the card)."""
    found = {getattr(s, "device", None) for s in model.stages()} - {None}
    if len(found) > 1:
        raise ValueError(f"the model's stages compute on several devices: "
                         f"{sorted(map(str, found))}")
    if not found:
        return resolve_device("cuda" if device is None else device)
    dev = found.pop()
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or want.index not in (None, dev.index):
            raise ValueError(f"the model computes on {dev}, the plan was "
                             f"asked for {want}")
    return dev


class _BucketGraph:
    """One bucket's captured program on the card: static inputs, the
    graph, its static outputs, and pinned host buffers each way."""

    def __init__(self, run: Callable, bucket: int,
                 specs: Sequence[Tuple[tuple, torch.dtype]],
                 dtype: torch.dtype, device: torch.device):
        self.bucket = bucket
        self.inputs = [torch.zeros((bucket,) + tail, dtype=dt, device=device)
                       for tail, dt in specs]
        self.mask = torch.zeros(bucket, dtype=dtype, device=device)
        self.staging = [torch.zeros((bucket,) + tail, dtype=dt,
                                    pin_memory=True) for tail, dt in specs]
        self.mask_staging = torch.zeros(bucket, dtype=dtype, pin_memory=True)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_RUNS):
                run(self.inputs, self.mask)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = run(self.inputs, self.mask)
        self.host_out = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                         for o in self.outputs]
        self.device = device

    def replay(self, arrays: Sequence[np.ndarray],
               mask: np.ndarray) -> List[np.ndarray]:
        """Copy ``arrays`` and ``mask`` in, replay, copy the outputs out.
        The caller holds the plan's dispatch lock: the buffers are shared
        by every dispatch of this bucket."""
        stream = torch.cuda.current_stream(self.device)
        for stage, static, arr in zip(self.staging, self.inputs, arrays):
            stage.numpy()[...] = arr
            static.copy_(stage, non_blocking=True)
        self.mask_staging.numpy()[...] = mask
        self.mask.copy_(self.mask_staging, non_blocking=True)
        self.graph.replay()
        for host, out in zip(self.host_out, self.outputs):
            host.copy_(out, non_blocking=True)
        stream.synchronize()
        return [host.numpy().copy() for host in self.host_out]


class ScoringPlan:
    """A fitted ``WorkflowModel`` frozen into shape-bucketed scoring
    programs on the model's device (captured CUDA graphs on the card).
    Build once per model, reuse per batch:

    >>> plan = ScoringPlan(model).compile()
    >>> scored = plan.score(records)        # Dataset of result columns

    ``device`` defaults to the device the model's stages compute on (a
    model loaded on the CPU gives a CPU plan); a DAG without such a stage
    computes on the card. ``donate`` is kept for the JAX package's
    signature: there it donates the input buffers to the program; on the
    card the graph's static input buffers play that part (each chunk is
    copied into them), so nothing else is donated.
    """

    def __init__(self, model, min_bucket: int = DEFAULT_MIN_BUCKET,
                 max_bucket: int = DEFAULT_MAX_BUCKET,
                 donate: Optional[bool] = None,
                 lattice: Optional[Sequence[int]] = None, device=None):
        if lattice:
            raise not_ported("ScoringPlan(lattice=...), the tuned bucket "
                             "lattices", "tuning/lattice.py")
        self.model = model
        self.min_bucket = int(min_bucket)
        self.max_bucket = int(max_bucket)
        if self.min_bucket < 1 or self.max_bucket < self.min_bucket:
            raise ValueError(
                f"bad bucket range [{min_bucket}, {max_bucket}]")
        self.device = _model_device(model, device)
        self.dtype = working_dtype(self.device)
        self.donate = donate
        self._plan_id = plan_seq()
        self._compiled = False
        self.coverage = PlanCoverage()
        #: serving guardrails (guard.py); None means disabled, and the
        #: default score path is the unguarded one
        self.guard: Optional[ServingGuard] = None
        #: the online drift sentinel (sentinel.py); None means disabled
        self.sentinel = None
        #: GuardedScoreResult of the most recent guarded batch
        self.last_guard_result: Optional[GuardedScoreResult] = None
        self._deadline_pool = None
        #: live rows dispatched per bucket (bucket_profile's rows)
        self._bucket_rows: Dict[int, int] = {}
        #: bucket -> its captured graph (card only)
        self._graphs: Dict[int, _BucketGraph] = {}
        #: bucket -> seconds its graph took to capture, warm-up included
        self.capture_seconds: Dict[int, float] = {}
        #: held around a bucket's capture and every replay: the static
        #: buffers are shared by all dispatches
        self._dispatch_lock = threading.Lock()

    # -- compilation -------------------------------------------------------
    def compile(self) -> "ScoringPlan":
        """Walk the fitted DAG, classify every stage (device kernel or
        host stage), probe zero rows through the numpy path for output
        metadata, compose the device program and run it once at the
        smallest bucket, on zeros. Idempotent."""
        if self._compiled:
            return self
        self._raw_features = self.model.raw_features()
        self._result_names = [f.name for f in self.model.result_features]
        self._retry = RetryPolicy.from_env()
        stages = []
        for layer in topo_layers(self.model.result_features):
            for s in layer:
                if isinstance(s, FeatureGeneratorStage):
                    continue
                if not isinstance(s, Transformer):
                    raise PlanCompileError(
                        f"unfitted estimator {s!r} in scoring DAG")
                stages.append(s)
        self._proto_cols = self._probe_zero_rows(stages)
        self.coverage = PlanCoverage()
        self._classify(stages)
        self._build_device_fn()
        if self.donate is None:
            self.donate = self.device.type == "cuda"
        if self._device_steps:
            # the probe run: every kernel once, on this device, so a
            # broken kernel fails here and by name
            zeros = [np.zeros((self.min_bucket,) + tail, dtype=dt)
                     for tail, dt in self._host_specs()]
            self._run_eager(zeros, np.zeros(self.min_bucket))
        self._compiled = True
        return self

    def fallbacks(self) -> int:
        """How many stages run their host ``transform_columns`` instead of
        the device program (``coverage`` carries the reasons)."""
        return len(self.coverage.fallback)

    def _probe_zero_rows(self, stages: List[Transformer]
                         ) -> Dict[str, FeatureColumn]:
        """Run the whole DAG over zero rows through the numpy path,
        capturing every intermediate column's type/width/metadata so device
        outputs can be wrapped back into the columns the numpy path
        builds. Prediction outputs are stubbed."""
        ds = empty_raw_dataset(self._raw_features)
        for stage in stages:
            out = stage.get_output()
            if issubclass(stage.static_output_type(), Prediction):
                ds = ds.with_column(
                    out.name, PredictionColumn.from_arrays(np.zeros(0)))
                continue
            try:
                ds = stage.transform_dataset(ds)
            except Exception as e:
                raise PlanCompileError(
                    f"stage {type(stage).__name__}({stage.uid}) failed "
                    f"the zero-row probe: {e!r}") from e
        return {name: ds[name] for name in ds.column_names}

    def _classify(self, stages: List[Transformer]) -> None:
        """Assign each stage to the device program or a host phase. A stage
        lowers when it has an array kernel and every input is
        array-feedable (``plans/common.lowering_reason``); a host stage
        downstream of a lowered stage waits for the device outputs (phase
        "post"), and nothing downstream of a "post" stage lowers."""
        producer: Dict[str, str] = {f.name: "host"
                                    for f in self._raw_features}
        steps: List[PlanStep] = []
        for stage in stages:
            out_name = stage.get_output().name
            in_names = tuple(f.name for f in stage.input_features)
            reason = lowering_reason(stage, in_names, producer,
                                     lambda n: self._proto_cols[n])
            if not reason:
                try:
                    maybe_inject("plan", type(stage).__name__, "compile")
                except Exception as e:
                    reason = (f"injected compile fault: "
                              f"{type(e).__name__}: {e}")
            label = f"{type(stage).__name__}({out_name})"
            if not reason:
                phase = "device"
                producer[out_name] = "device"
                self.coverage.lowered.append(label)
            else:
                upstream = {producer.get(n, "host") for n in in_names}
                phase = "pre" if upstream <= {"host"} else "post"
                producer[out_name] = "host" if phase == "pre" else "post"
                self.coverage.fallback.append((label, reason))
            steps.append(PlanStep(stage, out_name, in_names, phase, reason))
        self._steps = steps
        self._producer = producer

        # device inputs: (key, feature name, encoder); encoders with
        # stage-specific lookups get their own key, identity encodings
        # share the feature name
        self._host_inputs: List[Tuple[str, str, Callable]] = []
        seen_keys = set()
        for step in steps:
            if step.phase != "device":
                continue
            for i, name in enumerate(step.input_names):
                if self._producer.get(name) == "device":
                    continue
                key = (f"enc:{step.stage.uid}:{i}"
                       if step.stage.encodes_input(i) else name)
                if key not in seen_keys:
                    seen_keys.add(key)
                    self._host_inputs.append((
                        key, name, lambda col, s=step.stage, slot=i:
                        s.encode_input_column(slot, col)))

        # device outputs materialized back into columns: the result
        # features and the inputs of "post" host stages
        needed = set(self._result_names)
        for step in steps:
            if step.phase == "post":
                needed.update(step.input_names)
        self._device_outputs = [
            s.out_name for s in steps
            if s.phase == "device" and s.out_name in needed]

    def _build_device_fn(self) -> None:
        """Compose the lowered kernels into one function ``run(inputs,
        mask, failed=None)``: the program each bucket's graph captures.
        ``failed``, a dict, receives the label of the stage whose kernel
        raised."""
        device_steps = [
            (s.stage, s.out_name,
             tuple((f"enc:{s.stage.uid}:{i}"
                    if self._producer.get(n) != "device"
                    and s.stage.encodes_input(i) else n)
                   for i, n in enumerate(s.input_names)))
            for s in self._steps if s.phase == "device"]
        self._device_steps = device_steps
        in_keys = tuple(k for k, _, _ in self._host_inputs)
        out_names = tuple(self._device_outputs)

        def run(inputs, mask, failed=None):
            env = dict(zip(in_keys, inputs))
            for stage, out_name, keys in device_steps:
                try:
                    env[out_name] = stage.transform_arrays(
                        [env[k] for k in keys])
                except Exception:
                    if failed is not None:
                        failed["stage"] = f"{type(stage).__name__}({out_name})"
                    raise
            outs = []
            for name in out_names:
                o = env[name]
                outs.append(o * (mask[:, None] if o.ndim == 2 else mask))
            return tuple(outs)

        self._device_fn = run

    def _host_specs(self) -> List[Tuple[tuple, np.dtype]]:
        """(row shape, host dtype) of each host input, from its encoder
        over the zero-row proto column."""
        specs = []
        for _, name, enc in self._host_inputs:
            arr = np.asarray(enc(self._proto_cols[name]))
            specs.append((tuple(arr.shape[1:]), arr.dtype))
        return specs

    @staticmethod
    def _torch_dtype(dt: np.dtype) -> torch.dtype:
        """Device dtype of a host array: floats in float64 (the feature
        arithmetic runs in float64, as on the numpy path; the model stage
        takes its vector in the working dtype), integers and booleans as
        they are."""
        if np.issubdtype(dt, np.floating):
            return torch.float64
        return torch.from_numpy(np.zeros(0, dtype=dt)).dtype

    def _failure(self, what: str, failed: dict,
                 e: Exception) -> PlanCompileError:
        stage = failed.get("stage", "the composed program")
        return PlanCompileError(f"stage {stage} failed {what}: "
                                f"{type(e).__name__}: {e}")

    def _run_eager(self, inputs: Sequence[np.ndarray], mask: np.ndarray,
                   probe: bool = True) -> List[np.ndarray]:
        """One eager run of the composed program on this device, outputs
        on the host in float64. ``probe`` turns a kernel's failure into a
        PlanCompileError naming its stage."""
        tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, self._torch_dtype(a.dtype)) for a in inputs]
        mask_t = torch.from_numpy(np.asarray(mask, dtype=np.float64)).to(
            self.device, self.dtype)
        failed: dict = {}
        try:
            outs = self._device_fn(tensors, mask_t, failed)
        except Exception as e:
            if not probe:
                raise
            raise self._failure("its probe run", failed, e) from e
        return [o.cpu().numpy().astype(np.float64) for o in outs]

    def run_eager(self, inputs: Sequence[np.ndarray],
                  mask: np.ndarray) -> List[np.ndarray]:
        """One chunk (its padded encoded arrays and mask, as
        ``encode_raw_dataset`` makes them) through the composed program,
        eagerly, without a graph: the reference a bucket's graph replay
        is held against."""
        self.compile()
        return self._run_eager(inputs, mask, probe=False)

    def _capture(self, bucket: int) -> _BucketGraph:
        """Capture ``bucket``'s graph (card only; the caller holds the
        dispatch lock)."""
        specs = [(tail, self._torch_dtype(dt))
                 for tail, dt in self._host_specs()]
        failed: dict = {}
        t0 = time.perf_counter()
        try:
            with torch.cuda.device(self.device):
                graph = _BucketGraph(
                    lambda i, m: self._device_fn(i, m, failed), bucket,
                    specs, self.dtype, self.device)
        except Exception as e:
            raise self._failure(f"CUDA graph capture at bucket {bucket}",
                                failed, e) from e
        seconds = time.perf_counter() - t0
        self.capture_seconds[bucket] = seconds
        note_compile(seconds)
        record_compile("score", (self._plan_id, bucket))
        _telemetry.count("plan_graph_captures")
        self._graphs[bucket] = graph
        return graph

    def prewarm(self, buckets: Optional[Sequence[int]] = None
                ) -> Dict[int, float]:
        """Capture the graphs of ``buckets`` (default: every bucket of the
        plan) before traffic, so no request pays a capture. Returns each
        bucket's capture seconds (0.0 for one already captured). On the
        CPU there is nothing to capture: each bucket runs once, and its
        seconds are that run's."""
        self.compile()
        out: Dict[int, float] = {}
        for bucket in (self.buckets() if buckets is None else buckets):
            bucket = int(bucket)
            if not self.min_bucket <= bucket <= self.max_bucket:
                raise ValueError(f"bucket {bucket} outside the plan's range "
                                 f"[{self.min_bucket}, {self.max_bucket}]")
            if not self._device_steps:
                continue
            if self.device.type == "cuda":
                with self._dispatch_lock:
                    if bucket in self._graphs:
                        out[bucket] = 0.0
                        continue
                    self._capture(bucket)
                out[bucket] = self.capture_seconds[bucket]
            else:
                t0 = time.perf_counter()
                self._run_eager([np.zeros((bucket,) + tail, dtype=dt)
                                 for tail, dt in self._host_specs()],
                                np.zeros(bucket))
                out[bucket] = time.perf_counter() - t0
                record_compile("score", (self._plan_id, bucket))
        return out

    # -- guardrails --------------------------------------------------------
    def with_guardrails(self, admission: Optional[AdmissionPolicy] = None,
                        output_guard: Optional[OutputGuard] = None,
                        breaker: Optional[CircuitBreaker] = None,
                        deadline_seconds: Optional[float] = None,
                        sentinel: Any = True,
                        thresholds=None) -> "ScoringPlan":
        """Enable the serving guardrails: schema admission, output guards,
        the circuit breaker, a per-batch deadline and (``sentinel=True``,
        the default) the online drift sentinel with ``thresholds``.
        Guardrails are off unless this is called. ``sentinel`` may also
        be a prebuilt :class:`~.sentinel.DriftSentinel`."""
        self.guard = ServingGuard(self.model, admission=admission,
                                  output_guard=output_guard,
                                  breaker=breaker,
                                  deadline_seconds=deadline_seconds)
        from .sentinel import DriftSentinel
        if isinstance(sentinel, DriftSentinel):
            self.sentinel = sentinel
        elif sentinel:
            self.sentinel = DriftSentinel.for_model(
                self.model, thresholds=thresholds)
            if self.sentinel is None:
                _log.warning(
                    "drift sentinel unavailable: the model carries no "
                    "training fingerprints (re-save it with this build "
                    "or train in-process); serving without drift "
                    "monitoring")
        return self

    def drift_report(self) -> dict:
        """Per-feature JS divergence of the scored traffic against
        training (sentinel.py); ``{"enabled": False}`` without a
        sentinel."""
        if self.sentinel is None:
            return {"enabled": False}
        report = self.sentinel.drift_report()
        report["enabled"] = True
        return report

    # -- execution ---------------------------------------------------------
    def score(self, data: Any) -> Dataset:
        """Score a Dataset, record iterable or DataReader through the
        plan; returns the raw and result feature columns (the
        ``Workflow.score`` contract). With guardrails enabled this routes
        through :meth:`score_guarded`, keeping its ledger on
        ``last_guard_result``."""
        if self.guard is not None or self.sentinel is not None:
            return self.score_guarded(data).scored
        self.compile()
        from ..workflow.workflow import _generate_raw_data
        ds = _generate_raw_data(self._raw_features, data,
                                require_responses=False)
        return self.score_raw_dataset(ds)

    def score_guarded(self, data: Any) -> GuardedScoreResult:
        """Guarded batch scoring: admission -> masked device scoring (or
        the host columnar path behind the breaker) -> output guards. The
        returned Dataset keeps every row; quarantined or invalidated rows
        carry NaN outputs and one machine-readable reason each."""
        self.compile()
        from ..readers.data_readers import DataReader
        from ..workflow.workflow import _generate_raw_data
        if self.guard is not None \
                and not isinstance(data, (Dataset, DataReader)):
            # record admission materializes the raw Dataset itself:
            # malformed fields become boxable placeholders, and the row
            # is masked out
            ds, reasons = self.guard.schema.admit_records(list(data))
            return self._score_guarded_raw(ds, pre_reasons=reasons,
                                           columnar_admission=False)
        ds = _generate_raw_data(self._raw_features, data,
                                require_responses=False)
        return self._score_guarded_raw(ds)

    def _score_guarded_raw(self, ds: Dataset,
                           pre_reasons: Optional[List[GuardReason]] = None,
                           columnar_admission: bool = True
                           ) -> GuardedScoreResult:
        """Core guarded path over a materialized raw Dataset."""
        with _trace.span("score.guarded", rows=ds.n_rows):
            return self._score_guarded_raw_inner(
                ds, pre_reasons=pre_reasons,
                columnar_admission=columnar_admission)

    def _score_guarded_raw_inner(self, ds: Dataset,
                                 pre_reasons: Optional[
                                     List[GuardReason]] = None,
                                 columnar_admission: bool = True
                                 ) -> GuardedScoreResult:
        n = ds.n_rows
        quarantined: List[GuardReason] = list(pre_reasons or [])
        if self.guard is not None and columnar_admission:
            ds, more = self.guard.schema.admit_dataset(ds)
            quarantined.extend(more)
        qmask = np.zeros(n, dtype=bool)
        for r in quarantined:
            if 0 <= r.row < n:
                qmask[r.row] = True
        valid = (~qmask).astype(np.float64)

        breaker = self.guard.breaker if self.guard is not None else None
        used_fallback = False
        try:
            if breaker is not None:
                breaker.before_dispatch()
            scored = self.score_raw_dataset(ds, valid_mask=valid)
            if breaker is not None:
                breaker.record_success()
        except Exception as e:
            if not fall_back_to_host(breaker, e, "device scoring"):
                raise
            used_fallback = True
            scored = self.score_host_columnar(ds)
        # drill site: poison one output row, so the output guard's
        # invalidate path can be driven
        if maybe_inject("serving", "output", "guard") == "nan":
            scored = _poison_first_valid_row(scored, self._result_names,
                                             qmask)
        result = self.resolve_guarded(
            scored, quarantined, qmask,
            self.guard.output if self.guard is not None else None,
            used_fallback, breaker, raw=ds, sentinel=self.sentinel)
        self.last_guard_result = result
        return result

    def resolve_guarded(self, scored: Dataset,
                        quarantined: List[GuardReason], qmask: np.ndarray,
                        output_guard: Optional[OutputGuard],
                        used_fallback: bool,
                        breaker: Optional[CircuitBreaker],
                        raw: Optional[Dataset] = None,
                        sentinel=None) -> GuardedScoreResult:
        """The guarded path's finish over a scored batch: the output
        guard, NaN for quarantined rows (their zeroed device outputs mean
        nothing), the drift ``sentinel``'s observation of the admitted
        rows of the ``raw`` batch, the row counters, and the result with
        its ledger. The serving loop calls it with a tenant's own
        guards."""
        invalidated: List[GuardReason] = []
        if output_guard is not None:
            scored, invalidated = output_guard.check(
                scored, self._result_names, skip_rows=qmask)
        if qmask.any():
            scored = _invalidate_rows(scored, self._result_names, qmask)
        if sentinel is not None and raw is not None:
            sentinel.observe_dataset(
                raw.take(np.flatnonzero(~qmask)) if qmask.any() else raw)
        n_bad = int(qmask.sum())
        _telemetry.count("serving_rows_scored", scored.n_rows - n_bad)
        if n_bad:
            _telemetry.count("serving_rows_quarantined", n_bad)
        if invalidated:
            _telemetry.count("serving_rows_invalidated",
                             len({r.row for r in invalidated}))
        return GuardedScoreResult(
            scored=scored, quarantined=list(quarantined),
            invalidated=invalidated, used_host_fallback=used_fallback,
            breaker_state=(breaker.state if breaker is not None
                           else CircuitBreaker.CLOSED))

    def score_host_columnar(self, ds: Dataset) -> Dataset:
        """The host columnar path (every stage's ``transform_columns``,
        layer by layer; the model stage predicts on its device) as a
        whole-batch fallback when device dispatch is unavailable: the
        outputs of ``engine="columnar"``. The serving loop routes a
        tenant's breaker-open or failed-dispatch batches here; each call
        counts in ``serving_host_fallback_batches``."""
        from ..workflow.workflow import _fit_and_transform_layers
        _telemetry.count("serving_host_fallback_batches")
        layers = topo_layers(self.model.result_features)
        return self._select_outputs(_fit_and_transform_layers(layers, ds))

    def score_raw_dataset(self, ds: Dataset,
                          valid_mask: Optional[np.ndarray] = None
                          ) -> Dataset:
        """Score an already-materialized raw Dataset (every raw feature
        column present; absent responses NaN-filled by the caller).
        ``valid_mask`` (the guarded path) zeroes quarantined rows inside
        the padded device batch: same shapes, no new graph."""
        self.compile()
        return self.dispatch_encoded(
            self.encode_raw_dataset(ds, valid_mask=valid_mask))

    def encode_raw_dataset(self, ds: Dataset,
                           valid_mask: Optional[np.ndarray] = None
                           ) -> EncodedScoreBatch:
        """The host half of scoring: run the "pre"-phase host stages,
        encode every device input column once, and chunk, pad and mask
        the arrays onto the buckets. Host work only: the serving loop runs
        it for batch k+1 while batch k's dispatch is in flight."""
        self.compile()
        with _trace.span("score.encode", rows=ds.n_rows):
            return self._encode_raw_dataset_inner(ds, valid_mask)

    def _encode_raw_dataset_inner(self, ds: Dataset,
                                  valid_mask: Optional[np.ndarray]
                                  ) -> EncodedScoreBatch:
        n = ds.n_rows
        for step in self._steps:
            if step.phase == "pre":
                ds = step.stage.transform_dataset(ds)

        encoded = [(key, np.asarray(enc(ds[name])))
                   for key, name, enc in self._host_inputs]
        chunks: List[Tuple[int, tuple, np.ndarray, int]] = []
        for start in range(0, max(n, 1), self.max_bucket):
            stop = min(start + self.max_bucket, n)
            rows = stop - start
            bucket = bucket_for(rows, self.min_bucket, self.max_bucket)
            inputs = tuple(_pad_rows(arr[start:stop], bucket)
                           for _, arr in encoded)
            mask = np.zeros(bucket, dtype=np.float64)
            if valid_mask is None:
                mask[:rows] = 1.0
            else:
                mask[:rows] = valid_mask[start:stop]
            chunks.append((bucket, inputs, mask, rows))
            if n == 0:
                break
        return EncodedScoreBatch(ds=ds, n_rows=n, chunks=chunks)

    def dispatch_encoded(self, enc: EncodedScoreBatch) -> Dataset:
        """The device half of scoring: dispatch every encoded chunk
        (per-bucket cost recorded for :meth:`bucket_profile`), then
        materialize the columns and run the "post"-phase host stages."""
        out_chunks: List[List[np.ndarray]] = [[] for _ in
                                              self._device_outputs]
        with _trace.span("score.dispatch", rows=enc.n_rows,
                         chunks=len(enc.chunks)):
            for bucket, inputs, mask, rows in enc.chunks:
                record_compile("score", (self._plan_id, bucket))
                self._bucket_rows[bucket] = \
                    self._bucket_rows.get(bucket, 0) + rows
                record_rows("score", rows)
                with _bucket_section("score", self._plan_id, bucket):
                    outs = self._dispatch_device(inputs, mask, bucket)
                for i, o in enumerate(outs):
                    out_chunks[i].append(o[:rows])
        return self._finish_score(enc.ds, out_chunks)

    def bucket_profile(self) -> Dict[int, dict]:
        """Observed per-bucket dispatch cost of this plan: ``{bucket:
        {calls, wall_seconds, compile_seconds, execute_seconds, rows}}``,
        ``compile_seconds`` being the bucket's graph capture and ``rows``
        the real (pre-padding) rows. The serving coalescer reads it to
        pick its dispatch target."""
        return _shared_bucket_profile("score", self._plan_id,
                                      self._bucket_rows)

    def _run_bucket(self, bucket: int, inputs: Sequence[np.ndarray],
                    mask: np.ndarray) -> List[np.ndarray]:
        """One chunk through the device program: a graph replay on the
        card (capturing the bucket's graph at its first use), an eager
        run on the CPU. Outputs on the host, float64."""
        if self.device.type != "cuda":
            return self._run_eager(inputs, mask, probe=False)
        with self._dispatch_lock, torch.cuda.device(self.device):
            graph = self._graphs.get(bucket)
            if graph is None:
                graph = self._capture(bucket)
            outs = graph.replay(inputs, mask)
        return [o.astype(np.float64) for o in outs]

    def _dispatch_device(self, inputs, mask, bucket: int):
        """One dispatch behind the runtime retry policy: a transient
        error (a CUDA out-of-memory, a launch timeout) retries with
        backoff instead of failing the request; other errors propagate.
        With a guardrail deadline, the whole dispatch (retries included)
        runs under a per-batch wall-clock budget: a hung dispatch is
        abandoned (its thread orphaned; a replay cannot be killed) and
        surfaces as DEADLINE_EXCEEDED for the breaker."""
        def attempt():
            maybe_inject("plan", "device", "dispatch")
            return self._run_bucket(bucket, inputs, mask)

        deadline = (self.guard.deadline_seconds
                    if self.guard is not None else None)
        if deadline is None:
            return self._retry.call(attempt, description="plan-dispatch")
        if self._deadline_pool is None:
            self._deadline_pool = _cf.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tx-serve-dispatch")
        future = self._deadline_pool.submit(
            self._retry.call, attempt, description="plan-dispatch")
        try:
            return future.result(timeout=deadline)
        except _cf.TimeoutError:
            future.cancel()
            # the pool thread may be wedged inside the dispatch; the next
            # batch gets a new pool instead of queueing behind it
            self._deadline_pool.shutdown(wait=False)
            self._deadline_pool = None
            _telemetry.count("serving_deadline_exceeded")
            raise TimeoutError(
                f"DEADLINE_EXCEEDED: device scoring batch exceeded the "
                f"{deadline}s per-batch deadline") from None

    def _finish_score(self, ds: Dataset, out_chunks) -> Dataset:
        for name, chunks in zip(self._device_outputs, out_chunks):
            arr = (np.concatenate(chunks, axis=0) if chunks
                   else np.zeros(0))
            ds = ds.with_column(name, self._wrap_output(name, arr))
        for step in self._steps:
            if step.phase == "post":
                ds = step.stage.transform_dataset(ds)
        return self._select_outputs(ds)

    def _select_outputs(self, ds: Dataset) -> Dataset:
        keep = [f.name for f in self._raw_features if f.name in ds] \
            + list(self._result_names)
        return ds.select(list(dict.fromkeys(keep)))

    def _wrap_output(self, name: str, arr: np.ndarray) -> FeatureColumn:
        """A device output as the column the numpy path builds (metadata
        from the zero-row probe; a prediction's raw output through the
        model's own ``prediction_from_raw``)."""
        step = next(s for s in self._steps if s.out_name == name)
        stage = step.stage
        if issubclass(stage.static_output_type(), Prediction):
            return stage.prediction_from_raw(arr)
        proto = self._proto_cols[name]
        if proto.kind == "vector":
            return FeatureColumn(ftype=proto.ftype,
                                 data=arr.reshape(len(arr), -1),
                                 metadata=proto.metadata)
        return FeatureColumn(ftype=proto.ftype, data=arr.reshape(-1))

    # -- introspection -----------------------------------------------------
    def describe(self) -> dict:
        """Plan summary for logs and the smoke."""
        self.compile()
        return {
            "device": str(self.device),
            "stages": len(self._steps),
            "device_stages": len(self.coverage.lowered),
            "fallback_stages": len(self.coverage.fallback),
            "coverage": self.coverage.to_json(),
            "host_inputs": [k for k, _, _ in self._host_inputs],
            "device_outputs": list(self._device_outputs),
            "buckets": self.buckets(),
            "captured_buckets": sorted(self._graphs),
            "capture_seconds": dict(sorted(self.capture_seconds.items())),
        }

    def buckets(self) -> List[int]:
        """The plan's bucket ladder."""
        return list(bucket_ladder(self.min_bucket, self.max_bucket))

    def attach_artifacts(self, execs, manifest=None):
        raise not_ported("ScoringPlan.attach_artifacts, the AOT plan "
                         "artifacts", "artifacts/")


def _poison_first_valid_row(scored: Dataset, result_names, qmask
                            ) -> Dataset:
    """The ``serving:output:guard:N=nan`` drill: NaN the first
    non-quarantined row's prediction (inf a numeric output), so the output
    guard's invalidate-with-reason path runs end to end."""
    valid = np.flatnonzero(~qmask)
    if valid.size == 0:
        return scored
    row = int(valid[0])
    for name in result_names:
        if name not in scored:
            continue
        col = scored[name]
        if isinstance(col, PredictionColumn):
            data = col.data.copy()
            data[row] = np.nan
            scored = scored.with_column(name, PredictionColumn(
                ftype=col.ftype, data=data, metadata=col.metadata,
                probability=col.probability,
                raw_prediction=col.raw_prediction))
        elif col.kind == "numeric":
            data = np.asarray(col.data, dtype=np.float64).copy()
            data[row] = np.inf
            scored = scored.with_column(name, FeatureColumn(
                ftype=col.ftype, data=data, metadata=col.metadata))
    return scored
