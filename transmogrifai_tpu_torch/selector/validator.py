"""Hyperparameter validation: k-fold cross-validation and the single
train/validation split (device-resident search).

Counterpart of ``transmogrifai_tpu/selector/validator.py``
(``CrossValidation``, ``TrainValidationSplit``: ``_assignments``,
``_build_fold_arrays``, ``_try_device_eval``, ``_results_from_matrix``,
``validate_prepared``, ``_pick_best``, ``ValidationResult``,
``BestEstimator``, ``family_profile``, ``_use_batched_kernel``,
``_batched_fold_raw``, ``_family_host_results``). Each family evaluates
its whole fold x grid on its device and returns one (folds, grid) metric
matrix (``cand_idx`` narrows it to a candidate subset, as racing rungs
ask). Under an evaluator without a device metric (the log loss, a
user's own ``metric_from``) a family takes the host path: its
``fit_fold_grid_arrays`` fits every candidate as the device search
does (masked, on the whole matrix), the tree models of a fold score in
one stacked traversal (``models/trees.batch_predict_raw``), and the
evaluator runs on the host; a family without that batch, or whose batch
rejects the data, is fitted candidate by candidate on each fold's rows.
Workflow-level CV hands ``validate_prepared`` one matrix per fold, each
searched on its own device. Multi-fidelity racing is
``selector/racing.py``.

The fault-tolerant runtime (``runtime/``) wraps every family's search, as
in the JAX package (``_dispatch_device_evals``, ``_host_results_journaled``,
``_pick_best``): a journaled (family, candidates, rung) evaluation replays
from ``checkpoint_dir`` without dispatching; a transient error retries
under ``retry_policy``; a family whose error persists, is family-scoped,
or whose metric matrix is non-finite is quarantined (after a CUDA
out-of-memory its memory is released before the next family runs) and
the search goes on with the survivors; a classified bug, a sticky CUDA
error among them, propagates; ``AllFamiliesFailedError`` names every
family when none survives. Families run one after another, on the
calling thread; with a ``family_deadline`` each runs on a worker thread
of its own, abandoned (its results dropped) when it outlives the
deadline. The JAX package's concurrent dispatch of all families and its
mesh are not ported (one card).
"""
from __future__ import annotations

import contextvars
import functools
import gc
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..evaluators.base import Evaluator
from ..models.base import FamilyPreconditionError, Predictor
from ..observability import trace as _trace
from ..runtime import telemetry as _telemetry
from ..runtime.context import RuntimeContext
from ..runtime.errors import AllFamiliesFailedError, BUG, classify_error
from ..runtime.faults import maybe_inject
from ..utils.device import take_rows
from .splitters import stratified_split

_log = logging.getLogger(__name__)

__all__ = ["ValidationResult", "BestEstimator", "CrossValidation",
           "TrainValidationSplit", "family_profile", "reset_family_profile"]

#: per-family search accounting (seconds, nvcc build seconds, calls),
#: accumulated across every search in this process
_FAMILY_PROFILE: Dict[str, Dict[str, float]] = {}


def family_profile() -> List[dict]:
    """Per-family search profile rows, slowest first: ``{"family",
    "seconds", "compileSeconds", "executeSeconds", "calls"}``. A family's
    seconds run from its dispatch to the read-back of its metric matrix,
    which waits for the device. ``compileSeconds`` is the ``nvcc`` build
    time of the port's kernels (``_build.py``) spent inside the dispatch:
    0 once they are built. The JAX package's XLA trace and compile time,
    which the field holds there, has no counterpart in the port's eager
    ops."""
    return [
        {"family": k, "seconds": round(v["seconds"], 4),
         "compileSeconds": round(min(v["compile"], v["seconds"]), 4),
         "executeSeconds": round(
             max(0.0, v["seconds"] - v["compile"]), 4),
         "calls": int(v["calls"])}
        for k, v in sorted(_FAMILY_PROFILE.items(),
                           key=lambda kv: -kv[1]["seconds"])]


def reset_family_profile() -> None:
    _FAMILY_PROFILE.clear()


#: what a dispatch returns for a quarantined family, distinct from None
#: (no device path: the host evaluation takes over)
_QUARANTINED = object()


#: what ``_on_deadline_thread`` returns when the thread outlived its
#: deadline
_ABANDONED = object()


def _release_device_memory(oom: bool) -> None:
    """After a CUDA out-of-memory (``oom``), free what the failed family
    held and return the cached blocks to the card, so the next family does
    not meet the same wall. Call it once the exception is gone: its
    traceback holds the failed frames and their tensors. The tree designs
    the search binned stay cached: the other tree families read them."""
    if oom and torch.cuda.is_available():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _guarded(ctx: RuntimeContext, name: str, fn, fields=dict):
    """``fn()`` behind the runtime: a classified bug propagates; any other
    error quarantines family ``name`` in ``ctx`` (the record also gets
    ``fields()``, read once the error is caught) and gives
    ``_QUARANTINED``, after a CUDA out-of-memory once the card's memory
    is released."""
    try:
        return fn()
    except Exception as e:
        kind = classify_error(e)
        if kind == BUG:
            raise
        ctx.quarantine(name, f"{type(e).__name__}: {e}", kind=kind,
                       error_type=type(e).__name__, **fields())
        oom = isinstance(e, torch.cuda.OutOfMemoryError)
    _release_device_memory(oom)
    return _QUARANTINED


def _on_deadline_thread(fn, deadline: float, device):
    """``fn()`` on a daemon worker thread given ``deadline`` seconds: its
    value, what it raised (raised again here), or ``_ABANDONED`` when the
    thread outlived the deadline. The worker runs in a copy of the
    caller's context (its spans nest under the caller's) with ``device``
    as its current CUDA device. An abandoned thread may run on, but
    nothing it returns or raises is read: the caller alone records
    results, journal lines and quarantines."""
    box: Dict[str, object] = {}
    finished = threading.Event()

    def work():
        try:
            if device is not None and device.type == "cuda":
                torch.cuda.set_device(device)
            box["value"] = fn()
        except BaseException as e:          # KillPoint included
            box["error"] = e
        finally:
            finished.set()

    threading.Thread(target=contextvars.copy_context().run, args=(work,),
                     daemon=True, name="tx-family-deadline").start()
    if not finished.wait(deadline):
        return _ABANDONED
    if "error" in box:
        raise box["error"]
    return box.get("value")


@dataclass
class ValidationResult:
    """Metric record for one (model family, grid point).

    The racing scheduler (``selector/racing.py``) annotates each record
    with its multi-fidelity trajectory: ``rung`` is the highest rung the
    candidate was evaluated at, ``budget_spent`` the fold-fit equivalents
    it consumed (full CV = num_folds per candidate) and ``pruned_at`` the
    rung where the racer dropped it (None = survived to the final
    full-fidelity rung). All three stay None/0, and out of the JSON, under
    exact validation."""
    model_name: str
    model_uid: str
    grid_index: int
    params: Dict
    metric_values: List[float] = field(default_factory=list)
    rung: Optional[int] = None
    budget_spent: float = 0.0
    pruned_at: Optional[int] = None

    @property
    def mean_metric(self) -> float:
        return float(np.mean(self.metric_values))

    def to_json(self) -> dict:
        out = {"modelName": self.model_name, "modelUID": self.model_uid,
               "gridIndex": self.grid_index, "params": self.params,
               "metricValues": [float(v) for v in self.metric_values],
               "meanMetric": self.mean_metric}
        if self.rung is not None:
            out["rung"] = self.rung
            out["budgetSpent"] = float(self.budget_spent)
            out["prunedAt"] = self.pruned_at
        return out

    @classmethod
    def from_json(cls, d: dict) -> "ValidationResult":
        return cls(model_name=d["modelName"], model_uid=d["modelUID"],
                   grid_index=d["gridIndex"], params=dict(d["params"]),
                   metric_values=list(d["metricValues"]),
                   rung=d.get("rung"),
                   budget_spent=d.get("budgetSpent", 0.0),
                   pruned_at=d.get("prunedAt"))


@dataclass
class BestEstimator:
    """Winner of validation."""
    estimator: Predictor
    name: str
    params: Dict
    metric: float
    results: List[ValidationResult] = field(default_factory=list)


def _batched_fold_raw(fitted_fold_models, X_val) -> dict:
    """Raw predictions of every tree model of one fold in one stacked
    traversal per static shape (``models/trees.batch_predict_raw``);
    ``{}`` when the batch is not implemented, so each model predicts on
    its own. Any other error propagates: a failing kernel is a fault, not
    a reason to take a slower path."""
    from ..models.trees import batch_predict_raw
    try:
        return batch_predict_raw(fitted_fold_models, X_val)
    except NotImplementedError:
        return {}


class _ValidatorBase:
    """What k-fold CV and the single split share: folds, the device
    search, the host path and the winner's pick."""

    def __init__(self, evaluator: Evaluator, seed: int = 42,
                 stratify: bool = False):
        self.evaluator = evaluator
        self.seed = seed
        self.stratify = stratify
        #: the runtime's knobs, set directly or through
        #: ModelSelector(checkpoint_dir=..., ...): journal completed
        #: family evaluations here and replay them on a resumed search
        self.checkpoint_dir: Optional[str] = None
        #: RetryPolicy of transient dispatch failures (None: the
        #: TX_RETRY_* environment defaults)
        self.retry_policy = None
        #: wall-clock seconds a family's search may take before its
        #: worker thread is abandoned and the family quarantined
        self.family_deadline: Optional[float] = None
        #: RuntimeContext of the last validate() call, whose quarantine
        #: ledger the selector reads
        self.last_runtime: Optional[RuntimeContext] = None

    # -- fault-tolerant runtime --------------------------------------------
    @staticmethod
    def _family_key(fi: int, estimator) -> str:
        """Journal and dispatch identity of one family in this pool: the
        pool index tells two instances of a class apart."""
        return f"{fi}:{type(estimator).__name__}"

    def _begin_runtime(self, models, X, y) -> RuntimeContext:
        """This search's RuntimeContext (quarantine ledger, retry and, with
        a ``checkpoint_dir``, the journal keyed by the search fingerprint:
        pool, splits, seed and data, the matrix copied to the host once
        for it)."""
        ctx = RuntimeContext(retry=self.retry_policy,
                             family_deadline=self.family_deadline)
        if self.checkpoint_dir and X is not None:
            from ..runtime.journal import search_fingerprint
            params = dict(self.get_params(),
                          validationType=type(self).__name__)
            # the header's record of the devices searched on: one card
            ctx.open_journal(self.checkpoint_dir,
                             search_fingerprint(models, params, X, y),
                             topology={"devices": 1, "mesh": None})
        self.last_runtime = ctx
        return ctx

    def _results_from_journal(self, estimator, grid, metric_rows
                              ) -> List["ValidationResult"]:
        """ValidationResults rebuilt from journaled per-candidate fold
        vectors, bit for bit (JSON doubles round-trip through repr)."""
        return [
            ValidationResult(
                model_name=type(estimator).__name__,
                model_uid=estimator.uid, grid_index=gi,
                params=dict(params),
                metric_values=[float(v) for v in metric_rows[gi]])
            for gi, params in enumerate(grid)]

    def _dispatch_device_evals(self, tasks, folds: int,
                               ctx: RuntimeContext,
                               rung: Optional[int] = None,
                               rung_label: str = "exact", device=None):
        """Run each family's device-search thunk behind the runtime, in
        order. ``tasks`` is [(family name, family key, candidate indices,
        thunk)]; returns per task an (F, G) metric matrix, None (no
        device path: the host evaluation takes over) or ``_QUARANTINED``.

        - a journaled (family, candidates, rung) evaluation replays
          without dispatching anything;
        - transient errors (a CUDA out-of-memory, a preemption) retry
          under ``ctx.retry``; an error that persists or is family-scoped
          quarantines the family, and a classified bug propagates;
        - a matrix at least ``ctx.nan_quarantine_fraction`` non-finite
          quarantines the family;
        - with ``ctx.family_deadline``, each family runs on a worker
          thread (on ``device``) that is abandoned, its family
          quarantined and its results kept out of the journal, when it
          outlives the deadline."""
        deadline = ctx.family_deadline

        def run_task(name, key, cands, thunk):
            with _trace.span("search.family", family=name,
                             rung=rung_label, cands=len(cands),
                             folds=folds):
                return run_task_traced(name, key, cands, thunk)

        def run_task_traced(name, key, cands, thunk):
            cached = ctx.journal_lookup(key, rung_label, cands)
            if cached is not None:
                # the journal stores per-candidate fold vectors; the
                # dispatch contract is (folds, candidates)
                _trace.add_event("journal.replay", family=name,
                                 rung=rung_label, cands=len(cands))
                return np.asarray(cached, dtype=np.float64).T

            def attempt():
                maybe_inject("family", name, "dispatch")
                return thunk()

            retries = [0]

            def dispatch():
                return ctx.retry.call(
                    attempt, description=f"dispatch:{name}",
                    on_retry=lambda a, e: retries.__setitem__(0, a + 1))

            if deadline is not None:
                dispatch = functools.partial(_on_deadline_thread, dispatch,
                                             deadline, device)
            mm = _guarded(ctx, name, dispatch,
                          lambda: {"rung": rung, "retries": retries[0]})
            if mm is _ABANDONED:
                # its results stay out of the search and the journal
                ctx.quarantine(
                    name, f"family dispatch exceeded the {deadline:g}s "
                          f"deadline (backend hung or wedged); thread "
                          f"abandoned", kind="deadline", rung=rung)
                return _QUARANTINED
            if mm is _QUARANTINED or mm is None:
                return mm
            if maybe_inject("family", name, "metric") == "nan":
                mm = np.full_like(np.asarray(mm, dtype=np.float64), np.nan)
            arr = np.asarray(mm, dtype=np.float64)
            if arr.size:
                bad = 1.0 - float(np.mean(np.isfinite(arr)))
                if bad >= ctx.nan_quarantine_fraction:
                    ctx.quarantine(
                        name, f"{bad:.0%} of device metrics non-finite",
                        kind="metrics", rung=rung)
                    return _QUARANTINED
            _telemetry.note_dispatch(key, rung_label, tuple(cands), folds)
            ctx.journal_record(key, rung_label, cands, arr.T.tolist(),
                               folds)
            return arr

        return [run_task(*t) for t in tasks]

    def _host_results_journaled(self, fi, estimator, grid, X, y, masks,
                                fold_data, ctx: RuntimeContext,
                                label: str = "exact-host"
                                ) -> List["ValidationResult"]:
        """One family's host evaluation behind the runtime: journal replay
        first, quarantine on a classified failure, a journal record on
        success. The label ``"exact-host"`` keeps host metric vectors from
        ever replaying into the device-matrix path."""
        key = self._family_key(fi, estimator)
        cands = tuple(range(len(grid)))
        cached = ctx.journal_lookup(key, label, cands)
        if cached is not None:
            _trace.add_event("journal.replay",
                             family=type(estimator).__name__,
                             rung=label, cands=len(cands))
            return self._results_from_journal(estimator, grid, cached)
        with _trace.span("search.family", family=type(estimator).__name__,
                         rung=label, path="host", cands=len(cands),
                         folds=len(fold_data)):
            host = _guarded(ctx, type(estimator).__name__,
                            lambda: self._family_host_results(
                                estimator, grid, X, y, masks, fold_data))
        if host is _QUARANTINED:
            return []
        _telemetry.note_dispatch(key, label, cands, len(fold_data))
        ctx.journal_record(key, label, cands,
                           [r.metric_values for r in host], len(fold_data))
        return host

    # -- split construction ------------------------------------------------
    def _splits(self, y: np.ndarray
                ) -> List[Tuple[np.ndarray, np.ndarray]]:
        raise NotImplementedError

    def _assignments(self, y: np.ndarray, k: int) -> np.ndarray:
        """Fold id per row; -1 = dropped. Folds are exactly equal-sized
        (up to k-1 remainder rows per stratum are dropped), as in the
        reference, so the validation folds stack."""
        rng = np.random.default_rng(self.seed)
        assign = np.full(len(y), -1, dtype=np.int64)

        def round_robin(idx: np.ndarray):
            m = (len(idx) // k) * k
            perm = rng.permutation(idx)
            assign[perm[:m]] = np.arange(m) % k

        if self.stratify:
            for cls in np.unique(y):
                round_robin(np.nonzero(y == cls)[0])
        else:
            round_robin(np.arange(len(y)))
        return assign

    def _build_fold_arrays(self, X, y: np.ndarray):
        """(masks (F, n), spec, X_val_st (F, nv, d), y_val_st (F, nv)):
        fold train masks over the prepared matrix and the stacked
        validation folds (gathered on X's device when X is a tensor)."""
        splits = self._splits(y)
        masks = np.zeros((len(splits), len(y)))
        for f, (train_idx, _) in enumerate(splits):
            masks[f, train_idx] = 1.0
        spec = self.evaluator.device_metric_spec()
        folds = [take_rows(X, va) for _, va in splits]
        X_val_st = (torch.stack(folds) if isinstance(X, torch.Tensor)
                    else np.stack(folds))
        y_val_st = np.stack([y[va] for _, va in splits])
        return masks, spec, X_val_st, y_val_st

    def _fold_data(self, X, y: np.ndarray):
        """[(X_tr, y_tr, X_val, y_val)] of every split, rows gathered on
        X's device: the host path's folds."""
        return [(take_rows(X, tr), y[tr], take_rows(X, va), y[va])
                for tr, va in self._splits(y)]

    # -- evaluation --------------------------------------------------------
    def _use_batched_kernel(self, estimator) -> bool:
        """Whether the host path hands this family's grid to its batched
        fold x grid fit: it must have one."""
        return hasattr(estimator, "fit_fold_grid_arrays")

    def _try_device_eval(self, estimator, grid, X, y, masks, X_val_st,
                         y_val_st, spec, cand_idx=None
                         ) -> Optional[np.ndarray]:
        """(F, G) metric matrix from the family's fused fit+metric path,
        or None when the family or metric has none. ``cand_idx`` (racing
        rungs) evaluates only that candidate subset: the matrix is then
        (F, len(cand_idx))."""
        if spec is None or not hasattr(estimator, "eval_fold_grid_arrays"):
            return None
        kwargs = {} if cand_idx is None else {"cand_idx": cand_idx}
        t0, b0 = time.perf_counter(), _build.build_seconds()
        try:
            return estimator.eval_fold_grid_arrays(
                X, y, masks, grid, X_val_st, y_val_st, spec, **kwargs)
        except NotImplementedError:
            return None
        except FamilyPreconditionError as e:
            # the data violates the family's preconditions (NaiveBayes on
            # negative features): the host path scores it NaN per fold
            _log.warning("device eval of %s rejected the data: %s",
                         type(estimator).__name__, e)
            return None
        finally:
            rec = _FAMILY_PROFILE.setdefault(
                type(estimator).__name__,
                {"seconds": 0.0, "compile": 0.0, "calls": 0})
            rec["seconds"] += time.perf_counter() - t0
            rec["compile"] += _build.build_seconds() - b0
            rec["calls"] += 1

    def _results_from_matrix(self, estimator, grid, mm
                             ) -> List[ValidationResult]:
        return [
            ValidationResult(
                model_name=type(estimator).__name__,
                model_uid=estimator.uid, grid_index=gi,
                params=dict(params),
                metric_values=[float(v) for v in mm[:, gi]])
            for gi, params in enumerate(grid)]

    def _batched_fits(self, estimator, grid, X, y, masks):
        """The family's (F, G) models from ``fit_fold_grid_arrays``, or
        None when it has none, its grid is not batchable
        (NotImplementedError) or the data breaks its preconditions
        (FamilyPreconditionError: the per-candidate fits then score it
        NaN fold by fold)."""
        if not self._use_batched_kernel(estimator):
            return None
        try:
            return estimator.fit_fold_grid_arrays(X, y, masks, grid)
        except NotImplementedError:
            return None
        except FamilyPreconditionError as e:
            _log.warning("batched fit of %s rejected the data: %s",
                         type(estimator).__name__, e)
            return None

    def _family_host_results(self, estimator, grid, X, y, masks, fold_data
                             ) -> List[ValidationResult]:
        """One family validated with the evaluator on the host: the
        batched fold x grid fit (``fit_fold_grid_arrays`` on the whole
        matrix ``X`` under the fold ``masks``; ``masks`` None fits each
        fold of ``fold_data`` alone, one mask over its rows), the tree
        models of a fold scored in one batch, the others by their own
        ``predict_arrays``; without a batched fit, each grid point's
        ``fit_arrays`` on a fold's train rows. A candidate whose fit or
        prediction rejects the data scores NaN on that fold."""
        t0, b0 = time.perf_counter(), _build.build_seconds()
        try:
            if masks is not None:
                fitted = self._batched_fits(estimator, grid, X, y, masks)
            else:
                fitted = []
                for X_tr, y_tr, _, _ in fold_data:
                    fold = self._batched_fits(estimator, grid, X_tr, y_tr,
                                              np.ones((1, len(y_tr))))
                    if fold is None:
                        fitted = None
                        break
                    fitted.append(fold[0])
            fold_raw = ([_batched_fold_raw(fitted[f], fold_data[f][2])
                         for f in range(len(fold_data))]
                        if fitted is not None else None)
            return [self._candidate_result(estimator, gi, params, fold_data,
                                           fitted, fold_raw)
                    for gi, params in enumerate(grid)]
        finally:
            rec = _FAMILY_PROFILE.setdefault(
                type(estimator).__name__,
                {"seconds": 0.0, "compile": 0.0, "calls": 0})
            rec["seconds"] += time.perf_counter() - t0
            rec["compile"] += _build.build_seconds() - b0
            rec["calls"] += 1

    def _candidate_result(self, estimator, gi: int, params, fold_data,
                          fitted, fold_raw) -> ValidationResult:
        """Grid point ``gi``'s metric on every fold: its batched model
        (scored from ``fold_raw`` where the batch has it) or, without
        ``fitted``, a fit on the fold's train rows."""
        candidate = (None if fitted is not None
                     else estimator.with_params(**params))
        res = ValidationResult(
            model_name=type(estimator).__name__,
            model_uid=estimator.uid, grid_index=gi, params=dict(params))
        for f, (X_tr, y_tr, X_val, y_val) in enumerate(fold_data):
            try:
                if fitted is not None:
                    model = fitted[f][gi]
                    raw = fold_raw[f].get(gi)
                    pred = (model.prediction_from_raw(raw)
                            if raw is not None
                            else model.predict_arrays(X_val))
                else:
                    pred = candidate.fit_arrays_guarded(
                        X_tr, y_tr).predict_arrays(X_val)
                metrics = self.evaluator.evaluate_arrays(y_val, pred)
                res.metric_values.append(self.evaluator.metric_from(metrics))
            except (ValueError, FloatingPointError) as e:
                _log.warning("candidate %s%s failed on a fold: %s",
                             res.model_name, params, e)
                res.metric_values.append(float("nan"))
        return res

    def _device_matrices(self, models, X, y, masks, X_val_st, y_val_st,
                         spec, ctx: RuntimeContext):
        """Per-family (F, G) device metric matrices behind the runtime
        (None entries take the host path; ``_QUARANTINED`` ones are out
        of the search)."""
        tasks = [
            (type(est).__name__, self._family_key(fi, est),
             tuple(range(len(grid))),
             (lambda e=est, g=grid: self._try_device_eval(
                 e, g, X, y, masks, X_val_st, y_val_st, spec)))
            for fi, (est, grid) in enumerate(models)]
        return self._dispatch_device_evals(
            tasks, int(masks.shape[0]), ctx,
            device=X.device if isinstance(X, torch.Tensor) else None)

    def validate(self, models: Sequence[Tuple[Predictor, Sequence[Dict]]],
                 X, y: np.ndarray) -> BestEstimator:
        models = [(est, list(grid) or [{}]) for est, grid in models]
        ctx = self._begin_runtime(models, X, y)
        try:
            masks, spec, X_val_st, y_val_st = self._build_fold_arrays(X, y)
            results: List[ValidationResult] = []
            device_mm = self._device_matrices(models, X, y, masks, X_val_st,
                                              y_val_st, spec, ctx)
            fold_data = None
            for fi, ((estimator, grid), mm) in enumerate(
                    zip(models, device_mm)):
                if mm is _QUARANTINED:
                    continue
                if mm is not None:
                    results.extend(self._results_from_matrix(estimator,
                                                             grid, mm))
                    continue
                if fold_data is None:
                    fold_data = self._fold_data(X, y)
                results.extend(self._host_results_journaled(
                    fi, estimator, grid, X, y, masks, fold_data, ctx))
        finally:
            ctx.close_journal()
        return self._pick_best(models, results, ctx=ctx)

    def validate_prepared(self,
                          models: Sequence[Tuple[Predictor, Sequence[Dict]]],
                          folds: Sequence[Tuple]) -> BestEstimator:
        """Validate over pre-materialized per-fold data, the
        workflow-level-CV entry point (reference OpValidator.applyDAG:228
        + getSummary): each fold's in-CV DAG segment was refit on that
        fold's train rows, so the feature matrices may differ across
        folds, even in width. ``folds`` is [(X_tr, y_tr, X_val, y_val),
        ...], each matrix numpy or a tensor on its device; each fold is
        one device search per family. A family whose evaluation raises a
        classified transient or family error is quarantined, as on the
        array path; nothing is journaled here (the fold matrices differ
        by refit segment, so no fingerprint keys a resume)."""
        spec = self.evaluator.device_metric_spec()
        models = [(est, list(grid) or [{}]) for est, grid in models]
        ctx = self._begin_runtime(models, None, None)
        results: List[ValidationResult] = []
        for estimator, grid in models:
            fam = _guarded(ctx, type(estimator).__name__,
                           lambda: self._prepared_family_results(
                               estimator, grid, folds, spec))
            if fam is not _QUARANTINED:
                results.extend(fam)
        return self._pick_best(models, results, ctx=ctx)

    def _prepared_family_results(self, estimator, grid, folds, spec
                                 ) -> List[ValidationResult]:
        """One family's results over pre-materialized folds: the device
        search one fold at a time (fold matrices may differ in shape, so
        they cannot stack into one call), else the host path with one
        single-mask batched fit a fold."""
        if spec is not None:
            rows = []
            for X_tr, y_tr, X_val, y_val in folds:
                row = self._try_device_eval(
                    estimator, grid, X_tr, y_tr, np.ones((1, len(y_tr))),
                    X_val[None], np.asarray(y_val)[None], spec)
                if row is None:
                    break
                rows.append(row[0])
            else:
                if rows:
                    return self._results_from_matrix(estimator, grid,
                                                     np.stack(rows))
        return self._family_host_results(estimator, grid, None, None, None,
                                         folds)

    def _pick_best(self, models, results: List[ValidationResult],
                   rank_pool: Optional[List[ValidationResult]] = None,
                   ctx: Optional[RuntimeContext] = None) -> BestEstimator:
        """Winner by mean metric among ``rank_pool`` (default: all
        results); the first candidate wins a tie. Racing passes only its
        full-fidelity finalists (a pruned candidate's low-fidelity mean is
        not comparable to a full-CV one), while every record still lands
        in ``BestEstimator.results``. With nothing finite left after
        quarantines, one AllFamiliesFailedError names every family."""
        sign = 1.0 if self.evaluator.is_larger_better else -1.0
        pool = results if rank_pool is None else rank_pool
        finite = [r for r in pool if np.isfinite(r.mean_metric)]
        if not finite:
            if ctx is not None and ctx.quarantined:
                raise AllFamiliesFailedError(
                    ctx.quarantined,
                    detail="no family produced a finite validation "
                           "metric")
            raise ValueError(
                "all validation metrics are non-finite; cannot select a "
                "model (check for degenerate folds — e.g. a fold with a "
                "single class; stratify=True may help)")
        best = max(finite, key=lambda r: sign * r.mean_metric)
        by_uid = {est.uid: est for est, _ in models}
        winner = by_uid[best.model_uid].with_params(**best.params)
        return BestEstimator(estimator=winner, name=best.model_name,
                             params=best.params, metric=best.mean_metric,
                             results=results)


class CrossValidation(_ValidatorBase):
    """k-fold CV with equal-sized folds (reference
    OpCrossValidation.scala:40,71)."""

    validation_type = "CrossValidation"

    def __init__(self, evaluator: Evaluator, num_folds: int = 3,
                 seed: int = 42, stratify: bool = False):
        super().__init__(evaluator, seed, stratify)
        if num_folds < 2:
            raise ValueError("num_folds must be >= 2")
        self.num_folds = num_folds

    def get_params(self) -> Dict:
        return {"numFolds": self.num_folds, "seed": self.seed,
                "stratify": self.stratify}

    def _splits(self, y: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
        assign = self._assignments(y, self.num_folds)
        return [(np.nonzero((assign != f) & (assign >= 0))[0],
                 np.nonzero(assign == f)[0])
                for f in range(self.num_folds)]


class TrainValidationSplit(_ValidatorBase):
    """Single random split (reference OpTrainValidationSplit.scala:48);
    the JAX package's split to the index."""

    validation_type = "TrainValidationSplit"

    def __init__(self, evaluator: Evaluator, train_ratio: float = 0.75,
                 seed: int = 42, stratify: bool = False):
        super().__init__(evaluator, seed, stratify)
        if not 0.0 < train_ratio < 1.0:
            raise ValueError("train_ratio must be in (0, 1)")
        self.train_ratio = train_ratio

    def _splits(self, y: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
        # exact single split honoring train_ratio (stratified on request)
        rng = np.random.default_rng(self.seed)
        if self.stratify:
            train_idx, val_idx = stratified_split(
                y, 1.0 - self.train_ratio, rng)
        else:
            perm = rng.permutation(len(y))
            n_val = int(round(len(y) * (1.0 - self.train_ratio)))
            train_idx, val_idx = np.sort(perm[n_val:]), np.sort(perm[:n_val])
        if len(val_idx) == 0 or len(train_idx) == 0:
            raise ValueError(
                f"train_ratio={self.train_ratio} leaves an empty train or "
                f"validation set for n={len(y)} rows")
        return [(train_idx, val_idx)]

    def get_params(self) -> Dict:
        return {"trainRatio": self.train_ratio, "seed": self.seed,
                "stratify": self.stratify}
