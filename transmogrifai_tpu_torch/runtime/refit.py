"""Warm-start refit: retrain a fitted model in the background.

The port's copy of ``transmogrifai_tpu/runtime/refit.py``. The serving
lifecycle (``serving/lifecycle.py``) turns a fitted model and a window of
recent live traffic back into a fresh ``Workflow.train()``, off the event
loop, bounded by a wall-clock budget, under the retry policy of the
search, and journal-resumed through ``resume_from`` when the workflow
carries a ``ModelSelector``:

- :func:`rebuild_training_workflow` reconstructs a trainable workflow on
  the fitted model's device: every fitted ``Model`` stage is swapped back
  for a fresh instance of the estimator class that produced it
  (``parent_estimator_class``), matched by uid through
  ``Feature.copy_with_new_stages``. Hyperparameters that survive on the
  fitted model's captured constructor arguments (its ``device``
  included) carry over; the rest take the estimator's defaults. When
  that is impossible the error says so (:class:`RefitUnavailableError`).
- :func:`run_refit` merges the base training records with the labeled
  slice of the live window, trains under a :class:`~.retry.RetryPolicy`
  (transient failures retry, everything else propagates to the caller's
  quarantine layer) and enforces the budget by abandoning the training
  thread at the deadline.

Drills: ``TX_FAULT_PLAN="lifecycle:<model>:retrain:..."`` probes the top
of every training attempt (``runtime/faults.py``).
"""
from __future__ import annotations

import concurrent.futures as _cf
import inspect
import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from .faults import maybe_inject
from .retry import RetryPolicy

_log = logging.getLogger(__name__)

__all__ = ["RefitSpec", "RefitResult", "RefitUnavailableError",
           "RefitBudgetExceeded", "rebuild_training_workflow",
           "labeled_rows", "run_refit"]


class RefitUnavailableError(RuntimeError):
    """The model cannot be retrained from what we have — no trainable
    workflow can be reconstructed, or there are no labeled rows."""


class RefitBudgetExceeded(RuntimeError):
    """The retrain overran its wall-clock budget; the training thread
    was abandoned and the candidate discarded (old model keeps
    serving)."""


@dataclass
class RefitSpec:
    """How to retrain one registered model.

    ``workflow_factory`` returns a FRESH unfitted workflow (the exact
    estimators + hyperparameters — the high-fidelity path, used by
    ``ServingServer.register_refit``). Without one, the workflow is
    reconstructed generically from the fitted model. ``base_records``
    are merged with the labeled live window so a small drift ring does
    not starve the fit; ``checkpoint_dir`` points the search journal at
    a directory so a repeated/crashed refit warm-starts; ``save_dir``
    persists the accepted candidate atomically (workflow/persistence)."""
    workflow_factory: Optional[Callable[[], Any]] = None
    base_records: Optional[List[dict]] = None
    checkpoint_dir: Optional[str] = None
    save_dir: Optional[str] = None
    validate: str = "off"


@dataclass
class RefitResult:
    model: Any
    #: wall-clock train seconds (inside the budget)
    seconds: float
    #: rows the candidate was trained on (base + labeled live window)
    rows: int
    #: True when the train actually passed ``resume_from`` (a
    #: ModelSelector was present to replay the journal)
    resumed: bool
    journal_dir: Optional[str] = None


def rebuild_training_workflow(model) -> Any:
    """A trainable ``Workflow`` reconstructed from a fitted model, on the
    model's device: fitted stages swap back to fresh estimators by uid.
    Raises
    :class:`RefitUnavailableError` when any fitted stage's estimator
    class cannot be resolved or constructed."""
    from ..serving.plan import _model_device
    from ..stages.base import stage_class_by_name
    from ..workflow.workflow import Workflow
    stage_map: Dict[str, Any] = {}
    for s in model.stages():
        parent = getattr(s, "parent_estimator_class", None)
        if not parent:
            continue
        try:
            cls = stage_class_by_name(parent)
        except KeyError as e:
            raise RefitUnavailableError(
                f"fitted stage {s!r} came from unknown estimator class "
                f"{parent!r}; supply RefitSpec.workflow_factory") from e
        params = dict(getattr(s, "get_params", dict)() or {})
        try:
            sig = inspect.signature(cls.__init__)
        except (TypeError, ValueError):  # pragma: no cover
            sig = None
        kwargs = {}
        if sig is not None:
            has_var_kw = any(
                p.kind == inspect.Parameter.VAR_KEYWORD
                for p in sig.parameters.values())
            kwargs = {k: v for k, v in params.items()
                      if k != "uid" and (has_var_kw
                                         or k in sig.parameters)}
            if "uid" in sig.parameters:
                kwargs["uid"] = s.uid
        try:
            est = cls(**kwargs)
        except TypeError as e:
            raise RefitUnavailableError(
                f"estimator {parent}({', '.join(sorted(kwargs))}) could "
                f"not be reconstructed for stage {s.uid}: {e}; supply "
                f"RefitSpec.workflow_factory") from e
        est.uid = s.uid
        stage_map[s.uid] = est
    if not stage_map:
        raise RefitUnavailableError(
            "model has no fitted estimator stages — nothing to refit")
    result = tuple(f.copy_with_new_stages(stage_map)
                   for f in model.result_features)
    return Workflow(device=_model_device(model, None)) \
        .set_result_features(*result)


def labeled_rows(model, records: Sequence[dict]) -> List[dict]:
    """The slice of ``records`` that carries every response feature
    (a retrain can only learn from labeled traffic)."""
    responses = [f.name for f in model.raw_features() if f.is_response]
    if not responses:
        return [dict(r) for r in records]
    return [dict(r) for r in records
            if isinstance(r, dict)
            and all(r.get(name) is not None for name in responses)]


def run_refit(model, live_records: Sequence[dict],
              spec: Optional[RefitSpec] = None,
              budget_seconds: Optional[float] = None,
              name: str = "model",
              retry: Optional[RetryPolicy] = None,
              generation: int = 0) -> RefitResult:
    """Train a candidate replacement for ``model``. Blocking: run it on
    the lifecycle worker, never on the event loop. Raises on failure
    (retries exhausted, budget exceeded, reconstruction impossible); the
    caller decides what failure means (the lifecycle quarantines the lane
    and keeps serving the old model)."""
    spec = spec or RefitSpec()
    retry = retry or RetryPolicy.from_env()
    t0 = time.monotonic()
    records = [dict(r) for r in (spec.base_records or [])]
    records += labeled_rows(model, live_records)
    if not records:
        raise RefitUnavailableError(
            f"refit of {name!r} has no labeled rows (live window of "
            f"{len(live_records)} rows carries no responses and no "
            f"base_records were registered)")
    resumed = {"v": False}

    def train_once():
        # the deterministic drill site: lifecycle:<model>:retrain
        maybe_inject("lifecycle", name, "retrain")
        if spec.workflow_factory is not None:
            wf = spec.workflow_factory()
        else:
            wf = rebuild_training_workflow(model)
        wf.set_input_records([dict(r) for r in records])
        resume = None
        if spec.checkpoint_dir:
            from ..selector.selector import ModelSelector
            if any(isinstance(s, ModelSelector) for s in wf.stages()):
                resume = spec.checkpoint_dir
        resumed["v"] = resume is not None
        return wf.train(validate=spec.validate, resume_from=resume)

    def attempt():
        return retry.call(train_once, description=f"refit:{name}")

    if budget_seconds is None:
        candidate = attempt()
    else:
        # the training thread is abandoned at the deadline (it may be
        # deep inside a fit) and the candidate discarded
        pool = _cf.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tx-refit")
        fut = pool.submit(attempt)
        try:
            candidate = fut.result(timeout=budget_seconds)
        except _cf.TimeoutError:
            raise RefitBudgetExceeded(
                f"refit of {name!r} exceeded its "
                f"{budget_seconds}s wall-clock budget; training thread "
                f"abandoned, old model keeps serving") from None
        finally:
            pool.shutdown(wait=False)
    candidate.trained_generation = generation
    if spec.save_dir:
        from ..workflow.persistence import save_model
        save_model(candidate, spec.save_dir)
    return RefitResult(model=candidate,
                       seconds=time.monotonic() - t0,
                       rows=len(records), resumed=resumed["v"],
                       journal_dir=spec.checkpoint_dir)
