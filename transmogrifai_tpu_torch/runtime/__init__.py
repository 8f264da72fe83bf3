"""Fault-tolerant runtime of the PyTorch port (counterpart of
``transmogrifai_tpu/runtime/``), threaded through the selector, the
workflow and serving:

- **journal**: an append-only, fsync'd, fingerprint-keyed JSONL of
  completed family evaluations; ``ModelSelector(checkpoint_dir=...)``
  writes it and ``Workflow.train(resume_from=...)`` replays it to the
  identical winner without dispatching the journaled work again;
- **errors and retry**: the classifier of PyTorch's errors (transient,
  family, bug) and an exponential-backoff ``RetryPolicy`` with
  deterministic jitter around each family's dispatch and each compiled
  program's;
- **context**: one search's ``RuntimeContext`` with its quarantine
  ledger: a family that keeps failing is removed with its reason and the
  search goes on with the survivors, raising one
  :class:`AllFamiliesFailedError` only when none is left;
- **faults**: the deterministic fault injector
  (``TX_FAULT_PLAN="family:GBTClassifier:dispatch:2=oom"``) that drives
  every recovery path;
- **refit**: the warm-start retrain the serving lifecycle runs;
- **telemetry**: the counters, dispatch log and event stream the tests
  and the smoke read.
"""
from . import telemetry
from .context import RuntimeContext
from .errors import (BUG, FAMILY, TRANSIENT, AllFamiliesFailedError,
                     QuarantineRecord, classify_error)
from .faults import (FaultInjector, InjectedFault, KillPoint,
                     maybe_inject)
from .journal import SearchJournal, read_journal, search_fingerprint
from .retry import RetryPolicy

__all__ = [
    "RuntimeContext", "RetryPolicy",
    "AllFamiliesFailedError", "QuarantineRecord", "classify_error",
    "FaultInjector", "InjectedFault", "KillPoint", "maybe_inject",
    "SearchJournal", "read_journal", "search_fingerprint",
    "telemetry", "TRANSIENT", "FAMILY", "BUG",
]
