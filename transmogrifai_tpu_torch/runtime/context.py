"""RuntimeContext: one search's fault-tolerance state.

The port's copy of ``transmogrifai_tpu/runtime/context.py``. Owned by the
validator for one ``validate()`` call and read back by the
``ModelSelector`` afterwards (the lifecycle keeps one for its refits); it
bundles the retry policy, the optional search journal, the per-family
deadline and the quarantine ledger, so the dispatch layer threads one
object instead of five knobs.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import List, Optional, Sequence

from . import telemetry
from .errors import QuarantineRecord
from .journal import SearchJournal
from .retry import RetryPolicy

_log = logging.getLogger(__name__)

__all__ = ["RuntimeContext"]


class RuntimeContext:
    """Fault-tolerance state for one search.

    - ``retry``: the transient-error RetryPolicy for family dispatch.
    - ``family_deadline``: wall-clock seconds one family's dispatch may
      take before the validator abandons its worker thread (None = no
      deadline; ``TX_FAMILY_DEADLINE_S`` sets a process default).
    - ``journal``: opened when the selector carries a
      ``checkpoint_dir`` — completed family evaluations are appended
      and replayed on resume.
    - ``quarantined``: the ledger of families removed from this
      search, surfaced in ``ModelSelectorSummary.quarantined``.
    - ``nan_quarantine_fraction``: quarantine a family whose device
      metric matrix is at least this fraction non-finite (default 1.0:
      only a fully poisoned family is removed; a partly NaN family keeps
      its finite candidates).
    """

    def __init__(self, retry: Optional[RetryPolicy] = None,
                 family_deadline: Optional[float] = None,
                 nan_quarantine_fraction: float = 1.0):
        self.retry = retry if retry is not None else RetryPolicy.from_env()
        if family_deadline is None:
            env = os.environ.get("TX_FAMILY_DEADLINE_S", "")
            family_deadline = float(env) if env else None
        self.family_deadline = family_deadline
        self.nan_quarantine_fraction = float(nan_quarantine_fraction)
        self.journal: Optional[SearchJournal] = None
        self.quarantined: List[QuarantineRecord] = []
        self._lock = threading.Lock()

    # -- journal -----------------------------------------------------------
    def open_journal(self, checkpoint_dir: str, fingerprint: str,
                     topology: Optional[dict] = None) -> None:
        """``topology`` (the devices of the search) is header metadata
        only (``SearchJournal.open``)."""
        self.journal = SearchJournal(checkpoint_dir).open(
            fingerprint, topology=topology)
        if self.journal.replayed:
            telemetry.event("journal_resume",
                            checkpoint_dir=checkpoint_dir,
                            entries=self.journal.replayed)

    def close_journal(self) -> None:
        if self.journal is not None:
            self.journal.close()

    def journal_lookup(self, family_key: str, rung_label: str,
                       cands: Sequence[int]):
        """Replayed metric vectors, counting the resume savings."""
        if self.journal is None:
            return None
        hit = self.journal.lookup(family_key, rung_label, cands)
        if hit is not None:
            telemetry.count("journal_hits")
            telemetry.count("journal_replayed_entries",
                            len(hit) * (len(hit[0]) if hit else 0))
        return hit

    def journal_record(self, family_key: str, rung_label: str,
                       cands: Sequence[int], metrics, folds: int) -> None:
        if self.journal is None:
            return
        self.journal.record(family_key, rung_label, cands, metrics, folds)

    # -- quarantine --------------------------------------------------------
    def quarantine(self, family: str, reason: str, kind: str,
                   error_type: str = "", rung: Optional[int] = None,
                   retries: int = 0) -> QuarantineRecord:
        rec = QuarantineRecord(family=family, reason=reason, kind=kind,
                               error_type=error_type, rung=rung,
                               retries=retries)
        with self._lock:
            self.quarantined.append(rec)
        telemetry.count("quarantines")
        telemetry.event("quarantine", family=family, kind=kind,
                        reason=reason)
        return rec

    def quarantined_families(self) -> List[str]:
        with self._lock:
            return [r.family for r in self.quarantined]
