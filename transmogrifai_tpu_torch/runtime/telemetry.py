"""Process-wide telemetry: counters, the search dispatch log and an
event stream.

The port's copy of ``transmogrifai_tpu/runtime/telemetry.py``:
module-level accumulators that the smoke and the tests read to prove
runtime behaviour (zero re-dispatch of journaled work, retries,
quarantines, host-fallback batches, breaker short-circuits, lifecycle
transitions) rather than infer it from timing. ``WorkflowListener``
snapshots the event stream into ``AppMetrics.fault_events``.
"""
from __future__ import annotations

import logging
import os
import threading
from collections import deque
from typing import Dict, List, Tuple

from ..observability import trace as _trace

_log = logging.getLogger(__name__)

__all__ = ["count", "counters", "reset", "note_dispatch", "dispatch_log",
           "event", "events_mark", "events_since", "events_dropped",
           "OVERFLOW_EVENT"]

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {}
#: every real family dispatch of this process: (family key, rung label,
#: candidate indices, folds); journal replays never land here
_DISPATCH_LOG: List[Tuple[str, str, Tuple[int, ...], int]] = []
#: the event stream is a ring (``TX_TELEMETRY_EVENTS_CAP``, default
#: 4096): overflow drops the oldest events, counts them
#: (``telemetry_events_dropped``), and ``events_since`` marks the gap
_EVENTS: "deque[dict]" = deque()
#: absolute stream index of _EVENTS[0], so marks stay valid across
#: overflow
_EVENTS_BASE = 0

#: the record events_since() prepends when its mark fell off the ring
OVERFLOW_EVENT = "telemetry_events_overflow"


def _events_cap() -> int:
    """Env-tunable ring capacity (read per event)."""
    try:
        return max(16, int(os.environ.get("TX_TELEMETRY_EVENTS_CAP",
                                          "4096")))
    except ValueError:
        return 4096


def count(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Snapshot of all counters (``retries``, ``quarantines``,
    ``journal_hits``, ``journal_replayed_entries``,
    ``candidate_fold_dispatches``, ``family_dispatches``, the serving and
    ``lifecycle_*`` counters, ...)."""
    with _LOCK:
        return dict(_COUNTERS)


def note_dispatch(family: str, rung_label: str,
                  cands: Tuple[int, ...], folds: int) -> None:
    """Record one real family dispatch of ``len(cands) x folds``
    candidate-fold evaluations."""
    with _LOCK:
        _DISPATCH_LOG.append((family, rung_label, tuple(cands),
                              int(folds)))
        _COUNTERS["family_dispatches"] = \
            _COUNTERS.get("family_dispatches", 0) + 1
        _COUNTERS["candidate_fold_dispatches"] = \
            _COUNTERS.get("candidate_fold_dispatches", 0) \
            + len(cands) * int(folds)


def dispatch_log() -> List[Tuple[str, str, Tuple[int, ...], int]]:
    with _LOCK:
        return list(_DISPATCH_LOG)


def event(event_name: str, **fields) -> None:
    """Append one event (``retry``, ``quarantine``, ``journal_resume``,
    ``lifecycle``, ``serving_fallback``, ``breaker``, ...) and log it.
    With tracing enabled the event also attaches to the current span."""
    global _EVENTS_BASE
    rec = {"event": event_name, **fields}
    with _LOCK:
        _EVENTS.append(rec)
        cap = _events_cap()
        while len(_EVENTS) > cap:
            _EVENTS.popleft()
            _EVENTS_BASE += 1
            _COUNTERS["telemetry_events_dropped"] = \
                _COUNTERS.get("telemetry_events_dropped", 0) + 1
    if _trace.enabled():
        _trace.add_event(event_name, **fields)
    _log.warning("runtime: %s %s", event_name,
                 " ".join(f"{k}={v}" for k, v in fields.items()))


def events_mark() -> int:
    """Absolute position in the event stream (events emitted so far)."""
    with _LOCK:
        return _EVENTS_BASE + len(_EVENTS)


def events_since(mark: int) -> List[dict]:
    """Events from ``mark`` on. If the ring dropped events past the
    mark, the first record is ``{"event": OVERFLOW_EVENT, "dropped":
    n}``."""
    with _LOCK:
        if mark >= _EVENTS_BASE:
            start = mark - _EVENTS_BASE
            return [dict(e) for e in list(_EVENTS)[start:]]
        out: List[dict] = [{"event": OVERFLOW_EVENT,
                            "dropped": _EVENTS_BASE - mark}]
        out.extend(dict(e) for e in _EVENTS)
        return out


def events_dropped() -> int:
    """Events lost to ring overflow so far in this process."""
    with _LOCK:
        return _COUNTERS.get("telemetry_events_dropped", 0)


def reset() -> None:
    """Zero every accumulator (test isolation)."""
    global _EVENTS_BASE
    with _LOCK:
        _COUNTERS.clear()
        _DISPATCH_LOG.clear()
        _EVENTS.clear()
        _EVENTS_BASE = 0
