"""Per-section wall and compile seconds.

Counterpart of the section half of ``transmogrifai_tpu/utils/
compile_time.py``. There, ``jax.monitoring`` events report XLA's trace and
compile seconds into every open section. The port has no compiler of its
own at serving time: what it pays once per shape is the capture of a CUDA
graph, and the scoring plan reports those seconds here with
:func:`note_compile` while the bucket's section is open. A section is a
labelled span (``with section("score:0:b8"): ...``) on a per-thread stack;
each label records its wall seconds, compile seconds and calls, so a
caller reads ``execute = wall - compile`` per label.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict

__all__ = ["section", "note_compile", "seconds_by_section",
           "set_section_observer"]

_LOCK = threading.Lock()
#: label -> {"seconds": wall, "compile": compile seconds, "calls": n}
_SECTIONS: Dict[str, Dict[str, float]] = {}
_SECTION_STACK = threading.local()
#: optional callback ``(label, wall_seconds, compile_seconds)`` fired as
#: each section closes (the span tracer's hook); None costs nothing
_SECTION_OBSERVER = {"fn": None}


def set_section_observer(fn) -> None:
    """Register (or clear, with None) the section-close observer."""
    _SECTION_OBSERVER["fn"] = fn


def _stack():
    st = getattr(_SECTION_STACK, "stack", None)
    if st is None:
        st = _SECTION_STACK.stack = []
    return st


def _record(label: str) -> Dict[str, float]:
    """The record of ``label`` (call with _LOCK held)."""
    return _SECTIONS.setdefault(
        label, {"seconds": 0.0, "compile": 0.0, "calls": 0})


def note_compile(seconds: float) -> None:
    """Attribute ``seconds`` of one-time compile work (a graph capture,
    its warm-up runs included) to every section open on this thread."""
    labels = list(_stack())
    with _LOCK:
        for label in labels:
            _record(label)["compile"] += seconds


@contextmanager
def section(label: str):
    """Attribute wall seconds, and the compile seconds noted inside, to
    ``label`` (nested sections attribute to every open label)."""
    st = _stack()
    st.append(label)
    observer = _SECTION_OBSERVER["fn"]
    if observer is not None:
        with _LOCK:
            compile_before = _record(label)["compile"]
    t0 = time.perf_counter()
    try:
        yield
    finally:
        st.pop()
        wall = time.perf_counter() - t0
        with _LOCK:
            rec = _record(label)
            rec["seconds"] += wall
            rec["calls"] += 1
            compile_after = rec["compile"]
        if observer is not None:
            observer(label, wall, max(compile_after - compile_before, 0.0))


def seconds_by_section(prefix: str = "") -> Dict[str, Dict[str, float]]:
    """Snapshot of ``{label: {"seconds", "compile", "calls"}}`` for labels
    starting with ``prefix``."""
    with _LOCK:
        return {k: dict(v) for k, v in _SECTIONS.items()
                if k.startswith(prefix)}

