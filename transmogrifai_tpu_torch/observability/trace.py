"""Structured span tracing over the scoring plan and the serving loop.

The port's copy of ``transmogrifai_tpu/observability/trace.py``:

- **Spans.** A span is one timed operation (``score.encode``,
  ``score.dispatch``, ``score.guarded``, ``serve.request``) with a
  parent, a trace id and attributes. Parentage is a context-var stack
  per thread, so nested ``with span(...)`` blocks build the tree;
  context vars do not cross executor threads, so the serving loop
  rebuilds each request's tree from its marks (``add_span``) with an
  explicit ``(trace id, span id)`` parent.
- **Off by default, near-zero when off.** ``enabled()`` is one bool
  read; ``span()`` returns one shared no-op context manager and
  allocates nothing when tracing is disabled. Enable with ``TX_TRACE=1``
  (in-memory ring) or ``TX_TRACE=/path/trace.jsonl`` (also streamed to
  a schema-versioned JSONL file by a writer thread, so serializing never
  runs on the serving event loop).
- **Monotonic clocks.** Span times are ``time.monotonic()``; the file
  header records an (epoch, monotonic) anchor pair for exporters.
- **Integration points.** ``utils/compile_time`` sections report into
  the current span as child spans with their compile (graph capture) and
  execute split; ``runtime/telemetry.event`` events attach to the
  current span.

In-memory spans live in a bounded ring (``TX_TRACE_BUFFER``, default
20000). The JAX package's readers of a trace file (``read_trace``,
``span_tree``, ``coverage``, ``to_perfetto``, ``cli/trace.py``) are not
ported with it.
"""
from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["SCHEMA_VERSION", "configure", "configure_from_env",
           "enabled", "trace_path", "span", "add_span", "add_event",
           "current_ref", "new_request_id", "spans", "reset", "flush"]

#: bump when the JSONL span record shape changes; the header line and
#: every span record carry it so readers can refuse foreign files
SCHEMA_VERSION = 1

_LOCK = threading.Lock()
_ENABLED = False
_PATH: Optional[str] = None
_FILE = None
_SPAN_IDS = itertools.count(1)
_REQ_IDS = itertools.count(1)
#: (epoch seconds, monotonic seconds) captured together: exporters map
#: monotonic span times onto the wall clock via this anchor
_ANCHOR = (time.time(), time.monotonic())

def _buffer_cap() -> int:
    try:
        return max(16, int(os.environ.get("TX_TRACE_BUFFER", "20000")))
    except ValueError:
        return 20000


_SPANS: "deque[dict]" = deque(maxlen=_buffer_cap())

#: per-thread/task stack of OPEN span records (contextvars: coroutines
#: on one loop each see their own stack; worker threads start empty)
_STACK: contextvars.ContextVar = contextvars.ContextVar(
    "tx_trace_stack", default=())


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def configure(enabled: bool, path: Optional[str] = None) -> None:
    """Turn tracing on/off at runtime. ``path`` additionally streams
    every finished span to a JSONL file (header line first). Also
    (un)registers the compile-time section observer so section
    wall/compile splits land as child spans of whatever span is open."""
    global _ENABLED, _PATH, _FILE, _SPANS
    if _PATH is not None and (not enabled or path != _PATH):
        _drain_pending()            # pending spans land before close
    with _LOCK:
        if _FILE is not None and (not enabled or path != _PATH):
            try:
                _FILE.close()
            except OSError:  # pragma: no cover - best effort
                pass
            _FILE = None
        _ENABLED = bool(enabled)
        _PATH = path if enabled else None
        if enabled and _SPANS.maxlen != _buffer_cap():
            _SPANS = deque(_SPANS, maxlen=_buffer_cap())
    from ..utils import compile_time
    compile_time.set_section_observer(_note_section if enabled else None)


def configure_from_env() -> bool:
    """Read ``TX_TRACE``: unset/``0``/empty disables, ``1`` enables the
    in-memory ring, anything else is a JSONL output path. Returns the
    resulting enabled state."""
    raw = os.environ.get("TX_TRACE", "").strip()
    if raw in ("", "0", "off", "false"):
        configure(False)
    elif raw in ("1", "on", "true"):
        configure(True)
    else:
        configure(True, path=raw)
    return _ENABLED


def enabled() -> bool:
    """One bool read — the hot-path predicate."""
    return _ENABLED


def trace_path() -> Optional[str]:
    return _PATH


def new_request_id() -> str:
    """Process-unique request id, generated at serving admission and
    propagated enqueue -> coalesce -> encode -> dispatch -> reply
    (serving/server.py)."""
    return f"req-{os.getpid():x}-{next(_REQ_IDS):x}"


# ---------------------------------------------------------------------------
# span emission
# ---------------------------------------------------------------------------

class _NoopSpan:
    """The shared disabled-path context manager: no allocation, no
    record, identity across calls (asserted in tests)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("rec", "_token")

    def __init__(self, rec: dict):
        self.rec = rec
        self._token = None

    def __enter__(self):
        stack = _STACK.get()
        rec = self.rec
        if rec["parent"] is None and stack:
            top = stack[-1]
            rec["parent"] = top["sid"]
            rec["trace"] = rec["trace"] or top["trace"]
        if rec["trace"] is None:
            rec["trace"] = f"t{rec['sid']}"
        self._token = _STACK.set(stack + (rec,))
        rec["t0"] = time.monotonic()
        return rec

    def __exit__(self, exc_type, exc, tb):
        rec = self.rec
        rec["dur"] = time.monotonic() - rec["t0"]
        if exc_type is not None:
            rec["attrs"]["status"] = "error"
            rec["attrs"]["error"] = f"{exc_type.__name__}: {exc}"
        if self._token is not None:
            _STACK.reset(self._token)
        _emit(rec)
        return False


def _new_rec(name: str, parent: Optional[int], trace_id: Optional[str],
             attrs: Dict[str, Any]) -> dict:
    return {"v": SCHEMA_VERSION, "sid": next(_SPAN_IDS), "parent": parent,
            "trace": trace_id, "name": name, "t0": 0.0, "dur": None,
            "attrs": attrs, "events": []}


def span(name: str, parent: Optional[Tuple[str, int]] = None,
         trace_id: Optional[str] = None, **attrs):
    """Context manager for one timed operation. With no explicit
    ``parent`` (a ``(trace id, span id)`` pair), the innermost open span
    on this thread/task is the parent."""
    if not _ENABLED:
        return _NOOP
    pid = None
    if parent is not None:
        trace_id = trace_id or parent[0]
        pid = parent[1]
    return _Span(_new_rec(name, pid, trace_id, attrs))


def add_span(name: str, start: float, end: float,
             parent: Optional[Tuple[str, int]] = None,
             trace_id: Optional[str] = None,
             attrs: Optional[dict] = None,
             events: Optional[List[dict]] = None) -> Optional[int]:
    """Retrospective span emission over an already-measured monotonic
    window — the serving loop reconstructs each request's
    wait/encode/dispatch/guard segments this way at resolve time
    instead of holding context managers open across async hops.
    Returns the span id (None when tracing is off)."""
    if not _ENABLED:
        return None
    pid = parent[1] if parent is not None else None
    if parent is not None and trace_id is None:
        trace_id = parent[0]
    rec = _new_rec(name, pid, trace_id, dict(attrs or {}))
    if rec["trace"] is None:
        rec["trace"] = f"t{rec['sid']}"
    rec["t0"] = float(start)
    rec["dur"] = max(float(end) - float(start), 0.0)
    if events:
        rec["events"] = list(events)
    _emit(rec)
    return rec["sid"]


def current_ref() -> Optional[Tuple[str, int]]:
    """(trace_id, span_id) of the innermost open span on this thread or
    task, or None: capture it before handing work to another thread and
    pass it there as ``span(parent=...)``."""
    if not _ENABLED:
        return None
    stack = _STACK.get()
    if not stack:
        return None
    top = stack[-1]
    return (top["trace"], top["sid"])


def add_event(name: str, **fields) -> None:
    """Attach one timestamped event to the CURRENT open span (no-op
    when tracing is off or no span is open) — how runtime/telemetry
    fault/retry/quarantine events land inside the span that was doing
    the work when they fired."""
    if not _ENABLED:
        return
    stack = _STACK.get()
    if not stack:
        return
    stack[-1]["events"].append(
        {"name": name, "t": time.monotonic(), **fields})


def _note_section(label: str, wall: float, compile_s: float) -> None:
    """utils/compile_time section observer: a closed section becomes a
    child span of the current span, carrying the compile (graph
    capture) and execute split. Sections outside any span are dropped:
    a section is attribution detail, not a root operation."""
    if not _ENABLED:
        return
    stack = _STACK.get()
    if not stack:
        return
    top = stack[-1]
    now = time.monotonic()
    add_span(f"section:{label}", now - wall, now,
             parent=(top["trace"], top["sid"]),
             attrs={"compile_seconds": round(compile_s, 6),
                    "execute_seconds": round(max(wall - compile_s, 0.0),
                                             6)})


#: spans awaiting JSONL serialization: the hot path pays two atomic
#: deque appends; json.dumps and file I/O happen on the writer thread
_PENDING: "deque[dict]" = deque()
_WRITER = {"thread": None}


def _emit(rec: dict) -> None:
    _SPANS.append(rec)          # deque appends are atomic under the GIL
    if _PATH is not None:
        _PENDING.append(rec)
        th = _WRITER["thread"]
        if th is None or not th.is_alive():
            _start_writer()


def _start_writer() -> None:
    with _LOCK:
        th = _WRITER["thread"]
        if th is not None and th.is_alive():
            return
        th = threading.Thread(target=_writer_loop, daemon=True,
                              name="tx-trace-writer")
        _WRITER["thread"] = th
        th.start()


def _writer_loop() -> None:
    while _PATH is not None:
        time.sleep(0.05)
        _drain_pending()


def _open_file():
    """Call with _LOCK held."""
    global _FILE
    if _FILE is None and _PATH is not None:
        fresh = (not os.path.exists(_PATH)
                 or os.path.getsize(_PATH) == 0)
        _FILE = open(_PATH, "a", encoding="utf-8")
        if fresh:
            _FILE.write(json.dumps(
                {"kind": "header", "schema": SCHEMA_VERSION,
                 "anchor_epoch": _ANCHOR[0],
                 "anchor_monotonic": _ANCHOR[1],
                 "pid": os.getpid()}) + "\n")
    return _FILE


def _drain_pending() -> None:
    batch: List[dict] = []
    while True:
        try:
            batch.append(_PENDING.popleft())
        except IndexError:
            break
    if not batch:
        return
    with _LOCK:
        fh = _open_file()
        if fh is None:
            return
        fh.write("".join(
            json.dumps({"kind": "span", **r}, default=str) + "\n"
            for r in batch))


def flush() -> None:
    """Serialize every pending span to the JSONL file and fsync-level
    flush it — call before reading the file back."""
    _drain_pending()
    with _LOCK:
        if _FILE is not None:
            _FILE.flush()


def spans() -> List[dict]:
    """Snapshot of the in-memory span ring (finished spans only)."""
    with _LOCK:
        return [dict(s) for s in _SPANS]


def reset() -> None:
    """Drop buffered spans (test isolation); the JSONL file, the
    id counters and the enabled state are untouched."""
    with _LOCK:
        _SPANS.clear()


# import-time default: a process started with TX_TRACE set traces from
# its first span without an explicit configure call
if os.environ.get("TX_TRACE", "").strip() not in ("", "0", "off",
                                                  "false"):
    configure_from_env()
