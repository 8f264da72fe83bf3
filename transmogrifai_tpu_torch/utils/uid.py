"""Unique-ID generation for stages and features.

The port's own copy of ``transmogrifai_tpu/utils/uid.py``: the
reference's class-prefixed 12-hex UIDs
(reference: utils/src/main/scala/com/salesforce/op/utils/spark/UID.scala:42).
Deterministic per-process counter mode is supported for reproducible tests
(the reference resets UIDs via ``UID.reset()``).
"""
from __future__ import annotations

import secrets
import threading

_lock = threading.Lock()
_counters: dict[str, int] = {}
_deterministic = False


def uid(prefix: str | type) -> str:
    """Generate a UID of form ``<ClassName>_<12 hex>``."""
    name = prefix if isinstance(prefix, str) else prefix.__name__
    global _deterministic
    with _lock:
        if _deterministic:
            c = _counters.get(name, 0)
            _counters[name] = c + 1
            return f"{name}_{c:012x}"
        return f"{name}_{secrets.token_hex(6)}"


def reset(deterministic: bool = True) -> None:
    """Reset counters; if ``deterministic``, subsequent UIDs are sequential."""
    global _deterministic
    with _lock:
        _counters.clear()
        _deterministic = deterministic


def from_string(s: str) -> tuple[str, str]:
    """Split ``Prefix_hex`` into (prefix, id). Raises ValueError if malformed."""
    if "_" not in s:
        raise ValueError(f"Invalid UID: {s!r}")
    prefix, _, rest = s.rpartition("_")
    if not prefix or not rest:
        raise ValueError(f"Invalid UID: {s!r}")
    return prefix, rest
