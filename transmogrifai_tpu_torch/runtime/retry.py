"""RetryPolicy: exponential backoff with deterministic jitter for
transient backend failures.

The port's copy of ``transmogrifai_tpu/runtime/retry.py``. A search
wraps each family's dispatch in it, and the scoring and prepare plans
each device dispatch: an error the classifier
(``runtime/errors.py``) marks transient (a CUDA out-of-memory, a launch
timeout) retries with exponentially growing, jittered delays; anything
else propagates at once. The jitter is derived from (seed, description,
attempt), never from a clock or OS entropy.
"""
from __future__ import annotations

import logging
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Optional

from . import telemetry
from .errors import TRANSIENT, classify_error

_log = logging.getLogger(__name__)

__all__ = ["RetryPolicy"]


@dataclass(frozen=True)
class RetryPolicy:
    """``call(fn)`` runs ``fn`` up to ``max_attempts`` times, sleeping
    ``base_delay * multiplier**attempt`` (capped at ``max_delay``,
    +/- ``jitter`` fraction) between attempts. Only errors the
    classifier marks ``"transient"`` are retried; everything else
    propagates to the caller (which quarantines or crashes as its
    contract demands)."""

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25
    seed: int = 0

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        """Policy from the ``TX_RETRY_*`` environment knobs:
        ``TX_RETRY_MAX_ATTEMPTS``, ``TX_RETRY_BASE_DELAY_S``,
        ``TX_RETRY_MAX_DELAY_S``."""
        import os
        return cls(
            max_attempts=int(os.environ.get("TX_RETRY_MAX_ATTEMPTS", "3")),
            base_delay=float(os.environ.get("TX_RETRY_BASE_DELAY_S",
                                            "0.05")),
            max_delay=float(os.environ.get("TX_RETRY_MAX_DELAY_S", "2.0")))

    def delay_for(self, attempt: int, description: str = "") -> float:
        """Backoff delay before retry ``attempt`` (0-based), with the
        deterministic jitter derived from (seed, description,
        attempt)."""
        d = min(self.max_delay,
                self.base_delay * (self.multiplier ** attempt))
        if self.jitter:
            h = zlib.crc32(f"{self.seed}:{description}:{attempt}"
                           .encode()) / 0xFFFFFFFF
            d *= 1.0 + self.jitter * (2.0 * h - 1.0)
        return max(0.0, d)

    def call(self, fn: Callable, description: str = "",
             classify: Callable = classify_error,
             on_retry: Optional[Callable] = None):
        """Run ``fn()`` under the policy. ``on_retry(attempt, exc)`` runs
        before each backoff sleep. The last transient error is re-raised
        once attempts are exhausted, for the caller's quarantine layer to
        record."""
        attempts = max(1, int(self.max_attempts))
        for attempt in range(attempts):
            try:
                return fn()
            except Exception as e:
                if classify(e) != TRANSIENT or attempt == attempts - 1:
                    raise
                telemetry.count("retries")
                telemetry.event("retry", target=description or "call",
                                attempt=attempt + 1,
                                error=f"{type(e).__name__}: {e}")
                if on_retry is not None:
                    on_retry(attempt, e)
                time.sleep(self.delay_for(attempt, description))
        raise AssertionError("unreachable")  # pragma: no cover
