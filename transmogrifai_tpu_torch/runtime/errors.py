"""Error taxonomy and classifier of the fault-tolerant runtime.

Counterpart of ``transmogrifai_tpu/runtime/errors.py`` (``classify_error``,
``QuarantineRecord``, ``AllFamiliesFailedError``). Every exception
crossing a family dispatch, a compile or a serving dispatch boundary is
sorted into one of three kinds:

- ``"transient"``: worth retrying with backoff (``runtime/retry.py``);
  a family whose retries run out is quarantined, and the serving guard
  trips its breaker and serves the host columnar path;
- ``"family"``: deterministic failures of one family or program
  (a precondition the data breaks, an injected family fault, a backend
  rejection): retrying is futile, the family is quarantined at once and
  the search goes on with the survivors; the breaker still routes a
  serving batch to the host;
- ``"bug"``: everything else, which must propagate.

The JAX classifier matches ``XlaRuntimeError`` type names and the
gRPC/absl status names the TPU runtime writes into their messages. The
port classifies PyTorch's own errors instead:

===========================================  ==============================
PyTorch error                                kind
===========================================  ==============================
``PlanCompileError`` (a stage's kernel       bug: the device program did
failed the plan's probe run or its CUDA      not build, and the port serves
graph capture), whatever its message says    no stage on the host in its
                                             place
a sticky ``RuntimeError("CUDA error: ...")``  bug: the CUDA context is
("an illegal memory access", "unspecified    corrupt, so every later call
launch failure", "misaligned address", "an   on the card, a host fallback's
illegal instruction", "hardware stack        model stage included, fails
error", "invalid program counter",           alike
"device-side assert", "the launch timed
out", a global/shared address space fault)
``torch.cuda.OutOfMemoryError``              transient (memory may free)
``RuntimeError("CUDA out of memory ...")``   transient
``RuntimeError("CUDA error: out of memory")``   transient
``RuntimeError("CUDA error: ...")`` with     transient
"busy or unavailable", "not ready" or "ECC"
any other ``RuntimeError("CUDA error: ...")``   family (e.g. an invalid
                                             argument or configuration)
``RuntimeError`` of cuBLAS (``CUBLAS_STATUS``), family
cuDNN or NCCL
``ConnectionError``, ``TimeoutError``,       transient
``InterruptedError``, ``BrokenPipeError``
``MemoryError``, ``FloatingPointError``,     family
``FamilyPreconditionError``, an injected
family fault (``runtime/faults.py``)
anything else, a capture error outside a     bug
plan (``operation not permitted when
stream is capturing``) included
===========================================  ==============================

So on the card only a transient or family error reaches the guarded
path's host fallback (``serving/guard.fall_back_to_host``) or a search's
quarantine ledger: a sticky CUDA error leaves the context dead and is
never quarantined.

The JAX package's status-name patterns (``RESOURCE_EXHAUSTED``,
``DEADLINE_EXCEEDED``, ``INVALID_ARGUMENT``, ...) are kept as well, so a
``TimeoutError("DEADLINE_EXCEEDED: ...")`` raised by a serving deadline
classifies alike in both packages.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional

__all__ = ["classify_error", "QuarantineRecord", "AllFamiliesFailedError",
           "TRANSIENT", "FAMILY", "BUG"]

TRANSIENT = "transient"
FAMILY = "family"
BUG = "bug"

#: CUDA errors that leave the context unusable: the card fails every
#: later call of this process alike, so there is nothing to fall back to
_STICKY_RE = re.compile(
    r"CUDA error: [^\n]*(?:illegal memory access|illegal instruction"
    r"|unspecified launch failure|misaligned address|hardware stack error"
    r"|invalid program counter|device-side assert|launch timed out"
    r"|global/shared address space)",
    re.IGNORECASE)

#: resource pressure that may clear, and the JAX package's transient
#: status names
_TRANSIENT_RE = re.compile(
    r"CUDA out of memory|CUDA error: out of memory|busy or unavailable"
    r"|CUDA error: [^\n]*not ready|CUDA error: [^\n]*ECC"
    r"|RESOURCE_EXHAUSTED|DEADLINE_EXCEEDED|UNAVAILABLE|ABORTED"
    r"|preempt(?:ed|ion)?|allocat\w* failure"
    r"|connection (?:reset|refused|closed)|socket closed"
    r"|temporarily unavailable",
    re.IGNORECASE)

#: deterministic backend failures: the card rejected this program or
#: data and will again
_FAMILY_RE = re.compile(
    r"CUDA error:|CUBLAS_STATUS|cuDNN error|NCCL error"
    r"|INTERNAL|INVALID_ARGUMENT|FAILED_PRECONDITION|UNIMPLEMENTED"
    r"|injected family fault",
    re.IGNORECASE)

_TRANSIENT_TYPES = (ConnectionError, TimeoutError, InterruptedError,
                    BrokenPipeError)


def classify_error(exc: BaseException) -> str:
    """``"transient"`` / ``"family"`` / ``"bug"`` for one exception."""
    if any(c.__name__ == "PlanCompileError" for c in type(exc).__mro__):
        return BUG
    if isinstance(exc, _TRANSIENT_TYPES):
        return TRANSIENT
    if type(exc).__name__ == "OutOfMemoryError":
        return TRANSIENT           # torch.cuda.OutOfMemoryError
    msg = f"{type(exc).__name__}: {exc}"
    if _STICKY_RE.search(msg):
        return BUG
    if _TRANSIENT_RE.search(msg):
        return TRANSIENT
    from ..models.base import FamilyPreconditionError
    if isinstance(exc, (MemoryError, FloatingPointError,
                        FamilyPreconditionError)):
        return FAMILY
    if _FAMILY_RE.search(msg):
        return FAMILY
    return BUG


@dataclass
class QuarantineRecord:
    """One family removed from a search, and why: surfaced in
    ``ModelSelectorSummary.quarantined`` and ``model_insights()``, with
    the JAX package's JSON keys."""
    family: str
    reason: str
    #: "transient" | "family" | "deadline" | "metrics"
    kind: str = FAMILY
    error_type: str = ""
    rung: Optional[int] = None
    retries: int = 0

    def to_json(self) -> dict:
        out = {"family": self.family, "reason": self.reason,
               "kind": self.kind, "errorType": self.error_type,
               "retries": self.retries}
        if self.rung is not None:
            out["rung"] = self.rung
        return out

    @classmethod
    def from_json(cls, d: dict) -> "QuarantineRecord":
        return cls(family=d.get("family", ""), reason=d.get("reason", ""),
                   kind=d.get("kind", FAMILY),
                   error_type=d.get("errorType", ""),
                   rung=d.get("rung"), retries=d.get("retries", 0))

    def __str__(self) -> str:
        tag = f" at rung {self.rung}" if self.rung is not None else ""
        return (f"{self.family}{tag}: [{self.kind}] {self.reason}"
                + (f" (after {self.retries} retries)" if self.retries
                   else ""))


class AllFamiliesFailedError(RuntimeError):
    """Every candidate family was quarantined (or produced no finite
    metric): nothing is left to select. Raised once with the whole
    quarantine ledger, so every family's reason is in one traceback."""

    def __init__(self, records: List[QuarantineRecord],
                 detail: str = ""):
        self.records = list(records)
        lines = "\n".join(f"  - {r}" for r in self.records) or "  (none)"
        super().__init__(
            f"all candidate families failed validation"
            + (f" ({detail})" if detail else "")
            + f"; quarantine ledger:\n{lines}")
