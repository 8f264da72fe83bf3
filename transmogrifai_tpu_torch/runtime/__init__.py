"""Runtime layer of the PyTorch port (counterpart of
``transmogrifai_tpu/runtime/``): process telemetry (``telemetry``), the
error classifier (``errors``) and the retry policy (``retry``) that the
scoring plan's dispatch uses. The journal, the fault injector
(``faults.py``), refits and the runtime context are not ported."""
from . import telemetry
from .errors import BUG, FAMILY, TRANSIENT, classify_error
from .retry import RetryPolicy

__all__ = ["telemetry", "classify_error", "RetryPolicy", "TRANSIENT",
           "FAMILY", "BUG"]
