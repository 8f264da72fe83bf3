"""Observability of the PyTorch port (counterpart of
``transmogrifai_tpu/observability/``): the span tracer (``trace``) and
the serving loop's live metrics (``metrics``). The JAX package's profile
store (``store.py``) is not ported."""
from . import trace
from .metrics import METRICS_SCHEMA_VERSION, LatencyHistogram, ServeMetrics

__all__ = ["trace", "LatencyHistogram", "ServeMetrics",
           "METRICS_SCHEMA_VERSION"]
