"""Compiled serving of the PyTorch port (counterpart of
``transmogrifai_tpu/serving/``): the fitted workflow DAG frozen into
shape-bucketed device programs, one captured CUDA graph per row bucket on
the card (``plan.py``), the serving guardrails (``guard.py``), the online
drift sentinel (``sentinel.py``), the asyncio micro-batching serving
loop that coalesces live requests into those buckets (``server.py``) and
the self-healing lifecycle that retrains a drifted model in the
background and hot-swaps it (``lifecycle.py``).

The JAX package's other serving modules are not ported yet; importing one
of their names from here raises ``NotImplementedError`` naming the JAX
module.
"""
from .guard import (AdmissionPolicy, BreakerOpenError, CircuitBreaker,
                    GuardedScoreResult, GuardReason, OutputGuard,
                    SchemaGuard, ServingGuard)
from .lifecycle import LifecycleConfig, ModelLifecycle
from .plan import (EncodedScoreBatch, PlanCompileError, PlanCoverage,
                   ScoringPlan, bucket_for, plan_compiles)
from .sentinel import (DriftSentinel, DriftThresholds, FeatureFingerprint,
                       FingerprintSchemaError, compute_fingerprints,
                       load_fingerprint_doc, load_fingerprints,
                       save_fingerprints)
from .server import (PlanCache, ServeConfig, ServeDraining, ServeRejected,
                     ServingClient, ServingServer, serve_in_process)
from ..utils.ported import not_ported

__all__ = ["ScoringPlan", "EncodedScoreBatch", "PlanCoverage",
           "PlanCompileError", "plan_compiles", "bucket_for",
           "AdmissionPolicy", "SchemaGuard", "OutputGuard",
           "CircuitBreaker", "BreakerOpenError", "ServingGuard",
           "GuardReason", "GuardedScoreResult",
           "ServeConfig", "ServingServer", "ServingClient", "PlanCache",
           "ServeRejected", "ServeDraining", "serve_in_process",
           "DriftSentinel", "DriftThresholds", "FeatureFingerprint",
           "FingerprintSchemaError", "compute_fingerprints",
           "load_fingerprint_doc", "load_fingerprints",
           "save_fingerprints", "LifecycleConfig", "ModelLifecycle"]

#: the JAX package's serving exports that wait for their module's port
_UNPORTED = {
    **dict.fromkeys(("AdmissionConfig", "AdmissionController", "ServeShed"),
                    "serving/admission.py"),
    **dict.fromkeys(("TcpServingClient", "ServingUnavailable"),
                    "serving/client.py"),
    **dict.fromkeys(("ServingStateSnapshot", "StateManager",
                     "SNAPSHOT_SCHEMA"), "serving/state.py"),
    **dict.fromkeys(("ReplicaManager", "ReplicaSpec", "wait_port_ready"),
                    "serving/fleet.py"),
    **dict.fromkeys(("FleetRouter", "RouterConfig", "ReplicaHandle",
                     "BackendUnavailable", "merge_admission"),
                    "serving/router.py"),
}


def __getattr__(name):
    if name in _UNPORTED:
        raise not_ported(f"serving.{name}", _UNPORTED[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
