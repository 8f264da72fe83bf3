"""Train-time prepare plan of the PyTorch port (counterpart of
``transmogrifai_tpu/plans/``; the serving ScoringPlan is not ported)."""
from .common import PlanCoverage
from .prepare import PreparePlan

__all__ = ["PlanCoverage", "PreparePlan"]
