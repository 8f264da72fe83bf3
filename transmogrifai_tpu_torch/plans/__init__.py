"""Plans of the PyTorch port (counterpart of ``transmogrifai_tpu/plans/``):
the train-time prepare plan and the machinery it shares with the serving
``ScoringPlan`` (``serving/plan.py``)."""
from .common import PlanCompileError, PlanCoverage
from .prepare import PreparePlan

__all__ = ["PlanCompileError", "PlanCoverage", "PreparePlan"]
