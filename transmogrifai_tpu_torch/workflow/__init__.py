"""Workflow engine of the PyTorch port (counterpart of
``transmogrifai_tpu/workflow/``; persistence and the runner are not
ported)."""
from .workflow import Workflow, WorkflowModel

__all__ = ["Workflow", "WorkflowModel"]
