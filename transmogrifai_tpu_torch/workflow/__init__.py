"""Workflow engine of the PyTorch port (counterpart of
``transmogrifai_tpu/workflow/``; the runner is not ported)."""
from .persistence import load_model, save_model
from .workflow import Workflow, WorkflowModel, cut_dag

__all__ = ["Workflow", "WorkflowModel", "cut_dag", "save_model",
           "load_model"]
