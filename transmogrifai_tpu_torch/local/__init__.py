"""Engine-free local scoring of the PyTorch port (counterpart of
``transmogrifai_tpu/local/``; reference local/src/main/scala/com/
salesforce/op/local/OpWorkflowModelLocal.scala:52)."""
from .scoring import ScoreFunction, load_score_function, score_function_for

__all__ = ["ScoreFunction", "load_score_function", "score_function_for"]
