"""Tunable knobs of the PyTorch port (counterpart of the
``transmogrifai_tpu/tuning/`` registry): the serving knobs' static
defaults. The JAX package's ``TuningPolicy``, cost models and bucket
lattices are not ported; the port's serving layer takes the decisions that
policy takes with an empty store, which are these defaults."""
from .registry import KNOBS, STATIC_DEFAULTS, Knob

__all__ = ["Knob", "KNOBS", "STATIC_DEFAULTS"]
