"""PyTorch/CUDA port of transmogrifai_tpu.

The JAX package ``transmogrifai_tpu`` stays the reference; this package is
its counterpart for one NVIDIA H100, ported slice by slice with module
paths that mirror the reference's. It imports ``torch`` and numpy, never
``jax`` and nothing of ``transmogrifai_tpu``.

Ported so far: the binary model-selection search restricted to the
gradient-boosted-tree family (``selector.factories.
BinaryClassificationModelSelector.with_cross_validation(
model_types_to_use=["GBTClassifier"])``), with the per-level split
histogram as a hand-written CUDA kernel (``models/hist_kernel.py``,
``csrc/level_hist.cu``).
"""
