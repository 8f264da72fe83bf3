"""PyTorch/CUDA port of transmogrifai_tpu.

The JAX package ``transmogrifai_tpu`` stays the reference; this package is
its counterpart for one NVIDIA H100, ported slice by slice with module
paths that mirror the reference's. It imports ``torch`` and numpy, never
``jax`` and nothing of ``transmogrifai_tpu``.

Ported so far: the binary model-selection search over the tree families
of the default pool (``selector.factories.
BinaryClassificationModelSelector.with_cross_validation(
model_types_to_use=["RandomForestClassifier", "GBTClassifier"])``), and
the decision tree, with the per-level split histogram as a hand-written
CUDA kernel (``models/hist_kernel.py``, ``csrc/level_hist.cu``) and the
random draws passed in (``models/draws.py``).
"""
