"""PyTorch/CUDA port of transmogrifai_tpu.

The JAX package ``transmogrifai_tpu`` stays the reference; this package is
its counterpart for one NVIDIA H100, ported slice by slice with module
paths that mirror the reference's. It imports ``torch`` and numpy, never
``jax`` and nothing of ``transmogrifai_tpu``.

Ported so far: the binary model-selection search over the whole default
pool (``selector.factories.BinaryClassificationModelSelector.
with_cross_validation()``: LogisticRegression, RandomForestClassifier,
GBTClassifier, LinearSVC), and the decision tree, with the per-level
split histogram as a hand-written CUDA kernel (``models/hist_kernel.py``,
``csrc/level_hist.cu``), the random draws passed in
(``models/draws.py``), and the linear family's FISTA and L-BFGS solvers
(``models/solvers.py``) batched over the fold x grid candidates
(``parallel/cv.py``); and the workflow above it: the type lattice
(``types/``), the feature DAG (``features/``, ``stages/``), the Titanic
DAG's vectorizers and ``transmogrify`` (``ops/``), the prepare plan that
runs the DAG's device stages as torch ops so the selector searches a
matrix born on the device (``plans/prepare.py``), and ``Workflow`` /
``WorkflowModel`` (``workflow/``; the Titanic example in
``examples/titanic.py``), saving and serving (``workflow/persistence.py``,
``local/``, ``serving/``), and feature validation and search options:
the SanityChecker and the raw feature filter (``checkers/``),
workflow-level CV, racing (``selector/racing.py``) and the single
train/validation split.
"""
