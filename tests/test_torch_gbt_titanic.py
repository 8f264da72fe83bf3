"""Tree searches of the PyTorch port against the JAX package on the Titanic
matrix, in float64 on the CPU.

The matrix is the Titanic DAG's prepared vector of ``synthetic_titanic(891,
seed=5)`` (the example's 75 % split: 668 x 547), whose sparse one-hot and
hash columns put many rows on shared leaves. Tied margins then have to
stay tied, so the port must add trees in the reference's order and round
its sigmoid and log-odds as the reference's CPU code does
(``utils/ref_math.py``); a last-bit difference moves the tie-grouped AuPR
by up to 5.6e-4. Each metric must equal the JAX package's within 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_forest import JaxDraws
from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu_torch.evaluators import BinaryClassificationEvaluator
from transmogrifai_tpu_torch.examples import titanic
from transmogrifai_tpu_torch.models import trees as tt
from transmogrifai_tpu_torch.selector import CrossValidation
from transmogrifai_tpu_torch.utils import ref_math
from transmogrifai_tpu_torch.workflow import Workflow

#: default-grid points: depth 3 and depth 6 at min_child_weight 1, where
#: the tree order and the sigmoid's rounding decide ties, and a
#: min_child_weight 10 point
GBT_GRID = [{"max_depth": 3, "min_child_weight": 1.0, "gamma": 0.1},
            {"max_depth": 3, "min_child_weight": 10.0, "gamma": 0.001},
            {"max_depth": 6, "min_child_weight": 1.0, "gamma": 0.1}]
RF_GRID = [{"max_depth": 3, "min_instances_per_node": 10,
            "min_info_gain": 0.001},
           {"max_depth": 3, "min_instances_per_node": 100,
            "min_info_gain": 0.001},
           {"max_depth": 6, "min_instances_per_node": 10,
            "min_info_gain": 0.01}]
ROUNDS, TREES = 20, 5


@pytest.fixture(scope="module")
def matrix():
    """(X, y, masks, spec, X_val, y_val): the prepared training matrix and
    the selector's 3-fold stratified folds (seed 42)."""
    train, _ = titanic.stratified_split(titanic.synthetic_titanic(891,
                                                                  seed=5))
    label, vector = titanic.build_features()
    model = (Workflow(device="cpu").set_result_features(label, vector)
             .set_input_records(train).train())
    X = model.train_dataset[vector.name].data.numpy()
    y = np.asarray(model.train_dataset[label.name].data, dtype=np.float64)
    masks, spec, X_val, y_val = CrossValidation(
        BinaryClassificationEvaluator(), num_folds=3, seed=42,
        stratify=True)._build_fold_arrays(X, y)
    return X, y, masks, spec, X_val, y_val


@pytest.fixture(scope="module")
def gbt_metrics(matrix):
    X, y, masks, spec, X_val, y_val = matrix
    assert X.shape == (668, 547)
    ref = jt.GBTClassifier(num_rounds=ROUNDS).eval_fold_grid_arrays(
        X, y, masks, GBT_GRID, X_val, y_val, spec)
    got = tt.GBTClassifier(num_rounds=ROUNDS,
                           device="cpu").eval_fold_grid_arrays(
        torch.as_tensor(X), y, masks, GBT_GRID, torch.as_tensor(X_val),
        y_val, spec)
    return ref, got


@pytest.mark.parametrize("gi", range(len(GBT_GRID)))
def test_gbt_fold_grid_matches_jax(gbt_metrics, gi):
    ref, got = gbt_metrics
    assert got.shape == (3, len(GBT_GRID)) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got[:, gi], ref[:, gi], rtol=0, atol=1e-12)


@pytest.mark.parametrize("rows", [668, 609])
def test_gbt_fit_base_is_jax_bit_for_bit(matrix, rows):
    """The single fit's log-odds base: XLA folds the JAX package's mean
    over a constant mask into ``sum(y) * (1/n)``, which differs from
    ``sum(y) / n`` in the last bit at 609 rows; the trees follow."""
    X, y = matrix[0][:rows], matrix[1][:rows]
    kw = dict(num_rounds=3, max_depth=3)
    ref = jt.GBTClassifier(**kw).fit_arrays(X, y)
    got = tt.GBTClassifier(device="cpu", **kw).fit_arrays(X, y)
    assert got.base == ref.base
    np.testing.assert_array_equal(got.feats.numpy(), ref.feats)
    np.testing.assert_array_equal(got.thrs.numpy(), ref.thrs)
    np.testing.assert_array_equal(got.leaves.numpy(), ref.leaves)


@pytest.fixture(scope="module")
def rf_metrics(matrix):
    X, y, masks, spec, X_val, y_val = matrix
    ref = jt.RandomForestClassifier(num_trees=TREES).eval_fold_grid_arrays(
        X, y, masks, RF_GRID, X_val, y_val, spec)
    got = tt.RandomForestClassifier(
        num_trees=TREES, device="cpu", draws=JaxDraws).eval_fold_grid_arrays(
        torch.as_tensor(X), y, masks, RF_GRID, torch.as_tensor(X_val),
        y_val, spec)
    return ref, got


@pytest.mark.parametrize("gi", range(len(RF_GRID)))
def test_forest_fold_grid_matches_jax(rf_metrics, gi):
    """Vote sums in tree order, the mean as a product with 1/T."""
    ref, got = rf_metrics
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[:, gi], ref[:, gi], rtol=0, atol=1e-12)


def test_sigmoid_and_log_are_the_jax_packages():
    """Bit for bit on the CPU: ``jax.nn.sigmoid``, the metric's
    ``1 / (1 + exp(-m))`` (including margins whose quotient is subnormal,
    which XLA flushes to zero) and the log-odds' ``log``."""
    rng = np.random.default_rng(0)
    m = np.concatenate([rng.normal(0, 3, 50_000),
                        rng.uniform(-760, 760, 20_000),
                        [0.0, -0.0, 745.0, -745.0, np.inf, -np.inf]])
    got = ref_math.sigmoid(torch.as_tensor(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jax.nn.sigmoid)(m)))
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(lambda v: 1.0 / (1.0 + jnp.exp(-v)))(m)))
    p = rng.uniform(1e-6, 1 - 1e-6, 5_000)
    np.testing.assert_array_equal(
        ref_math.log(torch.as_tensor(p / (1 - p))).numpy(),
        np.asarray(jax.jit(lambda v: jnp.log(v / (1 - v)))(p)))
