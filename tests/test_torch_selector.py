"""The whole slice: the binary model-selection search, run by the JAX
package and by the PyTorch port (float64, CPU) on the same data, over GBT
alone and over the default pool's four families in its order (LR, RF,
GBT, LinearSVC; small trees, forests with the JAX package's draws
replayed). The (folds, grid) metric matrices agree to 1e-9 and the same
grid point wins; splitter and fold indices come from the same numpy
seeds."""
import numpy as np
import pytest

from test_torch_forest import JaxDraws
from transmogrifai_tpu.models import linear as jl
from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu.models.trees import GBTClassifier as JaxGBT
from transmogrifai_tpu.selector import splitters as jsplit
from transmogrifai_tpu.selector.factories import (
    BinaryClassificationModelSelector as JaxSelector)
from transmogrifai_tpu.selector.validator import CrossValidation as JaxCV
from transmogrifai_tpu_torch.evaluators import BinaryClassificationEvaluator
from transmogrifai_tpu_torch.models.registry import default_binary_models
from transmogrifai_tpu_torch.models import linear as tl
from transmogrifai_tpu_torch.models import trees as tt
from transmogrifai_tpu_torch.models.trees import GBTClassifier
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, CrossValidation, DataBalancer,
    stratified_split)

GRID = [{"max_depth": d, "min_child_weight": m}
        for d in (3, 5) for m in (1.0, 10.0)]


def _data(n=900, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] - 0.7 * X[:, 2] + 0.6 * rng.logistic(size=n) > 0
         ).astype(float)
    return X, y


def _matrix(selected):
    res = sorted(selected.summary.validation_results,
                 key=lambda r: r.grid_index)
    return np.array([r.metric_values for r in res]).T


@pytest.fixture(scope="module")
def searches():
    X, y = _data()
    ref = JaxSelector.with_cross_validation(
        num_folds=3, seed=7, stratify=True,
        splitter=jsplit.DataBalancer(reserve_test_fraction=0.1, seed=7),
        models=[(JaxGBT(num_rounds=3), GRID)], mesh=None).fit_arrays(X, y)
    got = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=7, stratify=True,
        splitter=DataBalancer(reserve_test_fraction=0.1, seed=7),
        models=[(GBTClassifier(num_rounds=3, device="cpu"), GRID)],
        device="cpu").fit_arrays(X, y)
    return ref, got


def test_metric_matrix_matches_jax(searches):
    ref, got = searches
    a, b = _matrix(ref), _matrix(got)
    assert a.shape == b.shape == (3, len(GRID))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-9)


def test_winner_matches_jax(searches):
    ref, got = searches
    assert got.summary.best_model_name == ref.summary.best_model_name
    assert got.summary.best_model_params == ref.summary.best_model_params
    assert int(np.argmax(_matrix(got).mean(0))) == int(
        np.argmax(_matrix(ref).mean(0)))
    assert abs(got.summary.best_validation_metric
               - ref.summary.best_validation_metric) <= 1e-9


def test_holdout_evaluation_matches_jax(searches):
    ref, got = searches
    for which in ("train_evaluation", "holdout_evaluation"):
        a = getattr(ref.summary, which)
        b = getattr(got.summary, which)
        for metric in ("AuPR", "AuROC", "Error"):
            assert abs(getattr(a, metric) - getattr(b, metric)) <= 1e-9
    assert set(got.summary.timings) == {"prepare", "validate", "refit",
                                        "evaluate"}


@pytest.mark.parametrize("stratify", [False, True])
def test_fold_assignments_match_jax(stratify):
    _, y = _data(n=301)
    ref = JaxCV(None, num_folds=3, seed=11, stratify=stratify,
                mesh=None)._assignments(y, 3)
    got = CrossValidation(BinaryClassificationEvaluator(), num_folds=3,
                          seed=11, stratify=stratify)._assignments(y, 3)
    np.testing.assert_array_equal(ref, got)


def test_splitters_match_jax():
    _, y = _data(n=401)
    y[:300] = 0.0                                 # imbalanced: resamples
    for a, b in zip(stratified_split(y, 0.2, np.random.default_rng(3)),
                    jsplit.stratified_split(y, 0.2,
                                            np.random.default_rng(3))):
        np.testing.assert_array_equal(a, b)
    ours = DataBalancer(sample_fraction=0.3, seed=5)
    theirs = jsplit.DataBalancer(sample_fraction=0.3, seed=5)
    np.testing.assert_array_equal(ours.prepare(y), theirs.prepare(y))
    assert ours.summary.results == theirs.summary.results


def test_default_grid_is_the_reference_grid():
    """The whole default pool, in the reference's order (the first
    candidate wins a tie: LR, RF, GBT, LinearSVC), with its grids and
    iteration counts."""
    from transmogrifai_tpu.models.registry import default_binary_models as ref
    pool = default_binary_models(device="cpu")
    names = [type(e).__name__ for e, _ in pool]
    assert names == [type(e).__name__ for e, _ in ref()] == [
        "LogisticRegression", "RandomForestClassifier", "GBTClassifier",
        "LinearSVC"]
    ref_grids = {type(e).__name__: g for e, g in ref()}
    for est, grid in pool:
        assert grid == ref_grids[type(est).__name__]
    assert [len(g) for _, g in pool] == [8, 18, 18, 4]
    assert pool[0][0].max_iter == pool[3][0].max_iter == 50
    assert pool[1][0].num_trees == 50 and pool[2][0].num_rounds == 20


def test_unported_families_are_named():
    """With no filter the selector builds the default pool; the MLP,
    ported since, filters as the JAX package filters it: it joins the
    multiclass pool by name, and a binary selector, whose pools lack it,
    drops it; filters keep the pool's order, and pick the opt-in families
    (NaiveBayes) after the default ones."""
    sel = BinaryClassificationModelSelector.with_cross_validation(
        device="cpu")
    assert [type(e).__name__ for e, _ in sel.models] == [
        "LogisticRegression", "RandomForestClassifier", "GBTClassifier",
        "LinearSVC"]
    assert sum(len(g) for _, g in sel.models) == 48
    sel = BinaryClassificationModelSelector.with_cross_validation(
        model_types_to_use=["GBTClassifier",
                            "MultilayerPerceptronClassifier"],
        device="cpu")
    assert [type(e).__name__ for e, _ in sel.models] == ["GBTClassifier"]
    from transmogrifai_tpu_torch.selector import (
        MultiClassificationModelSelector)
    sel = MultiClassificationModelSelector.with_cross_validation(
        model_types_to_use=["MultilayerPerceptronClassifier"], device="cpu")
    assert [(type(e).__name__, g) for e, g in sel.models] == [
        ("MultilayerPerceptronClassifier",
         [{"hidden_layers": (10,)}, {"hidden_layers": (32, 16)}])]
    sel = BinaryClassificationModelSelector.with_cross_validation(
        model_types_to_use=["NaiveBayes", "GBTClassifier"], device="cpu")
    assert [type(e).__name__ for e, _ in sel.models] == [
        "GBTClassifier", "NaiveBayes"]
    sel = BinaryClassificationModelSelector.with_cross_validation(
        model_types_to_use=["LinearSVC", "GBTClassifier"], device="cpu")
    assert [type(e).__name__ for e, _ in sel.models] == [
        "GBTClassifier", "LinearSVC"]
    sel = BinaryClassificationModelSelector.with_cross_validation(
        model_types_to_use=["RandomForestClassifier", "GBTClassifier"],
        device="cpu")
    assert [type(e).__name__ for e, _ in sel.models] == [
        "RandomForestClassifier", "GBTClassifier"]


LR_GRID = [{"reg_param": r, "elastic_net_param": e}
           for r in (0.001, 0.01, 0.1, 0.2) for e in (0.1, 0.5)]
SVC_GRID = [{"reg_param": r} for r in (0.001, 0.01, 0.1, 0.2)]
RF_GRID = [{"max_depth": 3, "min_instances_per_node": m}
           for m in (10, 100)]


@pytest.fixture(scope="module")
def pool_searches():
    """The default pool's four families in its order, the linear ones
    with their full grids, RF (3 trees) and GBT (3 rounds) cut small."""
    X, y = _data(n=600, seed=2)

    def search(selector, lr, rf, gbt, svc, **kw):
        return selector.with_cross_validation(
            num_folds=3, seed=7, stratify=True,
            models=[(lr, LR_GRID), (rf, RF_GRID), (gbt, GRID[:2]),
                    (svc, SVC_GRID)], **kw).fit_arrays(X, y)
    ref = search(JaxSelector, jl.LogisticRegression(max_iter=50),
                 jt.RandomForestClassifier(num_trees=3),
                 JaxGBT(num_rounds=3), jl.LinearSVC(max_iter=50),
                 splitter=jsplit.DataBalancer(reserve_test_fraction=0.1,
                                              seed=7), mesh=None)
    got = search(BinaryClassificationModelSelector,
                 tl.LogisticRegression(max_iter=50, device="cpu"),
                 tt.RandomForestClassifier(num_trees=3, device="cpu",
                                           draws=JaxDraws),
                 GBTClassifier(num_rounds=3, device="cpu"),
                 tl.LinearSVC(max_iter=50, device="cpu"),
                 splitter=DataBalancer(reserve_test_fraction=0.1, seed=7),
                 device="cpu")
    return ref, got


def test_default_pool_search_matches_jax(pool_searches):
    """Metric matrix (3 x 16) within 1e-9, the same winner (the logistic
    label makes it an LR point), and the holdout AuPR within 1e-9."""
    ref, got = pool_searches
    a, b = (np.array([r.metric_values
                      for r in sel.summary.validation_results]).T
            for sel in (ref, got))
    assert a.shape == b.shape == (3, 16)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-9)
    assert got.summary.best_model_name == ref.summary.best_model_name
    assert got.summary.best_model_params == ref.summary.best_model_params
    assert got.summary.best_model_name == "LogisticRegression"
    for which in ("train_evaluation", "holdout_evaluation"):
        for metric in ("AuPR", "AuROC"):
            assert abs(getattr(getattr(got.summary, which), metric)
                       - getattr(getattr(ref.summary, which), metric)
                       ) <= 1e-9
