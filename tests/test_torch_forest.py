"""Random forests and decision trees of the PyTorch port against the JAX
package, in float64 on the CPU.

The port takes its random draws as inputs (``models/draws.py``); here it
is handed ``JaxDraws``, which replays the JAX package's own key chain
through ``jax.random``, so both sides grow their trees from the same
pools, bootstrap weights and node feature subsets. Forest statistics are
integer class weights, so histograms and gains are exact and the heaps
equal the JAX package's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.evaluators import device_metrics as jdm
from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu.selector import splitters as jsplit
from transmogrifai_tpu.selector.factories import (
    BinaryClassificationModelSelector as JaxSelector)
from transmogrifai_tpu_torch.evaluators import (
    BinaryClassificationEvaluator, device_metrics as tdm)
from transmogrifai_tpu_torch.models import trees as tt
from transmogrifai_tpu_torch.models.convert import forest_from_numpy
from transmogrifai_tpu_torch.models.draws import TorchDraws
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, CrossValidation, DataBalancer)

CPU = torch.device("cpu")


_split = jax.jit(jax.random.split, static_argnums=1)
_choice = jax.jit(lambda k, N, p: jax.random.choice(k, N, (p,),
                                                    replace=False),
                  static_argnums=(1, 2))
_poisson = jax.jit(lambda k, rate, n: jax.random.poisson(k, rate, (n,)),
                   static_argnums=2)
_uniform = jax.jit(lambda k, d: jax.random.uniform(k, (256, d)),
                   static_argnums=1)
_bernoulli = jax.jit(lambda k, rate, n: jax.random.bernoulli(k, rate, (n,)),
                     static_argnums=2)


class JaxDraws:
    """The JAX package's draws, replayed: tree t's key is
    ``split(PRNGKey(seed), count)[t]``, split into (pool, weight, feature)
    keys; level l's node uniforms come from the (l+1)-th split of the
    feature key; boosting round r's subsample from the r-th key. Each draw
    is one jitted program (compiled once a shape, not once an op). Node
    uniforms are drawn at 256 rows and cut to the shape asked for: under
    JAX's partitionable threefry a (C, d) draw is the first C rows of any
    taller one."""

    def __init__(self, seed, count):
        self.keys = _split(jax.random.PRNGKey(seed), count)
        self.subs = {}

    def _tree(self, t):
        return _split(self.keys[t], 3)

    def pool(self, t, sizes):
        kn, kw = _split(self._tree(t)[0], 2)
        return [np.asarray(_choice(k, N, p)) if p else np.zeros(0, np.int64)
                for k, (N, p) in zip((kn, kw), sizes)]

    def poisson(self, t, rate, n):
        return np.asarray(_poisson(self._tree(t)[1], rate, n))

    def node_uniform(self, t, level, shape):
        subs = self.subs.setdefault(t, [])
        key = self._tree(t)[2] if not subs else subs[-1][0]
        while len(subs) <= level:
            key, sub = _split(key, 2)
            subs.append((key, sub))
        return np.asarray(_uniform(subs[level][1], shape[1]))[:shape[0]]

    def bernoulli(self, r, rate, n):
        return np.asarray(_bernoulli(self.keys[r], rate, n))


def _mixed(n, seed=0, mix=(8, 0, 12)):
    """``mix`` = (normal columns (32 bins), 3-valued columns (4 bins),
    Bernoulli columns (2 bins)); a logistic label."""
    n_num, n_four, n_bin = mix
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(size=(n, n_num)),
                        rng.integers(0, 3, size=(n, n_four)).astype(float),
                        (rng.uniform(size=(n, n_bin)) < 0.3).astype(float)],
                       axis=1)
    y = (X[:, 0] + 1.5 * X[:, -1] - X[:, -2] + 0.6 * rng.logistic(size=n)
         > 0.3).astype(float)
    return X, y


def _heaps_equal(ref, got):
    np.testing.assert_array_equal(np.asarray(ref.feats), got.feats.numpy())
    np.testing.assert_array_equal(np.asarray(ref.thrs), got.thrs.numpy())
    np.testing.assert_allclose(got.leaves.numpy(), np.asarray(ref.leaves),
                               rtol=0, atol=1e-12)


#: width mixes: (normal, 3-valued, Bernoulli) columns
MIXES = {"main": (20, 0, 80), "one-narrow": (19, 0, 1),
         "three-classes": (6, 5, 9), "no-narrow": (12, 0, 0),
         "no-wide": (0, 0, 24)}


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("strategy", ["auto", "log2", "0.5"])
def test_pool_plan_matches_jax(mix, strategy):
    n_num, n_four, n_bin = MIXES[mix]
    d = n_num + n_four + n_bin
    widths = np.array([32] * n_num + [4] * n_four + [2] * n_bin)
    mf = tt._resolve_max_features(strategy, d, True)
    assert mf == jt._resolve_max_features(strategy, d, True)
    (jn, jw), jcfg, jmf = jt._pool_plan(widths, mf)
    classes, cfg, got_mf = tt._pool_plan(widths, mf)
    assert cfg == jcfg and got_mf == jmf
    if cfg is not None:
        np.testing.assert_array_equal(classes[0], np.asarray(jn))
        np.testing.assert_array_equal(classes[1], np.asarray(jw))
    if mix == "main" and strategy == "auto":          # the 1M x 100 shape
        assert (mf, cfg) == (10, (32, 8, 2, 32))


@pytest.mark.parametrize("mix", ["one-narrow", "three-classes"])
def test_tree_pool_matches_jax(mix):
    """One tree's pooled design: pool, packed bins (offsets + compact
    ids), feature ownership, block starts and +inf-padded thresholds."""
    X, _ = _mixed(120, 1, MIXES[mix])
    n = X.shape[0]
    ref = jt._PackedDesign(X, 32)
    design = tt._PackedDesign(X, 32, CPU)
    mf = tt._resolve_max_features("auto", X.shape[1], True)
    (narrow, wide), cfg, _ = jt._pool_plan(ref.widths, mf)
    draws = JaxDraws(3, 2)
    pool, packed, feat_of, block_start, thr = jax.jit(
        jt._tree_pool, static_argnums=5)(
        draws._tree(1)[0], jnp.asarray(ref.binned), jnp.asarray(ref.col_thr),
        narrow, wide, cfg)
    classes, _, _ = tt._pool_plan(design.widths, mf)
    got = tt._ForestPool(design, classes, cfg).tree(1, draws)
    np.testing.assert_array_equal(got.feat_map.numpy(), np.asarray(pool))
    bins = torch.stack([got.row_bins(torch.full((n,), f))
                        for f in range(got.d)], dim=1)
    np.testing.assert_array_equal(bins.numpy(), np.asarray(packed))
    np.testing.assert_array_equal(got.feat_of.numpy(), np.asarray(feat_of))
    np.testing.assert_array_equal(got.offsets.numpy()[got.feat_of.numpy()],
                                  np.asarray(block_start))
    np.testing.assert_array_equal(got.packed_thr.numpy(), np.asarray(thr))
    assert got.total_bins == int(np.asarray(feat_of).shape[0])
    assert got.ids.dtype == torch.uint8 and got.ids.shape[1] % 16 == 0


@pytest.mark.parametrize("impurity", ["gini", "entropy"])
def test_gains_match_jax(impurity):
    """Gains on random integer class-weight histograms, with a min
    instances rule that binds."""
    rng = np.random.default_rng(5)
    hist = rng.integers(0, 6, size=(4, 30, 2)).astype(float)
    left = np.cumsum(hist, axis=1)
    total = left[:, -1:, :]
    fn_j = jax.jit(getattr(jt, f"_{impurity}_gain")(4.0))
    fn_t = getattr(tt, f"_{impurity}_gain")(4.0)
    ref = np.asarray(fn_j(jnp.asarray(left), jnp.asarray(total - left),
                          jnp.asarray(total)))
    got = fn_t(torch.as_tensor(left), torch.as_tensor(total - left),
               torch.as_tensor(total)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)
    assert np.isinf(got).any() and np.isfinite(got).any()


@pytest.mark.parametrize("impurity", ["gini", "entropy"])
@pytest.mark.parametrize("depth", [3, 5])
def test_decision_tree_matches_jax(impurity, depth):
    X, y = _mixed(300)
    ref = jt.DecisionTreeClassifier(max_depth=depth, impurity=impurity,
                                    min_instances_per_node=3
                                    ).fit_arrays(X, y)
    got = tt.DecisionTreeClassifier(max_depth=depth, impurity=impurity,
                                    min_instances_per_node=3,
                                    device="cpu").fit_arrays(X, y)
    _heaps_equal(ref, got)
    assert got.leaves.shape == (1, 2 ** depth, 2)


@pytest.fixture(scope="module")
def forests():
    """RF fits under replayed draws: 300 rows at depth 4 (identity levels)
    and 150 rows at depth 9 (cap 150: level 7 compressed and node-keyed,
    level 8 slot-keyed); 20 mixed features, so every tree is pooled."""
    X, y = _mixed(300)
    out = {}
    for n, depth in ((300, 4), (150, 9)):
        kw = dict(num_trees=4, max_depth=depth)
        out[depth] = (X[:n], jt.RandomForestClassifier(**kw).fit_arrays(
            X[:n], y[:n]), tt.RandomForestClassifier(
            device="cpu", draws=JaxDraws, **kw).fit_arrays(X[:n], y[:n]))
    return out


@pytest.mark.parametrize("depth", [4, 9])
def test_random_forest_matches_jax(forests, depth):
    X, ref, got = forests[depth]
    _heaps_equal(ref, got)
    assert tt._pool_plan(tt._PackedDesign(X, 32, CPU).widths,
                         4)[1] is not None           # pooled trees
    np.testing.assert_allclose(got.predict_arrays(X).probability,
                               ref.predict_arrays(X).probability, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("depth", [4, 9])
def test_forest_from_numpy_carries_jax_model(forests, depth):
    X, ref, _ = forests[depth]
    port = forest_from_numpy(ref.feats, ref.thrs, ref.leaves, ref.depth,
                             ref.n_features, device="cpu")
    a, b = ref.predict_arrays(X), port.predict_arrays(X)
    np.testing.assert_allclose(b.probability, a.probability, rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(b.data, a.data)


def test_vote_metrics_match_jax():
    votes = np.random.default_rng(2).uniform(size=(50, 2))
    votes[:3] = 0.0                                   # empty rows
    for a, b in zip(jdm.binary_from_votes(jnp.asarray(votes)),
                    tdm.binary_from_votes(torch.as_tensor(votes))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        np.asarray(jdm.vote_probability(jnp.asarray(votes))),
        tdm.vote_probability(torch.as_tensor(votes)).numpy())


#: one static group each (one compiled JAX kernel per family)
RF_GRID = [{"min_instances_per_node": m, "min_info_gain": g}
           for m in (5, 20) for g in (0.0, 0.01)]
GBT_GRID = [{"min_child_weight": m} for m in (1.0, 10.0)]


@pytest.fixture(scope="module")
def searches():
    """RF (replayed draws) + GBT under 3-fold CV, by the JAX package and
    by the port, on the same data and seeds."""
    X, y = _mixed(360, 6)

    def search(selector, rf, gbt, **kw):
        return selector.with_cross_validation(
            num_folds=3, seed=7, stratify=True, models=[(rf, RF_GRID),
                                                        (gbt, GBT_GRID)],
            **kw).fit_arrays(X, y)
    ref = search(JaxSelector,
                 jt.RandomForestClassifier(num_trees=3, max_depth=4),
                 jt.GBTClassifier(num_rounds=3, max_depth=3),
                 splitter=jsplit.DataBalancer(reserve_test_fraction=0.1,
                                              seed=7), mesh=None)
    got = search(BinaryClassificationModelSelector,
                 tt.RandomForestClassifier(num_trees=3, max_depth=4,
                                           device="cpu", draws=JaxDraws),
                 tt.GBTClassifier(num_rounds=3, max_depth=3, device="cpu"),
                 splitter=DataBalancer(reserve_test_fraction=0.1, seed=7),
                 device="cpu")
    return X, y, ref, got


def test_eval_fold_grid_matches_jax(searches):
    """The (F, G) matrix of ``eval_fold_grid_arrays`` on the folds the
    selector builds (the JAX side reuses the search's compiled kernel)."""
    X, y, _, _ = searches
    splitter = DataBalancer(reserve_test_fraction=0.1, seed=7)
    train_idx, _ = splitter.split(y)
    Xt, yt = X[train_idx], y[train_idx]
    keep = splitter.prepare(yt)
    Xp, yp = Xt[keep], yt[keep]
    masks, spec, X_val, y_val = CrossValidation(
        BinaryClassificationEvaluator(), num_folds=3, seed=7,
        stratify=True)._build_fold_arrays(Xp, yp)
    ref = jt.RandomForestClassifier(
        num_trees=3, max_depth=4).eval_fold_grid_arrays(
        Xp, yp, masks, RF_GRID, X_val, y_val, spec)
    got = tt.RandomForestClassifier(
        num_trees=3, max_depth=4, device="cpu",
        draws=JaxDraws).eval_fold_grid_arrays(
        Xp, yp, masks, RF_GRID, X_val, y_val, spec)
    assert got.shape == (3, len(RF_GRID)) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)


def test_selector_picks_jax_winner(searches):
    """Same metric matrices, winner and holdout metrics as the JAX
    package's search."""
    _, _, ref, got = searches

    def matrix(sel):
        return np.array([r.metric_values
                         for r in sel.summary.validation_results]).T
    np.testing.assert_allclose(matrix(got), matrix(ref), rtol=0, atol=1e-9)
    assert got.summary.best_model_name == ref.summary.best_model_name
    assert got.summary.best_model_params == ref.summary.best_model_params
    for metric in ("AuPR", "AuROC"):
        assert abs(getattr(got.summary.holdout_evaluation, metric)
                   - getattr(ref.summary.holdout_evaluation, metric)) <= 1e-9


def test_gbt_subsample_matches_jax():
    """subsample < 1 draws each round's rows from the provider: under the
    replayed Bernoulli draws the boosted trees equal the JAX package's."""
    X, y = _mixed(300, 8)
    kw = dict(num_rounds=3, max_depth=3, subsample=0.7)
    ref = jt.GBTClassifier(**kw).fit_arrays(X, y)
    got = tt.GBTClassifier(device="cpu", draws=JaxDraws, **kw).fit_arrays(
        X, y)
    np.testing.assert_array_equal(ref.feats, got.feats.numpy())
    np.testing.assert_array_equal(ref.thrs, got.thrs.numpy())
    np.testing.assert_allclose(got.leaves.numpy(), ref.leaves, rtol=0,
                               atol=1e-10)


def test_torch_draws_reproducible():
    """The default provider: the same (seed, tree) gives the same draws,
    another tree other ones; pools are distinct picks; Poisson(1) weights
    have mean 1 and about e^-1 zeros."""
    a, b = TorchDraws(3, 4), TorchDraws(3, 4)
    assert torch.equal(a.poisson(1, 1.0, 1000), b.poisson(1, 1.0, 1000))
    assert not torch.equal(a.poisson(1, 1.0, 1000), a.poisson(2, 1.0, 1000))
    w = a.poisson(0, 1.0, 200_000)
    assert abs(float(w.mean()) - 1.0) < 0.01
    assert abs(float((w == 0).double().mean()) - np.exp(-1)) < 0.01
    narrow, wide = a.pool(0, [(80, 32), (20, 8)])
    assert len(set(narrow.tolist())) == 32 and max(narrow) < 80
    assert len(set(wide.tolist())) == 8 and max(wide) < 20
    u = a.node_uniform(0, 2, (4, 40))
    assert u.shape == (4, 40) and u.dtype == torch.float64
    assert torch.equal(u, b.node_uniform(0, 2, (4, 40)))
    assert float(a.bernoulli(0, 0.7, 100_000).mean()) == pytest.approx(
        0.7, abs=0.01)
