"""GBT fit, prediction and model carry-over of the PyTorch port against the
JAX package, in float64 on the CPU.

On continuous data without ties every split decision is the same, so the
heaps (features, thresholds) are equal and the leaves and base margins
agree to rounding (the histograms' running sums are taken in another
order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu.models.trees import GBTClassifier as JaxGBT
from transmogrifai_tpu_torch.models import trees as tt
from transmogrifai_tpu_torch.models.convert import gbt_from_numpy
from transmogrifai_tpu_torch.models.hist_kernel import compact_ids
from transmogrifai_tpu_torch.models.trees import GBTClassifier, _gbt_margins


def _data(n=600, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.3 * X[:, 4]
         + 0.5 * rng.logistic(size=n) > 0).astype(float)
    return X, y


@pytest.fixture(scope="module")
def fitted():
    X, y = _data()
    out = {}
    for depth in (3, 5):
        ref = JaxGBT(num_rounds=5, max_depth=depth).fit_arrays(X, y)
        got = GBTClassifier(num_rounds=5, max_depth=depth,
                            device="cpu").fit_arrays(X, y)
        out[depth] = (ref, got)
    return X, y, out


@pytest.mark.parametrize("depth", [3, 5])
def test_fit_matches_jax(fitted, depth):
    _, _, out = fitted
    ref, got = out[depth]
    np.testing.assert_array_equal(ref.feats, got.feats.numpy())
    np.testing.assert_array_equal(ref.thrs, got.thrs.numpy())
    np.testing.assert_allclose(got.leaves.numpy(), ref.leaves, rtol=0,
                               atol=1e-10)
    assert abs(got.base - ref.base) <= 1e-10
    assert got.leaves.dtype == torch.float64 and got.depth == depth


@pytest.mark.parametrize("depth", [3, 5])
def test_predictions_match_jax(fitted, depth):
    X, _, out = fitted
    ref, got = out[depth]
    a, b = ref.predict_arrays(X), got.predict_arrays(X)
    np.testing.assert_allclose(b.probability, a.probability, atol=1e-10)
    np.testing.assert_array_equal(b.data, a.data)


@pytest.mark.parametrize("depth", [3, 5])
def test_gbt_from_numpy_carries_jax_model(fitted, depth):
    X, _, out = fitted
    ref, _ = out[depth]
    port = gbt_from_numpy(ref.feats, ref.thrs, ref.leaves, ref.depth,
                          ref.base, ref.n_features, device="cpu")
    np.testing.assert_allclose(port.predict_arrays(X).probability,
                               ref.predict_arrays(X).probability,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("node_cap", [4, 8])
def test_compressed_levels_match_jax(node_cap):
    """A small slot cap sends a depth-6 tree through the compressed path
    (rank compression, budget mask) at a test size; on the same stats the
    tree equals the JAX builder's exactly."""
    X, _ = _data(n=500)
    rng = np.random.default_rng(node_cap)
    stats = np.stack([rng.normal(size=500),
                      rng.uniform(0.05, 0.25, size=500)], axis=1)
    ref_d = jt._PackedDesign(X, 32)
    feat, thr, leaf, node = jt._grow_tree(
        jnp.asarray(ref_d.packed), jnp.asarray(ref_d.feat_of),
        jnp.asarray(ref_d.block_start), jnp.asarray(ref_d.packed_thr),
        jnp.asarray(stats), depth=6, gain_fn=jt._xgb_gain(1.0, 0.0, 1.0),
        min_info_gain=0.0, node_cap=node_cap, hist_mode="scatter")
    got = tt._grow_tree(tt._PackedDesign(X, 32, torch.device("cpu")),
                        torch.as_tensor(stats), depth=6,
                        gain_fn=tt._xgb_gain(1.0, 0.0, 1.0),
                        node_cap=node_cap)
    np.testing.assert_array_equal(np.asarray(feat), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(thr), got[1].numpy())
    np.testing.assert_allclose(got[2].numpy(), np.asarray(leaf), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(np.asarray(node), got[3].numpy())
    # more leaves than slots: the deep levels ran compressed
    assert len(np.unique(np.asarray(node))) > node_cap


def test_traversal_routes_nan_right():
    """``not (x <= t)``: a NaN feature goes right, as in the JAX package."""
    X = torch.tensor([[np.nan], [0.0], [2.0]], dtype=torch.float64)
    feats = torch.zeros((1, 1), dtype=torch.int32)
    thrs = torch.ones((1, 1), dtype=torch.float64)
    leaves = torch.tensor([[-1.0, 1.0]], dtype=torch.float64)
    m = _gbt_margins(X, feats, thrs, leaves, 0.0, 1)
    np.testing.assert_array_equal(m.numpy(), [1.0, -1.0, 1.0])


def test_rejects_non_binary_labels():
    X, y = _data(n=50)
    y[0] = 2.0
    with pytest.raises(ValueError, match="binary labels"):
        GBTClassifier(num_rounds=1, max_depth=2, device="cpu").fit_arrays(X,
                                                                          y)


def test_subsample_draws_from_seeded_generator():
    """subsample < 1 masks rows with a seeded torch.Generator: the same
    seed gives the same trees, another seed other trees."""
    X, y = _data(n=300)

    def fit(seed):
        return GBTClassifier(num_rounds=3, max_depth=3, subsample=0.5,
                             seed=seed, device="cpu").fit_arrays(X, y)
    a, b, c = fit(1), fit(1), fit(2)
    assert torch.equal(a.leaves, b.leaves)
    assert not torch.equal(a.leaves, c.leaves)


def _ids_rebuild_packed(ids, offsets, packed):
    """offsets + the compact ids equal the int32 packed ids exactly, the
    pad columns are 0 and a row is a multiple of 16 bytes."""
    d = offsets.shape[0]
    local = ids[:, :d].long()
    if ids.dtype == torch.int16:
        local = local & 0xFFFF
    assert torch.equal(local + offsets.long(), packed.long())
    assert ids.shape[1] * ids.element_size() % 16 == 0
    assert ids.shape[1] * ids.element_size() < d * ids.element_size() + 16
    assert not torch.any(ids[:, d:])


@pytest.mark.parametrize("d", [6, 16, 21])
def test_compact_ids_host_binning(d):
    """A CPU design's compact ids (host binning) rebuild its packed ids."""
    X, _ = _data(n=300, d=d, seed=d)
    design = tt._PackedDesign(X, 32, torch.device("cpu"))
    assert design.ids.dtype == torch.uint8 and design.ids.is_contiguous()
    assert design.ids.shape == (300, -(-d // 16) * 16)
    _ids_rebuild_packed(design.ids, design.offsets, design.packed)


def test_compact_ids_device_binning():
    """The device binning path (``_bin_device``), run on CPU tensors,
    gives local bins whose compact ids rebuild the packed ids; a feature
    wider than 256 bins switches the ids to uint16 bit patterns."""
    X, _ = _data(n=400, d=5, seed=3)
    thr, widths, binned = tt._PackedDesign._bin_device(torch.as_tensor(X), 32)
    ids, offsets = compact_ids(binned, widths)
    assert ids.dtype == torch.uint8 and ids.shape == (400, 16)
    packed = binned + offsets
    _ids_rebuild_packed(ids, offsets, packed)
    wide = torch.as_tensor(np.random.default_rng(0).integers(
        0, 300, size=(50, 3)).astype(np.int32))
    ids, offsets = compact_ids(wide, [300, 300, 300])
    assert ids.dtype == torch.int16 and ids.shape == (50, 8)
    _ids_rebuild_packed(ids, offsets, wide + offsets)
