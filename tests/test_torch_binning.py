"""Packed binning and slot compression of the PyTorch port against the JAX
package (models/trees.py: _PackedDesign, _compress_nodes).

The host path is a numpy copy and must be exact on any data. The device
path (f32 column sort, quantile gather, ``searchsorted``) runs here on the
CPU and must equal the JAX ``_bin_device`` on data where f32 is exact, as
tests/test_device_binning.py arranges it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import trees as jt
from transmogrifai_tpu_torch.models import trees as tt

CPU = torch.device("cpu")


def _exact_data(n=3201, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.integers(0, 1000, size=n) / 8.0,       # high-card -> 32 bins
        rng.integers(0, 2, size=n).astype(float),  # binary -> 2 bins
        np.full(n, 3.5),                           # constant -> 2 bins
        rng.integers(0, 5, size=n) / 8.0,          # low-card -> 8 bins
    ], axis=1)


def _assert_parts_equal(a, b):
    (thr_a, w_a, binned_a), (thr_b, w_b, binned_b) = a, b
    np.testing.assert_array_equal(np.asarray(w_a), np.asarray(w_b))
    assert len(thr_a) == len(thr_b)
    for x, y in zip(thr_a, thr_b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(np.asarray(binned_a), np.asarray(binned_b))


def test_host_binning_exact():
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.normal(size=(700, 3)),
                        (rng.uniform(size=(700, 2)) < 0.2).astype(float),
                        rng.integers(0, 6, size=(700, 1)).astype(float)],
                       axis=1)
    _assert_parts_equal(jt._PackedDesign._bin_host(X, 32, None),
                        tt._PackedDesign._bin_host(X, 32))


@pytest.mark.parametrize("n", [3201, 1601])
def test_device_binning_matches_jax(n):
    """m - 1 divisible by every bin width: quantiles land on samples."""
    X = _exact_data(n=n)
    ref = jt._PackedDesign._bin_device(X, 32, None)
    got = tt._PackedDesign._bin_device(torch.as_tensor(X), 32)
    _assert_parts_equal(ref, (got[0], got[1], got[2].numpy()))


def test_design_matches_jax():
    X = _exact_data(n=1601)
    ref = jt._PackedDesign(X, 32)
    got = tt._PackedDesign(X, 32, CPU)
    np.testing.assert_array_equal(np.asarray(ref.packed), got.packed.numpy())
    np.testing.assert_array_equal(ref.widths, got.widths)
    np.testing.assert_array_equal(ref.packed_thr, got.packed_thr.numpy())
    np.testing.assert_array_equal(ref.feat_of, got.feat_of.numpy())
    assert got.packed.dtype == torch.int32 and got.packed.is_contiguous()
    assert got.packed_thr.dtype == torch.float64     # CPU working dtype


def test_cpu_designs_bin_on_the_host():
    X = _exact_data(n=64)
    design = tt._PackedDesign(X, 32, CPU)
    host = tt._PackedDesign._bin_host(X, 32)
    np.testing.assert_array_equal(
        design.packed.numpy() - np.repeat(
            np.concatenate([[0], np.cumsum(host[1])[:-1]])[None, :], 64, 0),
        host[2])


@pytest.mark.parametrize("n,levels,cap", [(500, 16, 256), (900, 64, 32),
                                          (333, 8, 8)])
def test_compress_nodes_exact(n, levels, cap):
    """Slots, node-of-slot table (sentinel padded, ranks past the cap
    dropped) and the active count equal the JAX sort-based ranking."""
    rng = np.random.default_rng(n)
    occupied = rng.choice(4 * levels, size=levels, replace=False)
    node = rng.choice(occupied, size=n).astype(np.int32)
    slot_j, nos_j, act_j = jt._compress_nodes(jnp.asarray(node), cap)
    slot_t, nos_t, act_t = tt._compress_nodes(torch.as_tensor(node), cap)
    np.testing.assert_array_equal(np.asarray(slot_j), slot_t.numpy())
    np.testing.assert_array_equal(np.asarray(nos_j), nos_t.numpy())
    assert int(act_j) == int(act_t)
    assert tt._SLOT_SENTINEL == int(jt._SLOT_SENTINEL)
