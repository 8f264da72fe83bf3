"""K1, the level histogram of the PyTorch port (models/hist_kernel.py).

The plain version (what the CPU runs; the CUDA kernel is held against it
on the card by chip_smoke.py) must equal the JAX package's Pallas kernel
``pallas_level_hist`` run in interpret mode on the same float32 inputs,
on the shapes of tests/test_pallas_hist.py plus the zero-stats and
sentinel-slot cases. The packed bin ids and the dense indicator the Pallas
kernel takes describe the same rows: bin_oh[r, b] = [packed[r, feat_of[b]]
== b].
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models.pallas_hist import pallas_level_hist
from transmogrifai_tpu_torch.models.hist_kernel import (
    SMEM_BUDGET, HistPlan, hist_bytes, level_hist, level_hist_plain)


def _packed_case(n, TB, rng):
    """(packed (n, d) int32, bin_oh (n, TB) f32): features of 1-8 bins
    packed side by side, one bin per feature per row."""
    widths = []
    while sum(widths) < TB:
        widths.append(min(int(rng.integers(1, 9)), TB - sum(widths)))
    offsets = np.concatenate([[0], np.cumsum(widths)[:-1]])
    packed = (rng.integers(0, 1 << 20, size=(n, len(widths)))
              % np.asarray(widths) + offsets).astype(np.int32)
    bin_oh = np.zeros((n, TB), np.float32)
    for f in range(len(widths)):
        bin_oh[np.arange(n), packed[:, f]] = 1.0
    return packed, bin_oh


def _both(packed, bin_oh, slot, stats, C):
    ref = np.asarray(pallas_level_hist(
        jnp.asarray(bin_oh), jnp.asarray(slot), jnp.asarray(stats), C))
    got = level_hist_plain(torch.as_tensor(packed), torch.as_tensor(slot),
                           torch.as_tensor(stats), C, bin_oh.shape[1])
    return ref, got.numpy()


@pytest.mark.parametrize(
    "n,TB,C,S",
    [
        (1000, 50, 8, 3),
        (777, 130, 16, 2),
        (64, 10, 1, 4),
        (2100, 300, 64, 2),
        (512, 2200, 4, 2),
    ])
def test_plain_matches_pallas(n, TB, C, S):
    rng = np.random.default_rng(n + TB)
    packed, bin_oh = _packed_case(n, TB, rng)
    slot = rng.integers(0, C, size=n).astype(np.int32)
    stats = rng.normal(size=(n, S)).astype(np.float32)
    ref, got = _both(packed, bin_oh, slot, stats, C)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case", ["zero_stats", "sentinel_slot"])
def test_inert_rows_match_pallas(case):
    """Zero-stats rows (masked by a fold) and rows parked on slot C (the
    histogram-subtraction sentinel) add nothing, in both packages."""
    rng = np.random.default_rng(7)
    n, TB, C, S = 600, 40, 4, 2
    packed, bin_oh = _packed_case(n, TB, rng)
    slot = rng.integers(0, C, size=n).astype(np.int32)
    stats = rng.normal(size=(n, S)).astype(np.float32)
    if case == "zero_stats":
        stats[::3] = 0.0
    else:
        slot[::3] = C
    ref, got = _both(packed, bin_oh, slot, stats, C)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
    keep = np.nonzero((slot < C) & np.any(stats != 0, axis=1))[0]
    only = level_hist_plain(torch.as_tensor(packed[keep]),
                            torch.as_tensor(slot[keep]),
                            torch.as_tensor(stats[keep]), C, TB).numpy()
    np.testing.assert_allclose(got, only, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    packed, _ = _packed_case(300, 60, rng)
    slot = torch.as_tensor(rng.integers(0, 5, size=300).astype(np.int32))
    stats = torch.as_tensor(rng.normal(size=(300, 2)))
    before = level_hist.launches
    got = level_hist(torch.as_tensor(packed), slot, stats, 5, 60)
    want = level_hist_plain(torch.as_tensor(packed), slot, stats, 5, 60)
    assert torch.equal(got, want)
    assert level_hist.launches == before        # no kernel launched


def test_wrapper_rejects_other_devices():
    packed = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    slot = torch.zeros(4, dtype=torch.int32, device="meta")
    stats = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        level_hist(packed, slot, stats, 2, 4)


def test_plan_groups_whole_features():
    """Feature groups are contiguous runs of whole features whose bins
    fit one block's shared memory at one slot."""
    widths = [32] * 500 + [2] * 100
    S = 2
    plan = HistPlan(widths, S, torch.device("cpu"))
    g = plan.groups.numpy()
    assert plan.n_groups == len(g) > 1
    offsets = np.concatenate([[0], np.cumsum(widths)])
    assert g[0, 0] == 0 and g[-1, 1] == len(widths)
    np.testing.assert_array_equal(g[1:, 0], g[:-1, 1])
    np.testing.assert_array_equal(g[:, 2], offsets[g[:, 0]])
    np.testing.assert_array_equal(g[:, 3], offsets[g[:, 1]])
    assert np.all((g[:, 3] - g[:, 2]) * S * 4 <= SMEM_BUDGET)
    assert plan.w_max == int(np.max(g[:, 3] - g[:, 2]))
    small = HistPlan([32] * 20 + [2] * 80, S, torch.device("cpu"))
    assert small.groups is None and small.w_max == 800


def test_bound_bytes():
    # the main path's largest level: 1M rows, 100 features, TB 800, C 256
    assert hist_bytes(1_000_000, 100, 2, 256, 800) == (
        4 * 1_000_000 * 100 + 4 * 1_000_000 + 8 * 1_000_000
        + 4 * 256 * 800 * 2)
    # inert rows: a quarter on the sentinel slot (no stats, no bin ids
    # read), a third of the rest with zero stats (no bin ids read)
    assert hist_bytes(1_000_000, 100, 2, 256, 800, 750_000, 500_000) == (
        4 * 1_000_000 + 8 * 750_000 + 4 * 500_000 * 100
        + 4 * 256 * 800 * 2)
