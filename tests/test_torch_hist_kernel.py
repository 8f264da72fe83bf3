"""K1, the level histogram of the PyTorch port (models/hist_kernel.py).

The plain version (what the CPU runs; the CUDA kernel is held against it
on the card by chip_smoke.py) must equal the JAX package's Pallas kernel
``pallas_level_hist`` run in interpret mode on the same float32 inputs,
on the shapes of tests/test_pallas_hist.py plus the zero-stats and
sentinel-slot cases. The compact ids plus offsets and the dense indicator
the Pallas kernel takes describe the same rows: bin_oh[r, b] =
[offsets[f] + ids[r, f] == b] for the feature f owning b. The plain
version must also equal the first design's packed-id version bit for bit,
and the launch plan must fit a block's shared memory and cover every slot
and bin.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models.pallas_hist import pallas_level_hist
from transmogrifai_tpu_torch.models.hist_kernel import (
    BARRIER_BYTES, CONSUMERS, SMEM_BLOCK, HistPlan, compact_ids, hist_bytes,
    level_hist, level_hist_plain)


def _packed_case(n, TB, rng, max_width=8):
    """(packed (n, d) int32, bin_oh (n, TB) f32, widths): features of
    1..max_width bins packed side by side, one bin per feature per row."""
    widths = []
    while sum(widths) < TB:
        widths.append(min(int(rng.integers(1, max_width + 1)),
                          TB - sum(widths)))
    offsets = np.concatenate([[0], np.cumsum(widths)[:-1]])
    packed = (rng.integers(0, 1 << 20, size=(n, len(widths)))
              % np.asarray(widths) + offsets).astype(np.int32)
    bin_oh = np.zeros((n, TB), np.float32)
    for f in range(len(widths)):
        bin_oh[np.arange(n), packed[:, f]] = 1.0
    return packed, bin_oh, widths


def _compact(packed, widths):
    """(ids, offsets) of a packed case, through the port's compaction."""
    offsets = np.concatenate([[0], np.cumsum(widths)[:-1]])
    return compact_ids(torch.as_tensor(packed - offsets), widths)


def _packed_id_plain(packed, slot, stats, C, TB):
    """The first design's plain K1 over int32 packed ids, kept as the
    yardstick the compact-id version must equal bit for bit."""
    n, d = packed.shape
    S = stats.shape[1]
    keep = (slot >= 0) & (slot < C)
    seg = torch.where(keep[:, None], slot.long()[:, None] * TB + packed.long(),
                      C * TB)
    out = torch.zeros((C * TB + 1, S), dtype=stats.dtype)
    out.index_add_(0, seg.reshape(-1),
                   stats[:, None, :].expand(n, d, S).reshape(n * d, S))
    return out[:C * TB].view(C, TB, S)


def _both(packed, bin_oh, widths, slot, stats, C):
    ref = np.asarray(pallas_level_hist(
        jnp.asarray(bin_oh), jnp.asarray(slot), jnp.asarray(stats), C))
    ids, offsets = _compact(packed, widths)
    got = level_hist_plain(ids, offsets, torch.as_tensor(slot),
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
    packed, bin_oh, widths = _packed_case(n, TB, rng)
    slot = rng.integers(0, C, size=n).astype(np.int32)
    stats = rng.normal(size=(n, S)).astype(np.float32)
    ref, got = _both(packed, bin_oh, widths, slot, stats, C)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case", ["zero_stats", "sentinel_slot"])
def test_inert_rows_match_pallas(case):
    """Zero-stats rows (masked by a fold) and rows parked on slot C (the
    histogram-subtraction sentinel) add nothing, in both packages."""
    rng = np.random.default_rng(7)
    n, TB, C, S = 600, 40, 4, 2
    packed, bin_oh, widths = _packed_case(n, TB, rng)
    slot = rng.integers(0, C, size=n).astype(np.int32)
    stats = rng.normal(size=(n, S)).astype(np.float32)
    if case == "zero_stats":
        stats[::3] = 0.0
    else:
        slot[::3] = C
    ref, got = _both(packed, bin_oh, widths, slot, stats, C)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
    keep = np.nonzero((slot < C) & np.any(stats != 0, axis=1))[0]
    ids, offsets = _compact(packed[keep], widths)
    only = level_hist_plain(ids, offsets, torch.as_tensor(slot[keep]),
                            torch.as_tensor(stats[keep]), C, TB).numpy()
    np.testing.assert_allclose(got, only, atol=1e-5)


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    packed, _, widths = _packed_case(300, 60, rng)
    ids, offsets = _compact(packed, widths)
    slot = torch.as_tensor(rng.integers(0, 5, size=300).astype(np.int32))
    stats = torch.as_tensor(rng.normal(size=(300, 2)))
    before = level_hist.launches
    got = level_hist(ids, offsets, slot, stats, 5, 60)
    want = level_hist_plain(ids, offsets, slot, stats, 5, 60)
    assert torch.equal(got, want)
    assert level_hist.launches == before        # no kernel launched


def test_wrapper_rejects_other_devices():
    ids = torch.zeros((4, 16), dtype=torch.uint8, device="meta")
    offsets = torch.zeros(2, dtype=torch.int32, device="meta")
    slot = torch.zeros(4, dtype=torch.int32, device="meta")
    stats = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        level_hist(ids, offsets, slot, stats, 2, 4)


def test_plan_groups_whole_features():
    """Feature groups are contiguous runs of whole features whose skewed
    bin positions fit one block's histogram budget at one slot and span
    at most CONSUMERS words of a row."""
    widths = [32] * 1000 + [2] * 100
    S = 2
    plan = HistPlan(widths, S, torch.device("cpu"))
    g = plan.groups.numpy()
    assert plan.n_groups == len(g) > 1
    offsets = np.concatenate([[0], np.cumsum(widths)])
    pos = offsets[:-1] + np.arange(len(widths)) // 4    # uint8: 4 a word
    assert g[0, 0] == 0 and g[-1, 1] == len(widths)
    np.testing.assert_array_equal(g[1:, 0], g[:-1, 1])
    np.testing.assert_array_equal(g[:, 2], offsets[g[:, 0]])
    np.testing.assert_array_equal(g[:, 3], offsets[g[:, 1]])
    np.testing.assert_array_equal(g[:, 4], pos[g[:, 0]])
    np.testing.assert_array_equal(g[:, 5], pos[g[:, 1] - 1]
                                  + np.asarray(widths)[g[:, 1] - 1])
    assert np.all((g[:, 5] - g[:, 4]) * S * 4 <= plan.hist_budget)
    assert np.all(-(-g[:, 1] // 4) - g[:, 0] // 4 <= CONSUMERS)
    assert plan.w_max == int(np.max(g[:, 5] - g[:, 4]))
    small = HistPlan([32] * 20 + [2] * 80, S, torch.device("cpu"))
    # the main path's design: one group, 800 bins and a skew of 24 words
    assert small.n_groups == 1 and small.w_max == 824
    assert small.stride == 112 and small.id_bytes == 1


@pytest.mark.parametrize("id_bytes", [4, 2, 1])
def test_bound_bytes(id_bytes):
    """int32 packed ids (the first design's yardstick), uint16 and uint8
    compact ids: d ids a live row are priced, never the pad columns."""
    # the main path's largest level: 1M rows, 100 features, TB 800, C 256
    assert hist_bytes(1_000_000, 100, 2, 256, 800, id_bytes=id_bytes) == (
        id_bytes * 1_000_000 * 100 + 4 * 1_000_000 + 8 * 1_000_000
        + 4 * 256 * 800 * 2)
    # inert rows: a quarter on the sentinel slot (no stats, no bin ids
    # read), a third of the rest with zero stats (no bin ids read)
    assert hist_bytes(1_000_000, 100, 2, 256, 800, 750_000, 500_000,
                      id_bytes=id_bytes) == (
        4 * 1_000_000 + 8 * 750_000 + id_bytes * 500_000 * 100
        + 4 * 256 * 800 * 2)


@pytest.mark.parametrize("n,TB,C,S,max_width,inert", [
    (700, 90, 8, 2, 8, ""),
    (500, 400, 16, 3, 40, "sentinel"),
    (400, 1500, 4, 2, 700, "zero"),          # widths > 256: uint16 ids
])
def test_plain_equals_packed_id_version(n, TB, C, S, max_width, inert):
    """The compact-id plain version adds the same segment ids in the same
    row order as the first design's packed-id version: bitwise equal."""
    rng = np.random.default_rng(n + C)
    packed, _, widths = _packed_case(n, TB, rng, max_width)
    slot = rng.integers(0, C, size=n).astype(np.int32)
    stats = rng.normal(size=(n, S))
    if inert == "sentinel":
        slot[::4] = C
    elif inert == "zero":
        stats[::3] = 0.0
    ids, offsets = _compact(packed, widths)
    assert ids.dtype == (torch.uint8 if max(widths) <= 256 else torch.int16)
    got = level_hist_plain(ids, offsets, torch.as_tensor(slot),
                           torch.as_tensor(stats), C, TB)
    want = _packed_id_plain(torch.as_tensor(packed), torch.as_tensor(slot),
                      torch.as_tensor(stats), C, TB)
    assert torch.equal(got, want)


@pytest.mark.parametrize("widths,S", [
    ([32] * 20 + [2] * 80, 2),               # the main path's design
    ([32] * 500, 2),                          # wide: feature groups
    ([1000] + [32] * 19, 2),                  # uint16 ids
    ([1000] + [32] * 999, 2),                 # uint16, wide rows
    ([2] * 3000, 4),                          # many features: word cap
])
@pytest.mark.parametrize("C", [1, 4, 32, 128, 256])
def test_launch_plan_fits_and_covers(widths, S, C):
    """Every block fits the 227 KB a block may use; the slot tiles cover
    [0, C) and the feature groups every bin, each exactly once; small
    histograms are kept in several copies."""
    plan = HistPlan(widths, S, torch.device("cpu"))
    c_tile, stages, copies = plan.launch(C)
    assert 2 <= stages <= 4 and 1 <= c_tile <= C
    assert 1 <= copies <= CONSUMERS // 32
    assert plan.smem_bytes(C) <= SMEM_BLOCK
    assert plan.smem_bytes(C) == (BARRIER_BYTES + stages * plan.stage_bytes
                                  + copies * c_tile * plan.w_max * S * 4)
    assert plan.stage_bytes % 16 == 0 and plan.stride * plan.id_bytes % 16 == 0
    assert plan.rows % 4 == 0 and 2 * plan.stage_bytes <= SMEM_BLOCK // 4
    n_ct = -(-C // c_tile)
    covered = np.zeros(C, int)
    for ct in range(n_ct):
        covered[ct * c_tile:min(C, (ct + 1) * c_tile)] += 1
    assert np.all(covered == 1)
    g = plan.group_rows
    bins = np.zeros(sum(widths), int)
    for row in g:
        bins[row[2]:row[3]] += 1
    assert np.all(bins == 1)
    if C == 1 and len(widths) == 100:          # the main path at C = 1
        assert copies == CONSUMERS // 32
    # every bin's skewed position lies inside its group's span
    pos = plan.pos_of_bin.numpy()
    for row in g:
        p = pos[row[2]:row[3]]
        assert p.min() >= row[4] and p.max() < row[5]


def test_wrapper_raises_above_uint16():
    with pytest.raises(ValueError, match="uint16"):
        HistPlan([70_000, 2], 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="uint16"):
        compact_ids(torch.zeros((3, 2), dtype=torch.int32), [70_000, 2])
