"""K1: the per-level split histogram of the tree builder.

Counterpart of ``transmogrifai_tpu/models/pallas_hist.py``
(``pallas_level_hist``, the repository's one Pallas TPU kernel). The TPU
kernel contracts a dense (n, TB) 0/1 bin indicator on the MXU; the port
reads compact per-feature bin ids (one byte a feature when every feature
has at most 256 bins, else two) and scatter-adds into shared-memory
histograms, a hand-written CUDA kernel for Hopper (``csrc/level_hist.cu``,
where its design and bound are set out). Both compute

    hist[c, b, s] = sum_r [slot_r == c] * stats[r, s] * bin_oh[r, b]
    with bin_oh[r, b] = [offsets[f] + ids[r, f] == b], f = feat_of[b],

and rows whose slot lies outside [0, C) or whose stats are zero add
nothing.

:func:`level_hist` launches the kernel for CUDA tensors and takes the plain
version, :func:`level_hist_plain`, only for tensors on the CPU. Bound of
one call (memory, :func:`hist_bytes`): at n = 1M, d = 100 (uint8 ids),
S = 2, C = 256, TB = 800 the kernel must move about 113.6 MB, 0.0339 ms
at 3.35 TB/s; its time is set by the shared-memory float adds instead
(``csrc/level_hist.cu``). :class:`HistPlan` sizes each launch.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["HistPlan", "compact_ids", "hist_bytes", "level_hist",
           "index_add_rows", "level_hist_plain", "padded_stride"]

#: dynamic shared memory one block may opt into on an H100 (bytes)
SMEM_BLOCK = 232_448
#: the mbarriers and the row span at the start of a block's shared
#: memory (bytes)
BARRIER_BYTES = 128
#: rows of one staged tile at most (a multiple of 4 keeps every copy a
#: multiple of 16 bytes); wide rows take fewer, so that a two-stage ring
#: stays within a quarter of a block's shared memory
ROWS_PER_STAGE = 64
#: the staging ring holds 2..MAX_STAGES tiles
MAX_STAGES = 4
#: the kernel keeps a row's statistics in registers
MAX_STATS = 4
#: consumer threads of a block; a feature group spans at most this many
#: 32-bit words of a row
CONSUMERS = 992
#: widest feature the compact ids can hold (uint16)
MAX_WIDTH = 1 << 16


def padded_stride(d: int, id_bytes: int) -> int:
    """Row stride, in ids, of the compact (n, stride) matrix: ``d`` padded
    so that a row is a multiple of 16 bytes (a bulk copy's unit)."""
    per = 16 // id_bytes
    return -(-d // per) * per


def id_bytes_for(widths: Sequence[int]) -> int:
    """1 (uint8 ids) when every feature has at most 256 bins, 2 (uint16)
    up to 65,536; wider features raise."""
    w = int(max(widths)) if len(widths) else 1
    if w > MAX_WIDTH:
        raise ValueError(f"a feature with {w} bins does not fit the "
                         f"histogram kernel's uint16 bin ids")
    return 1 if w <= 256 else 2


def compact_ids(binned: torch.Tensor, widths: Sequence[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, offsets) of a design from its (n, d) per-feature local bins.

    ``ids`` is (n, stride) on ``binned``'s device, row-major with the
    stride of :func:`padded_stride`: uint8, or int16 holding uint16 bit
    patterns when some feature has more than 256 bins; the pad columns are
    0. ``offsets`` is the (d,) int32 start of each feature's block of
    packed bins, so ``offsets[f] + ids[r, f]`` is the packed bin id."""
    widths = np.asarray(widths, dtype=np.int64)
    n, d = binned.shape
    ib = id_bytes_for(widths)
    ids = torch.zeros((n, padded_stride(d, ib)),
                      dtype=torch.uint8 if ib == 1 else torch.int16,
                      device=binned.device)
    local = binned.to(torch.int32)
    ids[:, :d] = (local if ib == 1 else torch.where(
        local >= 1 << 15, local - (1 << 16), local)).to(ids.dtype)
    offsets = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int32)
    return ids, torch.as_tensor(offsets, device=binned.device)


def hist_bytes(n: int, d: int, S: int, C: int, TB: int,
               n_slotted: Optional[int] = None,
               n_live: Optional[int] = None, id_bytes: int = 4) -> int:
    """Bytes one call must move: every slot read once, the stats of the
    ``n_slotted`` rows whose slot lies in [0, C) read once, the ``d`` bin
    ids of ``id_bytes`` each of the ``n_live`` of those whose stats are
    not all zero read once, the output written once. Both counts default
    to every row; the default ``id_bytes=4`` prices int32 packed ids. The
    pad columns of the compact ids are not priced: the function does not
    need them."""
    n_slotted = n if n_slotted is None else n_slotted
    n_live = n_slotted if n_live is None else n_live
    return (4 * n + 4 * n_slotted * S + id_bytes * d * n_live
            + 4 * C * TB * S)


class HistPlan:
    """Launch plan of one design for ``S`` statistics.

    Shared-memory histogram layout: statistic-planar, hist[s][slot][pos],
    where feature f's bins start at pos = offsets[f] + f // K (K features
    share a 32-bit word of ids: 4 for uint8, 2 for uint16). The one-float
    skew per word keeps the lanes of a warp, which take consecutive words
    of a row, on different banks when their bins have equal local ids.

    A block owns one (slot tile x feature group) histogram. Feature groups
    are contiguous runs of whole features whose positions fit the
    histogram budget at one slot (and at most CONSUMERS words of a row);
    ``groups`` is the (G, 6) int32 table (f_lo, f_hi, b_lo, b_hi, p_lo,
    p_hi) on ``device`` and ``w_max`` the widest group's positions.
    :meth:`launch` sizes the slot tile and the staging ring for C slots."""

    __slots__ = ("groups", "n_groups", "w_max", "S", "id_bytes", "stride",
                 "d", "total_bins", "rows", "stage_bytes", "hist_budget",
                 "pos_of_bin", "group_rows", "_launch", "widths", "device",
                 "_blocks")

    def __init__(self, widths: Sequence[int], S: int, device: torch.device):
        widths = [int(w) for w in widths]
        self.widths, self.device = widths, device
        self._blocks: Dict[int, "HistPlan"] = {}
        d = len(widths)
        self.S, self.d = int(S), d
        self.id_bytes = id_bytes_for(widths)
        self.stride = padded_stride(d, self.id_bytes)
        K = 4 // self.id_bytes
        self.total_bins = TB = int(sum(widths))
        row_bytes = self.stride * self.id_bytes + 4 + 4 * self.S
        self.rows = max(4, min(ROWS_PER_STAGE,
                               SMEM_BLOCK // (8 * row_bytes) // 4 * 4))
        self.stage_bytes = self.rows * row_bytes
        self.hist_budget = SMEM_BLOCK - BARRIER_BYTES - 2 * self.stage_bytes
        cap = self.hist_budget // (4 * self.S)
        off = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
        pos = off[:-1] + np.arange(d) // K          # skewed start of each f
        end = pos + np.asarray(widths, dtype=np.int64)
        starts, f_lo = [], 0
        for f in range(d):
            if end[f] - pos[f] > cap:
                raise ValueError(f"a feature with {widths[f]} bins does not "
                                 f"fit the histogram kernel's shared memory")
            words = (f + 1 + K - 1) // K - f_lo // K
            if f > f_lo and (end[f] - pos[f_lo] > cap or words > CONSUMERS):
                starts.append(f_lo)
                f_lo = f
        starts.append(f_lo)
        bounds = starts + [d]
        table = [(a, b, off[a], off[b], pos[a], end[b - 1])
                 for a, b in zip(bounds[:-1], bounds[1:])]
        self.group_rows = np.asarray(table, dtype=np.int32).reshape(-1, 6)
        self.n_groups = len(table)
        self.w_max = int(max(t[5] - t[4] for t in table))
        self.groups = torch.as_tensor(self.group_rows, device=device)
        feat_of = np.repeat(np.arange(d, dtype=np.int64), widths)
        self.pos_of_bin = torch.as_tensor(
            (np.arange(TB) + feat_of // K).astype(np.int32), device=device)
        self._launch: Dict[int, Tuple[int, int]] = {}

    def launch(self, C: int) -> Tuple[int, int, int]:
        """(slot tile, ring stages, histogram copies) for ``C`` slots: the
        fewest slot tiles whose histogram fits the budget left by a
        two-stage ring, balanced; then as many copies of the tile as that
        budget holds (one per consumer warp at most), so that warps add
        into copies of their own; then as many stages (up to MAX_STAGES)
        as the rest holds. More than one slot tile buckets the rows by
        tile before the launch."""
        got = self._launch.get(C)
        if got is None:
            tile = 4 * self.S * self.w_max
            c_tile = max(1, min(C, self.hist_budget // tile))
            n_ct = -(-C // c_tile)
            c_tile = -(-C // n_ct)
            tile *= c_tile
            copies = max(1, min(CONSUMERS // 32, self.hist_budget // tile))
            free = SMEM_BLOCK - BARRIER_BYTES - copies * tile
            stages = min(MAX_STAGES, free // self.stage_bytes)
            got = self._launch[C] = (c_tile, stages, copies)
        return got

    def stat_blocks(self) -> List[Tuple[int, int, "HistPlan"]]:
        """(first, last + 1, plan) of each block of at most MAX_STATS
        statistics the kernel takes in one launch: S split into
        ceil(S / MAX_STATS) blocks of balanced widths (S = 7: 4 + 3), each
        block with its own plan over the same design."""
        k = -(-self.S // MAX_STATS)
        cuts = [-(-i * self.S // k) for i in range(k + 1)]
        out = []
        for a, b in zip(cuts[:-1], cuts[1:]):
            w = b - a
            if w == self.S:
                out.append((a, b, self))
                continue
            sub = self._blocks.get(w)
            if sub is None:
                sub = self._blocks[w] = HistPlan(self.widths, w, self.device)
            out.append((a, b, sub))
        return out

    def smem_bytes(self, C: int) -> int:
        """Dynamic shared memory of one block at ``C`` slots."""
        c_tile, stages, copies = self.launch(C)
        return (BARRIER_BYTES + stages * self.stage_bytes
                + copies * c_tile * self.w_max * self.S * 4)


def _packed(ids: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(n, d) int64 packed bin ids: offsets[f] + the local id."""
    local = ids[:, :offsets.shape[0]].long()
    if ids.dtype == torch.int16:                 # uint16 bit patterns
        local = local & 0xFFFF
    return local + offsets.long()


def level_hist_plain(ids: torch.Tensor, offsets: torch.Tensor,
                     slot: torch.Tensor, stats: torch.Tensor, num_slots: int,
                     total_bins: int) -> torch.Tensor:
    """Plain PyTorch K1: the packed ids rebuilt as offsets + local ids,
    then one ``index_add_`` over the segment ids slot * TB + packed, rows
    outside [0, C) parked on a dropped segment. Sums in row order on the
    CPU, as the JAX package's scatter does."""
    packed = _packed(ids, offsets)
    n, d = packed.shape
    S = stats.shape[1]
    C, TB = int(num_slots), int(total_bins)
    keep = (slot >= 0) & (slot < C)
    seg = torch.where(keep[:, None], slot.long()[:, None] * TB + packed,
                      C * TB)
    out = torch.zeros((C * TB + 1, S), dtype=stats.dtype,
                      device=stats.device)
    index_add_rows(out, seg.reshape(-1),
                   stats[:, None, :].expand(n, d, S).reshape(n * d, S))
    return out[:C * TB].view(C, TB, S)


def index_add_rows(out: torch.Tensor, index: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """``out.index_add_(0, index, src)`` with each index's rows added one
    after another in row order, the CPU's order, into an ``out`` of
    zeros. A float64 sum on a card (the float64 tree witness, which must
    grow the CPU's trees) runs under torch's deterministic algorithms:
    their ``index_add_`` sorts the indices stably and adds each index's
    rows in turn (measured on an H100: equal to the CPU bit for bit), but
    for rows of one value, which a warp reduces in another order; those
    are summed as rows of two, the second zero. The atomics of the
    default kernel add in no fixed order. Other sums are the plain
    ``index_add_``."""
    if out.device.type != "cuda" or out.dtype != torch.float64:
        return out.index_add_(0, index, src)
    narrow = src[0].numel() == 1 if src.shape[0] else False
    acc = (torch.zeros((out.shape[0], 2), dtype=out.dtype, device=out.device)
           if narrow else out)
    rows = (torch.stack([src.reshape(-1), torch.zeros_like(src.reshape(-1))],
                        dim=1) if narrow else src)
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        acc.index_add_(0, index, rows)
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
    if narrow:
        out.add_(acc[:, 0].reshape(out.shape))
    return out


def _lib():
    from .._build import load
    lib = load("level_hist")
    fn = lib.tx_level_hist
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 13 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(ids, offsets, slot, stats, S):
    dev = ids.device
    if any(t.device != dev for t in (offsets, slot, stats)):
        raise ValueError("ids, offsets, slot and stats must share one device")
    if ids.dim() != 2 or ids.dtype not in (torch.uint8, torch.int16):
        raise ValueError("ids must be an (n, stride) uint8 or int16 "
                         "(uint16 bits) tensor")
    n = ids.shape[0]
    d = offsets.shape[0]
    if offsets.shape != (d,) or offsets.dtype != torch.int32:
        raise ValueError("offsets must be a (d,) int32 tensor")
    if ids.shape[1] != padded_stride(d, ids.element_size()):
        raise ValueError("ids must have the padded stride of d features")
    if slot.shape != (n,) or slot.dtype != torch.int32:
        raise ValueError("slot must be an (n,) int32 tensor")
    if stats.dim() != 2 or stats.shape[0] != n:
        raise ValueError("stats must be an (n, S) tensor")
    if not 1 <= S <= MAX_STATS:
        raise ValueError(f"the kernel takes 1..{MAX_STATS} statistics")
    if stats.dtype != torch.float32:
        raise ValueError("the CUDA kernel takes float32 stats")
    for t in (ids, offsets, slot, stats):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("ids, offsets, slot and stats must be "
                             "contiguous and 16-byte aligned")


def level_hist(ids: torch.Tensor, offsets: torch.Tensor, slot: torch.Tensor,
               stats: torch.Tensor, num_slots: int, total_bins: int,
               plan: Optional[HistPlan] = None) -> torch.Tensor:
    """(num_slots, total_bins, S) histograms.

    ``ids`` (n, stride) compact bin ids and ``offsets`` (d,) int32 of
    :func:`compact_ids`, ``slot`` (n,) int32, ``stats`` (n, S) float32 on a
    CUDA device launch K1 (``level_hist.launches`` counts the launches,
    ``level_hist.launches_by_c`` them by slot count); tensors on the CPU
    take :func:`level_hist_plain`. ``plan`` is the design's
    :class:`HistPlan` for S statistics (the CPU path ignores it). More
    than MAX_STATS statistics launch once per block of
    :meth:`HistPlan.stat_blocks`, the blocks concatenated along S."""
    if ids.device.type == "cpu":
        return level_hist_plain(ids, offsets, slot, stats, num_slots,
                                total_bins)
    if ids.device.type != "cuda":
        raise ValueError(f"level_hist runs on CUDA or the CPU, not "
                         f"{ids.device}")
    n = ids.shape[0]
    d = offsets.shape[0] if offsets.dim() == 1 else 0
    S = stats.shape[1] if stats.dim() == 2 else 0
    if S > MAX_STATS and plan is not None and plan.S == S:
        # one launch per block of at most MAX_STATS statistics over the
        # same ids and slots (a K-class forest with K > 4)
        return torch.cat([
            level_hist(ids, offsets, slot, stats[:, a:b].contiguous(),
                       num_slots, total_bins, sub)
            for a, b, sub in plan.stat_blocks()], dim=2)
    _check(ids, offsets, slot, stats, S)
    C, TB = int(num_slots), int(total_bins)
    out = torch.zeros((C, TB, S), dtype=torch.float32, device=ids.device)
    if n == 0 or d == 0:
        return out
    if plan is None or (plan.S, plan.d, plan.total_bins, plan.id_bytes) != (
            S, d, TB, ids.element_size()):
        raise ValueError("a CUDA launch needs the HistPlan of this design "
                         "and S")
    c_tile, stages, copies = plan.launch(C)
    perm = work = None
    n_ct = -(-C // c_tile)
    if n_ct > 1:                       # rows bucketed by slot tile
        perm = torch.empty(n, dtype=torch.int32, device=ids.device)
        work = torch.zeros(2 * n_ct, dtype=torch.int32, device=ids.device)
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    err = _lib()(ids.data_ptr(), slot.data_ptr(), stats.data_ptr(),
                 offsets.data_ptr(), plan.pos_of_bin.data_ptr(),
                 plan.groups.data_ptr(),
                 None if perm is None else perm.data_ptr(),
                 None if work is None else work.data_ptr(), out.data_ptr(),
                 n, d, plan.stride * plan.id_bytes, plan.id_bytes, S, C, TB,
                 plan.n_groups, c_tile, plan.w_max, copies, stages,
                 plan.rows, CONSUMERS, stream)
    if err != 0:
        raise RuntimeError(f"level_hist kernel launch failed: CUDA error "
                           f"{err}")
    level_hist.launches += 1
    level_hist.launches_by_c[C] += 1
    return out


level_hist.launches = 0
level_hist.launches_by_c = collections.Counter()
