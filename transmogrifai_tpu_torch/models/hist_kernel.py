"""K1: the per-level split histogram of the tree builder.

Counterpart of ``transmogrifai_tpu/models/pallas_hist.py``
(``pallas_level_hist``, the repository's one Pallas TPU kernel). The TPU
kernel contracts a dense (n, TB) 0/1 bin indicator on the MXU; the port
reads the packed (n, d) bin ids directly and scatter-adds into
shared-memory histograms, a hand-written CUDA kernel for Hopper
(``csrc/level_hist.cu``, where its design and bound are set out). Both
compute

    hist[c, b, s] = sum_r [slot_r == c] * stats[r, s] * bin_oh[r, b]
    with bin_oh[r, b] = [packed[r, feat_of[b]] == b],

and rows whose slot lies outside [0, C) or whose stats are zero add
nothing.

:func:`level_hist` launches the kernel for CUDA tensors and takes the plain
version, :func:`level_hist_plain`, only for tensors on the CPU. Bound of
one call (memory): bytes = 4*n*d + 4*n + 4*n*S + 4*C*TB*S, about 0.41 GB
at n = 1M, d = 100, S = 2, C = 256, TB = 800 — 0.12 ms at 3.35 TB/s.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["HistPlan", "level_hist", "level_hist_plain", "hist_bytes"]

#: dynamic shared memory of one block (bytes): two blocks fit on an SM
SMEM_BUDGET = 96 * 1024
#: the kernel keeps a row's statistics in registers
MAX_STATS = 4
#: rows below which a row chunk is not worth a block of its own
_MIN_CHUNK_ROWS = 1024


def hist_bytes(n: int, d: int, S: int, C: int, TB: int,
               n_slotted: Optional[int] = None,
               n_live: Optional[int] = None) -> int:
    """Bytes one call must move: every slot read once, the stats of the
    ``n_slotted`` rows whose slot lies in [0, C) read once, the bin ids of
    the ``n_live`` of those whose stats are not all zero read once, the
    output written once. Both counts default to every row."""
    n_slotted = n if n_slotted is None else n_slotted
    n_live = n_slotted if n_live is None else n_live
    return 4 * n + 4 * n_slotted * S + 4 * n_live * d + 4 * C * TB * S


class HistPlan:
    """Feature groups of one packed design: contiguous runs of whole
    features whose packed-bin range fits one block's shared memory at one
    slot. ``groups`` is None for a single group (every feature, every
    bin) or a (G, 4) int32 device tensor of (f_lo, f_hi, b_lo, b_hi)."""

    __slots__ = ("groups", "n_groups", "w_max")

    def __init__(self, widths: Sequence[int], S: int,
                 device: torch.device):
        cap = SMEM_BUDGET // (4 * S)
        rows, f_lo, b_lo, f, b = [], 0, 0, 0, 0
        for w in (int(x) for x in widths):
            if w > cap:
                raise ValueError(f"a feature with {w} bins does not fit "
                                 f"the histogram kernel's shared memory")
            if b + w - b_lo > cap:
                rows.append((f_lo, f, b_lo, b))
                f_lo, b_lo = f, b
            f, b = f + 1, b + w
        rows.append((f_lo, f, b_lo, b))
        self.n_groups = len(rows)
        self.w_max = max(r[3] - r[2] for r in rows)
        self.groups = (None if self.n_groups == 1 else torch.as_tensor(
            np.asarray(rows, dtype=np.int32), device=device))


def level_hist_plain(packed: torch.Tensor, slot: torch.Tensor,
                     stats: torch.Tensor, num_slots: int,
                     total_bins: int) -> torch.Tensor:
    """Plain PyTorch K1: one ``index_add_`` over the segment ids
    slot * TB + packed, rows outside [0, C) parked on a dropped segment.
    Sums in row order on the CPU, as the JAX package's scatter does."""
    n, d = packed.shape
    S = stats.shape[1]
    C, TB = int(num_slots), int(total_bins)
    keep = (slot >= 0) & (slot < C)
    seg = torch.where(keep[:, None], slot.long()[:, None] * TB + packed.long(),
                      C * TB)
    out = torch.zeros((C * TB + 1, S), dtype=stats.dtype,
                      device=stats.device)
    out.index_add_(0, seg.reshape(-1),
                   stats[:, None, :].expand(n, d, S).reshape(n * d, S))
    return out[:C * TB].view(C, TB, S)


def _lib():
    from .._build import load
    lib = load("level_hist")
    fn = lib.tx_level_hist
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(packed, slot, stats, S):
    dev = packed.device
    if slot.device != dev or stats.device != dev:
        raise ValueError("packed, slot and stats must share one device")
    if packed.dim() != 2 or packed.dtype != torch.int32:
        raise ValueError("packed must be an (n, d) int32 tensor")
    n = packed.shape[0]
    if slot.shape != (n,) or slot.dtype != torch.int32:
        raise ValueError("slot must be an (n,) int32 tensor")
    if stats.dim() != 2 or stats.shape[0] != n:
        raise ValueError("stats must be an (n, S) tensor")
    if not 1 <= S <= MAX_STATS:
        raise ValueError(f"the kernel takes 1..{MAX_STATS} statistics")
    if stats.dtype != torch.float32:
        raise ValueError("the CUDA kernel takes float32 stats")
    if not (packed.is_contiguous() and slot.is_contiguous()
            and stats.is_contiguous()):
        raise ValueError("packed, slot and stats must be contiguous")


def level_hist(packed: torch.Tensor, slot: torch.Tensor,
               stats: torch.Tensor, num_slots: int, total_bins: int,
               plan: Optional[HistPlan] = None) -> torch.Tensor:
    """(num_slots, total_bins, S) histograms.

    ``packed`` (n, d) int32 packed bin ids, ``slot`` (n,) int32, ``stats``
    (n, S) float32 on a CUDA device launch K1 (``level_hist.launches``
    counts the launches); tensors on the CPU take :func:`level_hist_plain`.
    ``plan`` splits a design whose bins do not fit one block; None is one
    group of all ``total_bins`` bins, ``HistPlan([total_bins], S, ...)``."""
    if packed.device.type == "cpu":
        return level_hist_plain(packed, slot, stats, num_slots, total_bins)
    if packed.device.type != "cuda":
        raise ValueError(f"level_hist runs on CUDA or the CPU, not "
                         f"{packed.device}")
    n, d = packed.shape
    S = stats.shape[1] if stats.dim() == 2 else 0
    _check(packed, slot, stats, S)
    C, TB = int(num_slots), int(total_bins)
    out = torch.zeros((C, TB, S), dtype=torch.float32, device=packed.device)
    if n == 0 or d == 0:
        return out
    if plan is None:
        plan = HistPlan([TB], S, packed.device)
    c_tile = max(1, min(C, SMEM_BUDGET // (4 * S * plan.w_max)))
    blocks = -(-C // c_tile) * plan.n_groups
    sms = torch.cuda.get_device_properties(packed.device).multi_processor_count
    row_chunks = max(1, min(-(-n // _MIN_CHUNK_ROWS),
                            -(-4 * sms // blocks)))
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = _lib()(packed.data_ptr(), slot.data_ptr(), stats.data_ptr(),
                 out.data_ptr(),
                 None if plan.groups is None else plan.groups.data_ptr(),
                 n, d, S, C, TB, plan.n_groups, c_tile, plan.w_max,
                 row_chunks, stream)
    if err != 0:
        raise RuntimeError(f"level_hist kernel launch failed: CUDA error "
                           f"{err}")
    level_hist.launches += 1
    return out


level_hist.launches = 0
