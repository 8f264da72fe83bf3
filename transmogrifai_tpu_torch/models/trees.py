"""Gradient-boosted binary trees in PyTorch (the GBT slice of the port).

Counterpart of ``transmogrifai_tpu/models/trees.py`` restricted to the
binary GBT family on the logistic objective: packed binning
(``_PackedDesign``), the level-wise builder (``_grow_tree``) with
active-node slot compression, boosting (``_gbt_body``), traversal, the
estimator and its model, and the fold x grid search that fits every
(fold, grid point) candidate and scores it with the on-device metric.

Where the JAX package jit-compiles and vmaps, the port runs eagerly:

- the level loop issues a fixed sequence of tensor ops and never reads a
  value back to the host (no ``.item()``, no Python branch on a tensor),
  so the host only enqueues work;
- the per-level histogram is kernel K1 (``models/hist_kernel.py``) on
  CUDA and its plain ``index_add_`` version on the CPU, both over the
  design's compact bin ids;
- the fold x grid candidates run one after another (the vmap becomes a
  Python loop); only the (folds, grid) metric matrix reaches the host.

Numbers: float32 on CUDA, float64 on the CPU (``utils/device.py``). The
row subsample draws from a ``torch.Generator`` seeded with ``seed``; at the
default ``subsample=1.0`` it draws nothing, so trees equal the JAX
package's exactly in float64.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device, working_dtype
from .base import ClassifierModel, Predictor, subset_grid
from .hist_kernel import HistPlan, compact_ids, level_hist

__all__ = ["GBTClassifier", "GBTClassifierModel", "clear_design_cache"]

#: matrix element count (rows x features) from which a design on CUDA
#: is binned on the card (f32 sorts) instead of by the exact f64 host
#: loop (the JAX package's threshold, ``trees.py:94``)
_DEVICE_BIN_MIN_ELEMS = 4_000_000
#: node id of an unused compressed slot
_SLOT_SENTINEL = 2 ** 31 - 1
#: default per-level active-node slot cap
_DEFAULT_NODE_CAP = 256


# ---------------------------------------------------------------------------
# binning — packed variable-width bins
# ---------------------------------------------------------------------------

class _PackedDesign:
    """Binning of a feature matrix on ``device``.

    Attributes (n rows, d features, TB = sum of per-feature bin counts):
      packed      (n, d) int32 — packed bin id of row i, feature f
                  (feature f's block spans [offset_f, offset_f + B_f));
                  row routing reads it
      ids         (n, stride) uint8 (int16 holding uint16 bits when a
                  feature has more than 256 bins) — the local bin
                  packed - offset_f, rows padded to 16 bytes; K1 reads it
      offsets     (d,) int32 — offset_f
      feat_of     (TB,) int64 — feature id of each packed bin
      prev_bin    (TB,) int64 — packed index before the owning block's
                  start (clamped at 0); ``has_prev`` says if there is one
      packed_thr  (TB,) working dtype — split threshold "x <= thr" at this
                  bin; +inf marks last and padded bins (not a split)
    Binning runs on the card (f32 column sorts, quantile gathers,
    ``searchsorted``) for a CUDA design of >= _DEVICE_BIN_MIN_ELEMS
    elements, else as the exact f64 numpy loop.
    """

    __slots__ = ("packed", "ids", "offsets", "feat_of", "prev_bin", "has_prev", "packed_thr",
                 "not_a_split", "widths", "n", "d", "total_bins", "device",
                 "dtype", "_plans")

    def __init__(self, X, max_bins: int, device: torch.device):
        n, d = X.shape
        if device.type == "cuda" and n * d >= _DEVICE_BIN_MIN_ELEMS:
            thr_parts, widths, binned = self._bin_device(
                torch.as_tensor(X, dtype=torch.float32, device=device),
                max_bins)
        else:
            thr_parts, widths, binned = self._bin_host(_to_numpy(X),
                                                       max_bins)
            binned = torch.as_tensor(binned, device=device)
        widths = np.asarray(widths, dtype=np.int64)
        self.ids, self.offsets = compact_ids(binned, widths)
        offsets = self.offsets.cpu().numpy()
        block_start = np.repeat(offsets, widths).astype(np.int64)
        self.n, self.d = n, d
        self.device = device
        self.dtype = working_dtype(device)
        self.total_bins = int(np.sum(widths))
        self.widths = widths
        self.packed = (binned + self.offsets).to(torch.int32).contiguous()
        self.feat_of = torch.as_tensor(
            np.repeat(np.arange(d, dtype=np.int64), widths), device=device)
        self.prev_bin = torch.as_tensor(np.maximum(block_start - 1, 0),
                                        device=device)
        self.has_prev = torch.as_tensor(block_start > 0, device=device)
        self.packed_thr = torch.as_tensor(np.concatenate(thr_parts),
                                          dtype=self.dtype, device=device)
        self.not_a_split = ~torch.isfinite(self.packed_thr)
        self._plans: Dict[int, HistPlan] = {}

    def hist_plan(self, S: int) -> HistPlan:
        """K1's feature groups for ``S`` statistics (made once)."""
        plan = self._plans.get(S)
        if plan is None:
            plan = self._plans[S] = HistPlan(self.widths, S, self.device)
        return plan

    @staticmethod
    def _bin_host(X: np.ndarray, max_bins: int):
        """Exact f64 per-feature binning (the reference semantics)."""
        X = np.asarray(X, dtype=np.float64)
        binned_cols, thr_parts, widths = [], [], []
        for f in range(X.shape[1]):
            col = X[:, f]
            uniq = np.unique(col)
            if uniq.size <= 2:
                edges = uniq[:1]                     # one edge, two bins
                width = 2
            else:
                width = int(min(max_bins,
                                1 << int(np.ceil(np.log2(uniq.size)))))
                width = max(width, 4)
                qs = np.linspace(0.0, 1.0, width + 1)[1:-1]
                edges = np.unique(np.quantile(col, qs))
                if edges.size < width - 1:           # dedup left empty bins
                    edges = np.concatenate(
                        [edges, np.full(width - 1 - edges.size, np.inf)])
            binned_cols.append(
                np.searchsorted(edges, X[:, f],
                                side="left").astype(np.int32))
            thr_parts.append(np.concatenate([edges, [np.inf]]))
            widths.append(width)
        return thr_parts, widths, np.stack(binned_cols, axis=1)

    @staticmethod
    def _bin_device(Xd: torch.Tensor, max_bins: int):
        """f32 binning on Xd's device: one column sort with unique counts,
        one quantile-interpolation gather, one ``searchsorted`` — the
        width/edge/dedup semantics of _bin_host, with only (d,)-shaped
        metadata crossing to the host."""
        Xd = Xd.to(torch.float32)
        m, d = Xd.shape
        s = torch.sort(Xd, dim=0).values
        uniq = (1 + (s[1:] != s[:-1]).sum(0)).cpu().numpy()
        widths = np.where(
            uniq <= 2, 2,
            np.clip(np.exp2(np.ceil(np.log2(np.maximum(uniq, 2)))),
                    4, max_bins)).astype(np.int64)
        maxw = int(widths.max())
        # interior quantile positions (host f64 math on (d, maxw-1)
        # metadata; only the value gather runs in f32)
        j = np.arange(max(maxw - 1, 1))
        q = (j[None, :] + 1) / widths[:, None].astype(np.float64)
        h = np.clip(q, 0.0, 1.0) * (m - 1)
        lo = np.floor(h).astype(np.int64)
        sT = s.T
        lo_t = torch.as_tensor(lo, device=Xd.device)
        frac = torch.as_tensor((h - lo).astype(np.float32), device=Xd.device)
        vlo = torch.gather(sT, 1, lo_t)
        vhi = torch.gather(sT, 1, torch.clamp(lo_t + 1, max=m - 1))
        edges = (vlo + frac * (vhi - vlo)).cpu().numpy().astype(np.float64)
        colmin = s[0].cpu().numpy().astype(np.float64)
        thr_parts: List[np.ndarray] = []
        for f in range(d):
            w = int(widths[f])
            if uniq[f] <= 2:
                e = colmin[f:f + 1]
            else:
                e = np.unique(edges[f, :w - 1])
                if e.size < w - 1:                   # dedup left empty bins
                    e = np.concatenate(
                        [e, np.full(w - 1 - e.size, np.inf)])
            thr_parts.append(np.concatenate([e, [np.inf]]))
        col_edges = np.full((d, maxw), np.inf)
        for f in range(d):
            t = thr_parts[f][:-1]                    # real edges only
            col_edges[f, :len(t)] = t
        # bin = count of the feature's edges strictly below x
        binned = torch.searchsorted(
            torch.as_tensor(col_edges, dtype=torch.float32,
                            device=Xd.device),
            Xd.T.contiguous(), side="left", out_int32=True).T
        return thr_parts, list(widths), binned


def _to_numpy(X) -> np.ndarray:
    if isinstance(X, torch.Tensor):
        return X.detach().cpu().numpy()
    return np.asarray(X)


class _DesignCache:
    """Binning memo: the validator hands one prepared matrix to every
    static group of the search and to the winner's refit, so one binning
    serves them all. Strong references to the keyed arrays keep their
    ids valid while cached."""

    def __init__(self, size: int = 4):
        self.size = size
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()

    def get(self, X, max_bins: int, device: torch.device) -> _PackedDesign:
        key = (id(X), tuple(X.shape), max_bins, str(device))
        hit = self._entries.get(key)
        if hit is not None and hit[0] is X:
            self._entries.move_to_end(key)
            return hit[1]
        design = _PackedDesign(X, max_bins, device)
        self._entries[key] = (X, design)
        while len(self._entries) > self.size:
            self._entries.popitem(last=False)
        return design

    def clear(self) -> None:
        self._entries.clear()


_DESIGNS = _DesignCache()


def clear_design_cache() -> None:
    """Drop every memoized design and the device buffers it holds."""
    _DESIGNS.clear()


def _design_args(X, max_bins: int, device: torch.device) -> _PackedDesign:
    return _DESIGNS.get(X, max_bins, device)


# ---------------------------------------------------------------------------
# level-wise tree builder
# ---------------------------------------------------------------------------

def _compress_nodes(node: torch.Tensor, cap: int):
    """Rank-compress node ids (n,) into dense slots [0, cap): a stable
    sort, then the rank of each distinct id. Returns (slot per row (n,),
    node id of each slot (cap,) int32 with _SLOT_SENTINEL for unused
    slots, active slot count as a 0-d tensor)."""
    n = node.shape[0]
    snode, order = torch.sort(node, stable=True)
    is_new = torch.ones(n, dtype=torch.int32, device=node.device)
    is_new[1:] = (snode[1:] != snode[:-1]).to(torch.int32)
    rank = torch.cumsum(is_new, 0, dtype=torch.int32) - 1
    slot = torch.empty_like(node)
    slot[order] = rank.to(node.dtype)
    # ranks past the cap land on a dropped extra entry
    node_of_slot = torch.full((cap + 1,), _SLOT_SENTINEL, dtype=torch.int32,
                              device=node.device)
    node_of_slot.scatter_(0, torch.clamp(rank, max=cap).long(),
                          snode.to(torch.int32))
    return slot, node_of_slot[:cap], rank[-1] + 1


def _level_histograms(design: _PackedDesign, slot: torch.Tensor,
                      stats: torch.Tensor, num_slots: int) -> torch.Tensor:
    """(num_slots, TB, S) histograms: K1 on CUDA, its plain version on
    the CPU (``level_hist`` decides by the tensors' device)."""
    return level_hist(design.ids, design.offsets, slot, stats, num_slots,
                      design.total_bins, design.hist_plan(stats.shape[1]))


#: block width of the running sum over packed bins (see _bin_cumsum)
_SCAN_BLOCK = 16


def _bin_cumsum(hist: torch.Tensor) -> torch.Tensor:
    """Running sum of (C, TB, S) histograms along the packed-bin axis, in
    blocks of 16: a sequential sum inside each block plus the running sum
    of the block totals before it (itself taken the same way). That is
    the summation order of the JAX package's ``jnp.cumsum`` on XLA's CPU
    backend, so float64 gains, and the split chosen among mathematically
    tied candidates, match the reference bit for bit."""
    C, L, S = hist.shape
    if L <= _SCAN_BLOCK:
        return torch.cumsum(hist, dim=1)
    pad = (-L) % _SCAN_BLOCK
    blocks = torch.cat([hist, hist.new_zeros((C, pad, S))], dim=1
                       ).view(C, -1, _SCAN_BLOCK, S)
    inner = torch.cumsum(blocks, dim=2)
    before = _bin_cumsum(inner[:, :, -1, :])[:, :-1]
    carry = torch.cat([hist.new_zeros((C, 1, S)), before], dim=1)
    return (inner + carry[:, :, None, :]).reshape(C, -1, S)[:, :L]


def _xgb_gain(left, right, total, reg_lambda: float, gamma: float,
              min_child_weight: float):
    """Second-order gain (stats = [grad, hess]); XGBoost objective, -inf
    where a child is lighter than ``min_child_weight``."""
    def score(s):
        return s[..., 0] ** 2 / (s[..., 1] + reg_lambda)
    g = 0.5 * (score(left) + score(right) - score(total)) - gamma
    ok = ((left[..., 1] >= min_child_weight)
          & (right[..., 1] >= min_child_weight))
    return torch.where(ok, g, -torch.inf)


def _grow_tree(design: _PackedDesign, stats: torch.Tensor, *, depth: int,
               reg_lambda: float, gamma: float, min_child_weight: float,
               node_cap: int = _DEFAULT_NODE_CAP):
    """Grow one complete tree of static ``depth`` (see _PackedDesign).

    Levels whose node ids all fit the slot cap use the ids as slots (the
    identity path: no sort); deeper levels rank-compress the occupied
    nodes into at most ``cap`` slots and deny splits beyond the next
    level's budget (the budget mask). A split needs a gain of at least
    1e-12. A denied split writes (0, +inf) and routes every row left.

    Returns (feat_heap (2^depth - 1,) int32, thr_heap (2^depth - 1,),
    leaf_stats (2^depth, S), final node id per row (n,) int32).
    """
    packed = design.packed
    dev = packed.device
    n = packed.shape[0]
    TB = design.total_bins
    S = stats.shape[1]
    cap = min(n, node_cap)
    H = 2 ** depth - 1
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    # one extra entry at index H takes the writes of unused slots
    feat_heap = torch.zeros(H + 1, dtype=torch.int32, device=dev)
    thr_heap = torch.full((H + 1,), torch.inf, dtype=stats.dtype, device=dev)
    stats = stats.contiguous()
    aug_rows = torch.cat(
        [stats, torch.ones((n, 1), dtype=stats.dtype, device=dev)], dim=1)
    for level in range(depth):
        # identity path while every node id fits the cap and the next
        # level's budget mask cannot bind
        identity = 2 ** level <= cap and (
            level + 1 == depth or 2 ** (level + 1) <= cap)
        if identity:
            C = 2 ** level
            slot = node
            node_of_slot = torch.arange(C, dtype=torch.int32, device=dev)
        else:
            C = min(2 ** level, cap)
            slot, node_of_slot, active = _compress_nodes(node, C)
        slot_l = slot.long()
        hist = _level_histograms(design, slot, stats, C)
        cs = _bin_cumsum(hist)                     # packed-axis running sum
        # per-feature segmented cumsum: subtract the running sum before
        # the owning block's start; splitting at bin b sends bins <= b left
        left = cs - torch.where(design.has_prev[None, :, None],
                                cs[:, design.prev_bin, :], 0.0)
        if identity:
            # identity slots include empty nodes: count rows per slot
            # (an extra ones column) and keep empty slots from splitting
            aug = torch.zeros((C, S + 1), dtype=stats.dtype, device=dev
                              ).index_add_(0, slot_l, aug_rows)
            total = aug[:, None, :-1]
            nonempty = aug[:, -1] > 0
        else:
            total = torch.zeros((C, S), dtype=stats.dtype, device=dev
                                ).index_add_(0, slot_l, stats)[:, None, :]
        gain = _xgb_gain(left, total - left, total, reg_lambda, gamma,
                         min_child_weight)
        gain = torch.where(design.not_a_split[None, :], -torch.inf, gain)
        best = torch.argmax(gain, dim=1)           # first maximum, (C,)
        best_gain = torch.gather(gain, 1, best[:, None])[:, 0]
        split_ok = best_gain >= 1e-12
        if identity:
            split_ok &= nonempty
        elif level + 1 < depth:
            # budget mask: the next level holds at most min(2^(level+1),
            # cap) slots and each split adds one net node
            budget = min(2 ** (level + 1), cap)
            split_ok &= (torch.arange(C, device=dev) < (budget - active))
        bfeat = torch.where(split_ok, design.feat_of[best], 0)
        thr = torch.where(split_ok, design.packed_thr[best], torch.inf)
        heap_pos = torch.where(node_of_slot == _SLOT_SENTINEL, H,
                               2 ** level - 1 + node_of_slot).long()
        feat_heap[heap_pos] = bfeat.to(torch.int32)
        thr_heap[heap_pos] = thr.to(thr_heap.dtype)
        # route rows: bin <= best <=> go left; a denied split sends every
        # row left through the TB sentinel
        best_r = torch.where(split_ok, best, TB)
        row_bin = torch.gather(packed, 1, bfeat[slot_l][:, None])[:, 0]
        go_right = (row_bin > best_r[slot_l]).to(torch.int32)
        node = 2 * node + go_right                 # within-level index
    leaf_stats = torch.zeros((2 ** depth, S), dtype=stats.dtype, device=dev
                             ).index_add_(0, node.long(), stats)
    return feat_heap[:H], thr_heap[:H], leaf_stats, node


def _predict_leaves(X: torch.Tensor, feats: torch.Tensor,
                    thrs: torch.Tensor, depth: int) -> torch.Tensor:
    """(T, n) leaf index of every row in each of T trees; static-depth
    descent of all trees at once."""
    n = X.shape[0]
    rows = torch.arange(n, device=X.device)[None, :]
    feats = feats.long()
    node = torch.zeros((feats.shape[0], n), dtype=torch.long,
                       device=X.device)
    for level in range(depth):
        heap = 2 ** level - 1 + node           # levels concatenate in heap
        f = torch.gather(feats, 1, heap)
        t = torch.gather(thrs, 1, heap)
        # not(x <= t), so a NaN goes right as in the JAX package
        node = 2 * node + (~(X[rows, f] <= t)).long()
    return node


# ---------------------------------------------------------------------------
# boosting
# ---------------------------------------------------------------------------

def _gbt_body(design: _PackedDesign, y: torch.Tensor, mask: torch.Tensor,
              *, depth: int, num_rounds: int, step_size: float,
              reg_lambda: float, gamma: float, min_child_weight: float,
              subsample: float, seed: int):
    """Logistic boosting with row-mask semantics: masked rows get zero
    gradient and hessian; the base margin is the log-odds of the masked
    mean label. Returns (feats (R, H), thrs (R, H), leaves (R, L), base
    0-d tensor)."""
    n = design.n
    msum = torch.clamp(torch.sum(mask), min=1.0)
    mean_y = torch.sum(mask * y) / msum
    p0 = torch.clamp(mean_y, 1e-6, 1 - 1e-6)
    base = torch.log(p0 / (1 - p0))
    margins = base.expand(n)
    gen = None
    if subsample < 1.0:
        gen = torch.Generator(device=design.device)
        gen.manual_seed(int(seed))
    feats, thrs, leaves = [], [], []
    for _ in range(num_rounds):
        p = torch.sigmoid(margins)
        g = p - y
        h = torch.clamp(p * (1 - p), min=1e-12)
        m = mask
        if gen is not None:
            m = (torch.rand(n, generator=gen, device=design.device,
                            dtype=y.dtype) < subsample).to(y.dtype) * mask
        feat, thr, leaf_stats, node = _grow_tree(
            design, torch.stack([g * m, h * m], dim=1), depth=depth,
            reg_lambda=reg_lambda, gamma=gamma,
            min_child_weight=min_child_weight)
        vals = -step_size * leaf_stats[:, 0] / (leaf_stats[:, 1] + reg_lambda)
        vals = torch.where(torch.sum(torch.abs(leaf_stats), dim=1) > 0,
                           vals, 0.0)
        margins = margins + vals[node.long()]
        feats.append(feat)
        thrs.append(thr)
        leaves.append(vals)
    return torch.stack(feats), torch.stack(thrs), torch.stack(leaves), base


def _gbt_margins(X: torch.Tensor, feats, thrs, leaves, base, depth: int):
    """(n,) boosted margins: traversal, leaf gather, sum over trees."""
    leaf = _predict_leaves(X, feats, thrs, depth)
    return base + torch.sum(torch.gather(leaves, 1, leaf), dim=0)


def _on(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (tensor or array) as a tensor of ``dtype`` on ``device``;
    arrays are copied, so a read-only numpy buffer is never aliased."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


class GBTClassifierModel(ClassifierModel):
    """Boosted binary classifier: sigmoid over summed leaf margins. The
    trees live on ``device``; ``predict_arrays`` takes and returns numpy."""

    def __init__(self, feats, thrs, leaves, depth: int, base: float = 0.0,
                 n_features: int = 0, device="cuda",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device)
        self.feats = _on(feats, torch.int32, self.device)
        self.thrs = _on(thrs, self.dtype, self.device)
        self.leaves = _on(leaves, self.dtype, self.device)
        self.depth = int(depth)
        self.base = float(base)
        self.n_features = int(n_features)

    def margins(self, X) -> np.ndarray:
        Xt = torch.as_tensor(np.asarray(X), dtype=self.dtype,
                             device=self.device)
        m = _gbt_margins(Xt, self.feats, self.thrs, self.leaves, self.base,
                         self.depth)
        return m.cpu().numpy().astype(np.float64)

    def predict_raw(self, X) -> np.ndarray:
        m = self.margins(X)
        return np.stack([-m, m], axis=1)

    def raw_to_probability(self, raw: np.ndarray) -> np.ndarray:
        p = 1.0 / (1.0 + np.exp(-raw[:, 1]))
        return np.stack([1 - p, p], axis=1)


# ---------------------------------------------------------------------------
# fold x grid search
# ---------------------------------------------------------------------------

#: grid parameters that vary per candidate vs those that fix a shape group
_GBT_TRACED = ("step_size", "reg_lambda", "gamma", "min_child_weight",
               "subsample")
_GBT_SKEY = ("max_depth", "num_rounds", "max_bins", "seed")


def _check_binary(y) -> None:
    bad = np.setdiff1d(np.unique(y), [0.0, 1.0])
    if bad.size:
        raise ValueError(f"GBTClassifier supports binary labels {{0, 1}} "
                         f"only; got extra labels {bad.tolist()}")


def _candidate_groups(est, grid) -> List[List[Tuple[int, "GBTClassifier"]]]:
    """Grid points partitioned into static shape groups (depth, rounds,
    bins, seed), in first-seen order — the grouping of the JAX package's
    ``_candidate_groups`` with static depth."""
    groups: Dict[tuple, list] = {}
    for gi, p in enumerate(grid):
        cand = est.with_params(**p)
        key = tuple(getattr(cand, f) for f in _GBT_SKEY)
        groups.setdefault(key, []).append((gi, cand))
    return list(groups.values())


def _gbt_fold_grid(est: "GBTClassifier", X, y, masks, grid, X_val, y_val,
                   spec) -> np.ndarray:
    """(F, G) validation metrics of every (fold, grid point) candidate:
    each a masked fit on the whole prepared matrix (mask = the fold's
    train rows, bin edges from the whole matrix as in the JAX search),
    then the on-device metric on the fold's validation rows. Fold-major
    within each static group; only the matrix reaches the host."""
    from ..evaluators.device_metrics import binary_from_sigmoid, metric_fn
    grid = [dict(p) for p in (list(grid) or [{}])]
    allowed = set(_GBT_TRACED) | set(_GBT_SKEY)
    for p in grid:
        extra = set(p) - allowed
        if extra:
            raise NotImplementedError(
                f"the GBT search cannot vary {sorted(extra)}")
    dev, dtype = est.device, working_dtype(est.device)
    masks = np.asarray(masks, dtype=np.float64)
    F = masks.shape[0]
    mfn = metric_fn(*spec)
    y_t = torch.as_tensor(np.asarray(y), dtype=dtype, device=dev)
    masks_t = torch.as_tensor(masks, dtype=dtype, device=dev)
    Xv = torch.as_tensor(np.asarray(X_val), dtype=dtype, device=dev)
    yv = torch.as_tensor(np.asarray(y_val), dtype=dtype, device=dev)
    mm = torch.full((F, len(grid)), torch.nan, dtype=dtype, device=dev)
    for members in _candidate_groups(est, grid):
        design = _design_args(X, members[0][1].max_bins, dev)
        for f in range(F):
            for gi, cand in members:
                feats, thrs, leaves, base = _gbt_body(
                    design, y_t, masks_t[f], **cand._fit_kwargs())
                margin = _gbt_margins(Xv[f], feats, thrs, leaves, base,
                                      cand.max_depth)
                mm[f, gi] = mfn(yv[f], binary_from_sigmoid(margin))
    return mm.cpu().numpy().astype(np.float64)


class GBTClassifier(Predictor):
    """Gradient-boosted binary classifier with second-order (XGBoost-
    style) split gains on the logistic objective."""

    param_names = ("num_rounds", "max_depth", "step_size", "max_bins",
                   "reg_lambda", "gamma", "min_child_weight", "subsample",
                   "seed", "device")

    def __init__(self, num_rounds: int = 20, max_depth: int = 5,
                 step_size: float = 0.1, max_bins: int = 32,
                 reg_lambda: float = 1.0, gamma: float = 0.0,
                 min_child_weight: float = 1.0, subsample: float = 1.0,
                 seed: int = 42, device="cuda", uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.num_rounds = num_rounds
        self.max_depth = max_depth
        self.step_size = step_size
        self.max_bins = max_bins
        self.reg_lambda = reg_lambda
        self.gamma = gamma
        self.min_child_weight = min_child_weight
        self.subsample = subsample
        self.seed = seed
        self.device = resolve_device(device)

    def _fit_kwargs(self) -> dict:
        return dict(depth=int(self.max_depth),
                    num_rounds=int(self.num_rounds),
                    step_size=float(self.step_size),
                    reg_lambda=float(self.reg_lambda),
                    gamma=float(self.gamma),
                    min_child_weight=float(self.min_child_weight),
                    subsample=float(self.subsample), seed=int(self.seed))

    def eval_fold_grid_arrays(self, X, y, masks, grid, X_val, y_val, spec,
                              cand_idx=None) -> np.ndarray:
        """Device-resident search: fused fit + validation metric, (F, G)
        matrix out (see _gbt_fold_grid)."""
        if spec[0] != "binary":
            raise NotImplementedError(
                "GBT-classifier device eval is binary-only")
        _check_binary(y)
        return _gbt_fold_grid(self, X, y, masks, subset_grid(grid, cand_idx),
                              X_val, y_val, spec)

    def fit_arrays(self, X, y) -> GBTClassifierModel:
        _check_binary(y)
        design = _design_args(X, self.max_bins, self.device)
        y_t = torch.as_tensor(np.asarray(y), dtype=design.dtype,
                              device=self.device)
        feats, thrs, leaves, base = _gbt_body(
            design, y_t, torch.ones_like(y_t), **self._fit_kwargs())
        return GBTClassifierModel(feats, thrs, leaves, depth=self.max_depth,
                                  base=float(base), n_features=X.shape[1],
                                  device=self.device)
