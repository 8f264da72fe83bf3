"""Tree families in PyTorch: gradient-boosted trees, random forests and
decision trees, for binary and multiclass classification and regression.

Counterpart of ``transmogrifai_tpu/models/trees.py``: packed binning
(``_PackedDesign``), the level-wise builder (``_grow_tree``) with
active-node slot compression and per-node feature subsets, the gini,
entropy, variance and second-order gains, boosting on the logistic and
squared objectives (``_gbt_body``) and on the K-class softmax
(``_gbt_softmax_body``, XGBoost's ``multi:softprob``), bagged forests over
per-tree stratified feature pools (``_forest_trees``: K-class one-hot or
[w, wy, wyy] statistics), traversal, the estimators and their models
(with the XGBoost facades), and the fold x grid searches that fit every
(fold, grid point) candidate and either score it with the on-device
metric (``eval_fold_grid_arrays``) or return it as a model
(``fit_fold_grid_arrays``, the validator's host-metric path): one
search function a family (``_forest_fold_grid``, ``_gbt_fold_grid``) with
two sinks (``_FoldGridSink``). ``batch_predict_raw`` scores the fitted
models of a fold in one stacked traversal per static shape.
``TX_TREE_EDGES=fold`` takes each fold's bin edges from its train rows
(``_fold_edge_recurse``).
GBTClassifier stays binary, as in the JAX package.

Trees grow at their own static depth, so the JAX package's
``_trim_tree_arrays`` (which cuts a ``TX_TREE_DEPTH=mask`` group's
depth-cap trees back to a candidate's depth) has no counterpart here.

Where the JAX package jit-compiles and vmaps, the port runs eagerly:

- the level loop issues a fixed sequence of tensor ops and never reads a
  value back to the host (no ``.item()``, no Python branch on a tensor),
  so the host only enqueues work;
- the per-level histogram is kernel K1 (``models/hist_kernel.py``) on
  CUDA and its plain ``index_add_`` version on the CPU, both over the
  design's compact bin ids;
- the fold x grid candidates run one after another (the vmap becomes a
  Python loop); a forest's trees run one after another, each tree's
  pool and draws shared by every candidate of its static group; only the
  (folds, grid) metric matrix reaches the host.

Numbers: float32 on CUDA, float64 on the CPU (``utils/device.py``); a
float64 tree on a card (the smoke's witness) adds its histograms, totals
and leaf sums in row order as the CPU does (``index_add_rows``). Random
draws (feature pools, bootstrap weights, node feature subsets, the GBT
row subsample) come from a draws provider (``models/draws.py``); with one
that replays the JAX package's key chain, trees equal the JAX package's
exactly in float64. At the GBT default ``subsample=1.0`` nothing is drawn.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import ref_math
from ..utils.device import resolve_device, working_dtype
from .base import (ClassifierModel, Predictor, RegressionModel,
                   check_fold_classes, num_classes, subset_grid)
from .draws import TorchDraws
from .hist_kernel import (HistPlan, compact_ids, index_add_rows, level_hist,
                          padded_stride)

__all__ = ["DecisionTreeClassifier", "DecisionTreeRegressor",
           "GBTClassifier", "GBTClassifierModel",
           "GBTMulticlassClassifierModel", "GBTRegressor",
           "GBTRegressorModel", "RandomForestClassifier",
           "RandomForestRegressor", "TreeEnsembleClassifierModel",
           "TreeEnsembleRegressorModel", "XGBoostClassifier",
           "XGBoostRegressor", "batch_predict_raw", "clear_design_cache"]

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
      col_thr     (d, max width) working dtype — feature f's thresholds,
                  +inf padded (what a per-tree feature pool gathers)
    Binning runs on the card (f32 column sorts, quantile gathers,
    ``searchsorted``) for a CUDA design of >= _DEVICE_BIN_MIN_ELEMS
    elements, else as the exact f64 numpy loop.
    """

    __slots__ = ("packed", "ids", "offsets", "feat_of", "prev_bin",
                 "has_prev", "packed_thr", "col_thr", "not_a_split", "widths",
                 "n", "d", "total_bins", "device", "dtype", "_plans")

    def __init__(self, X, max_bins: int, device: torch.device,
                 edge_rows: Optional[np.ndarray] = None):
        """``edge_rows`` restricts the quantile edges to those rows (a
        fold's train rows under ``TX_TREE_EDGES=fold``) while every row of
        ``X`` is binned: held-out rows never move where a split can fall."""
        n, d = X.shape
        e_rows = n if edge_rows is None else len(edge_rows)
        if device.type == "cuda" and e_rows * d >= _DEVICE_BIN_MIN_ELEMS:
            thr_parts, widths, binned = self._bin_device(
                torch.as_tensor(X, dtype=torch.float32, device=device),
                max_bins, edge_rows)
        else:
            thr_parts, widths, binned = self._bin_host(_to_numpy(X),
                                                       max_bins, edge_rows)
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
        col_thr = np.full((d, int(widths.max())), np.inf)
        for f, t in enumerate(thr_parts):
            col_thr[f, :len(t)] = t
        self.col_thr = torch.as_tensor(col_thr, dtype=self.dtype,
                                       device=device)
        self.not_a_split = ~torch.isfinite(self.packed_thr)
        self._plans: Dict[int, HistPlan] = {}

    def row_bins(self, feat: torch.Tensor) -> torch.Tensor:
        """(n,) packed bin of each row at its feature ``feat`` (n,)."""
        return torch.gather(self.packed, 1, feat[:, None])[:, 0]

    def hist_plan(self, S: int) -> HistPlan:
        """K1's feature groups for ``S`` statistics (made once)."""
        plan = self._plans.get(S)
        if plan is None:
            plan = self._plans[S] = HistPlan(self.widths, S, self.device)
        return plan

    @staticmethod
    def _bin_host(X: np.ndarray, max_bins: int,
                  edge_rows: Optional[np.ndarray] = None):
        """Exact f64 per-feature binning (the reference semantics)."""
        X = np.asarray(X, dtype=np.float64)
        E = X if edge_rows is None else X[np.asarray(edge_rows)]
        binned_cols, thr_parts, widths = [], [], []
        for f in range(X.shape[1]):
            col = E[:, f]
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
    def _bin_device(Xd: torch.Tensor, max_bins: int,
                    edge_rows: Optional[np.ndarray] = None):
        """f32 binning on Xd's device: one column sort with unique counts,
        one quantile-interpolation gather, one ``searchsorted`` — the
        width/edge/dedup semantics of _bin_host, with only (d,)-shaped
        metadata crossing to the host."""
        Xd = Xd.to(torch.float32)
        Ed = Xd if edge_rows is None else Xd[torch.as_tensor(
            np.asarray(edge_rows), device=Xd.device)]
        m, d = Ed.shape
        s = torch.sort(Ed, dim=0).values
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

    def get(self, X, max_bins: int, device: torch.device,
            edge_rows: Optional[np.ndarray] = None) -> _PackedDesign:
        """The design of ``X`` whose edges come from ``edge_rows`` (all
        rows for None): the rows join the key, so one fold's design is
        never served to another fold."""
        key = (id(X), tuple(X.shape), max_bins, str(device),
               None if edge_rows is None else id(edge_rows))
        hit = self._entries.get(key)
        if hit is not None and hit[0] is X and hit[1] is edge_rows:
            self._entries.move_to_end(key)
            return hit[2]
        design = _PackedDesign(X, max_bins, device, edge_rows)
        self._entries[key] = (X, edge_rows, design)
        while len(self._entries) > self.size:
            self._entries.popitem(last=False)
        return design

    def clear(self) -> None:
        self._entries.clear()


_DESIGNS = _DesignCache()


def clear_design_cache() -> None:
    """Drop every memoized design and the device buffers it holds."""
    _DESIGNS.clear()


def _design_args(X, max_bins: int, device: torch.device,
                 edge_rows: Optional[np.ndarray] = None) -> _PackedDesign:
    return _DESIGNS.get(X, max_bins, device, edge_rows)


def _fold_edges_mode() -> bool:
    """Whether the fold x grid searches take each fold's bin edges from
    its train rows only (``TX_TREE_EDGES=fold``) instead of the whole
    prepared matrix (``"matrix"``, the default, as in the JAX package)."""
    return os.environ.get("TX_TREE_EDGES", "matrix") == "fold"


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


def _xgb_gain(reg_lambda: float, gamma: float, min_child_weight: float):
    """Second-order gain (stats = [grad, hess]); XGBoost objective, -inf
    where a child is lighter than ``min_child_weight``."""
    def score(s):
        return s[..., 0] ** 2 / (s[..., 1] + reg_lambda)

    def gain(left, right, total):
        g = 0.5 * (score(left) + score(right) - score(total)) - gamma
        ok = ((left[..., 1] >= min_child_weight)
              & (right[..., 1] >= min_child_weight))
        return torch.where(ok, g, -torch.inf)
    return gain


def _impurity_gain(impurity_weighted, min_instances: float):
    """Weighted impurity decrease over per-class weight statistics, -inf
    where a child weighs less than ``min_instances``."""
    def gain(left, right, total):
        wl = torch.sum(left, dim=-1)
        wr = torch.sum(right, dim=-1)
        wp = torch.clamp(torch.sum(total, dim=-1), min=1e-12)
        g = (impurity_weighted(total) - impurity_weighted(left)
             - impurity_weighted(right)) / wp
        ok = (wl >= min_instances) & (wr >= min_instances)
        return torch.where(ok, g, -torch.inf)
    return gain


def _gini_gain(min_instances: float):
    """MLlib 'gini': w - sum_c s_c^2 / w per node."""
    def impurity_weighted(s):
        w = torch.sum(s, dim=-1)
        return w - torch.sum(s * s, dim=-1) / torch.clamp(w, min=1e-12)
    return _impurity_gain(impurity_weighted, min_instances)


def _entropy_gain(min_instances: float):
    """MLlib 'entropy': w * -sum_c p_c log p_c per node."""
    def impurity_weighted(s):
        w = torch.clamp(torch.sum(s, dim=-1, keepdim=True), min=1e-12)
        p = s / w
        ent = -torch.sum(torch.where(s > 0, p * torch.log(p), 0.0), dim=-1)
        return w[..., 0] * ent
    return _impurity_gain(impurity_weighted, min_instances)


def _variance_gain(min_instances: float):
    """MLlib 'variance': the reduction of the sum of squared errors over
    statistics [w, wy, wyy], per unit of the parent's weight; -inf where a
    child weighs less than ``min_instances``."""
    def sse(s):
        return s[..., 2] - s[..., 1] ** 2 / torch.clamp(s[..., 0], min=1e-12)

    def gain(left, right, total):
        wp = torch.clamp(total[..., 0], min=1e-12)
        g = (sse(total) - sse(left) - sse(right)) / wp
        ok = ((left[..., 0] >= min_instances)
              & (right[..., 0] >= min_instances))
        return torch.where(ok, g, -torch.inf)
    return gain


def _grow_tree(design, stats: torch.Tensor, *, depth: int, gain_fn,
               min_info_gain: float = 0.0,
               max_features: Optional[int] = None,
               node_u: Optional[Callable[[int, Tuple[int, int]],
                                         torch.Tensor]] = None,
               feat_map: Optional[torch.Tensor] = None,
               node_cap: int = _DEFAULT_NODE_CAP):
    """Grow one complete tree of static ``depth`` over a binned design (a
    _PackedDesign or a tree's _PooledDesign).

    Levels whose node ids all fit the slot cap use the ids as slots (the
    identity path: no sort); deeper levels rank-compress the occupied
    nodes into at most ``cap`` slots and deny splits beyond the next
    level's budget (the budget mask). ``gain_fn(left, right, total)``
    scores every (slot, bin) split; a split needs a gain of at least
    max(min_info_gain, 1e-12). A denied split writes (0, +inf) and routes
    every row left.

    With ``max_features`` below the design's feature count, each node
    keeps the gains of the ``max_features`` features whose uniforms are
    smallest; ``node_u(level, shape)`` gives a level's uniforms, drawn
    per slot (C, d) at identity levels and at levels past 2^level > cap,
    and per node (2^level, d) at the compressed levels below, gathered by
    each slot's node. ``feat_map`` translates the design's feature ids to
    the heap's (a pooled design's pool).

    Returns (feat_heap (2^depth - 1,) int32, thr_heap (2^depth - 1,),
    leaf_stats (2^depth, S), final node id per row (n,) int32).
    """
    dev = design.device
    n = design.n
    TB = design.total_bins
    S = stats.shape[1]
    cap = min(n, node_cap)
    H = 2 ** depth - 1
    subset = max_features is not None and max_features < design.d
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
            aug = index_add_rows(torch.zeros((C, S + 1), dtype=stats.dtype,
                                             device=dev), slot_l, aug_rows)
            total = aug[:, None, :-1]
            nonempty = aug[:, -1] > 0
        else:
            total = index_add_rows(
                torch.zeros((C, S), dtype=stats.dtype, device=dev), slot_l,
                stats)[:, None, :]
        gain = gain_fn(left, total - left, total)
        gain = torch.where(design.not_a_split[None, :], -torch.inf, gain)
        if subset:
            if identity or 2 ** level > cap:
                u = node_u(level, (C, design.d))
            else:
                # node-keyed: a sentinel slot clamps onto the last node's
                # row; its outputs never reach the heap or the routing
                u = node_u(level, (2 ** level, design.d))[
                    torch.clamp(node_of_slot, 0, 2 ** level - 1).long()]
            kth = torch.sort(u, dim=1).values[:, max_features - 1:
                                              max_features]
            gain = torch.where((u <= kth)[:, design.feat_of], gain,
                               -torch.inf)
        best = torch.argmax(gain, dim=1)           # first maximum, (C,)
        best_gain = torch.gather(gain, 1, best[:, None])[:, 0]
        split_ok = best_gain >= max(min_info_gain, 1e-12)
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
        heap_feat = bfeat if feat_map is None else torch.where(
            split_ok, feat_map[bfeat], 0)
        feat_heap[heap_pos] = heap_feat.to(torch.int32)
        thr_heap[heap_pos] = thr.to(thr_heap.dtype)
        # route rows: bin <= best <=> go left; a denied split sends every
        # row left through the TB sentinel
        best_r = torch.where(split_ok, best, TB)
        go_right = (design.row_bins(bfeat[slot_l]) > best_r[slot_l]
                    ).to(torch.int32)
        node = 2 * node + go_right                 # within-level index
    leaf_stats = index_add_rows(
        torch.zeros((2 ** depth, S), dtype=stats.dtype, device=dev),
        node.long(), stats)
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

def _masked_mean(y: torch.Tensor, mask: Optional[torch.Tensor], n: int
                 ) -> torch.Tensor:
    """Mean label of the masked rows: ``sum(y) * (1/n)`` for the single
    fit (``mask=None``), as XLA folds the JAX package's constant mask; the
    search's masks divide, as its kernel does. The sums are added in
    XLA's CPU order (``ref_math.xla_sum``) on the CPU: a real label's mean
    moves by an ulp otherwise, and with it every residual of a squared
    boosting round."""
    if mask is None:
        return ref_math.xla_sum(y) * (1.0 / max(n, 1))
    return ref_math.xla_sum(mask * y) / torch.clamp(ref_math.xla_sum(mask),
                                                    min=1.0)


def _boost_tree(design, g, h, m, *, depth, step_size, reg_lambda,
                gain_fn):
    """One boosting tree on the masked gradients and hessians: (feat heap,
    thr heap, leaf values, final node per row). A leaf value is
    -step * G / (H + lambda), 0 where the leaf holds no statistics."""
    feat, thr, leaf_stats, node = _grow_tree(
        design, torch.stack([g * m, h * m], dim=1), depth=depth,
        gain_fn=gain_fn)
    vals = -step_size * leaf_stats[:, 0] / (leaf_stats[:, 1] + reg_lambda)
    vals = torch.where(torch.sum(torch.abs(leaf_stats), dim=1) > 0, vals,
                       0.0)
    return feat, thr, vals, node


def _gbt_body(design: _PackedDesign, y: torch.Tensor,
              mask: Optional[torch.Tensor], *, depth: int, num_rounds: int,
              step_size: float, reg_lambda: float, gamma: float,
              min_child_weight: float, subsample: float, seed: int,
              draws=None, objective: str = "logistic"):
    """Boosting with row-mask semantics: masked rows get zero gradient and
    hessian. ``objective`` "logistic" (binary classification: the base
    margin is the log-odds of the masked mean label, gradients p - y and
    p (1 - p)) or "squared" (regression: the base is the masked mean,
    gradients m - y and 1). Below ``subsample=1`` each round r keeps the
    rows of ``bernoulli(r, subsample, n)`` from the draws provider
    (``draws``, a factory of ``models/draws.py``, TorchDraws by default).
    Returns (feats (R, H), thrs (R, H), leaves (R, L), base 0-d tensor)."""
    n = design.n
    mean_y = _masked_mean(y, mask, n)
    if mask is None:
        mask = torch.ones_like(y)
    if objective == "logistic":
        p0 = torch.clamp(mean_y, 1e-6, 1 - 1e-6)
        base = ref_math.log(p0 / (1 - p0))
    else:
        base = mean_y
    margins = base.expand(n)
    rows = None
    if subsample < 1.0:
        rows = (draws or TorchDraws)(seed, num_rounds)
    gain_fn = _xgb_gain(reg_lambda, gamma, min_child_weight)
    feats, thrs, leaves = [], [], []
    for r in range(num_rounds):
        if objective == "logistic":
            p = ref_math.sigmoid(margins)
            g = p - y
            h = torch.clamp(p * (1 - p), min=1e-12)
        else:
            g = margins - y
            h = torch.ones_like(y)
        m = mask
        if rows is not None:
            m = _on(rows.bernoulli(r, subsample, n), y.dtype,
                    design.device) * mask
        feat, thr, vals, node = _boost_tree(
            design, g, h, m, depth=depth, step_size=step_size,
            reg_lambda=reg_lambda, gain_fn=gain_fn)
        margins = margins + vals[node.long()]
        feats.append(feat)
        thrs.append(thr)
        leaves.append(vals)
    return torch.stack(feats), torch.stack(thrs), torch.stack(leaves), base


def _gbt_softmax_body(design: _PackedDesign, y: torch.Tensor,
                      mask: Optional[torch.Tensor], *, num_classes: int,
                      depth: int, num_rounds: int, step_size: float,
                      reg_lambda: float, gamma: float,
                      min_child_weight: float, subsample: float, seed: int,
                      draws=None):
    """K-class softmax boosting (XGBoost's ``multi:softprob``): each round
    grows one tree per class on the softmax gradients g_k = p_k - [y = k]
    and hessians h_k = p_k (1 - p_k) of the same margins, the K trees one
    after another (the JAX package vmaps them); the base margins are the
    log class priors of the masked rows. Returns (feats (R, K, H), thrs
    (R, K, H), leaves (R, K, L), base (K,))."""
    n = design.n
    K = int(num_classes)
    if mask is None:
        mask = torch.ones_like(y)
    eye = torch.eye(K, dtype=y.dtype, device=y.device)
    onehot = eye[y.long()]
    counts = torch.sum(mask[:, None] * onehot, dim=0)
    priors = torch.clamp(counts / torch.clamp(torch.sum(counts), min=1.0),
                         1e-6, 1.0)
    base = ref_math.log(priors)
    margins = base.expand(n, K)
    rows = None
    if subsample < 1.0:
        rows = (draws or TorchDraws)(seed, num_rounds)
    gain_fn = _xgb_gain(reg_lambda, gamma, min_child_weight)
    feats, thrs, leaves = [], [], []
    for r in range(num_rounds):
        p = ref_math.softmax(margins, dim=1)
        g = p - onehot
        h = torch.clamp(p * (1.0 - p), min=1e-12)
        m = mask
        if rows is not None:
            m = _on(rows.bernoulli(r, subsample, n), y.dtype,
                    design.device) * mask
        out = [_boost_tree(design, g[:, k], h[:, k], m, depth=depth,
                           step_size=step_size, reg_lambda=reg_lambda,
                           gain_fn=gain_fn) for k in range(K)]
        delta = torch.stack([vals[node.long()] for _, _, vals, node in out],
                            dim=1)
        margins = margins + delta
        feats.append(torch.stack([o[0] for o in out]))
        thrs.append(torch.stack([o[1] for o in out]))
        leaves.append(torch.stack([o[2] for o in out]))
    return torch.stack(feats), torch.stack(thrs), torch.stack(leaves), base


def _tree_sum(vals: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (tree) axis, added in tree order as the JAX
    package's reductions add: the last row of a running sum, which the
    CPU accumulates one tree after another and the card computes in one
    launch. Tied rows then keep equal sums, and the tie-grouped metric
    sees the reference's ties."""
    return torch.cumsum(vals, dim=0)[-1]


def _gbt_margins(X: torch.Tensor, feats, thrs, leaves, base, depth: int):
    """(n,) boosted margins: traversal, leaf gather, ``base`` plus the
    tree-order sum over trees."""
    leaf = _predict_leaves(X, feats, thrs, depth)
    return base + _tree_sum(torch.gather(leaves, 1, leaf))


def _softmax_margins(X: torch.Tensor, feats, thrs, leaves, base,
                     depth: int) -> torch.Tensor:
    """(n, K) margins of a softmax booster (feats, thrs (R, K, H), leaves
    (R, K, L), base (K,)): each class's trees summed in round order."""
    R, K, H = feats.shape
    leaf = _predict_leaves(X, feats.reshape(R * K, H),
                           thrs.reshape(R * K, H), depth)      # (R*K, n)
    vals = torch.gather(leaves.reshape(R * K, -1), 1, leaf)
    return base + _tree_sum(vals.view(R, K, -1)).t()


def _on(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` (tensor or array) as a tensor of ``dtype`` on ``device``;
    arrays are copied, so a read-only numpy buffer is never aliased. A
    host tensor goes to a card through pinned memory, so the copy is
    queued on the stream and the host does not wait for the card (draws
    arrive this way inside the tree loops)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    if device.type == "cuda" and x.device.type == "cpu":
        return x.to(dtype).pin_memory().to(device, non_blocking=True)
    return x.to(device=device, dtype=dtype)


class _TreeArrays:
    """A fitted model's trees (split features, thresholds, leaves) on
    ``device``, from numpy or tensors."""

    def _set_trees(self, feats, thrs, leaves, depth, n_features, device):
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device)
        self.feats = _on(feats, torch.int32, self.device)
        self.thrs = _on(thrs, self.dtype, self.device)
        self.leaves = _on(leaves, self.dtype, self.device)
        self.depth = int(depth)
        self.n_features = int(n_features)

    @property
    def feature_importances(self) -> np.ndarray:
        """Normalized real-split counts per training column, numpy
        float64 (the JAX package's ``_split_count_importances``): a
        finite threshold is a split, +inf a dead node; the counting runs
        where the trees live."""
        return _split_count_importances(self.feats, self.thrs,
                                        self.n_features)


def _split_count_importances(feats: torch.Tensor, thrs: torch.Tensor,
                             n_features: int) -> np.ndarray:
    """Each feature's count of real splits over every tree (any heap
    layout: the booster's (rounds, K, heap) too), divided by their total;
    zeros where no tree split."""
    real = torch.isfinite(thrs)
    if feats.numel() == 0 or not bool(real.any()):
        return np.zeros(n_features)
    counts = torch.bincount(feats[real].long().reshape(-1),
                            minlength=n_features)
    counts = counts.cpu().numpy().astype(np.float64)
    total = counts.sum()
    return counts / total if total > 0 else counts


class GBTClassifierModel(_TreeArrays, ClassifierModel):
    """Boosted binary classifier: sigmoid over summed leaf margins. The
    trees live on ``device``; ``predict_arrays`` takes numpy or a tensor
    and returns numpy."""

    def __init__(self, feats, thrs, leaves, depth: int, base: float = 0.0,
                 n_features: int = 0, device="cuda",
                 uid: Optional[str] = None):
        ClassifierModel.__init__(self, uid=uid)
        self._set_trees(feats, thrs, leaves, depth, n_features, device)
        self.base = float(base)

    def raw_arrays(self, X: torch.Tensor) -> torch.Tensor:
        """(n, 2) raw pair [-m, m] of the boosted margins m."""
        m = _gbt_margins(X, self.feats, self.thrs, self.leaves, self.base,
                         self.depth)
        return torch.stack([-m, m], dim=1)

    @staticmethod
    def raw_from_margin(m: np.ndarray) -> np.ndarray:
        """The raw pair of host margins (``batch_predict_raw``'s layout of
        this model, the one ``raw_arrays`` makes)."""
        return np.stack([-m, m], axis=1)

    def raw_to_probability(self, raw: np.ndarray) -> np.ndarray:
        p = 1.0 / (1.0 + np.exp(-raw[:, 1]))
        return np.stack([1 - p, p], axis=1)


class GBTRegressorModel(_TreeArrays, RegressionModel):
    """Boosted regressor: base plus the summed leaf values."""

    def __init__(self, feats, thrs, leaves, depth: int, base: float = 0.0,
                 n_features: int = 0, device="cuda",
                 uid: Optional[str] = None):
        RegressionModel.__init__(self, uid=uid)
        self._set_trees(feats, thrs, leaves, depth, n_features, device)
        self.base = float(base)

    def raw_arrays(self, X: torch.Tensor) -> torch.Tensor:
        return _gbt_margins(X, self.feats, self.thrs, self.leaves,
                            self.base, self.depth)


class GBTMulticlassClassifierModel(_TreeArrays, ClassifierModel):
    """K-class softmax booster: raw predictions are the per-class margins
    (``feats``, ``thrs`` (R, K, H), ``leaves`` (R, K, L), ``base`` (K,)),
    whose softmax is the probability."""

    def __init__(self, feats, thrs, leaves, depth: int, base,
                 n_features: int = 0, device="cuda",
                 uid: Optional[str] = None):
        ClassifierModel.__init__(self, uid=uid)
        self._set_trees(feats, thrs, leaves, depth, n_features, device)
        self.base = _on(base, self.dtype, self.device).reshape(-1)

    def raw_arrays(self, X: torch.Tensor) -> torch.Tensor:
        return _softmax_margins(X, self.feats, self.thrs, self.leaves,
                                self.base, self.depth)


# ---------------------------------------------------------------------------
# fold x grid search
# ---------------------------------------------------------------------------

#: grid parameters that vary per candidate vs those that fix a shape group
#: ("eta" and "num_round" are the XGBoost facades' names of step_size and
#: num_rounds)
_GBT_TRACED = ("step_size", "reg_lambda", "gamma", "min_child_weight",
               "subsample", "eta")
_GBT_SKEY = ("max_depth", "num_rounds", "max_bins", "seed")
_GBT_STATIC = _GBT_SKEY + ("num_round",)


def _check_binary(y) -> None:
    bad = np.setdiff1d(np.unique(y), [0.0, 1.0])
    if bad.size:
        raise ValueError(f"GBTClassifier supports binary labels {{0, 1}} "
                         f"only; got extra labels {bad.tolist()}")


def _check_grid(grid, allowed: Sequence[str], family: str) -> List[Dict]:
    """The grid as a list of dicts; raises for a parameter the family's
    search cannot vary."""
    grid = [dict(p) for p in (list(grid) or [{}])]
    for p in grid:
        extra = set(p) - set(allowed)
        if extra:
            raise NotImplementedError(
                f"the {family} search cannot vary {sorted(extra)}")
    return grid


def _candidate_groups(est, grid, skey: Sequence[str]
                      ) -> List[List[Tuple[int, Predictor]]]:
    """Grid points partitioned into static shape groups (the ``skey``
    fields), in first-seen order — the grouping of the JAX package's
    ``_candidate_groups`` with static depth."""
    groups: Dict[tuple, list] = {}
    for gi, p in enumerate(grid):
        cand = est.with_params(**p)
        key = tuple(getattr(cand, f) for f in skey)
        groups.setdefault(key, []).append((gi, cand))
    return list(groups.values())


class _FoldGridSink:
    """Where a fold x grid search's candidates go, in one of two modes.

    With ``eval_ctx`` = (X_val (F, nv, d), y_val (F, nv), spec) each
    candidate's scores on its fold's validation rows feed the on-device
    metric (``score``) and only the (F, G) matrix reaches the host. With
    None each candidate's fitted model is kept (``keep``) and the result
    is the (F, G) list of lists of models."""

    def __init__(self, eval_ctx, F: int, G: int, device: torch.device,
                 dtype: torch.dtype):
        self.scoring = eval_ctx is not None
        if not self.scoring:
            self.models = [[None] * G for _ in range(F)]
            return
        from ..evaluators.device_metrics import metric_fn
        X_val, y_val, spec = eval_ctx
        self.spec = spec
        self.mfn = metric_fn(*spec)
        self.Xv = torch.as_tensor(X_val, dtype=dtype, device=device)
        self.yv = torch.as_tensor(np.asarray(y_val), dtype=dtype,
                                  device=device)
        self.mm = torch.full((F, G), torch.nan, dtype=dtype, device=device)

    def score(self, f: int, gi: int, scores) -> None:
        self.mm[f, gi] = self.mfn(self.yv[f], scores)

    def keep(self, f: int, gi: int, model) -> None:
        self.models[f][gi] = model

    def result(self):
        if self.scoring:
            return self.mm.cpu().numpy().astype(np.float64)
        return self.models


def _fold_edge_recurse(search, est, X, y, masks, grid, eval_ctx, **kw):
    """``TX_TREE_EDGES=fold``: one single-fold call of ``search`` per
    fold, each binning with edges from that fold's train rows only; the
    same (F, G) matrix or per-fold model lists the fold-major call
    returns. One design per fold, so no validation row moves a split's
    threshold."""
    outs = []
    for f in range(masks.shape[0]):
        rows = np.nonzero(masks[f] > 0)[0]
        sub = None if eval_ctx is None else (
            eval_ctx[0][f:f + 1], eval_ctx[1][f:f + 1], eval_ctx[2])
        outs.append(search(est, X, y, masks[f:f + 1], grid, eval_ctx=sub,
                           edge_rows=rows, **kw))
    if eval_ctx is not None:
        return np.concatenate(outs, axis=0)
    return [o[0] for o in outs]


def _gbt_fold_grid(est, X, y, masks, grid, objective: str = "logistic",
                   num_classes: int = 0, eval_ctx=None, edge_rows=None):
    """Every (fold, grid point) booster candidate: a masked fit on the
    whole prepared matrix (mask = the fold's train rows, bin edges from
    the whole matrix, or from ``edge_rows`` under ``TX_TREE_EDGES=fold``,
    as in the JAX search), fold-major within each static group. With
    ``eval_ctx`` (see _FoldGridSink) the on-device metric of each
    candidate on its fold's validation rows: the sigmoid pair of the
    margins (``objective`` "logistic"), the values ("squared"), or the
    softmax of the K class margins ("softmax", with ``num_classes``), and
    the (F, G) matrix out; without, the (F, G) fitted models."""
    from ..evaluators.device_metrics import binary_from_sigmoid
    masks = np.asarray(masks, dtype=np.float64)
    if edge_rows is None and _fold_edges_mode():
        return _fold_edge_recurse(_gbt_fold_grid, est, X, y, masks, grid,
                                  eval_ctx, objective=objective,
                                  num_classes=num_classes)
    grid = _check_grid(grid, _GBT_TRACED + _GBT_STATIC, "GBT")
    dev, dtype = est.device, working_dtype(est.device)
    F, d = masks.shape[0], X.shape[1]
    sink = _FoldGridSink(eval_ctx, F, len(grid), dev, dtype)
    y_t = torch.as_tensor(np.asarray(y), dtype=dtype, device=dev)
    masks_t = torch.as_tensor(masks, dtype=dtype, device=dev)
    for members in _candidate_groups(est, grid, _GBT_SKEY):
        design = _design_args(X, members[0][1].max_bins, dev, edge_rows)
        for f in range(F):
            for gi, cand in members:
                depth = cand.max_depth
                if objective == "softmax":
                    fit = _gbt_softmax_body(design, y_t, masks_t[f],
                                            num_classes=num_classes,
                                            **cand._fit_kwargs())
                    if sink.scoring:
                        sink.score(f, gi, ref_math.softmax(_softmax_margins(
                            sink.Xv[f], *fit, depth), dim=1))
                    else:
                        sink.keep(f, gi, GBTMulticlassClassifierModel(
                            *fit[:3], depth=depth, base=fit[3],
                            n_features=d, device=dev))
                    continue
                fit = _gbt_body(design, y_t, masks_t[f], objective=objective,
                                **cand._fit_kwargs())
                if not sink.scoring:
                    model_cls = (GBTClassifierModel if objective == "logistic"
                                 else GBTRegressorModel)
                    sink.keep(f, gi, model_cls(
                        *fit[:3], depth=depth, base=float(fit[3]),
                        n_features=d, device=dev))
                    continue
                scores = _gbt_margins(sink.Xv[f], *fit, depth)
                if objective == "logistic":
                    scores = binary_from_sigmoid(scores)
                sink.score(f, gi, scores)
    return sink.result()


def batch_predict_raw(models, X) -> dict:
    """Raw predictions of every forest, decision-tree and binary or
    regression booster model in ``models`` (others are skipped) on ``X``:
    the models grouped by static shape (kind, depth, heap and leaf
    shapes, device), each group one stacked traversal on its device, the
    trees of a model summed in tree order as its own ``raw_arrays`` sums
    them. Returns {index in models: raw numpy array} in each model's own
    ``predict_raw`` / ``predict_values`` layout, for its
    ``prediction_from_raw``."""
    groups: Dict[tuple, list] = {}
    for i, m in enumerate(models):
        if isinstance(m, _EnsembleModel):
            kind = "forest"
        elif isinstance(m, (GBTClassifierModel, GBTRegressorModel)):
            kind = "gbt"
        else:
            continue
        key = (kind, m.depth, tuple(m.feats.shape), tuple(m.leaves.shape),
               m.device, m.dtype)
        groups.setdefault(key, []).append(i)
    out: dict = {}
    for (kind, depth, _, lshape, dev, dtype), idxs in groups.items():
        Xt = torch.as_tensor(X, dtype=dtype, device=dev)
        feats = torch.stack([models[i].feats for i in idxs])
        thrs = torch.stack([models[i].thrs for i in idxs])
        C, T, H = feats.shape
        leaf = _predict_leaves(Xt, feats.reshape(C * T, H),
                               thrs.reshape(C * T, H), depth)   # (C*T, n)
        leaves = torch.stack([models[i].leaves for i in idxs]).reshape(
            C * T, *lshape[1:])
        rows = torch.arange(C * T, device=dev)[:, None]
        vals = leaves[rows, leaf]
        total = torch.cumsum(vals.reshape(C, T, *vals.shape[1:]), dim=1)[:, -1]
        if kind == "forest":
            raw = total / T
        else:
            bases = torch.tensor([models[i].base for i in idxs], dtype=dtype,
                                 device=dev)
            raw = bases[:, None] + total
        raw = raw.cpu().numpy().astype(np.float64)
        for j, i in enumerate(idxs):
            r = raw[j]
            if isinstance(models[i], GBTClassifierModel):
                r = models[i].raw_from_margin(r)
            out[i] = r
    return out


class _BoosterBase(Predictor):
    """Shared parameters and single fit of the boosters: ``objective``
    names the boosting body's loss and ``model_cls`` the model it fits."""

    objective = "logistic"
    model_cls = GBTClassifierModel

    def __init__(self, num_rounds: int = 20, max_depth: int = 5,
                 step_size: float = 0.1, max_bins: int = 32,
                 reg_lambda: float = 1.0, gamma: float = 0.0,
                 min_child_weight: float = 1.0, subsample: float = 1.0,
                 seed: int = 42, device="cuda", draws=None,
                 uid: Optional[str] = None):
        """``draws``: optional factory ``draws(seed, num_rounds)`` of the
        row-subsample provider (``models/draws.py``; TorchDraws when
        None)."""
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
        self.draws = draws

    def _fit_kwargs(self) -> dict:
        return dict(depth=int(self.max_depth),
                    num_rounds=int(self.num_rounds),
                    step_size=float(self.step_size),
                    reg_lambda=float(self.reg_lambda),
                    gamma=float(self.gamma),
                    min_child_weight=float(self.min_child_weight),
                    subsample=float(self.subsample), seed=int(self.seed),
                    draws=self.draws)

    def _fit_boosted(self, X, y):
        design = _design_args(X, self.max_bins, self.device)
        y_t = torch.as_tensor(np.asarray(y), dtype=design.dtype,
                              device=self.device)
        feats, thrs, leaves, base = _gbt_body(
            design, y_t, None, objective=self.objective,
            **self._fit_kwargs())
        return self.model_cls(feats, thrs, leaves, depth=self.max_depth,
                              base=float(base), n_features=X.shape[1],
                              device=self.device)


class GBTClassifier(_BoosterBase):
    """Gradient-boosted binary classifier with second-order (XGBoost-
    style) split gains on the logistic objective."""

    def eval_fold_grid_arrays(self, X, y, masks, grid, X_val, y_val, spec,
                              cand_idx=None) -> np.ndarray:
        """Device-resident search: fused fit + validation metric, (F, G)
        matrix out (see _gbt_fold_grid)."""
        if spec[0] != "binary":
            raise NotImplementedError(
                "GBT-classifier device eval is binary-only")
        if np.setdiff1d(np.unique(y), [0.0, 1.0]).size:
            raise NotImplementedError(
                "the GBT search requires binary labels {0, 1}")
        return _gbt_fold_grid(self, X, y, masks, subset_grid(grid, cand_idx),
                              eval_ctx=(X_val, y_val, spec))

    def fit_fold_grid_arrays(self, X, y, masks, grid):
        """Every (fold, grid point) candidate fitted by the search's
        masked fits, (F, G) models out (see _gbt_fold_grid). Labels
        outside {0, 1} raise NotImplementedError, so the validator fits
        candidate by candidate instead."""
        if np.setdiff1d(np.unique(y), [0.0, 1.0]).size:
            raise NotImplementedError(
                "the GBT search requires binary labels {0, 1}")
        return _gbt_fold_grid(self, X, y, masks, grid)

    def fit_arrays(self, X, y) -> GBTClassifierModel:
        _check_binary(y)
        return self._fit_boosted(X, y)


class GBTRegressor(_BoosterBase):
    """Gradient-boosted regressor on the squared loss (reference
    OpGBTRegressor.scala), second-order split gains."""

    objective = "squared"
    model_cls = GBTRegressorModel

    def eval_fold_grid_arrays(self, X, y, masks, grid, X_val, y_val, spec,
                              cand_idx=None) -> np.ndarray:
        """Device-resident search (see _gbt_fold_grid)."""
        if spec[0] != "regression":
            raise NotImplementedError(
                "GBT-regressor device eval needs a regression metric")
        return _gbt_fold_grid(self, X, y, masks, subset_grid(grid, cand_idx),
                              "squared", eval_ctx=(X_val, y_val, spec))

    def fit_fold_grid_arrays(self, X, y, masks, grid):
        """(F, G) fitted models of the search (see _gbt_fold_grid)."""
        return _gbt_fold_grid(self, X, y, masks, grid, "squared")

    def fit_arrays(self, X, y) -> GBTRegressorModel:
        return self._fit_boosted(X, y)


def _xgb_init(self, eta, max_depth, num_round, reg_lambda, gamma,
              min_child_weight, subsample, max_bins, seed, device, draws,
              uid):
    _BoosterBase.__init__(
        self, num_rounds=num_round, max_depth=max_depth, step_size=eta,
        max_bins=max_bins, reg_lambda=reg_lambda, gamma=gamma,
        min_child_weight=min_child_weight, subsample=subsample, seed=seed,
        device=device, draws=draws, uid=uid)
    self.eta = eta
    self.num_round = num_round


class XGBoostClassifier(GBTClassifier):
    """XGBoost-named facade over the histogram booster (reference
    OpXGBoostClassifier.scala): binary labels boost the logistic
    objective as GBTClassifier does; K > 2 classes boost the softmax
    objective (``multi:softprob``, ``_gbt_softmax_body``)."""

    def __init__(self, eta: float = 0.3, max_depth: int = 6,
                 num_round: int = 100, reg_lambda: float = 1.0,
                 gamma: float = 0.0, min_child_weight: float = 1.0,
                 subsample: float = 1.0, max_bins: int = 256,
                 seed: int = 42, device="cuda", draws=None,
                 uid: Optional[str] = None):
        _xgb_init(self, eta, max_depth, num_round, reg_lambda, gamma,
                  min_child_weight, subsample, max_bins, seed, device,
                  draws, uid)

    @staticmethod
    def _check_classes(y, k: int, error=NotImplementedError) -> None:
        bad = np.setdiff1d(np.unique(y), np.arange(k, dtype=np.float64))
        if bad.size:
            raise error(f"XGBoostClassifier needs integer class labels "
                        f"0..{k - 1}; got {bad.tolist()}")

    def eval_fold_grid_arrays(self, X, y, masks, grid, X_val, y_val, spec,
                              cand_idx=None) -> np.ndarray:
        """Binary labels: the GBT search. K > 2 classes: the softmax
        booster's fused fit and multiclass metric per candidate."""
        k = num_classes(y)
        if k <= 2:
            return GBTClassifier.eval_fold_grid_arrays(
                self, X, y, masks, grid, X_val, y_val, spec,
                cand_idx=cand_idx)
        if spec[0] != "multiclass":
            raise NotImplementedError(
                "softmax-GBT device eval needs a multiclass metric")
        self._check_classes(y, k)
        check_fold_classes(y, masks)
        return _gbt_fold_grid(self, X, y, masks, subset_grid(grid, cand_idx),
                              "softmax", num_classes=k,
                              eval_ctx=(X_val, y_val, spec))

    def fit_fold_grid_arrays(self, X, y, masks, grid):
        """Binary labels: the GBT search's models. K > 2 classes: the
        softmax booster's (F, G) models."""
        k = num_classes(y)
        if k <= 2:
            return GBTClassifier.fit_fold_grid_arrays(self, X, y, masks,
                                                      grid)
        self._check_classes(y, k)
        check_fold_classes(y, masks)
        return _gbt_fold_grid(self, X, y, masks, grid, "softmax",
                              num_classes=k)

    def fit_arrays(self, X, y):
        k = num_classes(y)
        if k <= 2:
            return GBTClassifier.fit_arrays(self, X, y)
        self._check_classes(y, k, ValueError)
        design = _design_args(X, self.max_bins, self.device)
        y_t = torch.as_tensor(np.asarray(y), dtype=design.dtype,
                              device=self.device)
        feats, thrs, leaves, base = _gbt_softmax_body(
            design, y_t, None, num_classes=k, **self._fit_kwargs())
        return GBTMulticlassClassifierModel(
            feats, thrs, leaves, depth=self.max_depth, base=base,
            n_features=X.shape[1], device=self.device)


class XGBoostRegressor(GBTRegressor):
    """XGBoost-named facade over the squared-loss booster (reference
    OpXGBoostRegressor.scala)."""

    def __init__(self, eta: float = 0.3, max_depth: int = 6,
                 num_round: int = 100, reg_lambda: float = 1.0,
                 gamma: float = 0.0, min_child_weight: float = 1.0,
                 subsample: float = 1.0, max_bins: int = 256,
                 seed: int = 42, device="cuda", draws=None,
                 uid: Optional[str] = None):
        _xgb_init(self, eta, max_depth, num_round, reg_lambda, gamma,
                  min_child_weight, subsample, max_bins, seed, device,
                  draws, uid)


# ---------------------------------------------------------------------------
# random forests and decision trees
# ---------------------------------------------------------------------------

#: feature widths <= this form the "narrow" pool class (one-hot-ish
#: columns), wider ones the "wide" class; each class packs at its own
#: uniform width, so a pool's bins scale with its features
_NARROW_WIDTH = 4


def _resolve_max_features(strategy: str, d: int, classification: bool
                          ) -> Optional[int]:
    """MLlib featureSubsetStrategy (RandomForestParams)."""
    s = str(strategy).lower()
    if s == "auto":
        s = "sqrt" if classification else "onethird"
    if s == "all":
        return None
    if s == "sqrt":
        return max(1, int(np.sqrt(d)))
    if s == "log2":
        return max(1, int(np.log2(d)))
    if s == "onethird":
        return max(1, d // 3)
    return max(1, min(d, int(float(s) * d) if "." in s else int(s)))


def _pool_size(d: int, mf: Optional[int]) -> Optional[int]:
    """Per-tree feature-pool size: 4x the per-node sample, at least 8."""
    if mf is None or mf >= d:
        return None
    return min(d, max(4 * mf, 8))


def _pool_classes(widths: np.ndarray, pool_size: int, max_features: int):
    """Stratified pool plan from per-feature bin widths: ((narrow_idx,
    wide_idx), (p_n, p_w, b_n, b_w), effective max_features). The pool is
    split in proportion (Python's ``round``), but every non-empty class
    keeps at least one slot."""
    narrow = np.nonzero(widths <= _NARROW_WIDTH)[0].astype(np.int64)
    wide = np.nonzero(widths > _NARROW_WIDTH)[0].astype(np.int64)
    d = len(widths)
    p_n = min(len(narrow), int(round(pool_size * len(narrow) / d)))
    if len(narrow):
        p_n = max(p_n, 1)
    p_w = min(len(wide), pool_size - p_n)
    if len(wide):
        p_w = max(p_w, 1)
    p_n = min(len(narrow), max(pool_size - p_w, 1 if len(narrow) else 0))
    b_n = int(widths[narrow].max()) if len(narrow) and p_n else 0
    b_w = int(widths[wide].max()) if len(wide) and p_w else 0
    return ((narrow, wide), (p_n, p_w, b_n, b_w),
            min(max_features, p_n + p_w))


def _pool_plan(widths: np.ndarray, mf: Optional[int]):
    """(class indices, pool_cfg, effective max_features), or (None, None,
    mf) when a pool would hold every feature (the shared design is then
    used as it is)."""
    pool = _pool_size(len(widths), mf)
    if pool is None or pool >= len(widths):
        return None, None, mf
    return _pool_classes(np.asarray(widths), pool, mf)


class _ForestPool:
    """The per-tree stratified feature pools of one static group.

    Every tree's pool packs p_n narrow features at width b_n and p_w wide
    ones at width b_w, so what depends only on those counts (offsets, bin
    ownership, K1's launch plan) is built once here; :meth:`tree` gathers
    one tree's columns. A narrower feature keeps padded bins whose
    thresholds are +inf: never occupied, never a split."""

    def __init__(self, design: _PackedDesign, classes, cfg):
        p_n, p_w, b_n, b_w = cfg
        dev = design.device
        self.design = design
        self.classes = [(torch.as_tensor(idx, device=dev), p, b)
                        for idx, p, b in zip(classes, (p_n, p_w), (b_n, b_w))]
        self.widths = np.array([b_n] * p_n + [b_w] * p_w, dtype=np.int64)
        self.n, self.d, self.device = design.n, p_n + p_w, dev
        self.total_bins = int(self.widths.sum())
        offsets = np.concatenate([[0], np.cumsum(self.widths)[:-1]])
        block_start = np.repeat(offsets, self.widths)
        self.offsets = torch.as_tensor(offsets.astype(np.int32), device=dev)
        self.feat_of = torch.as_tensor(
            np.repeat(np.arange(self.d, dtype=np.int64), self.widths),
            device=dev)
        self.prev_bin = torch.as_tensor(np.maximum(block_start - 1, 0),
                                        device=dev)
        self.has_prev = torch.as_tensor(block_start > 0, device=dev)
        self.stride = padded_stride(self.d, design.ids.element_size())
        self._plans: Dict[int, HistPlan] = {}

    def hist_plan(self, S: int) -> HistPlan:
        plan = self._plans.get(S)
        if plan is None:
            plan = self._plans[S] = HistPlan(self.widths, S, self.device)
        return plan

    def tree(self, t: int, draws) -> "_PooledDesign":
        """Tree ``t``'s pooled design from ``draws.pool``."""
        picks = draws.pool(t, [(len(idx), p) for idx, p, _ in self.classes])
        sel, thr = [], []
        for (idx, p, b), pos in zip(self.classes, picks):
            if p == 0:
                continue
            f = idx[_on(pos, torch.int64, self.device)]
            sel.append(f)
            thr.append(self.design.col_thr[f][:, :b].reshape(-1))
        return _PooledDesign(self, torch.cat(sel), torch.cat(thr))


class _PooledDesign:
    """One tree's design over its pool: the pool's columns of the compact
    ids gathered into a new (n, stride) matrix, the pooled thresholds, and
    ``feat_map`` (pooled feature -> original column). Routing reads the
    compact ids, so no (n, pool) int32 matrix is made."""

    def __init__(self, pool: _ForestPool, sel: torch.Tensor,
                 packed_thr: torch.Tensor):
        src = pool.design.ids
        self.ids = torch.zeros((pool.n, pool.stride), dtype=src.dtype,
                               device=pool.device)
        self.ids[:, :pool.d] = src.index_select(1, sel)
        self.feat_map = sel
        self.packed_thr = packed_thr
        self.not_a_split = ~torch.isfinite(packed_thr)
        self.n, self.d, self.device = pool.n, pool.d, pool.device
        self.total_bins, self.offsets = pool.total_bins, pool.offsets
        self.feat_of, self.prev_bin = pool.feat_of, pool.prev_bin
        self.has_prev, self.hist_plan = pool.has_prev, pool.hist_plan

    def row_bins(self, feat: torch.Tensor) -> torch.Tensor:
        """(n,) packed bin of each row at its pooled feature ``feat``."""
        local = torch.gather(self.ids, 1, feat[:, None])[:, 0].long()
        if self.ids.dtype == torch.int16:           # uint16 bit patterns
            local = local & 0xFFFF
        return local + self.offsets[feat]


def _node_uniforms(draws, t: int, device: torch.device):
    """``node_u`` of tree ``t`` for _grow_tree: each level drawn once and
    kept, so every candidate grown on the tree gets the same subsets.
    Float64 on every device, so the card picks the CPU's subsets."""
    cache: Dict[int, torch.Tensor] = {}

    def node_u(level: int, shape) -> torch.Tensor:
        u = cache.get(level)
        if u is None:
            u = cache[level] = _on(draws.node_uniform(t, level, shape),
                                   torch.float64, device)
        return u
    return node_u


def _forest_trees(design: _PackedDesign, labels: torch.Tensor, lanes,
                  draws, *, kind: str, depth: int, num_trees: int,
                  impurity: str, bootstrap: bool,
                  max_features: Optional[int], pool: Optional[_ForestPool]):
    """Grow one forest per lane, tree by tree; yields (tree, lane, feat
    heap, thr heap, leaves).

    ``lanes`` holds (mask (n,), min_instances, min_info_gain,
    subsampling_rate) per candidate. Tree t's pool, Poisson weights and
    node uniforms depend only on (draws, t, rate), so they are drawn once
    and shared by every lane. ``kind`` "cls": ``labels`` is the (n, K)
    one-hot, the statistics are it times (weight x mask), a leaf holds its
    class distribution (2^depth, K), 1/K when empty. ``kind`` "reg":
    ``labels`` is the (n,) label, the statistics [w, wy, wyy] feed the
    variance gain and a leaf holds its mean wy / w (2^depth,)."""
    dev = design.device
    if kind == "cls":
        K = labels.shape[1]
        gain = _gini_gain if impurity == "gini" else _entropy_gain
    else:
        gain = _variance_gain
    for t in range(num_trees):
        tree_design = design if pool is None else pool.tree(t, draws)
        feat_map = None if pool is None else tree_design.feat_map
        node_u = None
        if max_features is not None and max_features < tree_design.d:
            node_u = _node_uniforms(draws, t, dev)
        weights: Dict[float, torch.Tensor] = {}
        for i, (mask, min_inst, min_gain, rate) in enumerate(lanes):
            w = mask
            if bootstrap:
                if rate not in weights:
                    weights[rate] = _on(draws.poisson(t, rate, design.n),
                                        labels.dtype, dev)
                w = weights[rate] * mask
            if kind == "cls":
                stats = labels * w[:, None]
            else:
                wy = w * labels
                stats = torch.stack([w, wy, wy * labels], dim=1)
            feat, thr, leaf_stats, _ = _grow_tree(
                tree_design, stats, depth=depth, gain_fn=gain(min_inst),
                min_info_gain=min_gain, max_features=max_features,
                node_u=node_u, feat_map=feat_map)
            if kind == "cls":
                lw = torch.sum(leaf_stats, dim=-1, keepdim=True)
                leaf = torch.where(
                    lw > 0, leaf_stats / torch.clamp(lw, min=1e-12), 1.0 / K)
            else:
                leaf = (leaf_stats[:, 1]
                        / torch.clamp(leaf_stats[:, 0], min=1e-12))
            yield t, i, feat, thr, leaf


class _EnsembleModel(_TreeArrays):
    """Trees of a forest on ``device``: the mean over trees of the leaf
    values (class distributions (T, 2^depth, K) or values (T, 2^depth))
    reached by each row, the tree-order sum divided by T as the JAX
    model's host scoring (``np.mean``) computes it."""

    def raw_arrays(self, X: torch.Tensor) -> torch.Tensor:
        leaf = _predict_leaves(X, self.feats, self.thrs, self.depth)
        tree = torch.arange(leaf.shape[0], device=self.device)[:, None]
        return _tree_sum(self.leaves[tree, leaf]) / leaf.shape[0]


class TreeEnsembleClassifierModel(_EnsembleModel, ClassifierModel):
    """Random-forest / decision-tree classifier: the mean over trees of the
    leaf class distributions (the reference's normalized vote
    averaging)."""

    def __init__(self, feats, thrs, leaves, depth: int, n_features: int = 0,
                 device="cuda", uid: Optional[str] = None):
        ClassifierModel.__init__(self, uid=uid)
        self._set_trees(feats, thrs, leaves, depth, n_features, device)

    def raw_to_probability(self, raw: np.ndarray) -> np.ndarray:
        s = np.sum(raw, axis=1, keepdims=True)
        return raw / np.where(s > 0, s, 1.0)


class TreeEnsembleRegressorModel(_EnsembleModel, RegressionModel):
    """Random-forest / decision-tree regressor: the mean over trees of the
    leaf values."""

    def __init__(self, feats, thrs, leaves, depth: int, n_features: int = 0,
                 device="cuda", uid: Optional[str] = None):
        RegressionModel.__init__(self, uid=uid)
        self._set_trees(feats, thrs, leaves, depth, n_features, device)


#: grid parameters that vary per candidate vs those that fix a shape group
_FOREST_TRACED = ("min_instances_per_node", "min_info_gain",
                  "subsampling_rate")
_FOREST_STATIC = ("max_depth", "num_trees", "max_bins", "impurity",
                  "feature_subset_strategy", "seed")


def _forest_setup(est, X, y, device: torch.device, edge_rows=None):
    """(design, labels, pool or None, max_features, draws) of a static
    group: the one-hot labels of a classifier (K from all of ``y``) or the
    label of a regressor; per-node subsets (and so pools) only with
    bootstrap. ``edge_rows``: see _PackedDesign."""
    design = _design_args(X, est.max_bins, device, edge_rows)
    if est.kind == "cls":
        labels = _on(np.eye(num_classes(y))[np.asarray(y).astype(np.int64)],
                     design.dtype, device)
    else:
        labels = _on(np.asarray(y, dtype=np.float64), design.dtype, device)
    mf = (_resolve_max_features(est.feature_subset_strategy, design.d,
                                est.kind == "cls")
          if est.bootstrap else None)
    classes, cfg, mf = _pool_plan(design.widths, mf)
    pool = None if cfg is None else _ForestPool(design, classes, cfg)
    # K1's plan uploads its tables (a wait for the card): before the loop
    S = labels.shape[1] if est.kind == "cls" else 3
    (design if pool is None else pool).hist_plan(S)
    draws = (est.draws or TorchDraws)(est.seed, est.num_trees)
    return design, labels, pool, mf, draws


def _forest_fold_grid(est, X, y, masks, grid, eval_ctx=None,
                      edge_rows=None):
    """Every (fold, grid point) forest candidate: masked fits on the whole
    prepared matrix (bin edges as in _gbt_fold_grid), grown tree by tree
    for every lane of a static group at once. With ``eval_ctx`` (see
    _FoldGridSink) each lane's leaf values on its fold's validation rows
    are summed as its trees come, then the mean over trees (votes to the
    binary pair or the class probabilities, or the regression values)
    feeds the on-device metric and the (F, G) matrix comes out; without,
    each lane's trees make its model, (F, G) models out."""
    from ..evaluators.device_metrics import binary_from_votes, \
        vote_probability
    masks = np.asarray(masks, dtype=np.float64)
    if edge_rows is None and _fold_edges_mode():
        return _fold_edge_recurse(_forest_fold_grid, est, X, y, masks, grid,
                                  eval_ctx)
    grid = _check_grid(grid, _FOREST_TRACED + _FOREST_STATIC, "forest")
    dev, dtype = est.device, working_dtype(est.device)
    F = masks.shape[0]
    sink = _FoldGridSink(eval_ctx, F, len(grid), dev, dtype)
    masks_t = torch.as_tensor(masks, dtype=dtype, device=dev)
    model_cls = (TreeEnsembleClassifierModel if est.kind == "cls"
                 else TreeEnsembleRegressorModel)
    for members in _candidate_groups(est, grid, _FOREST_STATIC):
        cand0 = members[0][1]
        design, labels, pool, mf, draws = _forest_setup(cand0, X, y, dev,
                                                        edge_rows)
        lanes = [(masks_t[f], float(c.min_instances_per_node),
                  float(c.min_info_gain), float(c.subsampling_rate))
                 for f in range(F) for _, c in members]
        votes: List[Optional[torch.Tensor]] = [None] * len(lanes)
        trees: List[list] = [[] for _ in lanes]
        depth = cand0.max_depth
        for _, i, feat, thr, leaf in _forest_trees(
                design, labels, lanes, draws, kind=cand0.kind, depth=depth,
                num_trees=cand0.num_trees,
                impurity=cand0.impurity,
                bootstrap=cand0.bootstrap, max_features=mf, pool=pool):
            if not sink.scoring:
                trees[i].append((feat, thr, leaf))
                continue
            f = i // len(members)
            v = leaf[_predict_leaves(sink.Xv[f], feat[None], thr[None],
                                     depth)[0]]
            votes[i] = v if votes[i] is None else votes[i] + v
        for i in range(len(lanes)):
            f, j = divmod(i, len(members))
            gi = members[j][0]
            if not sink.scoring:
                feats, thrs, leaves = (torch.stack(a) for a in zip(*trees[i]))
                sink.keep(f, gi, model_cls(feats, thrs, leaves, depth=depth,
                                           n_features=X.shape[1],
                                           device=dev))
                continue
            # the mean as XLA computes it: times the reciprocal of T
            mean = votes[i] * (1.0 / cand0.num_trees)
            sink.score(f, gi, {"binary": binary_from_votes,
                               "multiclass": vote_probability,
                               "regression": lambda v: v}[sink.spec[0]](mean))
    return sink.result()


class _ForestBase(Predictor):
    """Shared search and fit of the tree ensembles; ``kind`` "cls"
    (classifiers) or "reg" (regressors)."""

    kind = "cls"
    num_trees = 1
    bootstrap = False
    subsampling_rate = 1.0
    feature_subset_strategy = "all"
    draws = None

    def fit_arrays(self, X, y):
        design, labels, pool, mf, draws = _forest_setup(self, X, y,
                                                        self.device)
        lane = (torch.ones(design.n, dtype=design.dtype, device=self.device),
                float(self.min_instances_per_node), float(self.min_info_gain),
                float(self.subsampling_rate))
        trees = [(f, t, leaf) for _, _, f, t, leaf in _forest_trees(
            design, labels, [lane], draws, kind=self.kind,
            depth=int(self.max_depth), num_trees=int(self.num_trees),
            impurity=self.impurity,
            bootstrap=self.bootstrap, max_features=mf, pool=pool)]
        feats, thrs, leaves = (torch.stack(a) for a in zip(*trees))
        model_cls = (TreeEnsembleClassifierModel if self.kind == "cls"
                     else TreeEnsembleRegressorModel)
        return model_cls(feats, thrs, leaves, depth=self.max_depth,
                         n_features=X.shape[1], device=self.device)


class _ForestClassifierBase(_ForestBase):
    """Shared search of the tree-ensemble classifiers (binary and K-class
    one-hot statistics)."""

    def eval_fold_grid_arrays(self, X, y, masks, grid, X_val, y_val, spec,
                              cand_idx=None) -> np.ndarray:
        """Device-resident search: fused fit + validation metric, (F, G)
        matrix out (see _forest_fold_grid)."""
        if spec[0] == "binary" and num_classes(y) != 2:
            raise NotImplementedError(
                "binary device eval needs binary labels")
        if spec[0] not in ("binary", "multiclass"):
            raise NotImplementedError(
                "forest-classifier device eval needs a classification "
                "metric")
        return _forest_fold_grid(self, X, y, masks,
                                 subset_grid(grid, cand_idx),
                                 eval_ctx=(X_val, y_val, spec))

    def fit_fold_grid_arrays(self, X, y, masks, grid):
        """Every (fold, grid point) candidate fitted by the search's
        masked fits, (F, G) models out (see _forest_fold_grid)."""
        return _forest_fold_grid(self, X, y, masks, grid)


class _ForestRegressorBase(_ForestBase):
    """Shared search of the tree-ensemble regressors (variance gain)."""

    kind = "reg"
    impurity = ""

    def eval_fold_grid_arrays(self, X, y, masks, grid, X_val, y_val, spec,
                              cand_idx=None) -> np.ndarray:
        """Device-resident search (see _forest_fold_grid)."""
        if spec[0] != "regression":
            raise NotImplementedError(
                "forest-regressor device eval needs a regression metric")
        return _forest_fold_grid(self, X, y, masks,
                                 subset_grid(grid, cand_idx),
                                 eval_ctx=(X_val, y_val, spec))

    def fit_fold_grid_arrays(self, X, y, masks, grid):
        """(F, G) fitted models of the search (see _forest_fold_grid)."""
        return _forest_fold_grid(self, X, y, masks, grid)


class DecisionTreeClassifier(_ForestClassifierBase):
    """Single CART tree, gini or entropy impurity, every feature at every
    node; draws nothing."""

    def __init__(self, max_depth: int = 5, max_bins: int = 32,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 impurity: str = "gini", seed: int = 42, device="cuda",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.min_instances_per_node = min_instances_per_node
        self.min_info_gain = min_info_gain
        self.impurity = impurity
        self.seed = seed
        self.device = resolve_device(device)


class DecisionTreeRegressor(_ForestRegressorBase):
    """Single regression tree, variance impurity, every feature at every
    node; draws nothing."""

    def __init__(self, max_depth: int = 5, max_bins: int = 32,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 seed: int = 42, device="cuda", uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.min_instances_per_node = min_instances_per_node
        self.min_info_gain = min_info_gain
        self.seed = seed
        self.device = resolve_device(device)


class RandomForestClassifier(_ForestClassifierBase):
    """Bagged trees with Poisson(subsampling_rate) row weights (MLlib's
    BaggedPoint approximation of sampling with replacement), a stratified
    feature pool per tree and a feature subset per node."""

    bootstrap = True

    def __init__(self, num_trees: int = 20, max_depth: int = 5,
                 max_bins: int = 32, min_instances_per_node: int = 1,
                 min_info_gain: float = 0.0, subsampling_rate: float = 1.0,
                 feature_subset_strategy: str = "auto", impurity: str = "gini",
                 seed: int = 42, device="cuda", draws=None,
                 uid: Optional[str] = None):
        """``draws``: optional factory ``draws(seed, num_trees)`` of the
        pool, bootstrap and node-subset provider (``models/draws.py``;
        TorchDraws when None)."""
        super().__init__(uid=uid)
        self.num_trees = num_trees
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.min_instances_per_node = min_instances_per_node
        self.min_info_gain = min_info_gain
        self.subsampling_rate = subsampling_rate
        self.feature_subset_strategy = feature_subset_strategy
        self.impurity = impurity
        self.seed = seed
        self.device = resolve_device(device)
        self.draws = draws


class RandomForestRegressor(_ForestRegressorBase):
    """Bagged regression trees (reference OpRandomForestRegressor.scala):
    Poisson row weights, a stratified feature pool per tree and a third of
    the features per node by default."""

    bootstrap = True

    def __init__(self, num_trees: int = 20, max_depth: int = 5,
                 max_bins: int = 32, min_instances_per_node: int = 1,
                 min_info_gain: float = 0.0, subsampling_rate: float = 1.0,
                 feature_subset_strategy: str = "auto", seed: int = 42,
                 device="cuda", draws=None, uid: Optional[str] = None):
        """``draws``: as RandomForestClassifier's."""
        super().__init__(uid=uid)
        self.num_trees = num_trees
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.min_instances_per_node = min_instances_per_node
        self.min_info_gain = min_info_gain
        self.subsampling_rate = subsampling_rate
        self.feature_subset_strategy = feature_subset_strategy
        self.seed = seed
        self.device = resolve_device(device)
        self.draws = draws
