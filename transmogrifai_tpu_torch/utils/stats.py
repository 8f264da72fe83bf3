"""Statistics used by the SanityChecker.

Counterpart of ``transmogrifai_tpu/utils/stats.py`` (reference
utils/src/main/scala/com/salesforce/op/utils/stats/OpStatistics.scala:39-346).
The column moments, the correlation matrix and the label correlations run
as torch ops on the matrix's own device, in float64 whatever the matrix's
dtype: a constant column's variance must come out 0 (float32 can leave it
near 1e-9) and a correlation must not move at 1e-6, or a column crosses a
threshold on the card that it does not cross on the CPU. Only the
d-length results come back to the host. The contingency-table statistics
(chi-squared, Cramér's V, mutual information, rule confidence) stay numpy
and scipy on the small tables, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["ColStats", "col_stats", "correlation_with_label",
           "correlation_matrix", "ContingencyStats", "contingency_stats",
           "chi_square", "cramers_v"]


def _f64(X, device=None) -> torch.Tensor:
    """``X`` as a float64 tensor: a tensor on its own device, a numpy
    array on ``device`` (default the CPU)."""
    if isinstance(X, torch.Tensor):
        return X.to(torch.float64)
    return torch.as_tensor(np.asarray(X, dtype=np.float64), device=device)


def _weights(w, n: int, like: torch.Tensor) -> torch.Tensor:
    if w is None:
        return torch.ones(n, dtype=torch.float64, device=like.device)
    return _f64(w, like.device).reshape(-1)


@dataclass
class ColStats:
    """Per-column moments (reference: Spark MultivariateStatisticalSummary
    usage in SanityChecker.fitFn:535)."""
    count: int
    mean: np.ndarray
    variance: np.ndarray
    min: np.ndarray
    max: np.ndarray
    num_nonzeros: np.ndarray


def col_stats(X, w: Optional[np.ndarray] = None) -> ColStats:
    """Weighted column statistics in one pass on ``X``'s device; one copy
    of the (6, d) results to the host."""
    X = _f64(X)
    n = X.shape[0]
    w = _weights(w, n, X)
    wsum = w.sum()
    mean = (w @ X) / wsum
    var = (w @ (X - mean) ** 2) / torch.clamp(wsum - 1.0, min=1.0)
    live = (w > 0)[:, None]
    mn = torch.where(live, X, torch.inf).amin(dim=0)
    mx = torch.where(live, X, -torch.inf).amax(dim=0)
    nnz = ((X != 0) & live).sum(dim=0).to(torch.float64)
    count = live.sum().to(torch.float64).reshape(1)
    d = X.shape[1]
    out = torch.cat([torch.stack([mean, var, mn, mx, nnz]).reshape(-1),
                     count]).cpu().numpy()
    m = out[:5 * d].reshape(5, d)
    return ColStats(count=int(out[-1]), mean=m[0], variance=m[1], min=m[2],
                    max=m[3], num_nonzeros=m[4].astype(np.int64))


def correlation_matrix(X, w: Optional[np.ndarray] = None) -> np.ndarray:
    """Weighted Pearson correlation matrix via one gram product on ``X``'s
    device, in float64."""
    X = _f64(X)
    n = X.shape[0]
    w = _weights(w, n, X)
    wsum = w.sum()
    mean = (w @ X) / wsum
    Xc = (X - mean) * torch.sqrt(w)[:, None]
    # population normalization; the 1/wsum factor cancels in corr = cov/sd²
    cov = (Xc.T @ Xc) / wsum
    sd = torch.sqrt(torch.diagonal(cov))
    denom = torch.outer(sd, sd)
    corr = torch.where(denom > 0, cov / torch.where(denom > 0, denom, 1.0),
                       torch.nan)
    return corr.cpu().numpy()


def correlation_with_label(X, y, w: Optional[np.ndarray] = None
                           ) -> np.ndarray:
    """Pearson correlation of each feature column with the label
    (reference SanityChecker.scala:535), computed per column on ``X``'s
    device in float64, with the population normalization of
    :func:`correlation_matrix`. ``y`` may lie on the host."""
    X = _f64(X)
    y = _f64(y, X.device).reshape(-1).to(X.device)
    n = X.shape[0]
    w = _weights(w, n, X)
    wsum = w.sum()
    sw = torch.sqrt(w)
    Xc = (X - (w @ X) / wsum) * sw[:, None]
    yc = (y - torch.sum(w * y) / wsum) * sw
    cov = (yc @ Xc) / wsum
    sd = torch.sqrt((torch.sum(Xc * Xc, dim=0) / wsum)
                    * (torch.sum(yc * yc) / wsum))
    corr = torch.where(sd > 0, cov / torch.where(sd > 0, sd, 1.0), torch.nan)
    return corr.cpu().numpy()


@dataclass
class ContingencyStats:
    """Results of contingency-table analysis for one categorical group
    (reference OpStatistics.contingencyStats:117)."""
    chi2: float
    p_value: float
    cramers_v: float
    mutual_info: float
    pointwise_mutual_info: np.ndarray  # shape (n_levels, n_labels)
    max_rule_confidences: np.ndarray   # per categorical level
    supports: np.ndarray               # per categorical level


def chi_square(table: np.ndarray) -> Tuple[float, float, int]:
    """Pearson chi-squared statistic, p-value, dof for a contingency table."""
    t = np.asarray(table, dtype=np.float64)
    rows = t.sum(axis=1, keepdims=True)
    cols = t.sum(axis=0, keepdims=True)
    total = t.sum()
    if total <= 0:
        return 0.0, 1.0, 0
    keep_r = rows.ravel() > 0
    keep_c = cols.ravel() > 0
    t = t[keep_r][:, keep_c]
    rows, cols = rows[keep_r], cols[:, keep_c]
    expected = rows * cols / total
    with np.errstate(divide="ignore", invalid="ignore"):
        stat = float(np.nansum((t - expected) ** 2 / expected))
    dof = max((t.shape[0] - 1) * (t.shape[1] - 1), 0)
    if dof == 0:
        return stat, 1.0, 0
    from scipy.stats import chi2 as _chi2
    p = float(_chi2.sf(stat, dof))
    return stat, p, dof


def cramers_v(table: np.ndarray) -> float:
    """Cramér's V (reference OpStatistics.cramersV:300, no bias correction
    beyond min-dimension normalization)."""
    t = np.asarray(table, dtype=np.float64)
    t = t[t.sum(axis=1) > 0][:, t.sum(axis=0) > 0]
    if t.size == 0:
        return float("nan")
    stat, _, _ = chi_square(t)
    n = t.sum()
    k = min(t.shape[0] - 1, t.shape[1] - 1)
    if n <= 0 or k <= 0:
        return float("nan")
    return float(np.sqrt(stat / (n * k)))


def contingency_stats(table: np.ndarray) -> ContingencyStats:
    """All association stats for one (categorical level x label) table
    (reference OpStatistics.contingencyStats:117-133)."""
    t = np.asarray(table, dtype=np.float64)
    total = t.sum()
    stat, p, _ = chi_square(t)
    cv = cramers_v(t)
    # mutual information in bits, as the reference's log2
    with np.errstate(divide="ignore", invalid="ignore"):
        pxy = t / total if total > 0 else t
        px = pxy.sum(axis=1, keepdims=True)
        py = pxy.sum(axis=0, keepdims=True)
        pmi = np.log2(pxy / (px * py))
        pmi[~np.isfinite(pmi)] = 0.0
        mi = float(np.nansum(np.where(pxy > 0, pxy * pmi, 0.0)))
    row_tot = t.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        conf = np.where(row_tot[:, None] > 0, t / row_tot[:, None], 0.0)
    max_conf = conf.max(axis=1) if t.size else np.zeros(0)
    support = row_tot / total if total > 0 else row_tot
    return ContingencyStats(chi2=stat, p_value=p, cramers_v=cv,
                            mutual_info=mi, pointwise_mutual_info=pmi,
                            max_rule_confidences=max_conf, supports=support)
