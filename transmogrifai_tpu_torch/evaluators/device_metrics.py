"""On-device validation metrics for the selector search.

Counterpart of ``transmogrifai_tpu/evaluators/device_metrics.py``. The
search computes each candidate's metric where the candidate was fitted,
so only one float per candidate reaches the host. Semantics match the host
evaluator exactly (tie-aware Spark ``BinaryClassificationMetrics`` curves,
``evaluators/binary.py`` ``_curve_points``): every position's cumulative
counts are replaced by the counts at the end of its score-tie run (a
reversed running minimum over end-of-run indices), so duplicated curve
points add zero-width trapezoids. The multiclass metrics are weighted over
all K classes with absent classes at zero weight (the host loop over the
labels present); the regression metrics are RMSE, MSE, R² and MAE.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..utils import ref_math

__all__ = ["BINARY_METRICS", "MULTICLASS_METRICS", "REGRESSION_METRICS",
           "binary_from_raw_pair", "binary_from_sigmoid",
           "binary_from_votes", "binary_metric", "metric_fn",
           "multiclass_metric", "regression_metric", "softmax_probability",
           "vote_probability"]

BINARY_METRICS = ("AuPR", "AuROC", "Precision", "Recall", "F1", "Error")
MULTICLASS_METRICS = ("F1", "Precision", "Recall", "Error")
REGRESSION_METRICS = ("RootMeanSquaredError", "MeanSquaredError", "R2",
                      "MeanAbsoluteError")


def softmax_probability(raw: torch.Tensor) -> torch.Tensor:
    """(n, K) max-shifted softmax — the twin of
    ``ClassifierModel.raw_to_probability`` (on the CPU with the JAX
    package's CPU ``exp``, ``utils/ref_math.py``)."""
    return ref_math.softmax(raw, dim=1)


def binary_from_raw_pair(raw: torch.Tensor):
    """(score, plabel) from an (n, 2) raw-prediction pair through the
    default softmax (the logistic-regression host model)."""
    p = softmax_probability(raw)
    return p[:, 1], (p[:, 1] > p[:, 0]).to(raw.dtype)


def binary_from_sigmoid(margin: torch.Tensor):
    """(score, plabel) from GBT margins — the twin of
    ``GBTClassifierModel.raw_to_probability`` (p = sigmoid(margin), label
    = argmax of [1 - p, p]): on the CPU with the JAX package's CPU
    arithmetic in float64 (``utils/ref_math.py``, the card's float64
    witness too), on the card's float32 in the host model's order of
    operations."""
    p = (ref_math.sigmoid(margin) if margin.dtype == torch.float64
         else 1.0 / (1.0 + torch.exp(-margin)))
    return p, (p > 1.0 - p).to(margin.dtype)


def vote_probability(votes: torch.Tensor) -> torch.Tensor:
    """(n, K) vote masses normalized by their row sums — the twin of
    ``TreeEnsembleClassifierModel.raw_to_probability``."""
    s = torch.sum(votes, dim=1, keepdim=True)
    return votes / torch.where(s > 0, s, 1.0)


def binary_from_votes(votes: torch.Tensor):
    """(score, plabel) from (n, 2) forest vote masses: the normalized
    positive share and the argmax of the two."""
    p = vote_probability(votes)
    return p[:, 1], (p[:, 1] > p[:, 0]).to(votes.dtype)


def _tie_grouped_curve(pos: torch.Tensor, margin: torch.Tensor):
    """Cumulative (tp, fp) per position, each taken at the END of its
    score-tie run (descending order), plus the positive and negative
    totals. ``pos`` is the 0/1 positive indicator."""
    n = margin.shape[0]
    order = torch.argsort(-margin, stable=True)
    ys = pos[order]
    ss = margin[order]
    tp = torch.cumsum(ys, 0)
    fp = torch.cumsum(1.0 - ys, 0)
    idx = torch.arange(n, device=margin.device)
    is_end = torch.cat([ss[1:] != ss[:-1],
                        torch.ones(1, dtype=torch.bool, device=ss.device)])
    # smallest j >= i with is_end[j]: running minimum from the right
    run_end = torch.flip(torch.cummin(torch.flip(
        torch.where(is_end, idx, n - 1), (0,)), 0).values, (0,))
    return tp[run_end], fp[run_end], tp[-1], fp[-1]


def binary_metric(y: torch.Tensor, score: torch.Tensor,
                  plabel: torch.Tensor, metric: str) -> torch.Tensor:
    """Scalar binary metric from the ranking score (the host's
    positive-class probability) and the 0/1 hard label; matches
    ``evaluators.binary.binary_metrics`` (curve metrics are 0 for
    single-class ``y``)."""
    if metric not in BINARY_METRICS:
        raise ValueError(f"unsupported binary device metric {metric!r}")
    pos = (y == 1).to(score.dtype)
    n = y.shape[0]
    if metric in ("AuPR", "AuROC"):
        tp_a, fp_a, npos, nneg = _tie_grouped_curve(pos, score)
        tpr = tp_a / torch.clamp(npos, min=1.0)
        zero = torch.zeros(1, dtype=tpr.dtype, device=tpr.device)
        if metric == "AuROC":
            fpr = fp_a / torch.clamp(nneg, min=1.0)
            xs = torch.cat([zero, fpr, zero + 1.0])
            ys_ = torch.cat([zero, tpr, zero + 1.0])
        else:
            prec = tp_a / torch.clamp(tp_a + fp_a, min=1.0)
            xs = torch.cat([zero, tpr])
            ys_ = torch.cat([prec[:1], prec])
        area = torch.sum(torch.diff(xs) * (ys_[1:] + ys_[:-1]) * 0.5)
        return torch.where((npos > 0) & (nneg > 0), area,
                           torch.zeros((), dtype=area.dtype,
                                       device=area.device))
    predicted = (plabel == 1).to(score.dtype)
    tp = torch.sum(predicted * pos)
    fp = torch.sum(predicted * (1.0 - pos))
    fn = torch.sum((1.0 - predicted) * pos)
    if metric == "Error":
        return (fp + fn) / max(n, 1)
    precision = torch.where(tp + fp > 0, tp / torch.clamp(tp + fp, min=1.0),
                            0.0)
    recall = torch.where(tp + fn > 0, tp / torch.clamp(tp + fn, min=1.0),
                         0.0)
    if metric == "Precision":
        return precision
    if metric == "Recall":
        return recall
    return torch.where(precision + recall > 0,
                       2.0 * precision * recall
                       / torch.clamp(precision + recall, min=1e-300), 0.0)


def multiclass_metric(y: torch.Tensor, prob: torch.Tensor,
                      metric: str) -> torch.Tensor:
    """Scalar multiclass metric from the (n, K) probability matrix (hard
    label = argmax, the first index on ties, as the host ``np.argmax``).
    Weighted precision, recall and F1 over all K classes; a class absent
    from ``y`` carries zero weight, so the sum equals the host loop over
    ``np.unique(y)``."""
    if metric not in MULTICLASS_METRICS:
        raise ValueError(f"unsupported multiclass device metric {metric!r}")
    k = prob.shape[1]
    pred = torch.argmax(prob, dim=1)
    yi = y.long()
    n = max(y.shape[0], 1)
    if metric == "Error":
        return torch.mean((pred != yi).to(prob.dtype))
    eye = torch.eye(k, dtype=prob.dtype, device=prob.device)
    y_oh = eye[yi]
    p_oh = eye[pred]
    tp = torch.sum(y_oh * p_oh, dim=0)
    fp = torch.sum(p_oh, dim=0) - tp
    fn = torch.sum(y_oh, dim=0) - tp
    weight = torch.sum(y_oh, dim=0) / n
    p = torch.where(tp + fp > 0, tp / torch.clamp(tp + fp, min=1.0), 0.0)
    r = torch.where(tp + fn > 0, tp / torch.clamp(tp + fn, min=1.0), 0.0)
    if metric == "Precision":
        return torch.sum(weight * p)
    if metric == "Recall":
        return torch.sum(weight * r)
    f = torch.where(p + r > 0,
                    2.0 * p * r / torch.clamp(p + r, min=1e-300), 0.0)
    return torch.sum(weight * f)


def regression_metric(y: torch.Tensor, pred: torch.Tensor,
                      metric: str) -> torch.Tensor:
    """Scalar regression metric (``evaluators/regression.py`` on the
    device); R² is 0 for a constant label."""
    if metric not in REGRESSION_METRICS:
        raise ValueError(f"unsupported regression device metric {metric!r}")
    err = pred - y
    if metric == "MeanAbsoluteError":
        return torch.mean(torch.abs(err))
    mse = torch.mean(err * err)
    if metric == "MeanSquaredError":
        return mse
    if metric == "RootMeanSquaredError":
        return torch.sqrt(mse)
    ss_tot = torch.sum((y - torch.mean(y)) ** 2)
    return torch.where(ss_tot > 0, 1.0 - torch.sum(err * err) / ss_tot,
                       torch.zeros((), dtype=err.dtype, device=err.device))


def metric_fn(kind: str, metric: str) -> Callable:
    """(y_val, scores) -> scalar for a validator metric spec.

    kind "binary"     : ``scores`` is a (score, plabel) pair from
                        :func:`binary_from_sigmoid`,
                        :func:`binary_from_votes`,
                        :func:`binary_from_raw_pair`, or a raw margin with
                        its sign label (LinearSVC)
    kind "multiclass" : ``scores`` is the (n, K) probability matrix
    kind "regression" : ``scores`` is the (n,) predicted values
    """
    if kind == "binary":
        return lambda y, s: binary_metric(y, s[0], s[1], metric)
    if kind == "multiclass":
        return lambda y, s: multiclass_metric(y, s, metric)
    if kind == "regression":
        return lambda y, s: regression_metric(y, s, metric)
    raise ValueError(f"unknown metric kind {kind!r}")
