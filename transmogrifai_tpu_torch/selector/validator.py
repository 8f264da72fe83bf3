"""k-fold cross-validation over model families (device-resident search).

Counterpart of ``transmogrifai_tpu/selector/validator.py``
(``CrossValidation``: ``_assignments``, ``_build_fold_arrays``,
``_try_device_eval``, ``_results_from_matrix``, ``_pick_best``,
``ValidationResult``, ``BestEstimator``, ``family_profile``). Each family
evaluates its whole fold x grid on its device and returns one (folds,
grid) metric matrix. The reference's journal, retries, deadlines, mesh,
concurrent family dispatch, racing and host evaluation path are not
ported yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..evaluators.base import Evaluator
from ..models.base import Predictor
from ..utils.device import take_rows

__all__ = ["ValidationResult", "BestEstimator", "CrossValidation",
           "family_profile", "reset_family_profile"]

#: per-family search accounting (seconds, nvcc build seconds, calls),
#: accumulated across every search in this process
_FAMILY_PROFILE: Dict[str, Dict[str, float]] = {}


def family_profile() -> List[dict]:
    """Per-family search profile rows, slowest first: ``{"family",
    "seconds", "compileSeconds", "executeSeconds", "calls"}``. A family's
    seconds run from its dispatch to the read-back of its metric matrix,
    which waits for the device. ``compileSeconds`` is the ``nvcc`` build
    time of the port's kernels (``_build.py``) spent inside the dispatch:
    0 once they are built. The JAX package's XLA trace and compile time,
    which the field holds there, has no counterpart in the port's eager
    ops."""
    return [
        {"family": k, "seconds": round(v["seconds"], 4),
         "compileSeconds": round(min(v["compile"], v["seconds"]), 4),
         "executeSeconds": round(
             max(0.0, v["seconds"] - v["compile"]), 4),
         "calls": int(v["calls"])}
        for k, v in sorted(_FAMILY_PROFILE.items(),
                           key=lambda kv: -kv[1]["seconds"])]


def reset_family_profile() -> None:
    _FAMILY_PROFILE.clear()


@dataclass
class ValidationResult:
    """Metric record for one (model family, grid point)."""
    model_name: str
    model_uid: str
    grid_index: int
    params: Dict
    metric_values: List[float] = field(default_factory=list)

    @property
    def mean_metric(self) -> float:
        return float(np.mean(self.metric_values))

    def to_json(self) -> dict:
        return {"modelName": self.model_name, "modelUID": self.model_uid,
                "gridIndex": self.grid_index, "params": self.params,
                "metricValues": [float(v) for v in self.metric_values],
                "meanMetric": self.mean_metric}

    @classmethod
    def from_json(cls, d: dict) -> "ValidationResult":
        return cls(model_name=d["modelName"], model_uid=d["modelUID"],
                   grid_index=d["gridIndex"], params=dict(d["params"]),
                   metric_values=list(d["metricValues"]))


@dataclass
class BestEstimator:
    """Winner of validation."""
    estimator: Predictor
    name: str
    params: Dict
    metric: float
    results: List[ValidationResult] = field(default_factory=list)


class CrossValidation:
    """k-fold CV with equal-sized folds."""

    def __init__(self, evaluator: Evaluator, num_folds: int = 3,
                 seed: int = 42, stratify: bool = False):
        if num_folds < 2:
            raise ValueError("num_folds must be >= 2")
        self.evaluator = evaluator
        self.num_folds = num_folds
        self.seed = seed
        self.stratify = stratify

    def get_params(self) -> Dict:
        return {"numFolds": self.num_folds, "seed": self.seed,
                "stratify": self.stratify}

    def _assignments(self, y: np.ndarray, k: int) -> np.ndarray:
        """Fold id per row; -1 = dropped. Folds are exactly equal-sized
        (up to k-1 remainder rows per stratum are dropped), as in the
        reference, so the validation folds stack."""
        rng = np.random.default_rng(self.seed)
        assign = np.full(len(y), -1, dtype=np.int64)

        def round_robin(idx: np.ndarray):
            m = (len(idx) // k) * k
            perm = rng.permutation(idx)
            assign[perm[:m]] = np.arange(m) % k

        if self.stratify:
            for cls in np.unique(y):
                round_robin(np.nonzero(y == cls)[0])
        else:
            round_robin(np.arange(len(y)))
        return assign

    def _splits(self, y: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
        assign = self._assignments(y, self.num_folds)
        return [(np.nonzero((assign != f) & (assign >= 0))[0],
                 np.nonzero(assign == f)[0])
                for f in range(self.num_folds)]

    def _build_fold_arrays(self, X, y: np.ndarray):
        """(masks (F, n), spec, X_val_st (F, nv, d), y_val_st (F, nv)):
        fold train masks over the prepared matrix and the stacked
        validation folds (gathered on X's device when X is a tensor)."""
        splits = self._splits(y)
        masks = np.zeros((len(splits), len(y)))
        for f, (train_idx, _) in enumerate(splits):
            masks[f, train_idx] = 1.0
        spec = self.evaluator.device_metric_spec()
        folds = [take_rows(X, va) for _, va in splits]
        X_val_st = (torch.stack(folds) if isinstance(X, torch.Tensor)
                    else np.stack(folds))
        y_val_st = np.stack([y[va] for _, va in splits])
        return masks, spec, X_val_st, y_val_st

    def _try_device_eval(self, estimator, grid, X, y, masks, X_val_st,
                         y_val_st, spec) -> Optional[np.ndarray]:
        """(F, G) metric matrix from the family's fused fit+metric path,
        or None when the family or metric has none."""
        if spec is None or not hasattr(estimator, "eval_fold_grid_arrays"):
            return None
        t0, b0 = time.perf_counter(), _build.build_seconds()
        try:
            return estimator.eval_fold_grid_arrays(
                X, y, masks, grid, X_val_st, y_val_st, spec)
        except NotImplementedError:
            return None
        finally:
            rec = _FAMILY_PROFILE.setdefault(
                type(estimator).__name__,
                {"seconds": 0.0, "compile": 0.0, "calls": 0})
            rec["seconds"] += time.perf_counter() - t0
            rec["compile"] += _build.build_seconds() - b0
            rec["calls"] += 1

    def _results_from_matrix(self, estimator, grid, mm
                             ) -> List[ValidationResult]:
        return [
            ValidationResult(
                model_name=type(estimator).__name__,
                model_uid=estimator.uid, grid_index=gi,
                params=dict(params),
                metric_values=[float(v) for v in mm[:, gi]])
            for gi, params in enumerate(grid)]

    def validate(self, models: Sequence[Tuple[Predictor, Sequence[Dict]]],
                 X, y: np.ndarray) -> BestEstimator:
        models = [(est, list(grid) or [{}]) for est, grid in models]
        masks, spec, X_val_st, y_val_st = self._build_fold_arrays(X, y)
        results: List[ValidationResult] = []
        for estimator, grid in models:
            mm = self._try_device_eval(estimator, grid, X, y, masks,
                                       X_val_st, y_val_st, spec)
            if mm is None:
                raise NotImplementedError(
                    f"{type(estimator).__name__} with metric "
                    f"{self.evaluator.default_metric!r} has no device "
                    f"search path, and the host path is not ported yet")
            results.extend(self._results_from_matrix(estimator, grid, mm))
        return self._pick_best(models, results)

    def _pick_best(self, models, results: List[ValidationResult]
                   ) -> BestEstimator:
        """Winner by mean metric; the first candidate wins a tie."""
        sign = 1.0 if self.evaluator.is_larger_better else -1.0
        finite = [r for r in results if np.isfinite(r.mean_metric)]
        if not finite:
            raise ValueError(
                "all validation metrics are non-finite; cannot select a "
                "model (check for degenerate folds — e.g. a fold with a "
                "single class; stratify=True may help)")
        best = max(finite, key=lambda r: sign * r.mean_metric)
        by_uid = {est.uid: est for est, _ in models}
        winner = by_uid[best.model_uid].with_params(**best.params)
        return BestEstimator(estimator=winner, name=best.model_name,
                             params=best.params, metric=best.mean_metric,
                             results=results)
