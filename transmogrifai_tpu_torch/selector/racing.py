"""Multi-fidelity racing search: successive-halving validation.

Counterpart of ``transmogrifai_tpu/selector/racing.py``.
``RacingCrossValidation`` stops paying full cross-validation cost for
losing candidates: the whole family x grid pool is first evaluated at a
low fidelity (a subset of folds and/or a row-subsampled train mask), the
top ``1/eta`` by the evaluator's device metric re-enter the next rung at
``eta`` times the fidelity, and only the final survivors are evaluated
under the exact full-CV fold protocol (successive halving; cf. Li et al.,
arxiv 1810.05934). Each rung calls the families' ``eval_fold_grid_arrays``
searches on the card with ``cand_idx``, the surviving grid points, so a
candidate's fitted parameters never reach the host: only the (folds,
candidates) metric matrix does.

Kept as the JAX package has them: the ladder (``_rung_budgets``), the
budget-to-fidelity rule (``_fidelity``), the seeded numpy rung masks
(``_rung_masks``), the deterministic prune order (``_prune_rung``: metric,
non-finite last, then (family, grid) index), the row slice of single-fold
rungs (their kept train rows are gathered, on the card for a tensor, so a
low-fidelity rung costs proportionally less) and the exactness contract:
the final rung evaluates the survivors under the same folds, masks and
metric kernel as exact full CV, so a racing winner's metric equals its
full-CV one. Families without a device metric path leave the race and are
validated at full fidelity candidate by candidate; their results join the
final comparison.

Each rung's family searches run behind the validator's runtime
(``_dispatch_device_evals``), as in the JAX package: a rung's matrices are
journaled under ``rung<r>``, a resume replays rungs ``0..r-1`` and
dispatches only from rung ``r`` (the ``rung:<r>:boundary`` probe is the
kill point between rungs), a quarantined family leaves the race with no
results, and the families validated exactly after leaving the race are
journaled under ``exact``.

Left out: the mesh (one card: the JAX package's ``pad_cand_idx`` with one
shard is the identity) and the ``TuningPolicy``: with no ``eta`` or
``min_fidelity`` given, the schedule is the registry's static default
(``tuning/registry.py``: eta 3, min_fidelity 1/eta**2), which is what the
JAX package decides with a cold profile store or ``TX_TUNE=off``.
"""
from __future__ import annotations

import functools
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.base import Predictor
from ..observability import trace as _trace
from ..runtime import telemetry as _telemetry
from ..runtime.faults import maybe_inject
from ..utils.device import take_rows
from .validator import (_QUARANTINED, BestEstimator, CrossValidation,
                        ValidationResult, _guarded)

__all__ = ["RacingCrossValidation", "search_compiles"]

_log = logging.getLogger(__name__)

#: (family, folds, rows, candidates, spec) rung signatures dispatched
_RUNG_KEYS: set = set()


def search_compiles() -> int:
    """Distinct racing rung signatures (family, folds, train rows,
    candidates, metric spec) dispatched so far in this process. The JAX
    package compiles one XLA program per signature; the port's eager torch
    ops compile nothing, so here the count is of distinct rung shapes the
    card was handed. A repeated same-shape search adds none, as there."""
    return len(_RUNG_KEYS)


class _Racer:
    """Bookkeeping for one raced candidate (family index, grid index)."""

    __slots__ = ("fam", "gi", "alive", "rung", "budget", "pruned_at",
                 "metrics")

    def __init__(self, fam: int, gi: int):
        self.fam = fam
        self.gi = gi
        self.alive = True
        self.rung: Optional[int] = None
        self.budget = 0.0
        self.pruned_at: Optional[int] = None
        self.metrics: List[float] = []

    def mean(self) -> float:
        arr = np.asarray(self.metrics, dtype=np.float64)
        return float(np.mean(arr)) if arr.size else float("nan")


class RacingCrossValidation(CrossValidation):
    """Successive-halving k-fold search (``validation="racing"``).

    eta          : promotion ratio, each rung keeps the top ``1/eta``
    min_fidelity : budget fraction of the first rung (full CV = 1.0);
                   default ``1/eta**2``, the classic 3-rung ladder (eta 3:
                   1/9, 1/3, 1). The ladder always ends at exactly 1.0:
                   the final rung is full CV for the survivors.
    """

    validation_type = "RacingCrossValidation"

    def __init__(self, evaluator, num_folds: int = 3,
                 eta: Optional[int] = None,
                 min_fidelity: Optional[float] = None, seed: int = 42,
                 stratify: bool = False):
        super().__init__(evaluator, num_folds=num_folds, seed=seed,
                         stratify=stratify)
        if eta is None:
            from ..tuning.registry import STATIC_DEFAULTS
            eta = int(STATIC_DEFAULTS["search.eta"])
        if eta < 2:
            raise ValueError("eta must be >= 2")
        self.eta = int(eta)
        mf = (1.0 / (eta * eta)) if min_fidelity is None else float(
            min_fidelity)
        if not 0.0 < mf <= 1.0:
            raise ValueError("min_fidelity must be in (0, 1]")
        self.min_fidelity = mf
        #: the last validate() call's record (rungs, budgets, pruned
        #: counts); the selector copies it into ModelSelectorSummary.racing
        self.last_report: Dict = {}
        #: the last validate() call's rows of each rung's matrix (a
        #: single-fold screening rung's sliced rows) and seconds by rung
        #: and family (host clock; each family's search ends in its
        #: metric read-back)
        self.rung_profile: List[Dict] = []

    @classmethod
    def from_cross_validation(cls, cv: CrossValidation,
                              eta: Optional[int] = None,
                              min_fidelity: Optional[float] = None
                              ) -> "RacingCrossValidation":
        """Racing twin of an exact CV validator (same folds, same seed,
        same evaluator; only the schedule changes)."""
        return cls(cv.evaluator, num_folds=cv.num_folds, eta=eta,
                   min_fidelity=min_fidelity, seed=cv.seed,
                   stratify=cv.stratify)

    def get_params(self):
        out = super().get_params()
        out.update({"eta": self.eta, "minFidelity": self.min_fidelity,
                    "validation": "racing"})
        return out

    # -- schedule ----------------------------------------------------------
    def _rung_budgets(self) -> List[float]:
        """Ascending budget fractions ending at exactly 1.0 (the full-CV
        rung): min_fidelity * eta^r, capped."""
        budgets: List[float] = []
        b = self.min_fidelity
        while b < 1.0 - 1e-12:
            budgets.append(b)
            b *= self.eta
        budgets.append(1.0)
        return budgets

    def _prune_rung(self, contenders: List[_Racer], rung: int) -> int:
        """The rung-boundary prune: the top ``1/eta`` by mean metric (the
        evaluator's sign; non-finite last; (family, grid) index as the
        tie-break) are kept, with no RNG and no clock. Returns the kept
        count."""
        sign = 1.0 if self.evaluator.is_larger_better else -1.0
        scored = sorted(
            contenders,
            key=lambda rc: (-(sign * rc.mean())
                            if np.isfinite(rc.mean())
                            else np.inf, rc.fam, rc.gi))
        keep = max(1, int(np.ceil(len(scored) / self.eta)))
        for rc in scored[keep:]:
            rc.alive = False
            rc.pruned_at = rung
        return keep

    def _fidelity(self, budget: float, n_folds: int) -> Tuple[int, float]:
        """(folds, train-row fraction) realizing a budget fraction, in
        full-CV units: folds * row_fraction = budget * num_folds fold-fit
        equivalents."""
        fold_units = budget * n_folds
        folds = min(n_folds, max(1, int(round(fold_units))))
        return folds, min(1.0, fold_units / folds)

    def _rung_masks(self, masks: np.ndarray, y: np.ndarray, rung: int,
                    folds: int, row_frac: float) -> np.ndarray:
        """Per-rung train masks: the first ``folds`` folds of the full CV
        protocol, with a deterministic row subsample (stratified when the
        splits are) zeroed into the mask."""
        sub = np.array(masks[:folds], copy=True)
        if row_frac >= 1.0:
            return sub
        for f in range(folds):
            rng = np.random.default_rng(
                [int(self.seed), 104729, int(rung), f])
            idx = np.nonzero(sub[f] > 0)[0]
            if self.stratify:
                kept = [rng.permutation(ci)[:max(1, int(round(
                    len(ci) * row_frac)))]
                    for cls in np.unique(y[idx])
                    for ci in [idx[y[idx] == cls]]]
                keep = np.concatenate(kept)
            else:
                keep = rng.permutation(idx)[
                    :max(1, int(round(len(idx) * row_frac)))]
            sub[f, np.setdiff1d(idx, keep)] = 0.0
        return sub

    # -- the racing loop ---------------------------------------------------
    def validate(self,
                 models: Sequence[Tuple[Predictor, Sequence[Dict]]],
                 X, y: np.ndarray) -> BestEstimator:
        t0 = time.perf_counter()
        models = [(est, list(grid) or [{}]) for est, grid in models]
        masks, spec, X_val_st, y_val_st = self._build_fold_arrays(X, y)
        F = masks.shape[0]
        budgets = self._rung_budgets()
        n_total = sum(len(grid) for _, grid in models)
        self.rung_profile = []
        if spec is None or len(budgets) < 2 or n_total <= 1:
            # nothing to race (no device metric, min_fidelity=1, a single
            # candidate): exact full CV
            _log.info("racing disabled for this search (no device metric "
                      "path or degenerate schedule); running exact full CV")
            best = super().validate(models, X, y)
            self.last_report = {
                "raced": False, "eta": self.eta,
                "minFidelity": self.min_fidelity, "rungs": [],
                "candidatesTotal": n_total, "candidatesPruned": 0,
                "budgetSpentFoldFits": float(n_total * F),
                "budgetFullCvFoldFits": float(n_total * F),
                "searchSeconds": round(time.perf_counter() - t0, 3)}
            return best
        ctx = self._begin_runtime(models, X, y)
        try:
            return self._validate_raced(models, X, y, masks, spec,
                                        X_val_st, y_val_st, budgets,
                                        n_total, t0, ctx)
        finally:
            ctx.close_journal()

    def _validate_raced(self, models, X, y, masks, spec, X_val_st,
                        y_val_st, budgets, n_total, t0, ctx
                        ) -> BestEstimator:
        F = masks.shape[0]
        device = X.device if isinstance(X, torch.Tensor) else None
        racers: Dict[Tuple[int, int], _Racer] = {
            (fi, gi): _Racer(fi, gi)
            for fi, (_, grid) in enumerate(models)
            for gi in range(len(grid))}
        host_fams: List[int] = []       # families validated exactly
        quarantined_fams: set = set()   # families out of the search
        rung_rows: List[Dict] = []
        for r, b in enumerate(budgets):
            # the rung-boundary kill point: every completed rung below is
            # journaled, so a resume replays rungs 0..r-1 and dispatches
            # from here on
            maybe_inject("rung", str(r), "boundary")
            final = r == len(budgets) - 1
            folds_r, row_frac = self._fidelity(b, F)
            X_r, y_r = X, y
            if final:
                # the exactness invariant: the last rung IS full CV
                assert folds_r == F and row_frac >= 1.0
                rung_masks = masks
            else:
                rung_masks = self._rung_masks(masks, y, r, folds_r,
                                              row_frac)
                if folds_r == 1 and row_frac < 1.0:
                    # a single-fold screening rung slices its subsampled
                    # train rows out instead of zero-masking them, so low
                    # fidelity costs proportionally less; multi-fold rungs
                    # keep the shared matrix and edit the mask
                    kept = np.nonzero(rung_masks[0] > 0)[0]
                    X_r, y_r = take_rows(X, kept), y[kept]
                    rung_masks = np.ones((1, len(kept)))
            Xv_r, yv_r = X_val_st[:folds_r], y_val_st[:folds_r]
            fam_idx: List[Tuple[int, List[int]]] = []
            for fi, (est, grid) in enumerate(models):
                if fi in host_fams:
                    continue
                alive = [gi for gi in range(len(grid))
                         if racers[(fi, gi)].alive]
                if alive:
                    fam_idx.append((fi, alive))
            if not fam_idx:
                break
            n_evaluated = 0
            t_rung = time.perf_counter()
            fam_seconds: Dict[str, float] = {}

            def evaluate(est, grid, alive, X_r, y_r, rung_masks, Xv_r,
                         yv_r, fam_seconds):
                t_fam = time.perf_counter()
                try:
                    return self._try_device_eval(
                        est, grid, X_r, y_r, rung_masks, Xv_r, yv_r, spec,
                        cand_idx=np.asarray(alive, dtype=np.int64))
                finally:
                    name = type(est).__name__
                    fam_seconds[name] = (fam_seconds.get(name, 0.0)
                                         + time.perf_counter() - t_fam)

            tasks = []
            for fi, alive in fam_idx:
                est, grid = models[fi]
                name = type(est).__name__
                _RUNG_KEYS.add((name, folds_r, rung_masks.shape[1],
                                len(alive), spec))
                tasks.append((name, self._family_key(fi, est), tuple(alive),
                              functools.partial(
                                  evaluate, est, grid, alive, X_r, y_r,
                                  rung_masks, Xv_r, yv_r, fam_seconds)))
            with _trace.span("search.rung", rung=r, final=final,
                             folds=folds_r, budget=round(float(b), 4),
                             families=len(fam_idx),
                             alive=sum(len(a) for _, a in fam_idx)):
                mats = self._dispatch_device_evals(
                    tasks, folds_r, ctx, rung=r, rung_label=f"rung{r}",
                    device=device)
            for (fi, alive), mm in zip(fam_idx, mats):
                est, grid = models[fi]
                if mm is _QUARANTINED:
                    # out of this search: no results and no exact
                    # fallback; the quarantine ledger says why
                    quarantined_fams.add(fi)
                    for gi in range(len(grid)):
                        racers[(fi, gi)].alive = False
                    continue
                if mm is None:
                    # the family cannot race (no device path for these
                    # labels or this metric): validate it exactly at full
                    # fidelity through the ordinary paths instead
                    _log.info("family %s leaves the race at rung %d; "
                              "validating it under exact full CV",
                              type(est).__name__, r)
                    host_fams.append(fi)
                    for gi in range(len(grid)):
                        racers[(fi, gi)].alive = False
                    continue
                mm = np.asarray(mm, dtype=np.float64)
                n_evaluated += len(alive)
                for j, gi in enumerate(alive):
                    racer = racers[(fi, gi)]
                    racer.rung = r
                    racer.budget += folds_r * row_frac
                    racer.metrics = [float(v) for v in mm[:, j]]
            contenders = [rc for rc in racers.values() if rc.alive]
            promoted = len(contenders)
            if not final and contenders:
                promoted = self._prune_rung(contenders, r)
            rung_rows.append({
                "rung": r, "budgetFraction": round(b, 6),
                "folds": folds_r, "rowFraction": round(row_frac, 6),
                "candidates": n_evaluated, "promoted": promoted})
            self.rung_profile.append({
                "rung": r, "rows": int(rung_masks.shape[1]),
                "seconds": time.perf_counter() - t_rung,
                "familySeconds": fam_seconds})
        # exact validation for the families that left the race, journaled
        # under "exact"; a classified failure quarantines the family
        host_results: Dict[int, List[ValidationResult]] = {}
        fold_data = None
        for fi in host_fams:
            est, grid = models[fi]
            key = self._family_key(fi, est)
            cands = tuple(range(len(grid)))
            cached = ctx.journal_lookup(key, "exact", cands)
            if cached is not None:
                host_results[fi] = self._results_from_journal(est, grid,
                                                              cached)
                continue

            def evaluate_exact():
                mm = self._try_device_eval(est, grid, X, y, masks, X_val_st,
                                           y_val_st, spec)
                if mm is not None:
                    return self._results_from_matrix(est, grid, mm)
                nonlocal fold_data
                if fold_data is None:
                    fold_data = self._fold_data(X, y)
                return self._family_host_results(est, grid, X, y, masks,
                                                 fold_data)

            host_results[fi] = _guarded(ctx, type(est).__name__,
                                        evaluate_exact)
            if host_results[fi] is _QUARANTINED:
                quarantined_fams.add(fi)
                host_results[fi] = []
                continue
            _telemetry.note_dispatch(key, "exact", cands, F)
            ctx.journal_record(
                key, "exact", cands,
                [res.metric_values for res in host_results[fi]], F)
        # assemble results in the exact path's family/grid order
        results: List[ValidationResult] = []
        rank_pool: List[ValidationResult] = []
        for fi, (est, grid) in enumerate(models):
            if fi in quarantined_fams:
                continue
            if fi in host_fams:
                results.extend(host_results[fi])
                # full-fidelity metrics: they compete with the finalists
                rank_pool.extend(host_results[fi])
                continue
            for gi, params in enumerate(grid):
                rc = racers[(fi, gi)]
                res = ValidationResult(
                    model_name=type(est).__name__, model_uid=est.uid,
                    grid_index=gi, params=dict(params),
                    metric_values=list(rc.metrics),
                    rung=rc.rung if rc.rung is not None else 0,
                    budget_spent=round(rc.budget, 6),
                    pruned_at=rc.pruned_at)
                results.append(res)
                if rc.pruned_at is None and rc.rung is not None:
                    rank_pool.append(res)
        spent = sum(rc.budget for rc in racers.values()) \
            + float(sum(len(models[fi][1]) for fi in host_fams
                        if fi not in quarantined_fams)) * F
        self.last_report = {
            "raced": True, "eta": self.eta,
            "minFidelity": self.min_fidelity, "rungs": rung_rows,
            "candidatesTotal": n_total,
            "candidatesPruned": sum(
                1 for rc in racers.values() if rc.pruned_at is not None),
            "budgetSpentFoldFits": round(spent, 3),
            "budgetFullCvFoldFits": float(n_total * F),
            "searchSeconds": round(time.perf_counter() - t0, 3)}
        return self._pick_best(models, results, rank_pool=rank_pool,
                               ctx=ctx)
