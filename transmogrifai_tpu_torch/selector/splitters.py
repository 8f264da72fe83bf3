"""Data splitters: holdout reserve, class balancing and label cutting
(numpy).

Counterpart of ``transmogrifai_tpu/selector/splitters.py`` (``Splitter``,
``DataSplitter``, ``DataBalancer``, ``DataCutter``, ``stratified_split``);
the same seed gives the same indices. Splitters are index computations
over the label vector.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["SplitterSummary", "Splitter", "DataSplitter", "DataBalancer",
           "DataCutter", "stratified_split"]


def stratified_split(y: np.ndarray, test_fraction: float,
                     rng: np.random.Generator
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(train_idx, test_idx) with per-class proportional sampling."""
    n = len(y)
    mask = np.zeros(n, dtype=bool)
    for cls in np.unique(y):
        idx = rng.permutation(np.nonzero(y == cls)[0])
        mask[idx[:int(round(len(idx) * test_fraction))]] = True
    return np.nonzero(~mask)[0], np.nonzero(mask)[0]


def _sample_frac(idx: np.ndarray, fraction: float,
                 rng: np.random.Generator) -> np.ndarray:
    """Without-replacement sample of ``round(fraction * len)`` rows."""
    if fraction >= 1.0 or not len(idx):
        return idx
    return rng.choice(idx, int(round(fraction * len(idx))), replace=False)


@dataclass
class SplitterSummary:
    """Data-prep record attached to the selector summary."""
    splitter: str = ""
    parameters: Dict = field(default_factory=dict)
    results: Dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"splitter": self.splitter, "parameters": self.parameters,
                "results": self.results}


class Splitter:
    """Base: optionally reserve a test fraction, then prepare (resample)
    the training portion."""

    def __init__(self, reserve_test_fraction: float = 0.0, seed: int = 42):
        if not 0.0 <= reserve_test_fraction < 1.0:
            raise ValueError("reserve_test_fraction must be in [0, 1)")
        self.reserve_test_fraction = reserve_test_fraction
        self.seed = seed
        self.summary: Optional[SplitterSummary] = None

    def split(self, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(train_idx, test_idx) — stratified on the label."""
        n = len(y)
        if self.reserve_test_fraction <= 0.0:
            return np.arange(n), np.zeros(0, dtype=np.int64)
        rng = np.random.default_rng(self.seed)
        return stratified_split(y, self.reserve_test_fraction, rng)

    def prepare(self, y: np.ndarray) -> np.ndarray:
        """Row indices (possibly resampled) to train on."""
        self.summary = SplitterSummary(splitter=type(self).__name__)
        return np.arange(len(y))

    def reset_plan(self) -> None:
        """Forget a stored resampling plan (a reused selector must not
        recycle it across datasets)."""

    def get_params(self) -> Dict:
        return {"reserve_test_fraction": self.reserve_test_fraction,
                "seed": self.seed}


class DataSplitter(Splitter):
    """Plain splitter of regression problems: an unstratified seeded
    holdout, every training row kept."""

    def split(self, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        n = len(y)
        if self.reserve_test_fraction <= 0.0:
            return np.arange(n), np.zeros(0, dtype=np.int64)
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        n_test = int(round(n * self.reserve_test_fraction))
        return np.sort(perm[n_test:]), np.sort(perm[:n_test])


class DataBalancer(Splitter):
    """Binary-label balancer: up-sample the minority / down-sample the
    majority until the minority fraction reaches ``sample_fraction``. The
    sampling proportions are a plan estimated once from the global label
    counts and reused by every later ``prepare``."""

    def __init__(self, sample_fraction: float = 0.1,
                 max_training_sample: int = 1_000_000,
                 reserve_test_fraction: float = 0.0, seed: int = 42):
        super().__init__(reserve_test_fraction, seed)
        if not 0.0 < sample_fraction < 0.5:
            raise ValueError("sample_fraction must be in (0, 0.5)")
        self.sample_fraction = sample_fraction
        self.max_training_sample = max_training_sample
        #: (is_positive_small, down, up, already_balanced_fraction)
        self._plan: Optional[Tuple[bool, float, float,
                                   Optional[float]]] = None

    def reset_plan(self) -> None:
        self._plan = None

    def _proportions(self, small: int, big: int) -> Tuple[float, float]:
        """(downSample, upSample) fractions: prefer integer up-sampling of
        the minority, capped so the balanced set stays under
        max_training_sample; otherwise down-sample both."""
        f = self.sample_fraction
        max_train = self.max_training_sample

        def up_ok(m: int) -> bool:
            return (m * small * (1.0 - f) < f * big
                    and max_train * f > small * m)

        if small < max_train * f:
            up = next((float(m) for m in (100, 50, 10, 5, 4, 3, 2)
                       if up_ok(m)), 1.0)
            return (small * up / f - small * up) / big, up
        up = (max_train * f) / small
        return (1.0 - f) * max_train / big, up

    def estimate(self, y: np.ndarray) -> None:
        """Compute and store the sampling plan from label counts."""
        n_pos = int(np.sum(y == 1))
        n_neg = int(len(y) - n_pos)
        total = max(n_pos + n_neg, 1)
        is_pos_small = n_pos < n_neg
        small, big = ((n_pos, n_neg) if is_pos_small else (n_neg, n_pos))
        if big == 0 or small / total >= self.sample_fraction:
            frac = (self.max_training_sample / total
                    if self.max_training_sample < total else 1.0)
            self._plan = (is_pos_small, frac, 0.0, frac)
            up, down = 0.0, frac
        else:
            down, up = self._proportions(small, big)
            self._plan = (is_pos_small, down, up, None)
        self.summary = SplitterSummary(
            splitter="DataBalancer", parameters=self.get_params(),
            results={"positiveCount": n_pos, "negativeCount": n_neg,
                     "desiredFraction": self.sample_fraction,
                     "upSamplingFraction": up,
                     "downSamplingFraction": down,
                     "balanced": self._plan[3] is None})

    def prepare(self, y: np.ndarray) -> np.ndarray:
        """Resampled row indices (may repeat: minority up-sampling draws
        with replacement); uses the stored plan when there is one."""
        if self._plan is None:
            self.estimate(y)
        is_pos_small, down, up, already_frac = self._plan
        rng = np.random.default_rng(self.seed)
        pos_idx = np.nonzero(y == 1)[0]
        neg_idx = np.nonzero(y != 1)[0]
        if already_frac is not None:
            if already_frac >= 1.0:
                return np.arange(len(y))
            return np.sort(np.concatenate([
                _sample_frac(neg_idx, already_frac, rng),
                _sample_frac(pos_idx, already_frac, rng)]))
        small, big = ((pos_idx, neg_idx) if is_pos_small
                      else (neg_idx, pos_idx))
        big_take = _sample_frac(big, min(down, 1.0), rng)
        if up > 1.0:
            small_take = rng.choice(
                small, int(round(up * len(small))), replace=True) \
                if len(small) else small
        elif up == 1.0:
            small_take = small
        else:
            small_take = _sample_frac(small, up, rng)
        return np.sort(np.concatenate([small_take, big_take]))

    def get_params(self) -> Dict:
        p = super().get_params()
        p.update({"sample_fraction": self.sample_fraction,
                  "max_training_sample": self.max_training_sample})
        return p


class DataCutter(Splitter):
    """Multiclass label cutter: drops the labels below
    ``min_label_fraction`` of the rows and keeps at most
    ``max_label_categories`` of the most frequent ones. The kept labels are
    estimated once from the global labels and reused by every later
    ``prepare``."""

    def __init__(self, min_label_fraction: float = 0.0,
                 max_label_categories: int = 100,
                 reserve_test_fraction: float = 0.0, seed: int = 42):
        super().__init__(reserve_test_fraction, seed)
        if not 0.0 <= min_label_fraction < 0.5:
            raise ValueError("min_label_fraction must be in [0, 0.5)")
        self.min_label_fraction = min_label_fraction
        self.max_label_categories = max_label_categories
        self.labels_kept: Optional[np.ndarray] = None

    def reset_plan(self) -> None:
        self.labels_kept = None

    def estimate(self, y: np.ndarray) -> None:
        """Decide which labels survive, from the label counts."""
        labels, counts = np.unique(y, return_counts=True)
        frac = counts / max(len(y), 1)
        keep = labels[frac >= self.min_label_fraction]
        if len(keep) > self.max_label_categories:
            order = np.argsort(-counts[np.isin(labels, keep)])
            keep = keep[order[:self.max_label_categories]]
        if len(keep) == 0:
            raise ValueError(
                f"DataCutter dropped every label: no class reaches "
                f"min_label_fraction={self.min_label_fraction} "
                f"(label fractions: "
                f"{dict(zip(labels.tolist(), np.round(frac, 4).tolist()))})")
        self.labels_kept = np.sort(keep)
        dropped = sorted(set(labels.tolist()) - set(keep.tolist()))
        self.summary = SplitterSummary(
            splitter="DataCutter",
            parameters={"min_label_fraction": self.min_label_fraction,
                        "max_label_categories": self.max_label_categories},
            results={"labelsKept": self.labels_kept.tolist(),
                     "labelsDropped": dropped})

    def prepare(self, y: np.ndarray) -> np.ndarray:
        """Row indices of the kept labels (estimated from ``y`` when no
        estimate ran)."""
        if self.labels_kept is None:
            self.estimate(y)
        return np.nonzero(np.isin(y, self.labels_kept))[0]
