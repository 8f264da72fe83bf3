"""RawFeatureFilter: pre-DAG raw-feature exclusion.

Counterpart of ``transmogrifai_tpu/checkers/raw_feature_filter.py``
(reference core/src/main/scala/com/salesforce/op/filters/
{RawFeatureFilter.scala:87-101,436,477, FeatureDistribution.scala:58}):
before any stage is fitted, every raw feature's fill rate and value
distribution are computed on the training data (and optionally on scoring
data), and features are excluded when

- training fill rate < ``min_fill``,
- |train fill - score fill| > ``max_fill_difference``,
- fill ratio between train/score > ``max_fill_ratio_diff``,
- Jensen-Shannon divergence between train and score distributions
  > ``max_js_divergence`` (distribution shift),
- the null-indicator correlates with the label above
  ``max_correlation`` (leaky missingness).

Distributions: numeric features use a streaming histogram
(``utils/histogram.py``); text-like features hash values into ``bins``
buckets with the vectorizers' md5 ``stable_hash``. This is host numpy over
the raw columns, as in the JAX package: it launches nothing on a device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..features.columns import Dataset, FeatureColumn
from ..features.feature import Feature
from ..ops.vector_utils import stable_hash as _stable_hash
from ..types import FeatureType, OPNumeric
from ..utils.histogram import StreamingHistogram

__all__ = ["RawFeatureFilter", "FeatureDistribution",
           "RawFeatureFilterResults", "ExclusionReason",
           "numeric_histogram_js", "rewire_without"]


def numeric_histogram_js(ha: Optional[StreamingHistogram],
                         hb: Optional[StreamingHistogram],
                         bins: int) -> float:
    """JS divergence of two numeric StreamingHistograms over shared
    breakpoints. Shared by the train-time RawFeatureFilter and the
    serve-time drift sentinel (serving/sentinel.py), so "shift" means
    the same thing in both places. Empty histograms compare as 0.0."""
    if ha is None or hb is None or ha.total == 0 or hb.total == 0 \
            or ha.centroids.size == 0 or hb.centroids.size == 0:
        return 0.0
    lo = min(ha.centroids.min(), hb.centroids.min())
    hi = max(ha.centroids.max(), hb.centroids.max())
    if hi <= lo:
        return 0.0
    breaks = np.linspace(lo, hi, bins + 1)[1:-1]
    pa = FeatureDistribution(name="a", distribution=ha.density(breaks))
    pb = FeatureDistribution(name="b", distribution=hb.density(breaks))
    return pa.js_divergence(pb)


@dataclass
class FeatureDistribution:
    """Null count + value histogram of one raw feature
    (reference FeatureDistribution.scala:58)."""
    name: str
    count: int = 0
    nulls: int = 0
    distribution: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.float64))
    is_numeric: bool = False

    @property
    def fill_rate(self) -> float:
        return 0.0 if self.count == 0 else 1.0 - self.nulls / self.count

    def js_divergence(self, other: "FeatureDistribution") -> float:
        """Jensen-Shannon divergence of the two normalized histograms
        (reference FeatureDistribution.jsDivergence).

        Empty, zero-count and non-finite histograms (a feature that was
        all-null on one side, a poisoned sketch) return 0.0 — "no
        evidence of shift" — instead of dividing by a zero/NaN bin sum
        and poisoning every downstream threshold comparison."""
        p = np.asarray(self.distribution, dtype=np.float64)
        q = np.asarray(other.distribution, dtype=np.float64)
        if p.size == 0 or q.size == 0 or p.size != q.size:
            return 0.0
        ps, qs = p.sum(), q.sum()
        if not np.isfinite(ps) or not np.isfinite(qs) \
                or ps <= 0 or qs <= 0:
            return 0.0
        p, q = p / ps, q / qs
        m = 0.5 * (p + q)
        with np.errstate(divide="ignore", invalid="ignore"):
            def kl(a, b):
                r = np.where((a > 0) & (b > 0), a * np.log2(a / b), 0.0)
                return float(np.sum(r))
            js = 0.5 * kl(p, m) + 0.5 * kl(q, m)
        # interpolation/rounding can leave js a hair outside [0, 1]
        return min(max(js, 0.0), 1.0) if np.isfinite(js) else 0.0

    def to_json(self) -> dict:
        return {"name": self.name, "count": self.count, "nulls": self.nulls,
                "distribution": self.distribution.tolist(),
                "isNumeric": self.is_numeric, "fillRate": self.fill_rate}

    @classmethod
    def from_json(cls, d: dict) -> "FeatureDistribution":
        return cls(name=d["name"], count=d["count"], nulls=d["nulls"],
                   distribution=np.asarray(d["distribution"],
                                           dtype=np.float64),
                   is_numeric=d["isNumeric"])


@dataclass
class ExclusionReason:
    """(reference ExclusionReasons in RawFeatureFilterResults)"""
    name: str
    reason: str

    def to_json(self) -> dict:
        return {"name": self.name, "reason": self.reason}

    @classmethod
    def from_json(cls, d: dict) -> "ExclusionReason":
        return cls(name=d["name"], reason=d["reason"])


@dataclass
class RawFeatureFilterResults:
    """(reference RawFeatureFilterResults recorded on the workflow)"""
    train_distributions: List[FeatureDistribution] = field(
        default_factory=list)
    score_distributions: List[FeatureDistribution] = field(
        default_factory=list)
    exclusions: List[ExclusionReason] = field(default_factory=list)

    @property
    def excluded_names(self) -> List[str]:
        seen, out = set(), []
        for e in self.exclusions:
            if e.name not in seen:
                seen.add(e.name)
                out.append(e.name)
        return out

    def to_json(self) -> dict:
        return {
            "trainDistributions": [d.to_json()
                                   for d in self.train_distributions],
            "scoreDistributions": [d.to_json()
                                   for d in self.score_distributions],
            "exclusions": [e.to_json() for e in self.exclusions]}

    @classmethod
    def from_json(cls, d: dict) -> "RawFeatureFilterResults":
        return cls(
            train_distributions=[FeatureDistribution.from_json(x)
                                 for x in d.get("trainDistributions", [])],
            score_distributions=[FeatureDistribution.from_json(x)
                                 for x in d.get("scoreDistributions", [])],
            exclusions=[ExclusionReason.from_json(x)
                        for x in d.get("exclusions", [])])


class RawFeatureFilter:
    """(reference RawFeatureFilter.scala:87-101; thresholds are the
    reference defaults)"""

    def __init__(self, min_fill: float = 0.001,
                 max_fill_difference: float = 0.90,
                 max_fill_ratio_diff: float = 20.0,
                 max_js_divergence: float = 0.90,
                 max_correlation: float = 0.9,
                 bins: int = 100,
                 protected_features: Sequence[str] = ()):
        self.min_fill = min_fill
        self.max_fill_difference = max_fill_difference
        self.max_fill_ratio_diff = max_fill_ratio_diff
        self.max_js_divergence = max_js_divergence
        self.max_correlation = max_correlation
        self.bins = bins
        self.protected_features = set(protected_features)

    # -- distribution computation ------------------------------------------
    def _distribution(self, f: Feature, col: FeatureColumn
                      ) -> FeatureDistribution:
        missing = col.is_missing()
        n = col.n_rows
        numeric = issubclass(f.ftype, OPNumeric)
        dist = FeatureDistribution(name=f.name, count=n,
                                   nulls=int(missing.sum()),
                                   is_numeric=numeric)
        if numeric:
            vals = np.asarray(
                [v if v is not None else np.nan for v in col.data],
                dtype=np.float64)
            hist = StreamingHistogram(self.bins)
            hist.update(vals[~np.isnan(vals)])
            dist.distribution = hist.counts.copy()
            dist._histogram = hist  # kept for shared-breakpoint JS
        else:
            counts = np.zeros(self.bins, dtype=np.float64)
            for v, miss in zip(col.data, missing):
                if miss:
                    continue
                if isinstance(v, (set, frozenset, list, tuple)):
                    for e in v:
                        counts[_stable_hash(str(e), self.bins)] += 1
                elif isinstance(v, dict):
                    for k in v:
                        counts[_stable_hash(str(k), self.bins)] += 1
                else:
                    counts[_stable_hash(str(v), self.bins)] += 1
            dist.distribution = counts
        return dist

    def _numeric_js(self, a: FeatureDistribution, b: FeatureDistribution
                    ) -> float:
        """JS divergence of two numeric histograms over shared quantile
        breakpoints (reference compares StreamingHistogram densities)."""
        return numeric_histogram_js(getattr(a, "_histogram", None),
                                    getattr(b, "_histogram", None),
                                    self.bins)

    # -- main entry ---------------------------------------------------------
    def compute_exclusions(
            self, raw_features: Sequence[Feature], train: Dataset,
            score: Optional[Dataset] = None,
            label: Optional[np.ndarray] = None
            ) -> RawFeatureFilterResults:
        """(reference generateFilteredRaw:477 / getFeaturesToExclude:436)"""
        results = RawFeatureFilterResults()
        predictors = [f for f in raw_features if not f.is_response]
        train_dists = {f.name: self._distribution(f, train[f.name])
                       for f in predictors if f.name in train}
        results.train_distributions = list(train_dists.values())
        score_dists: Dict[str, FeatureDistribution] = {}
        if score is not None:
            score_dists = {f.name: self._distribution(f, score[f.name])
                           for f in predictors if f.name in score}
            results.score_distributions = list(score_dists.values())

        def exclude(name: str, reason: str):
            if name not in self.protected_features:
                results.exclusions.append(ExclusionReason(name, reason))

        for f in predictors:
            td = train_dists.get(f.name)
            if td is None:
                continue
            if td.fill_rate < self.min_fill:
                exclude(f.name, f"train fill rate {td.fill_rate:.4f} below "
                                f"minFill {self.min_fill}")
            # leaky missingness: null indicator vs label correlation
            if label is not None and td.nulls > 0 and td.nulls < td.count:
                nulls = train[f.name].is_missing().astype(np.float64)
                y = np.asarray(label, dtype=np.float64)
                if np.std(nulls) > 0 and np.std(y) > 0:
                    c = float(np.corrcoef(nulls, y)[0, 1])
                    if abs(c) > self.max_correlation:
                        exclude(f.name,
                                f"null-indicator label correlation "
                                f"{c:.3f} above maxCorrelation "
                                f"{self.max_correlation}")
            sd = score_dists.get(f.name)
            if sd is None:
                continue
            fill_diff = abs(td.fill_rate - sd.fill_rate)
            if fill_diff > self.max_fill_difference:
                exclude(f.name, f"fill-rate difference {fill_diff:.3f} "
                                f"above maxFillDifference "
                                f"{self.max_fill_difference}")
            rates = sorted([max(td.fill_rate, 1e-12),
                            max(sd.fill_rate, 1e-12)])
            if rates[1] / rates[0] > self.max_fill_ratio_diff:
                exclude(f.name, f"fill-rate ratio {rates[1] / rates[0]:.2f} "
                                f"above maxFillRatioDiff "
                                f"{self.max_fill_ratio_diff}")
            js = self._numeric_js(td, sd) if td.is_numeric \
                else td.js_divergence(sd)
            if js > self.max_js_divergence:
                exclude(f.name, f"train/score JS divergence {js:.3f} above "
                                f"maxJSDivergence {self.max_js_divergence}")
        return results


def rewire_without(result_features: Sequence[Feature],
                   blacklist: Sequence[str]
                   ) -> Tuple[List[Feature], List[Feature]]:
    """Rebuild the DAG without blacklisted raw features
    (reference OpWorkflow.setBlacklist:112). Sequence stages lose the
    blacklisted inputs; fixed-arity stages with a blacklisted input raise
    (as the reference does for non-removable usages).

    Returns (new result features, blacklisted raw features).
    """
    bl = set(blacklist)
    cache: Dict[str, Optional[Feature]] = {}
    removed: List[Feature] = []

    def rebuild(f: Feature) -> Optional[Feature]:
        if f.uid in cache:
            return cache[f.uid]
        if f.is_raw:
            if f.name in bl:
                removed.append(f)
                cache[f.uid] = None
                return None
            cache[f.uid] = f
            return f
        new_parents = []
        dropped = []
        for p in f.parents:
            rp = rebuild(p)
            (new_parents if rp is not None else dropped).append(
                rp if rp is not None else p)
        stage = f.origin_stage

        def reclone() -> Feature:
            """Clone the stage onto the surviving parents, keeping the
            output feature's identity (name + uid) so user-held handles
            stay valid (the reference preserves features through
            setBlacklist rewiring)."""
            clone = type(stage)(**{**stage.get_params(), "uid": stage.uid})
            clone.set_input(*new_parents)
            nf = Feature(name=f.name, ftype=f.ftype,
                         is_response=f.is_response, origin_stage=clone,
                         parents=tuple(new_parents), uid=f.uid)
            clone._output_feature = nf
            return nf

        if not dropped:
            if all(np is op for np, op in zip(new_parents, f.parents)):
                cache[f.uid] = f
                return f
            out = reclone()
            cache[f.uid] = out
            return out
        if getattr(stage, "is_sequence", False) \
                and len(new_parents) >= stage.min_inputs:
            out = reclone()
            cache[f.uid] = out
            return out
        if not new_parents:
            cache[f.uid] = None
            return None
        raise ValueError(
            f"Cannot remove blacklisted features "
            f"{[p.name for p in dropped]} from non-sequence stage "
            f"{type(stage).__name__} feeding {f.name!r} — protect them "
            f"via RawFeatureFilter(protected_features=...) "
            f"(reference OpWorkflow.setBlacklist behavior)")

    new_results = []
    for rf in result_features:
        nf = rebuild(rf)
        if nf is None:
            raise ValueError(
                f"Result feature {rf.name!r} lost all its inputs to the "
                "raw feature filter")
        new_results.append(nf)
    return new_results, removed
