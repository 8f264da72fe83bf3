"""The lazy, typed feature DAG.

The port's own copy of ``transmogrifai_tpu/features/feature.py``, the
reference Feature DAG
(features/src/main/scala/com/salesforce/op/features/{FeatureLike.scala:48,
Feature.scala:52}): a ``Feature`` is a lazy node naming the output of a
stage applied to parent features; nothing is materialized until a workflow
runs. Topological sorting (``parent_stages``, reference
FeatureLike.parentStages:363-430) assigns every origin stage its maximum
distance from the result features — the workflow fits/transforms layer by
layer in decreasing distance order.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Sequence, Tuple, Type

from ..types import FeatureType
from ..utils.ported import not_ported
from ..utils.uid import uid as make_uid

if TYPE_CHECKING:  # pragma: no cover
    from ..stages.base import PipelineStage

__all__ = ["Feature", "FeatureCycleError", "FeatureHistory", "topo_layers"]


class FeatureCycleError(ValueError):
    """Raised when the feature graph contains a cycle
    (reference FeatureCycleException)."""


class FeatureHistory:
    """Lineage record: origin raw features + stage operations applied
    (reference utils/.../FeatureHistory.scala)."""

    def __init__(self, origin_features: Sequence[str],
                 stages: Sequence[str]):
        self.origin_features = tuple(sorted(set(origin_features)))
        self.stages = tuple(stages)

    def to_json(self) -> dict:
        return {"originFeatures": list(self.origin_features),
                "stages": list(self.stages)}

    def __repr__(self) -> str:
        return (f"FeatureHistory(origin={list(self.origin_features)}, "
                f"stages={list(self.stages)})")


class Feature:
    """A node in the feature DAG (reference Feature.scala:52)."""

    __slots__ = ("name", "ftype", "is_response", "origin_stage", "parents",
                 "uid", "distributions")

    def __init__(self, name: str, ftype: Type[FeatureType],
                 is_response: bool = False,
                 origin_stage: Optional["PipelineStage"] = None,
                 parents: Sequence["Feature"] = (),
                 uid: Optional[str] = None,
                 distributions: tuple = ()):
        self.name = name
        self.ftype = ftype
        self.is_response = is_response
        self.origin_stage = origin_stage
        self.parents: Tuple[Feature, ...] = tuple(parents)
        self.uid = uid or make_uid("Feature")
        #: feature distributions recorded by RawFeatureFilter
        self.distributions = distributions

    # -- graph API ---------------------------------------------------------
    @property
    def is_raw(self) -> bool:
        return len(self.parents) == 0

    def transform_with(self, stage: "PipelineStage",
                       *others: "Feature") -> "Feature":
        """Apply a stage to this feature (+ optional co-inputs) and return
        its output feature (reference FeatureLike.transformWith)."""
        return stage.set_input(self, *others).get_output()

    def traverse(self, visit: Callable[["Feature"], None]) -> None:
        """DFS over the subgraph rooted here, with cycle detection
        (reference FeatureLike.traverse:309)."""
        on_path: set[str] = set()
        seen: set[str] = set()

        def go(f: "Feature"):
            if f.uid in on_path:
                raise FeatureCycleError(
                    f"Feature cycle detected at {f.name!r}")
            if f.uid in seen:
                return
            on_path.add(f.uid)
            visit(f)
            for p in f.parents:
                go(p)
            on_path.discard(f.uid)
            seen.add(f.uid)

        go(self)

    def raw_features(self) -> List["Feature"]:
        """All raw (leaf) ancestors (reference FeatureLike.rawFeatures:338)."""
        uniq: dict[str, Feature] = {}
        for f in _collect(self):
            if f.is_raw:
                uniq.setdefault(f.uid, f)
        return sorted(uniq.values(), key=lambda f: f.name)

    def parent_stages(self) -> Dict["PipelineStage", int]:
        """Map each ancestor origin stage to its max distance from this
        feature (reference FeatureLike.parentStages:363-430)."""
        return parent_stages([self])

    def history(self) -> FeatureHistory:
        """Origin features + stage lineage (reference FeatureLike.history)."""
        origins = [f.name for f in self.raw_features()]
        dist = self.parent_stages()
        ordered = sorted(dist.items(), key=lambda kv: -kv[1])
        return FeatureHistory(
            origin_features=origins,
            stages=[s.stage_name() for s, _ in ordered])

    def copy_with_new_stages(self, stage_map: Dict[str, "PipelineStage"]
                             ) -> "Feature":
        """Rebuild the DAG swapping origin stages by uid — used to replace
        estimators with their fitted models after training
        (reference Feature.copyWithNewStages:86)."""
        cache: dict[str, Feature] = {}

        def rebuild(f: "Feature") -> "Feature":
            if f.uid in cache:
                return cache[f.uid]
            new_parents = tuple(rebuild(p) for p in f.parents)
            stage = stage_map.get(f.origin_stage.uid, f.origin_stage) \
                if f.origin_stage is not None else None
            nf = Feature(name=f.name, ftype=f.ftype,
                         is_response=f.is_response, origin_stage=stage,
                         parents=new_parents, uid=f.uid,
                         distributions=f.distributions)
            swapped = (f.origin_stage is not None
                       and f.origin_stage.uid in stage_map)
            if swapped and new_parents:
                # wire the swapped-in fitted model to the rebuilt DAG so
                # execution derives the same column names; stages shared
                # with the source graph are left untouched
                stage.input_features = new_parents
                stage._output_feature = nf
            cache[f.uid] = nf
            return nf

        return rebuild(self)

    # -- DSL enrichments (reference core/.../dsl/RichNumericFeature.scala,
    # RichTextFeature.scala, RichFeature.scala) -----------------------------
    def _arith(self, other, op: str, swapped: bool = False) -> "Feature":
        from ..ops.dsl import NumericBinaryTransformer, NumericScalarTransformer
        if isinstance(other, Feature):
            a, b = (other, self) if swapped else (self, other)
            return NumericBinaryTransformer(op=op).set_input(a, b).get_output()
        return NumericScalarTransformer(
            op=op, scalar=float(other), swapped=swapped
        ).set_input(self).get_output()

    def __add__(self, other):
        return self._arith(other, "add")

    def __radd__(self, other):
        return self._arith(other, "add", swapped=True)

    def __sub__(self, other):
        return self._arith(other, "sub")

    def __rsub__(self, other):
        return self._arith(other, "sub", swapped=True)

    def __mul__(self, other):
        return self._arith(other, "mul")

    def __rmul__(self, other):
        return self._arith(other, "mul", swapped=True)

    def __truediv__(self, other):
        return self._arith(other, "div")

    def __rtruediv__(self, other):
        return self._arith(other, "div", swapped=True)

    def map(self, fn: Callable, output_type: Type[FeatureType]) -> "Feature":
        """Row-wise boxed map (reference RichFeature.map)."""
        from ..stages.base import LambdaTransformer
        return LambdaTransformer(fn=fn, output_type=output_type
                                 ).set_input(self).get_output()

    def fill_missing_with_mean(self) -> "Feature":
        """(reference RichNumericFeature.fillMissingWithMean)"""
        from ..ops.dsl import FillMissingWithMean
        return FillMissingWithMean().set_input(self).get_output()

    def z_normalize(self) -> "Feature":
        """(reference RichNumericFeature.zNormalize:325)"""
        from ..ops.dsl import StandardScaler
        return StandardScaler().set_input(self).get_output()

    def pivot(self, top_k: int = 20, min_support: int = 10) -> "Feature":
        """One-hot pivot of a categorical text feature
        (reference RichTextFeature.pivot)."""
        from ..ops.categorical import OneHotVectorizer
        return OneHotVectorizer(top_k=top_k, min_support=min_support
                                ).set_input(self).get_output()

    def sanity_check(self, label: "Feature", **params) -> "Feature":
        """Prune this feature vector against the label
        (reference RichNumericFeature.sanityCheck:479)."""
        from ..checkers import SanityChecker
        return SanityChecker(**params).set_input(label, self).get_output()

    def alias(self, name: str) -> "Feature":
        """Rename via an identity stage (reference RichFeature.alias /
        AliasTransformer)."""
        from ..ops.dsl import AliasTransformer
        return AliasTransformer(alias=name, output_type=self.ftype
                                ).set_input(self).get_output()

    def bucketize(self, split_points, bucket_labels=None,
                  track_nulls: bool = True) -> "Feature":
        """One-hot bucket membership for a numeric feature
        (reference RichNumericFeature.bucketize)."""
        from ..ops.bucketizers import NumericBucketizer
        return NumericBucketizer(split_points=split_points,
                                 bucket_labels=bucket_labels,
                                 track_nulls=track_nulls
                                 ).set_input(self).get_output()

    def auto_bucketize(self, label: "Feature", **params) -> "Feature":
        """Label-aware decision-tree buckets
        (reference RichNumericFeature.autoBucketize); ``params`` go to
        ``DecisionTreeNumericBucketizer``, whose tree fits on the device
        of the workflow that fits it."""
        from ..ops.bucketizers import DecisionTreeNumericBucketizer
        return DecisionTreeNumericBucketizer(**params).set_input(
            label, self).get_output()

    def tokenize(self, **params) -> "Feature":
        """Text -> TextList tokens (reference RichTextFeature.tokenize)."""
        from ..ops.text import TextTokenizer
        return TextTokenizer(**params).set_input(self).get_output()

    def vectorize(self, track_nulls: bool = True) -> "Feature":
        """Default numeric vectorization with null tracking
        (reference RichNumericFeature.vectorize:325)."""
        from ..ops.numeric import RealVectorizer
        return RealVectorizer(track_nulls=track_nulls
                              ).set_input(self).get_output()

    def smart_vectorize(self, max_cardinality: int = 30, top_k: int = 20,
                        min_support: int = 10, num_hashes: int = 512,
                        track_nulls: bool = True) -> "Feature":
        """Pivot-or-hash text vectorization
        (reference RichTextFeature.smartVectorize)."""
        from ..ops.text import SmartTextVectorizer
        return SmartTextVectorizer(
            max_cardinality=max_cardinality, top_k=top_k,
            min_support=min_support, num_hashes=num_hashes,
            track_nulls=track_nulls).set_input(self).get_output()

    def combine(self, *others: "Feature") -> "Feature":
        """Concatenate OPVector features
        (reference RichVectorFeature.combine)."""
        from ..ops.combiner import VectorsCombiner
        return VectorsCombiner().set_input(self, *others).get_output()

    def lda(self, k: int = 10, **params) -> "Feature":
        """Topic-distribution vector from a token list
        (reference RichVectorFeature.lda)."""
        from ..ops.text_advanced import LDA
        return LDA(k=k, **params).set_input(self).get_output()

    # -- dunder ------------------------------------------------------------
    def __repr__(self) -> str:
        kind = "response" if self.is_response else "predictor"
        return (f"Feature[{self.ftype.__name__}]({self.name!r}, {kind}, "
                f"raw={self.is_raw})")

    def __hash__(self) -> int:
        return hash(self.uid)

    def __eq__(self, other) -> bool:
        return isinstance(other, Feature) and self.uid == other.uid


def _collect(root: Feature) -> List[Feature]:
    out: list[Feature] = []
    seen: set[str] = set()
    stack = [root]
    while stack:
        f = stack.pop()
        if f.uid in seen:
            continue
        seen.add(f.uid)
        out.append(f)
        stack.extend(f.parents)
    return out


def parent_stages(result_features: Sequence[Feature]
                  ) -> Dict["PipelineStage", int]:
    """Stage -> max distance from any result feature, with cycle check
    (reference FeatureLike.parentStages:363-430). Longest-path DP over the
    feature DAG in topological order."""
    color: dict[str, int] = {}   # 0/absent=white, 1=gray, 2=black
    post: list[Feature] = []     # post-order: parents before children

    def dfs(f: Feature):
        c = color.get(f.uid, 0)
        if c == 1:
            raise FeatureCycleError(f"Feature cycle detected at {f.name!r}")
        if c == 2:
            return
        color[f.uid] = 1
        for p in f.parents:
            dfs(p)
        color[f.uid] = 2
        post.append(f)

    for rf in result_features:
        dfs(rf)

    dist: dict[str, int] = {rf.uid: 0 for rf in result_features}
    for f in reversed(post):  # children before their parents
        d = dist.get(f.uid, 0)
        for p in f.parents:
            dist[p.uid] = max(dist.get(p.uid, -1), d + 1)

    out: dict = {}
    for f in post:
        if f.origin_stage is not None:
            s = f.origin_stage
            out[s] = max(out.get(s, -1), dist.get(f.uid, 0))
    return out


def topo_layers(result_features: Sequence[Feature]
                ) -> List[List["PipelineStage"]]:
    """Stages grouped into layers by decreasing distance from the results —
    the fit/transform execution order (reference
    FitStagesUtil.computeDAG:173)."""
    dist = parent_stages(result_features)
    if not dist:
        return []
    by_d: dict[int, list] = {}
    for s, d in dist.items():
        by_d.setdefault(d, []).append(s)
    return [sorted(by_d[d], key=lambda s: s.uid)
            for d in sorted(by_d, reverse=True)]
