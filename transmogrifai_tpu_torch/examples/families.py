"""Every ``transmogrify`` feature family in one binary workflow on the
PyTorch port.

The JAX package's own "every transmogrify feature family" workflow
(``tests/test_scoring_plan.py``: the testkit's generators and empty
rates, one raw feature per family: Real, Integral, Binary, Date,
PickList, MultiPickList, Text, NumericMap (as a RealMap feature),
PickListMap, MultiPickListMap, DateMap and DateList), with three more
parts:

- a Geolocation column (seeded numpy (lat, lon, accuracy) triples, 10 %
  empty);
- ``blurb.tokenize()``, a TextList for ``TextListHashVectorizer``;
- ``real.auto_bucketize(label)`` (a one-feature decision tree on the
  workflow's device) and ``integral.bucketize([10, 25, 40])``, combined
  with the ``transmogrify`` output.

``TransmogrifierDefaults`` throughout (512 hashes, top-K 20, min support
10, nulls tracked): about 1,100 columns. ``run`` trains the default
binary selector under 3-fold stratified CV (the whole default pool
unless ``model_stage`` replaces it) on a stratified 75 % split and
evaluates the 25 % holdout.

Run:  python -m transmogrifai_tpu_torch.examples.families [--rows N]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..evaluators import BinaryClassificationEvaluator
from ..evaluators.base import EvaluationMetrics
from ..features.builder import FeatureBuilder
from ..features.columns import Dataset
from ..features.feature import Feature
from ..ops import transmogrify
from ..selector import BinaryClassificationModelSelector
from ..testkit import (RandomBinary, RandomData, RandomIntegral, RandomList,
                       RandomMap, RandomReal, RandomSet, RandomText)
from ..types import (Binary, Date, DateList, DateMap, Geolocation, Integral,
                     MultiPickList, MultiPickListMap, NumericMap, PickList,
                     PickListMap, Real, RealMap, RealNN, Text)
from ..workflow import Workflow, WorkflowModel
from .titanic import stratified_split

__all__ = ["family_generators", "synthetic_families", "build_features",
           "default_selector", "run", "FamiliesRun", "BUCKET_SPLITS",
           "SEED"]

#: seed of the JAX package's family workflow (``seed0``)
SEED = 100
#: the fixed split points of ``integral.bucketize``
BUCKET_SPLITS = (10.0, 25.0, 40.0)
#: share of records whose geolocation is empty
GEO_EMPTY = 0.1


def family_generators(seed0: int = SEED) -> Dict[str, Tuple[type, object]]:
    """(feature type, testkit generator) per feature family: the JAX
    package's generators and empty rates
    (``tests/test_scoring_plan._family_generators``)."""
    return {
        "real": (Real, RandomReal.normal(0, 2, seed=seed0 + 1)
                 .with_probability_of_empty(0.2)),
        "integral": (Integral,
                     RandomIntegral.integers(0, 50, seed=seed0 + 2)
                     .with_probability_of_empty(0.15)),
        "flag": (Binary, RandomBinary(0.4, seed=seed0 + 3)
                 .with_probability_of_empty(0.1)),
        "when": (Date, RandomIntegral.dates(seed=seed0 + 4)
                 .with_probability_of_empty(0.2)),
        "pick": (PickList, RandomText.picklists(
            ["a", "b", "c", "d"], seed=seed0 + 5)
            .with_probability_of_empty(0.15)),
        "tags": (MultiPickList, RandomSet(
            ["x", "y", "z", "w"], seed=seed0 + 6)
            .with_probability_of_empty(0.2)),
        "blurb": (Text, RandomText.strings(seed=seed0 + 7)
                  .with_probability_of_empty(0.1)),
        # the generator's NumericMap is an abstract base without a type
        # name a saved model could record: the feature is a RealMap
        "nums": (RealMap, RandomMap(
            RandomReal.uniform(0, 5, seed=seed0 + 8), NumericMap,
            min_size=1, max_size=3, seed=seed0 + 9)
            .with_probability_of_empty(0.2)),
        "words": (PickListMap, RandomMap(
            RandomText.picklists(["p", "q", "r"], seed=seed0 + 10),
            PickListMap, min_size=1, max_size=3, seed=seed0 + 11)
            .with_probability_of_empty(0.2)),
        "sets": (MultiPickListMap, RandomMap(
            RandomSet(["m", "n", "o"], seed=seed0 + 12),
            MultiPickListMap, min_size=1, max_size=2, seed=seed0 + 13)
            .with_probability_of_empty(0.2)),
        "whens": (DateMap, RandomMap(
            RandomIntegral.dates(seed=seed0 + 14), DateMap,
            min_size=1, max_size=2, seed=seed0 + 15)
            .with_probability_of_empty(0.2)),
        "dates": (DateList, RandomList(
            RandomIntegral.dates(seed=seed0 + 16), min_size=1,
            max_size=3, ftype=DateList, seed=seed0 + 17)
            .with_probability_of_empty(0.3)),
    }


def synthetic_families(n: int, seed0: int = SEED) -> List[dict]:
    """``n`` records of every family: the testkit columns (the JAX
    package's records for the same ``seed0``, value for value), its label
    (``real + [pick == "a"] + 0.5 N(0, 1) > 0.5``) and a ``geo``
    column of (lat, lon, accuracy) triples drawn in bulk."""
    data = RandomData(seed=seed0)
    for name, (_, gen) in family_generators(seed0).items():
        data.with_column(name, gen)
    records = data.records(n)
    rng = np.random.default_rng(seed0)
    for r in records:
        r["label"] = float((r["real"] or 0)
                           + (1.0 if r["pick"] == "a" else 0.0)
                           + 0.5 * rng.normal() > 0.5)
    geo = np.random.default_rng(seed0 + 18)
    lat = np.round(geo.uniform(-60.0, 60.0, n), 4)
    lon = np.round(geo.uniform(-180.0, 180.0, n), 4)
    acc = geo.integers(1, 11, n)
    empty = geo.uniform(size=n) < GEO_EMPTY
    for i, r in enumerate(records):
        r["geo"] = None if empty[i] else [float(lat[i]), float(lon[i]),
                                          float(acc[i])]
    return records


def build_features(seed0: int = SEED):
    """(label, the combined feature vector): every family's raw feature,
    ``blurb``'s tokens and ``geo`` through ``transmogrify``, with
    ``real``'s label-aware buckets (fitted on the workflow's device) and
    ``integral``'s fixed ones."""
    raw = {name: FeatureBuilder.of(name, ftype).extract(
        lambda r, k=name: r.get(k)).as_predictor()
        for name, (ftype, _) in family_generators(seed0).items()}
    raw["geo"] = FeatureBuilder.of("geo", Geolocation).extract(
        lambda r: r.get("geo")).as_predictor()
    label = FeatureBuilder.of("label", RealNN).extract(
        lambda r: r.get("label")).as_response()
    tokens = raw["blurb"].tokenize()
    auto = raw["real"].auto_bucketize(label)
    fixed = raw["integral"].bucketize(list(BUCKET_SPLITS))
    vector = transmogrify(list(raw.values()) + [tokens, auto, fixed])
    return label, vector


def default_selector(device="cuda", seed: int = 42, models=None):
    """The default binary selector: the whole default pool (or
    ``models``) under 3-fold stratified CV, on ``device``."""
    return BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=seed, stratify=True, models=models,
        device=device)


class FamiliesRun(NamedTuple):
    metrics: EvaluationMetrics
    #: wall seconds of train, score and evaluation
    seconds: float
    model: WorkflowModel
    workflow: Workflow
    vector: Feature
    prediction: Feature
    scored: Dataset
    #: the 25 % holdout's records
    holdout: List[dict]


def run(records, device="cuda", model_stage=None, listener=None,
        verbose: bool = False) -> FamiliesRun:
    """Train on a stratified 75 % split of ``records`` on ``device``,
    score and evaluate the 25 % holdout. ``model_stage`` replaces the
    default selector (it must compute on ``device``); ``listener``
    collects the per-stage profile."""
    train, test = stratified_split(records, label_key="label")
    label, vector = build_features()
    stage = model_stage if model_stage is not None \
        else default_selector(device)
    prediction = stage.set_input(label, vector).get_output()
    t0 = time.perf_counter()
    wf = (Workflow(device=device).set_result_features(label, prediction)
          .set_input_records(train))
    if listener is not None:
        wf = wf.with_listener(listener)
    model = wf.train()
    evaluator = BinaryClassificationEvaluator(
        label_col="label", prediction_col=prediction.name)
    scored, metrics = model.score_and_evaluate(test, evaluator)
    elapsed = time.perf_counter() - t0
    if verbose:
        from ..selector import SelectedModel
        for s in model.stages():
            if isinstance(s, SelectedModel) and s.summary is not None:
                print(s.summary.pretty())
        width = model.train_dataset[vector.name].data.shape[1]
        print(f"Train rows: {len(train)}, holdout rows: {len(test)}, "
              f"columns: {width}")
        print(f"Holdout AuPR:   {metrics.AuPR:.4f}")
        print(f"Holdout AuROC:  {metrics.AuROC:.4f}")
        print(f"Wall clock: {elapsed:.2f}s")
    return FamiliesRun(metrics, elapsed, model, wf, vector, prediction,
                       scored, test)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(synthetic_families(args.rows, args.seed),
                 device=args.device, verbose=True)
    from ..local import load_score_function
    path = os.path.join(tempfile.mkdtemp(prefix="families_"), "model")
    result.model.save(path)
    served = load_score_function(path, device=args.device)(
        dict(result.holdout[0]))
    print(f"saved -> {path}; served one record: "
          f"P(label)={served[result.prediction.name]['probability_1']:.3f}")


if __name__ == "__main__":
    main()
