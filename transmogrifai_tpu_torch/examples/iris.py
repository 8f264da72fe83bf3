"""Iris species on the PyTorch port: the multiclass example.

Counterpart of ``examples/iris.py`` (reference
helloworld/src/main/scala/com/salesforce/hw/iris/OpIris.scala:62-80): four
typed real features, the species label indexed 0, 1, 2, ``transmogrify``,
and ``MultiClassificationModelSelector`` under 3-fold CV over the
example's pool (LogisticRegression, RandomForestClassifier, NaiveBayes,
DecisionTreeClassifier and the softmax XGBoostClassifier) with a
``DataCutter`` holding out a fifth of the records; the holdout metrics
are the selector's. ``load_iris`` reads the UCI ``iris.data`` file;
``synthetic_iris`` draws records of its schema (class-conditional normals
with the real data's per-species means and deviations, one decimal, equal
class shares).

Run:  python -m transmogrifai_tpu_torch.examples.iris [--rows N]
      [--device cpu] [--csv iris.data]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from ..evaluators.base import EvaluationMetrics
from ..features.builder import FeatureBuilder
from ..features.feature import Feature
from ..ops import transmogrify
from ..selector import MultiClassificationModelSelector
from ..selector.splitters import DataCutter
from ..types import Real, RealNN
from ..workflow import Workflow, WorkflowModel

__all__ = ["SPECIES", "FEATURES", "IRIS_FAMILIES", "load_iris",
           "synthetic_iris", "build_features", "default_selector", "run",
           "holdout_records", "IrisRun"]

SPECIES = ["Iris-setosa", "Iris-versicolor", "Iris-virginica"]
FEATURES = ["sepal_length", "sepal_width", "petal_length", "petal_width"]
#: the families ``examples/iris.py:run`` names
IRIS_FAMILIES = ("LogisticRegression", "RandomForestClassifier",
                 "NaiveBayes", "DecisionTreeClassifier", "XGBoostClassifier")
#: per species (setosa, versicolor, virginica) and feature: the mean and
#: standard deviation of the UCI data's 50 records a species
_MEANS = np.array([[5.006, 3.428, 1.462, 0.246],
                   [5.936, 2.770, 4.260, 1.326],
                   [6.588, 2.974, 5.552, 2.026]])
_STDS = np.array([[0.352, 0.379, 0.174, 0.105],
                  [0.516, 0.314, 0.470, 0.198],
                  [0.636, 0.322, 0.552, 0.275]])


def load_iris(path: str) -> List[dict]:
    """The records of a UCI ``iris.data`` file (comma-separated, species
    name last)."""
    records = []
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split(",")
            if len(parts) != 5 or parts[4] not in SPECIES:
                continue
            rec = {f: float(v) for f, v in zip(FEATURES, parts[:4])}
            rec["label"] = float(SPECIES.index(parts[4]))
            records.append(rec)
    return records


def synthetic_iris(n: int = 150, seed: int = 42) -> List[dict]:
    """``n`` Iris-shaped records: equal class shares in a seeded order,
    each feature drawn from its species' normal, rounded to one decimal
    as the UCI data is, and kept at 0.1 or more."""
    rng = np.random.default_rng(seed)
    label = rng.permutation(np.arange(n) % 3)
    vals = rng.normal(_MEANS[label], _STDS[label])
    vals = np.maximum(np.round(vals, 1), 0.1)
    return [dict(zip(FEATURES, map(float, vals[i])),
                 label=float(label[i])) for i in range(n)]


def build_features():
    """(label, the four real predictors), as ``examples/iris.py``."""
    feats = [FeatureBuilder.of(name, Real).extract(
        lambda r, n=name: r.get(n)).as_predictor() for name in FEATURES]
    label = FeatureBuilder.of("label", RealNN).extract(
        lambda r: r.get("label")).as_response()
    return feats, label


def default_selector(device="cuda", seed: int = 42, models=None,
                     validation: str = "exact"):
    """The example's selector: 3-fold CV over ``IRIS_FAMILIES`` (or
    ``models``), ranked by weighted F1, with a DataCutter reserving 20 %
    of the records, on ``device``."""
    return MultiClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=seed,
        splitter=DataCutter(reserve_test_fraction=0.2, seed=seed),
        models=models,
        model_types_to_use=None if models is not None else IRIS_FAMILIES,
        validation=validation, device=device)


def holdout_records(records: Sequence[dict], seed: int = 42) -> List[dict]:
    """The records the example's DataCutter reserves as its holdout."""
    y = np.array([r["label"] for r in records], dtype=np.float64)
    _, test = DataCutter(reserve_test_fraction=0.2, seed=seed).split(y)
    return [records[i] for i in test]


class IrisRun(NamedTuple):
    #: the selector's holdout metrics (its training metrics when it
    #: reserved none)
    metrics: EvaluationMetrics
    #: wall seconds of the workflow's train
    seconds: float
    model: WorkflowModel
    workflow: Workflow
    vector: Feature
    prediction: Feature
    #: the reserved holdout's records
    holdout: List[dict]


def run(records, device="cuda", seed: int = 42, models=None,
        validation: str = "exact", listener=None,
        verbose: bool = False) -> IrisRun:
    """Train the example's workflow on ``records`` on ``device``: the
    selector reserves its holdout and evaluates the winner there.
    ``models`` replaces the example's pool (each family on ``device``);
    ``listener`` collects the per-stage profile."""
    feats, label = build_features()
    vector = transmogrify(feats)
    selector = default_selector(device, seed, models, validation)
    prediction = selector.set_input(label, vector).get_output()
    t0 = time.perf_counter()
    wf = (Workflow(device=device).set_result_features(prediction)
          .set_input_records(list(records)))
    if listener is not None:
        wf = wf.with_listener(listener)
    model = wf.train()
    seconds = time.perf_counter() - t0
    summary = model.result_features[0].origin_stage.summary
    metrics = summary.holdout_evaluation or summary.train_evaluation
    if verbose:
        print(summary.pretty())
        print(f"holdout error={metrics.Error:.4f} f1={metrics.F1:.4f} "
              f"({seconds:.1f}s)")
    return IrisRun(metrics, seconds, model, wf, vector, prediction,
                   holdout_records(records, seed))


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--csv", default=None,
                    help="a UCI iris.data file instead of synthetic records")
    args = ap.parse_args(argv)
    records = (load_iris(args.csv) if args.csv
               else synthetic_iris(args.rows, args.seed))
    result = run(records, device=args.device, seed=args.seed, verbose=True)
    from ..local import load_score_function
    path = os.path.join(tempfile.mkdtemp(prefix="iris_"), "model")
    result.model.save(path)
    served = load_score_function(path, device=args.device)(
        dict(result.holdout[0]))
    print(f"saved -> {path}; served one record: "
          f"{served[result.prediction.name]}")


if __name__ == "__main__":
    main()
