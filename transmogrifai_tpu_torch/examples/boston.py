"""Boston housing on the PyTorch port: the regression example.

Counterpart of ``examples/boston.py`` (reference
helloworld/src/main/scala/com/salesforce/hw/boston/OpBoston.scala:86):
twelve typed real features and the binary ``chas``, ``transmogrify``, and
``RegressionModelSelector`` under 3-fold CV over its default pool
(LinearRegression, RandomForestRegressor, GBTRegressor and the GLM) with a
``DataSplitter`` holding out a fifth of the records; the holdout metrics
are the selector's. ``load_boston`` reads the whitespace-separated
``housing.data`` file; ``synthetic_boston`` draws records of its schema:
the 13 columns at the real data's ranges, a binary ``chas``, and ``medv``
from a fixed formula (rm, lstat, ptratio, crim, chas and a squared lstat
term) plus noise, clipped to [5, 50] as the real label is.

Run:  python -m transmogrifai_tpu_torch.examples.boston [--rows N]
      [--device cpu] [--csv housing.data]
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
from ..selector import RegressionModelSelector
from ..selector.splitters import DataSplitter
from ..types import Binary, Real, RealNN
from ..workflow import Workflow, WorkflowModel

__all__ = ["COLUMNS", "load_boston", "synthetic_boston", "build_features",
           "default_selector", "run", "holdout_records", "BostonRun"]

#: the whitespace-separated columns of housing.data (reference BostonHouse)
COLUMNS = ["crim", "zn", "indus", "chas", "nox", "rm", "age", "dis",
           "rad", "tax", "ptratio", "b", "lstat", "medv"]


def load_boston(path: str) -> List[dict]:
    """The records of a ``housing.data`` file."""
    records = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) == len(COLUMNS):
                records.append({c: float(v) for c, v in zip(COLUMNS, parts)})
    return records


def synthetic_boston(n: int = 506, seed: int = 42) -> List[dict]:
    """``n`` Boston-shaped records, each column drawn at once with numpy
    within the real column's range (crim log-normal in [0.006, 89], zn
    mostly 0, rad in {1..8, 24}, chas 1 in 7 % of the tracts, ...);
    ``medv`` = 22 + 5.5 (rm - 6.28) - 0.55 (lstat - 12.65) + 0.02 (lstat -
    12.65)^2 - 0.9 (ptratio - 18.46) - 0.08 crim + 3 chas + N(0, 3^2),
    clipped to [5, 50]."""
    rng = np.random.default_rng(seed)
    crim = np.clip(np.exp(rng.normal(-0.9, 2.0, n)), 0.006, 89.0)
    zn = np.where(rng.uniform(size=n) < 0.73, 0.0,
                  np.round(rng.uniform(12.5, 100.0, n), 1))
    indus = np.round(rng.uniform(0.46, 27.74, n), 2)
    chas = (rng.uniform(size=n) < 0.07).astype(np.float64)
    nox = np.round(rng.uniform(0.385, 0.871, n), 3)
    rm = np.round(np.clip(rng.normal(6.28, 0.70, n), 3.56, 8.78), 3)
    age = np.round(np.clip(100.0 - rng.exponential(32.0, n), 2.9, 100.0), 1)
    dis = np.round(np.clip(rng.lognormal(1.2, 0.5, n), 1.13, 12.13), 4)
    rad = rng.choice(np.array([1, 2, 3, 4, 5, 6, 7, 8, 24], dtype=float), n,
                     p=[.04, .05, .08, .22, .23, .05, .03, .04, .26])
    tax = np.round(rng.uniform(187.0, 711.0, n))
    ptratio = np.round(np.clip(rng.normal(18.46, 2.16, n), 12.6, 22.0), 1)
    b = np.round(np.clip(396.9 - rng.exponential(25.0, n), 0.32, 396.9), 2)
    lstat = np.round(np.clip(rng.normal(12.65, 7.14, n), 1.73, 37.97), 2)
    medv = (22.0 + 5.5 * (rm - 6.28) - 0.55 * (lstat - 12.65)
            + 0.02 * (lstat - 12.65) ** 2 - 0.9 * (ptratio - 18.46)
            - 0.08 * crim + 3.0 * chas + rng.normal(0.0, 3.0, n))
    medv = np.round(np.clip(medv, 5.0, 50.0), 1)
    cols = dict(crim=crim, zn=zn, indus=indus, chas=chas, nox=nox, rm=rm,
                age=age, dis=dis, rad=rad, tax=tax, ptratio=ptratio, b=b,
                lstat=lstat, medv=medv)
    arr = np.stack([cols[c] for c in COLUMNS], axis=1)
    return [dict(zip(COLUMNS, map(float, arr[i]))) for i in range(n)]


def build_features():
    """(the twelve real predictors and chas, the medv label), as
    ``examples/boston.py``."""
    feats = [FeatureBuilder.of(c, Real).extract(
        lambda r, n=c: r.get(n)).as_predictor()
        for c in COLUMNS if c not in ("chas", "medv")]
    feats.append(FeatureBuilder.of("chas", Binary).extract(
        lambda r: bool(r.get("chas"))).as_predictor())
    label = FeatureBuilder.of("medv", RealNN).extract(
        lambda r: r.get("medv")).as_response()
    return feats, label


def default_selector(device="cuda", seed: int = 42, models=None,
                     validation: str = "exact"):
    """The example's selector: 3-fold CV over the default regression pool
    (or ``models``), ranked by RMSE, with a DataSplitter reserving 20 % of
    the records, on ``device``."""
    return RegressionModelSelector.with_cross_validation(
        num_folds=3, seed=seed,
        splitter=DataSplitter(reserve_test_fraction=0.2, seed=seed),
        models=models, validation=validation, device=device)


def holdout_records(records: Sequence[dict], seed: int = 42) -> List[dict]:
    """The records the example's DataSplitter reserves as its holdout."""
    y = np.array([r["medv"] for r in records], dtype=np.float64)
    _, test = DataSplitter(reserve_test_fraction=0.2, seed=seed).split(y)
    return [records[i] for i in test]


class BostonRun(NamedTuple):
    #: the selector's holdout metrics
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
        verbose: bool = False) -> BostonRun:
    """Train the example's workflow on ``records`` on ``device``: the
    selector reserves its holdout and evaluates the winner there.
    ``models`` replaces the default pool (each family on ``device``);
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
        print(f"holdout RMSE={metrics.RootMeanSquaredError:.3f} "
              f"R2={metrics.R2:.3f} ({seconds:.1f}s)")
    return BostonRun(metrics, seconds, model, wf, vector, prediction,
                     holdout_records(records, seed))


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--csv", default=None,
                    help="a housing.data file instead of synthetic records")
    args = ap.parse_args(argv)
    records = (load_boston(args.csv) if args.csv
               else synthetic_boston(args.rows, args.seed))
    result = run(records, device=args.device, seed=args.seed, verbose=True)
    from ..local import load_score_function
    path = os.path.join(tempfile.mkdtemp(prefix="boston_"), "model")
    result.model.save(path)
    served = load_score_function(path, device=args.device)(
        dict(result.holdout[0]))
    print(f"saved -> {path}; served one record: "
          f"{served[result.prediction.name]}")


if __name__ == "__main__":
    main()
