"""Titanic survival on the PyTorch port: the framework's hello-world
workflow.

Counterpart of ``examples/titanic.py`` (reference
helloworld/src/main/scala/com/salesforce/hw/OpTitanicSimple.scala:152):
typed raw features, familySize / estimatedCostOfTickets arithmetic, pivoted
sex, age group, normalized age, then ``transmogrify`` and the default
binary model selector under 3-fold stratified CV over the combined vector,
trained on a stratified 75 % split and evaluated on the 25 % holdout; then,
as the reference helloworld ends, the fitted model is saved, reloaded with
``local.load_score_function`` and serves one record (``demo_serve``). The
records are Titanic-shaped synthetic ones (``synthetic_titanic``: the
example's schema and marginals, drawn column by column with numpy).

Run:  python -m transmogrifai_tpu_torch.examples.titanic [--rows N]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np

from ..evaluators import BinaryClassificationEvaluator
from ..evaluators.base import EvaluationMetrics
from ..features.builder import FeatureBuilder
from ..features.columns import Dataset
from ..features.feature import Feature
from ..ops import transmogrify
from ..selector import BinaryClassificationModelSelector
from ..types import PickList
from ..workflow import Workflow, WorkflowModel

__all__ = ["age_to_group", "build_features", "synthetic_titanic",
           "stratified_split", "default_selector", "run", "TitanicRun",
           "SAMPLE_PASSENGER", "demo_serve"]

#: one servable passenger record (the save+serve demo and the parity
#: tests share it)
SAMPLE_PASSENGER = {"pClass": "1", "sex": "female", "age": 29.0,
                    "sibSp": 0, "parCh": 0, "fare": 100.0,
                    "embarked": "S", "name": "Test Passenger",
                    "ticket": "t", "cabin": "C1"}


def demo_serve(model: WorkflowModel, path: str, device="cuda") -> dict:
    """Persist ``model`` to ``path``, reload it through the local serving
    entry point with its model stage on ``device``, and score
    :data:`SAMPLE_PASSENGER` — the reference helloworld's save+serve
    story. Returns the served prediction dict."""
    from ..local import load_score_function
    model.save(path)
    score = load_score_function(path, device=device)
    row = score(dict(SAMPLE_PASSENGER))
    pred_key = next(f.name for f in model.result_features
                    if f.name != "survived")
    return row[pred_key]


def age_to_group(a) -> PickList:
    """Binned age (module-level, as in the example)."""
    return PickList(None if a.is_empty
                    else ("adult" if a.value > 18 else "child"))


def build_features():
    """Raw + engineered features (``examples/titanic.py:build_features``,
    OpTitanicSimple.scala:103-131): (label, transmogrified vector)."""
    survived = FeatureBuilder.real_nn("survived").extract(
        lambda r: r["survived"]).as_response()
    p_class = FeatureBuilder.pick_list("pClass").extract(
        lambda r: r["pClass"]).as_predictor()
    name = FeatureBuilder.text("name").extract(
        lambda r: r["name"]).as_predictor()
    sex = FeatureBuilder.pick_list("sex").extract(
        lambda r: r["sex"]).as_predictor()
    age = FeatureBuilder.real("age").extract(
        lambda r: r["age"]).as_predictor()
    sib_sp = FeatureBuilder.integral("sibSp").extract(
        lambda r: r["sibSp"]).as_predictor()
    par_ch = FeatureBuilder.integral("parCh").extract(
        lambda r: r["parCh"]).as_predictor()
    ticket = FeatureBuilder.pick_list("ticket").extract(
        lambda r: r["ticket"]).as_predictor()
    fare = FeatureBuilder.real("fare").extract(
        lambda r: r["fare"]).as_predictor()
    cabin = FeatureBuilder.pick_list("cabin").extract(
        lambda r: r["cabin"]).as_predictor()
    embarked = FeatureBuilder.pick_list("embarked").extract(
        lambda r: r["embarked"]).as_predictor()

    family_size = (sib_sp + par_ch + 1).alias("familySize")
    ticket_cost = (family_size * fare).alias("estimatedCostOfTickets")
    pivoted_sex = sex.pivot()
    normed_age = age.fill_missing_with_mean().z_normalize()
    age_group = age.map(age_to_group, PickList).alias("ageGroup")

    passenger_features = transmogrify([
        p_class, name, age, sib_sp, par_ch, ticket, cabin, embarked,
        family_size, ticket_cost, pivoted_sex, age_group, normed_age,
    ])
    return survived, passenger_features


def synthetic_titanic(n: int = 1000, seed: int = 42) -> list:
    """``n`` Titanic-shaped records with the marginals of
    ``examples/titanic.py:synthetic_titanic`` (sex, class, 20 % missing
    ages, 2 % missing fares, the same logistic survival model, Poisson
    family counts, 77 % missing cabins, four ports one of them missing),
    each column drawn at once with numpy rather than record by record, so
    the values differ from that function's for the same seed."""
    rng = np.random.default_rng(seed)
    female = rng.uniform(size=n) < 0.5
    p_class = rng.choice(np.asarray(["1", "2", "3"]), n, p=[0.24, 0.21, 0.55])
    age = np.clip(rng.normal(29, 14, n), 0.5, 80)
    age_missing = rng.uniform(size=n) < 0.2
    fare = np.round(rng.gamma(2.0, 16.0, n), 4)
    fare_missing = rng.uniform(size=n) < 0.02
    logit = (1.2 * female - 0.5 * (p_class == "3")
             - 0.01 * np.where(age_missing, 29.0, age)
             + 0.004 * np.where(fare_missing | (fare == 0), 32.0, fare) - 0.4)
    survived = rng.uniform(size=n) < 1 / (1 + np.exp(-logit))
    sib_sp = rng.poisson(0.5, n)
    par_ch = rng.poisson(0.4, n)
    ticket = rng.integers(1000, 9999, n)
    cabin_missing = rng.uniform(size=n) < 0.77
    deck = rng.integers(6, size=n)
    room = rng.integers(1, 99, n)
    ports = ["S", "C", "Q", None]
    port = rng.choice(4, n, p=[0.72, 0.19, 0.08, 0.01])
    return [{
        "id": i,
        "survived": float(survived[i]),
        "pClass": str(p_class[i]),
        "name": f"Passenger {i} {'Mrs' if female[i] else 'Mr'}",
        "sex": "female" if female[i] else "male",
        "age": None if age_missing[i] else float(age[i]),
        "sibSp": int(sib_sp[i]),
        "parCh": int(par_ch[i]),
        "ticket": f"T{ticket[i]}",
        "fare": None if fare_missing[i] else float(fare[i]),
        "cabin": None if cabin_missing[i] else f"{'ABCDEF'[deck[i]]}{room[i]}",
        "embarked": ports[port[i]],
    } for i in range(n)]


def stratified_split(records, label_key="survived", test_fraction=0.25,
                     seed=42):
    """Seeded stratified holdout split (``examples/titanic.py``; reference
    tuning/Splitter.scala:56): the same records go to the same side."""
    rng = np.random.default_rng(seed)
    y = np.array([r[label_key] for r in records])
    idx = np.arange(len(records))
    test_idx = []
    for cls in np.unique(y):
        cls_idx = idx[y == cls]
        perm = rng.permutation(cls_idx)
        n_test = int(round(len(cls_idx) * test_fraction))
        test_idx.extend(perm[:n_test])
    test_mask = np.zeros(len(records), dtype=bool)
    test_mask[test_idx] = True
    train = [records[i] for i in idx[~test_mask]]
    test = [records[i] for i in idx[test_mask]]
    return train, test


def default_selector(device="cuda", num_folds: int = 3, seed: int = 42,
                     validation: str = "exact", eta: int = 3,
                     min_fidelity: Optional[float] = None):
    """The example's selector: the whole default binary pool under
    ``num_folds``-fold stratified CV, on ``device``.
    ``validation="racing"`` races the pool under successive halving
    (``selector/racing.py``) instead of training all of it to
    completion."""
    return BinaryClassificationModelSelector.with_cross_validation(
        num_folds=num_folds, seed=seed, stratify=True, device=device,
        validation=validation, eta=eta, min_fidelity=min_fidelity)


class TitanicRun(NamedTuple):
    metrics: EvaluationMetrics
    #: wall seconds of train, score and evaluation
    seconds: float
    model: WorkflowModel
    workflow: Workflow
    #: the transmogrified feature vector and the prediction feature
    vector: Feature
    prediction: Feature
    scored: Dataset


def run(records, device="cuda", model_stage=None, verbose: bool = False,
        listener=None, workflow_cv: bool = False, validation: str = "exact",
        min_fidelity: Optional[float] = None) -> TitanicRun:
    """Train on a stratified 75 % split of ``records`` on ``device``,
    score and evaluate the 25 % holdout. ``model_stage`` replaces the
    default selector (it must compute on ``device``); ``listener`` (a
    ``utils.listener.WorkflowListener``) collects the per-stage profile.
    ``workflow_cv=True`` enables leakage-free workflow-level CV (every
    label-consuming selector ancestor refit per fold);
    ``validation="racing"`` runs the default selector's search under
    successive halving."""
    train, test = stratified_split(records)
    survived, features = build_features()
    stage = (model_stage if model_stage is not None
             else default_selector(device, validation=validation,
                                   min_fidelity=min_fidelity))
    prediction = stage.set_input(survived, features).get_output()
    t0 = time.perf_counter()
    wf = (Workflow(device=device)
          .set_result_features(survived, prediction)
          .set_input_records(train))
    if workflow_cv:
        wf = wf.with_workflow_cv()
    if listener is not None:
        wf = wf.with_listener(listener)
    model = wf.train()
    evaluator = BinaryClassificationEvaluator(
        label_col="survived", prediction_col=prediction.name)
    scored, metrics = model.score_and_evaluate(test, evaluator)
    elapsed = time.perf_counter() - t0
    if verbose:
        from ..selector import SelectedModel
        for s in model.stages():
            if isinstance(s, SelectedModel) and s.summary is not None:
                print(s.summary.pretty())
        print(f"Train rows: {len(train)}, holdout rows: {len(test)}")
        print(f"Holdout AuPR:   {metrics.AuPR:.4f}")
        print(f"Holdout AuROC:  {metrics.AuROC:.4f}")
        print(f"Wall clock: {elapsed:.2f}s")
    return TitanicRun(metrics, elapsed, model, wf, features, prediction,
                      scored)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(synthetic_titanic(args.rows, args.seed), device=args.device,
                 verbose=True)
    # the reference helloworld's full story: persist the trained model
    # and serve a single record from the saved directory
    path = os.path.join(tempfile.mkdtemp(prefix="titanic_"), "model")
    served = demo_serve(result.model, path, device=args.device)
    print(f"saved -> {path}; served one record: "
          f"P(survived)={served['probability_1']:.3f}")


if __name__ == "__main__":
    main()
