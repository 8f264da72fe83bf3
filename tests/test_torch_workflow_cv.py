"""Workflow-level CV of the PyTorch port against the JAX package's, in
float64 on the CPU, on the Titanic DAG with a SanityChecker between
``transmogrify`` and the selector (the project generator's app), trained
by both packages on the same 600 synthetic records' 75 % split: ``cut_dag``
finds the same in-CV segment, and with the checker refit inside every fold
the selector's fold x grid metric matrix is within 1e-12 of the JAX
package's and picks its winner, with the default ``DataBalancer`` splitter
and without a splitter. The port's pre-pass fits the vectorizers once and
the final prepare plan reuses them; the fold matrices stay tensors. End
to end, ``run(workflow_cv=True)`` on the plain DAG (no label-consuming
stage, so the search is the exact one) picks the JAX example's winner."""
import re

import numpy as np
import pytest
import torch

from examples import titanic as jax_titanic
from transmogrifai_tpu.models import LogisticRegression as JaxLR
from transmogrifai_tpu.models import registry as jax_registry
from transmogrifai_tpu.models.trees import GBTClassifier as JaxGBT
from transmogrifai_tpu.selector import SelectedModel as JaxSelected
from transmogrifai_tpu.selector.factories import (
    BinaryClassificationModelSelector as JaxSelector)
from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
from transmogrifai_tpu.workflow.workflow import cut_dag as jax_cut_dag
from transmogrifai_tpu_torch.examples import titanic
from transmogrifai_tpu_torch.models import registry
from transmogrifai_tpu_torch.models.linear import LogisticRegression
from transmogrifai_tpu_torch.models.trees import GBTClassifier
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, SelectedModel)
from transmogrifai_tpu_torch.selector import validator as port_validator
from transmogrifai_tpu_torch.workflow import Workflow, cut_dag

LR_GRID = [{"reg_param": 0.01}, {"reg_param": 0.1}]
GBT_GRID = [{"max_depth": 2}, {"max_depth": 3}]
RECORDS = titanic.synthetic_titanic(600, seed=19)
TRAIN = titanic.stratified_split(RECORDS)[0]
#: fold x grid metrics of the two packages
METRIC_TOL = 1e-12


def _dag(pkg, selector):
    label, vector = pkg.build_features()
    checked = vector.sanity_check(label)
    return label, selector.set_input(label, checked).get_output()


def _jax_selector(splitter):
    kw = {} if splitter else {"splitter": None}
    sel = JaxSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, mesh=None,
        models=[(JaxLR(max_iter=30), LR_GRID),
                (JaxGBT(num_rounds=3), GBT_GRID)])
    if not splitter:
        sel.splitter = None
    return sel


def _port_selector(splitter):
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, device="cpu",
        models=[(LogisticRegression(max_iter=30, device="cpu"), LR_GRID),
                (GBTClassifier(num_rounds=3, device="cpu"), GBT_GRID)])
    if not splitter:
        sel.splitter = None
    return sel


def _matrix(model, cls):
    sel = next(s for s in model.stages() if isinstance(s, cls))
    return np.array([r.metric_values
                     for r in sel.summary.validation_results]).T, sel


def test_cut_dag_finds_the_same_segment():
    segments = []
    for pkg, sel, cut in ((jax_titanic, _jax_selector(True), jax_cut_dag),
                          (titanic, _port_selector(True), cut_dag)):
        label, pred = _dag(pkg, sel)
        found, during = cut([label, pred])
        assert found is sel
        segments.append([[type(s).__name__ for s in layer]
                         for layer in during])
        plain_label, plain_vec = pkg.build_features()
        sel2 = (_jax_selector(True) if pkg is jax_titanic
                else _port_selector(True))
        plain = sel2.set_input(plain_label, plain_vec).get_output()
        assert cut([plain_label, plain]) == (sel2, [])
    assert segments[1] == segments[0] == [["SanityChecker"]]


@pytest.fixture(scope="module", params=["balancer", "no_splitter"])
def trained(request):
    splitter = request.param == "balancer"
    label, pred = _dag(jax_titanic, _jax_selector(splitter))
    ref = (JaxWorkflow().set_result_features(label, pred)
           .set_input_records(TRAIN).with_workflow_cv()
           .train(validate="off"))
    label, pred = _dag(titanic, _port_selector(splitter))
    wf = (Workflow(device="cpu").set_result_features(label, pred)
          .set_input_records(TRAIN).with_workflow_cv())
    seen = []
    real = port_validator._ValidatorBase.validate_prepared

    def spy(self, models, folds):
        seen.extend(folds)
        return real(self, models, folds)

    port_validator._ValidatorBase.validate_prepared = spy
    try:
        got = wf.train()
    finally:
        port_validator._ValidatorBase.validate_prepared = real
    return ref, got, wf, seen


def test_fold_grid_metrics_and_winner_match_jax(trained):
    ref, got, _, _ = trained
    a, ref_sel = _matrix(ref, JaxSelected)
    b, got_sel = _matrix(got, SelectedModel)
    assert a.shape == b.shape == (3, 4) and np.all(np.isfinite(b))
    np.testing.assert_allclose(b, a, rtol=0, atol=METRIC_TOL)
    assert got_sel.summary.best_model_name == \
        ref_sel.summary.best_model_name
    assert got_sel.summary.best_model_params == \
        ref_sel.summary.best_model_params
    for which in ("train_evaluation", "holdout_evaluation"):
        ra, rb = (getattr(s.summary, which) for s in (ref_sel, got_sel))
        assert (ra is None) == (rb is None)
        if ra is not None:
            assert abs(rb.AuPR - ra.AuPR) <= METRIC_TOL


def test_final_checker_matches_jax(trained):
    ref, got, _, _ = trained
    kept = [next(s for s in m.stages()
                 if type(s).__name__ == "SanityCheckerModel").kept_indices
            for m in (ref, got)]
    assert kept[1] == kept[0]


def test_folds_are_tensors_and_the_prepass_is_reused(trained):
    """Each fold's matrices reach the search as CPU tensors of the refit
    checker's width; the vectorizers fit once, in the pre-pass, and the
    final prepare plan fits only the checker and the selector."""
    _, got, wf, seen = trained
    assert len(seen) == 3
    widths = wf.last_workflow_cv["fold_widths"]
    for (X_tr, y_tr, X_val, y_val), w in zip(seen, widths):
        assert isinstance(X_tr, torch.Tensor) and X_tr.dtype == torch.float64
        assert X_tr.shape[1] == X_val.shape[1] == w
        assert X_tr.shape[0] == len(y_tr) and X_val.shape[0] == len(y_val)
    fits = [re.sub(r"\(.*", "", label)
            for label, _, _ in wf.last_prepare_plan.fit_placements]
    assert fits == ["SanityChecker", "ModelSelector"]
    cv = wf.last_workflow_cv
    assert len(cv["fold_refit_seconds"]) == 3 and cv["search_seconds"] > 0


def test_titanic_workflow_cv_run_picks_the_jax_winner(monkeypatch):
    jax_pool = [(JaxLR(max_iter=30), LR_GRID), (JaxGBT(num_rounds=3),
                                                 GBT_GRID[:1])]
    port_pool = [(LogisticRegression(max_iter=30, device="cpu"), LR_GRID),
                 (GBTClassifier(num_rounds=3, device="cpu"), GBT_GRID[:1])]
    monkeypatch.setattr(jax_registry, "default_binary_models",
                        lambda: jax_pool)
    monkeypatch.setattr(registry, "default_binary_models",
                        lambda device="cuda": port_pool)
    records = jax_titanic.synthetic_titanic(300, seed=23)
    _, _, ref_model = jax_titanic.run(records=records, verbose=False,
                                      workflow_cv=True)
    got = titanic.run(records, device="cpu", workflow_cv=True)
    a, ref_sel = _matrix(ref_model, JaxSelected)
    b, got_sel = _matrix(got.model, SelectedModel)
    assert (got_sel.summary.best_model_name,
            got_sel.summary.best_model_params) == \
        (ref_sel.summary.best_model_name, ref_sel.summary.best_model_params)
    np.testing.assert_allclose(b, a, rtol=0, atol=METRIC_TOL)
    assert got.workflow.last_workflow_cv == {}   # no in-CV segment
