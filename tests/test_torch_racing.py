"""Racing (``RacingCrossValidation``) and ``TrainValidationSplit`` of the
PyTorch port against the JAX package's, in float64 on the CPU, on the same
numpy inputs.

Racing runs on 600 rows under two schedules given explicitly, so that the
JAX side reads no tuning store: the default eta 3 from 1/9 (a single-fold
rung on sliced rows, a single-fold rung on a whole fold, then full CV)
over a pool of LogisticRegression (4 points), GBTClassifier (5 rounds,
depths 2-4) and LinearSVC (2 points), and eta 2 from 1/4 (a single-fold
rung on sliced rows, a two-fold rung on masked rows, then full CV) over
the linear families.
Each candidate's pruned-at rung, rung and budget, the rung reports and the
winner are equal; the finalists' metrics within 1e-12. Forests are not
raced against the JAX package here: their draws are the port's own
(``TorchDraws``), so the port is held to the exactness contract instead,
a survivor's final-rung metrics equal to its exact-CV metrics bit for bit.
The single split equals the JAX package's to the index and picks its
winner. End to end, the port's Titanic ``run(validation="racing")`` picks
the JAX example's winner, both drawing from the same small pool."""
import numpy as np
import pytest

from examples import titanic as jax_titanic
from transmogrifai_tpu.evaluators import (
    BinaryClassificationEvaluator as JaxEvaluator)
from transmogrifai_tpu.models import registry as jax_registry
from transmogrifai_tpu.models import LinearSVC as JaxSVC
from transmogrifai_tpu.models import LogisticRegression as JaxLR
from transmogrifai_tpu.models.trees import GBTClassifier as JaxGBT
from transmogrifai_tpu.selector import SelectedModel as JaxSelected
from transmogrifai_tpu.selector.racing import (
    RacingCrossValidation as JaxRacing)
from transmogrifai_tpu.selector.validator import (
    TrainValidationSplit as JaxTVS)
from transmogrifai_tpu_torch.evaluators import BinaryClassificationEvaluator
from transmogrifai_tpu_torch.examples import titanic
from transmogrifai_tpu_torch.models import registry
from transmogrifai_tpu_torch.models.linear import LinearSVC, LogisticRegression
from transmogrifai_tpu_torch.models.trees import (GBTClassifier,
                                                  RandomForestClassifier)
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, CrossValidation, ModelSelectorSummary,
    RacingCrossValidation, SelectedModel, TrainValidationSplit,
    search_compiles)

LR_GRID = [{"reg_param": r} for r in (0.001, 0.01, 0.1, 1.0)]
GBT_GRID = [{"max_depth": d} for d in (2, 3, 4)]
SVC_GRID = [{"reg_param": r} for r in (0.01, 0.1)]
#: (eta, min_fidelity, families of the pool)
SCHEDULES = {"eta3": (3, 1 / 9, (0, 1, 2)), "eta2": (2, 0.25, (0, 2))}
#: finalists' metrics of the two packages
METRIC_TOL = 1e-12


def _data(n=600, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(size=(n, d - 3)),
                        (rng.uniform(size=(n, 3)) < 0.3).astype(float)],
                       axis=1)
    y = (X[:, 0] - X[:, 1] + 1.2 * X[:, -1] + rng.logistic(size=n)
         > 0.2).astype(float)
    return X, y


def _pools(families=(0, 1, 2), lr=LR_GRID, gbt=GBT_GRID, svc=SVC_GRID,
           rounds=5):
    """The same pool in both packages, (jax, port), of the families
    picked by index from LR, GBT, LinearSVC."""
    jax_pool = [(JaxLR(max_iter=30), lr), (JaxGBT(num_rounds=rounds), gbt),
                (JaxSVC(max_iter=30), svc)]
    port_pool = [(LogisticRegression(max_iter=30, device="cpu"), lr),
                 (GBTClassifier(num_rounds=rounds, device="cpu"), gbt),
                 (LinearSVC(max_iter=30, device="cpu"), svc)]
    return ([jax_pool[i] for i in families],
            [port_pool[i] for i in families])


def _trajectory(results):
    return [(r.model_name, r.grid_index, r.rung, r.pruned_at,
             r.budget_spent, len(r.metric_values)) for r in results]


def _report(report):
    return {k: v for k, v in report.items() if k != "searchSeconds"}


@pytest.fixture(scope="module", params=sorted(SCHEDULES))
def raced(request):
    eta, mf, families = SCHEDULES[request.param]
    X, y = _data()
    jax_pool, port_pool = _pools(families)
    ref_v = JaxRacing(JaxEvaluator(), num_folds=3, eta=eta, min_fidelity=mf,
                      stratify=True, mesh=None)
    got_v = RacingCrossValidation(BinaryClassificationEvaluator(),
                                  num_folds=3, eta=eta, min_fidelity=mf,
                                  stratify=True)
    ref = ref_v.validate(jax_pool, X, y)
    got = got_v.validate(port_pool, X, y)
    return ref, got, ref_v, got_v


def test_rung_trajectories_match_jax(raced):
    ref, got, ref_v, got_v = raced
    assert _trajectory(got.results) == _trajectory(ref.results)
    assert _report(got_v.last_report) == _report(ref_v.last_report)
    report = got_v.last_report
    assert report["raced"] and report["candidatesPruned"] > 0
    assert report["budgetSpentFoldFits"] < report["budgetFullCvFoldFits"]
    assert [r["rung"] for r in got_v.rung_profile] == [
        r["rung"] for r in report["rungs"]]


def test_finalists_and_winner_match_jax(raced):
    ref, got, _, _ = raced
    finalists = [(a, b) for a, b in zip(ref.results, got.results)
                 if a.pruned_at is None]
    assert finalists and all(len(b.metric_values) == 3
                             for _, b in finalists)
    for a, b in finalists:
        np.testing.assert_allclose(b.metric_values, a.metric_values,
                                   rtol=0, atol=METRIC_TOL)
    assert (got.name, got.params) == (ref.name, ref.params)
    assert abs(got.metric - ref.metric) <= METRIC_TOL


def test_racing_survivors_equal_exact_cv():
    """The exactness contract on the port alone, forests included: every
    finalist's metrics equal the exact CV's for the same candidate, bit
    for bit, and the winner is the exact CV's best finalist."""
    X, y = _data(seed=1)
    pool = [(LogisticRegression(max_iter=30, device="cpu"), LR_GRID[:2]),
            (RandomForestClassifier(num_trees=3, device="cpu"),
             [{"max_depth": d, "min_instances_per_node": m}
              for d in (3, 4) for m in (1, 20)]),
            (GBTClassifier(num_rounds=3, device="cpu"), GBT_GRID[:2])]
    ev = BinaryClassificationEvaluator()
    exact = CrossValidation(ev, stratify=True).validate(pool, X, y)
    racing = RacingCrossValidation(ev, stratify=True).validate(pool, X, y)
    by_key = {(r.model_name, r.grid_index): r for r in exact.results}
    finalists = [r for r in racing.results if r.pruned_at is None]
    assert finalists and len(finalists) < len(racing.results)
    for r in finalists:
        assert r.metric_values == by_key[(r.model_name,
                                          r.grid_index)].metric_values
    best = max(finalists, key=lambda r: r.mean_metric)
    assert (racing.name, racing.params) == (best.model_name, best.params)


def test_search_compiles_counts_new_shapes_only():
    X, y = _data(300, seed=2)
    pool = [(LogisticRegression(max_iter=10, device="cpu"), LR_GRID)]
    v = RacingCrossValidation(BinaryClassificationEvaluator(), stratify=True)
    v.validate(pool, X, y)
    first = search_compiles()
    v.validate(pool, X, y)
    assert search_compiles() == first >= 3


def test_selector_summary_carries_the_race():
    """The selector wires ``validation="racing"`` into its validator and
    records the race in its summary, whose JSON round-trips and whose
    ``pretty`` marks each candidate pruned or a finalist."""
    X, y = _data(seed=3)
    _, port_pool = _pools()
    sel = BinaryClassificationModelSelector.with_cross_validation(
        models=port_pool, validation="racing", eta=3, min_fidelity=1 / 9,
        stratify=True, device="cpu")
    assert isinstance(sel.validator, RacingCrossValidation)
    summary = sel.fit_arrays(X, y).summary
    assert summary.racing["raced"] and summary.racing["eta"] == 3
    assert summary.validation_type == "RacingCrossValidation"
    again = ModelSelectorSummary.from_json(summary.to_json())
    assert again.to_json() == summary.to_json()
    text = summary.pretty()
    assert "[finalist]" in text and "[pruned@rung0]" in text
    exact = BinaryClassificationModelSelector.with_cross_validation(
        models=port_pool, device="cpu").fit_arrays(X, y).summary
    assert "racing" not in exact.to_json()
    assert "rung" not in exact.to_json()["validationResults"][0]
    with pytest.raises(ValueError, match="requires a CrossValidation"):
        type(sel)(models=port_pool, device="cpu", validation="racing",
                  validator=TrainValidationSplit(
                      BinaryClassificationEvaluator()))


@pytest.mark.parametrize("stratify", [False, True])
def test_train_validation_split_matches_jax(stratify):
    X, y = _data(seed=4)
    ref_v = JaxTVS(JaxEvaluator(), train_ratio=0.7, seed=5,
                   stratify=stratify, mesh=None)
    got_v = TrainValidationSplit(BinaryClassificationEvaluator(),
                                 train_ratio=0.7, seed=5, stratify=stratify)
    (rt, rv), = ref_v._splits(y)
    (gt, gv), = got_v._splits(y)
    np.testing.assert_array_equal(gt, rt)
    np.testing.assert_array_equal(gv, rv)
    jax_pool, port_pool = _pools((0, 2))
    ref = ref_v.validate(jax_pool, X, y)
    got = got_v.validate(port_pool, X, y)
    assert (got.name, got.params) == (ref.name, ref.params)
    np.testing.assert_allclose([r.metric_values for r in got.results],
                               [r.metric_values for r in ref.results],
                               rtol=0, atol=METRIC_TOL)
    assert got_v.get_params() == ref_v.get_params()


def test_titanic_racing_run_picks_the_jax_winner(monkeypatch):
    """``run(validation="racing")`` of both examples on the same records,
    their default pools patched to the same small one: the same winner,
    the same pruned candidates."""
    jax_pool, port_pool = _pools(lr=LR_GRID[1:3], gbt=GBT_GRID[:1],
                                 svc=SVC_GRID[:1], rounds=3)
    monkeypatch.setattr(jax_registry, "default_binary_models",
                        lambda: jax_pool)
    monkeypatch.setattr(registry, "default_binary_models",
                        lambda device="cuda": port_pool)
    records = jax_titanic.synthetic_titanic(300, seed=17)
    _, _, ref_model = jax_titanic.run(records=records, verbose=False,
                                      validation="racing")
    got = titanic.run(records, device="cpu", validation="racing")
    ref_sel = next(s for s in ref_model.stages()
                   if isinstance(s, JaxSelected))
    got_sel = next(s for s in got.model.stages()
                   if isinstance(s, SelectedModel))
    assert got_sel.summary.best_model_name == \
        ref_sel.summary.best_model_name
    assert got_sel.summary.best_model_params == \
        ref_sel.summary.best_model_params
    assert _trajectory(got_sel.summary.validation_results) == \
        _trajectory(ref_sel.summary.validation_results)
