"""The compiled ScoringPlan of the PyTorch port against the JAX package's
(float64, CPU), each package training the Titanic DAG once with a fixed
LogisticRegression stage and once with a fixed depth-3 GBT stage on the
same synthetic records: scores at batch sizes 1, 7, 8, 9 and 1000 within
1e-9 of the JAX plan's (predictions equal) and within 1e-12 of the port's
own columnar path, the same coverage, the same compile counts per bucket,
``bucket_for`` equal over a hypothesis range, and a kernel that raises
giving PlanCompileError instead of a demotion. On the CPU the plan runs
its composed program eagerly at each bucket's shape; the CUDA graphs are
captured and checked on the card by ``chip_smoke.py`` (``[serve-compiled]``)."""
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from examples import titanic as jax_titanic
from transmogrifai_tpu.models import LogisticRegression as JaxLR
from transmogrifai_tpu.models.trees import GBTClassifier as JaxGBT
from transmogrifai_tpu.plans.common import bucket_for as jax_bucket_for
from transmogrifai_tpu.serving import ScoringPlan as JaxPlan
from transmogrifai_tpu.serving import plan_compiles as jax_plan_compiles
from transmogrifai_tpu.tuning.lattice import default_lattice
from transmogrifai_tpu.workflow import Workflow as JaxWorkflow
from transmogrifai_tpu_torch.examples import titanic
from transmogrifai_tpu_torch.local import score_function_for
from transmogrifai_tpu_torch.models import GBTClassifier, LogisticRegression
from transmogrifai_tpu_torch.ops.dsl import StandardScalerModel
from transmogrifai_tpu_torch.plans.common import (bucket_for, bucket_ladder,
                                                  pad_rows, row_histogram)
from transmogrifai_tpu_torch.serving import (PlanCompileError, ScoringPlan,
                                             plan_compiles)
from transmogrifai_tpu_torch.workflow import Workflow

RECORDS = titanic.synthetic_titanic(1200, seed=21)
#: the training records: a small fit keeps the JAX compiles few
TRAIN = titanic.stratified_split(RECORDS[:600])[0]
BATCHES = [1, 7, 8, 9, 1000]
STAGES = {
    "lr": (lambda: JaxLR(reg_param=0.01, max_iter=30),
           lambda: LogisticRegression(reg_param=0.01, max_iter=30,
                                      device="cpu")),
    "gbt": (lambda: JaxGBT(max_depth=3, num_rounds=3),
            lambda: GBTClassifier(max_depth=3, num_rounds=3, device="cpu")),
}


def _norm(s):
    """A label with its 12-hex stage uids masked (the two packages count
    uids separately)."""
    return re.sub(r"[0-9a-f]{12}", "UID", s)


def _train(kind):
    jax_stage, port_stage = STAGES[kind]
    label, vector = jax_titanic.build_features()
    pred = jax_stage().set_input(label, vector).get_output()
    ref = (JaxWorkflow().set_result_features(label, pred)
           .set_input_records(TRAIN).train(validate="off"))
    label, vector = titanic.build_features()
    got_pred = port_stage().set_input(label, vector).get_output()
    got = (Workflow(device="cpu").set_result_features(label, got_pred)
           .set_input_records(TRAIN).train())
    return {"ref": ref, "ref_name": pred.name, "got": got,
            "name": got_pred.name}


@pytest.fixture(scope="module")
def models():
    return {kind: _train(kind) for kind in STAGES}


@pytest.fixture(scope="module")
def plans(models):
    """One compiled plan of each package per model, scoring every batch
    size once (the JAX package compiles one program per bucket)."""
    out = {}
    for kind, m in models.items():
        ref = JaxPlan(m["ref"]).compile()
        got = ScoringPlan(m["got"]).compile()
        out[kind] = {
            "ref": ref, "got": got,
            "ref_scored": {n: ref.score(RECORDS[:n])[m["ref_name"]]
                           for n in BATCHES},
            "got_scored": {n: got.score(RECORDS[:n])[m["name"]]
                           for n in BATCHES}}
    return out


@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("kind", sorted(STAGES))
def test_plan_scores_match_jax(plans, kind, n):
    a = plans[kind]["ref_scored"][n]
    b = plans[kind]["got_scored"][n]
    assert b.n_rows == n
    np.testing.assert_array_equal(b.data, a.data)
    np.testing.assert_allclose(b.probability, a.probability, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(b.raw_prediction, a.raw_prediction, rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("kind", sorted(STAGES))
def test_plan_scores_match_columnar(models, plans, kind, n):
    """The plan reproduces the port's own columnar path (every stage's
    numpy transform, the model's prediction on its device)."""
    m = models[kind]
    b = plans[kind]["got_scored"][n]
    c = m["got"].score(RECORDS[:n])[m["name"]]
    np.testing.assert_array_equal(b.data, c.data)
    np.testing.assert_allclose(b.probability, c.probability, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("kind", sorted(STAGES))
def test_coverage_matches_jax(plans, kind):
    """The same stages lower, and the same fall back to the host with the
    same reasons (the order of stages within one DAG layer is the
    packages' own)."""
    ref, got = plans[kind]["ref"], plans[kind]["got"]
    assert sorted(_norm(x) for x in got.coverage.lowered) == \
        sorted(_norm(x) for x in ref.coverage.lowered)
    assert sorted((_norm(a), _norm(b)) for a, b in got.coverage.fallback) \
        == sorted((_norm(a), _norm(b)) for a, b in ref.coverage.fallback)
    assert got.fallbacks() == ref.fallbacks() == 3
    dr, dg = ref.describe(), got.describe()
    for key in ("stages", "device_stages", "fallback_stages", "buckets"):
        assert dg[key] == dr[key]
    assert sorted(_norm(k) for k in dg["host_inputs"]) == \
        sorted(_norm(k) for k in dr["host_inputs"])
    assert dg["device"] == "cpu" and dg["captured_buckets"] == []


def test_compiles_per_bucket_match_jax(models):
    """``plan_compiles()`` grows by one per new bucket and by zero on a
    repeat, in both packages alike."""
    m = models["lr"]
    ref, got = JaxPlan(m["ref"]).compile(), ScoringPlan(m["got"]).compile()
    steps = [7, 5, 9, 16, 1000, 1000, 1]
    grew = []
    for n in steps:
        r0, g0 = jax_plan_compiles(), plan_compiles()
        ref.score(RECORDS[:n])
        got.score(RECORDS[:n])
        grew.append((jax_plan_compiles() - r0, plan_compiles() - g0))
    assert grew == [(1, 1), (0, 0), (1, 1), (0, 0), (1, 1), (0, 0),
                    (0, 0)]
    assert sorted(got.bucket_profile()) == [8, 16, 1024]
    profile = got.bucket_profile()
    assert profile[8]["rows"] == 7 + 5 + 1 and profile[8]["calls"] == 3
    assert profile[1024]["calls"] == 2
    assert profile[16]["compile_seconds"] == 0.0    # nothing captured
    assert row_histogram("score")[1000] >= 2


@settings(max_examples=200, deadline=None)
@given(n=st.integers(0, 20_000),
       lo=st.sampled_from([1, 2, 3, 8, 16]),
       hi=st.sampled_from([8, 64, 1000, 1024, 8192, 10_000]))
def test_bucket_for_matches_jax(n, lo, hi):
    assert bucket_for(n, lo, hi) == jax_bucket_for(n, lo, hi)
    assert bucket_ladder(lo, hi) == default_lattice(lo, hi)


def test_pad_rows_numpy_and_tensor():
    a = np.arange(6.0).reshape(3, 2)
    padded = pad_rows(a, 8)
    assert padded.shape == (8, 2) and not padded[3:].any()
    np.testing.assert_array_equal(padded[:3], a)
    t = torch.arange(3, dtype=torch.int32)
    tp = pad_rows(t, 8)
    assert tp.dtype == torch.int32 and tp.tolist() == [0, 1, 2] + [0] * 5
    assert pad_rows(t, 3) is t


def test_kernel_failure_raises_plan_compile_error(models, monkeypatch):
    """A stage whose kernel raises fails the plan by name: it is not
    demoted to its host path."""
    def broken(self, arrays):
        raise RuntimeError("broken kernel")
    monkeypatch.setattr(StandardScalerModel, "transform_arrays", broken)
    with pytest.raises(PlanCompileError,
                       match=r"StandardScalerModel\(.*broken kernel"):
        ScoringPlan(models["lr"]["got"]).compile()


def test_engines_and_score_batch(models):
    """``WorkflowModel.score(engine="compiled")`` is the cached plan's
    score; ``score_batch``'s default engine is the plan, and equals the
    record loop."""
    m = models["gbt"]
    model, name = m["got"], m["name"]
    a = model.score(RECORDS[:20], engine="compiled")[name]
    assert model.scoring_plan() is model.scoring_plan()
    b = model.scoring_plan().score(RECORDS[:20])[name]
    np.testing.assert_array_equal(a.probability, b.probability)
    with pytest.raises(ValueError, match="keep_intermediate"):
        model.score(RECORDS[:2], engine="compiled", keep_intermediate=True)
    score = score_function_for(model)
    rows = score.score_batch(RECORDS[:5])
    loop = score.score_batch(RECORDS[:5], engine="records")
    for got, want in zip(rows, loop):
        assert got[name] == pytest.approx(want[name], abs=1e-12)


def test_plan_device_follows_the_model(models):
    """A CPU model gives a CPU plan; asking it for another device is an
    error, not a copy."""
    model = models["lr"]["got"]
    assert ScoringPlan(model).device.type == "cpu"
    with pytest.raises(ValueError, match="computes on cpu"):
        ScoringPlan(model, device="cuda:0" if torch.cuda.is_available()
                    else "cuda")
    with pytest.raises(ValueError, match="bad bucket range"):
        ScoringPlan(model, min_bucket=16, max_bucket=8)


def test_prewarm_and_run_eager(models):
    """``prewarm`` runs each bucket once on the CPU (on a card it captures
    the graphs); ``run_eager`` is the composed program on one chunk, and
    the dispatch path gives the same rows."""
    plan = ScoringPlan(models["lr"]["got"], max_bucket=32).compile()
    c0 = plan_compiles()
    warmed = plan.prewarm()
    assert sorted(warmed) == [8, 16, 32] and plan_compiles() == c0 + 3
    with pytest.raises(ValueError, match="outside"):
        plan.prewarm([64])
    from transmogrifai_tpu_torch.workflow.workflow import _generate_raw_data
    ds = _generate_raw_data(plan.model.raw_features(), RECORDS[:40],
                            require_responses=False)
    enc = plan.encode_raw_dataset(ds)
    assert [(b, r) for b, _, _, r in enc.chunks] == [(32, 32), (8, 8)]
    bucket, inputs, mask, rows = enc.chunks[0]
    eager = plan.run_eager(inputs, mask)
    scored = plan.dispatch_encoded(enc)[models["lr"]["name"]]
    np.testing.assert_array_equal(scored.raw_prediction[:32],
                                  eager[0][:rows])


@pytest.fixture(scope="module")
def checked(tmp_path_factory):
    from test_torch_persistence import checked_filtered_models
    return checked_filtered_models(tmp_path_factory.mktemp("checked"))


def test_checked_model_plan_serves_label_less_records(checked):
    """A reloaded model with a SanityChecker stage behind a raw feature
    filter: the checker's column gather runs inside the compiled plan,
    whose label input is NaN-filled for records without one; the plan
    serves ``SAMPLE_PASSENGER`` within 1e-9 of the JAX package's
    ``demo_serve`` answer and scores holdout-like records as the columnar
    path does, within 1e-12."""
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    ref_row, model, path = checked
    loaded = WorkflowModel.load(path, device="cpu")
    plan = ScoringPlan(loaded).compile()
    assert any(label.startswith("SanityCheckerModel(")
               for label in plan.coverage.lowered)
    pred = next(f.name for f in loaded.result_features
                if f.name != "survived")
    served = plan.score([dict(titanic.SAMPLE_PASSENGER)])[pred]
    assert served.data[0] == ref_row["prediction"]
    assert served.probability[0, 1] == pytest.approx(
        ref_row["probability_1"], abs=1e-9)
    records = [{k: v for k, v in r.items() if k != "survived"}
               for r in RECORDS[:50]]
    compiled = loaded.score(records, engine="compiled")[pred]
    columnar = loaded.score(records)[pred]
    np.testing.assert_allclose(compiled.probability, columnar.probability,
                               rtol=0, atol=1e-12)
