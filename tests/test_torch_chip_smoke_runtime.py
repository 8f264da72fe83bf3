"""CPU rehearsal of chip_smoke.py's fault-tolerant runtime phases at a
tiny size on an explicit CPU device: [resume] (kill and resume of the
Titanic search under exact CV and racing), [heal] (drift, background
retrain, canary, hot swap and rollback under live traffic) and the
all-families-failed half of [quarantine], with their wiring into the
runs (``--runtime-only``, the whole smoke's worker). [quarantine]'s
allocator limit (``torch.cuda.set_per_process_memory_fraction`` and the
real CUDA out-of-memory it provokes) needs a card and is not rehearsed
here."""
import inspect
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from transmogrifai_tpu_torch.examples import titanic  # noqa: E402
from transmogrifai_tpu_torch.models.linear import (  # noqa: E402
    LinearSVC, LogisticRegression)
from transmogrifai_tpu_torch.models.trees import (  # noqa: E402
    GBTClassifier, RandomForestClassifier)
from transmogrifai_tpu_torch.runtime import telemetry  # noqa: E402
from transmogrifai_tpu_torch.selector import (  # noqa: E402
    BinaryClassificationModelSelector)


def _tiny_pool(dev):
    """The default pool's four families at a rehearsal's size, in its
    order."""
    return [(LogisticRegression(device=dev),
             [{"reg_param": 0.01}, {"reg_param": 0.1}]),
            (RandomForestClassifier(num_trees=2, device=dev),
             [{"max_depth": 3}, {"max_depth": 4}]),
            (GBTClassifier(num_rounds=2, device=dev),
             [{"max_depth": 2}, {"max_depth": 3}]),
            (LinearSVC(device=dev), [{"reg_param": 0.01},
                                     {"reg_param": 0.1}])]


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    telemetry.reset()
    yield
    telemetry.reset()


def test_resume_phase(monkeypatch):
    """[resume]: run B killed at GBT's dispatch (exact) and at the rung 1
    boundary (racing) resumes to run A's winner, its journaled entries
    replayed bit for bit and none dispatched again."""
    monkeypatch.setattr(chip_smoke, "path_pool", _tiny_pool)
    out = chip_smoke.phase_resume("cpu", rows=400)
    exact, racing = out["exact"], out["racing"]
    assert exact["journaled"] == ["0:LogisticRegression/exact",
                                  "1:RandomForestClassifier/exact"]
    assert exact["dispatched_on_resume"] == ["2:GBTClassifier/exact",
                                             "3:LinearSVC/exact"]
    assert exact["journal_hits"] == 2 and exact["journal_lines"] == 5
    assert exact["resume_saved_fold_fits"] == 12
    assert all(j.endswith("/rung0") for j in racing["journaled"])
    assert not any(d.endswith("/rung0")
                   for d in racing["dispatched_on_resume"])
    for case in (exact, racing):
        assert case["max_metric_gap_vs_run_a"] == 0.0
        assert case["journal_bytes"] > 0 and case["journal_fsync_s"] > 0


def test_heal_phase():
    """[heal] on the CPU: the shifted stream arms the lifecycle, the
    retrain's candidate swaps in with no request dropped and no compile
    after it, tenant b keeps its entry and answers, and the injected
    post-swap preemption rolls the swap back."""
    out = chip_smoke.phase_heal("cpu", rows=2000, models=_tiny_pool)
    assert out["requests_dropped"] == 0 and out["failed_batches"] == 0
    assert out["plan_compiles_after"] == out["plan_compiles_at_swap"]
    assert out["tenant_b_entry_kept"] and out["tenant_b_answers_equal"]
    assert out["restored_original"]
    assert out["phases"] == ["detect", "retrain_start", "retrain_end",
                             "canary_pass", "swap", "rollback"]
    assert out["retrain_s"] > 0 and out["retrain_rows"] > 1500
    assert out["requests_before"] and out["requests_during"] \
        and out["requests_after"]
    assert out["swapped_generation"] == 1


def test_all_families_fail():
    """[quarantine]'s second half: an OOM at every family's dispatch
    raises one AllFamiliesFailedError naming all four."""
    train, _ = titanic.stratified_split(titanic.synthetic_titanic(200))
    dev = torch.device("cpu")
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, stratify=True, models=_tiny_pool(dev),
        device=dev)
    from transmogrifai_tpu_torch.runtime import RetryPolicy
    sel.retry_policy = RetryPolicy(max_attempts=1)
    assert chip_smoke.all_families_fail(dev, train, sel) == sorted(
        chip_smoke.FAMILIES)


def test_runtime_wiring(monkeypatch, capsys):
    """``--runtime-only`` runs phases 1, 2, [resume], [heal] and a spawned
    [quarantine] and prints their JSON last with the budget; the whole
    smoke runs [heal] after the profiles, [resume] and [quarantine] in
    its worker, and reports K1's launches on both paths."""
    monkeypatch.setattr(chip_smoke.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "resolve_device",
                        lambda d: torch.device("cpu"))
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: {
        "kind": "fake", "count": 1, "smi": "fake, 1 W"})
    monkeypatch.setattr(chip_smoke, "phase_build", lambda: None)
    ran = []
    for name in ("phase_resume", "phase_heal"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda dev, *rows, n=name: ran.append(n)
                            or {"seconds": 30.0})
    monkeypatch.setattr(chip_smoke, "_spawned",
                        lambda name, dev: ran.append(name)
                        or {"seconds": 40.0})
    assert chip_smoke.main(["--runtime-only"]) == 0
    assert ran == ["phase_resume", "phase_heal", "phase_quarantine"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["runtime"]["seconds"] == 100.0
    assert last["runtime"]["within_budget"] is False
    whole = inspect.getsource(chip_smoke._whole_smoke)
    assert "phase_heal(device)" in whole
    for name in ("phase_resume", "phase_quarantine"):
        assert f'worker.result("{name}")' in whole
        assert name in chip_smoke.AGREE_PHASES
    assert "launches_resume" in whole and "launches_heal" in whole
    assert chip_smoke.RUNTIME_PHASES_BUDGET_S == 90


def test_a_quarantine_fails_a_path_phase():
    """A family quarantined on a search path fails the smoke: a GBT whose
    every dispatch meets an out-of-memory leaves [main]'s search with LR
    alone, and ``forbid_quarantines`` (around every phase but
    [quarantine]) raises on leaving it."""
    from transmogrifai_tpu_torch.runtime import FaultInjector
    X, y = chip_smoke.make_data(600, 8)
    models = chip_smoke.small_models(
        "cpu", num_rounds=2,
        families=("LogisticRegression", "GBTClassifier"))
    with pytest.raises(AssertionError, match="GBTClassifier"):
        with chip_smoke.forbid_quarantines("main"), \
                FaultInjector.plan("family:GBTClassifier:dispatch:*=oom"):
            chip_smoke.phase_main("cpu", X, y, models=models, tag="oom")
    assert not chip_smoke.QUARANTINES


def test_quarantine_guard_wiring(monkeypatch):
    """``main`` runs its phases under the guard and each lap checks it;
    the worker's phases run under it too, all but [quarantine]."""
    from transmogrifai_tpu_torch.runtime.context import RuntimeContext
    real = RuntimeContext.quarantine
    monkeypatch.setattr(chip_smoke.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "resolve_device",
                        lambda d: torch.device("cpu"))
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: {
        "kind": "fake", "count": 1, "smi": "fake, 1 W"})
    monkeypatch.setattr(chip_smoke, "phase_build", lambda: None)

    def quarantining(dev, *rows):
        RuntimeContext().quarantine("GBTClassifier", "out of memory",
                                    "transient")
        return {"seconds": 1.0}
    monkeypatch.setattr(chip_smoke, "phase_runtime", quarantining)
    with pytest.raises(AssertionError, match="11 runtime"):
        chip_smoke.main(["--runtime-only"])
    assert RuntimeContext.quarantine is real
    monkeypatch.setattr(chip_smoke, "phase_models_agree", quarantining)
    monkeypatch.setattr(chip_smoke, "phase_quarantine", quarantining)
    with pytest.raises(AssertionError, match="phase_models_agree"):
        chip_smoke._agree_phase("phase_models_agree", "cpu")
    assert chip_smoke._agree_phase("phase_quarantine", "cpu") == {
        "seconds": 1.0}
