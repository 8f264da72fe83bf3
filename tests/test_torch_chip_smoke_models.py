"""CPU rehearsal of chip_smoke.py's model-layer phases at a tiny size on
an explicit CPU device: [host-metric] (a log-loss search of the small
pool through every family's batched fits, both validator paths on its
matrix, fold edges), [mlp] (the Iris workflow with the MLP grid, its
serving, a calibrator and an external family), [models-agree] (the CPU
on both sides) and their wiring into the runs (``--models-only``)."""
import inspect
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _main_source() -> str:
    return (inspect.getsource(chip_smoke.main)
            + inspect.getsource(chip_smoke._whole_smoke))


def _fake_card(monkeypatch):
    monkeypatch.setattr(chip_smoke.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "resolve_device",
                        lambda d: torch.device("cpu"))
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: {
        "kind": "fake", "count": 1, "smi": "fake, 1 W"})
    monkeypatch.setattr(chip_smoke, "phase_build", lambda: None)


def _tiny_small_models(monkeypatch):
    """The card-against-CPU pool at a CPU rehearsal's size: boosters at two
    rounds, forests at two trees."""
    real = chip_smoke.small_models
    monkeypatch.setattr(chip_smoke, "small_models",
                        lambda dev: real(dev, num_rounds=2, num_trees=2))


def test_host_metric_phase(monkeypatch):
    """[host-metric] on the CPU at a tiny size: every family takes its
    batched fit once, the tree families' models score through
    ``batch_predict_raw`` (two groups of two models a fold and family at
    depths 3 and 6, ... : one group a depth), the device and host paths
    give the same matrix and winner, and the fold-edge search runs with
    other edges."""
    _tiny_small_models(monkeypatch)
    out = chip_smoke.phase_host_metric("cpu", rows=400)
    assert sorted(out["families"]) == sorted(chip_smoke.FAMILIES)
    assert all(rec["calls"] == 1 and rec["candidates"] == 3 * n
               for rec, n in zip(
                   (out["families"][f] for f in chip_smoke.FAMILIES),
                   (8, 4, 4, 4)))
    groups = out["batch_predict_raw"]
    assert groups["calls"] == 12 and groups["models"] == 24
    assert groups["groups"] == 12
    assert np.isfinite(out["holdout_logloss"])
    assert out["device_vs_host"]["max_abs_diff"] <= 1e-12
    assert out["device_vs_host"]["same_winner"]
    assert out["fold_edges"]["max_abs_diff_to_matrix_edges"] > 0.0
    assert "k1" not in out


def test_mlp_phase():
    """[mlp] on the CPU at a tiny size: the MLP wins its own search, its
    L-BFGS refit is counted, the model serves; the calibrator and the
    external family serve one record each, the external as a host
    stage."""
    out = chip_smoke.phase_mlp("cpu", rows=600)
    assert out["winner"] == "MultilayerPerceptronClassifier"
    assert len(out["refits"]) == 1 and out["refits"][0]["iterations"] > 0
    assert out["serve"]["max_abs_diff_served"] <= 1e-6
    assert out["calibrator"]["coverage"]["fallback"] == []
    assert "SelectedModel" in str(out["external"]["coverage"]["fallback"])


def test_models_agree_phase(monkeypatch):
    """[models-agree] with the CPU on both sides: exact."""
    _tiny_small_models(monkeypatch)
    out = chip_smoke.phase_models_agree("cpu", rows=300)
    assert out["mlp"]["probability_max_diff"] == 0.0
    assert out["mlp"]["metric_max_diff"] == 0.0
    assert out["host_metric"]["max_abs_diff"] == 0.0
    assert out["host_metric"]["same_winner"]


def test_models_are_wired_in(monkeypatch, capsys):
    """``--models-only`` runs phases 1, 2 and the model-layer phases and
    prints their JSON last; the whole smoke runs them after the ingestion
    phases, [models-agree] in the worker, and lists the host-metric and
    fold-edge launches and the fold design's K1 cases on K1's line."""
    import json
    src = _main_source()
    assert src.count("phase_models(device") == 2
    assert src.index("phase_ingest_explain(device, trees") < src.index(
        "phase_models(device, agree=False)")
    assert "phase_models_agree" in chip_smoke.AGREE_PHASES
    for key in ('entry["launches_host_metric_by_family"]',
                'entry["launches_fold_edges"]',
                'mod["host_metric"]["k1"]["cases"]'):
        assert key in src, key
    calls = []
    _fake_card(monkeypatch)
    monkeypatch.setattr(chip_smoke, "phase_models",
                        lambda dev, **kw: calls.append(kw) or {"m": 1})
    assert chip_smoke.main(["--models-only", "--per-candidate"]) == 0
    assert calls == [{"per_candidate": True}]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"models": {"m": 1}}


def test_path_pool_cuts_the_forests():
    """The earlier slices' paths take the default pool with its forests at
    PATH_TREES trees, every grid whole; the Iris and Boston pools too."""
    from transmogrifai_tpu_torch.examples import boston, iris
    from transmogrifai_tpu_torch.models.registry import default_binary_models
    pool = chip_smoke.path_pool("cpu")
    ref = default_binary_models("cpu")
    assert [(type(e).__name__, g) for e, g in pool] == [
        (type(e).__name__, g) for e, g in ref]
    assert pool[1][0].num_trees == chip_smoke.PATH_TREES < ref[1][0].num_trees
    for example in (iris, boston):
        models = chip_smoke._problem_models(example, "cpu",
                                            chip_smoke.PATH_TREES)
        forests = [e for e, _ in models if hasattr(e, "num_trees")
                   and type(e).__name__.startswith("RandomForest")]
        assert [f.num_trees for f in forests] == [chip_smoke.PATH_TREES]
