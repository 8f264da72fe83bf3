"""CPU rehearsal of chip_smoke.py: the main-path (GBT alone, and the four
families of the default pool), card-against-CPU, L-BFGS and
single-record phases, the linear search slice and the forest-shape K1
inputs (random and a real level's slots), the workflow's save-and-serve
and compiled-serving phases, the feature-validation phases
([validate], [workflow-cv], [validate-agree]) and the multiclass and
regression phases ([k1-problems]' inputs, [iris], [boston],
[problems-agree]), the family phases and the text phases ([text] with its
default ``ServeConfig()`` server, [k1-text]'s inputs, [text-agree]) at a
tiny size on an explicit CPU device, the drift sentinel's checks in the
serving phases, the phases' wiring into the runs (``--problems-only``,
``--families-only``, ``--text-only``, ``--readers-only`` and
``--workflow-only --agree-witness-rows`` among them), the ingestion and
explainability phases ([quickstart], [readers], [insights]), the tree
families' float64 witness (``tree_dtype``), and the script's refusal to
run without a card."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def tiny():
    X, y = chip_smoke.make_data(1500, 12)
    out = chip_smoke.phase_main("cpu", X, y, models=chip_smoke.small_models(
        "cpu", num_rounds=2, families=("GBTClassifier",)), tag="rehearse")
    return X, y, out


def test_main_phase(tiny):
    X, _, out = tiny
    assert out["candidates"] == 3 * len(chip_smoke.SMALL_GRID)
    mm = np.asarray(out["metric_matrix"])
    assert mm.shape == (3, 4) and np.all(np.isfinite(mm))
    assert out["k1_launches"] == 0          # the CPU takes the plain path
    assert 0.5 < out["holdout_AuROC"] <= 1.0
    assert out["winner"] == "GBTClassifier"
    assert out["winner_params"] == chip_smoke.SMALL_GRID[out["winner_index"]]


def test_serve_phase(tiny):
    X, _, out = tiny
    assert chip_smoke.phase_serve(out["selected"], X) <= 1e-6


def test_card_vs_cpu_phase():
    got = chip_smoke.phase_card_vs_cpu("cpu", 900, 10, num_rounds=2,
                                       num_trees=2)
    assert got["max_abs_diff"] == 0.0 and got["same_winner"]
    assert got["max_abs_diff_by_family"] == {
        "LogisticRegression": 0.0, "RandomForestClassifier": 0.0,
        "GBTClassifier": 0.0, "LinearSVC": 0.0}
    lbfgs = got["lbfgs"]
    assert lbfgs["card_iterations"] == lbfgs["cpu_iterations"] >= 1
    assert lbfgs["max_coef_diff"] == 0.0
    assert lbfgs["aupr_card"] == lbfgs["aupr_cpu"] > 0.5


def test_main_phase_rf_and_gbt():
    """The main path's four families (the linear ones with their default
    8- and 4-point grids), each timed, in the pool's order; a fitted
    forest scores single records as in a batch."""
    X, y = chip_smoke.make_data(1200, 20, seed=2)
    models = chip_smoke.small_models("cpu", num_rounds=2, num_trees=3)
    out = chip_smoke.phase_main("cpu", X, y, models=models,
                                tag="rehearse-rf")
    assert list(out["families"]) == list(chip_smoke.FAMILIES)
    for (_, grid), rec in zip(models, out["families"].values()):
        assert rec["candidates"] == 3 * len(grid) and rec["seconds"] > 0
        assert rec["k1_launches"] == 0       # the CPU takes the plain path
    assert [len(g) for _, g in models] == [8, 4, 4, 4]
    mm = np.asarray(out["metric_matrix"])
    assert mm.shape == (3, 20) and np.all(np.isfinite(mm))
    grids = [(type(est).__name__, p) for est, grid in models for p in grid]
    assert (out["winner"], out["winner_params"]) == grids[
        out["winner_index"]]
    # the LR and SVC searches run the fixed 250 iterations; an L1
    # logistic refit stops on its own
    assert out["fista_iterations"][:2] == [250, 250]
    if out["winner"] == "LogisticRegression":
        assert len(out["fista_iterations"]) == 3
    forest = chip_smoke.RandomForestClassifier(
        num_trees=3, max_depth=4, device="cpu").fit_arrays(X, y)
    assert chip_smoke.phase_serve(forest, X, tag="rehearse-rf") <= 1e-6
    mm = chip_smoke.search_slice("cpu", X, y, num_trees=2, depth=3)()
    assert mm.shape == (3, 6) and np.all(np.isfinite(mm))


def test_forest_k1_inputs():
    """The forest-shape K1 input: tree 0's 40-feature pool of a 100-column
    design (32 narrow at 2 bins, 8 wide at 32: TB = 320, uint8 ids at a
    48-byte stride), with integer class-weight stats, a third of the rows
    masked out; K1's plain version sums them exactly."""
    X, y = chip_smoke.make_data(3000, chip_smoke.COLS, seed=3)
    tree, stats = chip_smoke.forest_k1_inputs("cpu", X, y)
    assert (tree.d, tree.total_bins, tree.ids.shape) == (40, 320, (3000, 48))
    assert tree.ids.dtype == torch.uint8 and stats.shape == (3000, 2)
    assert torch.equal(stats, stats.round()) and not stats[::3].any()
    assert torch.all((stats != 0).sum(dim=1) <= 1)
    slot = torch.randint(0, 32, (3000,), dtype=torch.int32)
    hist = chip_smoke.level_hist(tree.ids, tree.offsets, slot, stats, 32,
                                 tree.total_bins)
    assert torch.equal(hist.sum(dim=1), 40 * torch.zeros(
        (32, 2), dtype=stats.dtype).index_add_(0, slot.long(), stats))


def test_real_level_inputs():
    """The real-slot K1 cases: level 8 of the RF search's depth-12 trees
    (3 folds x 2 trees), as the search launches them (C = 256 compressed
    slots over the pooled design, integer stats); K1's plain version sums
    each exactly into its slots' totals."""
    X, y = chip_smoke.make_data(3000, chip_smoke.COLS, seed=4)
    levels = chip_smoke.real_level_inputs("cpu", X, y, num_trees=2)
    assert len(levels) == 6
    occupied = []
    for design, slot, stats, C in levels:
        assert C == 256 and slot.dtype == torch.int32
        assert (design.d, design.total_bins) == (40, 320)
        assert torch.equal(stats, stats.round())
        live = slot < C
        occupied.append(int(torch.unique(slot[live]).numel()))
        hist = chip_smoke.level_hist(design.ids, design.offsets, slot,
                                     stats, C, design.total_bins)
        totals = torch.zeros((C, 2), dtype=stats.dtype).index_add_(
            0, slot[live].long(), stats[live])
        assert torch.equal(hist.sum(dim=1), 40 * totals)
    assert max(occupied) > 8


def test_linear_phases():
    """The L-BFGS LinearSVC fit phase, single records through the SVC
    (raw margins, no probability), and the LR search slice the profile
    runs."""
    X, y = chip_smoke.make_data(1500, 12, seed=5)
    rec, svc = chip_smoke.phase_lbfgs("cpu", X, y)
    assert 1 <= rec["iterations"] <= 50 and 0.5 < rec["aupr"] <= 1.0
    assert svc.predict_arrays(X[:3]).probability.shape == (3, 0)
    assert chip_smoke.phase_serve(svc, X, tag="rehearse-svc") <= 1e-5
    mm = chip_smoke.linear_search("cpu", X, y)()
    assert mm.shape == (3, 8) and np.all(np.isfinite(mm))
    # the profile's shorter window: fewer FISTA iterations, same shape
    with chip_smoke.iterations_of("fista_minimize") as fista:
        mm = chip_smoke.linear_search("cpu", X, y, max_iter=4)()
    assert mm.shape == (3, 8) and [int(i.max()) for i in fista] == [20]


def test_search_rows():
    """The rows the linear products and the search profiles run on are
    the selector's own training rows: the 90 % left by its stratified
    holdout split, the label's balance kept."""
    X, y = chip_smoke.make_data(2000, 12, seed=6)
    X_s, y_s = chip_smoke.search_rows(X, y)
    assert X_s.shape == (1800, 12) and y_s.shape == (1800,)
    assert abs(y_s.mean() - y.mean()) < 2e-3
    rows = {r.tobytes() for r in X}
    assert all(r.tobytes() in rows for r in X_s)


def test_profiled_fits_serve():
    """The GBT and forest the profile windows fit score single records as
    in a batch (the smoke serves both on the card)."""
    X, y = chip_smoke.make_data(1200, 12, seed=7)
    gbt, rf = chip_smoke.profiled_estimators("cpu", num_rounds=2,
                                             num_trees=2)
    assert (gbt.max_depth, rf.max_depth) == (6, 6)
    for est, tag in ((gbt, "rehearse-gbt"), (rf, "rehearse-rf")):
        assert chip_smoke.phase_serve(est.fit_arrays(X, y), X,
                                      tag=tag) <= 1e-6


def test_write_out(tmp_path):
    """--out writes every measurement as JSON (into a new directory, values
    JSON cannot hold as strings); no path writes nothing."""
    import json
    path = tmp_path / "new" / "k1.json"
    chip_smoke.write_out(str(path), {"k1": {"ms_by_c": {1: 0.5}},
                                     "dtype": np.dtype("uint8")})
    assert json.loads(path.read_text()) == {"k1": {"ms_by_c": {"1": 0.5}},
                                            "dtype": "uint8"}
    chip_smoke.write_out(None, {"k1": {}})
    assert sorted(p.name for p in tmp_path.rglob("*")) == ["k1.json", "new"]


def test_refuses_without_a_card(tmp_path):
    """No card: exit non-zero and print no result. Alone in a directory
    (no package beside it) it cannot even import."""
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=str(REPO), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


@pytest.fixture(scope="module")
def workflow_out():
    return chip_smoke.phase_workflow(
        "cpu", 1200, tag="rehearse-wf",
        models=chip_smoke.small_models("cpu", num_rounds=2, num_trees=2))


def test_workflow_phase(workflow_out):
    """The Titanic workflow phase on the CPU at a tiny size (the four
    families with small trees): the prepared matrix is a CPU tensor the
    selector received as it is, every host stage is reported with its
    reason, the families are timed in pool order, and the listener and
    the validator's family profile report the run."""
    out = workflow_out
    assert out["matrix_device"] == "cpu"
    assert out["matrix_dtype"] == "torch.float64"
    assert out["train_rows"] == 900 and out["matrix_shape"][1] > 500
    seen = out["fit_columns"]
    assert seen["is_tensor"] and seen["device"] == "cpu"
    assert "dtoh_bytes" not in seen          # profiled on a card only
    assert list(out["families"]) == list(chip_smoke.FAMILIES)
    assert out["k1_launches"] == 0           # the CPU takes the plain path
    hosts = {label.split("(")[0] for label, _ in out["host_stages"]}
    assert hosts == {"LambdaTransformer", "AliasTransformer",
                     "SmartTextVectorizerModel", "SelectedModel"}
    mm = np.asarray(out["metric_matrix"])
    assert mm.shape == (3, 20) and np.all(np.isfinite(mm))
    for key in ("raw_extraction_s", "vectorizer_fits_s",
                "device_transforms_s", "host_stage_transforms_s",
                "search_s"):
        assert out[key] > 0
    assert out["models_x_folds"] == 60
    assert sorted(r["family"] for r in out["family_profile"]) == \
        sorted(chip_smoke.FAMILIES)
    assert len(out["stage_profile"]) == 3
    assert len(out["holdout_records"]) == 300


def test_serve_saved_phase(workflow_out):
    """[serve-saved] on the CPU: save, reload, serve the sample and the
    holdout records one at a time, equal to ``model.score`` and to the
    CPU reload; the model stage predicted on the workflow's device."""
    out = chip_smoke.phase_serve_saved(workflow_out["run"],
                                       workflow_out["holdout_records"])
    assert out["records"] == 301
    assert out["raw_arrays_devices"] == {"cpu": 301}
    assert out["max_abs_diff_vs_score"] <= 1e-12
    assert out["max_abs_prob_diff_cpu"] == 0.0
    assert out["op_model_json_bytes"] > 0 and out["arrays_npz_bytes"] > 0
    assert out["ms_p50"] > 0 and out["ms_p99"] >= out["ms_p50"]
    assert out["k1_launches"] == 0


def test_serve_compiled_phase(workflow_out):
    """[serve-compiled] on the CPU: the compiled plan over a reload equals
    the columnar path, the in-process server answers every request as the
    offline guarded plan does, with nothing captured in steady state, no
    fallback and no quarantine; the tree stages compile and agree."""
    out = chip_smoke.phase_serve_compiled(
        workflow_out["run"], workflow_out["holdout_records"],
        server_records=64, threads=8, tree_rows=600,
        tree_models=(chip_smoke.GBTClassifier(max_depth=3, num_rounds=2,
                                              device="cpu"),
                     chip_smoke.RandomForestClassifier(
                         num_trees=3, max_depth=3, device="cpu")))
    assert out["records"] == 300
    assert out["max_abs_diff_vs_columnar"] <= 1e-12
    assert out["bitwise_repeat"] and out["repeat_compiles"] == 0
    assert out["graph_vs_eager_ulps"] == 0 and out["max_abs_diff_cpu"] == 0
    assert sorted(out["capture_s"]) == [8, 16, 32, 64, 128, 256]
    assert out["capture_s_batch"] == {}       # nothing is captured on a CPU
    lowered = out["coverage"]["lowered"]
    assert lowered[-1].startswith("SelectedModel(") and len(lowered) == 14
    server = out["server"]
    assert server["requests"] == 64 and server["mismatched_answers"] == 0
    assert server["steady_compiles"] == 0
    assert not any(server["counters"].values())
    assert server["batches"] == server["full_dispatches"] \
        + server["deadline_dispatches"]
    assert server["ms_p99"] >= server["ms_p50"] > 0
    # the default config's drift sentinel watched the requests; the same
    # drive ran without it
    assert server["drift"]["rowsSeen"] == 64 + 64     # warm-up and drive
    assert out["drift_holdout"]["rowsSeen"] == 300
    assert out["drift_shifted"]["status"] in ("warn", "degrade")
    assert out["server_no_sentinel"]["requests"] == 64
    assert out["server_no_sentinel"]["ms_p50"] > 0
    ab = out["sentinel_ab"]
    assert ab["without"][0] is out["server_no_sentinel"]
    assert [len(ab["with"]), len(ab["without"])] == [2, 2]
    assert all(d["requests"] == 64 and d["requests_per_s"] > 0
               for d in ab["with"] + ab["without"])
    assert [t["stage"] for t in out["trees"]] == [
        "GBTClassifier", "RandomForestClassifier"]
    assert all(t["max_abs_diff_vs_columnar"] <= 1e-12
               and t["prediction_flips"] == 0 for t in out["trees"])
    assert out["k1_launches"] == 0


def _main_source() -> str:
    """The source of the run's entry point and of the whole smoke's body
    after phase 3."""
    import inspect
    return (inspect.getsource(chip_smoke.main)
            + inspect.getsource(chip_smoke._whole_smoke))


def test_serve_compiled_is_wired_in(monkeypatch, capsys):
    """Both runs serve phase 8's model through phases 8b and 8c: the whole
    smoke and ``--workflow-only``, whose run is replayed here with every
    phase stubbed and the card faked."""
    import inspect
    import json
    assert _main_source().count("phase_serving(") == 2
    calls = []
    monkeypatch.setattr(chip_smoke.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "resolve_device",
                        lambda d: torch.device("cpu"))
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: {
        "kind": "fake", "count": 1, "smi": "fake, 1 W"})
    monkeypatch.setattr(chip_smoke, "phase_build", lambda: None)
    monkeypatch.setattr(chip_smoke, "phase_workflow",
                        lambda dev, rows, **kw: {
                            "run": "run", "holdout_records": list(range(1500)),
                            "rows": rows})
    monkeypatch.setattr(chip_smoke, "phase_serve_saved",
                        lambda run, hold: calls.append(("8b", len(hold)))
                        or {"k1_launches": 0})
    monkeypatch.setattr(chip_smoke, "phase_serve_compiled",
                        lambda run, hold: calls.append(("8c", len(hold)))
                        or {"k1_launches": 0})
    monkeypatch.setattr(chip_smoke, "phase_workflow_agree",
                        lambda dev: calls.append(("9", 0)) or {})
    monkeypatch.setattr(
        chip_smoke, "phase_validation",
        lambda dev, rows, cv_rows, exact=None: calls.append(
            ("validation", rows, cv_rows, exact["source"][:7]))
        or {"validate": {}, "workflow_cv": {}, "validate_agree": {}})
    monkeypatch.setattr(chip_smoke, "exact_of",
                        lambda wf: {"source": "phase 8 " + str(wf["rows"])})
    assert chip_smoke.main(["--workflow-only"]) == 0
    assert calls == [("8b", 1000), ("8c", 1500), ("9", 0),
                     ("validation", 100_000, 25_000, "phase 8")]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["serve_compiled"] == {"k1_launches": 0}
    assert _main_source().count("phase_validation(") == 3


def _tiny_pool():
    return chip_smoke.small_models("cpu", num_rounds=2, num_trees=2)


def test_validate_phase():
    """[validate] on the CPU at a tiny size (the four families with small
    trees): the validated DAG races behind the raw feature filter, its
    exact search runs alongside, the checker's gather runs on the device
    in both plans, compiled scores equal columnar bit for bit, served
    records equal the batch, no batch falls back to the host."""
    out = chip_smoke.phase_validate("cpu", 900, models=_tiny_pool())
    assert out["racing"]["raced"] and out["racing"]["candidatesPruned"] > 0
    assert [r["rung"] for r in out["rung_profile"]] == [0, 1, 2]
    assert out["rung_profile"][0]["rows"] < out["rung_profile"][1]["rows"]
    assert out["exact"]["source"].startswith("an exact search")
    assert out["compiled_equals_columnar"] and out["host_fallback_batches"] == 0
    assert out["max_abs_diff_served"] <= 1e-12
    assert out["checker_lowered"] and out["plan_checker_lowered"]
    fit, = out["checker_fits"]
    assert fit["cols"] > 500 and 0 < fit["kept"] < fit["cols"]
    assert out["width_before_checker"] == fit["cols"]
    assert out["rff_exclusions"] == [] and out["rff_seconds"] > 0
    assert out["k1_launches"] == 0 and "rung_k1_case" not in out
    assert sum(r["calls"] for r in out["families"].values()) >= 8


def test_workflow_cv_phase():
    """[workflow-cv] on the CPU: the checker refit on each fold's rows,
    each fold searched at its own width."""
    out = chip_smoke.phase_workflow_cv("cpu", 900, models=_tiny_pool())
    cv = out["workflow_cv"]
    assert len(cv["fold_widths"]) == 3 and out["models_x_folds"] == 60
    assert len(out["checker_fits"]) == 4      # three folds, then the final
    assert [f["cols"] for f in out["checker_fits"]] == [
        out["width_before_checker"]] * 4
    assert cv["fold_widths"] == [f["kept"] for f in out["checker_fits"][:3]]


def test_validate_agree_phase():
    """[validate-agree] with the CPU on both sides: equal filters,
    checkers, rung decisions, metrics and winners."""
    got = chip_smoke.phase_validate_agree("cpu", 600, num_rounds=2,
                                          num_trees=2)
    assert got["rff_equal"] and got["checker"]["kept_equal"]
    assert got["checker"]["stats_max_rel_gap"] == 0.0
    assert got["prunes"] == {"prune_flips": [], "same_prunes": True}
    for key in ("racing", "workflow_cv"):
        assert got[key]["metric_max_abs_diff"] == 0.0
        assert got[key]["same_winner"]


def test_workflow_agree_phase():
    """Card-against-CPU workflow phase with the CPU on both sides: the
    matrices and metric matrices agree exactly."""
    got = chip_smoke.phase_workflow_agree("cpu", 900, num_rounds=2,
                                          num_trees=2)
    assert got["others_bitwise"] and got["float_max_rel_diff"] == 0.0
    assert got["metric_max_abs_diff"] == 0.0 and got["same_winner"]
    assert 0 < got["float_columns"] < 10
    # the GBT points at min_child_weight 1 searched again in float64 on
    # the plain histogram: the CPU on both sides, no gap
    witness = got["tree_precision_witness"]
    assert [p["min_child_weight"] for p in witness["points"]] == [1.0, 1.0]
    assert witness["device_float64"] == witness["device_float32"] == \
        [0.0, 0.0]


#: a Chrome trace as torch.profiler (kineto) exports one: a copy each way,
#: a pinned read-back, a kernel whose name holds escaped quotes, a set,
#: and host-side events
TRACE = b"""{"traceEvents": [
  {
    "ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "pid": 0, "tid": 7,
    "ts": 1371424165706.295, "dur": 540.824,
    "args": {
      "device": 0, "context": 1,
      "stream": 7, "correlation": 7,
      "bytes": 4000000, "memory bandwidth (GB/s)": 7.39
    }
  },
  {
    "ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "pid": 119, "tid": 25,
    "ts": 1371424165640.758, "dur": 2935.686,
    "args": {
      "cbid": 41, "correlation": 7
    }
  },
  {
    "ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "pid": 0, "tid": 7,
    "ts": 1371424170727.850, "dur": 21.311,
    "args": {
      "device": 0, "context": 1,
      "stream": 7, "correlation": 29,
      "bytes": 1000000, "memory bandwidth (GB/s)": 46.9
    }
  },
  {
    "ph": "X", "cat": "kernel", "name": "void k<\\"a\\">(float)", "pid": 0, "tid": 7,
    "ts": 1371424170800.000, "dur": 100.500,
    "args": {
      "grid": [1, 1, 1], "correlation": 40
    }
  },
  {
    "ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 7,
    "ts": 1371424170900.000, "dur": 2.000,
    "args": {
      "bytes": 64
    }
  },
  {
    "ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "pid": 0, "tid": 7,
    "ts": 1371424200738.968, "dur": 3.616,
    "args": {
      "device": 0, "context": 1,
      "stream": 7, "correlation": 58,
      "bytes": 4, "memory bandwidth (GB/s)": 0.0011
    }
  }
]}"""


def test_memcpy_window_reads_copy_bytes():
    """The trace reader sums a window's copies by direction from the
    memcpy events' bytes, and the time of every device event."""
    out = chip_smoke.memcpy_window(TRACE)
    busy = out.pop("device_busy_ms")
    assert out == {"dtoh_bytes": 4000004, "htod_bytes": 1000000,
                   "dtoh_copies": 2, "htod_copies": 1}
    assert abs(busy - (540.824 + 21.311 + 100.5 + 2.0 + 3.616) / 1e3) < 1e-12


_PROBLEM_MODELS = chip_smoke._problem_models


def _small_problem_models(example, device, num_trees=1):
    """The example's pool with every grid cut to two points, forests at
    one tree and boosters at two rounds (a CPU rehearsal's size)."""
    out = []
    for est, grid in _PROBLEM_MODELS(example, device, num_trees):
        name = type(est).__name__
        if name == "XGBoostClassifier":
            est = est.with_params(num_round=2)
        if name == "GBTRegressor":
            est = est.with_params(num_rounds=2)
        out.append((est, grid[:2]))
    return out


@pytest.mark.parametrize("name", ["iris", "boston"])
def test_problem_phase(name):
    """[iris] / [boston] on the CPU at a tiny size: the example's run with
    every family timed, the metric matrix finite, then save, reload,
    records served one at a time within 1e-6 of the batch and the
    compiled plan within 1e-6 of columnar, no fallback, no K1 launch."""
    from transmogrifai_tpu_torch.examples import boston, iris
    example = iris if name == "iris" else boston
    records = (iris.synthetic_iris(300) if name == "iris"
               else boston.synthetic_boston(300))
    out = chip_smoke.phase_problem(
        "cpu", example, records, name,
        models=_small_problem_models(example, "cpu"))
    fams = (list(iris.IRIS_FAMILIES) if name == "iris" else
            ["LinearRegression", "RandomForestRegressor", "GBTRegressor",
             "GeneralizedLinearRegression"])
    # the multinomial LR has no device search: it is timed as host path
    timed = [f for f in fams if f != "LogisticRegression"]
    assert list(out["families"]) == timed
    assert out["metric"] == ("F1" if name == "iris"
                             else "RootMeanSquaredError")
    mm = np.asarray(out["metric_matrix"])
    assert mm.shape == (3, 2 * len(fams) - (name == "iris"))
    assert np.all(np.isfinite(mm)) and out["k1_launches"] == 0
    serve = out["serve"]
    assert serve["max_abs_diff_served"] <= 1e-6
    assert serve["max_abs_diff_compiled"] <= 1e-6
    assert serve["host_fallback_batches"] == 0 == serve["k1_launches"]
    assert serve["served"] == min(1001, serve["holdout"])


def test_variance_check():
    """The card-against-CPU tree comparison, the CPU on both sides:
    nothing differs."""
    X, y = chip_smoke.boston_matrix(400)
    out = chip_smoke._variance_check("cpu", X, y)
    assert out["nodes"] == 2 ** chip_smoke.VARIANCE_DEPTH - 1
    assert out["nodes_differing"] == 0 and out["rmse"] == out["cpu_rmse"]


def test_problems_agree_phase(monkeypatch):
    """[problems-agree] with the CPU on both sides, at a tiny size: the
    examples' and the K = 7 search's metric matrices agree exactly."""
    monkeypatch.setattr(chip_smoke, "WIDE_ROWS", 240)
    monkeypatch.setattr(chip_smoke, "_problem_models",
                        lambda example, device: _small_problem_models(
                            example, device))
    out = chip_smoke.phase_problems_agree("cpu", rows=240)
    for tag in ("iris", "boston", f"k{chip_smoke.WIDE_K}"):
        assert out[tag]["max_diff"] == 0.0 and out[tag]["same_winner"]
    assert out["boston"]["relative"] and not out["iris"]["relative"]
    wide = f"k{chip_smoke.WIDE_K}"
    assert list(chip_smoke.phase_problems_agree(
        "cpu", rows=240, parts=(wide,))) == [wide]


def test_problem_k1_inputs():
    """[k1-problems]' inputs: the Iris matrix (four reals and their null
    indicators), the Boston matrix (twelve reals, chas, indicators), the
    K = 7 matrix; the statistics of each path (integer one-hot weights, the
    centred [w, wy, wyy], [g, h]); a K = 7 block splits 4 + 3 and its
    plain histogram equals the blocks' concatenated."""
    from transmogrifai_tpu_torch.models.trees import _PackedDesign
    X, y = chip_smoke.iris_matrix(300)
    assert X.shape == (300, 8) and not X[:, 1::2].any()
    assert set(np.unique(y)) == {0.0, 1.0, 2.0}
    Xb, yb = chip_smoke.boston_matrix(300)
    assert Xb.shape == (300, 26) and 5.0 <= yb.min() and yb.max() <= 50.0
    Xw, yw = chip_smoke.wide_multiclass(600, 20, 7)
    assert Xw.shape == (600, 20) and len(np.unique(yw)) == 7
    assert (Xw >= 0).all()
    cpu = torch.device("cpu")
    for Xs, ys, kind, S in ((X, y, "cls", 3), (Xw, yw, "cls", 7),
                            (Xb, yb, "reg", 3), (Xb, yb, "gbt", 2)):
        design = _PackedDesign(Xs, 32, cpu)
        st = chip_smoke._problem_k1_stats(design, kind, ys)
        assert st.shape == (design.n, S) and not st[::3].any()
        if kind == "cls":
            assert torch.equal(st, st.round())
        plan = design.hist_plan(S)
        blocks = plan.stat_blocks()
        assert [b - a for a, b, _ in blocks] == ([4, 3] if S == 7 else [S])
        slot = torch.randint(0, 32, (design.n,), dtype=torch.int32)
        whole = chip_smoke.level_hist_plain(design.ids, design.offsets,
                                            slot, st, 32, design.total_bins)
        parts = torch.cat([chip_smoke.level_hist_plain(
            design.ids, design.offsets, slot, st[:, a:b].contiguous(), 32,
            design.total_bins) for a, b, _ in blocks], dim=2)
        assert torch.equal(whole, parts)


def test_problems_are_wired_in(monkeypatch, capsys):
    """``--problems-only`` runs phases 1, 2 and the four problem phases
    and prints their JSON last; the whole smoke runs them too and lists
    the Iris and Boston launches on K1's line."""
    import inspect
    import json
    src = _main_source()
    assert src.count("phase_problems(device") == 2
    assert "launches_{tag}" in src
    calls = []
    monkeypatch.setattr(chip_smoke.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "resolve_device",
                        lambda d: torch.device("cpu"))
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: {
        "kind": "fake", "count": 1, "smi": "fake, 1 W"})
    monkeypatch.setattr(chip_smoke, "phase_build", lambda: None)
    for name in ("phase_k1_problems", "phase_iris", "phase_boston",
                 "phase_problems_agree"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda dev, name=name: calls.append(name)
                            or {"phase": name})
    assert chip_smoke.main(["--problems-only"]) == 0
    assert calls == ["phase_k1_problems", "phase_iris", "phase_boston",
                     "phase_problems_agree"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["problems"]["iris"] == {"phase": "phase_iris"}
    assert set(last["problems"]) == {"k1", "iris", "boston", "agree"}


@pytest.fixture(scope="module")
def families_out():
    """[families] on the CPU at a tiny size (600 records, the
    card-against-CPU pool at one tree and two rounds), without K1's
    card-only cases."""
    return chip_smoke.phase_families(
        "cpu", 600, models=chip_smoke.small_models("cpu", num_rounds=2,
                                                   num_trees=1), k1=False)


def test_families_phase(families_out):
    """Every family timed, every stage's fits and transforms reported
    where the prepare plan ran them (the six device kernels on the
    device), the auto-bucketizer's fit seconds, K1 launches (none on the
    CPU) and split points, then save, reload,
    the compiled plan bitwise the columnar path, records served within
    1e-6, no fallback, no K1 launch."""
    out = families_out
    assert list(out["families"]) == list(chip_smoke.FAMILIES)
    mm = np.asarray(out["metric_matrix"])
    assert mm.shape == (3, 20) and np.all(np.isfinite(mm))
    assert out["matrix_shape"][0] == 450 and out["matrix_shape"][1] > 1000
    seconds = out["stage_seconds"]
    for name in chip_smoke.FAMILY_DEVICE_STAGES:
        assert "device" in seconds[name], name
    for name in ("TextTokenizer", "TextListHashVectorizer",
                 "DateListVectorizer", "NumericBucketizer",
                 "DecisionTreeNumericBucketizerModel"):
        assert "host" in seconds[name], name
    assert "fit" in seconds["DecisionTreeNumericBucketizer"]
    assert "fit" in seconds["ModelSelector"]
    bucket = out["bucketizer"]
    assert bucket["seconds"] == seconds["DecisionTreeNumericBucketizer"][
        "fit"] > 0.0
    assert bucket["k1_launches"] == 0 and bucket["k1_launches_by_c"] == {}
    splits = bucket["split_points"]
    assert splits[0] == -np.inf and splits[-1] == np.inf and len(splits) > 2
    assert out["k1_launches"] == 0 and "k1" not in out
    serve = out["serve"]
    assert serve["max_abs_diff_compiled"] == 0.0
    assert serve["max_abs_diff_served"] <= 1e-6
    assert serve["host_fallback_batches"] == 0 == serve["k1_launches"]
    assert serve["served"] == 150 == serve["holdout"]
    assert serve["fingerprints"] and serve["drift"]["rowsSeen"] == 150
    lowered = {label.split("(")[0]
               for label in serve["plan_coverage"]["lowered"]}
    assert set(chip_smoke.FAMILY_DEVICE_STAGES) <= lowered


def test_families_agree_phase():
    """[families-agree] with the CPU on both sides: the matrices, the
    bucketizer's split points and the metric matrices agree exactly; the
    linear families' float64 witness on the device (the CPU) agrees
    exactly too, and the CPU's float32 run is reported for each of their
    12 grid points."""
    out = chip_smoke.phase_families_agree("cpu", 600, num_rounds=2,
                                          num_trees=1)
    witness = out["linear_precision_witness"]
    assert witness["device_float64"] == [0.0] * 12
    assert len(witness["cpu_float32"]) == 12
    assert out["others_bitwise"] and out["float_max_rel_diff"] == 0.0
    assert out["split_points_differing"] == 0
    assert out["rows_in_another_bucket"] == 0
    assert out["bucket_columns"][0] == out["bucket_columns"][1] > 2
    assert out["metric_max_abs_diff"] == 0.0 and out["same_winner"]


def test_family_k1_inputs():
    """[families]' K1 shapes: the bucketizer's one-feature design with
    its one-hot labels (S = 2, one bin per present value's bucket, each
    row counted once a slot), the family matrix's forest statistics
    (integer) and the GBT's [g, h]."""
    from transmogrifai_tpu_torch.examples import families
    records = families.synthetic_families(400)
    train, _ = chip_smoke.titanic.stratified_split(records,
                                                   label_key="label")
    y = np.array([r["label"] for r in train])
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.normal(size=(300, 3)),
                        (rng.uniform(size=(300, 5)) < 0.2)], axis=1)
    seen = []
    for label, design, st, slots, exact in chip_smoke.family_k1_inputs(
            "cpu", records, X, y):
        seen.append((label, design.d, st.shape[1], slots, exact))
        C = slots[-1]
        slot = torch.randint(0, C, (design.n,), dtype=torch.int32)
        hist = chip_smoke.level_hist_plain(design.ids, design.offsets, slot,
                                           st, C, design.total_bins)
        if exact:
            assert torch.equal(st, st.round())
        if label.startswith("bucketizer"):
            n_present = sum(r["real"] is not None for r in train)
            assert design.n == n_present and design.total_bins <= 32
            assert float(hist.sum()) == n_present
    assert seen == [
        ("bucketizer d=1", 1, 2, chip_smoke.BUCKET_SLOTS, True),
        ("family matrix forest", 8, 2, (1, 32, 256), True),
        ("family matrix GBT [g,h]", 8, 2, (256,), False)]


def test_families_are_wired_in(monkeypatch, capsys):
    """``--families-only`` runs phases 1, 2 and the family phases and
    prints their JSON last; the whole smoke runs them too, adds their K1
    cases to K1's line and lists the family path's launches there."""
    import inspect
    import json
    src = _main_source()
    assert src.count("phase_families_all(device, args.families_rows") == 2
    assert 'fam_run["k1"]["cases"]' in src
    assert "launches_families_by_family" in src
    calls = []
    monkeypatch.setattr(chip_smoke.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "resolve_device",
                        lambda d: torch.device("cpu"))
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: {
        "kind": "fake", "count": 1, "smi": "fake, 1 W"})
    monkeypatch.setattr(chip_smoke, "phase_build", lambda: None)
    monkeypatch.setattr(chip_smoke, "phase_families",
                        lambda dev, rows: calls.append(("families", rows))
                        or {"phase": "families"})
    monkeypatch.setattr(chip_smoke, "phase_families_agree",
                        lambda dev: calls.append(("agree",))
                        or {"phase": "agree"})
    assert chip_smoke.main(["--families-only", "--families-rows",
                            "1234"]) == 0
    assert calls == [("families", 1234), ("agree",)]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["families"] == {"families": {"phase": "families"},
                                "agree": {"phase": "agree"}}


def test_family_tolerances():
    """[families-agree]'s limits: FAMILY_LINEAR_TOL only at the
    LogisticRegression points of reg_param below FAMILY_LINEAR_REG and
    the LinearSVC points, GBT_SMALL_LEAF_TOL at the GBT points of
    min_child_weight < 10, AGREE_TOL everywhere else."""
    from types import SimpleNamespace as R
    tol = chip_smoke._family_tol
    assert tol(R(model_name="LogisticRegression",
                 params={"reg_param": 0.001})) == chip_smoke.FAMILY_LINEAR_TOL
    for reg in (0.01, 0.1, 0.2):
        assert tol(R(model_name="LogisticRegression",
                     params={"reg_param": reg})) == chip_smoke.AGREE_TOL
    assert tol(R(model_name="LinearSVC", params={"reg_param": 0.2})) == \
        chip_smoke.FAMILY_LINEAR_TOL
    assert tol(R(model_name="GBTClassifier",
                 params={"min_child_weight": 1.0})) == \
        chip_smoke.GBT_SMALL_LEAF_TOL
    for name, params in (("GBTClassifier", {"min_child_weight": 10.0}),
                         ("RandomForestClassifier", {"max_depth": 3})):
        assert tol(R(model_name=name, params=params)) == chip_smoke.AGREE_TOL


@pytest.mark.parametrize("name,reg,expect", [
    ("LogisticRegression", 0.001, "TEXT_LINEAR_TOL"),
    ("LogisticRegression", 0.01, "AGREE_TOL"),
    ("LogisticRegression", 0.2, "AGREE_TOL"),
    ("LinearSVC", 0.001, "AGREE_TOL"),
    ("LinearSVC", 0.2, "AGREE_TOL")])
def test_text_linear_tolerances(name, reg, expect):
    """[text-agree]'s linear limits: TEXT_LINEAR_TOL only at the
    LogisticRegression points of reg_param below FAMILY_LINEAR_REG,
    AGREE_TOL at every other LR point and every LinearSVC point."""
    from types import SimpleNamespace as R
    got = chip_smoke._text_linear_tol(R(model_name=name,
                                        params={"reg_param": reg}))
    assert got == getattr(chip_smoke, expect)


def test_linear_dtype():
    """Inside ``linear_dtype`` the linear families compute in the dtype
    asked for on the CPU too (float32 here), and the port's policy is
    back after the block."""
    X, y = chip_smoke.make_data(600, 8, seed=3)
    models = chip_smoke.small_models("cpu",
                                     families=chip_smoke.LINEAR_FAMILIES)
    real = chip_smoke.linear.working_dtype
    with chip_smoke.linear_dtype(torch.float32):
        model = models[0][0].fit_arrays(
            torch.as_tensor(X, dtype=torch.float32), y)
        assert chip_smoke.linear.working_dtype(torch.device("cpu")) == \
            torch.float32
    assert model.coefficients.dtype == torch.float32
    assert chip_smoke.linear.working_dtype is real
    assert real(torch.device("cpu")) == torch.float64


def test_device_events():
    """``device_events`` reads a profiler window's raw results: the name
    and microseconds of every CUDA event, no host event."""
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType

    def event(name, ns, dev):
        return NS(name=lambda: name, duration_ns=lambda: ns,
                  device_type=lambda: dev)
    events = [event("aten::add_", 5000, DeviceType.CPU),
              event("kernel_a", 1500, DeviceType.CUDA),
              event("Memcpy HtoD", 250, DeviceType.CUDA)]
    prof = NS(profiler=NS(kineto_results=NS(events=lambda: events)))
    assert chip_smoke.device_events(prof) == [("kernel_a", 1.5),
                                              ("Memcpy HtoD", 0.25)]


def test_k1_by_fit(monkeypatch):
    """``K1ByFit`` files the launches between two stage rows under the
    stage whose fit row follows them, by class; transform rows and fits
    that launch nothing are not filed."""
    from collections import Counter
    from types import SimpleNamespace as NS
    counts = Counter()
    monkeypatch.setattr(chip_smoke.level_hist, "launches_by_c", counts,
                        raising=False)

    class Stage(NS):
        def stage_name(self):
            return "Stage_000000000001"
    listener = chip_smoke.K1ByFit()
    counts.update({1: 1, 2: 1})
    bucketizer = type("DecisionTreeNumericBucketizer", (Stage,), {})(uid="b")
    listener.on_stage_completed(bucketizer, "fit", 0.1, 10)
    listener.on_stage_completed(Stage(uid="t"), "transform", 0.1, 10)
    listener.on_stage_completed(Stage(uid="f"), "fit", 0.1, 10)
    counts.update({1: 3, 256: 4})
    selector = type("ModelSelector", (Stage,), {})(uid="s")
    listener.on_stage_completed(selector, "fit", 0.1, 10)
    assert listener.k1_by_fit == {
        "DecisionTreeNumericBucketizer": {1: 1, 2: 1},
        "ModelSelector": {1: 3, 256: 4}}
    assert len(listener.metrics.stage_metrics) == 4


@pytest.fixture(scope="module")
def text_out():
    """[text] on the CPU at a tiny size (800 records, the card-against-CPU
    pool at one tree and two rounds), without K1's card-only cases, its
    default server answering 200 requests."""
    return chip_smoke.phase_text(
        "cpu", 800, models=chip_smoke.small_models("cpu", num_rounds=2,
                                                   num_trees=1),
        k1=False, server_records=200)


def test_text_phase(text_out):
    """Every family timed; Word2Vec and LDA fitted on the workflow's
    device (the CPU here) with their seconds; the holdout's log loss and
    Brier score; save with the drift fingerprints, reload, the compiled
    plan bitwise the columnar path, records served within 1e-6, a default
    ``ServeConfig()`` server within 1e-6 of the guarded plan with its
    sentinel watching every request; no fallback, no K1 launch."""
    out = text_out
    assert list(out["families"]) == list(chip_smoke.FAMILIES)
    assert out["matrix_shape"][0] == 600 and out["matrix_shape"][1] > 1500
    assert out["word2vec_fit_s"] > 0 and out["lda_fit_s"] > 0
    assert out["lda_device"] == "cpu"
    assert 0 < out["holdout_LogLoss"] and 0 < out["holdout_BrierScore"] < 1
    seconds = out["stage_seconds"]
    for name in ("Word2Vec", "LDA", "TfIdfVectorizer", "StringIndexer"):
        assert "fit" in seconds[name], name
    for name in ("LDAModel", "Word2VecModel", "TfIdfVectorizerModel",
                 "NameEntityRecognizer", "LangDetector", "NGramSimilarity",
                 "PhoneNumberParser"):
        assert "host" in seconds[name], name
    assert out["k1_launches"] == 0 and "k1" not in out
    serve = out["serve"]
    assert serve["fingerprints"] and serve["drift"]["rowsSeen"] == 200
    assert serve["max_abs_diff_compiled"] == 0.0
    assert serve["max_abs_diff_served"] <= 1e-6
    assert serve["host_fallback_batches"] == 0 == serve["k1_launches"]
    server = serve["server"]
    assert server["requests"] == 200 and server["max_abs_diff"] <= 1e-6
    assert server["drift"]["rowsSeen"] == 200


def test_text_agree_phase():
    """[text-agree] with the CPU on both sides: every host stage bitwise,
    Word2Vec and LDA exactly equal; its linear check on a second text
    design: the workflow's metric matrix equal to the float64 search on
    its train matrix, within every grid point's tolerance, the float64
    witness on the device (the CPU) exact, the CPU's float32 run reported
    for the 12 linear grid points."""
    out = chip_smoke.phase_text_agree("cpu", 400, linear_rows=500)
    assert out["host_stages_bitwise"]
    assert out["w2v_vocabulary_equal"] and out["lda_vocabulary_equal"]
    for key in ("w2v_vectors_max_abs_diff", "w2v_means_max_abs_diff",
                "lda_topic_word_max_abs_diff", "lda_mixtures_max_abs_diff"):
        assert out[key] == 0.0, key
    linear = out["linear"]
    assert linear["records"] == 500 and 360 <= linear["shape"][0] <= 390
    assert linear["card_float32"] == [0.0] * 12 and linear["within"]
    assert linear["tol"] == [chip_smoke.TEXT_LINEAR_TOL] * 2 + [
        chip_smoke.AGREE_TOL] * 10
    witness = linear["linear_precision_witness"]
    assert witness["device_float64"] == [0.0] * 12
    assert len(witness["cpu_float32"]) == 12


def test_text_k1_inputs():
    """[k1-text]'s shapes: the text matrix's forest statistics (integer,
    exact) and the GBT's [g, h]."""
    rng = np.random.default_rng(1)
    X = np.concatenate([rng.normal(size=(300, 3)),
                        (rng.uniform(size=(300, 5)) < 0.2)], axis=1)
    y = (rng.uniform(size=300) < 0.4).astype(np.float64)
    seen = []
    for label, design, st, slots, exact in chip_smoke.matrix_k1_inputs(
            "cpu", X, y, "text matrix"):
        seen.append((label, design.d, st.shape[1], slots, exact))
        if exact:
            assert torch.equal(st, st.round())
    assert seen == [("text matrix forest", 8, 2, (1, 32, 256), True),
                    ("text matrix GBT [g,h]", 8, 2, (256,), False)]


def test_workflow_agree_witness():
    """``phase_workflow_agree(witness=True)``, the CPU on both sides:
    the linear families' float64 witness on the device agrees exactly and
    the metric gap is reported."""
    got = chip_smoke.phase_workflow_agree("cpu", 900, num_rounds=2,
                                          num_trees=2, witness=True)
    assert got["records"] == 900
    assert got["linear_precision_witness"]["device_float64"] == [0.0] * 12
    assert got["metric_max_abs_diff"] == 0.0


def _fake_card(monkeypatch):
    monkeypatch.setattr(chip_smoke.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "resolve_device",
                        lambda d: torch.device("cpu"))
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: {
        "kind": "fake", "count": 1, "smi": "fake, 1 W"})
    monkeypatch.setattr(chip_smoke, "phase_build", lambda: None)


def test_text_is_wired_in(monkeypatch, capsys):
    """``--text-only`` runs phases 1, 2 and the text phases and prints
    their JSON last; the whole smoke runs them too, adds their K1 cases to
    K1's line and lists the text path's launches there;
    ``--workflow-only --agree-witness-rows N`` runs the witness alone."""
    import inspect
    import json
    src = _main_source()
    assert src.count("phase_text_all(device, args.text_rows") == 2
    assert 'txt["text"]["k1"]["cases"]' in src
    assert "launches_text_by_family" in src
    calls = []
    _fake_card(monkeypatch)
    monkeypatch.setattr(chip_smoke, "phase_text",
                        lambda dev, rows: calls.append(("text", rows))
                        or {"phase": "text"})
    monkeypatch.setattr(chip_smoke, "phase_text_agree",
                        lambda dev: calls.append(("agree",))
                        or {"phase": "agree"})
    monkeypatch.setattr(chip_smoke, "phase_workflow_agree",
                        lambda dev, rows, witness=False: calls.append(
                            ("witness", rows, witness)) or {"rows": rows})
    assert chip_smoke.main(["--text-only", "--text-rows", "1234"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["text"] == {"text": {"phase": "text"},
                            "agree": {"phase": "agree"}}
    assert chip_smoke.main(["--workflow-only",
                            "--agree-witness-rows", "3000"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"workflow_agree": {"rows": 3000}}
    assert calls == [("text", 1234), ("agree",), ("witness", 3000, True)]


def test_agree_worker(monkeypatch):
    """The whole smoke's card-against-CPU phases run in spawned worker
    processes: each result comes back, a failing phase raises in the
    caller, and the workers stop at ``close``; the whole smoke starts them
    only after its last timed phase (phase 10) and collects every one of
    AGREE_PHASES, and the composites skip theirs there."""
    phases = chip_smoke.AGREE_PHASES
    monkeypatch.setattr(chip_smoke, "AGREE_PHASES",
                        ("resolve_device", "make_data"))
    worker = chip_smoke.AgreeWorker("cpu", workers=2)
    try:
        assert worker.result("resolve_device") == torch.device("cpu")
        with pytest.raises(TypeError):
            worker.result("make_data")
    finally:
        worker.close()
    assert not worker.pool._pool or not any(
        p.is_alive() for p in worker.pool._pool)
    src = _main_source()
    assert src.count("AgreeWorker(") == 1
    start = src.index("AgreeWorker(")
    assert src.index('laps("10 profiles")') < start
    for timed in ("phase_main(", "phase_serving(wf_run)", "phase_text_all(",
                  "phase_families_all(", "phase_profile("):
        assert src.rindex(timed) < start, timed
    for name in phases:
        name = name.replace(f":k{chip_smoke.WIDE_K}", ":k{WIDE_K}")
        assert src.index(f'"{name}")') > start, name
    assert src.count("agree=False") == 5


def test_agree_phase_arguments(monkeypatch):
    """The worker calls phase 6 at its rows and columns, [problems-agree]
    one search at a time, the others on the device alone."""
    seen = []
    monkeypatch.setattr(chip_smoke, "phase_card_vs_cpu",
                        lambda *a: seen.append(a) or "six")
    monkeypatch.setattr(chip_smoke, "phase_text_agree",
                        lambda *a: seen.append(a) or "text")
    monkeypatch.setattr(chip_smoke, "phase_problems_agree",
                        lambda *a, **kw: seen.append((a, kw)) or "part")
    assert chip_smoke._agree_phase("phase_card_vs_cpu", "dev") == "six"
    assert chip_smoke._agree_phase("phase_text_agree", "dev") == "text"
    assert chip_smoke._agree_phase("phase_problems_agree:iris",
                                   "dev") == "part"
    assert seen == [("dev", chip_smoke.CARD_VS_CPU_ROWS, chip_smoke.COLS),
                    ("dev",), (("dev",), {"parts": ("iris",)})]
    parts = [n.partition(":")[2] for n in chip_smoke.AGREE_PHASES
             if n.startswith("phase_problems_agree")]
    assert sorted(parts) == sorted(
        ["iris", "boston", f"k{chip_smoke.WIDE_K}"])


@pytest.fixture(scope="module")
def ingest_out():
    """[quickstart], [readers] and [insights] on the CPU at a tiny size:
    1,200 Quick start records, 250 event-log users, the GBT family alone
    at two rounds, fixed trees on the event log."""
    return chip_smoke.phase_ingest_explain(
        "cpu", quickstart_rows=1200, users=250,
        families=("GBTClassifier",), num_rounds=2)


def test_quickstart_phase(ingest_out):
    """The README's DAG trained through ``csv_auto`` on the CSV's 900
    records, its summaries printed, a served record, the holdout streamed
    in batches equal to its whole score."""
    qs = ingest_out["quickstart"]
    assert qs["train_records"] == 900 and qs["holdout_records"] == 300
    assert qs["winner"] == "GBTClassifier"
    assert list(qs["families"]) == ["GBTClassifier"]
    assert qs["stream_max_abs_diff"] <= chip_smoke.COMPILED_SCORE_TOL
    assert qs["stream_batches"] == 1 and np.isfinite(qs["holdout_aupr"])
    assert all(np.isfinite(v) for v in qs["served"].values())
    assert qs["k1_launches"] == 0 and qs["insight_features"] >= 2
    assert "_insight_input" not in qs


def test_readers_phase(ingest_out):
    """The event log through Avro files and the joined aggregate readers:
    trained, scored a week later through a reader with responses and
    through one that refuses them (the Avro files read again)."""
    rd = ingest_out["readers"]
    assert rd["users"] == 250 and rd["events"] == rd["sends"] + rd["clicks"]
    assert rd["avro_bytes"] > 0 and rd["matrix_device"] == "cpu"
    for part in ("train_reader", "score_reader",
                 "score_without_responses_reader"):
        assert set(rd[part]) == {"avro_read_s", "aggregate_s", "join_s"}
        assert all(v >= 0 for v in rd[part].values())
        assert rd[part]["avro_read_s"] > 0
    assert rd["score_rows"] > 200 and 0 < rd["label_rate"] < 0.5
    assert rd["without_responses_label_nan"]
    assert rd["without_responses_max_abs_diff"] == 0.0
    assert rd["raw_extraction_s"] >= rd["train_reader"]["avro_read_s"]


def test_insights_phase(ingest_out):
    """LOCO and Corr on the CPU against a CPU reload agree exactly; the
    fixed trees' importances equal their reloads'; no K1 launch."""
    ins = ingest_out["insights"]
    for tag in ("quickstart", "readers"):
        rec = ins[tag]
        assert rec["loco_max_abs_diff"] == 0.0
        assert rec["loco_top_k_differ"] == 0
        assert rec["corr_max_abs_diff"] == 0.0 and rec["corr_nan_alike"]
        assert rec["corr_importance_max_abs_diff"] == 0.0
    assert ins["readers"]["loco_groups"] == 10
    assert ins["quickstart"]["loco_groups"] == 2
    for tag in ("gbt-fixed", "rf-fixed"):
        assert ins[tag]["equal"] and abs(ins[tag]["sum"] - 1.0) < 1e-12
    assert ins["k1_launches"] == 0
    secs = ingest_out["seconds"]
    assert secs["total"] == pytest.approx(
        secs["quickstart"] + secs["readers"] + secs["insights"])
    assert ingest_out["within_budget"] == (
        secs["total"] <= chip_smoke.NEW_PHASES_BUDGET_S)


def test_top_k_agree():
    """Top-K groups compared only where no tie straddles K."""
    cpu = np.array([[0.5, 0.4, 0.1], [0.5, 0.3, 0.3], [0.1, 0.2, 0.9]])
    card = np.array([[0.4, 0.5, 0.1], [0.5, 0.3, 0.3], [0.1, 0.2, 0.9]])
    assert chip_smoke._top_k_agree(card, cpu, 1, 1e-5) == (1, 3)
    assert chip_smoke._top_k_agree(card, cpu, 2, 1e-5) == (0, 2)
    assert chip_smoke._top_k_agree(card, cpu, 3, 1e-5) == (0, 3)


def test_tree_dtype():
    """Inside ``tree_dtype`` the tree modules' working dtype is the one
    given and the level histogram is the plain version; both come back
    after, also on an error."""
    from transmogrifai_tpu_torch.models import base, trees
    real = (trees.working_dtype, base.working_dtype, trees.level_hist)
    with pytest.raises(KeyError):
        with chip_smoke.tree_dtype(torch.float16):
            assert trees.working_dtype("cuda") is torch.float16
            assert base.working_dtype("cpu") is torch.float16
            assert trees.level_hist is not real[2]
            raise KeyError
    assert (trees.working_dtype, base.working_dtype,
            trees.level_hist) == real


@pytest.mark.parametrize("kind", ["binary", "regression"])
def test_tree_precision_witness(kind):
    """The witness on the CPU against the same search on the CPU: every
    gap 0, the card's float32 gap reported as given."""
    from transmogrifai_tpu_torch.models.trees import (GBTClassifier,
                                                      GBTRegressor)
    from transmogrifai_tpu_torch.selector import (
        BinaryClassificationModelSelector, RegressionModelSelector)
    X, y = chip_smoke.make_data(400, 6)
    if kind == "binary":
        factory = BinaryClassificationModelSelector.with_cross_validation
        est, grid = GBTClassifier(num_rounds=2, device="cpu"), [
            {"max_depth": 3, "min_child_weight": 1.0}]
    else:
        y = X[:, 0] * 2.0 + X[:, 1]
        factory = RegressionModelSelector.with_cross_validation
        est, grid = GBTRegressor(num_rounds=2, device="cpu"), [
            {"max_depth": 6}, {"max_depth": 12}]
    selector_fn = lambda d, models: factory(  # noqa: E731
        num_folds=3, models=models, device=d)
    cpu = chip_smoke.metric_matrix(selector_fn(
        torch.device("cpu"), models=[(est, grid)]).fit_arrays(X, y))
    got = chip_smoke.tree_precision_witness(
        "cpu", selector_fn, est, grid, X, y, cpu, cpu + 1e-3, "test",
        relative=kind == "regression")
    assert got["device_float64"] == [0.0] * len(grid)
    assert max(got["device_float32"]) > 0.0 and got["within_agree_tol"]
    with pytest.raises(AssertionError, match="float64 too"):
        chip_smoke.tree_precision_witness(
            "cpu", selector_fn, est, grid, X, y, cpu + 1.0, cpu, "test")
    wide = chip_smoke.tree_precision_witness(
        "cpu", selector_fn, est, grid, X, y, cpu + 5e-3, cpu, "test",
        tol=1e-2)
    assert not wide["within_agree_tol"]


def test_ingest_explain_is_wired_in(monkeypatch, capsys):
    """``--readers-only`` runs phases 1, 2 and the three new phases and
    prints their JSON last; the whole smoke runs them after [text] with
    phase 8c's trees and lists their launches on K1's line."""
    import json
    src = _main_source()
    assert src.count("phase_ingest_explain(device") == 2
    assert "trees=fixed_trees" in src
    assert 'for tag in ("quickstart", "readers")' in src
    assert 'entry[f"launches_{tag}_by_family"]' in src
    assert 'entry["launches_insights"]' in src
    calls = []
    _fake_card(monkeypatch)
    monkeypatch.setattr(chip_smoke, "phase_ingest_explain",
                        lambda dev: calls.append(dev) or {"phase": "ingest"})
    assert chip_smoke.main(["--readers-only"]) == 0
    assert len(calls) == 1
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"ingest_explain": {"phase": "ingest"}}

