"""CPU rehearsal of chip_smoke.py: the main-path, card-against-CPU and
single-record phases at a tiny size on an explicit CPU device, and the
script's refusal to run without a card."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def tiny():
    X, y = chip_smoke.make_data(1500, 12)
    out = chip_smoke.phase_main("cpu", X, y, grid=chip_smoke.SMALL_GRID,
                                num_rounds=2, tag="rehearse")
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
    got = chip_smoke.phase_card_vs_cpu("cpu", 900, 10, num_rounds=2)
    assert got["max_abs_diff"] == 0.0 and got["same_winner"]


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
