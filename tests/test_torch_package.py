"""Rules of the PyTorch port as a package: it runs on CUDA unless the caller
asks for the CPU, and it imports neither JAX nor the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import transmogrifai_tpu_torch
from transmogrifai_tpu_torch.models.linear import (
    LinearSVC, LinearSVCModel, LogisticRegression, LogisticRegressionModel)
from transmogrifai_tpu_torch.models.trees import (
    DecisionTreeClassifier, GBTClassifier, GBTClassifierModel,
    RandomForestClassifier, TreeEnsembleClassifierModel)
from transmogrifai_tpu_torch.selector import (
    BinaryClassificationModelSelector, ModelSelector)
from transmogrifai_tpu_torch.utils.device import resolve_device, working_dtype

PKG = Path(transmogrifai_tpu_torch.__file__).resolve().parent
REPO = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "transmogrifai_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: GBTClassifier(),
    lambda: GBTClassifierModel(np.zeros((1, 1)), np.zeros((1, 1)),
                               np.zeros((1, 2)), depth=1),
    lambda: ModelSelector(),
    lambda: BinaryClassificationModelSelector.with_cross_validation(
        model_types_to_use=["GBTClassifier"]),
    lambda: RandomForestClassifier(),
    lambda: DecisionTreeClassifier(),
    lambda: TreeEnsembleClassifierModel(np.zeros((1, 1)), np.zeros((1, 1)),
                                        np.zeros((1, 2, 2)), depth=1),
    lambda: BinaryClassificationModelSelector.with_cross_validation(
        model_types_to_use=["RandomForestClassifier", "GBTClassifier"]),
    lambda: LogisticRegression(),
    lambda: LinearSVC(),
    lambda: LogisticRegressionModel(np.zeros(2), 0.0),
    lambda: LinearSVCModel(np.zeros(2), 0.0),
    lambda: BinaryClassificationModelSelector.with_cross_validation(),
])
def test_default_device_needs_a_card(entry, monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_explicit_cpu_and_dtype_policy(monkeypatch):
    _no_card(monkeypatch)
    dev = resolve_device("cpu")
    assert dev.type == "cpu" and working_dtype(dev) == torch.float64
    assert working_dtype(torch.device("cuda")) == torch.float32
    assert GBTClassifier(device="cpu").device == dev
    assert torch.backends.cuda.matmul.allow_tf32 is False
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_sources_import_no_jax():
    """Walk every module's AST: no import of jax or the JAX package."""
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_imports_with_jax_package_hidden():
    """Import every module of the port, and chip_smoke, in a fresh
    interpreter where importing jax or transmogrifai_tpu fails."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PKG.rglob("*.py"))
    code = f"""
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in {FORBIDDEN!r}):
            raise ImportError("hidden: " + name)
sys.meta_path.insert(0, Block())
for m in {modules!r} + ["chip_smoke"]:
    importlib.import_module(m.replace(".__init__", ""))
bad = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}]
assert not bad, bad
print("ok", len({modules!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
