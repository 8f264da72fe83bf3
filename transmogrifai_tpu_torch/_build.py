"""Build the port's CUDA kernels at first use.

A ``csrc/<name>.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries land in
``csrc/build/`` (listed in ``.gitignore``) under a name that carries the
hash of the source, so an edited source is never served a stale build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

__all__ = ["build", "build_seconds", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
#: held around a library's first-use build and load: whichever thread
#: gets there first builds, the others wait for its library
_load_lock = threading.Lock()
#: seconds spent in nvcc by this process
_build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "transmogrifai_tpu_torch build with the CUDA toolkit")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(name: str) -> Optional[Tuple[float, str]]:
    """Compile ``csrc/<name>.cu`` unless its library is built; returns
    (seconds, nvcc output) for a build it ran, else None."""
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    target = _target(src)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)
    seconds = time.perf_counter() - t0
    global _build_seconds
    _build_seconds += seconds
    return seconds, proc.stdout


def build_seconds() -> float:
    """Seconds this process has spent compiling kernels with nvcc."""
    return _build_seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use (by
    one thread; a search's deadline worker and the serving lifecycle's
    retrain may reach it together)."""
    lib = _libs.get(name)
    if lib is None:
        with _load_lock:
            lib = _libs.get(name)
            if lib is None:
                build(name)
                lib = _libs[name] = ctypes.CDLL(
                    str(_target(CSRC / f"{name}.cu")))
    return lib
