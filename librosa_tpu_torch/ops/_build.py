"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``librosa_tpu_torch/csrc/`` compiles with ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) for ``sm_90a``. The library goes into
``librosa_tpu_torch/_build/`` under a name that carries a hash of the
source, the headers in ``csrc/`` and the flags, so an edited source is
rebuilt and a stale library is never loaded. ``nvcc`` is found on ``PATH``
or under ``$CUDA_HOME/bin``.

Nothing here runs at import: the CPU tests import every module on machines
with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["build", "build_all", "load", "build_log"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {"stft_mel": "stft_mel.cu", "staged_probe": "staged_probe.cu",
           "db_scale": "db_scale.cu", "ola_norm": "ola_norm.cu",
           "median_filter": "median_filter.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin")


def _lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` (registers, spills)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every kernel of ``names`` that is not built yet, one ``nvcc`` each, all at once.

    Raises ``RuntimeError`` with the compiler's output if a build fails.
    """
    jobs = []
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        jobs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited with {proc.returncode}\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))


def build(name: str) -> None:
    """Compile kernel ``name`` unless its library is built already."""
    build_all([name])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib
