"""Build the port's native code at first use and load it with ctypes.

Each CUDA source under ``librosa_tpu_torch/csrc/`` (``SOURCES``) compiles
with ``nvcc`` into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds) for ``sm_90a``; ``nvcc`` is found on
``PATH`` or under ``$CUDA_HOME/bin``. The host sources (``HOST_SOURCES``:
the audio decoder and the one-envelope beat DP) compile with ``g++`` and
build on any machine, with no CUDA toolkit. Every library goes into ``librosa_tpu_torch/_build/`` under a
name that carries a hash of its source and flags (for a CUDA source also
the headers in ``csrc/``), so an edited source is rebuilt and a stale
library is never loaded.

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
           "median_filter": "median_filter.cu", "beat_dp": "beat_dp.cu",
           "viterbi": "viterbi.cu", "peak_scan": "peak_scan.cu",
           "trough_priors": "trough_priors.cu", "phase_update": "phase_update.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# host code: g++, linked against libdl only (the codec libraries are dlopen'd)
HOST_SOURCES = {"audioio": "audioio.cpp", "hostdp": "hostdp.cpp"}
HOST_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
HOST_LIBS = ["-ldl"]

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
    if name in HOST_SOURCES:
        src = (CSRC / HOST_SOURCES[name]).read_bytes()
        flags = HOST_FLAGS + HOST_LIBS
    else:
        src = (CSRC / SOURCES[name]).read_bytes()
        src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        flags = NVCC_FLAGS
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _command(name: str, out: Path) -> list:
    if name in HOST_SOURCES:
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found on PATH")
        return [cxx, *HOST_FLAGS, str(CSRC / HOST_SOURCES[name]), "-o", str(out), *HOST_LIBS]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / SOURCES[name])]


def build_log(name: str) -> str:
    """The compiler's output for the current build of ``name`` (for a kernel: registers, spills)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Iterable[str] = (*SOURCES, *HOST_SOURCES)) -> None:
    """Compile every library of ``names`` that is not built yet, one compiler each, all at once.

    The default is every CUDA kernel and every host library.

    Raises ``RuntimeError`` with the compiler's output if a build fails.
    """
    jobs = []
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        jobs.append((name, lib, tmp, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: the compiler exited with {proc.returncode}\n{out}")
            continue
        lib.with_suffix(".log").write_text(out)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("native build failed: " + "\n".join(failed))


def build(name: str) -> None:
    """Compile ``name`` (a kernel or a host library) unless its library is built already."""
    build_all([name])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib
