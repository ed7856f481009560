"""pYIN's trough priors kernel on the CPU: its routing, its refusals and its arithmetic.

``ops/trough_priors.py`` sends CPU tensors to the plain loop over thresholds
and CUDA tensors to ``csrc/trough_priors.cu``. Here: the CPU route and its
launch count; ``kernel_refusal``'s reasons, on meta tensors at the card's
shapes; a numpy mirror of the kernel's one-pass sum (each trough's first
threshold, counts by threshold, terms in ascending k from it) against the
loop bit for bit, ties at the float thresholds included; and the kernel's
own source, built with g++ over ``tests/cuda_emulation.h`` (a thread a CUDA
thread, barriers for the block and warp synchronisations), against the loop
bit for bit, with one launch counted a launch and none for an input with no
frame, and its refusal of a block's shared memory where ``kernel_refusal``
refuses. Those skip only where g++ is absent.
"""

import ctypes
import re
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from librosa_tpu_torch.core import pitch
from librosa_tpu_torch.ops import trough_priors as tp
from librosa_tpu_torch.util.utils import frame
from portbench import signals

ROOT = Path(__file__).resolve().parents[1]
SR = 22050.0
# pYIN's tables for 65-800 Hz at hop 512, as the onset_beat_pyin cells run it: 314 lags
THRESHOLDS, BETA, _, _ = pitch._pyin_tables(SR, 65.0, 800.0, 512, 100, (2.0, 18.0), 0.1, 35.92,
                                            0.01, 1e-4)
NP_TYPES = {torch.float32: np.float32, torch.float64: np.float64}


def melody_cmnd(dtype, frames: int, rows: int = 1, seed: int = 3):
    """pYIN's difference function and troughs of the benchmark's signal, ``(rows, 314, frames)``."""
    y = signals.melody_clicks(rows, 512 * (frames - 1), seed, torch.device("cpu"), SR).to(dtype)
    y_frames = frame(torch.nn.functional.pad(y, (1024, 1024)), frame_length=2048, hop_length=512)
    yin, _, trough, _ = pitch._yin_of_frames(y_frames, sr=SR, fmin=65.0, fmax=800.0,
                                             frame_length=2048)
    return yin, trough


def tie_case(np_type, rng):
    """Values drawn from the float thresholds themselves, and frames with no trough, one, every
    other lag and every lag a trough, and two equal lowest troughs."""
    v = THRESHOLDS[1:].astype(np_type)[rng.randint(0, 100, size=(2, 60, 12))]
    m = rng.rand(2, 60, 12) < 0.4
    m[:, :, 0] = False
    m[:, :, 1] = False
    m[:, 17, 1] = True
    m[:, :, 2] = False
    m[:, ::2, 2] = True
    m[:, :, 3] = True
    m[:, :, 4] = False
    m[:, 5, 4] = m[:, 40, 4] = True
    v[:, 40, 4] = v[:, 5, 4]
    return torch.from_numpy(v), torch.from_numpy(m)


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit, NaN where the other has NaN, and the same layout."""
    nan = torch.isnan(want)
    return (got.stride() == want.stride() and torch.equal(torch.isnan(got), nan)
            and torch.equal(torch.where(nan, 0.0, got), torch.where(nan, 0.0, want)))


def test_cpu_tensors_take_the_plain_loop_and_launch_nothing(monkeypatch):
    monkeypatch.setattr(tp, "launches", 0)
    yin, trough = melody_cmnd(torch.float32, 12)
    want = tp.trough_priors_reference(yin, trough, THRESHOLDS, BETA, 2.0, 0.01)
    got = pitch._pyin_trough_probs(yin, trough, THRESHOLDS, BETA, 2.0, 0.01)
    assert same_bits(got, want)
    assert same_bits(tp.trough_priors(yin, trough, THRESHOLDS, BETA, 2.0, 0.01), want)
    assert tp.launches == 0


def meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("yin, trough, thresholds, beta, reason", [
    (meta((2, 314, 9), torch.float16), meta((2, 314, 9), torch.bool), THRESHOLDS, BETA,
     "float32 or float64"),
    (meta((2, 314, 9), torch.int32), meta((2, 314, 9), torch.bool), THRESHOLDS, BETA,
     "float32 or float64"),
    (meta((2, 314, 9)), meta((2, 314, 9), torch.uint8), THRESHOLDS, BETA, "bool trough mask"),
    (meta((2, 314, 9)), meta((2, 314, 8), torch.bool), THRESHOLDS, BETA, "of its shape"),
    (meta((314,)), meta((314,), torch.bool), THRESHOLDS, BETA, "of its shape"),
    (meta((2, 0, 9)), meta((2, 0, 9), torch.bool), THRESHOLDS, BETA, "at least one lag"),
    (meta((2, 314, 9)), meta((2, 314, 9), torch.bool), THRESHOLDS[::-1], BETA,
     "ascending"),
    (meta((2, 314, 9)), meta((2, 314, 9), torch.bool), THRESHOLDS, BETA[:50],
     "a beta mass for each threshold"),
    (meta((1, 40000, 4), torch.float64), meta((1, 40000, 4), torch.bool), THRESHOLDS, BETA,
     "bytes of shared memory"),
    (meta((1, 1000, 4)), meta((1, 1000, 4), torch.bool), np.linspace(0, 1, 30001),
     np.full(30000, 1 / 30000), "bytes of shared memory"),
])
def test_kernel_refusal_names_what_it_does_not_take(yin, trough, thresholds, beta, reason):
    refusal = tp.kernel_refusal(yin, trough, thresholds, beta)
    assert refusal is not None and reason in refusal


@pytest.mark.parametrize("shape, dtype", [
    ((16, 314, 8193), torch.float32),   # the catalogue's call
    ((32, 314, 1292), torch.float64),   # the clips' call in float64
    ((2, 3, 314, 1), torch.float32),    # a one-frame tail under two leading axes
    ((1, 2047, 5), torch.float64),      # the most lags frame_length 2048 gives
])
def test_kernel_refusal_takes_pyins_shapes(shape, dtype):
    assert tp.kernel_refusal(meta(shape, dtype), meta(shape, torch.bool), THRESHOLDS, BETA) is None


def one_pass_mirror(yin, trough, thresholds, beta_probs, a, no_trough_prob):
    """The kernel's sum in numpy, frame by frame: each trough's first threshold k_i by a search
    over the float thresholds, n_k from the counts by k_i, ranks from a running count by
    threshold, and each trough's terms added in ascending k from k_i, in the working type."""
    dtype = yin.dtype
    f = NP_TYPES[dtype]
    v_all, m_all = yin.numpy(), trough.numpy()
    P = v_all.shape[-2]
    K = len(thresholds) - 1
    t = f(thresholds[1:])
    beta = f(beta_probs[:K])
    num, den = (x.numpy() for x in tp._pmf_tables(a, P, dtype, torch.device("cpu")))
    empty = tp._empty_prefix(beta_probs[:K], dtype, torch.get_default_dtype())
    out = np.zeros(v_all.shape, f)
    for idx in np.ndindex(*v_all.shape[:-2], v_all.shape[-1]):
        col = idx[:-1] + (slice(None), idx[-1])
        v, m = v_all[col], m_all[col]
        ki = np.where(m, np.searchsorted(t, v, side="right"), K)  # the first k with v < t_k
        n_k = np.cumsum(np.bincount(ki[ki < K], minlength=K))
        earlier = np.zeros(K, np.int64)
        prior = np.zeros(P, f)
        for p in np.flatnonzero(ki < K):
            s = f(0)
            for k in range(ki[p], K):
                s = f(s + f(f(num[earlier[k]] / den[n_k[k]]) * beta[k]))
            earlier[ki[p]:] += 1
            prior[p] = s
        lowest = int(np.argmin(np.where(m, v, np.inf)))
        extra = f(f(no_trough_prob) * (empty[ki.min()] if m.any() else f(0)))
        prior[lowest] = f(prior[lowest] + extra)
        out[col] = prior
    return torch.from_numpy(out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_numpy_mirror_of_the_one_pass_sum_equals_the_loop(dtype):
    rng = np.random.RandomState(7)
    cases = [melody_cmnd(dtype, 24, rows=2), tie_case(NP_TYPES[dtype], rng)]
    for yin, trough in cases:
        want = tp.trough_priors_reference(yin, trough, THRESHOLDS, BETA, 2.0, 0.01)
        assert same_bits(one_pass_mirror(yin, trough, THRESHOLDS, BETA, 2.0, 0.01), want)


@pytest.fixture(scope="module")
def emulated_kernel(tmp_path_factory):
    """``csrc/trough_priors.cu`` built with g++ over ``tests/cuda_emulation.h``."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    src = (ROOT / "librosa_tpu_torch" / "csrc" / "trough_priors.cu").read_text()
    decl = "extern __shared__ __align__(16) unsigned char smem[];"
    assert decl in src
    src = src.replace(decl, "unsigned char* smem = emu_smem_base;")
    src, n = re.subn(r"(trough_priors_kernel<T>)<<<(.*?)>>>\((.*?)\);",
                     r"emu_launch(\2, [=]() { \1(\3); });", src, flags=re.S)
    assert n == 1
    work = tmp_path_factory.mktemp("trough_priors_emulated")
    (work / "trough_priors.cpp").write_text(src)
    (work / "cuda_runtime.h").write_text("")
    lib = work / "libtrough_priors.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", "-include", str(ROOT / "tests" / "cuda_emulation.h"),
                    f"-I{work}", str(work / "trough_priors.cpp"), "-o", str(lib)], check=True)
    return ctypes.CDLL(str(lib))


def emulated_cases():
    rng = np.random.RandomState(11)
    for dtype, f in NP_TYPES.items():
        name = str(dtype).replace("torch.", "")
        yin, trough = melody_cmnd(dtype, 16)
        yield f"{name} pyin's input", yin, trough, 2.0, 0.01
        yin, trough = melody_cmnd(dtype, 9, rows=2, seed=4)
        yield f"{name} every other frame", yin[:, :, ::2], trough[:, :, ::2], 2.0, 0.01
        yield (f"{name} ties", *tie_case(f, rng), 2.0, 0.01)
        v, m = rng.rand(3, 314, 1).astype(f), rng.rand(3, 314, 1) < 0.3
        yield f"{name} T = 1", torch.from_numpy(v), torch.from_numpy(m), 2.0, 0.01
        v, m = rng.rand(1, 2047, 3).astype(f) * 1.2, rng.rand(1, 2047, 3) < 0.3
        yield f"{name} P = 2047", torch.from_numpy(v), torch.from_numpy(m), 2.0, 0.01
        v, m = rng.rand(2, 40, 5).astype(f), rng.rand(2, 40, 5) < 0.4
        v[0, 3] = np.nan
        yield (f"{name} NaN values, a = 0 (NaN priors)",
               torch.from_numpy(v), torch.from_numpy(m), 0.0, 0.3)


def use_emulated(monkeypatch, lib):
    monkeypatch.setattr(tp, "_build", types.SimpleNamespace(load=lambda name: lib))
    monkeypatch.setattr(tp, "launches", 0)


@pytest.mark.parametrize("case", list(emulated_cases()), ids=lambda c: c[0])
def test_kernel_source_under_gxx_equals_the_loop(case, emulated_kernel, monkeypatch):
    label, yin, trough, a, no_trough = case
    use_emulated(monkeypatch, emulated_kernel)
    want = tp.trough_priors_reference(yin, trough, THRESHOLDS, BETA, a, no_trough)
    got = tp._launch(yin, trough, THRESHOLDS, BETA, a, no_trough, None)
    assert same_bits(got, want), label
    assert tp.launches == 1


@pytest.mark.parametrize("shape", [(2, 314, 0), (0, 314, 7), (3, 0, 314, 1)])
def test_an_input_with_no_frame_launches_nothing(shape, emulated_kernel, monkeypatch):
    use_emulated(monkeypatch, emulated_kernel)
    got = tp._launch(torch.rand(shape), torch.rand(shape) < 0.3, THRESHOLDS, BETA, 2.0, 0.01, None)
    assert got.shape == shape and got.is_contiguous() and tp.launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_geometry_matches_the_kernel_source(dtype, emulated_kernel, monkeypatch):
    """``kernel_refusal`` takes the most lags the kernel's launch fits into a one-warp block,
    and refuses one more, which the launch refuses too."""
    use_emulated(monkeypatch, emulated_kernel)

    def refused(P):
        return tp.kernel_refusal(meta((1, P, 1), dtype), meta((1, P, 1), torch.bool), THRESHOLDS,
                                 BETA) is not None

    lo, hi = 314, 1 << 17  # lo taken, hi refused
    assert not refused(lo) and refused(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if refused(mid) else (mid, hi)
    f = NP_TYPES[dtype]
    for P in (lo, hi):
        yin = torch.from_numpy(np.linspace(0.0, 1.2, P).astype(f)).reshape(1, P, 1)
        trough = torch.zeros(1, P, 1, dtype=torch.bool)
        trough[0, ::997] = True
        if P == lo:
            want = tp.trough_priors_reference(yin, trough, THRESHOLDS, BETA, 2.0, 0.01)
            assert same_bits(tp._launch(yin, trough, THRESHOLDS, BETA, 2.0, 0.01, None), want)
        else:
            with pytest.raises(RuntimeError, match="CUDA error 1"):
                tp._launch(yin, trough, THRESHOLDS, BETA, 2.0, 0.01, None)
    assert tp.launches == 1
