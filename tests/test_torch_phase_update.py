"""Griffin-Lim's phase update kernel on the CPU: its routing, its refusals and its arithmetic.

``core/spectrum.py:_phase_update`` sends what ``ops/phase_update.py:kernel_refusal``
takes to ``csrc/phase_update.cu`` and everything else to the plain torch passes. Here:
the CPU route and the plain version bit for bit, with no launch; every refusal, and
``griffinlim``'s own tensors refused for their device alone; and the kernel's source,
built with g++ over ``tests/cuda_emulation.h``, against a numpy mirror of torch's CUDA
arithmetic bit for bit and against the plain version on the CPU as the source states (the
same bits wherever |z| is normal, 4 ulps where it is subnormal): its pairs, its scalar head
and tail, both bases' alignments, zeros, large and subnormal magnitudes, with one launch
counted a launch. The g++ cases skip only where g++ is absent.
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

from librosa_tpu_torch.core import spectrum
from librosa_tpu_torch.ops import phase_update as pu
from librosa_tpu_torch.util import profiling
from librosa_tpu_torch.util.exceptions import ParameterError

ROOT = Path(__file__).resolve().parents[1]
WEIGHT = 0.99 / 1.99  # griffinlim's momentum / (1 + momentum)
TINY = np.float32(np.finfo(np.float32).tiny)
ULPS = 4  # the source's tolerance against the plain version on the CPU where z is subnormal


def time_major(shape, seed, scale=1.0):
    """Complex64 ``(..., bins, T)`` views of time-major memory, as ``stft`` returns them."""
    g = torch.Generator().manual_seed(seed)
    *lead, bins, T = shape
    z = torch.randn(*lead, T, bins, 2, generator=g) * scale
    return torch.view_as_complex(z).transpose(-2, -1)


def operands(shape=(2, 33, 17), seed=0, prev=True):
    """``(estimate, rebuilt, tprev, S)`` in griffinlim's layout."""
    S = time_major(shape, seed + 1).abs()
    tprev = time_major(shape, seed + 2) if prev else None
    return time_major(shape, seed + 3), time_major(shape, seed), tprev, S


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit, NaN where the other has NaN."""
    g, w = torch.view_as_real(got), torch.view_as_real(want)
    nan = torch.isnan(w)
    return (torch.equal(torch.isnan(g), nan)
            and torch.equal(torch.where(nan, 0.0, g).view(torch.int32),
                            torch.where(nan, 0.0, w).view(torch.int32)))


@pytest.mark.parametrize("prev", [False, True])
def test_cpu_route_is_the_plain_version_and_launches_nothing(prev, monkeypatch):
    monkeypatch.setattr(pu, "launches", 0)
    estimate, rebuilt, tprev, S = operands(prev=prev)
    want = estimate.clone()
    pu.phase_update_reference(want, rebuilt, tprev, S, WEIGHT)
    before = profiling.counts().get("phase_update_kernels", 0)
    spectrum._phase_update(estimate, rebuilt, tprev, S, WEIGHT)
    assert same_bits(estimate, want) and estimate.stride() == want.stride()
    assert pu.launches == 0
    assert profiling.counts().get("phase_update_kernels", 0) == before


def _refused(case):
    estimate, rebuilt, tprev, S = operands()
    if case == "complex128 estimate":
        estimate = estimate.to(torch.complex128)
    elif case == "complex128 rebuilt":
        rebuilt = rebuilt.to(torch.complex128)
    elif case == "complex128 tprev":
        tprev = tprev.to(torch.complex128)
    elif case == "float64 S":
        S = S.double()
    elif case == "S in another layout":
        S = S.contiguous()
    elif case == "tprev in another layout":
        tprev = tprev.contiguous()
    elif case == "rebuilt of another shape":
        rebuilt = rebuilt[..., :-1]
    elif case == "S on another device":
        S = S.to("meta")
    elif case == "non-dense views":
        estimate, rebuilt, tprev, S = (t[..., ::2] for t in (estimate, rebuilt, tprev, S))
    elif case == "overlapping views":
        estimate, rebuilt, tprev, S = (t[:1].expand(2, -1, -1) for t in (estimate, rebuilt,
                                                                          tprev, S))
    return pu.kernel_refusal(estimate, rebuilt, tprev, S)


@pytest.mark.parametrize("case, reason", [
    ("complex128 estimate", "complex64 estimate"),
    ("complex128 rebuilt", "complex64 rebuilt"),
    ("complex128 tprev", "complex64 tprev"),
    ("float64 S", "float32 S"),
    ("S in another layout", "S in the estimate's shape and strides"),
    ("tprev in another layout", "tprev in the estimate's shape and strides"),
    ("rebuilt of another shape", "rebuilt in the estimate's shape"),
    ("S on another device", "on one device"),
    ("non-dense views", "non-overlapping, dense"),
    ("overlapping views", "non-overlapping, dense"),
    ("CPU tensors", "runs on a CUDA tensor, not on cpu"),
])
def test_kernel_refusal_names_what_it_does_not_take(case, reason):
    refusal = _refused(case)
    assert refusal is not None and reason in refusal


def test_phase_update_raises_on_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(pu, "launches", 0)
    estimate, rebuilt, tprev, S = operands()
    with pytest.raises(ParameterError, match="CUDA tensor"):
        pu.phase_update(estimate, rebuilt, tprev, S, WEIGHT)
    assert pu.launches == 0


@pytest.mark.parametrize("shape", [(2, 129, 40), (129, 40), (1, 129, 5)])
def test_griffinlims_tensors_are_refused_for_their_device_alone(shape, monkeypatch):
    """The loop's four tensors pass every rule but the device: on a card, the kernel takes
    every round, the first (no tprev) among them."""
    reasons, refusal = [], pu.kernel_refusal

    def spy(*args):
        reason = refusal(*args)
        reasons.append((args[2] is None, reason))
        return reason

    monkeypatch.setattr(pu, "kernel_refusal", spy)
    S = torch.rand(*shape, generator=torch.Generator().manual_seed(1))
    spectrum.griffinlim(S, n_iter=3, rng=0, n_fft=256, hop_length=64)
    assert [first for first, _ in reasons] == [True, False, False]
    assert all(r == "the phase update kernel runs on a CUDA tensor, not on cpu"
               for _, r in reasons)


# -- the kernel's source under g++ -------------------------------------------------------------

@pytest.fixture(scope="module")
def emulated_kernel(tmp_path_factory):
    """``csrc/phase_update.cu`` built with g++ over ``tests/cuda_emulation.h``."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    src = (ROOT / "librosa_tpu_torch" / "csrc" / "phase_update.cu").read_text()
    src, n = re.subn(r"(phase_update_kernel<PREV, VEC>)<<<(.*?)>>>\((.*?)\);",
                     r"emu_launch(\2, [=]() { \1(\3); });", src, flags=re.S)
    assert n == 1
    work = tmp_path_factory.mktemp("phase_update_emulated")
    (work / "phase_update.cpp").write_text(src)
    (work / "cuda_runtime.h").write_text("")
    lib = work / "libphase_update.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", "-include", str(ROOT / "tests" / "cuda_emulation.h"),
                    f"-I{work}", str(work / "phase_update.cpp"), "-o", str(lib)], check=True)
    return ctypes.CDLL(str(lib))


def use_emulated(monkeypatch, lib):
    monkeypatch.setattr(pu, "_build", types.SimpleNamespace(load=lambda name: lib))
    monkeypatch.setattr(pu, "launches", 0)


def torch_cuda_mirror(rebuilt, tprev, S, weight):
    """torch's CUDA ops of the plain version, one rounding each, in numpy float32: the add
    with the complex alpha (-w, 0), hypotf, + tiny, the quotient by (d, 0) by numpy's
    scaling, the product by (S, 0)."""
    f = np.float32
    r = torch.view_as_real(rebuilt).numpy()
    zr, zi = r[..., 0], r[..., 1]
    zero = f(0)
    with np.errstate(all="ignore"):
        if tprev is not None:
            t = torch.view_as_real(tprev).numpy()
            negw = -f(weight)
            zr = zr + (negw * t[..., 0] - zero * t[..., 1])
            zi = zi + (negw * t[..., 1] + zero * t[..., 0])
        scale = f(1) / (np.hypot(zr, zi) + TINY)
        ur = (zr + zi * zero) * scale
        ui = (zi - zr * zero) * scale
        s = S.numpy()
        out = np.stack([ur * s - ui * zero, ur * zero + ui * s], axis=-1)
    return torch.view_as_complex(torch.from_numpy(np.ascontiguousarray(out)))


def ulps_apart(got, want):
    """The larger part's difference, in ulps of the element's larger part of ``want``."""
    g, w = torch.view_as_real(got).double(), torch.view_as_real(want).double()
    big = w.abs().amax(-1)
    ulp = torch.from_numpy(np.spacing(big.float().numpy()).astype(np.float64))
    return float(((g - w).abs().amax(-1) / ulp).max())


def flat(n, seed, scale=1.0, offset=0):
    """Complex64 and float32 tensors of n elements starting ``offset`` elements into a buffer."""
    g = torch.Generator().manual_seed(seed)
    c = torch.view_as_complex(torch.randn(n + offset, 2, generator=g) * scale)[offset:]
    return c


def emulated_cases():
    """(label, estimate, rebuilt, tprev, S)."""
    for prev in (False, True):
        tag = "tprev" if prev else "no tprev"
        e, r, t, s = operands((3, 65, 41), seed=5, prev=prev)
        yield f"{tag}: griffinlim's layout, pairs", e, r, t, s
        n = 2 * 256 * 8 + 5  # an odd count: the scalar tail
        r, t, e = flat(n, 6), (flat(n, 7) if prev else None), flat(n, 8)
        s = flat(n, 9).abs()
        yield f"{tag}: odd count", e, r, t, s
        buf = [flat(n + 1, k) for k in (10, 11, 12, 13)]
        r, t, e, s = buf[0][1:], (buf[1][1:] if prev else None), buf[2][1:], buf[3].abs()[1:]
        yield f"{tag}: bases 8 bytes past 16, a scalar head", e, r, t, s
        yield f"{tag}: S at another alignment, all scalar", e, r, t, buf[3].abs()[:-1]
        for m in (1, 2):  # the head alone, then the head and the tail, with no pair between
            one = [flat(m + 1, k) for k in (25, 26, 27, 28)]
            r, t, e = one[0][1:], (one[1][1:] if prev else None), one[2][1:]
            yield f"{tag}: {m} element(s) 8 bytes past 16", e, r, t, one[3].abs()[1:]
    n = 1001
    r, t, s = flat(n, 14), flat(n, 15), flat(n, 16).abs()
    r[::7] = 0
    t[::7] = 0  # z == 0 there: the output is 0
    r[3::7] = 1e-41 + 1e-42j  # subnormal z (tprev 0 there too)
    t[3::7] = 0
    r[5::7] *= 1e37  # large z, and one term of the weighted sum large
    yield "zeros, subnormal and large magnitudes", flat(n, 17), r, t, s
    r, t, s = flat(n, 18, scale=1e-39), flat(n, 19, scale=1e-39), flat(n, 20).abs()
    yield "every z subnormal", flat(n, 21), r, t, s
    r, s = flat(n, 22, scale=1e37), flat(n, 23).abs() * 1e-30
    yield "every z near the top of float32, no tprev", flat(n, 24), r, None, s


@pytest.mark.parametrize("case", list(emulated_cases()), ids=lambda c: c[0])
def test_kernel_source_under_gxx_is_torchs_cuda_arithmetic(case, emulated_kernel, monkeypatch):
    label, estimate, rebuilt, tprev, S = case
    use_emulated(monkeypatch, emulated_kernel)
    before = profiling.counts().get("phase_update_kernels", 0)
    pu._launch(estimate, rebuilt, tprev, S, WEIGHT, None)
    assert pu.launches == 1
    assert profiling.counts().get("phase_update_kernels", 0) == before + 1
    assert same_bits(estimate, torch_cuda_mirror(rebuilt, tprev, S, WEIGHT)), label
    want = torch.empty_like(estimate)
    pu.phase_update_reference(want, rebuilt, tprev, S, WEIGHT)
    assert torch.isfinite(estimate).all() and torch.isfinite(want).all()
    assert ulps_apart(estimate, want) <= ULPS, label
    z = rebuilt.to(torch.complex128)
    if tprev is not None:
        z = z - WEIGHT * tprev.to(torch.complex128)
    normal = z.abs() >= float(TINY)
    assert same_bits(estimate[normal], want[normal]), label
    zero = (rebuilt == 0) & ((tprev == 0) if tprev is not None else True)
    assert torch.equal(estimate[zero], torch.zeros_like(estimate[zero]))


def test_an_empty_update_launches_nothing(emulated_kernel, monkeypatch):
    use_emulated(monkeypatch, emulated_kernel)
    e, r, t, s = operands((2, 0, 5))
    pu._launch(e, r, t, s, WEIGHT, None)
    assert pu.launches == 0
