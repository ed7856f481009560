"""The ``precision`` dial of the ``stft_mel`` kernel's function and of the ``'matmul'`` route.

Both take what ``jax.lax.Precision`` takes (``ops/precision.py``). On the
CPU the port runs the plain versions, which compute each setting as
explicit arithmetic: ``'highest'`` exact float32, bit-equal to the routes
as they were before the dial; ``'default'`` and ``'high'`` bfloat16-rounded
or split operands through exact float32 products. Here they are held
against a numpy emulation that rounds to bfloat16 by bit operations and
sums in float64, against float64, and against the JAX kernel in interpret
mode (whose products are exact float32 on the CPU at every setting, so only
``'highest'`` can be compared with it). The kernel is held against the
plain version at each setting on the card (``chip_smoke.py`` phase 4p).
"""

import jax
import numpy as np
import pytest
import torch

import librosa_tpu as lt
from librosa_tpu.ops.pallas_stft import stft_mel_pallas

import librosa_tpu_torch as L
from librosa_tpu_torch._device import exact_f32
from librosa_tpu_torch.ops import fft, fused_stft, precision
from librosa_tpu_torch.ops.framing import frame_signal
from librosa_tpu_torch.util.utils import pad_last

SR = 22050
N_FFT, HOP, N_MELS = 512, 128, 64
MIN_SNR_DB = 115.0          # tests/test_torch_fused_stft.py's floor against the JAX kernel
SUM_RTOL = 5e-7             # float32 sums in another order, relative to the sum of |terms|
                            # (2.2e-7 at most here; HIGH differs from exact by 1.8e-5 on the mel)
# against float64 on _signal(): each floor a few dB under what was measured
MEL_F64_FLOOR_DB = {"default": 53.0, "high": 107.0, "highest": 135.0}   # 56.3, 110.6, 138.9
DFT_F64_FLOOR_DB = {"default": 50.0, "high": 105.0, "highest": 125.0}   # 53.4, 108.3, 128.9
FLAGS = ("cuda.matmul.allow_tf32", "cuda.matmul.allow_bf16_reduced_precision_reduction",
         "cudnn.allow_tf32")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)
    fft.set_stft_backend("auto", precision="highest")


def _signal(seed: int = 0, tracks: int = 2, seconds: float = 1.0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(tracks, int(seconds * SR)) * 0.1).astype(np.float32)


def _tables():
    win = np.hanning(N_FFT).astype(np.float32)
    basis = lt.filters.mel(sr=SR, n_fft=N_FFT, n_mels=N_MELS).astype(np.float32)
    return win, basis


def _snr(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(10 * np.log10(np.sum(want**2) / max(np.sum((got - want) ** 2), 1e-300)))


def bf16(x) -> np.ndarray:
    """float32 ``x`` rounded to bfloat16 (to nearest, ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def emulated_terms(a, b, setting):
    """The setting's rounded operand pairs of ``a @ b``, float64."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if setting == "default":
        return [(bf16(a), bf16(b))]
    a_hi, b_hi = bf16(a), bf16(b)
    a_lo, b_lo = bf16(a - a_hi), bf16(b - b_hi)
    return [(a_hi, b_hi), (a_hi, b_lo), (a_lo, b_hi)]


def emulated(a, b, setting):
    """``a @ b`` at ``setting`` in float64, and the sum of the terms' magnitudes."""
    pairs = [(x.astype(np.float64), w.astype(np.float64)) for x, w in emulated_terms(a, b, setting)]
    return sum(x @ w for x, w in pairs), sum(np.abs(x) @ np.abs(w) for x, w in pairs)


def _today_mel(y, win, basis):
    """``stft_mel_reference`` as it was before the dial: pad, frame, rfft, |.|^2, exact matmul."""
    yp = pad_last(y, N_FFT // 2, N_FFT // 2, mode="constant")
    spec = torch.fft.rfft(frame_signal(yp, frame_length=N_FFT, hop_length=HOP) * win, dim=-1)
    with exact_f32():
        return torch.matmul(basis, (spec.real.square() + spec.imag.square()).transpose(-1, -2))


def _frames(y, win):
    yp = pad_last(y, N_FFT // 2, N_FFT // 2, mode="constant")
    return frame_signal(yp, frame_length=N_FFT, hop_length=HOP) * win


def _mel(y, setting):
    win, basis = _tables()
    return fused_stft.stft_mel_fused(torch.from_numpy(y), win, basis, n_fft=N_FFT,
                                     hop_length=HOP, precision=setting)


def _mel64(y):
    win, basis = _tables()
    yp = np.pad(y.astype(np.float64), ((0, 0), (N_FFT // 2, N_FFT // 2)))
    fr = np.lib.stride_tricks.sliding_window_view(yp, N_FFT, axis=-1)[:, ::HOP] * win
    return basis.astype(np.float64) @ np.swapaxes(np.abs(np.fft.rfft(fr, axis=-1)) ** 2, -1, -2)


@pytest.mark.parametrize("setting", [None, "highest", "float32", ("highest",) * 3,
                                     ("default", "high", "highest")])
def test_highest_is_todays_mel_and_matches_jax(setting):
    y = _signal(1)
    win, basis = _tables()
    got = _mel(y, setting)
    today = _today_mel(torch.from_numpy(y), torch.from_numpy(win), torch.from_numpy(basis))
    assert torch.equal(got, today)
    want = np.asarray(stft_mel_pallas(y, win, basis, n_fft=N_FFT, hop_length=HOP,
                                      interpret=True, precision=jax.lax.Precision.HIGHEST))
    assert _snr(got.numpy(), want) >= MIN_SNR_DB


@pytest.mark.parametrize("setting", ["default", "high"])
def test_lower_mel_settings_are_the_emulation(setting):
    y = _signal(2)
    win, basis = _tables()
    got = _mel(y, setting).numpy()
    # the same power spectrum the plain version projects (its DFT is always exact)
    pw = fused_stft.frames_power(torch.from_numpy(y), torch.from_numpy(win), n_fft=N_FFT,
                                 hop_length=HOP, power=2.0, center=True,
                                 pad_mode="constant").numpy()
    want, scale = emulated(basis, np.swapaxes(pw, -1, -2), setting)
    assert np.all(np.abs(got - want) <= SUM_RTOL * scale)
    # and not the exact product: the rounding is there
    exact = basis.astype(np.float64) @ np.swapaxes(pw, -1, -2).astype(np.float64)
    assert np.max(np.abs(exact - want) / scale) > 10 * SUM_RTOL


@pytest.mark.parametrize("setting", ["default", "high", "highest"])
def test_mel_settings_against_float64(setting):
    y = _signal(3)
    assert _snr(_mel(y, setting).numpy(), _mel64(y)) >= MEL_F64_FLOOR_DB[setting]


def test_tuple_acts_only_through_its_basis_entry():
    y = _signal(4)
    for basis_entry in ("default", "high", "highest"):
        want = _mel(y, basis_entry)
        for first, second in (("highest", "highest"), ("default", "bfloat16_3x"),
                              ("fastest", "float32")):
            assert torch.equal(_mel(y, (first, second, basis_entry)), want)
    assert not torch.equal(_mel(y, "default"), _mel(y, "highest"))


def test_matmul_route_highest_is_todays():
    frames = _frames(torch.from_numpy(_signal(5)), torch.from_numpy(_tables()[0]))
    Ct, St = fft.dft_mats_device(N_FFT, torch.float32, "cpu")
    with exact_f32():
        re, im = torch.matmul(frames, Ct), torch.matmul(frames, St)
    for setting in (None, "highest", "float32"):
        fft.set_stft_backend("matmul", precision=setting)
        assert fft.get_matmul_precision() == "highest"
        assert torch.equal(fft.frames_power_spectrum(frames), re * re + im * im)
        assert torch.equal(fft.frames_rdft(frames), torch.complex(re, -im))


@pytest.mark.parametrize("setting", ["default", "high"])
def test_matmul_route_lower_settings_are_the_emulation(setting):
    frames = _frames(torch.from_numpy(_signal(6)), torch.from_numpy(_tables()[0]))
    C, S = (m.T.numpy() for m in fft.dft_mats_device(N_FFT, torch.float32, "cpu"))
    fft.set_stft_backend("matmul", precision=setting)
    got = fft.frames_rdft(frames).numpy()
    re, re_scale = emulated(frames.numpy(), C.T, setting)
    im, im_scale = emulated(frames.numpy(), S.T, setting)
    assert np.all(np.abs(got.real - re) <= SUM_RTOL * re_scale)
    assert np.all(np.abs(got.imag + im) <= SUM_RTOL * im_scale)
    pw = fft.frames_power_spectrum(frames).numpy()
    bound = 2 * SUM_RTOL * (np.abs(re) * re_scale + np.abs(im) * im_scale) + 1e-30
    assert np.all(np.abs(pw - (re * re + im * im)) <= 2 * bound)


@pytest.mark.parametrize("setting", ["default", "high", "highest"])
def test_matmul_route_against_float64(setting):
    y = _signal(7)
    win = _tables()[0]
    frames = _frames(torch.from_numpy(y), torch.from_numpy(win))
    fft.set_stft_backend("matmul", precision=setting)
    got = fft.frames_power_spectrum(frames).numpy()
    want = np.abs(np.fft.rfft(frames.numpy().astype(np.float64), axis=-1)) ** 2
    assert _snr(got, want) >= DFT_F64_FLOOR_DB[setting]


def test_normalizer_takes_every_jax_alias_and_refuses_the_rest():
    for name in ("default", "bfloat16", "fastest", "high", "bfloat16_3x", "tensorfloat32",
                 "highest", "float32"):
        assert precision.normalize(name) == jax.lax.Precision(name).name.lower()
    assert precision.normalize(None) == "highest"
    for bad in ("cufft", "tf32", "HIGHEST", "Highest", "fp32", " highest"):  # JAX refuses them
        with pytest.raises(ValueError):
            precision.normalize(bad)
        with pytest.raises(ValueError):
            jax.lax.Precision(bad)
    for bad in (2, 1.0, jax.lax.Precision.HIGH, ("highest",) * 3):  # not names: the port refuses
        with pytest.raises(ValueError):
            precision.normalize(bad)
    with pytest.raises(ValueError):
        precision.normalize3(("highest", "highest"))
    y = _signal(8, tracks=1, seconds=0.2)
    with pytest.raises(ValueError):
        _mel(y, "cufft")
    with pytest.raises(ValueError):
        _mel(y, ("highest", "highest", "tf32"))


def test_set_stft_backend_keeps_or_refuses_the_setting():
    fft.set_stft_backend("matmul", precision="bfloat16_3x")
    assert fft.get_matmul_precision() == "high"
    fft.set_stft_backend("fft")              # None keeps the stored setting, as in JAX
    assert fft.get_matmul_precision() == "high" and fft.get_stft_backend() == "fft"
    with pytest.raises(ValueError):
        fft.set_stft_backend("matmul", precision="cufft")
    assert fft.get_stft_backend() == "fft" and fft.get_matmul_precision() == "high"
    fft.set_stft_backend("auto", precision="highest")
    assert fft.get_matmul_precision() == "highest"


def _flags():
    out = {}
    for path in FLAGS:
        obj = torch.backends
        for part in path.split(".")[:-1]:
            obj = getattr(obj, part)
        out[path] = getattr(obj, path.split(".")[-1])
    return out, torch.get_float32_matmul_precision()


@pytest.mark.parametrize("tf32", [False, True])
def test_no_backend_flag_changes_across_a_call(tf32):
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = not tf32
    try:
        before = _flags()
        y = _signal(9, tracks=1, seconds=0.3)
        frames = _frames(torch.from_numpy(y), torch.from_numpy(_tables()[0]))
        for setting in ("default", "high", "highest", ("highest", "highest", "default")):
            _mel(y, setting)
            assert _flags() == before
        for setting in ("default", "high", "highest"):
            fft.set_stft_backend("matmul", precision=setting)
            fft.frames_power_spectrum(frames)
            fft.frames_rdft(frames)
            assert _flags() == before
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
