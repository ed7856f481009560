"""The port's ``ops.ctfft``, ``ops.transforms.dft_matrices`` and the STFT backend switch, against
the JAX package and float64 numpy on the CPU.

Floors, each below the value measured on its own input (seeded; measured
values in brackets, lowest over the lengths):

- ``fft_arbitrary`` on complex64 ``(2, 3, n)`` at n = 110250, 1000, 997
  (prime), 4096 against float64 ``numpy.fft.fft``: 120 dB (126.7) and
  against the JAX function 120 dB (128.3); complex128 input against float64
  240 dB (255.9); ``ifft_arbitrary(fft_arbitrary(x))`` against ``x``
  118 dB (123.6);
- under ``set_stft_backend('matmul')`` in both packages: ``resample(res_type='fft')``
  22050 -> 16000 Hz 120 dB (128.5), ``autocorrelate`` 125 dB (135.1) and
  ``stft`` 125 dB (127.6);
- under ``'auto'`` both functions are bit-identical to the port's route
  before the switch existed (``torch.fft`` over scipy's fast length).
"""

import jax
import numpy as np
import pytest
import scipy.fft
import torch

from librosa_tpu import autocorrelate as jax_autocorrelate
from librosa_tpu import resample as jax_resample
from librosa_tpu import stft as jax_stft
from librosa_tpu.ops import ctfft as jax_ctfft
from librosa_tpu.ops import fft as jax_fft
from librosa_tpu.ops import transforms as jax_transforms
from torch_threads import one_torch_thread  # noqa: F401 (autouse, one intra-op thread)
import librosa_tpu_torch as L
from librosa_tpu_torch.ops import ctfft, fft, transforms

LENGTHS = [110250, 1000, 997, 4096]
FFT64_SNR_DB = 120.0
FFT_JAX_SNR_DB = 120.0
FFT128_SNR_DB = 240.0
ROUNDTRIP_SNR_DB = 118.0
RESAMPLE_SNR_DB = 120.0
AUTOCORR_SNR_DB = 125.0
STFT_SNR_DB = 125.0


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


@pytest.fixture
def matmul_backend():
    fft.set_stft_backend("matmul")
    jax_fft.set_stft_backend("matmul")
    try:
        yield
    finally:
        fft.set_stft_backend("auto")
        jax_fft.set_stft_backend("auto")


def snr_db(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    err = np.sum(np.abs(got.astype(np.complex128) - want) ** 2)
    return float(10 * np.log10(np.sum(np.abs(want) ** 2) / max(err, 1e-300)))


def _signal(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 3, n) + 1j * rng.randn(2, 3, n)).astype(np.complex64)


@pytest.mark.parametrize("n", LENGTHS)
def test_fft_arbitrary_matches_float64_and_jax(n):
    x = _signal(n)
    want = np.fft.fft(x.astype(np.complex128), axis=-1)
    got = ctfft.fft_arbitrary(x, n)
    assert got.dtype == torch.complex64 and tuple(got.shape) == x.shape
    assert snr_db(got, want) >= FFT64_SNR_DB
    assert snr_db(got, jax_ctfft.fft_arbitrary(x, n)) >= FFT_JAX_SNR_DB
    got128 = ctfft.fft_arbitrary(torch.from_numpy(x.astype(np.complex128)), n)
    assert got128.dtype == torch.complex128
    assert snr_db(got128, want) >= FFT128_SNR_DB


@pytest.mark.parametrize("n", LENGTHS)
def test_ifft_arbitrary_inverts_and_matches_jax(n):
    x = _signal(n, seed=1)
    X = ctfft.fft_arbitrary(x, n)
    back = ctfft.ifft_arbitrary(X, n)
    assert snr_db(back, x) >= ROUNDTRIP_SNR_DB
    want = np.fft.ifft(np.asarray(X).astype(np.complex128), axis=-1)
    assert snr_db(back, want) >= FFT64_SNR_DB
    assert snr_db(back, jax_ctfft.ifft_arbitrary(np.asarray(X), n)) >= FFT_JAX_SNR_DB


def test_real_input_and_length_check():
    y = np.random.RandomState(2).randn(4, 1000).astype(np.float32)
    got = ctfft.fft_arbitrary(y, 1000)
    assert got.dtype == torch.complex64
    assert snr_db(got, np.fft.fft(y.astype(np.float64))) >= FFT64_SNR_DB
    for fn in (ctfft.fft_arbitrary, jax_ctfft.fft_arbitrary):
        with pytest.raises(ValueError, match="length mismatch"):
            fn(y, 999)


@pytest.mark.parametrize("n", [1, 2, 7, 12, 97, 110250, 2 ** 16, 997 * 991])
def test_good_fft_factor_matches_jax(n):
    assert ctfft.good_fft_factor(n) == jax_ctfft.good_fft_factor(n)
    assert ctfft._is_pow2(n) == jax_ctfft._is_pow2(n)


@pytest.mark.parametrize("n_fft", [16, 511, 2048])
def test_dft_matrices_equal_jax(n_fft):
    for ours, theirs in zip(transforms.dft_matrices(n_fft), jax_transforms.dft_matrices(n_fft)):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    C, S = transforms.dft_matrices(n_fft, dtype="float64")
    x = np.random.RandomState(n_fft).randn(n_fft)
    assert np.allclose(C @ x - 1j * (S @ x), np.fft.rfft(x), atol=1e-9)


def test_backend_surface_matches_jax():
    assert fft.get_stft_backend() == jax_fft.get_stft_backend() == "auto"
    assert fft._resolved_backend() == jax_fft._resolved_backend() == "fft"
    try:
        fft.set_stft_backend("matmul")
        assert fft.get_stft_backend() == "matmul" and fft._resolved_backend() == "matmul"
    finally:
        fft.set_stft_backend("auto")
    for fn in (fft.set_stft_backend, jax_fft.set_stft_backend):
        with pytest.raises(ValueError, match="Unknown stft backend"):
            fn("cufft")
    fft.set_stft_backend("auto", precision="highest")
    # the port takes the names jax.lax.Precision takes, refuses the rest, and a refusal
    # changes neither the backend nor the stored precision
    with pytest.raises(ValueError, match="not a valid precision"):
        fft.set_stft_backend("matmul", precision="cufft")
    with pytest.raises(ValueError):
        jax.lax.Precision("cufft")
    assert fft.get_stft_backend() == "auto" and fft.get_matmul_precision() == "highest"
    try:
        fft.set_stft_backend("matmul", precision="high")
        assert fft.get_matmul_precision() == jax.lax.Precision("high").name.lower() == "high"
    finally:
        fft.set_stft_backend("auto", precision="highest")
    assert fft.get_stft_backend() == "auto"
    Ct, St = fft.dft_mats_device(64, torch.float64)
    assert tuple(Ct.shape) == (64, 33) and Ct.dtype == torch.float64
    assert Ct.device.type == "cpu" and fft.dft_mats_device(64, torch.float64)[0] is Ct


def test_resample_fft_under_matmul_matches_jax(matmul_backend):
    y = np.random.RandomState(3).randn(3, 22050).astype(np.float32)
    got = L.resample(y, orig_sr=22050, target_sr=16000, res_type="fft")
    want = jax_resample(y, orig_sr=22050, target_sr=16000, res_type="fft")
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 16000)
    assert snr_db(got, want) >= RESAMPLE_SNR_DB


def test_autocorrelate_and_stft_under_matmul_match_jax(matmul_backend):
    y = np.random.RandomState(4).randn(2, 1000).astype(np.float32)
    assert snr_db(L.autocorrelate(y), jax_autocorrelate(y)) >= AUTOCORR_SNR_DB
    z = np.random.RandomState(5).randn(4096).astype(np.float32)
    assert snr_db(L.stft(z, n_fft=512), jax_stft(z, n_fft=512)) >= STFT_SNR_DB


def test_auto_leaves_resample_and_autocorrelate_bit_identical():
    """Under 'auto' the two functions run the route they ran before the switch existed."""
    y = torch.from_numpy(np.random.RandomState(6).randn(3, 22050).astype(np.float32))
    n, num = 22050, 16000
    X = torch.fft.rfft(y, dim=-1)
    Y = X.new_zeros((3, num // 2 + 1))
    Y[..., :num // 2 + 1] = X[..., :num // 2 + 1]
    Y[..., num // 2] *= 2.0
    want = torch.fft.irfft(Y, n=num, dim=-1) * (float(num) / float(n))
    assert torch.equal(L.resample(y, orig_sr=n, target_sr=num, res_type="fft"), want)
    n_pad = scipy.fft.next_fast_len(2 * n - 1, real=True)
    spec = torch.fft.rfft(y, n=n_pad, dim=-1)
    want_ac = torch.fft.irfft(spec.real.square() + spec.imag.square(), n=n_pad, dim=-1)[..., :n]
    assert torch.equal(L.autocorrelate(y), want_ac)
