"""The port's NNLS and feature inversions against the JAX package on the CPU.

Seeded input: two channels of noise over a tone, 0.5 s at 22050 Hz, n_fft
512, hop 128, 32 mel bands (a 32 x 257 basis) unless stated. Both packages
run the same FISTA from the same pseudo-inverse start; where the basis has
a null space (rank 32 of 257 columns) the iterates keep their start's
rounding there, so solutions are compared by what they fit, not elementwise
at float precision. Floors, each below the value measured:

- ``nnls``: the fit ``A x`` 115 dB against the JAX package's (121.0-141.7
  measured), ``x`` itself 60 dB (66.0-90.7), the objective
  ``||A x - B|| / ||B||`` within 1.25 times the JAX package's plus 1e-7
  (measured 2.3e-6 against 2.1e-6, and 7.0e-8 against 1.9e-8 for one
  column), and ``x >= 0``;
- ``mel_to_stft``: the mel projection of ``S**2`` 110 dB (123.4), ``S`` 60
  dB (67.4: the square root lifts the near-zero bins' differences);
- ``mfcc_to_mel``: 120 dB (129.4, with and without a lifter);
- ``mel_to_audio``, ``mfcc_to_audio``: the random phases come from another
  generator than ``jax.random`` (the same seed gives other draws), so the
  output is held by its shape, by the seed's determinism, and by its
  spectral convergence ``|| |STFT(y)| - S || / ||S||`` after 16 rounds: at
  most the JAX package's plus 0.05 (measured 0.172 against 0.184 and 0.178
  against 0.183).
"""

import numpy as np
import pytest
import torch

import librosa_tpu as lt

import librosa_tpu_torch as L
from torch_threads import one_torch_thread  # noqa: F401 (autouse, one intra-op thread)

SR = 22050
FFT = dict(n_fft=512, hop_length=128)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _snr(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got.astype(np.float64), np.asarray(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return 10 * np.log10(np.sum(want**2) / max(np.sum((got - want) ** 2), 1e-300))


@pytest.fixture(scope="module")
def signal():
    rng = np.random.RandomState(0)
    n = SR // 2
    return (0.1 * rng.randn(2, n) + 0.5 * np.sin(2 * np.pi * 440 * np.arange(n) / SR)).astype(
        np.float32)


@pytest.fixture(scope="module")
def mel(signal):
    return np.asarray(lt.feature.melspectrogram(y=signal, sr=SR, n_mels=32, **FFT))


def _fit(A, x):
    """``A @ x`` over the last two axes, ``x`` of one column as a column."""
    x = np.asarray(x, dtype=np.float64)
    return np.einsum("mn,...nk->...mk", np.asarray(A, np.float64), x[..., None] if x.ndim == 1 else x)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_nnls(mel, rank):
    A = lt.filters.mel(sr=SR, n_fft=FFT["n_fft"], n_mels=32)
    B = {1: mel[0, :, 0], 2: mel[0], 3: mel}[rank]
    got = L.util.nnls(A, torch.from_numpy(B.copy()))
    want = np.asarray(lt.util.nnls(A, B))
    assert got.shape == want.shape and bool((got >= 0).all())
    Bc = B[..., None] if B.ndim == 1 else B

    def objective(x):
        return np.linalg.norm(_fit(A, x) - Bc) / np.linalg.norm(Bc)

    assert _snr(_fit(A, got.numpy()), _fit(A, want)) > 115
    assert _snr(got, want) > 60
    assert objective(got.numpy()) <= 1.25 * objective(want) + 1e-7


def test_nnls_refuses_a_basis_that_is_not_a_matrix():
    with pytest.raises(L.ParameterError):
        L.util.nnls(np.ones(3), np.ones(3))


def test_mel_to_stft(mel):
    A = lt.filters.mel(sr=SR, n_fft=FFT["n_fft"], n_mels=32)
    got = L.feature.inverse.mel_to_stft(torch.from_numpy(mel.copy()), sr=SR, n_fft=FFT["n_fft"], n_mels=32)
    want = np.asarray(lt.feature.inverse.mel_to_stft(mel, sr=SR, n_fft=FFT["n_fft"], n_mels=32))
    assert got.shape == want.shape == (2, 257, mel.shape[-1])
    assert _snr(_fit(A, got.numpy() ** 2), _fit(A, want**2)) > 110
    assert _snr(got, want) > 60


@pytest.mark.parametrize("lifter", [0, 22])
def test_mfcc_to_mel(signal, lifter):
    m = np.asarray(lt.feature.mfcc(y=signal, sr=SR, n_mels=32, n_mfcc=20, lifter=lifter, **FFT))
    got = L.feature.inverse.mfcc_to_mel(torch.from_numpy(m.copy()), n_mels=32, lifter=lifter)
    want = lt.feature.inverse.mfcc_to_mel(m, n_mels=32, lifter=lifter)
    assert got.shape == want.shape == (2, 32, m.shape[-1])
    assert _snr(got, want) > 120
    with pytest.raises(L.ParameterError):
        L.feature.inverse.mfcc_to_mel(m, lifter=-1)


def _convergence(y, S):
    X = np.abs(np.asarray(lt.stft(np.asarray(y), **FFT)))
    return np.linalg.norm(X - S) / np.linalg.norm(S)


def test_mel_to_audio(mel):
    kw = dict(sr=SR, n_iter=16, length=SR // 2, n_mels=32, **FFT)
    got = L.feature.inverse.mel_to_audio(torch.from_numpy(mel.copy()), **kw)
    want = np.asarray(lt.feature.inverse.mel_to_audio(mel, **kw))
    assert got.shape == want.shape == (2, SR // 2)
    assert torch.equal(got, L.feature.inverse.mel_to_audio(torch.from_numpy(mel.copy()), **kw))
    S = np.asarray(lt.feature.inverse.mel_to_stft(mel, sr=SR, n_fft=FFT["n_fft"], n_mels=32))
    assert _convergence(got.numpy(), S) <= _convergence(want, S) + 0.05


def test_mfcc_to_audio(signal):
    m = np.asarray(lt.feature.mfcc(y=signal, sr=SR, n_mfcc=20, **FFT))
    kw = dict(sr=SR, n_iter=16, **FFT)
    got = L.feature.inverse.mfcc_to_audio(torch.from_numpy(m.copy()), **kw)
    want = np.asarray(lt.feature.inverse.mfcc_to_audio(m, **kw))
    assert got.shape == want.shape
    S = np.asarray(lt.feature.inverse.mel_to_stft(lt.feature.inverse.mfcc_to_mel(m), sr=SR,
                                                  n_fft=FFT["n_fft"]))
    assert _convergence(got.numpy(), S) <= _convergence(want, S) + 0.05


def test_mel_to_stft_takes_n_mels_from_its_arguments_as_the_jax_package(mel):
    """Both packages build the basis with ``filters.mel``'s default 128 bands unless ``n_mels``
    is passed, so a 32-band spectrogram without it fails in both (upstream takes the count from
    ``M``); ``mfcc_to_audio`` passes no ``n_mels`` on, so it works only at 128 in both."""
    with pytest.raises(RuntimeError):
        L.feature.inverse.mel_to_stft(torch.from_numpy(mel.copy()), sr=SR, n_fft=FFT["n_fft"])
    with pytest.raises(TypeError):
        lt.feature.inverse.mel_to_stft(mel, sr=SR, n_fft=FFT["n_fft"])
