"""The port's bandwidth, contrast, flatness, polynomial fits and tonnetz against the JAX package.

The same seeded input (noise over a tone, n_fft 512, 1 s at 22050 Hz; two
channels where stated) goes through both packages on the CPU. Floors, each
below the value measured on these inputs (SNR over the whole output):

- ``spectral_bandwidth``: 120 dB (137.0-145.2 measured: a normalised
  weighted sum of float32 terms, summed in another order);
- ``spectral_contrast``: 120 dB in dB (141.1-141.3 measured); 130 dB
  linear (measured equal: the same sort, means of the same bins);
- ``spectral_flatness``: 115 dB (128.3 from ``y``, 139.9 from ``S``): exp
  of a mean of logs;
- ``poly_features``: 1-d ``freq`` 110 dB (126.6-133.4; the float64
  pseudo-inverse applied as one float32 product); 2-d ``freq`` 120 dB
  (135.3-146.3): both sides solve each frame in float32 from an SVD of a
  Vandermonde matrix, here over the bins up to 2 kHz at orders 0 and 1.
  Over the full band the matrix's condition number reaches ~1e8 at order
  2 and both float32 sides are poor, so that case is not compared;
- ``tonnetz``: 120 dB from a chromagram (135.6) and from ``y`` (136.9,
  through both packages' constant-Q transforms).
"""

import numpy as np
import pytest
import torch

import librosa_tpu as lt

import librosa_tpu_torch as L

SR = 22050
N_FFT = 512
HOP = 128


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


def _signal(channels=1, seed=0, n=SR):
    rng = np.random.RandomState(seed)
    tone = np.sin(2 * np.pi * 440 * np.arange(n) / SR)
    y = 0.1 * rng.randn(channels, n) + 0.5 * tone
    return (y[0] if channels == 1 else y).astype(np.float32)


@pytest.fixture(scope="module")
def spec():
    S = np.abs(np.asarray(lt.stft(_signal(2), n_fft=N_FFT, hop_length=HOP)))
    return S.astype(np.float32)


@pytest.mark.parametrize("kw", [dict(p=1), dict(p=2), dict(p=3), dict(norm=False),
                                dict(centroid="given"), dict(freq="2d")],
                         ids=["p1", "p2", "p3", "unnormed", "centroid", "freq2d"])
def test_spectral_bandwidth(spec, kw):
    kw = dict(kw)
    if kw.get("centroid") == "given":
        kw["centroid"] = np.asarray(lt.feature.spectral_centroid(S=spec, sr=SR)) * 1.01
    if kw.get("freq") == "2d":
        freqs = lt.fft_frequencies(sr=SR, n_fft=N_FFT)
        kw["freq"] = (freqs[:, None] * (1 + 0.001 * np.arange(spec.shape[-1]))[None]).astype(
            np.float32)
    got = L.feature.spectral_bandwidth(S=torch.from_numpy(spec), sr=SR, **kw)
    want = lt.feature.spectral_bandwidth(S=spec, sr=SR, **kw)
    assert _snr(got, want) > 120


def test_spectral_bandwidth_from_y():
    y = _signal()
    got = L.feature.spectral_bandwidth(y=y, sr=SR, n_fft=N_FFT, hop_length=HOP)
    want = lt.feature.spectral_bandwidth(y=y, sr=SR, n_fft=N_FFT, hop_length=HOP)
    assert _snr(got, want) > 120


@pytest.mark.parametrize("kw", [dict(), dict(linear=True), dict(quantile=0.1),
                                dict(fmin=100.0, n_bands=5), dict(n_bands=3)],
                         ids=["default", "linear", "quantile", "fmin", "bands"])
def test_spectral_contrast(spec, kw):
    got = L.feature.spectral_contrast(S=torch.from_numpy(spec), sr=SR, **kw)
    want = lt.feature.spectral_contrast(S=spec, sr=SR, **kw)
    assert got.shape == want.shape == spec.shape[:1] + (kw.get("n_bands", 6) + 1,) + spec.shape[-1:]
    assert _snr(got, want) > (130 if kw.get("linear") else 120)


def test_spectral_contrast_refuses_what_the_jax_package_refuses(spec):
    for kw in (dict(quantile=1.0), dict(fmin=0.0), dict(n_bands=0), dict(fmin=2000.0),
               dict(freq=np.arange(5))):
        with pytest.raises(lt.util.ParameterError):
            lt.feature.spectral_contrast(S=spec, sr=SR, **kw)
        with pytest.raises(L.ParameterError):
            L.feature.spectral_contrast(S=torch.from_numpy(spec), sr=SR, **kw)


@pytest.mark.parametrize("source", ["S", "y"])
def test_spectral_flatness(spec, source):
    if source == "S":
        got = L.feature.spectral_flatness(S=torch.from_numpy(spec), power=1.0)
        want = lt.feature.spectral_flatness(S=spec, power=1.0)
    else:
        y = _signal()
        got = L.feature.spectral_flatness(y=y, n_fft=N_FFT, hop_length=HOP)
        want = lt.feature.spectral_flatness(y=y, n_fft=N_FFT, hop_length=HOP)
    assert _snr(got, want) > 115


@pytest.mark.parametrize("order", [0, 1, 2])
def test_poly_features(spec, order):
    got = L.feature.poly_features(S=torch.from_numpy(spec), sr=SR, order=order)
    want = lt.feature.poly_features(S=spec, sr=SR, order=order)
    assert got.shape == want.shape
    assert _snr(got, want) > 110


@pytest.mark.parametrize("order", [0, 1])
def test_poly_features_with_frequencies_per_frame(spec, order):
    S = spec[:, :48, :20]  # the bins up to 2 kHz
    freqs = lt.fft_frequencies(sr=SR, n_fft=N_FFT)[:48]
    freq = (freqs[:, None] * (1 + 0.01 * np.arange(S.shape[-1]))[None]).astype(np.float32)
    got = L.feature.poly_features(S=torch.from_numpy(S), sr=SR, order=order, freq=freq)
    want = lt.feature.poly_features(S=S, sr=SR, order=order, freq=freq)
    assert got.shape == want.shape == S.shape[:1] + (order + 1,) + S.shape[-1:]
    assert _snr(got, want) > 120


def test_tonnetz_from_chroma():
    chroma = np.asarray(lt.feature.chroma_stft(y=_signal(2), sr=SR, n_fft=N_FFT, hop_length=HOP,
                                               tuning=0.0))
    got = L.feature.tonnetz(chroma=torch.from_numpy(chroma.copy()))
    want = lt.feature.tonnetz(chroma=chroma)
    assert got.shape == want.shape == chroma.shape[:1] + (6,) + chroma.shape[-1:]
    assert _snr(got, want) > 120


def test_tonnetz_from_y():
    y = _signal(n=SR // 2)
    got = L.feature.tonnetz(y=y, sr=SR, tuning=0.0, n_octaves=5, fmin=65.4)
    want = lt.feature.tonnetz(y=y, sr=SR, tuning=0.0, n_octaves=5, fmin=65.4)
    assert _snr(got, want) > 120
    with pytest.raises(L.ParameterError):
        L.feature.tonnetz()
