"""The port's rhythm features and harmonic interpolation against the JAX package on the CPU.

Tolerances: 110 dB on tempograms (the ``rhythm`` golden's floor; framing,
window and FFT autocorrelation are float32 in both), tempo as the same BPM
(both take the argmax of the same prior-weighted tempogram), 100 dB on
``tempogram_ratio`` and ``metrogram`` (a linear blend at a bin picked by a
float32 search: a frequency that lands on a bin edge in one package and
beside it in the other moves one sample, so not bit-stable) and 110 dB on
the harmonic interpolations of smooth spectra.
"""

import numpy as np
import pytest
import scipy.stats
import torch

import librosa_tpu as lt

import librosa_tpu_torch as L

SR = 22050
TG_SNR_DB = 110.0
RATIO_SNR_DB = 100.0
HARM_SNR_DB = 110.0


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _snr(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    num = np.sum(np.abs(want.astype(np.complex128)) ** 2)
    den = np.sum(np.abs(got.astype(np.complex128) - want) ** 2)
    return 10 * np.log10(num / max(den, 1e-30))


def _pulse_env(n=600, period=22, channels=2, seed=0):
    rng = np.random.RandomState(seed)
    env = 0.1 * np.abs(rng.randn(channels, n))
    for c in range(channels):
        env[c, (3 * c)::period + c] += 1.0
    return env.astype(np.float32)


@pytest.mark.parametrize("kw", [{}, {"win_length": 128, "norm": None},
                                {"center": False, "window": "hamming", "norm": 2}],
                         ids=["default", "short", "uncentred"])
def test_tempograms_match_jax(kw):
    env = _pulse_env()
    got = L.feature.tempogram(onset_envelope=env, sr=SR, **kw)
    assert _snr(got.numpy(), lt.feature.tempogram(onset_envelope=env, sr=SR, **kw)) >= TG_SNR_DB
    kw.pop("norm", None)
    got = L.feature.fourier_tempogram(onset_envelope=env, sr=SR, **kw)
    want = lt.feature.fourier_tempogram(onset_envelope=env, sr=SR, **kw)
    assert _snr(got.numpy(), want) >= TG_SNR_DB


def test_tempogram_from_y_matches_jax():
    y = np.random.RandomState(1).randn(SR).astype(np.float32) * 0.1
    y[::5000] += 1.0
    got = L.feature.tempogram(y=y, sr=SR, win_length=64)
    assert _snr(got.numpy(), lt.feature.tempogram(y=y, sr=SR, win_length=64)) >= TG_SNR_DB


@pytest.mark.parametrize("kw", [
    {},
    {"start_bpm": 90, "std_bpm": 0.5},
    {"aggregate": None},
    {"aggregate": np.median, "max_tempo": None},
    {"prior": scipy.stats.uniform(30, 300)},
    {"ac_size": 4.0, "hop_length": 256},
], ids=["default", "start90", "per_frame", "median", "prior", "ac_size"])
def test_tempo_matches_jax(kw):
    env = _pulse_env()
    got = L.feature.tempo(onset_envelope=env, sr=SR, **kw)
    want = lt.feature.tempo(onset_envelope=env, sr=SR, **kw)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_tempo_from_a_tempogram_matches_jax():
    env = _pulse_env(channels=1)[0]
    tg = np.asarray(lt.feature.tempogram(onset_envelope=env, sr=SR))
    for agg in (np.mean, None):
        np.testing.assert_array_equal(L.feature.tempo(tg=torch.from_numpy(tg), sr=SR,
                                                      aggregate=agg),
                                      lt.feature.tempo(tg=tg, sr=SR, aggregate=agg))
    with pytest.raises(L.ParameterError):
        L.feature.tempo(onset_envelope=env, start_bpm=0)


@pytest.mark.parametrize("kw", [{}, {"bpm": 120.0, "kind": "nearest"},
                                {"aggregate": np.mean, "factors": np.array([1, 2, 0.5])}],
                         ids=["default", "fixed_bpm", "aggregated"])
def test_tempogram_ratio_matches_jax(kw):
    env = _pulse_env()
    got = L.feature.tempogram_ratio(onset_envelope=env, sr=SR, **kw)
    want = lt.feature.tempogram_ratio(onset_envelope=env, sr=SR, **kw)
    assert _snr(np.nan_to_num(got.numpy()), np.nan_to_num(np.asarray(want))) >= RATIO_SNR_DB


def test_hybrid_tempogram_and_metrogram_match_jax():
    env = _pulse_env()
    got = L.feature.hybrid_tempogram(onset_envelope=env, sr=SR)
    want = lt.feature.hybrid_tempogram(onset_envelope=env, sr=SR)
    assert _snr(got.numpy(), want) >= TG_SNR_DB
    # ascending BPM: the Fourier tempogram's grid (on the lag grid, descending from an infinite
    # first bin, every sample falls outside and both packages give zeros)
    tg = np.abs(np.asarray(lt.feature.fourier_tempogram(onset_envelope=env, sr=SR)))
    freqs = L.fourier_tempo_frequencies(sr=SR)
    for kw in ({}, {"aggregate": None}, {"factors": np.array([0.5, 0.25]), "kind": "nearest"},
               {"aggregate": np.max}):
        got = L.feature.metrogram(tg=tg, freqs=freqs, **kw)
        want = lt.feature.metrogram(tg=tg, freqs=freqs, **kw)
        assert _snr(got.numpy(), want) >= RATIO_SNR_DB, sorted(kw)


# ---------------------------------------------------------------------------
# harmonics
# ---------------------------------------------------------------------------


def _spectrum(n_bins=257, frames=20, seed=2):
    rng = np.random.RandomState(seed)
    freqs = np.linspace(0, SR / 2, n_bins)
    S = np.abs(np.sin(np.outer(freqs / 300.0, 1 + 0.05 * np.arange(frames)))
               + 0.1 * rng.rand(n_bins, frames)).astype(np.float32)
    return S, freqs


@pytest.mark.parametrize("kind", ["linear", "nearest", "cubic"])
def test_interp_harmonics_matches_jax(kind):
    S, freqs = _spectrum()
    S2 = np.stack([S, S[::-1]])
    got = L.interp_harmonics(S2, freqs=freqs, harmonics=[0.5, 1, 2, 3], kind=kind)
    want = lt.interp_harmonics(S2, freqs=freqs, harmonics=[0.5, 1, 2, 3], kind=kind)
    assert got.shape == (2, 4, 257, 20)
    assert _snr(got.numpy(), want) >= HARM_SNR_DB
    if kind != "cubic":
        warped = freqs[:, None] * (1 + 0.01 * np.sin(np.linspace(0, 3, 20)))[None, :]
        got = L.interp_harmonics(S, freqs=warped, harmonics=[1, 2], kind=kind, fill_value=-1)
        want = lt.interp_harmonics(S, freqs=warped, harmonics=[1, 2], kind=kind, fill_value=-1)
        assert _snr(got.numpy(), want) >= HARM_SNR_DB


@pytest.mark.parametrize("kw", [{}, {"weights": [1.0, 0.5, 0.25], "fill_value": 0.0},
                                {"filter_peaks": False, "kind": "nearest"},
                                {"aggregate": np.max, "fill_value": 0.0}],
                         ids=["default", "weights", "no_filter", "max"])
def test_salience_matches_jax(kw):
    S, freqs = _spectrum(seed=3)
    got = L.salience(S, freqs=freqs, harmonics=[1, 2, 3], **kw)
    want = lt.salience(S, freqs=freqs, harmonics=[1, 2, 3], **kw)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
    assert _snr(np.nan_to_num(got.numpy()), np.nan_to_num(np.asarray(want))) >= HARM_SNR_DB


def test_f0_harmonics_matches_jax():
    S, freqs = _spectrum(seed=4)
    f0 = 200.0 + 10.0 * np.arange(20)
    freqs_inf = freqs.copy()
    freqs_inf[0] = np.inf
    for fr in (freqs, freqs_inf):
        for kind in ("linear", "nearest"):
            got = L.f0_harmonics(S, f0=f0, freqs=fr, harmonics=[1, 2, 3.5], kind=kind)
            want = lt.f0_harmonics(S, f0=f0, freqs=fr, harmonics=[1, 2, 3.5], kind=kind)
            assert _snr(got.numpy(), want) >= HARM_SNR_DB
    warped = freqs[:, None] * (1 + 0.01 * np.cos(np.linspace(0, 3, 20)))[None, :]
    got = L.f0_harmonics(np.stack([S, S]), f0=f0, freqs=np.stack([warped, warped]),
                         harmonics=[1, 2])
    want = lt.f0_harmonics(np.stack([S, S]), f0=f0, freqs=np.stack([warped, warped]),
                           harmonics=[1, 2])
    assert _snr(got.numpy(), want) >= HARM_SNR_DB
    with pytest.raises(L.ParameterError):
        L.f0_harmonics(S, f0=f0, freqs=freqs, harmonics=[1], kind="cubic")
    with pytest.raises(L.ParameterError):
        L.f0_harmonics(S, f0=f0, freqs=freqs[:-1], harmonics=[1])
