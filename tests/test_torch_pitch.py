"""The port's peak tracking and tuning estimate against the JAX package on the CPU.

Tolerances: 120 dB on ``piptrack``'s two outputs (the goldens' floor), the
tuning as the same float (both pick a cell of the same histogram), 110 dB on
``chroma_stft`` with the estimated tuning.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import librosa_tpu as lt

import librosa_tpu_torch as L
from librosa_tpu_torch.core import pitch as port_pitch

SR = 22050
PIP_SNR_DB = 120.0
CHROMA_SNR_DB = 110.0


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _snr(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return 10 * np.log10(np.sum(want**2) / max(np.sum((got - want) ** 2), 1e-30))


def _tone(freq, n=SR, harmonics=3, seed=0):
    t = np.arange(n) / SR
    y = sum(np.sin(2 * np.pi * freq * (k + 1) * t) / (k + 1) for k in range(harmonics))
    return (0.5 * y + 0.001 * np.random.RandomState(seed).randn(n)).astype(np.float32)


def _chirp(n=2 * SR):
    t = np.arange(n) / SR
    return np.sin(2 * np.pi * (110.0 + 900.0 * t) * t).astype(np.float32)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def test_parabolic_interpolation_matches_jax():
    from librosa_tpu.core.pitch import _parabolic_interpolation as jax_pi

    x = np.abs(np.random.RandomState(1).randn(2, 40, 9)).astype(np.float32)
    x[0, 5:8, 2] = 1.0  # a plateau: a == 0
    for axis in (-2, -1):
        got = port_pitch._parabolic_interpolation(torch.from_numpy(x), axis=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_pi(x, axis=axis)), rtol=1e-6,
                                   atol=1e-7)


def test_torch_gradient_has_numpys_edges():
    x = np.random.RandomState(2).randn(3, 17, 5)
    got = torch.gradient(torch.from_numpy(x), dim=-2)[0]
    np.testing.assert_allclose(got.numpy(), np.gradient(x, axis=-2), rtol=1e-12, atol=0)


@pytest.mark.parametrize("axis", [0, -1, 1])
def test_localmax_localmin_match_jax(axis):
    x = np.random.RandomState(3).randint(0, 4, size=(6, 7, 8)).astype(np.float32)
    for name in ("localmax", "localmin"):
        got = getattr(L.util, name)(x, axis=axis)
        want = np.asarray(getattr(lt.util, name)(x, axis=axis))
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


def test_small_util_helpers_match_jax():
    assert L.util.dtype_r2c(np.float32) == torch.complex64
    assert L.util.dtype_r2c(torch.float64) == torch.complex128
    assert L.util.dtype_r2c(torch.complex64) == torch.complex64
    assert L.util.dtype_r2c(np.int16) == torch.complex64
    assert L.util.dtype_c2r(np.complex128) == torch.float64
    assert L.util.dtype_c2r(torch.complex64) == torch.float32
    assert L.util.dtype_c2r(torch.float64) == torch.float64
    assert L.util.dtype_c2r(np.int16) == torch.float32
    for np_dtype in (np.float32, np.float64, np.complex64, np.complex128):
        assert np.dtype(str(L.util.dtype_r2c(np_dtype)).split(".")[1]) == lt.util.dtype_r2c(np_dtype)
        assert np.dtype(str(L.util.dtype_c2r(np_dtype)).split(".")[1]) == lt.util.dtype_c2r(np_dtype)
    z = (np.random.RandomState(4).randn(5, 6) + 1j * np.random.RandomState(5).randn(5, 6))
    z = z.astype(np.complex64)
    np.testing.assert_allclose(L.util.abs2(z).numpy(), np.asarray(lt.util.abs2(z)), rtol=1e-6)
    np.testing.assert_allclose(L.util.abs2(z.real).numpy(), np.asarray(lt.util.abs2(z.real)),
                               rtol=1e-6)
    assert L.util.abs2(z, dtype=np.float64).dtype == torch.float64
    ang = np.linspace(-4, 4, 31).astype(np.float32)
    np.testing.assert_allclose(L.util.phasor(ang).numpy(), np.asarray(lt.util.phasor(ang)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(L.util.phasor(ang, mag=2.0).numpy(),
                               np.asarray(lt.util.phasor(ang, mag=2.0)), rtol=1e-6, atol=1e-7)


def test_hz_octs_round_trip_matches_jax():
    f = np.linspace(20.0, 10000.0, 57)
    np.testing.assert_allclose(L.hz_to_octs(f), lt.hz_to_octs(f), rtol=1e-12)
    np.testing.assert_allclose(L.hz_to_octs(f, tuning=0.3, bins_per_octave=24),
                               lt.hz_to_octs(f, tuning=0.3, bins_per_octave=24), rtol=1e-12)
    o = np.linspace(0, 8, 33)
    np.testing.assert_allclose(L.octs_to_hz(o), lt.octs_to_hz(o), rtol=1e-12)
    np.testing.assert_allclose(L.octs_to_hz(L.hz_to_octs(f, tuning=-0.2), tuning=-0.2), f,
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# piptrack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(threshold=0.5), dict(fmin=500, fmax=3000, n_fft=1024),
     dict(ref=0.3), dict(ref=np.max), dict(ref=np.mean), dict(hop_length=256, center=False)],
    ids=["defaults", "threshold", "band_1024", "scalar_ref", "np_max", "np_mean", "uncentered"],
)
def test_piptrack_from_audio_matches_jax(kw):
    y = _chirp()
    p, m = L.piptrack(y=y, sr=SR, **kw)
    jp, jm = lt.piptrack(y=y, sr=SR, **kw)
    assert isinstance(p, torch.Tensor) and p.dtype == torch.float32
    assert tuple(p.shape) == tuple(m.shape) == np.asarray(jp).shape
    assert _snr(p, jp) >= PIP_SNR_DB
    assert _snr(m, jm) >= PIP_SNR_DB


def test_piptrack_callable_ref_runs_where_the_spectrogram_lies():
    from librosa_tpu_torch.core import pitch as port_pitch

    S = torch.from_numpy(np.abs(np.asarray(lt.stft(_chirp()))))
    host = port_pitch._frame_reference(S, np.mean)
    assert tuple(host.shape) == (1, S.shape[-1])
    # a torch reduction gives the same level, and one with indices gives its values
    torch.testing.assert_close(host, torch.mean(S, dim=-2, keepdim=True), rtol=1e-5, atol=0)
    # off the CPU the callable gets the tensor (dim=-2), a numpy reduction that numpy hands to
    # the array's own method runs as torch's, any other numpy function raises: no host copy
    away = S.to("meta")
    assert port_pitch._frame_reference(away, torch.mean).shape == (1, S.shape[-1])
    assert port_pitch._frame_reference(away, torch.median).shape == (1, S.shape[-1])
    assert port_pitch._frame_reference(away, torch.mean).device.type == "meta"
    assert port_pitch._frame_reference(away, np.mean).device.type == "meta"
    with pytest.raises(L.ParameterError, match="numpy function"):
        port_pitch._frame_reference(away, np.median)


REDUCTIONS = [np.mean, np.sum, np.std, np.var, np.min, np.amin, np.max, np.amax, np.prod]


@pytest.mark.parametrize("ref", REDUCTIONS, ids=[f.__name__ for f in REDUCTIONS])
def test_device_reference_of_numpy_reductions_matches_jax(ref):
    # the card's branch, run here on a CPU tensor: the reduction by torch, as JAX runs it
    S = np.abs(np.asarray(lt.stft(_chirp(n=SR // 2), n_fft=512))).astype(np.float32)
    if ref is np.prod:
        S = 1.0 + 0.01 * S / S.max()  # a product over the bins that neither under- nor overflows
    got = port_pitch._device_frame_reference(torch.from_numpy(S), ref)
    want = np.expand_dims(np.asarray(ref(jnp.asarray(S), axis=-2)), -2)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("ref", [np.mean, np.sum], ids=["np_mean", "np_sum"])
def test_piptrack_on_the_cards_branch_matches_jax(monkeypatch, ref):
    S = np.abs(np.asarray(lt.stft(_chirp()))).astype(np.float32)
    jp, jm = lt.piptrack(S=S, sr=SR, ref=ref)
    monkeypatch.setattr(port_pitch, "_frame_reference", port_pitch._device_frame_reference)
    monkeypatch.setattr(torch.Tensor, "numpy", lambda *a, **k: pytest.fail("host copy"))
    p, m = L.piptrack(S=torch.from_numpy(S), sr=SR, ref=ref)
    monkeypatch.undo()
    assert _snr(p, jp) >= PIP_SNR_DB and _snr(m, jm) >= PIP_SNR_DB
    # np.median: the JAX function cannot trace it, and the card's branch refuses it
    with pytest.raises(Exception):
        lt.piptrack(S=S, sr=SR, ref=np.median)
    monkeypatch.setattr(port_pitch, "_frame_reference", port_pitch._device_frame_reference)
    with pytest.raises(L.ParameterError, match="numpy function"):
        L.piptrack(S=torch.from_numpy(S), sr=SR, ref=np.median)


def test_piptrack_from_spectrogram_and_stereo():
    y = np.stack([_tone(440.0), _tone(330.0, seed=1)])
    S = np.abs(np.asarray(lt.stft(y)))
    p, m = L.piptrack(S=S, sr=SR)
    jp, jm = lt.piptrack(S=S, sr=SR)
    assert tuple(p.shape) == (2, 1025, S.shape[-1])
    assert _snr(p, jp) >= PIP_SNR_DB and _snr(m, jm) >= PIP_SNR_DB
    # from audio, stereo; each channel alone gives the same peaks
    p2, m2 = L.piptrack(y=y, sr=SR)
    jp2, jm2 = lt.piptrack(y=y, sr=SR)
    assert _snr(p2, jp2) >= PIP_SNR_DB and _snr(m2, jm2) >= PIP_SNR_DB
    p1, _ = L.piptrack(y=y[1], sr=SR)
    assert torch.equal(p2[1], p1)
    # the median pitch of the strong peaks is the tone
    strong = p2[0][m2[0] > 0.5 * m2[0].max()]
    assert abs(float(strong.median()) - 440.0) < 2.0


def test_piptrack_complex_and_negative_input():
    D = np.asarray(lt.stft(_tone(440.0, n=8000)))
    p, m = L.piptrack(S=D, sr=SR)
    jp, jm = lt.piptrack(S=D, sr=SR)
    assert _snr(p, jp) >= PIP_SNR_DB and _snr(m, jm) >= PIP_SNR_DB
    pn, mn = L.piptrack(S=-np.abs(D), sr=SR)
    assert torch.equal(pn, L.piptrack(S=np.abs(D), sr=SR)[0])


# ---------------------------------------------------------------------------
# pitch_tuning, estimate_tuning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(resolution=0.05), dict(bins_per_octave=24),
                                dict(resolution=0.003, bins_per_octave=36)],
                         ids=["defaults", "coarse", "quarter_tones", "fine_36"])
def test_pitch_tuning_matches_jax(kw):
    rng = np.random.RandomState(6)
    freqs = 440.0 * 2.0 ** ((rng.randint(-24, 24, size=200) + 0.13 + 0.02 * rng.randn(200)) / 12)
    freqs[::7] = 0.0     # ignored
    freqs[::11] = -5.0   # ignored
    for arr in (freqs, freqs.astype(np.float32), list(freqs), torch.from_numpy(freqs)):
        assert L.pitch_tuning(arr, **kw) == lt.pitch_tuning(np.asarray(arr), **kw)
    # 0.13 lies on a cell's edge and float64 puts it a hair below: the golden's value is 0.12
    assert L.pitch_tuning(440.0 * 2 ** (0.13 / 12) * np.ones(50)) == pytest.approx(0.12)


def test_pitch_tuning_empty_warns_and_returns_zero():
    for arr in ([], np.zeros(5), [-1.0, 0.0]):
        with pytest.warns(UserWarning, match="no positive frequencies"):
            assert L.pitch_tuning(arr) == 0.0


@pytest.mark.parametrize("freq", [440.0, 443.0, 452.0])
def test_estimate_tuning_on_tones_matches_jax(freq):
    y = _tone(freq)
    got = L.estimate_tuning(y=y, sr=SR)
    want = lt.estimate_tuning(y=y, sr=SR)
    assert isinstance(got, float) and got == want
    # 443 Hz is 0.12 semitones sharp, 452 Hz 0.47
    assert got == pytest.approx(12 * np.log2(freq / 440.0), abs=0.03)
    S = np.abs(np.asarray(lt.stft(y, n_fft=1024)))
    assert (L.estimate_tuning(S=S, sr=SR, n_fft=1024, bins_per_octave=24, resolution=0.02)
            == lt.estimate_tuning(S=S, sr=SR, n_fft=1024, bins_per_octave=24, resolution=0.02))


@pytest.mark.parametrize("n_peaks", [6, 7], ids=["even", "odd"])
def test_estimate_tuning_median_of_even_and_odd_counts(n_peaks):
    """One frame with ``n_peaks`` isolated peaks of distinct heights.

    With an even count numpy's median is the mean of the two middle heights,
    which keeps the upper half; ``torch.median`` would return the lower middle
    and keep one peak more.
    """
    bin_hz = SR / 2048
    bins = 40 + 25 * np.arange(n_peaks)
    assert bins.max() * bin_hz < 4000
    S = np.full((1025, 1), 1e-3, dtype=np.float32)
    heights = 1.0 + np.arange(n_peaks, dtype=np.float32)
    # each peak a little off its bin, by an amount that grows with its height
    for b, h in zip(bins, heights):
        skew = 0.04 * h
        S[b - 1, 0], S[b, 0], S[b + 1, 0] = h * (0.5 - skew), h, h * (0.5 + skew)
    got = L.estimate_tuning(S=S, sr=SR, threshold=0.01)
    want = lt.estimate_tuning(S=S, sr=SR, threshold=0.01)
    assert got == want
    pitch, mag = L.piptrack(S=S, sr=SR, threshold=0.01)
    voiced = mag[pitch > 0].numpy()
    assert len(voiced) == n_peaks
    kept = int((voiced >= np.median(voiced)).sum())
    assert kept == (n_peaks + 1) // 2


def test_estimate_tuning_silence_warns():
    with pytest.warns(UserWarning, match="no positive frequencies"):
        assert L.estimate_tuning(S=np.zeros((1025, 4), dtype=np.float32), sr=SR) == 0.0


# ---------------------------------------------------------------------------
# chroma_stft with the default tuning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("freq", [440.0, 452.0])
def test_chroma_stft_default_tuning_matches_jax(freq):
    y = np.stack([_tone(freq), _tone(freq * 1.5, seed=1)])
    got = L.feature.chroma_stft(y=y, sr=SR)
    want = np.asarray(lt.feature.chroma_stft(y=y, sr=SR))
    assert tuple(got.shape) == want.shape == (2, 12, 44)
    assert _snr(got, want) >= CHROMA_SNR_DB
    # it is the chroma at the tuning the port estimates from the power spectrogram
    S = np.abs(np.asarray(lt.stft(y))) ** 2
    tuning = L.estimate_tuning(S=S, sr=SR, bins_per_octave=12)
    fixed = L.feature.chroma_stft(y=y, sr=SR, tuning=tuning)
    assert _snr(got, fixed) >= CHROMA_SNR_DB


def test_chroma_stft_default_tuning_from_spectrogram_and_n_chroma():
    y = _tone(446.0)
    S = np.abs(np.asarray(lt.stft(y, n_fft=1024))) ** 2
    got = L.feature.chroma_stft(S=S, sr=SR, n_chroma=24)
    want = np.asarray(lt.feature.chroma_stft(S=S, sr=SR, n_chroma=24))
    assert tuple(got.shape) == want.shape == (24, S.shape[-1])
    assert _snr(got, want) >= CHROMA_SNR_DB
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a tone has peaks: nothing warns
        L.feature.chroma_stft(y=y, sr=SR)
