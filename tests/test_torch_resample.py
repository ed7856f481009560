"""The port's resamplers and signal generators against the JAX package on the CPU.

Tolerances: 110 dB for the polyphase and Fourier resamplers (a float32 matrix
product or FFT on both sides), 100 dB for the interpolators (gathers and a
float32 windowed sinc), bit-equal for the ``soxr_*`` qualities where libsoxr
loads (the same library call on both sides), 120 dB for the generators (the
goldens' floor).
"""

import warnings

import numpy as np
import pytest
import scipy.signal
import torch

import librosa_tpu as lt
from librosa_tpu.io import _soxr as jax_soxr

import librosa_tpu_torch as L
from librosa_tpu_torch.core import audio as port_audio
from librosa_tpu_torch.io import _soxr

SR = 22050
POLY_SNR_DB = 110.0
INTERP_SNR_DB = 100.0


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


def _signal(*shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(np.float32)


TARGETS = [16000, 11025, 44100]


@pytest.mark.parametrize("target_sr", TARGETS)
@pytest.mark.parametrize("res_type", ["polyphase", "kaiser_best", "kaiser_fast", "fft", "scipy"])
def test_resample_polyphase_and_fft_match_jax(res_type, target_sr):
    y = _signal(2, 6000, seed=1)
    got = L.resample(y, orig_sr=SR, target_sr=target_sr, res_type=res_type)
    want = np.asarray(lt.resample(y, orig_sr=SR, target_sr=target_sr, res_type=res_type))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (2, int(np.ceil(6000 * target_sr / SR)))
    assert _snr(got, want) >= POLY_SNR_DB


@pytest.mark.parametrize("target_sr", TARGETS + [17000.5])
@pytest.mark.parametrize("res_type", ["linear", "zero_order_hold", "sinc_best", "sinc_medium",
                                      "sinc_fastest"])
def test_resample_interpolators_match_jax(res_type, target_sr):
    y = _signal(2, 5000, seed=2)
    got = L.resample(y, orig_sr=SR, target_sr=target_sr, res_type=res_type)
    want = np.asarray(lt.resample(y, orig_sr=SR, target_sr=target_sr, res_type=res_type))
    assert tuple(got.shape) == want.shape
    assert _snr(got, want) >= INTERP_SNR_DB


@pytest.mark.parametrize("res_type", ["soxr_vhq", "soxr_hq", "soxr_mq", "soxr_lq", "soxr_qq"])
def test_resample_soxr_is_bit_equal_on_the_cpu(res_type):
    if not (_soxr.available() and jax_soxr.available()):
        pytest.skip("libsoxr does not load on this system")
    y = _signal(2, 6000, seed=3)
    for target_sr in (16000, 44100):
        got = L.resample(y, orig_sr=SR, target_sr=target_sr, res_type=res_type)
        want = np.asarray(lt.resample(y, orig_sr=SR, target_sr=target_sr, res_type=res_type))
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    # a CPU tensor takes libsoxr too, whatever the default device
    L.set_device("cuda")
    got_t = L.resample(torch.from_numpy(y), orig_sr=SR, target_sr=44100, res_type=res_type)
    assert torch.equal(got_t, got)


def test_soxr_binding_matches_the_jax_packages():
    if not (_soxr.available() and jax_soxr.available()):
        pytest.skip("libsoxr does not load on this system")
    x = _signal(4000, seed=4)
    np.testing.assert_array_equal(_soxr.resample(x, SR, 16000), jax_soxr.resample(x, SR, 16000))
    with pytest.raises(ValueError):
        _soxr.resample(x, SR, 16000, quality="soxr_best")


def test_resample_without_libsoxr_falls_to_polyphase(monkeypatch):
    monkeypatch.setattr(_soxr, "available", lambda: False)
    y = _signal(4000, seed=5)
    with pytest.warns(UserWarning, match="libsoxr unavailable"):
        got = L.resample(y, orig_sr=SR, target_sr=16000, res_type="soxr_hq")
    want = L.resample(y, orig_sr=SR, target_sr=16000, res_type="polyphase")
    assert torch.equal(got, want)
    with pytest.raises(L.ParameterError, match="requires libsoxr"):
        L.resample(y, orig_sr=22050.5, target_sr=16000, res_type="soxr_hq")


def test_soxr_on_an_accelerator_tensor_takes_a_device_resampler():
    port_audio._warn_soxr_substitution.cache_clear()
    meta = torch.zeros(8, device="meta")
    with pytest.warns(UserWarning, match="device 'polyphase' resampler"):
        assert port_audio._device_res_type(meta, "soxr_hq", 22050, 16000) == "polyphase"
    with pytest.warns(UserWarning, match="device 'kaiser_best' resampler"):
        assert port_audio._device_res_type(meta, "soxr_vhq", 22050.5, 16000) == "kaiser_best"
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # once per pair; other qualities and the CPU as asked
        assert port_audio._device_res_type(meta, "soxr_hq", 22050, 16000) == "polyphase"
        assert port_audio._device_res_type(meta, "fft", 22050, 16000) == "fft"
        assert port_audio._device_res_type(torch.zeros(8), "soxr_hq", 22050, 16000) == "soxr_hq"


def test_resample_poly_matches_scipy_in_float64():
    y = _signal(3, 7000, seed=6)
    for up, down in ((320, 441), (1, 2), (2, 1), (3, 7), (640, 882)):
        got = port_audio.resample_poly(y, up, down)
        want = scipy.signal.resample_poly(y.astype(np.float64), up, down, axis=-1)
        assert tuple(got.shape) == want.shape
        assert _snr(got, want) >= POLY_SNR_DB
    assert port_audio.resample_poly(y, 5, 5).shape == y.shape
    assert port_audio.resample_poly(y, 1, 2, dtype=torch.float64).dtype == torch.float64


def test_resample_poly_float64_and_axis():
    y = _signal(5000, 2, seed=7).astype(np.float64)
    got = L.resample(y, orig_sr=SR, target_sr=16000, res_type="polyphase", axis=0)
    assert got.dtype == torch.float64 and tuple(got.shape) == (3629, 2)
    want = scipy.signal.resample_poly(y, 320, 441, axis=0)
    assert _snr(got, want) >= POLY_SNR_DB  # the filter matrix is rounded to float32


@pytest.mark.parametrize("res_type", ["polyphase", "fft", "linear", "sinc_fastest"])
def test_resample_axis_fix_and_scale_match_jax(res_type):
    y = _signal(4000, 2, seed=8)
    kw = dict(orig_sr=SR, target_sr=16000, res_type=res_type)
    got = L.resample(y, axis=0, **kw)
    want = np.asarray(lt.resample(y, axis=0, **kw))
    assert tuple(got.shape) == want.shape == (2903, 2)
    assert _snr(got, want) >= INTERP_SNR_DB
    loose = L.resample(y.T, fix=False, **kw)
    jloose = np.asarray(lt.resample(y.T, fix=False, **kw))
    assert tuple(loose.shape) == jloose.shape
    assert _snr(loose, jloose) >= INTERP_SNR_DB
    scaled = L.resample(y.T, scale=True, **kw)
    assert _snr(scaled, np.asarray(lt.resample(y.T, scale=True, **kw))) >= INTERP_SNR_DB
    np.testing.assert_allclose(scaled.numpy() * np.sqrt(16000 / SR),
                               L.resample(y.T, **kw).numpy(), rtol=1e-5, atol=1e-7)


def test_resample_same_rate_and_errors():
    y = _signal(3000, seed=9)
    same = L.resample(y, orig_sr=SR, target_sr=SR)
    np.testing.assert_array_equal(same.numpy(), y)
    with pytest.raises(L.ParameterError):
        L.resample(y, orig_sr=0, target_sr=22050)
    with pytest.raises(L.ParameterError):
        L.resample(y, orig_sr=22050.5, target_sr=16000, res_type="polyphase")
    with pytest.raises(L.ParameterError, match="Unsupported resampling mode"):
        L.resample(y, orig_sr=SR, target_sr=16000, res_type="bogus")
    with pytest.raises(L.ParameterError, match="floating-point"):
        L.resample(np.zeros(100, dtype=np.int16), orig_sr=SR, target_sr=16000)


def test_polyphase_matrix_is_cached_on_the_device():
    from librosa_tpu_torch import _device

    y = _signal(3000, seed=10)
    L.resample(y, orig_sr=SR, target_sr=16000, res_type="polyphase")
    keys = {k for k in _device._tables if k[0][0] == "upfirdn"}
    assert any(k[0][1:3] == (320, 441) for k in keys)
    L.resample(y, orig_sr=SR, target_sr=16000, res_type="polyphase")
    assert {k for k in _device._tables if k[0][0] == "upfirdn"} == keys
    h = port_audio._poly_filter(320, 441)
    F_mat = port_audio._upfirdn_matrix(h, 320, 441)
    assert F_mat.shape == (441 + -(-len(h) // 320) - 1, 320) and F_mat.dtype == np.float32


# ---------------------------------------------------------------------------
# tone, chirp, clicks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(length=4096), dict(duration=0.25), dict(length=1000, phi=0.3),
                                dict(duration=0.1, sr=8000)],
                         ids=["length", "duration", "phi", "sr8000"])
def test_tone_matches_jax(kw):
    got = L.tone(440.0, **kw)
    want = np.asarray(lt.tone(440.0, **kw))
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert _snr(got, want) >= 120.0


@pytest.mark.parametrize("kw", [dict(length=8192), dict(duration=0.3, linear=True),
                                dict(duration=0.2, fmax=110.0), dict(length=3000, phi=1.0)],
                         ids=["exponential", "linear", "constant", "phi"])
def test_chirp_matches_jax(kw):
    kw = dict(dict(fmin=110.0, fmax=4000.0), **kw)
    got = L.chirp(**kw)
    want = np.asarray(lt.chirp(**kw))
    assert got.shape == want.shape
    assert _snr(got, want) >= 120.0


def test_clicks_match_jax():
    for kw in (dict(times=[0.1, 0.5], sr=SR, length=SR), dict(frames=[3, 40, 41], hop_length=256),
               dict(times=[0.0, 0.2], click_freq=2000.0, click_duration=0.05),
               dict(times=[0.05], click=np.hanning(64)), dict(times=[0.1, 3.0], length=5000)):
        got = L.clicks(**kw)
        want = np.asarray(lt.clicks(**kw))
        assert got.shape == want.shape and got.dtype == want.dtype
        assert _snr(got, want) >= 120.0


def test_generators_reject_what_jax_rejects():
    with pytest.raises(L.ParameterError):
        L.tone(440.0)
    with pytest.raises(L.ParameterError):
        L.tone(None, length=10)
    with pytest.raises(L.ParameterError):
        L.chirp(fmin=110.0, fmax=220.0)
    with pytest.raises(L.ParameterError):
        L.chirp(fmin=None, fmax=220.0, length=10)
    with pytest.raises(L.ParameterError):
        L.clicks()
    with pytest.raises(L.ParameterError):
        L.clicks(times=[0.1], click_duration=0)
    with pytest.raises(L.ParameterError):
        L.clicks(times=[0.1], click_freq=-1)
    with pytest.raises(L.ParameterError):
        L.clicks(times=[0.1], click=np.ones(4, dtype=np.int16))
    with pytest.raises(L.ParameterError):
        L.clicks(times=[0.1], length=0)


def test_time_and_frame_conversions_match_jax():
    t = np.linspace(0, 2, 11)
    np.testing.assert_array_equal(L.time_to_samples(t, sr=SR), lt.time_to_samples(t, sr=SR))
    f = np.arange(20)
    np.testing.assert_array_equal(L.frames_to_samples(f, hop_length=256, n_fft=1024),
                                  lt.frames_to_samples(f, hop_length=256, n_fft=1024))
    m = np.linspace(10.0, 120.0, 31)
    np.testing.assert_allclose(L.midi_to_hz(m), lt.midi_to_hz(m), rtol=1e-12)
    np.testing.assert_allclose(L.hz_to_midi(L.midi_to_hz(m)), m, rtol=1e-12)
