"""The port's YIN and pYIN against the JAX package on the CPU.

Tolerances: 120 dB on ``yin`` (the ``yin`` golden's floor) and on the
cumulative mean normalised difference; 1e-5 relative (1e-7 absolute) on
the trough priors and pYIN's voicing probability (the same float32 terms,
summed over thresholds in another order); the decoded voicing equal and
``f0`` at 120 dB where voiced (both decode the same float32 log
probabilities with the first maximum on ties).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import librosa_tpu as lt
from librosa_tpu.core import pitch as jax_pitch

import librosa_tpu_torch as L
from librosa_tpu_torch.core import pitch as port_pitch

SR = 22050
YIN_SNR_DB = 120.0
PROB_RTOL = 1e-5


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


def _voice(n=SR // 2, f0=220.0, seed=0, glide=0.0):
    t = np.arange(n) / SR
    phase = 2 * np.pi * (f0 * t + 0.5 * glide * t**2)
    y = sum(np.sin((k + 1) * phase) / (k + 1) for k in range(4))
    y = 0.3 * y + 0.01 * np.random.RandomState(seed).randn(n)
    y[n // 2:n // 2 + n // 8] = 0.01 * np.random.RandomState(seed + 1).randn(n // 8)  # unvoiced
    return y.astype(np.float32)


def test_difference_function_and_trough_priors_match_jax():
    y = _voice()
    frames = L.util.frame(torch.from_numpy(y), frame_length=1024, hop_length=256)
    got = port_pitch._cumulative_mean_normalized_difference(frames, 30, 200)
    want = jax_pitch._cumulative_mean_normalized_difference(jnp.asarray(frames.numpy()), 30, 200)
    assert _snr(got.numpy(), want) >= YIN_SNR_DB
    yin_frames = np.asarray(want)
    trough = np.array(lt.util.localmin(yin_frames, axis=-2))
    trough[0] = yin_frames[0] < yin_frames[1]
    thresholds = np.linspace(0, 1, 101)
    beta = np.diff(np.linspace(0, 1, 101) ** 2)
    got = port_pitch._pyin_trough_probs(torch.from_numpy(yin_frames), torch.from_numpy(trough),
                                        thresholds, beta, 2.0, 0.01)
    want = jax_pitch._pyin_trough_probs(jnp.asarray(yin_frames), jnp.asarray(trough),
                                        jnp.asarray(thresholds), jnp.asarray(beta), 2.0, 0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PROB_RTOL, atol=1e-7)


@pytest.mark.parametrize("kw", [
    {"fmin": 100, "fmax": 800},
    {"fmin": 200, "fmax": 900, "frame_length": 512, "hop_length": 128},
    {"fmin": 100, "fmax": 800, "center": False, "trough_threshold": 0.2},
    {"fmin": 80, "fmax": 1000, "pad_mode": "reflect", "frame_length": 1024},
], ids=["default", "short", "uncentred", "reflect"])
def test_yin_matches_jax(kw):
    y = np.stack([_voice(), _voice(f0=300.0, seed=2, glide=100.0)])
    got = L.yin(y, sr=SR, **kw)
    want = lt.yin(y, sr=SR, **kw)
    assert _snr(got.numpy(), want) >= YIN_SNR_DB


def test_yin_rejects_what_jax_rejects():
    y = _voice()
    for bad in ({"fmin": 0, "fmax": 500}, {"fmin": 500, "fmax": 400},
                {"fmin": 100, "fmax": 20000}, {"fmin": 10, "fmax": 500},
                {"fmin": 100, "fmax": 500, "win_length": 4096}):
        with pytest.raises(L.ParameterError):
            L.yin(y, sr=SR, **bad)


def _compare_pyin(got, want):
    f0, vflag, vprob = (x.numpy() for x in got)
    f0_j, vflag_j, vprob_j = (np.asarray(x) for x in want)
    np.testing.assert_allclose(vprob, vprob_j, rtol=PROB_RTOL, atol=1e-7)
    np.testing.assert_array_equal(vflag, vflag_j)
    np.testing.assert_array_equal(np.isnan(f0), np.isnan(f0_j))
    assert _snr(np.nan_to_num(f0), np.nan_to_num(f0_j)) >= YIN_SNR_DB


@pytest.mark.parametrize("kw", [
    {"fmin": 300, "fmax": 600},
    {"fmin": 100, "fmax": 800, "fill_na": None, "switch_prob": 0.05},
    {"fmin": 150, "fmax": 600, "resolution": 0.25, "transition_min_prob": None,
     "frame_length": 1024, "beta_parameters": (1, 18), "boltzmann_parameter": 3},
], ids=["golden", "wide", "options"])
def test_pyin_matches_jax(kw):
    y = _voice(glide=60.0)
    _compare_pyin(L.pyin(y, sr=SR, **kw), lt.pyin(y, sr=SR, **kw))


def test_pyin_on_a_batch_matches_jax():
    y = np.stack([_voice(f0=330.0), _voice(f0=440.0, seed=3)])
    _compare_pyin(L.pyin(y, sr=SR, fmin=300, fmax=600), lt.pyin(y, sr=SR, fmin=300, fmax=600))


def test_pyin_float64_runs_in_float64():
    y = _voice().astype(np.float64)
    f0, vflag, vprob = L.pyin(y, sr=SR, fmin=300, fmax=600)
    assert f0.dtype == torch.float64 and vprob.dtype == torch.float64
    f0_32, vflag_32, _ = L.pyin(y.astype(np.float32), sr=SR, fmin=300, fmax=600)
    assert (vflag == vflag_32).float().mean() >= 0.95
    voiced = (vflag & vflag_32).numpy()
    assert _snr(f0_32.numpy()[voiced], f0.numpy()[voiced]) >= YIN_SNR_DB


# The port's counterparts of tests/test_golden_pitch.py's tone and chirp checks: within a
# hundredth of an octave of the true frequency, as there.
@pytest.mark.parametrize("freq", [110, 220, 440, 880])
def test_yin_tone_golden(freq):
    y = L.tone(freq, duration=1.0)
    f0 = L.yin(y, fmin=110, fmax=880, center=False).numpy()
    assert np.allclose(np.log2(f0), np.log2(freq), rtol=0, atol=1e-2)


def test_yin_chirp_instantaneous():
    fl, hl = 2048, 512
    f = 220 * (640 / 220) ** (np.arange(SR) / SR)
    target = L.util.frame(torch.from_numpy(f), frame_length=fl, hop_length=hl).mean(dim=0)
    y = L.chirp(fmin=220, fmax=640, sr=SR, duration=1.0, linear=False)
    f0 = L.yin(y, fmin=110, fmax=880, sr=SR, frame_length=fl, hop_length=hl, center=False)
    assert np.allclose(np.log2(f0.numpy()), np.log2(target.numpy()), rtol=0, atol=1e-2)
