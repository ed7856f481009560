"""The port's main path (mel spectrogram -> dB -> MFCC) against the JAX package on the CPU."""

import numpy as np
import pytest
import torch

import librosa_tpu as lt

import librosa_tpu_torch as L
from librosa_tpu_torch.core import spectrum as port_spectrum
from librosa_tpu_torch.ops import fused_stft

SR = 22050
MEL_SNR_DB = 115.0   # goldens' melspectrogram floor (tests/golden_cases.py)
MFCC_SNR_DB = 105.0  # goldens' mfcc floor


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
    return 10 * np.log10(np.sum(want**2) / max(np.sum((got - want) ** 2), 1e-300))


def _signal(*shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(np.float32)


@pytest.mark.parametrize("shape", [(SR,), (2, SR)], ids=["mono", "stereo"])
@pytest.mark.parametrize(
    "kw",
    [{}, dict(n_fft=512, hop_length=128, n_mels=64),
     dict(n_fft=2048, hop_length=512, win_length=1024, window=("kaiser", 4.0))],
    ids=["defaults", "n_fft512", "short_window"],
)
def test_melspectrogram_matches_jax(shape, kw):
    y = _signal(*shape)
    got = L.feature.melspectrogram(y=y, sr=SR, **kw)
    want = np.asarray(lt.feature.melspectrogram(y=y, sr=SR, **kw))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert _snr(got, want) >= MEL_SNR_DB


def test_melspectrogram_reflect_and_power_one():
    y = _signal(2 * SR, seed=1)
    kw = dict(pad_mode="reflect", power=1.0)
    got = L.feature.melspectrogram(y=y, sr=SR, **kw)
    want = np.asarray(lt.feature.melspectrogram(y=y, sr=SR, **kw))
    assert _snr(got, want) >= 110.0  # |.| (power 1): the square root loses ~5 dB


def test_melspectrogram_from_power_spectrogram():
    rng = np.random.RandomState(2)
    S = np.abs(rng.randn(2, 1025, 30)).astype(np.float32)
    got = L.feature.melspectrogram(S=S, sr=SR)
    want = np.asarray(lt.feature.melspectrogram(S=S, sr=SR))
    assert _snr(got, want) >= MEL_SNR_DB


def test_melspectrogram_window_as_samples_from_either_package():
    y = _signal(SR, seed=3)
    win = lt.filters.get_window("hamming", 1024)
    want = np.asarray(lt.feature.melspectrogram(y=y, sr=SR, n_fft=1024, window=win))
    got = L.feature.melspectrogram(y=y, sr=SR, n_fft=1024, window=win)
    assert _snr(got, want) >= MEL_SNR_DB


def test_short_window_is_centre_padded_like_jax():
    from librosa_tpu.core.spectrum import _win_device as jax_win

    got = port_spectrum._win_device("hann", 1000, 2048, torch.device("cpu"), torch.float32)
    want = np.asarray(jax_win("hann", 1000, 2048, np.float32))
    assert got.shape == (2048,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "kw", [dict(), dict(ref=np.max), dict(ref=torch.max), dict(top_db=None),
           dict(ref=0.5, top_db=40.0), dict(ref=np.max, amin=1e-6)],
    ids=["scalar_ref", "np_max", "torch_max", "no_top_db", "ref_half", "np_max_amin"],
)
def test_power_to_db_matches_jax(kw):
    S = np.abs(np.random.RandomState(4).randn(2, 64, 50)).astype(np.float32) ** 2
    S[0, :5, :5] = 0.0  # below amin
    got = L.power_to_db(S, **kw)
    jkw = dict(kw, ref=np.max) if kw.get("ref") is torch.max else kw
    want = np.asarray(lt.power_to_db(S, **jkw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    if kw.get("ref") in (np.max, torch.max):
        # exactly 0 dB at each channel's peak
        assert torch.equal(got.amax(dim=(-2, -1)), torch.zeros(2))


@pytest.mark.parametrize(
    "kw",
    [dict(), dict(lifter=22, n_mfcc=13), dict(dct_type=1, norm=None), dict(dct_type=3)],
    ids=["defaults", "lifter22", "dct1", "dct3"],
)
def test_mfcc_matches_jax(kw):
    y = _signal(SR, seed=5)
    got = L.feature.mfcc(y=y, sr=SR, **kw)
    want = np.asarray(lt.feature.mfcc(y=y, sr=SR, **kw))
    assert _snr(got, want) >= MFCC_SNR_DB


def test_entry_forward_matches_jax_entry():
    import __graft_entry__

    from librosa_tpu_torch.entry import entry

    fwd, (example,) = entry()
    jfwd, (jexample,) = __graft_entry__.entry()
    assert example.shape == jexample.shape == (4 * SR,)
    y = _signal(*example.shape, seed=6)
    got = fwd(y)
    want = np.asarray(jfwd(y))
    assert got.shape == (20, 173)
    assert _snr(got, want) >= MFCC_SNR_DB


def test_multichannel_leading_dims():
    y = _signal(2, 3, 8192, seed=7)
    M = L.feature.melspectrogram(y=y, sr=SR, n_fft=512, hop_length=128)
    C = L.feature.mfcc(y=y, sr=SR, n_fft=512, hop_length=128, n_mfcc=13)
    assert M.shape == (2, 3, 128, 65) and C.shape == (2, 3, 13, 65)
    want_M = np.asarray(lt.feature.melspectrogram(y=y, sr=SR, n_fft=512, hop_length=128))
    want_C = np.asarray(lt.feature.mfcc(y=y, sr=SR, n_fft=512, hop_length=128, n_mfcc=13))
    assert _snr(M, want_M) >= MEL_SNR_DB
    assert _snr(C, want_C) >= MFCC_SNR_DB
    # each channel alone gives the same answer
    one = L.feature.melspectrogram(y=y[1, 2], sr=SR, n_fft=512, hop_length=128)
    assert torch.allclose(M[1, 2], one, rtol=1e-6, atol=0)


def test_float32_routes_to_fused_and_float64_to_plain(monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port_spectrum, "_fused", spy("fused", fused_stft._fused))
    monkeypatch.setattr(port_spectrum, "stft_mel_reference",
                        spy("plain", fused_stft.stft_mel_reference))
    y = _signal(SR, seed=8)
    m32 = L.feature.melspectrogram(y=y, sr=SR)
    m64 = L.feature.melspectrogram(y=y.astype(np.float64), sr=SR)
    L.feature.melspectrogram(y=y, sr=SR, pad_mode="edge")
    L.feature.melspectrogram(y=y, sr=SR, n_fft=2000, hop_length=500)
    assert calls == ["fused", "plain", "plain", "plain"]
    assert m64.dtype == torch.float64
    assert _snr(m32, m64.numpy()) >= MEL_SNR_DB


def test_integer_audio_raises():
    with pytest.raises(L.ParameterError):
        L.feature.melspectrogram(y=np.zeros(4096, dtype=np.int16), sr=SR)


def test_win_length_above_n_fft_raises():
    with pytest.raises(L.ParameterError):
        L.feature.melspectrogram(y=_signal(8000), sr=SR, n_fft=512, win_length=1024)


def test_reconstruction_forward_matches_the_jax_chain():
    """entry.reconstruction() with zero-phase init against the same chain of JAX functions.

    2 tracks of one second. The resampled signal is held to 110 dB (one
    float32 matrix product on both sides); the recovered one to 50 dB after
    32 rounds that feed their own rounding back, on noise, which has no phase
    structure to settle on (measured: 67 dB).
    """
    from librosa_tpu_torch.entry import reconstruction

    fwd, (example,) = reconstruction(init=None)
    assert example.shape == (2, 4 * SR)
    y = _signal(2, SR, seed=9)
    y16k, y_hat = fwd(y)
    j16k = lt.resample(y, orig_sr=SR, target_sr=16000, res_type="polyphase")
    jS, _ = lt.core.spectrum._spectrogram(y=j16k, n_fft=2048, hop_length=512, power=1)
    j_hat = lt.griffinlim(jS, n_iter=32, n_fft=2048, hop_length=512, rng=0, init=None,
                          length=j16k.shape[-1])
    assert tuple(y16k.shape) == tuple(y_hat.shape) == (2, 16000)
    assert _snr(y16k, np.asarray(j16k)) >= 110.0
    assert _snr(y_hat, np.asarray(j_hat)) >= 50.0
    # with random phases: same seed, same signal, and a spectrum close to the one asked for
    fwd_random, _ = reconstruction()
    a, b = fwd_random(y)[1], fwd_random(y)[1]
    assert torch.equal(a, b)
    S = np.asarray(jS)
    got = np.abs(np.asarray(lt.stft(a.numpy())))
    assert np.linalg.norm(got - S) / np.linalg.norm(S) < 0.5
