"""The port's feature stack (stft, chroma, centroid, roll-off, RMS, the dB family) against the
JAX package on the CPU, from the same seeded numpy inputs.

Tolerances: rtol 1e-4 / atol 1e-5 on values, or an SNR floor where the
goldens hold the same function to one (tests/golden_cases.py): 115 dB for
the STFT, 120 dB for chroma_stft's golden but 115 dB here (the mel
kernel's floor, which the chroma projection shares), 105 dB for MFCC.
"""

import numpy as np
import pytest
import torch

import librosa_tpu as lt

import librosa_tpu_torch as L
from librosa_tpu_torch.core import spectrum as port_spectrum
from librosa_tpu_torch.entry import feature_stack
from librosa_tpu_torch.feature import spectral as port_spectral
from librosa_tpu_torch.ops import fused_stft

SR = 22050
STFT_SNR_DB = 115.0
CHROMA_SNR_DB = 115.0
MFCC_SNR_DB = 105.0
RTOL, ATOL = 1e-4, 1e-5


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
    err = np.sum(np.abs(got.astype(np.complex128) - want.astype(np.complex128)) ** 2)
    return 10 * np.log10(np.sum(np.abs(want.astype(np.complex128)) ** 2) / max(err, 1e-300))


def _signal(*shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (tuple(got.shape), want.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# stft, magphase, _spectrogram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [{}, dict(center=False), dict(n_fft=512, hop_length=128, window="hamming"),
     dict(n_fft=1024, win_length=512), dict(n_fft=1024, hop_length=300),
     dict(pad_mode="reflect"), dict(pad_mode="edge"), dict(pad_mode="symmetric"),
     dict(pad_mode="wrap", n_fft=1024)],
    ids=["defaults", "uncentered", "hamming512", "short_window", "odd_hop", "reflect", "edge",
         "symmetric", "wrap"],
)
def test_stft_matches_jax(kw):
    y = _signal(2, 9000, seed=1)
    got = L.stft(y, **kw)
    want = np.asarray(lt.stft(y, **kw))
    assert got.dtype == torch.complex64 and tuple(got.shape) == want.shape
    assert _snr(got.numpy(), want) >= STFT_SNR_DB


def test_stft_float64_and_dtype():
    y = _signal(6000, seed=2).astype(np.float64)
    got = L.stft(y, n_fft=1024)
    assert got.dtype == torch.complex128
    ref = np.asarray(lt.stft(y.astype(np.float32), n_fft=1024))
    assert _snr(got.numpy(), ref) >= STFT_SNR_DB
    assert L.stft(y, n_fft=1024, dtype=torch.complex64).dtype == torch.complex64


def test_stft_rejects_what_jax_rejects():
    with pytest.raises(L.ParameterError):
        L.stft(np.zeros(4096, dtype=np.int16))
    with pytest.raises(L.ParameterError):
        L.stft(_signal(1000), n_fft=2048, center=False)
    with pytest.raises(L.ParameterError):
        L.stft(_signal(4096), hop_length=0)
    with pytest.raises(L.ParameterError, match="pad"):
        L.stft(_signal(4096), pad_mode="no such mode")
    with pytest.raises(NotImplementedError):
        lt.stft(_signal(4096), pad_mode="no such mode")
    with pytest.warns(UserWarning, match="too large"):
        L.stft(_signal(1500), n_fft=2048)


def test_magphase_matches_jax():
    D = np.array(lt.stft(_signal(5000, seed=3), n_fft=512))
    D[3, 4] = 0.0
    for power in (1, 2):
        mag, phase = L.magphase(D, power=power)
        jmag, jphase = lt.magphase(D, power=power)
        _close(mag, jmag)
        np.testing.assert_allclose(phase.numpy(), np.asarray(jphase), rtol=RTOL, atol=ATOL)
    assert phase[3, 4] == 1.0 + 0.0j
    np.testing.assert_allclose((L.magphase(D)[0] * phase).numpy(), D, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("power", [1, 2])
@pytest.mark.parametrize(
    "kw", [dict(), dict(n_fft=512, hop_length=128, pad_mode="reflect"),
           dict(n_fft=1024, hop_length=None, win_length=800, center=False)],
    ids=["defaults", "reflect512", "short_window_uncentered"])
def test_spectrogram_matches_jax(power, kw):
    y = _signal(2, 8000, seed=4)
    got, n_fft = port_spectrum._spectrogram(y=y, power=power, **kw)
    want, jn_fft = lt.core.spectrum._spectrogram(y=y, power=power, **kw)
    assert n_fft == jn_fft
    assert _snr(got.numpy(), np.asarray(want)) >= (110.0 if power == 1 else STFT_SNR_DB)


def test_spectrogram_passes_S_through_and_infers_n_fft():
    S = np.abs(np.random.RandomState(5).randn(257, 9)).astype(np.float32)
    got, n_fft = port_spectrum._spectrogram(S=S, n_fft=2048)
    assert n_fft == 512 and np.array_equal(got.numpy(), S)
    with pytest.raises(L.ParameterError):
        port_spectrum._spectrogram()
    with pytest.raises(L.ParameterError):
        port_spectrum._spectrogram(y=_signal(4096), n_fft=None)


# ---------------------------------------------------------------------------
# chroma_stft
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [dict(tuning=0.0), dict(tuning=0.25, n_chroma=24), dict(tuning=-0.1, norm=1),
     dict(tuning=0.0, norm=2), dict(tuning=0.0, norm=None),
     dict(tuning=0.0, pad_mode="reflect", n_fft=1024, hop_length=256),
     dict(tuning=0.0, octwidth=None, base_c=False)],
    ids=["a440", "n24_tuned", "norm1", "norm2", "norm_none", "reflect1024", "flat_octaves"],
)
def test_chroma_stft_from_y_matches_jax(kw):
    y = _signal(SR // 2, seed=6)
    got = L.feature.chroma_stft(y=y, sr=SR, **kw)
    want = np.asarray(lt.feature.chroma_stft(y=y, sr=SR, **kw))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert _snr(got.numpy(), want) >= CHROMA_SNR_DB


def test_chroma_stft_leading_dims_and_S_path():
    y = _signal(2, 3, 6000, seed=7)
    got = L.feature.chroma_stft(y=y, sr=SR, tuning=0.0, n_fft=512, hop_length=128)
    want = np.asarray(lt.feature.chroma_stft(y=y, sr=SR, tuning=0.0, n_fft=512,
                                             hop_length=128))
    assert tuple(got.shape) == (2, 3, 12, 47)
    assert _snr(got.numpy(), want) >= CHROMA_SNR_DB
    S = np.abs(np.asarray(lt.stft(y[0], n_fft=512))) ** 2
    for kw in (dict(tuning=0.0), dict(tuning=0.3, n_chroma=24, norm=2)):
        got = L.feature.chroma_stft(S=S, sr=SR, **kw)
        want = np.asarray(lt.feature.chroma_stft(S=S, sr=SR, **kw))
        assert _snr(got.numpy(), want) >= CHROMA_SNR_DB


def test_chroma_stft_without_tuning_names_the_missing_function():
    """The function that used to be missing, ``estimate_tuning``, now supplies the tuning."""
    y = _signal(8192, seed=20)
    got = L.feature.chroma_stft(y=y, sr=SR)
    want = np.asarray(lt.feature.chroma_stft(y=y, sr=SR))
    assert _snr(got.numpy(), want) >= 110.0  # the estimated tuning agrees, then one projection
    S = np.abs(np.asarray(lt.stft(y))) ** 2
    tuning = L.estimate_tuning(S=S, sr=SR, bins_per_octave=12)
    assert tuning == lt.estimate_tuning(S=S, sr=SR, bins_per_octave=12)
    from_S = L.feature.chroma_stft(S=S, sr=SR, tuning=None)
    assert _snr(from_S.numpy(), L.feature.chroma_stft(S=S, sr=SR, tuning=tuning).numpy()) >= 140.0
    with pytest.warns(UserWarning, match="no positive frequencies"):  # silence: tuning 0.0
        flat = L.feature.chroma_stft(S=np.zeros((1025, 4), np.float32), sr=SR, tuning=None)
    assert tuple(flat.shape) == (12, 4)


# ---------------------------------------------------------------------------
# spectral_centroid, spectral_rolloff, rms
# ---------------------------------------------------------------------------


def _with_silence(seed):
    y = _signal(2, 12000, seed=seed)
    y[0, 3000:9000] = 0.0  # whole frames of zeros
    return y


def test_spectral_centroid_matches_jax():
    y = _with_silence(8)
    got = L.feature.spectral_centroid(y=y, sr=SR)
    _close(got, lt.feature.spectral_centroid(y=y, sr=SR), atol=1e-2)  # Hz, values ~5e3
    assert torch.isfinite(got).all()
    S = np.abs(np.asarray(lt.stft(y, n_fft=1024)))
    _close(L.feature.spectral_centroid(S=S, sr=SR), lt.feature.spectral_centroid(S=S, sr=SR),
           atol=1e-2)
    freq = np.linspace(10.0, 9000.0, 513)
    _close(L.feature.spectral_centroid(S=S, freq=freq),
           lt.feature.spectral_centroid(S=S, freq=freq), atol=1e-2)
    freq2 = np.abs(np.random.RandomState(9).randn(*S.shape[-2:])) * 1e3  # varies with time
    _close(L.feature.spectral_centroid(S=S, freq=freq2),
           lt.feature.spectral_centroid(S=S, freq=freq2), atol=1e-2)


@pytest.mark.parametrize("roll_percent", [0.5, 0.85])
def test_spectral_rolloff_matches_jax(roll_percent):
    y = _with_silence(10)
    got = L.feature.spectral_rolloff(y=y, sr=SR, roll_percent=roll_percent)
    want = np.asarray(lt.feature.spectral_rolloff(y=y, sr=SR, roll_percent=roll_percent))
    assert torch.isfinite(got).all() and np.isfinite(want).all()
    # a frame whose cumulative sum lands within rounding of the threshold may pick the next bin
    bins = np.abs(got.numpy() - want) / (SR / 2048)
    assert bins.max() <= 1.0 + 1e-6 and (bins < 0.5).mean() >= 0.98
    silent = got[0, 0, 8:16]
    assert torch.equal(silent, torch.zeros(8))  # all-zero frames: the first bin
    S = np.abs(np.asarray(lt.stft(y, n_fft=512)))
    freq = np.linspace(5.0, 8000.0, 257)
    for kw in (dict(sr=SR), dict(freq=freq)):
        got = L.feature.spectral_rolloff(S=S, roll_percent=roll_percent, **kw)
        want = lt.feature.spectral_rolloff(S=S, roll_percent=roll_percent, **kw)
        _close(got, want, atol=1e-3)


def test_spectral_features_reject_bad_spectra():
    S = np.ones((257, 4), np.float32)
    S[3, 2] = -1.0
    for fn in (L.feature.spectral_centroid, L.feature.spectral_rolloff):
        with pytest.raises(L.ParameterError, match="non-negative"):
            fn(S=S)
        with pytest.raises(L.ParameterError, match="real-valued"):
            fn(S=S.astype(np.complex64))
    with pytest.raises(L.ParameterError):
        L.feature.spectral_rolloff(S=np.abs(S), roll_percent=1.0)


def test_rms_matches_jax():
    y = _signal(2, 9000, seed=11)
    _close(L.feature.rms(y=y), lt.feature.rms(y=y))
    _close(L.feature.rms(y=y, frame_length=512, hop_length=100, center=False),
           lt.feature.rms(y=y, frame_length=512, hop_length=100, center=False))
    _close(L.feature.rms(y=y, pad_mode="reflect"), lt.feature.rms(y=y, pad_mode="reflect"))
    S = np.abs(np.asarray(lt.stft(y)))
    _close(L.feature.rms(S=S), lt.feature.rms(S=S))
    D = np.asarray(lt.stft(y, n_fft=1023))  # odd frame length, complex input
    _close(L.feature.rms(S=D, frame_length=1023), lt.feature.rms(S=D, frame_length=1023))
    with pytest.raises(L.ParameterError):
        L.feature.rms(S=S, frame_length=1024)
    with pytest.raises(L.ParameterError):
        L.feature.rms()


# ---------------------------------------------------------------------------
# util: normalize, pad_center, fix_length
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", [np.inf, -np.inf, 0, 1, 2, 0.5, 3.0, None])
@pytest.mark.parametrize("axis", [0, -1, 1, None])
def test_normalize_matches_jax(norm, axis):
    X = np.random.RandomState(12).randn(5, 7, 6).astype(np.float32)
    X[:, 2, :] = 0.0
    _close(L.util.normalize(X, norm=norm, axis=axis), lt.util.normalize(X, norm=norm, axis=axis),
           rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fill", [None, False, True])
@pytest.mark.parametrize("norm", [np.inf, 1, 2])
def test_normalize_threshold_and_fill_match_jax(fill, norm):
    X = np.random.RandomState(13).randn(6, 9).astype(np.float32)
    X[:, ::4] *= 1e-3
    X[:, 1] = 0.0
    for threshold in (None, 0.05):
        kw = dict(norm=norm, axis=0, threshold=threshold, fill=fill)
        _close(L.util.normalize(X, **kw), lt.util.normalize(X, **kw), rtol=1e-5, atol=1e-6)
    Z = (X + 1j * X[::-1]).astype(np.complex64)
    got = L.util.normalize(Z, norm=norm, axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(lt.util.normalize(Z, norm=norm, axis=1)),
                               rtol=1e-5, atol=1e-6)


def test_normalize_rejects_what_jax_rejects():
    X = np.ones((3, 3), np.float32)
    for kw in (dict(fill=3), dict(threshold=0.0), dict(norm=-1), dict(norm="max"),
               dict(norm=0, fill=True)):
        with pytest.raises(L.ParameterError):
            L.util.normalize(X, **kw)
    with pytest.raises(L.ParameterError):
        L.util.normalize(np.ones((3, 3), np.int32))


def test_pad_center_and_fix_length_match_jax():
    X = np.random.RandomState(14).randn(3, 10).astype(np.float32)
    for kw in (dict(size=17), dict(size=16, axis=0), dict(size=15, mode="reflect"),
               dict(size=13, mode="edge"), dict(size=14, mode="symmetric"),
               dict(size=12, constant_values=2.0)):
        _close(L.util.pad_center(X, **kw), lt.util.pad_center(X, **kw), rtol=0, atol=0)
    for kw in (dict(size=4), dict(size=10), dict(size=15), dict(size=2, axis=0),
               dict(size=5, axis=0, mode="edge")):
        _close(L.util.fix_length(X, **kw), lt.util.fix_length(X, **kw), rtol=0, atol=0)
    with pytest.raises(L.ParameterError):
        L.util.pad_center(X, size=5)
    with pytest.raises(L.ParameterError, match="pad"):
        L.util.pad_center(X, size=20, mode="no such mode")
    for mode in ("mean", "reflect", "edge"):  # 40 samples: more than one period of 10
        _close(L.util.pad_center(X, size=40, mode=mode), lt.util.pad_center(X, size=40, mode=mode),
               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the dB family and the weighting curves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw", [dict(), dict(ref=np.max), dict(top_db=None), dict(ref=2.0, top_db=0),
           dict(ref=np.max, amin=1e-3, axes=None), dict(top_db=60.0, axes=(-1,))],
    ids=["defaults", "np_max", "no_top_db", "ref2_top0", "whole_array", "last_axis"])
def test_amplitude_to_db_matches_jax(kw):
    S = np.random.RandomState(15).randn(2, 40, 30).astype(np.float32)
    S[1, :4, :4] = 0.0
    _close(L.amplitude_to_db(S, **kw), lt.amplitude_to_db(S, **kw), rtol=0, atol=1e-4)
    if kw.get("ref") is np.max and "axes" not in kw:
        assert torch.equal(L.amplitude_to_db(S, **kw).amax(dim=(-2, -1)), torch.zeros(2))


def test_db_inverses_and_perceptual_weighting_match_jax():
    db = np.linspace(-80.0, 20.0, 37).astype(np.float32).reshape(1, 37)
    _close(L.db_to_power(db), lt.db_to_power(db), rtol=1e-5)
    _close(L.db_to_power(db, ref=3.0), lt.db_to_power(db, ref=3.0), rtol=1e-5)
    _close(L.db_to_amplitude(db, ref=2.0), lt.db_to_amplitude(db, ref=2.0), rtol=1e-5)
    S = np.abs(np.random.RandomState(16).randn(2, 257, 12)).astype(np.float32) ** 2
    freqs = L.fft_frequencies(sr=SR, n_fft=512)
    for kind in ("A", "C", "Z"):
        _close(L.perceptual_weighting(S, freqs, kind=kind, ref=np.max),
               lt.perceptual_weighting(S, freqs, kind=kind, ref=np.max), rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["A", "B", "C", "D", "Z", None, "a"])
def test_frequency_weighting_matches_jax(kind):
    f = np.linspace(20.0, 11025.0, 200)
    np.testing.assert_allclose(L.frequency_weighting(f, kind=kind),
                               lt.frequency_weighting(f, kind=kind), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(L.frequency_weighting(f, kind=kind, min_db=None),
                               lt.frequency_weighting(f, kind=kind, min_db=None),
                               rtol=1e-10, atol=1e-10)
    with pytest.raises(L.ParameterError):
        L.frequency_weighting(f, kind="Q")


def test_db_family_warns_on_complex_and_validates():
    D = np.asarray(lt.stft(_signal(4096, seed=17), n_fft=512))
    with pytest.warns(UserWarning, match="phase information"):
        got = L.amplitude_to_db(D)
    _close(got, lt.amplitude_to_db(np.abs(D)), rtol=0, atol=1e-4)
    with pytest.warns(UserWarning, match="phase information"):
        L.power_to_db(D)
    for fn in (L.power_to_db, L.amplitude_to_db):
        with pytest.raises(L.ParameterError):
            fn(np.ones(4, np.float32), amin=0)
        with pytest.raises(L.ParameterError):
            fn(np.ones(4, np.float32), top_db=-1)


# ---------------------------------------------------------------------------
# routing, and the feature stack as a whole
# ---------------------------------------------------------------------------


def test_spectrogram_and_chroma_route_by_kernel_refusal(monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port_spectrum, "_fused", spy("fused", fused_stft._fused))
    monkeypatch.setattr(port_spectrum, "stft_mel_reference",
                        spy("plain_mel", fused_stft.stft_mel_reference))
    monkeypatch.setattr(port_spectrum, "_stft_power_core",
                        spy("plain_power", port_spectrum._stft_power_core))
    y = _signal(8000, seed=18)
    for kw in (dict(), dict(pad_mode="reflect")):
        port_spectrum._spectrogram(y=y, **kw)
        L.feature.chroma_stft(y=y, sr=SR, tuning=0.0, **kw)
        L.feature.spectral_centroid(y=y, sr=SR, **kw)
    assert calls == ["fused"] * 6
    calls.clear()
    s64, _ = port_spectrum._spectrogram(y=y.astype(np.float64))
    port_spectrum._spectrogram(y=y, pad_mode="edge")
    port_spectrum._spectrogram(y=y, n_fft=2000, hop_length=500)
    assert calls == ["plain_power"] * 3 and s64.dtype == torch.float64
    calls.clear()
    c64 = L.feature.chroma_stft(y=y.astype(np.float64), sr=SR, tuning=0.0)
    L.feature.chroma_stft(y=y, sr=SR, tuning=0.0, pad_mode="edge")
    L.feature.chroma_stft(y=y, sr=SR, tuning=0.0, n_fft=2000, hop_length=500)
    assert calls == ["plain_mel"] * 3 and c64.dtype == torch.float64
    c32 = L.feature.chroma_stft(y=y, sr=SR, tuning=0.0)
    assert _snr(c32.numpy(), c64.numpy()) >= CHROMA_SNR_DB


def test_identity_basis_and_bands_are_cached_per_device():
    a = port_spectrum._eye_device(512, torch.device("cpu"))
    b = port_spectrum._eye_device(512, torch.device("cpu"))
    assert a[0] is b[0] and a[1] is b[1]
    assert tuple(a[0].shape) == (257, 257) and a[1].dtype == torch.int32
    c = port_spectral._basis_device(L.filters.chroma, SR, 512, torch.device("cpu"),
                                    torch.float32, tuning=0.0, n_chroma=12)
    d = port_spectral._basis_device(L.filters.chroma, SR, 512, torch.device("cpu"),
                                    torch.float32, tuning=0.0, n_chroma=12)
    assert c[0] is d[0] and c[1] is d[1]


def test_feature_stack_matches_the_four_jax_calls():
    forward, (example,) = feature_stack()
    assert example.shape == (2, 4 * SR) and example.dtype == np.float32
    y = _signal(2, SR, seed=19)
    mfcc, chroma, centroid, rolloff = forward(y)
    kw = dict(sr=SR, n_fft=2048, hop_length=512)
    want_mfcc = np.asarray(lt.feature.mfcc(y=y, n_mfcc=20, n_mels=128, **kw))
    want_chroma = np.asarray(lt.feature.chroma_stft(y=y, tuning=0.0, **kw))
    want_centroid = np.asarray(lt.feature.spectral_centroid(y=y, **kw))
    want_rolloff = np.asarray(lt.feature.spectral_rolloff(y=y, **kw))
    assert tuple(mfcc.shape) == (2, 20, 44) and tuple(chroma.shape) == (2, 12, 44)
    assert tuple(centroid.shape) == tuple(rolloff.shape) == (2, 1, 44)
    assert _snr(mfcc.numpy(), want_mfcc) >= MFCC_SNR_DB
    assert _snr(chroma.numpy(), want_chroma) >= CHROMA_SNR_DB
    np.testing.assert_allclose(centroid.numpy(), want_centroid, rtol=RTOL, atol=1e-2)
    bins = np.abs(rolloff.numpy() - want_rolloff) / (SR / 2048)
    assert bins.max() <= 1.0 + 1e-6 and (bins < 0.5).mean() >= 0.95
