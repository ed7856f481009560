"""The port's sliding median, HPSS, ``effects.hpss``, ``entry.cqt_hpss`` and the padding repairs.

Everything on the CPU against the JAX package, from the same seeded numpy
inputs. The median's plain version (what the CUDA kernel is held to,
bit for bit, on the card) must equal ``librosa_tpu.ops.median.median_filter_1d``
exactly: sizes 1 to 31, both axes, axes shorter than half the window, NaN,
infinities and zeros of both signs, and ``stft``'s strided layout. ``hpss``
takes the same magnitude array on both sides, so the medians agree exactly
and the masks to rounding: 105 dB, the ``hpss_margin`` golden's floor.

Also covered: the kernel's routing predicate, the wrapper's CPU route,
``softmask``, and the two faults repaired beside this slice: ``pad_last``
pads as ``jax.numpy.pad`` does in every mode and over many periods, and
``resample_poly`` is no flat name.
"""

import numpy as np
import pytest
import torch

import librosa_tpu as lt
from librosa_tpu.ops.median import median_filter_1d as jax_median

import librosa_tpu_torch as L
from librosa_tpu_torch.ops import median

SR = 22050
HPSS_SNR_DB = 105.0    # the hpss_margin golden's floor
EFFECT_SNR_DB = 105.0  # the hpss_effect golden's floor


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _snr(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return 10 * np.log10(np.sum(np.abs(want) ** 2) / max(np.sum(np.abs(got - want) ** 2), 1e-300))


def _clicks_and_tone(n=SR // 2, seed=0, channels=()):
    rng = np.random.RandomState(seed)
    y = np.sin(2 * np.pi * 440 * np.arange(n) / SR) + 0.01 * rng.randn(*channels, n)
    for at in (0.1, 0.3):
        k = int(at * n)
        y[..., k:k + 100] += np.hanning(100)
    return y.astype(np.float32)


# ---------------------------------------------------------------------------
# the sliding median
# ---------------------------------------------------------------------------


def _hard_input(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = np.round(flat[::7])              # ties
    flat[3], flat[5], flat[6] = np.nan, np.inf, -np.inf
    flat[9], flat[10] = -0.0, 0.0
    flat[-2] = np.nan
    return x


@pytest.mark.parametrize("size", [1, 2, 3, 4, 17, 31])
@pytest.mark.parametrize("shape", [(2, 5, 40), (40, 3)], ids=["short_rows", "short_columns"])
def test_median_plain_version_equals_jax(size, shape):
    x = _hard_input(shape, seed=size)
    for axis in (-1, -2):
        want = np.asarray(jax_median(x, size=size, axis=axis))
        got = median.median_filter_reference(torch.from_numpy(x), size=size, axis=axis).numpy()
        np.testing.assert_array_equal(got, want)
        # the wrapper takes the plain version for a CPU tensor
        np.testing.assert_array_equal(
            median.median_filter_1d(torch.from_numpy(x), size=size, axis=axis).numpy(), want)


def test_median_on_the_stft_layout_equals_jax():
    D = L.stft(_clicks_and_tone(), n_fft=256, hop_length=64)
    S = D.abs()
    assert S.stride(-2) == 1  # bins contiguous: the harmonic filter runs along the strided axis
    for size, axis in ((31, -1), (8, -2)):
        want = np.asarray(jax_median(S.numpy(), size=size, axis=axis))
        got = median.median_filter_reference(S, size=size, axis=axis)
        np.testing.assert_array_equal(got.numpy(), want)


def test_median_kernel_refusal():
    x = torch.zeros(2, 5, 7)
    assert median.kernel_refusal(x, 31, -1) is None
    assert median.kernel_refusal(x, 64, -2) is None
    assert median.kernel_refusal(x, 5, 1) is None and median.kernel_refusal(x, 5, 2) is None
    assert median.kernel_refusal(torch.zeros(9), 3, -1) is None
    assert "float32" in median.kernel_refusal(x.double(), 31, -1)
    assert "sizes" in median.kernel_refusal(x, 65, -1)
    assert "sizes" in median.kernel_refusal(x, 1, -1)
    assert "axis" in median.kernel_refusal(x, 3, 0)
    assert "axis" in median.kernel_refusal(torch.zeros(9), 3, -2)
    assert "non-empty" in median.kernel_refusal(torch.zeros(0, 4), 3, -1)
    with pytest.raises(L.ParameterError):
        median.median_filter_1d(x, size=0)
    before = median.launches
    median.median_filter_1d(x, size=3)
    assert median.launches == before  # the CPU route launches nothing


def test_median_batch_view_folds_leading_dims():
    x = torch.zeros(4, 3, 6, 10)
    view = median._as_batch(x)
    assert view.shape == (12, 6, 10) and view.stride() == (60, 10, 1)
    view = median._as_batch(x.transpose(-1, -2))
    assert view.shape == (12, 10, 6) and view.stride() == (60, 1, 10)
    assert median._as_batch(x.transpose(0, 1)) is None
    assert median._as_batch(x[:, :1]).shape == (4, 6, 10)
    assert median._as_batch(torch.zeros(9)).shape == (1, 1, 9)


# ---------------------------------------------------------------------------
# softmask, decompose.hpss, effects.hpss, entry.cqt_hpss
# ---------------------------------------------------------------------------


def test_softmask_matches_jax():
    rng = np.random.RandomState(4)
    X, R = np.abs(rng.randn(2, 30, 20)).astype(np.float32), np.abs(rng.randn(2, 30, 20)).astype(np.float32)
    X[0, :3], R[0, :3] = 0.0, 0.0
    for kw in (dict(), dict(power=2.0, split_zeros=True), dict(power=np.inf),
               dict(power=np.inf, split_zeros=True), dict(power=0.5)):
        np.testing.assert_allclose(L.util.softmask(X, R, **kw).numpy(),
                                   np.asarray(lt.util.softmask(X, R, **kw)), rtol=1e-6, atol=1e-7)
    for bad in (dict(X_ref=R[:1]), dict(power=0), dict(X_ref=-R)):
        with pytest.raises(L.ParameterError):
            L.util.softmask(X, **{"X_ref": R, **bad})


@pytest.mark.parametrize("kw", [dict(), dict(margin=(1.0, 3.0), power=1.0, kernel_size=(17, 7)),
                                dict(power=np.inf), dict(kernel_size=4, mask=True)],
                         ids=["defaults", "margins_kernels", "hard", "even_kernel_masks"])
def test_decompose_hpss_matches_jax(kw):
    S = np.abs(np.asarray(lt.stft(_clicks_and_tone(), n_fft=512, hop_length=128)))
    H, P = L.decompose.hpss(S, **kw)
    want_H, want_P = lt.decompose.hpss(S, **kw)
    assert _snr(H.numpy(), want_H) >= HPSS_SNR_DB and _snr(P.numpy(), want_P) >= HPSS_SNR_DB


def test_decompose_hpss_complex_and_multichannel():
    D = np.asarray(lt.stft(_clicks_and_tone(channels=(2,)), n_fft=512, hop_length=128))
    H, P = L.decompose.hpss(D)
    want_H, want_P = lt.decompose.hpss(D)
    assert H.dtype == torch.complex64 and H.shape == D.shape
    assert _snr(H.numpy(), want_H) >= HPSS_SNR_DB and _snr(P.numpy(), want_P) >= HPSS_SNR_DB
    one, _ = L.decompose.hpss(D[1])
    assert _snr(H[1].numpy(), one.numpy()) >= 140.0
    with pytest.raises(L.ParameterError):
        L.decompose.hpss(np.abs(D), margin=0.5)


def test_effects_hpss_matches_jax():
    y = _clicks_and_tone(channels=(2,))
    yh, yp = L.effects.hpss(y)
    want_h, want_p = lt.effects.hpss(y)
    assert yh.shape == y.shape and yh.dtype == torch.float32
    assert _snr(yh.numpy(), want_h) >= EFFECT_SNR_DB and _snr(yp.numpy(), want_p) >= EFFECT_SNR_DB
    kw = dict(kernel_size=(13, 9), margin=2.0, n_fft=1024, hop_length=256)
    assert _snr(L.effects.harmonic(y[0], **kw).numpy(), lt.effects.harmonic(y[0], **kw)) >= EFFECT_SNR_DB
    assert _snr(L.effects.percussive(y[0], **kw).numpy(), lt.effects.percussive(y[0], **kw)) >= EFFECT_SNR_DB


def test_entry_cqt_hpss_matches_jax():
    from librosa_tpu_torch.entry import cqt_hpss

    forward, (example,) = cqt_hpss()
    assert example.shape == (2, 4 * SR)
    y = _clicks_and_tone(channels=(2,))
    C, yh, yp = forward(y)
    want_C = lt.cqt(y, sr=SR, hop_length=512, n_bins=84, bins_per_octave=12, res_type="polyphase")
    want_h, want_p = lt.effects.hpss(y)
    assert C.shape == (2, 84, 22) and yh.shape == yp.shape == y.shape
    assert _snr(C.numpy(), want_C) >= 110.0
    assert _snr(yh.numpy(), want_h) >= EFFECT_SNR_DB and _snr(yp.numpy(), want_p) >= EFFECT_SNR_DB


def test_hpss_effect_golden():
    import golden_cases
    from pathlib import Path

    case = golden_cases.CASES["hpss_effect"]
    want = np.load(Path(__file__).parent / "goldens" / "hpss_effect.npz")
    got = case.fn(L, golden_cases.make_signals())
    for key in want.files:
        case.compare(np.asarray(got[key]), want[key], f"hpss_effect/{key}")


# ---------------------------------------------------------------------------
# repairs: numpy's pad modes over many periods, and the flat namespace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(mode="reflect"), dict(mode="symmetric"), dict(mode="wrap"), dict(mode="edge"),
    dict(mode="linear_ramp"), dict(mode="linear_ramp", end_values=(1.5, -2.0)),
    dict(mode="maximum"), dict(mode="minimum"), dict(mode="mean"), dict(mode="median"),
    dict(mode="mean", stat_length=3), dict(mode="median", stat_length=(2, 4)),
    dict(mode="empty"), dict(mode="constant", constant_values=(1.0, 2.0)),
], ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_pad_center_matches_jax_in_every_mode(kw):
    X = np.random.RandomState(5).randn(3, 7).astype(np.float32)
    for size in (10, 40):  # within one period, and several periods of a 7-sample axis
        np.testing.assert_allclose(L.util.pad_center(X, size=size, **kw).numpy(),
                                   np.asarray(lt.util.pad_center(X, size=size, **kw)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(L.util.fix_length(X, size=30, axis=-1, **kw).numpy(),
                               np.asarray(lt.util.fix_length(X, size=30, axis=-1, **kw)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pad_mode", ["reflect", "symmetric", "wrap", "edge", "mean",
                                      "linear_ramp"])
def test_stft_of_a_short_signal_matches_jax(pad_mode):
    y = np.random.RandomState(6).randn(300).astype(np.float32)
    with pytest.warns(UserWarning):
        got = L.stft(y, n_fft=1024, pad_mode=pad_mode)
    want = lt.stft(y, n_fft=1024, pad_mode=pad_mode)
    assert _snr(got.numpy(), want) >= 115.0
    got = L.feature.melspectrogram(y=y, sr=SR, n_fft=1024, pad_mode=pad_mode)
    want = lt.feature.melspectrogram(y=y, sr=SR, n_fft=1024, pad_mode=pad_mode)
    assert _snr(got.numpy(), want) >= 115.0


def test_resample_poly_is_no_flat_name():
    assert not hasattr(lt, "resample_poly") and not hasattr(lt.core, "resample_poly")
    assert not hasattr(L, "resample_poly") and not hasattr(L.core, "resample_poly")
    assert "resample_poly" not in L.core.audio.__all__
    assert callable(L.core.audio.resample_poly)
