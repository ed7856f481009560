"""The port's phase vocoder, effects, nn_filter and decompose against the JAX package on the CPU.

The inputs are noise over a tone (seeded numpy): every bin of every frame
carries energy, so each frame's phase is well defined. On a pure tone or a
chirp the bins far from it hold rounding noise, whose phases the phase
vocoder sums into every later frame; the goldens compare those by
magnitude (60 dB) and waveform SNR (45 dB).

Floors, each below the value measured on these inputs:

- ``phase_vocoder``: 110 dB complex (118.9-129.7 measured: the float32
  running sum of the phase advances in another order), 130 dB on the
  magnitudes (142.2-144.7);
- ``time_stretch``, ``pitch_shift``: 105 dB (117.4-122.7), also over a
  stretch of exact silence, whose zero bins must have phase 0 whatever the
  sign of their zeros;
- ``preemphasis`` 130 dB (139.4), ``deemphasis`` 125 dB, the golden's
  (133.5-136.7: the doubling scan against XLA's associative scan), and its
  final state, one sample a channel, 1e-5 relative (1.2e-6 measured);
- ``trim``, ``split``, ``remix``: equal (index arithmetic, copies);
- ``nn_filter``: equal (the same neighbours, the same float64 scipy product);
- ``decompose``: sklearn's NMF equal (the same host code, seeded), sorted
  components to float32 (the JAX package returns them as float32); the ``'mu'``
  updates 1e-4 relative from the same start (float32 products in another
  order, over 50 rounds), and the seeded public call by reconstruction error.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import librosa_tpu as lt
from librosa_tpu import decompose as jax_decompose

import librosa_tpu_torch as L
from librosa_tpu_torch import decompose as port_decompose

SR = 22050
PV_SNR_DB = 110.0
PV_MAG_SNR_DB = 130.0
STRETCH_SNR_DB = 105.0
PRE_SNR_DB = 130.0
DE_SNR_DB = 125.0
DE_ZF_RTOL = 1e-5
NMF_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _snr(got, want):
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return 10 * np.log10(np.sum(np.abs(want) ** 2) / max(np.sum(np.abs(got - want) ** 2), 1e-300))


def _signal(n=SR, seed=0, channels=2):
    rng = np.random.RandomState(seed)
    tone = np.sin(2 * np.pi * 440 * np.arange(n) / SR)
    y = 0.1 * rng.randn(channels, n) + 0.5 * tone
    return (y[0] if channels == 1 else y).astype(np.float32)


@pytest.fixture(scope="module")
def stft_pair():
    D = np.asarray(lt.stft(_signal()))
    return D, torch.from_numpy(D.copy())


@pytest.mark.parametrize("kw", [dict(rate=1.3), dict(rate=0.8), dict(t_out="grid"),
                                dict(rate=1.1, kind="nearest"), dict(rate=0.7, kind="cubic")],
                         ids=["fast", "slow", "t_out", "nearest", "cubic"])
def test_phase_vocoder_matches_jax(kw, stft_pair):
    D, Dt = stft_pair
    if kw.get("t_out") == "grid":
        kw = dict(t_out=np.linspace(0, D.shape[-1] - 1.01, 57))
    got = L.phase_vocoder(Dt, **kw)
    want = np.asarray(lt.phase_vocoder(D, **kw))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.complex64
    assert _snr(got, want) >= PV_SNR_DB
    assert _snr(got.abs(), np.abs(want)) >= PV_MAG_SNR_DB


def test_phase_vocoder_checks_and_warnings(stft_pair):
    D, Dt = stft_pair
    n = D.shape[-1]
    assert L.phase_vocoder(Dt.to(torch.complex128), rate=2.0).dtype == torch.complex128
    with pytest.warns(FutureWarning, match="hop_length"):
        L.phase_vocoder(Dt, rate=1.5, hop_length=512)
    with pytest.warns(FutureWarning, match="n_fft"):
        L.phase_vocoder(Dt, rate=1.5, n_fft=2048)
    with pytest.warns(UserWarning, match="monotonic"):
        L.phase_vocoder(Dt, t_out=np.array([3.0, 1.0, 2.0]))
    for bad in (dict(), dict(rate=1.0, t_out=np.arange(3.0)), dict(rate=0),
                dict(t_out=np.array([0.0, n])), dict(t_out=np.array([-0.5]))):
        with pytest.raises(L.ParameterError):
            L.phase_vocoder(Dt, **bad)


@pytest.mark.parametrize("rate", [1.25, 0.8])
def test_time_stretch_matches_jax(rate):
    y = _signal()
    got = L.effects.time_stretch(y, rate=rate)
    assert tuple(got.shape) == (2, round(SR / rate)) and got.dtype == torch.float32
    assert _snr(got, lt.effects.time_stretch(y, rate=rate)) >= STRETCH_SNR_DB
    kw = dict(n_fft=1024, hop_length=256)
    assert _snr(L.effects.time_stretch(y[0], rate=rate, **kw),
                lt.effects.time_stretch(y[0], rate=rate, **kw)) >= STRETCH_SNR_DB
    with pytest.raises(L.ParameterError):
        L.effects.time_stretch(y, rate=-1)


@pytest.mark.parametrize("kw", [dict(n_steps=3, res_type="fft"),
                                dict(n_steps=-4, bins_per_octave=24, res_type="linear",
                                     scale=True)], ids=["fft", "linear"])
def test_pitch_shift_matches_jax(kw):
    y = _signal()
    got = L.effects.pitch_shift(y, sr=SR, **kw)
    assert tuple(got.shape) == y.shape
    assert _snr(got, lt.effects.pitch_shift(y, sr=SR, **kw)) >= STRETCH_SNR_DB
    with pytest.raises(L.ParameterError):
        L.effects.pitch_shift(y, sr=SR, n_steps=1, bins_per_octave=0)


def _silent_stretch(n=3 * SR):
    """Noise over a tone, with 11025 samples of exact silence: whole frames of zeros."""
    y = _signal(n)
    y[:, SR:SR + SR // 2] = 0
    return y


@pytest.mark.parametrize("rate", [0.7, 1.3])
def test_time_stretch_over_exact_silence_matches_jax(rate):
    y = _silent_stretch()
    got = L.effects.time_stretch(y, rate=rate)
    assert _snr(got, lt.effects.time_stretch(y, rate=rate)) >= STRETCH_SNR_DB


def test_pitch_shift_over_exact_silence_matches_jax():
    y = _silent_stretch()
    got = L.effects.pitch_shift(y, sr=SR, n_steps=2, res_type="fft")
    assert _snr(got, lt.effects.pitch_shift(y, sr=SR, n_steps=2, res_type="fft")) >= STRETCH_SNR_DB


def test_phase_vocoder_takes_exact_zero_bins_as_phase_zero():
    # an FFT may return -0.0 as the real part of a silent bin; torch.angle gives pi there,
    # and the running phase sum would carry it into every later frame
    D = L.stft(torch.from_numpy(_silent_stretch()))
    zero = D == 0
    assert int(zero.sum()) > 1000
    neg_zero = torch.complex(torch.full_like(D.real, -0.0), torch.zeros_like(D.real))
    D_neg = torch.where(zero, neg_zero, D)
    assert bool(torch.signbit(D_neg.real[zero]).all())
    assert float(torch.angle(D_neg[zero]).abs().min()) == pytest.approx(np.pi)
    for rate in (0.7, 1.3):
        assert torch.equal(L.phase_vocoder(D_neg, rate=rate), L.phase_vocoder(D, rate=rate))


@pytest.mark.parametrize("align_zeros", [False, True])
@pytest.mark.parametrize("channels", [1, 2])
def test_remix_matches_jax(align_zeros, channels):
    y = _signal(channels=channels)
    iv = np.array([[0, 4096], [8192, 12288], [4096, 8192], [15000, 15001]])
    got = L.effects.remix(y, iv, align_zeros=align_zeros)
    want = np.asarray(lt.effects.remix(y, iv, align_zeros=align_zeros))
    np.testing.assert_array_equal(got.numpy(), want)


def _gappy(channels):
    y = _signal(n=30000, channels=channels, seed=1)
    y[..., :4000] = 0
    y[..., 12000:16000] *= 1e-4
    y[..., 25000:] = 0
    return y


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("kw", [dict(), dict(top_db=30), dict(ref=0.05, top_db=40),
                                dict(aggregate=np.mean, frame_length=1024, hop_length=256)],
                         ids=["default", "top30", "ref", "mean"])
def test_trim_and_split_match_jax(channels, kw):
    y = _gappy(channels)
    yt, idx = L.effects.trim(y, **kw)
    yt_j, idx_j = lt.effects.trim(y, **kw)
    np.testing.assert_array_equal(idx, np.asarray(idx_j))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yt_j))
    np.testing.assert_array_equal(L.effects.split(y, **kw), np.asarray(lt.effects.split(y, **kw)))
    silent = np.zeros(5000, np.float32)
    np.testing.assert_array_equal(L.effects.trim(silent)[1], np.asarray(lt.effects.trim(silent)[1]))


@pytest.mark.parametrize("zi", [None, "state"])
def test_emphasis_matches_jax(zi):
    y = _signal()
    if zi == "state":
        zi = np.array([[0.1], [-0.2]], dtype=np.float32)
    p, zf = L.effects.preemphasis(y, zi=zi, return_zf=True)
    p_j, zf_j = lt.effects.preemphasis(y, zi=zi, return_zf=True)
    assert tuple(zf.shape) == np.asarray(zf_j).shape == (2, 1)
    assert _snr(p, p_j) >= PRE_SNR_DB and _snr(zf, zf_j) >= PRE_SNR_DB
    d, zf = L.effects.deemphasis(p_j, zi=zi, return_zf=True)
    d_j, zf_j = lt.effects.deemphasis(p_j, zi=zi, return_zf=True)
    assert _snr(d, d_j) >= DE_SNR_DB
    np.testing.assert_allclose(zf.numpy(), np.asarray(zf_j), rtol=DE_ZF_RTOL)
    assert _snr(L.effects.preemphasis(y[0], coef=0.5), lt.effects.preemphasis(y[0], coef=0.5)) \
        >= PRE_SNR_DB


@pytest.mark.parametrize("aggregate", [None, np.average, np.median])
def test_nn_filter_matches_jax(aggregate):
    S = np.abs(np.asarray(lt.stft(_signal(channels=1), n_fft=512))).astype(np.float32)
    got = L.decompose.nn_filter(S, aggregate=aggregate)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, lt.decompose.nn_filter(S, aggregate=aggregate))
    rec = lt.segment.recurrence_matrix(S, mode="affinity", k=5)
    np.testing.assert_array_equal(
        L.decompose.nn_filter(torch.from_numpy(S), rec=rec, aggregate=aggregate),
        lt.decompose.nn_filter(S, rec=rec, aggregate=aggregate))
    with pytest.raises(L.ParameterError, match="shape"):
        L.decompose.nn_filter(S, rec=np.eye(5))


def test_nn_filter_along_axis_0_and_with_kwargs():
    S = np.random.RandomState(2).rand(40, 6).astype(np.float64)
    kw = dict(axis=0, k=4, mode="affinity", metric="cosine")
    np.testing.assert_array_equal(L.decompose.nn_filter(S, **kw), lt.decompose.nn_filter(S, **kw))


def _nonneg(seed=3, shape=(30, 50)):
    return np.abs(np.random.RandomState(seed).randn(*shape))


@pytest.mark.parametrize("kw", [dict(n_components=3, random_state=0, max_iter=400),
                                dict(n_components=4, sort=True, init="nndsvd", random_state=0)],
                         ids=["nmf", "sorted"])
def test_decompose_with_sklearn_matches_jax(kw):
    S = _nonneg()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        W, H = L.decompose.decompose(S, **kw)
        W_j, H_j = lt.decompose.decompose(S, **kw)
    # sorted, the JAX package hands back its float64 components as float32 (no x64)
    np.testing.assert_allclose(W, np.asarray(W_j), rtol=0 if W_j.dtype == W.dtype else 1e-7)
    np.testing.assert_array_equal(H, np.asarray(H_j))
    S3 = np.stack([S, S[::-1]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        W3, H3 = L.decompose.decompose(S3, n_components=3, random_state=0)
        W3_j, H3_j = lt.decompose.decompose(S3, n_components=3, random_state=0)
    assert W3.shape == (2, 30, 3)
    np.testing.assert_array_equal(W3, np.asarray(W3_j))
    with pytest.raises(L.ParameterError, match="2-D"):
        L.decompose.decompose(S3, sort=True)
    with pytest.raises(L.ParameterError, match="pre-fit"):
        L.decompose.decompose(S, fit=False)


def test_nmf_updates_match_jax_from_the_same_start():
    """The JAX package draws its start with ``jax.random``; the same start goes to the port's updates."""
    V = _nonneg(shape=(20, 40)).astype(np.float32)
    k, n_iter, seed = 4, 50, 7
    key1, key2 = jax.random.split(jax.random.PRNGKey(np.uint32(seed)))
    W0 = np.array(jax.random.uniform(key1, (20, k), minval=0.1, maxval=1.0))
    H0 = np.array(jax.random.uniform(key2, (k, 40), minval=0.1, maxval=1.0))
    W_j, H_j = jax_decompose._nmf_mu_run(jnp.asarray(V), np.uint32(seed), k=k, n_iter=n_iter)
    W, H = port_decompose._nmf_mu_run(torch.from_numpy(V), torch.from_numpy(W0),
                                      torch.from_numpy(H0), n_iter=n_iter)
    np.testing.assert_allclose(W.numpy(), np.asarray(W_j), rtol=NMF_RTOL, atol=1e-7)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_j), rtol=NMF_RTOL, atol=1e-7)


def test_mu_decompose_converges_and_is_seeded():
    S = _nonneg(shape=(24, 60)).astype(np.float32)
    W, H = L.decompose.decompose(S, n_components=5, transformer="mu", n_iter=300, seed=1)
    W_j, H_j = lt.decompose.decompose(S, n_components=5, transformer="mu", n_iter=300, seed=1)
    assert W.shape == (24, 5) and H.shape == (5, 60) and (W >= 0).all() and (H >= 0).all()
    err = np.linalg.norm(S - W @ H) / np.linalg.norm(S)
    err_j = np.linalg.norm(S - np.asarray(W_j) @ np.asarray(H_j)) / np.linalg.norm(S)
    assert err < 1.1 * err_j + 1e-3, (err, err_j)
    W2, H2 = L.decompose.decompose(S, n_components=5, transformer="mu", n_iter=300, seed=1)
    np.testing.assert_array_equal(W, W2)
    Ws, _ = L.decompose.decompose(S, n_components=5, transformer="mu", n_iter=10, seed=1,
                                  sort=True)
    assert np.all(np.diff(Ws.argmax(axis=0)) >= 0)
