"""The port's sharded analysis chains against the JAX package's and against the port unsharded.

Onset strength (and multichannel), tempo, PCEN, the constant-Q ladder at 48
and 84 bins, chroma, HPSS (constant, reflect, margins on two channels),
pYIN and beats, each on eight CPU positions. Each chain is held against
the JAX sharded function at the floor that the port's unsharded test of the
same function holds against JAX (the constants below name their files), and
against the port's unsharded function at ``tests/test_parallel.py``'s
tolerance. Each JAX sharded function that can be traced runs under
``jax.jit``: outside it ``shard_map`` dispatches op by op (13.9 s for
``hpss_sharded`` here, against 1.8 s jitted); ``tempo_sharded`` and
``beat_track_sharded`` read their envelope on the host and run as they are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import librosa_tpu as lt
from librosa_tpu import parallel as jp

import librosa_tpu_torch as L
from librosa_tpu_torch import parallel as P
from librosa_tpu_torch.feature.spectral import _cq_chroma

SR = 22050
ENV_SNR_DB = 110.0         # tests/test_torch_onset.py:26
MEDIAN_ENV_SNR_DB = 100.0  # tests/test_torch_onset.py:27
PCEN_SNR_DB = 120.0        # tests/test_torch_pcen_ext.py:6, the port's pcen against JAX's
CQT_SNR_DB = 110.0         # tests/test_torch_constantq.py:30
CHROMA_SNR_DB = 120.0      # tests/test_torch_constantq.py:31
EFFECT_SNR_DB = 105.0      # tests/test_torch_hpss.py:29
YIN_SNR_DB = 120.0         # tests/test_torch_yin.py:23
PROB_RTOL = 1e-5           # tests/test_torch_yin.py:24
# tests/test_parallel.py's tolerances, sharded against unsharded
ENV_ATOL = 2e-5            # :83, :157
PCEN_TOL = 1e-4            # :106
CQT_REL = 1e-5             # :124
HPSS_SHARDED_SNR_DB = 120.0          # :222
HPSS_MARGIN_SHARDED_SNR_DB = 110.0   # :239
CHROMA_SHARDED_SNR_DB = 120.0        # :284
F0_RTOL = 1e-5             # :180
VOICED_PROB_ATOL = 1e-6    # :181
TEMPO_RTOL = 1e-6          # :199-202
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


@pytest.fixture(scope="module")
def jmesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jp.make_mesh((8,), ("time",))


@pytest.fixture(scope="module")
def mesh8():
    return P.make_mesh((8,), ("time",), devices=CPU8)


def _snr(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return 10 * np.log10(np.sum(want**2) / max(np.sum((got - want) ** 2), 1e-300))


def _jax(fn, *args, **kw):
    """``fn(*args, **kw)`` compiled whole by ``jax.jit``, as numpy (a tuple stays a tuple)."""
    out = jax.jit(lambda *a: fn(*a, **kw))(*args)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


def _rng():
    return np.random.RandomState(440)


# ---------------------------------------------------------------------------
# onset strength and tempo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["mono", "multichannel"])
def test_onset_strength_sharded(mesh8, jmesh8, case):
    n = 8 * 512 * 16
    if case == "mono":
        t = np.arange(n) / SR
        y = (0.4 * np.sin(2 * np.pi * 220 * t) + 0.05 * _rng().randn(n)).astype(np.float32)
    else:
        y = (_rng().randn(2, n) * 0.1).astype(np.float32)
    got = P.onset_strength_sharded(y, mesh=mesh8)
    want = L.onset.onset_strength(y=y, sr=SR)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ENV_ATOL)
    assert _snr(got.numpy(), _jax(jp.onset_strength_sharded, y, mesh=jmesh8)) >= ENV_SNR_DB


def test_onset_strength_sharded_median_lag_and_uncentred(mesh8, jmesh8):
    n = 8 * 512 * 16
    y = (_rng().randn(n) * 0.1).astype(np.float32)
    y[::5000] += 1.0
    kw = dict(lag=2, center=False, hop_length=256, n_fft=1024)
    got = P.onset_strength_sharded(y, mesh=mesh8, aggregate=np.median, **kw)
    want = L.onset.onset_strength(y=y, sr=SR, aggregate=np.median, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ENV_ATOL)
    jax_got = _jax(jp.onset_strength_sharded, y, mesh=jmesh8, aggregate=jnp.median, **kw)
    assert _snr(got.numpy(), jax_got) >= MEDIAN_ENV_SNR_DB


def test_onset_strength_sharded_clamps_each_channel_as_power_to_db(mesh8, jmesh8):
    """Two channels 100 dB apart: the port clamps each at its own peak - 80 dB, as the
    unsharded ``power_to_db`` does in both packages; the JAX sharded function clamps both at
    the louder one's, so its quiet channel leaves its own unsharded envelope."""
    n = 8 * 512 * 16
    rng = _rng()
    y = np.stack([rng.randn(n), 1e-5 * rng.randn(n)]).astype(np.float32)
    got = P.onset_strength_sharded(y, mesh=mesh8)
    np.testing.assert_allclose(got.numpy(), L.onset.onset_strength(y=y, sr=SR).numpy(),
                               atol=ENV_ATOL)
    jax_got = _jax(jp.onset_strength_sharded, y, mesh=jmesh8)
    assert _snr(got.numpy()[0], jax_got[0]) >= ENV_SNR_DB
    assert np.abs(jax_got[1] - np.asarray(lt.onset.onset_strength(y=y, sr=SR))[1]).max() > 1.0


def test_tempo_sharded(mesh8, jmesh8):
    pulse = np.zeros(8 * 512 * 16, dtype=np.float32)
    pulse[::SR // 2] = 1.0  # 120 bpm
    got = P.tempo_sharded(pulse, mesh=mesh8)
    want = L.feature.tempo(onset_envelope=L.onset.onset_strength(y=pulse, sr=SR), sr=SR)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jp.tempo_sharded(pulse, mesh=jmesh8)))


def test_pcen_sharded_carries_the_state_across_positions(mesh8, jmesh8):
    S = (np.abs(_rng().randn(64, 256)) * 100).astype(np.float32)
    got = P.pcen_sharded(S, mesh=mesh8)
    np.testing.assert_allclose(got.numpy(), L.pcen(S, sr=SR).numpy(), atol=PCEN_TOL,
                               rtol=PCEN_TOL)
    assert _snr(got.numpy(), _jax(jp.pcen_sharded, S, mesh=jmesh8)) >= PCEN_SNR_DB
    with pytest.raises(L.ParameterError):
        P.pcen_sharded(S[:, :250], mesh=mesh8)


# ---------------------------------------------------------------------------
# the constant-Q ladder and chroma
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cq_signal():
    n = 8 * 512 * 64
    t = np.arange(n) / SR
    return (0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 1760 * t)
            + 0.02 * _rng().randn(n)).astype(np.float32)


@pytest.mark.parametrize("n_bins", [48, 84])
def test_cqt_sharded(mesh8, jmesh8, cq_signal, n_bins):
    got = P.cqt_sharded(cq_signal, mesh=mesh8, sr=SR, n_bins=n_bins, hop_length=512)
    want = L.cqt(cq_signal, sr=SR, n_bins=n_bins, hop_length=512, res_type="polyphase")
    assert got.shape == want.shape and got.dtype == torch.complex64
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < CQT_REL, rel
    jax_got = _jax(jp.cqt_sharded, cq_signal, mesh=jmesh8, sr=SR, n_bins=n_bins, hop_length=512)
    assert _snr(np.stack([got.real, got.imag]), np.stack([jax_got.real, jax_got.imag])) \
        >= CQT_SNR_DB


def test_chroma_cqt_sharded(mesh8, jmesh8):
    n = 8 * 512 * 64
    t = np.arange(n) / SR
    y = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.1 * _rng().randn(n)).astype(np.float32)
    kw = dict(sr=SR, hop_length=512, n_octaves=4, bins_per_octave=12)
    got = P.chroma_cqt_sharded(y, mesh=mesh8, **kw)
    fmin = float(L.note_to_hz("C1"))
    C = L.cqt(y, sr=SR, hop_length=512, fmin=fmin, n_bins=48, bins_per_octave=12,
              res_type="polyphase").abs()
    want = _cq_chroma(C, bins_per_octave=12, n_chroma=12, fmin=fmin, window=None, norm=np.inf,
                      threshold=0.0)
    assert _snr(got.numpy(), want.numpy()) >= CHROMA_SHARDED_SNR_DB
    assert _snr(got.numpy(), _jax(jp.chroma_cqt_sharded, y, mesh=jmesh8, **kw)) >= CHROMA_SNR_DB


# ---------------------------------------------------------------------------
# HPSS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["constant", "reflect", "margins_multichannel"])
def test_hpss_sharded(mesh8, jmesh8, case):
    n = 8 * 512 * 48
    if case == "margins_multichannel":
        y = (0.1 * _rng().randn(2, n)).astype(np.float32)
        kw, floor = dict(margin=2.0, kernel_size=17), HPSS_MARGIN_SHARDED_SNR_DB
    else:
        t = np.arange(n) / SR
        y = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.2 * _rng().randn(n)).astype(np.float32)
        kw, floor = dict(pad_mode=case), HPSS_SHARDED_SNR_DB
    got = P.hpss_sharded(y, mesh=mesh8, **kw)
    want = L.effects.hpss(y, **kw)
    jax_got = _jax(jp.hpss_sharded, y, mesh=jmesh8, **kw)
    for g, w, j in zip(got, want, jax_got):
        assert g.shape == w.shape
        assert _snr(g.numpy(), w.numpy()) >= floor
        assert _snr(g.numpy(), j) >= EFFECT_SNR_DB


# ---------------------------------------------------------------------------
# pYIN and beats
# ---------------------------------------------------------------------------


def test_pyin_sharded(mesh8, jmesh8):
    n = 8 * 512 * 24
    t = np.arange(n) / SR
    f_true = 220 * 2 ** (0.5 * np.sin(2 * np.pi * 0.7 * t))
    y = (0.4 * np.sin(2 * np.pi * np.cumsum(f_true) / SR)).astype(np.float32)
    f0, vf, vp = P.pyin_sharded(y, mesh=mesh8, fmin=65, fmax=800, sr=SR)
    f0_r, vf_r, vp_r = L.pyin(y, fmin=65, fmax=800, sr=SR)
    assert f0.shape == f0_r.shape
    assert torch.equal(vf, vf_r)
    both = torch.isfinite(f0) & torch.isfinite(f0_r)
    np.testing.assert_allclose(f0[both].numpy(), f0_r[both].numpy(), rtol=F0_RTOL)
    np.testing.assert_allclose(vp.numpy(), vp_r.numpy(), atol=VOICED_PROB_ATOL)
    f0_j, vf_j, vp_j = _jax(jp.pyin_sharded, y, mesh=jmesh8, fmin=65, fmax=800, sr=SR)
    np.testing.assert_allclose(vp.numpy(), vp_j, rtol=PROB_RTOL, atol=1e-7)
    np.testing.assert_array_equal(vf.numpy(), vf_j)
    np.testing.assert_array_equal(np.isnan(f0.numpy()), np.isnan(f0_j))
    assert _snr(np.nan_to_num(f0.numpy()), np.nan_to_num(f0_j)) >= YIN_SNR_DB


def test_beat_track_sharded(mesh8, jmesh8):
    n = 8 * 512 * 32
    y = 0.01 * _rng().randn(n).astype(np.float32)
    for s in range(0, n - 256, SR // 2):
        y[s:s + 256] += np.hanning(256).astype(np.float32)
    tempo, beats = P.beat_track_sharded(y, mesh=mesh8, sr=SR, hop_length=512)
    tempo_r, beats_r = L.beat.beat_track(y=y, sr=SR, hop_length=512)
    np.testing.assert_allclose(np.asarray(tempo, dtype=float), np.asarray(tempo_r, dtype=float),
                               rtol=TEMPO_RTOL)
    np.testing.assert_array_equal(beats, beats_r)
    tempo_j, beats_j = jp.beat_track_sharded(y, mesh=jmesh8, sr=SR, hop_length=512)
    np.testing.assert_array_equal(np.atleast_1d(tempo), np.atleast_1d(np.asarray(tempo_j)))
    np.testing.assert_array_equal(beats, np.asarray(beats_j))


def test_beat_track_sharded_on_a_batch(mesh8):
    """Two tracks: the envelopes of both, then the batched beat DP (kernel A on the card)."""
    n = 8 * 512 * 32
    y = 0.01 * _rng().randn(2, n).astype(np.float32)
    for r, period in enumerate((SR // 2, SR // 3)):
        for s in range(0, n - 256, period):
            y[r, s:s + 256] += np.hanning(256).astype(np.float32)
    tempo, mask = P.beat_track_sharded(y, mesh=mesh8, sr=SR, sparse=False)
    tempo_r, mask_r = L.beat.beat_track(y=y, sr=SR, sparse=False)
    np.testing.assert_allclose(tempo, tempo_r, rtol=TEMPO_RTOL)
    np.testing.assert_array_equal(mask, mask_r)
