"""The port's beat tracker and predominant local pulse against the JAX package on the CPU.

Tolerances: the beat DP's backlinks equal (both pick the best predecessor of
the same float32 scores; cumulative scores to 1e-6 relative, as XLA may fuse
the penalty differently), the host DP bit for bit against the JAX package's
C++ loop (the same float64 operations) and to 1e-12 against its numpy twin,
beat frames equal where both see the same envelope and within one frame
(the ``beat`` golden's rule) where each computes its own, and 110 dB on
``plp`` (the ``plp`` golden's floor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import librosa_tpu as lt
from librosa_tpu import beat as jax_beat

import librosa_tpu_torch as L
from librosa_tpu_torch.ops import beat_dp as port_dp

SR = 22050
PLP_SNR_DB = 110.0
CUM_RTOL = 1e-6


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


def _pulse(n=5 * SR, period=11025, seed=0):
    rng = np.random.RandomState(seed)
    y = 0.02 * rng.randn(n)
    for start in range(1000, n - 600, period):
        y[start:start + 400] += np.hanning(400) * np.sin(np.arange(400) * 0.5)
    return y.astype(np.float32)


def _envelopes(rows=3, T=400, period=22, seed=1):
    rng = np.random.RandomState(seed)
    env = 0.2 * np.abs(rng.randn(rows, T))
    for r in range(rows):
        env[r, (2 * r)::period] += 1.0 + 0.1 * r
    return env.astype(np.float32)


def _within_one(got, want):
    got, want = np.sort(np.asarray(got)), np.sort(np.asarray(want))
    assert abs(len(got) - len(want)) <= 1, (got, want)
    n = min(len(got), len(want))
    assert any(np.all(np.abs(got[o:o + n] - want[:n]) <= 1) for o in range(len(got) - n + 1)) \
        or np.all(np.abs(got[:n] - want[:n]) <= 1), (got, want)


# ---------------------------------------------------------------------------
# the two DPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tv", [False, True], ids=["fixed", "per_frame"])
def test_batched_dp_plain_version_matches_the_jax_scan(tv):
    rng = np.random.RandomState(2)
    R, T = 4, 300
    ls = rng.randn(R, T).astype(np.float32)
    ls[1] = -np.abs(ls[1])  # all negative: first-beat gating on its maximum
    fpb = (rng.randint(10, 40, size=(R, T if tv else 1))).astype(np.float32)
    fpb[2] = 700.0  # 2 fpb beyond the window of 1024
    bl, cs = port_dp.beat_dp_reference(torch.from_numpy(ls), torch.from_numpy(fpb), 100.0)
    bl_j, cs_j = jax.vmap(lambda a, b: jax_beat._beat_dp_scan(a, b, 100.0, tv=tv))(
        jnp.asarray(ls), jnp.asarray(fpb))
    np.testing.assert_array_equal(bl.numpy(), np.asarray(bl_j))
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j), rtol=CUM_RTOL, atol=1e-5)


@pytest.mark.parametrize("tv", [False, True], ids=["fixed", "per_frame"])
def test_host_dp_matches_the_jax_host_dp(tv):
    rng = np.random.RandomState(3)
    T = 500
    ls = rng.randn(T)
    fpb = rng.randint(10, 40, size=T if tv else 1).astype(np.float64)
    from librosa_tpu._native import beat_dp as jax_native_dp

    bl, cs = port_dp.beat_dp_host(ls, fpb, 100.0)
    bl_j, cs_j = jax_native_dp(ls, fpb, 100.0)  # the JAX package's C++ loop: the same bits
    np.testing.assert_array_equal(bl, bl_j)
    np.testing.assert_array_equal(cs, cs_j)
    bl_py, cs_py = jax_beat._beat_dp_host(ls, fpb, 100.0)  # its numpy twin: the same links
    np.testing.assert_array_equal(bl, bl_py)
    np.testing.assert_allclose(cs, cs_py, rtol=1e-12)


def test_the_two_dps_break_ties_apart_and_the_port_keeps_both():
    """Equal scores: the device scan keeps the nearest predecessor, the host DP the farthest."""
    T, fpb = 60, 8.0
    zeros = np.zeros(T)
    bl_scan = np.asarray(jax_beat._beat_dp_scan(jnp.zeros(T), jnp.full(1, fpb), 0.0, tv=False)[0])
    bl_host, _ = jax_beat._beat_dp_host(zeros, np.full(1, fpb), 0.0)
    i = np.arange(T)
    np.testing.assert_array_equal(bl_scan[4:], i[4:] - 4)  # d = round(fpb / 2)
    np.testing.assert_array_equal(bl_host[16:], i[16:] - 16)  # d = 2 fpb
    bl_plain, _ = port_dp.beat_dp_reference(torch.zeros(1, T), torch.full((1, 1), fpb), 0.0)
    np.testing.assert_array_equal(bl_plain[0].numpy(), bl_scan)
    np.testing.assert_array_equal(port_dp.beat_dp_host(zeros, np.full(1, fpb), 0.0)[0], bl_host)


def test_beat_dp_routes_and_refusals():
    ls, fpb = torch.zeros(2, 5), torch.ones(2, 1)
    assert port_dp.kernel_refusal(ls, fpb) is None
    assert port_dp.kernel_refusal(ls, torch.ones(2, 5)) is None
    assert "float32" in port_dp.kernel_refusal(ls.double(), fpb)
    assert "shape" in port_dp.kernel_refusal(ls, torch.ones(2, 3))
    assert "(rows, frames)" in port_dp.kernel_refusal(ls[0], fpb)
    before = port_dp.launches
    port_dp.beat_dp(ls, fpb, 100.0)  # a CPU tensor runs the plain version
    assert port_dp.launches == before


# ---------------------------------------------------------------------------
# beat_track
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"units": "time"}, {"trim": False, "tightness": 400},
                                {"bpm": 118.0, "units": "samples"}, {"start_bpm": 90.0}],
                         ids=["frames", "time", "untrimmed", "bpm", "start90"])
def test_beat_track_one_envelope_matches_jax(kw):
    env = _envelopes(rows=1)[0]
    tempo, beats = L.beat.beat_track(onset_envelope=env, sr=SR, **kw)
    tempo_j, beats_j = lt.beat.beat_track(onset_envelope=env, sr=SR, **kw)
    np.testing.assert_array_equal(np.asarray(tempo), np.asarray(tempo_j))
    np.testing.assert_array_equal(beats, np.asarray(beats_j))


def test_beat_track_per_frame_tempo_matches_jax():
    env = _envelopes(rows=1, seed=4)[0]
    bpm = np.linspace(110, 130, env.shape[-1])
    _, beats = L.beat.beat_track(onset_envelope=env, sr=SR, bpm=bpm)
    _, beats_j = lt.beat.beat_track(onset_envelope=env, sr=SR, bpm=bpm)
    np.testing.assert_array_equal(beats, np.asarray(beats_j))


def test_beat_track_from_y_matches_jax():
    y = _pulse()
    tempo, beats = L.beat.beat_track(y=y, sr=SR)
    tempo_j, beats_j = lt.beat.beat_track(y=y, sr=SR)
    np.testing.assert_array_equal(np.atleast_1d(tempo), np.atleast_1d(tempo_j))
    _within_one(beats, beats_j)


def test_beat_track_batch_matches_jax():
    env = _envelopes(rows=3)
    tempo, mask = L.beat.beat_track(onset_envelope=env, sr=SR, bpm=117.0, sparse=False)
    _, mask_j = lt.beat.beat_track(onset_envelope=env, sr=SR, bpm=117.0, sparse=False)
    np.testing.assert_array_equal(mask, np.asarray(mask_j))
    tempo, mask = L.beat.beat_track(onset_envelope=env, sr=SR, sparse=False)
    tempo_j, _ = lt.beat.beat_track(onset_envelope=env, sr=SR, sparse=False)
    np.testing.assert_array_equal(tempo, np.asarray(tempo_j))
    assert mask.shape == env.shape and mask.dtype == bool


def test_beat_track_batch_at_per_row_tempi_matches_jax():
    """Per-row tempi: the batch beats as the JAX package's batch does.

    Both smooth every row with the window of the first row's tempo and run
    each row's DP at its own tempo; the first row beats as it does alone.
    """
    env = _envelopes(rows=2, period=25)
    env[1] = _envelopes(rows=1, period=17, seed=5)[0]
    bpm = np.array([60 * SR / 512 / 25, 60 * SR / 512 / 17])
    _, mask = L.beat.beat_track(onset_envelope=env, sr=SR, bpm=bpm, sparse=False)
    _, mask_j = lt.beat.beat_track(onset_envelope=env, sr=SR, bpm=bpm, sparse=False)
    np.testing.assert_array_equal(mask, np.asarray(mask_j))
    _, alone_j = lt.beat.beat_track(onset_envelope=env[0], sr=SR, bpm=bpm[0])
    _within_one(np.flatnonzero(mask[0]), np.asarray(alone_j))


def test_beat_track_batch_sends_every_batch_to_the_kernel_wrapper(monkeypatch):
    """The batched DP always goes through ``beat_dp``, which on the card launches or raises."""
    calls = []
    wrapped = port_dp.beat_dp

    def spy(ls, fpb, tightness):
        calls.append((ls.dtype, tuple(ls.shape), tuple(fpb.shape)))
        return wrapped(ls, fpb, tightness)

    monkeypatch.setattr(port_dp, "beat_dp", spy)
    env = _envelopes(rows=3)
    L.beat.beat_track(onset_envelope=env.astype(np.float64), sr=SR, bpm=117.0, sparse=False)
    L.beat.beat_track(onset_envelope=env[0], sr=SR, bpm=117.0)  # one envelope: the host DP
    assert calls == [(torch.float32, (3, env.shape[-1]), (3, 1))]


def test_beat_track_edges():
    tempo, beats = L.beat.beat_track(onset_envelope=np.zeros(100, np.float32), sr=SR)
    assert tempo == 0.0 and beats.shape == (0,)
    tempo, mask = L.beat.beat_track(onset_envelope=np.zeros((2, 100), np.float32), sparse=False)
    assert tempo.shape == (2,) and not mask.any()
    with pytest.raises(L.ParameterError):
        L.beat.beat_track(onset_envelope=_envelopes(rows=2))
    with pytest.raises(L.ParameterError):
        L.beat.beat_track(onset_envelope=_envelopes(rows=1)[0], bpm=-5.0)
    with pytest.raises(L.ParameterError):
        L.beat.beat_track()


# ---------------------------------------------------------------------------
# plp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"tempo_min": None, "tempo_max": 200},
                                {"win_length": 200, "hop_length": 256}],
                         ids=["default", "band", "window"])
def test_plp_matches_jax(kw):
    env = _envelopes(rows=2, T=300)
    got = L.beat.plp(onset_envelope=env, sr=SR, **kw)
    want = lt.beat.plp(onset_envelope=env, sr=SR, **kw)
    assert _snr(got.numpy(), want) >= PLP_SNR_DB


def test_plp_from_y_and_with_a_prior_matches_jax():
    import scipy.stats

    y = _pulse(n=3 * SR)
    assert _snr(L.beat.plp(y=y, sr=SR).numpy(), lt.beat.plp(y=y, sr=SR)) >= PLP_SNR_DB
    env = _envelopes(rows=1, T=300)[0]
    prior = scipy.stats.lognorm(loc=np.log(120), scale=120, s=1)
    got = L.beat.plp(onset_envelope=env, sr=SR, prior=prior)
    assert _snr(got.numpy(), lt.beat.plp(onset_envelope=env, sr=SR, prior=prior)) >= PLP_SNR_DB
    with pytest.raises(L.ParameterError):
        L.beat.plp(onset_envelope=env, tempo_min=200, tempo_max=100)


def test_onset_beat_pyin_forward_matches_the_jax_chain():
    """entry.onset_beat_pyin() on 2 tracks of 3 s against the same chain of JAX functions.

    The envelope at the median floor of ``test_torch_onset.py`` (100 dB),
    the tempo equal, the beats within a frame (each side smooths its own
    envelope), pYIN's voicing equal in 99 % of frames and ``f0`` at 100 dB
    where both say voiced.
    """
    import jax.numpy as jnp

    from librosa_tpu_torch.entry import onset_beat_pyin

    fwd, (example,) = onset_beat_pyin()
    assert example.shape == (2, 4 * SR)
    t = np.arange(3 * SR) / SR
    tone = 0.3 * np.sin(2 * np.pi * 220.0 * t * (1 + 0.02 * t))
    y = np.stack([_pulse(n=3 * SR, seed=6) + tone, _pulse(n=3 * SR, period=9000, seed=7)])
    y = y.astype(np.float32)
    env, tempo, beats, (f0, vflag, vprob) = fwd(y)
    env_j = lt.onset.onset_strength(y=y, sr=SR, hop_length=512, aggregate=jnp.median)
    tempo_j = lt.feature.tempo(onset_envelope=np.asarray(env_j), sr=SR, hop_length=512)
    _, beats_j = lt.beat.beat_track(onset_envelope=np.asarray(env_j), sr=SR, bpm=tempo_j,
                                    sparse=False)
    f0_j, vflag_j, _ = lt.pyin(y, fmin=65, fmax=800, sr=SR)
    assert _snr(env.numpy(), env_j) >= 100.0
    np.testing.assert_array_equal(tempo, np.asarray(tempo_j))
    assert beats.shape == env.shape and beats.dtype == bool
    for r in range(2):
        _within_one(np.flatnonzero(beats[r]), np.flatnonzero(np.asarray(beats_j)[r]))
    vflag_j = np.asarray(vflag_j)
    assert (vflag.numpy() == vflag_j).mean() >= 0.99
    both = vflag.numpy() & vflag_j
    assert _snr(f0.numpy()[both], np.asarray(f0_j)[both]) >= 100.0
