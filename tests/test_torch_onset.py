"""The port's onset functions and the utilities under them against the JAX package on the CPU.

Tolerances: 110 dB on onset envelopes (the ``onset_strength`` golden's
floor; the mel spectrogram, dB and flux are float32 in both), 100 dB where
the median folds the bands (it keeps one band's float32 rounding per frame
where the mean averages 128 of them: 104 dB measured), 1e-5 relative
on ``sync`` and ``first_order_filter`` (sums in another order), and equality
for everything that picks, matches or indexes (peak picking, backtracking,
matching, ``fix_frames``): those choose the same frames from the same
inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import librosa_tpu as lt
from librosa_tpu.ops import iir as jax_iir

import librosa_tpu_torch as L
from librosa_tpu_torch.ops import iir as port_iir
from librosa_tpu_torch.ops import peaks as port_peaks

SR = 22050
ENV_SNR_DB = 110.0
MEDIAN_ENV_SNR_DB = 100.0
SYNC_RTOL = 1e-5


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


def _clicks(n=2 * SR, seed=0, channels=None):
    rng = np.random.RandomState(seed)
    shape = (n,) if channels is None else (channels, n)
    y = 0.01 * rng.randn(*shape)
    for start in range(2000, n - 800, 5000 + 37 * seed):
        y[..., start:start + 600] += np.hanning(600) * np.sin(np.arange(600) * 0.3)
    return y.astype(np.float32)


# ---------------------------------------------------------------------------
# onset_strength and onset_strength_multi
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {},
    {"aggregate": np.median},
    {"lag": 2, "max_size": 3},
    {"detrend": True},
    {"center": False, "hop_length": 256},
    {"n_mels": 64, "fmax": 8000.0},
], ids=["default", "median", "superflux", "detrend", "uncentred", "mel_kwargs"])
def test_onset_strength_matches_jax(kw):
    y = _clicks(channels=2)
    jax_kw = {k: (jnp.median if v is np.median else v) for k, v in kw.items()}
    got = L.onset.onset_strength(y=y, sr=SR, **kw)
    want = lt.onset.onset_strength(y=y, sr=SR, **jax_kw)
    floor = MEDIAN_ENV_SNR_DB if kw.get("aggregate") is np.median else ENV_SNR_DB
    assert _snr(got.numpy(), want) >= floor


def test_onset_strength_from_S_and_ref():
    rng = np.random.RandomState(1)
    S = (rng.randn(3, 40, 60) * 10).astype(np.float32)
    ref = (rng.randn(3, 40, 60) * 10).astype(np.float32)
    for kw in ({"S": S}, {"S": S, "ref": ref}, {"S": S[0], "lag": 3, "center": False}):
        got = L.onset.onset_strength(**kw)
        want = lt.onset.onset_strength(**kw)
        assert _snr(got.numpy(), want) >= ENV_SNR_DB, sorted(kw)


@pytest.mark.parametrize("kw", [
    {"channels": [0, 32, 64, 96, 128]},
    {"channels": [slice(0, 10), slice(10, 128)], "aggregate": np.max},
    {"channels": [0, 16, 128], "max_size": 5, "detrend": True},
    {"aggregate": False},
], ids=["bands", "slices_max", "superflux_detrend", "unaggregated"])
def test_onset_strength_multi_matches_jax(kw):
    y = _clicks(seed=1)
    got = L.onset.onset_strength_multi(y=y, sr=SR, **kw)
    want = lt.onset.onset_strength_multi(y=y, sr=SR, **kw)
    assert _snr(got.numpy(), want) >= ENV_SNR_DB


def test_onset_strength_with_another_feature_matches_jax():
    """A feature other than the mel spectrogram: each package's own chroma_stft."""
    y = _clicks(seed=3)
    got = L.onset.onset_strength(y=y, sr=SR, feature=L.feature.chroma_stft, tuning=0.0)
    want = lt.onset.onset_strength(y=y, sr=SR, feature=lt.feature.chroma_stft, tuning=0.0)
    assert _snr(got.numpy(), want) >= ENV_SNR_DB


def test_onset_strength_rejects_what_jax_rejects():
    y = _clicks()
    with pytest.raises(L.ParameterError):
        L.onset.onset_strength(y=y, aggregate=False)
    for bad in ({"lag": 0}, {"max_size": 1.5}):
        with pytest.raises(L.ParameterError):
            L.onset.onset_strength(y=y, **bad)


# ---------------------------------------------------------------------------
# onset_detect and onset_backtrack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {},
    {"units": "time"},
    {"units": "samples", "backtrack": True},
    {"sparse": False},
    {"normalize": False, "delta": 0.2, "wait": 4},
], ids=["frames", "time", "backtrack", "dense", "overrides"])
def test_onset_detect_matches_jax(kw):
    y = _clicks(seed=2)
    got = L.onset.onset_detect(y=y, sr=SR, **kw)
    want = lt.onset.onset_detect(y=y, sr=SR, **kw)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_onset_detect_on_a_batch_and_on_silence():
    env = np.abs(np.random.RandomState(3).randn(3, 200)).astype(np.float32)
    got = L.onset.onset_detect(onset_envelope=env, sr=SR, sparse=False)
    want = lt.onset.onset_detect(onset_envelope=env, sr=SR, sparse=False)
    np.testing.assert_array_equal(got, np.asarray(want))
    silent = L.onset.onset_detect(onset_envelope=np.zeros(50, np.float32))
    assert silent.shape == (0,)


def test_onset_backtrack_matches_jax():
    rng = np.random.RandomState(4)
    energy = np.abs(rng.randn(300))
    events = np.sort(rng.choice(np.arange(5, 300), 12, replace=False))
    got = L.onset.onset_backtrack(events, torch.from_numpy(energy))
    np.testing.assert_array_equal(got, lt.onset.onset_backtrack(events, energy))


# ---------------------------------------------------------------------------
# peak_pick
# ---------------------------------------------------------------------------

PICK = dict(pre_max=3, post_max=3, pre_avg=5, post_avg=5, delta=0.3, wait=8)


@pytest.mark.parametrize("method", ["greedy", "dp_count", "dp_value"])
def test_peak_pick_one_envelope_matches_jax(method):
    x = np.abs(np.random.RandomState(5).randn(400))
    got = L.util.peak_pick(x, method=method, **PICK)
    np.testing.assert_array_equal(got, lt.util.peak_pick(x, method=method, **PICK))
    got = L.util.peak_pick(torch.from_numpy(x), method=method, sparse=False, pre_max=2.5,
                           post_max=1, pre_avg=0, post_avg=3, delta=0.0, wait=0)
    want = lt.util.peak_pick(x, method=method, sparse=False, pre_max=2.5, post_max=1,
                             pre_avg=0, post_avg=3, delta=0.0, wait=0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["greedy", "dp_count", "dp_value"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_peak_pick_batch_matches_jax(method, axis):
    x = np.abs(np.random.RandomState(6).randn(4, 150)).astype(np.float32)
    x = x if axis == -1 else x.T.copy()
    got = L.util.peak_pick(x, method=method, sparse=False, axis=axis, **PICK)
    want = lt.util.peak_pick(x, method=method, sparse=False, axis=axis, **PICK)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_peak_pick_batch_selection_equals_one_row_at_a_time():
    """The host loops over all rows at once pick what the float64 one-envelope loops pick."""
    x = np.abs(np.random.RandomState(7).randn(5, 300)).astype(np.float32)
    win = {k: PICK[k] for k in ("pre_max", "post_max", "pre_avg", "post_avg")}
    cand = port_peaks.candidate_mask(torch.from_numpy(x), delta=0.3, **win).numpy()
    greedy = port_peaks.greedy_select(cand, 8)
    counted = port_peaks.dp_select(cand, np.ones(x.shape, np.float32), 8)
    for r in range(5):
        row = x[r].astype(np.float64)
        np.testing.assert_array_equal(greedy[r], port_peaks.greedy_1d(row, delta=0.3, wait=8,
                                                                      **win))
        np.testing.assert_array_equal(counted[r], port_peaks.dp_1d(row, delta=0.3, wait=8,
                                                                   count=True, **win))


def test_peak_pick_rejects_what_jax_rejects():
    x = np.ones(20)
    for bad in ({"pre_max": -1}, {"post_max": 0}, {"post_avg": 0}, {"delta": -1},
                {"wait": -1}, {"method": "best"}):
        kw = dict(PICK, **bad)
        with pytest.raises(L.ParameterError):
            L.util.peak_pick(x, **kw)
    with pytest.raises(L.ParameterError):
        L.util.peak_pick(np.ones((2, 20)), **PICK)


# ---------------------------------------------------------------------------
# sync, fix_frames, index_to_slice, valid_int
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aggregate", [None, np.mean, np.max, np.min, np.median, np.sum,
                                       np.std], ids=lambda f: getattr(f, "__name__", "none"))
def test_sync_matches_jax(aggregate):
    X = np.random.RandomState(8).randn(2, 6, 64).astype(np.float32)
    for idx, kw in (([0, 10, 25, 40, 64], {}), ([3, 10, 25], {"pad": False}),
                    ([slice(0, 10), slice(10, 30), slice(30, 64, 2)], {})):
        got = L.util.sync(X, idx, aggregate=aggregate, **kw)
        want = lt.util.sync(X, idx, aggregate=aggregate, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SYNC_RTOL, atol=1e-6)
    got = L.util.sync(X, [0, 2, 5], aggregate=aggregate, axis=-2)
    want = lt.util.sync(X, [0, 2, 5], aggregate=aggregate, axis=-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SYNC_RTOL, atol=1e-6)


def test_frame_index_helpers_match_jax():
    frames = np.array([1, 2, 5, 99, 5])
    for kw in ({"x_min": 0, "x_max": 10}, {"x_min": 3, "x_max": None, "pad": False},
               {"x_min": None, "x_max": 50, "pad": True}):
        np.testing.assert_array_equal(L.util.fix_frames(frames, **kw),
                                      lt.util.fix_frames(frames, **kw))
    assert L.util.index_to_slice(np.array([2, 5, 8])) == lt.util.index_to_slice(np.array([2, 5, 8]))
    assert (L.util.index_to_slice(np.array([2, 5]), idx_min=0, idx_max=9, step=2)
            == lt.util.index_to_slice(np.array([2, 5]), idx_min=0, idx_max=9, step=2))
    assert L.util.valid_int(3.7) == 3 and L.util.valid_int(3.2, cast=np.ceil) == 4
    with pytest.raises(L.ParameterError):
        L.util.fix_frames([-1, 2])
    with pytest.raises(L.ParameterError):
        L.util.valid_int(2.0, cast=3)


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------


def test_matching_matches_jax():
    rng = np.random.RandomState(9)
    ev_from, ev_to = np.sort(rng.rand(15) * 100), np.sort(rng.rand(8) * 100)
    for kw in ({}, {"left": False}, {"right": False}):
        src = ev_from if kw != {"left": False} else ev_from[ev_from <= ev_to.max()]
        src = src if kw != {"right": False} else src[src >= ev_to.min()]
        np.testing.assert_array_equal(L.util.match_events(torch.from_numpy(src), ev_to, **kw),
                                      lt.util.match_events(src, ev_to, **kw))
    starts = np.arange(10, dtype=np.float64)
    iv_from = np.stack([starts, starts + 1.0], axis=1)
    iv_to = np.stack([starts[::3] + 0.5, starts[::3] + 0.9], axis=1)
    np.testing.assert_array_equal(L.util.match_intervals(iv_from, iv_to, strict=False),
                                  lt.util.match_intervals(iv_from, iv_to, strict=False))
    with pytest.raises(L.ParameterError):
        L.util.match_intervals(iv_from, iv_to, strict=True)
    with pytest.raises(L.ParameterError):
        L.util.match_events([], ev_to)


# ---------------------------------------------------------------------------
# first_order_filter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coef", [(1.0, -1.0, -0.99), (0.5, 0.2, 0.7), (1.0, -0.97, 0.0)])
def test_first_order_filter_matches_jax(coef):
    b0, b1, a1 = coef
    rng = np.random.RandomState(10)
    x = rng.randn(3, 1000).astype(np.float32)
    zi = rng.randn(3).astype(np.float32)
    y, zf = port_iir.first_order_filter(torch.from_numpy(x), b0=b0, b1=b1, a1=a1,
                                        zi=torch.from_numpy(zi))
    y_j, zf_j = jax_iir.first_order_filter(jnp.asarray(x), b0=b0, b1=b1, a1=a1,
                                           zi=jnp.asarray(zi))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=SYNC_RTOL, atol=2e-5)
    np.testing.assert_allclose(zf.numpy(), np.asarray(zf_j), rtol=SYNC_RTOL, atol=2e-5)
    y0, _ = port_iir.first_order_filter(torch.from_numpy(x.T.copy()), b0=b0, b1=b1, a1=a1,
                                        zi=torch.zeros(3), axis=0)
    y1, _ = port_iir.first_order_filter(torch.from_numpy(x), b0=b0, b1=b1, a1=a1,
                                        zi=torch.zeros(3))
    np.testing.assert_array_equal(y0.numpy().T, y1.numpy())
