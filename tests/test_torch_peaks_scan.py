"""The port's wait-spaced peak selection (``ops/peaks.py``) against the JAX package's scans.

``greedy_mask``, ``dp_values`` and ``dp_mask`` get the same float32
envelopes, made from a seed with numpy, as ``librosa_tpu.ops.peaks``; on CPU
tensors the port runs the plain loops that the ``peak_scan`` kernels equal
bit for bit on the card (``chip_smoke.py`` phase 4p). The masks must be
equal, not close.
"""

import numpy as np
import pytest
import torch

from librosa_tpu.ops import peaks as jax_peaks
from librosa_tpu.util import peak_pick as jax_peak_pick

import librosa_tpu_torch as L
from librosa_tpu_torch.ops import peaks

ROWS, T = 3, 500
WINDOWS = [
    dict(pre_max=1, post_max=1, pre_avg=1, post_avg=1),
    dict(pre_max=3, post_max=1, pre_avg=10, post_avg=11),
    dict(pre_max=7, post_max=5, pre_avg=2, post_avg=30),
]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _envelopes(seed: int, rows: int = ROWS, length: int = T) -> np.ndarray:
    rng = np.random.RandomState(seed)
    x = rng.rand(rows, length) ** 3          # sparse, peaky rows as an onset envelope
    x[:, ::37] += 0.5 * rng.rand(rows, len(range(0, length, 37)))
    return x.astype(np.float32)


@pytest.mark.parametrize("win", range(len(WINDOWS)))
@pytest.mark.parametrize("wait,delta", [(0, 0.0), (4, 0.02), (30, 0.1), (T + 5, 0.05)])
def test_greedy_and_dp_match_jax(win, wait, delta):
    x = _envelopes(17 * win + wait)
    kw = dict(WINDOWS[win], delta=delta, wait=wait)
    before = peaks.launches
    got = peaks.greedy_mask(torch.from_numpy(x), **kw)
    assert got.dtype == torch.bool and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_peaks.greedy_mask(x, **kw)))
    for count in (True, False):
        taken = peaks.dp_values(torch.from_numpy(x), count=count, **kw)
        want = np.asarray(jax_peaks.dp_values(x, count=count, **kw))
        np.testing.assert_array_equal(taken.numpy(), want)
        np.testing.assert_array_equal(peaks.dp_mask(taken, wait), jax_peaks.dp_mask(want, wait))
    assert peaks.launches == before  # CPU tensors run the plain loops


def test_leading_dims_fold_into_rows():
    x = _envelopes(5, rows=6).reshape(2, 3, T)
    kw = dict(WINDOWS[1], delta=0.05, wait=6)
    got = peaks.greedy_mask(torch.from_numpy(x), **kw)
    assert tuple(got.shape) == (2, 3, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_peaks.greedy_mask(x, **kw)))
    taken = peaks.dp_values(torch.from_numpy(x), count=False, **kw)
    np.testing.assert_array_equal(peaks.dp_mask(taken, 6),
                                  jax_peaks.dp_mask(jax_peaks.dp_values(x, count=False, **kw), 6))


@pytest.mark.parametrize("method", ["greedy", "dp_count", "dp_value"])
def test_peak_pick_batch_matches_jax(method):
    x = _envelopes(23, rows=4, length=700)
    kw = dict(pre_max=3, post_max=1, pre_avg=10, post_avg=11, delta=0.07, wait=3)
    got = L.util.peak_pick(x, sparse=False, method=method, **kw)
    want = jax_peak_pick(x, sparse=False, method=method, **kw)
    assert isinstance(got, np.ndarray) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    # the axis moves the frames last and back, as in the JAX package
    np.testing.assert_array_equal(L.util.peak_pick(x.T, sparse=False, method=method, axis=0,
                                                   **kw), want.T)


def test_dp_value_ties_keep_the_later_peak_as_jax():
    # two candidates closer than wait with equal heights, and a pair summing to a single peak:
    # the DP takes a frame only when strictly better, so of equal sums the later set stays
    x = np.zeros((2, 60), np.float32)
    x[0, [10, 12]] = 0.5
    x[1, [20, 40]] = 0.25
    x[1, 30] = 0.5
    kw = dict(pre_max=1, post_max=1, pre_avg=1, post_avg=1, delta=0.0)
    for wait in (3, 12):
        taken = peaks.dp_values(torch.from_numpy(x), count=False, wait=wait, **kw)
        want = np.asarray(jax_peaks.dp_values(x, count=False, wait=wait, **kw))
        np.testing.assert_array_equal(taken.numpy(), want)
        got = peaks.dp_mask(taken, wait)
        np.testing.assert_array_equal(got, jax_peaks.dp_mask(want, wait))
    assert np.flatnonzero(peaks.dp_mask(peaks.dp_values(torch.from_numpy(x), count=False,
                                                        wait=3, **kw), 3)[0]).tolist() == [12]


def test_plain_loops_are_the_wrappers_on_the_cpu():
    x = torch.from_numpy(_envelopes(3))
    kw = dict(WINDOWS[1], delta=0.05)
    cand = peaks.candidate_mask(x, **kw)
    assert torch.equal(peaks.greedy_scan(cand, 5), torch.from_numpy(
        peaks.greedy_select(cand.numpy(), 5)))
    taken = peaks.dp_scan(cand, x, 5)
    np.testing.assert_array_equal(taken.numpy(), peaks.dp_flags(cand.numpy(), x.numpy(), 5))
    np.testing.assert_array_equal(peaks.dp_mask(taken, 5),
                                  peaks.dp_select(cand.numpy(), x.numpy(), 5))


def test_batched_peak_pick_tries_the_card_by_default(monkeypatch):
    """Without set_device('cpu') a batch of numpy envelopes goes to cuda and fails here; one
    envelope stays on the host's float64 loops, as in the JAX package."""
    from librosa_tpu_torch.ops import _build

    assert _build.SOURCES["peak_scan"] == "peak_scan.cu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    L.set_device("cuda")
    kw = dict(pre_max=3, post_max=1, pre_avg=10, post_avg=11, delta=0.07, wait=3)
    x = _envelopes(29)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        L.util.peak_pick(x, sparse=False, **kw)
    np.testing.assert_array_equal(L.util.peak_pick(x[0], **kw), jax_peak_pick(x[0], **kw))
