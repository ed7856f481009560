"""The rest of the port's ``segment`` against the JAX package on the CPU: ``path_enhance``,
``agglomerative``, ``subsegment`` and ``timelag_filter``.

``path_enhance`` is held at 130 dB SNR against the JAX function on the same
float64 affinity matrix (measured 140.1 dB at the lowest, over every case
here; the path_enhance golden asks 110). The clusterings and the lag-domain
filters are equal to the JAX results. The two other routes of
``diagnostics/path_enhance_routes.py`` share the package's pad and filter
frame: ``per_filter`` equals the package's route bit for bit, ``rfft2`` is
held at 120 dB against it (measured 135.6 dB at the lowest).
"""

import numpy as np
import pytest
import scipy.ndimage
import sklearn.cluster
import torch

from librosa_tpu import segment as jax_segment
from librosa_tpu.util.exceptions import ParameterError as JaxParameterError
from torch_threads import one_torch_thread  # noqa: F401 (autouse, one intra-op thread)
import librosa_tpu_torch as L
from librosa_tpu_torch import segment
from librosa_tpu_torch.diagnostics import path_enhance_routes
from librosa_tpu_torch.filters import diagonal_filter

PATH_SNR_DB = 130.0
RFFT2_ROUTE_SNR_DB = 120.0


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


@pytest.fixture(scope="module")
def features():
    """A A B B A A: six blocks of ten frames, float64."""
    rng = np.random.RandomState(11)
    a, b = rng.randn(6, 10), rng.randn(6, 10) + 3
    return np.concatenate([a, a, b, b, a, a], axis=1) + 0.05 * rng.randn(6, 60)


@pytest.fixture(scope="module")
def affinity(features):
    return np.asarray(jax_segment.recurrence_matrix(features, mode="affinity", sym=True),
                      dtype=np.float64)


def snr_db(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-300)))


@pytest.mark.parametrize("n,kw", [
    (5, {}), (6, {}), (15, {}), (30, {}),
    (7, {"n_filters": 1}), (8, {"n_filters": 1}),
    (7, {"zero_mean": True}), (7, {"clip": False}), (8, {"zero_mean": True, "clip": False}),
    (9, {"min_ratio": 0.3, "max_ratio": 3.0}), (4, {"window": "triang", "n_filters": 3}),
])
def test_path_enhance_matches_jax(affinity, n, kw):
    got = segment.path_enhance(affinity, n, **kw)
    want = np.asarray(jax_segment.path_enhance(affinity, n, **kw))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    assert snr_db(got, want) >= PATH_SNR_DB
    if kw.get("clip", True):
        assert float(got.min()) >= 0


def test_path_enhance_keeps_leading_dims(affinity):
    R = np.stack([np.stack([affinity, affinity[::-1, ::-1]]), np.stack([affinity.T, affinity])])
    got = segment.path_enhance(torch.from_numpy(R), 9)
    want = np.asarray(jax_segment.path_enhance(R, 9))
    assert tuple(got.shape) == want.shape == R.shape
    assert snr_db(got, want) >= PATH_SNR_DB
    assert torch.equal(got[1, 1], segment.path_enhance(affinity, 9))


def test_path_enhance_ratio_order_is_checked_in_both(affinity):
    with pytest.raises(L.ParameterError, match="min_ratio"):
        segment.path_enhance(affinity, 5, min_ratio=3.0, max_ratio=2.0)
    with pytest.raises(JaxParameterError, match="min_ratio"):
        jax_segment.path_enhance(affinity, 5, min_ratio=3.0, max_ratio=2.0)


@pytest.mark.parametrize("n", [6, 15])
def test_path_enhance_routes_agree_with_the_package_route(affinity, n):
    R = torch.from_numpy(np.stack([affinity, affinity.T[::-1].copy()]).astype(np.float32))
    kernels = [torch.from_numpy(np.ascontiguousarray(
        diagonal_filter("hann", n, slope=r)[::-1, ::-1].astype(np.float32)))
        for r in np.logspace(-1.0, 1.0, 7, base=2)]
    want = segment._path_enhance_core(R, kernels, clip=True)
    assert torch.equal(path_enhance_routes.per_filter_route(R, kernels), want)
    got = path_enhance_routes.rfft2_route(R, kernels)
    assert snr_db(got, want) >= RFFT2_ROUTE_SNR_DB


@pytest.mark.parametrize("k", [1, 3, 6])
def test_agglomerative_equals_jax(features, k):
    got = segment.agglomerative(features, k)
    assert np.array_equal(got, jax_segment.agglomerative(features, k))
    assert got[0] == 0 and len(got) == k and np.all(np.diff(got) > 0)
    assert np.array_equal(segment.agglomerative(features.T, k, axis=0), got)
    assert np.array_equal(segment.agglomerative(torch.from_numpy(features), k), got)


def test_agglomerative_with_a_custom_clusterer_equals_jax(features):
    got = segment.agglomerative(features, 0, clusterer=sklearn.cluster.KMeans(3, n_init=4,
                                                                            random_state=0))
    want = jax_segment.agglomerative(features, 0, clusterer=sklearn.cluster.KMeans(
        3, n_init=4, random_state=0))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("frames,n_segments,axis", [
    ([0, 20, 40], 2, -1), ([0, 20, 45, 70], 3, -1), ([15, 30], 4, 0), ([], 2, -1)])
def test_subsegment_equals_jax(features, frames, n_segments, axis):
    data = features.T if axis == 0 else features
    frames = np.array(frames, dtype=int)
    got = segment.subsegment(data, frames, n_segments=n_segments, axis=axis)
    assert np.array_equal(got, jax_segment.subsegment(data, frames, n_segments=n_segments,
                                                      axis=axis))
    assert np.all(np.diff(got) >= 0)


def test_subsegment_rejects_no_segments_in_both(features):
    with pytest.raises(L.ParameterError):
        segment.subsegment(features, np.array([0, 30]), n_segments=0)
    with pytest.raises(JaxParameterError):
        jax_segment.subsegment(features, np.array([0, 30]), n_segments=0)


@pytest.mark.parametrize("pad", [True, False])
def test_timelag_filter_equals_jax(features, pad):
    R = np.asarray(jax_segment.recurrence_matrix(features, sym=True), dtype=np.float64)
    got = segment.timelag_filter(scipy.ndimage.median_filter, pad=pad)(R, size=(1, 7))
    want = jax_segment.timelag_filter(scipy.ndimage.median_filter, pad=pad)(R, size=(1, 7))
    assert got.shape == R.shape and np.array_equal(got, want)


def test_timelag_filter_on_another_argument_equals_jax(features):
    R = np.asarray(jax_segment.recurrence_matrix(features, sym=True), dtype=np.float64)

    def weigh(scale, rec, *, offset=0.0):
        return scale * rec + offset

    got = segment.timelag_filter(weigh, index=1)(0.5, torch.from_numpy(R), offset=0.25)
    want = jax_segment.timelag_filter(weigh, index=1)(0.5, R, offset=0.25)
    assert np.array_equal(got, want)
    assert segment.timelag_filter(weigh).__name__ == "weigh"


# counterparts of tests/test_segment_notation.py's clustering, path and lag-filter tests

def test_agglomerative(features):
    bounds = segment.agglomerative(features, 3)
    assert bounds[0] == 0 and len(bounds) == 3 and np.all(np.diff(bounds) > 0)


def test_subsegment(features):
    sub = segment.subsegment(features, np.array([0, 20, 40, 60]), n_segments=2)
    assert len(sub) >= 3 and np.all(np.diff(sub) >= 0)


def test_path_enhance(features):
    R = segment.recurrence_matrix(features, mode="affinity", sym=True)
    Rs = segment.path_enhance(R, 7)
    assert tuple(Rs.shape) == R.shape and float(Rs.min()) >= 0


def test_timelag_filter(features):
    R = segment.recurrence_matrix(features, sym=True).astype(float)
    assert np.allclose(segment.timelag_filter(lambda x: x)(R), R)
