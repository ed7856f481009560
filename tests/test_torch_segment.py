"""The port's neighbour search, recurrence and cross-similarity graphs and the lag shears against JAX.

Both packages run the search in float32 with the same centring and the
same stable sort, and everything after it in float64 numpy on the host.
Tolerances:

- neighbours (``topm``'s indices, the connectivity and lag matrices): equal.
  The two products sum in other orders, so a neighbour could differ at a
  near-tie; ``_assert_same_neighbours`` then names each pair and its
  float64 distance gap against the k-th distance, and passes only where the
  gap is below 1e-5 of it. On these inputs no such pair occurs.
- distances: 1e-4 relative. The float32 rounding of ``|x|^2 + |y|^2 - 2x.y``
  is relative to the squared norms, not to the distance: 1.7e-5 of a
  squared distance was measured here;
- affinity: rtol 1e-4, the ``recurrence`` golden's;
- the shears, ``fill_off_diagonal`` and ``axis_sort``: equal (index
  arithmetic only).
"""

import numpy as np
import pytest
import scipy.sparse
import torch

import librosa_tpu as lt
from librosa_tpu.ops import knn as jax_knn

import librosa_tpu_torch as L
from librosa_tpu_torch.ops import knn as port_knn

DIST_RTOL = 1e-4
AFFINITY_RTOL = 1e-4
NEAR_TIE = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _features(d=6, n=60, seed=0):
    """A slowly wandering feature sequence, so that neighbours are mostly nearby frames."""
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.randn(d, n), axis=1) + 0.3 * rng.randn(d, n)


def _dense(x):
    return np.asarray(x.todense() if scipy.sparse.issparse(x) else x)


def _dist64(X, Y, metric):
    X, Y = np.asarray(X, np.float64), np.asarray(Y, np.float64)
    if metric == "cosine":
        Xn = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-30)
        Yn = Y / np.maximum(np.linalg.norm(Y, axis=1, keepdims=True), 1e-30)
        return 1 - Xn @ Yn.T
    d2 = ((X[:, None, :] - Y[None, :, :]) ** 2).sum(-1)
    return d2 if metric == "sqeuclidean" else np.sqrt(d2)


def _assert_same_neighbours(idx_p, idx_j, D64, kth):
    """Equal neighbour lists, or differing only where the float64 distances tie to 1e-5 of the k-th."""
    bad = []
    for i, j in zip(*np.nonzero(idx_p != idx_j)):
        a, b = idx_p[i, j], idx_j[i, j]
        gap = abs(D64[i, a] - D64[i, b])
        if gap > NEAR_TIE * kth[i]:
            bad.append((int(i), int(j), int(a), int(b), float(gap), float(kth[i])))
    assert not bad, f"neighbours differ beyond a near-tie (row, rank, port, jax, gap, k-th): {bad}"


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
@pytest.mark.parametrize("exclude_self,block", [(True, 4096), (True, 16), (False, 25)])
def test_topm_matches_jax(metric, exclude_self, block):
    Q = _features(n=60, seed=1).T
    C = Q if exclude_self else _features(n=45, seed=2).T
    m = 12
    d_p, i_p = port_knn.topm(Q, C, m, metric=metric, exclude_self=exclude_self, block=block)
    d_j, i_j = jax_knn.topm(Q, C, m, metric=metric, exclude_self=exclude_self, block=block)
    assert d_p.dtype == np.float32 and i_p.dtype == np.int32 and i_p.shape == (60, m)
    D64 = _dist64(Q, C, metric)
    if exclude_self:
        np.fill_diagonal(D64, np.inf)
    _assert_same_neighbours(i_p, i_j, D64, np.sort(D64, axis=1)[:, m - 1])
    np.testing.assert_allclose(d_p, d_j, rtol=DIST_RTOL, atol=1e-6)
    assert not np.any(i_p == np.arange(60)[:, None]) or not exclude_self


def test_topm_keeps_the_lowest_index_on_ties():
    # four corpus rows at one distance from the query: the first ones win, as in the JAX package
    C = np.array([[1.0, 0], [0, 1.0], [-1.0, 0], [0, -1.0], [5.0, 5.0]])
    Q = np.zeros((1, 2))
    _, i_p = port_knn.topm(Q, C, 3)
    _, i_j = jax_knn.topm(Q, C, 3)
    assert i_p.tolist() == i_j.tolist() == [[0, 1, 2]]


def test_topm_refuses_other_metrics():
    with pytest.raises(ValueError, match="no device kernel"):
        port_knn.topm(np.zeros((3, 2)), np.zeros((3, 2)), 2, metric="cityblock")


RECURRENCE_CASES = [
    dict(),
    dict(mode="distance"),
    dict(mode="affinity"),
    dict(mode="affinity", sym=True, sparse=True),
    dict(mode="affinity", self=True),
    dict(mode="connectivity", self=True, sym=True),
    dict(k=4, width=3),
    dict(mode="distance", k=5, width=2, sparse=True),
    dict(metric="cosine", mode="affinity"),
    dict(metric="sqeuclidean", mode="distance"),
    dict(metric="cityblock", mode="affinity"),  # sklearn on the host in both
    dict(mode="affinity", full=True),
    dict(mode="connectivity", full=True, k=6),
]


def _compare_graphs(got, want, mode, case):
    assert scipy.sparse.issparse(got) == scipy.sparse.issparse(want), case
    if scipy.sparse.issparse(got):
        assert got.format == want.format == "csc", (got.format, want.format)
    g, w = _dense(got), _dense(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (case, g.dtype, w.dtype)
    if mode == "connectivity":
        np.testing.assert_array_equal(g, w, err_msg=str(case))
        return
    np.testing.assert_array_equal(g != 0, w != 0, err_msg=str(case))
    rtol = AFFINITY_RTOL if mode == "affinity" else DIST_RTOL
    np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6, err_msg=str(case))


@pytest.mark.parametrize("case", RECURRENCE_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()) or "default")
def test_recurrence_matrix_matches_jax(case):
    X = _features()
    got = L.segment.recurrence_matrix(X, **case)
    want = lt.segment.recurrence_matrix(X, **case)
    _compare_graphs(got, want, case.get("mode", "connectivity"), case)


@pytest.mark.parametrize("bandwidth", ["med_k_scalar", "mean_k", "gmean_k", "mean_k_avg",
                                       "gmean_k_avg", "mean_k_avg_and_pair", 2.5, "matrix"])
def test_affinity_bandwidth_estimators_match_jax(bandwidth):
    X = _features(seed=3)
    if bandwidth == "matrix":
        bandwidth = 1.0 + np.random.RandomState(4).rand(60, 60)
    got = L.segment.recurrence_matrix(X, mode="affinity", bandwidth=bandwidth, sparse=True)
    want = lt.segment.recurrence_matrix(X, mode="affinity", bandwidth=bandwidth, sparse=True)
    _compare_graphs(got, want, "affinity", bandwidth)


def test_recurrence_of_a_tensor_and_along_axis_0():
    X = _features(d=3, n=50, seed=5)
    got = L.segment.recurrence_matrix(torch.from_numpy(X.T.copy()), axis=0, k=4)
    want = lt.segment.recurrence_matrix(X.T, axis=0, k=4)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(L.ParameterError, match="width"):
        L.segment.recurrence_matrix(X, width=25)
    with pytest.raises(L.ParameterError, match="mode"):
        L.segment.recurrence_matrix(X, mode="bogus")
    with pytest.raises(L.ParameterError, match="bandwidth"):
        L.segment.recurrence_matrix(X, mode="affinity", bandwidth="bogus")


@pytest.mark.parametrize("case", [dict(), dict(mode="affinity"), dict(mode="distance", k=3),
                                  dict(mode="affinity", sparse=True, bandwidth=2.0),
                                  dict(metric="cosine"), dict(mode="affinity", full=True),
                                  dict(metric="chebyshev", mode="distance")],
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()) or "default")
def test_cross_similarity_matches_jax(case):
    X, Y = _features(n=40, seed=6), _features(n=55, seed=7)
    got = L.segment.cross_similarity(X, Y, **case)
    want = lt.segment.cross_similarity(X, Y, **case)
    assert _dense(got).shape == (55, 40)
    _compare_graphs(got, want, case.get("mode", "connectivity"), case)
    with pytest.raises(L.ParameterError, match="non-time axis"):
        L.segment.cross_similarity(X, Y[:3])


def test_cross_similarity_pointwise_bandwidth_needs_equal_lengths_in_both():
    # the estimators index each link's far end by its column: with n != n_ref both packages fail
    X, Y = _features(n=40, seed=6), _features(n=55, seed=7)
    for module in (L, lt):
        with pytest.raises(IndexError):
            module.segment.cross_similarity(X, Y, mode="affinity", bandwidth="mean_k_avg")
    got = L.segment.cross_similarity(X, Y[:, :40], mode="affinity", bandwidth="mean_k_avg")
    want = lt.segment.cross_similarity(X, Y[:, :40], mode="affinity", bandwidth="mean_k_avg")
    _compare_graphs(got, want, "affinity", "mean_k_avg")


@pytest.mark.parametrize("fmt", ["dense", "csr", "csc"])
@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("axis", [-1, 0])
def test_lag_shears_match_jax(fmt, pad, axis):
    R = L.segment.recurrence_matrix(_features(seed=8), k=5).astype(float)
    rec = R if fmt == "dense" else scipy.sparse.csr_matrix(R).asformat(fmt)
    got = L.segment.recurrence_to_lag(rec, pad=pad, axis=axis)
    want = lt.segment.recurrence_to_lag(rec, pad=pad, axis=axis)
    assert type(got) is type(want)
    if fmt != "dense":
        assert got.format == want.format == fmt
    np.testing.assert_array_equal(_dense(got), _dense(want))
    back = L.segment.lag_to_recurrence(got, axis=axis)
    np.testing.assert_array_equal(_dense(back), _dense(lt.segment.lag_to_recurrence(want,
                                                                                   axis=axis)))
    np.testing.assert_array_equal(_dense(back), R)


def test_lag_shears_refuse_bad_shapes():
    with pytest.raises(L.ParameterError, match="square"):
        L.segment.recurrence_to_lag(np.zeros((3, 4)))
    with pytest.raises(L.ParameterError, match="lag matrices"):
        L.segment.lag_to_recurrence(np.zeros((5, 3)))
    with pytest.raises(L.ParameterError, match="axis"):
        L.segment.lag_to_recurrence(np.zeros((3, 3)), axis=2)


@pytest.mark.parametrize("factor,axis", [(1, -1), (2, -1), (-3, 1), (1, 0), (-2, 0)])
def test_shear_matches_jax(factor, axis):
    X = np.random.RandomState(9).randn(7, 11).astype(np.float32)
    got = L.util.shear(torch.from_numpy(X), factor=factor, axis=axis)
    want = lt.util.shear(X, factor=factor, axis=axis)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    sp = L.util.shear(scipy.sparse.csr_matrix(X), factor=factor, axis=axis)
    assert sp.format == "csr"
    np.testing.assert_array_equal(sp.toarray(), np.asarray(want))
    with pytest.raises(L.ParameterError, match="integer"):
        L.util.shear(X, factor=1.5)


@pytest.mark.parametrize("shape,radius", [((8, 8), 0.25), ((6, 10), 0.5), ((10, 6), 2),
                                          ((3, 7, 9), 0.34)])
def test_fill_off_diagonal_matches_jax(shape, radius):
    x = np.random.RandomState(10).rand(*shape)
    want = x.copy()
    lt.util.fill_off_diagonal(want, radius=radius, value=-1.0)
    got = x.copy()
    assert L.util.fill_off_diagonal(got, radius=radius, value=-1.0) is None
    np.testing.assert_array_equal(got, want)
    t = torch.from_numpy(x.copy())
    L.util.fill_off_diagonal(t, radius=radius, value=-1.0)
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("axis", [-1, 0])
def test_axis_sort_matches_jax(axis):
    S = np.random.RandomState(11).rand(6, 9)
    got, order = L.util.axis_sort(S, axis=axis, index=True)
    want, order_j = lt.util.axis_sort(S, axis=axis, index=True)
    np.testing.assert_array_equal(order.numpy(), np.asarray(order_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    got_v = L.util.axis_sort(S, axis=axis, value=np.argmin)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(lt.util.axis_sort(
        S, axis=axis, value=np.argmin)), rtol=1e-7)
    with pytest.raises(L.ParameterError, match="matrix"):
        L.util.axis_sort(np.zeros(3))
