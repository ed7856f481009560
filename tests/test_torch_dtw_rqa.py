"""The port's DTW, its backtracking and RQA against the JAX package on the CPU.

Tolerances:

- given the same cost matrix ``C`` (or similarity ``sim``), ``D``, the step
  matrix, the warping path, the RQA ``score`` and its path are bit-equal:
  both are the same float64 numpy arithmetic on the host. The port finds
  each row's runs of unblocked cells with numpy where the JAX package walks
  them in Python; the banded 512 x 600 and 512 x 512 cases show that this
  leaves ``D`` bit-equal.
- from ``X`` and ``Y``, the port builds ``C`` with torch in float64 and the
  JAX package with scipy's ``cdist``: ``D`` agrees to 1e-12 relative, and
  the paths are equal.
"""

import numpy as np
import pytest
import scipy.spatial.distance
import torch

import librosa_tpu as lt
from librosa_tpu import sequence as jax_sequence

import librosa_tpu_torch as L
from librosa_tpu_torch import sequence as port_sequence

COST_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _seqs(n=40, m=52, d=6, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(d, n), rng.randn(d, m)


def _cost(n=40, m=52, seed=1):
    X, Y = _seqs(n, m, seed=seed)
    return scipy.spatial.distance.cdist(X.T, Y.T)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


STEPS = np.array([[1, 1], [1, 2], [2, 1]])

DTW_CASES = [
    dict(),
    dict(subseq=True),
    dict(weights_mul=np.array([2.0, 1.0, 1.0])),
    dict(weights_add=np.array([0.5, 0.1, 0.1]), weights_mul=np.array([1.0, 1.5, 1.5])),
    dict(step_sizes_sigma=STEPS),
    dict(step_sizes_sigma=STEPS, weights_mul=np.array([2.0, 3.0, 3.0])),
    dict(step_sizes_sigma=np.array([[1, 1], [0, 2], [2, 0]]), weights_add=np.zeros(3)),
    dict(global_constraints=True, square=True),
    dict(global_constraints=True, band_rad=0.4, subseq=True, square=True),
]


@pytest.mark.parametrize("case", DTW_CASES, ids=lambda c: "-".join(sorted(c)) or "default")
def test_dtw_on_a_cost_matrix_is_bit_equal(case):
    case = dict(case)
    shape = (40, 40) if case.pop("square", False) else (40, 52)
    C = _cost(*shape)
    got = L.sequence.dtw(C=C, return_steps=True, **case)
    want = lt.sequence.dtw(C=C, return_steps=True, **case)
    _same(got, want)
    # the caller's matrix is left alone under the band
    np.testing.assert_array_equal(C, _cost(*shape))


def test_global_constraints_on_a_rectangle_fail_in_both():
    """``fill_off_diagonal`` also fills a rectangle's last ``radius`` columns past the square,
    the last cell among them: neither package finds a complete alignment."""
    for module in (L, lt):
        with pytest.raises(module.ParameterError, match="no complete alignment"):
            module.sequence.dtw(C=_cost(40, 52), global_constraints=True)


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cityblock", "chebyshev",
                                    "cosine", "correlation"])
def test_dtw_from_features_matches_jax(metric):
    X, Y = _seqs()
    D, wp = L.sequence.dtw(X=X, Y=Y, metric=metric)
    D_j, wp_j = lt.sequence.dtw(X=X, Y=Y, metric=metric)
    np.testing.assert_allclose(D, D_j, rtol=COST_RTOL)
    np.testing.assert_array_equal(wp, wp_j)


@pytest.mark.parametrize("swap", [False, True])
def test_dtw_subsequence_flipped_and_multichannel(swap):
    X, Y = _seqs(n=20, m=50, seed=2)
    if swap:  # the longer sequence first: the cost is transposed and the path flipped back
        X, Y = Y, X
    D, wp = L.sequence.dtw(X=X, Y=Y, subseq=True)
    D_j, wp_j = lt.sequence.dtw(X=X, Y=Y, subseq=True)
    np.testing.assert_allclose(D, D_j, rtol=COST_RTOL)
    np.testing.assert_array_equal(wp, wp_j)
    # (channels, d, n) features and tensors on the CPU
    X3, Y3 = np.stack([X, X[::-1]]), np.stack([Y, Y[::-1]])
    D3, wp3 = L.sequence.dtw(X=torch.from_numpy(X3), Y=torch.from_numpy(Y3), subseq=True)
    D3_j, wp3_j = lt.sequence.dtw(X=X3, Y=Y3, subseq=True)
    np.testing.assert_allclose(D3, D3_j, rtol=COST_RTOL)
    np.testing.assert_array_equal(wp3, wp3_j)


@pytest.mark.parametrize("shape", [(512, 600), (512, 512)])
def test_banded_dtw_is_bit_equal(shape):
    """A band blocks most of every row: the runs found by numpy give JAX's ``D`` to the bit.

    At 512 x 600 the band follows the rectangle's diagonal, given as infinite
    costs (``global_constraints`` cannot band a rectangle, see above); at
    512 x 512 it is ``global_constraints``' own band.
    """
    rng = np.random.RandomState(3)
    C = np.abs(np.cumsum(rng.randn(*shape), axis=1)) + rng.rand(*shape)
    if shape[0] != shape[1]:
        i, j = np.indices(shape)
        C[np.abs(j - i * (shape[1] - 1) / (shape[0] - 1)) > 40] = np.inf
        kw = {}
    else:
        kw = dict(global_constraints=True, band_rad=0.1)
    got = L.sequence.dtw(C=C, return_steps=True, **kw)
    want = lt.sequence.dtw(C=C, return_steps=True, **kw)
    _same(got, want)
    assert np.isinf(got[0]).mean() > 0.5  # the band really blocks cells


def test_unblocked_runs_are_the_walks_runs():
    rng = np.random.RandomState(4)
    for p in (0.0, 0.1, 0.5, 0.9, 1.0):
        blocked = rng.rand(97) < p
        starts, ends = port_sequence._unblocked_runs(blocked)
        walk, a = [], 0
        while a < len(blocked):  # the JAX package's scalar walk
            if blocked[a]:
                a += 1
                continue
            b = a
            while b < len(blocked) and not blocked[b]:
                b += 1
            walk.append((a, b))
            a = b
        assert list(zip(starts.tolist(), ends.tolist())) == walk


def test_dtw_errors_match_jax():
    C = _cost()
    for module in (L, lt):
        with pytest.raises(module.ParameterError, match="both feature sequences"):
            module.sequence.dtw(X=np.zeros((2, 3)))
        with pytest.raises(module.ParameterError, match="not both"):
            module.sequence.dtw(X=np.zeros((2, 3)), Y=np.zeros((2, 3)), C=C)
        with pytest.raises(module.ParameterError, match="NaN"):
            module.sequence.dtw(C=np.full((3, 3), np.nan))
        with pytest.raises(module.ParameterError, match="no complete alignment"):
            # diagonal steps only, and a query longer than the target
            module.sequence.dtw(C=C.T, step_sizes_sigma=np.array([[1, 1]]))
        with pytest.raises(module.ParameterError, match="weight"):
            module.sequence.dtw(C=C, weights_add=np.zeros(2))


@pytest.mark.parametrize("subseq", [False, True])
def test_backtracking_and_path_to_steps_match_jax(subseq):
    C = _cost(30, 45, seed=5)
    _, _, steps = lt.sequence.dtw(C=C, subseq=subseq, return_steps=True)
    start = None if not subseq else 20
    got = L.sequence.dtw_backtracking(steps, subseq=subseq, start=start)
    want = jax_sequence.dtw_backtracking(steps, subseq=subseq, start=start)
    assert got == want
    wp = np.asarray(got)
    for inverse in (False, True):
        np.testing.assert_array_equal(L.sequence.path_to_steps(wp, inverse=inverse),
                                      lt.sequence.path_to_steps(wp, inverse=inverse))


def _sim(n=40, m=36, seed=6):
    X = np.cumsum(np.random.RandomState(seed).randn(5, max(n, m)), axis=1)
    R = lt.segment.recurrence_matrix(X, k=6, mode="affinity", sym=False)
    return R[:n, :m]


@pytest.mark.parametrize("case", [dict(), dict(knight_moves=False),
                                  dict(gap_onset=0.5, gap_extend=2.0),
                                  dict(gap_onset=0, gap_extend=0, knight_moves=False),
                                  dict(backtrack=False)],
                         ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()) or "default")
def test_rqa_is_bit_equal(case):
    for sim in (_sim(), (_sim(seed=7) > 0).astype(float), _sim(n=1, m=9), _sim(n=25, m=3)):
        got = L.sequence.rqa(sim, **case)
        want = lt.sequence.rqa(sim, **case)
        _same(got if isinstance(got, tuple) else (got,),
              want if isinstance(want, tuple) else (want,))


def test_rqa_of_an_empty_matrix_and_bad_gaps():
    score, path = L.sequence.rqa(np.zeros((4, 5)))
    assert path.shape == (0, 2) and not score.any()
    with pytest.raises(L.ParameterError):
        L.sequence.rqa(np.ones((3, 3)), gap_onset=-1)
    with pytest.raises(L.ParameterError):
        L.sequence.rqa(np.ones((3, 3)), gap_extend=-1)
