"""The port's last ``util`` helpers against the JAX package on the CPU.

``cyclic_gradient``, ``stack``, ``count_unique``, ``is_unique``,
``buf_to_float``, ``interp_broadcast``, ``valid_audio``,
``valid_intervals`` and ``utils.band_mask`` on the same seeded numpy
inputs. All of them are exact arithmetic on the same floats (a difference
of two shifts halved, copies, a sort and its change points, integer
scaling, the same numpy and scipy interpolation on the host, integer
comparisons), so each is held to equality (measured: equal).
The ``ParameterError`` cases are those both packages raise.
"""

import numpy as np
import pytest
import torch

import librosa_tpu as lt
from librosa_tpu.util.utils import band_mask as jax_band_mask

import librosa_tpu_torch as L


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_max_mem_block():
    assert L.util.MAX_MEM_BLOCK == lt.util.MAX_MEM_BLOCK


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_cyclic_gradient(axis):
    x = np.random.RandomState(0).randn(5, 7, 9).astype(np.float32)
    _equal(L.util.cyclic_gradient(x, axis=axis), lt.util.cyclic_gradient(x, axis=axis))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_stack(axis):
    rng = np.random.RandomState(1)
    arrays = [rng.randn(3, 4).astype(np.float32) for _ in range(3)]
    _equal(L.util.stack(arrays, axis=axis), lt.util.stack(arrays, axis=axis))


def test_stack_refuses_what_the_jax_package_refuses():
    for arrays in ([], [np.zeros(3), np.zeros(4)]):
        with pytest.raises(lt.util.ParameterError):
            lt.util.stack(arrays)
        with pytest.raises(L.ParameterError):
            L.util.stack(arrays)


@pytest.mark.parametrize("axis", [-1, 0])
def test_count_unique_and_is_unique(axis):
    rng = np.random.RandomState(2)
    x = rng.randint(0, 4, size=(6, 5)).astype(np.float32)
    x[2] = np.arange(5)
    _equal(L.util.count_unique(x, axis=axis), lt.util.count_unique(x, axis=axis))
    _equal(L.util.is_unique(x, axis=axis), lt.util.is_unique(x, axis=axis))


@pytest.mark.parametrize("n_bytes", [1, 2, 4])
def test_buf_to_float(n_bytes):
    ints = np.random.RandomState(3).randint(-2 ** (8 * n_bytes - 1), 2 ** (8 * n_bytes - 1),
                                             size=64, dtype=np.int64)
    buf = ints.astype(f"<i{n_bytes}").tobytes()
    got = L.util.buf_to_float(buf, n_bytes=n_bytes)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    _equal(got, lt.util.buf_to_float(buf, n_bytes=n_bytes))


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_interp_broadcast(kind):
    rng = np.random.RandomState(4)
    x1, x2 = rng.randn(3, 20, 6), rng.randn(1, 15, 6)
    p1 = np.sort(rng.rand(20)) * 10
    p2 = np.linspace(0, 10, 15)
    targets = np.linspace(-1, 11, 30)
    kw = dict(x1=x1, x1_pos=p1, x2=x2, x2_pos=p2, interp_pos=targets, kind=kind, axis=-2)
    _equal(L.util.interp_broadcast(**kw), lt.util.interp_broadcast(**kw))
    for got, want in zip(L.util.interp_broadcast(op=None, **kw),
                         lt.util.interp_broadcast(op=None, **kw)):
        _equal(got, want)
    bad = dict(kw, x2=rng.randn(2, 15, 6))
    with pytest.raises(lt.util.ParameterError):
        lt.util.interp_broadcast(**bad)
    with pytest.raises(L.ParameterError):
        L.util.interp_broadcast(**bad)


def test_valid_audio():
    y = np.random.RandomState(5).randn(2, 100).astype(np.float32)
    assert L.util.valid_audio(y) and lt.util.valid_audio(y)
    assert L.util.valid_audio(torch.from_numpy(y), mono=True)  # device arrays skip the mono check
    bad = [(np.arange(10), {}), (np.float32(1.0), {}), (y, {"mono": True}),
           (np.array([0.0, np.inf], dtype=np.float32), {}),
           (torch.tensor([0.0, float("nan")]), {})]
    for arr, kw in bad:
        with pytest.raises(L.ParameterError):
            L.util.valid_audio(arr, **kw)
        if not isinstance(arr, torch.Tensor):
            with pytest.raises(lt.util.ParameterError):
                lt.util.valid_audio(arr, **kw)


def test_valid_intervals():
    good = np.array([[0.0, 1.0], [0.5, 2.0]])
    assert L.util.valid_intervals(good) and lt.util.valid_intervals(good)
    assert L.util.valid_intervals(torch.from_numpy(good))
    for bad in (np.array([[1.0, 0.0]]), np.zeros((3, 3)), np.zeros(2)):
        with pytest.raises(L.ParameterError):
            L.util.valid_intervals(bad)
        with pytest.raises(lt.util.ParameterError):
            lt.util.valid_intervals(bad)


@pytest.mark.parametrize("nx,ny", [(9, 9), (7, 12), (12, 7), (1, 5)])
@pytest.mark.parametrize("radius", [1, 3, 0.25, 0.5, 0.99])
def test_band_mask(nx, ny, radius):
    got = L.util.utils.band_mask(nx, ny, radius=radius)
    assert isinstance(got, np.ndarray) and got.dtype == bool
    _equal(got, jax_band_mask(nx, ny, radius=radius))
    # the cells fill_off_diagonal fills are the band's outside
    x = np.ones((nx, ny), np.float32)
    L.util.fill_off_diagonal(x, radius=radius)
    _equal(x != 0, got)
