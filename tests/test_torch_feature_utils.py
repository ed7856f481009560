"""The port's ``delta`` and ``stack_memory`` against the JAX package on the CPU.

``delta`` runs on seeded float32 MFCC-like features ``(2, 13, 40)``:
interior samples are one convolution with the same Savitzky-Golay taps,
the ``'interp'`` edges two products with the same float64 matrices. Floor
120 dB (132.3-139.1 measured: float32 sums of up to 11 products in another
order). ``stack_memory`` copies and pads: equal (measured equal).
"""

import numpy as np
import pytest
import torch

import librosa_tpu as lt

import librosa_tpu_torch as L

DELTA_SNR_DB = 120.0


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _snr(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got, want = got.astype(np.float64), np.asarray(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return 10 * np.log10(np.sum(want**2) / max(np.sum((got - want) ** 2), 1e-300))


@pytest.fixture(scope="module")
def feats():
    rng = np.random.RandomState(0)
    return np.cumsum(rng.randn(2, 13, 40), axis=-1).astype(np.float32)


@pytest.mark.parametrize("mode", ["interp", "nearest", "mirror", "wrap", "constant"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_delta(feats, mode, order):
    width = 9 if order < 3 else 11
    got = L.feature.delta(torch.from_numpy(feats), width=width, order=order, mode=mode)
    want = lt.feature.delta(feats, width=width, order=order, mode=mode)
    assert got.shape == want.shape == feats.shape
    assert _snr(got, want) > DELTA_SNR_DB


@pytest.mark.parametrize("mode", ["interp", "nearest"])
def test_delta_along_axis_0(feats, mode):
    x = feats[0].T.copy()  # (40, 13): time first
    got = L.feature.delta(x, axis=0, width=5, mode=mode)
    want = lt.feature.delta(x, axis=0, width=5, mode=mode)
    assert _snr(got, want) > DELTA_SNR_DB


def test_delta_refuses_what_the_jax_package_refuses(feats):
    for kw in (dict(width=4), dict(width=1), dict(order=0), dict(order=1.5), dict(width=41)):
        with pytest.raises(lt.util.ParameterError):
            lt.feature.delta(feats, **kw)
        with pytest.raises(L.ParameterError):
            L.feature.delta(torch.from_numpy(feats), **kw)


@pytest.mark.parametrize("kw", [dict(n_steps=3), dict(n_steps=3, delay=-2),
                                dict(n_steps=2, delay=3, mode="edge"),
                                dict(n_steps=4, delay=2, mode="reflect"),
                                dict(n_steps=2, mode="constant", constant_values=[1.5]),
                                dict(n_steps=3, delay=-1, mode="wrap")],
                         ids=["default", "ahead", "edge", "reflect", "value", "wrap"])
def test_stack_memory(feats, kw):
    got = L.feature.stack_memory(torch.from_numpy(feats), **kw)
    want = np.asarray(lt.feature.stack_memory(feats, **kw))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_stack_memory_of_one_row_and_the_refusals():
    x = np.arange(10, dtype=np.float32)
    np.testing.assert_array_equal(L.feature.stack_memory(x, n_steps=2).numpy(),
                                  np.asarray(lt.feature.stack_memory(x, n_steps=2)))
    for kw in (dict(n_steps=0), dict(delay=0)):
        with pytest.raises(L.ParameterError):
            L.feature.stack_memory(x, **kw)
        with pytest.raises(lt.util.ParameterError):
            lt.feature.stack_memory(x, **kw)
