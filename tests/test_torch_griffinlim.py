"""The port's Griffin-Lim against the JAX package on the CPU, from the same seeded numpy inputs.

``init=None`` (zero phase) is deterministic in both packages and is held
sample by sample. ``init='random'`` draws its phases from a
``torch.Generator`` here and from ``jax.random`` there, so it is held to what
the function promises: the same seed gives the same output, and the spectral
error falls.

Tolerance: the iteration feeds its own rounding back through ``n_iter``
round trips, so the floor is 70 dB after 8 rounds (measured: 84 dB and more
on these inputs) and not the single-transform 115 dB.
"""

import numpy as np
import pytest
import torch

import librosa_tpu as lt

import librosa_tpu_torch as L

GL_SNR_DB = 70.0
KW = dict(n_fft=512, hop_length=128)


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


def _magnitudes(*shape, seed=0):
    """|STFT| of a chirp plus a little noise: a spectrogram that a signal does have."""
    rng = np.random.RandomState(seed)
    n = shape[-1]
    t = np.arange(n) / 22050.0
    y = np.sin(2 * np.pi * (200.0 + 900.0 * t) * t)[None] * np.ones(shape[:-1] + (1,))
    y = (0.5 * y + 0.01 * rng.randn(*y.shape)).astype(np.float32).reshape(shape)
    return y, np.abs(np.asarray(lt.stft(y, **KW)))


def _convergence(S, y_hat):
    """``|| |stft(y_hat)| - S || / || S ||``."""
    got = np.abs(np.asarray(lt.stft(np.asarray(y_hat), **KW)))
    return np.linalg.norm(got - S) / np.linalg.norm(S)


@pytest.mark.parametrize("momentum", [0.0, 0.99], ids=["classic", "fast"])
@pytest.mark.parametrize("shape", [(6000,), (2, 6000)], ids=["mono", "stereo"])
def test_griffinlim_zero_phase_matches_jax(momentum, shape):
    _, S = _magnitudes(*shape, seed=1)
    kw = dict(n_iter=8, init=None, momentum=momentum, hop_length=128)
    got = L.griffinlim(S, **kw)
    want = np.asarray(lt.griffinlim(S, **kw))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    snr = _snr(got, want)
    print(f"griffinlim init=None momentum={momentum} {shape}: {snr:.1f} dB against JAX")
    assert snr >= GL_SNR_DB


def test_griffinlim_length_and_window():
    y, S = _magnitudes(6000, seed=2)
    kw = dict(n_iter=4, init=None, hop_length=128, length=len(y))
    got = L.griffinlim(S, **kw)
    want = np.asarray(lt.griffinlim(S, **kw))
    assert tuple(got.shape) == (len(y),)
    assert _snr(got, want) >= GL_SNR_DB
    # a window given as samples takes the JAX function's eager loop; the port has one loop
    win = lt.filters.get_window("hann", 512)
    want = np.asarray(lt.griffinlim(S, window=win, **kw))
    assert _snr(L.griffinlim(S, window=win, **kw), want) >= GL_SNR_DB


def test_griffinlim_zero_iterations_is_one_istft():
    _, S = _magnitudes(5000, seed=3)
    got = L.griffinlim(S, n_iter=0, init=None, hop_length=128)
    want = L.istft(torch.from_numpy(S).to(torch.complex64), hop_length=128)
    # the same inverse FFT over time-major memory: its rounding differs in the last bits
    assert _snr(got, want) >= 125.0


def test_griffinlim_float64():
    _, S = _magnitudes(5000, seed=4)
    got = L.griffinlim(S.astype(np.float64), n_iter=3, init=None, hop_length=128)
    assert got.dtype == torch.float64
    ref = L.griffinlim(S, n_iter=3, init=None, hop_length=128)
    assert _snr(ref, got) >= GL_SNR_DB


def test_griffinlim_bad_momentum_and_init():
    _, S = _magnitudes(4000, seed=5)
    with pytest.raises(L.ParameterError):
        L.griffinlim(S, momentum=-1)
    with pytest.raises(L.ParameterError):
        L.griffinlim(S, init="bogus")
    with pytest.warns(UserWarning, match="unstable"):
        L.griffinlim(S, n_iter=1, momentum=1.5, hop_length=128)


def test_griffinlim_rng_and_deprecated_random_state():
    S = np.abs(np.random.RandomState(6).randn(33, 12)).astype(np.float32)
    y1 = L.griffinlim(S, n_iter=2, rng=7, n_fft=64)
    y2 = L.griffinlim(S, n_iter=2, rng=7, n_fft=64)
    assert torch.equal(y1, y2)
    assert not torch.equal(y1, L.griffinlim(S, n_iter=2, rng=8, n_fft=64))
    # no seed is seed 0
    assert torch.equal(L.griffinlim(S, n_iter=2, n_fft=64),
                       L.griffinlim(S, n_iter=2, rng=0, n_fft=64))
    # a numpy Generator or RandomState gives one integer
    a = L.griffinlim(S, n_iter=1, rng=np.random.default_rng(3), n_fft=64)
    b = L.griffinlim(S, n_iter=1, rng=np.random.default_rng(3), n_fft=64)
    assert torch.equal(a, b)
    a = L.griffinlim(S, n_iter=1, rng=np.random.RandomState(3), n_fft=64)
    b = L.griffinlim(S, n_iter=1, rng=np.random.RandomState(3), n_fft=64)
    assert torch.equal(a, b)
    with pytest.warns(FutureWarning):
        c = L.griffinlim(S, n_iter=2, random_state=7, n_fft=64)
    assert torch.equal(c, y1)
    with pytest.raises(L.ParameterError):
        L.griffinlim(S, n_iter=1, rng=1, random_state=1, n_fft=64)


def test_griffinlim_random_phases_are_unit_and_uniform():
    from librosa_tpu_torch.core.spectrum import _griffinlim_init

    z = _griffinlim_init((4, 300, 257), 0, "random", torch.device("cpu"), torch.complex64)
    assert z.dtype == torch.complex64
    np.testing.assert_allclose(z.abs().numpy(), 1.0, rtol=0, atol=1e-6)
    angle = z.angle().numpy()
    # uniform on the circle: the mean phasor of 308 400 draws is near 0, every quadrant near 1/4
    assert abs(z.mean()) < 0.01
    assert np.allclose(np.histogram(angle, bins=4, range=(-np.pi, np.pi))[0] / angle.size, 0.25,
                       atol=0.01)
    ones = _griffinlim_init((2, 5, 9), 0, None, torch.device("cpu"), torch.complex128)
    assert ones.dtype == torch.complex128 and bool((ones == 1).all())


def test_griffinlim_random_init_converges():
    y, S = _magnitudes(2, 8000, seed=7)
    errs = [_convergence(S, L.griffinlim(S, n_iter=n, rng=0, hop_length=128, length=8000))
            for n in (0, 4, 32)]
    print(f"spectral convergence after 0, 4, 32 rounds: {errs}")
    assert errs[2] < errs[1] < errs[0]
    assert errs[2] < 0.2
    # as close to the magnitudes as the JAX function gets from its own random phases
    jax_err = _convergence(S, lt.griffinlim(S, n_iter=32, rng=0, hop_length=128, length=8000))
    assert errs[2] < 1.5 * jax_err + 0.02


def test_griffinlim_leaves_its_input_alone():
    _, S = _magnitudes(4000, seed=8)
    S_t = torch.from_numpy(S.copy())
    L.griffinlim(S_t, n_iter=2, hop_length=128)
    assert torch.equal(S_t, torch.from_numpy(S))
