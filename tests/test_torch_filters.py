"""Port's host tables (filterbanks, windows, DCT, unit conversions) against the JAX package's."""

import numpy as np
import pytest
import torch

import librosa_tpu as lt
from librosa_tpu.ops.transforms import dct_matrix as jax_dct

import librosa_tpu_torch as L
from librosa_tpu_torch.feature.spectral import _mel_device
from librosa_tpu_torch.ops.transforms import dct_matrix

SR = 22050


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


@pytest.mark.parametrize(
    "kw",
    [
        dict(sr=SR, n_fft=2048, n_mels=128),
        dict(sr=SR, n_fft=1024, n_mels=40, htk=True),
        dict(sr=SR, n_fft=1024, n_mels=40, norm=None),
        dict(sr=SR, n_fft=1024, n_mels=40, norm=1),
        dict(sr=SR, n_fft=1024, n_mels=40, norm=2),
        dict(sr=SR, n_fft=1024, n_mels=40, norm=0),
        dict(sr=16000, n_fft=512, n_mels=32, fmin=50.0, fmax=7000.0, htk=True, norm=np.inf),
        dict(sr=SR, n_fft=2048, n_mels=64, dtype=np.float64),
    ],
    ids=["slaney", "htk", "norm_none", "norm_1", "norm_2", "norm_0", "fmin_fmax_inf",
         "float64"],
)
def test_mel_matches_jax(kw):
    got, want = L.filters.mel(**kw), lt.filters.mel(**kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def test_mel_bad_norm_raises():
    with pytest.raises(L.ParameterError):
        L.filters.mel(sr=SR, n_fft=512, norm="bogus")


@pytest.mark.parametrize(
    "window", ["hann", ("kaiser", 4.0), np.linspace(0.0, 1.0, 400)],
    ids=["hann", "kaiser", "array"],
)
@pytest.mark.parametrize("fftbins", [True, False])
def test_get_window_matches_jax(window, fftbins):
    got = L.filters.get_window(window, 400, fftbins=fftbins)
    want = lt.filters.get_window(window, 400, fftbins=fftbins)
    np.testing.assert_array_equal(got, want)


def test_get_window_takes_tensor_and_checks_length():
    w = torch.linspace(0.0, 1.0, 64)
    np.testing.assert_array_equal(L.filters.get_window(w, 64), w.numpy())
    with pytest.raises(L.ParameterError):
        L.filters.get_window(np.ones(10), 64)


@pytest.mark.parametrize("dct_type", [1, 2, 3])
@pytest.mark.parametrize("norm", ["ortho", None])
def test_dct_matrix_matches_jax(dct_type, norm):
    got = dct_matrix(40, dct_type=dct_type, norm=norm)
    want = jax_dct(40, dct_type=dct_type, norm=norm)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_mel_device_table_is_jax_mel_column_major():
    # (named for the first kernel's column-major table) the cached device basis holds
    # the same values, row-major as the kernel walks its bands, beside its band table
    basis, bands = _mel_device(SR, 512, torch.device("cpu"), torch.float32, n_mels=40)
    assert basis.shape == (40, 257) and basis.is_contiguous()
    want = lt.filters.mel(sr=SR, n_fft=512, n_mels=40)
    np.testing.assert_allclose(basis.numpy(), want, rtol=1e-6, atol=1e-8)
    assert bands.dtype == torch.int32 and bands.shape == (40, 2)
    for row, (lo, hi) in zip(np.asarray(want), bands.tolist()):
        nz = np.flatnonzero(row)
        assert (lo, hi) == (nz[0], nz[-1] + 1)
    again = _mel_device(SR, 512, torch.device("cpu"), torch.float32, n_mels=40)
    assert again[0].data_ptr() == basis.data_ptr()  # made and uploaded once
    assert again[1].data_ptr() == bands.data_ptr()


@pytest.mark.parametrize("htk", [False, True])
def test_convert_matches_jax(htk):
    f = np.linspace(20.0, 11025.0, 57)
    m = np.linspace(0.0, 60.0, 41)
    np.testing.assert_allclose(L.hz_to_mel(f, htk=htk), lt.hz_to_mel(f, htk=htk),
                               rtol=1e-12)
    np.testing.assert_allclose(L.mel_to_hz(m, htk=htk), lt.mel_to_hz(m, htk=htk),
                               rtol=1e-12)
    for scalar in (440.0, 1500.0):  # either side of Slaney's 1 kHz knee
        assert np.isclose(L.hz_to_mel(scalar, htk=htk), lt.hz_to_mel(scalar, htk=htk),
                          rtol=1e-12)
    np.testing.assert_allclose(
        L.mel_frequencies(64, fmin=30.0, fmax=8000.0, htk=htk),
        lt.mel_frequencies(64, fmin=30.0, fmax=8000.0, htk=htk), rtol=1e-12)
    np.testing.assert_array_equal(L.fft_frequencies(sr=SR, n_fft=2048),
                                  lt.fft_frequencies(sr=SR, n_fft=2048))
