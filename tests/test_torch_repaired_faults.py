"""Three faults of the port, repaired, each held against the JAX package on the CPU.

1. Numpy input with a negative stride (``y[::-1]``, ``S[::-1]``): the port
   copies it before handing it to torch, which refuses such strides.
   Tolerances are those of each module's own port tests: 115 dB on the STFT
   (``test_torch_feature_stack.py``), rtol 1e-4 / atol 1e-5 on values,
   1e-4 dB on the dB scale (``test_torch_db_scale.py``), 105 dB on HPSS
   (``test_torch_hpss.py``), 110 dB on onset envelopes
   (``test_torch_onset.py``).
2. ``util.sparsify_rows`` returns a ``scipy.sparse.csr_matrix``, as the JAX
   function does; the constant-Q filters keep a dense helper.
3. pYIN prunes its transition only where ``transition_min_prob > 0`` and
   never refuses a value: on a 2 s 220 Hz tone at 65-800 Hz, ``-0.1``
   decodes unpruned and ``0.5`` leaves states without a transition, which
   decode with every score -inf (65 Hz, voiced everywhere, in both
   packages). Voicing equal, ``f0`` to 1e-4 Hz, the voicing probability to
   1e-5 relative (``test_torch_yin.py``).
"""

import numpy as np
import pytest
import scipy.sparse
import torch

import librosa_tpu as lt

import librosa_tpu_torch as L
from librosa_tpu_torch._device import as_tensor
from librosa_tpu_torch.util.utils import _sparsify_dense

SR = 22050
STFT_SNR_DB = 115.0
HPSS_SNR_DB = 105.0
ENV_SNR_DB = 110.0
DB_ATOL = 1e-4
RTOL, ATOL = 1e-4, 1e-5
PROB_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _snr(got, want):
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.sum(np.abs(got - want) ** 2)
    return 10 * np.log10(np.sum(np.abs(want) ** 2) / max(err, 1e-300))


def _y(n=SR // 2, seed=0):
    rng = np.random.RandomState(seed)
    y = 0.1 * rng.randn(n) + np.sin(2 * np.pi * 330 * np.arange(n) / SR)
    return y.astype(np.float32)


def _S(seed=1):
    return np.abs(np.random.RandomState(seed).randn(257, 40)).astype(np.float32) ** 2


# ---------------------------------------------------------------------------
# 1. negative strides
# ---------------------------------------------------------------------------


def test_reversed_view_is_copied():
    y = _y()[::-1]
    assert y.strides[0] < 0
    t = as_tensor(y)
    assert t.device.type == "cpu" and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), y)


def test_stft_of_a_reversed_signal_matches_jax():
    y = _y()[::-1]
    got = L.stft(y, n_fft=512, hop_length=128)
    assert _snr(got.numpy(), lt.stft(y, n_fft=512, hop_length=128)) >= STFT_SNR_DB


def test_normalize_of_reversed_rows_matches_jax():
    S = _S()[::-1]
    np.testing.assert_allclose(L.util.normalize(S).numpy(), np.asarray(lt.util.normalize(S)),
                               rtol=RTOL, atol=ATOL)


def test_melspectrogram_of_a_reversed_spectrum_matches_jax():
    S = _S()[::-1]
    got = L.feature.melspectrogram(S=S, sr=SR, n_fft=512, n_mels=32)
    want = lt.feature.melspectrogram(S=S, sr=SR, n_fft=512, n_mels=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_power_to_db_of_a_reversed_spectrum_matches_jax():
    S = _S()[::-1, ::-1]
    got = L.power_to_db(S, ref=np.max)
    np.testing.assert_allclose(got.numpy(), np.asarray(lt.power_to_db(S, ref=np.max)),
                               rtol=0, atol=DB_ATOL)


def test_hpss_of_a_reversed_spectrogram_matches_jax():
    S = np.abs(lt.stft(_y(seed=2), n_fft=512, hop_length=128))
    S = np.asarray(S)[:, ::-1]
    H, P = L.decompose.hpss(S, kernel_size=9)
    H_j, P_j = lt.decompose.hpss(S, kernel_size=9)
    assert _snr(H.numpy(), H_j) >= HPSS_SNR_DB and _snr(P.numpy(), P_j) >= HPSS_SNR_DB


def test_onset_strength_of_a_reversed_spectrogram_matches_jax():
    S = np.asarray(lt.power_to_db(np.asarray(lt.feature.melspectrogram(y=_y(seed=3), sr=SR))))
    S = S[::-1, ::-1]
    got = L.onset.onset_strength(S=S, sr=SR)
    assert _snr(got.numpy(), lt.onset.onset_strength(S=S, sr=SR)) >= ENV_SNR_DB


# ---------------------------------------------------------------------------
# 2. sparsify_rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantile,dtype", [(0.01, None), (0.2, None), (0.5, np.complex64)],
                         ids=["q0.01", "q0.2", "q0.5-complex64"])
def test_sparsify_rows_is_csr_and_matches_jax(quantile, dtype):
    x = np.random.RandomState(4).randn(12, 64)
    got = L.util.sparsify_rows(x, quantile=quantile, dtype=dtype)
    want = lt.util.sparsify_rows(x, quantile=quantile, dtype=dtype)
    assert isinstance(got, scipy.sparse.csr_matrix)
    assert got.shape == want.shape and got.dtype == want.dtype and got.nnz == want.nnz
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    np.testing.assert_array_equal(_sparsify_dense(x, quantile=quantile, dtype=dtype),
                                  want.toarray())


def test_sparsify_rows_of_a_vector_is_one_row():
    x = np.random.RandomState(5).randn(30)
    got = L.util.sparsify_rows(x, quantile=0.1)
    assert isinstance(got, scipy.sparse.csr_matrix) and got.shape == (1, 30)
    np.testing.assert_array_equal(got.toarray(),
                                  lt.util.sparsify_rows(x, quantile=0.1).toarray())


# ---------------------------------------------------------------------------
# 3. pYIN's pruning rule
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tone():
    t = np.arange(2 * SR) / SR
    return (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)


@pytest.mark.parametrize("min_prob,mean_f0", [(-0.1, 219.93), (0.5, 65.0)],
                         ids=["negative-unpruned", "0.5-empty-states"])
def test_pyin_transition_min_prob_matches_jax(tone, min_prob, mean_f0):
    f0, vflag, vprob = L.pyin(tone, sr=SR, fmin=65, fmax=800, transition_min_prob=min_prob)
    f0_j, vflag_j, vprob_j = (np.asarray(a) for a in lt.pyin(
        tone, sr=SR, fmin=65, fmax=800, transition_min_prob=min_prob))
    np.testing.assert_array_equal(vflag.numpy(), vflag_j)
    np.testing.assert_array_equal(np.isnan(f0.numpy()), np.isnan(f0_j))
    np.testing.assert_allclose(f0.numpy(), f0_j, rtol=0, atol=1e-4, equal_nan=True)
    np.testing.assert_allclose(vprob.numpy(), vprob_j, rtol=PROB_RTOL, atol=1e-7)
    assert abs(float(np.nanmean(f0.numpy())) - mean_f0) < 0.01
    assert vflag.numpy().all()


def test_viterbi_still_refuses_what_jax_refuses():
    prob = np.full((3, 5), 1 / 3)
    trans = np.full((3, 3), 1 / 3)
    for bad in (-0.1, 0.5):
        with pytest.raises(L.ParameterError):
            L.sequence.viterbi(prob, trans, transition_min_prob=bad)
        with pytest.raises(lt.ParameterError):
            lt.sequence.viterbi(prob, trans, transition_min_prob=bad)
