"""Port's fused STFT-basis function against the JAX package's Pallas kernel.

Both get the same numpy inputs, made from a seed. The JAX kernel runs in
interpret mode on the CPU, as tests/test_pallas_stft.py runs it; the port's
``stft_mel_fused`` gets CPU tensors, so it runs its plain PyTorch version
(the CUDA kernel is checked against that version on the card by
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import librosa_tpu as lt
from librosa_tpu.ops.pallas_stft import pallas_supported, stft_mel_pallas

import librosa_tpu_torch as L
from librosa_tpu_torch.ops import fused_stft

SR = 22050
MIN_SNR_DB = 115.0         # the goldens' melspectrogram floor
MIN_SNR_POWER1_DB = 110.0  # |.|: the square root near empty bins loses ~5 dB


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
    return 10 * np.log10(np.sum(want**2) / max(np.sum((got - want) ** 2), 1e-300))


def _both(y, win, basis, **kw):
    want = np.asarray(stft_mel_pallas(y, win, basis, interpret=True, **kw))
    got = fused_stft.stft_mel_fused(torch.from_numpy(y), win, basis, **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    return got.numpy(), want


GEOMETRIES = [(512, 128), (256, 128)]


@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
@pytest.mark.parametrize(
    "length,center,pad_mode",
    [
        (40000, True, "constant"),
        (40000, True, "reflect"),
        (40000, False, "constant"),
        (2 * 128 * 128, True, "constant"),
        (400, True, "constant"),
        (400, True, "reflect"),
    ],
)
def test_matches_pallas_edges(n_fft, hop, length, center, pad_mode):
    rng = np.random.RandomState(length + n_fft)
    y = (rng.randn(length) * 0.1).astype(np.float32)
    win = np.hanning(n_fft).astype(np.float32)
    mb = lt.filters.mel(sr=SR, n_fft=n_fft, n_mels=64).astype(np.float32)
    got, want = _both(y, win, mb, n_fft=n_fft, hop_length=hop, center=center,
                      pad_mode=pad_mode)
    assert _snr(got, want) >= MIN_SNR_DB


@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
@pytest.mark.parametrize("power", [1.0, 2.0, 1.5])
def test_matches_pallas_multitrack_powers(n_fft, hop, power):
    # 3 tracks of 129 hop rows + 57 samples (test_kernel_multitrack_unaligned_rows)
    rng = np.random.RandomState(129)
    y = (rng.randn(3, 129 * hop + 57) * 0.1).astype(np.float32)
    win = np.hanning(n_fft).astype(np.float32)
    mb = lt.filters.mel(sr=SR, n_fft=n_fft, n_mels=64).astype(np.float32)
    got, want = _both(y, win, mb, n_fft=n_fft, hop_length=hop, power=power)
    assert got.shape == (3, 64, want.shape[-1])
    assert _snr(got, want) >= (MIN_SNR_POWER1_DB if power == 1 else MIN_SNR_DB)


@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
@pytest.mark.parametrize("basis_name", ["mel", "chroma", "identity"])
def test_matches_pallas_bases(n_fft, hop, basis_name):
    basis = {
        "mel": lambda: lt.filters.mel(sr=SR, n_fft=n_fft, n_mels=64),
        "chroma": lambda: lt.filters.chroma(sr=SR, n_fft=n_fft),
        "identity": lambda: np.eye(n_fft // 2 + 1),
    }[basis_name]().astype(np.float32)
    rng = np.random.RandomState(7)
    y = (rng.randn(2, 12000) * 0.1).astype(np.float32)
    win = lt.filters.get_window("hann", n_fft).astype(np.float32)
    got, want = _both(y, win, basis, n_fft=n_fft, hop_length=hop)
    assert got.shape[-2] == basis.shape[0]
    assert _snr(got, want) >= MIN_SNR_DB


def test_support_is_superset_of_pallas():
    # the test_kernel_support_matrix cases
    for n_fft, hop in [(2048, 512), (4096, 1024)]:
        assert pallas_supported(n_fft, hop) and fused_stft.fused_supported(n_fft, hop)
    assert not fused_stft.fused_supported(2000, 512)           # not a power of two
    # the TPU compiler's rules are dropped: hops that are not multiples of
    # 128 or do not divide n_fft, and n_fft of 128
    assert not pallas_supported(2048, 500) and fused_stft.fused_supported(2048, 500)
    assert not pallas_supported(2048, 64) and fused_stft.fused_supported(2048, 64)
    assert not pallas_supported(128, 128) and fused_stft.fused_supported(128, 128)
    # superset up to n_fft 8192; beyond, one frame no longer fits on chip
    for log2 in range(8, 14):
        n_fft = 1 << log2
        for hop in range(128, n_fft + 1, 128):
            if pallas_supported(n_fft, hop):
                assert fused_stft.fused_supported(n_fft, hop), (n_fft, hop)
    assert pallas_supported(16384, 4096) and not fused_stft.fused_supported(16384, 4096)
    assert not fused_stft.fused_supported(2048, 4096)          # hop beyond the frame


@pytest.mark.parametrize(
    "dtype,n_fft,hop,pad_mode,refused",
    [
        (torch.float32, 2048, 512, "constant", False),
        (torch.float32, 2048, 512, "reflect", False),
        (torch.float64, 2048, 512, "constant", True),
        (torch.float32, 2048, 512, "edge", True),
        (torch.float32, 2000, 512, "constant", True),
    ],
)
def test_kernel_refusal_is_the_routing_rule(dtype, n_fft, hop, pad_mode, refused):
    reason = fused_stft.kernel_refusal(dtype, n_fft, hop, pad_mode)
    assert (reason is not None) == refused
    if refused:
        assert "stft_mel kernel" in reason


def test_flops_per_frame_counts_the_function():
    # n_fft 8: window 8, real FFT 2.5 * 8 * 3 = 60, |X|^2 3 * 5 = 15, 2 per nonzero
    assert fused_stft.flops_per_frame(8, 10) == 8 + 60 + 15 + 20
    # the main path's geometry with a 128-band slaney mel basis: the FFT dominates
    nnz = int(np.count_nonzero(L.filters.mel(sr=SR, n_fft=2048, n_mels=128)))
    assert nnz < 2 * 1025
    fft = 5 * 2048 * 11 // 2
    assert fft < fused_stft.flops_per_frame(2048, nnz) < 1.2 * fft


def test_cpu_tensor_does_not_count_a_launch():
    before = fused_stft.launches
    y = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    win = np.hanning(512).astype(np.float32)
    mb = lt.filters.mel(sr=SR, n_fft=512, n_mels=16).astype(np.float32)
    out = fused_stft.stft_mel_fused(y, win, mb, n_fft=512, hop_length=128)
    assert out.shape == (16, 1 + 4096 // 128)
    assert fused_stft.launches == before


def test_port_tables_and_jax_tables_agree():
    # the same function fed the port's own window and basis
    rng = np.random.RandomState(3)
    y = (rng.randn(20000) * 0.1).astype(np.float32)
    jax_out = np.asarray(stft_mel_pallas(
        y, lt.filters.get_window("hann", 512).astype(np.float32),
        lt.filters.mel(sr=SR, n_fft=512, n_mels=40), n_fft=512, hop_length=128,
        interpret=True))
    port_out = fused_stft.stft_mel_fused(
        torch.from_numpy(y), L.filters.get_window("hann", 512),
        L.filters.mel(sr=SR, n_fft=512, n_mels=40), n_fft=512, hop_length=128)
    assert _snr(port_out.numpy(), jax_out) >= MIN_SNR_DB


def test_short_input_raises():
    with pytest.raises(L.ParameterError):
        fused_stft.stft_mel_fused(torch.zeros(100), np.hanning(512), np.eye(257),
                                  n_fft=512, hop_length=128, center=False)
