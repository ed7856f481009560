"""Port's fused STFT-basis function against the JAX package's Pallas kernel.

Both get the same numpy inputs, made from a seed. The JAX kernel runs in
interpret mode on the CPU, as tests/test_pallas_stft.py runs it; the port's
``stft_mel_fused`` gets CPU tensors, so it runs its plain PyTorch version
(the CUDA kernel is checked against that version on the card by
chip_smoke.py). The kernel's index math that lives in Python (band tables,
FFT plan, exchange layout, twiddle tables, shared-memory sizes) is checked
here by emulation.
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


@pytest.mark.parametrize("n_fft,hop", GEOMETRIES)
@pytest.mark.parametrize("basis_name,power", [("chroma", 2.0), ("chroma24", 2.0),
                                              ("identity", 1.0), ("identity", 2.0)])
def test_port_bases_with_cached_bands_match_pallas(n_fft, hop, basis_name, power):
    # the bases and band tables as chroma_stft and _spectrogram hand them to the kernel
    from librosa_tpu_torch.core.spectrum import _eye_device
    from librosa_tpu_torch.feature.spectral import _basis_device

    cpu = torch.device("cpu")
    if basis_name == "identity":
        basis, bands = _eye_device(n_fft, cpu)
        assert torch.equal(basis, torch.eye(n_fft // 2 + 1))
        assert torch.equal(bands[:, 1] - bands[:, 0], torch.ones(n_fft // 2 + 1,
                                                                 dtype=torch.int32))
    else:
        kw = dict(tuning=0.0, n_chroma=12) if basis_name == "chroma" else dict(tuning=0.25,
                                                                              n_chroma=24)
        basis, bands = _basis_device(L.filters.chroma, SR, n_fft, cpu, torch.float32, **kw)
        np.testing.assert_array_equal(
            basis.numpy(), np.asarray(lt.filters.chroma(sr=SR, n_fft=n_fft, **kw)))
    assert torch.equal(bands, fused_stft.basis_bands(basis))
    rng = np.random.RandomState(11)
    y = (rng.randn(2, 12000) * 0.1).astype(np.float32)
    win = lt.filters.get_window("hann", n_fft).astype(np.float32)
    kw = dict(n_fft=n_fft, hop_length=hop, power=power)
    want = np.asarray(stft_mel_pallas(y, win, basis.numpy(), interpret=True, **kw))
    got = fused_stft._fused(torch.from_numpy(y), win, basis, bands, center=True,
                            pad_mode="constant", **kw)
    assert got.shape == (2, basis.shape[0], want.shape[-1])
    assert _snr(got, want) >= (MIN_SNR_POWER1_DB if power == 1 else MIN_SNR_DB)


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


# ---------------------------------------------------------------------------
# the kernel's index math, which the CPU can check without the kernel
# ---------------------------------------------------------------------------


def _first_and_last(n_bins, rows=5):
    b = np.zeros((rows, n_bins), np.float32)
    b[:, 0], b[:, -1] = 1.0, 2.0
    b[2] = np.linspace(0.5, 1.5, n_bins)
    return b


def _zero_rows(n_fft, n_mels=40):
    b = lt.filters.mel(sr=SR, n_fft=n_fft, n_mels=n_mels).astype(np.float32)
    b[[0, 7, n_mels - 1]] = 0.0
    return b


BASES = {
    "mel64": lambda: lt.filters.mel(sr=SR, n_fft=512, n_mels=64),
    "mel128": lambda: lt.filters.mel(sr=SR, n_fft=2048, n_mels=128),
    "chroma": lambda: lt.filters.chroma(sr=SR, n_fft=512),
    "identity": lambda: np.eye(257),
    "dense": lambda: np.random.RandomState(5).rand(12, 257) + 0.1,
    "zero_rows": lambda: _zero_rows(512),
    "first_and_last": lambda: _first_and_last(257),
}


@pytest.mark.parametrize("name", sorted(BASES))
def test_basis_bands_match_a_scan(name):
    basis = np.asarray(BASES[name](), dtype=np.float32)
    want = np.zeros((basis.shape[0], 2), np.int32)
    for m, row in enumerate(basis):  # brute force: first and one-past-last nonzero
        cols = [k for k, v in enumerate(row) if v != 0]
        if cols:
            want[m] = cols[0], cols[-1] + 1
    from_numpy = fused_stft.basis_bands(basis)
    from_tensor = fused_stft.basis_bands(torch.from_numpy(basis))
    assert isinstance(from_numpy, np.ndarray) and from_numpy.dtype == np.int32
    assert isinstance(from_tensor, torch.Tensor) and from_tensor.dtype == torch.int32
    np.testing.assert_array_equal(from_numpy, want)
    np.testing.assert_array_equal(from_tensor.numpy(), want)
    if name == "zero_rows":
        assert (want[[0, 7, 39]] == 0).all() and (want[1] != 0).any()
    if name == "first_and_last":
        assert (want == [0, 257]).all()
    if name == "identity":
        assert (want[:, 1] - want[:, 0] == 1).all()


N_FFTS = [1 << b for b in range(6, 14)]


def _snr_complex(got, want):
    err = np.sum(np.abs(got - want) ** 2)
    return 10 * np.log10(np.sum(np.abs(want) ** 2) / max(err, 1e-300))


def _unpack(Z, n_fft):
    """Bins 0..n_fft/2 from the half-length transform, with the kernel's float32 table."""
    half, quarter = n_fft // 2, n_fft // 4
    table = torch.from_numpy(fused_stft._twiddles(n_fft)[-2 * (quarter + 1):])
    w = torch.complex(table[:quarter + 1], table[quarter + 1:])   # exp(-2 pi i k / n_fft)
    k = torch.arange(1, quarter + 1)
    z, y = Z[..., k], Z[..., half - k].conj()
    a, b = 0.5 * (z + y), 0.5 * (z - y)
    c = w[k] * b
    X = torch.zeros(Z.shape[:-1] + (half + 1,), dtype=Z.dtype)
    X[..., k] = a - 1j * c
    X[..., half - k] = (a + 1j * c).conj()       # k = n_fft/4 writes its own bin twice, alike
    X[..., 0] = Z[..., 0].real + Z[..., 0].imag
    X[..., half] = Z[..., 0].real - Z[..., 0].imag
    return X


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_half_length_pack_unpack_matches_rfft(n_fft):
    # the real frame as n_fft/2 complex points, transformed in float32, unpacked with
    # the kernel's own table, against the float64 rfft
    rng = np.random.RandomState(n_fft)
    x = torch.from_numpy(rng.randn(4, n_fft).astype(np.float32))
    z = torch.complex(x[:, 0::2], x[:, 1::2])
    X = _unpack(torch.fft.fft(z), n_fft)
    assert X.dtype == torch.complex64
    want = torch.fft.rfft(x.double())
    assert _snr_complex(X.numpy().astype(np.complex128), want.numpy()) >= 130.0


def _bit_reverse(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _kernel_fft(z, n_fft):
    """The kernel's FFT of n_fft/2 complex points, thread for thread.

    Thread ``lt`` of a frame's ``T`` holds elements ``lt + s*T``; a pass
    multiplies by its table's twiddles, runs radix-R transforms on the
    registers (outputs in bit-reversed registers) and stores through the
    padded exchange layout. float64 arithmetic on the float32 tables.
    Returns the spectrum and the largest number of lanes of one warp that
    met in one shared-memory bank.
    """
    half = n_fft // 2
    points, radices = fused_stft._fft_plan(n_fft)
    pads = fused_stft._exchange_pads(n_fft)
    table = fused_stft._twiddles(n_fft).astype(np.float64)
    T = half // points
    lt_ = np.arange(T)
    regs = np.stack([z[lt_ + s * T] for s in range(points)]).astype(np.complex128)
    buf = np.full(fused_stft._frame_floats(n_fft) // 2, np.nan, np.complex128)
    worst, p, off = 1, 1, 0

    def lanes_per_bank(addr):
        most = 1
        for w0 in range(0, len(addr), 32):
            banks = np.unique(addr[w0:w0 + 32]) % 32      # equal addresses broadcast
            most = max(most, np.bincount(banks).max())
        return most

    for i, R in enumerate(radices):
        B, bits = points // R, R.bit_length() - 1
        if i > 0:
            n = (R - 1) * p
            for q in range(B):
                k = (lt_ + q * T) & (p - 1)
                for r in range(1, R):
                    idx = off + (r - 1) * p + k
                    worst = max(worst, lanes_per_bank(idx))
                    regs[q + r * B] *= table[idx] + 1j * table[idx + n]
            off += 2 * n
        for q in range(B):                                  # radix-R transform of registers q + r*B
            v = regs[q::B].copy()
            regs[q::B] = np.fft.fft(v, axis=0)[[_bit_reverse(r, bits) for r in range(R)]]
        last = i == len(radices) - 1
        pad, unit = (0, 32) if last else pads[i]
        for q in range(B):
            bi = lt_ + q * T
            k = bi & (p - 1)
            for r in range(R):
                a = bi + r * B * T if last else (bi - k) * R + k + r * p
                a = a + pad * (a // unit)
                worst = max(worst, lanes_per_bank(a))
                buf[a] = regs[q + _bit_reverse(r, bits) * B]
        if not last:
            for s in range(points):
                a = lt_ + s * T
                a = a + pad * (a // unit)
                worst = max(worst, lanes_per_bank(a))
                regs[s] = buf[a]
        p *= R
    assert off + 2 * (n_fft // 4 + 1) == len(table)
    return buf[:half], worst


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_fft_plan_exchange_and_twiddles(n_fft):
    points, radices = fused_stft._fft_plan(n_fft)
    assert int(np.prod(radices)) == n_fft // 2 and max(radices) <= points
    assert 1 <= n_fft // 2 // points <= 256   # a frame's threads fit in one block
    rng = np.random.RandomState(n_fft + 1)
    z = rng.randn(n_fft // 2) + 1j * rng.randn(n_fft // 2)
    Z, lanes = _kernel_fft(z, n_fft)
    assert _snr_complex(Z, np.fft.fft(z)) >= 130.0
    assert lanes == 1                       # no two lanes of a warp in one bank, tables included
    X = _unpack(torch.from_numpy(Z), n_fft)  # and on through the unpacking, in float64
    x = np.empty(n_fft)
    x[0::2], x[1::2] = z.real, z.imag
    assert _snr_complex(X.numpy(), np.fft.rfft(x)) >= 130.0


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_tile_fits_shared_memory_over_the_support_set(n_fft):
    for hop in range(1, n_fft + 1):
        assert fused_stft.fused_supported(n_fft, hop)
        tt = fused_stft._tile_frames(n_fft, hop)
        assert tt in (1, 2, 4, 8)
        assert fused_stft._smem_bytes(n_fft, hop, tt) <= 232448
        # whole frames on every thread of a block, and whole warps
        threads = min(256, tt * (n_fft // 2 // fused_stft._fft_plan(n_fft)[0]))
        assert threads % 32 == 0 and threads % (n_fft // 2 // fused_stft._fft_plan(n_fft)[0]) == 0
    if n_fft == 2048:  # the main path: 8 frames a block, two blocks an SM
        assert fused_stft._tile_frames(2048, 512) == 8
        assert 2 * (fused_stft._smem_bytes(2048, 512, 8) + 1024) <= 233472
