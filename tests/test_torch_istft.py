"""The port's inverse STFT against the JAX package on the CPU, from the same seeded numpy inputs.

Covered: the window's sum-of-squares envelope, overlap-add, ``istft`` itself,
the plain version of the synthesis kernel (``ops/ola_norm.py``) against the
tail of the JAX ``_istft_core``, an emulation in numpy of the kernel's index
arithmetic, and the kernel's routing predicate.

Tolerances: rtol 1e-6 on the envelope (float64 sums rounded to float32 on
both sides), 120 dB on signals (the golden holds ``istft`` to 115 dB).
"""

import numpy as np
import pytest
import torch

import librosa_tpu as lt
from librosa_tpu.ops.framing import overlap_add as jax_overlap_add

import librosa_tpu_torch as L
from librosa_tpu_torch.core import spectrum as port_spectrum
from librosa_tpu_torch.ops import ola_norm
from librosa_tpu_torch.ops.framing import overlap_add

ISTFT_SNR_DB = 120.0


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


def _signal(*shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# window_sumsquare, overlap_add
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw",
    [dict(window="hann", n_frames=20, hop_length=512, n_fft=2048),
     dict(window="hann", n_frames=4000, hop_length=512, n_fft=2048),
     dict(window="hamming", n_frames=33, hop_length=256, n_fft=1024, win_length=768),
     dict(window="hann", n_frames=50, hop_length=441, n_fft=1024),
     dict(window=("kaiser", 4.0), n_frames=7, hop_length=512, n_fft=512),
     dict(window="hann", n_frames=25, hop_length=128, n_fft=512, norm=2),
     dict(window="hann", n_frames=1, hop_length=100, n_fft=256, dtype=np.float64)],
    ids=["20_frames", "4000_frames", "short_window", "odd_hop", "no_overlap", "norm2",
         "one_frame_f64"],
)
def test_window_sumsquare_matches_jax(kw):
    got = L.filters.window_sumsquare(**kw)
    want = lt.filters.window_sumsquare(**kw)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    assert got.shape == want.shape == (kw["n_fft"] + kw["hop_length"] * (kw["n_frames"] - 1),)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (512, 512), (512, 200), (256, 77), (64, 1)],
                         ids=["quarter", "no_overlap", "odd_200", "odd_77", "hop_1"])
def test_overlap_add_matches_jax(n_fft, hop):
    frames = np.random.RandomState(1).randn(2, 3, 9, n_fft).astype(np.float32)
    got = overlap_add(torch.from_numpy(frames), hop_length=hop)
    want = np.asarray(jax_overlap_add(frames, hop_length=hop))
    assert tuple(got.shape) == want.shape == (2, 3, n_fft + hop * 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # float64 in, float64 out; and the same bits on a second run
    got64 = overlap_add(torch.from_numpy(frames.astype(np.float64)), hop_length=hop)
    assert got64.dtype == torch.float64
    assert torch.equal(got, overlap_add(torch.from_numpy(frames), hop_length=hop))


def test_overlap_add_rejects_a_hop_of_zero():
    with pytest.raises(L.ParameterError):
        overlap_add(torch.zeros(3, 8), hop_length=0)


# ---------------------------------------------------------------------------
# istft
# ---------------------------------------------------------------------------

ISTFT_CASES = {
    "defaults": (dict(), dict()),
    "length": (dict(), dict(length=9000)),
    "length_short": (dict(), dict(length=5000)),
    "length_long": (dict(), dict(length=12000)),
    "uncentered": (dict(center=False), dict(center=False)),
    "uncentered_length": (dict(center=False), dict(center=False, length=8000)),
    "hamming512": (dict(n_fft=512, hop_length=128, window="hamming"),
                   dict(hop_length=128, window="hamming")),
    "short_window": (dict(n_fft=1024, win_length=768),
                     dict(n_fft=1024, win_length=768, length=9000)),
    "odd_hop": (dict(n_fft=1024, hop_length=441), dict(hop_length=441)),
    "no_overlap": (dict(n_fft=512, hop_length=512, window="boxcar"),
                   dict(hop_length=512, window="boxcar")),
}


@pytest.mark.parametrize("name", list(ISTFT_CASES))
@pytest.mark.parametrize("shape", [(9000,), (2, 9000)], ids=["mono", "stereo"])
def test_istft_matches_jax(name, shape):
    stft_kw, istft_kw = ISTFT_CASES[name]
    D = np.asarray(lt.stft(_signal(*shape, seed=2), **stft_kw))
    got = L.istft(D, **istft_kw)
    want = np.asarray(lt.istft(D, **istft_kw))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    # Where only the skirt of one frame's window reaches (the ends of an uncentred
    # signal, the last samples of the last frame), the envelope falls towards 1e-12
    # of its peak and the quotient is the inverse FFT's rounding noise over the
    # window, in both packages: samples with an envelope below a thousandth of its
    # peak are held to be finite, the rest to 120 dB.
    n_fft = 2 * (D.shape[-2] - 1)
    hop = istft_kw.get("hop_length", istft_kw.get("win_length", n_fft) // 4)
    start = n_fft // 2 if istft_kw.get("center", True) else 0
    wss = lt.filters.window_sumsquare(
        window=istft_kw.get("window", "hann"), n_frames=D.shape[-1], hop_length=hop,
        n_fft=n_fft, win_length=istft_kw.get("win_length"), dtype=np.float64)[start:]
    wss = np.pad(wss, (0, max(0, want.shape[-1] - len(wss))))[:want.shape[-1]]
    sound = (wss > 1e-3 * wss.max()) | (wss == 0)
    assert sound.mean() > 0.95
    assert _snr(got.numpy()[..., sound], want[..., sound]) >= ISTFT_SNR_DB
    assert np.isfinite(got.numpy()).all()
    assert (got.numpy()[..., wss == 0] == 0).all()


def test_istft_inverts_the_ports_stft():
    y = _signal(2, 3, 8192, seed=3)
    back = L.istft(L.stft(y, n_fft=1024), length=y.shape[-1])
    assert tuple(back.shape) == y.shape
    assert _snr(back, y) >= 115.0  # the goldens' floor for the round trip


def test_istft_float64_and_dtype():
    y = _signal(6000, seed=4).astype(np.float64)
    D = L.stft(y, n_fft=1024)
    assert D.dtype == torch.complex128
    back = L.istft(D, length=len(y))
    assert back.dtype == torch.float64
    assert _snr(back, y) >= 250.0  # float64 throughout
    assert L.istft(D, dtype=np.float32).dtype == torch.float32
    assert L.istft(D.to(torch.complex64), dtype=torch.float64).dtype == torch.float64


def test_istft_window_as_samples_and_bad_hop():
    y = _signal(6000, seed=5)
    win = lt.filters.get_window("hamming", 512)
    D = np.asarray(lt.stft(y, n_fft=512, window=win))
    got = L.istft(D, window=win, length=len(y))
    want = np.asarray(lt.istft(D, window=win, length=len(y)))
    assert _snr(got, want) >= ISTFT_SNR_DB
    with pytest.raises(L.ParameterError):
        L.istft(D, hop_length=0)


def test_istft_envelope_is_cached_per_configuration():
    from librosa_tpu_torch import _device

    D = np.asarray(lt.stft(_signal(5000, seed=6), n_fft=512))
    L.istft(D)
    keys = {k for k in _device._tables if k[0][0] == "wss"}
    L.istft(D)
    assert {k for k in _device._tables if k[0][0] == "wss"} == keys
    L.istft(D, length=4000)
    assert len({k for k in _device._tables if k[0][0] == "wss"}) == len(keys) + 1


# ---------------------------------------------------------------------------
# the synthesis kernel's plain version, its index arithmetic and its predicate
# ---------------------------------------------------------------------------

OLA_CASES = [
    # n_fft, hop, n_frames, start, out_len
    (512, 128, 20, 256, 2432),     # centred, as the frames give
    (512, 128, 20, 256, 2000),     # shorter
    (512, 128, 20, 256, 3100),     # longer: zeros past the last frame
    (512, 200, 11, 0, 2512),       # a hop that does not divide n_fft
    (1024, 441, 9, 512, 4000),
    (512, 512, 6, 0, 3072),        # no overlap
    (64, 1, 40, 32, 39),
]


def _ola_inputs(n_fft, hop, n_frames, start, out_len, tracks=2, seed=7):
    rng = np.random.RandomState(seed)
    frames = rng.randn(tracks, n_frames, n_fft).astype(np.float32)
    window = lt.filters.get_window("hann", n_fft).astype(np.float32)
    wss = lt.filters.window_sumsquare(window="hann", n_frames=n_frames, hop_length=hop,
                                      n_fft=n_fft)[start:start + out_len]
    wss = np.pad(wss, (0, out_len - len(wss)))
    return frames, window, wss


@pytest.mark.parametrize("case", OLA_CASES, ids=[f"n{c[0]}_h{c[1]}_o{c[4]}" for c in OLA_CASES])
def test_ola_norm_reference_matches_the_jax_tail(case):
    import jax.numpy as jnp

    from librosa_tpu.util import utils as jax_util

    n_fft, hop, n_frames, start, out_len = case
    frames, window, wss = _ola_inputs(*case)
    got = ola_norm.ola_norm_reference(torch.from_numpy(frames), torch.from_numpy(window),
                                      torch.from_numpy(wss), hop_length=hop, start=start)
    # the tail of librosa_tpu.core.spectrum._istft_core, step by step
    y_full = jax_overlap_add(jnp.asarray(frames) * window, hop_length=hop)
    take = min(y_full.shape[-1] - start, out_len)
    y = jnp.pad(y_full[..., start:start + take], [(0, 0), (0, out_len - take)])
    good = wss > jax_util.tiny(wss)
    want = np.asarray(jnp.where(good, y / jnp.where(good, wss, 1.0), y))
    assert tuple(got.shape) == want.shape == (2, out_len)
    assert _snr(got, want) >= 130.0  # the same float32 sums in another order
    # and ola_norm on a CPU tensor is that plain version
    same = ola_norm.ola_norm(torch.from_numpy(frames), torch.from_numpy(window),
                             torch.from_numpy(wss), hop_length=hop, start=start)
    assert torch.equal(same, got)


def _covering_frames(n, *, n_frames, n_fft, hop_length, start):
    """``(t_lo, t_hi)``: the frames csrc/ola_norm.cu sums for output sample ``n``, ``t_hi`` first.

    Frame ``t`` covers sample ``p = n + start`` when ``0 <= p - t * hop_length
    < n_fft``. The range is empty (``t_lo > t_hi``) past the last frame.
    """
    p = n + start
    t_hi = min(p // hop_length, n_frames - 1)
    t_lo = 0 if p < n_fft else (p - n_fft) // hop_length + 1
    return t_lo, t_hi


def _vector_width(*, n_fft, hop_length, start):
    """Output samples per thread of csrc/ola_norm.cu, on buffers at 16-byte boundaries.

    4 where four neighbours share their frames at 16-byte offsets: ``hop``,
    ``n_fft`` and ``start`` multiples of 4.
    """
    return 4 if hop_length % 4 == 0 and n_fft % 4 == 0 and start % 4 == 0 else 1


def _emulate_kernel(frames, window, wss, *, hop, start):
    """What csrc/ola_norm.cu computes, thread by thread, in float32 numpy."""
    tracks, n_frames, n_fft = frames.shape
    out_len = len(wss)
    vec = _vector_width(n_fft=n_fft, hop_length=hop, start=start)
    tiny = np.float32(np.finfo(np.float32).tiny)
    y = np.full((tracks, out_len), np.nan, dtype=np.float32)
    for n0 in range(0, out_len, vec):
        t_lo, t_hi = _covering_frames(n0, n_frames=n_frames, n_fft=n_fft,
                                              hop_length=hop, start=start)
        acc = np.zeros((tracks, vec), dtype=np.float32)
        for t in range(t_hi, t_lo - 1, -1):
            i = n0 + start - t * hop
            assert 0 <= i and i + vec <= n_fft and (vec == 1 or i % 4 == 0)
            acc = acc + frames[:, t, i:i + vec] * window[i:i + vec]
        for k in range(min(vec, out_len - n0)):
            e = wss[n0 + k]
            y[:, n0 + k] = acc[:, k] / e if e > tiny else acc[:, k]
    return y


@pytest.mark.parametrize("case", OLA_CASES, ids=[f"n{c[0]}_h{c[1]}_o{c[4]}" for c in OLA_CASES])
def test_kernel_index_arithmetic_matches_plain(case):
    n_fft, hop, n_frames, start, out_len = case
    frames, window, wss = _ola_inputs(*case)
    want = ola_norm.ola_norm_reference(torch.from_numpy(frames), torch.from_numpy(window),
                                       torch.from_numpy(wss), hop_length=hop, start=start)
    got = _emulate_kernel(frames, window, wss, hop=hop, start=start)
    assert not np.isnan(got).any()  # every output sample is written
    # the same products summed in the same order: bit for bit
    np.testing.assert_array_equal(got, want.numpy())


def test_covering_frames_are_exactly_the_frames_that_cover():
    for n_fft, hop, n_frames, start in ((512, 128, 20, 256), (512, 200, 11, 0), (64, 1, 40, 32),
                                        (512, 512, 6, 0)):
        for n in range(0, n_fft + hop * n_frames, 37):
            t_lo, t_hi = _covering_frames(n, n_frames=n_frames, n_fft=n_fft,
                                                  hop_length=hop, start=start)
            want = [t for t in range(n_frames) if 0 <= n + start - t * hop < n_fft]
            assert list(range(t_lo, t_hi + 1)) == want, (n_fft, hop, n)
            assert len(want) <= -(-n_fft // hop)


def test_vector_width():
    assert _vector_width(n_fft=2048, hop_length=512, start=1024) == 4
    assert _vector_width(n_fft=2048, hop_length=512, start=0) == 4
    assert _vector_width(n_fft=1024, hop_length=441, start=512) == 1
    assert _vector_width(n_fft=2048, hop_length=512, start=1023) == 1
    assert _vector_width(n_fft=1022, hop_length=512, start=0) == 1


def test_kernel_refusal_cases():
    frames, window, wss = (torch.zeros(2, 5, 64), torch.ones(64), torch.ones(300))
    assert ola_norm.kernel_refusal(frames, window, wss, 16) is None
    assert ola_norm.kernel_refusal(frames, window, wss, 64) is None
    assert "float32" in ola_norm.kernel_refusal(frames.double(), window, wss, 16)
    assert "float32" in ola_norm.kernel_refusal(frames, window, wss.double(), 16)
    assert "contiguous" in ola_norm.kernel_refusal(frames.transpose(0, 1), window, wss, 16)
    assert "hop_length" in ola_norm.kernel_refusal(frames, window, wss, 0)
    assert "hop_length" in ola_norm.kernel_refusal(frames, window, wss, 65)
    assert "window" in ola_norm.kernel_refusal(frames, torch.ones(32), wss, 16)
    assert "at least one" in ola_norm.kernel_refusal(frames[:, :0], window, wss, 16)
    long_wss = torch.empty(2**31 - 2000, device="meta")  # no memory behind it
    assert "32 bits" in ola_norm.kernel_refusal(frames.to("meta"), window.to("meta"), long_wss, 16)


def test_float32_routes_to_ola_norm_and_float64_to_plain(monkeypatch):
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port_spectrum._ola, "ola_norm", spy("kernel", ola_norm.ola_norm))
    monkeypatch.setattr(port_spectrum._ola, "ola_norm_reference",
                        spy("plain", ola_norm.ola_norm_reference))
    D = np.asarray(lt.stft(_signal(5000, seed=8), n_fft=512))
    L.istft(D)
    # on a CPU tensor the wrapper itself takes the plain version
    assert calls == ["kernel", "plain"]
    del calls[:]
    L.istft(D.astype(np.complex128))
    assert calls == ["plain"]


def test_ola_norm_on_another_device_raises():
    frames = torch.zeros(1, 4, 16, device="meta")
    with pytest.raises(L.ParameterError, match="cuda or cpu"):
        ola_norm.ola_norm(frames, torch.ones(16, device="meta"), torch.ones(40, device="meta"),
                          hop_length=4, start=0)
