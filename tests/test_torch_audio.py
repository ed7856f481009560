"""The port's decoder, load, channel mixers and signal functions against the JAX package.

Every file here is written by the test itself: WAV at each sample format the
decoder reads (with a RIFF writer for the formats the ``wave`` module does
not write) and FLAC with ``tests/flac_writer.py``. The same file or the same
seeded array goes through the port (on the CPU) and through the JAX
function. Decoding and ``load`` at the file's rate are bit-equal; the other
tolerances are stated where they are used.
"""

import io as stdio
import os
import struct
import warnings
import wave
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import librosa_tpu as lt
import librosa_tpu_torch as L
from flac_writer import write_flac
from librosa_tpu_torch.io import _native, _soxr

ROOT = Path(__file__).resolve().parent.parent
SR = 22050
POLY_SNR_DB = 110.0  # the floor tests/test_torch_resample.py holds polyphase to
SOXR_ATOL = 1e-6
SIGNAL_SNR_DB = 120.0  # the audio_ops and lpc_burg_noise goldens' floor


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def snr_db(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.sum(np.abs(got.astype(np.complex128) - want.astype(np.complex128)) ** 2)
    return 10 * np.log10(np.sum(np.abs(want.astype(np.complex128)) ** 2) / max(err, 1e-300))


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

_GUID_TAIL = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"


def write_riff(path, frames: bytes, *, tag: int, channels: int, sr: int, bits: int,
               extensible: bool = False):
    """A RIFF/WAVE file with one fmt chunk (plain or WAVE_FORMAT_EXTENSIBLE) and one data chunk."""
    align = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else tag, channels, sr, sr * align,
                      align, bits)
    if extensible:
        fmt += struct.pack("<HHI", 22, bits, (1 << channels) - 1)
        fmt += struct.pack("<H", tag) + _GUID_TAIL
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(frames)) + frames
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def _pcm(rng, n, channels, bits):
    """Seeded integer PCM ``(n, channels)`` and its expected float32 decoding."""
    if bits == 8:
        q = rng.randint(0, 256, size=(n, channels)).astype(np.uint8)
        return q.tobytes(), ((q.astype(np.float32) - 128.0) / 128.0)
    if bits == 16:
        q = rng.randint(-32768, 32768, size=(n, channels)).astype("<i2")
        return q.tobytes(), q.astype(np.float32) / 32768.0
    if bits == 24:
        q = rng.randint(-(1 << 23), 1 << 23, size=(n, channels)).astype(np.int32)
        raw = q.astype("<i4").view(np.uint8).reshape(n, channels, 4)[..., :3].tobytes()
        return raw, q.astype(np.float32) / float(1 << 23)
    q = rng.randint(-(1 << 31), (1 << 31) - 1, size=(n, channels), dtype=np.int64)
    q = q.astype("<i4")
    return q.tobytes(), (q.astype(np.float64) / 2147483648.0).astype(np.float32)


FORMATS = ["pcm8", "pcm16", "pcm24", "pcm32", "float32", "float64", "extensible16",
           "extensible_float32", "flac_mono", "flac_stereo"]


def make_file(tmp_path, kind, *, n=6000, channels=2, sr=SR, seed=0):
    """Write a file of ``kind``; return its path and the float32 ``(n, channels)`` it holds."""
    rng = np.random.RandomState(seed)
    path = tmp_path / f"{kind}.{'flac' if kind.startswith('flac') else 'wav'}"
    if kind.startswith("flac"):
        channels = 1 if kind == "flac_mono" else 2
        q = (rng.randn(n, channels) * 6000).astype(np.int16)
        write_flac(str(path), q, sr, blocksize=1024)
        return str(path), q.astype(np.float32) / 32768.0
    if kind.startswith("pcm") or kind == "extensible16":
        bits = 16 if kind == "extensible16" else int(kind[3:])
        raw, want = _pcm(rng, n, channels, bits)
        write_riff(path, raw, tag=1, channels=channels, sr=sr, bits=bits,
                   extensible=kind == "extensible16")
        return str(path), want
    dtype = np.float64 if kind == "float64" else np.float32
    x = (rng.uniform(-1, 1, size=(n, channels))).astype(dtype)
    write_riff(path, x.astype("<f8" if dtype == np.float64 else "<f4").tobytes(), tag=3,
               channels=channels, sr=sr, bits=8 * x.itemsize,
               extensible=kind == "extensible_float32")
    return str(path), x.astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("audio")
    return {kind: make_file(d, kind, seed=i) for i, kind in enumerate(FORMATS)}


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------


def test_decoder_is_built_from_the_ports_source():
    lib = _native.library()
    assert lib is not None
    path = _native.library_path()
    assert path.exists()
    assert path.parent == ROOT / "librosa_tpu_torch" / "_build"
    assert path.name.startswith("audioio-")


@pytest.mark.parametrize("kind", FORMATS)
def test_decode_bit_equal_to_jax(files, kind):
    path, want = files[kind]
    got, sr = L.io.read_audio(path)
    ref, ref_sr = lt.io.read_audio(path)
    assert sr == ref_sr == SR
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want.T[0] if want.shape[1] == 1 else want.T)
    assert L.io.get_info(path) == lt.io.get_info(path) == (SR, want.shape[1], want.shape[0])


def test_native_decode_info_and_stream(files):
    path, want = files["flac_stereo"]
    data, sr = _native.decode(path)
    np.testing.assert_array_equal(data, want)
    assert _native.info(path) == (sr, 2, len(want))
    with _native.NativeStream(path) as s:
        s.seek(4000)
        np.testing.assert_array_equal(s.read(100), want[4000:4100])
        s.seek(3)  # backwards: FLAC decodes again from the first frame
        np.testing.assert_array_equal(s.read(5), want[3:8])
        assert s.read(10 ** 6).shape == (len(want) - 8, 2)
        assert s.read(10).shape == (0, 2)
    with pytest.raises(ValueError, match="closed"):
        s.read(1)


def test_wave_fallback_reads_wav_bit_equal(files, monkeypatch):
    path, want = files["pcm16"]
    native, _ = L.io.read_audio(path, offset=0.01, duration=0.1)
    monkeypatch.setattr(_native, "library", lambda: None)
    fallback, sr = L.io.read_audio(path, offset=0.01, duration=0.1)
    assert sr == SR
    np.testing.assert_array_equal(fallback, native)
    assert L.io.get_info(path) == (SR, 2, len(want))
    for bits in (8, 24, 32):
        p, w = files[f"pcm{bits}"]
        np.testing.assert_array_equal(L.io.read_audio(p)[0], w.T)
    with pytest.raises(L.ParameterError, match="only supports WAV"):
        L.io.AudioReader(files["flac_mono"][0])


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------


LOAD_CASES = {
    "default": dict(),
    "native_rate": dict(sr=None),
    "offset_duration": dict(sr=None, offset=0.05, duration=0.1),
    "negative_offset": dict(sr=None, offset=-0.08),
    "negative_offset_duration": dict(sr=None, offset=-0.2, duration=0.05),
    "stereo": dict(sr=None, mono=False),
}


@pytest.mark.parametrize("kind", ["pcm16", "flac_stereo", "float32"])
@pytest.mark.parametrize("case", list(LOAD_CASES))
def test_load_native_rate_bit_equal(files, kind, case):
    path, _ = files[kind]
    got, sr = L.load(path, **LOAD_CASES[case])
    ref, ref_sr = lt.load(path, **LOAD_CASES[case])
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert sr == ref_sr
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.skipif(not _soxr.available(), reason="libsoxr does not load here")
def test_load_soxr_matches_jax(files):
    path, _ = files["pcm16"]
    got, sr = L.load(path, sr=16000)
    ref, ref_sr = lt.load(path, sr=16000)
    assert sr == ref_sr == 16000 and got.shape == np.shape(ref)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=SOXR_ATOL)


def test_load_polyphase_matches_jax(files):
    path, _ = files["flac_mono"]
    got, sr = L.load(path, sr=11025, res_type="polyphase")
    ref, _ = lt.load(path, sr=11025, res_type="polyphase")
    assert sr == 11025 and got.shape == np.shape(ref)
    assert snr_db(got, ref) >= POLY_SNR_DB


def test_load_stereo_resampled_keeps_channels(files):
    path, _ = files["pcm24"]
    got, _ = L.load(path, sr=11025, mono=False, res_type="polyphase")
    ref, _ = lt.load(path, sr=11025, mono=False, res_type="polyphase")
    assert got.shape == np.shape(ref) == (2, 3000)
    assert snr_db(got, ref) >= POLY_SNR_DB


def test_loadx_reads_the_local_example(files, tmp_path, monkeypatch):
    src, _ = files["pcm16"]
    (tmp_path / "trumpet.wav").write_bytes(Path(src).read_bytes())
    monkeypatch.setenv("LIBROSA_DATA_DIR", str(tmp_path))
    assert L.example("trumpet") == lt.example("trumpet") == str(tmp_path / "trumpet.wav")
    got, sr = L.loadx("trumpet", sr=None)
    ref, _ = lt.loadx("trumpet", sr=None)
    np.testing.assert_array_equal(got, np.asarray(ref))
    with pytest.raises(L.ParameterError, match="not found locally"):
        L.example("brahms")
    with pytest.raises(L.ParameterError, match="Unknown example"):
        L.ex("no-such-track")


def test_durations_and_rates(files):
    path, want = files["float64"]
    assert L.get_samplerate(path) == lt.get_samplerate(path) == SR
    assert L.io.get_samplerate(path) == SR
    assert L.get_duration(path=path) == lt.get_duration(path=path) == len(want) / SR
    y = np.zeros((2, 12345), dtype=np.float32)
    assert L.get_duration(y=torch.from_numpy(y), sr=8000) == lt.get_duration(y=y, sr=8000)
    for center in (True, False):
        S = np.zeros((1025, 37))
        assert (L.get_duration(S=torch.from_numpy(S), n_fft=2048, hop_length=256, center=center)
                == lt.get_duration(S=S, n_fft=2048, hop_length=256, center=center))
    with pytest.raises(L.ParameterError):
        L.get_duration()


# ---------------------------------------------------------------------------
# channel mixing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sig():
    rng = np.random.RandomState(5)
    return {"a": rng.randn(2, 300).astype(np.float32), "b": rng.randn(250).astype(np.float32),
            "c": rng.randn(3, 2, 280).astype(np.float32), "d": rng.randn(2, 280).astype(np.float32)}


MIX_CASES = {
    "mono_one": lambda M, s: M.to_mono(s["a"]),
    "mono_sum": lambda M, s: M.to_mono(s["c"], norm=False),
    "mono_many": lambda M, s: M.to_mono(s["a"], s["b"], s["c"]),
    "mono_cut": lambda M, s: M.to_mono(s["a"], s["b"], pad=False),
    "stereo": lambda M, s: M.to_stereo(left=s["a"], right=s["b"]),
    "stereo_left": lambda M, s: M.to_stereo(left=s["b"]),
    "stereo_right_cut": lambda M, s: M.to_stereo(right=s["a"], pad=False, norm=False),
    "stereo_nodownmix": lambda M, s: M.to_stereo(left=s["b"][:200], right=s["d"][:, :200],
                                                 downmix=False),
    "multi": lambda M, s: M.to_multi(s["a"], s["b"], s["c"]),
    "multi_cut": lambda M, s: M.to_multi(s["a"], s["b"], pad=False, norm=False),
    "multi_nodownmix": lambda M, s: M.to_multi(s["a"], s["d"], downmix=False),
}


@pytest.mark.parametrize("case", list(MIX_CASES))
def test_channel_mixing_matches_jax(sig, case):
    got = host(MIX_CASES[case](L, sig))
    want = np.asarray(MIX_CASES[case](lt, sig))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_channel_mixing_errors(sig):
    for M in (L, lt):
        with pytest.raises(M.ParameterError):
            M.to_mono()
        with pytest.raises(M.ParameterError):
            M.to_stereo()
        with pytest.raises(M.ParameterError):
            M.to_multi()
        with pytest.raises(M.ParameterError, match="channel layouts"):
            M.to_multi(sig["a"], sig["b"], downmix=False)
        with pytest.raises(M.ParameterError, match="downmix=False"):
            M.to_stereo(left=sig["c"], right=sig["b"], downmix=False)


# ---------------------------------------------------------------------------
# autocorrelation, lpc, zero crossings, mu-law
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def noise():
    rng = np.random.RandomState(11)
    return rng.randn(3, 2048).astype(np.float32)


SIGNAL_CASES = {
    "acorr": lambda M, x: M.autocorrelate(x, max_size=300),
    "acorr_axis0": lambda M, x: M.autocorrelate(x.T, axis=0),
    "acorr_complex": lambda M, x: M.autocorrelate((x[0] + 1j * x[1]).astype(np.complex64),
                                                  max_size=64),
    "lpc": lambda M, x: M.lpc(x, order=12),
    "lpc_axis0": lambda M, x: M.lpc(x.T, order=4, axis=0),
    "mu": lambda M, x: M.mu_compress(np.tanh(x), quantize=False),
    "mu_expand": lambda M, x: M.mu_expand(np.tanh(x), quantize=False),
    "mu_expand_codes": lambda M, x: M.mu_expand(M.mu_compress(np.tanh(x)), quantize=True),
}


@pytest.mark.parametrize("case", list(SIGNAL_CASES))
def test_signal_functions_match_jax(noise, case):
    got = host(SIGNAL_CASES[case](L, noise))
    want = np.asarray(SIGNAL_CASES[case](lt, noise))
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    assert snr_db(got, want) >= SIGNAL_SNR_DB


def test_mu_compress_codes_equal_jax(noise):
    for mu in (255, 15, 100):
        got = L.mu_compress(np.tanh(noise), mu=mu)
        want = np.asarray(lt.mu_compress(np.tanh(noise), mu=mu))
        np.testing.assert_array_equal(got.numpy(), want)
    assert L.mu_compress(torch.tensor([-1.0, 0.0, 1.0])).tolist() == [-128, 0, 127]


def test_lpc_keeps_dtype(noise):
    assert L.lpc(torch.from_numpy(noise.astype(np.float64)), order=3).dtype == torch.float64
    a = L.lpc(noise, order=2)
    assert torch.equal(a[..., 0], torch.ones(3))


ZC_CASES = {
    "default": dict(),
    "threshold": dict(threshold=0.3),
    "callable_ref": dict(threshold=0.2, ref_magnitude=np.max),
    "mean_ref": dict(threshold=0.5, ref_magnitude=np.mean),
    "number_ref": dict(threshold=0.1, ref_magnitude=3.0),
    "no_threshold": dict(threshold=None),
    "zero_neg": dict(zero_pos=False),
    "nopad": dict(pad=False),
    "axis0": dict(axis=0),
}


@pytest.mark.parametrize("case", list(ZC_CASES))
def test_zero_crossings_equal_jax(noise, case):
    x = noise.copy()
    x[:, ::7] = 0.0
    x[:, 3::11] = -0.0
    got = L.zero_crossings(x, **ZC_CASES[case])
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(lt.zero_crossings(x, **ZC_CASES[case])))


@pytest.mark.parametrize("kw", [dict(), dict(center=False), dict(frame_length=1000, hop_length=333),
                                dict(threshold=0.4, pad=True), dict(zero_pos=False)],
                         ids=["default", "uncentred", "odd_frames", "threshold_pad", "zero_neg"])
def test_zero_crossing_rate_equal_jax(noise, kw):
    got = L.feature.zero_crossing_rate(noise, **kw)
    want = np.asarray(lt.feature.zero_crossing_rate(noise, **kw))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_zero_crossing_rate_with_callable_reference(noise):
    # the JAX function raises here (its jit cannot call a numpy function); the port computes
    got = L.feature.zero_crossing_rate(noise, threshold=0.1, ref_magnitude=np.max)
    frames = L.util.frame(np.pad(noise, ((0, 0), (1024, 1024)), mode="edge"),
                          frame_length=2048, hop_length=512)
    want = np.asarray(lt.zero_crossings(frames.numpy(), threshold=0.1, ref_magnitude=np.max,
                                        pad=False, axis=-2)).mean(axis=-2, keepdims=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("axis", [-1, -2, -3, 0, 1, 2])
def test_util_frame_equal_jax(axis):
    x = np.random.RandomState(3).randn(20, 30, 25).astype(np.float32)
    got = L.util.frame(x, frame_length=7, hop_length=3, axis=axis)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(lt.util.frame(x, frame_length=7, hop_length=3,
                                                           axis=axis)))


def test_signal_errors():
    for M in (L, lt):
        with pytest.raises(M.ParameterError):
            M.lpc(np.ones(100, dtype=np.float32), order=0)
        with pytest.raises(M.ParameterError, match="floating-point"):
            M.lpc(np.ones(100, dtype=np.int32), order=2)
        with pytest.raises(M.ParameterError, match="range"):
            M.mu_compress(np.array([0.5, 1.5], dtype=np.float32))
        with pytest.raises(M.ParameterError, match="strictly positive"):
            M.mu_compress(np.zeros(3, dtype=np.float32), mu=0)
        with pytest.raises(M.ParameterError, match="range"):
            M.mu_expand(np.array([300, 0]), quantize=True)
        with pytest.raises(M.ParameterError, match="strictly positive"):
            M.mu_expand(np.zeros(3, dtype=np.float32), mu=-1)
        with pytest.raises(M.ParameterError, match="too short"):
            M.util.frame(np.zeros(5), frame_length=8, hop_length=1)
        with pytest.raises(M.ParameterError, match="hop_length"):
            M.util.frame(np.zeros(10), frame_length=8, hop_length=0)


def test_decode_errors(tmp_path):
    bad = tmp_path / "x.wav"
    bad.write_bytes(b"JUNKJUNKJUNK")
    for M in (L, lt):
        with pytest.raises(RuntimeError, match="unrecognized audio format"):
            M.load(str(bad))
        with pytest.raises(RuntimeError, match="cannot open file"):
            M.io.read_audio(str(tmp_path / "missing.wav"))


# ---------------------------------------------------------------------------
# conversions, files, life-cycle helpers
# ---------------------------------------------------------------------------


CONVERT_CASES = {
    "samples_to_frames": lambda M: M.samples_to_frames([0, 511, 512, 5000], hop_length=512,
                                                        n_fft=2048),
    "frames_to_time": lambda M: M.frames_to_time(np.arange(9), sr=16000, hop_length=160,
                                                  n_fft=400),
    "time_to_frames": lambda M: M.time_to_frames([0.0, 0.5, 1.7], sr=SR, n_fft=1024),
    "samples_to_time": lambda M: M.samples_to_time(np.arange(0, 50000, 777), sr=SR),
    "blocks_to_frames": lambda M: M.blocks_to_frames(np.arange(6), block_length=13),
    "blocks_to_samples": lambda M: M.blocks_to_samples(3, block_length=13, hop_length=256),
    "blocks_to_time": lambda M: M.blocks_to_time(np.arange(4), block_length=13,
                                                  hop_length=256, sr=SR),
    "times_like": lambda M: M.times_like(np.zeros((3, 17)), sr=8000, hop_length=80, n_fft=256),
    "times_like_count": lambda M: M.times_like(12, axis=0),
    "samples_like_axis0": lambda M: M.samples_like(np.zeros((6, 2)), axis=0, hop_length=10),
    "multi_weighting": lambda M: M.multi_frequency_weighting(np.linspace(30, 9000, 21),
                                                             kinds="ABCDZ", min_db=-60),
}


@pytest.mark.parametrize("case", list(CONVERT_CASES))
def test_conversions_equal_jax(case):
    got, want = np.asarray(CONVERT_CASES[case](L)), np.asarray(CONVERT_CASES[case](lt))
    assert got.dtype == want.dtype
    if got.dtype.kind == "f":
        # the port computes the weighting curves in its own float64 order: a few ulps apart
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_array_equal(got, want)


def test_util_files_match_jax(tmp_path):
    for name in ("b.WAV", "a.flac", "sub/c.mp3", "sub/d.txt", "e.ogg"):
        (tmp_path / name).parent.mkdir(exist_ok=True)
        (tmp_path / name).write_bytes(b"")
    for kw in (dict(), dict(recurse=False), dict(ext="wav", case_sensitive=True),
               dict(ext=["mp3", "ogg"]), dict(offset=-2, limit=1)):
        assert L.util.find_files(str(tmp_path), **kw) == lt.util.find_files(str(tmp_path), **kw)
    outs = []
    for M in (L, lt):
        buf = stdio.StringIO()
        with redirect_stdout(buf):
            M.util.list_examples()
            M.util.example_info("trumpet")
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "trumpet" in outs[0]
    assert L.cite() == lt.cite() and L.cite("0.10.1") == lt.cite("0.10.1")
    for bad in ("0.11.0.dev0", "9.9"):
        with pytest.raises(L.ParameterError, match="No citation"):
            L.cite(bad)


def test_lifecycle_helpers_warn_as_jax():
    from librosa_tpu.util import decorators as jd
    from librosa_tpu_torch.util import decorators as td

    for D in (td, jd):
        @D.moved(moved_from="old.f", version="0.1", version_removed="1.0")
        def f(x):
            """Doc of f."""
            return x + 1

        @D.deprecated(version="0.2", version_removed="1.0")
        def g(x):
            return 2 * x

        @D.future_default(param_name="k", old_default=1, new_default=2, version="1.0")
        def h(x, k=1):
            return x * k

        @D.vectorize(otypes=[float])
        def v(x):
            """Doc of v."""
            return x if x > 0 else 0.0

        with pytest.warns(FutureWarning, match="old.f"):
            assert f(1) == 2
        assert f.__doc__ == "Doc of f."
        with pytest.warns(FutureWarning, match="scheduled for removal in 1.0"):
            assert g(2) == 4
        with pytest.warns(FutureWarning, match="switch its default"):
            assert h(3) == 3
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert h(3, 2) == 6 and h(3, k=1) == 3
        assert v.__doc__ == "Doc of v." and v(np.array([-1.0, 2.0])).tolist() == [0.0, 2.0]
    D = L.util.Deprecated()
    assert repr(D) == repr(lt.util.Deprecated())
    assert L.util.rename_kw(old_name="a", old_value=D, new_name="b", new_value=5,
                            version_deprecated="0.1", version_removed="0.2") == 5
    with pytest.warns(FutureWarning, match="a parameter is deprecated"):
        assert L.util.rename_kw(old_name="a", old_value=3, new_name="b", new_value=5,
                                version_deprecated="0.1", version_removed="0.2") == 3


def test_typing_aliases():
    from librosa_tpu import _typing as jt
    from librosa_tpu_torch import _typing as tt

    public = {n for n in dir(jt) if n.startswith("_") and not n.startswith("__")
              and n[1].isupper()}
    assert public <= set(dir(tt))
    assert tt._STFTPad == jt._STFTPad and tt._ModeKind == jt._ModeKind
    assert torch.Tensor in tt._WindowSpec.__args__

