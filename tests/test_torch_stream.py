"""The port's ``stream`` and ``StreamResampler`` against the JAX package, block for block.

The files are written here: 16-bit WAV with the ``wave`` module and FLAC
with ``tests/flac_writer.py``. Blocks are numpy arrays in both packages and
must be bit-equal; so must the streaming resampler, since both bind the same
libsoxr (those cases skip where libsoxr does not load).
"""

import wave

import numpy as np
import pytest

import librosa_tpu as lt
import librosa_tpu_torch as L
from flac_writer import write_flac
from librosa_tpu_torch.io import _soxr

SR = 22050


def _pcm16(rng, n, channels):
    y = 0.3 * np.sin(2 * np.pi * 330 * np.arange(n) / SR)[:, None] + 0.1 * rng.randn(n, channels)
    return (np.clip(y, -1, 1) * 32767).astype("<i2")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    rng = np.random.RandomState(21)
    out = {}
    for channels in (1, 2):
        pcm = _pcm16(rng, 3 * SR + 777, channels)
        path = d / f"wav{channels}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(SR)
            w.writeframes(pcm.tobytes())
        out[f"wav{channels}"] = str(path)
        path = d / f"flac{channels}.flac"
        write_flac(str(path), pcm, SR, blocksize=1152)
        out[f"flac{channels}"] = str(path)
    return out


def _blocks(M, path, **kw):
    return list(M.stream(path, **kw))


def _assert_same_blocks(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


STREAM_CASES = {
    "plain": dict(block_length=4, frame_length=2048, hop_length=512),
    "stereo": dict(block_length=3, frame_length=1024, hop_length=256, mono=False),
    "fill_value": dict(block_length=5, frame_length=2048, hop_length=512, fill_value=0.25),
    "offset_duration": dict(block_length=2, frame_length=512, hop_length=512, offset=0.4,
                            duration=1.3),
    "negative_offset": dict(block_length=7, frame_length=1000, hop_length=300, offset=-1.1),
    "float64": dict(block_length=2, frame_length=2048, hop_length=1024, dtype=np.float64),
}


@pytest.mark.parametrize("kind", ["wav1", "wav2", "flac1", "flac2"])
@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_blocks_equal_jax(files, kind, case):
    kw = STREAM_CASES[case]
    _assert_same_blocks(_blocks(L, files[kind], **kw), _blocks(lt, files[kind], **kw))


def test_stream_blocks_tile_the_loaded_signal(files):
    y, _ = L.load(files["flac2"], sr=None, mono=False)
    frame, hop, bl = 2048, 512, 6
    for b, block in enumerate(L.stream(files["flac2"], block_length=bl, frame_length=frame,
                                       hop_length=hop, mono=False)):
        start = b * bl * hop
        np.testing.assert_array_equal(block, y[:, start:start + (bl - 1) * hop + frame])


def test_stream_accepts_an_open_reader_and_leaves_it_open(files):
    kw = dict(block_length=4, frame_length=1024, hop_length=512)
    with L.io.AudioReader(files["flac1"]) as reader, lt.io.AudioReader(files["flac1"]) as ref:
        _assert_same_blocks(_blocks(L, reader, **kw), _blocks(lt, ref, **kw))
        reader.seek(0)
        again = next(L.stream(reader, **kw))
        assert reader._nat is not None
    np.testing.assert_array_equal(again, _blocks(lt, files["flac1"], **kw)[0])


def test_stream_never_materializes_signal(files, monkeypatch):
    """The decoder is only ever asked for one advance at a time, never the file."""
    read_sizes = []
    orig_read = L.io.AudioReader.read

    def spy(self, n):
        read_sizes.append(int(n))
        return orig_read(self, n)

    monkeypatch.setattr(L.io.AudioReader, "read", spy)
    frame, hop, bl = 2048, 512, 8
    advance = bl * hop
    blocks = list(L.stream(files["wav1"], block_length=bl, frame_length=frame,
                           hop_length=hop, sr=None))
    assert len(blocks) > 10
    assert len(read_sizes) > 10          # many small reads, not one big one
    assert max(read_sizes) <= advance    # never more than one advance at once


@pytest.mark.skipif(not _soxr.available(), reason="libsoxr does not load here")
@pytest.mark.parametrize("kind", ["wav1", "flac2"])
def test_stream_resampled_equal_jax(files, kind):
    kw = dict(block_length=13, frame_length=1024, hop_length=256, sr=SR // 2, mono=kind == "wav1")
    _assert_same_blocks(_blocks(L, files[kind], **kw), _blocks(lt, files[kind], **kw))


@pytest.mark.skipif(not _soxr.available(), reason="libsoxr does not load here")
@pytest.mark.parametrize("channels", [1, 2])
def test_stream_resampler_equal_jax(channels):
    x = np.random.RandomState(channels).randn(30000, channels).astype(np.float32)
    if channels == 1:
        x = x[:, 0]
    got_rs = L.io._soxr.StreamResampler(44100, 16000, channels=channels, quality="soxr_vhq")
    ref_rs = lt.io._soxr.StreamResampler(44100, 16000, channels=channels, quality="soxr_vhq")
    got, want = [], []
    for lo in range(0, len(x), 7000):
        got.append(got_rs.process(x[lo:lo + 7000]))
        want.append(ref_rs.process(x[lo:lo + 7000]))
        # an empty block in the middle changes nothing
        assert got_rs.process(x[:0]).shape[0] == 0 and ref_rs.process(x[:0]).shape[0] == 0
    got.append(got_rs.process(x[:0], last=True))
    want.append(ref_rs.process(x[:0], last=True))
    got, want = np.concatenate(got), np.concatenate(want)
    np.testing.assert_array_equal(got, want)
    oneshot = L.io._soxr.resample(x if channels == 1 else x[:, 0], 44100, 16000, "soxr_vhq")
    n = min(len(oneshot), len(got))
    np.testing.assert_allclose(got[:n] if channels == 1 else got[:n, 0], oneshot[:n], atol=1e-7)
    got_rs.close()
    got_rs.close()
    with pytest.raises(ValueError, match="closed"):
        got_rs.process(x)


def test_soxr_unavailable(monkeypatch):
    monkeypatch.setattr(_soxr, "_lib", None)
    monkeypatch.setattr(_soxr, "_load_failed", True)
    assert _soxr.available() is False
    with pytest.raises(RuntimeError, match="libsoxr"):
        _soxr.StreamResampler(2, 1)
    with pytest.raises(RuntimeError, match="libsoxr"):
        _soxr.resample(np.zeros(10, np.float32), 2, 1)


def test_stream_errors(files):
    path = files["wav1"]
    for M in (L, lt):
        with pytest.raises(M.ParameterError, match="block_length"):
            next(M.stream(path, block_length=0, frame_length=10, hop_length=5))
        with pytest.raises(M.ParameterError, match="frame_length"):
            next(M.stream(path, block_length=2, frame_length=2.5, hop_length=5))
        with pytest.raises(M.ParameterError, match="hop_length"):
            next(M.stream(path, block_length=2, frame_length=10, hop_length=-1))
        with pytest.raises(M.ParameterError, match="sr="):
            next(M.stream(path, block_length=2, frame_length=10, hop_length=5, sr=-3))
        with pytest.raises(M.ParameterError, match="soxr"):
            next(M.stream(path, block_length=4, frame_length=10, hop_length=5,
                          res_type="polyphase"))
        with pytest.raises(M.ParameterError, match="fractional"):
            next(M.stream(path, block_length=3, frame_length=7, hop_length=7, sr=SR / 3.0001))
