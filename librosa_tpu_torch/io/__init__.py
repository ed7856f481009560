"""Audio decoding on the host, and the host-side libsoxr binding.

Decoding is host work that feeds the card. The port's own C++ decoder
(``csrc/audioio.cpp``: WAV and FLAC written from their specifications, Ogg
Vorbis through the system's libvorbisfile, MP3 through libmpg123) is built
with ``g++`` at first use. Where it cannot be built, WAV files are read with
the standard ``wave`` module and other containers raise.
"""

from __future__ import annotations

import os
import wave
from typing import Optional, Tuple

import numpy as np

from ..util.exceptions import ParameterError
from . import _native, _soxr  # noqa: F401

__all__ = ["read_audio", "get_samplerate", "get_info", "AudioReader"]


def _wav_bytes_to_float(raw: bytes, width: int) -> np.ndarray:
    """Interleaved little-endian PCM bytes of ``width`` bytes a sample as float32 in [-1, 1)."""
    if width == 2:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if width == 4:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    if width == 1:
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    if width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        vals = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        return vals.astype(np.float32) / float(1 << 23)
    raise ParameterError(f"Unsupported WAV sample width: {width}")


class AudioReader:
    """A decoding handle on an audio file: open once, ``seek`` to a frame, ``read`` N frames.

    What :func:`read_audio` and ``stream`` read through, with memory
    O(block) whatever the file's length. The port's decoder reads WAV, FLAC,
    Ogg Vorbis and MP3; where it cannot be built, WAV is read with the
    standard ``wave`` module and other containers raise ``ParameterError``.

    Attributes
    ----------
    sr : int
        the file's sampling rate
    channels : int
        its number of channels
    frames : int or None
        its length in frames, where the container declares it
    """

    def __init__(self, path):
        path = os.fspath(path)
        self._nat = None
        self._wave = None
        if _native.library() is not None:
            self._nat = _native.NativeStream(path)
            self.sr = self._nat.sr
            self.channels = self._nat.channels
            self.frames = self._nat.frames
        else:
            if os.path.splitext(path)[1].lower() not in (".wav", ".wave"):
                raise ParameterError(
                    f"Cannot stream {path!r}: native audio module unavailable "
                    "and the pure-Python fallback only supports WAV"
                )
            self._wave = wave.open(path, "rb")
            self.sr = self._wave.getframerate()
            self.channels = self._wave.getnchannels()
            self.frames = self._wave.getnframes()
            self._width = self._wave.getsampwidth()

    def read(self, n_frames: int) -> np.ndarray:
        """The next ``n_frames`` frames as ``(n, channels)`` float32 in [-1, 1).

        ``n`` is smaller at the end of the file and 0 at its end.
        """
        if self._nat is not None:
            return self._nat.read(int(n_frames))
        raw = self._wave.readframes(int(n_frames))
        return _wav_bytes_to_float(raw, self._width).reshape(-1, self.channels)

    def seek(self, frame: int) -> None:
        """Make the next :meth:`read` start at ``frame`` (clamped to the file).

        Nothing before ``frame`` is decoded, except for FLAC, which decodes
        forward to it (and from the start when it seeks backwards).
        """
        frame = max(0, int(frame))
        if self._nat is not None:
            self._nat.seek(frame)
        else:
            self._wave.setpos(min(frame, self.frames))

    def close(self) -> None:
        """Release the decoder's handle and buffers. Idempotent."""
        if self._nat is not None:
            self._nat.close()
            self._nat = None
        if self._wave is not None:
            self._wave.close()
            self._wave = None

    def __enter__(self) -> "AudioReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def get_info(path) -> Tuple[int, int, int]:
    """``(sr, n_channels, n_frames)`` of an audio file, read from its headers.

    No sample is decoded, except where the container does not declare its length.
    """
    if _native.library() is not None:
        return _native.info(os.fspath(path))
    with wave.open(os.fspath(path), "rb") as w:
        return w.getframerate(), w.getnchannels(), w.getnframes()


def get_samplerate(path) -> int:
    """The sampling rate that an audio file's header declares."""
    return get_info(os.fspath(path))[0]


def read_audio(
    path,
    *,
    offset: float = 0.0,
    duration: Optional[float] = None,
    dtype: np.dtype = np.float32,
) -> Tuple[np.ndarray, int]:
    """Decode an audio file to ``(y, sr)`` on the host.

    ``y`` is ``(channels, n)``, or ``(n,)`` for one channel, in ``dtype``.
    ``offset`` (seconds, may be negative: from the end) seeks instead of
    decoding what it skips, and ``duration`` (seconds) stops the decoder
    early.
    """
    with AudioReader(path) as reader:
        sr = reader.sr
        start = int(np.round(sr * offset)) if offset else 0
        if start < 0:
            if reader.frames is None:
                raise ParameterError(
                    "negative offset requires a container that declares its length"
                )
            start = max(0, reader.frames + start)
        if start:
            reader.seek(start)
        if duration is not None:
            data = reader.read(int(np.round(sr * duration)))
        elif reader.frames is not None:
            data = reader.read(max(0, reader.frames - start))
        else:
            chunks = []
            while True:
                c = reader.read(1 << 16)
                if c.shape[0] == 0:
                    break
                chunks.append(c)
            data = (np.concatenate(chunks) if chunks
                    else np.empty((0, reader.channels), dtype=np.float32))

    y = data.astype(dtype, copy=False).T
    if y.shape[0] == 1:
        y = y[0]
    return np.ascontiguousarray(y), int(sr)
