"""ctypes binding of the port's audio decoder (``csrc/audioio.cpp``).

The library is built with ``g++`` by ``ops/_build.py`` into
``librosa_tpu_torch/_build/`` the first time a file is decoded, never at
import. :func:`library` returns None where it cannot be built or loaded;
``io`` then reads WAV files with the standard ``wave`` module.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..ops import _build

__all__ = ["library", "library_path", "decode", "info", "NativeStream"]

_NAME = "audioio"
_lib: Optional[ctypes.CDLL] = None
_failed = False

_c_float_p = ctypes.POINTER(ctypes.c_float)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.lt_decode.restype = ctypes.c_int
    lib.lt_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(_c_float_p),
                              ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)]
    lib.lt_info.restype = ctypes.c_int
    lib.lt_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)]
    lib.lt_free.restype = None
    lib.lt_free.argtypes = [ctypes.c_void_p]
    lib.lt_last_error.restype = ctypes.c_char_p
    lib.lt_open.restype = ctypes.c_void_p
    lib.lt_open.argtypes = [ctypes.c_char_p]
    for fn in ("lt_stream_sr", "lt_stream_channels"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.lt_stream_frames.restype = ctypes.c_long
    lib.lt_stream_frames.argtypes = [ctypes.c_void_p]
    lib.lt_stream_read.restype = ctypes.c_long
    lib.lt_stream_read.argtypes = [ctypes.c_void_p, _c_float_p, ctypes.c_long]
    lib.lt_stream_seek.restype = ctypes.c_int
    lib.lt_stream_seek.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.lt_stream_close.restype = None
    lib.lt_stream_close.argtypes = [ctypes.c_void_p]
    return lib


def library() -> Optional[ctypes.CDLL]:
    """The decoder's library, built and loaded at the first call; None if that failed."""
    global _lib, _failed
    if _lib is None and not _failed:
        try:
            _lib = _bind(_build.load(_NAME))
        except (OSError, RuntimeError):
            _failed = True
    return _lib


def library_path() -> Path:
    """Where the decoder's library is built (a hash of its source in the name)."""
    return _build._lib_path(_NAME)


def _error(lib: ctypes.CDLL, what: str, rc: Optional[int] = None) -> RuntimeError:
    code = "" if rc is None else f" ({rc})"
    return RuntimeError(f"audio {what} failed{code}: {lib.lt_last_error().decode()}")


def decode(path: str) -> Tuple[np.ndarray, int]:
    """The whole file as ``((n_frames, n_channels) float32, sr)``.

    Raises RuntimeError with the decoder's message on a container it does not
    know or a malformed one.
    """
    lib = library()
    data = _c_float_p()
    frames, channels, sr = ctypes.c_long(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.lt_decode(os.fspath(path).encode(), ctypes.byref(data), ctypes.byref(frames),
                       ctypes.byref(channels), ctypes.byref(sr))
    if rc != 0:
        raise _error(lib, "decode", rc)
    try:
        n = frames.value * channels.value
        arr = np.ctypeslib.as_array(data, shape=(n,)).copy() if n else np.empty(0, np.float32)
    finally:
        lib.lt_free(data)
    return arr.reshape(frames.value, channels.value), sr.value


def info(path: str) -> Tuple[int, int, int]:
    """``(sr, n_channels, n_frames)`` from the container's headers.

    Only a container that does not declare its length is decoded, to count it.
    """
    lib = library()
    sr, channels, frames = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_long(0)
    rc = lib.lt_info(os.fspath(path).encode(), ctypes.byref(sr), ctypes.byref(channels),
                     ctypes.byref(frames))
    if rc != 0:
        raise _error(lib, "info", rc)
    return sr.value, channels.value, frames.value


class NativeStream:
    """A decoding handle: open once, then ``read`` / ``seek`` / ``close``.

    Memory is O(block): WAV is read straight off the file, FLAC decodes
    through a fixed sliding window, Ogg Vorbis and MP3 pull from their
    libraries. ``frames`` is None where the container does not declare its
    length.
    """

    def __init__(self, path):
        lib = library()
        handle = lib.lt_open(os.fspath(path).encode())
        if not handle:
            raise _error(lib, "open")
        self._lib = lib
        self._h = handle
        self.sr = int(lib.lt_stream_sr(handle))
        self.channels = int(lib.lt_stream_channels(handle))
        n = int(lib.lt_stream_frames(handle))
        self.frames = n if n >= 0 else None

    def read(self, n_frames: int) -> np.ndarray:
        """The next ``n_frames`` frames as ``(n, channels)`` float32; fewer at the end, none at EOF."""
        if self._h is None:
            raise ValueError("stream is closed")
        out = np.empty((int(n_frames), self.channels), dtype=np.float32)
        got = self._lib.lt_stream_read(self._h, out.ctypes.data_as(_c_float_p), int(n_frames))
        if got < 0:
            raise _error(self._lib, "stream read")
        return out[:int(got)]

    def seek(self, frame: int) -> None:
        """Make the next :meth:`read` start at frame ``frame``.

        WAV seeks by arithmetic, Ogg Vorbis and MP3 by their libraries, FLAC
        by decoding forward (a seek backwards starts again from the first
        audio frame).
        """
        if self._h is None:
            raise ValueError("stream is closed")
        if self._lib.lt_stream_seek(self._h, int(frame)) != 0:
            raise _error(self._lib, "stream seek")

    def close(self) -> None:
        """Free the handle (file, FLAC window, codec state). Idempotent."""
        if self._h is not None:
            self._lib.lt_stream_close(self._h)
            self._h = None

    def __enter__(self) -> "NativeStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
