"""A ctypes binding of the system's ``libsoxr`` for the ``soxr_*`` resampling qualities.

Host code on numpy arrays: ``core.audio.resample`` calls :func:`resample`
for input on the CPU only, and ``stream`` feeds its blocks through a
:class:`StreamResampler`. The library is looked up at first use; where it
does not load, :func:`available` is False and ``resample`` falls to its
polyphase resampler.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "resample", "StreamResampler"]

# quality recipes of soxr.h
_RECIPES = {"soxr_qq": 0, "soxr_lq": 1, "soxr_mq": 2, "soxr_hq": 4, "soxr_vhq": 6}
_SOXR_FLOAT32_I = 0


class _QualitySpec(ctypes.Structure):
    _fields_ = [
        ("precision", ctypes.c_double),
        ("phase_response", ctypes.c_double),
        ("passband_end", ctypes.c_double),
        ("stopband_begin", ctypes.c_double),
        ("e", ctypes.c_void_p),
        ("flags", ctypes.c_ulong),
    ]


class _IOSpec(ctypes.Structure):
    _fields_ = [
        ("itype", ctypes.c_int),
        ("otype", ctypes.c_int),
        ("scale", ctypes.c_double),
        ("e", ctypes.c_void_p),
        ("flags", ctypes.c_ulong),
    ]


_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    for name in ("libsoxr.so.0", "libsoxr.so", ctypes.util.find_library("soxr")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.soxr_quality_spec.restype = _QualitySpec
        lib.soxr_quality_spec.argtypes = [ctypes.c_ulong, ctypes.c_ulong]
        lib.soxr_io_spec.restype = _IOSpec
        lib.soxr_io_spec.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.soxr_oneshot.restype = ctypes.c_char_p
        lib.soxr_oneshot.argtypes = [
            ctypes.c_double, ctypes.c_double, ctypes.c_uint,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(_IOSpec), ctypes.POINTER(_QualitySpec), ctypes.c_void_p,
        ]
        # the streaming calls: soxr_create, soxr_process, soxr_delete
        lib.soxr_create.restype = ctypes.c_void_p
        lib.soxr_create.argtypes = [
            ctypes.c_double, ctypes.c_double, ctypes.c_uint, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(_IOSpec), ctypes.POINTER(_QualitySpec), ctypes.c_void_p,
        ]
        lib.soxr_process.restype = ctypes.c_char_p
        lib.soxr_process.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.soxr_delete.restype = None
        lib.soxr_delete.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
    _load_failed = True
    return None


def available() -> bool:
    """Whether ``libsoxr`` loads on this system (looked up once; never raises)."""
    return _get_lib() is not None


def resample(x: np.ndarray, in_rate: float, out_rate: float,
             quality: str = "soxr_hq") -> np.ndarray:
    """Resample a 1-d array with libsoxr's one-shot call, in float32.

    ``quality`` is one of ``soxr_vhq``, ``soxr_hq``, ``soxr_mq``,
    ``soxr_lq``, ``soxr_qq``. The output has as many samples as libsoxr
    wrote, at most ``ceil(n * out_rate / in_rate) + 1``.
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("libsoxr is not available on this system")
    if quality not in _RECIPES:
        raise ValueError(f"Unknown soxr quality: {quality}")

    x32 = np.ascontiguousarray(x, dtype=np.float32)
    n_in = x32.shape[0]
    n_out = int(np.ceil(n_in * out_rate / in_rate)) + 1
    out = np.zeros(n_out, dtype=np.float32)
    idone, odone = ctypes.c_size_t(0), ctypes.c_size_t(0)
    qspec = lib.soxr_quality_spec(_RECIPES[quality], 0)
    iospec = lib.soxr_io_spec(_SOXR_FLOAT32_I, _SOXR_FLOAT32_I)
    err = lib.soxr_oneshot(
        float(in_rate), float(out_rate), 1,
        x32.ctypes.data_as(ctypes.c_void_p), n_in, ctypes.byref(idone),
        out.ctypes.data_as(ctypes.c_void_p), n_out, ctypes.byref(odone),
        ctypes.byref(iospec), ctypes.byref(qspec), None,
    )
    if err:
        raise RuntimeError(f"soxr error: {err.decode()}")
    return out[:odone.value]


class StreamResampler:
    """A libsoxr resampler that keeps its filter's state from one block to the next.

    The streaming twin of :func:`resample`: the blocks of a signal go in one
    after the other, and the concatenated output is the one-shot resample of
    the whole signal, without the signal ever being held whole.

    Parameters
    ----------
    in_rate, out_rate : float > 0
        the rates in and out
    channels : int > 0
        channels of the blocks, interleaved
    quality : str
        one of the ``soxr_*`` recipe names
    """

    def __init__(self, in_rate: float, out_rate: float, *, channels: int = 1,
                 quality: str = "soxr_hq"):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("libsoxr is not available on this system")
        if quality not in _RECIPES:
            raise ValueError(f"Unknown soxr quality: {quality}")
        self._lib = lib
        self._channels = int(channels)
        self._ratio = float(out_rate) / float(in_rate)
        err = ctypes.c_char_p(None)
        qspec = lib.soxr_quality_spec(_RECIPES[quality], 0)
        iospec = lib.soxr_io_spec(_SOXR_FLOAT32_I, _SOXR_FLOAT32_I)
        self._h = lib.soxr_create(float(in_rate), float(out_rate), self._channels,
                                  ctypes.byref(err), ctypes.byref(iospec), ctypes.byref(qspec),
                                  None)
        if not self._h:
            raise RuntimeError(f"soxr_create failed: {(err.value or b'?').decode()}")

    def _call(self, block: Optional[np.ndarray], n_in: int, cap: int) -> Tuple[int, np.ndarray]:
        """One ``soxr_process`` call: ``(input frames taken, output frames)``.

        A None ``block`` tells libsoxr that the input has ended.
        """
        out = np.empty((cap, self._channels), dtype=np.float32)
        idone, odone = ctypes.c_size_t(0), ctypes.c_size_t(0)
        e = self._lib.soxr_process(
            self._h, None if block is None else block.ctypes.data_as(ctypes.c_void_p), n_in,
            ctypes.byref(idone), out.ctypes.data_as(ctypes.c_void_p), cap, ctypes.byref(odone))
        if e:
            raise RuntimeError(f"soxr error: {e.decode()}")
        return idone.value, out[:odone.value]

    def process(self, block: np.ndarray, last: bool = False) -> np.ndarray:
        """Resample the next block; ``last=True`` also drains the filter's tail.

        ``block`` is ``(n,)`` or ``(n, channels)`` and may be empty; the
        output has its layout. Its length varies from call to call: libsoxr
        holds back what its filter has not centred yet and gives it out at
        the end.
        """
        if self._h is None:
            raise ValueError("resampler is closed")
        block = np.ascontiguousarray(block, dtype=np.float32)
        squeeze = block.ndim == 1
        if squeeze:
            block = block[:, None]
        n_in = block.shape[0]
        if n_in == 0 and not last:
            # libsoxr reads no input as the end of the stream; an empty block must change nothing
            return block[:, 0] if squeeze else block

        pieces = []
        fed = 0
        while True:
            cap = int(np.ceil((n_in - fed) * self._ratio)) + 256
            took, out = self._call(block[fed:] if fed < n_in else None, n_in - fed, cap)
            fed += took
            if out.shape[0]:
                pieces.append(out)
            if fed >= n_in and (out.shape[0] == 0 or not last):
                break
        if last:
            while True:  # the end of the input: drain until libsoxr gives nothing more
                _, out = self._call(None, 0, 8192)
                if out.shape[0] == 0:
                    break
                pieces.append(out)

        res = (np.concatenate(pieces, axis=0) if pieces
               else np.empty((0, self._channels), dtype=np.float32))
        return res[:, 0] if squeeze else res

    def close(self) -> None:
        """Free libsoxr's state. Idempotent; later calls to :meth:`process` raise."""
        if self._h is not None:
            self._lib.soxr_delete(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
