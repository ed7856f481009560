"""A ctypes binding of the system's ``libsoxr`` for the ``soxr_*`` resampling qualities.

Host code on numpy arrays: ``core.audio.resample`` calls it for input on the
CPU only. The library is looked up at first use; where it does not load,
:func:`available` is False and ``resample`` falls to its polyphase resampler.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

__all__ = ["available", "resample"]

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
