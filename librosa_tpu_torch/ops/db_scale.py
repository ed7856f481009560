"""Decibel scaling: the CUDA kernel behind ``power_to_db`` / ``amplitude_to_db`` and its plain version.

The function is ``max(L - ref_db, peak - ref_db - top_db)`` with
``L = 10 * log10(max(amin, S))`` (``S`` squared first for amplitudes),
``peak`` the maximum of ``L`` over the reduction axes and ``ref_db`` either
that peak (``ref=np.max``: the peak is exactly 0 dB) or the level of a
reference value.

:func:`db_scale` on a CUDA tensor launches the hand-written kernel
``csrc/db_scale.cu`` (two launches: each channel's peak, then one
elementwise pass; built for ``sm_90a`` at first use by ``ops/_build.py``)
or raises; on a CPU tensor it runs :func:`db_scale_reference`, the plain
PyTorch version of the same function. The kernel takes what
:func:`kernel_refusal` does not refuse: contiguous float32 input reduced
over a trailing block of axes (each channel's last two for
``axes='auto'``) or over the whole array, and a ``ref`` that is a number
or a maximum. The callers in ``core/spectrum.py`` send everything else
(float64, complex, a callable or array ``ref``, other axes, strided input)
to the plain version by that predicate.

The kernel replaces no TPU kernel; the JAX package compiles this step with
XLA (``librosa_tpu/core/spectrum.py``: ``_db_log_core``,
``_db_maxref_core``, ``_power_to_db_core``).
"""

from __future__ import annotations

import ctypes
import numbers
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..util.exceptions import ParameterError
from ..util.utils import _device_reduction
from . import _build

__all__ = ["db_scale", "db_scale_reference", "kernel_refusal", "MAX_REFS", "launches"]

#: Kernel launches so far: :func:`db_scale` adds one per call that reaches
#: the card (the peak pass and the elementwise pass count as one). Callers
#: may reset it to 0.
launches = 0

#: References that mean "the maximum over the reduction axes".
MAX_REFS = (np.max, np.amax, torch.max, torch.amax)

_PART_ELEMENTS = 8192   # elements of a channel that one block of the kernel takes per ...
_MAX_PARTS = 1024       # ... part, up to this many parts a channel; then the blocks stride


def is_max_ref(ref: Any) -> bool:
    return any(ref is r for r in MAX_REFS)


def _trailing(ndim: int, axes: Any) -> Optional[int]:
    """How many trailing axes ``axes`` covers, or None if it is not a trailing block.

    ``axes=None`` (the whole array) covers all ``ndim``.
    """
    if axes is None:
        return ndim
    dims = sorted({int(a) % ndim for a in np.atleast_1d(axes).tolist()}) if ndim else []
    if dims and dims == list(range(ndim - len(dims), ndim)):
        return len(dims)
    return None


def kernel_refusal(S: torch.Tensor, ref: Any, axes: Any) -> Optional[str]:
    """Why the CUDA kernel does not take this call, or None if it does.

    ``axes`` is None or a tuple of axes (``'auto'`` already resolved). The
    one support rule: the callers route by it, and :func:`db_scale` raises
    with this reason on a CUDA tensor otherwise.
    """
    if S.dtype != torch.float32:
        return f"the db_scale kernel takes float32 input, not {S.dtype}"
    if S.ndim == 0 or S.numel() == 0:
        return "the db_scale kernel takes a non-empty array of at least one axis"
    if not S.is_contiguous():
        return "the db_scale kernel takes contiguous input"
    if _trailing(S.ndim, axes) is None:
        return f"the db_scale kernel reduces trailing axes or the whole array, not axes={axes}"
    if not (is_max_ref(ref) or (isinstance(ref, numbers.Real) and not isinstance(ref, bool))):
        return "the db_scale kernel takes a number or a maximum as ref"
    return None


def _amax(x: torch.Tensor, axes: Any) -> torch.Tensor:
    if axes is None:
        return x.amax()
    return x.amax(dim=tuple(np.atleast_1d(axes).tolist()), keepdim=True)


def db_scale_reference(S: torch.Tensor, *, ref: Any = 1.0, amin: float = 1e-10,
                       top_db: Optional[float] = 80.0, axes: Any = None,
                       amplitude: bool = False) -> torch.Tensor:
    """The plain PyTorch version of :func:`db_scale`, on ``S``'s device, for every input.

    ``ref`` is a number, an array, or a reduction of ``|S|`` over ``axes``
    with ``keepdims``: the numpy reductions that numpy hands to an array's
    own method (``np.mean``, ``np.sum``, ...) run as torch reductions on
    ``S``'s device, any other (``np.median``) on a host copy. With a maximum
    as ``ref`` the log is taken once and its maximum subtracted from that
    same tensor, so the peak is exactly 0 dB. ``amplitude`` squares
    ``|S|``, ``ref`` and ``amin``.
    """
    mag = S.abs() if amplitude or S.is_complex() else S
    if not mag.dtype.is_floating_point:
        mag = mag.to(torch.float32)
    max_ref = is_max_ref(ref)
    if callable(ref) and not max_ref:
        on_device = _device_reduction(ref, mag, axes)
        try:
            # any other numpy reduction (np.median, ...) gets a host copy
            ref = on_device if on_device is not None else ref(
                mag.detach().cpu().numpy(), axis=axes, keepdims=True)
        except TypeError as e:
            raise ParameterError(
                "The provided reference function must support 'axis' and "
                "'keepdims' arguments for proper multichannel processing."
            ) from e
    if amplitude:
        mag, amin = mag.square(), amin**2
    log_spec = 10.0 * torch.log10(mag.clamp(min=amin))
    if max_ref:
        log_spec = log_spec - _amax(log_spec, axes)
    else:
        ref_value = torch.as_tensor(ref, dtype=mag.dtype, device=mag.device).abs()
        if amplitude:
            ref_value = ref_value.square()
        log_spec = log_spec - 10.0 * torch.log10(ref_value.clamp(min=amin))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, _amax(log_spec, axes) - top_db)
    return log_spec


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("db_scale")
    fn = lib.db_scale_launch
    if fn.argtypes is None:
        p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, i64, i64, i32, i32, f32, i32, f32, i32, f32, p]
        fn.restype = ctypes.c_int
    return lib


def launch_geometry(S: torch.Tensor, axes: Any) -> Tuple[int, int, int]:
    """``(channels, elements per channel, parts per channel)`` of the kernel's grid for ``S``."""
    n = int(np.prod(S.shape[S.ndim - _trailing(S.ndim, axes):], dtype=np.int64))
    channels = S.numel() // n
    parts = max(1, min(_MAX_PARTS, -(-n // _PART_ELEMENTS)))
    return channels, n, parts


def db_scale(S: torch.Tensor, *, ref: Any = 1.0, amin: float = 1e-10,
             top_db: Optional[float] = 80.0, axes: Any = None,
             amplitude: bool = False) -> torch.Tensor:
    """``S`` in decibels, same shape, in two kernel launches on the card.

    ``axes`` is None (one peak for the whole array) or a tuple of trailing
    axes (one peak per channel in front of them). On a CUDA tensor this
    launches the kernel where :func:`kernel_refusal` gives no reason, and
    raises with that reason otherwise; a failed build or launch raises too.
    On a CPU tensor it returns :func:`db_scale_reference`. Nothing is copied
    to the host and nothing synchronises.
    """
    global launches
    if S.device.type == "cpu":
        return db_scale_reference(S, ref=ref, amin=amin, top_db=top_db, axes=axes,
                                  amplitude=amplitude)
    if S.device.type != "cuda":
        raise ParameterError(f"db_scale runs on cuda or cpu, not {S.device}")
    refusal = kernel_refusal(S, ref, axes)
    if refusal is not None:
        raise ParameterError(refusal)
    channels, n, parts = launch_geometry(S, axes)
    max_ref = is_max_ref(ref)
    out = torch.empty_like(S)
    partial = torch.empty(channels * parts, dtype=torch.float32, device=S.device)
    lib = _kernel_lib()
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream(S.device).cuda_stream
        err = lib.db_scale_launch(
            S.data_ptr(), out.data_ptr(), partial.data_ptr(), channels, n, parts,
            int(amplitude), float(amin) ** 2 if amplitude else float(amin), int(max_ref),
            0.0 if max_ref else abs(float(ref)), int(top_db is not None),
            0.0 if top_db is None else float(top_db), stream,
        )
    if err != 0:
        raise RuntimeError(f"db_scale kernel launch failed with CUDA error {err}")
    launches += 1
    return out
