"""Spectral engine of the port: window tables, the fused STFT-basis route, dB scaling.

Layout as in the JAX package: frequency on axis -2, time on axis -1, any
leading dims.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from .. import filters
from .._device import as_tensor, device_table
from ..ops.fused_stft import _fused, kernel_refusal, stft_mel_reference
from ..util.exceptions import ParameterError

__all__ = ["power_to_db"]

def _padded_window(window: Any, win_length: int, n_fft: int) -> np.ndarray:
    win = filters.get_window(window, win_length, fftbins=True)
    if len(win) > n_fft:
        raise ParameterError(f"win_length={len(win)} exceeds n_fft={n_fft}")
    lpad = (n_fft - len(win)) // 2
    return np.pad(win, (lpad, n_fft - len(win) - lpad), mode="constant")


def _win_device(window: Any, win_length: int, n_fft: int, device: torch.device,
                dtype: torch.dtype) -> torch.Tensor:
    """The analysis window, centre-padded from ``win_length`` to ``n_fft``, on ``device``.

    Windows given by name, tuple or scalar are cached on the device; one
    given as samples or as a callable is made and uploaded each call.
    """
    if isinstance(window, (str, tuple)) or np.isscalar(window):
        return device_table(("window", window, win_length, n_fft),
                            lambda: _padded_window(window, win_length, n_fft),
                            device, dtype)
    return torch.tensor(_padded_window(window, win_length, n_fft), dtype=dtype,
                        device=device)


def _stft_mel_core(y: torch.Tensor, window: torch.Tensor, basis: Any,
                   bands: Optional[torch.Tensor] = None, *, n_fft: int, hop_length: int,
                   center: bool, pad_mode: str, power: float) -> torch.Tensor:
    """``basis @ |STFT(y)|**power``: the CUDA kernel where it applies, else plain torch.

    A call that :func:`kernel_refusal` finds no reason to refuse (float32
    input, constant or reflect padding, a geometry the kernel takes) goes to
    the fused path, which launches the kernel on a CUDA tensor and raises
    if that fails. Everything else (float64 input, other pad modes, other
    geometries) takes the plain version by this predicate, never by
    catching an error. ``bands`` is the basis's band table where the caller
    keeps one (``None``: the fused path derives it).
    """
    kw = dict(n_fft=n_fft, hop_length=hop_length, power=power, center=center,
              pad_mode=pad_mode)
    if kernel_refusal(y.dtype, n_fft, hop_length, pad_mode) is None:
        return _fused(y, window, basis, bands, **kw)
    return stft_mel_reference(y, window, basis, **kw)


# ---------------------------------------------------------------------------
# dB scaling
# ---------------------------------------------------------------------------


def _db_axes(ndim: int, axes: Any) -> Any:
    """``axes='auto'``: per channel, the last two axes (the last one for 1-d)."""
    if axes == "auto":
        if ndim >= 2:
            return (-2, -1)
        if ndim == 1:
            return (-1,)
        return None
    return axes


def _amax(x: torch.Tensor, axes: Any) -> torch.Tensor:
    if axes is None:
        return x.amax()
    return x.amax(dim=tuple(np.atleast_1d(axes).tolist()), keepdim=True)


_MAX_REFS = (np.max, np.amax, torch.max, torch.amax)


def power_to_db(
    S: Any,
    *,
    ref: Union[float, Callable] = 1.0,
    amin: float = 1e-10,
    top_db: Optional[float] = 80.0,
    axes: Any = "auto",
) -> torch.Tensor:
    """``10 * log10(S / ref)`` with an ``amin`` floor and a ``top_db`` clamp below the peak.

    ``ref`` is a number, an array, or a callable applied to ``S`` over
    ``axes``. With ``np.max`` / ``torch.max`` (or the ``amax`` forms) the
    peak is exactly 0 dB: the log is taken once and the maximum is
    subtracted from that same tensor. ``axes='auto'`` reduces each channel's
    last two axes.
    """
    S = as_tensor(S)
    if amin <= 0:
        raise ParameterError("amin must be strictly positive")
    if top_db is not None and top_db < 0:
        raise ParameterError("top_db must be non-negative")
    if S.is_complex():
        warnings.warn(
            "power_to_db was called on complex input so phase information will be "
            "discarded. To suppress this warning, call power_to_db(np.abs(D)**2) "
            "instead.",
            stacklevel=2,
        )
        S = S.abs()
    elif not S.dtype.is_floating_point:
        S = S.to(torch.float32)
    axes = _db_axes(S.ndim, axes)

    log_spec = 10.0 * torch.log10(S.clamp(min=amin))
    if any(ref is r for r in _MAX_REFS):
        log_spec = log_spec - _amax(log_spec, axes)
    else:
        if callable(ref):
            try:
                ref_value = ref(S, axis=axes, keepdims=True)
            except TypeError as e:
                raise ParameterError(
                    "The provided reference function must support 'axis' and "
                    "'keepdims' arguments for proper multichannel processing."
                ) from e
        else:
            ref_value = ref
        ref_value = torch.as_tensor(ref_value, dtype=S.dtype, device=S.device).abs()
        log_spec = log_spec - 10.0 * torch.log10(ref_value.clamp(min=amin))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, _amax(log_spec, axes) - top_db)
    return log_spec
