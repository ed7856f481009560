"""Spectral engine of the port: STFT, the fused STFT-basis route, dB scaling.

Layout as in the JAX package: frequency on axis -2, time on axis -1, any
leading dims.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from .. import filters
from .._device import as_tensor, device_table
from ..ops import db_scale as _db
from ..ops.fft import frames_rdft
from ..ops.framing import frame_signal
from ..ops.fused_stft import _fused, frames_power, kernel_refusal, stft_mel_reference
from ..util.exceptions import ParameterError
from ..util.utils import pad_last
from .convert import frequency_weighting

__all__ = [
    "stft", "magphase", "power_to_db", "db_to_power", "amplitude_to_db", "db_to_amplitude",
    "perceptual_weighting", "_spectrogram",
]


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



def _audio(y: Any) -> torch.Tensor:
    """``y`` as a float32 or float64 tensor; integer audio raises."""
    y = as_tensor(y)
    if not y.dtype.is_floating_point:
        raise ParameterError("Audio data must be floating-point")
    if y.dtype not in (torch.float32, torch.float64):
        y = y.to(torch.float32)
    return y


def _stft_core(y: torch.Tensor, window: torch.Tensor, *, n_fft: int, hop_length: int,
               center: bool, pad_mode: str) -> torch.Tensor:
    """Framed, windowed ``rfft``: complex ``(..., 1 + n_fft // 2, n_frames)``."""
    if center:
        y = pad_last(y, n_fft // 2, n_fft // 2, mode=pad_mode)
    frames = frame_signal(y, frame_length=n_fft, hop_length=hop_length)
    return frames_rdft(frames * window).transpose(-2, -1)


def _stft_power_core(y: torch.Tensor, window: torch.Tensor, *, n_fft: int, hop_length: int,
                     center: bool, pad_mode: str, power: float) -> torch.Tensor:
    """``|STFT(y)|**power`` as ``(..., 1 + n_fft // 2, n_frames)``, in plain PyTorch."""
    return frames_power(y, window, n_fft=n_fft, hop_length=hop_length, power=power,
                        center=center, pad_mode=pad_mode).transpose(-2, -1)


def stft(
    y: Any,
    *,
    n_fft: int = 2048,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    dtype: Any = None,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Short-time Fourier transform: complex ``(..., 1 + n_fft // 2, n_frames)``.

    Frame ``t`` is centred on ``y[t * hop_length]`` where ``center`` (the
    signal is padded by ``n_fft // 2`` a side in ``pad_mode``: ``'constant'``,
    ``'reflect'``, ``'symmetric'``, ``'edge'`` or ``'wrap'``), else it
    starts there. ``hop_length`` defaults to ``win_length // 4`` and
    ``win_length`` to ``n_fft``; a shorter window is centre-padded. The
    output is complex64 for float32 input and complex128 for float64, or
    ``dtype`` (a torch complex dtype). The transform is ``torch.fft.rfft``.
    """
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = int(win_length // 4)
    if hop_length <= 0:
        raise ParameterError(f"hop_length={hop_length} must be a positive integer")
    y = _audio(y)
    if y.ndim == 0:
        raise ParameterError("Audio data must be at least one-dimensional")
    if n_fft > y.shape[-1]:
        if not center:
            raise ParameterError(
                f"n_fft={n_fft} is too large for uncentered analysis of input "
                f"signal of length={y.shape[-1]}"
            )
        warnings.warn(
            f"n_fft={n_fft} is too large for input signal of length={y.shape[-1]}",
            stacklevel=2,
        )
    window_dev = _win_device(window, win_length, n_fft, y.device, y.dtype)
    S = _stft_core(y, window_dev, n_fft=n_fft, hop_length=hop_length, center=center,
                   pad_mode=pad_mode)
    return S if dtype is None else S.to(dtype)


def magphase(D: Any, *, power: float = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(|D|**power, D / |D|)``: magnitude and unit phasor, with ``D = |D| * phasor``.

    A zero bin gets the phasor 1.
    """
    D = as_tensor(D)
    mag = D.abs()
    zero = mag == 0
    phase = torch.where(zero, torch.ones_like(D), D / mag.masked_fill(zero, 1.0))
    return mag ** float(power), phase


def _eye_device(n_fft: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The identity basis over ``1 + n_fft // 2`` bins and its band table (row k: ``[k, k+1)``)."""
    n_bins = 1 + n_fft // 2

    def bands() -> np.ndarray:
        return np.arange(n_bins)[:, None] + np.array([0, 1])

    return (device_table(("eye", n_fft), lambda: np.eye(n_bins, dtype=np.float32), device,
                         torch.float32),
            device_table(("eye.bands", n_fft), bands, device, torch.int32))


def _spectrogram(
    *,
    y: Any = None,
    S: Any = None,
    n_fft: Optional[int] = 2048,
    hop_length: Optional[int] = 512,
    power: float = 1,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    pad_mode: str = "constant",
) -> Tuple[torch.Tensor, int]:
    """``(S, n_fft)``: ``S`` as given, or ``|STFT(y)|**power`` computed from ``y``.

    A call that :func:`kernel_refusal` finds no reason to refuse runs the
    stft_mel kernel with the identity basis (no frame matrix and no complex
    spectrum in device memory); every other call runs the plain version.
    The choice is made by that predicate, never by catching an error.
    """
    if S is not None:
        S = as_tensor(S)
        if n_fft is None or n_fft // 2 + 1 != S.shape[-2]:
            n_fft = 2 * (S.shape[-2] - 1)
        return S, n_fft
    if n_fft is None:
        raise ParameterError(f"Unable to compute spectrogram with n_fft={n_fft}")
    if y is None:
        raise ParameterError("Input signal must be provided to compute a spectrogram")
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = int(win_length // 4)
    y = _audio(y)
    window_dev = _win_device(window, win_length, n_fft, y.device, y.dtype)
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, pad_mode=pad_mode,
              power=float(power))
    if kernel_refusal(y.dtype, n_fft, hop_length, pad_mode) is None:
        basis, bands = _eye_device(n_fft, y.device)
        return _fused(y, window_dev, basis, bands, **kw), n_fft
    return _stft_power_core(y, window_dev, **kw), n_fft


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


def _to_db(S: Any, name: str, *, ref: Any, amin: float, top_db: Optional[float], axes: Any,
           amplitude: bool) -> torch.Tensor:
    """Shared body of :func:`power_to_db` and :func:`amplitude_to_db`.

    Contiguous float32 input with a number or a maximum as ``ref``, reduced
    over trailing axes or the whole array, goes to the db_scale kernel
    (``ops/db_scale.py``), which launches on a CUDA tensor and raises if
    that fails. Everything else takes the plain version, by the kernel's
    predicate and never by catching an error.
    """
    S = as_tensor(S)
    if amin <= 0:
        raise ParameterError("amin must be strictly positive")
    if top_db is not None and top_db < 0:
        raise ParameterError("top_db must be non-negative")
    if S.is_complex():
        hint = "np.abs(D)**2" if not amplitude else "np.abs(S)"
        warnings.warn(
            f"{name} was called on complex input so phase information will be "
            f"discarded. To suppress this warning, call {name}({hint}) instead.",
            stacklevel=3,
        )
    axes = _db_axes(S.ndim, axes)
    kw = dict(ref=ref, amin=float(amin), top_db=top_db, axes=axes, amplitude=amplitude)
    if _db.kernel_refusal(S, ref, axes) is None:
        return _db.db_scale(S, **kw)
    return _db.db_scale_reference(S, **kw)


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
    peak is exactly 0 dB: the maximum is taken of the logarithms and
    subtracted from them. ``axes='auto'`` reduces each channel's last two
    axes. Float32 input on the card runs as one CUDA kernel
    (``csrc/db_scale.cu``).
    """
    return _to_db(S, "power_to_db", ref=ref, amin=amin, top_db=top_db, axes=axes,
                  amplitude=False)


def amplitude_to_db(
    S: Any,
    *,
    ref: Union[float, Callable] = 1.0,
    amin: float = 1e-5,
    top_db: Optional[float] = 80.0,
    axes: Any = "auto",
) -> torch.Tensor:
    """``20 * log10(|S| / ref)``: :func:`power_to_db` of ``|S|**2`` with ``ref**2`` and ``amin**2``."""
    return _to_db(S, "amplitude_to_db", ref=ref, amin=amin, top_db=top_db, axes=axes,
                  amplitude=True)


def db_to_power(S_db: Any, *, ref: float = 1.0) -> torch.Tensor:
    """``ref * 10**(S_db / 10)``: the inverse of :func:`power_to_db`."""
    return ref * torch.pow(10.0, 0.1 * as_tensor(S_db))


def db_to_amplitude(S_db: Any, *, ref: float = 1.0) -> torch.Tensor:
    """``ref * 10**(S_db / 20)``: the inverse of :func:`amplitude_to_db`."""
    return db_to_power(S_db, ref=ref**2) ** 0.5


def perceptual_weighting(S: Any, frequencies: Any, *, kind: str = "A",
                         **kwargs: Any) -> torch.Tensor:
    """A power spectrogram ``(..., f, t)`` in dB, each row offset by a weighting curve.

    ``frequencies`` ``(f,)`` are the rows' centre frequencies in Hz,
    ``kind`` the curve (:func:`frequency_weighting`); ``kwargs`` go to
    :func:`power_to_db`.
    """
    if isinstance(frequencies, torch.Tensor):
        frequencies = frequencies.detach().cpu().numpy()
    db = power_to_db(S, **kwargs)
    offset = frequency_weighting(frequencies, kind=kind).reshape((-1, 1))
    return torch.as_tensor(offset, dtype=db.dtype, device=db.device) + db
