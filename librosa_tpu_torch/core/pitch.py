"""Pitch tracking by spectral peaks and the tuning estimate built on it.

Everything runs on the spectrogram's device: the peak picking, the median
of the voiced magnitudes and the histogram of tuning deviations. An estimate
reads back the count of peaks and then the winning cell, nothing larger, and
``piptrack`` reads back nothing: a callable ``ref`` is applied where the
spectrogram lies.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from .._device import as_tensor, device_table
from ..ops.db_scale import is_max_ref
from ..util.exceptions import ParameterError
from ..util.utils import _device_reduction, expand_to, localmax
from .convert import fft_frequencies
from .spectrum import _spectrogram

__all__ = ["estimate_tuning", "pitch_tuning", "piptrack"]


def _parabolic_interpolation(x: torch.Tensor, *, axis: int = -2) -> torch.Tensor:
    """Per bin, the offset of the vertex of the parabola through the bin and its two neighbours.

    0 at the two ends of ``axis`` and wherever the vertex would lie a bin
    or more away.
    """
    xi = x.movedim(axis, -1)
    a = xi[..., 2:] + xi[..., :-2] - 2 * xi[..., 1:-1]
    b = (xi[..., 2:] - xi[..., :-2]) / 2
    shift = torch.where(b.abs() >= a.abs(), 0.0, -b / torch.where(a == 0, 1.0, a))
    zero = torch.zeros_like(xi[..., :1])
    return torch.cat([zero, shift, zero], dim=-1).movedim(-1, axis)


def piptrack(
    *,
    y: Any = None,
    sr: float = 22050,
    S: Any = None,
    n_fft: Optional[int] = 2048,
    hop_length: Optional[int] = None,
    fmin: float = 150.0,
    fmax: float = 4000.0,
    threshold: float = 0.1,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    ref: Optional[Union[float, Callable]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pitches and magnitudes ``(..., 1 + n_fft // 2, T)`` of the spectral peaks of each frame.

    A bin is a peak where it is a local maximum over frequency, lies in
    ``[fmin, fmax)`` and exceeds the reference level: ``threshold`` times
    ``ref`` of the frame where ``ref`` is a callable (default: the frame's
    maximum), else ``|ref|`` itself. A peak's frequency and magnitude are
    refined by a parabola through the bin and its neighbours; every other
    cell of both outputs is 0.

    ``S`` is a magnitude spectrogram; without it ``|STFT(y)|`` is computed
    (by the stft_mel kernel with the identity basis where it applies). A
    maximum as ``ref`` (``np.max``, ``torch.amax`` ...) runs on ``S``'s device.
    Any other callable is, for ``S`` on the CPU, a numpy reduction called
    with ``axis=-2``. For ``S`` on the card, ``np.mean``, ``np.sum``,
    ``np.std``, ``np.var``, ``np.prod`` and ``np.min`` run as the torch
    reduction of the same name, a torch reduction is called with ``dim=-2``
    (``torch.mean``), and any other numpy function (``np.median``) raises
    ``ParameterError`` rather than copy ``S`` to the host.
    """
    S, n_fft = _spectrogram(y=y, S=S, n_fft=n_fft, hop_length=hop_length,
                            win_length=win_length, window=window, center=center,
                            pad_mode=pad_mode)
    return _piptrack_core(S, ref, sr=float(sr), n_fft=int(n_fft), fmin=float(max(fmin, 0)),
                          fmax=float(min(fmax, float(sr) / 2)), threshold=float(threshold))


def _frame_reference(S: torch.Tensor, ref: Callable) -> torch.Tensor:
    """``ref`` of each frame of ``S``, ``(..., 1, T)``, computed where ``S`` lies.

    On the CPU ``ref`` is a numpy reduction and sees ``S``'s memory with
    ``axis=-2``. On the card see :func:`_device_frame_reference`.
    """
    if S.device.type == "cpu":
        host = np.expand_dims(ref(S.detach().numpy(), axis=-2), -2)
        return torch.as_tensor(host, dtype=S.dtype)
    return _device_frame_reference(S, ref)


def _device_frame_reference(S: torch.Tensor, ref: Callable) -> torch.Tensor:
    """``ref`` of each frame of ``S`` by torch on ``S``'s device: the branch the card takes.

    A numpy reduction that numpy hands to the array's own method
    (``np.mean``, ``np.sum``, ``np.std``, ...) runs as the torch reduction of
    the same name, as the JAX function runs it under ``jit``. Any other numpy
    function (``np.median``) would need the spectrogram on the host and
    raises ``ParameterError``, as the JAX function raises for it. Anything
    else is a torch reduction called with ``dim=-2`` (one that returns values
    and indices gives its values).
    """
    out = _device_reduction(ref, S, -2)
    if out is not None:
        return out.to(S.dtype)
    if (getattr(ref, "__module__", None) or "").split(".")[0] == "numpy":
        raise ParameterError(
            f"ref={getattr(ref, '__name__', ref)!r} is a numpy function that the card cannot "
            f"run on S ({S.device}): pass a maximum, a number, a numpy reduction such as "
            "np.mean, or a torch reduction that takes dim=")
    out = ref(S, dim=-2)
    if not isinstance(out, torch.Tensor):
        out = out.values
    return out.unsqueeze(-2).to(S.dtype)


def _piptrack_core(S: torch.Tensor, ref: Any, *, sr: float, n_fft: int, fmin: float,
                   fmax: float, threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    S = S.abs()
    if not S.dtype.is_floating_point:
        S = S.to(torch.float32)

    # torch.gradient takes central differences inside and one-sided ones at the ends
    avg = torch.gradient(S, dim=-2)[0]
    shift = _parabolic_interpolation(S, axis=-2)
    dskew = 0.5 * avg * shift

    freqs = fft_frequencies(sr=sr, n_fft=n_fft)
    in_band = device_table(("piptrack.band", sr, n_fft, fmin, fmax),
                           lambda: (fmin <= freqs) & (freqs < fmax), S.device, torch.bool)
    in_band = expand_to(in_band, ndim=S.ndim, axes=-2)

    if ref is None or is_max_ref(ref):
        level = threshold * S.amax(dim=-2, keepdim=True)
    elif callable(ref):
        level = threshold * _frame_reference(S, ref)
    else:
        level = torch.as_tensor(ref, dtype=S.dtype, device=S.device).abs()

    peaks = in_band & localmax(S * (S > level), axis=-2)
    bins = expand_to(torch.arange(S.shape[-2], dtype=S.dtype, device=S.device), ndim=S.ndim,
                     axes=-2)
    pitches = torch.where(peaks, (bins + shift) * (sr / n_fft), 0.0)
    mags = torch.where(peaks, S + dskew, 0.0)
    return pitches, mags


def pitch_tuning(frequencies: Any, *, resolution: float = 0.01,
                 bins_per_octave: int = 12) -> float:
    """The tuning deviation, in fractions of a bin in ``[-0.5, 0.5)``, that most of ``frequencies`` share.

    ``frequencies`` (Hz; a tensor, a numpy array or a list) are folded to
    their distance from the nearest of ``bins_per_octave`` equal-tempered
    bins per octave around A440, and the fullest cell of a histogram of
    width ``resolution`` wins. Values that are not positive are ignored;
    with none left this warns and returns 0.0.

    The folding and the histogram run on the tensor's device, over the
    array as it is (no compaction); the winning cell and the count of
    positive values come back to the host together.
    """
    freq = as_tensor(frequencies).reshape(-1)
    if not freq.dtype.is_floating_point:
        freq = freq.to(torch.float32)
    audible = freq > 0
    n_cells = int(np.ceil(1.0 / resolution))
    cells = np.linspace(-0.5, 0.5, n_cells + 1)

    # distance of each pitch from its nearest bin, wrapped to [-0.5, 0.5)
    octs = torch.log2(torch.where(audible, freq, 1.0) / (440.0 / 16))
    frac = torch.remainder(bins_per_octave * octs, 1.0)
    frac = torch.where(frac >= 0.5, frac - 1.0, frac)

    edges = torch.as_tensor(cells, dtype=torch.float64, device=freq.device)
    slots = (torch.searchsorted(edges, frac.to(torch.float64), right=True) - 1).clamp_(
        0, n_cells - 1)
    # values that are not positive vote in a cell of their own, which is dropped
    votes = torch.bincount(torch.where(audible, slots, n_cells), minlength=n_cells + 1)[:n_cells]
    winner, total = torch.stack([votes.argmax(), votes.sum()]).tolist()
    if total == 0:
        warnings.warn("no positive frequencies to estimate tuning from; returning 0 cents",
                      stacklevel=2)
        return 0.0
    return float(cells[winner])


def estimate_tuning(
    *,
    y: Any = None,
    sr: float = 22050,
    S: Any = None,
    n_fft: Optional[int] = 2048,
    resolution: float = 0.01,
    bins_per_octave: int = 12,
    **kwargs: Any,
) -> float:
    """The tuning deviation of a recording, in fractions of a bin in ``[-0.5, 0.5)``.

    :func:`piptrack` (which takes ``kwargs``) finds the spectral peaks; the
    pitches of those at or above the median peak magnitude go to
    :func:`pitch_tuning`. All tracks and channels of the input vote
    together: the result is one number.

    The peaks stay on the device: their pitches and magnitudes are gathered
    out of the two spectrogram-sized outputs (the one synchronisation
    before the vote), so that the median and the histogram run over the
    peaks alone. The median is that of numpy (the mean of the two middle
    values of an even count), taken from a sort.
    """
    pitch, mag = piptrack(n_fft=n_fft, S=S, sr=sr, y=y, **kwargs)
    voiced = pitch > 0
    pitch, mag = pitch[voiced], mag[voiced]
    count = mag.numel()
    if count:
        ranked = mag.sort().values
        median = (ranked[(count - 1) // 2] + ranked[count // 2]) / 2
        pitch = torch.where(mag >= median, pitch, 0.0)
    return pitch_tuning(pitch, resolution=resolution, bins_per_octave=bins_per_octave)
