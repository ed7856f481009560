"""Effects on waveforms: separation, time stretching, pitch shifting, silence, emphasis.

On the input's device:

- :func:`hpss`: :func:`stft`, then :func:`~librosa_tpu_torch.decompose.hpss`
  (two median_filter kernel launches on the card), then one :func:`istft`
  per part at the input's length (one ola_norm kernel launch each);
- :func:`time_stretch`: :func:`stft`, :func:`phase_vocoder`, :func:`istft`
  (one ola_norm launch); :func:`pitch_shift` adds :func:`resample`;
- :func:`trim` and :func:`split`: frame RMS, its decibels against the peak
  (the db_scale kernel on the card), the maximum over channels and the
  threshold; only the mask of loud frames goes to the host, which finds
  their runs;
- :func:`preemphasis` and :func:`deemphasis`: the first-order filter of
  ``ops/iir.py``, a doubling scan;
- :func:`remix`: the slices joined on the device. With ``align_zeros`` the
  boundaries move to the zero crossings of the channel mean, found on the
  host as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from . import decompose
from ._device import as_tensor
from .core.audio import resample
from .core.convert import frames_to_samples
from .core.spectrum import _audio, amplitude_to_db, istft, phase_vocoder, stft
from .feature.spectral import rms
from .ops.iir import first_order_filter
from .util.exceptions import ParameterError
from .util.utils import _host, fix_length, is_positive_int

__all__ = ["hpss", "harmonic", "percussive", "time_stretch", "pitch_shift", "remix", "trim",
           "split", "preemphasis", "deemphasis"]


def hpss(
    y: Any,
    *,
    kernel_size: Any = 31,
    power: float = 2.0,
    mask: bool = False,
    margin: Any = 1.0,
    n_fft: int = 2048,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    pad_mode: str = "constant",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Harmonic and percussive waveforms ``(y_harm, y_perc)`` of ``y`` ``(..., n)``, each ``(..., n)``.

    ``kernel_size``, ``power``, ``mask`` and ``margin`` go to
    :func:`~librosa_tpu_torch.decompose.hpss` and the rest to :func:`stft`
    and :func:`istft`; the outputs have ``y``'s dtype.
    """
    y = _audio(y)
    kw = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length, window=window,
              center=center)
    D = stft(y, pad_mode=pad_mode, **kw)
    harm, perc = decompose.hpss(D, kernel_size=kernel_size, power=power, mask=mask,
                                margin=margin)
    return (istft(harm, dtype=y.dtype, length=y.shape[-1], **kw),
            istft(perc, dtype=y.dtype, length=y.shape[-1], **kw))


def harmonic(y: Any, **kwargs: Any) -> torch.Tensor:
    """The harmonic waveform of ``y``: the first part of :func:`hpss`, which takes ``kwargs``."""
    return hpss(y, **kwargs)[0]


def percussive(y: Any, **kwargs: Any) -> torch.Tensor:
    """The percussive waveform of ``y``: the second part of :func:`hpss`, which takes ``kwargs``."""
    return hpss(y, **kwargs)[1]


def time_stretch(y: Any, *, rate: float, **kwargs: Any) -> torch.Tensor:
    """``y`` ``(..., n)`` played ``rate`` times as fast at the same pitch: ``(..., round(n / rate))``.

    :func:`stft`, :func:`phase_vocoder` at ``rate``, :func:`istft`;
    ``kwargs`` go to both transforms.
    """
    if rate <= 0:
        raise ParameterError("rate must be a positive number")
    y = _audio(y)
    len_stretch = round(y.shape[-1] / rate)
    stretched = phase_vocoder(stft(y, **kwargs), rate=rate)
    return istft(stretched, dtype=y.dtype, length=len_stretch, **kwargs)


def pitch_shift(y: Any, *, sr: float, n_steps: float, bins_per_octave: int = 12,
                res_type: str = "soxr_hq", scale: bool = False, **kwargs: Any) -> torch.Tensor:
    """``y`` ``(..., n)`` shifted by ``n_steps`` of ``bins_per_octave`` to the octave, at its length.

    Raising the pitch by ``k`` bins is playing ``2**(k / bins_per_octave)``
    times as fast: :func:`time_stretch` to the inverse rate (``kwargs`` go
    there), then :func:`resample` by ``res_type`` from ``sr / rate`` back to
    ``sr`` (``scale`` as there), cut or padded to ``n``. A ``soxr_*`` type on
    a tensor on the card is replaced as :func:`resample` replaces it.
    """
    if not is_positive_int(bins_per_octave):
        raise ParameterError(f"the octave must divide into a positive integer number of "
                             f"bins; got bins_per_octave={bins_per_octave}")
    y = _audio(y)
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)
    shifted = resample(time_stretch(y, rate=rate, **kwargs), orig_sr=float(sr) / rate,
                       target_sr=sr, res_type=res_type, scale=scale)
    return fix_length(shifted, size=y.shape[-1])


def remix(y: Any, intervals: Iterable[Tuple[int, int]], *,
          align_zeros: bool = True) -> torch.Tensor:
    """The intervals ``[start, end)`` of ``y`` ``(..., n)``, in the order given, joined.

    ``align_zeros`` moves each boundary to the nearest zero crossing of the
    mean over channels (the crossings are found on the host).
    """
    from .util.matching import match_events

    y = as_tensor(y)
    if align_zeros:
        y_np = _host(y)
        y_mono = y_np if y_np.ndim == 1 else np.mean(y_np, axis=tuple(range(y_np.ndim - 1)))
        # zero_crossings' defaults: |y| <= 1e-10 is zero, zero is positive, the first sample counts
        signs = np.signbit(np.where(np.abs(y_mono) <= 1e-10, 0.0, y_mono))
        crossings = np.concatenate([[True], signs[1:] != signs[:-1]])
        zeros = np.append(np.nonzero(crossings)[-1], [len(y_mono)])
    bounds = []
    for interval in intervals:
        if align_zeros:
            interval = zeros[match_events(np.asarray(interval), zeros)]
        bounds.append((int(interval[0]), int(interval[1])))
    return _remix_core(y, bounds)


def _remix_core(y: torch.Tensor, bounds: Iterable[Tuple[int, int]]) -> torch.Tensor:
    return torch.cat([y[..., start:end] for start, end in bounds], dim=-1)


def _signal_to_frame_nonsilent(y: torch.Tensor, frame_length: int = 2048, hop_length: int = 512,
                               top_db: float = 60, ref: Union[Callable, float] = np.max,
                               aggregate: Callable = np.max) -> np.ndarray:
    """Whether each frame of ``y`` is within ``top_db`` of ``ref`` (RMS in dB), as a host bool array.

    Channels combine by ``aggregate``: the maximum on ``y``'s device, any
    other one axis at a time on the host.
    """
    if aggregate in (np.max, np.amax):
        return _host(_nonsilent_core(y, ref, frame_length=int(frame_length),
                                     hop_length=int(hop_length), top_db=float(top_db)))
    mse = rms(y=y, frame_length=frame_length, hop_length=hop_length)
    level = _host(amplitude_to_db(mse[..., 0, :], ref=ref, top_db=None))
    while level.ndim > 1:  # one axis at a time, as an order-dependent aggregate needs
        level = np.asarray(aggregate(level, axis=0))
    return level > -top_db


def _nonsilent_core(y: torch.Tensor, ref: Union[Callable, float], *, frame_length: int,
                    hop_length: int, top_db: float) -> torch.Tensor:
    mse = rms(y=y, frame_length=frame_length, hop_length=hop_length)[..., 0, :]
    db = amplitude_to_db(mse, ref=ref, top_db=None)
    if db.ndim > 1:
        db = db.amax(dim=tuple(range(db.ndim - 1)))
    return db > -top_db


def trim(y: Any, *, top_db: float = 60, ref: Union[float, Callable] = np.max,
         frame_length: int = 2048, hop_length: int = 512,
         aggregate: Callable = np.max) -> Tuple[torch.Tensor, np.ndarray]:
    """``y`` without the frames before the first and after the last loud one, and ``[start, end]`` in samples.

    A frame is loud where its RMS is within ``top_db`` decibels of ``ref``
    (a number, or a function of the RMS such as ``np.max``); channels
    combine by ``aggregate``.
    """
    y = as_tensor(y)
    active = _signal_to_frame_nonsilent(y, frame_length=frame_length, hop_length=hop_length,
                                        ref=ref, top_db=top_db, aggregate=aggregate)
    lo = hi = 0
    if active.any():
        first = int(np.argmax(active))
        last = active.size - int(np.argmax(active[::-1]))
        lo = int(frames_to_samples(first, hop_length=hop_length))
        hi = min(y.shape[-1], int(frames_to_samples(last, hop_length=hop_length)))
    return y[..., lo:hi], np.asarray([lo, hi])


def split(y: Any, *, top_db: float = 60, ref: Union[float, Callable] = np.max,
          frame_length: int = 2048, hop_length: int = 512,
          aggregate: Callable = np.max) -> np.ndarray:
    """The runs of loud frames of ``y`` as ``[start, end)`` sample intervals ``(m, 2)``; arguments as :func:`trim`."""
    y = as_tensor(y)
    active = _signal_to_frame_nonsilent(y, frame_length=frame_length, hop_length=hop_length,
                                        ref=ref, top_db=top_db, aggregate=aggregate)
    edges = np.diff(np.concatenate(([False], np.asarray(active, bool), [False])).astype(np.int8))
    bounds = frames_to_samples(np.stack([np.flatnonzero(edges > 0), np.flatnonzero(edges < 0)],
                                        axis=1), hop_length=hop_length)
    return np.minimum(bounds, y.shape[-1])


def preemphasis(y: Any, *, coef: float = 0.97, zi: Optional[Any] = None,
                return_zf: bool = False):
    """``y[n] - coef * y[n - 1]`` along the last axis; with ``return_zf`` also the final state ``(..., 1)``.

    ``zi`` is the state before the first sample; by default ``2 y[0] -
    y[1]``, the signal extended by a straight line.
    """
    y = _audio(y)
    if zi is None:
        zi = 2 * y[..., 0:1] - y[..., 1:2]
    zi = torch.atleast_1d(torch.as_tensor(zi, device=y.device).to(y.dtype))
    y_out, zf = first_order_filter(y, b0=1.0, b1=-float(coef), a1=0.0, zi=zi)
    return (y_out, zf[..., None]) if return_zf else y_out


def deemphasis(y: Any, *, coef: float = 0.97, zi: Optional[Any] = None,
               return_zf: bool = False):
    """The inverse of :func:`preemphasis`, the filter ``1 / (1 - coef z^-1)``, by a doubling scan.

    Without ``zi`` the state is estimated as :func:`preemphasis` sets it,
    and its decaying response ``coef**n`` is taken off the output.
    """
    y = _audio(y)
    if zi is None:
        y_out, zf = first_order_filter(y, b0=1.0, b1=0.0, a1=-float(coef),
                                       zi=y.new_zeros(y.shape[:-1] + (1,)))
        start = ((2 - coef) * y[..., 0:1] - y[..., 1:2]) / (3 - coef)
        decay = torch.pow(coef, torch.arange(y.shape[-1], dtype=y.dtype, device=y.device))
        y_out = y_out - start * decay
    else:
        zi = torch.atleast_1d(torch.as_tensor(zi, device=y.device).to(y.dtype))
        y_out, zf = first_order_filter(y, b0=1.0, b1=0.0, a1=-float(coef), zi=zi)
    return (y_out, zf[..., None]) if return_zf else y_out
