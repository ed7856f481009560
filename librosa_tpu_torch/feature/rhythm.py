"""Rhythm features: tempograms of the onset envelope and tempo estimation.

The tempograms are torch ops on the envelope's device (hop-1 framing, a
windowed FFT autocorrelation or an STFT). ``tempo`` picks the lag of the
frame-averaged tempogram under a log-normal prior and returns numpy, as the
JAX package does; ``hybrid_tempogram`` regrids on the host with scipy.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from .._device import as_tensor
from ..core.audio import autocorrelate
from ..core.convert import fourier_tempo_frequencies, tempo_frequencies, time_to_frames
from ..core.spectrum import stft
from ..filters import get_window
from ..util import profiling
from ..util import utils as util
from ..util.exceptions import ParameterError

__all__ = ["tempogram", "fourier_tempogram", "tempo", "tempogram_ratio", "hybrid_tempogram",
           "metrogram"]


def _resolve_envelope(onset_envelope: Any, y: Any, sr: float, hop_length: int) -> torch.Tensor:
    """The given onset envelope as a tensor, or one computed from ``y``."""
    if onset_envelope is not None:
        return as_tensor(onset_envelope)
    if y is None:
        raise ParameterError("tempogram features need an input: pass y= or onset_envelope=")
    from ..onset import onset_strength

    return onset_strength(y=y, sr=sr, hop_length=hop_length)


def _tempogram_core(envelope: torch.Tensor, ac_window: torch.Tensor, *, win_length: int,
                    center: bool, norm: Optional[float]) -> torch.Tensor:
    n = envelope.shape[-1]
    if center:
        envelope = util.pad_last(envelope, win_length // 2, win_length // 2, mode="linear_ramp",
                                 end_values=0)
    frames = util.frame(envelope, frame_length=win_length, hop_length=1)
    if center:
        frames = frames[..., :n]
    windowed = frames * ac_window.to(frames.dtype).reshape(-1, 1)
    return util.normalize(autocorrelate(windowed, axis=-2), norm=norm, axis=-2)


def tempogram(*, y: Any = None, sr: float = 22050, onset_envelope: Optional[Any] = None,
              hop_length: int = 512, win_length: int = 384, center: bool = True,
              window: Any = "hann", norm: Optional[float] = np.inf) -> torch.Tensor:
    """Local autocorrelation tempogram ``(..., win_length, T)`` of the onset envelope.

    Each frame's ``win_length`` envelope values (centred, the ends ramped to
    zero) are windowed and autocorrelated; each column is scaled to unit
    ``norm``.
    """
    if win_length < 1:
        raise ParameterError(f"the tempogram window must span >= 1 frame; got {win_length}")
    envelope = _resolve_envelope(onset_envelope, y, sr, hop_length)
    ac_window = torch.as_tensor(get_window(window, win_length, fftbins=True),
                                dtype=envelope.dtype, device=envelope.device)
    return _tempogram_core(envelope, ac_window, win_length=win_length, center=center, norm=norm)


def fourier_tempogram(*, y: Any = None, sr: float = 22050, onset_envelope: Optional[Any] = None,
                      hop_length: int = 512, win_length: int = 384, center: bool = True,
                      window: Any = "hann") -> torch.Tensor:
    """Fourier tempogram: the complex hop-1 STFT of the onset envelope, ``(..., 1 + win_length // 2, T)``."""
    if win_length < 1:
        raise ParameterError(f"the tempogram window must span >= 1 frame; got {win_length}")
    envelope = _resolve_envelope(onset_envelope, y, sr, hop_length)
    return stft(envelope, n_fft=win_length, hop_length=1, center=center, window=window)


def tempo(*, y: Any = None, sr: float = 22050, onset_envelope: Optional[Any] = None,
          tg: Optional[Any] = None, hop_length: int = 512, start_bpm: float = 120,
          std_bpm: float = 1.0, ac_size: float = 8.0, max_tempo: Optional[float] = 320.0,
          aggregate: Optional[Callable] = np.mean, prior: Optional[Any] = None) -> np.ndarray:
    """Tempo in BPM (numpy): per channel, or per frame with ``aggregate=None``.

    The tempogram over ``ac_size`` seconds (or ``tg``) is aggregated over
    frames and its lag picked by ``argmax(log1p(1e6 tg) + log prior)``; the
    prior is log-normal around ``start_bpm`` with ``std_bpm`` octaves (or
    ``prior.logpdf``), and tempi from ``max_tempo`` up are excluded.
    """
    with profiling.annotate("tempo"):
        if start_bpm <= 0:
            raise ParameterError("start_bpm must be strictly positive")
        if tg is None:
            win_length = int(time_to_frames(ac_size, sr=sr, hop_length=hop_length))
        else:
            tg = as_tensor(tg)
            win_length = tg.shape[-2]
        bpms = tempo_frequencies(win_length, hop_length=hop_length, sr=sr)
        if prior is None:
            with np.errstate(divide="ignore"):
                logprior = -0.5 * ((np.log2(bpms) - np.log2(start_bpm)) / std_bpm) ** 2
        else:
            logprior = np.asarray(prior.logpdf(bpms))
        if max_tempo is not None:
            logprior[:int(np.argmax(bpms < max_tempo))] = -np.inf

        if tg is None:
            tg = tempogram(y=y, sr=sr, onset_envelope=onset_envelope, hop_length=hop_length,
                           win_length=win_length)
        if aggregate is np.mean:
            tg = tg.mean(dim=-1, keepdim=True)
        elif aggregate is not None:
            tg = as_tensor(aggregate(util._host(tg), axis=-1, keepdims=True)).to(tg.device)
        lp = torch.as_tensor(logprior, dtype=tg.dtype, device=tg.device).reshape(-1, 1)
        best_period = torch.argmax(torch.log1p(1e6 * tg) + lp, dim=-2)
        return np.take(bpms, util._host(best_period))


def tempogram_ratio(*, y: Any = None, sr: float = 22050, onset_envelope: Optional[Any] = None,
                    tg: Optional[Any] = None, bpm: Optional[Any] = None, hop_length: int = 512,
                    win_length: int = 384, start_bpm: float = 120, std_bpm: float = 1.0,
                    max_tempo: Optional[float] = 320.0, freqs: Optional[np.ndarray] = None,
                    factors: Optional[np.ndarray] = None, aggregate: Optional[Callable] = None,
                    prior: Optional[Any] = None, center: bool = True, window: Any = "hann",
                    kind: str = "linear", fill_value: float = 0,
                    norm: Optional[float] = np.inf) -> torch.Tensor:
    """The tempogram sampled at metrical ratios of the per-frame tempo: ``(..., len(factors), T)``.

    ``factors`` defaults to the 13 ratios of Prockup et al. (2015), from 4
    down to 1/4; ``bpm`` to :func:`tempo` per frame; ``aggregate`` folds
    the frames if given.
    """
    from ..core.harmonic import f0_harmonics

    if tg is None:
        tg = tempogram(y=y, sr=sr, onset_envelope=onset_envelope, hop_length=hop_length,
                       win_length=win_length, center=center, window=window, norm=norm)
    tg = as_tensor(tg)
    if freqs is None:
        freqs = tempo_frequencies(tg.shape[-2], hop_length=hop_length, sr=sr)
    if bpm is None:
        bpm = tempo(aggregate=None, hop_length=hop_length, max_tempo=max_tempo, prior=prior,
                    sr=sr, start_bpm=start_bpm, std_bpm=std_bpm, tg=tg)
    if factors is None:
        factors = np.array([4, 8 / 3, 3, 2, 4 / 3, 3 / 2, 1, 2 / 3, 3 / 4, 1 / 2, 1 / 3, 3 / 8,
                            1 / 4])
    ratio_track = f0_harmonics(tg, f0=bpm, fill_value=fill_value, freqs=freqs,
                               harmonics=factors, kind=kind)
    if aggregate is None:
        return ratio_track
    return as_tensor(aggregate(util._host(ratio_track), axis=-1)).to(tg.device)


def hybrid_tempogram(*, y: Any = None, sr: float = 22050, onset_envelope: Optional[Any] = None,
                     hop_length: int = 512, win_length: int = 384, center: bool = True,
                     window: Any = "hann", **kwargs: Any) -> torch.Tensor:
    """Geometric mean of the Fourier tempogram and the autocorrelation tempogram on its BPM grid.

    The autocorrelation tempogram is regridded by scipy's ``interp1d`` on
    the host (``kwargs`` go to it); the result is ``(..., 1 + win_length //
    2, T)`` on the envelope's device.
    """
    import scipy.interpolate

    envelope = _resolve_envelope(onset_envelope, y, sr, hop_length)
    shared = dict(sr=sr, hop_length=hop_length, win_length=win_length, center=center,
                  window=window)
    spectral = util._host(fourier_tempogram(onset_envelope=envelope, **shared))
    lagged = util._host(tempogram(onset_envelope=envelope, **shared))
    bpm_grid = fourier_tempo_frequencies(sr=sr, hop_length=hop_length, win_length=win_length)
    lag_bpm = tempo_frequencies(lagged.shape[-2], sr=sr, hop_length=hop_length)
    opts = dict(kwargs)
    for key, val in (("bounds_error", False), ("fill_value", 0.0), ("copy", False),
                     ("axis", -2)):
        opts.setdefault(key, val)
    lagged_on_bpm = scipy.interpolate.interp1d(lag_bpm[:0:-1], lagged[..., :0:-1, :],
                                               **opts)(bpm_grid)
    frames = min(spectral.shape[-1], lagged_on_bpm.shape[-1])
    agreement = np.abs(spectral[..., :frames]) * np.abs(lagged_on_bpm[..., :frames])
    return torch.as_tensor(np.sqrt(np.maximum(0, agreement)), device=envelope.device)


def metrogram(*, tg: Any, freqs: np.ndarray, factors: Optional[np.ndarray] = None,
              aggregate: Optional[Callable] = np.sum, kind: str = "linear",
              fill_value: float = 0) -> torch.Tensor:
    """Metrical salience ``(..., n_factors, T)``: the tempogram times itself at each factor.

    ``factors`` defaults to 1/3, 1/4, 1/5 and 1/7; ``aggregate`` (default
    the sum) folds the tempo axis, None keeps it.
    """
    from ..core.harmonic import interp_harmonics

    tg = as_tensor(tg)
    if factors is None:
        factors = np.array([1 / 3, 1 / 4, 1 / 5, 1 / 7])
    rescaled = interp_harmonics(tg, axis=-2, fill_value=fill_value, freqs=freqs,
                                harmonics=factors, kind=kind)
    coincidence = rescaled * tg.unsqueeze(-3)
    if aggregate is None:
        return coincidence
    if aggregate is np.sum:
        return coincidence.sum(dim=-2)
    return as_tensor(aggregate(util._host(coincidence), axis=-2)).to(tg.device)
