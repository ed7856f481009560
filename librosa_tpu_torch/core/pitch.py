"""Pitch tracking by spectral peaks, the tuning estimate built on it, and YIN and pYIN.

Everything runs on the input's device: the peak picking, the median of the
voiced magnitudes and the histogram of tuning deviations. An estimate reads
back the count of peaks and then the winning cell, nothing larger, and
``piptrack`` reads back nothing: a callable ``ref`` is applied where the
spectrogram lies. ``yin`` and ``pyin`` frame the signal and compute the
cumulative mean normalised difference by FFT autocorrelation for every frame
at once; on the card ``pyin`` computes its trough priors with the trough
priors kernel (``csrc/trough_priors.cu``) and decodes its pitch and voicing
HMM with the Viterbi kernel (``csrc/viterbi.cu``).
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from .._device import as_tensor, device_table
from ..ops.db_scale import is_max_ref
from ..ops.trough_priors import trough_priors
from ..util import profiling
from ..util.exceptions import ParameterError
from ..util.utils import _device_reduction, expand_to, frame, localmax, localmin, pad_last, tiny
from .audio import autocorrelate
from .convert import fft_frequencies
from .spectrum import _spectrogram

__all__ = ["estimate_tuning", "pitch_tuning", "piptrack", "yin", "pyin"]


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


def _cumulative_mean_normalized_difference(y_frames: torch.Tensor, min_period: int,
                                           max_period: int) -> torch.Tensor:
    """YIN's difference function over lags ``min_period .. max_period``, each over its running mean.

    Frames are ``(..., frame_length, n_frames)``. The difference at lag k is
    ``2 (r(0) - r(k))`` less the energy of the first k samples, the first
    sample's energy left out (as in librosa).
    """
    autocorr = autocorrelate(y_frames, max_size=max_period + 1, axis=-2)
    edge_power = y_frames.square().cumsum(dim=-2)
    edge_power[..., 0, :] = 0.0
    difference = (2.0 * (autocorr[..., :1, :] - autocorr[..., 1:max_period + 1, :])
                  - edge_power[..., :max_period, :])
    lags = torch.arange(1, max_period + 1, dtype=difference.dtype, device=difference.device)
    running_mean = difference.cumsum(dim=-2) / lags.reshape(-1, 1)
    band = slice(min_period - 1, max_period)
    return difference[..., band, :] / (running_mean[..., band, :] + tiny(running_mean))


def _check_yin_params(*, sr: float, fmax: float, fmin: float, frame_length: int,
                      win_length: Optional[int] = None) -> None:
    if fmin is None or fmax is None:
        raise ParameterError('both "fmin" and "fmax" must be provided')
    if fmin <= 0:
        raise ParameterError(f"fmin={fmin} must be strictly positive")
    if fmax <= fmin:
        raise ParameterError(f"fmax={fmax} must be greater than fmin={fmin}")
    if fmax > sr / 2:
        raise ParameterError(f"fmax={fmax} cannot exceed Nyquist frequency {sr/2}")
    if frame_length < 1:
        raise ParameterError(f"frame_length={frame_length} must be a positive integer")
    if win_length is not None and win_length >= frame_length:
        raise ParameterError(f"win_length={win_length} must be less than frame_length={frame_length}")
    if sr / fmin >= frame_length:
        raise ParameterError(f"frame_length={frame_length} is too small for fmin={fmin} at sr={sr}")


def _yin_frames(y: Any, *, sr: float, fmin: float, fmax: float, frame_length: int,
                hop_length: int, center: bool, pad_mode: str):
    """Frames of ``y`` -> (difference function, parabolic shifts, troughs, min_period)."""
    y = as_tensor(y)
    if center:
        y = pad_last(y, frame_length // 2, frame_length // 2, mode=pad_mode)
    return _yin_of_frames(frame(y, frame_length=frame_length, hop_length=hop_length), sr=sr,
                          fmin=fmin, fmax=fmax, frame_length=frame_length)


def _yin_of_frames(y_frames: torch.Tensor, *, sr: float, fmin: float, fmax: float,
                   frame_length: int):
    """Frames ``(..., frame_length, T)`` -> (difference function, parabolic shifts, troughs,
    min_period)."""
    min_period = int(np.floor(sr / fmax))
    max_period = min(int(np.ceil(sr / fmin)), frame_length - 1)
    yin_frames = _cumulative_mean_normalized_difference(y_frames, min_period, max_period)
    shifts = _parabolic_interpolation(yin_frames)
    is_trough = localmin(yin_frames, axis=-2)
    is_trough[..., 0, :] = yin_frames[..., 0, :] < yin_frames[..., 1, :]
    return yin_frames, shifts, is_trough, min_period


def yin(y: Any, *, fmin: float, fmax: float, sr: float = 22050, frame_length: int = 2048,
        win_length: Optional[int] = None, hop_length: Optional[int] = None,
        trough_threshold: float = 0.1, center: bool = True,
        pad_mode: str = "constant") -> torch.Tensor:
    """Fundamental frequency ``(..., n_frames)`` by YIN (de Cheveigne and Kawahara 2002).

    Per frame, the first trough of the cumulative mean normalised difference
    below ``trough_threshold`` (else its global minimum), refined by a
    parabola. ``hop_length`` defaults to ``frame_length // 4``; ``center``
    pads ``frame_length // 2`` a side in ``pad_mode``.
    """
    _check_yin_params(sr=sr, fmax=fmax, fmin=fmin, frame_length=frame_length,
                      win_length=win_length)
    hop_length = frame_length // 4 if hop_length is None else hop_length
    yin_frames, shifts, is_trough, min_period = _yin_frames(
        y, sr=sr, fmin=fmin, fmax=fmax, frame_length=frame_length, hop_length=hop_length,
        center=center, pad_mode=pad_mode)
    below = is_trough & (yin_frames < trough_threshold)
    period = below.to(torch.uint8).argmax(dim=-2, keepdim=True)  # the first trough below
    period = torch.where(below.any(dim=-2, keepdim=True), period,
                         yin_frames.argmin(dim=-2, keepdim=True))
    return sr / (min_period + period + shifts.gather(-2, period))[..., 0, :]


@functools.lru_cache(maxsize=16)
def _pyin_tables(sr: float, fmin: float, fmax: float, hop_length: int, n_thresholds: int,
                 beta_parameters: Tuple[float, float], resolution: float,
                 max_transition_rate: float, switch_prob: float,
                 transition_min_prob: Optional[float]):
    """pYIN's host constants in float64: thresholds, beta masses, log transition, log initial."""
    import scipy.stats

    from ..sequence import transition_local, transition_loop

    thresholds = np.linspace(0, 1, n_thresholds + 1)
    beta_probs = np.diff(scipy.stats.beta.cdf(thresholds, beta_parameters[0],
                                              beta_parameters[1]))
    n_bins_per_semitone = int(np.ceil(1.0 / resolution))
    n_pitch_bins = int(np.floor(12 * n_bins_per_semitone * np.log2(fmax / fmin))) + 1
    max_semitones_per_frame = round(max_transition_rate * 12 * hop_length / sr)
    width = max_semitones_per_frame * n_bins_per_semitone + 1
    transition = np.kron(transition_loop(2, 1 - switch_prob),
                         transition_local(n_pitch_bins, width, window="triangle", wrap=False))
    eps = np.finfo(np.float64).tiny
    log_trans = np.log(transition + eps)
    # pruned only above 0, never refused: a state left with no transition decodes with every
    # score -inf, as the JAX package's pYIN does
    if transition_min_prob is not None and transition_min_prob > 0:
        log_trans = np.where(log_trans >= np.log(transition_min_prob + eps), log_trans, -np.inf)
    log_p_init = np.log(np.full(2 * n_pitch_bins, 1 / (2 * n_pitch_bins)) + eps)
    return thresholds, beta_probs, log_trans, log_p_init


def _pyin_trough_probs(yin_frames: torch.Tensor, is_trough: torch.Tensor, thresholds: np.ndarray,
                       beta_probs: np.ndarray, boltzmann_parameter: float,
                       no_trough_prob: float) -> torch.Tensor:
    """Prior mass of each period candidate ``(..., P, T)``.

    For each threshold, the troughs below it share its beta mass by a
    Boltzmann law over their order; where none is below, ``no_trough_prob``
    of that mass goes to the lowest trough. On the card one launch of the
    trough priors kernel (``ops/trough_priors.py``), on the CPU its plain
    loop over thresholds.
    """
    with profiling.annotate("pyin.priors"):
        return trough_priors(yin_frames, is_trough, thresholds, beta_probs, boltzmann_parameter,
                             no_trough_prob)


def pyin(y: Any, *, fmin: float, fmax: float, sr: float = 22050, frame_length: int = 2048,
         win_length: Optional[int] = None, hop_length: Optional[int] = None,
         n_thresholds: int = 100, beta_parameters: Tuple[float, float] = (2, 18),
         boltzmann_parameter: float = 2, resolution: float = 0.1,
         max_transition_rate: float = 35.92, switch_prob: float = 0.01,
         no_trough_prob: float = 0.01, fill_na: Optional[float] = np.nan, center: bool = True,
         pad_mode: str = "constant", transition_min_prob: Optional[float] = 1e-4,
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probabilistic YIN (Mauch and Dixon 2014): ``(f0, voiced_flag, voiced_prob)``, each ``(..., n_frames)``.

    Every trough of the difference function gets prior mass from
    ``n_thresholds`` thresholds weighted by a beta law; the masses land in
    pitch bins of ``resolution`` semitones, and an HMM over pitch bins times
    voicing (pitch moves of at most ``max_transition_rate`` octaves a
    second, voicing switches with ``switch_prob``, transitions below
    ``transition_min_prob`` pruned) is decoded by Viterbi. Unvoiced frames
    of ``f0`` hold ``fill_na`` (None: the decoded bin's frequency). Float64
    input runs in float64, everything else in float32.
    """
    with profiling.annotate("pyin"):
        _check_yin_params(sr=sr, fmax=fmax, fmin=fmin, frame_length=frame_length,
                          win_length=win_length)
        hop_length = frame_length // 4 if hop_length is None else hop_length
        y = as_tensor(y)
        dtype = torch.float64 if y.dtype == torch.float64 else torch.float32
        model = _PyinModel(sr=sr, fmin=fmin, fmax=fmax, hop_length=hop_length,
                           n_thresholds=n_thresholds, beta_parameters=beta_parameters,
                           resolution=resolution, max_transition_rate=max_transition_rate,
                           switch_prob=switch_prob, transition_min_prob=transition_min_prob,
                           boltzmann_parameter=boltzmann_parameter, no_trough_prob=no_trough_prob)
        y = y.to(dtype)
        if center:
            y = pad_last(y, frame_length // 2, frame_length // 2, mode=pad_mode)
        obs_full, voiced_prob = model.observe(frame(y, frame_length=frame_length,
                                                    hop_length=hop_length), frame_length)
        f0, voiced_flag = model.decode(obs_full, fill_na)
        return f0, voiced_flag, voiced_prob


class _PyinModel:
    """pYIN's settings and host tables, split into its frame-wise half (:meth:`observe`, any
    block of frames) and its sequential half (:meth:`decode`, all frames at once)."""

    def __init__(self, *, sr: float, fmin: float, fmax: float, hop_length: int,
                 n_thresholds: int, beta_parameters: Tuple[float, float], resolution: float,
                 max_transition_rate: float, switch_prob: float,
                 transition_min_prob: Optional[float], boltzmann_parameter: float,
                 no_trough_prob: float):
        self.key = (float(sr), float(fmin), float(fmax), int(hop_length), int(n_thresholds),
                    (float(beta_parameters[0]), float(beta_parameters[1])), float(resolution),
                    float(max_transition_rate), float(switch_prob),
                    None if transition_min_prob is None else float(transition_min_prob))
        self.thresholds, self.beta_probs, self.log_trans, self.log_p_init = _pyin_tables(
            *self.key)
        self.sr, self.fmin, self.fmax = sr, fmin, fmax
        self.n_bins_per_semitone = int(np.ceil(1.0 / resolution))
        self.n_pitch_bins = self.log_p_init.shape[0] // 2
        self.boltzmann_parameter = float(boltzmann_parameter)
        self.no_trough_prob = float(no_trough_prob)

    def observe(self, y_frames: torch.Tensor,
                frame_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Observations ``(..., 2 n_pitch_bins, T)`` and voicing ``(..., T)`` of frames
        ``(..., frame_length, T)``."""
        return _pyin_observe(
            y_frames, sr=self.sr, fmin=self.fmin, fmax=self.fmax, frame_length=frame_length,
            thresholds=self.thresholds, beta_probs=self.beta_probs,
            n_pitch_bins=self.n_pitch_bins, n_bins_per_semitone=self.n_bins_per_semitone,
            boltzmann_parameter=self.boltzmann_parameter, no_trough_prob=self.no_trough_prob)

    def decode(self, obs_full: torch.Tensor,
               fill_na: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(f0, voiced_flag)`` of every frame: the Viterbi path through the observations."""
        from ..sequence import _decode

        device, dtype = obs_full.device, obs_full.dtype
        lpi = device_table(("pyin_log_p_init", self.key), lambda: self.log_p_init, device,
                           dtype)
        states, _ = _decode(_pyin_log_prob(obs_full), self.log_trans, lpi,
                            ("pyin_log_trans", self.key))
        freqs = self.fmin * 2.0 ** (torch.arange(self.n_pitch_bins, dtype=dtype, device=device)
                                    / (12 * self.n_bins_per_semitone))
        states = states.long()
        f0 = freqs[states % self.n_pitch_bins]
        voiced_flag = states < self.n_pitch_bins
        if fill_na is not None:
            f0 = torch.where(voiced_flag, f0, float(fill_na))
        return f0, voiced_flag


def _pyin_observe(y_frames: torch.Tensor, *, sr: float, fmin: float, fmax: float,
                  frame_length: int, thresholds: np.ndarray, beta_probs: np.ndarray,
                  n_pitch_bins: int, n_bins_per_semitone: int, boltzmann_parameter: float,
                  no_trough_prob: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """pYIN's frame-wise half on frames ``(..., frame_length, T)``: observation probabilities
    ``(..., 2 n_pitch_bins, T)`` and voicing ``(..., T)``.

    Each period candidate's prior mass lands in the pitch bin of its refined
    frequency (candidates above ``fmax`` in a bin that is dropped); the
    unvoiced states share what the voiced ones leave. Each frame is
    computed on its own, so a block of frames gives the columns of the whole.
    """
    yin_frames, shifts, is_trough, min_period = _yin_of_frames(
        y_frames, sr=sr, fmin=fmin, fmax=fmax, frame_length=frame_length)
    yin_probs = _pyin_trough_probs(yin_frames, is_trough, thresholds, beta_probs,
                                   boltzmann_parameter, no_trough_prob)
    periods = torch.arange(min_period, min_period + yin_frames.shape[-2], dtype=y_frames.dtype,
                           device=y_frames.device)
    f0_cands = sr / (periods.reshape(-1, 1) + shifts)
    bins = torch.round(12 * n_bins_per_semitone * torch.log2(f0_cands / fmin))
    bins = bins.clamp(0, n_pitch_bins).to(torch.int64)
    observed = torch.zeros((*yin_probs.shape[:-2], n_pitch_bins + 1, yin_probs.shape[-1]),
                           dtype=y_frames.dtype, device=y_frames.device)
    observed = observed.scatter_add(-2, bins, yin_probs)[..., :n_pitch_bins, :]
    voiced_prob = observed.sum(dim=-2, keepdim=True).clamp(0, 1)
    unvoiced = ((1 - voiced_prob) / n_pitch_bins).expand_as(observed)
    return torch.cat([observed, unvoiced], dim=-2), voiced_prob[..., 0, :]


def _pyin_log_prob(obs_full: torch.Tensor) -> torch.Tensor:
    """``log(obs + tiny)`` with float64's tiny, which is 0 in float32: empty states get -inf there."""
    return torch.log(obs_full + float(np.finfo(np.float64).tiny))
