"""Further spectral transforms: the reassigned spectrogram, the fast Mellin transform and the
multirate semitone filterbank spectrogram (``iirt``).

Filters and grids are made on the host in float64; the transforms run on
the device of the signal: three complex STFTs (``torch.fft``) for the
reassignment, a spline resample and a real FFT for ``fmt``, a bank of
biquad cascades as refined doubling scans (:mod:`ops.iir`) and a frame
gather for ``iirt``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from .. import filters
from .._device import as_tensor
from ..ops import iir
from ..ops import spline
from ..util.exceptions import ParameterError
from ..util.utils import _device_reduction, _host, _torch_dtype, abs2, expand_to, pad_last
from . import convert
from .audio import resample
from .spectrum import _audio, stft

__all__ = ["reassigned_spectrogram", "fmt", "iirt"]

# iirt runs a group's bank over as many tracks at once as keep one state tensor of the scans,
# (tracks, bands, 2, samples), within this many bytes; the refinement holds a few dozen of them
IIRT_BLOCK_BYTES = 1 << 29


def iirt_block_tracks(n_bands: int, n_samples: int, element_size: int) -> int:
    """How many tracks of a rate group :func:`iirt` filters at once: the most whose scan state
    ``(tracks, n_bands, 2, n_samples)`` fits in :data:`IIRT_BLOCK_BYTES` (at least one)."""
    return max(1, IIRT_BLOCK_BYTES // (n_bands * 2 * n_samples * element_size))


def _win_center(window: Any, win_length: int, n_fft: int) -> np.ndarray:
    """The analysis window centre-padded to ``n_fft``, on the host."""
    win = np.asarray(filters.get_window(window, win_length, fftbins=True))
    lpad = (n_fft - len(win)) // 2
    return np.pad(win, (lpad, n_fft - len(win) - lpad))


def _cyclic_gradient(win: np.ndarray) -> np.ndarray:
    """``np.gradient`` of a 1-d window extended by one period at each end (host)."""
    go = min(len(win) - 1, 1)
    return np.gradient(np.pad(win, (go, go), mode="wrap"), axis=-1)[go:-go]


def _reassign_frequencies(y, sr, S, n_fft, hop_length, win_length, window, center, dtype,
                          pad_mode):
    """``(S_dh, S_h)``: the STFTs with the window's derivative and with the window itself."""
    win = _win_center(window, win_length or n_fft, n_fft)
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, dtype=dtype, pad_mode=pad_mode)
    S_h = stft(y, window=win, **kw) if S is None else as_tensor(S)
    return stft(y, window=_cyclic_gradient(win), **kw), S_h


def _reassign_times(y, sr, S, n_fft, hop_length, win_length, window, center, dtype, pad_mode):
    """``(S_th, S_h)``: the STFTs with the time-weighted window and with the window itself."""
    if win_length is None:
        win_length = n_fft
    win = _win_center(window, win_length, n_fft)
    if hop_length is None:
        hop_length = int(win_length // 4)
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=center, dtype=dtype, pad_mode=pad_mode)
    S_h = stft(y, window=win, **kw) if S is None else as_tensor(S)
    half_width = n_fft // 2
    if n_fft % 2:
        window_times = np.arange(-half_width, half_width + 1)
    else:
        window_times = np.arange(0.5 - half_width, half_width)
    return stft(y, window=win * window_times, **kw), S_h


def reassigned_spectrogram(
    y: Any,
    *,
    sr: float = 22050,
    S: Any = None,
    n_fft: int = 2048,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    reassign_frequencies: bool = True,
    reassign_times: bool = True,
    ref_power: Union[float, Callable] = 1e-6,
    fill_nan: bool = False,
    clip: bool = True,
    dtype: Any = None,
    pad_mode: str = "constant",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(freqs, times, mags)``: each STFT bin moved to its instantaneous frequency (Hz) and its
    group delay (s), and its magnitude.

    The corrections are ``-Im(S_dh / S)`` and ``Re(S_th / S)``, from the STFTs
    with the window's derivative and with the time-weighted window. Bins
    with power below ``ref_power`` (or ``ref_power(|S|**2)``) get NaN
    coordinates, which ``fill_nan`` replaces by the bin's own; ``clip``
    keeps them inside ``[0, sr / 2]`` and ``[0, len(y) / sr]``. An axis not
    reassigned keeps the bin's frequency or the frame's time.
    """
    if not callable(ref_power) and ref_power < 0:
        raise ParameterError(f"the masking reference must be a non-negative power or a "
                             f"callable; got {ref_power}")
    if not (reassign_frequencies or reassign_times):
        raise ParameterError("nothing to reassign: enable the frequency axis, the time axis, "
                             "or both")
    y = _audio(y)
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = int(win_length // 4)
    dtype = _torch_dtype(dtype)
    args = (y, sr, S, n_fft, hop_length, win_length, window, center, dtype, pad_mode)
    S_dh = S_th = None
    if reassign_frequencies:
        S_dh, S = _reassign_frequencies(*args)
        args = (y, sr, S) + args[3:]
    if reassign_times:
        S_th, S = _reassign_times(*args)
    S = as_tensor(S)
    bin_freqs = torch.as_tensor(convert.fft_frequencies(sr=sr, n_fft=n_fft),
                                dtype=_real_dtype(S), device=S.device)
    frame_times = torch.as_tensor(
        convert.frames_to_time(np.arange(S.shape[-1]), sr=sr, hop_length=hop_length,
                               n_fft=None if center else n_fft),
        dtype=_real_dtype(S), device=S.device)
    if callable(ref_power):
        power = abs2(S)
        ref = _device_reduction(ref_power, power, None)
        ref_p = float(ref) if ref is not None else float(ref_power(_host(power)))
    else:
        ref_p = float(ref_power)

    mags = S.abs()
    mags_low = (mags < ref_p**0.5) & ~torch.isnan(mags)
    nan = torch.full((), float("nan"), dtype=mags.dtype, device=mags.device)
    if S_dh is not None:
        base = expand_to(bin_freqs, ndim=S.ndim, axes=-2)
        freqs = base + (-(S_dh / S).imag) * (0.5 * sr / np.pi)
        if ref_p > 0:
            freqs = torch.where(mags_low, nan, freqs)
        if fill_nan:
            freqs = torch.where(torch.isnan(freqs), base, freqs)
        if clip:
            freqs = torch.clamp(freqs, 0, sr / 2.0)
    else:
        freqs = expand_to(bin_freqs, ndim=S.ndim, axes=-2).expand(S.shape)
    if S_th is not None:
        base = expand_to(frame_times, ndim=S.ndim, axes=-1)
        times = base + (S_th / S).real / sr
        if ref_p > 0:
            times = torch.where(mags_low, nan, times)
        if fill_nan:
            times = torch.where(torch.isnan(times), base, times)
        if clip:
            times = torch.clamp(times, 0, float(y.shape[-1] / float(sr)))
    else:
        times = expand_to(frame_times, ndim=S.ndim, axes=-1).expand(S.shape)
    return freqs, times, mags


def _real_dtype(S: torch.Tensor) -> torch.dtype:
    return S.real.dtype if S.is_complex() else S.dtype


def fmt(y: Any, *, t_min: float = 0.5, n_fmt: Optional[int] = None, kind: str = "cubic",
        beta: float = 0.5, over_sample: float = 1, axis: int = -1) -> torch.Tensor:
    """The fast Mellin transform of ``y`` along ``axis``: a complex spectrum whose magnitude does
    not change when ``y`` is stretched in time.

    ``y`` (on ``linspace(0, 1, n, endpoint=False)``) is resampled onto an
    exponential grid from ``t_min / n`` (``n_fmt`` points; by default as
    fine as the input's last step, times ``over_sample``), weighted by
    ``t**beta * sqrt(n) / n_fmt`` and transformed by a real FFT. ``'cubic'``
    (the not-a-knot spline) and ``'linear'`` resample on the device; other
    ``kind`` values go to scipy's ``interp1d`` on the host, as in the JAX package.
    """
    y = as_tensor(y)
    n = y.shape[axis]
    if n < 3:
        raise ParameterError(f"the Mellin transform needs at least 3 samples along axis {axis}; "
                             f"got {n}")
    if t_min <= 0:
        raise ParameterError(f"the exponential grid starts at t_min={t_min}, which must be "
                             "positive")
    if n_fmt is None:
        if over_sample < 1:
            raise ParameterError(f"over_sample={over_sample} would UNDERsample; use >= 1")
    elif n_fmt < 3:
        raise ParameterError(f"a {n_fmt}-point Mellin spectrum is degenerate; use n_fmt >= 3")
    if not bool(torch.isfinite(y).all()):
        raise ParameterError("y must be finite everywhere")
    targets = _fmt_targets(n, float(t_min), None if n_fmt is None else int(n_fmt),
                           float(over_sample))
    n_fmt = len(targets)
    moved = y.movedim(axis, -1)
    if not moved.dtype.is_floating_point:
        moved = moved.to(torch.float32)
    if kind == "cubic" and n >= 4:
        resampled = spline.uniform_cubic_resample(moved, targets, x0=0.0, dx=1.0 / n)
    elif kind == "linear":
        resampled = spline.uniform_linear_resample(moved, targets, x0=0.0, dx=1.0 / n)
    else:
        import scipy.interpolate

        fit = scipy.interpolate.interp1d(np.linspace(0, 1, num=n, endpoint=False),
                                         _host(moved), kind=kind, axis=-1)
        resampled = torch.as_tensor(fit(targets), dtype=moved.dtype, device=moved.device)
    weight = targets.astype(np.float64) ** beta * np.sqrt(n) / n_fmt
    weighted = resampled * torch.as_tensor(weight, dtype=resampled.dtype, device=resampled.device)
    return torch.fft.rfft(weighted, dim=-1).movedim(-1, axis)


def _fmt_default_points(n: int, t_min: float, over_sample: float) -> int:
    """fmt's default ``n_fmt`` for ``n`` samples: as fine as the input's last step."""
    log_step = np.log(n - 1) - np.log(n - 2)
    return int(np.ceil(over_sample * (np.log(n - 1) - np.log(t_min)) / log_step))


@functools.lru_cache(maxsize=16)
def _fmt_targets(n: int, t_min: float, n_fmt: Optional[int], over_sample: float) -> np.ndarray:
    """fmt's exponential grid (host float64, read-only) of ``n_fmt`` points (by default
    :func:`_fmt_default_points`) in ``[t_min / n, (n - 1) / n]``, cached per shape: on a long
    signal the grid and its duplicate check took most of a call."""
    if n_fmt is None:
        log_step = np.log(n - 1) - np.log(n - 2)
        n_fmt = _fmt_default_points(n, t_min, over_sample)
    else:
        log_step = (np.log(n_fmt - 1) - np.log(n_fmt - 2)) / over_sample
    pad = int(np.ceil(over_sample))
    targets = np.logspace((np.log(t_min) - np.log(n)) / log_step, 0, num=n_fmt + pad,
                          endpoint=False, base=np.exp(log_step))[:-pad]
    if targets[0] < t_min or targets[-1] > (n - 1.0) / n:
        targets = np.clip(targets, float(t_min) / n, (n - 1.0) / n)
    if np.unique(targets).size != targets.size:
        raise ParameterError("the exponential grid collapsed onto duplicate positions; "
                             "reduce over_sample or raise t_min")
    targets.setflags(write=False)
    return targets


def _frame_starts(n_rs: int, n_frames: int, hop: float, win: int) -> Tuple[np.ndarray, int]:
    """The rounded starts of a group's ``n_frames`` frames at its rate, and the length its
    filtered signal is zero-padded to so that every frame fits."""
    start = np.arange(0, n_rs - win, hop)
    pad_to = n_rs
    if len(start) < n_frames:
        pad_to = int(np.ceil(n_frames * hop)) + win
        start = np.arange(0, pad_to - win, hop)
    return np.round(start).astype(np.int64)[:n_frames], pad_to


def _frame_energies(filtered: torch.Tensor, starts: torch.Tensor, win: int, pad_to: int,
                    factor: float) -> torch.Tensor:
    """``factor`` times the sum of squares of each window ``[start, start + win)`` of ``filtered``
    ``(L, B, n)`` (zero-padded to ``pad_to``): ``(L, B, F)``, gathered in blocks of frames."""
    if pad_to > filtered.shape[-1]:
        filtered = torch.nn.functional.pad(filtered, (0, pad_to - filtered.shape[-1]))
    windows = filtered.unfold(-1, win, 1)  # a view: (L, B, n - win + 1, win)
    per_frame = filtered.shape[0] * filtered.shape[1] * win * filtered.element_size()
    step = max(1, IIRT_BLOCK_BYTES // per_frame)
    out = []
    for k in range(0, starts.shape[0], step):
        frames = windows.index_select(-2, starts[k:k + step])
        out.append(factor * (frames * frames).sum(dim=-1))
    return torch.cat(out, dim=-1)


def iirt(
    y: Any,
    *,
    sr: float = 22050,
    win_length: int = 2048,
    hop_length: Optional[int] = None,
    center: bool = True,
    tuning: float = 0.0,
    pad_mode: str = "constant",
    flayout: str = "sos",
    res_type: str = "soxr_hq",
    **kwargs: Any,
) -> torch.Tensor:
    """The semitone filterbank spectrogram ``(..., 85, T)``: short-time mean-square power of ``y``
    through 85 elliptic band-pass filters (MIDI 24-108), each applied forward and backward at
    its group's sample rate (882, 4410 or 22050 Hz, ``y`` resampled by ``res_type``).

    Each group's bank runs as one set of refined doubling scans over all its
    bands (:func:`ops.iir._bank_filtfilt_core`), in blocks of tracks of at
    most :data:`IIRT_BLOCK_BYTES` per ``(tracks, bands, 2, samples)`` state
    tensor (:func:`iirt_block_tracks`);
    the frames start at the rounded positions ``k * hop / factor`` of the
    group's rate. ``flayout`` ``'ba'`` and ``'sos'`` both filter by the
    second-order sections (the factored form of the same filters).
    ``kwargs`` go to :func:`filters.semitone_filterbank`.
    """
    if flayout not in ("ba", "sos"):
        raise ParameterError(f"Unsupported flayout={flayout}")
    y = as_tensor(y)
    if not y.dtype.is_floating_point:
        raise ParameterError("Audio data must be floating-point")
    if hop_length is None:
        hop_length = win_length // 4
    if center:
        y = pad_last(y, win_length // 2, win_length // 2, mode=pad_mode)
    bank, sample_rates = filters.semitone_filterbank(tuning=tuning, flayout="sos", **kwargs)
    n_frames = int(1 + (y.shape[-1] - win_length) // hop_length)
    batch = tuple(y.shape[:-1])
    outs, band_order = [], []
    for cur_sr in np.unique(sample_rates):
        sel = np.flatnonzero(sample_rates == cur_sr)
        band_order.extend(sel.tolist())
        group = np.stack([np.asarray(bank[i]) for i in sel])
        y_rs = resample(y, orig_sr=sr, target_sr=cur_sr, res_type=res_type)
        n_rs = y_rs.shape[-1]
        factor = sr / cur_sr
        win = round(win_length / factor)
        starts, pad_to = _frame_starts(n_rs, n_frames, hop_length / factor, win)
        padlen = iir._bank_padlen(group)
        if n_rs <= padlen:
            raise ParameterError(f"Input too short for the {cur_sr} Hz filter group: "
                                 f"{n_rs} resampled samples <= pad length {padlen}")
        M, v, b0, Mpows, M_lo, v_lo = iir._bank_tensors(group, n_rs + 2 * padlen, y_rs)
        zi_unit = torch.as_tensor(np.stack([iir.sosfilt_zi(s) for s in group]),
                                  dtype=y_rs.dtype, device=y_rs.device)
        starts_t = torch.as_tensor(starts, device=y_rs.device)
        flat = y_rs.reshape(-1, n_rs)
        step = iirt_block_tracks(len(sel), n_rs + 2 * padlen, flat.element_size())
        parts = []
        for k in range(0, flat.shape[0], step):
            filtered = iir._bank_filtfilt_core(flat[k:k + step], M, v, b0, Mpows, zi_unit, M_lo,
                                               v_lo, padlen=padlen)
            parts.append(_frame_energies(filtered, starts_t, win, pad_to, float(factor)))
            del filtered
        outs.append(torch.cat(parts, dim=0))
    inv = torch.as_tensor(np.argsort(np.asarray(band_order)), device=y.device)
    bands_power = torch.cat(outs, dim=1).index_select(1, inv)
    return bands_power.reshape(batch + tuple(bands_power.shape[1:]))
