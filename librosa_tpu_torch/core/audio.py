"""Resampling and signal synthesis.

The resamplers run on the input's device: polyphase FIR resampling as one
matrix product in full float32 (``scipy.signal.resample_poly``'s filter and
alignment), Fourier resampling on ``torch.fft`` at any length, and gather
interpolators (linear, zero-order hold, windowed sinc). The ``soxr_*``
qualities run libsoxr on the host for CPU input and are replaced by a device
resampler, with a warning, for input on the card. ``tone``, ``chirp`` and
``clicks`` make their signals on the host in float64 numpy.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import as_tensor, device_table, exact_f32
from ..util.exceptions import ParameterError
from ..util.utils import fix_length
from .convert import frames_to_samples, time_to_samples

__all__ = ["resample", "tone", "chirp", "clicks"]


# ---------------------------------------------------------------------------
# Polyphase resampling
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _poly_filter(up: int, down: int, window_beta: float = 5.0) -> np.ndarray:
    """The Kaiser-windowed sinc lowpass of ``scipy.signal.resample_poly``, scaled by ``up``.

    ``firwin(20 * max(up, down) + 1, 1 / max(up, down), window=('kaiser', 5.0))``.
    """
    import scipy.signal

    max_rate = max(up, down)
    h = scipy.signal.firwin(2 * 10 * max_rate + 1, 1.0 / max_rate,
                            window=("kaiser", window_beta))
    return (h * up).astype(np.float64)


def _upfirdn_len(len_h: int, n_in: int, up: int, down: int) -> int:
    """Output length of upsampling by ``up``, filtering with ``len_h`` taps, keeping every ``down``-th."""
    return ((n_in - 1) * up + len_h - 1) // down + 1


def _upfirdn_matrix(h: np.ndarray, up: int, down: int) -> np.ndarray:
    """The polyphase filter ``h`` as a float32 matrix ``F`` ``(W, up)``.

    Output sample ``m = q * up + p`` of upsample-filter-decimate is
    ``sum_j x[q * down + c_p - j] * h[(p * down) % up + j * up]`` with
    ``c_p = (p * down) // up``. With ``L = ceil(len(h) / up)`` taps per
    phase, ``W = down + L - 1`` and ``xs[q, k] = x_padded[q * down + k]``
    (``L - 1`` zeros in front), all ``up`` outputs of block ``q`` are the row
    ``xs[q] @ F``.
    """
    len_h = len(h)
    L = -(-len_h // up)
    taps = np.zeros(L * up)
    taps[:len_h] = h
    W = down + L - 1
    F_mat = np.zeros((W, up), dtype=np.float32)
    j = np.arange(L)
    for p in range(up):
        F_mat[(L - 1) + (p * down) // up - j, p] = taps[(p * down) % up + j * up]
    return F_mat


def _upfirdn_matmul(x: torch.Tensor, F_mat: torch.Tensor, *, down: int, W: int, q_blocks: int,
                    lpad: int, rpad: int, lo: int, hi: int) -> torch.Tensor:
    """Pad, view ``xs[q, k] = x_padded[q * down + k]``, ``xs @ F`` in full float32, cut ``[lo, hi)``."""
    xs = F.pad(x, (lpad, rpad)).unfold(-1, W, down)[..., :q_blocks, :]
    with exact_f32():
        y = torch.matmul(xs, F_mat)
    return y.reshape(*x.shape[:-1], -1)[..., lo:hi]


def _upfirdn_conv(x: torch.Tensor, h: np.ndarray, key: tuple, *, up: int, down: int,
                  n_pre_remove: int, n_out: int) -> torch.Tensor:
    """Upsample by ``up``, filter with ``h``, keep every ``down``-th sample, as one matrix product.

    ``h`` is rounded to float32 before the matrix is made. ``key`` names
    the filter; the matrix is kept on the device under it.
    """
    F_mat = device_table(("upfirdn", up, down) + key,
                         lambda: _upfirdn_matrix(h.astype(np.float32), up, down),
                         x.device, x.dtype)
    W = F_mat.shape[0]
    L = W - down + 1
    q_blocks = -(-_upfirdn_len(len(h), x.shape[-1], up, down) // up)
    # L - 1 zeros in front for the taps that look back, zeros behind to fill the last block
    need = (q_blocks + (W - 1) // down + 1) * down
    return _upfirdn_matmul(x, F_mat, down=down, W=W, q_blocks=q_blocks, lpad=L - 1,
                           rpad=max(0, need - (L - 1) - x.shape[-1]), lo=n_pre_remove,
                           hi=n_pre_remove + n_out)


def resample_poly(x: Any, up: int, down: int, *, axis: int = -1,
                  dtype: Any = None) -> torch.Tensor:
    """Resample ``x`` along ``axis`` by the rational factor ``up / down``.

    ``scipy.signal.resample_poly`` with its default filter: the same
    Kaiser(5.0) lowpass, the same alignment, ``ceil(n * up / down)`` output
    samples. The whole transform is one matrix product against a polyphase
    filter matrix that is made on the host once per rate pair and kept on
    the device.
    """
    x = as_tensor(x)
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    x = x.movedim(axis, -1)
    n_in = x.shape[-1]
    g = int(np.gcd(up, down))
    up, down = up // g, down // g
    if up == down == 1:
        out = x
    else:
        h = _poly_filter(up, down)
        n_out = -(-n_in * up // down)
        half_len = (len(h) - 1) // 2
        n_pre_pad = down - half_len % down
        n_post_pad = 0
        n_pre_remove = (half_len + n_pre_pad) // down
        while _upfirdn_len(len(h) + n_pre_pad + n_post_pad, n_in, up, down) < n_out + n_pre_remove:
            n_post_pad += 1
        h_padded = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
        out = _upfirdn_conv(x, h_padded, (n_pre_pad, n_post_pad), up=up, down=down,
                            n_pre_remove=n_pre_remove, n_out=n_out)
    out = out.movedim(-1, axis)
    if dtype is not None:
        out = out.to(dtype)
    return out


# ---------------------------------------------------------------------------
# Fourier and interpolating resamplers
# ---------------------------------------------------------------------------


def _resample_fft(x: torch.Tensor, *, num: int) -> torch.Tensor:
    """Fourier resampling of the last axis to ``num`` samples (``scipy.signal.resample``).

    The spectrum is cut or zero-extended, with the bin at the shorter
    length's Nyquist frequency folded (down) or split (up). ``torch.fft``
    takes any length.
    """
    n = x.shape[-1]
    X = torch.fft.rfft(x, dim=-1)
    n_min = min(num, n)
    nyq = n_min // 2 + 1
    Y = X.new_zeros((*x.shape[:-1], num // 2 + 1))
    Y[..., :nyq] = X[..., :nyq]
    if n_min % 2 == 0:
        if num < n:
            Y[..., n_min // 2] *= 2.0
        elif num > n:
            Y[..., n // 2] *= 0.5
    return torch.fft.irfft(Y, n=num, dim=-1) * (float(num) / float(n))


def _interp_grid(n_samples: int, ratio: float,
                 device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The output positions ``n / ratio`` as (whole part, int64; fraction, float32) on ``device``.

    Divided on the host in float64, so that a position late in a long
    signal is as exact as an early one.
    """
    pos = np.arange(n_samples, dtype=np.float64) / ratio
    base = np.floor(pos)
    return (torch.as_tensor(base.astype(np.int64), device=device),
            torch.as_tensor((pos - base).astype(np.float32), device=device))


def _resample_interp(x: torch.Tensor, base: torch.Tensor, frac: torch.Tensor, *,
                     hold: bool) -> torch.Tensor:
    """Zero-order hold (``hold``) or linear interpolation of the last axis at ``base + frac``."""
    n_in = x.shape[-1]
    left = x.index_select(-1, base.clamp(0, n_in - 1))
    if hold:
        return left
    right = x.index_select(-1, (base + 1).clamp(0, n_in - 1))
    return left + frac.to(x.dtype) * (right - left)


# taps on each side of an output position in the windowed-sinc interpolators
_SINC_HALF_WIDTH = {"sinc_best": 64, "sinc_medium": 32, "sinc_fastest": 16}


def _resample_sinc(x: torch.Tensor, base: torch.Tensor, frac: torch.Tensor, cutoff: float, *,
                   half_width: int) -> torch.Tensor:
    """Band-limited interpolation of the last axis at ``base + frac``, any ratio.

    Each output sample weighs its ``2 * half_width`` nearest input samples
    by a Blackman-windowed sinc of cutoff ``cutoff`` (``min(1, ratio)``)
    evaluated at their exact distances: no filter table, no quantised phase.
    """
    n_in = x.shape[-1]
    offsets = torch.arange(-half_width + 1, half_width + 1, device=x.device)
    src = base[:, None] + offsets[None, :]
    t = frac[:, None] - offsets[None, :]
    u = t / half_width
    win = 0.42 + 0.5 * torch.cos(np.pi * u) + 0.08 * torch.cos(2 * np.pi * u)
    cutoff = float(np.float32(cutoff))  # the kernel is evaluated in float32 throughout
    kern = cutoff * torch.sinc(cutoff * t) * win
    valid = (src >= 0) & (src < n_in) & (u.abs() <= 1.0)
    kern = torch.where(valid, kern, 0.0).to(x.dtype)
    gathered = x[..., src.clamp(0, n_in - 1)]
    return (gathered * kern).sum(dim=-1)


# ---------------------------------------------------------------------------
# resample
# ---------------------------------------------------------------------------


def _device_res_type(y: torch.Tensor, res_type: str, orig_sr: float = 2,
                     target_sr: float = 1) -> str:
    """The resampler that runs for ``res_type`` on ``y``'s device.

    libsoxr runs on the host. A ``soxr_*`` quality asked of a tensor on the
    card would pull the signal to the host and push the result back, so it
    is replaced there by a resampler of the device: ``polyphase`` for
    integer rates, else ``kaiser_best``, with one warning per pair. This
    changes the filter, never the device. A CPU tensor keeps libsoxr.
    """
    if not str(res_type).startswith("soxr") or y.device.type == "cpu":
        return res_type
    sub = ("polyphase" if int(orig_sr) == orig_sr and int(target_sr) == target_sr
           else "kaiser_best")
    _warn_soxr_substitution(res_type, sub)
    return sub


@functools.lru_cache(maxsize=None)
def _warn_soxr_substitution(requested: str, substituted: str) -> None:
    warnings.warn(
        f"res_type={requested!r} runs on the host (libsoxr); the input is on an accelerator, "
        f"so the device {substituted!r} resampler is used instead (numerically different "
        "filter). Move the tensor to the CPU to force exact soxr semantics.",
        stacklevel=4,
    )


def _integer_ratio(orig_sr: float, target_sr: float) -> Tuple[int, int]:
    """``(up, down)`` in lowest terms for integer rates."""
    gcd = int(np.gcd(int(orig_sr), int(target_sr)))
    return int(target_sr) // gcd, int(orig_sr) // gcd


def resample(
    y: Any,
    *,
    orig_sr: float,
    target_sr: float,
    res_type: str = "soxr_hq",
    fix: bool = True,
    scale: bool = False,
    axis: int = -1,
    **kwargs: Any,
) -> torch.Tensor:
    """Resample ``y`` along ``axis`` from ``orig_sr`` to ``target_sr``.

    ``res_type`` is one of

    - ``'polyphase'``, ``'kaiser_best'``, ``'kaiser_fast'``: polyphase FIR
      resampling (:func:`resample_poly`), integer rates only;
    - ``'fft'``, ``'scipy'``: Fourier resampling;
    - ``'linear'``, ``'zero_order_hold'``: interpolation, not band-limited;
    - ``'sinc_best'``, ``'sinc_medium'``, ``'sinc_fastest'``: windowed-sinc
      interpolation at any ratio;
    - ``'soxr_vhq'``, ``'soxr_hq'``, ``'soxr_mq'``, ``'soxr_lq'``,
      ``'soxr_qq'``: libsoxr on the host, for input on the CPU. For input on
      the card a device resampler takes its place (``polyphase`` for integer
      rates, else ``kaiser_best``) with a one-time warning. Where libsoxr
      does not load, integer rates fall to ``polyphase`` with a warning and
      others raise.

    ``fix`` cuts or pads the output to ``ceil(n * target_sr / orig_sr)``
    samples (``kwargs`` go to :func:`util.fix_length`); ``scale`` divides by
    ``sqrt(target_sr / orig_sr)`` so that the energy stays about the same.
    The output has ``y``'s dtype and device.
    """
    if orig_sr <= 0 or target_sr <= 0:
        raise ParameterError(
            f"Invalid sample rates: orig_sr={orig_sr}, target_sr={target_sr} "
            "(must be strictly positive)"
        )
    y = as_tensor(y)
    if not y.dtype.is_floating_point:
        raise ParameterError("Audio data must be floating-point")
    if orig_sr == target_sr:
        return y

    res_type = _device_res_type(y, res_type, orig_sr, target_sr)
    ratio = float(target_sr) / orig_sr
    n_samples = int(np.ceil(y.shape[axis] * ratio))
    integer_rates = int(orig_sr) == orig_sr and int(target_sr) == target_sr

    if res_type in ("scipy", "fft"):
        y_hat = _resample_fft(y.movedim(axis, -1), num=n_samples).movedim(-1, axis)
    elif res_type in ("polyphase", "kaiser_best", "kaiser_fast"):
        if not integer_rates:
            raise ParameterError(
                "polyphase resampling is only supported for integer-valued sampling rates."
            )
        y_hat = resample_poly(y, *_integer_ratio(orig_sr, target_sr), axis=axis)
    elif res_type in ("linear", "zero_order_hold") or res_type in _SINC_HALF_WIDTH:
        base, frac = _interp_grid(n_samples, ratio, y.device)
        y_last = y.movedim(axis, -1)
        if res_type in _SINC_HALF_WIDTH:
            y_hat = _resample_sinc(y_last, base, frac, min(1.0, ratio),
                                   half_width=_SINC_HALF_WIDTH[res_type])
        else:
            y_hat = _resample_interp(y_last, base, frac, hold=res_type == "zero_order_hold")
        y_hat = y_hat.movedim(-1, axis)
    elif res_type.startswith("soxr"):
        from ..io import _soxr

        if _soxr.available():
            y_hat = torch.as_tensor(np.apply_along_axis(
                _soxr.resample, axis, y.detach().numpy(), in_rate=orig_sr, out_rate=target_sr,
                quality=res_type))
        else:
            if not integer_rates:
                raise ParameterError(
                    f"res_type={res_type} requires libsoxr for non-integer rates"
                )
            warnings.warn(f"libsoxr unavailable; substituting device polyphase for {res_type}",
                          stacklevel=2)
            y_hat = resample_poly(y, *_integer_ratio(orig_sr, target_sr), axis=axis)
    else:
        raise ParameterError(f"Unsupported resampling mode: {res_type}")

    if fix:
        y_hat = fix_length(y_hat, size=n_samples, axis=axis, **kwargs)
    if scale:
        y_hat = y_hat / np.sqrt(ratio)
    return y_hat.to(y.dtype)


# ---------------------------------------------------------------------------
# Signal synthesis (host, float64 numpy)
# ---------------------------------------------------------------------------


def clicks(
    *,
    times: Any = None,
    frames: Any = None,
    sr: float = 22050,
    hop_length: int = 512,
    click_freq: float = 1000.0,
    click_duration: float = 0.1,
    click: Optional[np.ndarray] = None,
    length: Optional[int] = None,
) -> np.ndarray:
    """A click track as a host array: one click at each of ``times`` (seconds) or ``frames``.

    The default click is ``click_duration`` seconds of a sinusoid at
    ``click_freq`` Hz under a 60 dB exponential decay; ``click`` gives
    another waveform (float). ``length`` fixes the output length and drops
    the clicks that start beyond it.
    """
    if times is not None:
        marks = time_to_samples(times, sr=sr)
    elif frames is not None:
        marks = frames_to_samples(frames, hop_length=hop_length)
    else:
        raise ParameterError("clicks() needs event locations: pass times= or frames=")

    if click is None:
        if click_duration <= 0:
            raise ParameterError(f"click_duration={click_duration} must be > 0 seconds")
        if click_freq <= 0:
            raise ParameterError(f"click_freq={click_freq} must be > 0 Hz")
        n = int(sr * click_duration)
        fade = np.exp2(np.linspace(0.0, -10.0, num=n))
        click = fade * np.sin((2 * np.pi * click_freq / sr) * np.arange(n))
    else:
        click = np.asarray(click)
        if not np.issubdtype(click.dtype, np.floating):
            raise ParameterError("a custom click waveform must be float")

    click_len = click.shape[-1]
    if length is None:
        length = int(np.max(marks)) + click_len
    elif length < 1:
        raise ParameterError(f"output length must be at least 1 sample; got {length}")
    else:
        marks = marks[marks < length]

    # a canvas one click longer than the output, so that every click is added whole
    canvas = np.zeros(click.shape[:-1] + (length + click_len,), dtype=np.float32)
    for at in np.atleast_1d(marks):
        canvas[..., at:at + click_len] += click
    return canvas[..., :length]


def tone(frequency: float, *, sr: float = 22050, length: Optional[int] = None,
         duration: Optional[float] = None, phi: Optional[float] = None) -> np.ndarray:
    """A sinusoid at ``frequency`` Hz as a host array of ``length`` samples or ``duration`` seconds.

    ``phi`` is the phase of the cosine at sample 0 (default ``-pi / 2``: the
    tone starts at 0 and rises).
    """
    if frequency is None:
        raise ParameterError("tone() needs a frequency in Hz")
    if length is None:
        if duration is None:
            raise ParameterError(
                "tone() needs a size: pass length= (samples) or duration= (seconds)"
            )
        length = duration * sr
    start_phase = -0.5 * np.pi if phi is None else phi
    return np.cos((2.0 * np.pi * frequency / sr) * np.arange(int(length)) + start_phase)


def chirp(*, fmin: float, fmax: float, sr: float = 22050, length: Optional[int] = None,
          duration: Optional[float] = None, linear: bool = False,
          phi: Optional[float] = None) -> np.ndarray:
    """A sweep from ``fmin`` to ``fmax`` Hz as a host array, exponential or ``linear`` in time.

    The phase is the integral of the frequency in closed form, plus ``phi``
    (default ``-pi / 2``).
    """
    if fmin is None or fmax is None:
        raise ParameterError("chirp() needs both endpoint frequencies (fmin and fmax)")
    if length is not None:
        duration = length / sr
    elif duration is None:
        raise ParameterError(
            "chirp() needs a size: pass length= (samples) or duration= (seconds)"
        )
    start_phase = -0.5 * np.pi if phi is None else phi
    t = np.arange(int(duration * sr)) / sr
    if linear:
        angle = 2 * np.pi * (fmin * t + 0.5 * ((fmax - fmin) / duration) * t * t)
    elif fmin == fmax:
        angle = 2 * np.pi * fmin * t
    else:
        growth = fmax / fmin
        angle = (2 * np.pi * fmin * duration / np.log(growth)) * (
            np.power(growth, t / duration) - 1.0)
    return np.cos(angle + start_phase)
