"""Loading and streaming audio, channel mixing, resampling and signal synthesis.

``load`` and ``stream`` decode on the host (``io``); ``load`` then mixes
and resamples on the port's device and returns a numpy array, and
``stream`` yields numpy blocks. The signal functions (``autocorrelate``,
``lpc``, ``zero_crossings``, the mu-law pair, the channel mixers) are torch
ops on the input's device.

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
from typing import Any, Callable, Generator, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import io as audio_io
from .._device import as_tensor, device_table, exact_f32
from ..util.exceptions import ParameterError
from ..util.utils import _device_reduction, fix_length, is_positive_int, tiny
from .convert import frames_to_samples, time_to_samples

__all__ = ["load", "loadx", "stream", "to_mono", "to_stereo", "to_multi", "resample",
           "get_duration", "get_samplerate", "autocorrelate", "lpc", "zero_crossings",
           "clicks", "tone", "chirp", "mu_compress", "mu_expand"]


# ---------------------------------------------------------------------------
# Loading and streaming
# ---------------------------------------------------------------------------


def load(
    path: Any,
    *,
    sr: Optional[float] = 22050,
    mono: bool = True,
    offset: float = 0.0,
    duration: Optional[float] = None,
    dtype: Any = np.float32,
    res_type: str = "soxr_hq",
) -> Tuple[np.ndarray, Union[int, float]]:
    """Load an audio file as a floating-point time series ``(y, sr)``.

    The file is decoded on the host (:func:`io.read_audio`: ``offset`` and
    ``duration`` in seconds, a negative ``offset`` counts from the end); then
    :func:`to_mono` (with ``mono``) and :func:`resample` to ``sr`` (unless
    ``sr`` is None or the file's rate) run on the port's device, and ``y``
    comes back to the host as a numpy array ``(n,)`` or ``(channels, n)`` of
    ``dtype``. On the card a ``soxr_*`` ``res_type`` is replaced by
    ``polyphase`` (integer rates) or ``kaiser_best``, with a warning, as
    :func:`resample` does for any input there.
    """
    y, native_rate = audio_io.read_audio(path, offset=offset, duration=duration, dtype=dtype)
    out_rate = native_rate if sr is None else sr
    if mono or out_rate != native_rate:
        # one copy to the device, the stages there, one copy back
        yd = as_tensor(y)
        if mono:
            yd = to_mono(yd)
        if out_rate != native_rate:
            yd = resample(yd, orig_sr=native_rate, target_sr=out_rate, res_type=res_type)
        y = yd.cpu().numpy()
    return np.asarray(y, dtype=dtype), out_rate


def loadx(key: str, *, hq: Optional[bool] = None,
          **kwargs: Any) -> Tuple[np.ndarray, Union[int, float]]:
    """:func:`load` of the example recording ``key`` (``util.example``); ``kwargs`` go to ``load``."""
    from ..util.files import example

    return load(example(key, hq=bool(hq)), **kwargs)


_STREAM_RES_TYPES = ("soxr_vhq", "soxr_hq", "soxr_mq", "soxr_lq", "soxr_qq")


def stream(
    path: Any,
    *,
    block_length: int,
    frame_length: int,
    hop_length: int,
    sr: Optional[float] = None,
    mono: bool = True,
    offset: float = 0.0,
    duration: Optional[float] = None,
    fill_value: Optional[float] = None,
    res_type: str = "soxr_hq",
    dtype: Any = np.float32,
) -> Generator[np.ndarray, None, None]:
    """Read an audio file in overlapping blocks of ``block_length`` frames, as numpy arrays.

    Each block has ``(block_length - 1) * hop_length + frame_length``
    samples and starts ``block_length * hop_length`` samples after the one
    before, so an analysis with ``center=False`` on each block gives the
    frames of the whole file. The last blocks are shorter, or padded with
    ``fill_value``. ``path`` may be an open :class:`io.AudioReader`; it is
    left open. With ``sr`` other than the file's rate the blocks go through
    libsoxr's streaming resampler (``res_type`` a ``soxr_*`` quality), and
    one advance must be a whole number of samples at the file's rate.

    Memory is O(block): the decoder is only ever asked for one advance, and
    the blocks are cut from a ring buffer of ``yield + 2 * advance`` samples.
    """
    if not is_positive_int(block_length):
        raise ParameterError(f"block_length={block_length} must be a positive integer")
    if not is_positive_int(frame_length):
        raise ParameterError(f"frame_length={frame_length} must be a positive integer")
    if not is_positive_int(hop_length):
        raise ParameterError(f"hop_length={hop_length} must be a positive integer")
    if sr is not None and not (np.isfinite(sr) and sr > 0):
        raise ParameterError(f"sr={sr} must be a positive number")
    if res_type not in _STREAM_RES_TYPES:
        raise ParameterError(
            f"res_type={res_type} is not a valid soxr resampling mode for streaming"
        )

    yield_size = (block_length - 1) * hop_length + frame_length
    advance = block_length * hop_length

    caller_owns_reader = isinstance(path, audio_io.AudioReader)
    reader = path if caller_owns_reader else audio_io.AudioReader(path)
    try:
        sr_native = reader.sr
        needs_resampling = sr is not None and sr != sr_native
        if sr is None:
            sr = sr_native

        # one advance must be a whole number of samples at the file's rate
        exact_step = advance * sr_native / sr
        native_step = int(round(exact_step))
        if abs(exact_step - native_step) > 1e-5 + 1e-7 * abs(exact_step):
            raise ParameterError(
                f"A block advance of {advance} samples at sr={sr} is a "
                f"fractional number of samples at the native rate "
                f"{sr_native}; choose block/hop lengths that divide evenly"
            )

        n_channels = 1 if mono else reader.channels
        resampler = (audio_io._soxr.StreamResampler(sr_native, sr, channels=n_channels,
                                                    quality=res_type)
                     if needs_resampling else None)

        if offset >= 0:
            reader.seek(int(offset * sr_native))
        else:
            if reader.frames is None:
                raise ParameterError(
                    "negative offset requires a container that declares its length"
                )
            reader.seek(reader.frames + int(offset * sr_native))
        budget = int(duration * sr_native) if duration is not None else None

        # ring buffer of decoded (and resampled) samples, (n, channels)
        capacity = yield_size + 2 * advance
        ring = np.zeros((capacity, n_channels), dtype=dtype)
        w_idx = r_idx = 0

        def _emit(block2d):
            # a copy: later reads overwrite the ring under a block the caller still holds
            if mono or block2d.shape[1] == 1:
                return block2d[:, 0].copy()
            return block2d.T.copy()

        while budget is None or budget > 0:
            chunk = reader.read(native_step if budget is None else min(native_step, budget))
            if budget is not None:
                budget -= chunk.shape[0]
            if chunk.shape[0] == 0:
                break
            if mono and reader.channels > 1:
                chunk = chunk.mean(axis=1, keepdims=True)
            if resampler is not None:
                chunk = resampler.process(chunk)
            chunk = chunk.astype(dtype, copy=False)

            n_in = chunk.shape[0]
            if w_idx + n_in > capacity:
                held = w_idx - r_idx
                ring[:held] = ring[r_idx:w_idx]
                r_idx, w_idx = 0, held
            ring[w_idx:w_idx + n_in] = chunk
            w_idx += n_in

            while w_idx - r_idx >= yield_size:
                yield _emit(ring[r_idx:r_idx + yield_size])
                r_idx += advance

        # the resampler's tail, then what is left in the ring
        tail = [ring[r_idx:w_idx]]
        if resampler is not None:
            flushed = resampler.process(np.empty((0, n_channels), dtype=np.float32),
                                        last=True).astype(dtype, copy=False)
            if flushed.shape[0]:
                tail.append(flushed)
        remainder = np.concatenate(tail) if len(tail) > 1 else tail[0]

        pos = 0
        while pos < remainder.shape[0]:
            block = remainder[pos:pos + yield_size]
            if fill_value is not None and block.shape[0] < yield_size:
                block = np.pad(block, ((0, yield_size - block.shape[0]), (0, 0)),
                               constant_values=fill_value)
            yield _emit(block)
            pos += advance
    finally:
        if not caller_owns_reader:
            reader.close()


def get_samplerate(path: Any) -> int:
    """The sampling rate that an audio file's header declares (nothing is decoded)."""
    return audio_io.get_samplerate(path)


def get_duration(
    *,
    y: Optional[Any] = None,
    sr: float = 22050,
    S: Optional[Any] = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    center: bool = True,
    path: Optional[str] = None,
) -> float:
    """Duration in seconds of a file (``path``, from its header), a signal ``y`` or a spectrogram ``S``.

    They are consulted in that order. For ``S`` the framing is inverted:
    ``n_fft + hop_length * (frames - 1)`` samples, less the centring pad.
    """
    if path is not None:
        native_sr, _, n_frames = audio_io.get_info(path)
        return float(n_frames) / native_sr
    if y is not None:
        return np.shape(y)[-1] / float(sr)
    if S is None:
        raise ParameterError(
            "get_duration needs a signal (y), a spectrogram (S), or a path"
        )
    span = n_fft + hop_length * (np.shape(S)[-1] - 1)
    if center:
        span -= (n_fft // 2) * 2
    return span / float(sr)


# ---------------------------------------------------------------------------
# Channel mixing
# ---------------------------------------------------------------------------


def to_mono(*signals: Any, pad: bool = True, norm: bool = True, out: Any = None) -> torch.Tensor:
    """Mix one or more signals down to one channel.

    Each signal is averaged (``norm``) or summed over its leading axes; the
    signals are then padded to the longest (``pad``) or cut to the shortest
    and added, and the sum divided by their number (``norm``). ``out`` is
    accepted and unused.
    """
    if not signals:
        raise ParameterError("At least one signal must be provided to `to_mono`.")
    arrs = [as_tensor(y) for y in signals]
    lengths = [a.shape[-1] for a in arrs]
    size = max(lengths) if pad else min(lengths)
    total = None
    for a in arrs:
        if a.ndim > 1:
            lead = tuple(range(a.ndim - 1))
            a = a.mean(dim=lead) if norm else a.sum(dim=lead)
        a = fix_length(a, size=size, axis=-1)
        total = a if total is None else total + a
    if norm:
        total = total / len(arrs)
    return total


def to_stereo(*, left: Optional[Any] = None, right: Optional[Any] = None, downmix: bool = True,
              pad: bool = True, norm: bool = True, out: Any = None) -> torch.Tensor:
    """Put ``left`` and ``right`` into the two rows of a ``(2, n)`` signal.

    A missing side is silence. With ``downmix`` each side is mixed to mono
    first (``norm`` as in :func:`to_mono`); without it each side must be
    mono or already ``(2, n)``, and with both given the sum is halved
    (``norm``). ``pad`` pads the shorter side, else the longer is cut.
    """
    if left is None and right is None:
        raise ParameterError("to_stereo() needs at least one channel (left= or right=)")
    both_given = left is not None and right is not None
    left = None if left is None else as_tensor(left)
    right = None if right is None else as_tensor(right)
    sides = [torch.zeros_like(right) if left is None else left,
             torch.zeros_like(left) if right is None else right]
    lengths = [s.shape[-1] for s in sides]
    size = max(lengths) if pad else min(lengths)
    sides = [fix_length(s, size=size, axis=-1) for s in sides]

    if downmix:
        return torch.stack([to_mono(s, norm=norm) for s in sides])

    def _as_channel(x: torch.Tensor, slot: int) -> torch.Tensor:
        if x.ndim == 2 and x.shape[0] == 2:
            return x
        if x.ndim == 1:
            rows = [x, torch.zeros_like(x)]
            return torch.stack(rows if slot == 0 else rows[::-1])
        raise ParameterError(
            f"downmix=False accepts mono or (2, n) inputs; got shape {tuple(x.shape)}"
        )

    mixed = _as_channel(sides[0], 0) + _as_channel(sides[1], 1)
    if norm and both_given:
        mixed = mixed / 2
    return mixed


def to_multi(*signals: Any, downmix: bool = True, pad: bool = True, norm: bool = True,
             out: Any = None) -> torch.Tensor:
    """Stack signals as the channels of one ``(len(signals), n)`` signal.

    With ``downmix`` each signal is mixed to mono first; without it all must
    have one channel layout, and they are added (and divided by their number
    with ``norm``). ``pad`` pads to the longest, else all are cut to the
    shortest.
    """
    if not signals:
        raise ParameterError("At least one signal must be provided.")
    arrs = [as_tensor(y) for y in signals]
    lengths = [a.shape[-1] for a in arrs]
    size = max(lengths) if pad else min(lengths)

    if downmix:
        return torch.stack([fix_length(to_mono(a, norm=norm), size=size, axis=-1)
                            for a in arrs], dim=0)

    layout = arrs[0].shape[:-1]
    for a in arrs:
        if a.shape[:-1] != layout:
            raise ParameterError(
                f"Cannot combine signals with different channel layouts "
                f"{tuple(a.shape[:-1])} when downmix=False"
            )
    total = None
    for a in arrs:
        a = fix_length(a, size=size, axis=-1)
        total = a if total is None else total + a
    if norm:
        total = total / len(arrs)
    return total


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
    takes any length; under the ``'matmul'`` STFT backend
    (:func:`~librosa_tpu_torch.ops.fft.set_stft_backend`) lengths other than
    powers of two go through the complex FFTs of
    :mod:`~librosa_tpu_torch.ops.ctfft` (complex64, complex128 for float64
    input), the kept bins then their conjugate mirror, as in the JAX package.
    """
    from ..ops.ctfft import _is_pow2, fft_arbitrary, ifft_arbitrary
    from ..ops.fft import _resolved_backend

    n = x.shape[-1]
    two_stage = _resolved_backend() == "matmul" and not (_is_pow2(n) and _is_pow2(num))
    if two_stage:
        X = fft_arbitrary(x.to(torch.complex128 if x.dtype == torch.float64
                               else torch.complex64), n)
    else:
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
    if two_stage:
        mirror = (Y[..., 1:-1] if num % 2 == 0 else Y[..., 1:]).flip(-1).conj()
        y = ifft_arbitrary(torch.cat([Y, mirror], dim=-1), num).real
    else:
        y = torch.fft.irfft(Y, n=num, dim=-1)
    return y * (float(num) / float(n))


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


# ---------------------------------------------------------------------------
# Autocorrelation, linear prediction, zero crossings
# ---------------------------------------------------------------------------


def autocorrelate(y: Any, *, max_size: Optional[int] = None, axis: int = -1) -> torch.Tensor:
    """Autocorrelation of ``y`` along ``axis`` for the first ``max_size`` lags (default: all).

    ``irfft(|rfft(y)|**2)`` (``ifft`` / ``fft`` for complex input) over a
    length of at least ``2 n - 1`` (scipy's next fast length; the next power
    of two under the ``'matmul'`` STFT backend, as in the JAX package), so
    that the correlation is linear, not circular. Lag 0 is the energy.
    """
    import scipy.fft

    from ..ops.fft import _resolved_backend

    y = as_tensor(y)
    n = y.shape[axis]
    max_size = n if max_size is None else int(min(max_size, n))
    if _resolved_backend() == "matmul":
        n_pad = 1 << (2 * n - 2).bit_length()
    else:
        n_pad = scipy.fft.next_fast_len(2 * n - 1, real=True)
    if y.is_complex():
        spec = torch.fft.fft(y, n=n_pad, dim=axis)
        power = (spec.real.square() + spec.imag.square()).to(spec.dtype)
        autocorr = torch.fft.ifft(power, n=n_pad, dim=axis)
    else:
        spec = torch.fft.rfft(y, n=n_pad, dim=axis)
        autocorr = torch.fft.irfft(spec.real.square() + spec.imag.square(), n=n_pad, dim=axis)
    return autocorr.narrow(axis, 0, max_size)


def _lpc_burg(y: torch.Tensor, order: int) -> torch.Tensor:
    """Burg's method along axis 0 of ``y``, batched over the other axes.

    The forward and backward prediction errors lose one sample at each
    order, so each order works on a slice one shorter than the last.
    """
    eps = tiny(y)
    fwd = y[1:]    # forward error, one step ahead
    bwd = y[:-1]   # backward error
    den = (fwd.square() + bwd.square()).sum(dim=0)
    ar = y.new_zeros((order + 1,) + tuple(y.shape[1:]))
    ar[0] = 1.0
    for i in range(order):
        k = -2.0 * (bwd * fwd).sum(dim=0) / (den + eps)
        # Levinson-Durbin: a_j += k * a_{i + 1 - j} for j = 1 .. i + 1
        ar[1:i + 2] = ar[1:i + 2] + k * ar[:i + 1].flip(0)
        fwd, bwd = fwd + k * bwd, bwd + k * fwd
        den = (1.0 - k.square()) * den - bwd[-1].square() - fwd[0].square()
        fwd, bwd = fwd[1:], bwd[:-1]
    return ar


def lpc(y: Any, *, order: int, axis: int = -1) -> torch.Tensor:
    """Linear prediction coefficients of ``y`` along ``axis`` by Burg's method.

    Returns ``order + 1`` coefficients along ``axis``, the first 1, in
    ``y``'s dtype, for every signal of the other axes.
    """
    if not is_positive_int(order):
        raise ParameterError(f"order={order} must be an integer > 0")
    y = as_tensor(y)
    if not y.dtype.is_floating_point:
        raise ParameterError("Audio data must be floating-point")
    return _lpc_burg(y.movedim(axis, 0), order).movedim(0, axis)


def zero_crossings(
    y: Any,
    *,
    threshold: float = 1e-10,
    ref_magnitude: Optional[Union[float, Callable]] = None,
    pad: bool = True,
    zero_pos: bool = True,
    axis: int = -1,
) -> torch.Tensor:
    """Where the sign of ``y`` changes along ``axis``, as a bool tensor of ``y``'s shape.

    Values with ``|y| <= threshold`` count as zero (``threshold`` is scaled
    by ``ref_magnitude``, a number or a function of ``|y|`` such as
    ``np.max``). With ``zero_pos`` zero is positive (the sign bit decides),
    else zero is a sign of its own. ``pad`` marks the first sample as a
    crossing.
    """
    y = as_tensor(y)
    if threshold is None:
        threshold = 0.0
    if callable(ref_magnitude):
        mag = y.abs()
        ref = _device_reduction(ref_magnitude, mag, None)
        threshold = threshold * float(ref_magnitude(mag) if ref is None else ref)
    elif ref_magnitude is not None:
        threshold = threshold * ref_magnitude

    yi = y.movedim(axis, -1)
    if threshold > 0:
        yi = torch.where(yi.abs() <= threshold, yi.new_zeros(()), yi)
    sign = torch.signbit(yi) if zero_pos else torch.sign(yi)
    cross = sign[..., 1:] != sign[..., :-1]
    first = torch.full_like(cross[..., :1], bool(pad))
    return torch.cat([first, cross], dim=-1).movedim(-1, axis)


# ---------------------------------------------------------------------------
# mu-law companding
# ---------------------------------------------------------------------------


def mu_compress(x: Any, *, mu: float = 255, quantize: bool = True) -> torch.Tensor:
    """mu-law compression of ``x`` in [-1, 1]: ``sign(x) * log1p(mu |x|) / log1p(mu)``.

    With ``quantize`` the output is the integer code of each value's bin
    among ``mu + 1`` equal bins over [-1, 1], from ``-(mu + 1) // 2``.
    """
    if mu <= 0:
        raise ParameterError(
            f"mu-law compression parameter mu={mu} must be strictly positive."
        )
    x = as_tensor(x)
    if bool(((x < -1) | (x > 1)).any()):
        raise ParameterError("mu-law input x must be in the range [-1, +1].")
    x_comp = torch.sign(x) * torch.log1p(mu * x.abs()) / np.log1p(mu)
    if not quantize:
        return x_comp
    bins = torch.linspace(-1, 1, int(1 + mu), dtype=x_comp.dtype, device=x_comp.device)
    # bins[i - 1] < x <= bins[i], as numpy's digitize with right=True
    return torch.bucketize(x_comp, bins, right=False) - int(mu + 1) // 2


def mu_expand(x: Any, *, mu: float = 255, quantize: bool = True) -> torch.Tensor:
    """The inverse of :func:`mu_compress`; with ``quantize``, ``x`` holds its integer codes."""
    if mu <= 0:
        raise ParameterError(
            f"Inverse mu-law compression parameter mu={mu} must be strictly positive."
        )
    x = as_tensor(x)
    if quantize:
        x = x * 2.0 / (1 + mu)
    if bool(((x < -1) | (x > 1)).any()):
        raise ParameterError("Inverse mu-law input x must be in the range [-1, +1].")
    return torch.sign(x) / mu * (torch.pow(1 + mu, x.abs()) - 1)
