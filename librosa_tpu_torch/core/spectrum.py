"""Spectral engine of the port: STFT and its inverse, Griffin-Lim, the fused STFT-basis route,
dB scaling, per-channel energy normalisation.

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
from ..ops import ola_norm as _ola
from ..ops.fft import frames_rdft
from ..ops.framing import frame_signal
from ..ops.fused_stft import _fused, frames_power, kernel_refusal, stft_mel_reference
from ..util.exceptions import ParameterError
from ..util.utils import _host, _torch_dtype, dtype_c2r, dtype_r2c, pad_last, phasor, tiny
from .convert import frequency_weighting

__all__ = [
    "stft", "istft", "griffinlim", "magphase", "power_to_db", "db_to_power", "amplitude_to_db", "db_to_amplitude",
    "perceptual_weighting", "phase_vocoder", "pcen", "_spectrogram",
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
    if kernel_refusal(y.dtype, n_fft, hop_length, pad_mode,
                      y.shape[-1] if center else None) is None:
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


def _wss_device(window: Any, *, n_frames: int, win_length: int, n_fft: int, hop_length: int,
                start: int, out_len: int, device: torch.device,
                dtype: torch.dtype) -> torch.Tensor:
    """The window's sum-of-squares envelope from sample ``start``, ``out_len`` long, on ``device``.

    Cut or zero-padded at the end to ``out_len``. A window given by name,
    tuple or scalar has its envelope cached on the device per configuration;
    one given as samples or as a callable is summed and uploaded each call.
    """
    def make() -> np.ndarray:
        wss = filters.window_sumsquare(
            window=window, n_frames=n_frames, win_length=win_length, n_fft=n_fft,
            hop_length=hop_length, dtype=np.float64)[start:start + out_len]
        return np.pad(wss, (0, out_len - len(wss)))

    if isinstance(window, (str, tuple)) or np.isscalar(window):
        return device_table(("wss", window, n_frames, win_length, n_fft, hop_length, start,
                             out_len), make, device, dtype)
    return torch.tensor(make(), dtype=dtype, device=device)


def _istft_core(S: torch.Tensor, window: torch.Tensor, wss: torch.Tensor, *, n_fft: int,
                hop_length: int, n_frames: int, start: int) -> torch.Tensor:
    """``irfft`` of the first ``n_frames`` columns, then window, overlap-add, trim, normalise.

    The inverse transform is ``torch.fft.irfft``. What follows it is one
    function, ``ops/ola_norm.py``: contiguous float32 frames go to
    :func:`ola_norm`, which launches the CUDA kernel on a CUDA tensor and
    raises if that fails; everything else (float64) takes the plain
    version, by the kernel's predicate and never by catching an error.
    The output has ``wss``'s length.
    """
    frames = torch.fft.irfft(S[..., :n_frames].transpose(-2, -1), n=n_fft, dim=-1)
    if frames.dtype != window.dtype:
        frames = frames.to(window.dtype)
    if _ola.kernel_refusal(frames, window, wss, hop_length) is None:
        return _ola.ola_norm(frames, window, wss, hop_length=hop_length, start=start)
    return _ola.ola_norm_reference(frames, window, wss, hop_length=hop_length, start=start)


def _istft_geometry(shape: Tuple[int, ...], *, n_fft: Optional[int], win_length: Optional[int],
                    hop_length: Optional[int], center: bool,
                    length: Optional[int]) -> Tuple[int, int, int, int, int, int]:
    """``(n_fft, win_length, hop_length, n_frames, start, out_len)`` of an inverse STFT.

    Defaults resolved from the spectrogram's ``shape``; ``n_frames`` columns
    are transformed (those that reach into ``length`` samples, where given),
    and the output is ``out_len`` samples of the overlap-add from sample
    ``start`` on.
    """
    if n_fft is None:
        n_fft = 2 * (shape[-2] - 1)
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = int(win_length // 4)
    if hop_length <= 0:
        raise ParameterError(f"hop_length={hop_length} must be a positive integer")
    n_frames = shape[-1]
    if length:
        padded_length = length + 2 * (n_fft // 2) if center else length
        n_frames = min(n_frames, -(-padded_length // hop_length))
    out_len = n_fft + hop_length * (n_frames - 1)
    if length:
        out_len = int(length)
    elif center:
        out_len -= 2 * (n_fft // 2)
    return n_fft, win_length, hop_length, n_frames, n_fft // 2 if center else 0, out_len


def istft(
    stft_matrix: Any,
    *,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    n_fft: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    dtype: Any = None,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add: ``(..., 1 + n_fft // 2, T)`` complex -> ``(..., n)``.

    The least-squares signal of a (possibly modified) STFT: each column's
    inverse real FFT times the synthesis window, summed at ``hop_length``
    and divided by the window's sum-of-squares envelope wherever that is
    not degenerate. ``n_fft`` defaults to ``2 * (rows - 1)``, ``win_length``
    to ``n_fft`` and ``hop_length`` to ``win_length // 4``; ``window`` must
    be the analysis window. ``center`` removes the ``n_fft // 2`` samples of
    padding from both ends. ``length`` fixes the output length: frames that
    lie wholly beyond it are not transformed, and the signal is zero-padded
    where the frames end short. The output is float32 for complex64 input
    and float64 for complex128, or ``dtype`` (torch or numpy, real).

    After ``torch.fft.irfft``, float32 frames on the card run as one CUDA
    kernel (``csrc/ola_norm.cu``).
    """
    S = as_tensor(stft_matrix)
    n_fft, win_length, hop_length, n_frames, start, out_len = _istft_geometry(
        S.shape, n_fft=n_fft, win_length=win_length, hop_length=hop_length, center=center,
        length=length)
    dtype = dtype_c2r(S.dtype) if dtype is None else _torch_dtype(dtype)
    work = dtype if dtype in (torch.float32, torch.float64) else torch.float32
    window_dev = _win_device(window, win_length, n_fft, S.device, work)
    wss = _wss_device(window, n_frames=n_frames, win_length=win_length, n_fft=n_fft,
                      hop_length=hop_length, start=start, out_len=out_len, device=S.device,
                      dtype=work)
    y = _istft_core(S, window_dev, wss, n_fft=n_fft, hop_length=hop_length, n_frames=n_frames,
                    start=start)
    return y.to(dtype)


def _griffinlim_seed(rng: Any) -> int:
    """The integer seed that ``rng`` (None, an int, a numpy Generator or RandomState) stands for."""
    if rng is None:
        return 0
    if isinstance(rng, (int, np.integer)):
        return int(rng)
    if isinstance(rng, np.random.RandomState):
        return int(rng.randint(2**31))
    return int(np.random.default_rng(rng).integers(2**31))


def _griffinlim_init(shape: Tuple[int, ...], seed: int, init: Optional[str],
                     device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The first phases ``(..., T, bins)``: unit phasors at uniform random angles, or all ones.

    The angles come from a ``torch.Generator`` on ``device`` seeded with
    ``seed``: the same seed gives the same phases on the same kind of
    device, and not those that any other library draws from it.
    """
    if init == "random":
        gen = torch.Generator(device=device).manual_seed(seed)
        phase = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        phase.mul_(2 * np.pi)
        return torch.complex(torch.cos(phase), torch.sin(phase)).to(dtype)
    return torch.ones(shape, dtype=dtype, device=device)


def griffinlim(
    S: Any,
    *,
    n_iter: int = 32,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    n_fft: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    dtype: Any = None,
    length: Optional[int] = None,
    pad_mode: str = "constant",
    momentum: float = 0.99,
    init: Optional[str] = "random",
    rng: Any = None,
    random_state: Any = None,
) -> torch.Tensor:
    """A signal whose STFT magnitude approximates ``S`` ``(..., 1 + n_fft // 2, T)``, by Griffin-Lim.

    Starting from random phases (``init='random'``) or zero phase
    (``init=None``), ``n_iter`` rounds of :func:`istft` then :func:`stft`
    re-estimate the phases, each round's estimate pushed past the last by
    ``momentum`` (0: the classic algorithm; above 1 warns, below 0 raises).
    ``rng`` seeds the random phases: an int, a numpy ``Generator`` or
    ``RandomState`` (one integer is drawn from it), or None for seed 0;
    ``random_state`` is its deprecated name. The other arguments are
    :func:`stft`'s and :func:`istft`'s.

    Everything stays on ``S``'s device. The loop holds the magnitudes, the
    current estimate ``S * phases`` and the last two rebuilt spectra, all in
    the layout :func:`stft` writes (time-major memory under a ``(bins, T)``
    view), and updates the estimate in place (:func:`_phase_update`).
    """
    if random_state is not None:
        if rng is not None:
            raise ParameterError(
                f"Both random_state={random_state!r} and rng={rng!r} were "
                "provided. Please use only the rng parameter."
            )
        warnings.warn("random_state is deprecated; use rng instead", FutureWarning,
                      stacklevel=2)
        rng = random_state
    if momentum > 1:
        warnings.warn(
            f"Griffin-Lim with momentum={momentum} > 1 can be unstable. "
            "Proceed with caution!",
            stacklevel=2,
        )
    elif momentum < 0:
        raise ParameterError(f"griffinlim() called with momentum={momentum} < 0")
    if init not in ("random", None):
        raise ParameterError(f"init={init} must either None or 'random'")

    S = as_tensor(S)
    if S.dtype not in (torch.float32, torch.float64):
        S = S.to(torch.float32)
    if n_fft is None:
        n_fft = 2 * (S.shape[-2] - 1)
    seed = _griffinlim_seed(rng)
    inverse_kw = dict(hop_length=hop_length, win_length=win_length, n_fft=n_fft, window=window,
                      center=center, dtype=dtype, length=length)
    forward_kw = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length, window=window,
                      center=center, pad_mode=pad_mode)

    # stft's output is a (bins, T) view of time-major memory; keep every tensor of the
    # loop in that layout so that each elementwise pass runs over matching strides
    S = S.transpose(-2, -1).contiguous().transpose(-2, -1)
    time_major = (*S.shape[:-2], S.shape[-1], S.shape[-2])
    estimate = _griffinlim_init(time_major, seed, init, S.device,
                                dtype_r2c(S.dtype)).transpose(-2, -1)
    estimate.mul_(S)  # the phases are kept as the spectrum estimate S * phases
    rebuilt = None
    for _ in range(n_iter):
        tprev = rebuilt
        rebuilt = stft(istft(estimate, **inverse_kw), **forward_kw)
        if rebuilt.dtype != estimate.dtype:
            rebuilt = rebuilt.to(estimate.dtype)
        _phase_update(estimate, rebuilt, tprev, S, momentum / (1 + momentum))
    return istft(estimate, **inverse_kw)


def _phase_update(estimate: torch.Tensor, rebuilt: torch.Tensor, tprev: Optional[torch.Tensor],
                  S: torch.Tensor, weight: float) -> None:
    """One Griffin-Lim update, in place: ``estimate <- S * unit(rebuilt - weight * tprev)``.

    ``unit(z) = z / (|z| + tiny)``; ``tprev`` None stands for zeros. Four
    passes over the complex tensor and one real temporary, no complex one.
    """
    if tprev is None:
        estimate.copy_(rebuilt)
    else:
        torch.add(rebuilt, tprev, alpha=-weight, out=estimate)
    estimate.div_(estimate.abs().add_(tiny(estimate)))
    estimate.mul_(S)


def magphase(D: Any, *, power: float = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(|D|**power, D / |D|)``: magnitude and unit phasor, with ``D = |D| * phasor``.

    A zero bin gets the phasor 1.
    """
    D = as_tensor(D)
    mag = D.abs()
    zero = mag == 0
    phase = torch.where(zero, torch.ones_like(D), D / mag.masked_fill(zero, 1.0))
    return mag ** float(power), phase


_PV_DEPRECATED = object()


def phase_vocoder(
    D: Any,
    *,
    rate: Optional[float] = None,
    t_out: Any = None,
    kind: str = "linear",
    hop_length: Any = _PV_DEPRECATED,
    n_fft: Any = _PV_DEPRECATED,
) -> torch.Tensor:
    """The STFT ``D`` ``(..., d, n)`` stretched in time: ``rate > 1`` faster, ``rate < 1`` slower.

    Output frame ``k`` sits at the fractional input frame ``t_out[k]``
    (``0, rate, 2 rate, ...`` for ``rate``; ``t_out`` in ``[0, n)`` gives
    them directly). Its phase is the first frame's plus the sum of the
    phase advances ``angle(D[i0 + 1]) - angle(D[i0])`` of the frames before
    it, where an exact-zero bin's angle is 0 whatever the signs of its zeros
    (``torch.angle`` gives pi for a real part of -0.0, and whether an FFT
    returns -0.0 for a silent frame depends on its build); its magnitude is interpolated from ``|D|`` at ``t_out`` by ``kind``:
    ``'linear'`` (extrapolating the last segment past the last frame),
    ``'nearest'`` (a half rounds down) or any kind of scipy's ``interp1d``.
    The index tables are built on the host; the phases, their running sum
    (``torch.cumsum``), the gathers and the interpolation run on ``D``'s
    device, except that another ``kind`` interpolates the magnitudes with
    scipy on the host. ``hop_length`` and ``n_fft`` are deprecated and unused.
    """
    for name, val in (("hop_length", hop_length), ("n_fft", n_fft)):
        if val is not _PV_DEPRECATED:
            warnings.warn(f"The `{name}` parameter is deprecated and unused in the "
                          "current implementation.", FutureWarning, stacklevel=2)
    D = as_tensor(D)
    n_frames = D.shape[-1]
    if (rate is None) == (t_out is None):
        raise ParameterError("Must specify exactly one of `rate` or `t_out`")
    if rate is not None and rate <= 0:
        raise ParameterError(f"rate={rate} must be a positive number")
    if t_out is None:
        t_out = np.arange(0.0, n_frames, rate)
    t_out = np.asarray(_host(t_out), dtype=float)
    if np.any(t_out < 0) or np.any(t_out >= n_frames):
        raise ParameterError("t_out values must be in the range [0, D.shape[-1])")
    if np.any(np.diff(t_out) < 0):
        warnings.warn("t_out is not monotonic; phase estimation may be unstable", stacklevel=2)

    real = D.real.dtype if D.is_complex() else D.dtype
    rdt = torch.promote_types(real, torch.float32)
    i0 = np.floor(t_out).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_frames - 1)

    def device_index(idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int64)).to(D.device)

    ph = torch.angle(D).masked_fill_(D == 0, 0.0)
    diff = ph.index_select(-1, device_index(i1)) - ph.index_select(-1, device_index(i0))
    first = ph[..., int(i0[0]):int(i0[0]) + 1]
    phase = torch.cumsum(torch.cat([first, diff[..., :-1]], dim=-1), dim=-1)
    del ph, diff
    if kind == "linear":
        # the last segment's slope carries on past the last frame, as scipy's "extrapolate"
        i0e = np.clip(i0, 0, max(n_frames - 2, 0))
        frac = torch.from_numpy((t_out - i0e).astype(np.float64)).to(D.device, rdt)
        mag = D.abs()
        mag_out = (mag.index_select(-1, device_index(i0e)) * (1 - frac)
                   + mag.index_select(-1, device_index(np.minimum(i0e + 1, n_frames - 1))) * frac)
    elif kind == "nearest":
        # scipy's "nearest" rounds a half down, toward i0
        mag_out = D.abs().index_select(-1, device_index(np.where(t_out - i0 <= 0.5, i0, i1)))
    else:
        import scipy.interpolate

        interp = scipy.interpolate.interp1d(np.arange(n_frames), np.abs(_host(D)), kind=kind,
                                            axis=-1, fill_value="extrapolate",
                                            assume_sorted=True, copy=False)
        mag_out = torch.as_tensor(interp(t_out), dtype=rdt, device=D.device)
    return phasor(phase, mag=mag_out)


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
    if kernel_refusal(y.dtype, n_fft, hop_length, pad_mode,
                      y.shape[-1] if center else None) is None:
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


# ---------------------------------------------------------------------------
# per-channel energy normalisation
# ---------------------------------------------------------------------------


def pcen(
    S: Any,
    *,
    sr: float = 22050,
    hop_length: int = 512,
    gain: float = 0.98,
    bias: float = 2,
    power: float = 0.5,
    time_constant: float = 0.400,
    eps: float = 1e-6,
    b: Optional[float] = None,
    max_size: int = 1,
    ref: Any = None,
    axis: int = -1,
    max_axis: Optional[int] = None,
    zi: Any = None,
    return_zf: bool = False,
):
    """Per-channel energy normalisation: ``(S / (eps + M)**gain + bias)**power - bias**power``.

    ``M`` is ``S`` (or ``ref``; with ``max_size > 1`` the centred,
    edge-padded maximum of ``max_size`` bins along ``max_axis``) smoothed
    along ``axis`` by the one-pole filter ``M[n] = b S[n] + (1 - b) M[n-1]``,
    a doubling scan on the device (:func:`ops.iir.first_order_filter`).
    ``b`` defaults to the coefficient matched to ``time_constant`` seconds at
    ``sr / hop_length`` frames a second. ``zi`` is the filter's starting state
    (default: the steady state ``1 - b``); ``return_zf`` also returns the final
    state, shaped like ``S`` with one sample along ``axis``, for the next
    block. ``power=0`` compresses by ``log1p``. Complex ``S`` warns and is
    reduced to its magnitude.
    """
    from ..ops.iir import first_order_filter
    from ..util.utils import is_positive_int

    for name, value, lo, strict in (("power", power, 0, False), ("gain", gain, 0, False),
                                    ("bias", bias, 0, False), ("eps", eps, 0, True),
                                    ("time_constant", time_constant, 0, True)):
        if value < lo or (strict and value == lo):
            raise ParameterError(f"PCEN coefficient {name}={value} must be "
                                 f"{'>' if strict else '>='} {lo}")
    if not is_positive_int(max_size):
        raise ParameterError(f"the max-filter width must be a positive integer; "
                             f"got max_size={max_size}")
    if b is None:
        t_frames = time_constant * sr / float(hop_length)
        b = (np.sqrt(1 + 4 * t_frames**2) - 1) / (2 * t_frames**2)
    if not 0 <= b <= 1:
        raise ParameterError(f"the smoothing coefficient b={b} is outside [0, 1]")
    b = float(b)
    S = as_tensor(S)
    if S.is_complex():
        warnings.warn("pcen discards phase: the complex input is reduced to its magnitude. "
                      "Pass pcen(np.abs(D)) to silence this warning.", stacklevel=2)
        S = S.abs()
    if ref is None and max_size > 1:
        if S.ndim == 1:
            raise ParameterError("a 1-D envelope has no frequency axis to max-filter over")
        if max_axis is None:
            if S.ndim != 2:
                raise ParameterError(f"max-filtering a {S.ndim}-D stack is ambiguous: "
                                     "specify max_axis")
            max_axis = int(np.mod(1 - axis, 2))

    if ref is not None:
        ref_arr = as_tensor(ref).to(S.device)
    elif max_size == 1:
        ref_arr = S
    else:
        lpad = max_size // 2
        moved = pad_last(S.movedim(max_axis, -1), lpad, max_size - 1 - lpad, mode="edge")
        ref_arr = moved.unfold(-1, max_size, 1).amax(dim=-1).movedim(-1, max_axis)
    if zi is None:
        zi_val = torch.full((), 1.0 - b, dtype=ref_arr.dtype, device=ref_arr.device)
    else:
        zi_val = as_tensor(zi).to(device=ref_arr.device, dtype=ref_arr.dtype)
        zi_val = zi_val.movedim(axis, -1)[..., 0]
    smooth_in, _ = first_order_filter(ref_arr, b0=b, b1=0.0, a1=b - 1.0, zi=zi_val, axis=axis)
    smooth = torch.exp(-gain * (np.log(eps) + torch.log1p(smooth_in / eps)))
    if power == 0:
        out = torch.log1p(S * smooth)
    elif bias == 0:
        out = torch.exp(power * (torch.log(S) + torch.log(smooth)))
    else:
        out = (bias**power) * torch.expm1(power * torch.log1p(S * smooth / bias))
    if return_zf:
        last = smooth_in.movedim(axis, -1)[..., -1:]
        return out, ((1.0 - b) * last).movedim(-1, axis)
    return out
