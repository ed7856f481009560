"""Array helpers used by the feature code (torch tensors, numpy scalars)."""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .._device import as_tensor
from ..ops import peaks as _peaks
from ..ops.framing import frame_signal
from . import profiling
from .exceptions import ParameterError

__all__ = ["tiny", "expand_to", "normalize", "pad_center", "fix_length", "localmax", "localmin",
           "dtype_r2c", "dtype_c2r", "abs2", "phasor", "softmask", "sparsify_rows", "frame",
           "is_positive_int", "valid_int", "fix_frames", "index_to_slice", "sync", "peak_pick",
           "shear", "fill_off_diagonal", "axis_sort", "MAX_MEM_BLOCK", "valid_audio",
           "valid_intervals", "cyclic_gradient", "stack", "count_unique", "is_unique",
           "buf_to_float", "interp_broadcast"]

# the upstream block size in bytes, kept for the API; nothing in the port blocks by it
MAX_MEM_BLOCK = 2**8 * 2**10

# numpy's names for padding modes, as torch.nn.functional.pad knows them
_TORCH_PAD_MODES = {"constant": "constant", "reflect": "reflect", "edge": "replicate",
                    "wrap": "circular"}
_STAT_PAD_MODES = ("maximum", "minimum", "mean", "median")
_PAD_MODES = tuple(_TORCH_PAD_MODES) + ("symmetric", "linear_ramp", "empty") + _STAT_PAD_MODES


# numpy reductions that hand an array that is not an ndarray to its own method (as numpy
# does for a JAX array), by the name of the torch reduction that computes the same
_NUMPY_REDUCTIONS = {np.mean: "mean", np.sum: "sum", np.max: "amax", np.amax: "amax",
                     np.min: "amin", np.amin: "amin", np.std: "std", np.var: "var",
                     np.prod: "prod"}


def _device_reduction(ref: Any, x: torch.Tensor, axis: Any) -> Optional[torch.Tensor]:
    """``ref(x, axis=axis, keepdims=True)`` by torch on ``x``'s device, or None.

    ``ref`` is one of the numpy reductions that numpy hands to an array's
    own ``.mean``, ``.sum``, ... method (``np.mean``, ``np.sum``,
    ``np.max``/``np.amax``, ``np.min``/``np.amin``, ``np.std``, ``np.var``,
    ``np.prod``); for any other ``ref`` the result is None. ``axis`` is an
    int, a tuple of ints or None (every axis); ``np.std`` and ``np.var``
    keep numpy's ``ddof=0``. Nothing is copied to the host.
    """
    name = next((n for f, n in _NUMPY_REDUCTIONS.items() if ref is f), None)
    if name is None:
        return None
    dims = tuple(range(x.ndim)) if axis is None else tuple(np.atleast_1d(axis).tolist())
    if name in ("std", "var"):
        return getattr(x, name)(dim=dims, keepdim=True, correction=0)
    if name == "prod":  # one axis at a time
        for d in dims:
            x = x.prod(dim=d, keepdim=True)
        return x
    return getattr(x, name)(dim=dims, keepdim=True)


def frame(x: Any, *, frame_length: int, hop_length: int, axis: int = -1,
          writeable: bool = False, subok: bool = False) -> torch.Tensor:
    """Overlapping frames of ``x`` along ``axis``, as a view.

    For ``axis=-1``, ``frame(x)[..., j, t]`` is ``x[..., t * hop_length + j]``
    and the shape is ``(..., frame_length, n_frames)``. For another negative
    axis the pair ``(frame_length, n_frames)`` takes the axis's place; for a
    non-negative one the pair is ``(n_frames, frame_length)``. ``writeable``
    and ``subok`` are accepted and unused.
    """
    x = as_tensor(x)
    if x.shape[axis] < frame_length:
        raise ParameterError(
            f"Input is too short (n={x.shape[axis]:d}) for frame_length={frame_length:d}"
        )
    if hop_length < 1:
        raise ParameterError(f"Invalid hop_length: {hop_length:d}")
    frames = frame_signal(x.movedim(axis, -1), frame_length=frame_length,
                          hop_length=hop_length)  # (..., n_frames, frame_length)
    if axis < 0:
        return frames.movedim((-1, -2), (axis - 1, axis))
    return frames.movedim((-2, -1), (axis, axis + 1))


def is_positive_int(x: Any) -> bool:
    """Whether ``x`` is an integer (Python or numpy) greater than zero."""
    if not isinstance(x, (int, np.integer)):
        return False
    return x > 0


def valid_int(x: float, *, cast: Optional[Callable[[float], float]] = None) -> int:
    """``int(cast(x))``, with ``cast`` ``np.floor`` by default."""
    rounder = np.floor if cast is None else cast
    if not callable(rounder):
        raise ParameterError(f"cast={cast!r} is not a callable rounding function")
    return int(rounder(x))


def fix_frames(frames: Any, *, x_min: Optional[int] = 0, x_max: Optional[int] = None,
               pad: bool = True) -> np.ndarray:
    """Sorted unique frame indices within ``[x_min, x_max]``, as a numpy int array.

    With ``pad`` the indices are clipped into the range and both endpoints
    are added; without it those outside the range are dropped. Host index
    arithmetic, as in the JAX package.
    """
    candidates = _host(frames)
    if (candidates < 0).any():
        raise ParameterError("frame indices must be non-negative")
    endpoints = [e for e in (x_min, x_max) if e is not None]
    if pad:
        if endpoints:
            candidates = np.clip(candidates, x_min, x_max)
        candidates = np.append(candidates, endpoints)
    else:
        keep = np.ones(candidates.shape, dtype=bool)
        if x_min is not None:
            keep &= candidates >= x_min
        if x_max is not None:
            keep &= candidates <= x_max
        candidates = candidates[keep]
    return np.unique(candidates).astype(int)


def index_to_slice(idx: Any, *, idx_min: Optional[int] = None, idx_max: Optional[int] = None,
                   step: Optional[int] = None, pad: bool = True) -> list:
    """One ``slice(start, stop, step)`` per pair of neighbouring boundaries of :func:`fix_frames`."""
    fixed = fix_frames(idx, x_min=idx_min, x_max=idx_max, pad=pad)
    return [slice(start, end, step) for start, end in zip(fixed, fixed[1:])]


def _median(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """numpy's median along ``dim``: the mean of the two middle values for an even count.

    ``torch.median`` takes the lower middle value; this sorts and averages.
    """
    n = x.shape[dim]
    ordered = x.sort(dim=dim).values
    upper = ordered.narrow(dim, n // 2, 1)
    mid = upper if n % 2 else (ordered.narrow(dim, n // 2 - 1, 1) + upper) / 2
    return mid if keepdim else mid.squeeze(dim)


def sync(data: Any, idx: Any, *, aggregate: Optional[Callable] = None, pad: bool = True,
         axis: int = -1) -> torch.Tensor:
    """Aggregate ``data`` along ``axis`` between boundaries (indices or slices).

    ``idx`` is a sequence of boundary indices (turned into slices by
    :func:`index_to_slice` over ``[0, n]``, the ends added with ``pad``) or
    a list of slices. ``aggregate`` defaults to the mean; numpy's mean,
    average, sum, max, min, median (the mean of the two middle values),
    std, var and prod run as torch reductions on ``data``'s device. Any other callable
    is called as ``aggregate(segment, axis=axis, keepdims=True)`` on each
    segment.
    """
    data = as_tensor(data)
    aggregate = np.mean if aggregate is None else aggregate
    n = data.shape[axis]
    if len(idx) > 0 and isinstance(idx[0], slice):
        slices = list(idx)
    else:
        idx_np = _host(idx)
        if idx_np.ndim != 1 or not np.issubdtype(idx_np.dtype, np.integer):
            raise ParameterError(f"Invalid index set: {idx}")
        slices = index_to_slice(idx_np, idx_min=0, idx_max=n, pad=pad)
    dim = axis % data.ndim
    parts = []
    for seg in slices:
        index = [slice(None)] * data.ndim
        index[dim] = seg
        part = data[tuple(index)]
        if aggregate is np.median:
            parts.append(_median(part, dim, keepdim=True))
            continue
        reduced = _device_reduction(np.mean if aggregate is np.average else aggregate, part, dim)
        parts.append(reduced if reduced is not None
                     else as_tensor(aggregate(part, axis=axis, keepdims=True)))
    return torch.cat(parts, dim=dim)


def peak_pick(x: Any, *, pre_max: int, post_max: int, pre_avg: int, post_avg: int, delta: float,
              wait: int, sparse: bool = True, method: str = "greedy", axis: int = -1) -> np.ndarray:
    """Peaks of an envelope along ``axis``, as indices (``sparse``, 1-D only) or a boolean mask.

    A frame ``n`` is a candidate when it is the maximum of ``x[n - pre_max:
    n + post_max]`` and at least ``delta`` above the mean of ``x[n -
    pre_avg: n + post_avg]`` (windows clipped to the array). ``method``
    'greedy' takes candidates left to right, at least ``wait`` frames
    apart; 'dp_count' and 'dp_value' take the spaced set with the most
    peaks or the largest summed height. One envelope runs in float64 on the
    host as the JAX package runs it; several run in float32 on ``x``'s
    device, as the JAX package runs them: the candidacy tests as torch ops,
    the selection as a scan over frames (``ops/peaks.py``: on the card the
    ``peak_scan`` kernels, on the CPU their plain loops). The DP's walk over
    its flags is the greedy selection of those flags: on the card the
    greedy kernel runs it and only the peaks are copied back; on the CPU it
    is a host loop. Returns numpy.
    """
    if sparse and np.ndim(x) != 1:
        raise ParameterError("sparse=True (default) does not support "
                             f"input with ndim={np.ndim(x)}. Set sparse=False.")
    for name, value in (("pre_max", pre_max), ("pre_avg", pre_avg), ("delta", delta),
                        ("wait", wait)):
        if value < 0:
            raise ParameterError(f"{name} must be non-negative")
    if post_max <= 0:
        raise ParameterError("post_max must be positive")
    if post_avg <= 0:
        raise ParameterError("post_avg must be positive")
    if method not in ("greedy", "dp_count", "dp_value"):
        raise ParameterError(f"Unsupported method: {method}")
    win = dict(pre_max=valid_int(pre_max, cast=np.ceil), post_max=valid_int(post_max, cast=np.ceil),
               pre_avg=valid_int(pre_avg, cast=np.ceil), post_avg=valid_int(post_avg, cast=np.ceil))
    wait = valid_int(wait, cast=np.ceil)

    xt = x.movedim(axis, -1) if isinstance(x, torch.Tensor) else np.moveaxis(np.asarray(x), axis, -1)
    shape = tuple(xt.shape)
    rows = int(np.prod(shape[:-1], dtype=np.int64))
    if rows > 1:
        flat = as_tensor(xt).reshape(rows, shape[-1]).to(torch.float32)
        if method == "greedy":
            out = _peaks.greedy_mask(flat, delta=float(delta), wait=wait, **win).cpu().numpy()
        else:
            out = _peaks.dp_mask(_peaks.dp_values(flat, delta=float(delta), wait=wait,
                                                  count=method == "dp_count", **win), wait)
    else:
        row = _host(xt).reshape(rows, shape[-1]).astype(np.float64)
        out = np.zeros(row.shape, dtype=bool)
        for i in range(rows):
            if method == "greedy":
                out[i] = _peaks.greedy_1d(row[i], delta=delta, wait=wait, **win)
            else:
                out[i] = _peaks.dp_1d(row[i], delta=delta, wait=wait,
                                      count=method == "dp_count", **win)
    mask = np.moveaxis(out.reshape(shape), -1, axis)
    return np.flatnonzero(mask) if sparse else mask


def _host(x: Any) -> np.ndarray:
    """``x`` as a numpy array on the host (a tensor is copied off its device).

    A copy off a CUDA device waits for the card: it is the program's span
    ``to_host`` and adds one to its counter ``host_syncs``.
    """
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            with profiling.annotate("to_host"):
                profiling.count("host_syncs")
                return x.detach().cpu().numpy()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tiny(x: Any) -> float:
    """Smallest positive normal number of the float type of ``x``.

    Integer and other non-float inputs use float32's.
    """
    if isinstance(x, torch.Tensor):
        if x.dtype.is_floating_point or x.dtype.is_complex:
            return float(torch.finfo(x.dtype).tiny)
        return float(np.finfo(np.float32).tiny)
    dtype = np.asarray(x).dtype
    if np.issubdtype(dtype, np.floating) or np.issubdtype(dtype, np.complexfloating):
        return float(np.finfo(dtype).tiny)
    return float(np.finfo(np.float32).tiny)


def expand_to(x: Any, *, ndim: int, axes: Union[int, Sequence[int]]) -> torch.Tensor:
    """View ``x`` at rank ``ndim`` with input axis ``i`` at position ``axes[i]``.

    Every other position becomes a singleton axis, so the result broadcasts
    against ``ndim``-dimensional multichannel arrays.
    """
    x = torch.as_tensor(x)
    if np.ndim(axes) == 0:
        axes = (int(axes),)
    placement = dict(zip(axes, x.shape))
    if len(placement) != x.ndim:
        raise ParameterError(
            f"expand_to needs one output position per input axis; "
            f"got axes={axes} for a {x.ndim}-d input"
        )
    if x.ndim > ndim:
        raise ParameterError(f"target rank ndim={ndim} is below the input rank {x.ndim}")
    shape = [1] * ndim
    for pos, extent in placement.items():
        shape[pos] = extent
    return x.reshape(tuple(shape))


def _pair(value: Any, name: str) -> Tuple[Any, Any]:
    """``value`` for the (before, after) sides: a scalar serves both, a pair gives each its own."""
    if np.ndim(value) == 0:
        return value, value
    if len(value) != 2:
        raise ParameterError(f"{name}={value!r} must be a scalar or a (before, after) pair")
    return value[0], value[1]


def _periodic_index(n: int, before: int, after: int, mode: str,
                    device: torch.device) -> torch.Tensor:
    """Source sample of each padded position, for the modes that repeat the signal.

    ``reflect`` (mirror without the edge sample) repeats with a period of
    ``2n - 2``, ``symmetric`` (mirror with it) of ``2n`` and ``wrap`` of ``n``,
    over as many periods as the pad needs; ``edge`` clamps.
    """
    idx = torch.arange(-before, n + after, device=device)
    if mode == "edge" or (mode == "reflect" and n == 1):
        return idx.clamp(0, n - 1)
    if mode == "wrap":
        return idx.remainder(n)
    period = 2 * n - 2 if mode == "reflect" else 2 * n
    m = idx.remainder(period)
    return torch.where(m < n, m, period - m - int(mode == "symmetric"))


def _stat(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The statistic of padding mode ``mode`` over the last axis, kept as an axis of one."""
    if mode == "maximum":
        return x.amax(dim=-1, keepdim=True)
    if mode == "minimum":
        return x.amin(dim=-1, keepdim=True)
    if mode == "mean":
        return x.mean(dim=-1, keepdim=True)
    # numpy's median: the mean of the two middle values of an even count
    s = x.sort(dim=-1).values
    k = s.shape[-1]
    return 0.5 * (s[..., (k - 1) // 2:(k - 1) // 2 + 1] + s[..., k // 2:k // 2 + 1])


def pad_last(x: torch.Tensor, before: int, after: int, *, mode: str = "constant",
             constant_values: Any = 0.0, end_values: Any = 0.0,
             stat_length: Any = None) -> torch.Tensor:
    """Pad the last axis of ``x`` by ``(before, after)`` samples, as ``numpy.pad`` pads.

    Every mode of ``numpy.pad`` except a callable: ``constant``
    (``constant_values``), ``edge``, ``reflect`` (mirror without the edge
    sample), ``symmetric`` (mirror with it) and ``wrap`` over as many periods
    as the pad needs, ``linear_ramp`` (from ``end_values`` to the edge sample),
    ``maximum``, ``minimum``, ``mean`` and ``median`` of the ``stat_length``
    samples nearest each end (None: the whole axis), and ``empty``, which
    pads with zeros as ``jax.numpy.pad`` does. ``constant_values``,
    ``end_values`` and ``stat_length`` are scalars or ``(before, after)``
    pairs. A pad within one period goes to ``torch.nn.functional.pad``, a
    longer one is a gather by index.
    """
    if mode not in _PAD_MODES:
        raise ParameterError(f"Unsupported pad mode {mode!r}: the port pads {_PAD_MODES}")
    if before == 0 and after == 0:
        return x
    n = x.shape[-1]
    if mode in ("constant", "empty"):
        lo, hi = _pair(constant_values if mode == "constant" else 0.0, "constant_values")
        if lo == hi:
            return F.pad(x, (before, after), mode="constant", value=float(lo))
        return torch.cat([x.new_full((*x.shape[:-1], before), float(lo)), x,
                          x.new_full((*x.shape[:-1], after), float(hi))], dim=-1)
    if n == 0:
        raise ParameterError(f"pad mode {mode!r} cannot extend an empty axis")
    if mode == "linear_ramp":
        lo, hi = _pair(end_values, "end_values")
        ramp_up = torch.arange(before, device=x.device, dtype=x.dtype) / max(before, 1)
        ramp_down = torch.arange(1, after + 1, device=x.device, dtype=x.dtype) / max(after, 1)
        first, last = x[..., :1], x[..., -1:]
        return torch.cat([lo + (first - lo) * ramp_up, x, last + (hi - last) * ramp_down], dim=-1)
    if mode in _STAT_PAD_MODES:
        lo, hi = _pair(stat_length, "stat_length")
        lo, hi = n if lo is None else max(1, min(int(lo), n)), n if hi is None else max(1, min(int(hi), n))
        left, right = _stat(x[..., :lo], mode), _stat(x[..., n - hi:], mode)
        return torch.cat([left.expand(*x.shape[:-1], before), x,
                          right.expand(*x.shape[:-1], after)], dim=-1)
    within = {"reflect": n - 1, "wrap": n, "edge": max(before, after)}.get(mode, -1)
    if max(before, after) <= within:
        # F.pad's non-constant modes want (batch, channel, length)
        out = F.pad(x.reshape(-1, 1, n), (before, after), mode=_TORCH_PAD_MODES[mode])
        return out.reshape(*x.shape[:-1], out.shape[-1])
    return x.index_select(-1, _periodic_index(n, before, after, mode, x.device))


def _pad_axis(data: torch.Tensor, before: int, after: int, axis: int,
              kwargs: dict) -> torch.Tensor:
    unknown = set(kwargs) - {"mode", "constant_values", "end_values", "stat_length"}
    if unknown:
        raise ParameterError(f"Unsupported padding arguments: {sorted(unknown)}")
    return pad_last(data.movedim(axis, -1), before, after, **kwargs).movedim(-1, axis)


def pad_center(data: Any, *, size: int, axis: int = -1, **kwargs: Any) -> torch.Tensor:
    """``data`` centred in an axis of length ``size``; an odd remainder goes right.

    ``kwargs`` are :func:`pad_last`'s (``mode``, ``constant_values``, ``end_values``,
    ``stat_length``).
    """
    data = as_tensor(data)
    slack = size - data.shape[axis]
    if slack < 0:
        raise ParameterError(
            f"cannot center data of length {data.shape[axis]} in size={size}"
        )
    return _pad_axis(data, slack // 2, slack - slack // 2, axis, kwargs)


def fix_length(data: Any, *, size: int, axis: int = -1, **kwargs: Any) -> torch.Tensor:
    """``data`` cut or right-padded to exactly ``size`` elements along ``axis``.

    ``kwargs`` are :func:`pad_last`'s (``mode``, ``constant_values``, ``end_values``,
    ``stat_length``).
    """
    data = as_tensor(data)
    shortfall = size - data.shape[axis]
    if shortfall == 0:
        return data
    if shortfall < 0:
        return data.narrow(axis, 0, size)
    return _pad_axis(data, 0, shortfall, axis, kwargs)


def normalize(
    S: Any,
    *,
    norm: Optional[float] = np.inf,
    axis: Optional[int] = 0,
    threshold: Optional[float] = None,
    fill: Optional[bool] = None,
) -> torch.Tensor:
    """Scale ``S`` to unit ``norm`` along ``axis`` (over the whole array for ``axis=None``).

    ``norm`` is ``inf`` (peak), ``-inf`` (least magnitude), 0 (count of
    nonzeros), any ``p > 0``, or None (no scaling). Slices whose norm is
    below ``threshold`` (default: the dtype's smallest normal number) are
    left as they are (``fill=None``), set to zero (``fill=False``) or set to
    the uniform vector of unit norm (``fill=True``). Everything stays on
    ``S``'s device; no value is read back to the host.
    """
    if fill not in (None, False, True):
        raise ParameterError(f"fill={fill} must be None or boolean")
    if threshold is not None and threshold <= 0:
        raise ParameterError(f"threshold={threshold} must be strictly positive")
    S = as_tensor(S)
    if not (S.dtype.is_floating_point or S.dtype.is_complex):
        raise ParameterError("Input must be floating point")
    if norm is None:
        return S

    floor = tiny(S) if threshold is None else threshold
    mag = S.abs()
    if mag.dtype in (torch.float16, torch.bfloat16):
        mag = mag.to(torch.float32)
    dims = None if axis is None else (axis,)

    unit_fill = 1.0
    if norm == np.inf:
        scale = mag.amax(dim=dims, keepdim=True)
    elif norm == -np.inf:
        scale = mag.amin(dim=dims, keepdim=True)
    elif norm == 0:
        if fill is True:
            raise ParameterError("norm=0 is incompatible with fill=True")
        scale = (mag != 0).sum(dim=dims, keepdim=True).to(mag.dtype)
    elif np.issubdtype(type(norm), np.number) and norm > 0:
        scale = (mag**norm).sum(dim=dims, keepdim=True) ** (1.0 / norm)
        extent = mag.numel() if axis is None else mag.shape[axis]
        unit_fill = extent ** (-1.0 / norm)
    else:
        raise ParameterError(f"Unsupported norm: {norm!r}")

    below = scale < floor
    if fill is None:
        return S / scale.masked_fill(below, 1.0)
    if fill is False:
        return S / scale.masked_fill(below, float("inf"))
    out = S / scale.masked_fill(below, float("nan"))
    return torch.where(out.isnan(), unit_fill, out)


def _local_extremum(x: Any, axis: int, *, maxima: bool) -> torch.Tensor:
    x = as_tensor(x).movedim(axis, -1)
    first = torch.zeros_like(x[..., :1], dtype=torch.bool)
    last = torch.ones_like(x[..., :1], dtype=torch.bool)
    if maxima:
        inner, outer = x[..., 1:] > x[..., :-1], x[..., :-1] >= x[..., 1:]
    else:
        inner, outer = x[..., 1:] < x[..., :-1], x[..., :-1] <= x[..., 1:]
    out = torch.cat([first, inner], dim=-1) & torch.cat([outer, last], dim=-1)
    return out.movedim(-1, axis)


def localmax(x: Any, *, axis: int = 0) -> torch.Tensor:
    """Mask of local maxima along ``axis``: ``x[i] > x[i-1]`` and ``x[i] >= x[i+1]``.

    The first element is never a maximum; the last is one when it exceeds
    its left neighbour.
    """
    return _local_extremum(x, axis, maxima=True)


def localmin(x: Any, *, axis: int = 0) -> torch.Tensor:
    """Mask of local minima along ``axis``: ``x[i] < x[i-1]`` and ``x[i] <= x[i+1]``.

    The first element is never a minimum; the last is one when it lies
    below its left neighbour.
    """
    return _local_extremum(x, axis, maxima=False)


_R2C = {torch.float32: torch.complex64, torch.float64: torch.complex128}
_C2R = {c: r for r, c in _R2C.items()}


def _torch_dtype(d: Any) -> Optional[torch.dtype]:
    """``d`` (a torch dtype, or anything ``numpy.dtype`` takes) as a torch dtype; None stays."""
    if d is None or isinstance(d, torch.dtype):
        return d
    return getattr(torch, np.dtype(d).name)


def dtype_r2c(d: Any, *, default: Any = torch.complex64) -> Optional[torch.dtype]:
    """The complex torch dtype as precise as the real dtype ``d`` (float32 -> complex64).

    ``d`` may be a torch or a numpy dtype. A complex dtype stays; anything
    that has no complex partner (halves, integers) gives ``default``.
    """
    d = _torch_dtype(d)
    if d.is_complex:
        return d
    return _R2C.get(d, _torch_dtype(default))


def dtype_c2r(d: Any, *, default: Any = torch.float32) -> Optional[torch.dtype]:
    """The real torch dtype as precise as the complex dtype ``d`` (complex128 -> float64).

    ``d`` may be a torch or a numpy dtype. A floating dtype stays; anything
    that has no real partner gives ``default``.
    """
    d = _torch_dtype(d)
    if d.is_floating_point:
        return d
    return _C2R.get(d, _torch_dtype(default))


def abs2(x: Any, dtype: Any = None) -> torch.Tensor:
    """``|x|**2``, from the real and imaginary parts for complex input; cast to ``dtype`` if given."""
    x = as_tensor(x)
    out = x.real.square() + x.imag.square() if x.is_complex() else x.square()
    return out if dtype is None else out.to(_torch_dtype(dtype))


def phasor(angles: Any, *, mag: Any = None) -> torch.Tensor:
    """``mag * exp(1j * angles)`` as a complex tensor, from cosine and sine (``mag`` None: 1)."""
    angles = as_tensor(angles)
    if not angles.dtype.is_floating_point:
        angles = angles.to(torch.float32)
    z = torch.complex(torch.cos(angles), torch.sin(angles))
    if mag is not None:
        z = z * torch.as_tensor(mag, device=z.device)
    return z


def _sparsify_dense(x: Any, *, quantile: float = 0.01, dtype: Any = None) -> np.ndarray:
    """:func:`sparsify_rows` as a dense host array."""
    x = np.atleast_2d(np.asarray(x))
    if x.ndim != 2:
        raise ParameterError(f"sparsify_rows takes a vector or a matrix, not shape {x.shape}")
    if not 0 <= quantile < 1:
        raise ParameterError(f"quantile={quantile} must lie in [0, 1)")
    mags = np.abs(x)
    ranked = np.sort(mags, axis=1)
    share = np.cumsum(ranked, axis=1)
    share /= share[:, -1:]
    first_kept = (share < quantile).sum(axis=1)
    floor = np.take_along_axis(ranked, first_kept[:, None], axis=1)
    return np.where(mags >= floor, x, 0).astype(x.dtype if dtype is None else dtype)


def sparsify_rows(x: Any, *, quantile: float = 0.01, dtype: Any = None):
    """``x`` with each row's smallest entries set to zero, as a ``scipy.sparse.csr_matrix``.

    Per row, the entries are taken in rising order of magnitude until their
    share of the row's total magnitude would reach ``quantile``; those are
    zeroed, and every entry at least as large as the first one kept stays.
    A vector is one row. The result has ``x``'s dtype, or ``dtype``.
    """
    import scipy.sparse

    dense = _sparsify_dense(x, quantile=quantile, dtype=dtype)
    return scipy.sparse.csr_matrix(dense, shape=dense.shape)


def _softmask_core(X: torch.Tensor, X_ref: torch.Tensor, *, power: float,
                   split_zeros: bool) -> torch.Tensor:
    """:func:`softmask` without its checks, on the inputs' device."""
    big = torch.maximum(X, X_ref)
    # below the smallest normal number the ratio means nothing: such cells get the fill
    empty = big < torch.finfo(big.dtype).tiny
    fill = 0.5 if split_zeros else 0.0
    if not np.isfinite(power):
        return torch.where(empty, fill, (X > X_ref).to(X.dtype))
    scale = torch.where(empty, 1.0, big)
    mine = (X / scale) ** power
    return torch.where(empty, fill, mine / (mine + (X_ref / scale) ** power))


def softmask(X: Any, X_ref: Any, *, power: float = 1, split_zeros: bool = False) -> torch.Tensor:
    """The soft mask ``X**power / (X**power + X_ref**power)``, in ``[0, 1]``.

    Both inputs are divided by their elementwise maximum first, so that no
    power overflows. ``power=np.inf`` gives the hard mask ``X > X_ref``.
    Where both are (near) zero the mask is 0.5 with ``split_zeros``, else 0.
    The inputs must be non-negative floats of one shape; the test for
    negative values reads one flag back from the device.
    """
    X, X_ref = as_tensor(X), as_tensor(X_ref)
    if X.shape != X_ref.shape:
        raise ParameterError(f"softmask takes inputs of one shape, not {tuple(X.shape)} and "
                             f"{tuple(X_ref.shape)}")
    if power <= 0:
        raise ParameterError(f"power={power} must be positive")
    if not X.dtype.is_floating_point:
        raise ParameterError(f"softmask takes float inputs, not {X.dtype}")
    if bool((torch.minimum(X.min(), X_ref.min()) < 0).item()):
        raise ParameterError("softmask takes non-negative inputs")
    return _softmask_core(X, X_ref.to(X.device), power=float(power), split_zeros=split_zeros)


def shear(X: Any, *, factor: int = 1, axis: int = -1) -> Any:
    """``X`` ``(n0, n1)`` with each column rolled down by ``factor`` times its index.

    With ``axis=0`` each row ``i`` rolls right by ``factor * i`` instead.
    A tensor (or array, which goes to the default device) shears with one
    modular gather on its device; a ``scipy.sparse`` matrix shears its
    coordinates on the host and keeps its format.
    """
    if not np.issubdtype(type(factor), np.integer):
        raise ParameterError(f"factor={factor} must be integer-valued")
    import scipy.sparse

    if scipy.sparse.issparse(X):
        from ..segment import _shear_sparse

        return _shear_sparse(X, factor, axis)
    X = as_tensor(X)
    if X.ndim != 2:
        raise ParameterError("shear is defined only for 2D arrays")
    n0, n1 = X.shape
    rows = torch.arange(n0, device=X.device)[:, None]
    cols = torch.arange(n1, device=X.device)[None, :]
    if axis == 0:
        return torch.gather(X, 1, (cols - factor * rows).remainder(n1))
    return torch.gather(X, 0, (rows - factor * cols).remainder(n0))


def fill_off_diagonal(x: Any, *, radius: float, value: float = 0) -> None:
    """Set every cell of ``x`` ``(..., nx, ny)`` outside a band around the diagonal to ``value``, in place.

    The band keeps ``|i - j| < radius``; a float ``radius`` below 1 is a
    fraction of ``min(nx, ny)``. Of a rectangular matrix the columns (or
    rows) from ``min(nx, ny) - radius`` on are filled as well. ``x`` is a
    numpy array or a tensor, changed where it lies.
    """
    outside = ~band_mask(*x.shape[-2:], radius=radius)
    if isinstance(x, torch.Tensor):
        outside = torch.from_numpy(outside).to(x.device)
    x[..., outside] = value


def band_mask(nx: int, ny: int, *, radius: float) -> np.ndarray:
    """The Sakoe-Chiba band of an ``(nx, ny)`` matrix as numpy bool, True inside.

    Cell ``(i, j)`` is inside when ``|i - j| < radius``; a float ``radius``
    below 1 is a fraction of ``min(nx, ny)``. Of a rectangle the columns (or
    rows) from ``min(nx, ny) - radius`` on are outside, as
    :func:`fill_off_diagonal` fills them. As in the JAX package it is a name
    of this module only, not of the ``util`` namespace.
    """
    shortest = min(nx, ny)
    if isinstance(radius, float) and radius < 1:
        radius = int(radius * shortest)
    radius = int(radius)
    i = np.arange(nx)[:, None]
    j = np.arange(ny)[None, :]
    inside = (j - i < radius) & (i - j < radius)
    if nx < ny:
        inside[:, shortest - radius:] = False
    elif ny < nx:
        inside[shortest - radius:, :] = False
    return inside


def axis_sort(S: Any, *, axis: int = -1, index: bool = False,
              value: Optional[Callable] = None) -> Any:
    """The matrix ``S`` with its columns (``axis=-1``) or rows (``axis=0``) in rising order of peak.

    The peak of a column is ``value(S, axis=0)`` of it (``argmax`` by
    default), of a row ``value(S, axis=1)``; equal peaks keep their order.
    ``index=True`` also returns the permutation, as a tensor.
    """
    S = as_tensor(S)
    if S.ndim != 2:
        raise ParameterError(f"axis_sort needs a matrix; got ndim={S.ndim}")
    key_axis = (axis + 1) % 2
    peaks = S.argmax(dim=key_axis) if value is None else as_tensor(value(S, axis=key_axis))
    order = torch.argsort(peaks, stable=True).to(S.device)
    permuted = S.index_select(axis % 2, order)
    return (permuted, order) if index else permuted


def valid_audio(y: Any, *, mono: bool = False) -> bool:
    """True if ``y`` is audio: a floating-point array of at least one dimension, finite everywhere.

    A tensor is checked where it lies (its finiteness is one flag read back
    from the device) and, as in the JAX package for a device array, without
    the mono check; anything else is checked as a numpy array, where
    ``mono=True`` also asks for one dimension. Raises ``ParameterError`` on
    the first problem.
    """
    on_device = isinstance(y, torch.Tensor)
    if not on_device:
        y = np.asarray(y)
    problems = []
    floating = y.dtype.is_floating_point if on_device else np.issubdtype(y.dtype, np.floating)
    if not floating:
        problems.append("Audio data must be floating-point")
    if y.ndim == 0:
        problems.append(f"Audio data must be at least one-dimensional, given y.shape={tuple(y.shape)}")
    if mono and not on_device and y.ndim != 1:
        problems.append(f"Invalid shape for monophonic audio: ndim={y.ndim}")
    if not problems:
        finite = bool(torch.isfinite(y).all()) if on_device else bool(np.isfinite(y).all())
        if not finite:
            problems.append("Audio buffer is not finite everywhere")
    if problems:
        raise ParameterError(problems[0])
    return True


def valid_intervals(intervals: Any) -> bool:
    """True if ``intervals`` is an ``(n, 2)`` array of ``[start, end]`` rows with ``end >= start``."""
    ivals = _host(intervals)
    if ivals.shape[-1:] != (2,) or ivals.ndim != 2:
        raise ParameterError(f"interval arrays are (n, 2)-shaped; got {ivals.shape}")
    if (ivals[:, 1] - ivals[:, 0] < 0).any():
        raise ParameterError("every interval needs end >= start")
    return True


def cyclic_gradient(data: Any, *, edge_order: int = 1, axis: int = -1) -> torch.Tensor:
    """The gradient of a periodic signal along ``axis``: ``(x[n+1] - x[n-1]) / 2`` with wrap-around.

    Every sample of a periodic signal is an interior point, so ``edge_order``
    (which changes only ``np.gradient``'s edges) changes nothing.
    """
    data = as_tensor(data)
    return (torch.roll(data, -1, dims=axis) - torch.roll(data, 1, dims=axis)) / 2.0


def stack(arrays: Sequence[Any], *, axis: int = 0) -> torch.Tensor:
    """The arrays, all of one shape, stacked along a new ``axis``."""
    if not arrays:
        raise ParameterError("no input arrays provided to stack")
    tensors = [as_tensor(a) for a in arrays]
    if len({tuple(t.shape) for t in tensors}) > 1:
        raise ParameterError("all input arrays must have the same shape")
    return torch.stack([t.to(tensors[0].device) for t in tensors], dim=axis)


def count_unique(data: Any, *, axis: int = -1) -> torch.Tensor:
    """The number of distinct values in each slice along ``axis``: a sort and its change points."""
    data = as_tensor(data)
    s = torch.sort(data, dim=axis).values
    return (torch.diff(s, dim=axis) != 0).sum(dim=axis) + 1


def is_unique(data: Any, *, axis: int = -1) -> torch.Tensor:
    """True for each slice along ``axis`` whose values are all distinct."""
    data = as_tensor(data)
    return count_unique(data, axis=axis) == data.shape[axis]


def buf_to_float(x: Any, *, n_bytes: int = 2, dtype: Any = np.float32) -> np.ndarray:
    """Little-endian signed PCM of ``n_bytes`` a sample as floats in ``[-1, 1)``, on the host."""
    ints = np.frombuffer(x, dtype=f"<i{n_bytes}")
    return ints.astype(dtype) / float(2 ** (8 * n_bytes - 1))


def interp_broadcast(*, x1: Any, x1_pos: Any, x2: Any, x2_pos: Any, interp_pos: Any = None,
                     op: Optional[Callable] = np.multiply, kind: str = "linear",
                     fill_value: float = 0, axis: int = -2):
    """``op`` of ``x1`` and ``x2``, each first resampled along ``axis`` onto ``interp_pos``.

    ``x1`` is sampled at ``x1_pos`` and ``x2`` at ``x2_pos``; ``interp_pos``
    defaults to ``x1_pos``. Queries outside a grid get ``fill_value``. With
    ``op=None`` the two resampled arrays are returned. Runs on the host in
    numpy (linear) or scipy (other ``kind``), as the JAX package does.
    """
    x1, x2 = _host(x1), _host(x2)
    targets = _host(x1_pos if interp_pos is None else interp_pos)
    shallow = min(x1.ndim, x2.ndim)
    if not -shallow <= axis < shallow:
        raise ParameterError(f"axis={axis} does not exist in both inputs "
                             f"(ndim {x1.ndim} and {x2.ndim})")
    y1 = _regrid_1d(x1, _host(x1_pos), targets, axis=axis, kind=kind, fill_value=fill_value)
    y2 = _regrid_1d(x2, _host(x2_pos), targets, axis=axis, kind=kind, fill_value=fill_value)
    if op is None:
        return y1, y2
    try:
        np.broadcast_shapes(y1.shape, y2.shape)
    except ValueError as exc:
        raise ParameterError(f"Resampled shapes {y1.shape} and {y2.shape} (from inputs "
                             f"{x1.shape} / {x2.shape} along axis={axis}) do not broadcast") from exc
    return op(y1, y2)


def _regrid_1d(values: np.ndarray, grid: np.ndarray, targets: np.ndarray, *, axis: int,
               kind: str, fill_value: float) -> np.ndarray:
    """``values`` (sampled at ``grid`` along ``axis``) at ``targets``; ``fill_value`` outside.

    Linear: a bracketing search and a lerp in numpy; any other ``kind``
    goes to ``scipy.interpolate.interp1d``.
    """
    if kind != "linear":
        import scipy.interpolate

        fit = scipy.interpolate.interp1d(grid, values, axis=axis, kind=kind, copy=False,
                                         bounds_error=False, fill_value=fill_value)
        return fit(targets)
    order = np.argsort(grid)
    grid = grid[order]
    values = np.take(values, order, axis=axis)
    hi = np.clip(np.searchsorted(grid, targets, side="right"), 1, len(grid) - 1)
    span = grid[hi] - grid[hi - 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.where(span > 0, (targets - grid[hi - 1]) / span, 0.0)
    lo_vals = np.take(values, hi - 1, axis=axis)
    hi_vals = np.take(values, hi, axis=axis)
    bshape = [1] * values.ndim
    bshape[axis] = len(targets)
    out = lo_vals + w.reshape(bshape) * (hi_vals - lo_vals)
    inside = (targets >= grid[0]) & (targets <= grid[-1])
    return np.where(inside.reshape(bshape), out, fill_value)
