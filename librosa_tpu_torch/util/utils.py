"""Array helpers used by the feature code (torch tensors, numpy scalars)."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from .._device import as_tensor
from .exceptions import ParameterError

__all__ = ["tiny", "expand_to", "normalize", "pad_center", "fix_length", "localmax", "localmin",
           "dtype_r2c", "dtype_c2r", "abs2", "phasor"]

# numpy's names for padding modes, as torch.nn.functional.pad knows them
_TORCH_PAD_MODES = {"constant": "constant", "reflect": "reflect", "edge": "replicate",
                    "wrap": "circular"}
_PAD_MODES = tuple(_TORCH_PAD_MODES) + ("symmetric",)


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


def pad_last(x: torch.Tensor, before: int, after: int, *, mode: str = "constant",
             constant_values: float = 0.0) -> torch.Tensor:
    """Pad the last axis of ``x`` by ``(before, after)`` samples, with numpy's mode names.

    ``constant``, ``reflect`` (mirror without the edge sample), ``edge`` and
    ``wrap`` go to ``torch.nn.functional.pad``; ``symmetric`` (mirror with
    the edge sample) is a gather by index. ``reflect``, ``symmetric`` and
    ``wrap`` take at most one period, as ``torch`` does: a pad as long as
    the axis or longer raises. Other modes of ``numpy.pad`` (``linear_ramp``,
    ``mean``, ``median``, ``maximum``, ``minimum``, ``empty``) are not
    mapped and raise :class:`ParameterError`.
    """
    if mode not in _PAD_MODES:
        raise ParameterError(f"Unsupported pad mode {mode!r}: the port pads {_PAD_MODES}")
    if before == 0 and after == 0:
        return x
    n = x.shape[-1]
    if mode == "constant":
        return F.pad(x, (before, after), mode="constant", value=constant_values)
    limit = {"reflect": n - 1, "symmetric": n, "wrap": n}.get(mode)
    if limit is not None and max(before, after) > limit:
        raise ParameterError(
            f"pad mode {mode!r} takes at most {limit} samples a side from an axis of "
            f"{n}; got ({before}, {after})"
        )
    if mode == "symmetric":
        idx = torch.arange(-before, n + after, device=x.device)
        idx = torch.where(idx < 0, -idx - 1, idx)
        idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
        return x.index_select(-1, idx)
    # F.pad's non-constant modes want (batch, channel, length)
    out = F.pad(x.reshape(-1, 1, n), (before, after), mode=_TORCH_PAD_MODES[mode])
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _pad_axis(data: torch.Tensor, before: int, after: int, axis: int,
              kwargs: dict) -> torch.Tensor:
    kwargs = {"mode": "constant", **kwargs}
    unknown = set(kwargs) - {"mode", "constant_values"}
    if unknown:
        raise ParameterError(f"Unsupported padding arguments: {sorted(unknown)}")
    return pad_last(data.movedim(axis, -1), before, after, **kwargs).movedim(-1, axis)


def pad_center(data: Any, *, size: int, axis: int = -1, **kwargs: Any) -> torch.Tensor:
    """``data`` centred in an axis of length ``size``; an odd remainder goes right.

    ``kwargs`` are ``mode`` (see :func:`pad_last`) and ``constant_values``.
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

    ``kwargs`` are ``mode`` (see :func:`pad_last`) and ``constant_values``.
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
