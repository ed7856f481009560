"""Temporal feature helpers: delta features and memory stacking."""

from __future__ import annotations

from math import factorial
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .._device import as_tensor, exact_f32
from ..util.exceptions import ParameterError
from ..util.utils import pad_last

__all__ = ["delta", "stack_memory"]

# scipy.signal.savgol_filter's edge modes, as numpy.pad names them
_DELTA_PAD_MODES = {"nearest": "edge", "mirror": "reflect", "wrap": "wrap"}


def _edge_matrices(width: int, polyorder: int, order: int, delta_t: float):
    """``(head, tail)``, each ``(width // 2, width)`` in float64: the ``order``-th derivative of
    the degree-``polyorder`` fit to the first (last) ``width`` samples, at each of the first
    (last) ``width // 2`` positions."""
    half = width // 2
    t = np.arange(width, dtype=np.float64)
    pinv = np.linalg.pinv(np.vander(t, polyorder + 1, increasing=True))

    def deval(ts: np.ndarray) -> np.ndarray:
        D = np.zeros((len(ts), polyorder + 1))
        for ci in range(order, polyorder + 1):
            D[:, ci] = factorial(ci) / factorial(ci - order) * ts ** (ci - order) / delta_t**order
        return D

    return deval(t[:half]) @ pinv, deval(t[-half:]) @ pinv


def delta(data: Any, *, width: int = 9, order: int = 1, axis: int = -1, mode: str = "interp",
          **kwargs: Any) -> torch.Tensor:
    """The ``order``-th derivative of ``data`` along ``axis`` by a Savitzky-Golay filter.

    Interior samples are one convolution with ``scipy.signal.savgol_coeffs(width,
    polyorder, deriv=order, delta=delta)`` (``polyorder`` defaults to
    ``order``; both come from ``kwargs``). ``mode='interp'`` fits a
    polynomial to the first and last ``width`` samples and differentiates it
    at the edges (two float64 matrices from the host, applied as products);
    ``'nearest'``, ``'mirror'`` and ``'wrap'`` pad the edges as ``numpy.pad``'s
    ``'edge'``, ``'reflect'`` and ``'wrap'``, any other mode with zeros.
    """
    import scipy.signal

    data = as_tensor(data)
    if mode == "interp" and width > data.shape[axis]:
        raise ParameterError(f"when mode='interp', width={width} "
                             f"cannot exceed data.shape[axis]={data.shape[axis]}")
    if width < 3 or np.mod(width, 2) != 1:
        raise ParameterError("width must be an odd integer >= 3")
    if order <= 0 or not isinstance(order, (int, np.integer)):
        raise ParameterError("order must be a positive integer")
    kwargs.pop("deriv", None)
    polyorder = kwargs.get("polyorder", order)
    delta_t = kwargs.get("delta", 1.0)
    if not data.dtype.is_floating_point:
        data = data.to(torch.float32)
    coeffs = scipy.signal.savgol_coeffs(width, polyorder, deriv=order, delta=delta_t)

    x = data.movedim(axis, -1)
    n = x.shape[-1]
    flat = x.reshape(-1, 1, n)
    # numpy.convolve(row, coeffs) is conv1d's correlation with the coefficients reversed
    weight = torch.as_tensor(np.ascontiguousarray(coeffs[::-1]), dtype=x.dtype,
                             device=x.device).reshape(1, 1, width)
    with exact_f32():
        if mode == "interp":
            head_M, tail_M = _edge_matrices(width, polyorder, order, delta_t)
            head_t = torch.as_tensor(head_M.T, dtype=x.dtype, device=x.device)
            tail_t = torch.as_tensor(tail_M.T, dtype=x.dtype, device=x.device)
            rows = flat[:, 0]
            out = torch.cat([rows[:, :width] @ head_t, F.conv1d(flat, weight)[:, 0],
                             rows[:, -width:] @ tail_t], dim=-1)
        else:
            half = width // 2
            padded = pad_last(flat, half, half, mode=_DELTA_PAD_MODES.get(mode, "constant"))
            out = F.conv1d(padded, weight)[:, 0]
    return out.reshape(x.shape[:-1] + (out.shape[-1],)).movedim(-1, axis)


def stack_memory(data: Any, *, n_steps: int = 2, delay: int = 1, **kwargs: Any) -> torch.Tensor:
    """``data`` ``(..., d, t)`` with ``n_steps`` delayed copies stacked: ``(..., d * n_steps, t)``.

    Block ``k`` is ``data`` delayed by ``k * delay`` frames (a negative
    ``delay`` looks ahead), the frames it lacks padded by ``kwargs`` as
    ``numpy.pad`` pads (``mode``, default ``'constant'``, and its values).
    """
    if n_steps < 1:
        raise ParameterError("n_steps must be a positive integer")
    if delay == 0:
        raise ParameterError("delay must be a non-zero integer")
    kwargs.setdefault("mode", "constant")
    for key in ("constant_values", "end_values", "stat_length"):
        # numpy.pad takes [v] for one value on both sides
        if key in kwargs and np.ndim(kwargs[key]) > 0 and len(kwargs[key]) == 1:
            kwargs[key] = kwargs[key][0]
    unknown = set(kwargs) - {"mode", "constant_values", "end_values", "stat_length"}
    if unknown:
        raise ParameterError(f"Unsupported padding arguments: {sorted(unknown)}")
    data = as_tensor(data)
    if data.ndim < 2:
        data = data.reshape((1,) * (2 - data.ndim) + tuple(data.shape))
    t = data.shape[-1]
    blocks = []
    for step in range(n_steps):
        shift = step * delay
        if shift >= 0:
            blocks.append(pad_last(data, shift, 0, **kwargs)[..., :t])
        else:
            blocks.append(pad_last(data, 0, -shift, **kwargs)[..., -t:])
    return torch.cat(blocks, dim=-2)
