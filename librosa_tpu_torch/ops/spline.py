"""Cubic and linear resampling from a uniform grid at fixed positions, on the device.

Built for :func:`core.spectrum_ext.fmt`. The input grid is uniform and the
output positions are known on the host, so every interpolation weight and
every elimination constant of the spline system is made there in float64;
the device does two first-order recurrences (forward elimination and back
substitution of the not-a-knot tridiagonal system, each a doubling scan,
:func:`ops.iir.affine_scan`), four gathers and a weighted sum.

With unit spacing and second derivatives ``M_i``, continuity gives
``M_{i-1} + 4 M_i + M_{i+1} = 6 (y_{i-1} - 2 y_i + y_{i+1})`` for the
interior; the not-a-knot ends reduce on a uniform grid to
``M_0 = 2 M_1 - M_2`` and ``M_{n-1} = 2 M_{n-2} - M_{n-3}``, which leave
``M_1`` and ``M_{n-2}`` decoupled and a constant (1, 4, 1) system between
them. The not-a-knot cubic is unique, so this is scipy's
``interp1d(kind='cubic')`` to float rounding.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .iir import affine_scan

__all__ = ["notaknot_second_derivatives", "uniform_cubic_resample", "uniform_linear_resample"]


@functools.lru_cache(maxsize=64)
def _thomas_coefficients(m: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(upper, inv_pivot)`` of the ``m``-unknown (1, 4, 1) system's elimination, in float64:
    ``inv_pivot[k] = 1 / (4 - upper[k-1])`` and ``upper[k] = inv_pivot[k]``."""
    upper = np.empty(m, dtype=np.float64)
    inv_pivot = np.empty(m, dtype=np.float64)
    running = 0.0
    for k in range(m):
        inv_pivot[k] = 1.0 / (4.0 - running)
        running = inv_pivot[k]
        upper[k] = running
    return upper, inv_pivot


def notaknot_second_derivatives(y: torch.Tensor) -> torch.Tensor:
    """The second derivatives of the not-a-knot cubic through ``y`` on a unit grid (last axis).

    ``y`` needs at least 4 samples; for spacing ``h`` divide the result by ``h**2``.
    """
    n = y.shape[-1]
    if n < 4:
        raise ValueError("a not-a-knot cubic spline needs >= 4 samples")
    rhs = 6.0 * (y[..., :-2] - 2.0 * y[..., 1:-1] + y[..., 2:])
    m_first = rhs[..., :1] / 6.0
    m_last = rhs[..., -1:] / 6.0
    inner = n - 4
    if inner > 0:
        upper, inv_pivot = (torch.as_tensor(c, dtype=y.dtype, device=y.device)
                            for c in _thomas_coefficients(inner))
        r = rhs[..., 1:-1]
        if inner > 1:
            r = torch.cat([r[..., :1] - m_first, r[..., 1:-1], r[..., -1:] - m_last], dim=-1)
        else:
            r = r - m_first - m_last
        # forward elimination d_k = inv_pivot_k r_k - inv_pivot_k d_{k-1}, then back
        # substitution X_k = d_k - upper_k X_{k+1} as a scan over the reversed axis
        d = affine_scan(-inv_pivot, r * inv_pivot)
        m_inner = affine_scan(-upper.flip(-1), d.flip(-1)).flip(-1)
        body = torch.cat([m_first, m_inner, m_last], dim=-1)
    else:
        body = torch.cat([m_first, m_last], dim=-1)
    m_head = 2.0 * body[..., :1] - body[..., 1:2]
    m_tail = 2.0 * body[..., -1:] - body[..., -2:-1]
    return torch.cat([m_head, body, m_tail], dim=-1)


def _cells(n: int, positions: np.ndarray, x0: float, dx: float) -> Tuple[np.ndarray, np.ndarray]:
    """Each position's grid cell (clipped to ``[0, n - 2]``) and its offset in it, in float64."""
    t = (np.asarray(positions, dtype=np.float64) - x0) / dx
    cell = np.clip(np.floor(t).astype(np.int64), 0, n - 2)
    return cell, t - cell


def uniform_cubic_resample(y: torch.Tensor, positions: np.ndarray, *, x0: float,
                           dx: float) -> torch.Tensor:
    """The not-a-knot cubic through ``y`` (on ``x0 + dx * arange(n)``, last axis) at ``positions``."""
    n = y.shape[-1]
    cell, s = _cells(n, positions, x0, dx)
    curvature = notaknot_second_derivatives(y)
    lo = torch.as_tensor(cell, device=y.device)
    hi = lo + 1

    def weight(w: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(w, dtype=y.dtype, device=y.device)

    return (y.index_select(-1, lo) * weight(1.0 - s) + y.index_select(-1, hi) * weight(s)
            + curvature.index_select(-1, lo) * weight(((1.0 - s) ** 3 - (1.0 - s)) / 6.0)
            + curvature.index_select(-1, hi) * weight((s**3 - s) / 6.0))


def uniform_linear_resample(y: torch.Tensor, positions: np.ndarray, *, x0: float,
                            dx: float) -> torch.Tensor:
    """``y`` (on ``x0 + dx * arange(n)``, last axis) at ``positions`` by linear interpolation."""
    cell, s = _cells(y.shape[-1], positions, x0, dx)
    lo = torch.as_tensor(cell, device=y.device)
    return (y.index_select(-1, lo) * torch.as_tensor(1.0 - s, dtype=y.dtype, device=y.device)
            + y.index_select(-1, lo + 1) * torch.as_tensor(s, dtype=y.dtype, device=y.device))
