"""First-order IIR filtering along an axis: ``y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1]``.

The recurrence ``y[n] = a y[n-1] + c[n]`` (``a = -a1``) composes affine
maps, which compose associatively, so it runs as a scan of ``log2(n)``
doubling steps over the whole axis (Hillis-Steele), each a few torch ops
on the input's device: no loop over samples. The JAX package runs the same
composition as a ``lax.associative_scan`` (``librosa_tpu/ops/iir.py:40``);
the two sum in different orders and agree to float rounding.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from .._device import as_tensor

__all__ = ["first_order_filter"]


def first_order_filter(x: Any, *, b0: float, b1: float, a1: float, zi: Any,
                       axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter ``x`` along ``axis``; return ``(y, zf)`` with scipy's delay state.

    ``zi`` has ``x``'s shape without ``axis`` (or broadcasts to it): ``y[0]
    = b0 x[0] + zi``. ``zf = b1 x[-1] - a1 y[-1]`` continues the stream.
    """
    x = as_tensor(x).movedim(axis, -1)
    zi = torch.as_tensor(zi, dtype=x.dtype, device=x.device)
    if zi.ndim < x.ndim:
        zi = zi.unsqueeze(-1)
    c = torch.cat([b0 * x[..., :1] + zi, b0 * x[..., 1:] + b1 * x[..., :-1]], dim=-1)
    if a1 != 0.0:
        n = c.shape[-1]
        a = torch.full_like(c, -a1)
        shift = 1
        while shift < n:
            # after this step, (a[i], c[i]) compose the maps of samples i - 2 * shift + 1 .. i
            c = torch.cat([c[..., :shift], c[..., shift:] + a[..., shift:] * c[..., :-shift]], -1)
            a = torch.cat([a[..., :shift], a[..., shift:] * a[..., :-shift]], -1)
            shift *= 2
    zf = b1 * x[..., -1] - a1 * c[..., -1]
    return c.movedim(-1, axis), zf
