"""Array helpers used by the feature code (torch tensors, numpy scalars)."""

from __future__ import annotations

from typing import Any, Sequence, Union

import numpy as np
import torch

from .exceptions import ParameterError

__all__ = ["tiny", "expand_to"]


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
