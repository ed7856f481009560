"""Harmonic interpolation along the frequency axis: a gather and a linear blend on the device.

``interp_harmonics`` samples a spectrum at multiples of its bin
frequencies, ``salience`` sums those samples with weights, and
``f0_harmonics`` samples each frame at multiples of its own fundamental.
Linear and nearest interpolation are ``torch.searchsorted`` plus gathers on
the input's device, in the input's precision; other kinds go to scipy's
``interp1d`` on the host, as in the JAX package.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from .._device import as_tensor
from ..util import utils as util
from ..util.exceptions import ParameterError

__all__ = ["salience", "interp_harmonics", "f0_harmonics"]


def _real_dtype(x: torch.Tensor) -> torch.dtype:
    return x.real.dtype if x.is_complex() else x.dtype


def _interp(xq: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor, fill_value: float,
            kind: str) -> torch.Tensor:
    """Interpolate rows ``fp`` ``(B, F)`` sampled at ascending ``xp`` (``(F,)`` or ``(B, F)``) at ``xq``.

    ``xq`` is ``(Q,)`` or ``(B, Q)``; the result ``(B, Q)``. Outside
    ``[xp[0], xp[-1]]`` it is ``fill_value``.
    """
    B, n = fp.shape
    xp2 = xp.expand(B, n).contiguous()
    xq2 = xq.expand(B, xq.shape[-1]).contiguous()
    i = (torch.searchsorted(xp2, xq2, right=True) - 1).clamp(0, n - 2)
    x0, x1 = xp2.gather(1, i), xp2.gather(1, i + 1)
    w = (xq2 - x0) / torch.where(x1 == x0, torch.ones_like(x1), x1 - x0)
    if kind == "linear":
        out = fp.gather(1, i) * (1 - w) + fp.gather(1, i + 1) * w
    else:
        out = fp.gather(1, torch.where(w < 0.5, i, i + 1))
    in_range = (xq2 >= xp2[:, :1]) & (xq2 <= xp2[:, -1:])
    return torch.where(in_range, out, torch.full_like(out, fill_value))


def _check_freqs(freqs: np.ndarray, x: torch.Tensor, axis: int) -> None:
    if freqs.ndim == 1 and len(freqs) == x.shape[axis]:
        if not bool(np.all(np.diff(freqs) != 0)):
            warnings.warn("Frequencies are not unique. This may produce incorrect "
                          "harmonic interpolations.", stacklevel=3)
    elif freqs.shape != tuple(x.shape):
        raise ParameterError(
            f"freqs.shape={freqs.shape} is incompatible with input shape={tuple(x.shape)}")


def interp_harmonics(x: Any, *, freqs: Any, harmonics: Any, kind: str = "linear",
                     fill_value: float = 0, axis: int = -2) -> torch.Tensor:
    """``x`` sampled at ``harmonics[h] * freqs[f]`` along ``axis``: ``(..., H, F, T)`` for ``axis=-2``.

    ``freqs`` gives each bin's frequency, one row for all frames or, with
    ``x``'s shape, one per frame. Out of range gives ``fill_value``.
    """
    x = as_tensor(x)
    freqs = util._host(freqs)
    harmonics = np.asarray(harmonics, dtype=float)
    if kind not in ("linear", "nearest"):
        import scipy.interpolate

        f_interp = scipy.interpolate.interp1d(freqs, util._host(x), axis=axis, bounds_error=False,
                                              copy=False, kind=kind, fill_value=fill_value)
        return torch.as_tensor(f_interp(np.multiply.outer(harmonics, freqs)), device=x.device)
    _check_freqs(freqs, x, axis)
    rdt = _real_dtype(x)
    if freqs.ndim == 1:
        axis = axis - x.ndim if axis >= 0 else axis
        xp = torch.as_tensor(freqs, dtype=rdt, device=x.device)
        xm = x.transpose(axis, -1)
        flat = xm.reshape(-1, xm.shape[-1])
        outs = [_interp(float(h) * xp, xp, flat, fill_value, kind).reshape(xm.shape)
                for h in harmonics]
        out = torch.stack(outs, dim=0).transpose(axis, -1)  # (H, ...) with F back at axis
        return out.movedim(0, axis - 1)
    xm = x.transpose(axis, -1)
    fm = torch.as_tensor(freqs, dtype=rdt, device=x.device).transpose(axis, -1)
    lead, n = xm.shape[:-1], xm.shape[-1]
    flat_f = fm.reshape(-1, n)
    hj = torch.as_tensor(harmonics, dtype=rdt, device=x.device)
    tq = (flat_f[:, :, None] * hj).reshape(flat_f.shape[0], -1)  # (B, F * H)
    out = _interp(tq, flat_f, xm.reshape(-1, n), fill_value, kind)
    out = out.reshape(*lead, n, len(harmonics)).transpose(-2, axis)
    return out.transpose(-1, axis - 1)


def _strict_peaks(S: torch.Tensor, axis: int) -> torch.Tensor:
    """Local maxima along ``axis`` that are strictly above both neighbours."""
    Sm = S.movedim(axis, -1)
    right = torch.cat([Sm[..., :-1] > Sm[..., 1:], torch.zeros_like(Sm[..., :1], dtype=torch.bool)],
                      dim=-1)
    return util.localmax(S, axis=axis) & right.movedim(-1, axis)


def salience(S: Any, *, freqs: Any, harmonics: Sequence[float], weights: Optional[Any] = None,
             aggregate: Optional[Callable] = None, filter_peaks: bool = True,
             fill_value: float = np.nan, kind: str = "linear", axis: int = -2) -> torch.Tensor:
    """Harmonic salience: the weighted mean of ``S`` over ``harmonics``, same shape as ``S``.

    ``aggregate`` (default the weighted average) folds the harmonics;
    ``filter_peaks`` keeps only bins that are strict peaks of ``S`` along
    ``axis`` and sets the rest to ``fill_value``.
    """
    aggregate = np.average if aggregate is None else aggregate
    weights = np.ones(len(harmonics)) if weights is None else np.array(weights, dtype=float)
    S = as_tensor(S)
    S_harm = interp_harmonics(S, freqs=freqs, harmonics=harmonics, kind=kind, axis=axis)
    if aggregate is np.average:
        w = util.expand_to(torch.as_tensor(weights, dtype=_real_dtype(S_harm), device=S.device),
                           ndim=S_harm.ndim, axes=(axis - 1) % S_harm.ndim)
        S_sal = (S_harm * w).sum(dim=axis - 1) / w.sum()
    else:
        S_sal = as_tensor(aggregate(util._host(S_harm), axis=axis - 1)).to(S.device)
    if filter_peaks:
        S_sal = torch.where(_strict_peaks(S, axis), S_sal, torch.full_like(S_sal, fill_value))
    return S_sal


def f0_harmonics(x: Any, *, f0: Any, freqs: Any, harmonics: Any, kind: str = "linear",
                 fill_value: float = 0, axis: int = -2) -> torch.Tensor:
    """``x`` sampled at ``harmonics[h] * f0[t]`` in each frame ``t``: ``(..., H, T)`` for ``axis=-2``.

    ``freqs`` gives each bin's frequency (non-finite ones are skipped), one
    row for all frames or one per frame.
    """
    x = as_tensor(x)
    freqs_np = util._host(freqs).astype(float)
    if kind not in ("linear", "nearest"):
        raise ParameterError(f"kind={kind} interpolation is not supported on device; "
                             "use 'linear' or 'nearest'")
    rdt = _real_dtype(x)
    f0 = torch.as_tensor(util._host(f0), dtype=rdt, device=x.device)
    hj = torch.as_tensor(np.asarray(harmonics, dtype=float), dtype=rdt, device=x.device)
    xm = x.transpose(axis, -1)
    lead = xm.shape[:-1]
    if freqs_np.ndim == 1 and len(freqs_np) == x.shape[axis]:
        finite = np.isfinite(freqs_np)
        order = np.argsort(freqs_np[finite])
        sel = torch.as_tensor(np.flatnonzero(finite)[order], device=x.device)
        xp = torch.as_tensor(freqs_np[finite][order], dtype=rdt, device=x.device)
        rows = xm.index_select(-1, sel).reshape(-1, len(order))
    elif freqs_np.shape == tuple(x.shape):
        fm = torch.as_tensor(freqs_np, dtype=rdt, device=x.device).transpose(axis, -1)
        key = fm.reshape(-1, fm.shape[-1])
        key = torch.where(torch.isfinite(key), key, torch.full_like(key, float("inf")))
        key, order = key.sort(dim=-1, stable=True)
        xp, rows = key, xm.reshape(-1, xm.shape[-1]).gather(1, order)
    else:
        raise ParameterError(
            f"freqs.shape={freqs_np.shape} is incompatible with input shape={tuple(x.shape)}")
    targets = f0.expand(lead).reshape(-1, 1) * hj  # (B, H)
    out = _interp(targets, xp, rows, fill_value, kind).reshape(*lead, len(hj))
    return torch.nan_to_num(out.transpose(-1, axis), nan=fill_value)
