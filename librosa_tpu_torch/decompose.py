"""Spectrogram decompositions: harmonic-percussive separation by median filtering.

Only :func:`hpss` so far. Its two median filters run as the median_filter
kernel on the card (``ops/median.py``); the masks are elementwise torch ops
that keep the spectrogram's layout.
"""

from __future__ import annotations

from typing import Any, Tuple, Union

import torch

from ._device import as_tensor
from .core.spectrum import magphase
from .ops import median as _med
from .util.exceptions import ParameterError
from .util.utils import _pair, _softmask_core

__all__ = ["hpss"]


def hpss(
    S: Any,
    *,
    kernel_size: Union[int, Tuple[int, int]] = 31,
    power: float = 2.0,
    mask: bool = False,
    margin: Union[float, Tuple[float, float]] = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Harmonic and percussive parts ``(H, P)`` of a spectrogram ``S`` ``(..., d, n)``.

    A median filter along time (``kernel_size[0]`` frames) keeps what is
    steady in pitch, one along frequency (``kernel_size[1]`` bins) what is
    steady in time. Each part is ``S`` times its soft mask
    (:func:`~librosa_tpu_torch.util.softmask` of one filtered spectrogram
    against the other times ``margin``, at ``power``; ``np.inf`` gives hard
    masks). Margins above 1 leave a residual that neither part takes; with
    both margins 1 a cell where both filters are zero goes half to each
    part. A complex ``S`` is split into magnitude and phase and the parts
    get the phase back. ``mask=True`` returns the masks instead.
    """
    S = as_tensor(S)
    win_harm, win_perc = _pair(kernel_size, "kernel_size")
    margin_harm, margin_perc = _pair(margin, "margin")
    if margin_harm < 1 or margin_perc < 1:
        raise ParameterError("Margins must be >= 1.0. A typical range is between 1 and 10.")
    return _hpss_core(S, win_harm=int(win_harm), win_perc=int(win_perc), power=float(power),
                      margin_harm=float(margin_harm), margin_perc=float(margin_perc),
                      mask=bool(mask))


def _median(S: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """The sliding median: the kernel where its predicate takes the call, else the plain version."""
    if _med.kernel_refusal(S, size, axis) is None:
        return _med.median_filter_1d(S, size=size, axis=axis)
    return _med.median_filter_reference(S, size=size, axis=axis)


def _hpss_core(S: torch.Tensor, *, win_harm: int, win_perc: int, power: float,
               margin_harm: float, margin_perc: float,
               mask: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    phase = None
    if S.is_complex():
        S, phase = magphase(S)
    harm = _median(S, win_harm, -1)
    perc = _median(S, win_perc, -2)
    split_zeros = margin_harm == 1 and margin_perc == 1
    mask_harm = _softmask_core(harm, perc * margin_harm, power=power, split_zeros=split_zeros)
    mask_perc = _softmask_core(perc, harm * margin_perc, power=power, split_zeros=split_zeros)
    if mask:
        return mask_harm, mask_perc
    if phase is None:
        return S * mask_harm, S * mask_perc
    return (S * mask_harm) * phase, (S * mask_perc) * phase
