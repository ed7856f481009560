"""Framing of a signal along its last axis."""

from __future__ import annotations

import torch

from ..util.exceptions import ParameterError

__all__ = ["frame_signal"]


def frame_signal(y: torch.Tensor, *, frame_length: int, hop_length: int) -> torch.Tensor:
    """Frames of ``y`` as ``(..., n_frames, frame_length)``.

    A view made by ``Tensor.unfold``: frame ``t`` starts at sample
    ``t * hop_length``, and samples after the last whole frame are dropped.
    """
    n = y.shape[-1]
    if n < frame_length:
        raise ParameterError(
            f"Input is too short (n={n:d}) for frame_length={frame_length:d}"
        )
    return y.unfold(-1, frame_length, hop_length)
