"""Framing of a signal along its last axis."""

from __future__ import annotations

import torch

from ..util.exceptions import ParameterError

__all__ = ["frame_signal", "overlap_add"]


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


def overlap_add(frames: torch.Tensor, *, hop_length: int) -> torch.Tensor:
    """Sum frames ``(..., T, n_fft)`` at a spacing of ``hop_length``: ``(..., n_fft + hop_length * (T - 1))``.

    Sample ``i`` of frame ``t`` lands on output sample ``t * hop_length + i``.
    The output is laid out as rows of ``hop_length`` samples; chunk ``j`` of
    every frame (its samples ``j * hop_length`` and on, one row wide) falls
    on row ``t + j``, so the whole sum is ``ceil(n_fft / hop_length)``
    in-place adds of a column slice of ``frames`` onto shifted rows
    (``Tensor.add_`` on views; neither ``F.fold`` nor ``index_add_``). Any
    hop works, nothing is scattered and no atomics run, so the result is the
    same on every run and device: each output sample sums its frames from
    the latest to the earliest.

    This is the building block of ``ops.ola_norm.ola_norm_reference``, the
    plain version of the synthesis kernel. On the card the inverse STFT of
    float32 input goes through that kernel and does not call this function.
    """
    if hop_length < 1:
        raise ParameterError(f"hop_length={hop_length} must be a positive integer")
    *lead, n_frames, n_fft = frames.shape
    out_len = n_fft + hop_length * (n_frames - 1)
    n_shifts = -(-n_fft // hop_length)
    rows = frames.new_zeros((*lead, n_frames + n_shifts - 1, hop_length))
    for j in range(n_shifts):
        chunk = frames[..., j * hop_length:(j + 1) * hop_length]
        rows[..., j:j + n_frames, :chunk.shape[-1]] += chunk
    return rows.reshape(*lead, -1)[..., :out_len]
