"""Spectra of framed signals."""

from __future__ import annotations

import torch

__all__ = ["frames_rdft", "frames_power_spectrum"]


def frames_rdft(frames: torch.Tensor) -> torch.Tensor:
    """``rfft(frames)`` over the last axis: complex ``(..., T, 1 + n_fft // 2)``.

    ``frames`` are already windowed. The transform is ``torch.fft.rfft``
    (cuFFT on the card, pocketfft on the CPU).
    """
    return torch.fft.rfft(frames, dim=-1)


def frames_power_spectrum(frames: torch.Tensor) -> torch.Tensor:
    """``|rfft(frames)|**2`` over the last axis: ``(..., T, 1 + n_fft // 2)``.

    ``frames`` are already windowed; the transform is :func:`frames_rdft`.
    """
    spec = frames_rdft(frames)
    return spec.real.square() + spec.imag.square()
