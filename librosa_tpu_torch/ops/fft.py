"""Power spectra of framed signals."""

from __future__ import annotations

import torch

__all__ = ["frames_power_spectrum"]


def frames_power_spectrum(frames: torch.Tensor) -> torch.Tensor:
    """``|rfft(frames)|**2`` over the last axis: ``(..., T, 1 + n_fft // 2)``.

    ``frames`` are already windowed. The transform is ``torch.fft.rfft``
    (cuFFT on the card, pocketfft on the CPU).
    """
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real.square() + spec.imag.square()
