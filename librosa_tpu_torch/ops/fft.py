"""Spectra of framed signals, and the switch between two routes for the framed DFT.

- ``'fft'``: ``torch.fft.rfft`` (cuFFT on the card, pocketfft on the CPU).
- ``'matmul'``: two products against the cosine and sine matrices of
  :func:`~librosa_tpu_torch.ops.transforms.dft_matrices`, in exact float32.

``'auto'``, the default, resolves to ``'fft'`` on CUDA and on the CPU, as the
JAX package resolves it off a TPU. The backend also picks the arithmetic of
two functions, as in the JAX package: under ``'matmul'``
``resample(res_type='fft')`` transforms lengths other than powers of two
through :mod:`~librosa_tpu_torch.ops.ctfft`, and ``autocorrelate`` pads to a
power of two. The JAX package's ``chroma_stft`` and ``_spectrogram`` take
its Pallas kernel only under ``'matmul'``; the port routes those calls to
its ``stft_mel`` kernel by ``kernel_refusal`` whatever the backend.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .._device import device_table, exact_f32, get_device
from .transforms import dft_matrices

__all__ = ["set_stft_backend", "get_stft_backend", "dft_mats_device", "frames_rdft",
           "frames_power_spectrum"]

_BACKEND = "auto"  # 'auto' | 'fft' | 'matmul'


def set_stft_backend(backend: str, *, precision: Optional[str] = None) -> None:
    """Select the framed-DFT route: ``'auto'`` (``'fft'`` here), ``'fft'`` or ``'matmul'``.

    ``precision`` is that of the ``'matmul'`` route's products. The port
    keeps them exact float32 (no TF32), so only None and ``'highest'`` are
    accepted.
    """
    global _BACKEND
    if backend not in ("auto", "fft", "matmul"):
        raise ValueError(f"Unknown stft backend: {backend}")
    if precision not in (None, "highest"):
        raise ValueError(f"Unsupported matmul precision: {precision!r}; "
                         "the port's products are exact float32 ('highest')")
    _BACKEND = backend


def get_stft_backend() -> str:
    """The backend as last set (``'auto'``, ``'fft'`` or ``'matmul'``), unresolved."""
    return _BACKEND


def _resolved_backend() -> str:
    return "fft" if _BACKEND == "auto" else _BACKEND


def dft_mats_device(n_fft: int, dtype: torch.dtype, device: Any = None) -> tuple:
    """``(C.T, S.T)`` of :func:`~librosa_tpu_torch.ops.transforms.dft_matrices`, each
    ``(n_fft, 1 + n_fft // 2)``, kept on ``device`` (default: the package's) in ``dtype``."""
    device = get_device() if device is None else torch.device(device)
    C, S = dft_matrices(n_fft, dtype="float64")
    return (device_table(("dft_cos_t", n_fft), lambda: C.T, device, dtype),
            device_table(("dft_sin_t", n_fft), lambda: S.T, device, dtype))


def _dft_products(frames: torch.Tensor) -> tuple:
    Ct, St = dft_mats_device(frames.shape[-1], frames.dtype, frames.device)
    with exact_f32():
        return torch.matmul(frames, Ct), torch.matmul(frames, St)


def frames_rdft(frames: torch.Tensor) -> torch.Tensor:
    """``rfft(frames)`` over the last axis: complex ``(..., T, 1 + n_fft // 2)``.

    ``frames`` are real and already windowed.
    """
    if _resolved_backend() == "matmul":
        re, im = _dft_products(frames)
        return torch.complex(re, -im)
    return torch.fft.rfft(frames, dim=-1)


def frames_power_spectrum(frames: torch.Tensor) -> torch.Tensor:
    """``|rfft(frames)|**2`` over the last axis: ``(..., T, 1 + n_fft // 2)``.

    ``frames`` are real and already windowed.
    """
    if _resolved_backend() == "matmul":
        re, im = _dft_products(frames)
        return re * re + im * im
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real.square() + spec.imag.square()
