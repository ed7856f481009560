"""Spectra of framed signals, and the switch between two routes for the framed DFT.

- ``'fft'``: ``torch.fft.rfft`` (cuFFT on the card, pocketfft on the CPU).
- ``'matmul'``: two products against the cosine and sine matrices of
  :func:`~librosa_tpu_torch.ops.transforms.dft_matrices`, at the precision
  that :func:`set_stft_backend` stores (exact float32 unless asked;
  :mod:`~librosa_tpu_torch.ops.precision` says what the lower settings
  compute).

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

from .._device import device_table, get_device
from . import precision as _precision
from .transforms import dft_matrices

__all__ = ["set_stft_backend", "get_stft_backend", "get_matmul_precision", "dft_mats_device",
           "frames_rdft", "frames_power_spectrum", "power_spectrum_at"]

_BACKEND = "auto"  # 'auto' | 'fft' | 'matmul'
_PRECISION = _precision.HIGHEST  # of the 'matmul' route's products


def set_stft_backend(backend: str, *, precision: Optional[str] = None) -> None:
    """Select the framed-DFT route: ``'auto'`` (``'fft'`` here), ``'fft'`` or ``'matmul'``.

    ``precision`` is that of the ``'matmul'`` route's two products: a name
    that ``jax.lax.Precision`` takes (``'highest'``, ``'high'``,
    ``'default'`` and their aliases, :func:`~librosa_tpu_torch.ops.precision.normalize`).
    It is kept as module state, as in the JAX package; None keeps the
    setting already stored, which starts as ``'highest'`` (exact float32).
    On a CUDA device the lower settings run bfloat16 tensor-core products
    with float32 results; elsewhere the same rounded operands run through
    exact float32 products. A name the JAX package does not take raises
    ``ValueError`` and changes nothing.
    """
    global _BACKEND, _PRECISION
    if backend not in ("auto", "fft", "matmul"):
        raise ValueError(f"Unknown stft backend: {backend}")
    setting = None if precision is None else _precision.normalize(precision)
    _BACKEND = backend
    if setting is not None:
        _PRECISION = setting


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


def get_matmul_precision() -> str:
    """The ``'matmul'`` route's setting: ``'highest'``, ``'high'`` or ``'default'``."""
    return _PRECISION


def _dft_products(frames: torch.Tensor, setting: str) -> tuple:
    Ct, St = dft_mats_device(frames.shape[-1], frames.dtype, frames.device)
    return tuple(_precision.matmul(frames, M, setting, tensor_cores=True) for M in (Ct, St))


def frames_rdft(frames: torch.Tensor) -> torch.Tensor:
    """``rfft(frames)`` over the last axis: complex ``(..., T, 1 + n_fft // 2)``.

    ``frames`` are real and already windowed.
    """
    if _resolved_backend() == "matmul":
        re, im = _dft_products(frames, _PRECISION)
        return torch.complex(re, -im)
    return torch.fft.rfft(frames, dim=-1)


def frames_power_spectrum(frames: torch.Tensor) -> torch.Tensor:
    """``|rfft(frames)|**2`` over the last axis: ``(..., T, 1 + n_fft // 2)``.

    ``frames`` are real and already windowed.
    """
    return power_spectrum_at(frames, _PRECISION)


def power_spectrum_at(frames: torch.Tensor, setting: str) -> torch.Tensor:
    """:func:`frames_power_spectrum` with the ``'matmul'`` route's products at ``setting``."""
    if _resolved_backend() == "matmul":
        re, im = _dft_products(frames, setting)
        return re * re + im * im
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.real.square() + spec.imag.square()
