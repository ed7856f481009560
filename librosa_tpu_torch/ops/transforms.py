"""Dense transform matrices built on the host in float64.

The MFCC's DCT runs as one matrix product on the card against the matrix
made here, and the ``'matmul'`` backend of ``ops.fft`` runs the framed DFT
against :func:`dft_matrices`.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

__all__ = ["dct_matrix", "dft_matrices"]


@functools.lru_cache(maxsize=64)
def dct_matrix(n: int, *, dct_type: int = 2, norm: Optional[str] = "ortho") -> np.ndarray:
    """Matrix ``C`` (float32, ``(n, n)``) with ``C @ x == scipy.fft.dct(x, dct_type, norm=norm)``.

    Types 1, 2 and 3; ``norm`` is ``'ortho'`` or ``None``. Read-only.
    """
    if norm not in (None, "ortho"):
        raise ValueError(f"Unsupported DCT norm: {norm}")
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    if dct_type == 2:
        C = 2.0 * np.cos(np.pi * k * (2 * m + 1) / (2 * n))
        if norm == "ortho":
            C *= np.sqrt(1.0 / (2 * n))
            C[0] *= np.sqrt(0.5)
    elif dct_type == 3:
        scale = np.sqrt(2.0 / n) if norm == "ortho" else 2.0
        C = scale * np.cos(np.pi * (2 * k + 1) * m / (2 * n))
        C[:, 0] = np.sqrt(1.0 / n) if norm == "ortho" else 1.0
    elif dct_type == 1:
        if n < 2:
            raise ValueError("DCT-I requires n >= 2")
        C = 2.0 * np.cos(np.pi * k * m / (n - 1))
        C[:, 0] = 1.0
        C[:, -1] = (-1.0) ** k[:, 0]
        if norm == "ortho":
            s = np.ones(n)
            s[0] = s[-1] = np.sqrt(0.5)
            C = C * s[None, :] * s[:, None] * np.sqrt(0.5 / (n - 1))
    else:
        raise ValueError(f"Unsupported DCT type: {dct_type}")
    C = C.astype(np.float32)
    C.setflags(write=False)
    return C


@functools.lru_cache(maxsize=16)
def dft_matrices(n_fft: int, *, dtype: str = "float32") -> tuple:
    """``(C, S)``, each ``(1 + n_fft // 2, n_fft)`` of ``dtype``, with
    ``rfft(x) == C @ x - 1j * (S @ x)``. Read-only."""
    k = np.arange(1 + n_fft // 2)[:, None]
    t = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * t / n_fft
    C, S = np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)
    C.setflags(write=False)
    S.setflags(write=False)
    return C, S
