"""Complex FFTs of any length as a two-stage Cooley-Tukey decomposition into matrix products.

For ``n = n1 * n2``::

    X[n2 k1 + k2] = sum_{t1} W_{n1}^{t1 k1} W_n^{t1 k2} sum_{t2} x[t1 + n1 t2] W_{n2}^{t2 k2}

that is one product with the ``(n2, n2)`` DFT matrix, a twiddle, and one
product with the ``(n1, n1)`` matrix: ``n (n1 + n2)`` complex
multiply-adds and two small tables. Powers of two go to ``torch.fft``; a
prime ``n`` factors as ``(1, n)``, the dense DFT. The JAX package needs this
because its TPU lowers other lengths to a dense DFT; here it is the
``'matmul'`` backend's route (:func:`~librosa_tpu_torch.ops.fft.set_stft_backend`)
for ``resample(res_type='fft')``. The products run in complex64 (complex128
for such input) inside :func:`~librosa_tpu_torch._device.exact_f32`.
"""

from __future__ import annotations

import functools
from typing import Any, Tuple

import numpy as np
import torch

from .._device import as_tensor, device_table, exact_f32

__all__ = ["fft_arbitrary", "ifft_arbitrary", "good_fft_factor"]


def good_fft_factor(n: int) -> Tuple[int, int]:
    """``(n1, n2)`` with ``n1 * n2 == n`` and ``n1 <= n2`` as close as they come; ``(1, n)``
    for a prime."""
    for d in range(int(np.sqrt(n)), 0, -1):
        if n % d == 0:
            return d, n // d
    return 1, n


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@functools.lru_cache(maxsize=32)
def _ct_tables(n: int) -> Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]:
    """``(n1, n2, W2 [t2, k2], twiddle [k2, t1], W1 [t1, k1])`` in complex128, read-only."""
    n1, n2 = good_fft_factor(n)
    w2 = np.exp(-2j * np.pi / n2 * np.outer(np.arange(n2), np.arange(n2)))
    tw = np.exp(-2j * np.pi / n * np.outer(np.arange(n2), np.arange(n1)))
    w1 = np.exp(-2j * np.pi / n1 * np.outer(np.arange(n1), np.arange(n1)))
    for table in (w2, tw, w1):
        table.setflags(write=False)
    return n1, n2, w2, tw, w1


def _ct_fft_core(x: torch.Tensor, *, n: int, inverse: bool) -> torch.Tensor:
    """Complex DFT of the composite length ``n`` over the last axis of complex ``x``."""
    n1, n2, w2, tw, w1 = _ct_tables(n)
    W2, TW, W1 = (device_table(("ctfft", n, name, inverse),
                               lambda t=t: np.conj(t) if inverse else t, x.device, x.dtype)
                  for name, t in (("w2", w2), ("twiddle", tw), ("w1", w1)))
    lead = x.shape[:-1]
    with exact_f32():
        # x[t1 + n1 t2] as [..., t2, t1]; stage A over t2 gives [..., k2, t1]
        A = torch.matmul(W2.transpose(0, 1), x.reshape(*lead, n2, n1)) * TW
        # stage B over t1 gives [..., k2, k1]; bin k = n2 k1 + k2
        X = torch.matmul(A, W1)
    X = X.transpose(-2, -1).reshape(*lead, n)
    return X / n if inverse else X


def _complex_input(x: Any, n: int) -> torch.Tensor:
    x = as_tensor(x)
    if x.shape[-1] != n:
        raise ValueError("length mismatch")
    return x


def fft_arbitrary(x: Any, n: int) -> torch.Tensor:
    """Complex FFT of length ``n`` (``x.shape[-1]``) over the last axis.

    ``torch.fft.fft`` for a power of two; otherwise the two-stage
    decomposition in complex64, or complex128 for complex128 input.
    """
    x = _complex_input(x, n)
    if _is_pow2(n):
        return torch.fft.fft(x, dim=-1)
    x = x.to(torch.complex128 if x.dtype == torch.complex128 else torch.complex64)
    return _ct_fft_core(x, n=n, inverse=False)


def ifft_arbitrary(x: Any, n: int) -> torch.Tensor:
    """Inverse of :func:`fft_arbitrary`: conjugate tables and the ``1 / n`` scale."""
    x = _complex_input(x, n)
    if _is_pow2(n):
        return torch.fft.ifft(x, dim=-1)
    x = x.to(torch.complex128 if x.dtype == torch.complex128 else torch.complex64)
    return _ct_fft_core(x, n=n, inverse=True)
