"""Non-negative least squares over many right-hand sides, by FISTA.

The same solver as the JAX package (``librosa_tpu/util/_nnls.py``), not
upstream's L-BFGS-B: start from ``max(0, pinv(A) @ B)``, take the step
``1 / L`` with ``L`` the largest eigenvalue of ``A.T @ A`` from 30 power
steps, and run ``n_iter`` rounds of projected gradient with Nesterov's
momentum. Every column of ``B`` is solved at once: each round is one
matrix product ``(n, n) @ (n, k)`` and a few elementwise passes on the
device of ``B``, in full float32 (:func:`exact_f32`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._device import as_tensor, exact_f32
from .exceptions import ParameterError

__all__ = ["nnls"]


def _nnls_fista(A: torch.Tensor, B: torch.Tensor, *, n_iter: int = 300) -> torch.Tensor:
    """``argmin_{x >= 0} ||A x - B||_F`` for ``A`` ``(m, n)`` and ``B`` ``(m, k)``; ``(n, k)``."""
    with exact_f32():
        AtA = A.T @ A
        AtB = A.T @ B
        v = torch.ones(AtA.shape[0], dtype=A.dtype, device=A.device) / np.sqrt(AtA.shape[0])
        for _ in range(30):
            w = AtA @ v
            v = w / (torch.linalg.vector_norm(w) + 1e-30)
        step = 1.0 / (torch.dot(v, AtA @ v) + 1e-12)
        # jnp.linalg.pinv's default cut: 10 * max(m, n) * eps of the largest singular value
        rtol = 10.0 * max(A.shape) * torch.finfo(A.dtype).eps
        x = torch.clamp(torch.linalg.pinv(A, rtol=rtol) @ B, min=0.0)
        y = x
        # the momentum's scalar sequence, in the solver's dtype as the JAX scan carries it
        t = np.asarray(1.0, dtype=np.float32 if A.dtype == torch.float32 else np.float64)
        for _ in range(n_iter):
            grad = torch.addmm(AtB, AtA, y, beta=-1)  # AtA @ y - AtB
            x_new = torch.clamp(y - step * grad, min=0.0)
            t_new = t.dtype.type(0.5) * (1 + np.sqrt(1 + 4 * t * t))
            y = x_new + float((t - 1) / t_new) * (x_new - x)
            x, t = x_new, t_new
    return x


def nnls(A: Any, B: Any, **kwargs: Any) -> torch.Tensor:
    """Non-negative least squares: ``x >= 0`` minimising ``||A x - B||``, for every column of ``B``.

    ``A`` is ``(m, n)``; ``B`` is ``(m,)``, ``(m, k)`` or ``(..., m, k)``
    (leading dims solved together). The result is ``(n,)``, ``(n, k)`` or
    ``(..., n, k)``. ``n_iter`` (default 300) sets the number of FISTA
    rounds. Solutions agree with the JAX package's in objective, not
    elementwise: where ``A`` has a null space the iterates keep the
    rounding of their start there.
    """
    B = as_tensor(B)
    A = as_tensor(A).to(device=B.device)
    if A.ndim != 2:
        raise ParameterError("A must be a 2D matrix")
    if B.dtype != A.dtype:
        dtype = torch.promote_types(A.dtype, B.dtype)
        A, B = A.to(dtype), B.to(dtype)
    n_iter = int(kwargs.pop("n_iter", 300))
    squeeze = B.ndim == 1
    if squeeze:
        B = B[:, None]
    if B.ndim > 2:
        # (..., m, N) -> (m, ... * N), solved as one batch, then back
        lead = B.shape[:-2]
        B2 = B.movedim(-2, 0).reshape(B.shape[-2], -1)
        x = _nnls_fista(A, B2, n_iter=n_iter)
        x = x.reshape((A.shape[1],) + tuple(lead) + (B.shape[-1],)).movedim(0, -2)
    else:
        x = _nnls_fista(A, B, n_iter=n_iter)
    return x[..., 0] if squeeze else x
