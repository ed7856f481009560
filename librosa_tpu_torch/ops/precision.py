"""The precision of a float32 product, as the JAX package's ``precision`` arguments name it.

One argument design serves the two products that take a dial: the basis
projection of the ``stft_mel`` kernel (``ops/fused_stft.py``) and the DFT
products of the ``'matmul'`` route (``ops/fft.py``). :func:`normalize`
takes None or a string that ``jax.lax.Precision(...)`` takes, and gives one
of three settings. Each is written out as explicit arithmetic, so that its
numerics do not depend on a backend flag:

- ``'highest'`` (``'float32'``; None): exact float32 products;
- ``'high'`` (``'bfloat16_3x'``, ``'tensorfloat32'``): each operand splits
  into ``hi = bf16(a)`` and ``lo = bf16(a - hi)``, and a product is
  ``a_hi b_hi + a_hi b_lo + a_lo b_hi``, summed in float32;
- ``'default'`` (``'bfloat16'``, ``'fastest'``): each operand is rounded to
  bfloat16 (to nearest, ties to even) and the products are summed in
  float32.

A product of two bfloat16 values is exact in float32, so the lower settings
lose only the operands' rounding; they are what the settings mean on the TPU
the JAX package was written for. Float64 products stay exact at every
setting.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from .._device import exact_f32

__all__ = ["HIGHEST", "HIGH", "DEFAULT", "normalize", "normalize3", "split_bf16", "matmul"]

HIGHEST, HIGH, DEFAULT = "highest", "high", "default"

_ALIASES = {"default": DEFAULT, "bfloat16": DEFAULT, "fastest": DEFAULT,
            "high": HIGH, "bfloat16_3x": HIGH, "tensorfloat32": HIGH,
            "highest": HIGHEST, "float32": HIGHEST}

#: the mode number csrc/stft_mel.cu takes for each setting
MODES = {HIGHEST: 0, DEFAULT: 1, HIGH: 2}


def normalize(precision: Any) -> str:
    """``'highest'``, ``'high'`` or ``'default'`` for None or a name ``jax.lax.Precision`` takes.

    None means ``'highest'``, as in the JAX package. Anything else raises
    ``ValueError``.
    """
    if precision is None:
        return HIGHEST
    if isinstance(precision, str) and precision in _ALIASES:
        return _ALIASES[precision]
    raise ValueError(f"{precision!r} is not a valid precision: use None or one of "
                     f"{sorted(_ALIASES)}")


def normalize3(precision: Any) -> Tuple[str, str, str]:
    """The ``(stage a, stage b, basis)`` settings of a single value or of a 3-tuple."""
    if isinstance(precision, tuple):
        if len(precision) != 3:
            raise ValueError(f"a precision tuple has 3 entries (stage a, stage b, basis), "
                             f"not {len(precision)}")
        return tuple(normalize(p) for p in precision)
    setting = normalize(precision)
    return setting, setting, setting


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` of float32 ``x``: ``hi = bf16(x)``, ``lo = bf16(x - hi)``, both float32."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def matmul(a: torch.Tensor, b: torch.Tensor, setting: str, *,
           tensor_cores: bool = False) -> torch.Tensor:
    """``a @ b`` at ``setting`` (one of :func:`normalize`'s), float32 out.

    ``'highest'`` is ``torch.matmul`` inside ``exact_f32``. The lower
    settings round or split the operands (:func:`split_bf16`) and run the
    products of the rounded parts; by default as exact float32 products,
    which computes the setting's arithmetic on any device. With
    ``tensor_cores`` and float32 operands on a CUDA device the parts go to
    the card as bfloat16 and each product comes back in float32 from a
    bfloat16 tensor-core product (``torch.mm(..., out_dtype=torch.float32)``,
    float32 accumulation): the same products, summed in another order. No
    ``torch.backends`` flag is left changed.
    """
    if setting == HIGHEST or a.dtype != torch.float32 or b.dtype != torch.float32:
        with exact_f32():
            return torch.matmul(a, b)
    cards = tensor_cores and a.device.type == "cuda"
    if setting == DEFAULT:
        parts = [(_bf16(a), _bf16(b))]
    elif setting == HIGH:
        (a_hi, a_lo), (b_hi, b_lo) = split_bf16(a), split_bf16(b)
        parts = [(a_hi, b_hi), (a_hi, b_lo), (a_lo, b_hi)]
    else:
        raise ValueError(f"unknown precision setting {setting!r}")
    out = None
    for x, w in parts:
        prod = _tensor_core_product(x, w) if cards else _exact(x, w)
        out = prod if out is None else out + prod
    return out


def _exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with exact_f32():
        return torch.matmul(a, b)


def _tensor_core_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bfloat16-valued float32 ``a (..., m, k)`` times ``b (k, n)`` on the card, float32 out."""
    lead = a.shape[:-1]
    out = torch.mm(a.reshape(-1, a.shape[-1]).to(torch.bfloat16), b.to(torch.bfloat16),
                   out_dtype=torch.float32)
    return out.reshape(*lead, b.shape[-1])
