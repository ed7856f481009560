"""pYIN's trough priors: the CUDA kernel behind ``core/pitch.py:_pyin_trough_probs`` and its plain version.

:func:`trough_priors` takes the difference function ``yin`` ``(..., P, T)``,
its trough mask (bool, same shape), pYIN's thresholds and beta masses, the
Boltzmann parameter and ``no_trough_prob``, and returns the prior mass of
each period candidate ``(..., P, T)``: for each threshold, the troughs below
it share its beta mass by a Boltzmann law over their order; where none is
below, ``no_trough_prob`` of that mass goes to the lowest trough. It is the
JAX package's ``_pyin_trough_probs`` (``librosa_tpu/core/pitch.py:773``).

On a CUDA tensor it launches the hand-written kernel of
``csrc/trough_priors.cu`` (one warp a frame, one pass; built for ``sm_90a``
at first use by ``ops/_build.py``) where :func:`kernel_refusal` gives no
reason, and raises otherwise; on a CPU tensor it runs
:func:`trough_priors_reference`, the plain loop over thresholds. Both give
the same bits: the kernel compares, rounds and adds in the loop's order, and
takes its exponentials from tables that the loop's own torch ops make
(:func:`_pmf_tables`, once per configuration and device).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import device_object, device_table
from ..util.exceptions import ParameterError
from . import _build

__all__ = ["trough_priors", "trough_priors_reference", "kernel_refusal", "launches"]

_SMEM_LIMIT = 232448 - 1024  # dynamic shared memory a block may ask for
_MAX_GRID = 2**31 - 1
_DTYPES = (torch.float32, torch.float64)

#: Kernel launches so far: one per launch of the kernel on the card.
launches = 0


def _one_warp_smem(P: int, K: int, itemsize: int) -> int:
    """Shared memory of the kernel's smallest block, one warp: the thresholds and beta masses,
    a column of ``P`` values, counts by threshold, a queue of 64 lags and ``P`` flags. The
    ``.cu``'s launch gives a block as many warps, of 8, as fit."""
    return itemsize * (2 * K + P) + 4 * (2 * K + 64) + P


def kernel_refusal(yin: torch.Tensor, is_trough: torch.Tensor, thresholds: np.ndarray,
                   beta_probs: np.ndarray) -> Optional[str]:
    """Why the CUDA kernel does not take this call, or None if it does.

    :func:`trough_priors` raises with this reason on a CUDA tensor.
    """
    if yin.dtype not in _DTYPES:
        return f"the trough priors kernel takes float32 or float64 yin, not {yin.dtype}"
    if is_trough.dtype != torch.bool:
        return f"the trough priors kernel takes a bool trough mask, not {is_trough.dtype}"
    if yin.ndim < 2 or is_trough.shape != yin.shape:
        return ("the trough priors kernel takes yin (..., lags, frames) and a trough mask of "
                "its shape")
    if is_trough.device != yin.device:
        return "the trough priors kernel takes yin and the trough mask on one device"
    P, T = yin.shape[-2:]
    if P < 1:
        return "the trough priors kernel takes at least one lag"
    thresholds = np.asarray(thresholds, dtype=np.float64)
    K = len(thresholds) - 1
    if K < 0 or len(beta_probs) < K:
        return "the trough priors kernel takes a beta mass for each threshold after the first"
    if K > 1 and not np.all(np.diff(_np_dtype(yin.dtype)(thresholds[1:])) >= 0):
        return "the trough priors kernel takes thresholds in ascending order"
    smem = _one_warp_smem(P, K, yin.element_size())
    if smem > _SMEM_LIMIT:
        return (f"the trough priors kernel takes {P} lags with {K} thresholds in "
                f"{smem} bytes of shared memory, above {_SMEM_LIMIT}")
    if math.prod(yin.shape[:-2]) * T > _MAX_GRID:
        return "the trough priors kernel takes fewer than 2**31 frames"
    return None


def trough_priors_reference(yin_frames: torch.Tensor, is_trough: torch.Tensor,
                            thresholds: np.ndarray, beta_probs: np.ndarray,
                            boltzmann_parameter: float, no_trough_prob: float) -> torch.Tensor:
    """The plain PyTorch version of :func:`trough_priors`, one threshold at a time, on
    ``yin_frames``' device."""
    a = boltzmann_parameter
    scale = float(1 - np.exp(-a))
    yin_probs = torch.zeros_like(yin_frames)
    empty_mass = torch.zeros_like(yin_frames[..., :1, :])
    for k in range(len(thresholds) - 1):
        below = is_trough & (yin_frames < float(thresholds[k + 1]))
        rank = below.cumsum(dim=-2, dtype=torch.int32) - 1
        n_below = below.sum(dim=-2, keepdim=True, dtype=torch.int32)
        pmf = (torch.exp(-a * rank.to(yin_frames.dtype)) * scale
               / (1 - torch.exp(-a * n_below.clamp_min(1).to(yin_frames.dtype))))
        beta = float(beta_probs[k])
        yin_probs += torch.where(below, pmf, 0.0) * beta
        empty_mass += torch.where(n_below == 0, beta, 0.0)
    lowest = torch.where(is_trough, yin_frames, float("inf")).argmin(dim=-2, keepdim=True)
    empty_mass = torch.where(is_trough.any(dim=-2, keepdim=True), empty_mass, 0.0)
    return yin_probs.scatter_add(-2, lowest, no_trough_prob * empty_mass)


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _pmf_tables(a: float, P: int, dtype: torch.dtype,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(num, den)``: ``exp(-a r) (1 - exp(-a))`` and ``1 - exp(-a max(n, 1))`` for
    ``r, n = 0 .. P`` in ``dtype`` on ``device``, made by the plain loop's torch ops, so with
    its bits. Once per configuration and device."""

    def make(dev):
        r = torch.arange(P + 1, dtype=dtype, device=dev)
        return (torch.exp(-a * r) * float(1 - np.exp(-a)),
                1 - torch.exp(-a * r.clamp_min(1)))

    return device_object(("pyin_trough_pmf", float(a), int(P), dtype), make, device)


def _empty_prefix(beta: np.ndarray, dtype: torch.dtype, rounding: torch.dtype) -> np.ndarray:
    """Prefix sums of the beta masses as the plain loop adds its empty mass: each mass as
    ``torch.where`` makes a tensor of a Python float (``rounding``, the default dtype), added
    in ``dtype`` in ascending order. Entry k is the mass of the thresholds before k."""
    acc_type, round_type = _np_dtype(dtype), _np_dtype(rounding)
    out = np.zeros(len(beta) + 1, acc_type)
    acc = acc_type(0)
    for k, b in enumerate(beta):
        acc = acc_type(acc + acc_type(round_type(b)))
        out[k + 1] = acc
    return out


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("trough_priors")
    if lib.trough_priors_launch.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.trough_priors_launch.argtypes = ([i32, p, p] + [i64] * 11 + [i32] * 2 + [p] * 5
                                             + [ctypes.c_double, p, p])
        lib.trough_priors_launch.restype = ctypes.c_int
    return lib


def trough_priors(yin_frames: torch.Tensor, is_trough: torch.Tensor, thresholds: np.ndarray,
                  beta_probs: np.ndarray, boltzmann_parameter: float,
                  no_trough_prob: float) -> torch.Tensor:
    """Prior mass of each period candidate ``(..., P, T)`` from the difference function
    ``yin_frames`` and its trough mask ``is_trough``.

    ``thresholds`` are pYIN's ``n_thresholds + 1`` sorted thresholds and
    ``beta_probs`` the beta mass of each after the first. On a CUDA tensor
    this launches the kernel where :func:`kernel_refusal` gives no reason and
    raises with that reason otherwise; a failed build or launch raises too.
    A call uploads nothing and reads nothing back once its configuration's
    tables are on the card. On a CPU tensor it returns
    :func:`trough_priors_reference`.
    """
    if yin_frames.device.type == "cpu":
        return trough_priors_reference(yin_frames, is_trough, thresholds, beta_probs,
                                       boltzmann_parameter, no_trough_prob)
    if yin_frames.device.type != "cuda":
        raise ParameterError(f"trough_priors runs on cuda or cpu, not {yin_frames.device}")
    refusal = kernel_refusal(yin_frames, is_trough, thresholds, beta_probs)
    if refusal is not None:
        raise ParameterError(refusal)
    with torch.cuda.device(yin_frames.device):
        return _launch(yin_frames, is_trough, thresholds, beta_probs, boltzmann_parameter,
                       no_trough_prob, torch.cuda.current_stream(yin_frames.device).cuda_stream)


def _launch(yin_frames: torch.Tensor, is_trough: torch.Tensor, thresholds: np.ndarray,
            beta_probs: np.ndarray, boltzmann_parameter: float, no_trough_prob: float,
            stream: Optional[int]) -> torch.Tensor:
    """The kernel's launch on ``stream`` for a call :func:`kernel_refusal` takes: the tables
    of the configuration, the output, and the output returned. Adds one to :data:`launches`
    where it launches; an input with no frame returns its empty output before any."""
    global launches
    thresholds = np.asarray(thresholds, dtype=np.float64)
    beta_probs = np.asarray(beta_probs, dtype=np.float64)
    shape, dtype, device = yin_frames.shape, yin_frames.dtype, yin_frames.device
    P, T = shape[-2:]
    K = len(thresholds) - 1
    beta = beta_probs[:K]
    rows = math.prod(shape[:-2])
    out = torch.empty(shape, dtype=dtype, device=device)  # contiguous, as the loop's
    if out.numel() == 0:
        return out
    yin3, mask3, out3 = (t.reshape(rows, P, T) for t in (yin_frames, is_trough, out))
    num, den = _pmf_tables(float(boltzmann_parameter), P, dtype, device)
    key = (thresholds.tobytes(), beta.tobytes())
    thr = device_table(("pyin_trough_thresholds", key), lambda: thresholds[1:], device, dtype)
    beta_d = device_table(("pyin_trough_beta", key), lambda: beta, device, dtype)
    rounding = torch.get_default_dtype()
    empty = device_table(("pyin_trough_empty", key, rounding),
                         lambda: _empty_prefix(beta, dtype, rounding), device, dtype)
    strides = [s for t in (yin3, mask3, out3) for s in t.stride()]
    err = _kernel_lib().trough_priors_launch(
        int(dtype == torch.float64), yin3.data_ptr(), mask3.data_ptr(), *strides, yin3.shape[0],
        T, P, K, thr.data_ptr(), beta_d.data_ptr(), empty.data_ptr(), num.data_ptr(),
        den.data_ptr(), float(no_trough_prob), out3.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"trough_priors kernel launch failed with CUDA error {err}")
    launches += 1
    return out
