"""Griffin-Lim's phase update: the CUDA kernel behind ``core.spectrum._phase_update`` and its plain version.

One round's update, in place: ``estimate <- S * unit(rebuilt - weight * tprev)``
with ``unit(z) = z / (|z| + tiny)``, ``tprev`` None standing for zeros (the
first round) and ``tiny`` the smallest normal number of the estimate's type.

:func:`phase_update` launches the hand-written kernel ``csrc/phase_update.cu``
(one pass over the four tensors, built for ``sm_90a`` at first use by
``ops/_build.py``) on what :func:`kernel_refusal` takes, and raises on
anything else; :func:`phase_update_reference` is the plain PyTorch version,
for the CPU, float64 and every layout the kernel does not take.
``core.spectrum._phase_update`` routes by :func:`kernel_refusal` alone.

On the card the two give the same bits: the kernel rounds each operation as
torch's own kernels do. The kernel replaces no TPU kernel; the JAX package
computes this step with XLA (``librosa_tpu/core/spectrum.py:1337-1338``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..util import profiling
from ..util.exceptions import ParameterError
from ..util.utils import tiny
from . import _build

__all__ = ["phase_update", "phase_update_reference", "kernel_refusal", "launches"]

#: Kernel launches so far: :func:`phase_update` adds one per launch on the
#: card. Callers may reset it to 0.
launches = 0


def _layout(t: torch.Tensor) -> tuple:
    """``t``'s strides over its axes longer than one (the others place nothing)."""
    return tuple((n, s) for n, s in zip(t.shape, t.stride()) if n != 1)


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill ``t.numel()`` consecutive places, each once."""
    expected = 1
    for n, s in sorted(_layout(t), key=lambda ns: ns[1]):
        if s != expected:
            return False
        expected *= n
    return True


def kernel_refusal(estimate: torch.Tensor, rebuilt: torch.Tensor, tprev: Optional[torch.Tensor],
                   S: torch.Tensor) -> Optional[str]:
    """Why the CUDA kernel does not take this update, or None if it does.

    It takes a complex64 ``estimate``, ``rebuilt`` and ``tprev`` (or None) and
    float32 magnitudes ``S``, on one CUDA device, in one shape and one
    non-overlapping, dense layout, as ``griffinlim`` keeps them. The one
    support rule: ``_phase_update`` routes by it, and :func:`phase_update`
    raises with its reason.
    """
    complexes = [("estimate", estimate), ("rebuilt", rebuilt)]
    if tprev is not None:
        complexes.append(("tprev", tprev))
    for name, t in complexes:
        if t.dtype != torch.complex64:
            return f"the phase update kernel takes complex64 {name}, not {t.dtype}"
    if S.dtype != torch.float32:
        return f"the phase update kernel takes float32 S, not {S.dtype}"
    for name, t in [*complexes[1:], ("S", S)]:
        if t.device != estimate.device:
            return "the phase update kernel takes its four tensors on one device"
        if t.shape != estimate.shape or _layout(t) != _layout(estimate):
            return f"the phase update kernel takes {name} in the estimate's shape and strides"
    if not _dense(estimate):
        return "the phase update kernel takes non-overlapping, dense tensors"
    if estimate.device.type != "cuda":
        return f"the phase update kernel runs on a CUDA tensor, not on {estimate.device}"
    return None


def phase_update_reference(estimate: torch.Tensor, rebuilt: torch.Tensor,
                           tprev: Optional[torch.Tensor], S: torch.Tensor,
                           weight: float) -> None:
    """The plain PyTorch version of :func:`phase_update`, on any device and type: the weighted
    difference, ``|z|``, ``+ tiny``, the quotient and the product by ``S``, each a torch op."""
    if tprev is None:
        estimate.copy_(rebuilt)
    else:
        torch.add(rebuilt, tprev, alpha=-weight, out=estimate)
    estimate.div_(estimate.abs().add_(tiny(estimate)))
    estimate.mul_(S)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("phase_update")
    fn = lib.phase_update_launch
    if fn.argtypes is None:
        p, f32 = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, f32, f32, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(estimate: torch.Tensor, rebuilt: torch.Tensor, tprev: Optional[torch.Tensor],
            S: torch.Tensor, weight: float, stream: Optional[int]) -> None:
    """The kernel's launch on ``stream`` for an update :func:`kernel_refusal` takes. Adds one
    to :data:`launches` and to the program's counter ``phase_update_kernels``; an empty tensor
    launches nothing."""
    global launches
    n = estimate.numel()
    if n == 0:
        return
    err = _kernel_lib().phase_update_launch(
        estimate.data_ptr(), rebuilt.data_ptr(), None if tprev is None else tprev.data_ptr(),
        S.data_ptr(), n, float(weight), tiny(estimate), stream)
    if err != 0:
        raise RuntimeError(f"phase_update kernel launch failed with CUDA error {err}")
    launches += 1
    profiling.count("phase_update_kernels")


def phase_update(estimate: torch.Tensor, rebuilt: torch.Tensor, tprev: Optional[torch.Tensor],
                 S: torch.Tensor, weight: float) -> None:
    """``estimate <- S * unit(rebuilt - weight * tprev)`` in place, in one kernel launch.

    Raises with :func:`kernel_refusal`'s reason on what the kernel does not
    take (a CPU tensor among them); a failed build or launch raises too.
    Nothing is allocated, copied to the host or synchronised.
    """
    refusal = kernel_refusal(estimate, rebuilt, tprev, S)
    if refusal is not None:
        raise ParameterError(refusal)
    with torch.cuda.device(estimate.device):
        _launch(estimate, rebuilt, tprev, S, weight,
                torch.cuda.current_stream(estimate.device).cuda_stream)
