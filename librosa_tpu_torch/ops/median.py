"""The centred sliding median along one axis: the CUDA kernel behind HPSS and its plain version.

``median_filter_1d(x, size=, axis=)`` is ``scipy.ndimage.median_filter``
with a one-dimensional window and the ``reflect`` boundary (numpy's
``symmetric``: the end sample repeated, over as many periods as the window
needs). For an even ``size`` it takes the upper middle value (rank
``size // 2``). A window that holds a NaN gives NaN for an odd size; for an
even size NaNs sort above every number.

On a CUDA tensor it launches the hand-written kernel
``csrc/median_filter.cu`` (one launch; built for ``sm_90a`` at first use by
``ops/_build.py``) or raises; on a CPU tensor it runs
:func:`median_filter_reference`, the plain PyTorch version (pad, view the
windows with ``Tensor.unfold``, ``torch.median`` or, for an even size, a
sort). The kernel takes what :func:`kernel_refusal` does not refuse:
float32, axis -1 or -2, sizes 2 to 64. It reads the tensor's own strides,
so a ``(bins, T)`` view of time-major memory is filtered in place and the
output has the input's layout; leading dimensions that do not fold into one
stride are copied first and counted in :data:`copies`. Each thread of the
kernel computes its outputs in groups that share one sorted core of keys
(``csrc/median_select.cuh``, which ``tests/test_torch_median_select.py``
also compiles for the CPU). Both versions select the same element of each
window (zeros of either sign come out as +0), so they agree to the bit.

The kernel replaces no TPU kernel: the JAX package compiles
``librosa_tpu/ops/median.py:median_filter_1d`` with XLA.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..util.exceptions import ParameterError
from ..util.utils import pad_last
from . import _build

__all__ = ["median_filter_1d", "median_filter_reference", "kernel_refusal", "launches",
           "copies"]

MAX_SIZE = 64  # the kernel's widest window
_COLS = 32     # columns (positions of the batch and the other axis) per block of the kernel
_TILE = 128    # positions of the filter axis per block of the kernel
_MAX_BLOCKS = 2**31 - 1

#: Kernel launches so far: :func:`median_filter_1d` adds one per call that reaches the card.
launches = 0
#: Inputs copied before a launch because their leading dimensions do not fold into one stride.
copies = 0


def _last_two(x: torch.Tensor, axis: int) -> Optional[int]:
    """``axis`` as -1 or -2 of ``x``, or None where it is another axis."""
    ax = axis if axis < 0 else axis - x.ndim
    return ax if ax in (-1, -2) and -x.ndim <= ax else None


def kernel_refusal(x: torch.Tensor, size: int, axis: int) -> Optional[str]:
    """Why the CUDA kernel does not take this call, or None if it does.

    The one support rule: callers route by it, and :func:`median_filter_1d`
    raises with this reason on a CUDA tensor otherwise.
    """
    if x.dtype != torch.float32:
        return f"the median_filter kernel takes float32, not {x.dtype}"
    if not 2 <= size <= MAX_SIZE:
        return f"the median_filter kernel takes sizes 2 to {MAX_SIZE}, not {size}"
    if x.ndim == 0 or x.numel() == 0:
        return "the median_filter kernel takes a non-empty tensor of one or more dimensions"
    ax = _last_two(x, axis)
    if ax is None or (x.ndim == 1 and ax != -1):
        return f"the median_filter kernel filters axis -1 or -2, not {axis} of {x.ndim}"
    d, n = (1, x.shape[-1]) if x.ndim == 1 else x.shape[-2:]
    length, columns = (n, x.numel() // n) if ax == -1 else (d, x.numel() // d)
    if -(-length // _TILE) * -(-columns // _COLS) > _MAX_BLOCKS:
        return f"the median_filter kernel's grid takes at most {_MAX_BLOCKS} blocks"
    return None


def median_filter_reference(x: torch.Tensor, *, size: int, axis: int = -1) -> torch.Tensor:
    """The plain PyTorch version of :func:`median_filter_1d`, on ``x``'s device, for every input.

    Pad by ``size // 2`` before and ``size - 1 - size // 2`` after in
    numpy's ``symmetric`` mode, view every window with ``Tensor.unfold``,
    then ``torch.median`` (odd sizes) or ``torch.sort`` and rank ``size //
    2`` (even sizes). ``x + 0.0`` first turns -0 into +0, as the kernel does.
    """
    if size < 1:
        raise ParameterError(f"size={size} must be at least 1")
    if size == 1:
        return x
    moved = (x + 0.0).movedim(axis, -1)
    lpad = size // 2
    windows = pad_last(moved, lpad, size - 1 - lpad, mode="symmetric").unfold(-1, size, 1)
    if size % 2:
        out = windows.median(dim=-1).values
    else:
        out = windows.sort(dim=-1).values[..., size // 2]
    return out.movedim(-1, axis)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("median_filter")
    fn = lib.median_filter_launch
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, i64, i64, i64, i64, i64, i64, i64, i64, i64, i32, i32, p]
        fn.restype = ctypes.c_int
    return lib


def _as_batch(x: torch.Tensor) -> Optional[torch.Tensor]:
    """``x`` as a ``(batch, d, n)`` view, or None where its leading dims do not fold into one stride."""
    x3 = x.reshape(1, 1, -1) if x.ndim == 1 else x
    lead = [(s, st) for s, st in zip(x3.shape[:-2], x3.stride()[:-2]) if s != 1]
    if not all(outer[1] == inner[1] * inner[0] for outer, inner in zip(lead, lead[1:])):
        return None
    batch = 1
    for s in x3.shape[:-2]:
        batch *= s
    step = lead[-1][1] if lead else 0
    return x3.as_strided((batch, *x3.shape[-2:]), (step, *x3.stride()[-2:]))


def median_filter_1d(x: torch.Tensor, *, size: int, axis: int = -1) -> torch.Tensor:
    """The centred sliding median of ``size`` samples along ``axis`` of ``x``; same shape.

    On a CUDA tensor this launches the kernel where :func:`kernel_refusal`
    gives no reason (``size`` 1 returns ``x`` without a launch), and raises
    with that reason otherwise; a failed build or launch raises too. On a
    CPU tensor it returns :func:`median_filter_reference`. The output has
    ``x``'s strides where ``x`` is dense, else it is contiguous. Nothing is
    copied to the host and nothing synchronises.
    """
    global launches, copies
    if size < 1:
        raise ParameterError(f"size={size} must be at least 1")
    if x.device.type == "cpu":
        return median_filter_reference(x, size=size, axis=axis)
    if x.device.type != "cuda":
        raise ParameterError(f"median_filter_1d runs on cuda or cpu, not {x.device}")
    if size == 1:
        return x
    refusal = kernel_refusal(x, size, axis)
    if refusal is not None:
        raise ParameterError(refusal)
    last = _last_two(x, axis) == -1
    view = _as_batch(x)
    if view is None:
        x = x.contiguous()
        copies += 1
        view = _as_batch(x)
    out = torch.empty_like(x)
    out_view = _as_batch(out)
    lib = _kernel_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.median_filter_launch(
            view.data_ptr(), out_view.data_ptr(), *view.shape, *view.stride(),
            *out_view.stride(), int(last), int(size), stream)
    if err != 0:
        raise RuntimeError(f"median_filter kernel launch failed with CUDA error {err}")
    launches += 1
    return out
