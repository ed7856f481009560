"""The synthesis step of the inverse STFT: the CUDA kernel behind ``istft`` and its plain version.

The function takes the frames that the inverse real FFT gives,
``(..., T, n_fft)``, multiplies each by the synthesis window, sums them at a
spacing of ``hop_length``, cuts ``out_len`` samples from sample ``start``
(zeros where the frames end short) and divides by the window's
sum-of-squares envelope ``wss`` wherever that exceeds the smallest normal
number.

:func:`ola_norm` on a CUDA tensor launches the hand-written kernel
``csrc/ola_norm.cu`` (one launch: a gather, one thread per output sample or
per four; built for ``sm_90a`` at first use by ``ops/_build.py``) or raises;
on a CPU tensor it runs :func:`ola_norm_reference`, the plain PyTorch
version of the same function. The kernel takes what :func:`kernel_refusal`
does not refuse: contiguous float32 frames, window and envelope and
``1 <= hop_length <= n_fft``. ``core.spectrum._istft_core`` sends everything
else (float64) to the plain version by that predicate.

Both sum each sample's frames from the latest to the earliest with rounded
products and sums, so they agree to the bit; the kernel uses no atomics and
gives the same bits on every run.

The kernel replaces no TPU kernel; the JAX package compiles this step with
XLA (``librosa_tpu/core/spectrum.py``: the tail of ``_istft_core``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..util.exceptions import ParameterError
from ..util.utils import tiny
from . import _build
from .framing import overlap_add

__all__ = ["ola_norm", "ola_norm_reference", "kernel_refusal", "launches"]

_MAX_TRACK = 2**31 - 2048  # samples: the kernel's positions within one track are ints

#: Kernel launches so far: :func:`ola_norm` adds one per call that reaches
#: the card. Callers may reset it to 0.
launches = 0


def kernel_refusal(frames: torch.Tensor, window: torch.Tensor, wss: torch.Tensor,
                   hop_length: int) -> Optional[str]:
    """Why the CUDA kernel does not take this call, or None if it does.

    The one support rule: ``_istft_core`` routes by it, and :func:`ola_norm`
    raises with this reason on a CUDA tensor otherwise.
    """
    for name, t in (("frames", frames), ("window", window), ("wss", wss)):
        if t.dtype != torch.float32:
            return f"the ola_norm kernel takes float32 {name}, not {t.dtype}"
        if not t.is_contiguous():
            return f"the ola_norm kernel takes contiguous {name}"
    if frames.ndim < 2 or frames.numel() == 0 or wss.numel() == 0:
        return "the ola_norm kernel takes at least one frame and one output sample"
    if window.shape != frames.shape[-1:] or wss.ndim != 1:
        return "the ola_norm kernel takes a window of n_fft samples and a 1-d envelope"
    n_frames, n_fft = frames.shape[-2:]
    if not 1 <= hop_length <= n_fft:
        return (f"the ola_norm kernel takes 1 <= hop_length <= n_fft, not "
                f"hop_length={hop_length} with n_fft={n_fft}")
    if max(wss.shape[0], n_frames * hop_length) + n_fft > _MAX_TRACK:
        return "the ola_norm kernel indexes a track's samples in 32 bits: the track is too long"
    return None


def ola_norm_reference(frames: torch.Tensor, window: torch.Tensor, wss: torch.Tensor, *,
                       hop_length: int, start: int) -> torch.Tensor:
    """The plain PyTorch version of :func:`ola_norm`, on ``frames``' device, for every input."""
    out_len = wss.shape[-1]
    full = overlap_add(frames * window, hop_length=hop_length)
    y = full[..., start:start + out_len]
    if y.shape[-1] < out_len:
        y = F.pad(y, (0, out_len - y.shape[-1]))
    good = wss > tiny(wss)
    return torch.where(good, y / torch.where(good, wss, 1.0), y)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("ola_norm")
    fn = lib.ola_norm_launch
    if fn.argtypes is None:
        p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i64, i64, i32, i32, i64, i64, f32, p]
        fn.restype = ctypes.c_int
    return lib


def ola_norm(frames: torch.Tensor, window: torch.Tensor, wss: torch.Tensor, *,
             hop_length: int, start: int) -> torch.Tensor:
    """Windowed overlap-add of ``frames`` ``(..., T, n_fft)``, trimmed and normalised: ``(..., out_len)``.

    ``out_len`` is ``wss``'s length: output sample ``n`` is sample ``n +
    start`` of the overlap-add, divided by ``wss[n]`` where that exceeds the
    smallest normal float32. On a CUDA tensor this launches the kernel where
    :func:`kernel_refusal` gives no reason, and raises with that reason
    otherwise; a failed build or launch raises too. On a CPU tensor it
    returns :func:`ola_norm_reference`. Nothing is copied to the host and
    nothing synchronises.
    """
    global launches
    if frames.device.type == "cpu":
        return ola_norm_reference(frames, window, wss, hop_length=hop_length, start=start)
    if frames.device.type != "cuda":
        raise ParameterError(f"ola_norm runs on cuda or cpu, not {frames.device}")
    refusal = kernel_refusal(frames, window, wss, hop_length)
    if refusal is not None:
        raise ParameterError(refusal)
    if window.device != frames.device or wss.device != frames.device:
        raise ParameterError("ola_norm takes frames, window and wss on one device")
    if start < 0:
        raise ParameterError(f"start={start} must not be negative")
    *lead, n_frames, n_fft = frames.shape
    out_len = wss.shape[0]
    y = torch.empty((*lead, out_len), dtype=torch.float32, device=frames.device)
    lib = _kernel_lib()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        err = lib.ola_norm_launch(
            frames.data_ptr(), window.data_ptr(), wss.data_ptr(), y.data_ptr(),
            frames.numel() // (n_frames * n_fft), n_frames, n_fft, int(hop_length), int(start),
            out_len, tiny(wss), stream,
        )
    if err != 0:
        raise RuntimeError(f"ola_norm kernel launch failed with CUDA error {err}")
    launches += 1
    return y
