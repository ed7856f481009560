"""Fused ``|STFT(y)|**power`` projected onto a basis: the CUDA kernel and its plain version.

``stft_mel_fused`` is the hot path behind ``feature.melspectrogram``. On a
CUDA tensor it launches the hand-written kernel ``csrc/stft_mel.cu``
(built for ``sm_90a`` at first use by ``ops/_build.py``) or raises; on a
CPU tensor it runs ``stft_mel_reference``, the plain PyTorch version of the
same function (pad, ``unfold``, window, ``torch.fft.rfft``, ``|.|**p``,
``torch.matmul``).

Source note. The kernel replaces the TPU kernel
``librosa_tpu/ops/pallas_stft.py:_kernel`` (entry ``stft_mel_pallas``). On
an H100, bytes and operations bound the function about equally: the input
is read once and the output is ``n_out`` values per hop, against the work
``flops_per_frame`` counts (a real FFT and the projection through the
basis's nonzeros), near the card's float32 balance. Its design keeps every
intermediate on chip, as the TPU kernel did, so the bytes stay at that
least: one block per (track, tile of frames) stages the tile's samples in
shared memory once, synthesises the centre padding by index, runs one
radix-2 FFT per warp in shared memory, and projects the power spectra onto
the basis before writing ``(track, n_out, T)``. No frame matrix and no
power spectrum touch device memory. It does more operations than the
function needs (a complex FFT of real input, a dense projection); see
``csrc/stft_mel.cu``.

The TPU kernel's 128-lane factorisation, row DMAs, edge-tile buffers and
``lpad % hop`` pre-pad were rules of its compiler; none is carried over.
"""

from __future__ import annotations

import ctypes
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import as_tensor, device_table, exact_f32
from ..util.exceptions import ParameterError
from . import _build
from .fft import frames_power_spectrum
from .framing import frame_signal

__all__ = [
    "stft_mel_fused", "stft_mel_reference", "fused_supported", "kernel_refusal",
    "flops_per_frame", "launches",
]

#: Kernel launches so far. ``stft_mel_fused`` adds one where it launches the
#: kernel and nowhere else; callers may reset it to 0.
launches = 0

_MAX_SMEM = 232448            # bytes of shared memory one H100 block may use
_TILE_CHOICES = (8, 4, 2, 1)  # frames per block, one warp each
_PAD_MODES = {"constant": "constant", "reflect": "reflect", "edge": "replicate",
              "wrap": "circular"}


def _smem_bytes(n_fft: int, hop_length: int, tt: int) -> int:
    # frames (re, im) + the tile's span of samples + twiddles, in the order
    # csrc/stft_mel.cu lays them out; the launch is given this size
    return 4 * (2 * tt * n_fft + (tt - 1) * hop_length + 2 * n_fft)


def _tile_frames(n_fft: int, hop_length: int) -> int:
    for tt in _TILE_CHOICES:
        if _smem_bytes(n_fft, hop_length, tt) <= _MAX_SMEM:
            return tt
    return 0


def fused_supported(n_fft: int, hop_length: int) -> bool:
    """Whether the CUDA kernel takes an ``(n_fft, hop_length)`` geometry.

    It needs a power-of-two ``n_fft`` from 64 to 8192 (radix-2 FFT, and at
    least one frame's complex buffer in a block's shared memory) and
    ``1 <= hop_length <= n_fft``. Against the TPU kernel's
    ``pallas_supported`` this drops the rules of that kernel's compiler
    (``hop % 128 == 0``, ``hop`` dividing ``n_fft``, ``n_fft >= 256``), so
    it is a superset of that set for every ``n_fft <= 8192``. Above 8192,
    where ``pallas_supported`` says yes, this says no and the plain path runs.
    """
    if n_fft < 64 or n_fft & (n_fft - 1):
        return False
    if not 1 <= hop_length <= n_fft:
        return False
    return _tile_frames(n_fft, hop_length) > 0


def kernel_refusal(dtype: torch.dtype, n_fft: int, hop_length: int,
                   pad_mode: str) -> Optional[str]:
    """Why the CUDA kernel does not take this call, or None if it does.

    The one support rule: the router in ``core/spectrum.py`` sends a call
    to the kernel when this is None, and :func:`stft_mel_fused` raises with
    this reason on a CUDA tensor otherwise.
    """
    if dtype != torch.float32:
        return f"the stft_mel kernel takes float32 input, not {dtype}"
    if pad_mode not in ("constant", "reflect"):
        return f"the stft_mel kernel pads 'constant' or 'reflect', not {pad_mode!r}"
    if not fused_supported(n_fft, hop_length):
        return f"the stft_mel kernel does not take n_fft={n_fft}, hop={hop_length}"
    return None


def flops_per_frame(n_fft: int, basis_nnz: int) -> int:
    """Floating-point operations one frame needs, for the roofline bound.

    This counts the function, not a kernel that computes it: the window
    (``n_fft`` multiplies), a real FFT (``2.5 * n_fft * log2(n_fft)``, half
    the usual ``5 N log2 N`` of a complex one), ``|X|**2`` (3 per bin) and
    the projection through the basis's ``basis_nnz`` nonzeros (a multiply
    and an add each). A mel basis is banded, about 2 nonzeros per bin, so
    the projection is small beside the FFT.
    """
    log2_n = n_fft.bit_length() - 1
    return n_fft + (5 * n_fft * log2_n) // 2 + 3 * (n_fft // 2 + 1) + 2 * basis_nnz


def frame_geometry(sig_len: int, *, n_fft: int, hop_length: int, center: bool,
                   pad_mode: str) -> Tuple[int, int]:
    """``(lpad, n_frames)`` of a signal of ``sig_len`` samples; raises if none fits."""
    lpad = n_fft // 2 if center else 0
    if center and pad_mode in ("reflect", "wrap") and lpad >= sig_len:
        raise ParameterError(
            f"pad_mode={pad_mode!r} needs more than n_fft // 2 = {lpad} samples; "
            f"got {sig_len}"
        )
    if sig_len + 2 * lpad < n_fft:
        raise ParameterError(
            f"Input is too short (n={sig_len:d}) for n_fft={n_fft:d}"
        )
    return lpad, 1 + (sig_len + 2 * lpad - n_fft) // hop_length


def _twiddles(n_fft: int) -> np.ndarray:
    # [cos(2 pi k / N) for k < N/2] + [-sin(2 pi k / N) for k < N/2], made
    # in float64 and rounded once to float32
    ang = 2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)]).astype(np.float32)


def _table(a: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``a`` (numpy or tensor) on ``device`` in ``dtype``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("stft_mel")
    fn = lib.stft_mel_launch
    if fn.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i64, i64, i64, i32, i32, i64, i32, i32, i32,
                       ctypes.c_float, i32, p]
        fn.restype = ctypes.c_int
    return lib


def stft_mel_fused(
    y: Any,
    window: Any,
    basis: Any,
    *,
    n_fft: int,
    hop_length: int,
    power: float = 2.0,
    center: bool = True,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """``basis @ |STFT(y)|**power`` as ``(..., n_out, T)``, in one kernel on the card.

    ``y`` is ``(..., n)``; its leading dims fold into tracks. ``window`` is
    ``(n_fft,)`` and ``basis`` ``(n_out, 1 + n_fft // 2)``, numpy or tensors.
    On a CUDA tensor this launches the kernel where :func:`kernel_refusal`
    gives no reason, and raises with that reason otherwise; on a CPU tensor
    it returns :func:`stft_mel_reference`. The kernel reads the basis by
    column: a float32 basis on ``y``'s device that is already column-major
    (the transpose of a contiguous ``(n_bins, n_out)`` tensor, as
    ``feature.melspectrogram`` keeps its mel basis) is read in place, any
    other is transposed into a copy first.
    """
    global launches
    y = as_tensor(y)
    if y.device.type == "cpu":
        return stft_mel_reference(y, window, basis, n_fft=n_fft, hop_length=hop_length,
                                  power=power, center=center, pad_mode=pad_mode)
    if y.device.type != "cuda":
        raise ParameterError(f"stft_mel_fused runs on cuda or cpu, not {y.device}")
    refusal = kernel_refusal(y.dtype, n_fft, hop_length, pad_mode)
    if refusal is not None:
        raise ParameterError(refusal)
    device = y.device
    lead, sig_len = y.shape[:-1], y.shape[-1]
    lpad, n_frames = frame_geometry(sig_len, n_fft=n_fft, hop_length=hop_length,
                                    center=center, pad_mode=pad_mode)
    y2 = y.reshape(-1, sig_len).contiguous()
    win = _table(window, device, torch.float32).contiguous()
    basis_t = _table(basis, device, torch.float32).t().contiguous()  # no copy if column-major
    twiddle = device_table(("twiddle", n_fft), lambda: _twiddles(n_fft), device,
                           torch.float32)
    if tuple(win.shape) != (n_fft,):
        raise ParameterError(f"window has shape {tuple(win.shape)}, expected ({n_fft},)")
    if basis_t.ndim != 2 or basis_t.shape[0] != n_fft // 2 + 1:
        raise ParameterError(
            f"basis has shape {tuple(basis_t.t().shape)}, expected (n_out, {n_fft // 2 + 1})"
        )
    n_out = basis_t.shape[1]
    out = torch.empty((y2.shape[0], n_out, n_frames), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out.reshape(*lead, n_out, n_frames)
    lib = _kernel_lib()
    tt = _tile_frames(n_fft, hop_length)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.stft_mel_launch(
            y2.data_ptr(), win.data_ptr(), twiddle.data_ptr(), basis_t.data_ptr(),
            out.data_ptr(), y2.shape[0], sig_len, n_frames, n_fft, hop_length, lpad,
            int(pad_mode == "reflect" and center), n_out, tt, float(power),
            _smem_bytes(n_fft, hop_length, tt), stream,
        )
    if err != 0:
        raise RuntimeError(f"stft_mel kernel launch failed with CUDA error {err}")
    launches += 1
    return out.reshape(*lead, n_out, n_frames)


def stft_mel_reference(
    y: Any,
    window: Any,
    basis: Any,
    *,
    n_fft: int,
    hop_length: int,
    power: float = 2.0,
    center: bool = True,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """The plain PyTorch version of :func:`stft_mel_fused`, on ``y``'s device.

    Pad, frame with ``unfold``, window, ``torch.fft.rfft``, ``|.|**power``,
    then ``torch.matmul`` with the basis in full float32 (or in float64 for
    float64 input). ``pad_mode`` is one of ``'constant'``, ``'reflect'``,
    ``'edge'`` or ``'wrap'``.
    """
    y = as_tensor(y)
    dtype = y.dtype if y.dtype in (torch.float32, torch.float64) else torch.float32
    y = y.to(dtype)
    if pad_mode not in _PAD_MODES:
        raise ParameterError(f"Unsupported pad_mode={pad_mode!r}")
    lead, sig_len = y.shape[:-1], y.shape[-1]
    lpad, _ = frame_geometry(sig_len, n_fft=n_fft, hop_length=hop_length,
                             center=center, pad_mode=pad_mode)
    win = _table(window, y.device, dtype)
    bas = _table(basis, y.device, dtype)
    y2 = y.reshape(-1, 1, sig_len)
    if lpad:
        y2 = F.pad(y2, (lpad, lpad), mode=_PAD_MODES[pad_mode])
    frames = frame_signal(y2[:, 0], frame_length=n_fft, hop_length=hop_length)
    pw = frames_power_spectrum(frames * win)
    if power == 1:
        pw = pw.sqrt()
    elif power != 2:
        pw = pw ** (power / 2)
    with exact_f32():
        out = torch.matmul(bas, pw.transpose(-1, -2))
    return out.reshape(*lead, *out.shape[-2:])
