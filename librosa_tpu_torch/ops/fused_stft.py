"""Fused ``|STFT(y)|**power`` projected onto a basis: the CUDA kernel and its plain version.

``stft_mel_fused`` is the hot path behind ``feature.melspectrogram``. On a
CUDA tensor it launches the hand-written kernel ``csrc/stft_mel.cu``
(built for ``sm_90a`` at first use by ``ops/_build.py``) or raises; on a
CPU tensor it runs ``stft_mel_reference``, the plain PyTorch version of the
same function (pad, ``unfold``, window, ``torch.fft.rfft``, ``|.|**p``,
``torch.matmul``).

Source note. The kernel replaces the TPU kernel
``librosa_tpu/ops/pallas_stft.py:_kernel`` (entry ``stft_mel_pallas``). By
the roofline an H100 is bound on this function by operations and bytes about
equally (``flops_per_frame`` against ``hop`` samples in and ``n_out`` values
out per frame); a kernel for it is bound by the SM's shared-memory
wavefronts, scheduler slots and occupancy. The design keeps every intermediate
on chip, as the TPU kernel did, and spends the SM sparingly:

- one block per (track, tile of frames) stages the tile's samples in shared
  memory once and synthesises the centre padding by index;
- a real frame of ``n_fft`` samples is packed as ``n_fft / 2`` complex
  points, transformed by a self-sorting (Stockham) FFT whose radix-4 to
  radix-16 butterflies live in registers, and unpacked to bins
  ``0..n_fft/2``; shared memory only carries the exchange between passes,
  in a padded layout whose stores and loads are free of bank conflicts;
  the twiddles between passes come from ``_twiddles``, one contiguous run
  per pass, made in float64 and rounded once;
- the projection walks only each basis row's band of nonzeros
  (``basis_bands``), eight rows to a warp, with one sum per frame of the
  tile in each lane's registers, at the basis entry of ``precision``
  (exact float32 unless asked; :mod:`~librosa_tpu_torch.ops.precision`).

No frame matrix and no power spectrum touch device memory, and there is one
launch per call. ``_fft_plan``, ``_frame_floats``, ``_smem_bytes`` and
``_twiddles`` mirror the constants of ``csrc/stft_mel.cu``; the launch
refuses a shared-memory size that disagrees with its own.

The TPU kernel's 128-lane factorisation, row DMAs, edge-tile buffers and
``lpad % hop`` pre-pad were rules of its compiler; none is carried over.
"""

from __future__ import annotations

import ctypes
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .._device import as_tensor, device_table
from ..util.exceptions import ParameterError
from ..util.utils import pad_last
from . import _build
from . import precision as _precision
from .fft import get_matmul_precision, power_spectrum_at
from .framing import frame_signal

__all__ = [
    "stft_mel_fused", "stft_mel_reference", "fused_supported", "kernel_refusal",
    "flops_per_frame", "launches",
]

#: Kernel launches so far. ``stft_mel_fused`` adds one where it launches the
#: kernel and nowhere else; callers may reset it to 0.
launches = 0

_MAX_SMEM = 232448            # bytes of shared memory one H100 block may use
_HALF_SMEM = 115712           # ... and the most that lets two blocks share an SM (1 KB reserved each)
_TILE_CHOICES = (8, 4, 2, 1)  # frames per block


def _fft_plan(n_fft: int) -> Tuple[int, List[int]]:
    """``(points per thread, radix of each pass)`` of the ``n_fft / 2``-point complex FFT.

    Every pass but the last takes as many bits as a thread holds points
    (16 from n_fft 2048, 8 from 256, else 4); the last takes the rest.
    """
    log2_h = n_fft.bit_length() - 2
    bits = 4 if log2_h >= 10 else 3 if log2_h >= 7 else 2
    passes = [bits] * (log2_h // bits) + ([log2_h % bits] if log2_h % bits else [])
    return 1 << bits, [1 << b for b in passes]


def _exchange_pads(n_fft: int) -> List[Tuple[int, int]]:
    """``(pad, unit)`` of the exchange after each pass but the last.

    Element ``a`` of an exchange lies at ``a + pad * (a // unit)``. A pass of
    radix ``R`` behind passes of product ``p`` stores runs of ``p`` elements
    that lie ``p * R`` apart; shifting each run by ``p`` banks spreads a
    warp's 32 stores over 32 banks, and the loads (consecutive elements)
    stay whole. From ``p = 32`` on the runs fill a warp and need no pad.
    """
    _, radices = _fft_plan(n_fft)
    pads, p = [], 1
    for radix in radices[:-1]:
        pads.append((p, max(p * radix, 32)) if p < 32 else (0, 32))
        p *= radix
    return pads


def _frame_floats(n_fft: int) -> int:
    """Floats of shared memory in one frame's buffer.

    It holds the padded exchange (real parts, then imaginary parts) and
    later the power spectrum, bins ``0..n_fft/2``, in the real part's place.
    """
    half = n_fft // 2
    pad = max([p * ((half - 1) // unit) for p, unit in _exchange_pads(n_fft)], default=0)
    return 2 * (half + pad + 1)


def _smem_bytes(n_fft: int, hop_length: int, tt: int) -> int:
    # the tile's span of samples (rounded up to 4 floats), then one buffer per
    # frame, as csrc/stft_mel.cu lays them out; the launch is given this size
    span = (tt - 1) * hop_length + n_fft
    return 4 * (span + (-span) % 4 + tt * _frame_floats(n_fft))


def _tile_frames(n_fft: int, hop_length: int) -> int:
    """Frames per block: the most that leave room for two blocks on an SM, else the most that fit.

    A frame takes ``n_fft / 2 / points-per-thread`` threads, and a block
    256 or, where the tile's frames take fewer, those: whole warps.
    """
    points, _ = _fft_plan(n_fft)
    threads = n_fft // 2 // points
    for limit in (_HALF_SMEM, _MAX_SMEM):
        for tt in _TILE_CHOICES:
            if (tt * threads) % 32 == 0 and _smem_bytes(n_fft, hop_length, tt) <= limit:
                return tt
    return 0


def fused_supported(n_fft: int, hop_length: int) -> bool:
    """Whether the CUDA kernel takes an ``(n_fft, hop_length)`` geometry.

    It needs a power-of-two ``n_fft`` from 64 to 8192 (its FFT plans, with
    one frame's ``n_fft / 2`` complex points on at most one block's threads)
    and ``1 <= hop_length <= n_fft``. Against the TPU kernel's
    ``pallas_supported`` this drops the rules of that kernel's compiler
    (``hop % 128 == 0``, ``hop`` dividing ``n_fft``, ``n_fft >= 256``), so
    it is a superset of that set for every ``n_fft <= 8192``. Above 8192,
    where ``pallas_supported`` says yes, this says no and the plain path runs.
    """
    if not 64 <= n_fft <= 8192 or n_fft & (n_fft - 1):
        return False
    if not 1 <= hop_length <= n_fft:
        return False
    return _tile_frames(n_fft, hop_length) > 0


def kernel_refusal(dtype: torch.dtype, n_fft: int, hop_length: int, pad_mode: str,
                   centred_len: Optional[int] = None) -> Optional[str]:
    """Why the CUDA kernel does not take this call, or None if it does.

    The one support rule: the router in ``core/spectrum.py`` sends a call
    to the kernel when this is None, and :func:`stft_mel_fused` raises with
    this reason on a CUDA tensor otherwise. ``centred_len`` is the length of
    a signal that is padded by ``n_fft // 2`` a side (None: not centred);
    the kernel mirrors a ``'reflect'`` pad once, so it needs more samples
    than the pad.
    """
    if dtype != torch.float32:
        return f"the stft_mel kernel takes float32 input, not {dtype}"
    if pad_mode not in ("constant", "reflect"):
        return f"the stft_mel kernel pads 'constant' or 'reflect', not {pad_mode!r}"
    if not fused_supported(n_fft, hop_length):
        return f"the stft_mel kernel does not take n_fft={n_fft}, hop={hop_length}"
    if pad_mode == "reflect" and centred_len is not None and centred_len <= n_fft // 2:
        return (f"the stft_mel kernel reflects the pad once: it needs more than n_fft // 2 = "
                f"{n_fft // 2} samples, not {centred_len}")
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


def frame_geometry(sig_len: int, *, n_fft: int, hop_length: int,
                   center: bool) -> Tuple[int, int]:
    """``(lpad, n_frames)`` of a signal of ``sig_len`` samples; raises if none fits."""
    lpad = n_fft // 2 if center else 0
    if sig_len + 2 * lpad < n_fft:
        raise ParameterError(
            f"Input is too short (n={sig_len:d}) for n_fft={n_fft:d}"
        )
    return lpad, 1 + (sig_len + 2 * lpad - n_fft) // hop_length


def _twiddles(n_fft: int) -> np.ndarray:
    """The kernel's float32 tables, made in float64 and rounded once.

    For each pass after the first (radix ``R``, behind passes of product
    ``p``): ``exp(-2 pi i r k / (p R))`` for ``r = 1..R-1`` and ``k < p``,
    ``k`` fastest, real parts then imaginary parts, so that a warp's lanes
    (consecutive ``k``) read consecutive words. Then the unpacking table of
    the real-input FFT: ``cos(2 pi k / n_fft)`` and ``-sin(2 pi k / n_fft)``
    for ``k = 0..n_fft/4``.
    """
    _, radices = _fft_plan(n_fft)
    parts, p = [], radices[0]
    for radix in radices[1:]:
        ang = -2.0 * np.pi * np.outer(np.arange(1, radix), np.arange(p)) / (p * radix)
        parts += [np.cos(ang).ravel(), np.sin(ang).ravel()]
        p *= radix
    ang = -2.0 * np.pi * np.arange(n_fft // 4 + 1) / n_fft
    parts += [np.cos(ang), np.sin(ang)]
    return np.concatenate(parts).astype(np.float32)


def basis_bands(basis: Any) -> Any:
    """Per row of ``basis``, ``[first nonzero column, one past the last)``, as int32 ``(n_out, 2)``.

    A row without a nonzero gets the empty band ``[0, 0)``. A numpy basis
    gives a numpy table; a tensor gives a tensor on its device, computed
    there with no copy to the host and no synchronisation.
    """
    if isinstance(basis, torch.Tensor):
        nz = basis != 0
        n_bins = nz.shape[1]
        lo = nz.to(torch.uint8).argmax(dim=1)                  # the first of equal maxima
        hi = n_bins - nz.flip(1).to(torch.uint8).argmax(dim=1)
        bands = torch.stack([lo, hi], dim=1) * nz.any(dim=1, keepdim=True)
        return bands.to(torch.int32)
    nz = np.asarray(basis) != 0
    lo = nz.argmax(axis=1)
    hi = nz.shape[1] - nz[:, ::-1].argmax(axis=1)
    return (np.stack([lo, hi], axis=1) * nz.any(axis=1, keepdims=True)).astype(np.int32)


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
        fn.argtypes = [p, p, p, p, p, p, i64, i64, i64, i32, i32, i64, i32, i32, i32,
                       ctypes.c_float, i32, i32, p]
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
    precision: Any = None,
) -> torch.Tensor:
    """``basis @ |STFT(y)|**power`` as ``(..., n_out, T)``, in one kernel on the card.

    ``y`` is ``(..., n)``; its leading dims fold into tracks. ``window`` is
    ``(n_fft,)`` and ``basis`` ``(n_out, 1 + n_fft // 2)``, numpy or tensors.
    On a CUDA tensor this launches the kernel where :func:`kernel_refusal`
    gives no reason, and raises with that reason otherwise; on a CPU tensor
    it returns :func:`stft_mel_reference`. The kernel walks each basis row
    over its band of nonzeros (:func:`basis_bands`, computed on the card
    without a synchronisation); a float32 row-major basis on ``y``'s device
    is read in place, any other is copied first.

    ``precision`` is the JAX kernel's: None (exact float32), a name that
    ``jax.lax.Precision`` takes, or a tuple ``(stage a, stage b, basis)``
    of them (:func:`~librosa_tpu_torch.ops.precision.normalize3`). The JAX
    kernel computes its DFT as two products (stages a and b) and the
    projection as a third. Here the DFT is an FFT in shared memory, not a
    product, so it is always exact: the tuple's first two entries are
    checked and accepted, and have nothing to act on. The basis entry sets
    the projection's arithmetic: ``'highest'`` exact float32 (the default,
    whose bits do not change), ``'default'`` both operands rounded to
    bfloat16 before each float32 multiply-add, ``'high'`` the three
    products of their bfloat16 halves (``hi hi + hi lo + lo hi``).
    """
    return _fused(y, window, basis, None, n_fft=n_fft, hop_length=hop_length, power=power,
                  center=center, pad_mode=pad_mode, precision=precision)


def _fused(y: Any, window: Any, basis: Any, bands: Optional[torch.Tensor], *, n_fft: int,
           hop_length: int, power: float, center: bool, pad_mode: str,
           precision: Any = None) -> torch.Tensor:
    """:func:`stft_mel_fused` with the basis's band table given (``None``: derived here)."""
    global launches
    y = as_tensor(y)
    setting = _precision.normalize3(precision)[2]
    if y.device.type == "cpu":
        return stft_mel_reference(y, window, basis, n_fft=n_fft, hop_length=hop_length,
                                  power=power, center=center, pad_mode=pad_mode,
                                  precision=setting)
    if y.device.type != "cuda":
        raise ParameterError(f"stft_mel_fused runs on cuda or cpu, not {y.device}")
    lead, sig_len = y.shape[:-1], y.shape[-1]
    refusal = kernel_refusal(y.dtype, n_fft, hop_length, pad_mode, sig_len if center else None)
    if refusal is not None:
        raise ParameterError(refusal)
    device = y.device
    lpad, n_frames = frame_geometry(sig_len, n_fft=n_fft, hop_length=hop_length,
                                    center=center)
    y2 = y.reshape(-1, sig_len).contiguous()
    win = _table(window, device, torch.float32).contiguous()
    bas = _table(basis, device, torch.float32).contiguous()
    twiddle = device_table(("twiddle", n_fft), lambda: _twiddles(n_fft), device,
                           torch.float32)
    if tuple(win.shape) != (n_fft,):
        raise ParameterError(f"window has shape {tuple(win.shape)}, expected ({n_fft},)")
    if bas.ndim != 2 or bas.shape[1] != n_fft // 2 + 1:
        raise ParameterError(
            f"basis has shape {tuple(bas.shape)}, expected (n_out, {n_fft // 2 + 1})"
        )
    n_out = bas.shape[0]
    if bands is None:
        bands = basis_bands(bas)
    bands = bands.to(device=device, dtype=torch.int32).contiguous()
    if tuple(bands.shape) != (n_out, 2):
        raise ParameterError(f"bands has shape {tuple(bands.shape)}, expected ({n_out}, 2)")
    out = torch.empty((y2.shape[0], n_out, n_frames), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out.reshape(*lead, n_out, n_frames)
    lib = _kernel_lib()
    tt = _tile_frames(n_fft, hop_length)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.stft_mel_launch(
            y2.data_ptr(), win.data_ptr(), twiddle.data_ptr(), bas.data_ptr(),
            bands.data_ptr(), out.data_ptr(), y2.shape[0], sig_len, n_frames, n_fft,
            hop_length, lpad, int(pad_mode == "reflect" and center), n_out, tt, float(power),
            _smem_bytes(n_fft, hop_length, tt), _precision.MODES[setting], stream,
        )
    if err != 0:
        raise RuntimeError(f"stft_mel kernel launch failed with CUDA error {err}")
    launches += 1
    return out.reshape(*lead, n_out, n_frames)


def frames_power(y: torch.Tensor, window: torch.Tensor, *, n_fft: int, hop_length: int,
                 power: float, center: bool, pad_mode: str) -> torch.Tensor:
    """``|rfft(window * frame)|**power`` of every frame of ``y``: ``(..., T, 1 + n_fft // 2)``.

    Pad by ``n_fft // 2`` a side where ``center`` (``pad_mode`` as
    :func:`~librosa_tpu_torch.util.utils.pad_last` takes it), frame with
    ``unfold``, window, ``torch.fft.rfft`` (under the ``'matmul'`` backend
    its products, at that route's precision). ``y`` and ``window`` share a
    device and a real dtype.
    """
    return _frames_power(y, window, n_fft=n_fft, hop_length=hop_length, power=power,
                         center=center, pad_mode=pad_mode, setting=get_matmul_precision())


def _frames_power(y: torch.Tensor, window: torch.Tensor, *, n_fft: int, hop_length: int,
                  power: float, center: bool, pad_mode: str, setting: str) -> torch.Tensor:
    lpad, _ = frame_geometry(y.shape[-1], n_fft=n_fft, hop_length=hop_length,
                             center=center)
    y = pad_last(y, lpad, lpad, mode=pad_mode)
    pw = power_spectrum_at(frame_signal(y, frame_length=n_fft, hop_length=hop_length)
                           * window, setting)
    if power == 1:
        return pw.sqrt()
    if power != 2:
        return pw ** (power / 2)
    return pw


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
    precision: Any = None,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`stft_mel_fused`, on ``y``'s device.

    :func:`frames_power` (pad, ``unfold``, window, ``torch.fft.rfft``,
    ``|.|**power``; the DFT always exact, as the kernel's), then the product
    with the basis at ``precision``'s basis entry: ``torch.matmul`` in full
    float32 (or in float64 for float64 input), or for ``'default'`` and
    ``'high'`` the same rounding of both operands as the kernel's, through
    exact float32 products (:func:`~librosa_tpu_torch.ops.precision.matmul`).
    ``pad_mode`` is one of ``'constant'``, ``'reflect'``, ``'symmetric'``,
    ``'edge'`` or ``'wrap'``.
    """
    setting = _precision.normalize3(precision)[2]
    y = as_tensor(y)
    dtype = y.dtype if y.dtype in (torch.float32, torch.float64) else torch.float32
    y = y.to(dtype)
    win = _table(window, y.device, dtype)
    bas = _table(basis, y.device, dtype)
    pw = _frames_power(y, win, n_fft=n_fft, hop_length=hop_length, power=power,
                       center=center, pad_mode=pad_mode, setting=_precision.HIGHEST)
    return _precision.matmul(bas, pw.transpose(-1, -2), setting)
