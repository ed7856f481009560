"""Seam-free sharded spectrograms by overlap-save halo exchange.

A centred STFT frame ``t`` reads the samples ``[t * hop - n_fft // 2,
t * hop + n_fft - n_fft // 2)``. A signal split into contiguous blocks,
one per position, therefore needs a left halo of ``n_fft // 2`` samples from
the left neighbour and a right halo of ``n_fft - hop - n_fft // 2`` from the
right one, with the global centre padding only at the two end positions.
Each frame then sees exactly the samples, window and transform of the
unsharded call: ``stft_sharded`` equals :func:`~librosa_tpu_torch.stft` bit
for bit, and ``melspectrogram_sharded`` runs the stft_mel kernel
(``csrc/stft_mel.cu``) on each position's extended block, which computes
every frame on its own.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..core.spectrum import _audio, _stft_mel_core, _win_device
from ..ops.fft import frames_rdft
from ..ops.framing import frame_signal
from ..util.exceptions import ParameterError
from ..util.utils import pad_last
from .collectives import Line, Shards, join, shift_left, shift_right, split
from .mesh import Mesh

__all__ = ["stft_sharded", "melspectrogram_sharded"]


def _halo_sizes(n_fft: int, hop_length: int):
    return n_fft // 2, max(0, n_fft - hop_length - n_fft // 2)


def _check_pad_mode(pad_mode: str) -> None:
    if pad_mode not in ("constant", "reflect"):
        raise ParameterError(f"Unsupported sharded pad_mode: {pad_mode}")


def _check_length(n: int, line: Line, hop_length: int) -> int:
    """The samples a position owns; raises unless ``n`` splits into whole hops a position."""
    if n % (line.size * hop_length) != 0:
        raise ParameterError(f"Signal length {n} must be divisible by D*hop = "
                             f"{line.size * hop_length} for seam-free time sharding")
    return n // line.size


def _extend(shards: Shards, line: Line, *, lh: int, rh: int, pad_mode: str) -> Shards:
    """Each shard with ``lh`` samples of its left neighbour before it and ``rh`` of its right
    one after it; the end positions take the global pad (zeros, or the signal reflected)."""
    last = line.size - 1
    per = shards[0].shape[-1]
    lefts = shift_right([s[..., per - lh:] for s in shards], line) if lh else None
    rights = shift_left([s[..., :rh] for s in shards], line) if rh else None
    out = []
    for k, (d, s) in enumerate(zip(line.local, shards)):
        parts = []
        if lh:
            left = lefts[k]
            if pad_mode == "reflect" and d == 0:
                left = s[..., 1:lh + 1].flip(-1)
            parts.append(left)
        parts.append(s)
        if rh:
            right = rights[k]
            if pad_mode == "reflect" and d == last:
                right = s[..., per - rh - 1:per - 1].flip(-1)
            parts.append(right)
        out.append(torch.cat(parts, dim=-1))
    return out


def _local_frames(shards: Shards, windows: Shards, line: Line, *, n_fft: int, hop_length: int,
                  pad_mode: str) -> Shards:
    """Each position's windowed frames ``(..., T_loc, n_fft)``, ``T_loc = per // hop``."""
    lh, rh = _halo_sizes(n_fft, hop_length)
    ext = _extend(shards, line, lh=lh, rh=rh, pad_mode=pad_mode)
    return [frame_signal(e, frame_length=n_fft, hop_length=hop_length) * w
            for e, w in zip(ext, windows)]


def _rfft_by_device(blocks: Shards) -> Shards:
    """``frames_rdft`` of each block of frames ``(..., T_k, n_fft)``; the blocks that share a
    device go through one call.

    cuFFT picks its kernel by the batch size, and on an H100 a batch of up to
    1025 frames gives other bits than a batch of 2048 or more
    (``diagnostics/rfft_batches.py``). One call over a device's blocks gives
    every frame the bits of the unsharded transform.
    """
    out: Shards = [None] * len(blocks)
    groups: dict = {}
    for k, b in enumerate(blocks):
        groups.setdefault(b.device, []).append(k)
    for idx in groups.values():
        spectra = frames_rdft(torch.cat([blocks[k] for k in idx], dim=-2))
        for k, part in zip(idx, spectra.split([blocks[k].shape[-2] for k in idx], dim=-2)):
            out[k] = part
    return out


def _tail_block(y: torch.Tensor, *, n_fft: int, pad_mode: str) -> torch.Tensor:
    """The ``n_fft`` samples of the one trailing centred frame (``t = n // hop``), which
    reaches into the global right pad: the signal's last ``n_fft // 2`` samples, then the pad.
    The reflect pad looks back ``n_fft // 2 + 1`` samples, so a whole ``n_fft`` tail is padded."""
    tail = y[..., -min(y.shape[-1], n_fft):]
    return pad_last(tail, 0, n_fft // 2, mode=pad_mode)[..., -n_fft:]


def _check_shard(per: int, n_fft: int, hop_length: int, what: str = "n_fft") -> None:
    lh, rh = _halo_sizes(n_fft, hop_length)
    if per < max(n_fft, lh + 1, rh + 1):
        raise ParameterError(f"Shard size {per} too small for {what}={n_fft} halos")


def stft_sharded(
    y: Any,
    *,
    mesh: Mesh,
    axis_name: str = "time",
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: Optional[int] = None,
    window: Any = "hann",
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Centred STFT of a signal sharded in time over ``mesh``; bit-equal to :func:`stft`.

    ``y`` ``(..., n)`` needs ``n % (D * hop_length) == 0`` for the ``D``
    positions along ``axis_name``, and each position's block must span at
    least ``n_fft`` samples. Each position frames its block with the halos
    its neighbours send; the one trailing frame spans the global right pad.
    The frames are transformed by ``torch.fft.rfft``, in one call for the
    positions that share a device (:func:`_rfft_by_device`). Returns the
    complex ``(..., 1 + n_fft // 2, n // hop_length + 1)``.
    """
    _check_pad_mode(pad_mode)
    if win_length is None:
        win_length = n_fft
    line = Line.of(mesh, axis_name)
    y = _audio(y)
    per = _check_length(y.shape[-1], line, hop_length)
    _check_shard(per, n_fft, hop_length)
    windows = [_win_device(window, win_length, n_fft, d, y.dtype) for d in line.local_devices]
    frames = _local_frames(split(y, line), windows, line, n_fft=n_fft, hop_length=hop_length,
                           pad_mode=pad_mode)
    w = _win_device(window, win_length, n_fft, line.home, y.dtype)
    tail = _tail_block(y.to(line.home), n_fft=n_fft, pad_mode=pad_mode) * w
    *spectra, tail = _rfft_by_device(frames + [tail.unsqueeze(-2)])   # (..., T_k, bins)
    return torch.cat([join(spectra, line, dim=-2), tail], dim=-2).transpose(-2, -1)


def _mel_sharded(y: torch.Tensor, line: Line, *, sr: float, n_fft: int, hop_length: int,
                 win_length: int, window: Any, pad_mode: str, power: float,
                 **mel_kwargs: Any):
    """``(local mel shards (..., n_mels, T_loc), the trailing frame's mel (..., n_mels, 1))``.

    Each position's extended block goes through the stft_mel route uncentred
    (``per // hop`` frames), and so does the trailing frame's block; on the
    card that is one kernel launch a position and one for the tail.
    """
    from ..feature.spectral import _mel_device

    _check_pad_mode(pad_mode)
    per = _check_length(y.shape[-1], line, hop_length)
    _check_shard(per, n_fft, hop_length)
    lh, rh = _halo_sizes(n_fft, hop_length)
    kw = dict(n_fft=n_fft, hop_length=hop_length, center=False, pad_mode=pad_mode,
              power=float(power))

    def mel(block: torch.Tensor, device: torch.device) -> torch.Tensor:
        win = _win_device(window, win_length, n_fft, device, y.dtype)
        basis, bands = _mel_device(sr, n_fft, device, y.dtype, **mel_kwargs)
        return _stft_mel_core(block, win, basis, bands, **kw)

    ext = _extend(split(y, line), line, lh=lh, rh=rh, pad_mode=pad_mode)
    shards = [mel(e, d) for e, d in zip(ext, line.local_devices)]
    tail = mel(_tail_block(y.to(line.home), n_fft=n_fft, pad_mode=pad_mode), line.home)
    return shards, tail


def melspectrogram_sharded(
    y: Any,
    *,
    mesh: Mesh,
    axis_name: str = "time",
    sr: float = 22050,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: Optional[int] = None,
    window: Any = "hann",
    pad_mode: str = "constant",
    power: float = 2.0,
    n_mels: int = 128,
    **mel_kwargs: Any,
) -> torch.Tensor:
    """Mel spectrogram of a signal sharded in time over ``mesh``: ``(..., n_mels, n // hop + 1)``.

    The halo exchange of :func:`stft_sharded` feeds each position's block
    to the route of :func:`~librosa_tpu_torch.feature.melspectrogram`: on
    the card the stft_mel kernel, once a position and once for the
    trailing frame. ``mel_kwargs`` go to :func:`filters.mel`. Same length
    rules as :func:`stft_sharded`.
    """
    if win_length is None:
        win_length = n_fft
    line = Line.of(mesh, axis_name)
    y = _audio(y)
    shards, tail = _mel_sharded(y, line, sr=sr, n_fft=n_fft, hop_length=hop_length,
                                win_length=win_length, window=window, pad_mode=pad_mode,
                                power=power, n_mels=n_mels, **mel_kwargs)
    return torch.cat([join(shards, line), tail], dim=-1)
