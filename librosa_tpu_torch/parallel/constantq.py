"""Constant-Q transform of a signal sharded in time: the octave ladder with halos at every rung.

The ladder of :func:`~librosa_tpu_torch.cqt` is a chain (each octave reads
the previous one's signal at half the rate), but each step reads only a
short neighbourhood: an octave's frames an ``n_fft`` window, the polyphase
half-band decimation its filter's taps. Both halos move between
neighbouring positions at every rung, so each position holds its span of
the signal at every rate of the ladder. The plan, the filters and the
decimator are the port's own (``core/constantq.py``, ``core/audio.py``), so
the sharded ladder equals ``cqt(..., res_type='polyphase')`` to float32
rounding.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .. import filters
from .._device import exact_f32
from ..core import audio
from ..core.constantq import _filters_device, _grid, _ladder_plan, _trim_stack, _twos
from ..core.spectrum import _audio, _win_device
from ..ops.fft import frames_rdft
from ..util.exceptions import ParameterError
from ..util.utils import _torch_dtype, dtype_r2c, expand_to
from .collectives import Line, Shards, all_gather, join, shift_left, shift_right, split
from .mesh import Mesh
from .sharded import _check_length, _check_pad_mode, _check_shard, _local_frames, _tail_block

__all__ = ["cqt_sharded"]


def _decimate_local(shards: Shards, line: Line, factor: int) -> Shards:
    """Each position's block decimated ``factor``:1, as ``resample(..., orig_sr=factor,
    target_sr=1, res_type='polyphase', scale=True)`` gives it on the whole signal.

    The filter, its padding and alignment are ``resample_poly``'s for the
    whole signal's length. Each block takes a halo of whole ``factor``
    periods that covers the filter's reach from each neighbour (zeros at the
    ends, as the whole signal's convolution pads), so every output sample
    sums the same taps over the same samples.
    """
    per = shards[0].shape[-1]
    n = per * line.size
    h = audio._poly_filter(1, factor)
    half_len = (len(h) - 1) // 2
    n_pre_pad = factor - half_len % factor
    n_pre_remove = (half_len + n_pre_pad) // factor
    n_out = -(-n // factor)
    n_post_pad = 0
    while audio._upfirdn_len(len(h) + n_pre_pad + n_post_pad, n, 1, factor) < n_out + n_pre_remove:
        n_post_pad += 1
    h_padded = np.concatenate([np.zeros(n_pre_pad), h, np.zeros(n_post_pad)])
    halo = -(-len(h) // factor) * factor
    if per < halo:
        raise ParameterError(f"Shard size {per} too small for the {len(h)}-tap decimator")
    lefts = shift_right([s[..., per - halo:] for s in shards], line)
    rights = shift_left([s[..., :halo] for s in shards], line)
    out = []
    for s, left, right in zip(shards, lefts, rights):
        ext = torch.cat([left, s, right], dim=-1)
        dec = audio._upfirdn_conv(ext, h_padded, (n_pre_pad, n_post_pad), up=1, down=factor,
                                  n_pre_remove=n_pre_remove + halo // factor,
                                  n_out=per // factor)
        out.append((dec / np.sqrt(1.0 / factor)).to(s.dtype))
    return out


def cqt_sharded(
    y: Any,
    *,
    mesh: Mesh,
    axis_name: str = "time",
    sr: float = 22050,
    hop_length: int = 512,
    fmin: Optional[float] = None,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    filter_scale: float = 1,
    norm: Optional[float] = 1,
    sparsity: float = 0.01,
    window: Any = "hann",
    scale: bool = True,
    pad_mode: str = "constant",
    dtype: Any = None,
) -> torch.Tensor:
    """Constant-Q transform ``(..., n_bins, T)`` of a signal sharded in time; equals
    ``cqt(y, ..., res_type='polyphase')``.

    Needs ``n`` divisible by ``D * hop_length`` and, at every rung of the
    ladder, each position's block at least that rung's ``n_fft`` (and the
    decimator's halo). The trailing centred frame of each rung is computed
    from the last position's block.
    """
    _check_pad_mode(pad_mode)
    line = Line.of(mesh, axis_name)
    y = _audio(y)
    dtype = dtype_r2c(y.dtype) if dtype is None else _torch_dtype(dtype)
    freqs, alpha, _, cutoff = _grid(sr=sr, fmin=fmin, n_bins=n_bins, intervals="equal",
                                    bins_per_octave=bins_per_octave, tuning=0.0, window=window,
                                    filter_scale=filter_scale, gamma=0)
    n_bins = len(freqs)
    if cutoff > sr / 2.0:
        raise ParameterError("Wavelet basis exceeds Nyquist")
    n_octaves = int(np.ceil(float(n_bins) / bins_per_octave))
    n_filters = min(bins_per_octave, n_bins)
    per = _check_length(y.shape[-1], line, hop_length)

    shards = split(y, line)
    down = max(0, min(int(np.ceil(np.log2(sr / 2.0 / cutoff))) - 2,
                      _twos(hop_length) - (n_octaves - 1)))
    if down:
        factor = 1 << down
        shards = _decimate_local(shards, line, factor)
        if not scale:
            shards = [s * np.sqrt(factor) for s in shards]
        sr, hop_length, per = sr / factor, hop_length // factor, per // factor

    work = dtype_r2c(y.dtype)
    responses = []
    rung_sr = sr
    for rate, hop, bins in _ladder_plan(sr, hop_length, freqs, n_filters, n_octaves):
        if rate != rung_sr:
            shards = _decimate_local(shards, line, 2)
            rung_sr, per = rate, per // 2

        def basis_on(device):
            return _filters_device(device, work, rate, freqs[bins], filter_scale, norm, sparsity,
                                   window=window, gamma=0, alpha=alpha[bins],
                                   gain=float(np.sqrt(sr / rate)))[:2]

        n_fft = basis_on(line.home)[1]
        _check_shard(per, n_fft, hop)
        wins = [_win_device("ones", n_fft, n_fft, d, y.dtype) for d in line.local_devices]
        frames = _local_frames(shards, wins, line, n_fft=n_fft, hop_length=hop, pad_mode=pad_mode)
        with exact_f32():
            resp = [torch.matmul(basis_on(d)[0], frames_rdft(f).transpose(-2, -1))
                    for d, f in zip(line.local_devices, frames)]
            # the rung's trailing centred frame, from the last position's block
            last = all_gather([s[..., -n_fft:] for s in shards], line)[0][-1].to(line.home)
            tail = frames_rdft(_tail_block(last, n_fft=n_fft, pad_mode=pad_mode)
                               * _win_device("ones", n_fft, n_fft, line.home, y.dtype))
            tail_resp = torch.matmul(basis_on(line.home)[0], tail.unsqueeze(-1))
        responses.append(torch.cat([join(resp, line), tail_resp], dim=-1))

    V = _trim_stack(responses, n_bins)
    if scale:
        weights = 1.0 / np.sqrt(filters.wavelet_lengths(
            freqs=freqs, sr=sr, window=window, filter_scale=filter_scale, gamma=0,
            alpha=alpha)[0])
    else:
        weights = np.ones(n_bins)
    V = V * expand_to(torch.as_tensor(weights.astype(np.float32), device=V.device,
                                      dtype=V.real.dtype), ndim=V.ndim, axes=-2)
    return V.to(dtype)
