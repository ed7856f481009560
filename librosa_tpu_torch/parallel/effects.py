"""Harmonic-percussive separation of a signal sharded in time, by overlap-save.

``effects.hpss`` couples neighbouring positions twice: the harmonic median
looks ``kernel_size // 2`` frames along time, and the inverse STFT's
overlap-add draws on frames up to ``n_fft // hop`` away. Each position
therefore receives a signal halo wide enough to rebuild every frame its own
samples depend on, plus the median's reach, runs the whole chain on that
extended frame set and keeps its own samples. Frames outside the global
grid are masked out of the overlap-add, and the frames the time median
reads beyond the global ends are taken by the same symmetric reflection the
unsharded median pads with. The medians run through
:func:`~librosa_tpu_torch.decompose.hpss` (on the card the median kernel,
``csrc/median_filter.cu``, twice a position); the masked overlap-add is
plain torch (``ops/framing.py:overlap_add``), divided by the window's
sum-of-squares envelope of the whole signal, as :func:`istft` divides.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from ..core.spectrum import _audio, _win_device, _wss_device
from ..decompose import _hpss_core
from ..ops.fft import frames_rdft
from ..ops.framing import frame_signal, overlap_add
from ..util.exceptions import ParameterError
from ..util.utils import _pair, tiny
from .collectives import Line, join, shift_left, shift_right, split
from .mesh import Mesh
from .sharded import _check_length, _check_pad_mode

__all__ = ["hpss_sharded"]


def hpss_sharded(
    y: Any,
    *,
    mesh: Mesh,
    axis_name: str = "time",
    kernel_size: Any = 31,
    power: float = 2.0,
    margin: Any = 1.0,
    n_fft: int = 2048,
    hop_length: int = 512,
    window: str = "hann",
    pad_mode: str = "constant",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``effects.hpss`` of a signal sharded in time: ``(y_harm, y_perc)``, each ``(..., n)``.

    ``n`` must split into ``D * hop_length`` blocks, and each position's
    block must hold its halos: ``n / D >= (n_fft // hop + 2 * max(1,
    kernel // 2)) * hop + n_fft // 2``. ``kernel_size``, ``power`` and
    ``margin`` are :func:`decompose.hpss`'s (a pair each for harmonic and
    percussive, or one for both).
    """
    _check_pad_mode(pad_mode)
    win_harm, win_perc = (int(k) for k in _pair(kernel_size, "kernel_size"))
    margin_harm, margin_perc = (float(m) for m in _pair(margin, "margin"))
    if margin_harm < 1 or margin_perc < 1:
        raise ParameterError("Margins must be >= 1.0.")
    line = Line.of(mesh, axis_name)
    y = _audio(y)
    n = y.shape[-1]
    per = _check_length(n, line, hop_length)
    t_loc, t_total, lh = per // hop_length, n // hop_length, n_fft // 2
    # frames beyond the block on each side: the overlap-add's reach and the median's
    F = n_fft // hop_length + 2 * max(win_harm // 2, 1)
    hl = F * hop_length + lh
    hr = (t_loc + 2 * F - 1) * hop_length + n_fft - hl - per
    if per < max(hl, hr):
        raise ParameterError(f"Shard size {per} too small for halo {max(hl, hr)} "
                             f"(n_fft={n_fft}, kernel={win_harm})")
    wss = _wss_device(window, n_frames=t_total + 1, win_length=n_fft, n_fft=n_fft,
                      hop_length=hop_length, start=lh, out_len=n, device=line.home,
                      dtype=y.dtype)
    shards = split(y, line)
    lefts = shift_right([s[..., per - hl:] for s in shards], line)
    rights = shift_left([s[..., :hr] for s in shards], line)
    harm, perc = [], []
    for d, s, left, right in zip(line.local, shards, lefts, rights):
        if pad_mode == "reflect" and d == 0:
            left = torch.cat([s.new_zeros((*s.shape[:-1], hl - lh)), s[..., 1:lh + 1].flip(-1)],
                             dim=-1)
        if pad_mode == "reflect" and d == line.size - 1:
            right = torch.cat([s[..., per - lh - 1:per - 1].flip(-1),
                               s.new_zeros((*s.shape[:-1], hr - lh))], dim=-1)
        w = _win_device(window, n_fft, n_fft, s.device, s.dtype)
        frames = frame_signal(torch.cat([left, s, right], dim=-1), frame_length=n_fft,
                              hop_length=hop_length)
        g = d * t_loc - F + torch.arange(frames.shape[-2], device=s.device)
        valid = (g >= 0) & (g <= t_total)
        # frames past the global ends as the unsharded median's symmetric pad reads them
        g_ref = torch.where(g < 0, -g - 1, g)
        g_ref = torch.where(g_ref > t_total, 2 * t_total + 1 - g_ref, g_ref)
        spec = frames_rdft(frames * w).index_select(-2, g_ref - (d * t_loc - F))
        parts = _hpss_core(spec.transpose(-2, -1), win_harm=win_harm, win_perc=win_perc,
                           power=float(power), margin_harm=margin_harm,
                           margin_perc=margin_perc, mask=False)
        lo = lh + F * hop_length
        env = wss[..., d * per:(d + 1) * per].to(s.device)
        good = env > tiny(env)
        for part, out in zip(parts, (harm, perc)):
            fr = torch.fft.irfft(part.transpose(-2, -1), n=n_fft, dim=-1).to(s.dtype)
            fr = fr * w * valid.to(s.dtype)[:, None]
            y_own = overlap_add(fr, hop_length=hop_length)[..., lo:lo + per]
            out.append(torch.where(good, y_own / torch.where(good, env, 1.0), y_own))
    return join(harm, line), join(perc, line)
