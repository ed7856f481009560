"""Input signals made from a seed, in bulk, on the device that will hold them.

A traffic mix names its signal by the name of a function here; each takes
``(rows, samples, seed, device, sr)`` and returns float32 ``(rows, samples)``.
A signal with tempi and starting pitches also names, in :data:`GRIDS`, the
function that gives them from the seed, so that a run can print them.
"""

from __future__ import annotations

import numpy as np
import torch

BPM = (80.0, 160.0)
F0_HZ = (110.0, 440.0)


def _random_grid(rows: int, seed: int, device):
    """The seed's generator and, drawn from it, a tempo (BPM) and a starting pitch (Hz) a row,
    each ``(rows, 1)`` float64 and uniform over its range (the pitch in octaves)."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    f64 = dict(device=device, dtype=torch.float64)
    bpm = BPM[0] + (BPM[1] - BPM[0]) * torch.rand(rows, 1, generator=g, **f64)
    f0 = F0_HZ[0] * 2 ** (np.log2(F0_HZ[1] / F0_HZ[0]) * torch.rand(rows, 1, generator=g, **f64))
    return g, bpm, f0


def _even_grid(rows: int, seed: int, device):
    """The seed's generator, and a tempo and starting pitch a row at the middles of ``rows``
    equal steps over their ranges (the pitch's in octaves), the same for every seed. Row ``i``
    takes step ``(i + rows // 2) % rows``: the rows start at the grid's middle, because the beat
    tracker sizes one smoothing window for the whole batch from its first row's tempo, and an
    ascending grid would always hand it the slowest, widest one."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    step = (torch.arange(rows, device=device) + rows // 2) % rows
    mid = (step.double().reshape(rows, 1) + 0.5) / rows
    bpm = BPM[0] + (BPM[1] - BPM[0]) * mid
    f0 = F0_HZ[0] * 2 ** (np.log2(F0_HZ[1] / F0_HZ[0]) * mid)
    return g, bpm, f0


def _melody(g: torch.Generator, bpm: torch.Tensor, f0: torch.Tensor, samples: int,
            sr: float) -> torch.Tensor:
    """Tracks of a melody over clicks at tempi ``bpm`` from starting pitches ``f0``, the rest
    drawn from ``g``: the melody's steps and the noise."""
    rows, device = bpm.shape[0], bpm.device
    f64 = dict(device=device, dtype=torch.float64)
    t = torch.arange(samples, **f64) / sr
    beat_pos = t * bpm / 60
    # as many steps as the fastest tempo needs, whatever this seed's tempi are
    n_steps = int(np.ceil(samples / sr * BPM[1] / 60)) + 2
    steps = torch.randint(-3, 4, (rows, n_steps), generator=g, device=device)
    semis = torch.cumsum(steps, 1).clamp(-12, 12).double().gather(1, beat_pos.long())
    pitch = f0 * 2 ** (semis / 12) * (1 + 0.003 * torch.sin(2 * np.pi * 5 * t))
    phase = 2 * np.pi * torch.cumsum(pitch / sr, dim=1)
    tone = sum(torch.sin(k * phase) / k for k in range(1, 5))
    frac = torch.frac(beat_pos)
    noise = torch.randn(rows, samples, generator=g, **f64)
    y = 0.2 * tone * torch.exp(-8 * frac) + 0.3 * noise * torch.exp(-frac * 60 / bpm * 200)
    return (y + 0.01 * noise).float()


def melody_clicks(rows: int, samples: int, seed: int, device, sr: float) -> torch.Tensor:
    """Tracks of a melody over clicks, each at a tempo of its own.

    Per track: a tempo of 80-160 BPM; a tone of four harmonics whose pitch
    steps by up to three semitones on each beat (at most an octave from a
    start of 110-440 Hz), with a 5 Hz vibrato of 0.3 %, decaying after each
    beat; a noise burst on each beat; a noise floor 40 dB down. Every seed
    gives the same sizes; only the content differs.
    """
    return _melody(*_random_grid(rows, seed, device), samples, sr)


def melody_clicks_even(rows: int, samples: int, seed: int, device, sr: float) -> torch.Tensor:
    """:func:`melody_clicks` with the tempi and starting pitches on an even grid.

    Row ``i`` of ``rows`` plays at ``80 + 80 (j + 1/2) / rows`` BPM from
    ``110 * 4 ** ((j + 1/2) / rows)`` Hz, with ``j = (i + rows // 2) % rows``,
    whatever the seed, so every seed and every batch of a pool gives the beat
    tracker and pYIN the same tempi and pitch ranges; the seed draws the
    melody's steps and the noise.
    """
    return _melody(*_even_grid(rows, seed, device), samples, sr)


#: each signal's tempi and starting pitches from its seed: ``(generator, bpm, f0)``
GRIDS = {"melody_clicks": _random_grid, "melody_clicks_even": _even_grid}
