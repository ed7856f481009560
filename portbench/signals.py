"""Input signals made from a seed, in bulk, on the device that will hold them.

A traffic mix names its signal by the name of a function here; each takes
``(rows, samples, seed, device, sr)`` and returns float32 ``(rows, samples)``.
"""

from __future__ import annotations

import numpy as np
import torch


def melody_clicks(rows: int, samples: int, seed: int, device, sr: float) -> torch.Tensor:
    """Tracks of a melody over clicks, each at a tempo of its own.

    Per track: a tempo of 80-160 BPM; a tone of four harmonics whose pitch
    steps by up to three semitones on each beat (at most an octave from a
    start of 110-440 Hz), with a 5 Hz vibrato of 0.3 %, decaying after each
    beat; a noise burst on each beat; a noise floor 40 dB down. Every seed
    gives the same sizes; only the content differs.
    """
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    f64 = dict(device=device, dtype=torch.float64)
    t = torch.arange(samples, **f64) / sr
    bpm = 80 + 80 * torch.rand(rows, 1, generator=g, **f64)
    f0 = 110 * 2 ** (2 * torch.rand(rows, 1, generator=g, **f64))
    beat_pos = t * bpm / 60
    # as many steps as the fastest tempo needs, whatever this seed's tempi are
    n_steps = int(np.ceil(samples / sr * 160 / 60)) + 2
    steps = torch.randint(-3, 4, (rows, n_steps), generator=g, device=device)
    semis = torch.cumsum(steps, 1).clamp(-12, 12).double().gather(1, beat_pos.long())
    pitch = f0 * 2 ** (semis / 12) * (1 + 0.003 * torch.sin(2 * np.pi * 5 * t))
    phase = 2 * np.pi * torch.cumsum(pitch / sr, dim=1)
    tone = sum(torch.sin(k * phase) / k for k in range(1, 5))
    frac = torch.frac(beat_pos)
    noise = torch.randn(rows, samples, generator=g, **f64)
    y = 0.2 * tone * torch.exp(-8 * frac) + 0.3 * noise * torch.exp(-frac * 60 / bpm * 200)
    return (y + 0.01 * noise).float()
