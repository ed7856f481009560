"""Weak-scaling harness for the sharded chains.

Times one sharded chain at several mesh sizes with the same audio a
position and reports its throughput against linear scaling from the
smallest mesh. Every sharded entry point of :mod:`librosa_tpu_torch.parallel`
has a chain here. Times are CUDA events on a card and the host clock on the
CPU. ``devices`` lays the positions: ``[torch.device("cuda:0")] * 8`` puts
eight positions on one card, where the points measure what sharding costs
on that card and not how the chain scales across cards.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .mesh import _visible, make_mesh
from .sharded import melspectrogram_sharded, stft_sharded

__all__ = ["ScalingPoint", "scaling_report", "scaling_report_all", "CHAINS"]


def _sync(out: Any) -> float:
    """Wait for a chain's output (tensor, array, tuple) and reduce it to one float64 number."""
    if isinstance(out, (tuple, list)):
        return sum(_sync(o) for o in out)
    x = out.abs() if isinstance(out, torch.Tensor) and out.is_complex() else out
    if isinstance(x, torch.Tensor):
        return float(x.double().nansum())
    return float(np.nansum(np.abs(np.asarray(x, dtype=np.float64))))


def _make_chains() -> dict:
    """Runner per sharded entry point: ``(y, mesh, sr, n_fft, hop) -> output``."""
    from .analysis import (beat_track_sharded, chroma_cqt_sharded, mfcc_sharded,
                           onset_strength_sharded, pcen_sharded, pyin_sharded, tempo_sharded)
    from .constantq import cqt_sharded
    from .effects import hpss_sharded

    return {
        "stft": lambda y, mesh, sr, n_fft, hop: stft_sharded(
            y, mesh=mesh, n_fft=n_fft, hop_length=hop),
        "melspectrogram": lambda y, mesh, sr, n_fft, hop: melspectrogram_sharded(
            y, mesh=mesh, n_fft=n_fft, hop_length=hop),
        "onset_strength": lambda y, mesh, sr, n_fft, hop: onset_strength_sharded(
            y, mesh=mesh, sr=sr, hop_length=hop),
        "tempo": lambda y, mesh, sr, n_fft, hop: tempo_sharded(
            y, mesh=mesh, sr=sr, hop_length=hop),
        # the mel spectrogram's n // hop whole frames, which split evenly over the positions
        "pcen": lambda y, mesh, sr, n_fft, hop: pcen_sharded(
            melspectrogram_sharded(y, mesh=mesh, n_fft=n_fft, hop_length=hop)[..., :-1],
            mesh=mesh, sr=sr, hop_length=hop),
        "cqt": lambda y, mesh, sr, n_fft, hop: cqt_sharded(
            y, mesh=mesh, sr=sr, hop_length=hop),
        "hpss": lambda y, mesh, sr, n_fft, hop: hpss_sharded(y, mesh=mesh),
        "pyin": lambda y, mesh, sr, n_fft, hop: pyin_sharded(
            y, mesh=mesh, sr=sr, fmin=65, fmax=2093),
        "beat_track": lambda y, mesh, sr, n_fft, hop: beat_track_sharded(
            y, mesh=mesh, sr=sr, hop_length=hop),
        "mfcc": lambda y, mesh, sr, n_fft, hop: mfcc_sharded(
            y, mesh=mesh, sr=sr, n_fft=n_fft, hop_length=hop),
        "chroma_cqt": lambda y, mesh, sr, n_fft, hop: chroma_cqt_sharded(
            y, mesh=mesh, sr=sr, hop_length=hop),
    }


CHAINS: dict = {}
"""Name -> runner for every sharded entry point (filled at first use)."""


def _chains() -> dict:
    if not CHAINS:
        CHAINS.update(_make_chains())
    return CHAINS


@dataclass
class ScalingPoint:
    """One point of a weak-scaling curve (:func:`scaling_report`).

    ``samples_per_s`` is the chain's audio throughput at ``n_devices``
    positions, ``efficiency`` its ratio to linear scaling from the smallest
    mesh measured (1.0: ``D`` times the audio in the same time), ``seconds``
    the best time of one run and ``device`` where the positions lay.
    """

    n_devices: int
    samples_per_s: float
    efficiency: float
    chain: str = "melspectrogram"
    seconds: float = 0.0
    device: str = ""


def _seconds(run, device: torch.device, iters: int) -> float:
    """Best time of ``iters`` runs: CUDA events on a card, the host clock on the CPU."""
    best = float("inf")
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
    return best


def scaling_report(
    *,
    chain: str = "melspectrogram",
    device_counts: Optional[Sequence[int]] = None,
    seconds_per_device: float = 60.0,
    sr: int = 22050,
    n_fft: int = 2048,
    hop_length: int = 512,
    iters: int = 3,
    devices: Any = None,
) -> List[ScalingPoint]:
    """Weak scaling of one sharded chain (any key of ``CHAINS``).

    Each position gets ``seconds_per_device`` of seeded noise, rounded to
    whole hops, so linear scaling keeps the time flat. ``devices`` (default:
    every visible position) lays the positions, the first ``D`` for a mesh
    of ``D``; ``device_counts`` defaults to the powers of two up to their
    number. Each point is the best of ``iters`` timed runs after one
    untimed run.
    """
    runners = _chains()
    if chain not in runners:
        raise ValueError(f"Unknown chain {chain!r}; choose one of {sorted(runners)}")
    runner = runners[chain]
    if devices is None:
        devices = [d for _, d in _visible()]
    devices = [torch.device(d) for d in devices]
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8) if d <= len(devices)]

    rng = np.random.RandomState(0)
    points: List[ScalingPoint] = []
    base_rate = None
    for d in device_counts:
        n = int(seconds_per_device * sr) * d
        n -= n % (d * hop_length)
        y = torch.from_numpy(rng.randn(n).astype(np.float32)).to(devices[0])
        mesh = make_mesh((d,), ("time",), devices=devices[:d])

        def run():
            return _sync(runner(y, mesh, sr, n_fft, hop_length))

        run()
        dt = _seconds(run, devices[0], iters)
        rate = n / dt
        if base_rate is None:
            base_rate = rate / d
        points.append(ScalingPoint(n_devices=d, samples_per_s=rate,
                                   efficiency=rate / (base_rate * d), chain=chain, seconds=dt,
                                   device=str(devices[0])))
    return points


def scaling_report_all(*, chains: Optional[Sequence[str]] = None,
                       **kwargs: Any) -> List[ScalingPoint]:
    """:func:`scaling_report` for every chain (or ``chains``), concatenated."""
    points: List[ScalingPoint] = []
    for name in chains if chains is not None else sorted(_chains()):
        points.extend(scaling_report(chain=name, **kwargs))
    return points


if __name__ == "__main__":
    import sys

    names = sys.argv[1:] or ["melspectrogram"]
    if names == ["all"]:
        names = sorted(_chains())
    for name in names:
        for p in scaling_report(chain=name, seconds_per_device=30.0):
            print(f"{p.chain:>15s} {p.n_devices:2d} positions on {p.device}: "
                  f"{p.samples_per_s / 1e6:9.1f} Msamples/s, efficiency {100 * p.efficiency:5.1f}%")
