"""Peak picking: the windowed candidacy tests as torch ops, the wait-spaced selection on the host.

A frame is a candidate when it equals the maximum of its window
``[n - pre_max, n + post_max)`` and reaches the mean of ``[n - pre_avg, n +
post_avg)`` plus ``delta`` (windows clipped to the envelope). The selection
is sequential: 'greedy' takes candidates left to right at least ``wait``
frames apart; the DP takes the spaced set with the largest count or summed
height. The JAX package runs the selection as a ``lax.scan`` over frames,
vmapped over rows (``librosa_tpu/ops/peaks.py``); here it is a loop over
frames on the host with numpy over all rows at once, since each step is a
few comparisons per row. One envelope alone runs the float64 host loops of
the JAX package (:func:`greedy_1d`, :func:`dp_1d`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["candidate_mask", "greedy_select", "dp_select", "greedy_1d", "dp_1d"]


def candidate_mask(x: torch.Tensor, *, pre_max: int, post_max: int, pre_avg: int, post_avg: int,
                   delta: float) -> torch.Tensor:
    """Candidates of ``x`` ``(rows, T)`` on its device: a boolean tensor of the same shape."""
    wmax = F.pad(x, (pre_max, post_max - 1), value=float("-inf"))
    wmax = wmax.unfold(-1, pre_max + post_max, 1).amax(dim=-1)
    width = pre_avg + post_avg
    wsum = F.pad(x, (pre_avg, post_avg - 1)).unfold(-1, width, 1).sum(dim=-1)
    count = F.pad(torch.ones_like(x[:1]), (pre_avg, post_avg - 1)).unfold(-1, width, 1).sum(dim=-1)
    return (x == wmax) & (x >= wsum / count + delta)


def greedy_select(cand: np.ndarray, wait: int) -> np.ndarray:
    """Candidates taken left to right, each at least ``wait + 1`` frames after the last taken one."""
    rows, T = cand.shape
    out = np.zeros_like(cand, dtype=bool)
    countdown = np.zeros(rows, dtype=np.int64)
    for n in range(T):
        take = cand[:, n] & (countdown == 0)
        out[:, n] = take
        countdown = np.where(take, wait, np.maximum(countdown - 1, 0))
    return out


def dp_select(cand: np.ndarray, gain: np.ndarray, wait: int) -> np.ndarray:
    """The spaced candidate set of largest total ``gain`` per row (float32, as the JAX scan).

    Backward: ``value[n] = max(value[n + 1], value[min(T, n + wait + 1)] +
    gain[n])`` where ``n`` is a candidate (taken only if strictly larger),
    then forward from frame 0, jumping ``wait + 1`` frames after each taken one.
    """
    rows, T = cand.shape
    values = np.zeros((rows, T + 1), dtype=np.float32)
    taken = np.zeros((rows, T), dtype=bool)
    gain = gain.astype(np.float32)
    for n in range(T - 1, -1, -1):
        nxt = min(T, n + wait + 1)
        with_n = values[:, nxt] + gain[:, n]
        take = cand[:, n] & (with_n > values[:, n + 1])
        taken[:, n] = take
        values[:, n] = np.where(take, with_n, values[:, n + 1])
    out = np.zeros_like(taken)
    for r in range(rows):
        n = 0
        while n < T:
            if taken[r, n]:
                out[r, n] = True
                n += wait + 1
            else:
                n += 1
    return out


def greedy_1d(x: np.ndarray, *, pre_max: int, post_max: int, pre_avg: int, post_avg: int,
              delta: float, wait: int) -> np.ndarray:
    """Greedy peak picking of one float64 envelope, frame by frame."""
    n_frames = x.shape[0]
    peaks = np.zeros(n_frames, dtype=bool)
    if n_frames == 0:
        return peaks
    p0 = x[0] >= np.max(x[:min(post_max, n_frames)])
    p0 &= x[0] >= np.mean(x[:min(post_avg, n_frames)]) + delta
    peaks[0] = p0
    n = wait + 1 if p0 else 1
    while n < n_frames:
        if x[n] != np.max(x[max(0, n - pre_max):min(n + post_max, n_frames)]):
            n += 1
            continue
        if x[n] < np.mean(x[max(0, n - pre_avg):min(n + post_avg, n_frames)]) + delta:
            n += 1
            continue
        peaks[n] = True
        n += wait + 1
    return peaks


def dp_1d(x: np.ndarray, *, pre_max: int, post_max: int, pre_avg: int, post_avg: int,
          delta: float, wait: int, count: bool) -> np.ndarray:
    """The largest spaced peak set of one float64 envelope by a backward DP with pointers."""
    n_frames = len(x)
    values = np.zeros(n_frames + 1)
    pointers = np.zeros(n_frames + 1, dtype=np.int64)
    taken = np.zeros(n_frames + 1, dtype=bool)
    cumulate = np.cumsum(x)
    pointers[-1] = -1
    for n in range(n_frames - 1, -1, -1):
        values[n] = values[n + 1]
        pointers[n] = n + 1
        if x[n] < np.max(x[max(0, n - pre_max):min(n + post_max, n_frames)]):
            continue
        lo, hi = max(0, n - pre_avg), min(n + post_avg, n_frames)
        avg = (cumulate[hi - 1] - (cumulate[lo - 1] if lo else 0.0)) / (hi - lo)
        v = 1.0 if count else x[n]
        nxt = min(n_frames, n + wait + 1)
        if x[n] >= avg + delta and values[nxt] + v > values[n + 1]:
            values[n] = values[nxt] + v
            pointers[n] = nxt
            taken[n] = True
    peaks = np.zeros(n_frames, dtype=bool)
    n = 0
    while pointers[n] >= 0:
        peaks[n] = taken[n]
        n = pointers[n]
    return peaks
