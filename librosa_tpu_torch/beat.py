"""Beat tracking (Ellis 2007) and the predominant local pulse (Grosche and Mueller 2011).

``beat_track`` estimates the tempo, smooths the onset envelope with a
tempo-matched Gaussian (numpy on the host, as in the JAX package) and
decodes beats by dynamic programming. One envelope runs the DP on the host
in the port's C++ (``csrc/hostdp.cpp``); a batch runs it on the envelope's
device (on the card the kernel ``csrc/beat_dp.cu``, which raises where its
``kernel_refusal`` refuses). Backtracking and trimming are host loops over a few
thousand frames. ``plp`` is an STFT of the envelope and torch ops.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ._device import as_tensor
from .core.convert import fourier_tempo_frequencies, frames_to_samples, frames_to_time
from .core.spectrum import istft, stft
from .feature.rhythm import tempo as _tempo
from .onset import onset_strength
from .ops import beat_dp as _dp
from .util import profiling
from .util import utils as util
from .util.exceptions import ParameterError

__all__ = ["beat_track", "plp"]


def _local_score(onset_envelope: np.ndarray, frames_per_beat: np.ndarray) -> np.ndarray:
    """The envelope over its standard deviation, smoothed by a Gaussian of about one beat.

    A tempo per row convolves every row with the window of the first row's
    tempo (the JAX package's rule); a tempo per frame smooths frame ``i``
    with its own window of half-width ``int(fpb_i)``.
    """
    oe = onset_envelope / (onset_envelope.std(ddof=1, axis=-1, keepdims=True)
                           + util.tiny(onset_envelope))
    N = oe.shape[-1]
    flat = oe.reshape(-1, N)
    if frames_per_beat.shape[-1] == 1:
        # one window for every row, at the first row's tempo, as in the JAX package
        fpb = float(frames_per_beat.reshape(-1)[0])
        window = np.exp(-0.5 * (np.arange(-fpb, fpb + 1) * 32.0 / fpb) ** 2)
        res = np.empty_like(flat)
        for r in range(flat.shape[0]):
            res[r] = np.convolve(flat[r], window, mode="same")
        return res.reshape(oe.shape)
    fpb_flat = np.broadcast_to(frames_per_beat, oe.shape).reshape(-1, N)
    half = fpb_flat.astype(np.int64)
    taps = np.arange(int(2 * half.max() + 1))
    idx = np.arange(N)
    # tap k of frame i reads sample i + h_i - k, for k in [max(0, i + h_i - N + 1), min(i + h_i, 2 h_i + 1))
    src = idx[None, :, None] + half[:, :, None] - taps[None, None, :]
    k_lo = np.maximum(0, idx[None, :, None] + half[:, :, None] - N + 1)
    k_hi = np.minimum(idx[None, :, None] + half[:, :, None], 2 * half[:, :, None] + 1)
    mask = (taps >= k_lo) & (taps < k_hi)
    weights = np.exp(-0.5 * ((taps - fpb_flat[:, :, None]) * 32.0 / fpb_flat[:, :, None]) ** 2)
    gathered = np.take_along_axis(flat[:, None, :],
                                  np.clip(src, 0, N - 1).reshape(flat.shape[0], 1, -1),
                                  axis=-1).reshape(src.shape)
    res = np.sum(np.where(mask, weights * gathered, 0.0), axis=-1)
    return res.reshape(oe.shape).astype(oe.dtype)


def _last_beats(cumscore: np.ndarray) -> np.ndarray:
    """Per row, the last local maximum of ``cumscore`` at or above half the median of its maxima."""
    flat = cumscore.reshape(-1, cumscore.shape[-1])
    lmax = np.zeros(flat.shape, dtype=bool)
    lmax[:, 1:-1] = (flat[:, 1:-1] > flat[:, :-2]) & (flat[:, 1:-1] >= flat[:, 2:])
    if flat.shape[-1] > 1:
        lmax[:, -1] = flat[:, -1] > flat[:, -2]
    tails = np.empty(flat.shape[0], dtype=int)
    for r in range(flat.shape[0]):
        peaks = flat[r][lmax[r]]
        threshold = 0.5 * np.median(peaks) if len(peaks) else 0.0
        hits = np.flatnonzero(lmax[r] & (flat[r] >= threshold))
        tails[r] = hits[-1] if len(hits) else flat.shape[1] - 1
    return tails


def _trim_beats(localscore: np.ndarray, beats: np.ndarray, trim: bool) -> np.ndarray:
    """Beats at the ends whose local score is at or below a threshold, removed, per row."""
    out = beats.copy()
    w = np.hanning(5)
    flat_l = localscore.reshape(-1, localscore.shape[-1])
    flat_b = out.reshape(-1, out.shape[-1])
    for ls, bt in zip(flat_l, flat_b):
        smooth_boe = np.convolve(ls[bt], w)[len(w) // 2:len(ls) + len(w) // 2]
        threshold = 0.5 * ((smooth_boe ** 2).mean() ** 0.5) if trim and len(smooth_boe) else 0.0
        n = 0
        while n < len(ls) and ls[n] <= threshold:
            bt[n] = False
            n += 1
        n = len(ls) - 1
        while n >= 0 and ls[n] <= threshold:
            bt[n] = False
            n -= 1
    return out


def _beat_tracker(onset_envelope: np.ndarray, bpm: np.ndarray, frame_rate: float,
                  tightness: float, trim: bool, device: torch.device) -> np.ndarray:
    """The beat mask of each envelope row, the batched DP on ``device``."""
    if np.any(bpm <= 0):
        raise ParameterError(f"bpm={bpm} must be strictly positive")
    if tightness <= 0:
        raise ParameterError("tightness must be strictly positive")
    if bpm.shape[-1] not in (1, onset_envelope.shape[-1]):
        raise ParameterError(f"Invalid bpm shape={bpm.shape} does not match "
                             f"onset envelope shape={onset_envelope.shape}")
    frames_per_beat = np.round(frame_rate * 60.0 / bpm)
    with profiling.annotate("beat.local_score"):
        localscore = _local_score(onset_envelope, frames_per_beat)
    tv = frames_per_beat.shape[-1] > 1

    if localscore.ndim == 1:
        fpb = np.broadcast_to(frames_per_beat, localscore.shape if tv else (1,))
        backlink, cumscore = _dp.beat_dp_host(localscore, fpb, tightness)
        backlink, cumscore = backlink[None], cumscore[None]
    else:
        T = localscore.shape[-1]
        ls = torch.as_tensor(localscore.reshape(-1, T), dtype=torch.float32, device=device)
        fpb = np.broadcast_to(frames_per_beat,
                              onset_envelope.shape if tv else (*onset_envelope.shape[:-1], 1))
        fpb = torch.as_tensor(np.array(fpb, dtype=np.float32).reshape(ls.shape[0], -1),
                              device=device)
        backlink, cumscore = _dp.beat_dp(ls, fpb, tightness)
        backlink = util._host(backlink)
        cumscore = util._host(cumscore).astype(np.float64)

    with profiling.annotate("beat.backtrack"):
        tails = _last_beats(cumscore)
        beats = np.zeros(backlink.shape, dtype=bool)
        for r, n in enumerate(tails):
            while n >= 0:
                beats[r, n] = True
                n = int(backlink[r, n])
    with profiling.annotate("beat.trim"):
        return _trim_beats(localscore, beats.reshape(localscore.shape), trim)


def beat_track(*, y: Any = None, sr: float = 22050, onset_envelope: Optional[Any] = None,
               hop_length: int = 512, start_bpm: float = 120.0, tightness: float = 100,
               trim: bool = True, bpm: Optional[Any] = None, prior: Optional[Any] = None,
               units: str = "frames", sparse: bool = True) -> Tuple[Any, np.ndarray]:
    """Tempo and beats of ``y`` or an onset envelope ``(..., T)``, as numpy.

    ``bpm`` (scalar, per channel or per frame) skips the tempo estimate
    (``start_bpm``, ``prior``); ``tightness`` weighs the penalty for beats
    off the period; ``trim`` drops weak beats at the ends. ``sparse`` gives
    beat positions in ``units`` (1-d input only), else a boolean mask.
    """
    with profiling.annotate("beat_track"):
        if onset_envelope is None:
            if y is None:
                raise ParameterError("beat tracking needs a signal (y) or an onset envelope")
            onset_envelope = onset_strength(aggregate=np.median, hop_length=hop_length, sr=sr, y=y)
        env_t = as_tensor(onset_envelope)
        envelope = util._host(env_t)
        if sparse and envelope.ndim != 1:
            raise ParameterError(
                f"frame-index (sparse) output is single-channel only; this envelope has "
                f"{envelope.ndim} dimensions — set sparse=False or downmix first")
        if not envelope.any():
            if sparse:
                return 0.0, np.array([], dtype=int)
            return np.zeros(envelope.shape[:-1], dtype=float), np.zeros_like(envelope, dtype=bool)
        if bpm is None:
            bpm = _tempo(onset_envelope=env_t, sr=sr, hop_length=hop_length, start_bpm=start_bpm,
                         prior=prior)
        tempi = np.atleast_1d(util._host(bpm))
        tempi = tempi.reshape(tempi.shape + (1,) * (envelope.ndim - tempi.ndim))
        beat_mask = _beat_tracker(envelope, tempi, float(sr) / hop_length, tightness, trim,
                                  env_t.device)
        if not sparse:
            return bpm, beat_mask
        frames = np.flatnonzero(beat_mask)
        if units == "frames":
            return bpm, frames
        if units == "samples":
            return bpm, frames_to_samples(frames, hop_length=hop_length)
        if units == "time":
            return bpm, frames_to_time(frames, hop_length=hop_length, sr=sr)
        raise ParameterError(f"units must be frames, samples, or time; got {units!r}")


def plp(*, y: Any = None, sr: float = 22050, onset_envelope: Optional[Any] = None,
        hop_length: int = 512, win_length: int = 384, tempo_min: Optional[float] = 30,
        tempo_max: Optional[float] = 300, prior: Optional[Any] = None) -> torch.Tensor:
    """Predominant local pulse ``(..., T)``: the strongest Fourier-tempogram bin per frame, resynthesised.

    Bins outside ``[tempo_min, tempo_max]`` BPM are dropped, ``prior``
    weighs the rest; the inverse STFT of the unit-magnitude peaks is
    half-wave rectified and scaled to a peak of 1.
    """
    if onset_envelope is None:
        onset_envelope = onset_strength(y=y, sr=sr, hop_length=hop_length, aggregate=np.median)
    env = as_tensor(onset_envelope)
    if tempo_min is not None and tempo_max is not None and tempo_max <= tempo_min:
        raise ParameterError(f"tempo_max={tempo_max} must be larger than tempo_min={tempo_min}")
    tempo_freqs = fourier_tempo_frequencies(sr=sr, hop_length=hop_length, win_length=win_length)
    keep = np.ones_like(tempo_freqs, dtype=bool)
    if tempo_min is not None:
        keep &= tempo_freqs >= tempo_min
    if tempo_max is not None:
        keep &= tempo_freqs <= tempo_max

    ftgram = stft(env, n_fft=win_length, hop_length=1, center=True, window="hann")
    ftgram = torch.where(torch.as_tensor(keep, device=env.device).reshape(-1, 1), ftgram, 0)
    ftmag = torch.log1p(1e6 * ftgram.abs())
    if prior is not None:
        logprior = np.asarray(prior.logpdf(tempo_freqs), dtype=np.float32)
        ftmag = ftmag + torch.as_tensor(logprior, device=env.device).reshape(-1, 1)
    peak_values = ftmag.amax(dim=-2, keepdim=True)
    ftgram = torch.where(ftmag < peak_values, torch.zeros_like(ftgram), ftgram)
    # numpy's (and the JAX package's) maximum of complex numbers: the largest real part, then
    # the largest imaginary part among those; its magnitude scales the column
    re_max = ftgram.real.amax(dim=-2, keepdim=True)
    im_max = torch.where(ftgram.real == re_max, ftgram.imag, float("-inf")).amax(dim=-2,
                                                                                keepdim=True)
    ftgram = ftgram / (util.tiny(ftgram) ** 0.5 + torch.complex(re_max, im_max).abs())
    pulse = istft(ftgram, hop_length=1, n_fft=win_length, length=env.shape[-1])
    return util.normalize(pulse.clamp_min(0), axis=-1)
