"""Sharded analysis chains: onset strength, tempo, PCEN, pYIN, beats, MFCC and chroma.

- ``onset_strength_sharded``: the mel power of each position's block from
  the stft_mel route (:mod:`.sharded`), the dB step with the ``top_db``
  clamp against the maximum over every position (:func:`.collectives.pmax`,
  per channel as :func:`power_to_db` clamps), and a ``lag``-frame left halo
  for the flux.
- ``tempo_sharded`` and ``beat_track_sharded``: the envelope sharded, then
  the tempogram and the beat DP on the joined envelope (on the card the beat
  DP kernel for a batch of envelopes).
- ``pcen_sharded``: the one-pole smoother is affine in its state, so each
  position smooths its block from zero and its true starting state comes
  from every earlier position's last value (:func:`.collectives.all_gather`).
- ``pyin_sharded``: the frame-wise half on each position's frames, the
  Viterbi decode (on the card the Viterbi kernel) on the joined observations.
- ``mfcc_sharded`` and ``chroma_cqt_sharded``: the sharded mel spectrogram
  or constant-Q transform, then the frame-local steps on the joined result.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .._device import as_tensor
from ..core.spectrum import _audio
from ..util import utils as util
from ..util.exceptions import ParameterError
from .collectives import Line, all_gather, join, pmax, shift_right, split
from .mesh import Mesh
from .sharded import _check_length, _check_pad_mode, _check_shard, _extend, _halo_sizes, \
    _mel_sharded, _tail_block, melspectrogram_sharded

__all__ = ["onset_strength_sharded", "tempo_sharded", "pcen_sharded", "pyin_sharded",
           "beat_track_sharded", "mfcc_sharded", "chroma_cqt_sharded"]

_AMIN = 1e-10
_TOP_DB = 80.0


def _log_power(mel: torch.Tensor) -> torch.Tensor:
    """``10 log10(max(amin, mel))``, as ``power_to_db``'s plain version takes it (ref 1)."""
    return 10.0 * torch.log10(mel.clamp(min=_AMIN))


def _channel_max(x: torch.Tensor) -> torch.Tensor:
    """The maximum over each channel's last two axes, kept as ``(..., 1, 1)``."""
    return x.amax(dim=(-2, -1), keepdim=True)


def _aggregate(flux: torch.Tensor, aggregate: Any) -> torch.Tensor:
    """``aggregate`` over the bands (axis -2), as ``onset_strength`` folds them."""
    return util.sync(flux, [slice(None)], aggregate=aggregate, pad=True, axis=-2)[..., 0, :]


def onset_strength_sharded(
    y: Any,
    *,
    mesh: Mesh,
    axis_name: str = "time",
    sr: float = 22050,
    n_fft: int = 2048,
    hop_length: int = 512,
    lag: int = 1,
    n_mels: int = 128,
    center: bool = True,
    pad_mode: str = "constant",
    aggregate: Any = np.mean,
) -> torch.Tensor:
    """Spectral-flux onset envelope ``(..., n // hop + 1)`` of a signal sharded in time.

    Matches ``onset.onset_strength(y=y, sr=sr, aggregate=aggregate)`` on the
    same signal. The dB clamp's peak is each channel's maximum over every
    position and the trailing frame. Same length rules as
    :func:`stft_sharded`; ``lag`` must be below the frames a position owns.
    """
    line = Line.of(mesh, axis_name)
    y = _audio(y)
    t_loc = _check_length(y.shape[-1], line, hop_length) // hop_length
    if lag >= t_loc:
        raise ParameterError(f"lag={lag} must be < frames per shard {t_loc}")
    mels, tail = _mel_sharded(y, line, sr=sr, n_fft=n_fft, hop_length=hop_length,
                              win_length=n_fft, window="hann", pad_mode=pad_mode, power=2.0,
                              n_mels=n_mels, fmax=0.5 * sr)
    logs = [_log_power(m) for m in mels]
    tail_log = _log_power(tail)
    peaks = pmax([torch.maximum(_channel_max(s), _channel_max(tail_log).to(s.device))
                  for s in logs], line)
    dbs = [torch.maximum(s, p - _TOP_DB) for s, p in zip(logs, peaks)]
    halos = shift_right([s[..., -lag:] for s in dbs], line)
    envs = []
    for d, s, h in zip(line.local, dbs, halos):
        flux = (s - torch.cat([h, s[..., :-lag]], dim=-1)).clamp_min(0.0)
        if d == 0:  # global frames before `lag` have no predecessor
            flux[..., :lag] = 0.0
        envs.append(_aggregate(flux, aggregate))
    # the trailing frame against the last position's last dB frames
    last = all_gather([s[..., -lag:] for s in dbs], line)[0][-1].to(line.home)
    tail_db = torch.maximum(tail_log, peaks[0].to(line.home) - _TOP_DB)
    tail_env = _aggregate((tail_db - last[..., :1]).clamp_min(0.0), aggregate)
    env = torch.cat([join(envs, line), tail_env], dim=-1)
    c = n_fft // (2 * hop_length) if center else 0
    if c:
        env = torch.nn.functional.pad(env, (c, 0))[..., :env.shape[-1]]
    return env


def tempo_sharded(y: Any, *, mesh: Mesh, axis_name: str = "time", sr: float = 22050,
                  hop_length: int = 512, **tempo_kwargs: Any) -> np.ndarray:
    """Tempo in BPM (numpy) of a signal sharded in time: the envelope by
    :func:`onset_strength_sharded`, then :func:`feature.tempo` on the joined envelope.
    ``tempo_kwargs`` go to :func:`feature.tempo`."""
    from ..feature.rhythm import tempo

    env = onset_strength_sharded(y, mesh=mesh, axis_name=axis_name, sr=sr,
                                 hop_length=hop_length)
    return tempo(onset_envelope=env, sr=sr, hop_length=hop_length, **tempo_kwargs)


def pcen_sharded(
    S: Any,
    *,
    mesh: Mesh,
    axis_name: str = "time",
    sr: float = 22050,
    hop_length: int = 512,
    gain: float = 0.98,
    bias: float = 2.0,
    power: float = 0.5,
    time_constant: float = 0.400,
    eps: float = 1e-6,
    b: Optional[float] = None,
) -> torch.Tensor:
    """PCEN of a spectrogram sharded over its frames (last axis); matches :func:`pcen`.

    Position ``d`` smooths its ``L`` frames from a zero state, then adds its
    true starting state decayed over the block: the sum over earlier
    positions ``k`` of ``(1 - b)**(L (d - 1 - k))`` times ``k``'s last
    zero-state value, plus the steady state ``1`` decayed over ``d L`` frames.
    The frame count must split evenly over the positions.
    """
    from ..ops.iir import first_order_filter

    line = Line.of(mesh, axis_name)
    S = as_tensor(S)
    T, D = S.shape[-1], line.size
    if T % D != 0:
        raise ParameterError(f"frame count {T} must be divisible by D={D}")
    L = T // D
    if b is None:
        t_frames = time_constant * sr / float(hop_length)
        b = (np.sqrt(1 + 4 * t_frames**2) - 1) / (2 * t_frames**2)
    b = float(b)
    decay = (1.0 - b) ** L

    shards = split(S, line)
    zero_state = [first_order_filter(s, b0=b, b1=0.0, a1=b - 1.0,
                                     zi=torch.zeros((), dtype=s.dtype, device=s.device))[0]
                  for s in shards]
    ends = all_gather([m[..., -1] for m in zero_state], line)
    out = []
    for d, s, m0, p in zip(line.local, shards, zero_state, ends):
        k = np.arange(D)
        w = torch.as_tensor(np.where(k < d, decay ** (d - 1 - k).astype(np.float64), 0.0),
                            dtype=s.dtype, device=s.device)
        carry = torch.tensordot(w, p, dims=([0], [0])) + (1.0 - b) ** (d * L)
        t = torch.arange(1, L + 1, dtype=s.dtype, device=s.device)
        m = m0 + (1.0 - b) ** t * carry[..., None]
        smooth = torch.exp(-gain * (np.log(eps) + torch.log1p(m / eps)))
        if power == 0:
            out.append(torch.log1p(s * smooth))
        elif bias == 0:
            out.append(torch.exp(power * (torch.log(s) + torch.log(smooth))))
        else:
            out.append((bias**power) * torch.expm1(power * torch.log1p(s * smooth / bias)))
    return join(out, line)


def pyin_sharded(
    y: Any,
    *,
    mesh: Mesh,
    axis_name: str = "time",
    fmin: float,
    fmax: float,
    sr: float = 22050,
    frame_length: int = 2048,
    hop_length: Optional[int] = None,
    n_thresholds: int = 100,
    beta_parameters: tuple = (2, 18),
    boltzmann_parameter: float = 2,
    resolution: float = 0.1,
    max_transition_rate: float = 35.92,
    switch_prob: float = 0.01,
    no_trough_prob: float = 0.01,
    fill_na: Optional[float] = np.nan,
    pad_mode: str = "constant",
    transition_min_prob: Optional[float] = 1e-4,
):
    """pYIN of a signal sharded in time: ``(f0, voiced_flag, voiced_prob)``, as :func:`pyin`
    (``center=True``) gives them.

    Each position frames its block with halos, as :func:`stft_sharded` does,
    and computes the frame-wise half (difference function, trough priors,
    observations); the observations are joined and decoded once (on the card
    by the Viterbi kernel). Same length rules as :func:`stft_sharded`, with
    ``frame_length`` in place of ``n_fft``.
    """
    from ..core import pitch

    pitch._check_yin_params(sr=sr, fmax=fmax, fmin=fmin, frame_length=frame_length,
                            win_length=None)
    if hop_length is None:
        hop_length = frame_length // 4
    _check_pad_mode(pad_mode)
    line = Line.of(mesh, axis_name)
    y = _audio(y)
    per = _check_length(y.shape[-1], line, hop_length)
    _check_shard(per, frame_length, hop_length, "frame_length")
    model = pitch._PyinModel(
        sr=sr, fmin=fmin, fmax=fmax, hop_length=hop_length, n_thresholds=n_thresholds,
        beta_parameters=beta_parameters, resolution=resolution,
        max_transition_rate=max_transition_rate, switch_prob=switch_prob,
        transition_min_prob=transition_min_prob, boltzmann_parameter=boltzmann_parameter,
        no_trough_prob=no_trough_prob)
    lh, rh = _halo_sizes(frame_length, hop_length)
    ext = _extend(split(y, line), line, lh=lh, rh=rh, pad_mode=pad_mode)
    parts = [model.observe(util.frame(e, frame_length=frame_length, hop_length=hop_length),
                           frame_length) for e in ext]
    tail = _tail_block(y.to(line.home), n_fft=frame_length, pad_mode=pad_mode)
    obs_tail, vp_tail = model.observe(tail.unsqueeze(-1), frame_length)
    obs = torch.cat([join([o for o, _ in parts], line), obs_tail], dim=-1)
    voiced_prob = torch.cat([join([v for _, v in parts], line), vp_tail], dim=-1)
    f0, voiced_flag = model.decode(obs, fill_na)
    return f0, voiced_flag, voiced_prob


def beat_track_sharded(y: Any, *, mesh: Mesh, axis_name: str = "time", sr: float = 22050,
                       hop_length: int = 512, **beat_kwargs: Any):
    """Beat tracking of a signal sharded in time: the envelope (the median over the mel
    bands) by :func:`onset_strength_sharded`, then :func:`beat.beat_track` on the joined
    envelope. Returns ``(tempo, beats)`` as ``beat.beat_track`` does; ``beat_kwargs`` go to
    it (a batch of tracks needs ``sparse=False``)."""
    from .. import beat

    env = onset_strength_sharded(y, mesh=mesh, axis_name=axis_name, sr=sr,
                                 hop_length=hop_length, aggregate=np.median)
    return beat.beat_track(onset_envelope=env, sr=sr, hop_length=hop_length, **beat_kwargs)


def mfcc_sharded(
    y: Any,
    *,
    mesh: Mesh,
    axis_name: str = "time",
    sr: float = 22050,
    n_mfcc: int = 20,
    dct_type: int = 2,
    norm: Optional[str] = "ortho",
    lifter: float = 0,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    **mel_kwargs: Any,
) -> torch.Tensor:
    """MFCCs ``(..., n_mfcc, n // hop + 1)`` of a signal sharded in time.

    :func:`melspectrogram_sharded`, then on the joined mel spectrogram the
    steps of :func:`feature.mfcc`: :func:`power_to_db` (on the card the dB
    kernel, whose ``top_db`` clamp needs every frame) and the DCT.
    """
    from ..core.spectrum import power_to_db
    from ..feature.spectral import mfcc

    M = melspectrogram_sharded(y, mesh=mesh, axis_name=axis_name, sr=sr, n_fft=n_fft,
                               hop_length=hop_length, n_mels=n_mels, **mel_kwargs)
    return mfcc(S=power_to_db(M), n_mfcc=n_mfcc, dct_type=dct_type, norm=norm, lifter=lifter)


def chroma_cqt_sharded(
    y: Any,
    *,
    mesh: Mesh,
    axis_name: str = "time",
    sr: float = 22050,
    hop_length: int = 512,
    fmin: Optional[float] = None,
    norm: Optional[float] = np.inf,
    threshold: float = 0.0,
    n_chroma: int = 12,
    n_octaves: int = 7,
    bins_per_octave: int = 36,
) -> torch.Tensor:
    """Constant-Q chromagram ``(..., n_chroma, T)`` of a signal sharded in time.

    The magnitudes of :func:`cqt_sharded`, then the pitch-class fold,
    threshold and normalisation of :func:`feature.chroma_cqt`, which are
    frame-local, on the joined result.
    """
    from ..core.convert import note_to_hz
    from ..feature.spectral import _cq_chroma
    from .constantq import cqt_sharded

    if fmin is None:
        fmin = note_to_hz("C1")
    C = cqt_sharded(y, mesh=mesh, axis_name=axis_name, sr=sr, hop_length=hop_length, fmin=fmin,
                    n_bins=n_octaves * bins_per_octave, bins_per_octave=bins_per_octave).abs()
    return _cq_chroma(C, bins_per_octave=bins_per_octave, n_chroma=n_chroma, fmin=fmin,
                      window=None, norm=norm, threshold=threshold)
