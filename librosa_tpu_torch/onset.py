"""Onset detection: the spectral-flux envelope on the device, event picking on the host.

``onset_strength`` from ``y`` at its defaults is ``melspectrogram`` (on the
card the stft_mel kernel, ``csrc/stft_mel.cu``), ``power_to_db`` (the
db_scale kernel, ``csrc/db_scale.cu``), the lagged positive difference and
the mean (or median) over the mel bands, all on ``y``'s device. Picking,
backtracking and unit conversion work on small event lists on the host, as
in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ._device import as_tensor
from .core.convert import frames_to_samples, frames_to_time
from .core.spectrum import power_to_db
from .feature.spectral import melspectrogram
from .ops.iir import first_order_filter
from .util import profiling
from .util import utils as util
from .util.exceptions import ParameterError
from .util.matching import match_events

__all__ = ["onset_detect", "onset_strength", "onset_strength_multi", "onset_backtrack"]


def onset_strength(*, y: Any = None, sr: float = 22050, S: Any = None, lag: int = 1,
                   max_size: int = 1, ref: Optional[Any] = None, detrend: bool = False,
                   center: bool = True, feature: Optional[Callable] = None,
                   aggregate: Optional[Union[Callable, bool]] = None,
                   **kwargs: Any) -> torch.Tensor:
    """Spectral-flux onset strength ``(..., T)``: the positive ``lag``-frame difference of dB mels.

    ``S`` is a log-power spectrogram given instead of ``y``; ``feature``
    (default :func:`feature.melspectrogram`, up to ``sr / 2``) makes it from
    ``y`` with ``kwargs``. ``max_size > 1`` takes the difference against a
    maximum filter over that many bands (SuperFlux), ``ref`` against a given
    spectrum. ``aggregate`` (default the mean) folds the bands;
    ``detrend`` removes the DC with ``(1 - z^-1) / (1 - 0.99 z^-1)``;
    ``center`` shifts the envelope onto centred frames.
    """
    with profiling.annotate("onset_strength"):
        if aggregate is False:
            raise ParameterError(
                "onset_strength always aggregates over frequency; use "
                "onset_strength_multi for unaggregated envelopes"
            )
        env = onset_strength_multi(y=y, sr=sr, S=S, lag=lag, max_size=max_size, ref=ref,
                                   detrend=detrend, center=center, feature=feature,
                                   aggregate=aggregate, channels=None, **kwargs)
        return env[..., 0, :]


def _max_filter_bands(S: torch.Tensor, size: int) -> torch.Tensor:
    """Centred maximum over ``size`` bands along axis -2, the ends repeated."""
    padded = util.pad_last(S.movedim(-2, -1), size // 2, size - 1 - size // 2, mode="edge")
    return padded.unfold(-1, size, 1).amax(dim=-1).movedim(-1, -2)


def onset_strength_multi(*, y: Any = None, sr: float = 22050, S: Any = None, n_fft: int = 2048,
                         hop_length: int = 512, lag: int = 1, max_size: int = 1,
                         ref: Optional[Any] = None, detrend: bool = False, center: bool = True,
                         feature: Optional[Callable] = None,
                         aggregate: Optional[Union[Callable, bool]] = None,
                         channels: Optional[Sequence] = None, **kwargs: Any) -> torch.Tensor:
    """Onset strength per group of bands: ``(..., n_channels, T)``.

    ``channels`` lists band boundaries (indices or slices; None: one group
    of every band); the other parameters are :func:`onset_strength`'s.
    ``aggregate=False`` keeps every band.
    """
    if feature is None:
        feature = melspectrogram
        kwargs.setdefault("fmax", 0.5 * sr)
    if aggregate is None:
        aggregate = np.mean
    for knob, value in (("lag", lag), ("max_size", max_size)):
        if not util.is_positive_int(value):
            raise ParameterError(f"{knob} must be a whole number of frames >= 1; got {value}")

    if S is None:
        S = power_to_db(feature(y=y, sr=sr, n_fft=n_fft, hop_length=hop_length, **kwargs).abs())
    else:
        S = as_tensor(S)
    if S.ndim < 2:
        S = S.reshape(1, -1)

    if ref is not None:
        ref_arr = as_tensor(ref).to(S.device)
        if ref_arr.shape != S.shape:
            raise ParameterError(f"the flux reference must match the spectrum shape "
                                 f"{tuple(S.shape)}; got {tuple(ref_arr.shape)}")
    elif max_size == 1:
        ref_arr = S
    else:
        ref_arr = _max_filter_bands(S, max_size)

    onset_env = (S[..., lag:] - ref_arr[..., :-lag]).clamp_min(0.0)
    if callable(aggregate):
        groups = [slice(None)] if channels is None else channels
        onset_env = util.sync(onset_env, groups, aggregate=aggregate, pad=channels is None,
                              axis=-2)

    pad_width = lag + (n_fft // (2 * hop_length) if center else 0)
    onset_env = F.pad(onset_env, (int(pad_width), 0))
    if detrend:
        onset_env, _ = first_order_filter(onset_env, b0=1.0, b1=-1.0, a1=-0.99,
                                          zi=torch.zeros_like(onset_env[..., :1]))
    if center:
        onset_env = onset_env[..., :S.shape[-1]]
    return onset_env


def onset_backtrack(events: Any, energy: Any) -> np.ndarray:
    """Each event moved back to the nearest local minimum of ``energy`` at or before it."""
    level = util._host(energy)
    interior = level[1:-1]
    dips = 1 + np.flatnonzero((interior <= level[:-2]) & (interior < level[2:]))
    dips = util.fix_frames(dips, x_min=0)
    return dips[match_events(util._host(events), dips, right=False)]


def onset_detect(*, y: Any = None, sr: float = 22050, onset_envelope: Optional[Any] = None,
                 hop_length: int = 512, backtrack: bool = False, energy: Optional[Any] = None,
                 units: str = "frames", normalize: bool = True, sparse: bool = True,
                 **kwargs: Any) -> np.ndarray:
    """Onset events picked from the onset envelope (numpy: frames, samples or seconds).

    The envelope is scaled to [0, 1] (``normalize``) and peak-picked with
    30 ms max windows and wait, 100 ms mean windows and ``delta`` 0.07
    (``kwargs`` override them). ``backtrack`` moves each onset to the
    preceding minimum of ``energy`` (default: the envelope). ``sparse=False``
    gives a boolean mask per frame.
    """
    if onset_envelope is None:
        if y is None:
            raise ParameterError("onset detection needs a signal (y) or an onset envelope")
        onset_envelope = onset_strength(y=y, sr=sr, hop_length=hop_length)
    envelope = util._host(onset_envelope)
    if normalize:
        floor = np.min(envelope, keepdims=True, axis=-1)
        span = np.max(envelope, keepdims=True, axis=-1) - floor
        envelope = (envelope - floor) / (span + util.tiny(envelope))

    if not envelope.any() or not np.isfinite(envelope).all():
        picks = np.array([], dtype=int) if sparse else np.zeros_like(envelope, dtype=bool)
    else:
        params = {"pre_max": 0.03 * sr // hop_length, "post_max": 0.00 * sr // hop_length + 1,
                  "pre_avg": 0.10 * sr // hop_length, "post_avg": 0.10 * sr // hop_length + 1,
                  "wait": 0.03 * sr // hop_length, "delta": 0.07}
        params.update(kwargs)
        picks = util.peak_pick(envelope, sparse=sparse, axis=-1, **params)
        if backtrack:
            if not sparse:
                raise ParameterError("backtracking needs sparse=True (frame indices)")
            picks = onset_backtrack(picks, envelope if energy is None else energy)

    if not sparse or units == "frames":
        return picks
    if units == "samples":
        return frames_to_samples(picks, hop_length=hop_length)
    if units == "time":
        return frames_to_time(picks, hop_length=hop_length, sr=sr)
    raise ParameterError(f"units must be frames, samples, or time; got {units!r}")
