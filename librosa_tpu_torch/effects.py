"""Effects on waveforms: harmonic-percussive separation.

Only the HPSS pipeline so far: :func:`stft`, then
:func:`~librosa_tpu_torch.decompose.hpss` (two median_filter kernel
launches on the card), then one :func:`istft` per part at the input's length
(one ola_norm kernel launch each).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from . import decompose
from .core.spectrum import _audio, istft, stft

__all__ = ["hpss", "harmonic", "percussive"]


def hpss(
    y: Any,
    *,
    kernel_size: Any = 31,
    power: float = 2.0,
    mask: bool = False,
    margin: Any = 1.0,
    n_fft: int = 2048,
    hop_length: Optional[int] = None,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    pad_mode: str = "constant",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Harmonic and percussive waveforms ``(y_harm, y_perc)`` of ``y`` ``(..., n)``, each ``(..., n)``.

    ``kernel_size``, ``power``, ``mask`` and ``margin`` go to
    :func:`~librosa_tpu_torch.decompose.hpss` and the rest to :func:`stft`
    and :func:`istft`; the outputs have ``y``'s dtype.
    """
    y = _audio(y)
    kw = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length, window=window,
              center=center)
    D = stft(y, pad_mode=pad_mode, **kw)
    harm, perc = decompose.hpss(D, kernel_size=kernel_size, power=power, mask=mask,
                                margin=margin)
    return (istft(harm, dtype=y.dtype, length=y.shape[-1], **kw),
            istft(perc, dtype=y.dtype, length=y.shape[-1], **kw))


def harmonic(y: Any, **kwargs: Any) -> torch.Tensor:
    """The harmonic waveform of ``y``: the first part of :func:`hpss`, which takes ``kwargs``."""
    return hpss(y, **kwargs)[0]


def percussive(y: Any, **kwargs: Any) -> torch.Tensor:
    """The percussive waveform of ``y``: the second part of :func:`hpss`, which takes ``kwargs``."""
    return hpss(y, **kwargs)[1]
