"""Frequency-scale conversions (host numpy, float64).

These build the mel filterbank's frequency grids. They run once per
configuration on the host, so they stay in numpy; only the finished
filterbank goes to the card.
"""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = ["hz_to_mel", "mel_to_hz", "fft_frequencies", "mel_frequencies"]

# Slaney's mel scale: linear (200/3 Hz per mel) below 1 kHz, logarithmic
# above it with 27 mels per factor of 6.4 in frequency.
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies: Any, *, htk: bool = False) -> np.ndarray:
    """Frequencies in Hz to mels (Slaney's scale, or HTK's with ``htk``)."""
    f = np.asanyarray(frequencies)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    if f.ndim:
        mels[log_region] = _MIN_LOG_MEL + np.log(f[log_region] / _MIN_LOG_HZ) / _LOGSTEP
    elif log_region:
        mels = _MIN_LOG_MEL + np.log(f / _MIN_LOG_HZ) / _LOGSTEP
    return mels


def mel_to_hz(mels: Any, *, htk: bool = False) -> np.ndarray:
    """Mels to frequencies in Hz; the inverse of :func:`hz_to_mel`."""
    m = np.asanyarray(mels)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    freqs = _F_SP * m
    log_region = m >= _MIN_LOG_MEL
    if m.ndim:
        freqs[log_region] = _MIN_LOG_HZ * np.exp(_LOGSTEP * (m[log_region] - _MIN_LOG_MEL))
    elif log_region:
        freqs = _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL))
    return freqs


def fft_frequencies(*, sr: float = 22050, n_fft: int = 2048) -> np.ndarray:
    """Centre frequencies of the ``1 + n_fft // 2`` real-FFT bins, in Hz."""
    return np.fft.rfftfreq(n=n_fft, d=1.0 / sr)


def mel_frequencies(
    n_mels: int = 128, *, fmin: float = 0.0, fmax: float = 11025.0, htk: bool = False
) -> np.ndarray:
    """``n_mels`` frequencies evenly spaced on the mel scale from fmin to fmax."""
    mels = np.linspace(hz_to_mel(fmin, htk=htk), hz_to_mel(fmax, htk=htk), n_mels)
    return mel_to_hz(mels, htk=htk)
