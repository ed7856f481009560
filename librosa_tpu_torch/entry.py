"""Entry points: each main path as one forward function, with an example input."""

from __future__ import annotations

import numpy as np

from . import feature
from .core.audio import resample
from .core.spectrum import _spectrogram, griffinlim, power_to_db

SR = 22050


def entry():
    """Return ``(forward, example_args)`` for y -> mel spectrogram -> dB -> MFCC.

    The same forward as the JAX package's entry: 4 s at 22050 Hz, n_fft
    2048, hop 512, 128 mels, 20 coefficients.
    """
    def forward(y):
        M = feature.melspectrogram(y=y, sr=SR, n_fft=2048, hop_length=512, n_mels=128)
        return feature.mfcc(S=power_to_db(M), n_mfcc=20)

    return forward, (np.zeros(SR * 4, dtype=np.float32),)


def feature_stack():
    """Return ``(forward, example_args)`` for the feature stack of a batch of tracks.

    ``forward(y)`` gives ``(mfcc, chroma, centroid, rolloff)`` of ``y``
    ``(..., n)``: 20 MFCCs over 128 mels, 12 chroma at A440, spectral
    centroid and 85 % roll-off, all at n_fft 2048 and hop 512. Each feature
    is computed from ``y`` on its own, as the four public functions do: on
    the card the stft_mel kernel runs four times (mel, chroma and twice the
    identity basis) and the db_scale kernel once.
    """
    kw = dict(sr=SR, n_fft=2048, hop_length=512)

    def forward(y):
        return (feature.mfcc(y=y, n_mfcc=20, n_mels=128, **kw),
                feature.chroma_stft(y=y, tuning=0.0, n_chroma=12, **kw),
                feature.spectral_centroid(y=y, **kw),
                feature.spectral_rolloff(y=y, **kw))

    return forward, (np.zeros((2, SR * 4), dtype=np.float32),)


def reconstruction(init="random"):
    """Return ``(forward, example_args)`` for resample -> |STFT| -> Griffin-Lim.

    ``forward(y)`` resamples ``y`` ``(..., n)`` from 22050 Hz to 16000 Hz
    (polyphase: up 320, down 441), takes the magnitude spectrogram at n_fft
    2048 and hop 512, and recovers a signal from the magnitudes alone with
    32 rounds of Griffin-Lim from seed 0. It returns ``(y16k, y_hat)``, both
    ``(..., ceil(n * 320 / 441))``. On the card the stft_mel kernel runs once
    (identity basis) and the ola_norm kernel 33 times. ``init=None`` starts
    from zero phase instead of random phases.
    """
    kw = dict(n_fft=2048, hop_length=512)

    def forward(y):
        y16k = resample(y, orig_sr=SR, target_sr=16000, res_type="polyphase")
        S, _ = _spectrogram(y=y16k, power=1, **kw)
        y_hat = griffinlim(S, n_iter=32, rng=0, init=init, length=y16k.shape[-1], **kw)
        return y16k, y_hat

    return forward, (np.zeros((2, SR * 4), dtype=np.float32),)
