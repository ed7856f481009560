"""Entry point: the main path as one forward function, with an example input."""

from __future__ import annotations

import numpy as np

from . import feature
from .core.spectrum import power_to_db


def entry():
    """Return ``(forward, example_args)`` for y -> mel spectrogram -> dB -> MFCC.

    The same forward as the JAX package's entry: 4 s at 22050 Hz, n_fft
    2048, hop 512, 128 mels, 20 coefficients.
    """
    sr = 22050
    n = sr * 4

    def forward(y):
        M = feature.melspectrogram(y=y, sr=sr, n_fft=2048, hop_length=512, n_mels=128)
        return feature.mfcc(S=power_to_db(M), n_mfcc=20)

    return forward, (np.zeros(n, dtype=np.float32),)
