"""Feature extraction: mel spectrogram, MFCC, chroma, spectral centroid and roll-off, RMS,
zero-crossing rate."""

from .spectral import *  # noqa: F401,F403
