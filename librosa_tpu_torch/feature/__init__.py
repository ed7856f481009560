"""Feature extraction: mel spectrogram, MFCC, chroma, spectral centroid and roll-off, RMS."""

from .spectral import *  # noqa: F401,F403
