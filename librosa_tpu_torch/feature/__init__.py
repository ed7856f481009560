"""Feature extraction: mel spectrogram and MFCC."""

from .spectral import *  # noqa: F401,F403
