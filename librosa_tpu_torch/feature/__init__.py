"""Feature extraction: mel spectrogram, MFCC, chroma, spectral centroid and roll-off, RMS,
zero-crossing rate, tempograms and tempo."""

from .rhythm import *  # noqa: F401,F403
from .spectral import *  # noqa: F401,F403
