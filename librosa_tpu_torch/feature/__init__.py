"""Feature extraction: mel spectrogram, MFCC, chroma, tonnetz, the spectral descriptors, RMS,
zero-crossing rate, tempograms and tempo, delta features and memory stacking, and the
inversions in ``feature.inverse``."""

from .rhythm import *  # noqa: F401,F403
from .spectral import *  # noqa: F401,F403
from .utils import delta, stack_memory  # noqa: F401
from .inverse import mel_to_audio, mel_to_stft, mfcc_to_audio, mfcc_to_mel  # noqa: F401
