"""Core layer: unit conversions, spectral transforms, resampling, pitch and harmonics."""

from .audio import *  # noqa: F401,F403
from .convert import *  # noqa: F401,F403
from .pitch import *  # noqa: F401,F403
from .spectrum import *  # noqa: F401,F403
from . import harmonic  # noqa: F401
