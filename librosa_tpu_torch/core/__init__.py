"""Core layer: unit conversions and spectral transforms."""

from .convert import *  # noqa: F401,F403
from .spectrum import *  # noqa: F401,F403
