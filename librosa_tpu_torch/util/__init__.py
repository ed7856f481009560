"""Utility layer: exceptions and array helpers."""

from .utils import *  # noqa: F401,F403
from .exceptions import LibrosaError, ParameterError  # noqa: F401
from . import exceptions  # noqa: F401
