"""Utility layer: exceptions, array helpers, non-negative least squares, example files, API
life-cycle helpers."""

from .utils import *  # noqa: F401,F403
from .matching import match_events, match_intervals  # noqa: F401
from ._nnls import nnls  # noqa: F401
from .exceptions import LibrosaError, ParameterError  # noqa: F401
from .files import cite, ex, example, example_info, find_files, list_examples  # noqa: F401
from .deprecation import Deprecated, rename_kw  # noqa: F401
from . import decorators, deprecation, exceptions, files, matching, profiling  # noqa: F401
