"""Exception classes of the PyTorch port.

Counterpart of ``librosa_tpu/util/exceptions.py``: the same two names, so
code written against either package catches the same errors by name.
"""

from __future__ import annotations

__all__ = ["LibrosaError", "ParameterError"]


class LibrosaError(Exception):
    """Root of every error the port raises on purpose."""


class ParameterError(LibrosaError):
    """An argument is malformed or out of range (bad mode, short input, ...)."""
