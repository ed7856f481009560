"""Opt-in on-disk caching of host tables, through ``joblib.Memory``.

``cache(level=L)`` memoizes a function to disk only when a cache
directory is configured (``LIBROSA_CACHE_DIR``) and ``L`` is at or below
the manager's level (``LIBROSA_CACHE_LEVEL``, default 10); otherwise it
returns the function itself. ``joblib`` is imported only when a directory
is set, so the package imports without it.
"""

from __future__ import annotations

import logging
import os
import pprint
from typing import Any, Callable

__all__ = ["cache", "CacheManager"]


class CacheManager:
    """A ``joblib.Memory`` (``args`` and ``kwargs`` are its own) with a level filter.

    With no location (``None``, the default) no ``Memory`` is made:
    decorated functions stay undecorated, :meth:`eval` calls the function,
    :meth:`clear` and :meth:`reduce_size` do nothing.
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        self.level = kwargs.pop("level", 10)
        location = args[0] if args else kwargs.get("location")
        self.memory = None
        if location is not None:
            from joblib import Memory

            self.memory = Memory(*args, **kwargs)

    def __call__(self, level: int) -> Callable:
        """Decorator: cache the function on disk if a directory is set and ``level`` is enabled."""
        def wrapper(function: Callable) -> Callable:
            if self.memory is not None and self.level >= level:
                return self.memory.cache(function)
            return function

        return wrapper

    def clear(self, *args: Any, **kwargs: Any) -> None:
        """Delete the cache directory's contents (``joblib.Memory.clear``)."""
        if self.memory is not None:
            self.memory.clear(*args, **kwargs)

    def eval(self, func: Callable, *args: Any, **kwargs: Any) -> Any:
        """``func(*args, **kwargs)``, served from the cache where it holds the call."""
        if self.memory is None:
            return func(*args, **kwargs)
        return self.memory.eval(func, *args, **kwargs)

    def format(self, obj: Any, indent: int = 0) -> str:
        """``obj`` pretty-printed as joblib's logs print it (depth 3)."""
        if self.memory is None:
            return pprint.pformat(obj, indent=indent, depth=3)
        return self.memory.format(obj, indent=indent)

    def reduce_size(self, *args: Any, **kwargs: Any) -> None:
        """Evict entries until the cache fits its limits (``joblib.Memory.reduce_size``)."""
        if self.memory is not None:
            self.memory.reduce_size(*args, **kwargs)

    def warn(self, msg: str) -> None:
        """Log ``msg`` as a warning, as ``joblib.Memory.warn`` does."""
        if self.memory is None:
            logging.getLogger(__name__).warning("[%s]: %s", self, msg)
        else:
            self.memory.warn(msg)


cache = CacheManager(
    os.environ.get("LIBROSA_CACHE_DIR", None),
    mmap_mode=os.environ.get("LIBROSA_CACHE_MMAP", None),
    compress=os.environ.get("LIBROSA_CACHE_COMPRESS", False),
    verbose=int(os.environ.get("LIBROSA_CACHE_VERBOSE", 0)),
    level=int(os.environ.get("LIBROSA_CACHE_LEVEL", 10)),
)
