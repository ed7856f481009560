"""Decorators for an API's life cycle: moved, deprecated, a default about to change; and vectorize."""

from __future__ import annotations

import functools
import inspect
import warnings
from typing import Any, Callable, TypeVar

import numpy as np

__all__ = ["moved", "deprecated", "vectorize", "future_default"]

F = TypeVar("F", bound=Callable[..., Any])


def _lifecycle_notice(text: str) -> None:
    """A FutureWarning attributed to the code that called the decorated function."""
    warnings.warn(text, FutureWarning, stacklevel=3)


def moved(*, moved_from: str, version: str, version_removed: str) -> Callable[[F], F]:
    """Mark a function as moved: a call through its old name ``moved_from`` warns, then runs it."""

    def __wrapper(func: F) -> F:
        new_home = f"{func.__module__}.{func.__name__}"

        @functools.wraps(func)
        def _inner(*args: Any, **kwargs: Any) -> Any:
            _lifecycle_notice(
                f"{moved_from} is a backward-compatibility alias: the "
                f"function now lives at '{new_home}' (since {version}), "
                f"and the old name goes away in {version_removed}."
            )
            return func(*args, **kwargs)

        return _inner  # type: ignore[return-value]

    return __wrapper


def deprecated(*, version: str, version_removed: str) -> Callable[[F], F]:
    """Mark a function as deprecated: every call warns with the removal version, then runs it."""

    def __wrapper(func: F) -> F:
        qualified = f"{func.__module__}.{func.__name__}"

        @functools.wraps(func)
        def _inner(*args: Any, **kwargs: Any) -> Any:
            _lifecycle_notice(
                f"{qualified} has been deprecated since {version} and is "
                f"scheduled for removal in {version_removed}."
            )
            return func(*args, **kwargs)

        return _inner  # type: ignore[return-value]

    return __wrapper


def vectorize(*, otypes: Any = None, doc: Any = None, excluded: Any = None,
              cache: bool = False, signature: Any = None):
    """``np.vectorize`` that keeps the decorated function's name and docstring."""

    def __wrapper(function: F) -> F:
        vecfunc = np.vectorize(function, otypes=otypes, doc=doc, excluded=excluded,
                               cache=cache, signature=signature)
        return functools.wraps(function)(vecfunc)  # type: ignore[return-value]

    return __wrapper


def future_default(*, param_name: str, old_default: Any, new_default: Any, version: str):
    """Warn a caller who leaves ``param_name`` at its default that the default will change."""

    def decorator(func):
        # the positional slot that can carry the parameter, found once
        params = list(inspect.signature(func).parameters.values())
        slot = next((i for i, p in enumerate(params)
                     if p.name == param_name
                     and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)), None)
        notice = (
            f"{func.__name__}() will switch its default "
            f"{param_name} from {old_default!r} to {new_default!r} in "
            f"version {version}; pass {param_name}={old_default!r} "
            "explicitly to keep today's behavior and silence this warning."
        )

        @functools.wraps(func)
        def __wrapper(*args, **kwargs):
            supplied = param_name in kwargs or (slot is not None and len(args) > slot)
            if not supplied:
                _lifecycle_notice(notice)
            return func(*args, **kwargs)

        return __wrapper

    return decorator
