"""Deprecation helpers: a sentinel default and the resolution of a renamed keyword."""

from __future__ import annotations

import warnings
from typing import Any

__all__ = ["Deprecated", "rename_kw"]


class Deprecated:
    """The default of a parameter on its way out: no value a caller passes is one."""

    def __repr__(self) -> str:
        return "<DEPRECATED parameter>"


def rename_kw(
    *,
    old_name: str,
    old_value: Any,
    new_name: str,
    new_value: Any,
    version_deprecated: str,
    version_removed: str,
) -> Any:
    """The value that takes effect when a keyword was renamed from ``old_name`` to ``new_name``.

    ``new_value`` if the old keyword was left at its :class:`Deprecated`
    default; else ``old_value``, with a ``FutureWarning`` that names both
    keywords and the two versions.
    """
    if isinstance(old_value, Deprecated):
        return new_value
    warnings.warn(
        f"{old_name} parameter is deprecated in version {version_deprecated}."
        f"\n\tIt will be removed in version {version_removed}."
        f"\n\tUse {new_name} instead.",
        FutureWarning,
        stacklevel=3,
    )
    return old_value
