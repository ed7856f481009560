"""Matching of intervals and events: small host-side lists, so numpy on the host.

Each source maps to the best target by a dense table of Jaccard overlaps or
distances and an argmax / argmin (the first on ties), as in the JAX package.
Tensors are accepted and copied to the host.
"""

from __future__ import annotations

import numpy as np

from .exceptions import ParameterError
from .utils import _host

__all__ = ["match_intervals", "match_events"]


def _jaccard(int_a: np.ndarray, int_b: np.ndarray) -> np.ndarray:
    """Pairwise Jaccard similarity between interval sets.

    An ``(n, m)`` matrix.
    """
    lo = np.maximum(int_a[:, None, 0], int_b[None, :, 0])
    hi = np.minimum(int_a[:, None, 1], int_b[None, :, 1])
    intersection = np.maximum(0.0, hi - lo)
    lo_u = np.minimum(int_a[:, None, 0], int_b[None, :, 0])
    hi_u = np.maximum(int_a[:, None, 1], int_b[None, :, 1])
    union = hi_u - lo_u
    with np.errstate(invalid="ignore", divide="ignore"):
        jac = np.where(union > 0, intersection / union, 0.0)
    return jac


def match_intervals(
    intervals_from: np.ndarray, intervals_to: np.ndarray, *, strict: bool = True
) -> np.ndarray:
    """Match one set of time intervals to another.

    Each source interval maps to the candidate maximizing Jaccard overlap
    (ties to the earlier candidate); with ``strict=False``, non-overlapping
    intervals fall back to minimum boundary distance.

    Parameters
    ----------
    intervals_from : np.ndarray [shape=(n, 2)]
    intervals_to : np.ndarray [shape=(m, 2)]
    strict : bool
        require a positive overlap

    Returns
    -------
    interval_mapping : np.ndarray [shape=(n,), dtype=int]
    """
    intervals_from = _host(intervals_from).astype(float)
    intervals_to = _host(intervals_to).astype(float)
    if len(intervals_from) == 0 or len(intervals_to) == 0:
        raise ParameterError("Attempting to match empty interval list")

    jac = _jaccard(intervals_from, intervals_to)  # (n_from, n_to)
    best = jac.argmax(axis=1)
    has_overlap = jac.max(axis=1) > 0

    if strict:
        if not np.all(has_overlap):
            raise ParameterError("Unable to match intervals with strict=True")
        return best.astype(int)

    # Non-strict: fall back to closest endpoints (max of start/end distances)
    dist = np.maximum(
        np.abs(intervals_from[:, None, 0] - intervals_to[None, :, 0]),
        np.abs(intervals_from[:, None, 1] - intervals_to[None, :, 1]),
    )
    fallback = dist.argmin(axis=1)
    return np.where(has_overlap, best, fallback).astype(int)


def match_events(
    events_from: np.ndarray,
    events_to: np.ndarray,
    *,
    left: bool = True,
    right: bool = True,
) -> np.ndarray:
    """Match one set of event times to another.

    Each source event maps to its closest target, optionally constrained to
    be left/right of the source.

    Parameters
    ----------
    events_from, events_to : 1-D arrays
    left, right : bool
        allow targets before / after the source

    Returns
    -------
    event_mapping : np.ndarray [shape=(n,), dtype=int]
    """
    sources = _host(events_from)
    targets = _host(events_to)
    if sources.size == 0 or targets.size == 0:
        raise ParameterError(
            "match_events needs at least one event on each side"
        )

    # Feasibility: every source must have at least one admissible target.
    if not (left or right):
        # only exact coincidences are admissible
        if not np.isin(sources, targets).all():
            raise ParameterError(
                "left=right=False permits exact matches only, but some "
                "events_from values do not occur in events_to"
            )
    elif not left and targets.max() < sources.max():
        raise ParameterError(
            "left=False needs a target at/after every source; the largest "
            "source exceeds every target"
        )
    elif not right and targets.min() > sources.min():
        raise ParameterError(
            "right=False needs a target at/before every source; the "
            "smallest source precedes every target"
        )

    # Dense |target - source| table with inadmissible directions masked;
    # argmin keeps the earliest target on ties (np.argmin first-index rule).
    gap = targets[None, :].astype(float) - sources[:, None].astype(float)
    cost = np.abs(gap)
    if not left:
        cost[gap < 0] = np.inf
    if not right:
        cost[gap > 0] = np.inf
    return cost.argmin(axis=1).astype(int)
