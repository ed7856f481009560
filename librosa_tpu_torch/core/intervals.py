"""Interval systems: equal temperament, Pythagorean and p-limit just intonation (host, float64).

Each system gives a set of frequency ratios in ``[1, 2)``;
:func:`interval_frequencies` repeats them over octaves from ``fmin``. The
p-limit sets grow by "crystal growth": starting from the unison, the next
interval is the candidate next to the set with the least total harmonic
distance to every interval already chosen. These are small host tables,
made once per configuration.
"""

from __future__ import annotations

import functools
from typing import Any, Collection, List, Tuple, Union

import numpy as np

from .._cache import cache
from ..util.exceptions import ParameterError

__all__ = ["interval_frequencies", "pythagorean_intervals", "plimit_intervals"]

_JUST = {"ji3": (3,), "ji5": (3, 5), "ji7": (3, 5, 7)}


def _octave_fold(log2_ratio: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(log2_ratio`` moved into ``[0, 1)``, the octaves taken off to get there)."""
    octaves = np.floor(log2_ratio)
    return log2_ratio - octaves, octaves.astype(int)


@cache(level=10)
def interval_frequencies(n_bins: int, *, fmin: float, intervals: Union[str, Collection[float]],
                         bins_per_octave: int = 12, tuning: float = 0.0,
                         sort: bool = True) -> np.ndarray:
    """``n_bins`` frequencies from ``fmin``: one octave's ratios, repeated an octave higher each time.

    ``intervals`` is ``'equal'`` (``bins_per_octave`` equal steps, shifted by
    ``tuning`` of a step), ``'pythagorean'``, ``'ji3'``, ``'ji5'``, ``'ji7'``
    (``bins_per_octave`` ratios each), or the ratios themselves (their count
    is then the bins per octave). ``sort`` puts the result in rising order.
    """
    if not isinstance(intervals, str):
        ratios = np.array(intervals)
        bins_per_octave = len(ratios)
    elif intervals == "equal":
        ratios = np.exp2((tuning + np.arange(bins_per_octave, dtype=float)) / bins_per_octave)
    elif intervals == "pythagorean":
        ratios = pythagorean_intervals(bins_per_octave=bins_per_octave, sort=sort)
    elif intervals in _JUST:
        ratios = plimit_intervals(primes=_JUST[intervals], bins_per_octave=bins_per_octave,
                                  sort=sort)
    else:
        raise ParameterError(
            f"interval system {intervals!r} is not one of: equal, pythagorean, ji3, ji5, ji7 "
            "(or an explicit ratio array)"
        )
    octaves = np.exp2(np.arange(np.ceil(n_bins / bins_per_octave)))
    freqs = np.multiply.outer(octaves, ratios).ravel()[:n_bins]
    return (np.sort(freqs) if sort else freqs) * fmin


@cache(level=10)
def pythagorean_intervals(*, bins_per_octave: int = 12, sort: bool = True,
                          return_factors: bool = False) -> Any:
    """The first ``bins_per_octave`` fifths ``3**k``, each brought into one octave by powers of 2.

    ``sort`` orders them by size (else by ``k``). ``return_factors`` gives
    each as ``{2: -octaves, 3: k}`` instead.
    """
    fifths = np.arange(bins_per_octave)
    log2_ratio, octaves = _octave_fold(fifths * np.log2(3.0))
    order = np.argsort(log2_ratio) if sort else np.arange(bins_per_octave)
    if return_factors:
        return [{2: -int(octaves[k]), 3: int(fifths[k])} for k in order]
    return 2.0 ** log2_ratio[order]


def _harmonic_distance(a: np.ndarray, b: np.ndarray, log2_primes: np.ndarray) -> np.ndarray:
    """Tenney harmonic distance of every row of ``a`` to every row of ``b`` (exponent vectors).

    The distance of ``a / b`` in lowest terms, ``log2`` of its numerator
    times its denominator, is ``sum |a - b| * log2(prime)``; rounded to six
    decimals, so that equal distances stay equal whatever the order of sums.
    """
    return np.around(np.abs(a[:, None, :] - b[None, :, :]) @ log2_primes, 6)


@functools.lru_cache(maxsize=64)
def _grow(primes: Tuple[int, ...], n_intervals: int) -> Tuple[Tuple[int, ...], ...]:
    """Exponent vectors (over ``primes``) of ``n_intervals`` intervals grown from the unison.

    Candidates are the neighbours of the chosen set, one step up or down
    along one prime. Each round takes, scanning candidates in the order
    they joined, the one of least total distance to the chosen set; a
    candidate whose total is close to the best so far wins it if it is the
    simpler interval (less ``sum |exponent| * log2(prime)``).
    """
    log2_primes = np.log2(np.asarray(primes, dtype=np.float64))
    steps: List[Tuple[int, ...]] = []
    for axis in range(len(primes)):
        unit = [0] * len(primes)
        unit[axis] = 1
        steps += [tuple(unit), tuple(-u for u in unit)]

    chosen: List[Tuple[int, ...]] = [(0,) * len(primes)]
    candidates: List[Tuple[int, ...]] = list(steps)
    seen = set(chosen) | set(candidates)
    totals = [float(t) for t in _harmonic_distance(np.asarray(candidates), np.asarray(chosen),
                                                   log2_primes).sum(axis=1)]

    def simplicity(v: Tuple[int, ...]) -> float:
        return log2_primes @ np.abs(np.asarray(v))

    while len(chosen) < n_intervals:
        best = 0
        for k in range(1, len(candidates)):
            if totals[k] < totals[best] or (np.isclose(totals[k], totals[best])
                                            and simplicity(candidates[k])
                                            < simplicity(candidates[best])):
                best = k
        winner = candidates.pop(best)
        totals.pop(best)
        chosen.append(winner)
        if candidates:
            extra = _harmonic_distance(np.asarray(candidates), np.asarray([winner]),
                                       log2_primes)[:, 0]
            totals = [t + float(d) for t, d in zip(totals, extra)]
        fresh = [tuple(w + s for w, s in zip(winner, step)) for step in steps]
        fresh = [v for v in fresh if v not in seen]
        if fresh:
            seen.update(fresh)
            candidates += fresh
            totals += [float(t) for t in _harmonic_distance(
                np.asarray(fresh), np.asarray(chosen), log2_primes).sum(axis=1)]
    return tuple(chosen)


@cache(level=10)
def plimit_intervals(*, primes: Any, bins_per_octave: int = 12, sort: bool = True,
                     return_factors: bool = False) -> Any:
    """``bins_per_octave`` just intervals over the odd ``primes``, grown by harmonic distance.

    Each interval is a product of powers of the primes brought into one
    octave by powers of 2. ``sort`` orders them by size (else in the order
    they were grown). ``return_factors`` gives each as ``{prime: exponent}``
    with 2 among the primes where octaves were taken off.
    """
    primes = np.atleast_1d(primes)
    log2_primes = np.log2(primes, dtype=np.float64)
    exponents = np.asarray(_grow(tuple(int(p) for p in primes), int(bins_per_octave)),
                           dtype=float)
    log2_ratio, octaves = _octave_fold(exponents @ log2_primes)
    order = np.argsort(log2_ratio) if sort else np.arange(bins_per_octave)
    if return_factors:
        factors = []
        for k in order:
            f = {2: -int(octaves[k])} if octaves[k] else {}
            f.update({int(p): int(e) for p, e in zip(primes, exponents[k]) if e})
            factors.append(f)
        return factors
    return 2.0 ** log2_ratio[order]
