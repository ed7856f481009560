"""Key signatures: how a key spells the twelve pitch classes (host Python).

Only what :func:`~librosa_tpu_torch.core.convert.midi_to_note` reaches:
:func:`key_to_notes` and :func:`key_to_degrees`.

A spelling is a position on the line of fifths: position ``p`` holds pitch
class ``7 p mod 12``, the letters F C G D A E B sit at -1 .. 5, and each
sharp moves a letter 7 positions up (a flat 7 down). A key spells the
twelve classes from a window of twelve consecutive positions.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from ..util.exceptions import ParameterError

__all__ = ["key_to_notes", "key_to_degrees"]

_ACCIDENTALS = "#♯𝄪b!♭𝄫♮n"
_KEY = re.compile(
    rf"^(?P<tonic>[A-Ga-g])(?P<acc>[{_ACCIDENTALS}]*):((?P<scale>(maj|min)(or)?)|"
    r"(?P<mode>(((ion|dor|phryg|lyd|mixolyd|aeol|locr)(ian)?)|phr|mix|aeo|loc)))$"
)
_NOTE = re.compile(rf"^(?P<letter>[A-Ga-g])(?P<acc>[{_ACCIDENTALS}]*)(?P<octave>[+-]?\d+)?"
                   r"(?P<cents>[+-]\d+)?$")
_SHIFT = {"#": 1, "♯": 1, "𝄪": 2, "b": -1, "!": -1, "♭": -1, "𝄫": -2, "♮": 0, "n": 0}
_ASCII = str.maketrans({"♯": "#", "𝄪": "##", "♭": "b", "𝄫": "bb", "♮": "n"})
_FIFTHS = "FCGDAEB"          # letter k of this string sits at position k - 1
_CLASS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
# how far a church mode's tonic lies above its parent major scale's tonic, in fifths and in degrees
_MODE_FIFTHS = {"ion": 0, "dor": 2, "phr": 4, "lyd": -1, "mix": 1, "aeo": 3, "loc": 5}
_MODE_DEGREE = {"ion": 0, "dor": 1, "phr": 2, "lyd": 3, "mix": 4, "aeo": 5, "loc": 6}


def _spell(position: int) -> str:
    """The note at a line-of-fifths position: its letter and its sharps or flats, doubles first."""
    letter = _FIFTHS[(position + 1) % 7]
    shift = (position + 1) // 7
    single, double = ("♯", "𝄪") if shift >= 0 else ("♭", "𝄫")
    return letter + single * (abs(shift) % 2) + double * (abs(shift) // 2)


def _pitch_class(note: str) -> int:
    parsed = _NOTE.match(note)
    if parsed is None:
        raise ParameterError(f"Cannot parse note name: {note!r}")
    return (_CLASS[parsed.group("letter").upper()]
            + sum(_SHIFT[a] for a in parsed.group("acc"))) % 12


def _simplify(note: str, unicode: bool) -> str:
    """A letter and accidentals as the letter with its net shift: one single sign, then doubles."""
    parsed = _NOTE.match(note)
    if parsed is None:
        raise ParameterError(f"Improper key format: {note:s}")
    letter = parsed.group("letter").upper()
    shift = sum(_SHIFT[a] for a in parsed.group("acc"))
    single, double = ("♯", "𝄪") if shift >= 0 else ("♭", "𝄫")
    name = letter + single * (abs(shift) % 2) + double * (abs(shift) // 2)
    return name if unicode else name.translate(_ASCII)


def _as_major_or_minor(key: str, unicode: bool = True) -> str:
    """``key`` spelled as ``tonic:maj`` / ``tonic:min``; a church mode becomes its parent major."""
    parsed = _KEY.match(key)
    if parsed is None:
        raise ParameterError(f"Improper format: {key:s}")
    acc = parsed.group("acc")
    if parsed.group("scale") or not parsed.group("mode"):
        scale = parsed.group("scale")
        return _simplify(parsed.group("tonic").upper() + acc, unicode) + (
            ":" + scale if scale else "")
    mode = parsed.group("mode").lower()[:3]
    parent = _spell(_FIFTHS.index(parsed.group("tonic").upper()) - 1 - _MODE_FIFTHS[mode])
    return _simplify(parent + acc, unicode) + ":maj"


def key_to_notes(key: str, *, unicode: bool = True, natural: bool = False) -> List[str]:
    """The twelve pitch classes from C as ``key`` spells them (``'C:maj'``, ``'F#:min'``, ``'D:dor'``).

    Sharp keys spell black keys with sharps, flat keys with flats; a natural
    tonic takes whichever side needs fewer accidentals (sharps on a tie).
    Each accidental of the tonic beyond the first moves the whole spelling
    by seven fifths. ``natural`` marks the white keys outside the scale with
    ``♮``; ``unicode=False`` writes ``#``, ``b``, ``##``, ``bb`` and ``n``.
    """
    parsed = _KEY.match(key)
    if parsed is None:
        raise ParameterError(f"Improper key format: {key:s}")
    if parsed.group("mode") or not parsed.group("scale"):
        return key_to_notes(_as_major_or_minor(key), unicode=unicode, natural=natural)

    shift = sum(_SHIFT[a] for a in parsed.group("acc"))
    sign = (shift > 0) - (shift < 0)
    minor = parsed.group("scale")[:3].lower() != "maj"
    # the key's signature on the line of fifths, counting one tonic accidental at most
    signature = _FIFTHS.index(parsed.group("tonic").upper()) - 1 + 7 * sign - 3 * minor
    sharps = sign > 0 if sign else signature % 12 < 6
    lowest = max(signature - 6, -1) if sharps else min(signature, -5) - 1
    if shift:
        lowest += 7 * sign * (abs(shift) - 1)

    notes = [""] * 12
    for position in range(lowest, lowest + 12):
        notes[7 * position % 12] = _spell(position)
    if natural:
        scale = set(key_to_degrees(key).tolist())
        notes = [n + "♮" if len(n) == 1 and _pitch_class(n) not in scale else n for n in notes]
    if not unicode:
        notes = [n.translate(_ASCII) for n in notes]
    return notes


def key_to_degrees(key: str) -> np.ndarray:
    """The seven pitch classes of ``key``'s scale, from its tonic up.

    Major: whole, whole, half, whole, whole, whole; natural minor: whole,
    half, whole, whole, half, whole. A church mode is its parent major
    scale started on another degree.
    """
    parsed = _KEY.match(key)
    if parsed is None:
        raise ParameterError(f"Cannot parse key specification: {key!r}")
    if parsed.group("mode") or not parsed.group("scale"):
        parent = key_to_degrees(_as_major_or_minor(key))
        return np.roll(parent, -_MODE_DEGREE[parsed.group("mode")[:3]])
    steps = (2, 2, 1, 2, 2, 2) if parsed.group("scale")[:3].lower() == "maj" else (2, 1, 2, 2, 1, 2)
    tonic = _pitch_class(parsed.group("tonic").upper() + parsed.group("acc"))
    return (tonic + np.concatenate(([0], np.cumsum(steps)))) % 12
