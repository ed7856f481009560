"""Music notation on the host: key signatures, Indian svara systems, and FJS names.

Pure Python and numpy, as in the JAX package: :func:`key_to_notes` and
:func:`key_to_degrees` (what :func:`~librosa_tpu_torch.core.convert.midi_to_note`
reaches), the Hindustani thaats and Carnatic melakartas, and the Functional
Just System's names of just intervals (:func:`interval_to_fjs`, from a
table of prime factorisations built from the interval generators of
``core/intervals.py``).

A spelling is a position on the line of fifths: position ``p`` holds pitch
class ``7 p mod 12``, the letters F C G D A E B sit at -1 .. 5, and each
sharp moves a letter 7 positions up (a flat 7 down). A key spells the
twelve classes from a window of twelve consecutive positions.
"""

from __future__ import annotations

import functools
import re
from typing import Any, Dict, List, Union

import numpy as np

from ..util.exceptions import ParameterError
from .intervals import plimit_intervals, pythagorean_intervals

__all__ = ["key_to_notes", "key_to_degrees", "mela_to_degrees", "mela_to_svara",
           "thaat_to_degrees", "list_mela", "list_thaat", "fifths_to_note", "interval_to_fjs"]

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


# ---------------------------------------------------------------------------
# Hindustani thaats and Carnatic melakartas
# ---------------------------------------------------------------------------

_THAAT = {
    "bilaval": [0, 2, 4, 5, 7, 9, 11], "khamaj": [0, 2, 4, 5, 7, 9, 10],
    "kafi": [0, 2, 3, 5, 7, 9, 10], "asavari": [0, 2, 3, 5, 7, 8, 10],
    "bhairavi": [0, 1, 3, 5, 7, 8, 10], "kalyan": [0, 2, 4, 6, 7, 9, 11],
    "marva": [0, 1, 4, 6, 7, 9, 11], "poorvi": [0, 1, 4, 6, 7, 8, 11],
    "todi": [0, 1, 3, 6, 7, 8, 11], "bhairav": [0, 1, 4, 5, 7, 8, 11],
}

# the 72 melakarta ragas, in their order
_MELA = (
    "kanakangi ratnangi ganamurthi vanaspathi manavathi tanarupi senavathi hanumathodi "
    "dhenuka natakapriya kokilapriya rupavathi gayakapriya vakulabharanam mayamalavagaula "
    "chakravakom suryakantham hatakambari jhankaradhwani natabhairavi keeravani "
    "kharaharapriya gaurimanohari varunapriya mararanjini charukesi sarasangi harikambhoji "
    "dheerasankarabharanam naganandini yagapriya ragavardhini gangeyabhushani vagadheeswari "
    "sulini chalanatta salagam jalarnavam jhalavarali navaneetham pavani raghupriya "
    "gavambodhi bhavapriya subhapanthuvarali shadvidhamargini suvarnangi divyamani "
    "dhavalambari namanarayani kamavardhini ramapriya gamanasrama viswambhari syamalangi "
    "shanmukhapriya simhendramadhyamam hemavathi dharmavathi neethimathi kanthamani "
    "rishabhapriya latangi vachaspathi mechakalyani chitrambari sucharitra jyotisvarupini "
    "dhatuvardhini nasikabhushani kosalam rasikapriya"
).split()

_MELA_NUMBER = {name: i for i, name in enumerate(_MELA, 1)}

# Ri/Ga (and Dha/Ni) take two of four consecutive semitones: the six pairs in order
_PAIRS = [(a, b) for a in range(4) for b in range(a + 1, 4)]


def thaat_to_degrees(thaat: str) -> np.ndarray:
    """The seven pitch classes (semitones above Sa) of a Hindustani thaat, e.g. ``'bilaval'``."""
    return np.array(_THAAT[thaat.lower()])


def _mela_index(mela: Union[str, int]) -> int:
    """The melakarta's place 0-71, from its name or its number 1-72."""
    if isinstance(mela, str):
        return _MELA_NUMBER[mela.lower()] - 1
    if 0 < mela <= 72:
        return int(mela) - 1
    raise ParameterError(f"melakarta index {mela} is outside the system (1..72)")


def mela_to_degrees(mela: Union[str, int]) -> np.ndarray:
    """The seven pitch classes of a Carnatic melakarta raga, by name or number 1-72.

    Ma is perfect in melas 1-36 and augmented in 37-72; within each half the
    mela's number runs through the six Ri/Ga pairs, and within each of
    those through the six Dha/Ni pairs.
    """
    index = _mela_index(mela)
    ri, ga = _PAIRS[index % 36 // 6]
    dha, ni = _PAIRS[index % 6]
    return np.array([0, 1 + ri, 1 + ga, 5 + index // 36, 7, 8 + dha, 8 + ni])


def mela_to_svara(mela: Union[str, int], *, abbr: bool = True,
                  unicode: bool = True) -> List[str]:
    """The svara names of the 12 pitch classes above Sa under a melakarta.

    The four classes that two svaras can name (2, 3, 9, 10) are named as the
    mela's Ri/Ga and Dha/Ni pairs need. ``abbr`` keeps the initial and the
    variant (``'R₁'``), ``unicode=False`` writes the variant as an ASCII digit.
    """
    index = _mela_index(mela)
    ri_ga = _PAIRS[index % 36 // 6]
    dha_ni = _PAIRS[index % 6]
    names = ["Sa", "Ri₁", "Ga₁" if ri_ga == (0, 1) else "Ri₂",
             "Ri₃" if ri_ga == (2, 3) else "Ga₂", "Ga₃", "Ma₁", "Ma₂", "Pa", "Dha₁",
             "Ni₁" if dha_ni == (0, 1) else "Dha₂", "Dha₃" if dha_ni == (2, 3) else "Ni₂", "Ni₃"]
    out = []
    for name in names:
        if abbr:
            name = name[0] + (name[-1] if name[-1] in "₁₂₃" else "")
        if not unicode:
            name = name.translate(_SUB_TO_ASCII)
        out.append(name)
    return out


def list_mela() -> Dict[str, int]:
    """Every melakarta raga's name, with its number 1-72."""
    return dict(_MELA_NUMBER)


def list_thaat() -> List[str]:
    """The ten Hindustani thaats that :func:`thaat_to_degrees` knows."""
    return list(_THAAT)


# ---------------------------------------------------------------------------
# The Functional Just System
# ---------------------------------------------------------------------------

_SUPER = str.maketrans("0123456789", "⁰¹²³⁴⁵⁶⁷⁸⁹")
_SUB = str.maketrans("0123456789", "₀₁₂₃₄₅₆₇₈₉")
_SUB_TO_ASCII = str.maketrans("₀₁₂₃₄₅₆₇₈₉", "0123456789")


def _accidental_run(count: int, *, unicode: bool = True) -> str:
    """``count`` sharps (positive) or flats (negative), doubles first: +3 is ``𝄪♯``."""
    if count == 0:
        return ""
    doubles, singles = divmod(abs(count), 2)
    if count > 0:
        mark = "𝄪" * doubles + "♯" * singles
    else:
        mark = "𝄫" * doubles + "♭" * singles
    return mark if unicode else mark.translate(_ASCII)


def fifths_to_note(*, unison: str, fifths: int, unicode: bool = True) -> str:
    """The note ``fifths`` perfect fifths above ``unison`` (below where negative), spelled on the line of fifths."""
    parsed = _NOTE.match(unison)
    if parsed is None:
        raise ParameterError(f"Cannot parse note name: {unison!r}")
    position = (_FIFTHS.index(parsed.group("letter").upper()) - 1
                + 7 * sum(_SHIFT[a] for a in parsed.group("acc")) + fifths)
    return _FIFTHS[(position + 1) % 7] + _accidental_run((position + 1) // 7, unicode=unicode)


def _o_fold(d):
    """``d`` folded by octaves into [1, 2)."""
    return d * (2.0 ** -np.floor(np.log2(d)))


def _bo_fold(d):
    """``d`` folded by octaves into [sqrt(2)/2, sqrt(2))."""
    return d * (2.0 ** -np.round(np.log2(d)))


def _fifth_search(interval: float, tolerance: float) -> int:
    """The fewest fifths (0, 1, -1, 2, -2, ...) whose octave-folded remainder of ``interval`` is within ``tolerance``; 31 if none."""
    radius = abs(np.log2(tolerance))
    for step in range(32):
        for k in (step, -step):
            if abs(np.log2(_bo_fold(interval * 3.0 ** (-k)))) <= radius:
                return k
    return 31


@functools.lru_cache(maxsize=4)
def _interval_table(level: int) -> Dict[float, Dict[int, int]]:
    """Octave-folded just interval (rounded to 6 decimals) -> its prime factorisation.

    From the Pythagorean and the 3-, 5- and 7-limit systems at 72 bins an
    octave; ``level >= 1`` adds the 23-limit system at 190 bins. The first
    system to reach an interval names it.
    """
    table: Dict[float, Dict[int, int]] = {}
    systems = [pythagorean_intervals(bins_per_octave=72, sort=False, return_factors=True)]
    systems += [plimit_intervals(primes=primes, bins_per_octave=72, sort=False,
                                 return_factors=True)
                for primes in ([3], [3, 5], [3, 5, 7])]
    if level >= 1:
        systems.append(plimit_intervals(primes=[3, 5, 7, 11, 13, 17, 19, 23],
                                        bins_per_octave=190, sort=False, return_factors=True))
    for factor_list in systems:
        for factors in factor_list:
            ratio = 1.0
            for p, k in factors.items():
                ratio *= float(p) ** k
            table.setdefault(float(np.around(_o_fold(ratio), decimals=6)), factors)
    return table


def interval_to_fjs(interval: Any, *, unison: str = "C", tolerance: float = 65.0 / 63,
                    unicode: bool = True) -> Any:
    """The FJS name of a just interval (a frequency ratio) above ``unison``, or an array of names.

    The note is the nearest one a chain of pure fifths reaches (within
    ``tolerance``); the primes above 3 of the ratio's numerator are written
    above it (``E⁵`` for 5/4; ``^5`` in ASCII), those of its denominator
    below (``_5``).
    """
    if not np.isscalar(interval):
        return np.array([interval_to_fjs(i, unison=unison, tolerance=tolerance, unicode=unicode)
                         for i in np.asarray(interval)])
    if interval <= 0:
        raise ParameterError(f"FJS names exist only for positive ratios; got {interval}")
    spine = fifths_to_note(unison=unison, fifths=_fifth_search(interval, tolerance),
                           unicode=unicode)
    folded = float(np.around(_o_fold(interval), decimals=6))
    factors = _interval_table(0).get(folded) or _interval_table(1).get(folded)
    if factors is None:
        raise ParameterError(f"interval {interval} is not in the just-intonation tables")
    over = under = 1
    for prime, exponent in factors.items():
        if prime > 3 and exponent > 0:
            over *= prime ** exponent
        elif prime > 3:
            under *= prime ** (-exponent)

    def comma(value: int, trans: Any, ascii_mark: str) -> str:
        if value <= 1:
            return ""
        return str(value).translate(trans) if unicode else ascii_mark + str(value)

    return spine + comma(over, _SUPER, "^") + comma(under, _SUB, "_")
