"""Unit conversions, frequency grids and weighting curves (host numpy, float64).

These build the filterbanks' frequency grids and the per-bin offsets of
perceptual weighting, and convert between samples, frames, blocks and
seconds. They run on the host, so they stay in numpy; only a finished table
goes to the card.
"""

from __future__ import annotations

import re
from typing import Any, Iterable, Optional

import numpy as np

from ..util.exceptions import ParameterError

__all__ = [
    "hz_to_mel", "mel_to_hz", "hz_to_octs", "octs_to_hz", "hz_to_midi", "midi_to_hz",
    "note_to_midi", "note_to_hz", "midi_to_note", "hz_to_note", "A4_to_tuning", "tuning_to_A4",
    "frames_to_samples", "samples_to_frames", "frames_to_time", "time_to_frames",
    "time_to_samples", "samples_to_time", "blocks_to_frames", "blocks_to_samples",
    "blocks_to_time", "times_like", "samples_like", "fft_frequencies", "mel_frequencies",
    "cqt_frequencies", "tempo_frequencies", "fourier_tempo_frequencies",
    "A_weighting", "B_weighting", "C_weighting", "D_weighting", "Z_weighting",
    "frequency_weighting", "multi_frequency_weighting", "midi_to_svara_h", "hz_to_svara_h",
    "note_to_svara_h", "midi_to_svara_c", "hz_to_svara_c", "note_to_svara_c", "hz_to_fjs",
]

# Slaney's mel scale: linear (200/3 Hz per mel) below 1 kHz, logarithmic
# above it with 27 mels per factor of 6.4 in frequency.
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies: Any, *, htk: bool = False) -> np.ndarray:
    """Frequencies in Hz to mels (Slaney's scale, or HTK's with ``htk``)."""
    f = np.asanyarray(frequencies)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    mels = f / _F_SP
    log_region = f >= _MIN_LOG_HZ
    if f.ndim:
        mels[log_region] = _MIN_LOG_MEL + np.log(f[log_region] / _MIN_LOG_HZ) / _LOGSTEP
    elif log_region:
        mels = _MIN_LOG_MEL + np.log(f / _MIN_LOG_HZ) / _LOGSTEP
    return mels


def mel_to_hz(mels: Any, *, htk: bool = False) -> np.ndarray:
    """Mels to frequencies in Hz; the inverse of :func:`hz_to_mel`."""
    m = np.asanyarray(mels)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    freqs = _F_SP * m
    log_region = m >= _MIN_LOG_MEL
    if m.ndim:
        freqs[log_region] = _MIN_LOG_HZ * np.exp(_LOGSTEP * (m[log_region] - _MIN_LOG_MEL))
    elif log_region:
        freqs = _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL))
    return freqs


def hz_to_octs(frequencies: Any, *, tuning: float = 0.0,
               bins_per_octave: int = 12) -> np.ndarray:
    """Frequencies in Hz to octaves above ``A440 / 16``.

    ``tuning`` moves A440 by that fraction of one of ``bins_per_octave`` bins.
    """
    a440 = 440.0 * 2.0 ** (tuning / bins_per_octave)
    return np.log2(np.asanyarray(frequencies) / (float(a440) / 16))


def octs_to_hz(octs: Any, *, tuning: float = 0.0, bins_per_octave: int = 12) -> np.ndarray:
    """Octaves above ``A440 / 16`` to frequencies in Hz; the inverse of :func:`hz_to_octs`."""
    a440 = 440.0 * 2.0 ** (tuning / bins_per_octave)
    return (float(a440) / 16) * (2.0 ** np.asanyarray(octs))


def midi_to_hz(notes: Any) -> np.ndarray:
    """MIDI note numbers to Hz: note 69 is A440, a step is an equal-tempered semitone."""
    return 440.0 * (2.0 ** ((np.asanyarray(notes) - 69.0) / 12.0))


def hz_to_midi(frequencies: Any) -> np.ndarray:
    """Frequencies in Hz to (fractional) MIDI note numbers; the inverse of :func:`midi_to_hz`."""
    return 12 * (np.log2(np.asanyarray(frequencies)) - np.log2(440.0)) + 69


# A spelled note: a letter, accidentals, an optional octave and an optional offset in cents
_NOTE = re.compile(r"^(?P<letter>[A-Ga-g])(?P<acc>[#♯𝄪b!♭𝄫♮]*)(?P<octave>[+-]?\d+)?"
                   r"(?P<cents>[+-]\d+)?$")
_LETTER_SEMITONES = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
_ACCIDENTAL_SEMITONES = {"#": 1, "♯": 1, "𝄪": 2, "b": -1, "!": -1, "♭": -1, "𝄫": -2, "♮": 0}


def note_to_midi(note: Any, *, round_midi: bool = True) -> Any:
    """MIDI number of a spelled note (``'C4'`` is 60), or an array of them for a list.

    Accidentals ``#``/``♯`` (+1), ``𝄪`` (+2), ``b``/``!``/``♭`` (-1),
    ``𝄫`` (-2), ``♮`` (0); no octave means octave 0; a trailing ``+25`` or
    ``-10`` adds cents, kept as a fraction unless ``round_midi``. The empty
    string gives NaN.
    """
    if not isinstance(note, str):
        return np.array([note_to_midi(n, round_midi=round_midi) for n in note])
    if note == "":
        return np.nan
    parsed = _NOTE.match(note)
    if parsed is None:
        raise ParameterError(f"Cannot parse note name: {note!r}")
    octave = int(parsed.group("octave") or 0)
    value = (12 * (octave + 1) + _LETTER_SEMITONES[parsed.group("letter").upper()]
             + sum(_ACCIDENTAL_SEMITONES[a] for a in parsed.group("acc"))
             + int(parsed.group("cents") or 0) / 100.0)
    return int(np.round(value)) if round_midi else value


def note_to_hz(note: Any, *, round_midi: bool = False) -> Any:
    """Frequency in Hz of a spelled note (see :func:`note_to_midi`); cents kept by default."""
    return midi_to_hz(note_to_midi(note, round_midi=round_midi))


def midi_to_note(midi: Any, *, octave: bool = True, cents: bool = False, key: str = "C:maj",
                 unicode: bool = True) -> Any:
    """The spelled name of a MIDI number, or an array of names for an array.

    The pitch class is spelled as ``key`` spells it
    (:func:`~librosa_tpu_torch.core.notation.key_to_notes`); ``octave``
    appends the octave number and ``cents`` the signed offset in cents of a
    fractional number from the nearest note.
    """
    if cents and not octave:
        raise ParameterError("Cannot encode cents without octave information.")
    if not np.isscalar(midi):
        return np.array([midi_to_note(m, octave=octave, cents=cents, key=key, unicode=unicode)
                         for m in midi])
    from .notation import key_to_notes

    nearest = int(np.round(midi))
    name = key_to_notes(key=key, unicode=unicode)[nearest % 12]
    if octave:
        name += f"{nearest // 12 - 1:0d}"
    if cents:
        name += f"{int(100 * np.around(midi - nearest, 2)):+02d}"
    return name


def hz_to_note(frequencies: Any, **kwargs: Any) -> Any:
    """The spelled name of the note nearest each frequency; ``kwargs`` go to :func:`midi_to_note`."""
    return midi_to_note(hz_to_midi(frequencies), **kwargs)


def A4_to_tuning(A4: Any, *, bins_per_octave: int = 12) -> np.ndarray:
    """The tuning deviation, in fractions of a bin, of the reference pitch ``A4`` Hz from 440 Hz."""
    return bins_per_octave * (np.log2(np.asanyarray(A4)) - np.log2(440.0))


def tuning_to_A4(tuning: Any, *, bins_per_octave: int = 12) -> np.ndarray:
    """The reference pitch in Hz of a tuning deviation; the inverse of :func:`A4_to_tuning`."""
    return 440.0 * 2.0 ** (np.asanyarray(tuning) / bins_per_octave)


def frames_to_samples(frames: Any, *, hop_length: int = 512,
                      n_fft: Optional[int] = None) -> np.ndarray:
    """Frame indices to sample indices, offset by ``n_fft // 2`` for centred frames."""
    offset = 0 if n_fft is None else int(n_fft // 2)
    return (np.asanyarray(frames) * hop_length + offset).astype(int)


def samples_to_frames(samples: Any, *, hop_length: int = 512,
                      n_fft: Optional[int] = None) -> np.ndarray:
    """Sample indices to the index of the frame that last started at or before each.

    With ``n_fft``, frames are centred: sample indices are shifted back by
    ``n_fft // 2`` first.
    """
    offset = 0 if n_fft is None else int(n_fft // 2)
    samples = np.asanyarray(samples)
    return np.asarray(np.floor((samples - offset) // hop_length), dtype=int)


def frames_to_time(frames: Any, *, sr: float = 22050, hop_length: int = 512,
                   n_fft: Optional[int] = None) -> np.ndarray:
    """Frame indices to the time in seconds of their first sample (centred with ``n_fft``)."""
    return samples_to_time(frames_to_samples(frames, hop_length=hop_length, n_fft=n_fft), sr=sr)


def time_to_frames(times: Any, *, sr: float = 22050, hop_length: int = 512,
                   n_fft: Optional[int] = None) -> np.ndarray:
    """Times in seconds to frame indices, through :func:`time_to_samples`."""
    return samples_to_frames(time_to_samples(times, sr=sr), hop_length=hop_length, n_fft=n_fft)


def time_to_samples(times: Any, *, sr: float = 22050) -> np.ndarray:
    """Times in seconds to sample indices, rounded toward zero."""
    return (np.asanyarray(times) * sr).astype(int)


def samples_to_time(samples: Any, *, sr: float = 22050) -> np.ndarray:
    """Sample indices to times in seconds."""
    return np.asanyarray(samples) / float(sr)


def blocks_to_frames(blocks: Any, *, block_length: int) -> np.ndarray:
    """Indices of ``stream``'s blocks to the index of each block's first frame."""
    return block_length * np.asanyarray(blocks)


def blocks_to_samples(blocks: Any, *, block_length: int, hop_length: int) -> np.ndarray:
    """Indices of ``stream``'s blocks to the index of each block's first sample."""
    return frames_to_samples(blocks_to_frames(blocks, block_length=block_length),
                             hop_length=hop_length)


def blocks_to_time(blocks: Any, *, block_length: int, hop_length: int,
                   sr: float) -> np.ndarray:
    """Indices of ``stream``'s blocks to the time in seconds of each block's first sample."""
    return samples_to_time(
        blocks_to_samples(blocks, block_length=block_length, hop_length=hop_length), sr=sr)


def samples_like(X: Any, *, hop_length: int = 512, n_fft: Optional[int] = None,
                 axis: int = -1) -> np.ndarray:
    """The sample index of each frame along ``axis`` of ``X`` (or of ``X`` frames, a number)."""
    n_frames = X if np.isscalar(X) else np.shape(X)[axis]
    return frames_to_samples(np.arange(n_frames), hop_length=hop_length, n_fft=n_fft)


def times_like(X: Any, *, sr: float = 22050, hop_length: int = 512,
               n_fft: Optional[int] = None, axis: int = -1) -> np.ndarray:
    """The time in seconds of each frame along ``axis`` of ``X`` (or of ``X`` frames, a number)."""
    return samples_to_time(samples_like(X, hop_length=hop_length, n_fft=n_fft, axis=axis),
                           sr=sr)


def fft_frequencies(*, sr: float = 22050, n_fft: int = 2048) -> np.ndarray:
    """Centre frequencies of the ``1 + n_fft // 2`` real-FFT bins, in Hz."""
    return np.fft.rfftfreq(n=n_fft, d=1.0 / sr)


def mel_frequencies(
    n_mels: int = 128, *, fmin: float = 0.0, fmax: float = 11025.0, htk: bool = False
) -> np.ndarray:
    """``n_mels`` frequencies evenly spaced on the mel scale from fmin to fmax."""
    mels = np.linspace(hz_to_mel(fmin, htk=htk), hz_to_mel(fmax, htk=htk), n_mels)
    return mel_to_hz(mels, htk=htk)


def cqt_frequencies(n_bins: int, *, fmin: float, bins_per_octave: int = 12,
                    tuning: float = 0.0) -> np.ndarray:
    """``n_bins`` frequencies spaced ``bins_per_octave`` to the octave from ``fmin``, tuned.

    ``tuning`` shifts the grid by that fraction of a bin.
    """
    steps = (float(tuning) + np.arange(0, n_bins, dtype=float)) / bins_per_octave
    return fmin * 2.0 ** steps


def tempo_frequencies(n_bins: int, *, hop_length: int = 512, sr: float = 22050) -> np.ndarray:
    """Tempo in BPM of each lag bin of an autocorrelation tempogram; lag 0 is infinite."""
    lags = np.arange(int(n_bins), dtype=np.float64)
    with np.errstate(divide="ignore"):
        return 60.0 * sr / (hop_length * lags)


def fourier_tempo_frequencies(*, sr: float = 22050, win_length: int = 384,
                              hop_length: int = 512) -> np.ndarray:
    """Tempo in BPM of each bin of a Fourier tempogram of ``win_length`` onset frames."""
    return fft_frequencies(sr=sr * 60 / float(hop_length), n_fft=win_length)


# ---------------------------------------------------------------------------
# Frequency weighting curves (IEC 61672 for A and C; B and D as withdrawn)
# ---------------------------------------------------------------------------

# corner frequencies in Hz shared by the A, B and C curves
_F_LOW, _F_HIGH = 20.598997, 12194.217


def _gain_db(frequencies: Any, offset: float, zeros: float, poles: list,
             min_db: Optional[float]) -> np.ndarray:
    """``offset + 20 log10 |H(f)|`` for ``|H| = f_high**2 f**zeros / prod (f**2 + p**2)**m``.

    ``zeros`` is the number of zeros at the origin and ``poles`` a list of
    ``(corner frequency, multiplicity)``; both corners ``_F_LOW`` and
    ``_F_HIGH`` are double poles of every curve and are not listed.
    """
    f_sq = np.asanyarray(frequencies) ** 2.0
    with np.errstate(divide="ignore"):
        gain = 2.0 * np.log10(_F_HIGH) + 0.5 * zeros * np.log10(f_sq)
        for corner, multiplicity in [(_F_HIGH, 2), (_F_LOW, 2), *poles]:
            gain = gain - 0.5 * multiplicity * np.log10(f_sq + corner**2.0)
    weights = offset + 20.0 * gain
    return weights if min_db is None else np.maximum(min_db, weights)


def A_weighting(frequencies: Any, *, min_db: Optional[float] = -80.0) -> np.ndarray:
    """A-weighting gain in dB at ``frequencies`` (Hz), clipped below at ``min_db``.

    Four zeros at the origin, double poles at 20.6 Hz and 12194 Hz, single
    poles at 107.7 Hz and 737.9 Hz, +2.0 dB so that 1 kHz reads 0 dB.
    """
    return _gain_db(frequencies, 2.0, 4, [(107.65265, 1), (737.86223, 1)], min_db)


def B_weighting(frequencies: Any, *, min_db: Optional[float] = -80.0) -> np.ndarray:
    """B-weighting gain in dB: three zeros at the origin, a single pole at 158.5 Hz, +0.17 dB."""
    return _gain_db(frequencies, 0.17, 3, [(158.48932, 1)], min_db)


def C_weighting(frequencies: Any, *, min_db: Optional[float] = -80.0) -> np.ndarray:
    """C-weighting gain in dB: two zeros at the origin and the shared double poles, +0.062 dB."""
    return _gain_db(frequencies, 0.062, 2, [], min_db)


def D_weighting(frequencies: Any, *, min_db: Optional[float] = -80.0) -> np.ndarray:
    """D-weighting gain in dB at ``frequencies`` (Hz), clipped below at ``min_db``.

    ``|H| = f / 6.8967e-5 * sqrt(h(f) / ((f^2 + 282.7^2) (f^2 + 1160^2)))`` with the
    bump around 1-10 kHz ``h(f) = ((1018.7^2 - f^2)^2 + 1039.6^2 f^2) /
    ((3136.5^2 - f^2)^2 + 3424^2 f^2)``.
    """
    f_sq = np.asanyarray(frequencies) ** 2.0
    scale = 8.3046305e-3**2.0
    with np.errstate(divide="ignore"):
        bump = (np.log10((1018.7**2.0 - f_sq) ** 2 + 1039.6**2.0 * f_sq)
                - np.log10((3136.5**2.0 - f_sq) ** 2 + 3424.0**2.0 * f_sq))
        tail = np.log10(f_sq + 282.7**2.0) + np.log10(f_sq + 1160.0**2.0)
        weights = 20.0 * (0.5 * np.log10(f_sq) - np.log10(scale) + 0.5 * (bump - tail))
    return weights if min_db is None else np.maximum(min_db, weights)


def Z_weighting(frequencies: Any, *, min_db: Optional[float] = None) -> np.ndarray:
    """The flat weighting: 0 dB at every frequency (``min_db`` is accepted and unused)."""
    return np.zeros_like(np.asanyarray(frequencies), dtype=float)


_WEIGHTINGS = {"A": A_weighting, "B": B_weighting, "C": C_weighting, "D": D_weighting,
               "Z": Z_weighting, None: Z_weighting}


def frequency_weighting(frequencies: Any, *, kind: Optional[str] = "A",
                        **kwargs: Any) -> np.ndarray:
    """The weighting curve ``kind`` (``'A'``, ``'B'``, ``'C'``, ``'D'``, ``'Z'`` or None) in dB.

    ``kwargs`` go to the curve (``min_db``).
    """
    if isinstance(kind, str):
        kind = kind.upper()
    if kind not in _WEIGHTINGS:
        raise ParameterError(f"Unknown weighting kind: {kind}")
    return _WEIGHTINGS[kind](frequencies, **kwargs)


def multi_frequency_weighting(frequencies: Any, *, kinds: Iterable[str] = "ZAC",
                              **kwargs: Any) -> np.ndarray:
    """One row of :func:`frequency_weighting` for each of ``kinds``, stacked on axis 0."""
    return np.stack([frequency_weighting(frequencies, kind=k, **kwargs) for k in kinds], axis=0)


# ---------------------------------------------------------------------------
# Indian svara names and FJS names (host Python)
# ---------------------------------------------------------------------------

_SVARA_H = ["Sa", "re", "Re", "ga", "Ga", "ma", "Ma", "Pa", "dha", "Dha", "ni", "Ni"]


def _mark_svara_octave(name: str, steps: int, octave: bool, unicode: bool) -> str:
    """``name`` with its octave: a dot above (``'``) in the octave above Sa's, a dot below (``,``) in the one below."""
    if not octave:
        return name
    if 12 <= steps < 24:
        mark, suffix = "\u0307", "'"
    elif -12 <= steps < 0:
        mark, suffix = "\u0323", ","
    else:
        return name
    return name[0] + mark + name[1:] if unicode else name + suffix


def midi_to_svara_h(midi: Any, *, Sa: float, abbr: bool = True, octave: bool = True,
                    unicode: bool = True) -> Any:
    """The Hindustani svara of a MIDI number above the tonic ``Sa`` (a MIDI number), or an array of them.

    ``abbr`` keeps the initial (``'S'``, ``'r'``, ...); ``octave`` marks the
    octaves above and below Sa's, ``unicode`` with combining dots, else with
    ``'`` and ``,``. A number that is not finite gives ``''``.
    """
    if not np.isscalar(midi):
        return np.array([midi_to_svara_h(m, Sa=Sa, abbr=abbr, octave=octave, unicode=unicode)
                         for m in np.asarray(midi)])
    if not np.isfinite(midi):
        return ""
    steps = int(np.round(midi - Sa))
    name = _SVARA_H[steps % 12]
    return _mark_svara_octave(name[0] if abbr else name, steps, octave, unicode)


def hz_to_svara_h(frequencies: Any, *, Sa: float, abbr: bool = True, octave: bool = True,
                  unicode: bool = True) -> Any:
    """:func:`midi_to_svara_h` of frequencies in Hz, with the tonic ``Sa`` in Hz."""
    return midi_to_svara_h(hz_to_midi(frequencies), Sa=float(hz_to_midi(Sa)), abbr=abbr,
                           octave=octave, unicode=unicode)


def note_to_svara_h(notes: Any, *, Sa: str, abbr: bool = True, octave: bool = True,
                    unicode: bool = True) -> Any:
    """:func:`midi_to_svara_h` of spelled notes, with the tonic ``Sa`` spelled (``'C4'``)."""
    return midi_to_svara_h(note_to_midi(notes, round_midi=False), Sa=note_to_midi(Sa),
                           abbr=abbr, octave=octave, unicode=unicode)


def midi_to_svara_c(midi: Any, *, Sa: float, mela: Any, abbr: bool = True, octave: bool = True,
                    unicode: bool = True) -> Any:
    """The Carnatic svara of a MIDI number above ``Sa`` under the melakarta ``mela`` (name or 1-72).

    The names are :func:`~librosa_tpu_torch.core.notation.mela_to_svara`'s;
    ``abbr``, ``octave`` and ``unicode`` as in :func:`midi_to_svara_h`.
    """
    from .notation import mela_to_svara

    if not np.isscalar(midi):
        return np.array([midi_to_svara_c(m, Sa=Sa, mela=mela, abbr=abbr, octave=octave,
                                         unicode=unicode) for m in np.asarray(midi)])
    if not np.isfinite(midi):
        return ""
    steps = int(np.round(midi - Sa))
    name = mela_to_svara(mela, abbr=abbr, unicode=unicode)[steps % 12]
    return _mark_svara_octave(name, steps, octave, unicode)


def hz_to_svara_c(frequencies: Any, *, Sa: float, mela: Any, abbr: bool = True,
                  octave: bool = True, unicode: bool = True) -> Any:
    """:func:`midi_to_svara_c` of frequencies in Hz, with the tonic ``Sa`` in Hz."""
    return midi_to_svara_c(hz_to_midi(frequencies), Sa=float(hz_to_midi(Sa)), mela=mela,
                           abbr=abbr, octave=octave, unicode=unicode)


def note_to_svara_c(notes: Any, *, Sa: str, mela: Any, abbr: bool = True, octave: bool = True,
                    unicode: bool = True) -> Any:
    """:func:`midi_to_svara_c` of spelled notes, with the tonic ``Sa`` spelled."""
    return midi_to_svara_c(note_to_midi(notes, round_midi=False), Sa=note_to_midi(Sa),
                           mela=mela, abbr=abbr, octave=octave, unicode=unicode)


def hz_to_fjs(frequencies: Any, *, fmin: Optional[float] = None, unison: Optional[str] = None,
              unicode: bool = False) -> Any:
    """FJS names of just-intoned frequencies in Hz, as intervals above ``fmin`` (default their minimum).

    ``unison`` names ``fmin`` (default: its nearest note, without octave);
    see :func:`~librosa_tpu_torch.core.notation.interval_to_fjs`.
    """
    from .notation import interval_to_fjs

    base = np.min(frequencies) if fmin is None else fmin
    ratios = frequencies / base if np.isscalar(frequencies) else np.asarray(frequencies) / base
    root = hz_to_note(base, octave=False, unicode=False) if unison is None else unison
    return interval_to_fjs(ratios, unison=root, unicode=unicode)
