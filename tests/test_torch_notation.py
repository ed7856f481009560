"""The port's notation, svara and FJS names against the JAX package: equal in every case.

Both packages compute them in Python and numpy on the host, so every
name, degree and table must be the same.
"""

import numpy as np
import pytest

import librosa_tpu as lt

import librosa_tpu_torch as L


def _eq(got, want):
    assert type(got) is type(want) or (isinstance(got, np.ndarray) and isinstance(want, np.ndarray))
    if isinstance(want, np.ndarray):
        assert got.dtype.kind == want.dtype.kind and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("thaat", lt.list_thaat())
def test_thaats(thaat):
    _eq(L.thaat_to_degrees(thaat), lt.thaat_to_degrees(thaat))
    _eq(L.thaat_to_degrees(thaat.upper()), lt.thaat_to_degrees(thaat.upper()))


def test_melas_and_lists():
    assert L.list_mela() == lt.list_mela() and L.list_thaat() == lt.list_thaat()
    for mela in list(range(1, 73)) + ["kanakangi", "Harikambhoji", "rasikapriya"]:
        _eq(L.mela_to_degrees(mela), lt.mela_to_degrees(mela))
        for abbr in (True, False):
            for unicode in (True, False):
                _eq(L.mela_to_svara(mela, abbr=abbr, unicode=unicode),
                    lt.mela_to_svara(mela, abbr=abbr, unicode=unicode))
    for module in (L, lt):
        with pytest.raises(module.ParameterError):
            module.mela_to_degrees(0)
        with pytest.raises(KeyError):
            module.mela_to_svara("no such raga")


def test_fifths_to_note():
    for unison in ("C", "F#", "Bb", "E𝄫", "G♯♯", "d"):
        for fifths in range(-16, 17):
            for unicode in (True, False):
                _eq(L.fifths_to_note(unison=unison, fifths=fifths, unicode=unicode),
                    lt.fifths_to_note(unison=unison, fifths=fifths, unicode=unicode))
    with pytest.raises(L.ParameterError):
        L.fifths_to_note(unison="H", fifths=1)


RATIOS = [1.0, 3 / 2, 4 / 3, 5 / 4, 6 / 5, 7 / 4, 9 / 8, 11 / 8, 13 / 8, 15 / 8, 17 / 16,
          19 / 16, 23 / 16, 45 / 32, 64 / 45, 2.0, 0.5, 10 / 9, 16 / 15, 25 / 24]


def test_interval_to_fjs():
    for unison in ("C", "A", "F#"):
        for unicode in (True, False):
            _eq(L.interval_to_fjs(np.array(RATIOS), unison=unison, unicode=unicode),
                lt.interval_to_fjs(np.array(RATIOS), unison=unison, unicode=unicode))
            _eq(L.interval_to_fjs(5 / 4, unison=unison, unicode=unicode),
                lt.interval_to_fjs(5 / 4, unison=unison, unicode=unicode))
    for tol in (1.001, 1.01, 1.1):
        _eq(L.interval_to_fjs(np.array(RATIOS), tolerance=tol),
            lt.interval_to_fjs(np.array(RATIOS), tolerance=tol))
    for module in (L, lt):
        with pytest.raises(module.ParameterError):
            module.interval_to_fjs(-1.0)
        with pytest.raises(module.ParameterError):
            module.interval_to_fjs(np.pi)


def test_hz_to_fjs():
    freqs = 110.0 * np.array(RATIOS[:12])
    for kw in (dict(), dict(fmin=110.0), dict(unison="A", unicode=True), dict(fmin=55.0)):
        _eq(L.hz_to_fjs(freqs, **kw), lt.hz_to_fjs(freqs, **kw))
    _eq(L.hz_to_fjs(165.0, fmin=110.0), lt.hz_to_fjs(165.0, fmin=110.0))
    assert L.core.hz_to_fjs is L.hz_to_fjs


@pytest.mark.parametrize("abbr", [True, False])
@pytest.mark.parametrize("octave", [True, False])
@pytest.mark.parametrize("unicode", [True, False])
def test_svara(abbr, octave, unicode):
    kw = dict(abbr=abbr, octave=octave, unicode=unicode)
    midis = np.arange(40, 90, 0.5)
    _eq(L.midi_to_svara_h(midis, Sa=60, **kw), lt.midi_to_svara_h(midis, Sa=60, **kw))
    _eq(L.midi_to_svara_h(61.0, Sa=48, **kw), lt.midi_to_svara_h(61.0, Sa=48, **kw))
    _eq(L.midi_to_svara_h(np.nan, Sa=48, **kw), lt.midi_to_svara_h(np.nan, Sa=48, **kw))
    hz = np.array([110.0, 196.0, 262.0, 440.0, 523.3, 1000.0])
    _eq(L.hz_to_svara_h(hz, Sa=220.0, **kw), lt.hz_to_svara_h(hz, Sa=220.0, **kw))
    notes = ["C4", "D#4", "G5", "Bb3", "F#4"]
    _eq(L.note_to_svara_h(notes, Sa="C4", **kw), lt.note_to_svara_h(notes, Sa="C4", **kw))
    for mela in (1, 15, 29, 36, 37, 65, "mechakalyani"):
        _eq(L.midi_to_svara_c(midis, Sa=60, mela=mela, **kw),
            lt.midi_to_svara_c(midis, Sa=60, mela=mela, **kw))
        _eq(L.hz_to_svara_c(hz, Sa=220.0, mela=mela, **kw),
            lt.hz_to_svara_c(hz, Sa=220.0, mela=mela, **kw))
        _eq(L.note_to_svara_c(notes, Sa="C4", mela=mela, **kw),
            lt.note_to_svara_c(notes, Sa="C4", mela=mela, **kw))
    _eq(L.note_to_svara_c("G4", Sa="C4", mela=29, **kw),
        lt.note_to_svara_c("G4", Sa="C4", mela=29, **kw))
    for name in ("midi_to_svara_h", "hz_to_svara_c", "note_to_svara_h"):
        assert getattr(L.core, name) is getattr(L, name)
