"""The port's constant-Q family, its grids and its chroma features against the JAX package.

Everything on the CPU, from the same seeded numpy inputs on both sides.
Covered: the note, tuning and tempo grids and the interval systems (to
1e-10), ``key_to_notes``, the wavelet filters, ``cqt``, ``vqt``,
``pseudo_cqt`` (and its route to the stft_mel kernel's function),
``hybrid_cqt``, ``icqt``, ``griffinlim_cqt`` from zero phase,
``chroma_cqt``, ``chroma_cens``, ``chroma_vqt``, multichannel input, and the
flat namespace against the JAX package's.

Tolerances: each transform at its golden's floor (110 dB; ``chroma_cqt`` and
``chroma_cens`` 120 dB), measured 110-140 dB. ``griffinlim_cqt`` has no
golden: each round normalises the phase of bins near zero, where either
side's float32 rounding moves it, so after two rounds from zero phase the
floor is 100 dB (port against JAX 106.5 dB, each 97-99 dB from the port's
own float64 run; 130 dB before the first round).
"""

import numpy as np
import pytest
import scipy.sparse
import torch

import librosa_tpu as lt

import librosa_tpu_torch as L
from librosa_tpu_torch.core import constantq as port_cq

SR = 22050
CQT_SNR_DB = 110.0     # the cqt, vqt, pseudo_hybrid_cqt and icqt goldens' floor
CHROMA_SNR_DB = 120.0  # the chroma_cqt and chroma_cens goldens' floor
GL_SNR_DB = 100.0      # griffinlim_cqt after two rounds (see above)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _snr(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return 10 * np.log10(np.sum(np.abs(want) ** 2) / max(np.sum(np.abs(got - want) ** 2), 1e-300))


def _signal(n=SR // 2, seed=0, channels=()):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    tone = np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 97.3 * t)
    return (tone + 0.1 * rng.randn(*channels, n)).astype(np.float32)


# ---------------------------------------------------------------------------
# grids, notes, interval systems, wavelets
# ---------------------------------------------------------------------------


def test_frequency_grids_match_jax():
    for got, want in [
        (L.cqt_frequencies(84, fmin=L.note_to_hz("C1")), lt.cqt_frequencies(84, fmin=lt.note_to_hz("C1"))),
        (L.cqt_frequencies(40, fmin=55.0, bins_per_octave=24, tuning=-0.3),
         lt.cqt_frequencies(40, fmin=55.0, bins_per_octave=24, tuning=-0.3)),
        (L.tempo_frequencies(384, sr=SR, hop_length=512), lt.tempo_frequencies(384, sr=SR, hop_length=512)),
        (L.fourier_tempo_frequencies(sr=SR, hop_length=256, win_length=100),
         lt.fourier_tempo_frequencies(sr=SR, hop_length=256, win_length=100)),
        (L.A4_to_tuning([430.0, 440.0, 452.5], bins_per_octave=24),
         lt.A4_to_tuning([430.0, 440.0, 452.5], bins_per_octave=24)),
        (L.tuning_to_A4([-0.3, 0.0, 0.25]), lt.tuning_to_A4([-0.3, 0.0, 0.25])),
    ]:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("note", ["C4", "C#3", "Bb-1", "A4+25", "G𝄪2", "E𝄫5", "f♮4", "B!3-40", "a",
                                  ["C1", "D♭2", "A4+50"]])
def test_note_to_midi_and_hz_match_jax(note):
    for rnd in (True, False):
        np.testing.assert_array_equal(L.note_to_midi(note, round_midi=rnd),
                                      lt.note_to_midi(note, round_midi=rnd))
        np.testing.assert_allclose(L.note_to_hz(note, round_midi=rnd),
                                   lt.note_to_hz(note, round_midi=rnd), rtol=1e-12)
    with pytest.raises(L.ParameterError):
        L.note_to_midi("H2")
    assert np.isnan(L.note_to_midi(""))


@pytest.mark.parametrize("key", ["C:maj", "A:min", "Eb:maj", "F#:min", "C#:maj", "Cb:maj",
                                 "G##:maj", "Abb:min", "D:dor", "E:phryg", "F:lydian",
                                 "Bb:mix", "C#:aeolian", "B:locrian", "c:ionian", "Fn:maj"])
def test_key_spellings_match_jax(key):
    for unicode in (True, False):
        for natural in (True, False):
            assert (L.key_to_notes(key, unicode=unicode, natural=natural)
                    == lt.key_to_notes(key, unicode=unicode, natural=natural))
    np.testing.assert_array_equal(L.key_to_degrees(key), lt.key_to_degrees(key))
    midi = np.linspace(20.0, 100.0, 23)
    for cents in (True, False):
        np.testing.assert_array_equal(L.midi_to_note(midi, key=key, cents=cents),
                                      lt.midi_to_note(midi, key=key, cents=cents))
    assert L.hz_to_note(255.0, key=key, cents=True) == lt.hz_to_note(255.0, key=key, cents=True)
    with pytest.raises(L.ParameterError):
        L.midi_to_note(60, octave=False, cents=True)


@pytest.mark.parametrize("kw", [
    dict(n_bins=24, fmin=55.0, intervals="equal"),
    dict(n_bins=30, fmin=55.0, intervals="equal", tuning=0.2, bins_per_octave=10),
    dict(n_bins=24, fmin=55.0, intervals="pythagorean"),
    dict(n_bins=24, fmin=55.0, intervals="ji3", bins_per_octave=24),
    dict(n_bins=24, fmin=55.0, intervals="ji5"),
    dict(n_bins=31, fmin=30.0, intervals="ji7", sort=False),
    dict(n_bins=10, fmin=100.0, intervals=[1, 9 / 8, 5 / 4, 4 / 3, 3 / 2, 5 / 3]),
], ids=["equal", "equal_tuned", "pythagorean", "ji3_24", "ji5", "ji7_unsorted", "explicit"])
def test_interval_frequencies_match_jax(kw):
    np.testing.assert_allclose(L.interval_frequencies(**kw), lt.interval_frequencies(**kw),
                               rtol=1e-10, atol=1e-12)


def test_interval_systems_and_factors_match_jax():
    for bpo in (5, 12, 17):
        for sort in (True, False):
            np.testing.assert_allclose(L.pythagorean_intervals(bins_per_octave=bpo, sort=sort),
                                       lt.pythagorean_intervals(bins_per_octave=bpo, sort=sort),
                                       rtol=1e-10)
        assert (L.pythagorean_intervals(bins_per_octave=bpo, return_factors=True)
                == lt.pythagorean_intervals(bins_per_octave=bpo, return_factors=True))
    for primes, bpo in (([3, 5], 12), ([3, 5, 7], 19), ([3], 24), ([5, 7], 9)):
        for sort in (True, False):
            np.testing.assert_allclose(L.plimit_intervals(primes=primes, bins_per_octave=bpo, sort=sort),
                                       lt.plimit_intervals(primes=primes, bins_per_octave=bpo, sort=sort),
                                       rtol=1e-10)
        assert (L.plimit_intervals(primes=primes, bins_per_octave=bpo, return_factors=True)
                == lt.plimit_intervals(primes=primes, bins_per_octave=bpo, return_factors=True))
    with pytest.raises(L.ParameterError):
        L.interval_frequencies(4, fmin=55.0, intervals="ji11")


@pytest.mark.parametrize("kw", [dict(), dict(gamma=None), dict(gamma=4.0, filter_scale=2.0),
                                dict(window="hamming", norm=2), dict(pad_fft=False, norm=None)],
                         ids=["defaults", "erb", "gamma_scale", "hamming_l2", "unpadded"])
def test_wavelets_match_jax(kw):
    freqs = L.cqt_frequencies(30, fmin=40.0)
    lk = {k: v for k, v in kw.items() if k in ("gamma", "filter_scale", "window")}
    lengths, cutoff = L.filters.wavelet_lengths(freqs=freqs, sr=SR, **lk)
    want_lengths, want_cutoff = lt.filters.wavelet_lengths(freqs=freqs, sr=SR, **lk)
    np.testing.assert_allclose(lengths, want_lengths, rtol=1e-12)
    assert abs(cutoff - want_cutoff) < 1e-9
    basis, blengths = L.filters.wavelet(freqs=freqs, sr=SR, **kw)
    want_basis, _ = lt.filters.wavelet(freqs=freqs, sr=SR, **kw)
    assert basis.shape == want_basis.shape and basis.dtype == want_basis.dtype
    np.testing.assert_allclose(basis, want_basis, rtol=1e-5, atol=1e-7)
    assert L.filters.window_bandwidth("hann") == lt.filters.window_bandwidth("hann")
    assert L.filters.window_bandwidth(("kaiser", 6.0)) == lt.filters.window_bandwidth(("kaiser", 6.0))


def test_sparsify_rows_matches_jax():
    x = np.random.RandomState(3).randn(6, 50) * np.exp(np.random.RandomState(4).randn(6, 50))
    for q in (0.0, 0.01, 0.2, 0.9):
        got = L.util.sparsify_rows(x, quantile=q)
        assert isinstance(got, scipy.sparse.csr_matrix)  # as the JAX function returns
        np.testing.assert_array_equal(got.toarray(),
                                      lt.util.sparsify_rows(x, quantile=q).toarray())
    np.testing.assert_array_equal(L.util.sparsify_rows(x[0], quantile=0.1).toarray(),
                                  lt.util.sparsify_rows(x[0], quantile=0.1).toarray())
    with pytest.raises(L.ParameterError):
        L.util.sparsify_rows(x, quantile=1.0)


# ---------------------------------------------------------------------------
# the transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_bins=84), dict(n_bins=48, fmin=65.0, tuning=0.2, scale=False),
    dict(n_bins=None, fmin=200.0, sparsity=0.0, hop_length=256),
    dict(n_bins=30, pad_mode="reflect", window="hamming", filter_scale=2),
], ids=["84_bins", "tuned_unscaled", "to_nyquist_dense_hop256", "reflect_hamming_fscale2"])
def test_cqt_matches_jax(kw):
    y = _signal()
    got = L.cqt(y, sr=SR, res_type="polyphase", **kw)
    want = lt.cqt(y, sr=SR, res_type="polyphase", **kw)
    assert got.dtype == torch.complex64
    assert _snr(got.numpy(), want) >= CQT_SNR_DB


@pytest.mark.parametrize("kw", [
    dict(n_bins=48, gamma=None), dict(n_bins=84, intervals="ji5"),
    dict(n_bins=24, intervals=[1, 9 / 8, 5 / 4, 4 / 3, 3 / 2, 5 / 3], fmin=110.0, gamma=3.0),
], ids=["erb", "ji5", "explicit_gamma3"])
def test_vqt_matches_jax(kw):
    y = _signal(seed=1)
    got = L.vqt(y, sr=SR, res_type="polyphase", **kw)
    want = lt.vqt(y, sr=SR, res_type="polyphase", **kw)
    assert _snr(got.numpy(), want) >= CQT_SNR_DB


def test_cqt_float64_and_estimated_tuning_match_jax():
    y = _signal(seed=2)
    got = L.cqt(y.astype(np.float64), sr=SR, n_bins=36, res_type="polyphase")
    want = lt.cqt(y.astype(np.float64), sr=SR, n_bins=36, res_type="polyphase")
    assert got.dtype == torch.complex128 and _snr(got.numpy(), want) >= CQT_SNR_DB
    got = L.cqt(y, sr=SR, n_bins=36, tuning=None, res_type="polyphase")
    want = lt.cqt(y, sr=SR, n_bins=36, tuning=None, res_type="polyphase")
    assert _snr(got.numpy(), want) >= CQT_SNR_DB


def test_cqt_refuses_what_jax_refuses():
    y = _signal()
    for kw in (dict(fmin=12000.0), dict(n_bins=200)):
        with pytest.raises(L.ParameterError):
            L.cqt(y, sr=SR, res_type="polyphase", **kw)
        with pytest.raises(lt.ParameterError):
            lt.cqt(y, sr=SR, res_type="polyphase", **kw)


@pytest.mark.parametrize("kw", [dict(n_bins=48), dict(n_bins=36, scale=False, hop_length=256),
                                dict(n_bins=None, fmin=300.0)],
                         ids=["48_bins", "unscaled_hop256", "to_nyquist"])
def test_pseudo_cqt_matches_jax_through_the_stft_mel_route(kw, monkeypatch):
    y = _signal(seed=3)
    calls = []
    route = port_cq._stft_mel_core

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return route(*args, **kwargs)

    monkeypatch.setattr(port_cq, "_stft_mel_core", spy)
    got = L.pseudo_cqt(y, sr=SR, **kw)
    want = lt.pseudo_cqt(y, sr=SR, **kw)
    assert got.dtype == torch.complex64 and np.asarray(want).dtype == np.complex64
    assert _snr(got.numpy(), want) >= CQT_SNR_DB
    assert len(calls) == 1 and calls[0]["power"] == 1.0


def test_hybrid_cqt_matches_jax():
    y = _signal(seed=4)
    for kw in (dict(n_bins=None, fmin=150.0, hop_length=256),):
        got = L.hybrid_cqt(y, sr=SR, res_type="polyphase", **kw)
        want = lt.hybrid_cqt(y, sr=SR, res_type="polyphase", **kw)
        assert got.dtype == torch.float32
        assert _snr(got.numpy(), want) >= CQT_SNR_DB


@pytest.mark.parametrize("kw", [dict(n_bins=36, scale=False),
                                dict(n_bins=36, hop_length=256, bins_per_octave=24, fmin=100.0)],
                         ids=["36_unscaled", "bpo24"])
def test_icqt_matches_jax(kw):
    y = _signal(seed=5)
    inv = {k: v for k, v in kw.items() if k != "n_bins"}
    C = np.asarray(lt.cqt(y, sr=SR, res_type="polyphase", **kw))
    got = L.icqt(C, sr=SR, length=len(y), res_type="polyphase", **inv)
    want = lt.icqt(C, sr=SR, length=len(y), res_type="polyphase", **inv)
    assert got.shape == (len(y),)
    assert _snr(got.numpy(), want) >= CQT_SNR_DB
    assert L.icqt(C, sr=SR, res_type="polyphase", dtype=np.float64, **inv).dtype == torch.float64


def test_griffinlim_cqt_from_zero_phase_matches_jax():
    y = _signal(SR // 2, seed=6)
    C = np.abs(np.asarray(lt.cqt(y, sr=SR, n_bins=24, fmin=110.0, res_type="polyphase")))
    kw = dict(sr=SR, fmin=110.0, n_iter=2, init=None, res_type="polyphase", length=len(y))
    got = L.griffinlim_cqt(C, **kw)
    want = lt.griffinlim_cqt(C, **kw)
    assert got.shape == (len(y),)
    assert _snr(got.numpy(), want) >= GL_SNR_DB
    # random phases: a torch.Generator's, so only the seed's determinism is shared
    a = L.griffinlim_cqt(C, sr=SR, n_iter=1, rng=3, res_type="polyphase")
    b = L.griffinlim_cqt(C, sr=SR, n_iter=1, rng=3, res_type="polyphase")
    assert torch.equal(a, b)
    with pytest.raises(L.ParameterError):
        L.griffinlim_cqt(C, momentum=-1)
    with pytest.raises(L.ParameterError):
        L.griffinlim_cqt(C, init="zeros")


def test_multichannel_cqt_is_per_channel():
    y = _signal(seed=7, channels=(2, 3))
    got = L.cqt(y, sr=SR, n_bins=36, res_type="polyphase")
    assert got.shape[:2] == (2, 3)
    want = lt.cqt(y, sr=SR, n_bins=36, res_type="polyphase")
    assert _snr(got.numpy(), want) >= CQT_SNR_DB
    one = L.cqt(y[1, 2], sr=SR, n_bins=36, res_type="polyphase")
    assert _snr(got[1, 2].numpy(), one.numpy()) >= 140.0
    inv = L.icqt(got, sr=SR, res_type="polyphase", length=y.shape[-1])
    assert inv.shape == y.shape
    assert L.pseudo_cqt(y, sr=SR, n_bins=24).shape[:2] == (2, 3)


# ---------------------------------------------------------------------------
# chroma from constant-Q magnitudes
# ---------------------------------------------------------------------------


def test_chroma_cqt_and_cens_match_jax():
    y = _signal(seed=8)
    C = np.abs(np.asarray(lt.cqt(y, sr=SR, n_bins=84, res_type="polyphase")))
    for kw in (dict(), dict(norm=2, threshold=0.1), dict(n_chroma=12, bins_per_octave=12),
               dict(window=np.hanning(3))):
        assert _snr(L.feature.chroma_cqt(C=C, sr=SR, **kw).numpy(),
                    lt.feature.chroma_cqt(C=C, sr=SR, **kw)) >= CHROMA_SNR_DB
    for kw in (dict(), dict(win_len_smooth=None), dict(win_len_smooth=11, norm=1),
               dict(smoothing_window="hamming")):
        assert _snr(L.feature.chroma_cens(C=C, sr=SR, **kw).numpy(),
                    lt.feature.chroma_cens(C=C, sr=SR, **kw)) >= CHROMA_SNR_DB
    with pytest.raises(L.ParameterError):
        L.feature.chroma_cqt(C=C, bins_per_octave=30, n_chroma=12)
    with pytest.raises(L.ParameterError):
        L.feature.chroma_cens(C=C, win_len_smooth=0)


def test_chroma_from_the_signal_matches_jax():
    y = _signal(seed=9)
    kw = dict(y=y, sr=SR, n_octaves=3, fmin=130.0)
    assert _snr(L.feature.chroma_cqt(tuning=0.0, **kw).numpy(),
                lt.feature.chroma_cqt(tuning=0.0, **kw)) >= CQT_SNR_DB
    assert _snr(L.feature.chroma_vqt(intervals="ji5", **kw).numpy(),
                lt.feature.chroma_vqt(intervals="ji5", **kw)) >= CQT_SNR_DB
    with pytest.raises(L.ParameterError):
        L.feature.chroma_vqt(y=y, sr=SR)


# ---------------------------------------------------------------------------
# the namespace
# ---------------------------------------------------------------------------


def test_flat_names_are_the_jax_package_names():
    own = {"get_device", "set_device"}
    for mod, ref in ((L, lt), (L.core, lt.core), (L.feature, lt.feature), (L.util, lt.util),
                     (L.filters, lt.filters), (L.decompose, lt.decompose),
                     (L.effects, lt.effects)):
        names = getattr(mod, "__all__", None) or dir(mod)
        public = {n for n in names if not n.startswith("_")
                  and callable(getattr(mod, n)) and not isinstance(getattr(mod, n), type)}
        missing = sorted(n for n in public - own if not hasattr(ref, n))
        assert not missing, (mod.__name__, missing)
    assert not hasattr(L, "resample_poly") and not hasattr(lt, "resample_poly")
    for name in ("cqt", "vqt", "pseudo_cqt", "hybrid_cqt", "icqt", "griffinlim_cqt",
                 "interval_frequencies", "pythagorean_intervals", "plimit_intervals",
                 "note_to_hz", "hz_to_note", "cqt_frequencies", "key_to_notes"):
        assert callable(getattr(L, name)) and callable(getattr(lt, name))
