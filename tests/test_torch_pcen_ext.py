"""The port's pcen, biquad bank, iirt, reassigned spectrogram and fmt against the JAX package.

Seeded inputs on the CPU: noise over a tone and a chirp, n_fft 512 for the
spectrograms. Floors, each below the value measured on these inputs:

- ``pcen``: 120 dB (132.4-137.9 measured: the doubling scan against XLA's
  associative scan, then logs and powers), the final state ``zf`` likewise
  (142.9) and the streamed halves against the JAX package's whole run
  (133.5);
- the bank (``sosfilt``, ``sosfiltfilt``, ``sos_bank_filtfilt``,
  ``biquad_filter``) on six bands of the 882 Hz semitone group, an elliptic
  band of Q ~ 40 and a Butterworth low-pass: 130 dB against float64 scipy
  (143.9-149.7 measured; the final states 136.7-150.2) and 150 dB against
  the JAX package (167.3-177.7, or equal). On the semitone bands the
  refinement round lifts the same float32 scan from 122.9 to 142.5 dB
  against float64 scipy; the test holds the refined scan above 130 dB and
  the unrefined one at least 15 dB lower. The error-free transforms are
  exact (measured equal to float64);
- ``iirt``: 120 dB, the goldens' floor (140.5 measured in both layouts);
  blocks of one track and one frame give the same bits as the whole;
- ``reassigned_spectrogram``: 130 dB on the coordinates of the bins above
  1e-3 of the peak magnitude (142.1-150.9 measured, or equal: a quotient
  of two float32 spectra), 125 dB on the magnitudes (139.3), and the same
  NaN mask;
- ``fmt``: 115 dB cubic and linear (129.7-136.9 measured: a float32
  spline solve by doubling scans in another order, then an FFT);
- ``mr_frequencies``, ``semitone_filterbank``: equal (the same float64
  host design).
"""

import warnings

import numpy as np
import pytest
import scipy.signal
import torch

import librosa_tpu as lt
from librosa_tpu.ops import iir as jax_iir

import librosa_tpu_torch as L
from librosa_tpu_torch.ops import iir as port_iir
from torch_threads import one_torch_thread  # noqa: F401 (autouse, one intra-op thread)

SR = 22050


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _snr(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    got = got.astype(np.complex128 if np.iscomplexobj(want) else np.float64)
    want = np.asarray(want).astype(got.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    return 10 * np.log10(np.sum(np.abs(want) ** 2) / max(np.sum(np.abs(got - want) ** 2), 1e-300))


def _signal(n=SR, seed=0, channels=2):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    y = 0.1 * rng.randn(channels, n) + 0.5 * np.sin(2 * np.pi * (220 + 400 * t) * t)
    return (y[0] if channels == 1 else y).astype(np.float32)


@pytest.fixture(scope="module")
def power():
    return (np.abs(np.asarray(lt.stft(_signal(), n_fft=512, hop_length=128))) ** 2).astype(
        np.float32)


@pytest.mark.parametrize("kw", [dict(), dict(max_size=5, max_axis=-2),
                                dict(gain=0.8, bias=10, power=0.25, time_constant=0.06),
                                dict(power=0.0), dict(bias=0.0), dict(b=0.3), dict(ref="given")],
                         ids=["default", "maxfilter", "gain", "log", "nobias", "b", "ref"])
def test_pcen(power, kw):
    kw = dict(kw)
    if kw.get("ref") == "given":
        kw["ref"] = power * 0.5 + 1e-3
    got = L.pcen(torch.from_numpy(power), sr=SR, hop_length=128, **kw)
    want = lt.pcen(power, sr=SR, hop_length=128, **kw)
    assert _snr(got, want) > 120


def test_pcen_streams_through_its_final_state(power):
    want = lt.pcen(power, sr=SR, hop_length=128)
    p1, zf = L.pcen(torch.from_numpy(power[..., :30]), sr=SR, hop_length=128, return_zf=True)
    j1, jzf = lt.pcen(power[..., :30], sr=SR, hop_length=128, return_zf=True)
    assert zf.shape == jzf.shape and _snr(zf, jzf) > 120
    p2 = L.pcen(torch.from_numpy(power[..., 30:]), sr=SR, hop_length=128, zi=zf)
    assert _snr(torch.cat([p1, p2], dim=-1), want) > 120


def test_pcen_on_a_complex_input_warns_and_refuses_what_the_jax_package_refuses(power):
    D = np.asarray(lt.stft(_signal(channels=1), n_fft=512, hop_length=128))
    with pytest.warns(UserWarning, match="discards phase"):
        got = L.pcen(torch.from_numpy(D), sr=SR, hop_length=128)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert _snr(got, lt.pcen(D, sr=SR, hop_length=128)) > 120
    for kw in (dict(power=-1), dict(eps=0), dict(max_size=0), dict(b=2.0),
               dict(max_size=3)):  # a 3-d stack needs max_axis
        with pytest.raises(L.ParameterError):
            L.pcen(torch.from_numpy(power), **kw)
        with pytest.raises(lt.util.ParameterError):
            lt.pcen(power, **kw)


@pytest.fixture(scope="module")
def group882():
    bank, rates = lt.filters.semitone_filterbank(flayout="sos")
    return np.stack([bank[i] for i in np.flatnonzero(rates == 882.0)[:6]])


def test_sos_bank_filtfilt(group882):
    x = np.random.RandomState(1).randn(2, 1500).astype(np.float32)
    got = port_iir.sos_bank_filtfilt(torch.from_numpy(x), group882)
    want = np.asarray(jax_iir.sos_bank_filtfilt(x, group882))
    ref = np.stack([[scipy.signal.sosfiltfilt(s, row.astype(np.float64)) for s in group882]
                    for row in x])
    assert got.shape == want.shape == (2, 6, 1500)
    assert _snr(got, ref) > 130 and _snr(got, want) > 150


def test_the_refinement_round_matters(group882):
    x = np.random.RandomState(1).randn(1, 1500).astype(np.float32)
    ref = np.stack([scipy.signal.sosfiltfilt(s, x[0].astype(np.float64)) for s in group882])
    padlen = port_iir._bank_padlen(group882)
    M, v, b0, Mpows, M_lo, v_lo = port_iir._bank_tensors(group882, 1500 + 2 * padlen,
                                                          torch.from_numpy(x))
    zi = torch.as_tensor(np.stack([port_iir.sosfilt_zi(s) for s in group882]),
                         dtype=torch.float32)
    out = {refine: port_iir._bank_filtfilt_core(torch.from_numpy(x), M, v, b0, Mpows, zi, M_lo,
                                                v_lo, padlen=padlen, refine=refine)[0]
           for refine in (True, False)}
    refined, unrefined = _snr(out[True], ref), _snr(out[False], ref)
    assert refined > 130 and unrefined < refined - 15


def test_error_free_transforms_are_exact():
    rng = np.random.RandomState(2)
    a, b = (torch.from_numpy(rng.randn(2048).astype(np.float32)) for _ in range(2))
    exact_p = a.double() * b.double()
    p, e = port_iir._two_prod(a, b)
    assert torch.equal(p.double() + e.double(), exact_p)
    s, e = port_iir._two_sum(a, b)
    assert torch.equal(s.double() + e.double(), a.double() + b.double())


@pytest.mark.parametrize("design", ["ellip", "butter"])
def test_sosfilt_and_sosfiltfilt(design):
    if design == "ellip":
        sos = scipy.signal.ellip(4, 7, 100, [0.4, 0.41], btype="bandpass", output="sos")
    else:
        sos = scipy.signal.butter(4, 0.1, output="sos")
    x = np.random.RandomState(3).randn(2, 3000).astype(np.float32)
    zi = np.random.RandomState(4).randn(2, sos.shape[0], 2).astype(np.float32) * 0.1
    got, zf = port_iir.sosfilt(torch.from_numpy(x), sos, zi=torch.from_numpy(zi))
    want, jzf = jax_iir.sosfilt(x, sos, zi=zi)
    ref, rzf = scipy.signal.sosfilt(sos, x.astype(np.float64), zi=zi.transpose(1, 0, 2))
    assert _snr(got, ref) > 130 and _snr(got, want) > 150
    assert _snr(zf, rzf.transpose(1, 0, 2)) > 130 and _snr(zf, jzf) > 150
    got = port_iir.sosfiltfilt(torch.from_numpy(x.T.copy()), sos, axis=0)
    assert _snr(got, scipy.signal.sosfiltfilt(sos, x.T.astype(np.float64), axis=0)) > 130
    y1, z1 = port_iir.biquad_filter(torch.from_numpy(x), sos[0])
    j1, jz1 = jax_iir.biquad_filter(x, sos[0])
    assert _snr(y1, j1) > 150 and z1.shape == jz1.shape


@pytest.mark.parametrize("flayout", ["sos", "ba"])
def test_iirt(flayout):
    y = _signal(n=SR // 2)
    got = L.iirt(torch.from_numpy(y), sr=SR, res_type="polyphase", flayout=flayout)
    want = lt.iirt(y, sr=SR, res_type="polyphase", flayout=flayout)
    assert got.shape == want.shape == (2, 85, 22)
    assert _snr(got, want) > 120


def test_iirt_blocks_of_tracks_change_nothing(monkeypatch):
    from librosa_tpu_torch.core import spectrum_ext

    y = torch.from_numpy(_signal(n=SR // 4, channels=3))
    whole = L.iirt(y, sr=SR, res_type="polyphase", hop_length=256)
    monkeypatch.setattr(spectrum_ext, "IIRT_BLOCK_BYTES", 1)  # one track, a frame at a time
    assert torch.equal(L.iirt(y, sr=SR, res_type="polyphase", hop_length=256), whole)


@pytest.mark.parametrize("n_bands, n", [(15, 4196352 + 2 * 400), (40, 839271), (30, 167855),
                                         (15, 1 << 30)])
def test_iirt_block_counts_both_state_rows(n_bands, n):
    from librosa_tpu_torch.core import spectrum_ext

    tracks = spectrum_ext.iirt_block_tracks(n_bands, n, 4)
    assert tracks >= 1
    assert tracks == 1 or tracks * n_bands * 2 * n * 4 <= spectrum_ext.IIRT_BLOCK_BYTES
    assert (tracks + 1) * n_bands * 2 * n * 4 > spectrum_ext.IIRT_BLOCK_BYTES


@pytest.mark.parametrize("kw", [dict(), dict(reassign_times=False),
                                dict(reassign_frequencies=False, center=False),
                                dict(fill_nan=True, clip=False), dict(ref_power=np.max)],
                         ids=["both", "freqs", "times", "fill", "ref_max"])
def test_reassigned_spectrogram(kw):
    y = _signal(n=SR // 2)
    got = L.reassigned_spectrogram(torch.from_numpy(y), sr=SR, n_fft=512, **kw)
    want = lt.reassigned_spectrogram(y, sr=SR, n_fft=512, **kw)
    mags = np.asarray(want[2])
    assert _snr(got[2], mags) > 125
    keep = mags > 1e-3 * mags.max()
    for g, w in zip(got[:2], want[:2]):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert _snr(np.where(keep, np.nan_to_num(g), 0), np.where(keep, np.nan_to_num(w), 0)) > 130


@pytest.mark.parametrize("kind", ["cubic", "linear"])
@pytest.mark.parametrize("kw", [dict(), dict(n_fmt=300, beta=0.3), dict(over_sample=2)],
                         ids=["default", "n_fmt", "oversample"])
def test_fmt(kind, kw):
    y = _signal(n=2048)
    got = L.fmt(torch.from_numpy(y), kind=kind, **kw)
    want = lt.fmt(y, kind=kind, **kw)
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert _snr(got, want) > 115


def test_fmt_grid_is_cached_read_only_and_changes_nothing():
    from librosa_tpu_torch.core import spectrum_ext

    y = torch.from_numpy(_signal(n=2048))
    first = L.fmt(y)
    grid = spectrum_ext._fmt_targets(2048, 0.5, None, 1.0)
    assert grid is spectrum_ext._fmt_targets(2048, 0.5, None, 1.0)
    assert not grid.flags.writeable
    assert len(grid) == spectrum_ext._fmt_default_points(2048, 0.5, 1.0)
    assert torch.equal(L.fmt(y), first)


def test_fmt_refuses_what_the_jax_package_refuses():
    for y, kw in ((np.ones(2, np.float32), {}), (np.ones(64, np.float32), dict(t_min=0)),
                  (np.ones(64, np.float32), dict(n_fmt=2)),
                  (np.array([0, np.inf] * 8, np.float32), {})):
        with pytest.raises(L.ParameterError):
            L.fmt(torch.from_numpy(y), **kw)
        with pytest.raises(lt.util.ParameterError):
            lt.fmt(y, **kw)


@pytest.mark.parametrize("tuning", [0.0, 0.25])
def test_mr_frequencies_and_semitone_filterbank(tuning):
    for got, want in zip(L.filters.mr_frequencies(tuning), lt.filters.mr_frequencies(tuning)):
        np.testing.assert_array_equal(got, want)
    for flayout in ("sos", "ba"):
        got, rates = L.filters.semitone_filterbank(tuning=tuning, flayout=flayout)
        want, jrates = lt.filters.semitone_filterbank(tuning=tuning, flayout=flayout)
        np.testing.assert_array_equal(rates, jrates)
        for g, w in zip(got, want):
            for a, b in zip(np.atleast_1d(g) if flayout == "sos" else g,
                            np.atleast_1d(w) if flayout == "sos" else w):
                np.testing.assert_array_equal(a, b)
