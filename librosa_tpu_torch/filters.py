"""Filterbanks and windows, built on the host in float64 numpy.

A filterbank is made once per configuration and cached here as numpy;
``core.spectrum`` keeps one device copy of it per card. Only the
products that use it run on the card.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, Optional, Tuple, Union

import numpy as np
import scipy.signal
import torch

from .core.convert import fft_frequencies, hz_to_midi, mel_frequencies, midi_to_hz
from ._cache import cache
from .util.exceptions import ParameterError

__all__ = ["mel", "chroma", "get_window", "window_sumsquare", "cq_to_chroma",
           "diagonal_filter", "window_bandwidth", "wavelet_lengths", "wavelet",
           "WINDOW_BANDWIDTHS", "mr_frequencies", "semitone_filterbank"]


def get_window(window: Any, Nx: int, *, fftbins: bool = True) -> np.ndarray:
    """A window of length ``Nx`` as a host array.

    ``window`` is a name (``'hann'``), a name with parameters
    (``('kaiser', 4.0)``), a scalar (Kaiser beta), a callable taking the
    length, or the samples themselves (numpy, list or tensor), which must
    have length ``Nx``. ``fftbins`` selects the periodic form.
    """
    if isinstance(window, torch.Tensor):
        window = window.detach().cpu().numpy()
    if isinstance(window, (list, np.ndarray)):
        win = np.asarray(window)
        if win.shape[0] != Nx:
            raise ParameterError(f"Window size mismatch: {win.shape[0]:d} != {Nx:d}")
        return win
    if callable(window):
        return window(Nx)
    if not (isinstance(window, (str, tuple)) or np.isscalar(window)):
        raise ParameterError(f"Invalid window specification: {window!r}")
    return np.asarray(scipy.signal.get_window(window, Nx, fftbins=fftbins))


def _normalize_rows(w: np.ndarray, norm: Any) -> np.ndarray:
    """Scale each row of ``w`` to unit ``norm``; rows of (near) zero norm stay."""
    mag = np.abs(w)
    if norm == np.inf:
        length = mag.max(axis=-1, keepdims=True)
    elif norm == -np.inf:
        length = mag.min(axis=-1, keepdims=True)
    elif norm == 0:
        length = (mag > 0).sum(axis=-1, keepdims=True).astype(np.float64)
    elif np.issubdtype(type(norm), np.number) and norm > 0:
        length = (mag**norm).sum(axis=-1, keepdims=True) ** (1.0 / norm)
    else:
        raise ParameterError(f"Unsupported norm: {norm!r}")
    length[length < np.finfo(np.float64).tiny] = 1.0
    return w / length


@functools.lru_cache(maxsize=64)
def _mel_basis(sr: float, n_fft: int, n_mels: int, fmin: float, fmax: float,
               htk: bool, norm: Any, dtype: str) -> np.ndarray:
    # Band i is a triangle on the Hz axis with corners at the mel-spaced
    # frequencies edges[i] < edges[i + 1] < edges[i + 2]: it rises linearly
    # from 0 at the first corner to 1 at the middle one, then falls back to
    # 0 at the last. Each FFT bin takes the triangle's height at its centre.
    freqs = fft_frequencies(sr=sr, n_fft=n_fft)[None, :]
    edges = mel_frequencies(n_mels + 2, fmin=fmin, fmax=fmax, htk=htk)
    left, mid, right = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    rising = (freqs - left) / (mid - left)
    falling = (right - freqs) / (right - mid)
    weights = np.maximum(0.0, np.minimum(rising, falling))

    if norm == "slaney":
        # divide each triangle by half its width in Hz: equal area per band
        weights = weights * (2.0 / (right - left))
    elif isinstance(norm, str):
        raise ParameterError(f"Unsupported norm={norm}")
    elif norm is not None:
        weights = _normalize_rows(weights, norm)

    if not np.all((edges[:-2] == 0) | (weights.max(axis=1) > 0)):
        warnings.warn(
            "Empty filters detected in mel frequency basis. Some channels will "
            "produce empty responses. Try increasing your sampling rate (and "
            "fmax) or reducing n_mels.",
            stacklevel=3,
        )
    out = weights.astype(np.dtype(dtype))
    out.setflags(write=False)
    return out


@cache(level=10)
def mel(
    *,
    sr: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm: Union[str, float, None] = "slaney",
    dtype: Any = np.float32,
) -> np.ndarray:
    """Mel filterbank of shape ``(n_mels, 1 + n_fft // 2)``.

    Row ``i`` is a triangular band on ``n_mels + 2`` frequencies spaced
    evenly in mels between ``fmin`` and ``fmax`` (default ``sr / 2``).
    ``norm='slaney'`` gives each band equal area; a number scales each row
    to unit norm of that order; ``None`` leaves peaks at 1. The result is
    cached and read-only.
    """
    if fmax is None:
        fmax = float(sr) / 2
    return _mel_basis(float(sr), int(n_fft), int(n_mels), float(fmin), float(fmax),
                      bool(htk), norm, np.dtype(dtype).str)


@functools.lru_cache(maxsize=64)
def _chroma_basis(sr: float, n_fft: int, n_chroma: int, tuning: float, ctroct: float,
                  octwidth: Optional[float], norm: Any, base_c: bool,
                  dtype: str) -> np.ndarray:
    # Every FFT bin gets a position on a pitch axis counted in chroma steps:
    # n_chroma steps per octave above a sixteenth of the (tuned) A440. Bin 0
    # has no logarithm and is put an octave and a half below bin 1. One bin
    # beyond the last column kept is placed too, so that every column has a
    # right-hand neighbour.
    n_bins = 1 + n_fft // 2
    a440 = 440.0 * 2.0 ** (tuning / n_chroma)
    k = np.arange(1, n_bins + 1, dtype=np.float64)
    pos = n_chroma * np.log2(k * sr / n_fft / (a440 / 16.0))
    pos = np.concatenate(([pos[0] - 1.5 * n_chroma], pos))
    # a bin is as wide as the step to the next one, and never narrower than one chroma
    width = np.maximum(np.diff(pos), 1.0)
    pos = pos[:n_bins]

    # distance from each bin to each chroma class around the circle, in
    # [-half, n_chroma - half), then a Gaussian whose sigma is half the bin's width
    half = np.round(n_chroma / 2.0)
    dist = pos[None, :] - np.arange(n_chroma, dtype=np.float64)[:, None]
    dist = np.mod(dist + half, n_chroma) - half
    weights = np.exp(-0.5 * (2.0 * dist / width[None, :]) ** 2)

    if norm is not None:
        weights = _normalize_rows(weights.T, norm).T  # each column to unit norm
    if octwidth is not None:
        # bins far from octave ``ctroct`` (counted from A440 / 16) weigh less
        weights = weights * np.exp(-0.5 * ((pos / n_chroma - ctroct) / octwidth) ** 2)[None, :]
    if base_c:
        # class 0 is A: bring C (three semitones up) to row 0
        weights = np.roll(weights, -3 * (n_chroma // 12), axis=0)
    out = np.ascontiguousarray(weights.astype(np.dtype(dtype)))
    out.setflags(write=False)
    return out


@cache(level=10)
def chroma(
    *,
    sr: float,
    n_fft: int,
    n_chroma: int = 12,
    tuning: float = 0.0,
    ctroct: float = 5.0,
    octwidth: Optional[float] = 2,
    norm: Optional[float] = 2,
    base_c: bool = True,
    dtype: Any = np.float32,
) -> np.ndarray:
    """Chroma filterbank of shape ``(n_chroma, 1 + n_fft // 2)``.

    Column ``k`` spreads FFT bin ``k`` over the pitch classes by a Gaussian
    of its wrapped distance to each class, normalised to unit ``norm`` and
    weighted by a Gaussian over octaves centred ``ctroct`` octaves above
    A440 / 16 with width ``octwidth`` (None: no octave weighting).
    ``tuning`` shifts A440 by that fraction of a chroma bin; ``base_c``
    puts C in row 0 (else A). The result is cached and read-only.
    """
    return _chroma_basis(float(sr), int(n_fft), int(n_chroma), float(tuning), float(ctroct),
                         None if octwidth is None else float(octwidth), norm, bool(base_c),
                         np.dtype(dtype).str)


@cache(level=10)
def window_sumsquare(
    *,
    window: Any,
    n_frames: int,
    hop_length: int = 512,
    win_length: Optional[int] = None,
    n_fft: int = 2048,
    dtype: Any = np.float32,
    norm: Optional[float] = None,
) -> np.ndarray:
    """Sum of the squared windows of ``n_frames`` overlapping frames, as a host array.

    ``wss[n] = sum_t w[n - t * hop_length]**2`` over ``n_fft + hop_length *
    (n_frames - 1)`` samples, the envelope that an inverse STFT divides by.
    ``window`` has ``win_length`` samples (default ``n_fft``), is scaled to
    unit ``norm`` first (None: as it is) and centre-padded to ``n_fft``.

    Summed in float64 as ``ceil(n_fft / hop_length)`` shifted adds of one
    squared window over rows of ``hop_length`` samples, each sample taking
    its frames in rising order: the cost is that of the output, whatever the
    number of frames.
    """
    if win_length is None:
        win_length = n_fft
    n = n_fft + hop_length * (n_frames - 1)
    win_sq = np.asarray(get_window(window, win_length), dtype=np.float64)
    if norm is not None:
        win_sq = _normalize_rows(win_sq[None, :], norm)[0]
    win_sq = win_sq**2
    lpad = (n_fft - win_length) // 2
    n_shifts = -(-n_fft // hop_length)
    # chunk j of the padded window, hop_length samples wide, lands in row t + j of frame t
    chunks = np.zeros(n_shifts * hop_length)
    chunks[lpad:lpad + win_length] = win_sq
    chunks = chunks.reshape(n_shifts, hop_length)
    rows = np.zeros((n_frames + n_shifts - 1, hop_length))
    for j in reversed(range(n_shifts)):
        rows[j:j + n_frames] += chunks[j]
    return rows.reshape(-1)[:n].astype(dtype)


@cache(level=10)
def cq_to_chroma(
    n_input: int,
    *,
    bins_per_octave: int = 12,
    n_chroma: int = 12,
    fmin: Optional[float] = None,
    window: Optional[np.ndarray] = None,
    base_c: bool = True,
    dtype: Any = np.float32,
) -> np.ndarray:
    """Map from ``n_input`` constant-Q bins onto ``n_chroma`` pitch classes: ``(n_chroma, n_input)``.

    Every ``bins_per_octave / n_chroma`` neighbouring bins (the group
    centred on a class) merge into that class; the rows are rolled so that
    row 0 is C (A without ``base_c``) given that bin 0 lies at ``fmin``
    (default C1). ``window`` smooths each row across bins.
    """
    if bins_per_octave % n_chroma:
        raise ParameterError(
            f"cannot merge {bins_per_octave} CQ bins/octave into "
            f"{n_chroma} chroma classes: not an integer ratio"
        )
    merge = bins_per_octave // n_chroma
    anchor = midi_to_hz(24) if fmin is None else fmin  # MIDI 24 is C1
    tonic_class = np.mod(hz_to_midi(anchor), 12)
    if not base_c:
        tonic_class -= 9
    rotation = int(np.round(tonic_class * n_chroma / 12.0))

    cols = np.arange(n_input)
    in_octave = (cols % bins_per_octave + merge // 2) % bins_per_octave
    rows = (in_octave // merge + rotation) % n_chroma
    proj = np.zeros((n_chroma, n_input), dtype=dtype)
    proj[rows, cols] = 1
    if window is not None:
        proj = np.stack([np.convolve(row, window, mode="same") for row in proj]).astype(dtype)
    return proj


@cache(level=10)
def diagonal_filter(window: Any, n: int, *, slope: float = 1.0,
                    angle: Optional[float] = None, zero_mean: bool = False) -> np.ndarray:
    """An ``(n, n)`` smoothing kernel: ``window`` laid along a line of the given slope.

    The window goes on the main diagonal and the plane is rotated by a
    quintic spline to ``angle`` radians (default ``arctan(slope)``); negative
    ringing is clipped, and the kernel sums to 1 (to 0 with ``zero_mean``).
    """
    theta = np.arctan(slope) if angle is None else angle
    stencil = np.diag(get_window(window, n, fftbins=False))
    if not np.isclose(theta, np.pi / 4):
        from scipy.ndimage import rotate

        stencil = rotate(stencil, 45.0 - np.degrees(theta), order=5, prefilter=False)
        stencil = np.where(stencil > 0, stencil, 0.0)
    stencil /= stencil.sum()
    if zero_mean:
        stencil -= stencil.mean()
    return stencil


# Equivalent noise bandwidth in FFT bins, n * sum(w**2) / sum(w)**2, of the named
# windows (scipy's names and aliases), as the constant-Q filters are sized with it.
_ENBW = {
    ("bart", "bartlett", "brt"): 1.3334961334912805,
    ("barthann", "brthan", "bth"): 1.4560255965133932,
    ("bkh", "blackharr", "blackmanharris"): 2.0045975283585014,
    ("black", "blackman", "blk"): 1.7269681554262326,
    ("bman", "bmn", "bohman"): 1.7859588613860062,
    ("box", "boxcar", "ones", "rect", "rectangular"): 1.0,
    ("cosine", "halfcosine"): 1.2337005350199792,
    ("flat", "flattop", "flt"): 2.7762255046484143,
    ("ham", "hamm", "hamming"): 1.3629455320350348,
    ("han", "hann"): 1.50018310546875,
    ("nut", "nutl", "nuttall"): 1.9763500280946082,
    ("par", "parz", "parzen"): 1.9174603174603191,
    ("tri", "triang", "triangle"): 1.3331706523555851,
}
WINDOW_BANDWIDTHS: dict = {name: bw for names, bw in _ENBW.items() for name in names}


def window_bandwidth(window: Any, n: int = 1000) -> float:
    """Equivalent noise bandwidth of ``window``, in FFT bins.

    Named windows come from :data:`WINDOW_BANDWIDTHS`; any other (a tuple,
    a callable) is measured once as ``n * sum(w**2) / sum(w)**2`` on ``n``
    samples and remembered under its name.
    """
    key = getattr(window, "__name__", window)
    if key not in WINDOW_BANDWIDTHS:
        win = get_window(window, n)
        WINDOW_BANDWIDTHS[key] = n * np.sum(win**2) / (np.sum(win) ** 2 + np.finfo(win.dtype).tiny)
    return WINDOW_BANDWIDTHS[key]


def _relative_bandwidth(*, freqs: np.ndarray) -> np.ndarray:
    """Each bin's relative bandwidth ``(r - 1) / (r + 1)``, ``r`` the frequency ratio of its neighbours.

    At the two ends the one neighbour's ratio counts twice.
    """
    if len(freqs) <= 1:
        raise ParameterError(
            f"2 or more frequencies are required to compute bandwidths. Given freqs={freqs}")
    ratio = np.exp2(2.0 * np.gradient(np.log2(freqs)))
    return (ratio - 1) / (ratio + 1)


@cache(level=10)
def wavelet_lengths(*, freqs: Any, sr: float = 22050, window: Any = "hann",
                    filter_scale: float = 1, gamma: Optional[float] = 0,
                    alpha: Any = None) -> Tuple[np.ndarray, float]:
    """``(lengths, f_cutoff)``: each wavelet's length in samples and the top of the highest band.

    Filter ``k`` has the bandwidth ``alpha[k] * freqs[k] + gamma`` Hz
    (``alpha`` defaults to :func:`_relative_bandwidth`; ``gamma=None`` takes
    the ERB-like ``24.7 / 0.108 * alpha``) and so ``filter_scale * sr`` over
    that many samples. ``f_cutoff`` is the highest ``freqs + half`` a
    window's main lobe.
    """
    freqs = np.asarray(freqs)
    if filter_scale <= 0:
        raise ParameterError(f"filter_scale must be a positive number; got {filter_scale}")
    if gamma is not None and gamma < 0:
        raise ParameterError(f"a negative gamma ({gamma}) is not meaningful")
    if freqs.min(initial=np.inf) <= 0:
        raise ParameterError("wavelet center frequencies must be > 0")
    if np.any(np.diff(freqs) < 0):
        raise ParameterError(f"wavelet center frequencies must be sorted ascending; got {freqs}")
    alpha = _relative_bandwidth(freqs=freqs) if alpha is None else np.asarray(alpha)
    offset = alpha * (24.7 / 0.108) if gamma is None else gamma
    scale = float(filter_scale)
    lobe = 0.5 * (freqs * (window_bandwidth(window) * alpha / scale) + offset)
    return scale * sr / (alpha * freqs + offset), float(np.max(freqs + lobe))


def _fractional_window(window: Any, length: float) -> np.ndarray:
    """``window`` over ``floor(length)`` samples, zero-padded to ``ceil(length)``."""
    whole = int(np.floor(length))
    win = np.asarray(get_window(window, whole), dtype=np.float64)
    return np.pad(win, (0, int(np.ceil(length)) - whole))


@cache(level=10)
def wavelet(*, freqs: Any, sr: float = 22050, window: Any = "hann", filter_scale: float = 1,
            pad_fft: bool = True, norm: Optional[float] = 1, dtype: Any = np.complex64,
            gamma: float = 0, alpha: Any = None, **kwargs: Any) -> Tuple[np.ndarray, np.ndarray]:
    """``(basis, lengths)``: one windowed complex sinusoid per frequency, centred in a common width.

    Row ``k`` is ``exp(2 pi i freqs[k] t / sr)`` on ``t`` from
    ``-lengths[k] // 2`` up to ``lengths[k] // 2`` (:func:`wavelet_lengths`),
    under ``window``, scaled to unit ``norm``, and centred (``kwargs`` go to
    ``numpy.pad``) in the longest length, rounded up to a power of two with
    ``pad_fft``.
    """
    freqs = np.asarray(freqs)
    lengths, _ = wavelet_lengths(freqs=freqs, sr=sr, window=window, filter_scale=filter_scale,
                                 gamma=gamma, alpha=alpha)
    width = float(np.max(lengths))
    width = int(2.0 ** np.ceil(np.log2(width))) if pad_fft else int(np.ceil(width))
    rows = []
    for length, freq in zip(lengths, freqs):
        t = np.arange(-length // 2, length // 2, dtype=float)
        atom = np.exp(1j * (2 * np.pi * freq / sr) * t) * _fractional_window(window, len(t))
        if norm is not None:
            atom = _normalize_rows(atom[None, :], norm)[0]
        lpad = (width - len(atom)) // 2
        rows.append(np.pad(atom, (lpad, width - len(atom) - lpad), **{"mode": "constant", **kwargs}))
    return np.asarray(rows, dtype=dtype), lengths


# ---------------------------------------------------------------------------
# multirate semitone filterbank (for iirt)
# ---------------------------------------------------------------------------


def _multirate_fb(center_freqs: Optional[np.ndarray] = None,
                  sample_rates: Optional[np.ndarray] = None, Q: float = 25.0,
                  passband_ripple: float = 1, stopband_attenuation: float = 50,
                  ftype: str = "ellip", flayout: str = "sos") -> Tuple[list, np.ndarray]:
    """One band-pass IIR filter per centre frequency, designed at its own sample rate.

    Each passband spans ``fc +- fc / (2 Q)``, its stopband twice as wide;
    ``scipy.signal.iirdesign`` designs it in ``flayout``.
    """
    if center_freqs is None or sample_rates is None:
        raise ParameterError("the multirate bank needs both center_freqs and sample_rates")
    if center_freqs.shape != sample_rates.shape:
        raise ParameterError(f"one sample rate per center frequency: got {center_freqs.shape} "
                             f"centers vs {sample_rates.shape} rates")
    half_bw = center_freqs / (2.0 * float(Q))
    bank = [scipy.signal.iirdesign(np.array([fc - hb, fc + hb]) / ny,
                                   np.array([fc - 2 * hb, fc + 2 * hb]) / ny,
                                   passband_ripple, stopband_attenuation, analog=False,
                                   ftype=ftype, output=flayout)
            for fc, ny, hb in zip(center_freqs, 0.5 * sample_rates, half_bw)]
    return bank, sample_rates


def mr_frequencies(tuning: float) -> Tuple[np.ndarray, np.ndarray]:
    """Centre frequencies and sample rates of the semitone filterbank: MIDI 24-59 at 882 Hz,
    60-93 at 4410 Hz and 94-108 at 22050 Hz, each shifted by ``tuning`` semitones."""
    center_freqs = midi_to_hz(np.arange(24 + tuning, 109 + tuning))
    sample_rates = np.asarray(36 * [882.0] + 34 * [4410.0] + 15 * [22050.0])
    return center_freqs, sample_rates


@cache(level=10)
def semitone_filterbank(*, center_freqs: Optional[np.ndarray] = None, tuning: float = 0.0,
                        sample_rates: Optional[np.ndarray] = None, flayout: str = "ba",
                        **kwargs: Any) -> Tuple[list, np.ndarray]:
    """The multirate semitone filterbank: a list of filters (``'ba'`` or ``'sos'``) and the sample
    rate of each.

    Without ``center_freqs`` and ``sample_rates``, the 85 bands of
    :func:`mr_frequencies` at ``tuning``. ``kwargs`` go to the designer
    (``Q``, ``passband_ripple``, ``stopband_attenuation``, ``ftype``).
    """
    if center_freqs is None and sample_rates is None:
        center_freqs, sample_rates = mr_frequencies(tuning)
    return _multirate_fb(center_freqs=center_freqs, sample_rates=sample_rates, flayout=flayout,
                         **kwargs)
