"""Spectral features: mel spectrogram, MFCC, chroma, tonnetz, centroid, bandwidth, contrast,
roll-off, flatness, polynomial fits, RMS and zero-crossing rate."""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from .. import filters
from .._device import as_tensor, device_table, exact_f32
from ..core.convert import fft_frequencies
from ..core.pitch import estimate_tuning
from ..core.spectrum import _audio, _spectrogram, _stft_mel_core, _win_device, power_to_db
from ..ops.framing import frame_signal
from ..ops.fused_stft import basis_bands
from ..ops.transforms import dct_matrix
from ..util.exceptions import ParameterError
from ..util.utils import _host, _torch_dtype, abs2, expand_to, normalize, pad_last

__all__ = ["melspectrogram", "mfcc", "chroma_stft", "chroma_cqt", "chroma_cens", "chroma_vqt",
           "spectral_centroid", "spectral_rolloff", "rms", "zero_crossing_rate",
           "spectral_bandwidth", "spectral_contrast", "spectral_flatness", "poly_features",
           "tonnetz"]


def _basis_device(make: Callable[..., np.ndarray], sr: float, n_fft: int,
                  device: torch.device, dtype: torch.dtype,
                  **kwargs: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """The filterbank ``make(sr=sr, n_fft=n_fft, **kwargs)`` and its band table, on ``device``.

    ``make`` is :func:`filters.mel` or :func:`filters.chroma`. Both tables
    are made on the host from the same array and uploaded once per
    configuration. The band table (each row's span of nonzero columns,
    :func:`basis_bands`) is what the stft_mel kernel walks.
    """
    key = (make.__name__, float(sr), int(n_fft), tuple(sorted(kwargs.items())))

    def basis() -> np.ndarray:
        return make(sr=sr, n_fft=n_fft, **kwargs)

    return (device_table(key, basis, device, dtype),
            device_table(("bands",) + key, lambda: basis_bands(basis()), device, torch.int32))


def _mel_device(sr: float, n_fft: int, device: torch.device, dtype: torch.dtype,
                **kwargs: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mel filterbank ``(n_mels, 1 + n_fft // 2)`` and its band table, on ``device``."""
    return _basis_device(filters.mel, sr, n_fft, device, dtype, **kwargs)


def melspectrogram(
    *,
    y: Any = None,
    sr: float = 22050,
    S: Any = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    power: float = 2.0,
    **kwargs: Any,
) -> torch.Tensor:
    """Mel spectrogram ``(..., n_mels, T)``: ``|STFT(y)|**power`` projected onto mel bands.

    From ``y`` ``(..., n)``, float32 input on the card runs as one CUDA
    kernel (pad, frame, window, FFT, ``|.|**power``, projection); other
    input runs the plain PyTorch version. From a power spectrogram ``S``
    ``(..., 1 + n_fft // 2, T)`` only the projection runs. ``window`` may
    be a name, a tuple, or the samples (``win_length`` of them, centre-padded
    to ``n_fft``). ``kwargs`` go to :func:`filters.mel` (``n_mels``,
    ``fmin``, ``fmax``, ``htk``, ``norm``).
    """
    if S is not None:
        S = as_tensor(S)
        if n_fft is None or n_fft // 2 + 1 != S.shape[-2]:
            n_fft = 2 * (S.shape[-2] - 1)
        basis, _ = _mel_device(sr, n_fft, S.device, S.dtype, **kwargs)
        with exact_f32():
            return torch.matmul(basis, S)
    if y is None:
        raise ParameterError("Input signal must be provided to compute a spectrogram")

    y = _audio(y)
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = int(win_length // 4)
    window_dev = _win_device(window, win_length, n_fft, y.device, y.dtype)
    basis, bands = _mel_device(sr, n_fft, y.device, y.dtype, **kwargs)
    return _stft_mel_core(y, window_dev, basis, bands, n_fft=n_fft, hop_length=hop_length,
                          center=center, pad_mode=pad_mode, power=float(power))


def mfcc(
    *,
    y: Any = None,
    sr: float = 22050,
    S: Any = None,
    n_mfcc: int = 20,
    dct_type: int = 2,
    norm: Optional[str] = "ortho",
    lifter: float = 0,
    mel_norm: Union[str, float, None] = "slaney",
    **kwargs: Any,
) -> torch.Tensor:
    """MFCCs ``(..., n_mfcc, T)``: a DCT over log-power mel bands, optionally liftered.

    ``S`` is a log-power mel spectrogram; without it the mel spectrogram of
    ``y`` is computed (``kwargs`` and ``mel_norm`` go to
    :func:`melspectrogram`) and converted with :func:`power_to_db`. The DCT
    (type ``dct_type``, ``norm`` ``'ortho'`` or None) is one float32 matrix
    product against a matrix made on the host and cached on the device.
    ``lifter > 0`` scales coefficient ``k`` by ``1 + lifter/2 * sin(pi*(k+1)/lifter)``.
    """
    if lifter < 0:
        raise ParameterError(f"MFCC lifter={lifter} must be a non-negative number")
    if S is None:
        S = power_to_db(melspectrogram(y=y, sr=sr, norm=mel_norm, **kwargs))
    else:
        S = as_tensor(S)
    n_mels = S.shape[-2]
    C = device_table(("dct", n_mels, dct_type, norm),
                     lambda: dct_matrix(n_mels, dct_type=dct_type, norm=norm),
                     S.device, S.dtype)[:n_mfcc]
    with exact_f32():
        M = torch.matmul(C, S)
    if lifter > 0:
        k = torch.arange(1, 1 + C.shape[0], dtype=M.dtype, device=M.device)
        LI = expand_to(torch.sin(np.pi * k / lifter), ndim=S.ndim, axes=-2)
        M = M * (1 + (lifter / 2) * LI)
    return M


def chroma_stft(
    *,
    y: Any = None,
    sr: float = 22050,
    S: Any = None,
    norm: Optional[float] = np.inf,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    tuning: Optional[float] = None,
    n_chroma: int = 12,
    **kwargs: Any,
) -> torch.Tensor:
    """Chromagram ``(..., n_chroma, T)``: ``|STFT|**2`` folded onto pitch classes, each frame
    scaled to unit ``norm``.

    ``tuning`` is the deviation from A440 in fractions of a chroma bin.
    Given it and ``y``, float32 input that the stft_mel kernel takes runs as
    that one kernel with the chroma filterbank as its basis, and other
    input as the kernel's plain version; then :func:`util.normalize` over
    axis -2. A power spectrogram ``S`` goes through one matrix product in
    full float32. With ``tuning=None`` the power spectrogram is computed
    once (or taken as given), :func:`core.pitch.estimate_tuning` estimates
    one tuning for the whole input from it with ``n_chroma`` bins per
    octave, and the same spectrogram is projected.
    ``kwargs`` go to :func:`filters.chroma` (``ctroct``, ``octwidth``,
    ``norm`` is taken by this function, ``base_c``).
    """
    if tuning is None:
        S, n_fft = _spectrogram(y=y, S=S, n_fft=n_fft, hop_length=hop_length, power=2,
                                win_length=win_length, window=window, center=center,
                                pad_mode=pad_mode)
        tuning = estimate_tuning(S=S, sr=sr, bins_per_octave=n_chroma)
    fb = dict(tuning=float(tuning), n_chroma=int(n_chroma), **kwargs)
    if S is None:
        if y is None:
            raise ParameterError("Input signal must be provided to compute a spectrogram")
        y = _audio(y)
        if win_length is None:
            win_length = n_fft
        if hop_length is None:
            hop_length = int(win_length // 4)
        window_dev = _win_device(window, win_length, n_fft, y.device, y.dtype)
        basis, bands = _basis_device(filters.chroma, sr, n_fft, y.device, y.dtype, **fb)
        raw = _stft_mel_core(y, window_dev, basis, bands, n_fft=n_fft, hop_length=hop_length,
                             center=center, pad_mode=pad_mode, power=2.0)
        return normalize(raw, norm=norm, axis=-2)
    S = as_tensor(S)
    if not S.dtype.is_floating_point:
        S = S.to(torch.float32)
    if n_fft is None or n_fft // 2 + 1 != S.shape[-2]:
        n_fft = 2 * (S.shape[-2] - 1)
    basis, _ = _basis_device(filters.chroma, sr, n_fft, S.device, S.dtype, **fb)
    return _project_norm_core(S, basis, norm=norm)


def _project_norm_core(X: torch.Tensor, basis: torch.Tensor, *, norm: Optional[float],
                       threshold: Optional[float] = None) -> torch.Tensor:
    """``basis @ X`` in full float32, values below ``threshold`` set to 0 (None: none), then each
    frame scaled to unit ``norm`` (None: as it is)."""
    with exact_f32():
        out = torch.matmul(basis, X)
    if threshold is not None:
        out = torch.where(out < threshold, 0.0, out)
    return normalize(out, norm=norm, axis=-2)


def _cq_chroma(C: torch.Tensor, *, bins_per_octave: int, n_chroma: int, fmin: float,
               window: Optional[np.ndarray], norm: Optional[float],
               threshold: Optional[float]) -> torch.Tensor:
    """Constant-Q bins ``C`` folded onto ``n_chroma`` pitch classes (:func:`filters.cq_to_chroma`)."""
    fold = filters.cq_to_chroma(C.shape[-2], bins_per_octave=bins_per_octave, n_chroma=n_chroma,
                                fmin=fmin, window=window)
    basis = torch.as_tensor(np.asarray(fold, dtype=np.float64), device=C.device,
                            dtype=C.dtype)
    return _project_norm_core(C, basis, norm=None if norm is None else float(norm),
                              threshold=None if threshold is None else float(threshold))


def _cq_kwargs(sr: float, hop_length: int, fmin: float, n_bins: int) -> dict:
    """The constant-Q settings of the chroma features: hann filters of unit L1 norm, scaled."""
    return dict(sr=sr, hop_length=hop_length, fmin=fmin, n_bins=n_bins, filter_scale=1, norm=1,
                sparsity=0.01, window="hann", scale=True, pad_mode="constant",
                res_type="soxr_hq", dtype=None)


def chroma_cqt(
    *,
    y: Any = None,
    sr: float = 22050,
    C: Any = None,
    hop_length: int = 512,
    fmin: Optional[float] = None,
    norm: Optional[float] = np.inf,
    threshold: float = 0.0,
    tuning: Optional[float] = None,
    n_chroma: int = 12,
    n_octaves: int = 7,
    window: Optional[np.ndarray] = None,
    bins_per_octave: int = 36,
    cqt_mode: str = "full",
) -> torch.Tensor:
    """Constant-Q chromagram ``(..., n_chroma, T)``: constant-Q magnitudes folded onto pitch classes.

    ``C`` is a constant-Q magnitude spectrogram with ``bins_per_octave``
    bins to the octave from ``fmin`` (default C1); without it one is
    computed from ``y`` over ``n_octaves`` octaves (``cqt_mode='full'``: the
    modulus of :func:`~librosa_tpu_torch.core.constantq.vqt` on the equal
    grid; ``'hybrid'``: :func:`~librosa_tpu_torch.core.constantq.hybrid_cqt`),
    at ``tuning`` (None: estimated from ``y``). Values below ``threshold``
    are zeroed, then each frame is scaled to unit ``norm``.
    """
    from ..core import constantq
    from ..core.convert import note_to_hz

    if bins_per_octave is None:
        bins_per_octave = n_chroma
    elif np.remainder(bins_per_octave, n_chroma) != 0:
        raise ParameterError(f"bins_per_octave={bins_per_octave} must be an integer multiple of "
                             f"n_chroma={n_chroma}")
    if fmin is None:
        fmin = note_to_hz("C1")
    if C is None:
        kw = _cq_kwargs(sr, hop_length, fmin, n_octaves * bins_per_octave)
        if cqt_mode == "full":
            C = constantq._vqt(y, magnitude=True, intervals="equal", gamma=0,
                               bins_per_octave=bins_per_octave, tuning=tuning, **kw)
        elif cqt_mode == "hybrid":
            C = constantq.hybrid_cqt(y, sr=sr, hop_length=hop_length, fmin=fmin,
                                     n_bins=n_octaves * bins_per_octave,
                                     bins_per_octave=bins_per_octave, tuning=tuning).abs()
        else:
            raise ParameterError(f"Invalid cqt_mode: {cqt_mode}")
    else:
        C = as_tensor(C)
    return _cq_chroma(C, bins_per_octave=bins_per_octave, n_chroma=n_chroma, fmin=fmin,
                      window=window, norm=norm, threshold=threshold)


def chroma_cens(
    *,
    y: Any = None,
    sr: float = 22050,
    C: Any = None,
    hop_length: int = 512,
    fmin: Optional[float] = None,
    tuning: Optional[float] = None,
    n_chroma: int = 12,
    n_octaves: int = 7,
    bins_per_octave: int = 36,
    cqt_mode: str = "full",
    window: Optional[np.ndarray] = None,
    norm: Optional[float] = 2,
    win_len_smooth: Optional[int] = 41,
    smoothing_window: Any = "hann",
) -> torch.Tensor:
    """Chroma energy normalised statistics ``(..., n_chroma, T)``.

    The :func:`chroma_cqt` of each frame scaled to unit L1 norm, counted in
    quarters by the thresholds 0.4, 0.2, 0.1 and 0.05, smoothed over
    ``win_len_smooth`` frames by ``smoothing_window`` (its ``win_len_smooth
    + 2``-point symmetric form with the zero ends, summing to 1; None: no
    smoothing), then scaled to unit ``norm``.
    """
    if win_len_smooth is not None and (not isinstance(win_len_smooth, (int, np.integer))
                                       or win_len_smooth <= 0):
        raise ParameterError(f"the CENS smoothing length must be a positive frame count or None; "
                             f"got {win_len_smooth!r}")
    chroma = chroma_cqt(y=y, C=C, sr=sr, hop_length=hop_length, fmin=fmin,
                        bins_per_octave=bins_per_octave, tuning=tuning, norm=None,
                        n_chroma=n_chroma, n_octaves=n_octaves, cqt_mode=cqt_mode, window=window)
    chroma = normalize(chroma, norm=1, axis=-2)
    counts = sum(((chroma > step).to(chroma.dtype) * 0.25 for step in (0.4, 0.2, 0.1, 0.05)),
                 torch.zeros_like(chroma))
    if win_len_smooth:
        win = np.asarray(filters.get_window(smoothing_window, win_len_smooth + 2, fftbins=False),
                         dtype=np.float32)
        taps = torch.as_tensor(win / np.sum(win), device=counts.device, dtype=counts.dtype)
        counts = _convolve_same(counts, taps)
    return normalize(counts, norm=None if norm is None else float(norm), axis=-2)


def _convolve_same(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """``numpy.convolve(row, taps, 'same')`` of every row of ``x`` along its last axis."""
    n = taps.shape[0]
    padded = pad_last(x, (n - 1) // 2, n - 1 - (n - 1) // 2)
    frames = padded.unfold(-1, n, 1)
    with exact_f32():
        return torch.matmul(frames, taps.flip(0))


def chroma_vqt(
    *,
    y: Any = None,
    sr: float = 22050,
    V: Any = None,
    hop_length: int = 512,
    fmin: Optional[float] = None,
    intervals: Any = None,
    norm: Optional[float] = np.inf,
    threshold: float = 0.0,
    n_octaves: int = 7,
    gamma: Optional[float] = 0,
    bins_per_octave: int = 12,
) -> torch.Tensor:
    """Variable-Q chromagram ``(..., bins_per_octave, T)``: variable-Q magnitudes folded onto one octave.

    ``V`` is a variable-Q magnitude spectrogram on the grid ``intervals``
    from ``fmin`` (default C1); without it one is computed from ``y`` over
    ``n_octaves`` octaves with bandwidth offset ``gamma`` (``intervals`` is
    then required). Each bin of an octave is its own class.
    """
    from ..core import constantq
    from ..core.convert import note_to_hz

    if fmin is None:
        fmin = note_to_hz("C1")
    if V is None:
        if intervals is None:
            raise ParameterError("intervals must be provided to compute VQT chroma")
        V = constantq._vqt(y, magnitude=True, intervals=intervals, gamma=gamma,
                           bins_per_octave=bins_per_octave, tuning=0.0,
                           **_cq_kwargs(sr, hop_length, fmin, n_octaves * bins_per_octave))
    else:
        V = as_tensor(V)
    return _cq_chroma(V, bins_per_octave=bins_per_octave, n_chroma=bins_per_octave, fmin=fmin,
                      window=None, norm=norm, threshold=threshold)


def _check_nonneg_real(S: torch.Tensor, name: str, *, computed: bool = False) -> None:
    """Reject complex and negative spectra.

    The test for negative values reads one flag back from the device, so it
    runs only on an ``S`` the caller gave (``computed=False``); a magnitude
    spectrogram computed here is non-negative by construction.
    """
    if S.is_complex():
        raise ParameterError(f"{name} is only defined with real-valued input")
    if not computed and bool((S < 0).any()):
        raise ParameterError(f"{name} is only defined with non-negative energies")


def _bin_frequencies(freq: Any, sr: float, n_fft: int, S: torch.Tensor) -> torch.Tensor:
    """``freq`` (default: the FFT bins' centre frequencies) on ``S``'s device, broadcastable.

    A 1-d ``freq`` is placed on axis -2; a full-rank one (frequencies that
    vary with time) is used as it is.
    """
    dtype = S.dtype if S.dtype.is_floating_point else torch.float32
    if freq is None:
        freq = device_table(("fft_frequencies", float(sr), int(n_fft)),
                            lambda: fft_frequencies(sr=sr, n_fft=n_fft), S.device, dtype)
    elif isinstance(freq, torch.Tensor):
        freq = freq.to(device=S.device, dtype=dtype)
    else:
        freq = torch.as_tensor(np.asarray(freq), dtype=dtype, device=S.device)
    return expand_to(freq, ndim=S.ndim, axes=-2) if freq.ndim == 1 else freq


def spectral_centroid(
    *,
    y: Any = None,
    sr: float = 22050,
    S: Any = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    freq: Any = None,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    pad_mode: str = "constant",
) -> torch.Tensor:
    """Spectral centroid ``(..., 1, T)`` in Hz: each frame's magnitude-weighted mean frequency.

    ``S`` is a magnitude spectrogram; without it ``|STFT(y)|`` is computed
    (by the stft_mel kernel with the identity basis where it applies).
    ``freq`` gives the bins' frequencies, 1-d or varying with time.
    """
    given = S is not None
    S, n_fft = _spectrogram(y=y, S=S, n_fft=n_fft, hop_length=hop_length,
                            win_length=win_length, window=window, center=center,
                            pad_mode=pad_mode)
    _check_nonneg_real(S, "Spectral centroid", computed=not given)
    return _centroid_core(S, _bin_frequencies(freq, sr, n_fft, S))


def _centroid_core(S: torch.Tensor, freq: torch.Tensor) -> torch.Tensor:
    return (freq * normalize(S, norm=1, axis=-2)).sum(dim=-2, keepdim=True)


def spectral_bandwidth(
    *,
    y: Any = None,
    sr: float = 22050,
    S: Any = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    freq: Any = None,
    centroid: Any = None,
    norm: bool = True,
    p: float = 2,
) -> torch.Tensor:
    """Spectral bandwidth ``(..., 1, T)``: ``(sum_k S[k] |freq[k] - centroid|**p)**(1/p)`` per frame.

    ``S`` is a magnitude spectrogram (without it ``|STFT(y)|``, by the
    stft_mel kernel with the identity basis where it applies), scaled to
    unit sum per frame where ``norm``. ``centroid`` defaults to
    :func:`spectral_centroid` of the same ``S``; ``freq`` is 1-d or varies
    with time.
    """
    given = S is not None
    S, n_fft = _spectrogram(y=y, S=S, n_fft=n_fft, hop_length=hop_length,
                            win_length=win_length, window=window, center=center,
                            pad_mode=pad_mode)
    _check_nonneg_real(S, "Spectral bandwidth", computed=not given)
    one_d = freq is None or np.ndim(freq) == 1
    freq = _bin_frequencies(freq, sr, n_fft, S)
    if centroid is None:
        centroid = _centroid_core(S, freq)
    centroid = as_tensor(centroid).to(device=S.device, dtype=freq.dtype)
    deviation = (freq - centroid[..., 0:1, :]).abs() if one_d else (freq - centroid).abs()
    if norm:
        S = normalize(S, norm=1, axis=-2)
    return (S * deviation ** float(p)).sum(dim=-2, keepdim=True) ** (1.0 / float(p))


def _contrast_bands(freq: np.ndarray, *, sr: float, fmin: float, n_bands: int,
                    quantile: float) -> list:
    """The octave bands of :func:`spectral_contrast` as ``(members, n_take)`` pairs, on the host.

    Band ``k`` holds the bins in ``[edges[k], edges[k + 1]]`` and annexes the
    one below it; the top band runs to Nyquist, every other drops its last
    member. ``n_take`` is counted before that drop.
    """
    edges = np.concatenate(([0.0], fmin * np.exp2(np.arange(n_bands + 1))))
    if (edges[:-1] >= 0.5 * sr).any():
        raise ParameterError(f"octave bands starting at fmin={fmin} with n_bands={n_bands} "
                             f"pass Nyquist ({sr / 2} Hz); lower one of them")
    bands = []
    for k in range(n_bands + 1):
        inside = (freq >= edges[k]) & (freq <= edges[k + 1])
        hits = np.flatnonzero(inside)
        if k > 0:
            inside[hits[0] - 1] = True
        if k == n_bands:
            inside[hits[-1] + 1:] = True
        members = np.flatnonzero(inside)
        if k < n_bands:
            members = members[:-1]
        bands.append((members, max(int(np.rint(quantile * int(inside.sum()))), 1)))
    return bands


def spectral_contrast(
    *,
    y: Any = None,
    sr: float = 22050,
    S: Any = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    freq: Any = None,
    fmin: float = 200.0,
    n_bands: int = 6,
    quantile: float = 0.02,
    linear: bool = False,
) -> torch.Tensor:
    """Octave-band spectral contrast ``(..., n_bands + 1, T)``.

    Each frame of the magnitude spectrogram is cut into octave bands from
    ``fmin`` (and one band below it); a band's peak and valley are the means
    of its top and bottom ``quantile`` of bins, by a sort on the device. The
    contrast is ``power_to_db(peak) - power_to_db(valley)`` (each clipped 80
    dB below its own peak per channel), or ``peak - valley`` where ``linear``.
    """
    S, n_fft = _spectrogram(y=y, S=S, n_fft=n_fft, hop_length=hop_length,
                            win_length=win_length, window=window, center=center,
                            pad_mode=pad_mode)
    freq = fft_frequencies(sr=sr, n_fft=n_fft) if freq is None else _host(freq)
    freq = np.atleast_1d(np.asarray(freq))
    if freq.ndim != 1 or len(freq) != S.shape[-2]:
        raise ParameterError(f"freq must be one center frequency per spectrogram row "
                             f"(({S.shape[-2]},)); got shape {freq.shape}")
    if not isinstance(n_bands, (int, np.integer)) or n_bands < 1:
        raise ParameterError(f"n_bands={n_bands!r} is not a positive integer")
    if not 0.0 < quantile < 1.0:
        raise ParameterError(f"the contrast quantile must be strictly inside (0, 1); got {quantile}")
    if fmin <= 0:
        raise ParameterError(f"fmin={fmin} must be above 0 Hz")
    valleys, peaks = [], []
    for members, n_take in _contrast_bands(freq, sr=sr, fmin=fmin, n_bands=int(n_bands),
                                           quantile=quantile):
        index = torch.as_tensor(members, device=S.device)
        ordered = torch.sort(S.index_select(-2, index), dim=-2).values
        valleys.append(ordered[..., :n_take, :].mean(dim=-2))
        peaks.append(ordered[..., -n_take:, :].mean(dim=-2))
    valley = torch.stack(valleys, dim=-2)
    peak = torch.stack(peaks, dim=-2)
    if linear:
        return peak - valley
    return power_to_db(peak) - power_to_db(valley)


def spectral_rolloff(
    *,
    y: Any = None,
    sr: float = 22050,
    S: Any = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    freq: Any = None,
    roll_percent: float = 0.85,
) -> torch.Tensor:
    """Roll-off frequency ``(..., 1, T)`` in Hz: the lowest bin at or below which lies
    ``roll_percent`` of the frame's magnitude.

    A frame of zeros gives the first bin's frequency.
    """
    if not 0.0 < roll_percent < 1.0:
        raise ParameterError("roll_percent must lie in the range (0, 1)")
    given = S is not None
    S, n_fft = _spectrogram(y=y, S=S, n_fft=n_fft, hop_length=hop_length,
                            win_length=win_length, window=window, center=center,
                            pad_mode=pad_mode)
    _check_nonneg_real(S, "Spectral rolloff", computed=not given)
    return _rolloff_core(S, _bin_frequencies(freq, sr, n_fft, S),
                         roll_percent=float(roll_percent))


def _rolloff_core(S: torch.Tensor, freq: torch.Tensor, *, roll_percent: float) -> torch.Tensor:
    total = S.cumsum(dim=-2)
    threshold = roll_percent * total[..., -1:, :]
    # bins below the threshold drop out of the minimum; the last bin never does
    inf = torch.full((), float("inf"), dtype=freq.dtype, device=freq.device)
    return torch.where(total < threshold, inf, freq).amin(dim=-2, keepdim=True)


def spectral_flatness(
    *,
    y: Any = None,
    S: Any = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    amin: float = 1e-10,
    power: float = 2.0,
) -> torch.Tensor:
    """Spectral flatness ``(..., 1, T)``: the geometric over the arithmetic mean of ``S**power``.

    ``S`` is a magnitude spectrogram (without it ``|STFT(y)|``); values
    below ``amin`` count as ``amin``.
    """
    if amin <= 0:
        raise ParameterError("amin must be strictly positive")
    given = S is not None
    S, n_fft = _spectrogram(y=y, S=S, n_fft=n_fft, hop_length=hop_length, power=1.0,
                            win_length=win_length, window=window, center=center,
                            pad_mode=pad_mode)
    _check_nonneg_real(S, "Spectral flatness", computed=not given)
    S_thresh = torch.clamp(S ** float(power), min=float(amin))
    gmean = torch.exp(torch.log(S_thresh).mean(dim=-2, keepdim=True))
    return gmean / S_thresh.mean(dim=-2, keepdim=True)


def poly_features(
    *,
    y: Any = None,
    sr: float = 22050,
    S: Any = None,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: Optional[int] = None,
    window: Any = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    order: int = 1,
    freq: Any = None,
) -> torch.Tensor:
    """Coefficients ``(..., order + 1, T)`` of a polynomial fit to each frame, highest degree first.

    With 1-d ``freq`` (default: the bins' frequencies) the fit is one
    product with the Vandermonde matrix's pseudo-inverse, made on the host
    in float64. With ``freq`` that varies by frame, each frame is a
    least-squares fit of its own: a batched SVD on the device, singular
    values below ``eps * max(f, order + 1)`` of the largest dropped, as
    ``jnp.linalg.lstsq`` drops them.
    """
    S, n_fft = _spectrogram(y=y, S=S, n_fft=n_fft, hop_length=hop_length,
                            win_length=win_length, window=window, center=center,
                            pad_mode=pad_mode)
    if freq is None:
        freq = fft_frequencies(sr=sr, n_fft=n_fft)
    if isinstance(freq, torch.Tensor) and freq.ndim > 1:
        freq = freq.to(device=S.device, dtype=S.dtype)
    else:
        freq = _host(freq)
    if freq.ndim == 1:
        pinv = np.linalg.pinv(np.vander(freq, order + 1))
        with exact_f32():
            return torch.matmul(torch.as_tensor(pinv, dtype=S.dtype, device=S.device), S)
    freq = torch.as_tensor(freq, dtype=S.dtype, device=S.device)
    flatS, flatF = S.transpose(-2, -1), freq.transpose(-2, -1)  # (..., T, f)
    bshape = torch.broadcast_shapes(flatS.shape[:-1], flatF.shape[:-1])
    flatS = flatS.broadcast_to(bshape + flatS.shape[-1:]).reshape(-1, flatS.shape[-1], 1)
    flatF = flatF.broadcast_to(bshape + flatF.shape[-1:]).reshape(-1, flatF.shape[-1])
    powers = torch.arange(order, -1, -1, dtype=S.dtype, device=S.device)
    V = flatF[..., None] ** powers  # decreasing powers, as np.vander
    U, sv, Vh = torch.linalg.svd(V, full_matrices=False)
    rcond = float(torch.finfo(S.dtype).eps) * max(V.shape[-2:])
    keep = (sv > 0) & (sv >= rcond * sv[..., :1])
    s_inv = torch.where(keep, 1 / torch.where(keep, sv, torch.ones_like(sv)), 0.0)
    with exact_f32():
        sol = Vh.transpose(-2, -1) @ (s_inv[..., None] * (U.transpose(-2, -1) @ flatS))
    return sol[..., 0].reshape(*bshape, order + 1).transpose(-2, -1)


def tonnetz(*, y: Any = None, sr: float = 22050, chroma: Any = None, **kwargs: Any) -> torch.Tensor:
    """Tonal centroids ``(..., 6, T)``: each frame's chroma (scaled to unit sum) projected onto the
    circles of fifths, minor thirds and major thirds (the last at half radius).

    Without ``chroma`` it is :func:`chroma_cqt` of ``y`` (``kwargs`` go there).
    """
    if y is None and chroma is None:
        raise ParameterError("tonnetz needs either a signal (y=) or a chromagram (chroma=)")
    chroma = chroma_cqt(y=y, sr=sr, **kwargs) if chroma is None else as_tensor(chroma)
    angle = np.pi * np.linspace(0, 12, num=chroma.shape[-2], endpoint=False)
    rows = []
    for ratio, radius in ((7.0 / 6, 1.0), (3.0 / 2, 1.0), (2.0 / 3, 0.5)):
        rows.append(radius * np.sin(ratio * angle))
        rows.append(radius * np.cos(ratio * angle))
    phi = torch.as_tensor(np.stack(rows), dtype=chroma.dtype, device=chroma.device)
    with exact_f32():
        return torch.matmul(phi, normalize(chroma, norm=1, axis=-2))


def rms(
    *,
    y: Any = None,
    S: Any = None,
    frame_length: int = 2048,
    hop_length: int = 512,
    center: bool = True,
    pad_mode: str = "constant",
    dtype: Any = torch.float32,
) -> torch.Tensor:
    """Root-mean-square energy ``(..., 1, T)`` of each frame.

    From ``y``: the mean of the squared samples of each frame (padded by
    ``frame_length // 2`` a side where ``center``). From a magnitude
    spectrogram ``S``: by Parseval's theorem over the one-sided spectrum,
    with the DC bin (and the Nyquist bin of an even ``frame_length``)
    counted once. ``dtype`` (a torch or numpy real dtype) is the type the
    squares are taken in.
    """
    dtype = _torch_dtype(dtype)
    if y is not None:
        y = as_tensor(y)
        if center:
            y = pad_last(y, frame_length // 2, frame_length // 2, mode=pad_mode)
        frames = frame_signal(y, frame_length=int(frame_length), hop_length=int(hop_length))
        power = abs2(frames, dtype).mean(dim=-1).unsqueeze(-2)
        return power.sqrt()
    if S is None:
        raise ParameterError("Either `y` or `S` must be input.")
    S = as_tensor(S)
    if S.shape[-2] != frame_length // 2 + 1:
        raise ParameterError(
            f"Since S.shape[-2] is {S.shape[-2]}, frame_length is expected to be "
            f"{S.shape[-2] * 2 - 2} or {S.shape[-2] * 2 - 1}; found {frame_length}"
        )
    x = abs2(S, dtype)
    scale = torch.ones(x.shape[-2], dtype=torch.float32, device=x.device)
    scale[0] = 0.5
    if frame_length % 2 == 0:
        scale[-1] = 0.5
    x = x * expand_to(scale, ndim=x.ndim, axes=-2)
    return (2 * x.sum(dim=-2, keepdim=True) / frame_length**2).sqrt()



def zero_crossing_rate(y: Any, *, frame_length: int = 2048, hop_length: int = 512,
                       center: bool = True, **kwargs: Any) -> torch.Tensor:
    """The share of samples of each frame where the sign changes, ``(..., 1, T)`` float32.

    Frames are padded by ``frame_length // 2`` edge samples a side where
    ``center``. ``kwargs`` go to ``zero_crossings`` (``threshold``,
    ``ref_magnitude``, ``zero_pos``; ``pad`` defaults to False), which runs
    along each frame.
    """
    from ..core.audio import zero_crossings

    kwargs["axis"] = -1
    kwargs.setdefault("pad", False)
    y = as_tensor(y)
    if center:
        y = pad_last(y, int(frame_length // 2), int(frame_length // 2), mode="edge")
    frames = frame_signal(y, frame_length=int(frame_length), hop_length=int(hop_length))
    crossings = zero_crossings(frames, **kwargs)  # (..., T, frame_length)
    # the count times the float32 reciprocal of the length, as the JAX package's mean rounds
    inv = torch.tensor(1.0 / frames.shape[-1], dtype=torch.float32, device=frames.device)
    return (crossings.sum(dim=-1, dtype=torch.float32) * inv).unsqueeze(-2)
