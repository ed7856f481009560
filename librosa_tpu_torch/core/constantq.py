"""Constant-Q and variable-Q transforms, their inverse and Griffin-Lim over them.

The forward transform runs the octave ladder: the top octave's filters on
the signal at its own rate, then each lower octave on the signal resampled
to half the rate (where the hop still halves and the octave lies well below
the new Nyquist frequency), so that every octave's filters are short. One
octave is an STFT with a rectangular window (``_stft_core``, ``torch.fft``)
and one complex matrix product in full float32 against that octave's
filters in the frequency domain. The plan (rate, hop and ``n_fft`` of each
rung) is fixed by the configuration; the filters are made on the host in
float64 once per configuration and kept on the device in the working type.

``pseudo_cqt`` is one magnitude STFT at the widest filter's size projected
onto ``|filters|``: the stft_mel kernel's function at power 1, so it goes
through ``core.spectrum._stft_mel_core`` and its ``kernel_refusal``.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, Collection, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import filters
from .._device import as_tensor, device_table, exact_f32
from ..ops.fused_stft import basis_bands
from ..util.exceptions import ParameterError
from ..util.utils import _sparsify_dense, _torch_dtype, dtype_r2c, expand_to, fix_length, tiny
from . import audio
from .convert import cqt_frequencies, note_to_hz
from .intervals import interval_frequencies
from .pitch import estimate_tuning
from .spectrum import (_audio, _griffinlim_init, _griffinlim_seed, _stft_core, _stft_mel_core,
                       _win_device, istft)

__all__ = ["cqt", "vqt", "hybrid_cqt", "pseudo_cqt", "icqt", "griffinlim_cqt"]


def _equal_bandwidth(bins_per_octave: int) -> np.ndarray:
    """Relative bandwidth ``(r**2 - 1) / (r**2 + 1)`` of ``bins_per_octave`` equal steps ``r``."""
    r2 = 2 ** (2 / bins_per_octave)
    return np.atleast_1d((r2 - 1) / (r2 + 1))


def _below_nyquist(freqs: np.ndarray, window: Any, filter_scale: float, gamma: Optional[float],
                   sr: float) -> np.ndarray:
    """The lowest ``freqs`` whose filters' bands (and every lower bin's) end below ``sr / 2``.

    A bin's band is its frequency plus half the window's main lobe at its
    Q, plus half the bandwidth offset (``gamma``, or the ERB-like one for
    None); the first bin takes its neighbour's spacing.
    """
    step = np.diff(np.log2(freqs))
    ratio = np.exp2(2 * np.concatenate((step[:1], step)))
    alpha = (ratio - 1) / (ratio + 1)
    offset = alpha * (24.7 / 0.108) if gamma is None else gamma
    q = float(filter_scale) / alpha
    top = np.maximum.accumulate(
        freqs * (1 + 0.5 * filters.window_bandwidth(window) / q) + 0.5 * offset)
    keep = int(np.searchsorted(top, sr / 2.0, side="left"))
    if keep == 0:
        raise ParameterError(
            f"no wavelet fits under Nyquist: even the lowest bin ({freqs[0]:.2f} Hz) has "
            f"support beyond sr/2 = {sr / 2:.2f} Hz"
        )
    return freqs[:keep]


def _twos(x: int) -> int:
    """How many times 2 divides ``x`` (0 for ``x <= 0``)."""
    count = 0
    while x > 0 and x % 2 == 0:
        x //= 2
        count += 1
    return count


def _hashable(window: Any) -> bool:
    return isinstance(window, (str, tuple)) or np.isscalar(window)


def _filters_fft_host(sr: float, freqs: np.ndarray, filter_scale: float, norm: Optional[float],
                      sparsity: float, hop_length: Optional[int], window: Any,
                      gamma: Optional[float], alpha: Optional[np.ndarray]) -> tuple:
    """``(filters, n_fft, lengths)``: the wavelets' spectra, bins ``0..n_fft/2``, complex128.

    The wavelets (:func:`filters.wavelet`, centred in a power of two at
    least twice ``hop_length``) are scaled by ``length / n_fft`` and
    transformed; ``sparsity`` zeroes each row's smallest entries that
    together hold that share of its magnitude (:func:`util.sparsify_rows`).
    """
    basis, lengths = filters.wavelet(freqs=freqs, sr=sr, filter_scale=filter_scale, norm=norm,
                                     pad_fft=True, window=window, gamma=gamma, alpha=alpha,
                                     dtype=np.complex128)
    n_fft = basis.shape[1]
    if hop_length is not None:
        n_fft = max(n_fft, int(2.0 ** (1 + np.ceil(np.log2(hop_length)))))
    spectra = np.fft.fft(basis * (lengths[:, None] / float(n_fft)), n=n_fft,
                         axis=1)[:, :n_fft // 2 + 1]
    if sparsity > 0:
        spectra = _sparsify_dense(spectra, quantile=sparsity)
    spectra.setflags(write=False)
    return spectra, n_fft, lengths


_filters_fft_cached = functools.lru_cache(maxsize=64)(_filters_fft_host)


def _filters_fft(sr: float, freqs: np.ndarray, filter_scale: float, norm: Optional[float],
                 sparsity: float, *, hop_length: Optional[int] = None, window: Any = "hann",
                 gamma: Optional[float] = 0.0, alpha: Optional[np.ndarray] = None) -> tuple:
    """:func:`_filters_fft_host`, cached per configuration where the window is hashable."""
    if not _hashable(window):
        return _filters_fft_host(sr, freqs, filter_scale, norm, sparsity, hop_length, window,
                                 gamma, alpha)
    spectra, n_fft, lengths = _filters_fft_cached(
        float(sr), tuple(np.asarray(freqs).tolist()), float(filter_scale), norm,
        float(sparsity), hop_length, window, None if gamma is None else float(gamma),
        None if alpha is None else tuple(np.asarray(alpha).tolist()))
    return spectra, n_fft, lengths


def _filters_device(device: torch.device, dtype: torch.dtype, sr: float, freqs: np.ndarray,
                    filter_scale: float, norm: Optional[float], sparsity: float, *,
                    hop_length: Optional[int] = None, window: Any = "hann",
                    gamma: Optional[float] = 0.0, alpha: Optional[np.ndarray] = None,
                    gain: float = 1.0, magnitude: bool = False
                    ) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
    """``(gain * filters, n_fft, bands)`` of :func:`_filters_fft` on ``device`` in ``dtype``.

    With ``magnitude`` the table is ``|filters|`` and ``bands`` its band
    table for the stft_mel kernel (:func:`ops.fused_stft.basis_bands`), else
    None. Made in float64 on the host and rounded once; kept on the device
    per configuration where the window is hashable.
    """
    spectra, n_fft, _ = _filters_fft(sr, freqs, filter_scale, norm, sparsity,
                                     hop_length=hop_length, window=window, gamma=gamma,
                                     alpha=alpha)

    def make() -> np.ndarray:
        table = spectra * gain
        return np.abs(table) if magnitude else table

    if not _hashable(window):
        table = make()
        bands = torch.as_tensor(basis_bands(table), device=device) if magnitude else None
        return torch.tensor(table, dtype=dtype, device=device), n_fft, bands
    key = ("cq_filters", float(sr), tuple(np.asarray(freqs).tolist()), filter_scale, norm,
           sparsity, hop_length, window, gamma,
           None if alpha is None else tuple(np.asarray(alpha).tolist()), float(gain), magnitude)
    bands = (device_table(("bands",) + key, lambda: basis_bands(make()), device, torch.int32)
             if magnitude else None)
    return device_table(key, make, device, dtype), n_fft, bands


def _ladder_plan(sr: float, hop_length: int, freqs: np.ndarray, n_filters: int, n_octaves: int
                 ) -> List[Tuple[float, int, slice]]:
    """``(rate, hop, bins)`` of each rung of the ladder, the top octave first.

    The next rung halves the rate and the hop where the hop is even and the
    next octave's highest bin lies at or below a fifth of the current rate.
    """
    plan = []
    for i in range(n_octaves):
        bins = slice(-n_filters, None) if i == 0 else slice(-n_filters * (i + 1), -n_filters * i)
        plan.append((sr, hop_length, bins))
        if i < n_octaves - 1 and hop_length % 2 == 0 and freqs[bins.start - 1] <= sr / 5:
            sr, hop_length = sr / 2.0, hop_length // 2
    return plan


def _trim_stack(responses: List[torch.Tensor], n_bins: int) -> torch.Tensor:
    """The octaves' responses (top first) cut to the shortest, stacked bottom-up: ``n_bins`` rows."""
    n_cols = min(r.shape[-1] for r in responses)
    pieces, left = [], n_bins
    for r in responses:
        rows = r.shape[-2]
        pieces.append(r[..., -left:, :n_cols] if left < rows else r[..., :n_cols])
        left -= rows
    return torch.cat(pieces[::-1], dim=-2)


def _grid(*, sr: float, fmin: Optional[float], n_bins: Optional[int], intervals: Any,
          bins_per_octave: int, tuning: float, window: Any, filter_scale: float,
          gamma: Optional[float]) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """``(freqs, alpha, lengths, cutoff)`` of the transform's bins.

    ``fmin`` (default C1) is tuned by ``tuning`` bins; ``n_bins=None`` fills
    the spectrum up to the last filter that ends below Nyquist.
    """
    if fmin is None:
        fmin = note_to_hz("C1")
    fmin = fmin * 2.0 ** (tuning / bins_per_octave)
    if fmin >= sr / 2:
        raise ParameterError(f"fmin={fmin} must be less than sr/2={sr / 2}")
    auto = n_bins is None
    if auto:
        n_bins = int(np.ceil(bins_per_octave * (np.log2(sr) - np.log2(fmin))))
    freqs = interval_frequencies(n_bins, fmin=fmin, intervals=intervals,
                                 bins_per_octave=bins_per_octave, sort=True)
    if auto:
        freqs = _below_nyquist(freqs, window, filter_scale, gamma, sr)
    alpha = (_equal_bandwidth(bins_per_octave) if len(freqs) == 1
             else filters._relative_bandwidth(freqs=freqs))
    lengths, cutoff = filters.wavelet_lengths(freqs=freqs, sr=sr, window=window,
                                              filter_scale=filter_scale, gamma=gamma,
                                              alpha=alpha)
    return freqs, alpha, lengths, cutoff


def vqt(
    y: Any,
    *,
    sr: float = 22050,
    hop_length: int = 512,
    fmin: Optional[float] = None,
    n_bins: Optional[int] = 84,
    intervals: Union[str, Collection[float]] = "equal",
    gamma: Optional[float] = None,
    bins_per_octave: int = 12,
    tuning: Optional[float] = 0.0,
    filter_scale: float = 1,
    norm: Optional[float] = 1,
    sparsity: float = 0.01,
    window: Any = "hann",
    scale: bool = True,
    pad_mode: str = "constant",
    res_type: str = "soxr_hq",
    dtype: Any = None,
) -> torch.Tensor:
    """Variable-Q transform ``(..., n_bins, T)``, complex, by the octave ladder.

    Bins lie on the grid ``intervals`` (``'equal'``, ``'pythagorean'``,
    ``'ji3'``, ``'ji5'``, ``'ji7'`` or the ratios of one octave, whose count
    then sets ``bins_per_octave``) from ``fmin`` (default C1) shifted by
    ``tuning`` bins (None: :func:`estimate_tuning` of ``y``). Filter ``k``
    has the bandwidth ``alpha[k] * f[k] + gamma`` Hz (``gamma=None``: an
    ERB-like offset). ``n_bins=None`` fills the spectrum below Nyquist. The
    signal is first decimated by the largest power of two that both the
    hop and the band leave room for, then halved per octave with
    ``res_type`` (``'soxr_*'`` on a CUDA tensor takes a resampler of the
    card, with a warning). ``scale`` divides each bin by the square root of
    its filter's length; ``dtype`` is the output's complex dtype.
    """
    return _vqt(y, magnitude=False, sr=sr, hop_length=hop_length, fmin=fmin, n_bins=n_bins,
                intervals=intervals, gamma=gamma, bins_per_octave=bins_per_octave, tuning=tuning,
                filter_scale=filter_scale, norm=norm, sparsity=sparsity, window=window,
                scale=scale, pad_mode=pad_mode, res_type=res_type, dtype=dtype)


def _vqt(y: Any, *, magnitude: bool, sr: float, hop_length: int, fmin: Optional[float],
         n_bins: Optional[int], intervals: Any, gamma: Optional[float], bins_per_octave: int,
         tuning: Optional[float], filter_scale: float, norm: Optional[float], sparsity: float,
         window: Any, scale: bool, pad_mode: str, res_type: str, dtype: Any) -> torch.Tensor:
    """:func:`vqt`, or its modulus with ``magnitude``."""
    y = _audio(y)
    res_type = audio._device_res_type(y, res_type)
    if not isinstance(intervals, str):
        bins_per_octave = len(intervals)
    if tuning is None:
        tuning = estimate_tuning(y=y, sr=sr, bins_per_octave=bins_per_octave)
    dtype = dtype_r2c(y.dtype) if dtype is None else _torch_dtype(dtype)

    freqs, alpha, lengths, cutoff = _grid(
        sr=sr, fmin=fmin, n_bins=n_bins, intervals=intervals, bins_per_octave=bins_per_octave,
        tuning=float(tuning), window=window, filter_scale=filter_scale, gamma=gamma)
    n_bins = len(freqs)
    if cutoff > sr / 2.0:
        raise ParameterError(
            f"Wavelet basis with max frequency={float(np.max(freqs[-bins_per_octave:]))} would "
            f"exceed the Nyquist frequency={sr / 2.0}. Try reducing the number of frequency bins."
        )
    n_octaves = int(np.ceil(float(n_bins) / bins_per_octave))
    n_filters = min(bins_per_octave, n_bins)

    # decimate up front by what the top band and the hop leave room for; the ladder
    # still needs n_octaves - 1 halvings of the hop
    down = max(0, min(int(np.ceil(np.log2(sr / 2.0 / cutoff))) - 2,
                      _twos(hop_length) - (n_octaves - 1)))
    if down:
        factor = 1 << down
        if y.shape[-1] < factor:
            raise ParameterError(
                f"A {n_octaves:d}-octave analysis wants a {factor:d}:1 early decimation, but the "
                f"signal has only {y.shape[-1]:d} samples")
        y = audio.resample(y, orig_sr=factor, target_sr=1, res_type=res_type, scale=True)
        if not scale:
            y = y * np.sqrt(factor)
        sr, hop_length = sr / factor, hop_length // factor

    work = dtype_r2c(y.dtype)
    responses = []
    rung_y, rung_sr = y, sr
    for rate, hop, bins in _ladder_plan(sr, hop_length, freqs, n_filters, n_octaves):
        if rate != rung_sr:
            rung_y = audio.resample(rung_y, orig_sr=2, target_sr=1, res_type=res_type,
                                    scale=True)
            rung_sr = rate
        basis, n_fft, _ = _filters_device(
            y.device, work, rate, freqs[bins], filter_scale, norm, sparsity, window=window,
            gamma=gamma, alpha=alpha[bins], gain=float(np.sqrt(sr / rate)))
        D = _stft_core(rung_y, _win_device("ones", n_fft, n_fft, y.device, y.dtype),
                       n_fft=n_fft, hop_length=hop, center=True, pad_mode=pad_mode)
        with exact_f32():
            responses.append(torch.matmul(basis, D))

    V = _trim_stack(responses, n_bins)
    if scale:
        weights = 1.0 / np.sqrt(filters.wavelet_lengths(
            freqs=freqs, sr=sr, window=window, filter_scale=filter_scale, gamma=gamma,
            alpha=alpha)[0])
    else:
        weights = np.ones(n_bins)
    V = V * expand_to(torch.as_tensor(weights.astype(np.float32), device=V.device,
                                      dtype=V.real.dtype), ndim=V.ndim, axes=-2)
    V = V.to(dtype)
    return V.abs() if magnitude else V


def cqt(
    y: Any,
    *,
    sr: float = 22050,
    hop_length: int = 512,
    fmin: Optional[float] = None,
    n_bins: Optional[int] = 84,
    bins_per_octave: int = 12,
    tuning: Optional[float] = 0.0,
    filter_scale: float = 1,
    norm: Optional[float] = 1,
    sparsity: float = 0.01,
    window: Any = "hann",
    scale: bool = True,
    pad_mode: str = "constant",
    res_type: str = "soxr_hq",
    dtype: Any = None,
) -> torch.Tensor:
    """Constant-Q transform ``(..., n_bins, T)``: :func:`vqt` on the equal grid with ``gamma=0``.

    ``hop_length`` should hold a factor of 2 for each octave below the top
    one, or the lower octaves run at the full rate.
    """
    return vqt(y, sr=sr, hop_length=hop_length, fmin=fmin, n_bins=n_bins, intervals="equal",
               gamma=0, bins_per_octave=bins_per_octave, tuning=tuning,
               filter_scale=filter_scale, norm=norm, sparsity=sparsity, window=window,
               scale=scale, pad_mode=pad_mode, res_type=res_type, dtype=dtype)


def pseudo_cqt(
    y: Any,
    *,
    sr: float = 22050,
    hop_length: int = 512,
    fmin: Optional[float] = None,
    n_bins: Optional[int] = 84,
    bins_per_octave: int = 12,
    tuning: Optional[float] = 0.0,
    filter_scale: float = 1,
    norm: Optional[float] = 1,
    sparsity: float = 0.01,
    window: Any = "hann",
    scale: bool = True,
    pad_mode: str = "constant",
    dtype: Any = None,
) -> torch.Tensor:
    """Pseudo constant-Q magnitudes ``(..., n_bins, T)``: ``|filters| @ |STFT(y)|`` at one rate.

    One hann-windowed STFT at the widest filter's ``n_fft`` (at least twice
    ``hop_length``), its magnitude projected onto the modulus of the
    constant-Q filters' spectra, then divided by ``sqrt(n_fft)`` (``scale``)
    or multiplied by ``sqrt(length / n_fft)`` per bin. No phase. The
    projection is the stft_mel kernel's function at power 1: float32 input
    that its ``kernel_refusal`` takes runs as that kernel on the card. The
    result has the complex ``dtype`` (default: that of ``y``'s type), with
    zero imaginary parts.
    """
    y = _audio(y)
    dtype = dtype_r2c(y.dtype) if dtype is None else _torch_dtype(dtype)
    if tuning is None:
        tuning = estimate_tuning(y=y, sr=sr, bins_per_octave=bins_per_octave)
    if fmin is None:
        fmin = note_to_hz("C1")
    fmin = fmin * 2.0 ** (tuning / bins_per_octave)
    if fmin >= sr / 2:
        raise ParameterError(
            f"the lowest bin ({fmin} Hz) must sit below Nyquist ({sr / 2} Hz)")
    auto = n_bins is None
    if auto:
        n_bins = int(np.ceil(bins_per_octave * np.log2(sr / fmin)))
    freqs = cqt_frequencies(fmin=fmin, n_bins=n_bins, bins_per_octave=bins_per_octave)
    if auto:
        freqs = _below_nyquist(freqs, window, filter_scale, 0, sr)
    alpha = (_equal_bandwidth(bins_per_octave) if len(freqs) == 1
             else filters._relative_bandwidth(freqs=freqs))
    lengths, cutoff = filters.wavelet_lengths(alpha=alpha, filter_scale=filter_scale,
                                              freqs=freqs, sr=sr, window=window)
    if cutoff > sr / 2:
        raise ParameterError(
            f"the highest filter reaches {cutoff} Hz, past Nyquist ({sr / 2} Hz); use fewer "
            "bins")
    basis, n_fft, bands = _filters_device(y.device, y.dtype, sr, freqs, filter_scale, norm,
                                          sparsity, hop_length=hop_length, window=window,
                                          alpha=alpha, magnitude=True)
    P = _stft_mel_core(y, _win_device("hann", n_fft, n_fft, y.device, y.dtype), basis, bands,
                       n_fft=n_fft, hop_length=hop_length, center=True, pad_mode=pad_mode,
                       power=1.0)
    if scale:
        P = P / float(np.float32(np.sqrt(n_fft)))
    else:
        P = P * expand_to(torch.as_tensor(np.sqrt(lengths / n_fft).astype(np.float32),
                                          device=P.device, dtype=P.dtype), ndim=P.ndim, axes=-2)
    return P.to(dtype)


def hybrid_cqt(
    y: Any,
    *,
    sr: float = 22050,
    hop_length: int = 512,
    fmin: Optional[float] = None,
    n_bins: Optional[int] = 84,
    bins_per_octave: int = 12,
    tuning: Optional[float] = 0.0,
    filter_scale: float = 1,
    norm: Optional[float] = 1,
    sparsity: float = 0.01,
    window: Any = "hann",
    scale: bool = True,
    pad_mode: str = "constant",
    res_type: str = "soxr_hq",
    dtype: Any = None,
) -> torch.Tensor:
    """Constant-Q magnitudes ``(..., n_bins, T)``: :func:`pseudo_cqt` for short filters, else :func:`cqt`.

    A bin whose filter, rounded up to a power of two, is shorter than
    twice ``hop_length`` takes the pseudo transform; the lower bins take the
    modulus of the full ladder.
    """
    y = _audio(y)
    res_type = audio._device_res_type(y, res_type)
    if fmin is None:
        fmin = note_to_hz("C1")
    if tuning is None:
        tuning = estimate_tuning(y=y, sr=sr, bins_per_octave=bins_per_octave)
    fmin = fmin * 2.0 ** (float(tuning) / bins_per_octave)
    if fmin >= sr / 2:
        raise ParameterError(f"fmin={fmin} must be less than sr/2={sr / 2}")
    auto = n_bins is None
    if auto:
        n_bins = int(np.ceil(bins_per_octave * (np.log2(sr) - np.log2(fmin))))
    freqs = cqt_frequencies(n_bins, fmin=fmin, bins_per_octave=bins_per_octave)
    if auto:
        freqs = _below_nyquist(freqs, window, filter_scale, 0, sr)
        n_bins = len(freqs)
    alpha = (_equal_bandwidth(bins_per_octave) if n_bins == 1
             else filters._relative_bandwidth(freqs=freqs))
    lengths, cutoff = filters.wavelet_lengths(freqs=freqs, sr=sr, filter_scale=filter_scale,
                                              window=window, alpha=alpha)
    if cutoff > sr / 2:
        raise ParameterError(
            f"Filter cutoff frequency {cutoff} exceeds Nyquist frequency {sr / 2}. Try reducing "
            "the number of frequency bins.")
    short = 2.0 ** np.ceil(np.log2(lengths)) < 2 * hop_length
    n_short = int(np.sum(short))
    common = dict(sr=sr, hop_length=hop_length, bins_per_octave=bins_per_octave,
                  filter_scale=filter_scale, norm=norm, sparsity=sparsity, window=window,
                  scale=scale, pad_mode=pad_mode, dtype=dtype, tuning=0.0)
    responses = []
    if n_short > 0:
        responses.append(pseudo_cqt(y, fmin=float(np.min(freqs[short])), n_bins=n_short,
                                    **common))
    if n_bins > n_short:
        responses.append(cqt(y, fmin=fmin, n_bins=n_bins - n_short, res_type=res_type,
                             **common).abs())
    real = not responses[-1].is_complex()
    return _trim_stack([r.real if real and r.is_complex() else r for r in responses], n_bins)


def icqt(
    C: Any,
    *,
    sr: float = 22050,
    hop_length: int = 512,
    fmin: Optional[float] = None,
    bins_per_octave: int = 12,
    tuning: float = 0.0,
    filter_scale: float = 1,
    norm: Optional[float] = 1,
    sparsity: float = 0.01,
    window: Any = "hann",
    scale: bool = True,
    length: Optional[int] = None,
    res_type: str = "soxr_hq",
    dtype: Any = None,
) -> torch.Tensor:
    """A signal ``(..., n)`` whose constant-Q transform approximates ``C`` ``(..., n_bins, T)``.

    The ladder run backwards: each octave's bins go through the conjugate
    transpose of its filters' spectra, each bin weighted by the inverse of
    its filter's energy (and by the square root of its length where
    ``scale``), then an inverse STFT with a rectangular window at that
    octave's hop; each octave is resampled up to ``sr`` with ``res_type`` and
    the octaves are summed. The arguments must match the forward transform;
    ``length`` fixes the output length and ``dtype`` its real dtype.
    """
    C = as_tensor(C)
    res_type = audio._device_res_type(C, res_type)
    if fmin is None:
        fmin = note_to_hz("C1")
    fmin = fmin * 2.0 ** (tuning / bins_per_octave)
    n_bins = C.shape[-2]
    n_octaves = int(np.ceil(float(n_bins) / bins_per_octave))
    freqs = cqt_frequencies(fmin=fmin, n_bins=n_bins, bins_per_octave=bins_per_octave)
    alpha = (_equal_bandwidth(bins_per_octave) if n_bins == 1
             else filters._relative_bandwidth(freqs=freqs))
    lengths, _ = filters.wavelet_lengths(freqs=freqs, sr=sr, window=window,
                                         filter_scale=filter_scale, alpha=alpha)
    if length is not None:
        C = C[..., :int(np.ceil((length + max(lengths)) / hop_length))]
    work = dtype_r2c(C.dtype)

    # rates and hops from the bottom octave up: halved below every even hop
    rates, hops = [sr], [hop_length]
    for _ in range(n_octaves - 1):
        even = hops[0] % 2 == 0
        rates.insert(0, rates[0] * 0.5 if even else rates[0])
        hops.insert(0, hops[0] // 2 if even else hops[0])

    y = None
    for i, (rate, hop) in enumerate(zip(rates, hops)):
        bins = slice(bins_per_octave * i, bins_per_octave * i + min(bins_per_octave,
                                                                     n_bins - bins_per_octave * i))
        spectra, n_fft, _ = _filters_fft(rate, freqs[bins], filter_scale, norm, sparsity,
                                         window=window, alpha=alpha[bins])
        inverse = spectra.conj().T
        weight = n_fft / lengths[bins] / np.sum(np.abs(inverse) ** 2, axis=0)
        if scale:
            weight = weight * np.sqrt(lengths[bins])
        # the product in the working type, the weights rounded as the inverse is
        inv = torch.as_tensor(inverse.astype(np.complex64), device=C.device).to(work)
        w = torch.as_tensor(weight.astype(np.complex64), device=C.device).to(work)
        with exact_f32():
            D = torch.matmul(inv, w[:, None] * C[..., bins, :].to(work))
        y_oct = istft(D, window="ones", hop_length=hop)
        if dtype is not None:
            y_oct = y_oct.to(_torch_dtype(dtype))
        factor = int(sr // rate)
        if factor > 1:
            y_oct = audio.resample(y_oct, orig_sr=1, target_sr=factor, res_type=res_type,
                                   scale=False, fix=False)
        if y is None:
            y = y_oct.clone()
        else:
            n = min(y.shape[-1], y_oct.shape[-1])
            y[..., :n] += y_oct[..., :n]
    if length:
        y = fix_length(y, size=length)
    return y


def griffinlim_cqt(
    C: Any,
    *,
    n_iter: int = 32,
    sr: float = 22050,
    hop_length: int = 512,
    fmin: Optional[float] = None,
    bins_per_octave: int = 12,
    tuning: float = 0.0,
    filter_scale: float = 1,
    norm: Optional[float] = 1,
    sparsity: float = 0.01,
    window: Any = "hann",
    scale: bool = True,
    pad_mode: str = "constant",
    res_type: str = "soxr_hq",
    dtype: Any = None,
    length: Optional[int] = None,
    momentum: float = 0.99,
    init: Optional[str] = "random",
    rng: Any = None,
    random_state: Any = None,
) -> torch.Tensor:
    """A signal whose constant-Q magnitudes approximate ``C`` ``(..., n_bins, T)``, by Griffin-Lim.

    From random phases (``init='random'``, seeded by ``rng`` as in
    :func:`~librosa_tpu_torch.core.spectrum.griffinlim`) or zero phase
    (``init=None``), ``n_iter`` rounds of :func:`icqt` then :func:`cqt`
    re-estimate the phases, each pushed past the last by ``momentum``. The
    other arguments are those of the two transforms.
    """
    if random_state is not None:
        if rng is not None:
            raise ParameterError(
                f"Both random_state={random_state!r} and rng={rng!r} were provided. Please use "
                "only the rng parameter.")
        warnings.warn("random_state is deprecated; use rng instead", FutureWarning,
                      stacklevel=2)
        rng = random_state
    if momentum > 1:
        warnings.warn(f"Griffin-Lim with momentum={momentum} > 1 can be unstable.",
                      stacklevel=2)
    elif momentum < 0:
        raise ParameterError(f"griffinlim_cqt() called with momentum={momentum} < 0")
    if init not in ("random", None):
        raise ParameterError(f"init={init} must either None or 'random'")

    C = as_tensor(C)
    if not (C.dtype.is_floating_point or C.dtype.is_complex):
        C = C.to(torch.float32)
    phase_dtype = dtype_r2c(C.dtype)
    angles = _griffinlim_init(tuple(C.shape), _griffinlim_seed(rng), init, C.device,
                              phase_dtype)
    eps = tiny(torch.zeros((), dtype=phase_dtype))
    kw = dict(sr=sr, hop_length=hop_length, fmin=fmin, bins_per_octave=bins_per_octave,
              tuning=tuning, filter_scale=filter_scale, norm=norm, sparsity=sparsity,
              window=window, scale=scale, res_type=res_type)
    weight = momentum / (1 + momentum)
    rebuilt = torch.zeros(C.shape, dtype=phase_dtype, device=C.device)
    for _ in range(n_iter):
        tprev = rebuilt
        inverse = icqt(C * angles, length=length, **kw)
        rebuilt = cqt(inverse, n_bins=C.shape[-2], pad_mode=pad_mode,
                      **kw)[..., :C.shape[-1]].to(phase_dtype)
        angles = rebuilt - weight * tprev
        angles = angles / (angles.abs() + eps)
    return icqt(C * angles, length=length, dtype=dtype, **kw)
