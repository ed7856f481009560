"""Spectral features of the port's main path: mel spectrogram and MFCC."""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from .. import filters
from .._device import as_tensor, device_table, exact_f32
from ..core.spectrum import _stft_mel_core, _win_device, power_to_db
from ..ops.fused_stft import basis_bands
from ..ops.transforms import dct_matrix
from ..util.exceptions import ParameterError
from ..util.utils import expand_to

__all__ = ["melspectrogram", "mfcc"]


def _mel_device(sr: float, n_fft: int, device: torch.device, dtype: torch.dtype,
                **kwargs: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mel filterbank ``(n_mels, 1 + n_fft // 2)`` and its band table, on ``device``.

    Both are made on the host from the same :func:`filters.mel` array and
    uploaded once per configuration. The band table (each row's span of
    nonzero columns, :func:`basis_bands`) is what the stft_mel kernel walks.
    """
    key = (float(sr), int(n_fft), tuple(sorted(kwargs.items())))

    def mel() -> np.ndarray:
        return filters.mel(sr=sr, n_fft=n_fft, **kwargs)

    return (device_table(("mel",) + key, mel, device, dtype),
            device_table(("mel.bands",) + key, lambda: basis_bands(mel()), device, torch.int32))


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

    y = as_tensor(y)
    if not y.dtype.is_floating_point:
        raise ParameterError("Audio data must be floating-point")
    if y.dtype not in (torch.float32, torch.float64):
        y = y.to(torch.float32)
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
