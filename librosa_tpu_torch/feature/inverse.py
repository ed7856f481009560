"""Feature inversion: mel or MFCC back to an STFT magnitude or to audio.

The mel projection is undone by non-negative least squares
(:func:`util.nnls`, FISTA as in the JAX package) and the phases by
:func:`griffinlim`, all on the device of the input.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .. import filters
from .._device import as_tensor, device_table, exact_f32
from ..core.spectrum import db_to_power, griffinlim
from ..ops.transforms import dct_matrix
from ..util._nnls import nnls
from ..util.exceptions import ParameterError
from ..util.utils import expand_to, tiny

__all__ = ["mel_to_stft", "mel_to_audio", "mfcc_to_mel", "mfcc_to_audio"]


def mel_to_stft(M: Any, *, sr: float = 22050, n_fft: int = 2048, power: float = 2.0,
                **kwargs: Any) -> torch.Tensor:
    """An STFT magnitude ``(..., 1 + n_fft // 2, T)`` whose mel projection approximates ``M``.

    ``M`` is a mel spectrogram of ``|STFT|**power`` ``(..., n_mels, T)``;
    ``kwargs`` go to :func:`filters.mel` and must match the forward
    transform. :func:`util.nnls` solves every frame at once against the
    float32 filterbank, then the result is raised to ``1 / power``.
    """
    M = as_tensor(M)
    key = ("mel_to_stft", float(sr), int(n_fft), tuple(sorted(kwargs.items())))
    basis = device_table(key, lambda: filters.mel(sr=sr, n_fft=n_fft, dtype=np.float32, **kwargs),
                         M.device, torch.float32)
    return torch.pow(nnls(basis, M), 1.0 / float(power)).to(M.dtype)


def mel_to_audio(M: Any, *, sr: float = 22050, n_fft: int = 2048, hop_length: Optional[int] = None,
                 win_length: Optional[int] = None, window: Any = "hann", center: bool = True,
                 pad_mode: str = "constant", power: float = 2.0, n_iter: int = 32,
                 length: Optional[int] = None, dtype: Any = np.float32,
                 **kwargs: Any) -> torch.Tensor:
    """Audio from a mel spectrogram: :func:`mel_to_stft`, then ``n_iter`` rounds of
    :func:`griffinlim` (its random start, seeded with 0). ``kwargs`` go to :func:`filters.mel`."""
    magnitude = mel_to_stft(M, sr=sr, n_fft=n_fft, power=power, **kwargs)
    return griffinlim(magnitude, n_iter=n_iter, hop_length=hop_length, win_length=win_length,
                      n_fft=n_fft, window=window, center=center, dtype=dtype, length=length,
                      pad_mode=pad_mode)


def mfcc_to_mel(mfcc: Any, *, n_mels: int = 128, dct_type: int = 2, norm: Optional[str] = "ortho",
                ref: float = 1.0, lifter: float = 0) -> torch.Tensor:
    """A mel power spectrogram ``(..., n_mels, T)`` from MFCCs ``(..., n_mfcc, T)``.

    Undoes the lifter (``lifter > 0``), applies the transposed DCT (the
    inverse where ``n_mfcc == n_mels`` and ``norm='ortho'``, else the least
    norm fit) as one full-float32 product, and :func:`db_to_power` with ``ref``.
    """
    mfcc = as_tensor(mfcc)
    if lifter < 0:
        raise ParameterError(f"MFCC to mel lifter={lifter} must be a positive number")
    C = device_table(("dct", n_mels, dct_type, norm),
                     lambda: dct_matrix(n_mels, dct_type=dct_type, norm=norm),
                     mfcc.device, mfcc.dtype)[:mfcc.shape[-2]]
    if lifter > 0:
        idx = torch.arange(1, 1 + mfcc.shape[-2], dtype=mfcc.dtype, device=mfcc.device)
        lifter_sine = 1 + lifter * 0.5 * torch.sin(np.pi * expand_to(idx, ndim=mfcc.ndim, axes=-2)
                                                   / lifter)
        mfcc = mfcc / (lifter_sine + tiny(mfcc) * 2)
    with exact_f32():
        logmel = torch.matmul(C.T, mfcc)
    return db_to_power(logmel, ref=ref)


def mfcc_to_audio(mfcc: Any, *, n_mels: int = 128, dct_type: int = 2,
                  norm: Optional[str] = "ortho", ref: float = 1.0, lifter: float = 0,
                  **kwargs: Any) -> torch.Tensor:
    """Audio from MFCCs: :func:`mfcc_to_mel`, then :func:`mel_to_audio` (``kwargs`` go there)."""
    spectrogram = mfcc_to_mel(mfcc, n_mels=n_mels, dct_type=dct_type, norm=norm, ref=ref,
                              lifter=lifter)
    return mel_to_audio(spectrogram, **kwargs)
