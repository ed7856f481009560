"""Plain float64 building blocks of the references: windows, framing, the mel filterbank, dB, DCT.

Everything here is written from librosa's documented definitions in plain
NumPy and PyTorch. It imports nothing of the program under test and takes
nothing that the program made: each table is worked out again here.

``q`` is a rounding applied to each stage's output. The reference proper
passes :func:`exact`; the lower-precision control passes :func:`bf16`,
which stores every stage's output in bfloat16, the precision below the
float32 that the configurations state.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest even) and widened back."""
    return x.to(torch.bfloat16).to(x.dtype)


def row_blocks(rows: int, samples: int, budget: int = 1 << 24):
    """Slices of rows that hold at most ``budget`` samples each (at least one row)."""
    step = max(1, budget // max(1, samples))
    return [slice(r, min(rows, r + step)) for r in range(0, rows, step)]


def hann(n: int, device) -> torch.Tensor:
    """The periodic Hann window of ``n`` samples, float64."""
    k = torch.arange(n, dtype=F64, device=device)
    return 0.5 - 0.5 * torch.cos(2 * np.pi * k / n)


def frames(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """``(rows, T, n_fft)`` frames of ``y`` ``(rows, n)``, centred with zeros."""
    padded = torch.nn.functional.pad(y, (n_fft // 2, n_fft // 2))
    return padded.unfold(-1, n_fft, hop)


def power_spectrum(y: torch.Tensor, n_fft: int, hop: int, q=exact) -> torch.Tensor:
    """``|rfft(window * frame)|**2`` as ``(rows, T, 1 + n_fft // 2)``."""
    X = torch.fft.rfft(frames(y, n_fft, hop) * hann(n_fft, y.device), dim=-1)
    return q(X.real.square() + X.imag.square())


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney's mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_basis(sr: float, n_fft: int, n_mels: int, fmin: float = 0.0,
              fmax: float | None = None) -> np.ndarray:
    """Slaney-normalised triangular mel filters ``(n_mels, 1 + n_fft // 2)``, float64."""
    fmax = sr / 2 if fmax is None else fmax
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    return weights * (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]


def mel_spectrogram(y: torch.Tensor, *, sr: float, n_fft: int, hop: int, n_mels: int,
                    fmax: float | None = None, q=exact) -> torch.Tensor:
    """``(rows, n_mels, T)`` power mel spectrogram of float64 ``y`` ``(rows, n)``."""
    basis = torch.as_tensor(mel_basis(sr, n_fft, n_mels, fmax=fmax), device=y.device)
    S = power_spectrum(y, n_fft, hop, q)
    return q(torch.matmul(S, basis.T).transpose(-1, -2))


def power_to_db(S: torch.Tensor, *, amin: float = 1e-10, top_db: float = 80.0,
                q=exact) -> torch.Tensor:
    """``10 log10(max(S, amin))`` against a reference of 1, clamped ``top_db`` below each
    row's peak over its last two axes."""
    log_spec = 10.0 * torch.log10(S.clamp(min=amin))
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    return q(torch.maximum(log_spec, peak - top_db))


def dct_ortho(n: int, device) -> torch.Tensor:
    """The orthonormal DCT-II matrix ``(n, n)``, float64."""
    k = torch.arange(n, dtype=F64, device=device)[:, None]
    j = torch.arange(n, dtype=F64, device=device)[None, :]
    C = torch.cos(np.pi * k * (2 * j + 1) / (2 * n)) * np.sqrt(2.0 / n)
    C[0] /= np.sqrt(2.0)
    return C


def on_host(x) -> torch.Tensor:
    """``x`` (a tensor on any device, an array or a number) as a tensor on the host."""
    return x.detach().cpu() if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def rel_err(got, want, mask=None) -> float:
    """``||got - want|| / ||want||`` in float64 over ``mask`` (all where None)."""
    g, w = on_host(got).double(), on_host(want).double()
    if mask is not None:
        m = on_host(mask)
        g, w = g[m], w[m]
    den = float(torch.linalg.vector_norm(w))
    num = float(torch.linalg.vector_norm(g - w))
    if not np.isfinite(num):
        return float("inf")
    return num / den if den > 0 else num
