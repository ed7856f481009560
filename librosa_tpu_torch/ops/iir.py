"""IIR filtering along an axis as doubling scans: first-order sections and banks of biquads.

The recurrence ``y[n] = a y[n-1] + c[n]`` composes affine maps, which
compose associatively, so it runs as a scan of ``log2(n)`` doubling steps
over the whole axis (Hillis-Steele), each a few torch ops on the input's
device: no loop over samples. The JAX package runs the same composition as
a ``lax.associative_scan`` (``librosa_tpu/ops/iir.py``); the two sum in
different orders and agree to float rounding.

A transposed-direct-form-II biquad is the two-state recurrence

    s[n] = M s[n-1] + v x[n],   M = [[-a1, 1], [-a2, 0]],   v = [b1 - a1 b0, b2 - a2 b0]
    y[n] = b0 x[n] + s[n-1][0]

Its scan (:func:`_prefix_affine_scan`) adds ``M**(2**k) s[n - 2**k]`` in
round ``k``; the powers of ``M`` are made on the host in float64 and only
rounded to float32, so the scan never multiplies matrices in float32. The
error that remains (the forcing summed over the filter's memory, ruinous
for the semitone bank's poles at ``|z| ~ 0.998``) is cancelled by one round
of refinement: the residual ``M s[n-1] + v x[n] - s[n]`` is computed
exactly with error-free transforms (:func:`_two_prod`, :func:`_two_sum`)
against the float64 coefficients (their float32 heads and tails), scanned
the same way and added. Those transforms need every product and sum
rounded on its own: each is a separate eager torch op, never fused (no
``addcmul``, no ``torch.compile``), or a fused multiply-add would silently
undo the refinement.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from .._device import as_tensor

__all__ = ["first_order_filter", "affine_scan", "sosfilt_zi", "biquad_filter", "sosfilt",
           "sosfiltfilt", "sos_bank_filtfilt"]


def affine_scan(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``y[n] = a[n] y[n-1] + c[n]`` along the last axis from ``y[-1] = 0``, by doubling steps.

    ``a`` broadcasts against ``c``. After the step of ``shift``, ``(a[i],
    c[i])`` compose the maps of samples ``i - 2 * shift + 1 .. i``.
    """
    n = c.shape[-1]
    a = a.expand_as(c)
    shift = 1
    while shift < n:
        c = torch.cat([c[..., :shift], c[..., shift:] + a[..., shift:] * c[..., :-shift]], -1)
        a = torch.cat([a[..., :shift], a[..., shift:] * a[..., :-shift]], -1)
        shift *= 2
    return c


def first_order_filter(x: Any, *, b0: float, b1: float, a1: float, zi: Any,
                       axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter ``x`` along ``axis`` by ``y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1]``; return
    ``(y, zf)`` with scipy's delay state.

    ``zi`` has ``x``'s shape without ``axis`` (or broadcasts to it): ``y[0]
    = b0 x[0] + zi``. ``zf = b1 x[-1] - a1 y[-1]`` continues the stream.
    """
    x = as_tensor(x).movedim(axis, -1)
    zi = torch.as_tensor(zi, dtype=x.dtype, device=x.device)
    if zi.ndim < x.ndim:
        zi = zi.unsqueeze(-1)
    c = torch.cat([b0 * x[..., :1] + zi, b0 * x[..., 1:] + b1 * x[..., :-1]], dim=-1)
    if a1 != 0.0:
        c = affine_scan(torch.full((), -a1, dtype=c.dtype, device=c.device), c)
    zf = b1 * x[..., -1] - a1 * c[..., -1]
    return c.movedim(-1, axis), zf


# ---------------------------------------------------------------------------
# error-free transforms
# ---------------------------------------------------------------------------

# Veltkamp's split constant, 2**(p - p // 2) + 1 for a p-bit significand
_SPLIT = {torch.float32: 4097.0, torch.float64: 134217729.0}


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Knuth's two-sum: ``fl(a + b)`` and its rounding error, exactly."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _two_prod(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dekker's two-product: ``fl(a * b)`` and its rounding error, exactly."""
    split = _SPLIT[b.dtype]
    p = a * b
    aa = a * split
    ah = aa - (aa - a)
    al = a - ah
    bb = b * split
    bh = bb - (bb - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


# ---------------------------------------------------------------------------
# banks of biquad cascades
# ---------------------------------------------------------------------------


def _bank_params(sos_bank: np.ndarray, n_ext: int, dtype: Any = np.float32):
    """Host constants of a bank of ``B`` cascades of ``S`` sections ``(B, S, 6)``, in float64 and
    rounded to ``dtype``.

    Returns ``M`` ``(S, B, 2, 2)``, ``v`` ``(S, B, 2)``, ``b0`` ``(S, B)``,
    ``Mpows`` ``(S, K, B, 2, 2)`` with ``Mpows[s, k] = M_s**(2**k)`` squared
    in float64 (``K = ceil(log2(n_ext))``), and ``M_lo``, ``v_lo``: the
    float64 coefficients less their rounded heads, which the refinement
    folds in (a high-Q pole moves by ``eps * Q`` with its coefficients).
    """
    sos = np.asarray(sos_bank, dtype=np.float64)
    B, S, _ = sos.shape
    sos = sos / sos[..., 3:4]
    b0, b1, b2, _, a1, a2 = (sos[..., i] for i in range(6))
    M = np.zeros((S, B, 2, 2))
    M[..., 0, 0] = -a1.T
    M[..., 0, 1] = 1.0
    M[..., 1, 0] = -a2.T
    v = np.stack([(b1 - a1 * b0).T, (b2 - a2 * b0).T], axis=-1)
    K = max(1, int(np.ceil(np.log2(max(n_ext, 2)))))
    Mpows = np.empty((S, K, B, 2, 2))
    P = M.copy()
    for k in range(K):
        Mpows[:, k] = P
        P = P @ P
    Mr, vr = M.astype(dtype), v.astype(dtype)
    return (Mr, vr, b0.T.astype(dtype), Mpows.astype(dtype), (M - Mr).astype(dtype),
            (v - vr).astype(dtype))


def sosfilt_zi(sos: Any) -> np.ndarray:
    """Each section's state ``(S, 2)`` in the steady state of a unit step, as
    ``scipy.signal.sosfilt_zi`` gives it (float64, on the host)."""
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim == 1:
        sos = sos[None]
    sos = sos / sos[:, 3:4]
    zi = np.empty((sos.shape[0], 2))
    scale = 1.0
    for k, (b0, b1, b2, _, a1, a2) in enumerate(sos):
        g = (b0 + b1 + b2) / (1.0 + a1 + a2)
        zi[k] = scale * np.array([g - b0, b2 - a2 * g])
        scale *= g
    return zi


def _coef(m: torch.Tensor) -> torch.Tensor:
    """Per-band coefficients of the two state rows, ``(B, 2)``, placed to broadcast over the
    stacked state ``(L, B, 2, N)``."""
    return m[None, :, :, None]


def _prefix_affine_scan(Mpows: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``s[n] = M s[n-1] + c[n]`` from ``s[-1] = 0`` along the last axis of the stacked state
    ``c`` ``(L, B, 2, N)``; ``Mpows`` ``(K, B, 2, 2)`` holds ``M**(2**k)``.

    Row ``i`` of a step adds ``M[i, 0] p0 + M[i, 1] p1``, with ``p`` the state
    ``2**k`` samples earlier: both rows in each op.
    """
    n = c.shape[-1]
    s = c
    shift, k = 1, 0
    while shift < n:
        p = torch.nn.functional.pad(s[..., :-shift], (shift, 0))
        m = Mpows[k]
        s = s + (_coef(m[:, :, 0]) * p[:, :, 0:1] + _coef(m[:, :, 1]) * p[:, :, 1:2])
        shift *= 2
        k += 1
    return s


def _bank_biquad_core(x: torch.Tensor, M: torch.Tensor, Mpows: torch.Tensor, v: torch.Tensor,
                      b0: torch.Tensor, s0: torch.Tensor, M_lo: torch.Tensor, v_lo: torch.Tensor,
                      *, refine: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One section over a bank: ``x`` ``(L, B, N)`` from state ``s0`` ``(L, B, 2)`` to ``(y, zf)``.

    The state's two rows are stacked as ``(L, B, 2, N)``. With ``refine``,
    one exact-residual round (the module notes) brings the float32 scan to
    about float64's accuracy against the float64 coefficients.
    """
    xs = x[:, :, None, :]
    c = xs * _coef(v)
    start = M[None, :, :, 0] * s0[..., 0:1] + M[None, :, :, 1] * s0[..., 1:2]
    c = torch.cat([c[..., :1] + start[..., None], c[..., 1:]], dim=-1)
    s = _prefix_affine_scan(Mpows, c)
    if refine:
        sp = torch.cat([s0[..., None], s[..., :-1]], dim=-1)
        p1, e1 = _two_prod(_coef(M[:, :, 0]), sp[:, :, 0:1])
        p2, e2 = _two_prod(_coef(M[:, :, 1]), sp[:, :, 1:2])
        p3, e3 = _two_prod(_coef(v), xs)
        acc, e4 = _two_sum(p1, p2)
        acc, e5 = _two_sum(acc, p3)
        acc, e6 = _two_sum(acc, -s)
        tail = (_coef(M_lo[:, :, 0]) * sp[:, :, 0:1] + _coef(M_lo[:, :, 1]) * sp[:, :, 1:2]
                + _coef(v_lo) * xs)
        s = s + _prefix_affine_scan(Mpows, acc + (e1 + e2 + e3 + e4 + e5 + e6 + tail))
    z1_prev = torch.cat([s0[..., 0:1], s[:, :, 0, :-1]], dim=-1)
    y = b0[None, :, None] * x + z1_prev
    return y, s[..., -1]


def _bank_tensors(sos_bank: np.ndarray, n_ext: int, like: torch.Tensor) -> List[torch.Tensor]:
    """:func:`_bank_params` of the bank for a scan of ``n_ext`` samples, on ``like``'s device and
    rounded to its dtype."""
    params = _bank_params(sos_bank, n_ext, np.dtype(str(like.dtype).removeprefix("torch.")))
    return [torch.as_tensor(p, device=like.device, dtype=like.dtype) for p in params]


def _bank_cascade(x: torch.Tensor, M: torch.Tensor, v: torch.Tensor, b0: torch.Tensor,
                  Mpows: torch.Tensor, zi: torch.Tensor, M_lo: torch.Tensor, v_lo: torch.Tensor,
                  *, refine: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``S`` sections in series over a bank: ``x`` ``(L, B, N)``, ``zi`` ``(L, B, S, 2)``."""
    zf = []
    for k in range(M.shape[0]):
        x, zf_k = _bank_biquad_core(x, M[k], Mpows[k], v[k], b0[k], zi[:, :, k], M_lo[k],
                                    v_lo[k], refine=refine)
        zf.append(zf_k)
    return x, torch.stack(zf, dim=2)


def _bank_padlen(sos_bank: np.ndarray) -> int:
    """scipy's default ``sosfiltfilt`` pad length for the bank's cascades (the most of any)."""
    n_sections = sos_bank.shape[1]
    ntaps = 2 * n_sections + 1
    drop = min(int((sos_bank[..., 2] == 0).all(axis=0).sum()),
               int((sos_bank[..., 5] == 0).all(axis=0).sum()))
    return 3 * (ntaps - drop)


def _bank_filtfilt_core(x2: torch.Tensor, M: torch.Tensor, v: torch.Tensor, b0: torch.Tensor,
                        Mpows: torch.Tensor, zi_unit: torch.Tensor, M_lo: torch.Tensor,
                        v_lo: torch.Tensor, *, padlen: int, refine: bool = True) -> torch.Tensor:
    """Signals ``x2`` ``(L, N)`` through every cascade of a bank forward and backward: ``(L, B, N)``.

    scipy's default edges: an odd extension by ``padlen`` at both ends, and
    each pass started from the sections' steady state (``zi_unit``
    ``(B, S, 2)``) scaled by its first sample.
    """
    n = x2.shape[-1]
    left = 2 * x2[:, :1] - x2[:, 1:padlen + 1].flip(-1)
    right = 2 * x2[:, -1:] - x2[:, -padlen - 1:-1].flip(-1)
    ext = torch.cat([left, x2, right], dim=-1)
    ext = ext[:, None, :].expand(ext.shape[0], M.shape[1], ext.shape[1])
    fwd, _ = _bank_cascade(ext, M, v, b0, Mpows, zi_unit[None] * ext[:, :, :1, None], M_lo,
                           v_lo, refine=refine)
    rev = fwd.flip(-1)
    bwd, _ = _bank_cascade(rev, M, v, b0, Mpows, zi_unit[None] * rev[:, :, :1, None], M_lo,
                           v_lo, refine=refine)
    return bwd.flip(-1)[..., padlen:padlen + n]


def _as_sos(sos: Any) -> np.ndarray:
    sos = np.asarray(sos, dtype=np.float64)
    return sos[None] if sos.ndim == 1 else sos


def biquad_filter(x: Any, sos_row: Any, *, zi: Any = None,
                  axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """One section ``[b0 b1 b2 1 a1 a2]`` along ``axis``: :func:`sosfilt` of a single section,
    ``zi`` and the final state ``(..., 2)``."""
    y, zf = sosfilt(x, np.asarray(sos_row)[None],
                    zi=None if zi is None else as_tensor(zi)[..., None, :], axis=axis)
    return y, zf[..., 0, :]


def sosfilt(x: Any, sos: Any, *, zi: Any = None,
            axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scipy.signal.sosfilt`` on the device: sections in series, each a refined doubling scan.

    ``zi`` and the returned final state are ``(..., n_sections, 2)``, scipy's layout.
    """
    sos = _as_sos(sos)
    x = as_tensor(x).movedim(axis, -1)
    batch, n = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, 1, n)
    M, v, b0, Mpows, M_lo, v_lo = _bank_tensors(sos[None], n, x)
    if zi is None:
        s0 = x.new_zeros((x2.shape[0], 1, sos.shape[0], 2))
    else:
        zi = torch.as_tensor(zi, dtype=x.dtype, device=x.device)
        s0 = zi.broadcast_to(tuple(batch) + (sos.shape[0], 2)).reshape(x2.shape[0], 1,
                                                                        sos.shape[0], 2)
    y, zf = _bank_cascade(x2, M, v, b0, Mpows, s0, M_lo, v_lo)
    return (y.reshape(tuple(batch) + (n,)).movedim(-1, axis),
            zf.reshape(tuple(batch) + (sos.shape[0], 2)))


def _filtfilt_bank(x: Any, sos_bank: np.ndarray, axis: int) -> Tuple[torch.Tensor, tuple]:
    """:func:`_bank_filtfilt_core` of ``x`` along ``axis``: ``(L, B, n)`` and the batch shape."""
    padlen = _bank_padlen(sos_bank)
    x = as_tensor(x).movedim(axis, -1)
    n = x.shape[-1]
    if n <= padlen:
        raise ValueError(f"The length of the input vector x must be greater than padlen, "
                         f"which is {padlen}.")
    M, v, b0, Mpows, M_lo, v_lo = _bank_tensors(sos_bank, n + 2 * padlen, x)
    zi_unit = torch.as_tensor(np.stack([sosfilt_zi(s) for s in sos_bank]), dtype=x.dtype,
                              device=x.device)
    out = _bank_filtfilt_core(x.reshape(-1, n), M, v, b0, Mpows, zi_unit, M_lo, v_lo,
                              padlen=padlen)
    return out, tuple(x.shape[:-1])


def sosfiltfilt(x: Any, sos: Any, *, axis: int = -1) -> torch.Tensor:
    """``scipy.signal.sosfiltfilt`` with its default edges, on the device (refined scans)."""
    out, batch = _filtfilt_bank(x, _as_sos(sos)[None], axis)
    return out[:, 0].reshape(batch + (out.shape[-1],)).movedim(-1, axis)


def sos_bank_filtfilt(x: Any, sos_bank: Any, *, axis: int = -1) -> torch.Tensor:
    """Zero-phase filter ``x`` through every cascade of ``sos_bank`` ``(B, S, 6)`` at once.

    Returns ``(..., B, n)``: the band axis before time (and ``axis`` taken as
    the time axis of ``x``). The bands are a batch dimension of one set of
    scans, not a loop.
    """
    sos_bank = np.asarray(sos_bank, dtype=np.float64)
    if sos_bank.ndim == 2:
        sos_bank = sos_bank[None]
    out, batch = _filtfilt_bank(x, sos_bank, axis)
    return out.reshape(batch + tuple(out.shape[1:]))
