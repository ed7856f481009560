"""Spectrogram decompositions: HPSS, matrix factorisation, nearest-neighbour filtering.

- :func:`hpss`: its two median filters run as the median_filter kernel on
  the card (``ops/median.py``); the masks are elementwise torch ops that
  keep the spectrogram's layout.
- :func:`decompose`: sklearn's ``NMF`` (or the caller's transformer) on
  the host, as in the JAX package; ``transformer='mu'`` runs
  multiplicative-update NMF on the device, its start drawn from a
  ``torch.Generator`` seeded with ``seed``.
- :func:`nn_filter`: the neighbour graph from
  :func:`~librosa_tpu_torch.segment.recurrence_matrix` (its search on the
  card), then the mean or weighted mean over each frame's neighbours as one
  sparse product, float64 ``scipy.sparse`` on the host as in the JAX
  package; another aggregate loops over the frames on the host.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import scipy.sparse
import torch

from ._device import as_tensor, exact_f32, get_device
from .core.spectrum import magphase
from .ops import median as _med
from .util.exceptions import ParameterError
from .util.utils import _host, _pair, _softmask_core, axis_sort

__all__ = ["decompose", "hpss", "nn_filter"]


def decompose(S: Any, *, n_components: Optional[int] = None, transformer: Optional[Any] = None,
              sort: bool = False, fit: bool = True, **kwargs: Any) -> Tuple[np.ndarray, np.ndarray]:
    """Factor ``S`` ``(..., n_features, n_samples)`` as components ``(n_features, k)`` times activations ``(k, n_samples)``.

    By default sklearn's ``NMF(n_components, **kwargs)`` is fitted on the
    host; ``transformer`` may be any object with ``fit_transform``,
    ``transform`` and ``components_`` (``fit=False`` uses it as fitted), or
    ``'mu'`` for multiplicative-update NMF on the device (``n_iter``,
    ``seed`` in ``kwargs``). ``sort`` orders the components by the bin of
    their peak (2-D ``S`` only). Both results are numpy arrays; a
    multichannel ``S`` gives components ``(..., n_features, k)``.
    """
    device = S.device if isinstance(S, torch.Tensor) else get_device()
    S = _host(S)
    lead_shape = list(S.shape[:-1])
    if sort and S.ndim > 2:
        raise ParameterError("sorted components are only defined for 2-D inputs; "
                             "got a stack with more than two dimensions")
    flat = S.T.reshape((S.shape[-1], -1), order="F")  # (samples, features)
    if n_components is None:
        n_components = flat.shape[-1]

    def unflatten(comp: np.ndarray) -> np.ndarray:
        return comp.reshape([*lead_shape, -1][::-1], order="F").T

    if transformer == "mu":
        V = torch.from_numpy(np.ascontiguousarray(flat.T)).to(device)
        W, H = _nmf_mu(V, n_components, **kwargs)
        components, activations = _host(W), _host(H)
        if S.ndim > 2:
            components = unflatten(components)
    else:
        if transformer is None:
            if fit is False:
                raise ParameterError("a fresh NMF transformer must be fitted: fit=False "
                                     "requires passing a pre-fit transformer")
            import sklearn.decomposition

            transformer = sklearn.decomposition.NMF(n_components=n_components, **kwargs)
        fitted = transformer.fit_transform(flat) if fit else transformer.transform(flat)
        activations = fitted.T
        components = unflatten(transformer.components_)
    if sort:
        components, order = axis_sort(torch.from_numpy(np.ascontiguousarray(components)),
                                      index=True)
        components = components.numpy()
        activations = np.asarray(activations)[order.numpy()]
    return np.asarray(components), np.asarray(activations)


def _nmf_mu(V: torch.Tensor, k: int, *, n_iter: int = 200, seed: int = 0,
            **_: Any) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multiplicative-update NMF of ``V`` ``(m, n)`` from a start uniform in [0.1, 1) seeded by ``seed``."""
    dtype = V.dtype if V.dtype in (torch.float32, torch.float64) else torch.float32
    V = V.to(dtype)
    gen = torch.Generator(device=V.device).manual_seed(int(seed))
    m, n = V.shape
    W = torch.rand(m, int(k), generator=gen, device=V.device, dtype=dtype) * 0.9 + 0.1
    H = torch.rand(int(k), n, generator=gen, device=V.device, dtype=dtype) * 0.9 + 0.1
    return _nmf_mu_run(V, W, H, n_iter=int(n_iter))


def _nmf_mu_run(V: torch.Tensor, W: torch.Tensor, H: torch.Tensor, *,
                n_iter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iter`` multiplicative updates (Frobenius loss) of ``H`` then ``W``, in full float32 products."""
    eps = 1e-10
    with exact_f32():
        for _ in range(n_iter):
            H = H * (W.T @ V) / (W.T @ W @ H + eps)
            W = W * (V @ H.T) / (W @ (H @ H.T) + eps)
    return W, H


def hpss(
    S: Any,
    *,
    kernel_size: Union[int, Tuple[int, int]] = 31,
    power: float = 2.0,
    mask: bool = False,
    margin: Union[float, Tuple[float, float]] = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Harmonic and percussive parts ``(H, P)`` of a spectrogram ``S`` ``(..., d, n)``.

    A median filter along time (``kernel_size[0]`` frames) keeps what is
    steady in pitch, one along frequency (``kernel_size[1]`` bins) what is
    steady in time. Each part is ``S`` times its soft mask
    (:func:`~librosa_tpu_torch.util.softmask` of one filtered spectrogram
    against the other times ``margin``, at ``power``; ``np.inf`` gives hard
    masks). Margins above 1 leave a residual that neither part takes; with
    both margins 1 a cell where both filters are zero goes half to each
    part. A complex ``S`` is split into magnitude and phase and the parts
    get the phase back. ``mask=True`` returns the masks instead.
    """
    S = as_tensor(S)
    win_harm, win_perc = _pair(kernel_size, "kernel_size")
    margin_harm, margin_perc = _pair(margin, "margin")
    if margin_harm < 1 or margin_perc < 1:
        raise ParameterError("Margins must be >= 1.0. A typical range is between 1 and 10.")
    return _hpss_core(S, win_harm=int(win_harm), win_perc=int(win_perc), power=float(power),
                      margin_harm=float(margin_harm), margin_perc=float(margin_perc),
                      mask=bool(mask))


def _median(S: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """The sliding median: the kernel where its predicate takes the call, else the plain version."""
    if _med.kernel_refusal(S, size, axis) is None:
        return _med.median_filter_1d(S, size=size, axis=axis)
    return _med.median_filter_reference(S, size=size, axis=axis)


def _hpss_core(S: torch.Tensor, *, win_harm: int, win_perc: int, power: float,
               margin_harm: float, margin_perc: float,
               mask: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    phase = None
    if S.is_complex():
        S, phase = magphase(S)
    harm = _median(S, win_harm, -1)
    perc = _median(S, win_perc, -2)
    split_zeros = margin_harm == 1 and margin_perc == 1
    mask_harm = _softmask_core(harm, perc * margin_harm, power=power, split_zeros=split_zeros)
    mask_perc = _softmask_core(perc, harm * margin_perc, power=power, split_zeros=split_zeros)
    if mask:
        return mask_harm, mask_perc
    if phase is None:
        return S * mask_harm, S * mask_perc
    return (S * mask_harm) * phase, (S * mask_perc) * phase


def nn_filter(S: Any, *, rec: Optional[Any] = None, aggregate: Optional[Callable] = None,
              axis: int = -1, **kwargs: Any) -> np.ndarray:
    """Each frame of ``S`` along ``axis`` replaced by the ``aggregate`` of its neighbours' frames.

    The neighbours are the links of ``rec`` ``(n, n)`` (column ``j``: frame
    ``j``'s), by default :func:`~librosa_tpu_torch.segment.recurrence_matrix`
    of ``S`` with ``kwargs``. ``np.mean`` (the default) and ``np.average``
    (weighted by the links) are one sparse product; a frame with no
    neighbour keeps its values. Returns a numpy array of ``S``'s shape and
    dtype.
    """
    if aggregate is None:
        aggregate = np.mean
    if rec is None:
        from . import segment

        rec_s = scipy.sparse.csc_matrix(
            segment.recurrence_matrix(S, axis=axis, **{**kwargs, "sparse": True}))
    elif not scipy.sparse.issparse(rec):
        rec_s = scipy.sparse.csc_matrix(_host(rec))
    else:
        rec_s = scipy.sparse.csc_matrix(rec)
    S = _host(S)
    if rec_s.shape[0] != S.shape[axis] or rec_s.shape[0] != rec_s.shape[1]:
        raise ParameterError("Invalid self-similarity matrix shape "
                             f"rec.shape={rec_s.shape} for S.shape={S.shape}")
    Sw = S.swapaxes(0, axis)
    if aggregate in (np.mean, np.average):
        W = rec_s.T.tocsr().astype(np.float64)
        if aggregate is np.mean:
            W = W.copy()
            W.data[:] = 1.0
        row_sums = np.asarray(W.sum(axis=1)).ravel()
        flat = Sw.reshape(Sw.shape[0], -1)
        out = W @ flat
        nonempty = row_sums > 0
        out[nonempty] /= row_sums[nonempty, None]
        out[~nonempty] = flat[~nonempty]
        return out.reshape(Sw.shape).astype(S.dtype).swapaxes(0, axis)
    s_out = np.empty_like(Sw)
    for i in range(rec_s.shape[1]):
        targets = rec_s.indices[rec_s.indptr[i]:rec_s.indptr[i + 1]]
        s_out[i] = aggregate(np.take(Sw, targets, axis=0), axis=0) if len(targets) else Sw[i]
    return s_out.swapaxes(0, axis)
