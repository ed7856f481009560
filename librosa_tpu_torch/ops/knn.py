"""The ``m`` nearest corpus rows of each query row, by one distance product per block.

For the euclidean metrics the squared distance is ``|x|^2 + |y|^2 - 2 x.y``
and for cosine ``1 - x.y`` of unit rows, so each block of query rows costs
one matrix product against the corpus, in full float32 (``exact_f32``; a
TF32 product would change which neighbours are chosen), then a stable sort
of each row. Both run on the card; the centring and the normalisation of
the rows are float32 numpy on the host, as in the JAX package
(``librosa_tpu/ops/knn.py:87-153``), so both sides multiply the same
matrices.

Ties keep the lowest index (``torch.sort(stable=True)``, as
``lax.sort(is_stable=True)``). Query blocks of ``block`` rows keep the
distance tile at ``block x t``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from .._device import exact_f32, get_device

__all__ = ["DEVICE_METRICS", "topm"]

# metrics whose pairwise distance is one matrix product
DEVICE_METRICS = frozenset({"euclidean", "l2", "sqeuclidean", "cosine"})


def _host_f32(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype=np.float32)


def _topm_block(Xb: torch.Tensor, Y: torch.Tensor, y_sq: Optional[torch.Tensor], start: int, *,
                m: int, exclude_self: bool, take_sqrt: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distances of the query rows ``Xb`` (from row ``start``) to every corpus row, sorted: the first ``m``."""
    with exact_f32():
        cross = Xb @ Y.T
    if y_sq is None:  # cosine, of unit rows
        dist = 1.0 - cross
    else:
        x_sq = (Xb * Xb).sum(dim=1, keepdim=True)
        dist = (x_sq + y_sq[None, :] - 2.0 * cross).clamp_min(0.0)
        if take_sqrt:
            dist = dist.sqrt()
    if exclude_self:
        rows = torch.arange(Xb.shape[0], device=dist.device)
        cols = rows + start
        keep = cols < dist.shape[1]
        dist[rows[keep], cols[keep]] = torch.inf
    d_sorted, i_sorted = torch.sort(dist, dim=1, stable=True)
    return d_sorted[:, :m], i_sorted[:, :m]


def topm(queries: Any, corpus: Any, m: int, *, metric: str = "euclidean",
         exclude_self: bool = False, block: int = 4096,
         device: Any = None) -> Tuple[np.ndarray, np.ndarray]:
    """For each query row ``(n, d)``, the ``m`` nearest corpus rows ``(t, d)``.

    Returns ``(dist, idx)``, host float32 and int32 arrays ``(n, min(m, t))``,
    in rising order of distance. ``metric`` is one of :data:`DEVICE_METRICS`;
    ``exclude_self`` gives query row ``i`` an infinite distance to corpus
    row ``i``. The search runs on ``device``: by default the device of
    ``queries`` where it is a tensor, else the package default.
    """
    if metric not in DEVICE_METRICS:
        raise ValueError(f"metric={metric!r} has no device kernel")
    if device is None:
        device = queries.device if isinstance(queries, torch.Tensor) else get_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("topm's device is 'cuda' but CUDA is not available; call "
                           "librosa_tpu_torch.set_device('cpu') or pass device='cpu'")
    X, Y = _host_f32(queries), _host_f32(corpus)
    n, t = X.shape[0], Y.shape[0]
    m = int(min(m, t))
    if metric == "cosine":
        # as sklearn: a zero row stays zero, at distance 1 from everything
        X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-30)
        Y = Y / np.maximum(np.linalg.norm(Y, axis=1, keepdims=True), 1e-30)
        y_sq = None
    else:
        # centring on the corpus mean leaves distances alone and tames the float32 cancellation
        mu = Y.mean(axis=0, keepdims=True)
        X = X - mu
        Y = Y - mu
        y_sq = torch.from_numpy(np.sum(Y * Y, axis=1).astype(np.float32)).to(device)
    Yd = torch.from_numpy(Y).to(device)
    Xd = torch.from_numpy(np.ascontiguousarray(X)).to(device)
    b = int(min(block, max(n, 1)))
    dists = np.empty((n, m), dtype=np.float32)
    idxs = np.empty((n, m), dtype=np.int32)
    for start in range(0, n, b):
        stop = min(start + b, n)
        d_blk, i_blk = _topm_block(Xd[start:stop], Yd, y_sq, start, m=m,
                                   exclude_self=exclude_self,
                                   take_sqrt=metric in ("euclidean", "l2"))
        dists[start:stop] = d_blk.cpu().numpy()
        idxs[start:stop] = i_blk.cpu().numpy()
    return dists, idxs
