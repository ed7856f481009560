"""Recurrence and cross-similarity graphs of feature sequences, the time-lag shears,
clustering into segments, and path enhancement.

Where each part runs, as in the JAX package (``librosa_tpu/segment.py``):

- the nearest-neighbour search for the metrics of
  :data:`~librosa_tpu_torch.ops.knn.DEVICE_METRICS` runs on the card
  (:func:`~librosa_tpu_torch.ops.knn.topm`: one float32 distance product and
  a stable sort per block of frames), on the device of a tensor input or
  the package default;
- everything after it is float64 numpy and ``scipy.sparse`` on the host:
  the band exclusion and the pruning to ``k`` links a frame on the
  candidate arrays, the graph's assembly, the bandwidth estimators and the
  affinity ``exp(-d / bandwidth)``;
- other metrics search with sklearn's ``NearestNeighbors`` on the host;
- :func:`recurrence_to_lag` and :func:`lag_to_recurrence` shear on the
  host, dense by one modular gather, sparse by remapping coordinates;
  :func:`timelag_filter` runs a host filter between the two;
- :func:`agglomerative` and :func:`subsegment` cluster on the host with
  sklearn's Ward clustering (a tensor comes to the host first);
- :func:`path_enhance` convolves on the device of its input: one
  symmetric pad, then one ``conv2d`` with a filter per output channel
  (exact float32) and the maximum over channels.

The graphs come back as the JAX package returns them: a dense numpy array,
or with ``sparse=True`` a ``scipy.sparse.csc_matrix``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import numpy as np
import scipy.sparse
import torch
import torch.nn.functional as F

from ._device import as_tensor, exact_f32, get_device
from .filters import diagonal_filter
from .ops import knn as _knn
from .util.exceptions import ParameterError
from .util.utils import _host, _periodic_index, fix_frames

__all__ = ["cross_similarity", "recurrence_matrix", "recurrence_to_lag", "lag_to_recurrence",
           "timelag_filter", "subsegment", "agglomerative", "path_enhance"]

_BANDWIDTH_MODES = ("med_k_scalar", "mean_k", "gmean_k", "mean_k_avg", "gmean_k_avg",
                    "mean_k_avg_and_pair")


def _host_and_device(data: Any):
    """``data`` as a host array, and the device its neighbour search runs on."""
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy(), data.device
    return np.asarray(data), get_device()


def _affinity_bandwidth(rec, bw_mode: Any, k: int):
    """The bandwidth of each link of the CSR distance graph ``rec`` (or one for all).

    A positive number or an array of ``rec``'s shape is taken as given. The
    estimators read each row's ``k`` nearest links: ``med_k_scalar`` the
    median over rows of the distance to the k-th, ``mean_k`` / ``gmean_k``
    the arithmetic / geometric mean of the two ends' k-th distances,
    ``mean_k_avg`` / ``gmean_k_avg`` the same of the ends' mean distances
    over their k, and ``mean_k_avg_and_pair`` the mean of those two and the
    link's own distance.
    """
    if isinstance(bw_mode, np.ndarray):
        if bw_mode.shape != rec.shape:
            raise ParameterError(f"Invalid matrix bandwidth shape: {bw_mode.shape}."
                                 f"Should be {rec.shape}.")
        if (bw_mode <= 0).any():
            raise ParameterError("Invalid bandwidth. All entries must be strictly positive.")
        return np.array(bw_mode[rec.nonzero()])
    if isinstance(bw_mode, (int, float)):
        if float(bw_mode) <= 0:
            raise ParameterError(f"Invalid scalar bandwidth={float(bw_mode)}. "
                                 "Must be strictly positive.")
        return float(bw_mode)

    mode = "med_k_scalar" if bw_mode is None else bw_mode
    if mode not in _BANDWIDTH_MODES:
        raise ParameterError(f"Invalid bandwidth='{mode}'. Must be either a positive scalar "
                             f"or one of {list(_BANDWIDTH_MODES)}")
    n = rec.shape[0]
    counts = np.diff(rec.indptr)
    empty_rows = np.flatnonzero(counts == 0)
    if empty_rows.size and mode != "med_k_scalar":
        raise ParameterError(f"The sample at time point {empty_rows[0]} has no neighbors")

    # each row's distances in rising order, its first k kept
    row_of = np.repeat(np.arange(n), counts)
    by_row_asc = rec.data[np.lexsort((rec.data, row_of))]
    rank_in_row = np.arange(len(row_of)) - np.repeat(rec.indptr[:-1], counts)
    kept = by_row_asc[rank_in_row < k]
    kept_counts = np.minimum(counts, k)
    kept_ends = np.cumsum(kept_counts)

    dist_to_k = np.full(n, np.nan)
    nonempty = counts > 0
    dist_to_k[nonempty] = kept[kept_ends[nonempty] - 1]
    if mode == "med_k_scalar":
        if not np.any(np.isfinite(dist_to_k)):
            raise ParameterError("Cannot estimate bandwidth from an empty graph")
        return float(np.nanmedian(dist_to_k))

    if mode in ("mean_k", "gmean_k"):
        per_row = dist_to_k
    else:
        per_row = np.add.reduceat(kept, kept_ends - kept_counts) / kept_counts
    sigma_out = per_row[row_of]
    sigma_in = per_row[rec.indices]
    if mode in ("gmean_k", "gmean_k_avg"):
        return np.array((sigma_out * sigma_in) ** 0.5)
    if mode == "mean_k_avg_and_pair":
        return np.array((sigma_out + sigma_in + rec.data) / 3)
    return np.array((sigma_out + sigma_in) / 2)


def _knn_graph(data_fit: np.ndarray, k_neighbors: int, metric: str, mode: str,
               X: Optional[np.ndarray] = None):
    """sklearn's k-nearest-neighbour graph as LIL, for the metrics the card has no route for."""
    import sklearn.neighbors

    try:
        knn = sklearn.neighbors.NearestNeighbors(n_neighbors=k_neighbors, metric=metric,
                                                 algorithm="auto")
    except ValueError:
        knn = sklearn.neighbors.NearestNeighbors(n_neighbors=k_neighbors, metric=metric,
                                                 algorithm="brute")
    knn.fit(data_fit)
    if X is None:
        return knn.kneighbors_graph(mode=mode).tolil()
    return knn.kneighbors_graph(X=X, mode=mode).tolil()


def _topk_prune(g, n_rows: int, k: int) -> None:
    """Keep the ``k`` smallest links of each row of the LIL graph ``g`` (the sklearn route)."""
    for i in range(n_rows):
        links = g.rows[i]
        if len(links) <= k:
            continue
        order = np.argsort(np.array(g.data[i]))
        for j in np.array(links)[order[k:]]:
            g[i, j] = 0


def _graph_from_candidates(dist: np.ndarray, idx: np.ndarray, n_cols: int, *, mode: str,
                           k: Optional[int] = None, width: int = 0):
    """The LIL graph ``(n, n_cols)`` of the candidates ``(n, m)``, sorted by rising distance.

    With ``k`` None every candidate is a link. Otherwise candidates with
    ``|i - j| < width`` go, then each row keeps ``k``: the nearest in the
    distance modes, the lowest column indices in connectivity mode (where
    every weight is 1).
    """
    n, m = idx.shape
    if k is None:
        rows = np.repeat(np.arange(n), m)
        cols = idx.ravel()
        vals = np.ones(cols.size) if mode == "connectivity" else dist.ravel().astype(np.float64)
    else:
        valid = np.abs(idx - np.arange(n)[:, None]) >= width
        if mode == "connectivity":
            cand = np.sort(np.where(valid, idx, n_cols), axis=1)[:, :k]  # n_cols: no link
            keep = cand < n_cols
            rows = np.repeat(np.arange(n), cand.shape[1])[keep.ravel()]
            cols = cand[keep]
            vals = np.ones(cols.size)
        else:
            keep = valid & (np.cumsum(valid, axis=1) <= k)
            rows = np.nonzero(keep)[0]
            cols = idx[keep]
            vals = dist[keep].astype(np.float64)
    return scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n, n_cols)).tolil()


def _flatten_time_major(x: np.ndarray, axis: int):
    """``x`` as a ``(steps, features)`` matrix with ``axis`` first, and its number of steps."""
    x = np.swapaxes(x, axis, 0)
    steps = x.shape[0]
    return x.reshape((steps, -1), order="F"), steps


def _check_rec_mode(mode: str) -> None:
    if mode not in ("connectivity", "distance", "affinity"):
        raise ParameterError(f"unknown similarity mode {mode!r}; choose connectivity, "
                             "distance, or affinity")


def _finalize_graph(g, mode: str, bandwidth: Any, bandwidth_k: int, sparse: bool, *,
                    clamp_negative: bool = False):
    """CSR without stored zeros, the mode's weights, then transposed so that time runs along columns."""
    g = g.tocsr()
    g.eliminate_zeros()
    if mode == "connectivity":
        g = g.astype(bool)
    elif mode == "affinity":
        if clamp_negative:
            g.data[g.data < 0] = 0.0
        scale = _affinity_bandwidth(g, bandwidth, bandwidth_k)
        g.data[:] = np.exp(g.data / (-1 * scale))
    g = scipy.sparse.csc_matrix(g.T)
    return g if sparse else g.toarray()


def cross_similarity(data: Any, data_ref: Any, *, k: Optional[int] = None,
                     metric: str = "euclidean", sparse: bool = False,
                     mode: str = "connectivity", bandwidth: Any = None, full: bool = False):
    """Cross-similarity ``(n_ref, n)`` of ``data`` ``(..., d, n)`` against ``data_ref`` ``(..., d, n_ref)``.

    Each frame of ``data`` links to its ``k`` nearest frames of
    ``data_ref`` (``k`` defaults to ``min(n_ref, 2 ceil(sqrt(n_ref)))``);
    ``metric``, ``mode``, ``bandwidth``, ``sparse`` and ``full`` are as in
    :func:`recurrence_matrix`.
    """
    ref_host, device = _host_and_device(data_ref)
    data_host, _ = _host_and_device(data)
    data_ref = np.atleast_2d(ref_host)
    data = np.atleast_2d(data_host)
    if data_ref.shape[:-1] != data.shape[:-1]:
        raise ParameterError(f"the two sequences must agree on every non-time axis: "
                             f"data_ref is {data_ref.shape}, data is {data.shape}")
    _check_rec_mode(mode)
    data_ref, n_ref = _flatten_time_major(data_ref, -1)
    data, n = _flatten_time_major(data, -1)
    if k is None:
        k = min(n_ref, 2 * np.ceil(np.sqrt(n_ref)))
    k = int(k)
    bandwidth_k = k
    if full and mode != "connectivity":
        k = n

    kng_mode = "distance" if mode == "affinity" else mode
    if metric in _knn.DEVICE_METRICS:
        dist_c, idx_c = _knn.topm(data, data_ref, min(n_ref, k), metric=metric,
                                  exclude_self=False, device=device)
        # at most k candidates a row: no pruning left to do
        xsim = _graph_from_candidates(dist_c, idx_c, n_ref, mode=kng_mode)
    else:
        xsim = _knn_graph(data_ref, min(n_ref, k), metric, kng_mode, X=data)
        if not full:
            _topk_prune(xsim, n, k)
    return _finalize_graph(xsim, mode, bandwidth, bandwidth_k, sparse)


def recurrence_matrix(data: Any, *, k: Optional[int] = None, width: int = 1,
                      metric: str = "euclidean", sym: bool = False, sparse: bool = False,
                      mode: str = "connectivity", bandwidth: Any = None, self: bool = False,
                      axis: int = -1, full: bool = False):
    """Recurrence matrix ``(n, n)`` of the frames of ``data`` ``(..., d, n)`` along ``axis``.

    Frame ``j`` links to its ``k`` nearest frames ``i`` with ``|i - j| >=
    width`` (``k`` defaults to ``2 ceil(sqrt(n - 2 width + 1))``); column
    ``j`` holds frame ``j``'s links. ``mode`` weighs a link 1
    (``'connectivity'``), by its distance (``'distance'``) or by
    ``exp(-distance / bandwidth)`` (``'affinity'``; ``bandwidth`` a positive
    number, an ``(n, n)`` array or an estimator, see
    ``_affinity_bandwidth``). ``sym`` keeps mutual links only, ``self``
    links each frame to itself (affinity 1), ``full`` keeps every link of
    the search (all frames in the distance modes). ``sparse`` returns a
    ``scipy.sparse.csc_matrix``, else a dense numpy array.
    """
    data_host, device = _host_and_device(data)
    data, t = _flatten_time_major(np.atleast_2d(data_host), axis)
    if not 1 <= width < (t - 1) // 2:
        raise ParameterError(f"the excluded diagonal band must satisfy "
                             f"1 <= width < {(t - 1) // 2} for {t} frames; got width={width}")
    _check_rec_mode(mode)
    if k is None:
        k = 2 * np.ceil(np.sqrt(t - 2 * width + 1))
    k = int(k)
    bandwidth_k = k
    if full and mode != "connectivity":
        k = t

    kng_mode = "distance" if mode == "affinity" else mode
    if metric in _knn.DEVICE_METRICS:
        dist_c, idx_c = _knn.topm(data, data, min(t - 1, k + 2 * width), metric=metric,
                                  exclude_self=True, device=device)
        rec = _graph_from_candidates(dist_c, idx_c, t, mode=kng_mode,
                                     k=None if full else k, width=width)
    else:
        rec = _knn_graph(data, min(t - 1, k + 2 * width), metric, kng_mode)
        if not full:
            for diag in range(-width + 1, width):
                rec.setdiag(0, diag)
            _topk_prune(rec, t, k)

    if self:
        if mode == "connectivity":
            rec.setdiag(1)
        elif mode == "affinity":
            # -1 keeps the link through the zero elimination and out of the bandwidth
            # statistics; it becomes distance 0, affinity 1
            rec.setdiag(-1)
    else:
        rec.setdiag(0)
    if sym:
        rec = rec.minimum(rec.T)
    return _finalize_graph(rec, mode, bandwidth, bandwidth_k, sparse, clamp_negative=True)


def _shear_dense_np(X: np.ndarray, factor: int, axis: int) -> np.ndarray:
    """Dense shear on the host: ``axis=0`` rolls row ``i`` by ``factor * i``, any other axis column ``j``."""
    X = np.asarray(X)
    n0, n1 = X.shape
    if axis == 0:
        src = (np.arange(n1)[None, :] - factor * np.arange(n0)[:, None]) % n1
        return np.take_along_axis(X, src, axis=1)
    src = (np.arange(n0)[:, None] - factor * np.arange(n1)[None, :]) % n0
    return np.take_along_axis(X, src, axis=0)


def _shear_sparse(X, factor: int, axis: int):
    """Sparse shear by remapping coordinates, in ``X``'s format (axes as :func:`_shear_dense_np`)."""
    coo = X.tocoo()
    if axis == 0:
        rows = coo.row
        cols = np.mod(coo.col + factor * coo.row, X.shape[1])
    else:
        rows = np.mod(coo.row + factor * coo.col, X.shape[0])
        cols = coo.col
    return scipy.sparse.coo_matrix((coo.data, (rows, cols)), shape=X.shape).asformat(X.format)


def _host_matrix(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x if scipy.sparse.issparse(x) else np.asarray(x)


def recurrence_to_lag(rec: Any, *, pad: bool = True, axis: int = -1):
    """The time-lag matrix of the square recurrence matrix ``rec``: ``(2n, n)`` with ``pad``, else ``(n, n)``.

    Column ``t`` (``axis=-1``) holds frame ``t``'s links by lag, so that a
    diagonal of ``rec`` becomes a row; ``pad`` gives negative lags a half of
    their own. A dense input gives a numpy array, a sparse one a matrix of
    its format.
    """
    axis = int(np.abs(axis))
    rec = _host_matrix(rec)
    if rec.ndim != 2 or rec.shape[0] != rec.shape[1]:
        raise ParameterError(f"recurrence matrices are square; got shape {rec.shape}")
    if scipy.sparse.issparse(rec):
        fmt_in = rec.format
        if pad:
            blank = scipy.sparse.coo_matrix((rec.shape[axis],) * 2, dtype=rec.dtype)
            if axis == 0:
                rec = scipy.sparse.hstack([rec, blank], format="csr")
            else:
                rec = scipy.sparse.vstack([rec, blank], format="csc")
        return _shear_sparse(rec, -1, axis).asformat(fmt_in)
    if pad:
        rec = np.concatenate([rec, np.zeros_like(rec)], axis=1 - axis)
    return _shear_dense_np(rec, -1, axis)


def lag_to_recurrence(lag: Any, *, axis: int = -1):
    """The recurrence matrix ``(n, n)`` of a lag matrix, padded ``(2n, n)`` or not: :func:`recurrence_to_lag` undone."""
    if axis not in (0, 1, -1):
        raise ParameterError(f"a 2-D lag matrix has no axis {axis}")
    axis = int(np.abs(axis))
    lag = _host_matrix(lag)
    t = lag.shape[axis] if lag.ndim == 2 else -1
    lag_extent = lag.shape[1 - axis] if lag.ndim == 2 else -1
    if lag.ndim != 2 or lag_extent not in (t, 2 * t):
        raise ParameterError(f"lag matrices are (n, n) or zero-padded to (2n, n); "
                             f"got shape {getattr(lag, 'shape', None)}")
    keep = [slice(None), slice(None)]
    keep[1 - axis] = slice(t)
    if scipy.sparse.issparse(lag):
        return _shear_sparse(lag, 1, axis).tocsr()[tuple(keep)].asformat(lag.format)
    return _shear_dense_np(lag, 1, axis)[tuple(keep)]


def timelag_filter(function: Callable, pad: bool = True, index: int = 0) -> Callable:
    """``function`` lifted to the time-lag domain.

    The wrapped function shears its ``index``-th argument with
    :func:`recurrence_to_lag` (``pad`` passed on), applies ``function``
    there, where repeated structure lies along rows, and shears the result
    back with :func:`lag_to_recurrence`.
    """

    @functools.wraps(function)
    def _wrapped(*args: Any, **kwargs: Any):
        args = list(args)
        args[index] = recurrence_to_lag(args[index], pad=pad)
        return lag_to_recurrence(function(*args, **kwargs))

    return _wrapped


def subsegment(data: Any, frames: Any, *, n_segments: int = 4, axis: int = -1) -> np.ndarray:
    """Each segment between the boundary ``frames`` split by :func:`agglomerative` into at most
    ``n_segments`` pieces; the boundaries of all pieces, as a numpy int array."""
    if n_segments < 1:
        raise ParameterError(f"cannot split a segment into n_segments={n_segments} pieces")
    data = _host(data)
    fences = fix_frames(frames, x_min=0, x_max=data.shape[axis], pad=True)

    def _split_one(lo: int, hi: int) -> np.ndarray:
        window = [slice(None)] * data.ndim
        window[axis] = slice(lo, hi)
        return lo + agglomerative(data[tuple(window)], min(hi - lo, n_segments), axis=axis)

    pieces = [_split_one(lo, hi) for lo, hi in zip(fences[:-1], fences[1:])]
    if not pieces:
        return np.array([], dtype=int)
    return np.concatenate(pieces)


def agglomerative(data: Any, k: int, *, clusterer: Optional[Any] = None,
                  axis: int = -1) -> np.ndarray:
    """The first frame of each of ``k`` segments, by Ward clustering of the frames along
    ``axis`` under a time-adjacency constraint (or by ``clusterer``), on the host.

    A frame may merge only with its neighbours in time, so every cluster is
    a run of frames; the boundaries are where the label changes, after a
    leading 0.
    """
    feats = np.swapaxes(np.atleast_2d(_host(data)), axis, 0)
    n = feats.shape[0]
    feats = feats.reshape((n, -1), order="F")
    if clusterer is None:
        import sklearn.cluster

        chain = scipy.sparse.diags([np.ones(n - 1), np.ones(n), np.ones(n - 1)],
                                   offsets=(-1, 0, 1), format="coo")
        clusterer = sklearn.cluster.AgglomerativeClustering(n_clusters=int(k),
                                                            connectivity=chain)
    clusterer.fit(feats)
    flips = np.flatnonzero(np.diff(clusterer.labels_)) + 1
    return np.concatenate(([0], flips.astype(int)))


def path_enhance(R: Any, n: int, *, window: Any = "hann", max_ratio: float = 2.0,
                 min_ratio: Optional[float] = None, n_filters: int = 7, zero_mean: bool = False,
                 clip: bool = True, **kwargs: Any) -> torch.Tensor:
    """``R`` smoothed along paths of ``n_filters`` slopes from ``min_ratio`` (default
    ``1 / max_ratio``) to ``max_ratio``: the elementwise maximum of its convolutions with
    :func:`~librosa_tpu_torch.filters.diagonal_filter` of length ``n`` at each slope,
    clipped at 0 with ``clip``.

    As ``scipy.ndimage.convolve(mode='reflect')`` (the edge sample
    repeated), on the last two axes of ``R`` in float32, leading axes
    kept; ``kwargs`` are accepted for the signature's sake and unused, as
    in the JAX package.
    """
    if min_ratio is None:
        min_ratio = 1.0 / max_ratio
    elif min_ratio > max_ratio:
        raise ParameterError(f"min_ratio={min_ratio} cannot exceed max_ratio={max_ratio}")
    R = as_tensor(R).to(torch.float32)
    ratios = np.logspace(np.log2(min_ratio), np.log2(max_ratio), num=n_filters, base=2)
    # flipped, so that conv2d's cross-correlation is the true convolution
    kernels = [torch.from_numpy(np.ascontiguousarray(
        diagonal_filter(window, n, slope=ratio, zero_mean=zero_mean)[::-1, ::-1]
        .astype(np.float32))).to(R.device) for ratio in ratios]
    return _path_enhance_core(R, kernels, clip=bool(clip))


def _shared_pads(kernels: list) -> tuple:
    """``(top, bottom, left, right)``: the largest of the kernels' symmetric pads
    ``((k - 1) // 2, k // 2)`` on each axis."""
    return (max((k.shape[0] - 1) // 2 for k in kernels), max(k.shape[0] // 2 for k in kernels),
            max((k.shape[1] - 1) // 2 for k in kernels), max(k.shape[1] // 2 for k in kernels))


def _shared_pad(R: torch.Tensor, pads: tuple) -> torch.Tensor:
    """``R`` as ``(N, 1, h, w)``, padded symmetrically (the edge repeated) by ``pads``."""
    top, bottom, left, right = pads
    h, w = R.shape[-2:]
    return (R.reshape(-1, 1, h, w)
            .index_select(-2, _periodic_index(h, top, bottom, "symmetric", R.device))
            .index_select(-1, _periodic_index(w, left, right, "symmetric", R.device)))


def _kernel_frame(kernels: list, pads: tuple) -> torch.Tensor:
    """The kernels zero-embedded in one ``(len, 1, top + bottom + 1, left + right + 1)``
    frame, each where its own pad within ``pads`` puts it."""
    top, bottom, left, right = pads
    frame = kernels[0].new_zeros((len(kernels), 1, top + bottom + 1, left + right + 1))
    for i, k in enumerate(kernels):
        r0, c0 = top - (k.shape[0] - 1) // 2, left - (k.shape[1] - 1) // 2
        frame[i, 0, r0:r0 + k.shape[0], c0:c0 + k.shape[1]] = k
    return frame


def _path_enhance_core(R: torch.Tensor, kernels: list, *, clip: bool) -> torch.Tensor:
    """The maximum over ``kernels`` of ``R``'s cross-correlations, each over its own
    symmetric pad ``((k - 1) // 2, k // 2)`` a side, ``R`` finite.

    ``R`` is padded once by the largest pad of each axis (a symmetric pad
    by ``p`` lies inside the one by any wider pad), and the kernels are
    set in one frame of the largest extent, each where its own pad puts
    it: one ``conv2d`` then computes every filter as an output channel.
    The zeros around a smaller kernel add exact zeros, so each channel
    equals that kernel's own convolution bit for bit; one call with seven
    channels took 139.6 ms where seven single-channel calls took 1048.3 ms
    on ``(2, 8193, 8193)`` (``diagnostics/path_enhance_routes.py``, NVIDIA
    H100 80GB HBM3, 700.00 W).
    """
    pads = _shared_pads(kernels)
    with exact_f32():
        out = F.conv2d(_shared_pad(R, pads), _kernel_frame(kernels, pads)).amax(dim=1)
    out = out.reshape(R.shape)
    return out.clamp_min(0) if clip else out
