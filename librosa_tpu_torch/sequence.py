"""Alignment (DTW), recurrence quantification (RQA), Viterbi decoding and HMM transitions.

The decoders take observation probabilities ``(..., n_states, n_steps)`` on
any device, form log probabilities there and decode with
:func:`..ops.viterbi.viterbi_decode`: on the card the max-plus kernel
``csrc/viterbi.cu`` (float32, at most 16384 states; a call it refuses
raises); on the CPU its plain PyTorch version. Float64 input decodes in
float64 with the plain version, anything else in float32. The transition
matrices and the checks of the distributions are float64 numpy on the host,
as in the JAX package.

:func:`dtw` builds the cost matrix of ``X`` and ``Y`` on their device in
float64 (``torch.cdist`` for the Minkowski metrics, the direct formula for
``sqeuclidean`` and ``cosine``; scipy's ``cdist`` on the host for any other
metric). Its accumulation and backtracking, :func:`rqa`'s dynamic program
over anti-diagonals and :func:`path_to_steps` are float64 numpy on the
host, as in the JAX package: given the same cost or similarity matrix they
give its ``D``, ``steps``, ``score`` and paths to the bit.
"""

from __future__ import annotations

import hashlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ._device import as_tensor, device_table
from .filters import get_window
from .ops import viterbi as _viterbi
from .util.exceptions import ParameterError
from .util.utils import _host, fill_off_diagonal, is_positive_int, tiny

__all__ = ["dtw", "dtw_backtracking", "rqa", "path_to_steps", "viterbi",
           "viterbi_discriminative", "viterbi_binary", "transition_uniform", "transition_loop",
           "transition_cycle", "transition_local"]


# ---------------------------------------------------------------------------
# DTW
# ---------------------------------------------------------------------------

# a finite stand-in for an infinite cost, so that the prefix sums of a row stay free of NaN
_BIG = 1e30


def _unblocked_runs(blocked: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Starts and (exclusive) ends of the runs of False in ``blocked``."""
    edges = np.diff(np.concatenate(([True], blocked, [True])).astype(np.int8))
    return np.flatnonzero(edges == -1), np.flatnonzero(edges == 1)


def _dtw_accumulate(C: np.ndarray, steps_sigma: np.ndarray, w_mul: np.ndarray,
                    w_add: np.ndarray, subseq: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Accumulated cost ``D[i, j] = min_s D[i - s0, j - s1] + w_mul[s] C[i, j] + w_add[s]`` and the step taken.

    Row by row on the host. The first row and column default to steps 1 and
    2. A step with an infinite weight is off. The steps within a row
    (``s0 == 0``, ``s1 == 1``) form the running minimum ``v[j] = min(v[j],
    v[j - 1] + c[j])``, solved for each run of cells between blocked
    (infinite-cost) cells by prefix sums: ``v[j] = min_{k < j}(v[k] - P[k])
    + P[j]``. Runs are found with numpy, one pass a row.
    """
    N, M = C.shape
    C = np.minimum(C, _BIG)
    D = np.full((N, M), _BIG)
    steps = np.zeros((N, M), dtype=np.int32)
    steps[0, :] = 1
    steps[:, 0] = 2
    enabled = [bool(np.isfinite(w_mul[s]) and np.isfinite(w_add[s]))
               for s in range(len(steps_sigma))]
    row_steps = [(s, int(steps_sigma[s, 1])) for s in range(len(steps_sigma))
                 if steps_sigma[s, 0] == 0 and enabled[s]]
    col_steps = [s for s in range(len(steps_sigma)) if steps_sigma[s, 0] > 0 and enabled[s]]
    init_row0 = np.full(M, _BIG)
    init_row0[0] = C[0, 0]
    if subseq:
        init_row0[:] = C[0, :]

    for i in range(N):
        value = init_row0.copy() if i == 0 else np.full(M, _BIG)
        for s in col_steps:
            s0, s1 = int(steps_sigma[s, 0]), int(steps_sigma[s, 1])
            if i - s0 < 0:
                continue
            prev = D[i - s0]
            if s1 == 0:
                cand = prev + w_mul[s] * C[i] + w_add[s]
            else:
                cand = np.full(M, _BIG)
                cand[s1:] = prev[:-s1] + w_mul[s] * C[i, s1:] + w_add[s]
            better = cand < value
            value[better] = cand[better]
            steps[i][better] = s
        for s, s1 in row_steps:
            c = w_mul[s] * C[i] + w_add[s]
            if s1 == 1:
                # a chain cannot pass a blocked cell, and prefix sums across one lose precision
                new_value = np.full(M, _BIG)
                for a, b in zip(*_unblocked_runs(c >= 1e20)):
                    P = np.cumsum(c[a:b])
                    E = np.minimum.accumulate(value[a:b] - P)
                    # sources k <= j - 1 only: k = j would re-derive value[j] through
                    # P[j] - P[j] and could label the cell a row step by one ulp
                    new_value[a + 1:b] = E[:-1] + P[1:]
                changed = new_value < value  # strict: the earlier step keeps a tie
                value = np.minimum(value, new_value)
                steps[i][changed] = s
            else:
                for j in range(s1, M):
                    cand_j = value[j - s1] + c[j]
                    if cand_j < value[j]:
                        value[j] = cand_j
                        steps[i, j] = s
        D[i] = value
    D[D >= _BIG * 1e-6] = np.inf
    return D, steps


def dtw_backtracking(steps: np.ndarray, step_sizes_sigma: Optional[np.ndarray] = None,
                     subseq: bool = False, start: Optional[int] = None) -> List[Tuple[int, int]]:
    """The warping path, from the last cell (column ``start`` of the last row) back, by the steps taken.

    ``steps`` is :func:`dtw`'s step matrix (``return_steps=True``) and
    ``step_sizes_sigma`` its step set (default diagonal, right, down). The
    path ends at ``(0, 0)``, or with ``subseq`` at the first row.
    """
    if step_sizes_sigma is None:
        step_sizes_sigma = np.array([[1, 1], [0, 1], [1, 0]], dtype=np.uint32)
    steps = _host(steps)
    cur = (steps.shape[0] - 1, steps.shape[1] - 1 if start is None else start)
    wp = [cur]
    while (subseq and cur[0] > 0) or (not subseq and cur != (0, 0)):
        step = step_sizes_sigma[steps[cur]]
        cur = (cur[0] - int(step[0]), cur[1] - int(step[1]))
        if min(cur) < 0:
            break
        wp.append(cur)
    return wp


def _resolve_step_set(user_steps: Optional[np.ndarray], weights_add: Optional[np.ndarray],
                      weights_mul: Optional[np.ndarray]):
    """The step set with its weights: diagonal, right and down, then the caller's steps.

    With steps of the caller's the first three are off (infinite weights).
    """
    canonical = np.array([[1, 1], [0, 1], [1, 0]], dtype=np.uint32)
    if user_steps is None:
        steps = canonical
        add_w = np.zeros(3) if weights_add is None else weights_add
        mul_w = np.ones(3) if weights_mul is None else weights_mul
    else:
        n_user = len(user_steps)
        steps = np.concatenate((canonical, user_steps))
        barred = np.full(3, np.inf)
        add_w = np.concatenate((barred, np.zeros(n_user) if weights_add is None else weights_add))
        mul_w = np.concatenate((barred, np.ones(n_user) if weights_mul is None else weights_mul))
    if np.any(steps < 0):
        raise ParameterError("DTW steps must move forward (no negatives)")
    if not len(steps) == len(add_w) == len(mul_w):
        raise ParameterError(f"every step needs one additive and one multiplicative weight: "
                             f"{len(steps)} steps, {len(add_w)} additive, "
                             f"{len(mul_w)} multiplicative")
    return steps, np.asarray(add_w, dtype=np.float64), np.asarray(mul_w, dtype=np.float64)


def _time_major(x: torch.Tensor) -> torch.Tensor:
    """``(..., d, n)`` features as an ``(n, features)`` matrix, the features in Fortran order."""
    x = torch.atleast_2d(x).swapaxes(-1, 0)
    return x.permute(0, *range(x.ndim - 1, 0, -1)).reshape(x.shape[0], -1)


_MINKOWSKI_P = {"euclidean": 2.0, "cityblock": 1.0, "chebyshev": float("inf")}


def _cost_matrix(X: torch.Tensor, Y: torch.Tensor, metric: str) -> np.ndarray:
    """Pairwise distances of the rows of ``X`` and ``Y`` in float64: on their device, or scipy's."""
    if metric in _MINKOWSKI_P or metric == "sqeuclidean":
        C = torch.cdist(X, Y, p=_MINKOWSKI_P.get(metric, 2.0),
                        compute_mode="donot_use_mm_for_euclid_dist")
        C = C * C if metric == "sqeuclidean" else C
    elif metric == "cosine":
        C = 1.0 - (X @ Y.T) / (torch.linalg.vector_norm(X, dim=1)[:, None]
                               * torch.linalg.vector_norm(Y, dim=1)[None, :])
    else:
        from scipy.spatial.distance import cdist

        return cdist(X.cpu().numpy(), Y.cpu().numpy(), metric=metric)
    return C.cpu().numpy()


def dtw(X: Any = None, Y: Any = None, *, C: Any = None, metric: str = "euclidean",
        step_sizes_sigma: Optional[np.ndarray] = None, weights_add: Optional[np.ndarray] = None,
        weights_mul: Optional[np.ndarray] = None, subseq: bool = False, backtrack: bool = True,
        global_constraints: bool = False, band_rad: float = 0.25, return_steps: bool = False):
    """Dynamic time warping of ``X`` ``(..., d, N)`` against ``Y`` ``(..., d, M)``, or of a cost ``C`` ``(N, M)``.

    Returns the accumulated cost ``D`` ``(N, M)`` (numpy float64), then the
    warping path ``wp`` ``(L, 2)`` from the end back (``backtrack``), then
    the step matrix (``return_steps``). The cost of ``X`` and ``Y`` is their
    ``metric`` distance: ``euclidean``, ``sqeuclidean``, ``cityblock``,
    ``chebyshev`` and ``cosine`` on their device in float64, any other of
    scipy's ``cdist`` on the host. ``step_sizes_sigma`` ``(n, 2)`` adds steps
    (with ``weights_add`` and ``weights_mul``) that replace diagonal, right
    and down; ``subseq`` aligns ``X`` anywhere within ``Y`` (the shorter
    sequence goes first); ``global_constraints`` confines the path to a
    band of ``band_rad`` times the shorter side around the diagonal.
    """
    steps, add_w, mul_w = _resolve_step_set(step_sizes_sigma, weights_add, weights_mul)
    if C is None and (X is None or Y is None):
        raise ParameterError("without a precomputed cost matrix C, both feature sequences "
                             "X and Y are required")
    if C is not None and (X is not None or Y is not None):
        raise ParameterError("pass either a precomputed cost matrix C, or the feature "
                             "sequences X and Y — not both")
    own_cost = C is None
    flipped = False
    if own_cost:
        X = _time_major(as_tensor(X).to(torch.float64))
        Y = _time_major(as_tensor(Y).to(X.device, torch.float64))
        if X.shape[1] != Y.shape[1]:
            raise ParameterError("could not build a pairwise cost matrix from X/Y; shape "
                                 "them (d, N) and (d, M) (1-D sequences as (1, N))")
        C = _cost_matrix(X, Y, metric)
        if subseq and X.shape[0] > Y.shape[0]:
            C = C.T
            flipped = True
    C = np.atleast_2d(np.asarray(_host(C), dtype=np.float64))
    if C.shape[0] > C.shape[1] and np.array_equal(steps, np.array([[1, 1]])):
        raise ParameterError("pure diagonal matching needs the query no longer than the "
                             "target (C.shape[0] <= C.shape[1])")
    if np.isnan(C).any():
        raise ParameterError("the DTW cost matrix contains NaN entries")
    if global_constraints:
        if not own_cost:
            C = np.copy(C)
        fill_off_diagonal(C, radius=band_rad, value=np.inf)

    D, traceback_steps = _dtw_accumulate(C, steps, mul_w, add_w, subseq)
    outputs: List[np.ndarray] = [D]
    if backtrack:
        outputs.append(_dtw_best_path(D, traceback_steps, steps, subseq,
                                      undo_flip=flipped or C.shape[0] > C.shape[1]))
    if return_steps:
        outputs.append(traceback_steps)
    return outputs[0] if len(outputs) == 1 else tuple(outputs)


def _dtw_best_path(D: np.ndarray, traceback_steps: np.ndarray, steps: np.ndarray, subseq: bool,
                   *, undo_flip: bool) -> np.ndarray:
    """The optimal warping path ``(L, 2)``, from the end back; a flipped subsequence comes back unflipped."""
    if subseq:
        if np.isinf(D[-1]).all():
            raise ParameterError("the step set admits no subsequence alignment at all")
        path = dtw_backtracking(traceback_steps, steps, subseq, int(np.argmin(D[-1, :])))
    else:
        if np.isinf(D[-1, -1]):
            raise ParameterError("the step set admits no complete alignment")
        path = dtw_backtracking(traceback_steps, steps, subseq)
        if path[-1] != (0, 0):
            raise ParameterError("no full-sequence warping path exists; subseq=True may "
                                 "recover a partial alignment")
    wp = np.asarray(path, dtype=int)
    return np.fliplr(wp) if subseq and undo_flip else wp


def path_to_steps(path: Any, *, inverse: bool = False) -> np.ndarray:
    """The (fractional) source position of each target frame along a warping path ``(k, 2)``.

    ``path`` holds (source, target) pairs; ``inverse`` swaps the roles.
    Target frames between the path's points are interpolated linearly.
    """
    path = _host(path)
    src, dst = (path[:, 1], path[:, 0]) if inverse else (path[:, 0], path[:, 1])
    order = np.argsort(dst)
    dst_s, src_s = dst[order], src[order]
    return np.interp(np.arange(dst_s[0], dst_s[-1] + 1), dst_s, src_s)


# ---------------------------------------------------------------------------
# RQA
# ---------------------------------------------------------------------------


def rqa(sim: Any, *, gap_onset: float = 1, gap_extend: float = 1, knight_moves: bool = True,
        backtrack: bool = True):
    """Recurrence quantification: the score ``(N, M)`` of the best diagonal path into each cell of ``sim``.

    A linked cell (``sim > 0``) extends its best predecessor by its own
    value: the diagonal, and with ``knight_moves`` the steps (1, 2) and (2, 1).
    An unlinked cell carries the best predecessor on, less ``gap_onset``
    after a link or ``gap_extend`` after a gap, and never below 0. With
    ``backtrack`` also the best path ``(L, 2)``, to the highest score. The
    cells of one anti-diagonal depend only on earlier ones and are computed
    together, float64 numpy on the host.
    """
    if gap_onset < 0:
        raise ParameterError("gap_onset={} must be strictly positive")
    if gap_extend < 0:
        raise ParameterError("gap_extend={} must be strictly positive")
    sim = np.asarray(_host(sim), dtype=np.float64)
    N, M = sim.shape
    score = np.zeros_like(sim)
    bt = np.zeros(sim.shape, dtype=np.int8)
    # moves: 0 diagonal (-1, -1), 1 (-1, -2), 2 (-2, -1)
    moves = ((1, 1), (1, 2), (2, 1))[:3 if knight_moves else 1]

    def cells(ii: np.ndarray, jj: np.ndarray) -> None:
        svals = np.full((len(moves), len(ii)), -np.inf)
        tvals = np.zeros((len(moves), len(ii)), dtype=bool)
        for m, (di, dj) in enumerate(moves):
            ok = (ii >= di) & (jj >= dj)
            svals[m, ok] = score[ii[ok] - di, jj[ok] - dj]
            tvals[m, ok] = sim[ii[ok] - di, jj[ok] - dj] > 0
        # a move off the matrix counts as score 0
        svals = np.where(np.isneginf(svals), 0.0, svals)
        cols = np.arange(len(ii))
        is_link = sim[ii, jj] > 0
        best = np.argmax(svals, axis=0)
        best_score = svals[best, cols]
        score[ii[is_link], jj[is_link]] = best_score[is_link] + sim[ii[is_link], jj[is_link]]
        bt[ii[is_link], jj[is_link]] = best[is_link]
        vec = svals - np.where(tvals, gap_onset, gap_extend)
        bbest = np.argmax(vec, axis=0)
        bval = vec[bbest, cols]
        gap = ~is_link
        score[ii[gap], jj[gap]] = np.maximum(0, bval[gap])
        bt[ii[gap], jj[gap]] = np.where(np.maximum(0, bval) == 0, -1, bbest)[gap]

    # the first row and column: the data, a start (-2) where linked, else a reset (-1)
    score[0, :] = sim[0, :]
    score[:, 0] = sim[:, 0]
    bt[0, :] = np.where(sim[0, :] > 0, -2, -1)
    bt[:, 0] = np.where(sim[:, 0] > 0, -2, -1)
    if N > 1 and M > 1:
        for d in range(2, N + M - 1):
            i_lo, i_hi = max(1, d - (M - 1)), min(N - 1, d - 1)
            if i_lo <= i_hi:
                ii = np.arange(i_lo, i_hi + 1)
                cells(ii, d - ii)
    if backtrack:
        return score, _rqa_backtrack(score, bt)
    return score


def _rqa_backtrack(score: np.ndarray, pointers: np.ndarray) -> np.ndarray:
    """The path into the highest score, by its pointers, back to a start or a reset."""
    offsets = ((-1, -1), (-1, -2), (-2, -1))
    idx = list(np.unravel_index(np.argmax(score), score.shape))
    path: List[List[int]] = []
    while True:
        bt_index = pointers[tuple(idx)]
        if bt_index == -1:
            break
        path.insert(0, list(idx))
        if bt_index == -2:
            break
        idx = [idx[k] + offsets[bt_index][k] for k in range(2)]
    if not path:
        return np.empty((0, 2), dtype=np.uint)
    return np.asarray(path, dtype=np.uint)


# ---------------------------------------------------------------------------
# Viterbi
# ---------------------------------------------------------------------------


def _work_dtype(prob: torch.Tensor) -> torch.dtype:
    return torch.float64 if prob.dtype == torch.float64 else torch.float32


def _decode(log_prob: torch.Tensor, log_trans: np.ndarray, log_p_init: Any,
            key: Optional[tuple] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode ``log_prob`` ``(..., n_states, n_steps)``: states ``(..., n_steps)`` int32 and logp ``(...)``.

    Float64 runs the plain version; float32 goes to the kernel's wrapper,
    which runs the plain version on the CPU and on the card launches the
    kernel or raises. ``log_trans`` is a host array; ``key`` identifies it
    (None: its bytes do). Its device copy and, where the cluster route
    decodes it, its run table are made once per key and device and kept
    (``device_table``, ``ops.viterbi.device_runs``).
    """
    lead = log_prob.shape[:-2]
    S, T = log_prob.shape[-2:]
    lp = log_prob.transpose(-2, -1).reshape(-1, T, S).contiguous()
    log_trans = np.asarray(log_trans)
    if key is None:
        digest = hashlib.blake2b(np.ascontiguousarray(log_trans).tobytes(), digest_size=16)
        key = ("log_trans", log_trans.shape, str(log_trans.dtype), digest.digest())
    lt = device_table(key, lambda: log_trans, lp.device, lp.dtype)
    lpi = torch.as_tensor(log_p_init, dtype=lp.dtype, device=lp.device)
    if lp.dtype == torch.float64:
        states, logp = _viterbi.viterbi_reference(lp, lt, lpi)
    else:
        runs = (_viterbi.device_runs(key, log_trans, lp.device)
                if _viterbi.route_for(S, lp.shape[0]) == "cluster" else None)
        states, logp = _viterbi.viterbi_decode(lp, lt, lpi, runs)
    return states.reshape(*lead, T), logp.reshape(lead)


def _validate_transition(transition: np.ndarray, n_states: int) -> None:
    if transition.shape != (n_states, n_states):
        raise ParameterError(f"transition.shape={transition.shape}, must be "
                             f"(n_states, n_states)={n_states, n_states}")
    if np.any(transition < 0) or not np.allclose(transition.sum(axis=1), 1):
        raise ParameterError("Invalid transition matrix: must be non-negative "
                             "and sum to 1 on each row.")


def _log_transition(transition: np.ndarray, epsilon: float,
                    transition_min_prob: Optional[float]) -> np.ndarray:
    """``log(transition + epsilon)``, transitions below ``transition_min_prob`` set to -inf."""
    log_trans = np.log(transition + epsilon)
    if transition_min_prob is not None and transition_min_prob > 0:
        feasible = log_trans >= np.log(transition_min_prob + epsilon)
        if not np.all(feasible.any(axis=0)):
            bad = int(np.flatnonzero(~feasible.any(axis=0))[0])
            raise ParameterError(
                f"Empty transition matrix detected for state {bad} in Viterbi. "
                f"Try reducing your minimum transition probability threshold.")
        log_trans = np.where(feasible, log_trans, -np.inf)
    elif transition_min_prob is not None and transition_min_prob < 0:
        raise ParameterError(f"Invalid transition_min_prob={transition_min_prob}, "
                             "must be None or non-negative.")
    return log_trans


def _state_distribution(name: str, dist: Any, n_states: int) -> np.ndarray:
    """An ``(n_states,)`` probability vector, uniform by default."""
    if dist is None:
        return np.full(n_states, 1.0 / n_states)
    dist = np.asarray(dist, dtype=np.float64)
    if dist.shape != (n_states,):
        raise ParameterError(f"{name} must be one probability per state "
                             f"(shape ({n_states},)); got shape {dist.shape}")
    if dist.min() < 0 or not np.allclose(dist.sum(), 1):
        raise ParameterError(f"{name} is not a probability distribution: {dist}")
    return dist


def viterbi(prob: Any, transition: Any, *, p_init: Optional[Any] = None,
            return_logp: bool = False, transition_min_prob: Optional[float] = None):
    """Most likely state sequence ``(..., n_steps)`` (int32) of an HMM given observation likelihoods.

    ``prob`` ``(..., n_states, n_steps)`` holds P(obs_t | state) in [0, 1];
    ``transition`` is row-stochastic; ``p_init`` defaults to uniform;
    transitions below ``transition_min_prob`` are pruned. With
    ``return_logp`` also the path's log probability ``(...)``.
    """
    prob = as_tensor(prob)
    n_states = prob.shape[-2]
    transition = _host(transition).astype(np.float64)
    _validate_transition(transition, n_states)
    if bool((prob < 0).any()) or bool((prob > 1).any()):
        raise ParameterError("Invalid probability values: must be between 0 and 1.")
    epsilon = tiny(prob)
    if p_init is None:
        p_init = np.full(n_states, 1.0 / n_states)
    else:
        p_init = np.asarray(p_init, dtype=np.float64)
        if (np.any(p_init < 0) or not np.allclose(p_init.sum(), 1)
                or p_init.shape != (n_states,)):
            raise ParameterError(f"Invalid initial state distribution: p_init={p_init}")
    log_trans = _log_transition(transition, epsilon, transition_min_prob)
    log_prob = torch.log(prob.to(_work_dtype(prob)) + epsilon)
    states, logp = _decode(log_prob, log_trans, np.log(p_init + epsilon))
    return (states, logp) if return_logp else states


def viterbi_discriminative(prob: Any, transition: Any, *, p_state: Optional[Any] = None,
                           p_init: Optional[Any] = None, return_logp: bool = False,
                           transition_min_prob: Optional[float] = None):
    """Viterbi decoding from per-frame state posteriors ``(..., n_states, n_steps)`` (columns sum to 1).

    The marginal ``p_state`` (default uniform) is divided out: log P[x | s]
    is log P[s | x] - log P[s] up to a constant.
    """
    prob = as_tensor(prob)
    n_states = prob.shape[-2]
    transition = _host(transition).astype(np.float64)
    _validate_transition(transition, n_states)
    if bool((prob < 0).any()) or not torch.allclose(
            prob.sum(dim=-2).double(), torch.ones((), dtype=torch.float64, device=prob.device)):
        raise ParameterError("the frame-wise observation matrix must hold a distribution "
                             "per column (non-negative, summing to 1)")
    epsilon = tiny(prob)
    p_state = _state_distribution("p_state", p_state, n_states)
    p_init = _state_distribution("p_init", p_init, n_states)
    log_trans = _log_transition(transition, epsilon, transition_min_prob)
    dtype = _work_dtype(prob)
    log_marginal = torch.as_tensor(np.log(p_state + epsilon), dtype=dtype, device=prob.device)
    log_prob = torch.log(prob.to(dtype) + epsilon) - log_marginal.reshape(-1, 1)
    states, logp = _decode(log_prob, log_trans, np.log(p_init + epsilon))
    return (states, logp) if return_logp else states


def _per_label_prob(name: str, values: Any, n_labels: int, *, default: float) -> np.ndarray:
    """An ``(n_labels,)`` vector of independent probabilities, ``default`` for None."""
    if values is None:
        return np.full(n_labels, default)
    vec = np.atleast_1d(np.asarray(values, dtype=np.float64))
    if vec.shape != (n_labels,) or vec.min() < 0 or vec.max() > 1:
        raise ParameterError(f"{name} needs one [0, 1] probability per label "
                             f"({n_labels} labels); got {values!r}")
    return vec


def viterbi_binary(prob: Any, transition: Any, *, p_state: Optional[Any] = None,
                   p_init: Optional[Any] = None, return_logp: bool = False,
                   transition_min_prob: Optional[float] = None):
    """Each label of ``prob`` ``(..., n_labels, n_steps)`` decoded as its own off/on HMM.

    ``transition`` is one 2x2 matrix for every label or ``(n_labels, 2,
    2)``; ``p_state`` and ``p_init`` give each label's probability of "on"
    (default 0.5). Returns states ``(..., n_labels, n_steps)``, and with
    ``return_logp`` the log probabilities ``(..., n_labels)``.
    """
    prob = as_tensor(prob)
    if prob.ndim < 2:
        prob = prob.reshape(1, -1)
    n_labels = prob.shape[-2]
    transition = _host(transition).astype(np.float64)
    if transition.shape == (2, 2):
        transition = np.broadcast_to(transition, (n_labels, 2, 2))
    elif transition.shape != (n_labels, 2, 2):
        raise ParameterError(f"binary decoding takes one 2x2 transition matrix (shared) or "
                             f"{n_labels} of them; got shape {transition.shape}")
    if transition.min() < 0 or not np.allclose(transition.sum(axis=-1), 1):
        raise ParameterError("each 2x2 transition row must be a probability distribution")
    if bool((prob < 0).any()) or bool((prob > 1).any()):
        raise ParameterError("per-label activation probabilities must lie in [0, 1]")
    on_state = _per_label_prob("p_state", p_state, n_labels, default=0.5)
    on_init = _per_label_prob("p_init", p_init, n_labels, default=0.5)
    decoded, scores = [], []
    for lab in range(n_labels):
        on = prob[..., lab, :]
        states, logp = viterbi_discriminative(
            torch.stack([1 - on, on], dim=-2), transition[lab],
            p_state=np.array([1 - on_state[lab], on_state[lab]]),
            p_init=np.array([1 - on_init[lab], on_init[lab]]), return_logp=True,
            transition_min_prob=transition_min_prob)
        decoded.append(states)
        scores.append(logp)
    states = torch.stack(decoded, dim=-2)
    return (states, torch.stack(scores, dim=-1)) if return_logp else states


def transition_uniform(n_states: int) -> np.ndarray:
    """Every move equally likely: each row is ``1 / n_states``."""
    if not is_positive_int(n_states):
        raise ParameterError(f"n_states={n_states} must be a positive integer")
    return np.full((n_states, n_states), 1.0 / n_states)


def _per_state_param(value: Any, n_states: int, *, kind: str) -> np.ndarray:
    """A per-state probability (``kind='probability'``) or width (``'width'``) vector."""
    if not (is_positive_int(n_states) and n_states > 1):
        raise ParameterError(f"a transition matrix needs at least 2 states; got n_states={n_states}")
    vec = np.asarray(value, dtype=np.float64 if kind == "probability" else int)
    if vec.ndim == 0:
        vec = np.full(n_states, vec.item())
    if vec.shape != (n_states,):
        raise ParameterError(f"per-state {kind} must be scalar or length-{n_states}; "
                             f"got shape {vec.shape}")
    if kind == "probability":
        if vec.min() < 0 or vec.max() > 1:
            raise ParameterError(f"state probabilities must lie in [0, 1]; got {vec}")
    elif vec.min() < 1:
        raise ParameterError(f"window widths must be >= 1; got {vec}")
    return vec


def transition_loop(n_states: int, prob: Any) -> np.ndarray:
    """Stay with probability ``prob`` (per state or shared), else move to any other state alike."""
    stay = _per_state_param(prob, n_states, kind="probability")
    spread = np.repeat((1.0 - stay)[:, None] / (n_states - 1), n_states, 1)
    return np.where(np.eye(n_states, dtype=bool), stay[:, None], spread)


def transition_cycle(n_states: int, prob: Any) -> np.ndarray:
    """Stay with probability ``prob``, else advance to the next state (the last wraps to the first)."""
    stay = _per_state_param(prob, n_states, kind="probability")
    here = np.arange(n_states)
    transition = np.zeros((n_states, n_states), dtype=np.float64)
    transition[here, here] = stay
    transition[here, (here + 1) % n_states] = 1.0 - stay
    return transition


def transition_local(n_states: int, width: Any, *, window: str = "triangle",
                     wrap: bool = False) -> np.ndarray:
    """Moves within ``width`` neighbouring states, weighted by ``window``; rows normalised.

    ``wrap`` lets the window reach around the ends of the state space.
    """
    widths = _per_state_param(width, n_states, kind="width")
    transition = np.zeros((n_states, n_states), dtype=np.float64)
    for state, w in enumerate(widths):
        w = int(w)
        if w > n_states:
            raise ParameterError(f"state {state} has window width {w} wider than the "
                                 f"{n_states}-state space")
        taps = get_window(window, w, fftbins=False)
        # the window centred on `state`: its pad-centred placement, rolled by n // 2 + state + 1
        offset = (n_states - w) // 2 + n_states // 2 + state + 1
        transition[state, (np.arange(w) + offset) % n_states] = taps
        if not wrap:
            reach = w // 2
            transition[state, state + reach + 1:] = 0
            transition[state, :max(0, state - reach)] = 0
    return transition / transition.sum(axis=1, keepdims=True)
