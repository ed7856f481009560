"""Viterbi decoding and the transition matrices of hidden Markov models.

The decoders take observation probabilities ``(..., n_states, n_steps)`` on
any device, form log probabilities there and decode with
:func:`..ops.viterbi.viterbi_decode`: on the card the max-plus kernel
``csrc/viterbi.cu`` (float32, at most 16384 states; a call it refuses
raises); on the CPU its plain PyTorch version. Float64 input decodes in
float64 with the plain version, anything else in float32. The transition
matrices and the checks of the distributions are float64 numpy on the host,
as in the JAX package.

``dtw``, ``dtw_backtracking``, ``rqa`` and ``path_to_steps`` are not ported
yet.
"""

from __future__ import annotations

import hashlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ._device import as_tensor, device_table
from .filters import get_window
from .ops import viterbi as _viterbi
from .util.exceptions import ParameterError
from .util.utils import _host, is_positive_int, tiny

__all__ = ["viterbi", "viterbi_discriminative", "viterbi_binary", "transition_uniform",
           "transition_loop", "transition_cycle", "transition_local"]


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
