"""Max-plus Viterbi decoding: the CUDA kernel behind ``sequence.viterbi*`` and ``pyin``, and its plain version.

:func:`viterbi_decode` takes ``log_prob`` ``(R, T, S)``, ``log_trans``
``(S, S)`` and ``log_p_init`` ``(S,)`` and returns ``(states (R, T) int32,
logp (R,))``: the forward recurrence ``v_t[n] = log_prob[t, n] + max_p
(v_{t-1}[p] + log_trans[p, n])`` from ``v_0 = log_prob[0] + log_p_init``,
the first ``p`` of equal scores, then the backtrack from the first argmax of
the last frame. It is the JAX package's ``_viterbi_scan``
(``librosa_tpu/sequence.py:609``).

On a CUDA tensor it launches the hand-written kernel ``csrc/viterbi.cu``
(one block per row; built for ``sm_90a`` at first use by ``ops/_build.py``)
or raises; on a CPU tensor it runs :func:`viterbi_reference`, the plain
PyTorch version: a loop over frames of a broadcast add and a max over ``(R,
S, S)``, then a loop of gathers. Both add the same floats in the same order
and break ties alike, so states and logp agree to the bit. The kernel keeps
an ``(R, T, S)`` int32 buffer of pointers on the card (456 MB for pYIN's 870
states on 16 tracks of 8193 frames).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..util.exceptions import ParameterError
from . import _build

__all__ = ["viterbi_decode", "viterbi_reference", "kernel_refusal", "launches", "MAX_STATES"]

MAX_STATES = 16384  # v_{t-1} and v_t in shared memory: 128 KB

#: Kernel launches so far: :func:`viterbi_decode` adds one per call that reaches the card.
launches = 0


def kernel_refusal(log_prob: torch.Tensor, log_trans: torch.Tensor,
                   log_p_init: torch.Tensor) -> Optional[str]:
    """Why the CUDA kernel does not take this call, or None if it does.

    The one support rule: ``sequence`` and ``pyin`` route by it, and
    :func:`viterbi_decode` raises with this reason on a CUDA tensor otherwise.
    """
    for name, t in (("log_prob", log_prob), ("log_trans", log_trans),
                    ("log_p_init", log_p_init)):
        if t.dtype != torch.float32:
            return f"the viterbi kernel takes float32 {name}, not {t.dtype}"
    if log_prob.ndim != 3:
        return "the viterbi kernel takes log_prob of shape (rows, frames, states)"
    R, T, S = log_prob.shape
    if log_trans.shape != (S, S) or log_p_init.shape != (S,):
        return f"the viterbi kernel takes a ({S}, {S}) log_trans and a ({S},) log_p_init"
    if R * T * S == 0:
        return "the viterbi kernel takes at least one row, frame and state"
    if S > MAX_STATES:
        return f"the viterbi kernel takes at most {MAX_STATES} states, not {S}"
    if R > 2**31 - 1 or T > 2**31 - 1:
        return "the viterbi kernel takes fewer than 2**31 rows and frames"
    return None


def viterbi_reference(log_prob: torch.Tensor, log_trans: torch.Tensor,
                      log_p_init: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`viterbi_decode`, on ``log_prob``'s device, any float dtype."""
    R, T, S = log_prob.shape
    v = log_prob[:, 0] + log_p_init
    ptrs = torch.zeros((R, T, S), dtype=torch.int32, device=log_prob.device)
    for t in range(1, T):
        best, p = (v[:, :, None] + log_trans).max(dim=1)  # the first p on ties
        ptrs[:, t] = p.to(torch.int32)
        v = log_prob[:, t] + best
    logp, last = v.max(dim=-1)
    states = torch.empty((R, T), dtype=torch.int32, device=log_prob.device)
    states[:, T - 1] = last.to(torch.int32)
    for t in range(T - 1, 0, -1):
        states[:, t - 1] = ptrs[:, t].gather(1, states[:, t:t + 1].long())[:, 0]
    return states, logp


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("viterbi")
    fn = lib.viterbi_launch
    if fn.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i32, i32, i32, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def viterbi_decode(log_prob: torch.Tensor, log_trans: torch.Tensor,
                   log_p_init: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(states, logp)`` of the most likely state path of each row of ``log_prob``.

    On a CUDA tensor this launches the kernel where :func:`kernel_refusal`
    gives no reason, and raises with that reason otherwise; a failed build
    or launch raises too. On a CPU tensor it returns
    :func:`viterbi_reference`. Nothing is copied to the host and nothing
    synchronises.
    """
    global launches
    if log_prob.device.type == "cpu":
        return viterbi_reference(log_prob, log_trans, log_p_init)
    if log_prob.device.type != "cuda":
        raise ParameterError(f"viterbi_decode runs on cuda or cpu, not {log_prob.device}")
    refusal = kernel_refusal(log_prob, log_trans, log_p_init)
    if refusal is not None:
        raise ParameterError(refusal)
    if log_trans.device != log_prob.device or log_p_init.device != log_prob.device:
        raise ParameterError("viterbi_decode takes its three tensors on one device")
    log_prob, log_trans = log_prob.contiguous(), log_trans.contiguous()
    log_p_init = log_p_init.contiguous()
    R, T, S = log_prob.shape
    ptrs = torch.empty((R, T, S), dtype=torch.int32, device=log_prob.device)
    states = torch.empty((R, T), dtype=torch.int32, device=log_prob.device)
    logp = torch.empty(R, dtype=torch.float32, device=log_prob.device)
    lib = _kernel_lib()
    with torch.cuda.device(log_prob.device):
        stream = torch.cuda.current_stream(log_prob.device).cuda_stream
        err = lib.viterbi_launch(log_prob.data_ptr(), log_trans.data_ptr(),
                                 log_p_init.data_ptr(), R, T, S, ptrs.data_ptr(),
                                 states.data_ptr(), logp.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"viterbi kernel launch failed with CUDA error {err}")
    launches += 1
    return states, logp
