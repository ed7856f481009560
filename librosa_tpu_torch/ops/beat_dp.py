"""The beat tracker's dynamic program: the CUDA kernel for a batch of rows, its plain version, and the host DP.

:func:`beat_dp` takes ``localscore`` ``(R, T)`` float32 and
``frames_per_beat`` ``(R, T)`` or ``(R, 1)`` and returns ``(backlink (R, T)
int32, cumscore (R, T) float32)``: for each frame the best predecessor at a
distance ``d`` with ``round(fpb / 2) <= d <= 2 fpb``, ``d <= i`` and ``d <=
1024`` under the penalty ``tightness * (log d - log fpb)**2`` (the smallest
``d`` of equal scores), -1 where none is valid or before the first frame
that reaches a hundredth of the row's maximum. It is the JAX package's
vmapped ``_beat_dp_scan`` (``librosa_tpu/beat.py:35``).

On a CUDA tensor it launches the hand-written kernel ``csrc/beat_dp.cu``
(one block per row, each step scoring up to 16 frames that do not depend on
each other, one warp a frame: :func:`step_schedule`; built for ``sm_90a`` at
first use by ``ops/_build.py``) or raises; on a CPU tensor it runs
:func:`beat_dp_reference`, the plain PyTorch version: a loop over frames,
all rows at once. Both take ``log d``,
``log fpb`` and the threshold from the same torch ops and form the penalty
in the same order without fused multiply-adds, so they agree to the bit.

:func:`beat_dp_host` is the DP of one float64 envelope on the host, in the
port's own C++ (``csrc/hostdp.cpp``, built with g++), which keeps the
*largest* distance of equal scores, as the JAX package's host DP does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..util.exceptions import ParameterError
from . import _build

__all__ = ["beat_dp", "beat_dp_reference", "beat_dp_host", "chain_floor_ms", "kernel_refusal",
           "launches", "step_schedule", "MAX_WINDOW", "STEP_FRAMES"]

MAX_WINDOW = 1024  # the largest predecessor distance, frames (the JAX package's _MAX_WINDOW)
STEP_FRAMES = 16  # frames a step of the kernel scores at most (csrc/beat_steps.cuh)
_MAX_ROWS = 2**31 - 1

#: Kernel launches so far: :func:`beat_dp` adds one per call that reaches the card.
launches = 0


def kernel_refusal(localscore: torch.Tensor, frames_per_beat: torch.Tensor) -> Optional[str]:
    """Why the CUDA kernel does not take this call, or None if it does.

    The one support rule: ``beat._beat_tracker`` routes by it, and
    :func:`beat_dp` raises with this reason on a CUDA tensor otherwise.
    """
    for name, t in (("localscore", localscore), ("frames_per_beat", frames_per_beat)):
        if t.dtype != torch.float32:
            return f"the beat_dp kernel takes float32 {name}, not {t.dtype}"
    if localscore.ndim != 2 or frames_per_beat.ndim != 2:
        return "the beat_dp kernel takes (rows, frames) tensors"
    R, T = localscore.shape
    if frames_per_beat.shape not in ((R, T), (R, 1)):
        return (f"the beat_dp kernel takes frames_per_beat of shape {(R, T)} or {(R, 1)}, "
                f"not {tuple(frames_per_beat.shape)}")
    if R * T == 0 or R > _MAX_ROWS or T > _MAX_ROWS:
        return "the beat_dp kernel takes at least one frame and fewer than 2**31 rows and frames"
    return None


def _tables(localscore: torch.Tensor, frames_per_beat: torch.Tensor):
    """``log d`` for d = 1 .. 1024, ``log fpb`` and each row's threshold, by torch on the device."""
    d = torch.arange(1, MAX_WINDOW + 1, dtype=localscore.dtype, device=localscore.device)
    return torch.log(d), torch.log(frames_per_beat), 0.01 * localscore.amax(dim=-1)


def beat_dp_reference(localscore: torch.Tensor, frames_per_beat: torch.Tensor,
                      tightness: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`beat_dp`, on ``localscore``'s device: a loop over frames."""
    R, T = localscore.shape
    dev = localscore.device
    log_d, log_fpb, thresh = _tables(localscore, frames_per_beat)
    d = torch.arange(1, MAX_WINDOW + 1, dtype=localscore.dtype, device=dev)
    fpb = frames_per_beat.expand(R, T)
    lf = log_fpb.expand(R, T)
    d_min = torch.round(fpb * 0.5)
    d_max = 2.0 * fpb
    neg_inf = torch.tensor(float("-inf"), dtype=localscore.dtype, device=dev)
    buf = torch.full((R, MAX_WINDOW), float("-inf"), dtype=localscore.dtype, device=dev)
    first = torch.ones(R, dtype=torch.bool, device=dev)
    backlink = torch.empty((R, T), dtype=torch.int32, device=dev)
    cumscore = torch.empty((R, T), dtype=localscore.dtype, device=dev)
    for i in range(T):
        valid = (d >= d_min[:, i:i + 1]) & (d <= d_max[:, i:i + 1]) & (d <= i)
        diff = log_d - lf[:, i:i + 1]
        scores = torch.where(valid, buf - tightness * (diff * diff), neg_inf)
        best, k = scores.max(dim=-1)  # buf[:, k] holds frame i - 1 - k: the smallest d on ties
        has = torch.isfinite(best)
        si = localscore[:, i]
        cum = torch.where(has, si + best, si)
        suppress = first & (si < thresh)
        link = torch.where(has & ~suppress, i - 1 - k, -1)
        first = suppress
        backlink[:, i] = link
        cumscore[:, i] = cum
        buf = torch.cat([cum[:, None], buf[:, :-1]], dim=1)
    return backlink, cumscore


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("beat_dp")
    fn = lib.beat_dp_launch
    if fn.argtypes is None:
        p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i32, i32, i32, f32, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def beat_dp(localscore: torch.Tensor, frames_per_beat: torch.Tensor,
            tightness: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(backlink, cumscore)`` of the beat DP over each row of ``localscore``.

    On a CUDA tensor this launches the kernel where :func:`kernel_refusal`
    gives no reason, and raises with that reason otherwise; a failed build
    or launch raises too. On a CPU tensor it returns
    :func:`beat_dp_reference`. Nothing is copied to the host and nothing
    synchronises.
    """
    global launches
    if localscore.device.type == "cpu":
        return beat_dp_reference(localscore, frames_per_beat, tightness)
    if localscore.device.type != "cuda":
        raise ParameterError(f"beat_dp runs on cuda or cpu, not {localscore.device}")
    refusal = kernel_refusal(localscore, frames_per_beat)
    if refusal is not None:
        raise ParameterError(refusal)
    if frames_per_beat.device != localscore.device:
        raise ParameterError("beat_dp takes localscore and frames_per_beat on one device")
    localscore = localscore.contiguous()
    frames_per_beat = frames_per_beat.contiguous()
    log_d, log_fpb, thresh = _tables(localscore, frames_per_beat)
    R, T = localscore.shape
    backlink = torch.empty((R, T), dtype=torch.int32, device=localscore.device)
    cumscore = torch.empty((R, T), dtype=torch.float32, device=localscore.device)
    lib = _kernel_lib()
    with torch.cuda.device(localscore.device):
        stream = torch.cuda.current_stream(localscore.device).cuda_stream
        err = lib.beat_dp_launch(
            localscore.data_ptr(), frames_per_beat.data_ptr(), log_fpb.data_ptr(),
            log_d.data_ptr(), thresh.data_ptr(), R, T, int(frames_per_beat.shape[1] == T),
            float(tightness), backlink.data_ptr(), cumscore.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"beat_dp kernel launch failed with CUDA error {err}")
    launches += 1
    return backlink, cumscore


def step_schedule(frames_per_beat: np.ndarray, T: int) -> np.ndarray:
    """The frames of each step of the kernel on one row: ``csrc/beat_steps.cuh``'s rule.

    ``frames_per_beat`` is the row's ``(T,)`` or ``(1,)`` float32. A step at
    frame ``i`` takes frames ``i .. i + k - 1`` while each frame ``i + m``
    has no candidate ``d <= m`` (its ``lo = max(round(fpb / 2), 1)`` is
    above ``m``, or it has none), at most :data:`STEP_FRAMES`.
    """
    f = np.broadcast_to(np.asarray(frames_per_beat, dtype=np.float32).reshape(-1), (T,))
    j = np.arange(T)
    with np.errstate(invalid="ignore"):
        lo = np.maximum(np.rint(f * np.float32(0.5)), np.float32(1.0))
        hi = np.minimum(np.floor(np.float32(2.0) * f), np.minimum(j, MAX_WINDOW).astype(np.float32))
        none = ~(lo <= hi)
    lo_i = np.where(none, T + MAX_WINDOW, lo).astype(np.int64)  # no candidate: joins any step
    steps = []
    i = 0
    while i < T:
        k = 1
        while k < STEP_FRAMES and i + k < T and lo_i[i + k] > k:
            k += 1
        steps.append(k)
        i += k
    return np.asarray(steps, dtype=np.int64)


def chain_floor_ms(rows: int, steps: int, device: torch.device, repeats: int = 10) -> float:
    """The least time of ``steps`` dependent steps of the beat DP on ``rows`` rows, in ms.

    Launches the probe in ``csrc/beat_dp.cu`` that runs only what each step
    of the kernel must do in order (the step's flags, a ring read, the
    five-level warp reduction, the ring write, the block barrier), with
    every step full, and returns its best time of ``repeats`` by CUDA events.
    Give it the most steps of any row (:func:`step_schedule`). A measurement
    for the bound: it adds nothing to :data:`launches`.
    """
    lib = _build.load("beat_dp")
    fn = lib.beat_dp_step_probe_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    out = torch.empty(rows, dtype=torch.float32, device=device)
    best = float("inf")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        for _ in range(repeats + 1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            err = fn(rows, steps, out.data_ptr(), stream.cuda_stream)
            end.record(stream)
            if err != 0:
                raise RuntimeError(f"beat_dp step probe launch failed with CUDA error {err}")
            end.synchronize()
            best = min(best, start.elapsed_time(end))
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("beat_dp step probe wrote non-finite values")
    return best


def _host_lib() -> ctypes.CDLL:
    lib = _build.load("hostdp")
    fn = lib.beat_dp_host
    if fn.argtypes is None:
        dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
        fn.argtypes = [dp, ctypes.c_long, dp, ctypes.c_int, ctypes.c_double, ip, dp]
        fn.restype = None
    return lib


def beat_dp_host(localscore: np.ndarray, frames_per_beat: np.ndarray,
                 tightness: float) -> Tuple[np.ndarray, np.ndarray]:
    """``(backlink int64, cumscore float64)`` of one envelope ``(T,)`` on the host.

    ``frames_per_beat`` is ``(T,)`` or ``(1,)``. The port's C++ loop
    (``csrc/hostdp.cpp``); of equal scores it keeps the earliest predecessor.
    """
    ls = np.ascontiguousarray(localscore, dtype=np.float64)
    fpb = np.ascontiguousarray(frames_per_beat, dtype=np.float64)
    T = ls.shape[0]
    backlink = np.full(T, -1, dtype=np.int64)
    cumscore = np.zeros(T, dtype=np.float64)
    dp = ctypes.POINTER(ctypes.c_double)
    _host_lib().beat_dp_host(ls.ctypes.data_as(dp), T, fpb.ctypes.data_as(dp),
                             int(fpb.shape[0] > 1), float(tightness),
                             backlink.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                             cumscore.ctypes.data_as(dp))
    return backlink, cumscore
