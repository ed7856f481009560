"""Peak picking: the windowed candidacy tests as torch ops, the wait-spaced selection as scans.

A frame is a candidate when it equals the maximum of its window
``[n - pre_max, n + post_max)`` and reaches the mean of ``[n - pre_avg, n +
post_avg)`` plus ``delta`` (windows clipped to the envelope). The selection
is sequential: 'greedy' takes candidates left to right at least ``wait``
frames apart (:func:`greedy_mask`); the DP takes the spaced set with the
largest count or summed height (:func:`dp_values`, then :func:`dp_mask`,
whose walk over the DP's flags is the greedy selection of those flags). The
JAX package runs both scans as a ``lax.scan`` over frames, vmapped over rows
(``librosa_tpu/ops/peaks.py``). Here, on a CUDA tensor, they launch the
hand-written kernels of ``csrc/peak_scan.cu`` (built for ``sm_90a`` at first
use by ``ops/_build.py``) or raise: the greedy selection as a walk over bit
words in shared memory, the DP over a ring of its values in shared memory,
or, for a wait whose ring exceeds :data:`RING_MAX` floats, over a scratch in
device memory (:func:`dp_route`). On a CPU tensor they run the plain
versions, loops over frames on the host with numpy over all rows at once
(:func:`greedy_select`, :func:`dp_flags`), which the kernels equal bit for
bit. One envelope alone runs the float64 host loops of the JAX package
(:func:`greedy_1d`, :func:`dp_1d`).
"""

from __future__ import annotations

import ctypes
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..util.exceptions import ParameterError
from . import _build

__all__ = ["candidate_mask", "greedy_mask", "dp_values", "dp_mask", "greedy_scan", "dp_scan",
           "greedy_select", "dp_flags", "dp_select", "greedy_1d", "dp_1d", "ring_size",
           "dp_route", "chain_floor_ms", "walk_floor_ms", "launch_floor_ms", "launches"]

_MAX_WAIT = 2**31 - 1  # the JAX scan's countdown is a 32-bit int

#: The kernels' geometry, as ``csrc/peak_scan.cu`` has it: frames a greedy stage
#: (``kGreedyChunk``), below which wait the walk visits every word (``kNearWait``), frames a
#: DP stage (``kDpChunk``), frames a group of the DP's chain (``kDpGroup``; the ring from wait
#: ``DP_GROUP - 1`` on), the largest ring of the DP's values in floats (``kRingMax``) and the
#: longest row of the walk probe (``32 * kProbeWords``).
GREEDY_CHUNK = 2048
NEAR_WAIT = 32
DP_CHUNK = 2048
DP_GROUP = 8
RING_MAX = 32768
WALK_PROBE_FRAMES = 32768

#: Kernel launches so far: :func:`greedy_scan` and :func:`dp_scan` add one per call that
#: reaches the card.
launches = 0


def candidate_mask(x: torch.Tensor, *, pre_max: int, post_max: int, pre_avg: int, post_avg: int,
                   delta: float) -> torch.Tensor:
    """Candidates of ``x`` ``(..., T)`` on its device: a boolean tensor of the same shape."""
    wmax = F.pad(x, (pre_max, post_max - 1), value=float("-inf"))
    wmax = wmax.unfold(-1, pre_max + post_max, 1).amax(dim=-1)
    width = pre_avg + post_avg
    wsum = F.pad(x, (pre_avg, post_avg - 1)).unfold(-1, width, 1).sum(dim=-1)
    ones = torch.ones_like(x.reshape(-1, x.shape[-1])[:1])
    count = F.pad(ones, (pre_avg, post_avg - 1)).unfold(-1, width, 1).sum(dim=-1)[0]
    return (x == wmax) & (x >= wsum / count + delta)


def greedy_mask(x: torch.Tensor, *, pre_max: int, post_max: int, pre_avg: int, post_avg: int,
                delta: float, wait: int) -> torch.Tensor:
    """Greedy peak mask of ``x`` ``(..., T)`` over the last axis, a bool tensor on ``x``'s device.

    :func:`candidate_mask`, then :func:`greedy_scan`: a candidate is taken
    when at least ``wait`` frames have passed since the last taken one.
    """
    cand = candidate_mask(x, pre_max=pre_max, post_max=post_max, pre_avg=pre_avg,
                          post_avg=post_avg, delta=delta)
    return greedy_scan(cand.reshape(-1, cand.shape[-1]), wait).reshape(cand.shape)


def dp_values(x: torch.Tensor, *, pre_max: int, post_max: int, pre_avg: int, post_avg: int,
              delta: float, wait: int, count: bool) -> torch.Tensor:
    """The backward DP's ``taken`` flags of ``x`` ``(..., T)``, a bool tensor on ``x``'s device.

    :func:`candidate_mask`, then :func:`dp_scan` with gain 1 (``count``) or
    ``x`` in float32: ``value[n] = max(value[n + 1], value[min(T, n + wait +
    1)] + gain[n])`` where ``n`` is a candidate, taken only if strictly
    larger. :func:`dp_mask` turns the flags into peaks. As in the JAX
    package, summed heights that tie to float32 resolution may pick another
    set than a float64 evaluation would.
    """
    cand = candidate_mask(x, pre_max=pre_max, post_max=post_max, pre_avg=pre_avg,
                          post_avg=post_avg, delta=delta)
    flat = cand.reshape(-1, cand.shape[-1])
    gain = (torch.ones(flat.shape, dtype=torch.float32, device=x.device) if count
            else x.reshape(flat.shape).to(torch.float32))
    return dp_scan(flat, gain, wait).reshape(cand.shape)


def dp_mask(taken: Any, wait: int) -> np.ndarray:
    """Peaks from the DP's ``taken`` flags ``(..., T)``: numpy bool of that shape.

    From frame 0, a taken frame is a peak and the walk jumps ``wait + 1``
    frames; any other frame steps one. That is the greedy selection of the
    flags, so on a CUDA tensor the walk is :func:`greedy_scan` on the card and
    only the peaks come back; anything else walks on the host.
    """
    if isinstance(taken, torch.Tensor) and taken.device.type == "cuda":
        flat = taken.reshape(-1, taken.shape[-1]).to(torch.bool)
        return greedy_scan(flat, wait).reshape(taken.shape).cpu().numpy()
    taken = taken.cpu().numpy() if isinstance(taken, torch.Tensor) else np.asarray(taken)
    return _walk_host(taken.reshape(-1, taken.shape[-1]).astype(bool), wait).reshape(taken.shape)


def _walk_host(flat: np.ndarray, wait: int) -> np.ndarray:
    T = flat.shape[1]
    out = np.zeros(flat.shape, dtype=bool)
    for r in range(flat.shape[0]):
        n = 0
        while n < T:
            if flat[r, n]:
                out[r, n] = True
                n += wait + 1
            else:
                n += 1
    return out


def greedy_select(cand: np.ndarray, wait: int) -> np.ndarray:
    """Candidates taken left to right, each at least ``wait + 1`` frames after the last taken one.

    The plain version of :func:`greedy_scan`: ``cand`` ``(rows, T)`` numpy bool.
    """
    rows, T = cand.shape
    out = np.zeros_like(cand, dtype=bool)
    countdown = np.zeros(rows, dtype=np.int64)
    for n in range(T):
        take = cand[:, n] & (countdown == 0)
        out[:, n] = take
        countdown = np.where(take, wait, np.maximum(countdown - 1, 0))
    return out


def dp_flags(cand: np.ndarray, gain: np.ndarray, wait: int) -> np.ndarray:
    """The backward DP's ``taken`` flags per row, in float32 as the JAX scan.

    The plain version of :func:`dp_scan`: ``value[n] = max(value[n + 1],
    value[min(T, n + wait + 1)] + gain[n])`` where ``n`` is a candidate
    (taken only if strictly larger), ``cand`` and ``gain`` ``(rows, T)``.
    """
    rows, T = cand.shape
    values = np.zeros((rows, T + 1), dtype=np.float32)
    taken = np.zeros((rows, T), dtype=bool)
    gain = gain.astype(np.float32)
    for n in range(T - 1, -1, -1):
        nxt = min(T, n + wait + 1)
        with_n = values[:, nxt] + gain[:, n]
        take = cand[:, n] & (with_n > values[:, n + 1])
        taken[:, n] = take
        values[:, n] = np.where(take, with_n, values[:, n + 1])
    return taken


def dp_select(cand: np.ndarray, gain: np.ndarray, wait: int) -> np.ndarray:
    """The spaced candidate set of largest total ``gain`` per row: :func:`dp_flags`, then
    :func:`dp_mask`."""
    return dp_mask(dp_flags(cand, gain, wait), wait)


def _kernel_refusal(cand: torch.Tensor, wait: int) -> None:
    if cand.device.type != "cuda":
        raise ParameterError(f"the peak_scan kernels run on cuda or cpu, not {cand.device}")
    if cand.dtype != torch.bool or cand.ndim != 2:
        raise ParameterError("the peak_scan kernels take (rows, T) bool candidates")
    if not 0 <= wait <= _MAX_WAIT:
        raise ParameterError(f"the peak_scan kernels take 0 <= wait <= {_MAX_WAIT}, not {wait}")


def ring_size(T: int, wait: int) -> int:
    """The DP's ring of values on the card for rows of ``T`` frames, in floats.

    The least power of two that holds ``wait + 2`` values (``v[n]`` up to
    ``v[n + wait + 1]``), and at least :data:`DP_GROUP` (a group's values
    are stored together); where ``wait + 1 >= T`` every reach lies past the
    row and reads 0, so :data:`DP_GROUP` does. Waits below ``DP_GROUP - 1``
    keep their values in registers and launch no ring. Above
    :data:`RING_MAX` the DP takes the scratch route (:func:`dp_route`).
    """
    need = wait + 2 if wait + 1 < T else 1
    return max(DP_GROUP, 1 << (need - 1).bit_length())


def dp_route(T: int, wait: int) -> str:
    """Which kernel :func:`dp_scan` launches for rows of ``T`` frames at ``wait``: 'ring'
    (``dp_ring_kernel``: the values in registers below wait ``DP_GROUP - 1``, in a shared ring
    from there on) while :func:`ring_size` is at most :data:`RING_MAX` floats, else 'scratch'
    (the values in a ``(rows, T + 1)`` float32 scratch in device memory)."""
    return "ring" if ring_size(T, wait) <= RING_MAX else "scratch"


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("peak_scan")
    if lib.greedy_scan_launch.argtypes is None:
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.greedy_scan_launch.argtypes = [p, p, i64, i64, i64, p]
        lib.dp_ring_launch.argtypes = [p, p, p, i64, i64, i64, i64, p]
        lib.dp_scratch_launch.argtypes = [p, p, p, p, i64, i64, i64, p]
        lib.peak_chain_probe_launch.argtypes = [i64, i64, i32, i32, p, p]
        lib.peak_walk_probe_launch.argtypes = [p, i64, i64, i64, i32, p, p]
        lib.peak_empty_launch.argtypes = [p]
        for fn in (lib.greedy_scan_launch, lib.dp_ring_launch, lib.dp_scratch_launch,
                   lib.peak_chain_probe_launch, lib.peak_walk_probe_launch,
                   lib.peak_empty_launch):
            fn.restype = ctypes.c_int
    return lib


def _checked(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def greedy_scan(cand: torch.Tensor, wait: int) -> torch.Tensor:
    """The greedy selection over candidates ``cand`` ``(rows, T)`` bool: a bool tensor, same shape.

    On a CUDA tensor this launches ``greedy_walk_kernel`` of
    ``csrc/peak_scan.cu`` (a block a row walks its candidates as bit words in
    shared memory) or raises; on a CPU tensor it runs :func:`greedy_select`.
    """
    global launches
    wait = int(wait)
    if cand.device.type == "cpu":
        return torch.from_numpy(greedy_select(cand.numpy(), wait))
    _kernel_refusal(cand, wait)
    cand = cand.contiguous()
    out = torch.empty_like(cand)
    if cand.numel() == 0:
        return out
    with torch.cuda.device(cand.device):
        stream = torch.cuda.current_stream(cand.device).cuda_stream
        _checked(_kernel_lib().greedy_scan_launch(cand.data_ptr(), out.data_ptr(), cand.shape[0],
                                                  cand.shape[1], wait, stream), "greedy_scan")
    launches += 1
    return out


def dp_scan(cand: torch.Tensor, gain: torch.Tensor, wait: int) -> torch.Tensor:
    """The DP's ``taken`` flags over candidates ``cand`` ``(rows, T)`` bool with float32 ``gain``.

    On a CUDA tensor this launches a kernel of ``csrc/peak_scan.cu`` by
    :func:`dp_route`: ``dp_ring_kernel`` (a block a row, its values in
    registers or a shared ring of :func:`ring_size` floats) or, for a larger wait,
    ``dp_scratch_kernel`` (a thread a row, its values in a ``(rows, T + 1)``
    float32 scratch), or raises; on a CPU tensor it runs :func:`dp_flags`.
    """
    global launches
    wait = int(wait)
    if cand.device.type == "cpu":
        return torch.from_numpy(dp_flags(cand.numpy(), gain.cpu().numpy(), wait))
    _kernel_refusal(cand, wait)
    if gain.dtype != torch.float32 or gain.shape != cand.shape or gain.device != cand.device:
        raise ParameterError("dp_scan takes float32 gain of the candidates' shape and device")
    if cand.numel() == 0:
        return torch.empty_like(cand)
    taken = _dp_launch(cand.contiguous(), gain.contiguous(), wait, dp_route(cand.shape[1], wait))
    launches += 1
    return taken


def _dp_launch(cand: torch.Tensor, gain: torch.Tensor, wait: int, route: str) -> torch.Tensor:
    """One launch of the DP's ``route`` on checked, contiguous, non-empty CUDA inputs; counts
    nothing."""
    taken = torch.empty_like(cand)
    rows, T = cand.shape
    lib = _kernel_lib()
    with torch.cuda.device(cand.device):
        stream = torch.cuda.current_stream(cand.device).cuda_stream
        if route == "ring":
            err = lib.dp_ring_launch(cand.data_ptr(), gain.data_ptr(), taken.data_ptr(), rows, T,
                                     wait, ring_size(T, wait), stream)
        else:
            values = torch.empty((rows, T + 1), dtype=torch.float32, device=cand.device)
            err = lib.dp_scratch_launch(cand.data_ptr(), gain.data_ptr(), values.data_ptr(),
                                        taken.data_ptr(), rows, T, wait, stream)
    _checked(err, f"dp_scan ({route} route)")
    return taken


def _event_ms(device: torch.device, launch, repeats: int) -> float:
    """The best of ``repeats`` CUDA-event timings of one ``launch(stream)``, in ms."""
    best = float("inf")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        for _ in range(repeats + 1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            launch(stream.cuda_stream)
            end.record(stream)
            end.synchronize()
            best = min(best, start.elapsed_time(end))
    return best


def chain_floor_ms(rows: int, T: int, wait: int, *, dp: bool, device: torch.device,
                   repeats: int = 10) -> float:
    """The least time of ``T`` dependent steps of a scan's carry on ``rows`` rows, in ms.

    Launches the probe of ``csrc/peak_scan.cu`` that runs only the
    countdown (``dp`` False) or the DP's compare and select, on flags made
    in registers, and returns its best time of ``repeats`` by CUDA events.
    A measurement for the bound: it adds nothing to :data:`launches`.
    """
    fn = _kernel_lib().peak_chain_probe_launch
    out = torch.empty(rows, dtype=torch.float32, device=device)
    best = _event_ms(device, lambda s: _checked(fn(rows, T, int(wait), int(dp), out.data_ptr(), s),
                                                "peak_scan chain probe"), repeats)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("peak_scan chain probe wrote non-finite values")
    return best


def walk_floor_ms(cand: torch.Tensor, wait: int, *, walks: int = 16,
                  repeats: int = 10) -> dict:
    """The greedy walk over ``cand`` ``(rows, T)`` bool on the card (``T`` at most
    :data:`WALK_PROBE_FRAMES`) from shared memory alone, with no device traffic.

    Launches the walk probe of ``csrc/peak_scan.cu``, which stages each
    row's candidate words once and walks them 1 or ``1 + walks`` times; the
    difference of the two best times over ``walks`` is one walk of the
    slowest row. Returns ``{"ms", "steps", "takes"}``: that time, the most
    steps of a row's walk (words visited plus takes) and the takes of all
    rows. A measurement for the bound: it adds nothing to :data:`launches`.
    """
    _kernel_refusal(cand, wait)
    cand = cand.contiguous()
    rows, T = cand.shape
    if not 0 < T <= WALK_PROBE_FRAMES:
        raise ParameterError(f"the walk probe takes 0 < T <= {WALK_PROBE_FRAMES}, not {T}")
    fn = _kernel_lib().peak_walk_probe_launch
    out = torch.empty((rows, 2), dtype=torch.float32, device=cand.device)

    def timed(k):
        return _event_ms(cand.device, lambda s: _checked(fn(
            cand.data_ptr(), rows, T, int(wait), k, out.data_ptr(), s), "peak_scan walk probe"),
            repeats)

    ms = (timed(1 + walks) - timed(1)) / walks
    steps, takes = out.cpu().numpy().T
    return {"ms": ms, "steps": int(steps.max()), "takes": int(takes.sum())}


def launch_floor_ms(device: torch.device, repeats: int = 20) -> float:
    """The best CUDA-event time of one empty kernel launch of ``csrc/peak_scan.cu``, in ms."""
    fn = _kernel_lib().peak_empty_launch
    return _event_ms(device, lambda s: _checked(fn(s), "peak_scan empty"), repeats)


def greedy_1d(x: np.ndarray, *, pre_max: int, post_max: int, pre_avg: int, post_avg: int,
              delta: float, wait: int) -> np.ndarray:
    """Greedy peak picking of one float64 envelope, frame by frame."""
    n_frames = x.shape[0]
    peaks = np.zeros(n_frames, dtype=bool)
    if n_frames == 0:
        return peaks
    p0 = x[0] >= np.max(x[:min(post_max, n_frames)])
    p0 &= x[0] >= np.mean(x[:min(post_avg, n_frames)]) + delta
    peaks[0] = p0
    n = wait + 1 if p0 else 1
    while n < n_frames:
        if x[n] != np.max(x[max(0, n - pre_max):min(n + post_max, n_frames)]):
            n += 1
            continue
        if x[n] < np.mean(x[max(0, n - pre_avg):min(n + post_avg, n_frames)]) + delta:
            n += 1
            continue
        peaks[n] = True
        n += wait + 1
    return peaks


def dp_1d(x: np.ndarray, *, pre_max: int, post_max: int, pre_avg: int, post_avg: int,
          delta: float, wait: int, count: bool) -> np.ndarray:
    """The largest spaced peak set of one float64 envelope by a backward DP with pointers."""
    n_frames = len(x)
    values = np.zeros(n_frames + 1)
    pointers = np.zeros(n_frames + 1, dtype=np.int64)
    taken = np.zeros(n_frames + 1, dtype=bool)
    cumulate = np.cumsum(x)
    pointers[-1] = -1
    for n in range(n_frames - 1, -1, -1):
        values[n] = values[n + 1]
        pointers[n] = n + 1
        if x[n] < np.max(x[max(0, n - pre_max):min(n + post_max, n_frames)]):
            continue
        lo, hi = max(0, n - pre_avg), min(n + post_avg, n_frames)
        avg = (cumulate[hi - 1] - (cumulate[lo - 1] if lo else 0.0)) / (hi - lo)
        v = 1.0 if count else x[n]
        nxt = min(n_frames, n + wait + 1)
        if x[n] >= avg + delta and values[nxt] + v > values[n + 1]:
            values[n] = values[nxt] + v
            pointers[n] = nxt
            taken[n] = True
    peaks = np.zeros(n_frames, dtype=bool)
    n = 0
    while pointers[n] >= 0:
        peaks[n] = taken[n]
        n = pointers[n]
    return peaks
