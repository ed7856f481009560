"""Max-plus Viterbi decoding: the CUDA kernel behind ``sequence.viterbi*`` and ``pyin``, and its plain version.

:func:`viterbi_decode` takes ``log_prob`` ``(R, T, S)``, ``log_trans``
``(S, S)`` and ``log_p_init`` ``(S,)`` and returns ``(states (R, T) int32,
logp (R,))``: the forward recurrence ``v_t[n] = log_prob[t, n] + max_p
(v_{t-1}[p] + log_trans[p, n])`` from ``v_0 = log_prob[0] + log_p_init``,
the first ``p`` of equal scores, then the backtrack from the first argmax of
the last frame. It is the JAX package's ``_viterbi_scan``
(``librosa_tpu/sequence.py:609``).

On a CUDA tensor it launches the hand-written kernels of ``csrc/viterbi.cu``
(built for ``sm_90a`` at first use by ``ops/_build.py``) or raises; on a CPU
tensor it runs :func:`viterbi_reference`, the plain PyTorch version: a loop
over frames of a broadcast add and a max over ``(R, S, S)``, then a loop of
gathers. The forward pass takes one of two routes by the number of states
(:func:`route_for`):

- ``"cluster"`` (``CLUSTER_MIN_STATES`` states or more): a cluster of
  ``CLUSTER`` blocks per row, each owning a share of the next states and
  walking only the finite entries of ``log_trans`` (:class:`RunTable`, which
  the caller builds on the host once per matrix: :func:`device_runs`), with
  ``v`` exchanged through distributed shared memory once a frame;
- ``"block"``: one block per row, every ``p`` of every column.

Then one backtrack kernel stages the int16 pointers in shared memory ahead
of the chain. Both routes add the plain version's floats in its order and
break ties alike, so states and logp agree to the bit. The pointer buffer
``(R, T, S)`` int16 stays on the card (228 MB for pYIN's 870 states on 16
tracks of 8193 frames).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .._device import device_object
from ..util.exceptions import ParameterError
from . import _build

__all__ = ["viterbi_decode", "viterbi_reference", "kernel_refusal", "launches", "MAX_STATES",
           "RunTable", "run_table", "device_runs", "route_for", "forward", "backtrack",
           "exchange_floor_ms", "max_active_clusters", "keeps_values_on_chip", "CLUSTER",
           "CLUSTER_MIN_STATES", "ROUTES"]

MAX_STATES = 16384  # v_{t-1} and v_t in shared memory: 128 KB; pointers fit int16
ROUTES = ("block", "cluster")
#: Blocks in a row's cluster. Eight blocks on 16 rows fill 128 of the H100's 132 SMs; on
#: pYIN's table they decode faster than four (``diagnostics/viterbi_cluster.py``, PERF.md §6).
CLUSTER = 8
#: States from which the cluster route decodes; fewer go one block per row. On (16, 8193, S)
#: the block route is faster at S = 2, 5 and 64, the cluster route at 256 and 870 (PERF.md §6).
CLUSTER_MIN_STATES = 128
_MAX_GRID = 2**31 - 1
_BLOCK_THREADS = 512  # the cluster route's threads a block at most (csrc/viterbi.cu)

#: Kernel launches so far: :func:`viterbi_decode` adds one per call that reaches the card.
launches = 0
#: The same calls, by the route of their forward pass.
launches_by_route = {route: 0 for route in ROUTES}


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


@dataclass
class RunTable:
    """The finite entries of a transition matrix, column by column, in runs of rows.

    Column ``n``'s runs are ``col_run[n] .. col_run[n + 1] - 1``; run ``k``
    covers rows ``run_start[k] .. run_start[k] + run_len[k] - 1`` and its
    values are ``vals[run_val[k] ...]``. A column's values start at
    ``col_val[n]``. An entry is finite here where it is above ``-inf``.
    """

    S: int
    vals: np.ndarray       # float32, the finite entries, column by column, ascending p
    col_run: np.ndarray    # int32 (S + 1,)
    col_val: np.ndarray    # int32 (S + 1,)
    run_start: np.ndarray  # int32
    run_len: np.ndarray    # int32
    run_val: np.ndarray    # int32
    device: Optional[Dict[str, torch.Tensor]] = None

    @property
    def n_finite(self) -> int:
        return int(self.col_val[-1])

    @property
    def runs_per_column(self) -> np.ndarray:
        return np.diff(self.col_run)

    @property
    def finite_per_column(self) -> np.ndarray:
        return np.diff(self.col_val)

    def group(self, cluster: int) -> int:
        """Lanes that walk one column together at ``cluster`` blocks a row.

        The largest of 4, 8, 16, 32 with which a block's 512 threads take its
        whole share of columns in one round, and 4 where none does: on the
        H100 a round of columns costs about the same whatever the lanes per
        column (PERF.md §6), so one round comes first, and within it more
        lanes shorten each column's walk.
        """
        share = -(-self.S // cluster)
        g = 4
        while g < 32 and share * 2 * g <= _BLOCK_THREADS:
            g *= 2
        return g

    def share_vals(self, cluster: int) -> int:
        """The most finite entries that one block's share of columns holds."""
        share = -(-self.S // cluster)
        edges = np.minimum(np.arange(cluster + 1) * share, self.S)
        return int(np.diff(self.col_val[edges]).max())

    def on(self, device: torch.device) -> "RunTable":
        """This table with a copy of its arrays on ``device`` (:attr:`device`)."""
        arrays = {name: torch.from_numpy(getattr(self, name)).to(device)
                  for name in ("col_run", "col_val", "run_start", "run_len", "run_val")}
        # a valid pointer even where no entry is finite
        arrays["vals"] = torch.from_numpy(
            self.vals if self.vals.size else np.zeros(1, np.float32)).to(device)
        return RunTable(self.S, self.vals, self.col_run, self.col_val, self.run_start,
                        self.run_len, self.run_val, arrays)


def run_table(log_trans: np.ndarray) -> RunTable:
    """The :class:`RunTable` of an ``(S, S)`` matrix (rows p, columns n), on the host."""
    lt = np.asarray(log_trans, dtype=np.float32)
    S = lt.shape[0]
    finite = lt.T > -np.inf  # (n, p); NaN is not finite
    edges = np.diff(np.pad(finite, ((0, 0), (1, 1))).astype(np.int8), axis=1)
    col, start = np.nonzero(edges == 1)  # in order of column, then of p
    _, stop = np.nonzero(edges == -1)
    run_len = (stop - start).astype(np.int32)
    counts = finite.sum(axis=1)
    return RunTable(
        S=S, vals=np.ascontiguousarray(lt.T[finite], dtype=np.float32),
        col_run=np.concatenate([[0], np.cumsum(np.bincount(col, minlength=S))]).astype(np.int32),
        col_val=np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
        run_start=start.astype(np.int32), run_len=run_len,
        run_val=np.concatenate([[0], np.cumsum(run_len)[:-1]]).astype(np.int32)[:len(run_len)])


def device_runs(key: tuple, log_trans: np.ndarray, device: torch.device) -> RunTable:
    """The :class:`RunTable` of the host matrix ``log_trans`` on ``device``, built once per ``key``.

    ``key`` identifies the matrix, as the key of its :func:`device_table`
    copy does; the table is cached beside that copy, so later calls read
    nothing back from the card and build nothing.
    """
    return device_object(("viterbi_runs",) + tuple(key),
                         lambda dev: run_table(log_trans).on(dev), device)


def route_for(S: int, rows: int) -> str:
    """The forward pass's route for ``S`` states on ``rows`` rows."""
    if S >= CLUSTER_MIN_STATES and rows * CLUSTER <= _MAX_GRID:
        return "cluster"
    return "block"


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("viterbi")
    if lib.viterbi_block_forward.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        pi = ctypes.POINTER(ctypes.c_int)
        for name, args in (
                ("viterbi_block_forward", [p, p, p, i32, i32, i32, p, p, p, p]),
                ("viterbi_cluster_forward", [p] * 8 + [i32] * 6 + [p] * 4),
                ("viterbi_backtrack", [p, i32, i32, i32, p, p]),
                ("viterbi_cluster_occupancy", [i32, i32, i32, i32, pi]),
                ("viterbi_cluster_smem_vals", [i32, i32, i32]),
                ("viterbi_exchange_probe", [i32, i32, i32, i32, i32, p, p])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"viterbi {what} failed with CUDA error {err}")


def _runs_on(runs: Optional[RunTable], log_trans: torch.Tensor) -> RunTable:
    """``runs`` checked against ``log_trans``'s shape and device; built from it where None."""
    if runs is None:  # reads the matrix back to the host: callers that decode often pass runs
        return run_table(log_trans.detach().cpu().numpy()).on(log_trans.device)
    if runs.S != log_trans.shape[0] or runs.device is None \
            or runs.device["vals"].device != log_trans.device:
        raise ParameterError(f"the viterbi runs ({runs.S} states) are not those of a "
                             f"{tuple(log_trans.shape)} log_trans on {log_trans.device}: pass "
                             f"device_runs of that matrix on its device")
    return runs


def _cluster_forward(log_prob: torch.Tensor, log_p_init: torch.Tensor, runs: RunTable,
                     cluster: int, group: int, ptrs: torch.Tensor, states: torch.Tensor,
                     logp: torch.Tensor) -> int:
    """Launch the cluster route at ``cluster`` blocks a row and ``group`` lanes a column.

    :func:`forward` takes ``CLUSTER`` and :meth:`RunTable.group`; other
    values are for ``diagnostics/viterbi_cluster.py``. Returns the CUDA error.
    """
    R, T, S = log_prob.shape
    if R * cluster > _MAX_GRID:
        raise ParameterError(f"the cluster route takes fewer than 2**31 / {cluster} rows")
    d = runs.device
    return _kernel_lib().viterbi_cluster_forward(
        log_prob.data_ptr(), log_p_init.data_ptr(), d["vals"].data_ptr(),
        d["col_run"].data_ptr(), d["col_val"].data_ptr(), d["run_start"].data_ptr(),
        d["run_len"].data_ptr(), d["run_val"].data_ptr(), R, T, S, cluster, group,
        runs.share_vals(cluster), ptrs.data_ptr(), states.data_ptr(), logp.data_ptr(),
        torch.cuda.current_stream(log_prob.device).cuda_stream)


def forward(log_prob: torch.Tensor, log_trans: torch.Tensor, log_p_init: torch.Tensor,
            route: str, runs: Optional[RunTable] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward pass on the card by ``route``: ``(pointers, states, logp)``.

    ``pointers`` is the flat int16 buffer of ``(R, T, S)`` pointers (and 16
    bytes beyond, which the backtrack's staging may read); ``states`` has
    only its last frame set. Takes contiguous float32 CUDA tensors that
    :func:`kernel_refusal` takes. The cluster route walks ``runs``, the
    :class:`RunTable` of ``log_trans`` on its device (:func:`device_runs`),
    or builds it from ``log_trans`` where it is None. Adds nothing to
    :data:`launches`.
    """
    if route not in ROUTES:
        raise ParameterError(f"viterbi route {route!r} is not one of {ROUTES}")
    refusal = kernel_refusal(log_prob, log_trans, log_p_init)
    if refusal is not None:
        raise ParameterError(refusal)
    for t in (log_prob, log_trans, log_p_init):
        if t.device.type != "cuda" or t.device != log_prob.device or not t.is_contiguous():
            raise ParameterError("viterbi.forward takes contiguous tensors on one CUDA device")
    R, T, S = log_prob.shape
    dev = log_prob.device
    ptrs = torch.empty(R * T * S + 8, dtype=torch.int16, device=dev)
    states = torch.empty((R, T), dtype=torch.int32, device=dev)
    logp = torch.empty(R, dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "block":
            err = lib.viterbi_block_forward(log_prob.data_ptr(), log_trans.data_ptr(),
                                            log_p_init.data_ptr(), R, T, S, ptrs.data_ptr(),
                                            states.data_ptr(), logp.data_ptr(), stream)
        else:
            runs = _runs_on(runs, log_trans)
            err = _cluster_forward(log_prob, log_p_init, runs, CLUSTER, runs.group(CLUSTER),
                                   ptrs, states, logp)
    _check(err, f"{route} forward launch")
    return ptrs, states, logp


def backtrack(ptrs: torch.Tensor, states: torch.Tensor, S: int) -> torch.Tensor:
    """Fill ``states`` ``(R, T)`` from its last frame back through :func:`forward`'s pointers."""
    R, T = states.shape
    if (states.dtype != torch.int32 or not states.is_contiguous() or ptrs.dtype != torch.int16
            or ptrs.numel() < R * T * S + 8 or ptrs.device != states.device):
        raise ParameterError("viterbi.backtrack takes forward's int16 pointers and int32 states")
    lib = _kernel_lib()
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        err = lib.viterbi_backtrack(ptrs.data_ptr(), R, T, S, states.data_ptr(), stream)
    _check(err, "backtrack launch")
    return states


def viterbi_decode(log_prob: torch.Tensor, log_trans: torch.Tensor, log_p_init: torch.Tensor,
                   runs: Optional[RunTable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(states, logp)`` of the most likely state path of each row of ``log_prob``.

    On a CUDA tensor this launches the kernels where :func:`kernel_refusal`
    gives no reason, and raises with that reason otherwise; a failed build
    or launch raises too. On a CPU tensor it returns
    :func:`viterbi_reference` and ignores ``runs``. The cluster route walks
    ``runs``, ``log_trans``'s :class:`RunTable` on the card
    (:func:`device_runs`, as ``sequence._decode`` passes it): then nothing
    is copied to the host and nothing synchronises. Without it the call
    reads ``log_trans`` back to the host to build the table.
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
    route = route_for(S, R)
    ptrs, states, logp = forward(log_prob, log_trans, log_p_init, route, runs)
    backtrack(ptrs, states, S)
    launches += 1
    launches_by_route[route] += 1
    return states, logp


def max_active_clusters(runs: RunTable, cluster: int = CLUSTER) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster route's launch on this table, at
    ``cluster`` blocks a row (the route's own: ``CLUSTER``)."""
    out = ctypes.c_int(0)
    _check(_kernel_lib().viterbi_cluster_occupancy(runs.S, cluster, runs.group(cluster),
                                                   runs.share_vals(cluster), ctypes.byref(out)),
           "occupancy query")
    return out.value


def keeps_values_on_chip(runs: RunTable) -> bool:
    """Whether the cluster route holds each block's share of values in shared memory."""
    return bool(_kernel_lib().viterbi_cluster_smem_vals(runs.S, CLUSTER,
                                                        runs.share_vals(CLUSTER)))


def exchange_floor_ms(rows: int, T: int, runs: RunTable, cluster: int = CLUSTER,
                      repeats: int = 5) -> float:
    """The least time of the cluster route's frame exchange over ``T`` frames, in ms.

    Launches the probe in ``csrc/viterbi.cu`` that runs only each frame's
    distributed-shared-memory stores of ``v_t`` and its cluster barrier, with
    the launch's blocks and threads at ``cluster`` blocks a row (the route's
    own: ``CLUSTER``), on ``runs``'s device, and returns its best time of
    ``repeats`` by CUDA events. A measurement for the bound: it adds nothing
    to :data:`launches`.
    """
    device = runs.device["vals"].device
    out = torch.empty(rows, dtype=torch.float32, device=device)
    fn = _kernel_lib().viterbi_exchange_probe
    best = float("inf")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        for _ in range(repeats + 1):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
            err = fn(rows, T, runs.S, cluster, runs.group(cluster), out.data_ptr(),
                     stream.cuda_stream)
            end.record(stream)
            _check(err, "exchange probe launch")
            end.synchronize()
            best = min(best, start.elapsed_time(end))
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("viterbi exchange probe wrote non-finite values")
    return best
