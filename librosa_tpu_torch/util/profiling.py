"""Tracing, launch counts and roofline accounting over ``torch.profiler``.

- :func:`annotate` / :func:`count` / :func:`recorded`: the program's own
  spans and counters. They record only while a torch profiler runs (the
  flag the profiler sets is the switch), on the Unix clock that Kineto
  stamps its host and device events with, so a span can be set against
  the device's timeline.
- :func:`trace`: a Chrome trace of a block, with the program's spans in it.
- :func:`dispatch_profile`: kernel launches, top-level torch ops and
  host-device copies in one call, read from the profiler's event list.
- :func:`calibrate`: this device's sustained float32 and bfloat16 matrix
  product rates and its elementwise memory rate, measured.
- :func:`roofline`: a function's time beside its operations and bytes as
  the torch dispatcher sees them, against those ceilings.

Kernels that the port launches itself through ``ctypes`` (``csrc/*.cu``)
are seen by the profiler, whose CUDA activity covers every launch, but not
by :func:`roofline`'s counters, which see torch ops only.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from .._device import as_tensor, exact_f32

__all__ = [
    "trace",
    "annotate",
    "count",
    "counts",
    "recorded",
    "calibrate",
    "roofline",
    "dispatch_profile",
    "DeviceCeilings",
    "RooflineReport",
]

# CUDA runtime and driver calls that launch a kernel
_LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                           "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch"})

# the C-level flag that torch.profiler sets in the thread it records (~0.1 us a call)
_tracing = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_counts_lock = threading.Lock()
_THREAD_COUNTS: list = []


class _Thread(threading.local):
    """Each thread's stack of open spans, its counters (kept for :func:`counts` after the
    thread ends) and its native id, read once (a system call)."""

    def __init__(self) -> None:
        self.stack: list = []
        self.counts: dict = {}
        self.tid = threading.get_native_id()
        with _counts_lock:
            _THREAD_COUNTS.append(self.counts)


_local = _Thread()
_span_ids = itertools.count()


class Span:
    """One region the program recorded: ``name``, ``start_ns`` and ``end_ns`` from
    ``time.time_ns()``, its own ``index``, its ``parent``'s index (-1 for none), ``call``
    (the index of its outermost span: one per public call), the native thread id ``tid``
    and the ``counters`` added while it was the innermost open span."""

    __slots__ = ("name", "start_ns", "end_ns", "index", "parent", "call", "tid", "counters")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "Span":
        mine = _local
        stack = mine.stack
        outer = stack[-1] if stack else None
        self.index = next(_span_ids)
        self.parent = outer.index if outer else -1
        self.call = outer.call if outer else self.index
        self.tid = mine.tid
        self.counters = {}
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.end_ns = time.time_ns()
        _local.stack.pop()
        _RECORD.add(self)
        return False


class Recorded(NamedTuple):
    """What :func:`recorded` returns: the spans held, oldest first, how many were dropped to
    keep the bound, and the latest ``end_ns`` among those dropped (0 if none)."""
    spans: tuple
    dropped: int
    dropped_end_ns: int


class SpanRecord:
    """Finished spans in memory, at most ``capacity``: a full record drops its oldest span for
    each new one and counts what it drops."""

    def __init__(self, capacity: int):
        self._spans = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0
        self.dropped_end_ns = 0

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
                self.dropped_end_ns = max(self.dropped_end_ns, self._spans[0].end_ns)
            self._spans.append(span)

    def read(self) -> Recorded:
        with self._lock:
            return Recorded(tuple(self._spans), self.dropped, self.dropped_end_ns)


SPAN_CAPACITY = 1 << 16
_RECORD = SpanRecord(SPAN_CAPACITY)


def annotate(name: str):
    """A named span of the program, as a context manager.

    While no torch profiler records the calling thread (torch's profiler
    records the thread that started it) this returns a shared null context
    and records nothing. While one does, the span is kept in the program's
    record (:func:`recorded`) with its start, end, parent and call, and
    :func:`trace` writes it into its Chrome trace. Spans nest per thread.
    """
    if not _tracing():
        return _NULL
    return Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the program's counter ``name``, and to the innermost open span's."""
    mine = _local
    mine.counts[name] = mine.counts.get(name, 0) + n
    if mine.stack:
        counters = mine.stack[-1].counters
        counters[name] = counters.get(name, 0) + n


def counts() -> dict:
    """The program's counters since the process started, summed over its threads."""
    total: dict = {}
    with _counts_lock:
        for per_thread in _THREAD_COUNTS:
            for name, n in list(per_thread.items()):
                total[name] = total.get(name, 0) + n
    return total


def recorded() -> Recorded:
    """The spans the program has recorded (at most :data:`SPAN_CAPACITY`, the newest) and
    what the bound dropped."""
    return _RECORD.read()


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _add_spans(path: str, spans) -> None:
    """Write ``spans`` into the Chrome trace at ``path`` as complete events, in microseconds
    from the trace's ``baseTimeNanoseconds``."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    doc.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.tid,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"index": s.index, "parent": s.parent, "call": s.call,
                  "counters": s.counters}}
        for s in spans)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block (CPU, and CUDA where present) and write its Chrome trace,
    with the program's spans of the block, into ``log_dir`` as ``trace_<pid>_<ns>.json``."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        begun = time.time_ns()
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in recorded().spans if s.start_ns >= begun])


def _busy_us(spans: list) -> float:
    """Length of the union of ``(start, end)`` spans, in their unit."""
    busy, reach = 0.0, -np.inf
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def dispatch_profile(fn: Callable[[], Any], *, warmup: int = 1) -> dict:
    """Count what one call of ``fn`` launches.

    Runs ``fn`` ``warmup`` times, then once under ``torch.profiler`` (CUDA
    activity where a card is present) and reads the profiler's events:

    - ``launches``: CUDA runtime kernel-launch calls (``cudaLaunchKernel``
      and its kin), the port's own ``ctypes`` launches included;
    - ``eager``: top-level torch ops (events with no parent whose name has
      an operator namespace, ``aten::...``);
    - ``transfers``: host-to-device and device-to-host copies;
    - ``by_function``: each device kernel's name, or on a host-only run
      each top-level op's, with its count, most frequent first;
    - ``device_s`` and ``wall_s``: the union of the device's kernel and
      copy spans, and the host time of the call (which ends by
      synchronising), so that ``device_s / wall_s`` is the busy share.
    """
    for _ in range(warmup):
        fn()
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=_activities()) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = eager = transfers = 0
    kernels: dict = {}
    ops: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            if e.name.startswith(("Memcpy HtoD", "Memcpy DtoH")):
                transfers += 1
            elif not e.name.startswith(("Memcpy", "Memset")):
                kernels[e.name] = kernels.get(e.name, 0) + 1
        elif e.name in _LAUNCH_CALLS:
            launches += 1
        elif e.cpu_parent is None and "::" in e.name:
            eager += 1
            ops[e.name] = ops.get(e.name, 0) + 1
    by_function = kernels or ops
    return {
        "launches": launches,
        "eager": eager,
        "transfers": transfers,
        "by_function": dict(sorted(by_function.items(), key=lambda kv: -kv[1])),
        "device_s": _busy_us(spans) * 1e-6,
        "wall_s": wall,
    }


@dataclass
class DeviceCeilings:
    """Measured sustained rates of one device, from :func:`calibrate`.

    Attributes
    ----------
    matmul_f32_flops : float
        exact float32 (no TF32) matrix product FLOP/s
    matmul_bf16_flops : float
        bfloat16 matrix product FLOP/s (NaN when not probed)
    hbm_bytes_per_s : float
        elementwise read + write bytes/s
    """

    matmul_f32_flops: float
    matmul_bf16_flops: float
    hbm_bytes_per_s: float


def _seconds(fn: Callable[[], Any], device: torch.device, iters: int) -> float:
    """Mean seconds of ``fn()`` over ``iters`` calls after one warm-up: CUDA events on a card,
    the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e-3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def calibrate(device: Any = None, *, size: int = 4096, chain: int = 16,
              include_bf16: bool = True) -> DeviceCeilings:
    """Measure matrix product rates and the memory rate of ``device`` (default: the package's).

    Each probe runs ``chain`` dependent operations a call: products of
    ``(size, size)`` float32 operands inside
    :func:`~librosa_tpu_torch._device.exact_f32`, the same in bfloat16
    (``include_bf16``), and a ``roll`` then a scale of ``2 * size**2``
    floats (two reads and two writes of the buffer a step; 128 MB at the
    default size). Timed by CUDA events on a card, by the host clock on
    the CPU.
    """
    rng = np.random.RandomState(0)
    a_np = rng.randn(size, size).astype(np.float32)
    # a right-hand side of spectral radius about 1 keeps the chained product bounded
    b_np = (rng.randn(size, size) / np.sqrt(size)).astype(np.float32)
    x_np = rng.randn(2 * size * size).astype(np.float32)
    if device is None:
        a, b, x = as_tensor(a_np), as_tensor(b_np), as_tensor(x_np)
    else:
        a, b, x = (torch.from_numpy(v).to(device) for v in (a_np, b_np, x_np))
    dev = a.device

    def chain_mm(lhs: torch.Tensor, rhs: torch.Tensor) -> Callable[[], torch.Tensor]:
        def run() -> torch.Tensor:
            acc = lhs
            for _ in range(chain):
                acc = acc @ rhs
            return acc
        return run

    flops = chain * 2 * size ** 3
    with exact_f32():
        t_f32 = _seconds(chain_mm(a, b), dev, 3)
    t_bf16 = (_seconds(chain_mm(a.bfloat16(), b.bfloat16()), dev, 3) if include_bf16
              else float("nan"))

    def elementwise() -> torch.Tensor:
        y = x
        for _ in range(chain):
            y = torch.roll(y, 12345) * 1.0000001
        return y

    t_ew = _seconds(elementwise, dev, 3)
    return DeviceCeilings(matmul_f32_flops=flops / t_f32,
                          matmul_bf16_flops=flops / t_bf16,
                          hbm_bytes_per_s=chain * 4 * x.nbytes / t_ew)


@dataclass
class RooflineReport:
    """Time and rates of one function, from :func:`roofline`.

    ``flops`` and ``bytes_accessed`` are what the torch dispatcher saw;
    each utilisation is the achieved rate over the :class:`DeviceCeilings`
    given, and ``bound`` names the larger share (``'compute'``,
    ``'memory'`` or ``'unknown'``). ``str()`` is a one-line summary.
    """

    seconds: float
    flops: Optional[float]
    bytes_accessed: Optional[float]
    achieved_flops: Optional[float]
    achieved_bandwidth: Optional[float]
    compute_utilization: Optional[float]   # against matmul_f32_flops
    bandwidth_utilization: Optional[float]
    bound: str

    def __str__(self) -> str:
        def fmt(v, unit, scale):
            return "n/a" if v is None else f"{v / scale:.2f} {unit}"

        return (
            f"time {self.seconds * 1e3:.2f} ms | "
            f"{fmt(self.achieved_flops, 'TF/s', 1e12)} "
            f"({'' if self.compute_utilization is None else f'{100 * self.compute_utilization:.0f}%'} of ceiling) | "
            f"{fmt(self.achieved_bandwidth, 'GB/s', 1e9)} "
            f"({'' if self.bandwidth_utilization is None else f'{100 * self.bandwidth_utilization:.0f}%'}) | "
            f"{self.bound}-bound"
        )


def _byte_counter():
    """A dispatch mode that sums the input and output bytes of every op it sees (views
    left out: they move nothing)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class ByteCounter(TorchDispatchMode):
        def __init__(self) -> None:
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                self.bytes += sum(t.numel() * t.element_size()
                                  for t in tree_leaves((args, kwargs, out))
                                  if isinstance(t, torch.Tensor))
            return out

    return ByteCounter()


def roofline(fn: Callable, *args: Any, ceilings: Optional[DeviceCeilings] = None,
             iters: int = 3, **kwargs: Any) -> RooflineReport:
    """Time ``fn(*args, **kwargs)`` and relate it to the device's ceilings.

    FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, bytes from
    a dispatch mode that sums each op's input and output bytes, both over
    one call: only torch ops count, so a function that reaches one of the
    port's ``ctypes`` kernels reports what torch saw around it. The time
    is the mean of ``iters`` calls after that one (host clock, ending in a
    synchronise where the arguments are on a card). ``ceilings`` defaults
    to :func:`calibrate` on the arguments' device.
    """
    from torch.utils.flop_counter import FlopCounterMode

    device = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    cuda = device is not None and device.type == "cuda"
    with FlopCounterMode(display=False) as flop_mode, _byte_counter() as byte_mode:
        fn(*args, **kwargs)
    flops = float(flop_mode.get_total_flops()) or None
    bytes_accessed = float(byte_mode.bytes) or None
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    if cuda:
        torch.cuda.synchronize(device)
    seconds = (time.perf_counter() - t0) / iters

    if ceilings is None:
        ceilings = calibrate(device)
    achieved_flops = None if flops is None else flops / seconds
    achieved_bw = None if bytes_accessed is None else bytes_accessed / seconds
    cu = None if achieved_flops is None else achieved_flops / ceilings.matmul_f32_flops
    bu = None if achieved_bw is None else achieved_bw / ceilings.hbm_bytes_per_s
    if cu is None and bu is None:
        bound = "unknown"
    elif (cu or 0) >= (bu or 0):
        bound = "compute"
    else:
        bound = "memory"
    return RooflineReport(seconds=seconds, flops=flops, bytes_accessed=bytes_accessed,
                          achieved_flops=achieved_flops, achieved_bandwidth=achieved_bw,
                          compute_utilization=cu, bandwidth_utilization=bu, bound=bound)
