"""What a traced window holds, read from ``torch.profiler``'s events, and the arithmetic on it.

The busy-time union and the launch count copy ``librosa_tpu_torch/util/profiling.py``'s
``_busy_us`` and ``dispatch_profile``: the union of the device's kernel, copy and set spans,
and the runtime calls that launch a kernel (the port's own ``ctypes`` launches among them).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

# CUDA runtime and driver calls that launch a kernel
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                          "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch"})
WINDOW = "portbench.window"


def busy(spans) -> float:
    """Length of the union of ``(start, end)`` spans, in their unit."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def gaps(spans, lo: float, hi: float):
    """``(start, end)`` of each stretch of ``[lo, hi]`` that no span covers."""
    out, reach = [], lo
    for start, end in sorted(spans):
        if start > reach:
            out.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [g for g in out if g[1] > g[0]]


def short_name(name: str) -> str:
    """A kernel's name cut to 64 characters of letters, digits, ``_``, ``.``, ``:`` and ``-``."""
    return re.sub(r"[^A-Za-z0-9_.:-]+", "_", name)[:64]


@dataclass
class Events:
    """One traced window: device spans by name, launches, and the benchmark's host spans.
    Times are in seconds on the profiler's clock."""
    device: list = field(default_factory=list)     # (name, start, end) of kernels, copies, sets
    host: list = field(default_factory=list)       # (name, start, end) of the benchmark's spans
    launch_times: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)

    @property
    def launches(self) -> int:
        lo, hi = self.window
        return sum(1 for t in self.launch_times if lo <= t <= hi)

    def kernel_seconds(self, patterns) -> float:
        return sum(e - s for n, s, e in self.device if any(p in n for p in patterns))

    def busy_seconds(self) -> float:
        lo, hi = self.window
        return busy((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)

    def top_ops(self, k: int = 10):
        totals: dict = {}
        for n, s, e in self.device:
            totals[n] = totals.get(n, 0.0) + (e - s)
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[short_name(n), t] for n, t in ranked]

    def idle_gaps(self, k: int = 10):
        """The ``k`` longest idle stretches of the device, each named by the benchmark span
        that was open on the host at its middle (the innermost, if several)."""
        lo, hi = self.window
        found = gaps([(s, e) for _, s, e in self.device], lo, hi)
        found.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in found[:k]:
            mid = 0.5 * (a + b)
            open_ = [(s, n) for n, s, e in self.host if s <= mid <= e]
            out.append([max(open_)[1] if open_ else "outside_spans", b - a])
        return out


def _num(e, ns: str, us: str) -> float:
    """A timestamp or duration of a Kineto event in seconds, whichever unit this torch gives."""
    if hasattr(e, ns):
        return getattr(e, ns)() * 1e-9
    return getattr(e, us)() * 1e-6


def _annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def read(prof, span_names) -> Events:
    """The :class:`Events` of a finished ``torch.profiler.profile`` whose window is the span
    named :data:`WINDOW`; ``span_names`` are the benchmark's own spans to keep."""
    import torch

    out = Events()
    keep = set(span_names)
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = _num(e, "start_ns", "start_us")
        end = start + _num(e, "duration_ns", "duration_us")
        if e.device_type() == cuda:
            # a span's image on the device's timeline covers its gaps too: not device work
            if name in keep or name == WINDOW or _annotation(e):
                continue
            out.device.append((name, start, end))
        elif name in LAUNCH_CALLS:
            out.launch_times.append(start)
        elif name == WINDOW:
            out.window = (start, end)
        elif name in keep:
            out.host.append((name, start, end))
    lo, hi = out.window
    out.device = [d for d in out.device if d[2] > lo and d[1] < hi]
    return out
