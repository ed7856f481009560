"""The program's own spans (``librosa_tpu_torch.util.profiling``) in the profiled window, and the
arithmetic the per-layer metrics do on them.

The port records a span only while a torch profiler runs, on the Unix clock that Kineto stamps
its events with, so its spans and the window's device events share one timeline. The arithmetic
lives here, on the benchmark's side, so that an edit to the port's helpers cannot move a metric.
A reading is None where the port has no span record (an older tree), where the record dropped
spans inside the window, or where no program span lies in it.
"""

from __future__ import annotations

from bisect import bisect_right

from portbench import trace

RHYTHM = ("onset_strength", "tempo", "beat_track")
PITCH = ("pyin",)
BEAT_HOST = ("beat.local_score", "beat.backtrack", "beat.trim")


def record():
    """The port's span record (``spans``, ``dropped``, ``dropped_end_ns``), or None where the
    port records no spans."""
    try:
        from librosa_tpu_torch.util import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return recorded() if recorded is not None else None


def window_spans(reading, rec=None):
    """The program's spans that begin and end inside the profiled window, or None."""
    rec = record() if rec is None else rec
    lo, hi = reading.events.window
    if rec is None or hi <= lo or not reading.calls:
        return None
    lo_ns, hi_ns = lo * 1e9, hi * 1e9
    if rec.dropped and rec.dropped_end_ns >= lo_ns:
        return None
    spans = [s for s in rec.spans if s.start_ns >= lo_ns and s.end_ns <= hi_ns]
    return spans or None


def _per_call_ms(reading, seconds: float) -> float:
    return 1e3 * seconds / reading.calls


def _outermost(spans) -> list:
    """``(start, end, name)`` in seconds of each span whose parent is not in ``spans``, sorted,
    each start moved to the previous one's end where two overlap (the earlier keeps the
    overlap)."""
    held = {s.index for s in spans}
    roots = sorted((s.start_ns * 1e-9, s.end_ns * 1e-9, s.name) for s in spans
                   if s.parent not in held)
    out, reach = [], float("-inf")
    for start, end, name in roots:
        start = max(start, reach)
        if end > start:
            out.append((start, end, name))
            reach = end
    return out


def idle_split(reading, spans) -> dict:
    """Seconds of the window in which the card was idle, by the name of the outermost program
    span open at each instant (``None``: no program span open). The values add up to the
    window's idle time. Idle stretches are the gaps between device events, as
    :func:`trace.gaps` finds them."""
    lo, hi = reading.events.window
    idle = trace.gaps([(s, e) for _, s, e in reading.events.device], lo, hi)
    roots = _outermost(spans)
    split: dict = {}
    j = 0
    for a, b in idle:
        covered = 0.0
        while j < len(roots) and roots[j][1] <= a:
            j += 1
        k = j
        while k < len(roots) and roots[k][0] < b:
            start, end, name = roots[k]
            part = min(b, end) - max(a, start)
            if part > 0:
                split[name] = split.get(name, 0.0) + part
                covered += part
            k += 1
        split[None] = split.get(None, 0.0) + (b - a) - covered
    return split


def idle_ms(reading, names):
    """Idle ms of the card per call under outermost program spans named ``names``."""
    spans = window_spans(reading)
    if spans is None or not reading.events.device:
        return None
    split = idle_split(reading, spans)
    return _per_call_ms(reading, sum(split.get(n, 0.0) for n in names))


def self_seconds(spans, names) -> float:
    """Host self time of the spans named ``names``: each one's duration less its children's."""
    children: dict = {}
    for s in spans:
        children[s.parent] = children.get(s.parent, 0) + (s.end_ns - s.start_ns)
    return 1e-9 * sum((s.end_ns - s.start_ns) - children.get(s.index, 0)
                      for s in spans if s.name in names)


def self_ms(reading, names):
    """Host self ms per call of the spans named ``names``."""
    spans = window_spans(reading)
    return None if spans is None else _per_call_ms(reading, self_seconds(spans, names))


def inside_ms(reading, name: str):
    """Host ms per call inside spans named ``name``."""
    spans = window_spans(reading)
    if spans is None:
        return None
    return _per_call_ms(reading, 1e-9 * sum(s.end_ns - s.start_ns for s in spans
                                            if s.name == name))


def launches_in(reading, name: str):
    """Launch calls per call of the profiled window that fall inside spans named ``name``."""
    spans = window_spans(reading)
    if spans is None or not reading.events.device:
        return None
    inside = sorted((s.start_ns * 1e-9, s.end_ns * 1e-9) for s in spans if s.name == name)
    starts = [a for a, _ in inside]
    hits = 0
    for t in reading.events.launch_times:
        i = bisect_right(starts, t) - 1
        if i >= 0 and t <= inside[i][1]:
            hits += 1
    return hits / reading.calls


def counter_per_call(reading, counter: str):
    """The program's counter ``counter`` summed over the window's spans, per call."""
    spans = window_spans(reading)
    if spans is None:
        return None
    return sum(s.counters.get(counter, 0) for s in spans) / reading.calls
