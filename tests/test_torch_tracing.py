"""The port's tracer (``util.profiling``: ``annotate``, ``count``, ``recorded``) and the
benchmark's readers of its spans (``portbench/program_spans.py``, ``portbench/metrics/``), on the
CPU.

- With no profiler running ``annotate`` hands back one shared null context, records nothing and
  enters no ``record_function``; with one running, spans nest per thread and carry their parent,
  call and counters, on the clock of Kineto's events.
- The readers on a synthetic window and record, with the idle split closing on the window's idle
  time, and on a tiny traced run of ``onset_beat_pyin.clips``.
"""

import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import librosa_tpu_torch as L
from librosa_tpu_torch import beat
from librosa_tpu_torch.feature import rhythm
from librosa_tpu_torch.util import profiling
from librosa_tpu_torch.util import utils as util
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, program_spans, trace  # noqa: E402
from portbench.tests._tiny import run as run_tiny, tiny  # noqa: E402

NEW_METRICS = ("rhythm_idle_ms", "pitch_idle_ms", "beat_host_ms", "priors_launches",
               "sync_wait_ms", "host_syncs")
CPU_ACTIVITY = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _spans_since(mark: int) -> list:
    return [s for s in profiling.recorded().spans if s.index >= mark]


def _next_index() -> int:
    """An index below that of every span opened from now on."""
    return next(profiling._span_ids)


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lives on a CUDA device, for ``_host``'s card branch."""

    @property
    def is_cuda(self):
        return True


def _no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_off_annotate_is_the_shared_null_context_and_records_nothing(monkeypatch):
    _no_record_function(monkeypatch)
    before = profiling.recorded()
    ctx = profiling.annotate("idle")
    assert ctx is profiling.annotate("other") is profiling._NULL
    with profiling.annotate("outer"):
        with profiling.annotate("inner"):
            profiling.count("tracing_test_off")
    after = profiling.recorded()
    assert after.spans == before.spans and after.dropped == before.dropped
    assert profiling.counts()["tracing_test_off"] >= 1


def test_on_spans_nest_with_parent_call_and_self_times_that_add_up(monkeypatch):
    mark = _next_index()
    with torch.profiler.profile(activities=CPU_ACTIVITY) as prof:
        _no_record_function(monkeypatch)
        for _ in range(2):
            with profiling.annotate("call"):
                with profiling.annotate("a"):
                    torch.ones(64).sum()
                    with profiling.annotate("a.leaf"):
                        torch.ones(64).sum()
                with profiling.annotate("b"):
                    torch.ones(64).sum()
    spans = _spans_since(mark)
    assert [s.name for s in spans] == ["a.leaf", "a", "b", "call"] * 2
    assert not {"call", "a", "b", "a.leaf"} & {e.name() for e in
                                                prof.profiler.kineto_results.events()}
    for leaf, a, b, call in (spans[:4], spans[4:]):
        assert call.parent == -1 and call.call == call.index
        assert a.parent == b.parent == call.index and leaf.parent == a.index
        assert {leaf.call, a.call, b.call} == {call.index}
        assert call.start_ns <= a.start_ns <= leaf.start_ns <= leaf.end_ns <= a.end_ns
        assert a.end_ns <= b.start_ns <= b.end_ns <= call.end_ns
        # self times (a span less its children) and the children make up the whole
        durations = {s.name: s.end_ns - s.start_ns for s in (leaf, a, b, call)}
        self_call = durations["call"] - durations["a"] - durations["b"]
        self_a = durations["a"] - durations["a.leaf"]
        assert self_call >= 0 and self_a >= 0
        assert (program_spans.self_seconds([leaf, a, b, call], ("call", "a", "b", "a.leaf"))
                == pytest.approx(1e-9 * durations["call"]))
    assert spans[3].call != spans[7].call


def test_counters_land_on_the_innermost_span_and_in_the_totals():
    mark = _next_index()
    total = profiling.counts().get("tracing_test_on", 0)
    with torch.profiler.profile(activities=CPU_ACTIVITY):
        with profiling.annotate("outer"):
            profiling.count("tracing_test_on")
            with profiling.annotate("inner"):
                profiling.count("tracing_test_on", 3)
                profiling.count("tracing_test_other")
    inner, outer = _spans_since(mark)
    assert inner.counters == {"tracing_test_on": 3, "tracing_test_other": 1}
    assert outer.counters == {"tracing_test_on": 1}
    assert profiling.counts()["tracing_test_on"] == total + 4


def test_the_record_keeps_its_bound_and_counts_its_drops(monkeypatch):
    small = profiling.SpanRecord(3)
    monkeypatch.setattr(profiling, "_RECORD", small)
    with torch.profiler.profile(activities=CPU_ACTIVITY):
        for k in range(5):
            with profiling.annotate(f"s{k}"):
                pass
    rec = profiling.recorded()
    assert [s.name for s in rec.spans] == ["s2", "s3", "s4"]
    assert rec.dropped == 2 and rec.dropped_end_ns > 0
    assert rec.dropped_end_ns <= rec.spans[0].start_ns
    assert profiling.SPAN_CAPACITY >= 65536


def test_a_program_span_lies_inside_its_record_function_region_on_kinetos_clock():
    with torch.profiler.profile(activities=CPU_ACTIVITY) as prof:
        with torch.profiler.record_function("tracing_test_region"):
            with profiling.annotate("tracing_test_inside") as span:
                torch.ones(4096).cumsum(0)
    region = next(e for e in prof.profiler.kineto_results.events()
                  if e.name() == "tracing_test_region")
    start, end = region.start_ns(), region.start_ns() + region.duration_ns()
    slack = 500_000
    assert start - slack <= span.start_ns <= span.end_ns <= end + slack


def test_trace_writes_the_program_spans_on_the_traces_time_base(tmp_path):
    import json

    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("tracing_test_region"):
            with profiling.annotate("tracing_test_inside"):
                torch.ones(4096).cumsum(0)
    doc = json.loads(next(tmp_path.iterdir()).read_text())
    by_name = {e.get("name"): e for e in doc["traceEvents"]}
    region, inside = by_name["tracing_test_region"], by_name["tracing_test_inside"]
    assert inside["cat"] == "program_span" and inside["args"]["parent"] == -1
    assert region["ts"] - 500 <= inside["ts"]
    assert inside["ts"] + inside["dur"] <= region["ts"] + region["dur"] + 500


def test_dispatch_profile_records_the_programs_spans():
    mark = _next_index()
    profiling.dispatch_profile(lambda: util._host(torch.arange(3.0).as_subclass(_CudaLike)),
                               warmup=0)
    spans = _spans_since(mark)
    assert [(s.name, s.counters) for s in spans] == [("to_host", {"host_syncs": 1})]


def test_spans_and_counts_of_many_threads_stay_apart():
    threads_n, rounds = 12, 200
    mark = _next_index()
    total = profiling.counts().get("tracing_test_threads", 0)
    switch = sys.getswitchinterval()

    # torch's profiler, and so annotate, records only the thread that started it: the workers
    # open the spans annotate would give them directly
    def work():
        for _ in range(rounds):
            with profiling.Span("t.outer"):
                with profiling.Span("t.inner"):
                    profiling.count("tracing_test_threads")

    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads_n)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    spans = _spans_since(mark)
    by_index = {s.index: s for s in spans}
    inner = [s for s in spans if s.name == "t.inner"]
    assert len(inner) == len(spans) // 2 == threads_n * rounds
    for s in inner:
        parent = by_index[s.parent]
        assert parent.name == "t.outer" and parent.tid == s.tid
        assert s.counters == {"tracing_test_threads": 1}
    assert profiling.counts()["tracing_test_threads"] == total + threads_n * rounds


def test_host_copies_off_the_card_are_spanned_and_counted(monkeypatch):
    x = torch.arange(6.0).reshape(2, 3)
    mark = _next_index()
    with torch.profiler.profile(activities=CPU_ACTIVITY):
        got = util._host(x.as_subclass(_CudaLike))
        util._host(x)  # a CPU tensor: no copy off a card
    assert np.array_equal(got, x.numpy()) and type(got) is np.ndarray
    assert [(s.name, s.counters) for s in _spans_since(mark)] == [("to_host",
                                                                  {"host_syncs": 1})]
    # the rhythm path's copies off the card all go through _host
    seen = []

    def spy(value):
        seen.append(tuple(value.shape) if torch.is_tensor(value) else None)
        return np.asarray(value.detach().cpu().numpy() if torch.is_tensor(value) else value)

    monkeypatch.setattr(util, "_host", spy)
    env = torch.rand(2, 400, generator=torch.Generator().manual_seed(0))
    rhythm.tempo(onset_envelope=env)
    assert seen == [(2, 1)]
    seen.clear()
    beat._beat_tracker(env.numpy().astype(np.float64), np.array([[120.0], [100.0]]), 43.07,
                       100.0, True, torch.device("cpu"))
    assert seen == [(2, 400), (2, 400)]


def test_the_benchmarks_trace_arithmetic_is_the_ports():
    rng = np.random.default_rng(3)
    starts = rng.uniform(0, 100, 400)
    spans = [(float(s), float(s + d)) for s, d in zip(starts, rng.exponential(0.5, 400))]
    assert profiling._busy_us(spans) == trace.busy(spans)
    assert profiling._busy_us([]) == trace.busy([]) == 0.0
    assert profiling._LAUNCH_CALLS == trace.LAUNCH_CALLS


# -- the readers on a synthetic window: seconds from BASE, on the Unix clock ------------------

BASE = 1_790_000_000.0


def _span(name, start, end, index, parent=-1, **counters):
    return SimpleNamespace(name=name, start_ns=int(round((BASE + start) * 1e9)),
                           end_ns=int(round((BASE + end) * 1e9)), index=index, parent=parent,
                           call=index if parent == -1 else None, counters=counters)


def _synthetic(device=True):
    """Two calls' worth of spans in the window [10, 20]; the card idles over (11, 12),
    (13, 15) and (16, 19)."""
    kernels = [(10.0, 11.0), (12.0, 13.0), (15.0, 16.0), (19.0, 20.0)]
    events = trace.Events(
        device=[("k", BASE + a, BASE + b) for a, b in kernels] if device else [],
        launch_times=[BASE + t for t in (10.2, 15.1, 15.5, 16.4, 16.6, 17.0)] if device else [],
        window=(BASE + 10.0, BASE + 20.0))
    spans = [
        _span("pyin", 9.5, 10.2, 0),                      # begins before the window
        _span("onset_strength", 10.5, 11.5, 1),           # the gap (11, 12) straddles it ...
        _span("to_host", 11.6, 11.9, 3, 2, host_syncs=1),
        _span("tempo", 11.5, 12.5, 2),                    # ... and tempo
        _span("to_host", 12.7, 12.8, 6, 5, host_syncs=1),
        _span("beat.local_score", 12.6, 13.0, 5, 4),
        _span("beat.backtrack", 13.2, 13.5, 7, 4),
        _span("beat.trim", 13.6, 13.8, 8, 4),
        _span("beat_track", 12.5, 14.0, 4),
        _span("pyin.priors", 15.0, 16.5, 10, 9),
        _span("pyin", 14.5, 18.0, 9),
        _span("tempo", 21.0, 22.0, 11),                   # after the window
    ]
    return harness.Reading(events=events, calls=2, span_ms={}), spans


def _record(spans, dropped=0, dropped_end_ns=0):
    return SimpleNamespace(spans=tuple(spans), dropped=dropped, dropped_end_ns=dropped_end_ns)


@pytest.mark.parametrize("suffix", ["catalog", "clips"])
def test_each_reader_on_a_synthetic_window(monkeypatch, suffix):
    reading, spans = _synthetic()
    monkeypatch.setattr(program_spans, "record", lambda: _record(spans))
    cell = tiny(f"onset_beat_pyin.{suffix}")
    got = {m: cell.reader(f"{m}.{suffix}").read(reading) for m in NEW_METRICS}
    want = {"rhythm_idle_ms": 1e3 * (0.5 + 0.5 + 1.0) / 2, "pitch_idle_ms": 1e3 * 2.5 / 2,
            "beat_host_ms": 1e3 * (0.3 + 0.3 + 0.2) / 2, "priors_launches": 3 / 2,
            "sync_wait_ms": 1e3 * 0.4 / 2, "host_syncs": 2 / 2}
    assert got == pytest.approx(want, rel=1e-5)


def test_the_idle_split_closes_on_the_windows_idle_time():
    reading, spans = _synthetic()
    inside = program_spans.window_spans(reading, _record(spans))
    assert {s.index for s in inside} == set(range(1, 11))
    split = program_spans.idle_split(reading, inside)
    lo, hi = reading.events.window
    idle = (hi - lo) - reading.events.busy_seconds()
    assert sum(split.values()) == pytest.approx(idle, rel=1e-9) and idle == pytest.approx(6.0)
    assert split == pytest.approx({"onset_strength": 0.5, "tempo": 0.5, "beat_track": 1.0,
                                   "pyin": 2.5, None: 1.5}, abs=1e-5)


@pytest.mark.parametrize("case", ["dropped_in_window", "no_span_in_window", "no_device_events",
                                  "dropped_before_window", "no_record"])
def test_when_the_readers_read_nothing(monkeypatch, case):
    reading, spans = _synthetic(device=case != "no_device_events")
    lo_ns = int(round((BASE + 10.0) * 1e9))
    rec = {"dropped_in_window": _record(spans, 4, lo_ns + 1),
           "no_span_in_window": _record([spans[0], spans[-1]]),
           "no_device_events": _record(spans),
           "dropped_before_window": _record(spans, 4, lo_ns - 1),
           "no_record": None}[case]
    monkeypatch.setattr(program_spans, "record", lambda: rec)
    got = {m: program_spans_reader(m).read(reading) for m in NEW_METRICS}
    if case in ("dropped_in_window", "no_span_in_window", "no_record"):
        assert all(v is None for v in got.values()), got
    elif case == "no_device_events":
        assert got["rhythm_idle_ms"] is got["pitch_idle_ms"] is got["priors_launches"] is None
        assert got["beat_host_ms"] == pytest.approx(400.0) and got["host_syncs"] == 1.0
    else:
        assert all(v is not None for v in got.values()), got


def program_spans_reader(metric):
    return tiny("onset_beat_pyin.clips").reader(f"{metric}.clips")


def test_a_tiny_traced_run_of_the_clip_cell_reads_the_new_metrics():
    res = run_tiny(tiny("onset_beat_pyin.clips"), traced=True)
    assert res["correct"]
    got = {name.split(".")[0]: m["value"] for name, m in res["metrics"].items()}
    # the CPU has no device events and copies nothing off a card
    assert not {"rhythm_idle_ms", "pitch_idle_ms", "priors_launches"} & set(got)
    assert got["beat_host_ms"] > 0
    assert got["sync_wait_ms"] == 0.0 and got["host_syncs"] == 0.0
