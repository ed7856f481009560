"""The benchmark's harness: find a cell's files by name, set it up, run its window, check it.

A cell is ``<config>.<traffic>`` in ``BENCHMARK.json``. Its files are found
by name alone, so that a later change adds a cell with new files and new
entries and edits none:

- ``configs/<config>.json``, the configuration as it is run (the ``file``
  that ``BENCHMARK.json`` names), and ``configs/<config>.py``: the
  forward through the port's public calls (``forward(cfg)``), the outputs
  a request returns (``RESPONSE``) and each hand kernel's work
  (``work(cfg, rows, samples)``);
- ``traffic/<traffic>.json``, the mix's parameters, updated by
  ``traffic/<config>.<traffic>.json`` where that exists; ``loop`` names
  one of :data:`LOOPS` and ``signal`` a function of ``signals.py``;
- ``reference/<config>.py``: ``compute``, ``compare`` and ``LIMITS``;
- ``metrics/<metric>.py`` (or ``metrics/<name before its first dot>.py``):
  ``read(reading)``, which returns the metric or None where there is
  nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import roofline, signals, trace

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "librosa_tpu"})
POOL_SEED_STRIDE = 1_000_003


def process_start() -> float:
    """Wall-clock time at which this process started (Linux), else the time now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything its files hold."""
    name: str
    config: str
    traffic: str
    chips: int
    cfg: dict
    mix: dict
    model: object
    reference: object
    end_to_end: list
    per_layer: list
    root: Path

    def reader(self, metric: str):
        path = self.root / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.root / "metrics" / f"{metric.split('.')[0]}.py"
        return _load(path, f"portbench_metric_{metric.replace('.', '_')}")


def find_cell(workload: str, bench: Path = BENCHMARK, root: Path = HERE) -> Cell:
    """The cell named ``workload`` in ``bench``, its files read from ``root``."""
    spec = json.loads(Path(bench).read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {bench}")
    config, traffic = entry["config"], entry["traffic"]
    conf = next(c for c in spec["configs"] if c["name"] == config)
    cfg = json.loads((Path(bench).parent / conf["file"]).read_text())
    mix = json.loads((root / "traffic" / f"{traffic}.json").read_text())
    override = root / "traffic" / f"{config}.{traffic}.json"
    if override.exists():
        mix.update(json.loads(override.read_text()))

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(name=workload, config=config, traffic=traffic, chips=int(entry["chips"]),
                cfg=cfg, mix=mix,
                model=_load(root / "configs" / f"{config}.py", f"portbench_config_{config}"),
                reference=_load(root / "reference" / f"{config}.py",
                                f"portbench_reference_{config}"),
                end_to_end=[m for m in spec["end_to_end"] if applies(m)],
                per_layer=[m for m in spec["per_layer"] if applies(m)], root=root)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """The benchmark's spans around the calls into the port: nothing (``'off'``), profiler
    regions (``'profile'``), or host-clock totals that end in a synchronisation (``'timed'``)."""

    def __init__(self, mode: str, device: torch.device):
        self.mode, self.device, self.totals, self.seen = mode, device, {}, set()

    def __call__(self, name: str):
        self.seen.add(name)
        if self.mode == "profile":
            return torch.profiler.record_function(name)
        if self.mode == "timed":
            return self._timed(name)
        return nullcontext()

    @contextmanager
    def _timed(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t


class Reservoir:
    """A sample of ``k`` calls of a window of unknown length, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items = k, random.Random(seed), []

    def wants(self, i: int) -> int:
        """The slot call ``i`` would take, or -1."""
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else -1

    def put(self, slot: int, item) -> None:
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item


def _host(value):
    """A tensor copied to the host (into pinned memory from the card, without waiting), or
    ``value`` as it is."""
    return value.to("cpu", non_blocking=True) if torch.is_tensor(value) else value


def catalog_loop(fwd, inputs, seconds, spans, keep, device, response, min_calls=0) -> dict:
    """Calls on batches resident on the card, back to back; one synchronisation at the end."""
    sync(device)
    wall0, t0, calls = time.time(), time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds or calls < min_calls:
        k = calls % len(inputs)
        slot = keep.wants(calls)
        out = fwd(inputs[k], spans)
        if slot >= 0:
            keep.put(slot, (k, out))
        calls += 1
    sync(device)
    return {"wall0": wall0, "calls": calls, "elapsed": time.perf_counter() - t0}


def requests_loop(fwd, inputs, seconds, spans, keep, device, response, min_calls=0) -> dict:
    """One client in a closed loop: each request copies its batch from pinned host memory to the
    card, runs the forward, and copies ``response`` back; it is timed until its results are on
    the host."""
    sync(device)
    wall0, t0, latencies = time.time(), time.perf_counter(), []
    while time.perf_counter() - t0 < seconds or len(latencies) < min_calls:
        i = len(latencies)
        k = i % len(inputs)
        slot = keep.wants(i)
        start = time.perf_counter()
        with spans("h2d"):
            y = inputs[k].to(device, non_blocking=True)
        out = fwd(y, spans)
        with spans("d2h"):
            back = {key: _host(out[key]) for key in response}
        sync(device)
        latencies.append(time.perf_counter() - start)
        if slot >= 0:
            keep.put(slot, (k, {**out, **back}))
    return {"wall0": wall0, "calls": len(latencies), "elapsed": time.perf_counter() - t0,
            "latencies": latencies}


LOOPS = {"catalog": catalog_loop, "requests": requests_loop}


def pool_seeds(cell: Cell, seed: int) -> list:
    """The seed of each batch of the mix's pool."""
    return [seed + k * POOL_SEED_STRIDE for k in range(int(cell.mix["pool"]))]


def grid_line(cell: Cell, seed: int, device: torch.device):
    """The tempi and starting pitches that the pool's batches play, as a line for standard
    error: their ranges and each batch's first row's tempo; None for a signal without them."""
    grid = signals.GRIDS.get(cell.mix["signal"])
    if grid is None:
        return None
    bpm, f0 = zip(*(grid(int(cell.mix["rows"]), s, device)[1:] for s in pool_seeds(cell, seed)))
    bpm, f0 = torch.cat(bpm, 1).cpu(), torch.cat(f0, 1).cpu()
    return (f"draws: tempo {bpm.min().item():.4f}-{bpm.max().item():.4f} BPM, first rows "
            + " ".join(f"{b:.4f}" for b in bpm[0].tolist())
            + f" BPM, start pitch {f0.min().item():.4f}-{f0.max().item():.4f} Hz")


def make_inputs(cell: Cell, seed: int, device: torch.device) -> list:
    """The mix's pool of batches from ``seed``: on the card for a catalogue, in pinned host
    memory for requests. Every seed gives the same sizes."""
    make = getattr(signals, cell.mix["signal"])
    pool = []
    for batch_seed in pool_seeds(cell, seed):
        y = make(int(cell.mix["rows"]), int(cell.mix["samples"]), batch_seed, device,
                 cell.cfg["sr"])
        if cell.mix["loop"] == "requests":
            y = y.cpu()
            if device.type == "cuda":
                y = y.pin_memory()
        pool.append(y)
    return pool


@dataclass
class Reading:
    """What per-layer readers read: the profiled window's events and calls, the timed
    window's spans in ms per call, and each hand kernel's work per call."""
    events: trace.Events
    calls: int
    span_ms: dict
    work: dict = field(default_factory=dict)

    def roofline_pct(self, kernel: str):
        """The kernel's share of its roofline, in %, or None where it did not run."""
        w = self.work.get(kernel)
        spent = self.events.kernel_seconds(w["kernels"]) if w else 0.0
        if not w or spent <= 0 or not self.calls:
            return None
        return 100.0 * self.calls * roofline.least_seconds(w) / spent


def e2e_metrics(cell: Cell, window: dict, setup_s: float) -> dict:
    """The cell's end-to-end metrics from its measured window."""
    rows, samples = int(cell.mix["rows"]), int(cell.mix["samples"])
    values = {"setup_s": setup_s}
    if "latencies" in window:
        values["call_p95_ms"] = 1e3 * float(np.percentile(window["latencies"], 95))
    else:
        audio_s = window["calls"] * rows * samples / cell.cfg["sr"]
        values["audio_rate"] = audio_s / window["elapsed"]
    # a metric is named by its quantity, before the first dot, and may add the cells it is for
    return {m["name"]: {"value": values[base], "unit": m["unit"]} for m in cell.end_to_end
            if (base := m["name"].split(".")[0]) in values}


def check(cell: Cell, inputs: list, kept: list, device: torch.device) -> dict:
    """Each compared number, the worst over the kept calls, beside its limit."""
    worst: dict = {}
    refs: dict = {}
    for k, out in kept:
        if k not in refs:
            refs[k] = cell.reference.compute(inputs[k].to(device), cell.cfg)
        for name, value in cell.reference.compare(out, refs[k]).items():
            bad = not np.isfinite(value)
            worst[name] = float("inf") if bad else max(worst.get(name, 0.0), float(value))
    return {name: {"value": worst.get(name, float("inf")), "limit": limit}
            for name, limit in cell.reference.LIMITS.items()}


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run_cell(cell: Cell, *, seed: int, seconds: float, traced: bool, device: torch.device,
             started: float, forward=None, log=sys.stderr, marks=()) -> dict:
    """Set up ``cell``, measure it for ``seconds`` (or trace it), check what it produced.

    ``forward`` replaces the configuration's forward (the control and the fault tests);
    ``started`` is the wall-clock time the run began, and ``marks`` the ``(part, time it
    ended)`` of the set-up's parts before this call. Returns the result's fields.
    """
    marks = [("start", started), *marks]

    def mark(part):
        marks.append((part, time.time()))

    mark("run_cell")
    if device.type == "cuda":
        torch.zeros(1, device=device)
    mark("CUDA context")
    fwd = forward or cell.model.forward(cell.cfg)
    loop = LOOPS[cell.mix["loop"]]
    response = tuple(getattr(cell.model, "RESPONSE", ()))
    mark("the port's forward")
    inputs = make_inputs(cell, seed, device)
    sync(device)
    mark("inputs")
    keep = Reservoir(int(cell.mix.get("check_calls", 1)), seed)
    off = Spans("off", device)
    # every shape this cell's traffic uses, and nothing else
    loop(fwd, inputs[:1], 0.0, off, Reservoir(0, 0), device, response, min_calls=2)
    mark("two warm calls")
    print("set-up s: " + ", ".join(f"{part} {t - t0:.3f}" for (_, t0), (part, t) in zip(
        marks, marks[1:])), file=log)
    grid = grid_line(cell, seed, device)
    if grid:
        print(grid, file=log)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    result = {"attempted": 0, "failed": 0}
    if not traced:
        window = loop(fwd, inputs, seconds, off, keep, device, response)
        result["metrics"] = e2e_metrics(cell, window, window["wall0"] - started)
        result["attempted"] = window["calls"]
        if "latencies" in window:
            lat = np.asarray(window["latencies"]) * 1e3
            p95 = np.percentile(lat, 95)
            print(f"requests {len(lat)}, beyond the 95th percentile {int(np.sum(lat > p95))}, "
                  f"median {np.median(lat):.4f} ms, p95 {p95:.4f} ms", file=log)
        else:
            print(f"calls {window['calls']} in {window['elapsed']:.4f} s", file=log)
    else:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof_spans = Spans("profile", device)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                profiled = loop(fwd, inputs, min(seconds, cell.mix["trace_seconds"]),
                                prof_spans, keep, device, response)
        events = trace.read(prof, prof_spans.seen)
        del prof
        timed_spans = Spans("timed", device)
        timed = loop(fwd, inputs, min(seconds, cell.mix["span_seconds"]), timed_spans, keep,
                     device, response)
        span_ms = {n: 1e3 * t / timed["calls"] for n, t in timed_spans.totals.items()}
        reading = Reading(events=events, calls=profiled["calls"], span_ms=span_ms,
                          work=cell.model.work(cell.cfg, int(cell.mix["rows"]),
                                               int(cell.mix["samples"])))
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = metrics
        result["attempted"] = profiled["calls"] + timed["calls"]
        lo, hi = events.window
        result["busy_s"], result["window_s"] = events.busy_seconds(), hi - lo
        result["breakdown"] = {"device_ops": events.top_ops(), "idle_gaps": events.idle_gaps()}
        print(f"profiled calls {profiled['calls']}, launches {events.launches}, "
              f"timed calls {timed['calls']}, span ms per call {span_ms}", file=log)
    result["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(device))
                                   if device.type == "cuda" else 0)
    kept = keep.items
    del fwd, keep
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result["checks"] = check(cell, inputs, kept, device)
    result["correct"] = all(c["value"] <= c["limit"] for c in result["checks"].values())
    return result


