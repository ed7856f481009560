"""The port's spans in ``resample`` and ``griffinlim`` and its counter ``ola_norm_launches``, and
the ``reconstruction.catalog`` cell's per-layer readers, on the CPU (one case on the card).

- Under the profiler one ``griffinlim`` call of ``n_iter`` rounds records ``griffinlim`` once
  and, nested under it, ``griffinlim.istft``, ``.stft`` and ``.phase_update`` once a round; the
  counter ``ola_norm_launches`` adds nothing on the CPU and one a launch on the card, and
  ``phase_update_kernels`` one a round on the card.
- Without the profiler nothing is recorded.
- The readers on a synthetic window and on a tiny traced run of the cell.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import librosa_tpu_torch as L
from librosa_tpu_torch.core.audio import resample
from librosa_tpu_torch.core.spectrum import griffinlim
from librosa_tpu_torch.util import profiling
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, program_spans, trace  # noqa: E402
from portbench.tests._tiny import run as run_tiny, tiny  # noqa: E402

CELL = "reconstruction.catalog"
ROUND_SPANS = ("griffinlim.istft", "griffinlim.stft", "griffinlim.phase_update")
NEW_METRICS = ("launches_per_call", "device_idle_pct", "ola_norm_roofline",
               "phase_update_launches", "griffinlim_ms", "resample_ms")
CPU_ACTIVITY = [torch.profiler.ProfilerActivity.CPU]
KW = dict(n_fft=256, hop_length=64)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _magnitudes(device="cpu"):
    g = torch.Generator().manual_seed(5)
    return torch.rand(2, 129, 40, generator=g).to(device)


def _spans_since(mark: int) -> list:
    return [s for s in profiling.recorded().spans if s.index >= mark]


def _traced_griffinlim(S, n_iter: int) -> list:
    mark = next(profiling._span_ids)
    with torch.profiler.profile(activities=CPU_ACTIVITY):
        griffinlim(S, n_iter=n_iter, rng=0, **KW)
    return _spans_since(mark)


@pytest.mark.parametrize("n_iter", [0, 4])
def test_griffinlim_records_its_rounds_nested_under_it(n_iter):
    spans = _traced_griffinlim(_magnitudes(), n_iter)
    outer = [s for s in spans if s.name == "griffinlim"]
    assert len(outer) == 1 and outer[0].parent == -1
    for name in ROUND_SPANS:
        inside = [s for s in spans if s.name == name]
        assert len(inside) == n_iter
        assert all(s.parent == outer[0].index and s.call == outer[0].call for s in inside)
        assert all(outer[0].start_ns <= s.start_ns <= s.end_ns <= outer[0].end_ns
                   for s in inside)
    assert {s.name for s in spans} == {"griffinlim", *(ROUND_SPANS if n_iter else ())}
    # the rounds run in order: istft, stft, phase update
    names = [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.name != "griffinlim"]
    assert names == list(ROUND_SPANS) * n_iter
    # no launch of the synthesis kernel on the CPU
    assert sum(s.counters.get("ola_norm_launches", 0) for s in spans) == 0


def test_resample_records_one_span():
    mark = next(profiling._span_ids)
    with torch.profiler.profile(activities=CPU_ACTIVITY):
        resample(torch.ones(2, 4410), orig_sr=22050, target_sr=16000, res_type="polyphase")
    assert [(s.name, s.parent) for s in _spans_since(mark)] == [("resample", -1)]


def test_without_the_profiler_nothing_is_recorded():
    before = profiling.recorded()
    total = profiling.counts().get("ola_norm_launches", 0)
    resample(torch.ones(2, 4410), orig_sr=22050, target_sr=16000, res_type="polyphase")
    griffinlim(_magnitudes(), n_iter=4, rng=0, **KW)
    after = profiling.recorded()
    assert after.spans == before.spans and after.dropped == before.dropped
    assert profiling.counts().get("ola_norm_launches", 0) == total


@pytest.mark.card
def test_ola_norm_counts_its_launches_on_the_card(card):
    spans = _traced_griffinlim(_magnitudes(card), 4)
    outer = next(s for s in spans if s.name == "griffinlim")
    istft_spans = [s for s in spans if s.name == "griffinlim.istft"]
    # one launch in each round's istft, one for the result
    assert [s.counters.get("ola_norm_launches", 0) for s in istft_spans] == [1] * 4
    assert outer.counters.get("ola_norm_launches", 0) == 1
    assert sum(s.counters.get("ola_norm_launches", 0) for s in spans) == 5


@pytest.mark.card
def test_phase_update_counts_one_kernel_a_round_on_the_card(card):
    spans = _traced_griffinlim(_magnitudes(card), 4)
    updates = [s for s in spans if s.name == "griffinlim.phase_update"]
    # the first round (no tprev) among them
    assert [s.counters.get("phase_update_kernels", 0) for s in updates] == [1] * 4
    assert sum(s.counters.get("phase_update_kernels", 0) for s in spans) == 4


# -- the readers on a synthetic window: seconds from BASE, on the Unix clock ------------------

BASE = 1_790_000_000.0


def _span(name, start, end, index, parent=-1):
    return SimpleNamespace(name=name, start_ns=int(round((BASE + start) * 1e9)),
                           end_ns=int(round((BASE + end) * 1e9)), index=index, parent=parent,
                           call=None, counters={})


def _synthetic():
    """Two calls in the window [10, 20]: ola_norm busy 2 s of them, the card idle 4 s."""
    device = [("void (anonymous namespace)::ola_norm_kernel<4>(float const*)", BASE + a,
               BASE + b) for a, b in ((10.0, 11.0), (14.0, 15.0))]
    device += [("elementwise", BASE + a, BASE + b) for a, b in ((11.0, 12.0), (15.0, 17.0))]
    events = trace.Events(device=device,
                          launch_times=[BASE + t for t in (10.1, 11.5, 11.6, 15.2, 15.3, 15.4)],
                          window=(BASE + 10.0, BASE + 20.0))
    spans = [_span("griffinlim", 10.0, 13.0, 0), _span("griffinlim.phase_update", 11.4, 11.7, 1, 0),
             _span("griffinlim", 14.0, 18.0, 2), _span("griffinlim.phase_update", 15.1, 15.5, 3, 2)]
    work = {"ola_norm": {"flops": 0, "bytes": 3.35e12 * 0.25, "kernels": ("ola_norm_kernel",)}}
    return (harness.Reading(events=events, calls=2,
                            span_ms={"resample": 1.5, "spectrogram": 0.5, "griffinlim": 20.0},
                            work=work), spans)


def _read(metric, reading):
    return tiny(CELL).reader(f"{metric}.recon_catalog").read(reading)


def test_each_reader_on_a_synthetic_window(monkeypatch):
    reading, spans = _synthetic()
    monkeypatch.setattr(program_spans, "record",
                        lambda: SimpleNamespace(spans=tuple(spans), dropped=0, dropped_end_ns=0))
    got = {m: _read(m, reading) for m in NEW_METRICS}
    assert got == pytest.approx({"launches_per_call": 3.0, "device_idle_pct": 50.0,
                                 "ola_norm_roofline": 25.0, "phase_update_launches": 2.5,
                                 "griffinlim_ms": 20.0, "resample_ms": 1.5})


def test_phase_update_launches_reads_nothing_without_the_programs_spans(monkeypatch):
    # a tree whose port records no spans, or none in the window, as the parent of the spans
    reading, spans = _synthetic()
    outside = tuple(SimpleNamespace(**{**vars(s), "start_ns": s.start_ns - 10**11,
                                       "end_ns": s.end_ns - 10**11}) for s in spans)
    for rec in (None, SimpleNamespace(spans=outside, dropped=0, dropped_end_ns=0)):
        monkeypatch.setattr(program_spans, "record", lambda rec=rec: rec)
        assert _read("phase_update_launches", reading) is None


def test_a_tiny_traced_run_of_the_cell_reads_the_new_metrics():
    res = run_tiny(tiny(CELL), traced=True)
    assert res["correct"], res["checks"]
    got = {name.split(".")[0]: m["value"] for name, m in res["metrics"].items()}
    assert set(got) == {"launches_per_call", "griffinlim_ms", "resample_ms"}
    assert got["launches_per_call"] == 0.0
    assert got["griffinlim_ms"] > got["resample_ms"] > 0
    # the CPU has no device events: no idle share, roofline or launches inside spans
    assert _read("ola_norm_roofline", harness.Reading(events=trace.Events(), calls=1,
                                                      span_ms={})) is None
