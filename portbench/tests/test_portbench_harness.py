"""The harness on the CPU: finding files by name, the last line, seeds, the trace arithmetic,
the roofline counts, the reference against the port, and what a run imports."""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, roofline, run, signals, trace
from portbench.tests._tiny import CELLS, run as run_tiny, tiny

REPO = Path(__file__).resolve().parents[2]

TOY_CONFIG = '''
RESPONSE = ("x",)

def forward(cfg):
    def run(y, span):
        with span("double"):
            return {"x": y * cfg["factor"]}
    return run

def work(cfg, rows, samples):
    return {}
'''
TOY_REFERENCE = '''
from portbench.reference.common import rel_err
LIMITS = {"x_err": 1e-6}

def compute(y, cfg, q=None):
    return {"x": y.double().cpu() * cfg["factor"]}

def compare(got, want):
    return {"x_err": rel_err(got["x"], want["x"])}
'''


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "bench"
    for sub in ("configs", "traffic", "metrics", "reference"):
        shutil.copytree(harness.HERE / sub, root / sub)
    (root / "configs" / "toy.json").write_text(json.dumps({"sr": 22050, "factor": 3.0}))
    (root / "configs" / "toy.py").write_text(TOY_CONFIG)
    (root / "reference" / "toy.py").write_text(TOY_REFERENCE)
    (root / "traffic" / "burst.json").write_text(json.dumps(
        {"loop": "requests", "signal": "melody_clicks", "rows": 3, "samples": 4096, "pool": 2,
         "check_calls": 2, "trace_seconds": 0.1, "span_seconds": 0.1}))
    (root / "metrics" / "answer.py").write_text("def read(r):\n    return 42.0\n")
    (root / "metrics" / "silent.py").write_text("def read(r):\n    return None\n")
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text(json.dumps({
        "configs": [{"name": "toy", "file": "bench/configs/toy.json"}],
        "workloads": [{"name": "toy.burst", "config": "toy", "traffic": "burst", "chips": 1}],
        "end_to_end": [{"name": "call_p95_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"},
                       {"name": "call_p95_ms.burst", "unit": "ms"}],
        "per_layer": [{"name": "answer.burst", "unit": "n"}, {"name": "silent", "unit": "n"},
                      {"name": "copy_ms.burst", "unit": "ms"}]}))
    cell = harness.find_cell("toy.burst", bench=bench, root=root)
    plain = run_tiny(cell)
    assert plain["correct"]
    assert set(plain["metrics"]) == {"call_p95_ms", "setup_s", "call_p95_ms.burst"}
    assert plain["metrics"]["call_p95_ms.burst"] == plain["metrics"]["call_p95_ms"]
    traced = run_tiny(cell, traced=True)
    assert traced["correct"]
    assert traced["metrics"]["answer.burst"]["value"] == 42.0
    assert "silent" not in traced["metrics"] and "copy_ms.burst" in traced["metrics"]


def test_the_last_line_has_the_contract_keys(monkeypatch, capsys):
    fake = {"correct": True, "attempted": 5, "failed": 0, "memory_peak_bytes": 7,
            "metrics": {"setup_s": {"value": 1.0, "unit": "s"}},
            "checks": {"mel_err": {"value": 1e-7, "limit": 1e-5}}, "busy_s": 0.5,
            "window_s": 1.0, "breakdown": {"device_ops": [], "idle_gaps": []}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: dict(fake))
    monkeypatch.setattr(run, "_power_limit", lambda: "not read")
    for traced, keys in ((0, ["correct", "attempted", "failed", "metrics", "device", "checks"]),
                         (1, ["correct", "attempted", "failed", "metrics", "device",
                              "breakdown", "checks"])):
        assert run.main(["--workload", "mel_mfcc.catalog", "--seed", str(2**31 + 9),
                         "--seconds", "1", "--trace", str(traced)]) == 0
        captured = capsys.readouterr()
        line = json.loads(captured.out.strip().splitlines()[-1])
        assert list(line) == keys
        assert set(line["device"]) == ({"platform", "kind", "count", "memory_peak_bytes"}
                                       | ({"busy_s", "window_s"} if traced else set()))
        assert captured.err.strip().splitlines()[-1].startswith("check mel_err ")


def test_no_result_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "mel_mfcc.catalog", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_no_result_in_a_directory_with_the_benchmark_alone(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    done = subprocess.run([sys.executable, "portbench/run.py", "--workload", "mel_mfcc.catalog",
                           "--seed", "3", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=120)
    assert done.returncode != 0 and done.stdout == ""


@pytest.mark.parametrize("signal", ["melody_clicks", "melody_clicks_even"])
def test_signals_repeat_from_a_seed(signal):
    seed = 2**31 + 77
    make = getattr(signals, signal)
    a = make(3, 22050 * 4, seed, "cpu", 22050)
    b = make(3, 22050 * 4, seed, "cpu", 22050)
    c = make(3, 22050 * 4, seed + 1, "cpu", 22050)
    assert a.dtype == torch.float32 and a.shape == (3, 22050 * 4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    cell = tiny("onset_beat_pyin.clips")
    p, q = harness.make_inputs(cell, seed, torch.device("cpu")), \
        harness.make_inputs(cell, seed, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(p, q)) and not torch.equal(p[0], p[1])


@pytest.mark.parametrize("workload", ["onset_beat_pyin.catalog", "onset_beat_pyin.clips"])
def test_every_seed_and_batch_plays_the_same_grid(workload):
    cell = harness.find_cell(workload)
    rows = int(cell.mix["rows"])
    grids = [signals.GRIDS[cell.mix["signal"]](rows, s, "cpu")[1:]
             for seed in (0, 2**31 + 5, 3 * 2**32 + 11) for s in harness.pool_seeds(cell, seed)]
    bpm, f0 = grids[0]
    step = (torch.arange(rows) + rows // 2) % rows
    mid = (step.double() + 0.5).reshape(rows, 1) / rows
    assert torch.allclose(bpm, 80 + 80 * mid, rtol=0, atol=1e-12)
    assert torch.allclose(f0, 110 * 4 ** mid, rtol=1e-12)
    # the first row, whose tempo sizes the beat tracker's window, is the grid's middle
    assert 115 < bpm[0].item() < 125 and bpm[0] > bpm.min()
    assert bpm.min() > 80 and bpm.max() < 160 and f0.min() > 110 and f0.max() < 440
    assert all(torch.equal(b, bpm) and torch.equal(f, f0) for b, f in grids)
    line = harness.grid_line(cell, 2**31 + 5, torch.device("cpu"))
    assert line.startswith(f"draws: tempo {bpm.min().item():.4f}-{bpm.max().item():.4f} BPM")


@pytest.mark.parametrize("workload, signal", [
    ("onset_beat_pyin.catalog", "melody_clicks_even"),
    ("onset_beat_pyin.clips", "melody_clicks_even"),
    ("mel_mfcc.catalog", "melody_clicks"), ("mel_mfcc.clips", "melody_clicks")])
def test_each_cell_finds_its_signal(workload, signal):
    assert harness.find_cell(workload).mix["signal"] == signal


def _melody_clicks_as_first_benchmarked(rows, samples, seed, device, sr):
    """``melody_clicks`` as the mel_mfcc cells were first measured with, written out whole."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    f64 = dict(device=device, dtype=torch.float64)
    t = torch.arange(samples, **f64) / sr
    bpm = 80 + 80 * torch.rand(rows, 1, generator=g, **f64)
    f0 = 110 * 2 ** (2 * torch.rand(rows, 1, generator=g, **f64))
    beat_pos = t * bpm / 60
    n_steps = int(np.ceil(samples / sr * 160 / 60)) + 2
    steps = torch.randint(-3, 4, (rows, n_steps), generator=g, device=device)
    semis = torch.cumsum(steps, 1).clamp(-12, 12).double().gather(1, beat_pos.long())
    pitch = f0 * 2 ** (semis / 12) * (1 + 0.003 * torch.sin(2 * np.pi * 5 * t))
    phase = 2 * np.pi * torch.cumsum(pitch / sr, dim=1)
    tone = sum(torch.sin(k * phase) / k for k in range(1, 5))
    frac = torch.frac(beat_pos)
    noise = torch.randn(rows, samples, generator=g, **f64)
    y = 0.2 * tone * torch.exp(-8 * frac) + 0.3 * noise * torch.exp(-frac * 60 / bpm * 200)
    return (y + 0.01 * noise).float()


@pytest.mark.parametrize("workload", ["mel_mfcc.catalog", "mel_mfcc.clips"])
def test_the_mel_mfcc_inputs_are_melody_clicks(workload):
    cell = tiny(workload)
    seed = 2**31 + 4242
    got = harness.make_inputs(cell, seed, torch.device("cpu"))
    rows, samples = int(cell.mix["rows"]), int(cell.mix["samples"])
    want = [_melody_clicks_as_first_benchmarked(rows, samples, s, torch.device("cpu"), 22050)
            for s in harness.pool_seeds(cell, seed)]
    assert len(got) == len(want) == int(cell.mix["pool"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert harness.grid_line(cell, seed, torch.device("cpu")).startswith("draws: tempo ")
    assert harness.grid_line(cell, seed, torch.device("cpu")).startswith("draws: tempo ")


def test_busy_idle_and_launch_arithmetic():
    ev = trace.Events(device=[("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("memcpy", 5.0, 6.0),
                              ("k1", 8.0, 9.5)],
                      host=[("tempo", 3.0, 4.5), ("pyin", 4.5, 8.0), ("call", 0.0, 10.0)],
                      launch_times=[0.5, 1.0, 2.0, 9.0, 11.0], window=(1.0, 10.0))
    assert trace.busy([(1, 2), (1.5, 3), (5, 6)]) == 3.0
    assert trace.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 7) == [(0, 1), (3, 5), (6, 7)]
    assert ev.busy_seconds() == 4.5 and ev.launches == 3
    assert ev.kernel_seconds(["k1"]) == 2.5
    assert ev.idle_gaps(2) == [["tempo", 2.0], ["pyin", 2.0]]
    assert ev.top_ops(1) == [["k1", 2.5]]
    reading = harness.Reading(events=ev, calls=2, span_ms={},
                              work={"k1": {"flops": 67e12 * 0.5, "bytes": 0, "kernels": ["k1"]}})
    idle = tiny("mel_mfcc.catalog").reader("device_idle_pct.catalog")
    assert idle.read(reading) == pytest.approx(50.0)
    assert reading.roofline_pct("k1") == pytest.approx(40.0)
    assert reading.roofline_pct("absent") is None


def test_roofline_counts_reproduce_the_bounds_at_the_main_buffer():
    cfg_m = json.loads((harness.HERE / "configs" / "mel_mfcc.json").read_text())
    cfg_o = json.loads((harness.HERE / "configs" / "onset_beat_pyin.json").read_text())
    mel = harness._load(harness.HERE / "configs" / "mel_mfcc.py", "t_mel")
    obp = harness._load(harness.HERE / "configs" / "onset_beat_pyin.py", "t_obp")
    k1 = roofline.least_seconds(mel.work(cfg_m, 16, 2**22)["stft_mel"]) * 1e3
    b = roofline.least_seconds(obp.work(cfg_o, 16, 2**22)["viterbi"]) * 1e3
    assert round(k1, 3) == 0.128 and round(b, 4) == 0.4905


@pytest.mark.parametrize("config", ["mel_mfcc", "onset_beat_pyin"])
def test_the_reference_agrees_with_the_port_on_the_cpu(config):
    cell = tiny(f"{config}.catalog")
    y = signals.melody_clicks(2, 22050 * 4, 2**31 + 3, "cpu", 22050)
    got = cell.model.forward(cell.cfg)(y, harness.Spans("off", torch.device("cpu")))
    numbers = cell.reference.compare(got, cell.reference.compute(y, cell.cfg))
    assert set(numbers) == set(cell.reference.LIMITS)
    assert all(v <= cell.reference.LIMITS[k] for k, v in numbers.items()), numbers


def _modules_of(code: str) -> set:
    done = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    return set(json.loads(done.stdout.strip().splitlines()[-1]))


def test_runs_load_neither_jax_nor_the_jax_package():
    loaded = _modules_of(f"""
        import json, sys
        sys.path.insert(0, ".")
        from portbench.tests._tiny import CELLS, run, tiny
        for wl in {CELLS!r}:
            assert run(tiny(wl))["correct"]
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    assert "librosa_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "librosa_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    loaded = _modules_of("""
        import json, sys
        sys.path.insert(0, ".")
        import portbench.reference.mel_mfcc, portbench.reference.onset_beat_pyin
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert not loaded & {"jax", "jaxlib", "flax", "librosa_tpu", "librosa_tpu_torch"}
