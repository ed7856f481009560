"""The harness on the CPU: finding files by name, the last line, seeds, the trace arithmetic,
the roofline counts, the reference against the port, and what a run imports."""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

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


def test_signals_repeat_from_a_seed():
    seed = 2**31 + 77
    a = signals.melody_clicks(3, 22050 * 4, seed, "cpu", 22050)
    b = signals.melody_clicks(3, 22050 * 4, seed, "cpu", 22050)
    c = signals.melody_clicks(3, 22050 * 4, seed + 1, "cpu", 22050)
    assert a.dtype == torch.float32 and a.shape == (3, 22050 * 4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    cell = tiny("onset_beat_pyin.clips")
    p, q = harness.make_inputs(cell, seed, torch.device("cpu")), \
        harness.make_inputs(cell, seed, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(p, q)) and not torch.equal(p[0], p[1])


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
