"""The port's ``util.profiling`` on the CPU, against the JAX package's where both count.

- ``roofline`` of ``a @ a`` at 256^2 reports the FLOPs that the JAX
  ``roofline`` takes from XLA's cost analysis of the same product,
  ``2 n**3``, exactly; its bytes are the product's three operands.
- ``calibrate(size=256)`` gives positive, finite rates on the CPU.
- ``dispatch_profile`` of torch ops on the CPU counts each top-level op and
  no launch or copy; ``trace`` writes a Chrome trace in which ``annotate``
  regions nest.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from librosa_tpu.util import profiling as jax_profiling
import librosa_tpu_torch as L
from librosa_tpu_torch.util import profiling

N = 256


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def test_calibrate_on_the_cpu():
    c = profiling.calibrate(size=N)
    assert isinstance(c, profiling.DeviceCeilings)
    for rate in (c.matmul_f32_flops, c.matmul_bf16_flops, c.hbm_bytes_per_s):
        assert np.isfinite(rate) and rate > 0
    assert np.isnan(profiling.calibrate(size=64, chain=2, include_bf16=False).matmul_bf16_flops)


def test_roofline_counts_the_flops_of_the_jax_cost_analysis():
    a_np = np.random.RandomState(0).randn(N, N).astype(np.float32)
    ceilings = profiling.DeviceCeilings(1e12, 2e12, 1e11)
    report = profiling.roofline(lambda a: a @ a, torch.from_numpy(a_np), ceilings=ceilings)
    jax_report = jax_profiling.roofline(
        lambda a: a @ a, jnp.asarray(a_np),
        ceilings=jax_profiling.DeviceCeilings(1e12, 2e12, 1e11))
    assert report.flops == jax_report.flops == 2 * N ** 3
    assert report.bytes_accessed == 3 * 4 * N * N
    assert report.seconds > 0 and report.bound in ("compute", "memory")
    assert report.compute_utilization == pytest.approx(report.achieved_flops / 1e12)
    assert "TF/s" in str(report) and report.bound + "-bound" in str(report)


def test_roofline_of_a_view_moves_no_bytes():
    report = profiling.roofline(lambda a: a.t(), torch.ones(8, 8),
                                ceilings=profiling.DeviceCeilings(1.0, 1.0, 1.0))
    assert report.flops is None and report.bytes_accessed is None and report.bound == "unknown"


def test_dispatch_profile_counts_eager_ops_and_no_transfers():
    x = torch.arange(1000, dtype=torch.float32)

    def three_ops():
        return torch.sum(torch.exp(x * 1e-3) + 1.0)

    counts = profiling.dispatch_profile(three_ops)
    assert counts["eager"] >= 3
    assert counts["transfers"] == 0 and counts["launches"] == 0 and counts["device_s"] == 0
    assert {"aten::mul", "aten::exp", "aten::add", "aten::sum"} <= set(counts["by_function"])
    assert counts["wall_s"] > 0


def test_trace_writes_a_file_in_which_annotations_nest(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                torch.ones(16).sum()
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    spans = {e["name"]: e for e in json.loads(files[0].read_text())["traceEvents"]
             if e.get("name") in ("outer", "inner")}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
