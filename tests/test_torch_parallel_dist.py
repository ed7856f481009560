"""The port's sharded layer across processes, its scaling harness and its multi-position dry run.

- Two processes joined by gloo, each owning two positions of a 4-position
  time mesh, give the single-process result bit for bit. The test starts
  them with a ``file://`` store in ``tmp_path`` and gives them a time limit
  of their own: a hang kills the processes and fails this one test.
- The scaling harness has a chain for every sharded entry point, as
  ``tests/test_parallel.py`` requires of the JAX package, and runs on a CPU
  mesh.
- ``entry.dryrun_multichip(8)`` on eight CPU positions: its first loss and
  gradient equal a float64 unsharded autograd computation of the same loss.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import librosa_tpu_torch as L
from librosa_tpu_torch import filters
from librosa_tpu_torch import parallel as P
from librosa_tpu_torch.entry import _dp_sp, dryrun_multichip
from librosa_tpu_torch.parallel import scaling

ROOT = Path(__file__).resolve().parent.parent
PROCESS_TIMEOUT_S = 120  # both processes start, import torch and finish in ~8 s here
GRAD_RTOL = 1e-5
SR = 22050


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _chains_on(mesh):
    """The results the processes save: each chain's output on ``mesh``, as numpy."""
    rng = np.random.RandomState(0)
    y = rng.randn(2, 4 * 512 * 16).astype(np.float32) * 0.1
    S = (np.abs(rng.randn(32, 64)) * 10).astype(np.float32)
    return {
        "stft": P.stft_sharded(y, mesh=mesh).numpy(),
        "stft_reflect": P.stft_sharded(y, mesh=mesh, pad_mode="reflect").numpy(),
        "onset": P.onset_strength_sharded(y, mesh=mesh).numpy(),
        "pcen": P.pcen_sharded(S, mesh=mesh).numpy(),
        "cqt": P.cqt_sharded(y[0], mesh=mesh, n_bins=24, hop_length=64, fmin=220.0).numpy(),
    }


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    sys.path[:0] = [{root!r}, {tests!r}]
    import librosa_tpu_torch as L
    from librosa_tpu_torch import parallel as P
    from test_torch_parallel_dist import _chains_on

    L.set_device("cpu")
    rank = int(sys.argv[1])
    P.init_distributed("file://" + sys.argv[2], num_processes=2, process_id=rank,
                       devices=["cpu", "cpu"])
    mesh = P.time_mesh()
    assert dict(mesh.shape) == {{"time": 4}}, mesh
    assert [int(p) for p in mesh.processes] == [0, 0, 1, 1], mesh
    np.savez(sys.argv[3], **_chains_on(mesh))
    torch.distributed.destroy_process_group()
""")


def test_two_gloo_processes_give_the_single_process_result(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(root=str(ROOT), tests=str(ROOT / "tests")))
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, str(worker), str(rank), str(tmp_path / "store"),
                               str(tmp_path / f"rank{rank}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=PROCESS_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert [p.returncode for p in procs] == [0, 0], logs
    want = _chains_on(P.time_mesh(devices=["cpu"] * 4))
    for rank in (0, 1):
        got = np.load(tmp_path / f"rank{rank}.npz")
        for name, value in want.items():
            assert np.array_equal(got[name], value), (rank, name)


def test_init_distributed_refuses_mixed_positions():
    with pytest.raises(L.ParameterError, match="all cards or all CPUs"):
        P.init_distributed("file:///nonexistent", num_processes=1, process_id=0,
                           devices=["cpu", "meta"])


# ---------------------------------------------------------------------------
# the scaling harness
# ---------------------------------------------------------------------------


def test_the_harness_has_a_chain_for_every_sharded_entry_point():
    import librosa_tpu.parallel as jax_parallel  # here, so that the worker processes load no JAX

    sharded = {name[:-len("_sharded")] for name in dir(P)
               if name.endswith("_sharded") and not name.startswith("_")}
    chains = set(scaling._chains())
    assert sharded and not sharded - chains, sorted(sharded - chains)
    jax_sharded = {name[:-len("_sharded")] for name in dir(jax_parallel)
                   if name.endswith("_sharded") and not name.startswith("_")}
    assert sharded == jax_sharded


def test_scaling_report_runs_on_a_cpu_mesh():
    pts = scaling.scaling_report(chain="melspectrogram", device_counts=[1, 2],
                                 seconds_per_device=2.0, iters=1, devices=["cpu"] * 2)
    assert [p.n_devices for p in pts] == [1, 2]
    assert pts[0].efficiency == 1.0
    assert all(p.samples_per_s > 0 and p.seconds > 0 and p.chain == "melspectrogram"
               and p.device == "cpu" for p in pts)
    with pytest.raises(ValueError):
        scaling.scaling_report(chain="no such chain")


def test_every_chain_runs_at_two_positions():
    pts = scaling.scaling_report_all(device_counts=[2], seconds_per_device=3.0, iters=1,
                                     devices=["cpu"] * 2)
    assert sorted(p.chain for p in pts) == sorted(scaling._chains())
    assert all(p.n_devices == 2 and p.samples_per_s > 0 for p in pts)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def _unsharded_loss64(fb, head, y, target, *, n_fft=512, hop=128):
    """The dry run's loss on the whole batch in float64: centred frames (the ``n // hop``
    that the mesh's positions own), |rfft|^2, the filterbank, log1p, the time mean, the head."""
    yp = torch.nn.functional.pad(y, (n_fft // 2, n_fft // 2))
    frames = yp.unfold(-1, n_fft, hop)[..., :y.shape[-1] // hop, :]
    window = torch.from_numpy(filters.get_window("hann", n_fft).astype(np.float64))
    power = torch.fft.rfft(frames * window, dim=-1).abs().square()
    feats = torch.log1p(torch.matmul(power, fb.T).clamp_min(0.0))
    pred = torch.matmul(feats.mean(dim=1), head)
    return (pred - target).square().mean()


def test_dryrun_multichip_on_eight_cpu_positions():
    out = dryrun_multichip(8, devices=["cpu"] * 8)
    dp, sp = out["mesh"]
    assert (dp, sp) == _dp_sp(8) == (2, 4)
    l0, l1 = out["losses"]
    assert np.isfinite(l0) and l1 <= l0
    # the same seeded draws, in the same order, in float64
    rng = np.random.RandomState(0)
    y = torch.from_numpy(rng.randn(2 * dp, sp * 128 * 16).astype(np.float32).astype(np.float64))
    fb = torch.from_numpy(filters.mel(sr=SR, n_fft=512, n_mels=16).astype(np.float32)
                          .astype(np.float64)).requires_grad_()
    head = torch.from_numpy((rng.randn(16, 4) * 0.1).astype(np.float32)
                            .astype(np.float64)).requires_grad_()
    target = torch.from_numpy(rng.randn(2 * dp, 4).astype(np.float32).astype(np.float64))
    loss = _unsharded_loss64(fb, head, y, target)
    loss.backward()
    loss = loss.detach()
    np.testing.assert_allclose(l0, float(loss), rtol=GRAD_RTOL)
    for name, param in (("fb", fb), ("head", head)):
        np.testing.assert_allclose(out["grads"][name], param.grad.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(param.grad.abs().max()))
    assert out["shapes"]["onset"] == (8 * 64 + 1,) and out["shapes"]["pyin"] == (8 * 8 + 1,)
