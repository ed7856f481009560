"""The port's mesh, collectives and sharded spectrograms against the JAX package's ``parallel``.

The port lays its mesh on eight CPU positions (``[cpu] * 8``); the JAX side
runs on ``conftest.py``'s eight virtual CPU devices. Each sharded chain is
held two ways: against the JAX sharded function at the floor of the port's
unsharded test of the same function, and against the port's own unsharded
function at ``tests/test_parallel.py``'s tolerance for that chain (the STFT
bit for bit). The JAX functions run under ``jax.jit``: outside it
``shard_map`` dispatches op by op, at several times the cost.
"""

import jax
import numpy as np
import pytest
import torch

import librosa_tpu as lt
from librosa_tpu import parallel as jp

import librosa_tpu_torch as L
from librosa_tpu_torch import parallel as P
from librosa_tpu_torch.ops import db_scale, fused_stft
from librosa_tpu_torch.parallel import collectives as C

SR = 22050
STFT_SNR_DB = 115.0   # tests/test_torch_feature_stack.py: the port's stft against JAX's
MEL_SNR_DB = 115.0    # tests/test_torch_main_path.py: the goldens' melspectrogram floor
MFCC_SNR_DB = 105.0   # tests/test_torch_main_path.py: the goldens' mfcc floor
MEL_RTOL = 1e-6       # tests/test_parallel.py:51, sharded against unsharded
POD_MEL_RTOL = 1e-5   # tests/test_parallel.py:111, the 2-D mesh
MFCC_SHARDED_SNR_DB = 120.0  # tests/test_parallel.py:245
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


@pytest.fixture(scope="module")
def jmesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jp.make_mesh((8,), ("time",))


@pytest.fixture(scope="module")
def mesh8():
    return P.make_mesh((8,), ("time",), devices=CPU8)


def _snr(got, want):
    dtype = np.complex128 if np.iscomplexobj(got) or np.iscomplexobj(want) else np.float64
    got = np.asarray(got).astype(dtype)
    want = np.asarray(want).astype(dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    return 10 * np.log10(np.sum(np.abs(want) ** 2) / max(np.sum(np.abs(got - want) ** 2), 1e-300))


def _jax(fn, *args, **kw):
    """``fn(*args, **kw)`` compiled whole by ``jax.jit``, as numpy."""
    return np.asarray(jax.jit(lambda *a: fn(*a, **kw))(*args))


def _noise(*shape, seed=440):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _tone_noise(n, seed=440):
    t = np.arange(n) / SR
    return (0.5 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * np.random.RandomState(seed).randn(n)).astype(np.float32)


# ---------------------------------------------------------------------------
# the surface and the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("module", ["mesh", "sharded", "analysis", "constantq", "effects",
                                    "scaling"])
def test_every_name_of_each_jax_parallel_module_is_ported(module):
    import importlib

    jax_module = importlib.import_module(f"librosa_tpu.parallel.{module}")
    port_module = importlib.import_module(f"librosa_tpu_torch.parallel.{module}")
    assert set(jax_module.__all__) <= set(dir(port_module))
    assert set(port_module.__all__) >= set(jax_module.__all__)


def test_the_package_exports_every_name_of_the_jax_package():
    names = {n for n in dir(jp) if not n.startswith("_")
             and not isinstance(getattr(jp, n), type(jp))}
    assert names and names <= set(dir(P))
    assert L.parallel is P


def test_too_few_devices_raises_as_jax_does(jmesh8):
    with pytest.raises(ValueError) as port:
        P.make_mesh((16,), ("time",), devices=CPU8)
    with pytest.raises(ValueError) as jax_side:
        jp.make_mesh((16,), ("time",))
    assert str(port.value) == str(jax_side.value)


def test_repeated_devices_make_one_position_each():
    mesh = P.make_mesh((2, 4), ("track", "time"), devices=CPU8)
    assert dict(mesh.shape) == {"track": 2, "time": 4} and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert set(mesh.processes.flat) == {0} and mesh.rank == 0
    line = C.Line.of(mesh, "time", at={"track": 1})
    assert line.size == 4 and line.local == [0, 1, 2, 3] and line.home == torch.device("cpu")
    assert C.Line.whole(mesh).size == 8
    with pytest.raises(L.ParameterError):
        C.Line.of(mesh, "freq")


def test_time_mesh():
    assert dict(P.time_mesh(devices=CPU8).shape) == {"time": 8}
    assert dict(P.time_mesh(3, devices=CPU8).shape) == {"time": 3}
    # the CPU default is one position
    assert dict(P.time_mesh().shape) == {"time": 1}


def test_pod_mesh_shapes(jmesh8):
    for track in (1, 2, 4):
        mesh = P.pod_mesh(track_axis=track, devices=CPU8)
        assert dict(mesh.shape) == dict(jp.pod_mesh(track_axis=track).shape)
        assert mesh.axis_names == ("track", "time")
    assert dict(P.pod_mesh(time_axis=2, track_axis=2, devices=CPU8).shape) == {"track": 2,
                                                                              "time": 2}
    with pytest.raises(ValueError):
        P.pod_mesh(track_axis=3, devices=CPU8)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def test_split_and_join_round_trip(mesh8):
    line = C.Line.of(mesh8, "time")
    x = torch.arange(2 * 64, dtype=torch.float32).reshape(2, 64)
    shards = C.split(x, line)
    assert len(shards) == 8 and all(tuple(s.shape) == (2, 8) for s in shards)
    assert torch.equal(C.join(shards, line), x)
    assert C.axis_index(line) == list(range(8))
    with pytest.raises(L.ParameterError):
        C.split(torch.zeros(2, 63), line)


def test_ppermute_gives_zeros_where_no_pair_sends(mesh8):
    line = C.Line.of(mesh8, "time")
    values = [torch.full((3,), float(d + 1)) for d in range(8)]
    got = C.ppermute(values, line, [(0, 2), (5, 1)])
    want = {2: 1.0, 1: 6.0}
    for d, g in enumerate(got):
        assert torch.equal(g, torch.full((3,), want.get(d, 0.0)))
    right = C.shift_right(values, line)
    left = C.shift_left(values, line)
    assert [float(v[0]) for v in right] == [0.0] + [float(d + 1) for d in range(7)]
    assert [float(v[0]) for v in left] == [float(d + 2) for d in range(7)] + [0.0]


def test_pmax_psum_and_all_gather(mesh8):
    line = C.Line.of(mesh8, "time")
    values = [torch.tensor([float(d), float(-d)]) for d in range(8)]
    assert all(torch.equal(m, torch.tensor([7.0, 0.0])) for m in C.pmax(values, line))
    assert all(torch.equal(s, torch.tensor([28.0, -28.0])) for s in C.psum(values, line))
    stacked = C.all_gather(values, line)
    assert len(stacked) == 8 and all(torch.equal(s, torch.stack(values)) for s in stacked)
    complex_values = [torch.full((2,), complex(d, -d)) for d in range(8)]
    assert torch.equal(C.all_gather(complex_values, line)[3][5], complex_values[5])


# ---------------------------------------------------------------------------
# stft_sharded, melspectrogram_sharded, mfcc_sharded
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stft_inputs():
    return {"mono": _noise(8 * 512 * 16), "multi": _noise(2, 8 * 512 * 8, seed=441)}


@pytest.fixture(scope="module")
def jax_stfts(jmesh8, stft_inputs):
    y, y2 = stft_inputs["mono"], stft_inputs["multi"]
    return {"constant": _jax(jp.stft_sharded, y, mesh=jmesh8, pad_mode="constant"),
            "reflect": _jax(jp.stft_sharded, y, mesh=jmesh8, pad_mode="reflect"),
            "multi": _jax(jp.stft_sharded, y2, mesh=jmesh8)}


@pytest.mark.parametrize("case", ["constant", "reflect", "multi"])
def test_stft_sharded_bit_equal_to_stft_and_held_to_jax(mesh8, stft_inputs, jax_stfts, case):
    y = stft_inputs["multi" if case == "multi" else "mono"]
    pad_mode = "constant" if case == "multi" else case
    got = P.stft_sharded(y, mesh=mesh8, n_fft=2048, hop_length=512, pad_mode=pad_mode)
    want = L.stft(y, pad_mode=pad_mode)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert torch.equal(got, want)
    assert _snr(got.numpy(), jax_stfts[case]) >= STFT_SNR_DB


def test_melspectrogram_sharded(mesh8, jmesh8):
    y = _noise(8 * 512 * 16)
    got = P.melspectrogram_sharded(y, mesh=mesh8)
    want = L.feature.melspectrogram(y=y)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=MEL_RTOL, atol=MEL_RTOL)
    assert _snr(got.numpy(), _jax(jp.melspectrogram_sharded, y, mesh=jmesh8)) >= MEL_SNR_DB


def test_melspectrogram_sharded_runs_the_kernel_route_once_a_position(mesh8, monkeypatch):
    """On the CPU the route is K1's plain version; the wrapper is called once a position
    and once for the trailing frame, uncentred."""
    calls = []
    real = fused_stft._fused

    def spy(y, *args, **kw):
        calls.append((tuple(y.shape), kw["center"]))
        return real(y, *args, **kw)

    monkeypatch.setattr("librosa_tpu_torch.core.spectrum._fused", spy)
    P.melspectrogram_sharded(_noise(8 * 512 * 4), mesh=mesh8)
    assert calls == [((2048 + 2048 - 512,), False)] * 8 + [((2048,), False)]


def test_melspectrogram_sharded_on_the_pod_mesh(jmesh8):
    mesh = P.pod_mesh(track_axis=2, devices=CPU8)
    y = _noise(2, 4 * 512 * 8, seed=442)
    got = P.melspectrogram_sharded(y, mesh=mesh, axis_name="time")
    want = L.feature.melspectrogram(y=y)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=POD_MEL_RTOL, atol=POD_MEL_RTOL)
    jax_got = _jax(jp.melspectrogram_sharded, y, mesh=jp.pod_mesh(track_axis=2),
                   axis_name="time")
    assert _snr(got.numpy(), jax_got) >= MEL_SNR_DB


def test_mfcc_sharded(mesh8, jmesh8):
    y = _tone_noise(8 * 512 * 32)
    before = db_scale.launches
    got = P.mfcc_sharded(y, mesh=mesh8, sr=SR)
    assert db_scale.launches == before  # the CPU runs the dB step's plain version
    want = L.feature.mfcc(y=y, sr=SR)
    assert got.shape == want.shape
    assert _snr(got.numpy(), want.numpy()) >= MFCC_SHARDED_SNR_DB
    assert _snr(got.numpy(), _jax(jp.mfcc_sharded, y, mesh=jmesh8, sr=SR)) >= MFCC_SNR_DB


@pytest.mark.parametrize("call", [
    lambda y, m: P.stft_sharded(y, mesh=m),
    lambda y, m: P.melspectrogram_sharded(y, mesh=m),
    lambda y, m: P.stft_sharded(np.zeros(8 * 512, np.float32), mesh=m),   # shards below n_fft
    lambda y, m: P.stft_sharded(np.zeros(8 * 4096, np.float32), mesh=m, pad_mode="edge"),
], ids=["stft_length", "mel_length", "short_shards", "pad_mode"])
def test_bad_lengths_and_modes_raise(mesh8, jmesh8, call):
    y = np.zeros(1000, dtype=np.float32)
    with pytest.raises(L.ParameterError):
        call(y, mesh8)
    with pytest.raises(lt.ParameterError):
        jp.stft_sharded(y, mesh=jmesh8)
