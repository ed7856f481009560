"""ops/db_scale.py on the CPU: the plain version against the JAX package, and the predicate.

The CUDA kernel itself runs only on the card (chip_smoke.py holds it against
the plain version there); here the plain version, which is what the kernel
is held against, is compared with ``librosa_tpu.power_to_db`` /
``amplitude_to_db`` on the same seeded inputs at atol 1e-4 dB (two float32
``log10`` implementations), and the routing rule is pinned.
"""

import numpy as np
import pytest
import torch

import librosa_tpu as lt

import librosa_tpu_torch as L
from librosa_tpu_torch.core import spectrum as port_spectrum
from librosa_tpu_torch.ops import db_scale
from librosa_tpu_torch.util import utils as port_utils

ATOL_DB = 1e-4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = L.get_device()
    L.set_device("cpu")
    yield
    L.set_device(prev)


def _power(*shape, seed=0):
    S = np.random.RandomState(seed).randn(*shape).astype(np.float32) ** 2
    S[..., :3, :2] = 0.0  # below amin
    return S


@pytest.mark.parametrize("amplitude", [False, True], ids=["power", "amplitude"])
@pytest.mark.parametrize("ref", [1.0, 0.25, np.max], ids=["one", "quarter", "np_max"])
@pytest.mark.parametrize("top_db", [80.0, None, 0.0], ids=["top80", "no_top", "top0"])
@pytest.mark.parametrize("axes", ["auto", None, (-1,), (0, 2)],
                         ids=["auto", "whole", "last", "outer"])
def test_plain_version_matches_jax(amplitude, ref, top_db, axes):
    S = _power(3, 24, 17, seed=1)
    if amplitude:
        S = np.sqrt(S) * np.sign(np.random.RandomState(2).randn(*S.shape)).astype(np.float32)
    jfn = lt.amplitude_to_db if amplitude else lt.power_to_db
    want = np.asarray(jfn(S, ref=ref, top_db=top_db, axes=axes))
    resolved = port_spectrum._db_axes(S.ndim, axes)
    got = db_scale.db_scale_reference(torch.from_numpy(S), ref=ref, top_db=top_db,
                                      amin=1e-5 if amplitude else 1e-10, axes=resolved,
                                      amplitude=amplitude)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_DB)
    # the wrapper on a CPU tensor is the plain version, and the public function agrees
    pfn = L.amplitude_to_db if amplitude else L.power_to_db
    assert torch.equal(pfn(S, ref=ref, top_db=top_db, axes=axes), got)
    if ref is np.max and resolved is not None:
        assert torch.equal(got.amax(dim=tuple(resolved)).flatten(),
                           torch.zeros(got.amax(dim=tuple(resolved)).numel()))


def test_plain_version_with_callable_and_array_refs_matches_jax():
    S = _power(2, 20, 15, seed=3)
    for ref in (np.median, np.mean):
        got = L.power_to_db(S, ref=ref)
        np.testing.assert_allclose(got.numpy(), np.asarray(lt.power_to_db(S, ref=ref)),
                                   rtol=0, atol=ATOL_DB)
    ref = np.array([[[0.5]], [[2.0]]], dtype=np.float32)
    np.testing.assert_allclose(L.power_to_db(S, ref=ref).numpy(),
                               np.asarray(lt.power_to_db(S, ref=ref)), rtol=0, atol=ATOL_DB)
    with pytest.raises(L.ParameterError, match="axis"):
        L.power_to_db(S, ref=lambda x: 1.0)


@pytest.mark.parametrize("amplitude", [False, True], ids=["power", "amplitude"])
@pytest.mark.parametrize("ref", [np.mean, np.sum], ids=["np_mean", "np_sum"])
@pytest.mark.parametrize("axes", ["auto", None, (-1,)], ids=["auto", "whole", "last"])
def test_numpy_reductions_as_ref_run_on_the_device_and_match_jax(monkeypatch, amplitude, ref,
                                                                 axes):
    # the branch a CUDA tensor takes, here on a CPU tensor: the reduction by torch, no host copy
    S = _power(3, 24, 17, seed=6)
    jfn = lt.amplitude_to_db if amplitude else lt.power_to_db
    want = np.asarray(jfn(S, ref=ref, axes=axes))
    resolved = port_spectrum._db_axes(S.ndim, axes)
    level = port_utils._device_reduction(ref, torch.from_numpy(S), resolved)
    np.testing.assert_allclose(level.numpy(), ref(S, axis=resolved, keepdims=True), rtol=1e-5)
    monkeypatch.setattr(torch.Tensor, "numpy", lambda *a, **k: pytest.fail("host copy"))
    got = db_scale.db_scale_reference(torch.from_numpy(S), ref=ref, axes=resolved,
                                      amin=1e-5 if amplitude else 1e-10, amplitude=amplitude)
    monkeypatch.undo()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_DB)


F32 = torch.zeros(2, 8, 6)


@pytest.mark.parametrize(
    "S,ref,axes,taken",
    [
        (F32, 1.0, (-2, -1), True),
        (F32, np.max, (-2, -1), True),
        (F32, torch.amax, None, True),
        (F32, np.float32(0.5), (-1,), True),
        (F32, 3, (0, 1, 2), True),
        (torch.zeros(9), 1.0, (-1,), True),
        (F32.double(), 1.0, (-2, -1), False),
        (F32.to(torch.complex64), 1.0, (-2, -1), False),
        (F32.transpose(-1, -2), 1.0, (-2, -1), False),
        (F32[:, ::2], 1.0, (-2, -1), False),
        (F32, 1.0, (0, 2), False),
        (F32, 1.0, (-2,), False),
        (F32, np.median, (-2, -1), False),
        (F32, np.ones((2, 1, 1), np.float32), (-2, -1), False),
        (F32, torch.tensor(1.0), (-2, -1), False),
        (F32, True, (-2, -1), False),
        (torch.zeros(0, 4), 1.0, (-2, -1), False),
        (torch.tensor(1.0), 1.0, None, False),
    ],
    ids=["auto", "np_max", "torch_amax_whole", "np_scalar_last", "int_all_axes", "one_d",
         "float64", "complex", "transposed", "strided", "outer_axes", "middle_axis",
         "callable", "array_ref", "tensor_ref", "bool_ref", "empty", "zero_d"],
)
def test_kernel_refusal_is_the_routing_rule(monkeypatch, S, ref, axes, taken):
    assert (db_scale.kernel_refusal(S, ref, axes) is None) == taken
    calls = []
    monkeypatch.setattr(db_scale, "db_scale", lambda S, **kw: calls.append("kernel") or S)
    monkeypatch.setattr(db_scale, "db_scale_reference",
                        lambda S, **kw: calls.append("plain") or S)
    L.power_to_db(S, ref=ref, axes=axes)
    assert calls == ["kernel" if taken else "plain"]


def test_cpu_tensor_runs_the_plain_version_and_counts_no_launch():
    before = db_scale.launches
    S = torch.from_numpy(_power(2, 9, 7, seed=4))
    got = db_scale.db_scale(S, ref=np.max, axes=(-2, -1))
    want = db_scale.db_scale_reference(S, ref=np.max, axes=(-2, -1))
    assert torch.equal(got, want) and db_scale.launches == before


def test_launch_geometry_covers_channels_and_parts():
    S = torch.zeros(16, 128, 33)
    assert db_scale.launch_geometry(S, (-2, -1)) == (16, 128 * 33, 1)
    assert db_scale.launch_geometry(S, None) == (1, 16 * 128 * 33, 9)
    assert db_scale.launch_geometry(S, (-1,)) == (16 * 128, 33, 1)
    big = torch.zeros(1).expand(3, 1 << 24)  # no storage behind it: only the shape counts
    assert db_scale.launch_geometry(big, (-1,)) == (3, 1 << 24, 1024)


def test_source_is_registered_for_the_build():
    from librosa_tpu_torch.ops import _build

    assert _build.SOURCES["db_scale"] == "db_scale.cu"
    text = (_build.CSRC / "db_scale.cu").read_text()
    assert 'extern "C" int db_scale_launch' in text
    # no fused multiply-add may touch the peak: products and differences are rounded singly
    assert "__fmul_rn" in text and "__fsub_rn" in text
