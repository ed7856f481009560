"""The port's staged-copy diagnostics against the JAX scripts they replace.

``scripts/dma_bisect.py`` is loaded as a module with its ``pallas_call`` in
interpret mode and shrunk to 6 tiles over 3 tile starts (``N_TILES``,
``WRAP``); the port runs the same variants at the same sizes on CPU tensors,
so its wrappers run their plain versions (the CUDA kernels are held against
those versions on the card by chip_smoke.py). Both get the same rows from
``np.random.RandomState(0)``.

Tolerance: ``rtol 1e-5`` plus an ``atol`` of ``1e-5`` times the sum of the
absolute values that each output sums, since float32 sums of the same terms
in two orders differ by a few ulps of that sum.
"""

import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from librosa_tpu_torch.diagnostics import dma_bisect, dma_pipeline_micro
from librosa_tpu_torch.ops import staged_probe
from librosa_tpu_torch.util.exceptions import ParameterError

ROOT = Path(__file__).resolve().parent.parent
N_TILES, WRAP = 6, 3
RTOL = ATOL_REL = 1e-5


@pytest.fixture(scope="module")
def script():
    """scripts/dma_bisect.py at 6 tiles and wrap 3, its Pallas calls interpreted."""
    spec = importlib.util.spec_from_file_location("dma_bisect_script",
                                                  ROOT / "scripts" / "dma_bisect.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    interp = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                      if not k.startswith("__")})
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = interp
    mod.N_TILES, mod.WRAP = N_TILES, WRAP
    return mod


@pytest.fixture(scope="module")
def rows_np():
    return np.random.RandomState(0).randn((WRAP * 128 + 144) * 512).astype(np.float32)


@pytest.fixture(scope="module")
def inputs(rows_np):
    return dma_bisect.Inputs("cpu", wrap=WRAP, rows=torch.from_numpy(rows_np))


def _assert_close(got, want, abs_sum):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    abs_sum = np.asarray(abs_sum, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    bad = np.abs(got - want) > ATOL_REL * abs_sum + RTOL * np.abs(want)
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


def _check(case, want):
    before = dict(staged_probe.launches)
    got = case.run()
    assert got.device.type == "cpu"
    assert staged_probe.launches == before  # a CPU tensor launches nothing
    _assert_close(got.numpy(), want, case.plain(absolute=True).numpy())


# (port variant, case group, the script's make_ function). The port's m_outg4 and
# m_outg8 change only how many tiles one block takes, so they are held
# against the script's group=1; the script's group=2 (which divides 6 tiles)
# is held against m_out run with group 2.
PAIRS = [
    ("m0", 1, lambda m: m.make_m0()),
    ("m_out", 1, lambda m: m.make_m_out(group=1)),
    ("m_out", 2, lambda m: m.make_m_out(group=2)),
    ("m_outg4", 4, lambda m: m.make_m_out(group=1)),
    ("m_outg8", 8, lambda m: m.make_m_out(group=1)),
    ("m_outc", 1, lambda m: m.make_m_out(contiguous=True)),
    ("m_edge", 1, lambda m: m.make_m_edge()),
    ("m_kitchen", 1, lambda m: m.make_m_kitchen(grid=N_TILES)),
    ("m_kitchen_notab", 1, lambda m: m.make_m_kitchen(tables=False, grid=N_TILES)),
    ("m_kitchen_nox", 1, lambda m: m.make_m_kitchen(xstack_scratch=False, grid=N_TILES)),
    ("m_kitchen_nooff", 1, lambda m: m.make_m_kitchen(offset_probe=False, grid=N_TILES)),
    ("m_kitchen_nostart", 1, lambda m: m.make_m_kitchen(real_start=False, grid=N_TILES)),
    ("m_kitchen_g1024", 1, lambda m: m.make_m_kitchen(grid=1024)),
]


@pytest.mark.parametrize("name,group,make", PAIRS,
                         ids=[f"{n}-group{g}" for n, g, _ in PAIRS])
def test_variant_matches_script(script, inputs, rows_np, name, group, make):
    want = np.asarray(make(script)(rows_np))
    case = dma_bisect.make_case(name, inputs, n_tiles=N_TILES)
    case.group = group
    _check(case, want)


def test_m0_is_the_last_tiles_column_sums(inputs, rows_np):
    got = dma_bisect.make_case("m0", inputs, n_tiles=N_TILES).run().numpy()
    last = ((N_TILES - 1) % WRAP) * 128
    want = rows_np.reshape(-1, 512)[last:last + 144].astype(np.float64).sum(axis=0)
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-4)


def test_kitchen_terms_and_edge_tiles(inputs, rows_np):
    full = dma_bisect.make_case("m_kitchen", inputs, n_tiles=N_TILES).run().numpy().copy()
    bare = dma_bisect.make_case("m_kitchen_notab", inputs, n_tiles=N_TILES).run().numpy()
    # the table term of the script's tables of ones, and the scratch row of ones
    np.testing.assert_allclose(full - bare, 184864.0, rtol=1e-6)
    assert (bare[:, :128] == 128.0).all() and (bare[:, -128:] == 128.0).all()
    # interior tile 1 probes rows 6 .. 133 of its span
    rows = rows_np.reshape(-1, 512).astype(np.float64)
    np.testing.assert_allclose(bare[0, 128:256] - 128.0, rows[128 + 6:128 + 134].sum(axis=1),
                               rtol=1e-5, atol=1e-3)


def test_pipeline_micro_matches_make_m0(script, inputs, rows_np):
    # scripts/dma_pipeline_micro.py runs its benchmark when imported, so it
    # cannot be loaded here; its kernel body is make_m0's, at WRAP from argv.
    want = np.asarray(script.make_m0()(rows_np))
    _check(dma_pipeline_micro.make_case(inputs, n_tiles=N_TILES), want)


@pytest.fixture(scope="module")
def scale_np():
    rs = np.random.RandomState(0)
    per_row = rs.randn(dma_bisect.SCALE_ROWS, 1).astype(np.float32)
    per_col = rs.randn(1, 512).astype(np.float32)
    return per_row + per_col  # 256 MB whose row sums all differ


@pytest.mark.parametrize("mode", dma_bisect.SCALE_MODES)
def test_scale_matches_script(script, scale_np, mode):
    build, _, grid = script.make_m_scale(mode)
    assert grid == dma_bisect.SCALE_TILES
    want = np.asarray(build(scale_np if mode == "pre2d" else scale_np.reshape(-1)))
    inputs = dma_bisect.Inputs("cpu", wrap=WRAP,
                               scale_rows=torch.from_numpy(scale_np.reshape(-1)))
    _check(dma_bisect.make_case(f"scale_{mode}", inputs), want)


def test_k1_geometry_probes_each_frames_first_hop():
    y = np.random.RandomState(1).randn(2, 512 * 64).astype(np.float32)
    case = dma_bisect.k1_staging_case(torch.from_numpy(y), n_out=4)
    got = case.run().numpy()
    n_frames = 65
    assert got.shape == (2, 4, n_frames)
    assert case.kwargs["rows_per_tile"] == 11 and case.kwargs["e_start"] == 7
    rowsum = y.reshape(2, 64, 512).astype(np.float64).sum(axis=-1)
    want = np.zeros((2, n_frames))
    for f in range(n_frames):
        tile = f // 8
        if 1 <= tile < case.kwargs["e_start"]:  # interior: frame f starts at row f - 2
            want[:, f] = rowsum[:, f - 2]
    np.testing.assert_allclose(got, np.broadcast_to(want[:, None, :], got.shape),
                               rtol=1e-5, atol=1e-3)


def _lines(capsys, prefix):
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(prefix)]


def test_dma_bisect_main_prints_one_line_per_variant(capsys):
    assert dma_bisect.main(["--device", "cpu", "--n-tiles", str(N_TILES), "--wrap",
                            str(WRAP), "--calls", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    for name in dma_bisect.VARIANTS:
        assert sum(ln.startswith(f"{name} ") for ln in out) == 1, name
    assert any(ln.startswith("dispatch floor:") for ln in out)


def test_dma_bisect_main_named_variants(capsys):
    assert dma_bisect.main(["m_outc", "m_edge", "--device", "cpu", "--n-tiles", "6",
                            "--wrap", "3", "--calls", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in out[2:]] == ["m_outc", "m_edge"]
    assert all("us/tile" in ln and "working set" in ln for ln in out[2:])


def test_pipeline_micro_main_prints_one_line(capsys):
    assert dma_pipeline_micro.main([str(WRAP), "--device", "cpu", "--n-tiles", "6",
                                    "--calls", "1"]) == 0
    assert len(_lines(capsys, "pipeline wrap 3")) == 1


def test_main_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dma_bisect.main(["m0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dma_pipeline_micro.main([])


def test_case_byte_counts(inputs):
    m0 = dma_bisect.make_case("m0", inputs)  # 4096 tiles over the 3 starts
    assert m0.staged_bytes == 4096 * 144 * 512 * 4
    assert m0.read_bytes == (2 * 128 + 144) * 512 * 4 and m0.l2_resident
    # an L2-resident working set still has its bound; over 3 starts the 0.8 MB of reads take
    # less time than one add per staged float
    assert m0.bound_by == "operations"
    assert m0.bound_ms == pytest.approx(1e3 * 4096 * 144 * 512 / 33.5e12)
    assert m0.bound_terms["bytes"] == pytest.approx(1e3 * (m0.read_bytes + 512 * 4) / 3.35e12)
    kitchen = dma_bisect.make_case("m_kitchen", inputs, n_tiles=N_TILES)
    # interior tiles 1..4 start at rows 128, 256, 0, 128; two edge slots; the tables
    assert kitchen.read_bytes == 4 * ((2 * 128 + 144) * 512 + 2 * 144 * 512 + 184864)


@pytest.mark.parametrize("name", ["m_out", "m_edge", "m_kitchen"])
def test_bound_counts_an_output_beyond_l2(inputs, name):
    # the 268 MB output is written once and the unique input read once, L2 or not
    case = dma_bisect.make_case(name, inputs)
    assert case.l2_resident and case.written_bytes == 128 * 4096 * 128 * 4
    assert case.bound_by == "bytes"
    assert case.bound_ms == pytest.approx(1e3 * (case.read_bytes + case.written_bytes) / 3.35e12)
    assert 0.0801 < case.bound_ms < 0.081
    small = dma_bisect.make_case(name, inputs, n_tiles=N_TILES)   # a few tiles: all in L2
    assert small.l2_resident
    assert small.bound_ms == pytest.approx(max(
        1e3 * (small.read_bytes + small.written_bytes) / 3.35e12,
        1e3 * N_TILES * 144 * 512 / 33.5e12))


# the bound at the diagnostics' default wrap of 128 (a 33.6 MB buffer): ms, and what bounds it
DEFAULT_BOUNDS = {"m0": (0.01003, "bytes"), "m_out": (0.09016, "bytes"),
                  "m_edge": (0.09033, "bytes"), "m_kitchen": (0.09055, "bytes"),
                  "m_kitchen_g1024": (0.03046, "bytes")}


@pytest.mark.parametrize("name", sorted(DEFAULT_BOUNDS))
def test_bound_at_the_default_geometry(name):
    inputs = dma_bisect.Inputs("cpu", rows=torch.zeros((dma_bisect.WRAP * 128 + 144) * 512))
    case = dma_bisect.make_case(name, inputs)
    ms, by = DEFAULT_BOUNDS[name]
    assert case.bound_by == by and case.bound_ms == pytest.approx(ms, abs=1e-5)


def test_scale_bound_counts_unique_reads_and_writes():
    inputs = dma_bisect.Inputs("cpu", scale_rows=torch.zeros(dma_bisect.SCALE_ROWS * 512))
    case = dma_bisect.make_case("scale_pre2d", inputs)
    assert case.read_bytes == (1022 * 128 + 144) * 512 * 4
    assert case.written_bytes == 128 * 1023 * 128 * 4
    assert case.bound_ms == pytest.approx(1e3 * (case.read_bytes + case.written_bytes) / 3.35e12)
    assert 0.09 < case.bound_ms < 0.11


def test_library_yardstick_reads_the_same_spans(inputs, rows_np):
    case = dma_bisect.make_case("m_out", inputs, n_tiles=N_TILES)
    sums = case.library()().numpy()
    assert sums.shape == (2, 3, 144)
    start = 128 * 2
    want = rows_np.reshape(-1, 512)[start:start + 144].astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(sums[1, 2], want, rtol=1e-5, atol=1e-3)


def test_wrappers_refuse_bad_geometry():
    rows = torch.zeros(300 * 512)
    with pytest.raises(ParameterError, match="tiles reach rows"):
        staged_probe.rowprobe(rows, n_tiles=4, wrap=None)
    with pytest.raises(ParameterError, match="edges must have shape"):
        staged_probe.rowprobe(rows, n_tiles=2, wrap=1, n_edge=2, e_start=1)
    with pytest.raises(ParameterError, match="float32"):
        staged_probe.colsum_probe(rows.double(), n_tiles=2, wrap=1)
    with pytest.raises(ParameterError, match="probe reads past"):
        staged_probe.rowprobe(rows, n_tiles=2, wrap=1, probe_offset=20)
    with pytest.raises(ParameterError, match="runs on cuda or cpu"):
        staged_probe.rowprobe(rows.to("meta"), n_tiles=2, wrap=1)


def test_chunks_hold_whole_probe_runs():
    assert staged_probe.chunk_rows_for(512, 144, 512) == 16
    assert staged_probe.chunk_rows_for(128, 576, 512) == 64
    assert staged_probe.chunk_rows_for(512, 11, 512) == 11
