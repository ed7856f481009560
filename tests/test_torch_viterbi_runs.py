"""Kernel B's cluster route on the CPU: the run table, the run walk and its exactness.

The cluster route of ``csrc/viterbi.cu`` visits, for each next state ``n``,
only the runs of finite entries of ``log_trans[:, n]``
(``ops/viterbi.py:RunTable``), splits a column over a group of lanes, and
gives ``p = 0`` where every visited sum is ``-inf``. Here

- the run table is checked on pYIN's 870-state table (two runs a column,
  144.08 finite entries on average, 155 at most), on a dense matrix, on
  all ``-inf`` columns and on one state, and rebuilt into the matrix;
- a torch emulation of the scan over the runs alone (a test helper: nothing
  on the path calls it) is held bit for bit against
  ``ops/viterbi.py:viterbi_reference`` and against the JAX package's
  ``_viterbi_scan``;
- ``csrc/viterbi_runs.cuh``, the code each group of lanes runs, is compiled
  with ``g++`` into a forward pass and backtrack that split every column
  over G lanes and combine them as the kernel's shuffle tree does, and held
  bit for bit against the plain version for G = 4, 8, 16, 32;
- the decoders build a matrix's run table on the host once and hand the
  cached table to the wrapper on every later call.

The compiled cases skip only where ``g++`` is absent.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from librosa_tpu import sequence as jax_sequence

import librosa_tpu_torch as L
from librosa_tpu_torch import _device
from librosa_tpu_torch.core import pitch
from librosa_tpu_torch.ops import _build, viterbi
from librosa_tpu_torch.util.exceptions import ParameterError

PYIN_KEY = (22050.0, 65.0, 800.0, 512, 100, (2.0, 18.0), 0.1, 35.92, 0.01, 1e-4)
LOGP_RTOL = 1e-5  # tests/test_torch_sequence.py's tolerance for the JAX scan's logp

HARNESS = r"""
#include <climits>
#include <cmath>
#include <vector>

#define __host__
#define __device__
#define __forceinline__ inline
static inline float __fadd_rn(float a, float b) { return a + b; }

#include "viterbi_runs.cuh"

// The cluster route's forward pass and backtrack for one group size G: every column's
// lanes walk its runs with lane_best, then combine as the kernel's __shfl_xor_sync tree.
extern "C" int decode_runs(const float* lp, const float* lpi, const float* vals,
                           const int* col_run, const int* run_start, const int* run_len,
                           const int* run_val, int R, int T, int S, int G, int* states,
                           float* logp) {
    std::vector<float> cur(S), nxt(S), best(G), nb(G);
    std::vector<int> ptr((size_t)T * S), bp(G), np_(G);
    for (int r = 0; r < R; ++r) {
        const float* l = lp + (size_t)r * T * S;
        for (int n = 0; n < S; ++n) cur[n] = __fadd_rn(l[n], lpi[n]);
        for (int t = 1; t < T; ++t) {
            for (int n = 0; n < S; ++n) {
                for (int lane = 0; lane < G; ++lane) {
                    best[lane] = -INFINITY;
                    bp[lane] = INT_MAX;
                    viterbi_runs::lane_best(cur.data(), vals, 0, run_start, run_len, run_val,
                                            col_run[n], col_run[n + 1], lane, G, best[lane],
                                            bp[lane]);
                }
                for (int off = G / 2; off > 0; off >>= 1) {
                    for (int lane = 0; lane < G; ++lane) {
                        const int o = lane ^ off;
                        const bool take = viterbi_runs::takes(best[o], bp[o], best[lane], bp[lane]);
                        nb[lane] = take ? best[o] : best[lane];
                        np_[lane] = take ? bp[o] : bp[lane];
                    }
                    best.swap(nb);
                    bp.swap(np_);
                }
                ptr[(size_t)t * S + n] = viterbi_runs::pointer_of(best[0], bp[0]);
                nxt[n] = __fadd_rn(l[(size_t)t * S + n], best[0]);
            }
            cur.swap(nxt);
        }
        float b = -INFINITY;
        int s = INT_MAX;
        for (int n = 0; n < S; ++n)
            if (viterbi_runs::takes(cur[n], n, b, s)) { b = cur[n]; s = n; }
        logp[r] = s == INT_MAX ? cur[0] : b;
        s = s == INT_MAX ? 0 : s;
        int* st = states + (size_t)r * T;
        st[T - 1] = s;
        for (int t = T - 1; t > 0; --t) st[t - 1] = s = ptr[(size_t)t * S + s];
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def pyin_trans():
    _, _, log_trans, log_p_init = pitch._pyin_tables(*PYIN_KEY)
    return log_trans.astype(np.float32), log_p_init.astype(np.float32)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("viterbi_runs")
    src = tmp / "harness.cpp"
    src.write_text(HARNESS)
    so = tmp / "libviterbi_runs.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{_build.CSRC}", "-o",
                    str(so), str(src)], check=True, capture_output=True, text=True)
    handle = ctypes.CDLL(str(so))
    handle.decode_runs.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    handle.decode_runs.restype = ctypes.c_int
    return handle


def _dense(table: viterbi.RunTable) -> np.ndarray:
    """The matrix a run table describes: its values in their runs, -inf elsewhere."""
    out = np.full((table.S, table.S), -np.inf, dtype=np.float32)
    for n in range(table.S):
        for k in range(table.col_run[n], table.col_run[n + 1]):
            p0, length, v0 = table.run_start[k], table.run_len[k], table.run_val[k]
            out[p0:p0 + length, n] = table.vals[v0:v0 + length]
    return out


def _random(rng, rows, T, S, pruned, empty=0.05):
    lp = np.log(rng.rand(rows, T, S)).astype(np.float32)
    lp[rng.rand(rows, T, S) < empty] = -np.inf  # empty states, as pYIN's float32 log gives
    lt = np.log(rng.rand(S, S)).astype(np.float32)
    if pruned:
        lt[rng.rand(S, S) < 0.3] = -np.inf
    return lp, lt, np.log(np.full(S, 1.0 / S)).astype(np.float32)


def _cases(pyin):
    """The phase 4i cases of chip_smoke.py at a small size: (label, lp, lt, lpi)."""
    rng = np.random.RandomState(10)
    lt870, lpi870 = pyin
    out = [("S 2", *_random(rng, 3, 9, 2, False)),
           ("S 5 pruned", *_random(rng, 3, 12, 5, True))]
    lp = rng.randint(-3, 1, size=(2, 10, 7)).astype(np.float32)
    out.append(("ties everywhere", lp, np.zeros((7, 7), np.float32), np.zeros(7, np.float32)))
    lp, lt, lpi = _random(rng, 2, 10, 23, True)
    lt[:, [4, 11]] = -np.inf
    out.append(("two all -inf columns", lp, lt, lpi))
    lp, lt, lpi = _random(rng, 2, 10, 19, False)
    lp[:, 3:5, :] = -np.inf
    out.append(("all -inf frames", lp, lt, lpi))
    lp = _random(rng, 2, 8, 870, False)[0]
    out.append(("pYIN", lp, lt870, lpi870))
    lp = _random(rng, 2, 8, 870, False)[0]
    lp[:, 3:5, np.isfinite(lt870[:, 300])] = -np.inf  # column 300's sums are all -inf there
    out.append(("pYIN, -inf over a column's runs", lp, lt870, lpi870))
    lt = lt870.copy()
    lt[:, [17, 600]] = -np.inf
    out.append(("pYIN, two all -inf columns", _random(rng, 2, 8, 870, False)[0], lt, lpi870))
    return out


CASE_IDS = ["S2", "S5_pruned", "ties", "empty_columns", "empty_frames", "pyin",
            "pyin_empty_runs", "pyin_empty_columns"]


def scan_over_runs(lp: torch.Tensor, table: viterbi.RunTable,
                   lpi: torch.Tensor) -> tuple:
    """The cluster route's forward pass and backtrack in torch, visiting only the runs.

    Per frame: the sum at every packed finite entry, each column's maximum
    over its entries, the first ``p`` that reaches it, and ``p = 0`` where
    the maximum is ``-inf``. A test helper, held to the plain version.
    """
    R, T, S = lp.shape
    counts = np.diff(table.col_val)
    col = torch.from_numpy(np.repeat(np.arange(S), counts)).long()
    row = torch.from_numpy(np.concatenate(
        [np.arange(s, s + n) for s, n in zip(table.run_start, table.run_len)]
        or [np.zeros(0, np.int64)])).long()
    vals = torch.from_numpy(table.vals)
    v = lp[:, 0] + lpi
    ptrs = torch.zeros((R, T, S), dtype=torch.int64)
    for t in range(1, T):
        sums = v[:, row] + vals  # (R, entries), the plain version's floats
        best = torch.full((R, S), float("-inf")).scatter_reduce(
            1, col.expand(R, -1), sums, "amax", include_self=True)
        at_best = (sums == best[:, col]) & (sums > float("-inf"))
        first = torch.full((R, S), S, dtype=torch.int64).scatter_reduce(
            1, col.expand(R, -1), torch.where(at_best, row.expand(R, -1), S), "amin",
            include_self=True)
        ptrs[:, t] = torch.where(best > float("-inf"), first, 0)
        v = lp[:, t] + best
    logp, last = v.max(dim=-1)
    states = torch.empty((R, T), dtype=torch.int64)
    states[:, T - 1] = last
    for t in range(T - 1, 0, -1):
        states[:, t - 1] = ptrs[:, t].gather(1, states[:, t:t + 1])[:, 0]
    return states.int(), logp


# ---------------------------------------------------------------------------
# the run table
# ---------------------------------------------------------------------------


def test_pyin_table_has_two_runs_a_column(pyin_trans):
    table = viterbi.run_table(pyin_trans[0])
    assert table.S == 870
    assert set(table.runs_per_column.tolist()) == {2}
    assert table.finite_per_column.mean() == pytest.approx(144.08, abs=0.005)
    assert int(table.finite_per_column.max()) == 155
    assert table.n_finite / 870**2 == pytest.approx(0.1656, abs=5e-5)
    assert np.array_equal(_dense(table), pyin_trans[0])
    # one round of columns at cluster 8 (109 columns x 4 lanes <= 512 threads): 4 lanes
    assert table.group(8) == 4 and table.group(4) == 4
    assert table.share_vals(8) * 4 < 64 * 1024  # a block's share fits its shared memory


@pytest.mark.parametrize("kind", ["dense", "empty_columns", "one_state", "all_empty",
                                  "pruned"])
def test_run_table_rebuilds_its_matrix(kind):
    rng = np.random.RandomState(3)
    S = {"one_state": 1}.get(kind, 37)
    lt = np.log(rng.rand(S, S)).astype(np.float32)
    if kind == "empty_columns":
        lt[:, [0, 5, 36]] = -np.inf
    elif kind == "all_empty":
        lt[:] = -np.inf
    elif kind == "pruned":
        lt[rng.rand(S, S) < 0.5] = -np.inf
    table = viterbi.run_table(lt)
    assert np.array_equal(_dense(table), lt)
    assert len(table.col_run) == len(table.col_val) == S + 1
    runs = table.runs_per_column
    if kind in ("dense", "one_state"):
        assert runs.tolist() == [1] * S and table.run_len.tolist() == [S] * S
    if kind == "empty_columns":
        assert runs[[0, 5, 36]].tolist() == [0, 0, 0] and (runs[1:5] == 1).all()
    if kind == "all_empty":
        assert table.n_finite == 0 and len(table.run_len) == 0
    for cluster in (1, 4, 8):
        share = -(-S // cluster)
        blocks = [table.finite_per_column[b * share:(b + 1) * share].sum()
                  for b in range(cluster)]
        assert table.share_vals(cluster) == max(blocks)


@pytest.mark.parametrize("S,cluster,group", [(870, 8, 4), (870, 4, 4), (64, 8, 32),
                                             (256, 8, 16), (2, 8, 32), (2000, 8, 4)])
def test_group_takes_a_share_in_one_round(S, cluster, group):
    table = viterbi.run_table(np.zeros((S, S), np.float32))
    assert table.group(cluster) == group
    share = -(-S // cluster)
    assert group == 4 or share * group <= 512


def test_routes_by_states():
    assert viterbi.route_for(viterbi.CLUSTER_MIN_STATES - 1, 16) == "block"
    assert viterbi.route_for(viterbi.CLUSTER_MIN_STATES, 16) == "cluster"
    assert viterbi.route_for(870, 2**31 // viterbi.CLUSTER + 1) == "block"
    assert viterbi.MAX_STATES <= 2**15 - 1  # the pointers are int16


# ---------------------------------------------------------------------------
# the scan over the runs: torch emulation and the compiled header
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index", range(8), ids=CASE_IDS)
def test_scan_over_runs_is_the_plain_version_bit_for_bit(pyin_trans, index):
    label, lp, lt, lpi = _cases(pyin_trans)[index]
    want_s, want_p = viterbi.viterbi_reference(torch.from_numpy(lp), torch.from_numpy(lt),
                                               torch.from_numpy(lpi))
    got_s, got_p = scan_over_runs(torch.from_numpy(lp), viterbi.run_table(lt),
                                  torch.from_numpy(lpi))
    assert torch.equal(got_s, want_s), label
    assert torch.equal(got_p, want_p), label
    states_j, logp_j = jax_sequence._viterbi_scan(jnp.asarray(lp), jnp.asarray(lt),
                                                  jnp.asarray(lpi))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(states_j))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(logp_j), rtol=LOGP_RTOL)


@pytest.mark.parametrize("group", [4, 8, 16, 32])
@pytest.mark.parametrize("index", range(8), ids=CASE_IDS)
def test_compiled_run_walk_is_the_plain_version_bit_for_bit(lib, pyin_trans, index, group):
    label, lp, lt, lpi = _cases(pyin_trans)[index]
    table = viterbi.run_table(lt)
    R, T, S = lp.shape
    states = np.full((R, T), -9, np.int32)
    logp = np.full(R, np.nan, np.float32)
    vals = table.vals if table.vals.size else np.zeros(1, np.float32)
    arrays = [np.ascontiguousarray(a) for a in (lp, lpi, vals, table.col_run, table.run_start,
                                                table.run_len, table.run_val)]
    assert lib.decode_runs(*(a.ctypes.data for a in arrays), R, T, S, group,
                           states.ctypes.data, logp.ctypes.data) == 0
    want_s, want_p = viterbi.viterbi_reference(torch.from_numpy(lp), torch.from_numpy(lt),
                                               torch.from_numpy(lpi))
    np.testing.assert_array_equal(states, want_s.numpy(), err_msg=label)
    np.testing.assert_array_equal(logp, want_p.numpy(), err_msg=label)


# ---------------------------------------------------------------------------
# the run table's cache: built on the host once per matrix, never read back
# ---------------------------------------------------------------------------


@pytest.fixture
def builds(monkeypatch):
    """The shapes of the run tables built during the test, from an empty table cache, with
    the port on the CPU and every table that reaches ``viterbi_decode`` in ``builds.seen``."""
    monkeypatch.setattr(_device, "_tables", {})
    make, decode = viterbi.run_table, viterbi.viterbi_decode

    def counting(log_trans):
        shapes.append(np.asarray(log_trans).shape)
        return make(log_trans)

    def spy(lp, lt_, lpi, runs=None):
        shapes.seen.append((lt_, runs))
        return decode(lp, lt_, lpi, runs)

    shapes = type("Builds", (list,), {})()
    shapes.seen = []
    monkeypatch.setattr(viterbi, "run_table", counting)
    monkeypatch.setattr(viterbi, "viterbi_decode", spy)
    prev = L.get_device()
    L.set_device("cpu")
    yield shapes
    L.set_device(prev)


def test_decoders_build_a_run_table_once_per_matrix(builds):
    rng = np.random.RandomState(11)
    S = viterbi.CLUSTER_MIN_STATES + 2  # the cluster route's side of the threshold
    trans = L.sequence.transition_local(S, 9)
    prob = rng.rand(S, 12).astype(np.float32)
    first = L.sequence.viterbi(prob, trans.copy(), transition_min_prob=1e-3)
    second = L.sequence.viterbi(prob, trans.copy(), transition_min_prob=1e-3)
    assert builds == [(S, S)]
    (lt1, runs1), (lt2, runs2) = builds.seen
    assert runs1 is not None and runs1 is runs2 and lt1 is lt2
    assert np.array_equal(_dense(runs1), lt1.numpy())
    assert runs1.runs_per_column.max() == 1  # a band a column
    np.testing.assert_array_equal(first, second)
    # another matrix builds its own table; a float64 decode builds none
    L.sequence.viterbi(prob, L.sequence.transition_local(S, 7), transition_min_prob=1e-3)
    L.sequence.viterbi(prob.astype(np.float64), trans, transition_min_prob=1e-3)
    assert builds == [(S, S), (S, S)] and len(builds.seen) == 3


def test_decoders_below_the_route_threshold_build_no_run_table(builds):
    S = viterbi.CLUSTER_MIN_STATES - 1
    prob = np.random.RandomState(12).rand(S, 6).astype(np.float32)
    L.sequence.viterbi(prob, L.sequence.transition_uniform(S))
    assert builds == [] and builds.seen[0][1] is None


def test_pyin_builds_its_run_table_once(builds):
    y = (0.5 * np.sin(2 * np.pi * 220 * np.arange(11025) / 22050)).astype(np.float32)
    f_a, v_a, _ = L.pyin(y, fmin=65.0, fmax=800.0, sr=22050)
    f_b, v_b, _ = L.pyin(y, fmin=65.0, fmax=800.0, sr=22050)
    assert builds == [(870, 870)]
    (_, runs1), (_, runs2) = builds.seen
    assert runs1 is runs2 and set(runs1.runs_per_column.tolist()) == {2}
    assert torch.equal(v_a, v_b) and torch.equal(torch.nan_to_num(f_a), torch.nan_to_num(f_b))


@pytest.mark.parametrize("kind", ["pyin", "all_empty"])
def test_run_table_on_a_device_copies_its_arrays(pyin_trans, kind):
    lt = pyin_trans[0] if kind == "pyin" else np.full((6, 6), -np.inf, np.float32)
    table = viterbi.run_table(lt)
    on = table.on(torch.device("cpu"))
    assert table.device is None and on.S == table.S
    for name in ("col_run", "col_val", "run_start", "run_len", "run_val"):
        assert np.array_equal(on.device[name].numpy(), getattr(table, name))
    want_vals = table.vals if table.vals.size else np.zeros(1, np.float32)  # a valid pointer
    assert np.array_equal(on.device["vals"].numpy(), want_vals)


def test_runs_must_describe_the_matrix():
    table = viterbi.run_table(np.zeros((5, 5), np.float32)).on(torch.device("cpu"))
    assert viterbi._runs_on(table, torch.zeros(5, 5)) is table
    with pytest.raises(ParameterError):
        viterbi._runs_on(table, torch.zeros(6, 6))
    with pytest.raises(ParameterError):
        viterbi._runs_on(viterbi.run_table(np.zeros((5, 5), np.float32)), torch.zeros(5, 5))
    built = viterbi._runs_on(None, torch.full((4, 4), -1.5))
    assert np.array_equal(_dense(built), np.full((4, 4), -1.5, np.float32))
