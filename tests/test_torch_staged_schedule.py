"""The staged-copy kernels' schedule on the CPU: the split, the ring and every store.

``csrc/staged_schedule.cuh`` is compiled with ``g++`` in a small harness and
checked at the geometries the kernels run (``csrc/staged_probe.cu``):

- the (tile, chunk) split covers every chunk exactly once, in equal ranges,
  with the last tile in one block where ``stage_colsum`` asks for it, for
  m0, m_out, m_kitchen_g1024, the scale variants and the mel kernel's tile
  geometry, at grids of one and two blocks per SM of an H100 and others;
- ``stage_colsum``'s rotated walk takes each block's range once, turns at a
  tile boundary, keeps the last tile whole, and, at the pipeline's WRAP of
  1024, stages the tiles that share a start far apart in time, as a
  round-robin walk would, so that they are read from device memory;
- the ring's slot and parity sequence is the one a waiter on an mbarrier
  needs: slot ``i % slots``, parity ``(i // slots) & 1``;
- each chunk's probe elements lie wholly in the chunk and together cover
  ``0 .. tt``;
- the stores of every block, unit and output row, replayed into an output
  of labels, reproduce ``ops/staged_probe.py:rowprobe_reference``'s layout
  (element ``t`` of tile ``i`` at ``out[i, r, t]`` or ``out[track, r,
  within * tt + t]``), every element written once and none at or past
  ``out_cols``; every float4 of a row lands on a 16-byte boundary after the
  row's scalar head; rows of a stride that is a multiple of 4 floats share
  row 0's place in 16 bytes and are written together; the rows of
  ``out_cols = 8193`` at the mel kernel's geometry are written one lane a
  row.

Skips only where ``g++`` is absent.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from librosa_tpu_torch.ops import _build, staged_probe

HARNESS = r"""
#define __host__
#define __device__
#define __forceinline__ inline

#include "staged_schedule.cuh"

extern "C" long long range_start(long long total, long long n_chunks, int grid, int b,
                                 int pin_last) {
    return staged::range_start(total, n_chunks, grid, b, pin_last != 0);
}

extern "C" long long rotation_point(long long q0, long long q1, long long n_chunks,
                                    long long wrap, long long n_tiles) {
    return staged::rotation_point(q0, q1, n_chunks, wrap, n_tiles);
}

// slot and parity of items 0 .. n - 1 of a ring of `slots`
extern "C" void ring(int slots, int n, int* slot, int* phase) {
    staged::Ring r{slots, 0, 0u};
    for (int i = 0; i < n; ++i) {
        slot[i] = r.slot;
        phase[i] = (int)r.phase;
        r.advance();
    }
}

extern "C" int first_probe(int c, int runs_per_chunk, int offset_runs, int tt) {
    return staged::first_probe(c, runs_per_chunk, offset_runs, tt);
}

// Every block's units and rows, as the kernel's store warp walks them: label[dst + i] =
// tile * tt + t of the slab float it writes, hits[dst + i] += 1. routes[0] counts rows
// written together (a row stride that is a multiple of 4 floats), routes[1] rows written
// one lane a row, routes[2] faults (a unit that does not continue the walk, a head that
// does not end on a 16-byte boundary, rows written together at different places in 16
// bytes), routes[3] the largest slab position a unit uses + 1, routes[4] rows that
// start with scalars (head > 0).
extern "C" void stores(long long n_tiles, long long tiles_per_track, long long out_cols,
                       long long base, int n_chunks, int tt, int n_out, int group,
                       int contiguous, int runs_per_chunk, int offset_runs,
                       int grid, int slab_floats,
                       long long* label, int* hits, long long* routes) {
    staged::OutGeom o{n_tiles, tiles_per_track, out_cols, base, n_chunks, tt, n_out, group,
                      contiguous};
    const long long total = n_tiles * n_chunks;
    for (int b = 0; b < grid; ++b) {
        staged::UnitWalk w = staged::walk_start(
            o, staged::range_start(total, n_chunks, grid, b, false),
            staged::range_start(total, n_chunks, grid, b + 1, false));
        for (long long k = 0; w.q < w.q_end; ++k) {
            const long long q = w.q;
            const staged::Unit u = staged::next_unit(o, w);
            if (u.q_next <= q || u.tile0 * n_chunks + u.c_begin != q ||
                u.tile_last * n_chunks + u.c_end != u.q_next - 1 ||
                u.track != u.tile0 / tiles_per_track ||
                u.within0 != u.tile0 % tiles_per_track) {
                routes[2] += 1;  // a unit that does not continue the walk
            }
            const int t0 = staged::first_probe(u.c_begin, runs_per_chunk, offset_runs, tt);
            const int t1 = staged::first_probe(u.c_end + 1, runs_per_chunk, offset_runs, tt);
            const long long used = staged::slab_pos(u.tile_last, u.tile0, t1, tt);
            if (used > routes[3]) routes[3] = used;
            const staged::UnitStore us = staged::unit_store(o, u, t0, t1);
            const bool together = us.row_stride % 4 == 0;
            const int head0 = staged::row_store(o, us, 0).head;
            for (int r = 0; r < n_out; ++r) {
                const staged::Store s = staged::row_store(o, us, r);
                if (s.count == 0) continue;
                routes[together ? 0 : 1] += 1;
                if (s.head > 0) routes[4] += 1;
                if (s.head < 0 || s.head > 3 ||
                    (s.head < s.count && (base + 4 * (s.dst + s.head)) % 16)) {
                    routes[2] += 1;
                }
                if (together && s.head != head0) {
                    routes[2] += 1;  // rows that broadcast_rows writes at row 0's phase
                }
                for (int i = 0; i < s.count; ++i) {
                    const long long p = s.src + i;
                    label[s.dst + i] = (u.tile0 + p / tt) * tt + p % tt;
                    hits[s.dst + i] += 1;
                }
            }
        }
    }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("staged_schedule")
    src = tmp / "harness.cpp"
    src.write_text(HARNESS)
    so = tmp / "libstaged_schedule.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{_build.CSRC}", "-o",
                    str(so), str(src)], check=True, capture_output=True, text=True)
    handle = ctypes.CDLL(str(so))
    i64, i32, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    handle.range_start.argtypes = [i64, i64, i32, i32, i32]
    handle.range_start.restype = i64
    handle.ring.argtypes = [i32, i32, p, p]
    handle.first_probe.argtypes = [i32, i32, i32, i32]
    handle.first_probe.restype = i32
    handle.rotation_point.argtypes = [i64, i64, i64, i64, i64]
    handle.rotation_point.restype = i64
    handle.stores.argtypes = [i64, i64, i64, i64, i32, i32, i32, i32, i32, i32, i32, i32,
                              i32, p, p, p]
    return handle


# (n_tiles, chunks per tile) of the kernels' geometries: m0 and m_out (4096 tiles of 144
# rows of 512 in chunks of 16 rows), m_kitchen_g1024, the scale variants (1023 tiles), the
# mel kernel's geometry (16 tracks of 1025 tiles of 11 rows, one chunk each), the
# unaligned phase-5 case (300 tiles of 40 rows)
SPLITS = {"m0": (4096, 9), "g1024": (1024, 9), "scale": (1023, 9), "k1": (16 * 1025, 1),
          "unaligned": (300, 3)}
GRIDS = [1, 7, 132, 264, 1000]


@pytest.mark.parametrize("pin_last", [False, True], ids=["rowprobe", "colsum"])
@pytest.mark.parametrize("geom", sorted(SPLITS))
def test_split_covers_every_chunk_once(lib, geom, pin_last):
    n_tiles, n_chunks = SPLITS[geom]
    total = n_tiles * n_chunks
    for grid in GRIDS:
        grid = min(grid, total)
        starts = [lib.range_start(total, n_chunks, grid, b, int(pin_last))
                  for b in range(grid + 1)]
        assert starts[0] == 0 and starts[-1] == total
        assert all(a <= b for a, b in zip(starts, starts[1:]))  # contiguous, no overlap
        sizes = np.diff(starts)
        if not pin_last:  # equal ranges: no block more than one chunk beyond another
            assert sizes.max() - sizes.min() <= 1, (geom, grid)
        else:  # the last tile's chunks in one block; the others as even as before
            holders = [b for b in range(grid)
                       if starts[b] < starts[b + 1] and starts[b + 1] > total - n_chunks]
            assert len(holders) == 1
            assert starts[holders[0]] <= total - n_chunks and starts[holders[0] + 1] == total
            assert sizes.max() <= -(-total // grid) + n_chunks


def _walks(lib, n_tiles, n_chunks, wrap, grid, rotate=True):
    """Each block's chunks in stage_colsum's order: [p, q1), then [q0, p)."""
    total = n_tiles * n_chunks
    starts = [lib.range_start(total, n_chunks, grid, b, 1) for b in range(grid + 1)]
    walks = []
    for q0, q1 in zip(starts, starts[1:]):
        p = lib.rotation_point(q0, q1, n_chunks, wrap, n_tiles) if rotate else q0
        walks.append((q0, q1, p, list(range(p, q1)) + list(range(q0, p))))
    return walks


# (n_tiles, chunks per tile, wrap) of stage_colsum's cases: m0 and the pipeline at WRAP 128
# and 1024, a wrap beyond the tiles, small geometries
WALKS = {"wrap128": (4096, 9, 128), "wrap1024": (4096, 9, 1024), "nowrap": (4096, 9, 4096),
         "small": (61, 3, 7), "ragged": (1023, 9, 100)}


@pytest.mark.parametrize("geom", sorted(WALKS))
def test_rotated_walk_takes_the_range_once_and_keeps_the_last_tile_whole(lib, geom):
    n_tiles, n_chunks, wrap = WALKS[geom]
    total = n_tiles * n_chunks
    for grid in GRIDS:
        grid = min(grid, total)
        turned = 0
        for q0, q1, p, walk in _walks(lib, n_tiles, n_chunks, wrap, grid):
            assert sorted(walk) == list(range(q0, q1))
            assert q0 <= p <= q1 and (p == q0 or p % n_chunks == 0)
            turned += p != q0
            if q1 == total:  # the last tile, whole and in order, ends the walk's first part
                assert p <= total - n_chunks
                assert walk[q1 - p - n_chunks:q1 - p] == list(range(total - n_chunks, total))
        if wrap >= n_tiles:
            assert turned == 0  # one lap: nothing to spread
        elif 1 < grid <= n_tiles // 4:  # blocks in several laps, several whole tiles each
            assert turned > 0


@pytest.mark.parametrize("grid", [264, 132])
def test_tiles_that_share_a_start_are_staged_apart(lib, grid):
    # the pipeline at WRAP 1024: four tiles share each start, 295 KB staged a tile. Taking
    # every block's walk one chunk a step, a start staged again within 100 MB (twice the
    # L2) of the grid's staging would be served by the L2.
    n_tiles, n_chunks, wrap = WALKS["wrap1024"]
    near = 100e6 / (grid * 32768)

    def close_share(rotate):
        when = {}
        for _, _, _, walk in _walks(lib, n_tiles, n_chunks, wrap, grid, rotate):
            for step, q in enumerate(walk):
                when.setdefault(q // n_chunks, []).append(step)
        by_start = {}
        for tile, steps in when.items():
            by_start.setdefault(tile % wrap, []).append(np.mean(steps))
        gaps = np.concatenate([np.diff(sorted(v)) for v in by_start.values()])
        assert gaps.size == n_tiles - wrap
        return float(np.mean(gaps < near))

    assert close_share(rotate=False) > 0.9   # equal ranges in order: at the same moment
    assert close_share(rotate=True) < 0.02


def test_ring_slots_and_parities(lib):
    for slots in (2, 3, 6, 10, 16):
        n = 7 * slots + 3
        slot = np.zeros(n, dtype=np.int32)
        phase = np.zeros(n, dtype=np.int32)
        lib.ring(slots, n, slot.ctypes.data, phase.ctypes.data)
        i = np.arange(n)
        np.testing.assert_array_equal(slot, i % slots)
        np.testing.assert_array_equal(phase, (i // slots) & 1)
        # an mbarrier model: round k of a slot is its k-th phase; a consumer of item i waits
        # for the phase whose parity is phase[i], which the item's own copy completes; the
        # producer of item i >= slots waits for the empty phase of round k - 1: parity
        # phase[i] ^ 1, completed by the consumers of item i - slots
        completed = np.zeros(slots, dtype=np.int64)
        for k in range(n):
            s = slot[k]
            if k >= slots:
                assert (completed[s] - 1) & 1 == phase[k] ^ 1
            completed[s] += 1
            assert (completed[s] - 1) & 1 == phase[k]


# (width, rows per tile, probe offset rows, probe width, tt) of the kernels' row probes
PROBES = {"m_out": (512, 144, 0, 512, 128), "m_kitchen": (512, 144, 6, 512, 128),
          "scale_flat128": (128, 576, 0, 512, 128), "k1": (512, 11, 0, 512, 8),
          "unaligned": (512, 40, 3, 512, 30)}


def _probe_floats(name):
    """(chunk floats, probe offset floats, probe width, tt, span floats), as the wrapper passes."""
    width, rows, offset, pw, tt = PROBES[name]
    return width * staged_probe.chunk_rows_for(width, rows, pw), offset * width, pw, tt, \
        rows * width


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_elements_lie_in_their_chunk(lib, name):
    cf, po, pw, tt, span = _probe_floats(name)
    assert cf % pw == 0 and po % pw == 0  # whole runs: what the launch asks for
    n_chunks = -(-span // cf)
    bounds = [lib.first_probe(c, cf // pw, po // pw, tt) for c in range(n_chunks + 1)]
    assert bounds[0] == 0 and bounds[-1] == tt
    for c in range(n_chunks):
        for t in range(bounds[c], bounds[c + 1]):
            assert c * cf <= po + t * pw and po + (t + 1) * pw <= min((c + 1) * cf, span)


def _replay(lib, *, n_tiles, tiles_per_track, out_cols, n_out, tt, group, contiguous,
            n_chunks, cf, po, pw, grid, base=0):
    slab_floats = -(-(tt if contiguous else group * tt) // 4) * 4
    n_tracks = n_tiles // tiles_per_track
    shape = (n_tiles, n_out, tt) if contiguous else (n_tracks, n_out, out_cols)
    label = np.full(int(np.prod(shape)), -1, dtype=np.int64)
    hits = np.zeros(label.size, dtype=np.int32)
    routes = np.zeros(5, dtype=np.int64)
    lib.stores(n_tiles, tiles_per_track, out_cols, base, n_chunks, tt, n_out, group,
               int(contiguous), cf // pw, po // pw, grid, slab_floats, label.ctypes.data,
               hits.ctypes.data, routes.ctypes.data)
    # the layout rowprobe_reference writes: element t of tile i
    tile = np.arange(n_tiles)
    labels = tile[:, None] * tt + np.arange(tt)
    if contiguous:
        want = np.broadcast_to(labels[:, None, :], shape)
    else:
        want = np.broadcast_to(labels.reshape(n_tracks, 1, tiles_per_track * tt)[..., :out_cols],
                               shape)
    np.testing.assert_array_equal(hits, 1)
    np.testing.assert_array_equal(label.reshape(shape), want)
    assert routes[2] == 0, "a store's route does not fit its alignment"
    assert routes[3] <= slab_floats
    return routes


# (n_tiles, tiles per track, out_cols, n_out, tt, group, contiguous, n_chunks, probe geometry)
LAYOUTS = {
    "m_out": (4096, 4096, 4096 * 128, 2, 128, 1, False, 9, "m_out"),
    "m_outg4": (4096, 4096, 4096 * 128, 2, 128, 4, False, 9, "m_out"),
    "m_outg8": (4096, 4096, 4096 * 128, 2, 128, 8, False, 9, "m_out"),
    "m_outc": (4096, 4096, 128, 2, 128, 1, True, 9, "m_out"),
    "m_kitchen": (4096, 4096, 4096 * 128, 2, 128, 1, False, 9, "m_kitchen"),
    "g1024": (1024, 1024, 1024 * 128, 3, 128, 1, False, 9, "m_kitchen"),
    "scale": (1023, 1023, 1023 * 128, 2, 128, 1, False, 9, "scale_flat128"),
    "k1": (16 * 1025, 1025, 8193, 5, 8, 1, False, 1, "k1"),
    "unaligned": (300, 100, 2993, 5, 30, 2, False, 3, "unaligned"),
}


@pytest.mark.parametrize("grid", [132, 264, 61])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_stores_reproduce_the_reference_layout(lib, name, grid):
    n_tiles, tpt, cols, n_out, tt, group, contiguous, n_chunks, probe = LAYOUTS[name]
    cf, po, pw, _, _ = _probe_floats(probe)
    routes = _replay(lib, n_tiles=n_tiles, tiles_per_track=tpt, out_cols=cols, n_out=n_out,
                     tt=tt, group=group, contiguous=contiguous, n_chunks=n_chunks, cf=cf,
                     po=po, pw=pw, grid=grid)
    if name in ("k1", "unaligned"):  # rows of 8193 / 2993 floats: one lane a row
        assert routes[0] == 0 and routes[1] > 0
    else:  # a row stride of whole float4s: every row at row 0's place, written together
        assert routes[1] == 0 and routes[0] > 0
    if name.startswith("m_out") and grid in (132, 264):  # ranges split tiles at 16 probes
        assert routes[4] == 0


def test_an_unaligned_output_base_takes_thread_stores(lib):
    n_tiles, tpt, cols, n_out, tt, group, contiguous, n_chunks, probe = LAYOUTS["m_out"]
    cf, po, pw, _, _ = _probe_floats(probe)
    routes = _replay(lib, n_tiles=64, tiles_per_track=64, out_cols=64 * tt, n_out=3, tt=tt,
                     group=1, contiguous=False, n_chunks=n_chunks, cf=cf, po=po, pw=pw,
                     grid=5, base=4)
    # every row starts with scalars up to the first 16-byte boundary, then float4s there
    assert routes[0] > 0 and routes[4] == routes[0] + routes[1]
