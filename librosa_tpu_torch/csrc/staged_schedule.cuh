// The schedule of the staged-copy kernels (csrc/staged_probe.cu), as plain C++.
//
// Work: n_tiles tiles of n_chunks chunks each, numbered in one sequence, chunk q being
// chunk q % n_chunks of tile q / n_chunks. Block b of a grid of B takes the chunks
// [start(b), start(b + 1)), start(b) = floor(b * total / B): equal ranges, so no block
// idles through a half-empty last round. With `pin_last` (stage_colsum, whose output is
// the last tile's column sums) a start that falls inside the last tile moves to that
// tile's first chunk, so one block sums the whole tile in one fixed order whatever the
// grid.
//
// stage_colsum takes its range in a rotated order. Where n_tiles tiles wrap over `wrap`
// starts, laps = ceil(n_tiles / wrap) tiles share each start, and in equal ranges the
// blocks that hold them reach them at the same place in their ranges: they would stage
// one start at the same moment, and all but the first would read it from the L2. So a
// block whose first whole tile lies in lap l starts its walk l / laps of the way through
// its whole tiles, at a tile boundary, and takes the chunks before that point last
// (rotation_point). The reads of one start then lie about as far apart as in a walk
// that deals tiles out round-robin. The last tile stays whole at the end of the first
// part of its block's walk.
//
// A block walks its chunks through a ring of `slots` shared-memory slots: item i of its
// range goes to slot i % slots in round i / slots. Each slot has a `full` mbarrier (one
// arrival with the copy's byte count, completed by the copy) and an `empty` mbarrier
// (one arrival per consumer warp). The consumers of item i wait for the completion of
// round i / slots of `full` (parity round & 1); the producer, before it refills a slot
// in round k >= 1, waits for the completion of round k - 1 of `empty` (parity
// (k - 1) & 1). Ring::advance keeps slot and parity without a division.
//
// stage_rowprobe: probe element t of a tile is the run of probe_width floats from
// probe_offset + t * probe_width floats into the tile's span. A chunk holds whole runs
// (the wrapper's chunk_rows_for) and the offset is whole runs, so element t lies in one
// chunk, and the chunk c holds the elements [first_probe(c), first_probe(c + 1)).
// A block gathers its elements in a shared slab for one output unit at a time: a run of
// consecutive tiles in one group of `group` tiles and one track (strided layout), or one
// tile (contiguous layout), cut at the block's range ends (UnitWalk: a block divides once,
// at its first unit, and steps from unit to unit). At a unit's end each of the
// n_out output rows gets the unit's run (unit_store: the first row's place and the row
// stride, computed once a unit). Where the row stride is a multiple of 4 floats every row
// sits at row 0's place in 16 bytes, and the kernel writes them all from float4s loaded
// once; else each row by thread stores (row_store: scalars to the first 16-byte boundary,
// float4s, scalars).
// Columns at and past out_cols are never written.
//
// tests/test_torch_staged_schedule.py compiles this header with g++ and checks the
// split, the rotation, the ring and every store against
// ops/staged_probe.py:rowprobe_reference's layout.

#pragma once

namespace staged {

// the first chunk of block b's range; start(grid) is total
__host__ __device__ __forceinline__ long long range_start(long long total, long long n_chunks,
                                                          int grid, int b, bool pin_last) {
    if (b >= grid) return total;
    long long s = (long long)b * total / grid;
    if (pin_last && s > total - n_chunks) s = total - n_chunks;
    return s;
}

// Where block [q0, q1) of stage_colsum starts its walk: it takes [p, q1), then [q0, p).
__host__ __device__ __forceinline__ long long rotation_point(long long q0, long long q1,
                                                             long long n_chunks, long long wrap,
                                                             long long n_tiles) {
    const long long t0 = (q0 + n_chunks - 1) / n_chunks;  // the range's whole tiles: [t0, t1)
    const long long t1 = q1 / n_chunks;
    const long long laps = (n_tiles + wrap - 1) / wrap;
    if (t1 <= t0 || laps <= 1) return q0;
    const long long turn = (t0 / wrap) * (t1 - t0) / laps;
    return turn == 0 ? q0 : (t0 + turn) * n_chunks;
}

struct Ring {
    int slots;
    int slot;
    unsigned phase;  // the round's parity: the full barrier's phase to wait for
    __host__ __device__ __forceinline__ void advance() {
        if (++slot == slots) {
            slot = 0;
            phase ^= 1u;
        }
    }
};

// the first probe element of chunk c: a chunk holds runs_per_chunk whole runs and the
// probe starts offset_runs runs into the span (the launch refuses other geometries)
__host__ __device__ __forceinline__ int first_probe(int c, int runs_per_chunk, int offset_runs,
                                                    int tt) {
    const int t = c * runs_per_chunk - offset_runs;
    return t <= 0 ? 0 : t < tt ? t : tt;
}

struct OutGeom {
    long long n_tiles;
    long long tiles_per_track;
    long long out_cols;   // columns of a track's output rows (strided layout)
    long long base;       // the output's address in bytes (for each row's place in 16 bytes)
    int n_chunks;
    int tt;
    int n_out;
    int group;
    int contiguous;       // 1: out[tile, r, t]; 0: out[track, r, within * tt + t]
};

// One output unit of a block: tiles tile0 .. tile_last (tile0 being tile `within0` of
// track `track`), from chunk c_begin of tile0 to chunk c_end of tile_last, its items
// ending before q_next.
struct Unit {
    long long tile0, tile_last, q_next, track, within0;
    int c_begin, c_end;
};

// A block's walk over the units of its range: the next unit's first item q (before q_end),
// tile, chunk, track and place in the track, and the last tile of its group. Only
// walk_start divides; next_unit steps.
struct UnitWalk {
    long long q, q_end, tile, track, within, group_end;
    int c;
};

__host__ __device__ __forceinline__ UnitWalk walk_start(const OutGeom& o, long long q0,
                                                        long long q1) {
    UnitWalk w;
    w.q = q0;
    w.q_end = q1;
    w.tile = q0 / o.n_chunks;
    w.c = (int)(q0 - w.tile * o.n_chunks);
    w.track = w.tile / o.tiles_per_track;
    w.within = w.tile - w.track * o.tiles_per_track;
    w.group_end = (w.tile / o.group + 1) * o.group - 1;
    return w;
}

// the walk's next unit (w.q < w.q_end), the walk moved past it
__host__ __device__ __forceinline__ Unit next_unit(const OutGeom& o, UnitWalk& w) {
    long long last = w.tile;  // contiguous layout: a unit is a tile
    if (!o.contiguous) {      // strided: to the end of the group or the track
        const long long track_end = w.tile + (o.tiles_per_track - 1 - w.within);
        last = w.group_end < track_end ? w.group_end : track_end;
    }
    Unit u;
    u.tile0 = w.tile;
    u.track = w.track;
    u.within0 = w.within;
    u.c_begin = w.c;
    const long long whole = w.q + (last - w.tile + 1) * o.n_chunks - w.c;
    if (whole <= w.q_end) {
        u.q_next = whole;
        u.tile_last = last;
        u.c_end = o.n_chunks - 1;
    } else {  // the range ends inside the unit
        const long long items = w.q_end - w.q + w.c;  // from chunk 0 of tile0
        u.q_next = w.q_end;
        u.tile_last = w.tile + (items - 1) / o.n_chunks;
        u.c_end = (int)((items - 1) % o.n_chunks);
    }
    w.q = u.q_next;
    w.tile = last + 1;
    w.c = 0;
    w.within += last - u.tile0 + 1;
    if (w.within == o.tiles_per_track) {
        w.within = 0;
        ++w.track;
    }
    if (w.tile > w.group_end) w.group_end += o.group;
    return u;
}

// the slab position of element t of tile `tile` in a unit that starts at tile0
__host__ __device__ __forceinline__ int slab_pos(long long tile, long long tile0, int t, int tt) {
    return (int)(tile - tile0) * tt + t;
}

// A unit's stores: output row r takes `count` floats from slab position `src` at output
// element dst0 + r * row_stride (clipped at out_cols; count 0 where nothing is left).
struct UnitStore {
    long long dst0;
    long long row_stride;
    int src;
    int count;
};

__host__ __device__ __forceinline__ UnitStore unit_store(const OutGeom& o, const Unit& u,
                                                         int t_begin, int t_end) {
    UnitStore s;
    s.src = t_begin;
    long long count = slab_pos(u.tile_last, u.tile0, t_end, o.tt) - t_begin;
    if (o.contiguous) {
        s.dst0 = u.tile0 * o.n_out * o.tt + t_begin;
        s.row_stride = o.tt;
    } else {
        const long long col = u.within0 * o.tt + t_begin;
        if (col + count > o.out_cols) count = o.out_cols - col;
        s.dst0 = u.track * o.n_out * o.out_cols + col;
        s.row_stride = o.out_cols;
    }
    s.count = count > 0 ? (int)count : 0;
    return s;
}

// One output row's store: `count` floats from slab position `src` to output element `dst`,
// `head` of them before the first 16-byte boundary.
struct Store {
    long long dst;
    int src;
    int count;
    int head;
};

__host__ __device__ __forceinline__ Store row_store(const OutGeom& o, const UnitStore& us, int r) {
    Store s;
    s.dst = us.dst0 + r * us.row_stride;
    s.src = us.src;
    s.count = us.count;
    const int to_edge = (int)((4 - ((o.base + 4 * s.dst) / 4) % 4) % 4);
    s.head = to_edge < s.count ? to_edge : s.count;
    return s;
}

}  // namespace staged
