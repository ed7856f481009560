// Staged-copy probes: tiles of rows copied from device memory into shared memory by TMA
// bulk copies, then reduced. Built for sm_90a.
//
// These are the Hopper counterparts of the copy diagnostics in scripts/dma_bisect.py
// (make_m0, make_m_out, make_m_edge, make_m_kitchen, make_m_scale) and
// scripts/dma_pipeline_micro.py (run). They compute the same functions
// (ops/staged_probe.py states them) and stage the same bytes: every tile's full span of
// `span_rows` rows of `width` floats goes through shared memory by bulk copies of its own,
// though the row probe reduces only some of them.
//
//   stage_colsum    (make_m0, run): the column sums of every tile; only the last tile's
//                   sums are written, as the TPU grid's one revisited (1, width) output
//                   block ended with them.
//   stage_rowprobe  (make_m_out, make_m_edge, make_m_kitchen, make_m_scale): per tile,
//                   probe[t] = the sum of the t-th run of `probe_width` floats from
//                   `probe_offset` floats into the span, plus the table and scratch terms,
//                   written to n_out rows of the output as an (n_out, tt) slab.
//
// What bounds them on an H100: bytes. They do one add per staged float. With the
// diagnostics' default wrap (128 tile starts over a 33.8 MB buffer) the working set sits in
// the 50 MB L2, so the staging is fed from L2 and the row probe's output (268 MB) goes to
// device memory; a working set beyond L2 streams from device memory at 3.35 TB/s.
//
// Design (the schedule is csrc/staged_schedule.cuh):
//   - Warp specialisation, two blocks per SM. Warp 0 is the producer: one lane issues
//     every chunk of the block's range as one cp.async.bulk into a ring of as many slots as
//     half the SM's shared memory holds (three of 32 KB), each with a `full` mbarrier
//     (expect_tx) and an `empty` mbarrier on which each consumer warp arrives when it has
//     read the slot. The steady loop has no block-wide barrier: the producer refills a slot
//     as soon as the last consumer warp leaves it, so slots - 1 chunks stay in flight. It
//     steps from tile to tile without a division.
//   - Eight consumer warps. stage_colsum reads float4s: a thread owns 4 adjacent columns
//     and the warps split a chunk's rows; the last tile's partials are combined in shared
//     memory in one fixed order. stage_rowprobe sums two probe runs a warp at once (half a
//     warp each, float4 loads, a shuffle reduction) into a double-buffered slab in shared
//     memory.
//   - An even split: each block takes an equal range of (tile, chunk) pairs
//     (staged::range_start), not whole tiles; stage_colsum keeps the last tile in one
//     block so that its sums do not depend on the grid, and rotates each block's walk
//     (staged::rotation_point) so that tiles which share a start are not staged by
//     several blocks at once.
//   - A store warp (stage_rowprobe). Warp 1 writes each output unit (a run of tiles in one
//     group and track) from the slab while the consumers fill the other slab, and frees a
//     slab as soon as its stores have read it. Rows at one place in 16 bytes (every layout
//     whose row stride is a multiple of 4 floats) are written by float4s that each lane
//     loads once and stores to every row it covers. Rows at varying places (an out_cols
//     that is not a multiple of 4, as at the mel kernel's geometry) take thread stores:
//     scalars to a 16-byte boundary, float4s, scalars at the end. (Bulk copies from the
//     slab, cp.async.bulk.global.shared::cta a row, measured 2-5 % slower on the H100, and
//     one block per SM with a ring of six slots 15-20 % slower on the row probe: PERF.md.)
//   - Edge tiles (the first of a track, and those from e_start on) are read from the
//     `edges` source, slot track * n_edge + eslot, as the production kernel read its edge
//     buffers.
//   - The table term is summed once per block at its start (the TPU kept the tables
//     resident in VMEM for the whole grid), while the producer's first copies are in
//     flight; the scratch term is the sum of the block's own row of n_scratch ones in
//     shared memory, taken again for every tile, as the TPU re-read its scratch.
//   - No two blocks write the same address.
// Left out, because they were rules or habits of the TPU's compiler: the wait on a
// descriptor other than the one started, pl.multiple_of hints, and the 48 MB VMEM limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staged_schedule.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kColsumThreads = 32 + kConsumers;    // producer warp, consumers
constexpr int kRowprobeThreads = 64 + kConsumers;  // producer warp, store warp, consumers
constexpr int kMaxSlots = 16;
constexpr int kChunkBytes = 32768;
constexpr int kMisc = 16;                          // floats: table sum, warp partials
constexpr int kBlocksPerSM = 2;
constexpr int kSmemPerSM = 233472;                 // 228 KB, of which 1 KB per block is reserved

// ---- PTX -----------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// a barrier over the consumer warps only
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// ---- the work ------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Geometry {
  const float* rows;
  const float* edges;
  long long n_tiles;
  long long tiles_per_track;
  long long track_rows;   // rows between the starts of two tracks
  long long row_offset;   // start row of within-track tile 0
  long long tile_stride;  // rows between two tile starts
  long long wrap;         // distinct tile starts per track
  long long e_start;      // first right-edge tile within a track
  int n_edge;             // edge slots per track; 0: no edge tiles
  int width;              // floats per row
  int span_floats;        // span_rows * width, staged per tile
  int chunk_floats;       // floats per staged chunk (whole rows)
  int n_chunks;           // chunks per tile
  int slots;              // ring slots
  int slot_floats;        // floats between two slots (a multiple of 32)
};

// The producer's walk over consecutive tiles: a tile's track, its place in the track and
// that place modulo the wrap, stepped without a division.
struct TileWalk {
  long long track, within, wpos;
};

__device__ TileWalk tile_walk(const Geometry& g, long long tile) {
  TileWalk t;
  t.track = tile / g.tiles_per_track;
  t.within = tile - t.track * g.tiles_per_track;
  t.wpos = t.within % g.wrap;
  return t;
}

__device__ __forceinline__ void step(const Geometry& g, TileWalk& t) {
  if (++t.wpos == g.wrap) t.wpos = 0;
  if (++t.within == g.tiles_per_track) {
    t.within = 0;
    t.wpos = 0;
    ++t.track;
  }
}

__device__ __forceinline__ const float* tile_source(const Geometry& g, const TileWalk& t) {
  if (g.n_edge > 0 && (t.within == 0 || t.within >= g.e_start)) {
    const long long eslot = t.within == 0 ? 0 : t.within - (g.e_start - 1);
    return g.edges + (t.track * g.n_edge + eslot) * (long long)g.span_floats;
  }
  return g.rows + (t.track * g.track_rows + g.row_offset + t.wpos * g.tile_stride) * g.width;
}

__device__ __forceinline__ int chunk_len(const Geometry& g, int c) {
  return min(g.chunk_floats, g.span_floats - c * g.chunk_floats);
}

// Shared memory: the ring's slots, then 2 * slots + 4 mbarriers (full, empty, slab_full,
// slab_empty), then kMisc floats, then the kernel's own part (16-byte aligned).
struct Smem {
  float* ring;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* slab_full;
  uint64_t* slab_empty;
  float* misc;
  float* rest;
};

__host__ __device__ __forceinline__ long long smem_fixed_bytes(int slots, int slot_floats) {
  const long long bars = (2LL * slots + 4) * 8;
  return 4LL * slots * slot_floats + ((bars + 15) / 16) * 16 + 4LL * kMisc;
}

__device__ __forceinline__ Smem carve(unsigned char* smem, const Geometry& g) {
  Smem s;
  s.ring = reinterpret_cast<float*>(smem);
  s.full = reinterpret_cast<uint64_t*>(smem + 4LL * g.slots * g.slot_floats);
  s.empty = s.full + g.slots;
  s.slab_full = s.empty + g.slots;
  s.slab_empty = s.slab_full + 2;
  s.misc = reinterpret_cast<float*>(smem + smem_fixed_bytes(g.slots, g.slot_floats) -
                                    4LL * kMisc);
  s.rest = s.misc + kMisc;
  return s;
}

__device__ void init_barriers(const Smem& s, int slots) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) {
      bar_init(&s.full[i], 1);
      bar_init(&s.empty[i], kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      bar_init(&s.slab_full[i], kConsumerWarps);
      bar_init(&s.slab_empty[i], 1);
    }
    bar_init_fence();
  }
  __syncthreads();
}

// The producer lane: every chunk of [q0, q1) into the ring, a slot refilled once every
// consumer warp has left it. `ring` and `issued` (chunks issued so far) carry over from an
// earlier part of the block's walk.
__device__ void produce(const Geometry& g, const Smem& s, staged::Ring& ring, long long& issued,
                        long long q0, long long q1) {
  if (q0 >= q1) return;
  const long long tile = q0 / g.n_chunks;
  int c = (int)(q0 - tile * g.n_chunks);
  TileWalk walk = tile_walk(g, tile);
  const float* src = tile_source(g, walk);
  for (long long q = q0; q < q1; ++q, ++issued) {
    if (issued >= g.slots) bar_wait(&s.empty[ring.slot], ring.phase ^ 1u);
    const uint32_t bytes = 4u * (uint32_t)chunk_len(g, c);
    bar_expect_tx(&s.full[ring.slot], bytes);
    bulk_load(s.ring + (size_t)ring.slot * g.slot_floats, src + (long long)c * g.chunk_floats,
              bytes, &s.full[ring.slot]);
    ring.advance();
    if (++c == g.n_chunks && q + 1 < q1) {
      c = 0;
      step(g, walk);
      src = tile_source(g, walk);
    }
  }
}

// a consumer warp is done with the slot
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) bar_arrive(empty);
}

// The consumers' walk over the chunks [a, e): each tile's column sums in registers, the
// last tile's (whole in this part of the walk) combined in group order and written. Consumer
// thread ct owns float4 column col4 of the rows grp, grp + groups, ...
__device__ void colsum_part(const Geometry& g, const Smem& s, staged::Ring& ring, long long a,
                            long long e, float* __restrict__ out, int ct, int lane) {
  const long long total = g.n_tiles * g.n_chunks;
  const int n4 = g.width / 4;
  const int groups = kConsumers / n4;
  const bool active = ct < groups * n4;
  const int col4 = ct % n4, grp = ct / n4;
  float4* part = reinterpret_cast<float4*>(s.rest);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int c = a < e ? (int)(a % g.n_chunks) : 0;
  for (long long q = a; q < e; ++q) {
    bar_wait(&s.full[ring.slot], ring.phase);
    const float4* buf =
        reinterpret_cast<const float4*>(s.ring + (size_t)ring.slot * g.slot_floats);
    const int rows = chunk_len(g, c) / g.width;
    if (active) {
#pragma unroll 4
      for (int r = grp; r < rows; r += groups) {
        const float4 v = buf[r * n4 + col4];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
    }
    release(&s.empty[ring.slot], lane);
    ring.advance();
    if (++c < g.n_chunks) continue;
    if (q == total - 1) {  // the last tile: combine in group order
      if (active) part[ct] = acc;
      consumer_sync();
      if (active && grp == 0) {
        float4 sum = part[col4];
        for (int k = 1; k < groups; ++k) {
          const float4 v = part[k * n4 + col4];
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        out[4 * col4] = sum.x;
        out[4 * col4 + 1] = sum.y;
        out[4 * col4 + 2] = sum.z;
        out[4 * col4 + 3] = sum.w;
      }
    }
    acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    c = 0;
  }
}

__global__ void __launch_bounds__(kColsumThreads, 2)
stage_colsum_kernel(Geometry g, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem, g);
  const long long total = g.n_tiles * g.n_chunks;
  const long long q0 = staged::range_start(total, g.n_chunks, gridDim.x, blockIdx.x, true);
  const long long q1 = staged::range_start(total, g.n_chunks, gridDim.x, blockIdx.x + 1, true);
  // the block's walk: [turn, q1), then [q0, turn)
  const long long turn = staged::rotation_point(q0, q1, g.n_chunks, g.wrap, g.n_tiles);
  init_barriers(s, g.slots);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  staged::Ring ring{g.slots, 0, 0u};
  if (warp == 0) {
    if (lane == 0) {
      long long issued = 0;
      produce(g, s, ring, issued, turn, q1);
      produce(g, s, ring, issued, q0, turn);
    }
    return;
  }
  colsum_part(g, s, ring, turn, q1, out, threadIdx.x - 32, lane);
  colsum_part(g, s, ring, q0, turn, out, threadIdx.x - 32, lane);
}

struct Probe {
  const float* tables;
  long long n_table;  // floats in the table operand; 0: no table term
  int n_scratch;      // ones in the scratch row; 0: no scratch term
  int probe_offset;   // floats into the span where probe row 0 starts
  int probe_width;    // floats summed per probe element
  int slab_floats;    // floats between the two slabs (a multiple of 4)
  staged::OutGeom o;
};

// this lane's part of the sum of `n` floats at `x` (16-byte aligned where n % 4 == 0),
// taken by `lanes` lanes of which this is number `lane`
__device__ __forceinline__ float run_part(const float* x, int n, int lane, int lanes) {
  float v = 0.0f;
  if (n % 4 == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
    for (int i = lane; i < n / 4; i += lanes) {
      const float4 a = x4[i];
      v += (a.x + a.y) + (a.z + a.w);
    }
  } else {
    for (int i = lane; i < n; i += lanes) v += x[i];
  }
  return v;
}

// the scratch term: the sum of the block's row of n ones, read again for every tile
__device__ __forceinline__ float scratch_sum(const float* scratch, int n, int lane) {
  return n > 0 ? warp_sum(run_part(scratch, n, lane, 32)) : 0.0f;
}

// the sum over the 16 lanes of each half of the warp
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the table operand's sum, once per block, in a fixed order over the consumers
__device__ float table_sum(const Probe& p, float* misc, int ct, int lane) {
  float part = 0.0f;
  const bool vec = (reinterpret_cast<uintptr_t>(p.tables) & 15) == 0;
  const long long n4 = vec ? p.n_table / 4 : 0;
  const float4* t4 = reinterpret_cast<const float4*>(p.tables);
  for (long long i = ct; i < n4; i += kConsumers) {
    const float4 a = __ldg(&t4[i]);
    part += (a.x + a.y) + (a.z + a.w);
  }
  for (long long i = 4 * n4 + ct; i < p.n_table; i += kConsumers) part += __ldg(&p.tables[i]);
  part = warp_sum(part);
  if (lane == 0) misc[1 + (ct >> 5)] = part;
  consumer_sync();
  float total = 0.0f;
  for (int w = 0; w < kConsumerWarps; ++w) total += misc[1 + w];
  return total;
}

// `count` floats from the slab to device memory by this thread: `head` scalars to the
// first 16-byte boundary, float4s, then scalars
__device__ __forceinline__ void thread_store(float* dst, const float* src, int count, int head) {
  int i = 0;
  for (; i < head; ++i) dst[i] = src[i];
  for (; i + 4 <= count; i += 4) {
    *reinterpret_cast<float4*>(dst + i) = make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
  }
  for (; i < count; ++i) dst[i] = src[i];
}

// The same `count` floats from the slab to n_out rows `stride` floats apart whose starts
// share one place in 16 bytes (`head` floats before a 16-byte boundary): a lane loads its
// float4 of the run once and writes it to every row it covers (several rows a pass where
// the run is under 32 float4s); the scalars before and after them, one lane a row.
__device__ void broadcast_rows(float* dst, long long stride, const float* src, int count,
                               int head, int n_out, int lane) {
  const int n4 = (count - head) / 4;
  const int body_end = head + 4 * n4;
  if (head > 0 || body_end < count) {
    for (int r = lane; r < n_out; r += 32) {
      float* d = dst + r * stride;
      for (int i = 0; i < head; ++i) d[i] = src[i];
      for (int i = body_end; i < count; ++i) d[i] = src[i];
    }
  }
  if (n4 == 0) return;
  const int rows_a_pass = n4 >= 32 ? 1 : 32 / n4;
  const int r0 = n4 >= 32 ? 0 : lane / n4;
  if (r0 >= rows_a_pass) return;
  for (int j = n4 >= 32 ? lane : lane % n4; j < n4; j += 32) {
    const float* x = src + head + 4 * j;
    const float4 v = make_float4(x[0], x[1], x[2], x[3]);
    for (int r = r0; r < n_out; r += rows_a_pass) {
      *reinterpret_cast<float4*>(dst + r * stride + head + 4 * j) = v;
    }
  }
}

__global__ void __launch_bounds__(kRowprobeThreads, 2)
stage_rowprobe_kernel(Geometry g, Probe p, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem s = carve(smem, g);
  float* slabs = s.rest;                           // two slabs of p.slab_floats
  float* scratch = slabs + 2 * p.slab_floats;      // n_scratch floats
  const long long total = g.n_tiles * g.n_chunks;
  const long long q0 = staged::range_start(total, g.n_chunks, gridDim.x, blockIdx.x, false);
  const long long q1 = staged::range_start(total, g.n_chunks, gridDim.x, blockIdx.x + 1, false);
  init_barriers(s, g.slots);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const staged::OutGeom& o = p.o;
  const int runs = g.chunk_floats / p.probe_width;        // probe runs a chunk holds
  const int offset_runs = p.probe_offset / p.probe_width;

  if (warp == 0) {
    if (lane == 0) {
      staged::Ring ring{g.slots, 0, 0u};
      long long issued = 0;
      produce(g, s, ring, issued, q0, q1);
    }
    return;
  }

  if (warp == 1) {  // the store warp
    staged::UnitWalk w = staged::walk_start(o, q0, q1);
    for (long long k = 0; w.q < w.q_end; ++k) {
      const staged::Unit u = staged::next_unit(o, w);
      const float* slab = slabs + (k & 1) * p.slab_floats;
      const staged::UnitStore us = staged::unit_store(
          o, u, staged::first_probe(u.c_begin, runs, offset_runs, o.tt),
          staged::first_probe(u.c_end + 1, runs, offset_runs, o.tt));
      bar_wait(&s.slab_full[k & 1], (uint32_t)((k >> 1) & 1));
      if (us.count > 0 && us.row_stride % 4 == 0) {  // rows at one place in 16 bytes
        broadcast_rows(out + us.dst0, us.row_stride, slab + us.src, us.count,
                       staged::row_store(o, us, 0).head, o.n_out, lane);
      } else if (us.count > 0) {  // rows at varying places in 16 bytes: one lane a row
        for (int r = lane; r < o.n_out; r += 32) {
          const staged::Store st = staged::row_store(o, us, r);
          thread_store(out + st.dst, slab + st.src, st.count, st.head);
        }
      }
      __syncwarp();  // the stores have read the slab: the consumers may refill it
      if (lane == 0) bar_arrive(&s.slab_empty[k & 1]);
    }
    return;
  }

  // consumers: the block's scratch row and the table term, while the first copies land
  const int ct = threadIdx.x - 64, cw = ct >> 5;
  for (int i = ct; i < p.n_scratch; i += kConsumers) scratch[i] = 1.0f;
  const float table = p.n_table > 0 ? table_sum(p, s.misc, ct, lane) : 0.0f;
  consumer_sync();  // the scratch row is written

  staged::Ring ring{g.slots, 0, 0u};
  staged::UnitWalk w = staged::walk_start(o, q0, q1);
  for (long long k = 0; w.q < w.q_end; ++k) {
    long long q = w.q;
    const staged::Unit u = staged::next_unit(o, w);
    float* slab = slabs + (k & 1) * p.slab_floats;
    if (k >= 2) bar_wait(&s.slab_empty[k & 1], (uint32_t)(((k >> 1) - 1) & 1));
    long long tile = u.tile0;
    int c = u.c_begin;
    float extra = scratch_sum(scratch, p.n_scratch, lane);
    for (; q < u.q_next; ++q) {
      const int t_lo = staged::first_probe(c, runs, offset_runs, o.tt);
      const int t_hi = staged::first_probe(c + 1, runs, offset_runs, o.tt);
      bar_wait(&s.full[ring.slot], ring.phase);
      if (t_lo + 2 * cw < t_hi) {  // two runs a pass: half a warp each
        const float* buf = s.ring + (size_t)ring.slot * g.slot_floats;
        const int lo = c * g.chunk_floats - p.probe_offset;  // probe float of the chunk's start
        const int half = lane >> 4, hl = lane & 15;
        for (int t0 = t_lo + 2 * cw; t0 < t_hi; t0 += 2 * kConsumerWarps) {
          const int t = t0 + half;
          const float v = half_warp_sum(
              t < t_hi ? run_part(buf + ((long long)t * p.probe_width - lo), p.probe_width, hl, 16)
                       : 0.0f);
          if (hl == 0 && t < t_hi) {
            slab[staged::slab_pos(tile, u.tile0, t, o.tt)] = (v + table) + extra;
          }
        }
      }
      release(&s.empty[ring.slot], lane);
      ring.advance();
      if (++c == g.n_chunks) {
        c = 0;
        ++tile;
        if (q + 1 < u.q_next) extra = scratch_sum(scratch, p.n_scratch, lane);
      }
    }
    __syncwarp();  // lanes 0 and 16 wrote this warp's probes: to the store warp
    if (lane == 0) bar_arrive(&s.slab_full[k & 1]);
  }
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
int g_smem_colsum[kMaxDevices];
int g_smem_rowprobe[kMaxDevices];

// The device's SM count, and the kernel's dynamic shared-memory limit raised to `smem`
// the first time a larger size comes.
cudaError_t prepare(const void* kernel, int* limit_table, int smem, int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[device] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  if (smem > limit_table[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    limit_table[device] = smem;
  }
  *sms = g_sms[device];
  return cudaSuccess;
}

Geometry make_geometry(const float* rows, const float* edges, long long n_tiles,
                       long long tiles_per_track, long long track_rows, long long row_offset,
                       long long tile_stride, long long wrap, int n_edge, long long e_start,
                       int width, int span_rows, int chunk_rows) {
  Geometry g;
  g.rows = rows;
  g.edges = edges;
  g.n_tiles = n_tiles;
  g.tiles_per_track = tiles_per_track;
  g.track_rows = track_rows;
  g.row_offset = row_offset;
  g.tile_stride = tile_stride;
  g.wrap = wrap;
  g.e_start = e_start;
  g.n_edge = n_edge;
  g.width = width;
  g.span_floats = span_rows * width;
  g.chunk_floats = chunk_rows * width;
  g.n_chunks = (span_rows + chunk_rows - 1) / chunk_rows;
  g.slot_floats = (g.chunk_floats + 31) / 32 * 32;  // 128-byte slots
  g.slots = 0;
  return g;
}

bool geometry_ok(const Geometry& g) {
  return g.n_tiles > 0 && g.tiles_per_track > 0 && g.wrap > 0 && g.width > 0 &&
         g.width % 4 == 0 && g.chunk_floats > 0 && 4LL * g.chunk_floats <= kChunkBytes &&
         g.span_floats > 0;
}

// The ring's depth: as many slots as the block's share of the SM's shared memory holds
// beside `extra` bytes, at most kMaxSlots; 0 where fewer than two fit.
int ring_slots(const Geometry& g, long long extra) {
  const long long budget = kSmemPerSM / kBlocksPerSM - 1024;
  int slots = kMaxSlots;
  while (slots >= 2 && smem_fixed_bytes(slots, g.slot_floats) + extra > budget) --slots;
  return slots >= 2 ? slots : 0;
}

// Blocks: kBlocksPerSM on every SM where the kernel fits so many, at most one per chunk.
cudaError_t grid_for(const void* kernel, int threads, int smem, int sms, long long chunks,
                     unsigned* grid) {
  int fit = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads,
                                                                  (size_t)smem);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const long long per_sm = fit < kBlocksPerSM ? fit : kBlocksPerSM;
  const long long most = per_sm * sms;
  *grid = (unsigned)(chunks < most ? chunks : most);
  return cudaSuccess;
}

}  // namespace

// Column sums of every tile, the last tile's written to out[0:width].
// Returns cudaGetLastError() (0 on success).
extern "C" int stage_colsum_launch(
    const float* rows, float* out, long long n_tiles, long long tile_stride, long long wrap,
    int width, int span_rows, int chunk_rows, void* stream) {
  Geometry g = make_geometry(rows, rows, n_tiles, n_tiles, 0, 0, tile_stride, wrap, 0, 0,
                             width, span_rows, chunk_rows);
  if (!geometry_ok(g) || width > 4 * kConsumers) return (int)cudaErrorInvalidValue;
  const long long extra = 16LL * kConsumers;  // the last tile's float4 partials
  g.slots = ring_slots(g, extra);
  if (g.slots == 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)(smem_fixed_bytes(g.slots, g.slot_floats) + extra);
  int sms = 0;
  cudaError_t err = prepare((const void*)stage_colsum_kernel, g_smem_colsum, smem, &sms);
  if (err != cudaSuccess) return (int)err;
  unsigned grid = 0;
  err = grid_for((const void*)stage_colsum_kernel, kColsumThreads, smem, sms,
                 g.n_tiles * g.n_chunks, &grid);
  if (err != cudaSuccess) return (int)err;
  stage_colsum_kernel<<<grid, kColsumThreads, (size_t)smem, (cudaStream_t)stream>>>(g, out);
  return (int)cudaGetLastError();
}

// Row probes of every tile, written as (n_out, tt) slabs. `group` consecutive tiles of a
// track share one store per output row. Returns cudaGetLastError() (0 on success).
extern "C" int stage_rowprobe_launch(
    const float* rows, const float* edges, const float* tables, float* out,
    long long n_tiles, long long tiles_per_track, long long track_rows, long long row_offset,
    long long tile_stride, long long wrap, int n_edge, long long e_start, int width,
    int span_rows, int chunk_rows, int group, int probe_offset, int probe_width, int tt,
    int n_out, int contiguous, long long out_cols, long long n_table, int n_scratch,
    void* stream) {
  Geometry g = make_geometry(rows, edges, n_tiles, tiles_per_track, track_rows, row_offset,
                             tile_stride, wrap, n_edge, e_start, width, span_rows, chunk_rows);
  if (!geometry_ok(g) || group <= 0 || tt <= 0 || n_out <= 0 || probe_width <= 0 ||
      probe_offset < 0 || n_scratch < 0 || n_table < 0 || g.chunk_floats % probe_width != 0 ||
      probe_offset % probe_width != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Probe p;
  p.tables = tables;
  p.n_table = n_table;
  p.n_scratch = n_scratch;
  p.probe_offset = probe_offset;
  p.probe_width = probe_width;
  const long long unit_floats = contiguous ? tt : (long long)group * tt;
  p.slab_floats = (int)((unit_floats + 3) / 4 * 4);
  p.o.n_tiles = n_tiles;
  p.o.tiles_per_track = tiles_per_track;
  p.o.out_cols = contiguous ? tt : out_cols;
  p.o.base = (long long)(uintptr_t)out;
  p.o.n_chunks = g.n_chunks;
  p.o.tt = tt;
  p.o.n_out = n_out;
  p.o.group = group;
  p.o.contiguous = contiguous;
  const long long extra = 4LL * (2LL * p.slab_floats + n_scratch);
  g.slots = ring_slots(g, extra);
  if (g.slots == 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)(smem_fixed_bytes(g.slots, g.slot_floats) + extra);
  int sms = 0;
  cudaError_t err = prepare((const void*)stage_rowprobe_kernel, g_smem_rowprobe, smem, &sms);
  if (err != cudaSuccess) return (int)err;
  unsigned grid = 0;
  err = grid_for((const void*)stage_rowprobe_kernel, kRowprobeThreads, smem, sms,
                 g.n_tiles * g.n_chunks, &grid);
  if (err != cudaSuccess) return (int)err;
  stage_rowprobe_kernel<<<grid, kRowprobeThreads, (size_t)smem, (cudaStream_t)stream>>>(
      g, p, out);
  return (int)cudaGetLastError();
}
