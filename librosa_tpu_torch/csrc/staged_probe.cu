// Staged-copy probes: tiles of rows copied from device memory into shared
// memory by TMA bulk copies, then reduced. Built for sm_90a.
//
// These are the Hopper counterparts of the copy diagnostics in
// scripts/dma_bisect.py (make_m0, make_m_out, make_m_edge, make_m_kitchen,
// make_m_scale) and scripts/dma_pipeline_micro.py (run). They compute the
// same functions (ops/staged_probe.py states them) and stage the same
// bytes: every tile's full span of `span_rows` rows of `width` floats goes
// through shared memory, though the row probe reduces only some of them.
//
//   stage_colsum    (make_m0, run): the column sums of every tile; only the
//                   last tile's sums are written, as the TPU grid's one
//                   revisited (1, width) output block ended with them.
//   stage_rowprobe  (make_m_out, make_m_edge, make_m_kitchen, make_m_scale):
//                   per tile, probe[t] = the sum of the t-th run of
//                   `probe_width` floats from `probe_offset` floats into
//                   the span, plus the table and scratch terms, written to
//                   n_out rows of the output as an (n_out, tt) slab.
//
// What bounds them on an H100: bytes. They do one add per staged float.
// With the diagnostics' default wrap (128 tile starts over a 33.8 MB
// buffer) the working set sits in the 50 MB L2, so the staging is fed from
// L2; only a working set beyond L2 streams from device memory at 3.35 TB/s.
//
// Design:
//   - A persistent grid: two blocks per SM, each walking its own tiles, in
//     runs of `group` consecutive tiles (1 for stage_colsum; in
//     stage_rowprobe, group > 1 makes one block write group * tt contiguous
//     floats of each output row).
//   - A tile's span (144 x 512 floats = 288 KB at the default geometry)
//     does not fit in a block's 227 KB of shared memory, so it is staged in
//     chunks of at most 32 KB (16 rows of 512 floats) through a ring of
//     kSlots slots. One thread issues each chunk as one cp.async.bulk whose
//     completion lands on the slot's mbarrier (expect_tx), the counterpart
//     of pltpu.make_async_copy and its DMA semaphore. While the block
//     reduces chunk q, chunks q+1 .. q+kSlots-1 are in flight; after a
//     __syncthreads marks slot q free, chunk q+kSlots is issued into it.
//   - Edge tiles (the first of a track, and those from e_start on) are
//     read from the `edges` source, slot track * n_edge + eslot, as the
//     production kernel read its edge buffers.
//   - The table term is summed once per block at its start (the TPU kept
//     the tables resident in VMEM for the whole grid); the scratch term is
//     the sum of the block's own row of n_scratch ones in shared memory,
//     taken again at every tile as the TPU re-read its scratch.
//   - No two blocks write the same address.
// Left out, because they were rules or habits of the TPU's compiler: the
// wait on a descriptor other than the one started, pl.multiple_of hints,
// and the 48 MB VMEM limit. Speed is not tuned: warp-specialised producers
// and wider stores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 3;
constexpr int kChunkBytes = 32768;
constexpr int kBlocksPerSM = 2;
constexpr int kMaxColsPerThread = 4;  // stage_colsum: width <= kThreads * 4
constexpr int kMisc = 4 + kWarps;     // table sum, scratch sum, warp partials

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
  int group;              // consecutive tiles per scheduling unit
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
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

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The k-th tile this block handles, and how many it handles.
__device__ __forceinline__ long long my_tile(const Geometry& g, long long k) {
  const long long unit = blockIdx.x + (k / g.group) * (long long)gridDim.x;
  return unit * g.group + k % g.group;
}

__device__ long long my_tile_count(const Geometry& g) {
  const long long n_units = (g.n_tiles + g.group - 1) / g.group;
  if ((long long)blockIdx.x >= n_units) return 0;
  const long long mine = (n_units - 1 - blockIdx.x) / gridDim.x + 1;
  long long count = mine * g.group;
  if (blockIdx.x + (mine - 1) * (long long)gridDim.x == n_units - 1) {
    count -= n_units * g.group - g.n_tiles;  // the last unit may be short
  }
  return count;
}

__device__ const float* tile_source(const Geometry& g, long long tile) {
  const long long track = tile / g.tiles_per_track;
  const long long within = tile - track * g.tiles_per_track;
  if (g.n_edge > 0 && (within == 0 || within >= g.e_start)) {
    const long long eslot = within == 0 ? 0 : within - (g.e_start - 1);
    return g.edges + (track * g.n_edge + eslot) * (long long)g.span_floats;
  }
  const long long row0 =
      track * g.track_rows + g.row_offset + (within % g.wrap) * g.tile_stride;
  return g.rows + row0 * g.width;
}

__device__ __forceinline__ int chunk_len(const Geometry& g, int c) {
  return min(g.chunk_floats, g.span_floats - c * g.chunk_floats);
}

// Issue chunk q of this block's sequence (tile q / n_chunks, chunk
// q % n_chunks) into slot q % kSlots. Thread 0 only.
__device__ void issue_chunk(const Geometry& g, float* slots, uint64_t* bars, long long q) {
  const long long k = q / g.n_chunks;
  const int c = (int)(q % g.n_chunks);
  const int s = (int)(q % kSlots);
  const uint32_t bytes = 4u * (uint32_t)chunk_len(g, c);
  bar_expect_tx(&bars[s], bytes);
  bulk_load(slots + (size_t)s * (kChunkBytes / 4),
            tile_source(g, my_tile(g, k)) + (long long)c * g.chunk_floats, bytes, &bars[s]);
}

// Shared-memory layout: kSlots chunk slots, then kSlots mbarriers, then
// kMisc floats, then the probe (tt floats) and the scratch row.
__device__ __forceinline__ uint64_t* bars_of(unsigned char* smem) {
  return reinterpret_cast<uint64_t*>(smem + (size_t)kSlots * kChunkBytes);
}
__device__ __forceinline__ float* misc_of(unsigned char* smem) {
  return reinterpret_cast<float*>(bars_of(smem) + kSlots);
}

__device__ void pipeline_start(const Geometry& g, float* slots, uint64_t* bars,
                               long long total) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) bar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (long long q = 0; q < kSlots && q < total; ++q) issue_chunk(g, slots, bars, q);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
stage_colsum_kernel(Geometry g, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* slots = reinterpret_cast<float*>(smem);
  uint64_t* bars = bars_of(smem);
  const int tid = threadIdx.x;
  const long long total = my_tile_count(g) * g.n_chunks;
  pipeline_start(g, slots, bars, total);

  float acc[kMaxColsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long q = 0; q < total; ++q) {
    const int s = (int)(q % kSlots);
    const int c = (int)(q % g.n_chunks);
    bar_wait(&bars[s], (uint32_t)((q / kSlots) & 1));
    const float* buf = slots + (size_t)s * (kChunkBytes / 4);
    const int rows = chunk_len(g, c) / g.width;
    for (int r = 0; r < rows; ++r) {
#pragma unroll
      for (int j = 0; j < kMaxColsPerThread; ++j) {
        const int col = tid + j * kThreads;
        if (col < g.width) acc[j] += buf[r * g.width + col];
      }
    }
    __syncthreads();  // slot s is free
    if (tid == 0 && q + kSlots < total) issue_chunk(g, slots, bars, q + kSlots);
    if (c == g.n_chunks - 1) {
      if (my_tile(g, q / g.n_chunks) == g.n_tiles - 1) {
#pragma unroll
        for (int j = 0; j < kMaxColsPerThread; ++j) {
          const int col = tid + j * kThreads;
          if (col < g.width) out[col] = acc[j];
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxColsPerThread; ++j) acc[j] = 0.0f;
    }
  }
}

struct Probe {
  const float* tables;
  long long n_table;  // floats in the table operand; 0: no table term
  int n_scratch;      // ones in the scratch row; 0: no scratch term
  int probe_offset;   // floats into the span where probe row 0 starts
  int probe_width;    // floats summed per probe element
  int tt;             // probe elements per tile
  int n_out;          // output rows the probe is written to
  int contiguous;     // 1: out[tile, r, t]; 0: out[track, r, within * tt + t]
  long long out_cols; // columns of a track's output rows (strided layout)
};

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
stage_rowprobe_kernel(Geometry g, Probe p, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* slots = reinterpret_cast<float*>(smem);
  uint64_t* bars = bars_of(smem);
  float* misc = misc_of(smem);         // [0] table sum, [1] scratch sum, [4..] partials
  float* probe = misc + kMisc;         // tt floats
  float* scratch = probe + p.tt;       // n_scratch floats
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long total = my_tile_count(g) * g.n_chunks;

  // the block's own scratch row, and the table term summed once
  for (int i = tid; i < p.n_scratch; i += kThreads) scratch[i] = 1.0f;
  float part = 0.0f;
  for (long long i = tid; i < p.n_table; i += kThreads) part += p.tables[i];
  part = warp_sum(part);
  if (lane == 0) misc[4 + warp] = part;
  __syncthreads();
  if (tid == 0) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += misc[4 + w];
    misc[0] = t;
    misc[1] = 0.0f;
  }
  pipeline_start(g, slots, bars, total);  // its __syncthreads publishes misc

  for (long long q = 0; q < total; ++q) {
    const int s = (int)(q % kSlots);
    const int c = (int)(q % g.n_chunks);
    bar_wait(&bars[s], (uint32_t)((q / kSlots) & 1));
    const float* buf = slots + (size_t)s * (kChunkBytes / 4);
    // probe elements whose run of floats lies in this chunk
    const long long lo = (long long)c * g.chunk_floats - p.probe_offset;
    const long long hi = lo + chunk_len(g, c);
    const int t_lo = lo <= 0 ? 0 : (int)((lo + p.probe_width - 1) / p.probe_width);
    const int t_hi = hi <= 0 ? 0 : (int)min((long long)p.tt, hi / p.probe_width);
    for (int t = t_lo + warp; t < t_hi; t += kWarps) {
      const float* run = buf + ((long long)t * p.probe_width - lo);
      float v = 0.0f;
      for (int i = lane; i < p.probe_width; i += 32) v += run[i];
      v = warp_sum(v);
      if (lane == 0) probe[t] = v;
    }
    if (c == g.n_chunks - 1 && warp == kWarps - 1 && p.n_scratch > 0) {
      float v = 0.0f;
      for (int i = lane; i < p.n_scratch; i += 32) v += scratch[i];
      v = warp_sum(v);
      if (lane == 0) misc[1] = v;
    }
    __syncthreads();  // slot s is free; the probe is complete at a tile's end
    if (tid == 0 && q + kSlots < total) issue_chunk(g, slots, bars, q + kSlots);
    if (c == g.n_chunks - 1) {
      const long long tile = my_tile(g, q / g.n_chunks);
      const long long track = tile / g.tiles_per_track;
      const long long col0 = (tile - track * g.tiles_per_track) * p.tt;
      const float extra = misc[0] + misc[1];
      for (int o = tid; o < p.n_out * p.tt; o += kThreads) {
        const int r = o / p.tt, t = o - r * p.tt;
        const float v = probe[t] + extra;
        if (p.contiguous) {
          out[(tile * p.n_out + r) * p.tt + t] = v;
        } else if (col0 + t < p.out_cols) {
          out[(track * p.n_out + r) * p.out_cols + col0 + t] = v;
        }
      }
      __syncthreads();  // the probe is read before the next tile writes it
    }
  }
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];
int g_smem_colsum[kMaxDevices];
int g_smem_rowprobe[kMaxDevices];

// The device's SM count, and the kernel's dynamic shared-memory limit
// raised to `smem` the first time a larger size comes.
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
                       int width, int span_rows, int chunk_rows, int group) {
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
  g.group = group;
  return g;
}

bool geometry_ok(const Geometry& g) {
  return g.n_tiles > 0 && g.tiles_per_track > 0 && g.wrap > 0 && g.group > 0 &&
         g.width > 0 && g.width % 4 == 0 && g.chunk_floats > 0 &&
         4LL * g.chunk_floats <= kChunkBytes && g.span_floats > 0;
}

unsigned grid_for(const Geometry& g, int sms) {
  const long long units = (g.n_tiles + g.group - 1) / g.group;
  const long long most = (long long)kBlocksPerSM * sms;
  return (unsigned)(units < most ? units : most);
}

}  // namespace

// Column sums of every tile, the last tile's written to out[0:width].
// Returns cudaGetLastError() (0 on success).
extern "C" int stage_colsum_launch(
    const float* rows, float* out, long long n_tiles, long long tile_stride, long long wrap,
    int width, int span_rows, int chunk_rows, void* stream) {
  const Geometry g = make_geometry(rows, rows, n_tiles, n_tiles, 0, 0, tile_stride, wrap, 0,
                                   0, width, span_rows, chunk_rows, 1);
  if (!geometry_ok(g) || width > kThreads * kMaxColsPerThread) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = kSlots * kChunkBytes + kSlots * 8;
  int sms = 0;
  cudaError_t err = prepare((const void*)stage_colsum_kernel, g_smem_colsum, smem, &sms);
  if (err != cudaSuccess) return (int)err;
  stage_colsum_kernel<<<grid_for(g, sms), kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      g, out);
  return (int)cudaGetLastError();
}

// Row probes of every tile, written as (n_out, tt) slabs. Returns
// cudaGetLastError() (0 on success).
extern "C" int stage_rowprobe_launch(
    const float* rows, const float* edges, const float* tables, float* out,
    long long n_tiles, long long tiles_per_track, long long track_rows, long long row_offset,
    long long tile_stride, long long wrap, int n_edge, long long e_start, int width,
    int span_rows, int chunk_rows, int group, int probe_offset, int probe_width, int tt,
    int n_out, int contiguous, long long out_cols, long long n_table, int n_scratch,
    void* stream) {
  const Geometry g = make_geometry(rows, edges, n_tiles, tiles_per_track, track_rows,
                                   row_offset, tile_stride, wrap, n_edge, e_start, width,
                                   span_rows, chunk_rows, group);
  if (!geometry_ok(g) || tt <= 0 || n_out <= 0 || probe_width <= 0 || probe_offset < 0 ||
      n_scratch < 0 || n_table < 0 || g.chunk_floats % probe_width != 0 ||
      probe_offset % probe_width != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Probe p;
  p.tables = tables;
  p.n_table = n_table;
  p.n_scratch = n_scratch;
  p.probe_offset = probe_offset;
  p.probe_width = probe_width;
  p.tt = tt;
  p.n_out = n_out;
  p.contiguous = contiguous;
  p.out_cols = out_cols;
  const long long smem_ll =
      (long long)kSlots * kChunkBytes + kSlots * 8 + 4LL * (kMisc + tt + n_scratch);
  if (smem_ll > 232448) return (int)cudaErrorInvalidValue;
  const int smem = (int)smem_ll;
  int sms = 0;
  cudaError_t err = prepare((const void*)stage_rowprobe_kernel, g_smem_rowprobe, smem, &sms);
  if (err != cudaSuccess) return (int)err;
  stage_rowprobe_kernel<<<grid_for(g, sms), kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      g, p, out);
  return (int)cudaGetLastError();
}
