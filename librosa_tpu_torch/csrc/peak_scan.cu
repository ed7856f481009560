// Wait-spaced peak selection over rows of candidate flags, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package runs this selection as two XLA
// scans vmapped over rows (librosa_tpu/ops/peaks.py: greedy_mask's
// countdown :99, dp_values' backward DP :158). Both are one dependence
// chain per row, so what bounds them on an H100 is that chain's latency, not
// bytes (a (16, 8193) batch moves 0.8 MB) or operations.
//
//   greedy:  take[n] = cand[n] && n >= next;  next = take ? n + wait + 1 : next
//            (the countdown of the plain loop, written as the next frame it allows)
//   dp:      with_n = v[n + wait + 1] (0 from T on) + gain[n];
//            take[n] = cand[n] && with_n > v[n + 1];  (strict)
//            v[n] = take ? with_n : v[n + 1], for n = T-1 .. 0
//
// The DP's walk over its taken flags (ops/peaks.py:dp_mask) is the greedy
// selection of those flags, so greedy_walk_kernel runs it too.
//
// Layout, both kernels: one block of 8 warps a row. The row goes through
// shared memory in stages. Warp 0's lane 0 runs the chain on the stage in
// hand while warps 1-7 load the next stage (aligned 16-byte blocks of
// flags folded into words of 32 frames; the DP's gains as floats) and write the stage
// before back (a word's 32 flags as 32 coalesced bytes), in double buffers;
// one __syncthreads a stage. Only the first stage is loaded, and only the
// last written back, by all 8 warps.
//
// greedy_walk_kernel: the chain lane walks the stage's candidate words from
// `next` (64-bit: wait reaches 2**31 - 1) with bit operations (walk_words):
// below wait 32 it visits every word and a take's block of the next word
// comes from the high half of one product; from wait 32 on a take skips to
// the word of next = p + wait + 1 and empty words are passed over. Its steps
// are words visited plus takes, not T. Stages of 2048 frames keep the
// loads of the next stage behind the walk.
//
// dp_ring_kernel: the chain takes frames in groups of 8 from the top (the top
// group padded with frames that are no candidates, whose values are 0 as
// v[T] is). A frame's candidate value (v[n + wait + 1] + gain[n], or -inf
// where it is no candidate) is off the chain, which is one fmaxf a frame;
// the taken flag is that value compared with v[n + 1], also off the chain.
// At waits 0-6 a reach lies in the group or the one above, so the values
// stay in registers (one instantiation a wait, indexed at compile time). From
// wait 7 on the reaches lie above the group: the values live in a shared ring
// of R floats (R a power of two >= wait + 2, chosen by the wrapper), v[n] at
// slot n & (R - 1), and a group reads its 8 reaches and gains from shared
// memory before its chain. No device memory sits on the chain. A group with
// no candidate only carries v[n + 1] into its 8 values (the same bits).
// Additions are __fadd_rn in the plain loop's order and the comparison is
// strict, so the flags equal ops/peaks.py:dp_flags bit for bit.
//
// dp_scratch_kernel: the large-wait route, for waits whose ring exceeds
// kRingMax floats (wait > 32766 on rows longer than wait + 1). One thread a
// row; the values in a (rows, T + 1) float32 scratch in device memory.
//
// Probes, for the bounds: chain_probe_kernel runs only a chain of T steps
// (the countdown, or the DP's compare and select) on flags made in
// registers; walk_probe_kernel stages one row's candidate words once and
// walks them `repeats` times from shared memory; empty_kernel is the launch
// floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                   // 8 warps a row
constexpr int kWarps = kThreads / 32;
constexpr int kGreedyChunk = 2048;              // frames a greedy stage: 64 words
constexpr int kGreedyWords = kGreedyChunk / 32;
constexpr int kNearWait = 32;                   // below it the walk visits every word
constexpr int kProbeWords = 1024;               // words of the walk probe's row: 32768 frames
constexpr int kDpChunk = 2048;                  // frames a DP stage
constexpr int kDpWords = kDpChunk / 32;
constexpr int kDpGroup = 8;                     // frames a group of the DP chain
constexpr int kRingMax = 32768;                 // floats: 128 KB of dynamic shared memory
constexpr int kScratchRows = 32;                // rows a block on the large-wait route

// Bit i of the result: byte i of x is not 0.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  const uint32_t top = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return (top * 0x00204081u) >> 28;  // bits 7, 15, 23, 31 to 28-31, no carries between them
}

// Candidate flags c[0, len) as words of 32 frames (bit b of word w: frame 32w + b; frames from
// len on read as 0), 16 words a warp at a time over warps [warp0, warp0 + nwarps). Each lane
// loads one aligned 16-byte block of the row (only blocks that hold some of c[0, len)) and
// folds it into 16 bits; lane L < 16 then takes word L's 32 bits from lanes 2L, 2L + 1 and
// 2L + 2 (lane 0's second block for L = 15), shifted by the row's offset from a 16-byte
// boundary.
__device__ __forceinline__ void stage_words(const uint8_t* __restrict__ c, int64_t len,
                                            uint32_t* words, int warp0, int nwarps) {
  const int lane = threadIdx.x & 31;
  const int off = (int)((uintptr_t)c & 15);
  const uint8_t* aligned = c - off;
  const int64_t end = off + len;  // the row is bytes [off, end) from `aligned`
  const int nw = (int)((len + 31) >> 5);
  auto block_bits = [&](int64_t at) -> uint32_t {  // the 16 flags from `aligned + at`
    if (at >= end) return 0u;
    const uint4 q = *reinterpret_cast<const uint4*>(aligned + at);
    const uint32_t bits = nonzero_bytes(q.x) | nonzero_bytes(q.y) << 4 |
                          nonzero_bytes(q.z) << 8 | nonzero_bytes(q.w) << 12;
    const int64_t lo = min(max((int64_t)off - at, (int64_t)0), (int64_t)16);
    const int64_t hi = min(end - at, (int64_t)16);
    return bits & ((1u << hi) - 1u) & ~((1u << lo) - 1u);
  };
  for (int g = (int)(threadIdx.x >> 5) - warp0; 16 * g < nw; g += nwarps) {
    const int64_t at = (int64_t)g * 512;
    const uint32_t mine = block_bits(at + 16 * lane);
    const uint32_t last = lane == 0 ? block_bits(at + 512) : 0u;
    const uint32_t lo = __shfl_sync(0xffffffffu, mine, (2 * lane) & 31);
    const uint32_t mid = __shfl_sync(0xffffffffu, mine, (2 * lane + 1) & 31);
    const uint32_t up = __shfl_sync(0xffffffffu, mine, (2 * lane + 2) & 31);
    const uint32_t tail = __shfl_sync(0xffffffffu, last, 0);
    const uint64_t span = (uint64_t)(lane == 15 ? tail : up) << 32 | mid << 16 | lo;
    const int w = 16 * g + lane;
    if (lane < 16 && w < nw) words[w] = (uint32_t)(span >> off);
  }
}

// Words of flags back to bytes out[0, len), a word's 32 frames as 32 coalesced bytes; with
// `clear` each word is zeroed once its warp has read it.
__device__ __forceinline__ void store_words(uint8_t* __restrict__ out, int64_t len,
                                            uint32_t* words, int warp0, int nwarps, bool clear) {
  const int lane = threadIdx.x & 31;
  const int nw = (int)((len + 31) >> 5);
  for (int w = (int)(threadIdx.x >> 5) - warp0; w < nw; w += nwarps) {
    const uint32_t bits = words[w];
    const int64_t f = (int64_t)w * 32 + lane;
    if (f < len) out[f] = (uint8_t)((bits >> lane) & 1u);
    if (clear) {
      __syncwarp();
      if (lane == 0) words[w] = 0;
    }
  }
}

// The greedy walk over one stage's words `cand` (nw words, len frames; cand[nw] may be read
// and is not used) from frame `rel` of the stage: sets the taken bits in `taken` (zero on
// entry) and returns the first frame the walk allows after the stage, relative to its start
// (len if that is the next stage's first frame). A take is three dependent operations: isolate
// the lowest bit, multiply it by `span` (the take and the wait after it, 2**jump - 1) and clear
// those bits; two takes a turn of the loop, the second a no-op where the first emptied the
// word. kNear (wait < kNearWait, so jump <= 32): the walk visits every word, and the high half
// of the last take's product is what it blocks of the next word, which was read while the walk
// was in this one. Far (jump > 32): a take blocks the rest of the word, and the walk skips to
// the word of p + jump, found by __ffs. Frame indices stay 32-bit inside the stage (jump
// clipped just past it); only the return is 64-bit. `steps` counts words visited plus takes.
template <bool kNear>
__device__ __forceinline__ int64_t walk_words(const uint32_t* cand, uint32_t* taken, int nw,
                                              int64_t len, int64_t rel, int64_t wait,
                                              int64_t& steps) {
  if (rel >= len) return rel;
  const int jump = (int)min(wait + 1, len + 32);
  const uint64_t span = (1ull << min(jump, 32)) - 1;
  int w = (int)(rel >> 5);
  uint32_t word = cand[w] & (~0u << (rel & 31));
  if constexpr (kNear) {
    for (;;) {
      const uint32_t ahead = cand[w + 1];
      uint32_t acc = 0, blocked = 0;
      ++steps;
      while (word != 0) {
        const uint32_t a = word & (0u - word);
        const uint64_t ta = a * span;
        word &= ~(uint32_t)ta;
        const uint32_t b = word & (0u - word);
        const uint64_t tb = b * span;
        word &= ~(uint32_t)tb;
        acc |= a | b;
        blocked = (uint32_t)((b != 0 ? tb : ta) >> 32);
        steps += 1 + (b != 0);
      }
      taken[w] = acc;  // a word with no take stays 0
      if (++w >= nw) return len + __popc(blocked);
      word = ahead & ~blocked;
    }
  } else {
    int64_t after = len;  // the first frame the last take allows, if beyond the stage
    for (;;) {
      ++steps;
      if (word != 0) {
        const int last = (w << 5) + __ffs(word) - 1;
        taken[w] = word & (0u - word);
        ++steps;
        after = max(len, (int64_t)last + wait + 1);
        const int r = last + jump;
        w = r >> 5;
        if (w >= nw) return after;
        word = cand[w] & (~0u << (r & 31));
      } else {
        if (++w >= nw) return after;
        word = cand[w];
      }
    }
  }
}

template <bool kNear>
__global__ void __launch_bounds__(kThreads) greedy_walk_kernel(const uint8_t* __restrict__ cand,
                                                               uint8_t* __restrict__ out,
                                                               int64_t T, int64_t wait) {
  __shared__ uint32_t cbuf[2][kGreedyWords + 1];  // + 1: the walk reads a word ahead
  __shared__ uint32_t tbuf[2][kGreedyWords];
  const uint8_t* c = cand + (int64_t)blockIdx.x * T;
  uint8_t* o = out + (int64_t)blockIdx.x * T;
  const int64_t stages = (T + kGreedyChunk - 1) / kGreedyChunk;
  for (int i = threadIdx.x; i < 2 * kGreedyWords; i += kThreads) (&tbuf[0][0])[i] = 0;
  stage_words(c, min((int64_t)kGreedyChunk, T), cbuf[0], 0, kWarps);
  __syncthreads();
  int64_t rel = 0, steps = 0;  // lane 0 of warp 0: the walk's next frame, relative to the stage
  for (int64_t s = 0; s < stages; ++s) {
    const int64_t base = s * kGreedyChunk, len = min((int64_t)kGreedyChunk, T - base);
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        rel = walk_words<kNear>(cbuf[s & 1], tbuf[s & 1], (int)((len + 31) >> 5), len, rel,
                                wait, steps) - len;
      }
    } else {
      if (s + 1 < stages) {
        stage_words(c + base + kGreedyChunk, min((int64_t)kGreedyChunk, T - base - kGreedyChunk),
                    cbuf[(s + 1) & 1], 1, kWarps - 1);
      }
      if (s > 0) {
        store_words(o + base - kGreedyChunk, kGreedyChunk, tbuf[(s - 1) & 1], 1, kWarps - 1,
                    true);
      }
    }
    __syncthreads();
  }
  const int64_t last = (stages - 1) * kGreedyChunk;
  store_words(o + last, T - last, tbuf[(stages - 1) & 1], 0, kWarps, false);
}

// The DP chain over one stage (frames base .. base + len - 1, from the top), in groups of
// kDpGroup frames (the top group padded with frames that are no candidates), carrying
// next = v[n + 1]; writes every word of taken flags of the stage. W is the wait for waits 0-6,
// whose reaches lie within the group or the one above (`v`: the group's values, then the
// group above's, registers indexed at compile time); W == kDpGroup - 1 stands for every wait
// from 7 on, whose reaches lie above the group, in the ring. The gains `gm` come with the
// candidacy folded in (stage_gains), so a frame's candidate value cv = reach + gm is off the
// chain; the chain is next = fmaxf(next, cv), equal to `take ? with_n : next` since next >= 0 is
// never -0 or NaN, and take = cv > next (strict; NaN compares false).
template <int W>
__device__ __forceinline__ float dp_chain(const float* gm, const uint32_t* cw, uint32_t* tw,
                                          float* ring, uint32_t mask, int64_t base, int len,
                                          int64_t T, int64_t wait, float next,
                                          float (&v)[2 * kDpGroup]) {
  constexpr bool kRing = W >= kDpGroup - 1;
  uint32_t acc = 0;
  for (int n0 = (len - 1) / kDpGroup * kDpGroup; n0 >= 0; n0 -= kDpGroup) {
    const int64_t g0 = base + n0;
    uint32_t bits = 0;
    if (((cw[n0 >> 5] >> (n0 & 31)) & 0xffu) == 0) {
#pragma unroll
      for (int k = 0; k < kDpGroup; ++k) v[k] = next;
    } else {
      const float4 ga = *reinterpret_cast<const float4*>(gm + n0);
      const float4 gc = *reinterpret_cast<const float4*>(gm + n0 + 4);
      const float gain[kDpGroup] = {ga.x, ga.y, ga.z, ga.w, gc.x, gc.y, gc.z, gc.w};
      float reach[kDpGroup];
      if constexpr (kRing) {
        // frames g0 + k + wait + 1: in the ring below T, v[T] = 0 from T on
        const int64_t above = T - (g0 + wait + 1);
        const int live = (int)max(min(above, (int64_t)kDpGroup), (int64_t)0);
        const uint32_t slot0 = (uint32_t)(g0 + wait + 1);
#pragma unroll
        for (int k = 0; k < kDpGroup; ++k) {
          const float r = ring[(slot0 + k) & mask];  // read unconditionally: no predicated
          reach[k] = k < live ? r : 0.0f;            // address arithmetic a frame
        }
      }
#pragma unroll
      for (int k = kDpGroup - 1; k >= 0; --k) {
        float rk;
        if constexpr (kRing) {
          rk = reach[k];
        } else {
          rk = v[k + W + 1];
        }
        const float cv = __fadd_rn(rk, gain[k]);
        bits |= (uint32_t)(cv > next) << k;
        next = fmaxf(next, cv);
        v[k] = next;
      }
    }
    if constexpr (kRing) {
      // 8 slots from an 8-aligned frame in a ring of at least 8: two aligned 16-byte stores
      float4* slot = reinterpret_cast<float4*>(ring + ((uint32_t)g0 & mask));
      slot[0] = make_float4(v[0], v[1], v[2], v[3]);
      slot[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int k = 0; k < kDpGroup; ++k) v[kDpGroup + k] = v[k];
    }
    acc |= bits << (n0 & 31);
    if ((n0 & 31) == 0) {
      tw[n0 >> 5] = acc;
      acc = 0;
    }
  }
  return next;
}

// A stage's gains with the candidacy folded in: -inf where a frame is no candidate, so that its
// with_n is -inf (or NaN, where v is +inf), which neither compares above next nor moves it; the
// frames that pad the top group past len too.
__device__ __forceinline__ void stage_gains(const uint8_t* __restrict__ c,
                                            const float* __restrict__ g, int64_t len, float* gm,
                                            int thread0, int nthreads) {
  const float no_candidate = __int_as_float(0xff800000u);  // -inf
  const int64_t padded = (len + kDpGroup - 1) / kDpGroup * kDpGroup;
  for (int64_t f = (int)threadIdx.x - thread0; f < padded; f += nthreads) {
    gm[f] = f < len && __ldg(c + f) != 0 ? __ldg(g + f) : no_candidate;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads) dp_ring_kernel(const uint8_t* __restrict__ cand,
                                                           const float* __restrict__ gain,
                                                           uint8_t* __restrict__ taken,
                                                           int64_t T, int64_t wait,
                                                           int64_t ring_size) {
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(16) float gbuf[2][kDpChunk];
  __shared__ uint32_t cbuf[2][kDpWords];
  __shared__ uint32_t tbuf[2][kDpWords];
  const int64_t row = (int64_t)blockIdx.x * T;
  const uint8_t* c = cand + row;
  const float* g = gain + row;
  uint8_t* t = taken + row;
  const uint32_t mask = (uint32_t)ring_size - 1u;
  const int64_t stages = (T + kDpChunk - 1) / kDpChunk;
  // stage i holds frames [s * kDpChunk, ...) with s = stages - 1 - i: the chain runs backwards
  const int64_t top = (stages - 1) * kDpChunk;
  stage_gains(c + top, g + top, T - top, gbuf[0], 0, kThreads);
  stage_words(c + top, T - top, cbuf[0], 0, kWarps);
  __syncthreads();
  float next = 0.0f;         // lane 0 of warp 0: v[n + 1], v[T] = 0
  // lane 0 of warp 0, waits 0-6: the values of the group in hand (0-7) and of the one above
  float v[2 * kDpGroup] = {};
  for (int64_t i = 0; i < stages; ++i) {
    const int64_t base = (stages - 1 - i) * kDpChunk;
    const int b = (int)(i & 1);
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        next = dp_chain<W>(gbuf[b], cbuf[b], tbuf[b], ring, mask, base,
                           (int)min((int64_t)kDpChunk, T - base), T, wait, next, v);
      }
    } else {
      if (i + 1 < stages) {  // the stage below, whole
        const int64_t lo = base - kDpChunk;
        stage_gains(c + lo, g + lo, kDpChunk, gbuf[b ^ 1], 32, kThreads - 32);
        stage_words(c + lo, kDpChunk, cbuf[b ^ 1], 1, kWarps - 1);
      }
      if (i > 0) {  // the stage above
        const int64_t hi = base + kDpChunk;
        store_words(t + hi, min((int64_t)kDpChunk, T - hi), tbuf[b ^ 1], 1, kWarps - 1, false);
      }
    }
    __syncthreads();
  }
  store_words(t, min((int64_t)kDpChunk, T), tbuf[(stages - 1) & 1], 0, kWarps, false);
}

__global__ void dp_scratch_kernel(const uint8_t* __restrict__ cand, const float* __restrict__ gain,
                                  float* __restrict__ values, uint8_t* __restrict__ taken,
                                  int64_t rows, int64_t T, int64_t wait) {
  const int64_t r = (int64_t)blockIdx.x * kScratchRows + threadIdx.x;
  if (r >= rows) return;
  const uint8_t* c = cand + r * T;
  const float* g = gain + r * T;
  float* v = values + r * (T + 1);
  uint8_t* t = taken + r * T;
  v[T] = 0.0f;
  float next = 0.0f;  // v[n + 1]
  for (int64_t n = T - 1; n >= 0; --n) {
    const int64_t j = min(T, n + wait + 1);
    const float reach = j == n + 1 ? next : v[j];
    const float with_n = __fadd_rn(reach, __ldg(g + n));
    const bool take = __ldg(c + n) != 0 && with_n > next;
    t[n] = take;
    next = take ? with_n : next;
    v[n] = next;
  }
}

// The chains alone: T steps of each scan's carry on flags drawn from a register pattern, no
// memory traffic but one word a row at the end.
__global__ void chain_probe_kernel(int64_t rows, int64_t T, int wait, int dp, float* out) {
  const int64_t r = (int64_t)blockIdx.x * kScratchRows + threadIdx.x;
  if (r >= rows) return;
  uint32_t pattern = 0x9e3779b9u * (uint32_t)(r + 1);
  if (!dp) {
    int countdown = 0, count = 0;
    for (int64_t n = 0; n < T; ++n) {
      const bool take = ((pattern >> (n & 31)) & 1u) && countdown == 0;
      count += take;
      countdown = take ? wait : max(countdown - 1, 0);
    }
    out[r] = (float)(count + countdown);
  } else {
    float next = 0.0f, reach = 0.0f;
    for (int64_t n = T - 1; n >= 0; --n) {
      const float with_n = __fadd_rn(reach, 1.0f);
      const bool take = ((pattern >> (n & 31)) & 1u) && with_n > next;
      next = take ? with_n : next;
      reach = (n & 7) == 0 ? next : reach;  // a value from steps ago, as v[n + wait + 1] is
    }
    out[r] = next;
  }
}

// The greedy walk alone: one row a block stages its candidate words once (T <= 32 *
// kProbeWords), then lane 0 walks them `repeats` times from shared memory with no device
// traffic. out[2 * row] = the steps of one walk (words visited plus takes), out[2 * row + 1] =
// the number of taken frames.
template <bool kNear>
__global__ void __launch_bounds__(kThreads) walk_probe_kernel(const uint8_t* __restrict__ cand,
                                                              int64_t T, int64_t wait,
                                                              int repeats, float* out) {
  __shared__ uint32_t cbuf[kProbeWords + 1];
  __shared__ uint32_t tbuf[kProbeWords];
  for (int i = threadIdx.x; i < kProbeWords; i += kThreads) tbuf[i] = 0;
  stage_words(cand + (int64_t)blockIdx.x * T, T, cbuf, 0, kWarps);
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int nw = (int)((T + 31) >> 5);
  int64_t steps = 0;
  for (int k = 0; k < repeats; ++k) walk_words<kNear>(cbuf, tbuf, nw, T, 0, wait, steps);
  int taken = 0;
  for (int w = 0; w < nw; ++w) taken += __popc(tbuf[w]);
  out[2 * blockIdx.x] = (float)(steps / max(repeats, 1));
  out[2 * blockIdx.x + 1] = (float)taken;
}

__global__ void empty_kernel() {}

int rows_checked(int64_t rows, int64_t per_block) {
  if (rows <= 0 || (rows + per_block - 1) / per_block > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  return 0;
}

}  // namespace

// cand, out: (rows, T) bytes of 0 or 1 (torch.bool), row-major; 0 <= wait. Returns
// cudaGetLastError() (0 on success).
extern "C" int greedy_scan_launch(const void* cand, void* out, long long rows, long long T,
                                  long long wait, void* stream) {
  if (int err = rows_checked(rows, 1)) return err;
  if (wait < 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const auto kernel = wait < kNearWait ? greedy_walk_kernel<true> : greedy_walk_kernel<false>;
  kernel<<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>((const uint8_t*)cand,
                                                               (uint8_t*)out, T, wait);
  return (int)cudaGetLastError();
}

// The ring route: cand, taken (rows, T) bytes of 0 or 1; gain float32 (rows, T); ring_size a
// power of two from kDpGroup to kRingMax, at least wait + 2 where wait + 1 < T. Returns
// cudaGetLastError() (0 on success).
extern "C" int dp_ring_launch(const void* cand, const float* gain, void* taken, long long rows,
                              long long T, long long wait, long long ring_size, void* stream) {
  if (int err = rows_checked(rows, 1)) return err;
  if (wait < 0 || T <= 0 || ring_size < kDpGroup || ring_size > kRingMax ||
      (ring_size & (ring_size - 1)) != 0 || (wait + 1 < T && ring_size < wait + 2)) {
    return (int)cudaErrorInvalidValue;
  }
  static void (*const kernels[kDpGroup])(const uint8_t*, const float*, uint8_t*, int64_t, int64_t,
                                         int64_t) = {
      dp_ring_kernel<0>, dp_ring_kernel<1>, dp_ring_kernel<2>, dp_ring_kernel<3>,
      dp_ring_kernel<4>, dp_ring_kernel<5>, dp_ring_kernel<6>, dp_ring_kernel<7>};
  const int w = (int)min(wait, (long long)kDpGroup - 1);
  const size_t smem = w == kDpGroup - 1 ? (size_t)ring_size * sizeof(float) : 0;
  if (smem > 16 * 1024) {  // with the 17 KB of stage buffers, near the default 48 KB
    cudaError_t err = cudaFuncSetAttribute(kernels[w], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)(kRingMax * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
  }
  kernels[w]<<<(unsigned)rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)cand, gain, (uint8_t*)taken, T, wait, ring_size);
  return (int)cudaGetLastError();
}

// The large-wait route: as dp_ring_launch, with values a float32 (rows, T + 1) scratch in place
// of the ring. Returns cudaGetLastError() (0 on success).
extern "C" int dp_scratch_launch(const void* cand, const float* gain, float* values, void* taken,
                                 long long rows, long long T, long long wait, void* stream) {
  if (int err = rows_checked(rows, kScratchRows)) return err;
  if (wait < 0 || T <= 0) return (int)cudaErrorInvalidValue;
  dp_scratch_kernel<<<(unsigned)((rows + kScratchRows - 1) / kScratchRows), kScratchRows, 0,
                      (cudaStream_t)stream>>>((const uint8_t*)cand, gain, values,
                                              (uint8_t*)taken, rows, T, wait);
  return (int)cudaGetLastError();
}

// The chain probe: `dp` 0 for the countdown, 1 for the DP's compare and select; out float32
// (rows,). Returns cudaGetLastError() (0 on success).
extern "C" int peak_chain_probe_launch(long long rows, long long T, int wait, int dp, float* out,
                                       void* stream) {
  if (int err = rows_checked(rows, kScratchRows)) return err;
  chain_probe_kernel<<<(unsigned)((rows + kScratchRows - 1) / kScratchRows), kScratchRows, 0,
                       (cudaStream_t)stream>>>(rows, T, wait, dp, out);
  return (int)cudaGetLastError();
}

// The walk probe: cand (rows, T) bytes with T <= 32 * kProbeWords; out float32 (rows, 2). Returns
// cudaGetLastError() (0 on success).
extern "C" int peak_walk_probe_launch(const void* cand, long long rows, long long T,
                                      long long wait, int repeats, float* out, void* stream) {
  if (int err = rows_checked(rows, 1)) return err;
  if (wait < 0 || T <= 0 || T > 32 * kProbeWords || repeats < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = wait < kNearWait ? walk_probe_kernel<true> : walk_probe_kernel<false>;
  kernel<<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>((const uint8_t*)cand, T, wait,
                                                               repeats, out);
  return (int)cudaGetLastError();
}

// One empty kernel: the launch floor. Returns cudaGetLastError() (0 on success).
extern "C" int peak_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
