// Fused |STFT(y)|^power projected onto a basis, for sm_90a.
//
// Replaces the TPU kernel librosa_tpu/ops/pallas_stft.py:_kernel (reached
// through stft_mel_pallas). It computes the same function, not the same
// blocks:
//
//   out[track, m, t] = sum_k basis[m, k] * |X_t[k]|^power,
//   X_t = rfft(window * padded(y[track])[t*hop : t*hop + n_fft])
//
// for k in [0, n_fft/2]. Centre padding ("constant" zeros or "reflect") is
// synthesised by index, so no padded copy of the signal exists.
//
// What bounds it on an H100. By the roofline, operations and bytes about
// equally: a frame moves hop samples in and n_out values out (2.5 KB at
// n_fft 2048 / hop 512 / 128 mels) against the function's work
// (ops/fused_stft.py:flops_per_frame: a real FFT, 2.5 n log2 n flops, and
// ~2 flops per nonzero of the basis), ~26 flops per byte, near the card's
// float32 balance of ~20. A kernel is held far above that bound by the SM
// itself: every trip of an FFT butterfly through shared memory costs
// wavefronts (and many more where 32 lanes meet in one bank), a dense walk
// through a banded basis multiplies by zeros, and a block that fills an
// SM's shared memory leaves nothing to run while it waits.
//
// Design, one block per (track, tile of `tt` frames), of 256 threads or, where
// the tile's frames take fewer, of those:
//   1. The block copies its tile's span of samples, (tt-1)*hop + n_fft of
//      them, into shared memory once (frames overlap): 16-byte loads where
//      the tile lies inside the signal, by index with the centre padding
//      and zeros past the end where it does not.
//   2. A real frame is transformed as H = n_fft/2 complex points
//      z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1], never two frames in one
//      transform. H/P threads share a frame, each holding P points in
//      registers (P = 16 from n_fft 2048, Plan below). The FFT is
//      self-sorting (Stockham): a pass multiplies by the twiddles of its
//      position, runs radix-R butterflies (R <= P) on registers with
//      compile-time constants, and hands its results to the next pass
//      through the frame's buffer in shared memory. Thread `lt` always
//      loads elements lt + s*H/P, so loads are consecutive; stores of a
//      pass behind passes of product p are runs of p elements p*R apart,
//      and the buffer shifts each run by p banks (Plan::pad) so that
//      a warp's 32 stores meet in no bank. Twiddles between passes come
//      from a table made in float64 (ops/fused_stft.py:_twiddles), one run
//      of consecutive words per (pass, r), read through L1. There is no
//      bit-reversal pass and no sin/cos on the card. The threads of a
//      frame meet at a hardware barrier of their own (frame_sync), so the
//      block's frames do not wait for each other.
//   3. Bins 0..H come from pairs (Z[k], Z[H-k]):
//      X[k] = A - i w B, X[H-k] = conj(A + i w B), A = (Z[k] + conj Z[H-k])/2,
//      B = (Z[k] - conj Z[H-k])/2, w = exp(-2 pi i k / n_fft). |X|^power
//      overwrites the real parts in place, so a frame keeps one buffer.
//   4. After one __syncthreads a warp takes 8 basis rows at a time, lane =
//      4 * row + phase. A lane walks its row's band [lo, hi) of nonzero
//      columns, four columns a step, and keeps one sum per frame of the
//      tile in registers: a basis value is loaded once (16 bytes a row,
//      through L1) for all the tile's frames, a frame's spectrum is read at
//      nearby bins by the whole warp (neighbouring rows' bands overlap, and
//      equal addresses are one broadcast), and rows of like width share a
//      warp. Partial sums cover at most 64 bins before they join the total;
//      six shuffles sum the four phases and leave each lane two frames to
//      write. The projection has three modes, the basis entry of the JAX
//      kernel's `precision` (ops/precision.py): exact float32 (0, the
//      default), both operands rounded to bf16 before each multiply-add
//      (1, DEFAULT), or the three products of their bf16 halves, hi*hi +
//      hi*lo + lo*hi (2, HIGH). A bf16 product is exact in float32, so each
//      mode is float32 multiply-adds of rounded operands; one branch on the
//      mode, outside the row loop, picks the loop.
// Frames, spectra and power spectra live only in registers and shared
// memory. All arithmetic is float32 (no TF32, no fast math; bf16 only as
// the rounding of the lower projection modes); indices into device memory
// are 64-bit. At n_fft 2048 / hop 512 a block
// holds 8 frames in 89 KB of shared memory and at most 128 registers a
// thread, so two blocks (16 warps) share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block, at most
constexpr int kChunk = 64;     // bins summed before adding to the total
constexpr int kMaxTile = 8;    // frames per block, at most

// The FFT of H = 2^LOG2H complex points, as ops/fused_stft.py:_fft_plan has
// it: every pass but the last takes kBits bits, the last takes the rest.
template <int LOG2H>
struct Plan {
  static constexpr int kBits = LOG2H >= 10 ? 4 : LOG2H >= 7 ? 3 : 2;
  static constexpr int kPoints = 1 << kBits;             // points per thread
  static constexpr int kPasses = (LOG2H + kBits - 1) / kBits;
  static constexpr int kH = 1 << LOG2H;
  static constexpr int kT = kH / kPoints;                 // threads per frame
  // log2 of pass i's radix, and of the product of the radices before it
  __host__ __device__ static constexpr int bits(int i) {
    return (i + 1) * kBits <= LOG2H ? kBits : LOG2H - i * kBits;
  }
  __host__ __device__ static constexpr int prior_bits(int i) { return i * kBits; }
  // exchange after pass i: element a lies at a + pad * (a >> unit_bits)
  __host__ __device__ static constexpr int pad(int i) {
    return prior_bits(i) < 5 ? 1 << prior_bits(i) : 0;
  }
  __host__ __device__ static constexpr int unit_bits(int i) {
    return prior_bits(i) + bits(i) > 5 ? prior_bits(i) + bits(i) : 5;
  }
  __host__ __device__ static constexpr int max_pad() {
    int worst = 0;
    for (int i = 0; i + 1 < kPasses; ++i) {
      const int here = pad(i) * ((kH - 1) >> unit_bits(i));
      worst = here > worst ? here : worst;
    }
    return worst;
  }
  static constexpr int kHR = kH + max_pad() + 1;          // floats of a buffer's real part
  // float offset of pass i's twiddles (i >= 1); tw_offset(kPasses) is the unpacking table
  __host__ __device__ static constexpr int tw_offset(int i) {
    int off = 0;
    for (int j = 1; j < i; ++j) off += 2 * ((1 << bits(j)) - 1) * (1 << prior_bits(j));
    return off;
  }
};

// x < 2^bits with its bits reversed, bits <= 4; no loop, so that it folds to a
// constant wherever x does (a register index must be one)
__host__ __device__ constexpr int bit_reverse(int x, int bits) {
  return (((x & 1) << 3) | ((x & 2) << 1) | ((x & 4) >> 1) | ((x & 8) >> 3)) >> (4 - bits);
}

// cos and sin of 2 pi t / 16, for the butterflies' own twiddles
__device__ __forceinline__ float cos16(int t) {
  return t == 1 ? 0.92387953251128674f : t == 3 ? 0.38268343236508977f
       : t == 5 ? -0.38268343236508977f : -0.92387953251128674f;
}
__device__ __forceinline__ float sin16(int t) {
  return (t == 1 || t == 7) ? 0.38268343236508977f : 0.92387953251128674f;
}

// One radix-2 stage (decimation in frequency, butterflies LEN apart) of B
// radix-R DFTs on registers, and the stages after it. DFT q takes registers
// q + r*B, r < R, and dft_regs leaves its output r in register
// q + bit_reverse(r)*B. Every loop bound is a template constant, so every
// register index is a compile-time constant once the loops are unrolled.
template <int R, int B, int PTS, int LEN>
__device__ __forceinline__ void dft_stage(float (&re)[PTS], float (&im)[PTS]) {
  constexpr float kHalfSqrt2 = 0.70710678118654752f;
  constexpr int kHalf = LEN / 2;
#pragma unroll
  for (int q = 0; q < B; ++q) {
#pragma unroll
    for (int b = 0; b < R / LEN; ++b) {
#pragma unroll
      for (int j = 0; j < kHalf; ++j) {
        const int i0 = q + (b * LEN + j) * B, i1 = i0 + kHalf * B;
        const float ar = re[i0], ai = im[i0], cr = re[i1], ci = im[i1];
        re[i0] = ar + cr;
        im[i0] = ai + ci;
        const float dr = ar - cr, di = ai - ci;
        const int t = j * (16 / LEN);  // (a - c) * exp(-2 pi i t / 16)
        if (t == 0) {
          re[i1] = dr;
          im[i1] = di;
        } else if (t == 4) {
          re[i1] = di;
          im[i1] = -dr;
        } else if (t == 2) {
          re[i1] = (dr + di) * kHalfSqrt2;
          im[i1] = (di - dr) * kHalfSqrt2;
        } else if (t == 6) {
          re[i1] = (di - dr) * kHalfSqrt2;
          im[i1] = -(dr + di) * kHalfSqrt2;
        } else {
          const float c = cos16(t), s = sin16(t);
          re[i1] = dr * c + di * s;
          im[i1] = di * c - dr * s;
        }
      }
    }
  }
  if constexpr (LEN > 2) dft_stage<R, B, PTS, LEN / 2>(re, im);
}

template <int R, int B, int PTS>
__device__ __forceinline__ void dft_regs(float (&re)[PTS], float (&im)[PTS]) {
  dft_stage<R, B, PTS, R>(re, im);
}

// Barrier among the T threads that share a frame (`slot` numbers the block's
// frames in flight): a hardware barrier of its own where they are whole
// warps, so that frames do not wait for each other; else the block's.
template <int T>
__device__ __forceinline__ void frame_sync(int slot) {
  if constexpr (T >= 32 && T < kThreads) {
    asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "n"(T) : "memory");
  } else {
    __syncthreads();
  }
}

// Pass I of a frame's FFT and everything after it. `lt` is the thread's
// place among the frame's T threads, `slot` the frame's barrier.
template <int LOG2H, int I>
__device__ __forceinline__ void fft_pass(
    float (&re)[Plan<LOG2H>::kPoints], float (&im)[Plan<LOG2H>::kPoints],
    float* fre, float* fim, const float* __restrict__ tw, int lt, int slot) {
  using P = Plan<LOG2H>;
  constexpr int PTS = P::kPoints, T = P::kT;
  constexpr int RB = P::bits(I), R = 1 << RB, B = PTS / R;
  constexpr int p = 1 << P::prior_bits(I);
  if constexpr (I > 0) {
    constexpr int kTable = P::tw_offset(I);
    const float* tr = tw + kTable;
    const float* ti = tr + (R - 1) * p;
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const int k = (lt + q * T) & (p - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float wr = __ldg(tr + (r - 1) * p + k), wi = __ldg(ti + (r - 1) * p + k);
        const float xr = re[q + r * B], xi = im[q + r * B];
        re[q + r * B] = xr * wr - xi * wi;
        im[q + r * B] = xr * wi + xi * wr;
      }
    }
  }
  dft_regs<R, B, PTS>(re, im);
  if constexpr (I > 0) frame_sync<T>(slot);  // the buffer's last loads are done
  if constexpr (I + 1 < P::kPasses) {
    constexpr int pad = P::pad(I), ub = P::unit_bits(I);
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const int bi = lt + q * T, k = bi & (p - 1);
      int base = (bi - k) * R + k;
      base += pad * (base >> ub);  // the same shift for every r: a run of p*R is not split
#pragma unroll
      for (int r = 0; r < R; ++r) {
        fre[base + r * p] = re[q + bit_reverse(r, RB) * B];
        fim[base + r * p] = im[q + bit_reverse(r, RB) * B];
      }
    }
    frame_sync<T>(slot);
#pragma unroll
    for (int s = 0; s < PTS; ++s) {
      int a = lt + s * T;
      a += pad * (a >> ub);
      re[s] = fre[a];
      im[s] = fim[a];
    }
    fft_pass<LOG2H, I + 1>(re, im, fre, fim, tw, lt, slot);
  } else {
    // the last pass leaves output r of DFT q at Z[lt + (q + r*B) * T]: natural order
#pragma unroll
    for (int q = 0; q < B; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        fre[lt + (q + r * B) * T] = re[q + bit_reverse(r, RB) * B];
        fim[lt + (q + r * B) * T] = im[q + bit_reverse(r, RB) * B];
      }
    }
    frame_sync<T>(slot);
  }
}

__device__ __forceinline__ float spectral_power(float a, float b, float power) {
  float pw = a * a + b * b;
  if (power == 1.0f) {
    pw = sqrtf(pw);
  } else if (power != 2.0f) {
    pw = powf(pw, 0.5f * power);
  }
  return pw;
}

// Bins k and H-k of the real frame's spectrum from Z[k] and Z[H-k], as
// |X|^power over the real parts. One thread owns the pair.
__device__ __forceinline__ void unpack_pair(
    float* fre, const float* fim, int k, int H, const float* __restrict__ uc,
    const float* __restrict__ us, float power) {
  if (k == 0) {
    const float a = fre[0], b = fim[0];
    fre[0] = spectral_power(a + b, 0.0f, power);
    fre[H] = spectral_power(a - b, 0.0f, power);
    return;
  }
  const float zr = fre[k], zi = fim[k], yr = fre[H - k], yi = fim[H - k];
  const float ar = 0.5f * (zr + yr), ai = 0.5f * (zi - yi);
  const float br = 0.5f * (zr - yr), bi = 0.5f * (zi + yi);
  const float wr = __ldg(uc + k), wi = __ldg(us + k);
  const float cr = wr * br - wi * bi, ci = wr * bi + wi * br;
  fre[k] = spectral_power(ar + ci, ai - cr, power);
  fre[H - k] = spectral_power(ar - ci, ai + cr, power);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc + w * p in the projection's MODE, w given as its parts (w_hi = w in mode 0,
// bf16(w) otherwise; w_lo = bf16(w - w_hi) in mode 2)
template <int MODE>
__device__ __forceinline__ float project_term(float w_hi, float w_lo, float p, float acc) {
  if constexpr (MODE == 0) {
    return fmaf(w_hi, p, acc);
  } else if constexpr (MODE == 1) {
    return fmaf(w_hi, bf16_round(p), acc);
  } else {
    const float p_hi = bf16_round(p);
    const float p_lo = bf16_round(p - p_hi);
    return fmaf(w_lo, p_hi, fmaf(w_hi, p_lo, fmaf(w_hi, p_hi, acc)));
  }
}

// Step 4: a warp takes 8 basis rows at a time, lane = 4 * row + phase
template <int MODE>
__device__ __forceinline__ void project(
    const float* __restrict__ basis, const int* __restrict__ bands, float* __restrict__ out,
    const float* frames, int64_t track, int64_t t0, int64_t n_frames, int n_out, int tt,
    int fb, int n_bins) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int phase = lane & 3;
  for (int m0 = 8 * warp; m0 < n_out; m0 += nthreads >> 2) {
    const int m = m0 + (lane >> 2);
    int lo = 0, hi = 0;
    if (m < n_out) {
      lo = max(__ldg(bands + 2 * m), 0);
      hi = min(__ldg(bands + 2 * m + 1), n_bins);
    }
    const float* row = basis + (int64_t)m * n_bins;
    float total[kMaxTile];
#pragma unroll
    for (int f = 0; f < kMaxTile; ++f) total[f] = 0.0f;
    for (int k0 = lo; k0 < hi; k0 += kChunk) {
      const int k1 = min(k0 + kChunk, hi);
      float part[kMaxTile];
#pragma unroll
      for (int f = 0; f < kMaxTile; ++f) part[f] = 0.0f;
#pragma unroll 2
      for (int k = k0 + phase; k < k1; k += 4) {
        const float w = __ldg(row + k);
        const float w_hi = MODE == 0 ? w : bf16_round(w);
        const float w_lo = MODE == 2 ? bf16_round(w - w_hi) : 0.0f;
#pragma unroll
        for (int f = 0; f < kMaxTile; ++f) {
          if (f < tt) part[f] = project_term<MODE>(w_hi, w_lo, frames[(size_t)f * fb + k], part[f]);
        }
      }
#pragma unroll
      for (int f = 0; f < kMaxTile; ++f) total[f] += part[f];
    }
    // sum over the 4 phases, halving what each lane keeps: phase j ends with frames j and j + 4
    __syncwarp();
    float kept[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = (i & 1) + 4 * (i >> 1);  // 0, 1, 4, 5, each paired with f + 2
      const bool upper = phase & 2;
      const float send = upper ? total[f] : total[f + 2];
      kept[i] = (upper ? total[f + 2] : total[f]) + __shfl_xor_sync(0xffffffffu, send, 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool upper = phase & 1;
      const float send = upper ? kept[2 * i] : kept[2 * i + 1];
      const float sum = (upper ? kept[2 * i + 1] : kept[2 * i])
                        + __shfl_xor_sync(0xffffffffu, send, 1);
      const int f = phase + 4 * i;
      if (m < n_out && f < tt && t0 + f < n_frames) {
        out[(track * n_out + m) * n_frames + t0 + f] = sum;
      }
    }
  }
}

template <int LOG2H>
__global__ void __launch_bounds__(kThreads, 2) stft_mel_kernel(
    const float* __restrict__ y, const float* __restrict__ win,
    const float* __restrict__ tw, const float* __restrict__ basis,
    const int* __restrict__ bands, float* __restrict__ out, int64_t sig_len,
    int64_t n_frames, int hop, int64_t lpad, int reflect, int n_out, int tt,
    int fb, int span_alloc, int64_t tiles_per_track, float power, int mode) {
  using P = Plan<LOG2H>;
  constexpr int H = P::kH, N = 2 * H, PTS = P::kPoints, T = P::kT;
  extern __shared__ __align__(16) float smem[];
  float* span = smem;                 // span_alloc floats: the tile's samples
  float* frames = smem + span_alloc;  // tt buffers of fb floats: re[kHR], im[kHR]

  const int64_t track = blockIdx.x / tiles_per_track;
  const int64_t t0 = (blockIdx.x % tiles_per_track) * tt;
  const float* yt = y + track * sig_len;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // 1. the tile's samples
  const int span_len = (tt - 1) * hop + N;
  const int64_t s0 = t0 * hop - lpad;  // signal index of span[0]
  if (s0 >= 0 && s0 + span_len <= sig_len) {
    const float* src = yt + s0;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4* span4 = reinterpret_cast<float4*>(span);
      for (int i = tid; i < (span_len >> 2); i += nthreads) span4[i] = __ldg(src4 + i);
      done = span_len & ~3;
    }
    for (int i = done + tid; i < span_len; i += nthreads) span[i] = __ldg(src + i);
  } else {  // the tile reaches the padding: by index
    for (int i = tid; i < span_len; i += nthreads) {
      const int64_t s = s0 + i;
      int64_t src = -1;
      if (s < 0) {
        if (reflect) src = -s;
      } else if (s < sig_len) {
        src = s;
      } else if (s < sig_len + lpad) {
        if (reflect) src = 2 * sig_len - 2 - s;
      }
      span[i] = src >= 0 ? yt[src] : 0.0f;
    }
  }
  __syncthreads();

  // 2, 3. blockDim / T frames at a time: pack, FFT, unpack to |X|^power
  const int frames_per_round = blockDim.x / T;
  const int lt = tid & (T - 1);
  constexpr int kUnpackTable = P::tw_offset(P::kPasses);
  const float* uc = tw + kUnpackTable;              // cos(2 pi k / N), k <= H/2
  const float* us = uc + H / 2 + 1;                 // -sin(2 pi k / N)
  for (int f = tid / T; f < tt; f += frames_per_round) {  // the same trips for every thread
    float* fre = frames + (size_t)f * fb;
    float* fim = fre + P::kHR;
    const float* x = span + (size_t)f * hop;
    float re[PTS], im[PTS];
#pragma unroll
    for (int s = 0; s < PTS; ++s) {
      const int n2 = 2 * (lt + s * T);
      float x0, x1;
      if ((hop & 1) == 0) {  // span + f*hop + n2 is 8-byte aligned
        const float2 v = *reinterpret_cast<const float2*>(x + n2);
        x0 = v.x;
        x1 = v.y;
      } else {
        x0 = x[n2];
        x1 = x[n2 + 1];
      }
      re[s] = x0 * __ldg(win + n2);
      im[s] = x1 * __ldg(win + n2 + 1);
    }
    fft_pass<LOG2H, 0>(re, im, fre, fim, tw, lt, tid / T);
#pragma unroll
    for (int s = 0; s < PTS / 2; ++s) unpack_pair(fre, fim, lt + s * T, H, uc, us, power);
    if (lt == 0) unpack_pair(fre, fim, H / 2, H, uc, us, power);
  }
  __syncthreads();

  // 4. banded projection, in the mode's arithmetic
  if (mode == 1) {
    project<1>(basis, bands, out, frames, track, t0, n_frames, n_out, tt, fb, H + 1);
  } else if (mode == 2) {
    project<2>(basis, bands, out, frames, track, t0, n_frames, n_out, tt, fb, H + 1);
  } else {
    project<0>(basis, bands, out, frames, track, t0, n_frames, n_out, tt, fb, H + 1);
  }
}

constexpr int kMaxDevices = 64;

template <int LOG2H>
int launch(const float* y, const float* win, const float* tw, const float* basis,
           const int* bands, float* out, long long n_tracks, long long sig_len,
           long long n_frames, int hop, long long lpad, int reflect, int n_out, int tt,
           float power, int smem, int mode, cudaStream_t stream) {
  using P = Plan<LOG2H>;
  static int smem_limit[kMaxDevices];  // largest dynamic shared memory allowed so far
  if (tt < 1 || tt > kMaxTile || (tt & (tt - 1))) return (int)cudaErrorInvalidValue;
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  // whole frames on every thread in every round, and whole warps
  const int threads = tt * P::kT < kThreads ? tt * P::kT : kThreads;
  if (threads % P::kT || threads % 32) return (int)cudaErrorInvalidValue;
  // the layout ops/fused_stft.py:_smem_bytes counts; a size that disagrees is refused
  const int span_len = (tt - 1) * hop + 2 * P::kH;
  const int span_alloc = (span_len + 3) & ~3;
  const int fb = 2 * P::kHR;
  if (smem != 4 * (span_alloc + tt * fb)) return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > smem_limit[device]) {  // raised only when a larger size first comes
    err = cudaFuncSetAttribute(stft_mel_kernel<LOG2H>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_limit[device] = smem;
  }
  const long long tiles = (n_frames + tt - 1) / tt;
  const long long blocks = tiles * n_tracks;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  stft_mel_kernel<LOG2H><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
      y, win, tw, basis, bands, out, sig_len, n_frames, hop, lpad, reflect, n_out, tt, fb,
      span_alloc, tiles, power, mode);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` with `smem` bytes of dynamic shared memory per block
// (ops/fused_stft.py:_smem_bytes). `tw` is ops/fused_stft.py:_twiddles(n_fft),
// `basis` row-major (n_out, n_fft/2 + 1), `bands` int32 (n_out, 2); `mode` the
// projection's (0 exact, 1 bf16 operands, 2 bf16_3x: ops/precision.py:MODES).
// Returns cudaGetLastError() (0 on success).
extern "C" int stft_mel_launch(
    const float* y, const float* win, const float* tw, const float* basis,
    const int* bands, float* out, long long n_tracks, long long sig_len,
    long long n_frames, int n_fft, int hop, long long lpad, int reflect, int n_out,
    int tt, float power, int smem, int mode, void* stream) {
#define STFT_MEL_CASE(LOG2H)                                                          \
  case 2 << LOG2H:                                                                    \
    return launch<LOG2H>(y, win, tw, basis, bands, out, n_tracks, sig_len, n_frames,  \
                         hop, lpad, reflect, n_out, tt, power, smem, mode, (cudaStream_t)stream)
  switch (n_fft) {
    STFT_MEL_CASE(5);
    STFT_MEL_CASE(6);
    STFT_MEL_CASE(7);
    STFT_MEL_CASE(8);
    STFT_MEL_CASE(9);
    STFT_MEL_CASE(10);
    STFT_MEL_CASE(11);
    STFT_MEL_CASE(12);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef STFT_MEL_CASE
}
