// Decibel scaling of a spectrogram in two launches: power_to_db and amplitude_to_db.
//
// The function: out = max(L - ref_db, (peak - ref_db) - top_db) with
// L = 10 * log10(max(amin, S)) (S squared first for amplitudes), peak the
// maximum of L over the element's channel, and ref_db either peak
// (ref = max: the channel's peak lands on exactly 0 dB) or
// 10 * log10(max(amin, |ref|)) for a number. The input is C channels of N
// contiguous float32 values each.
//
// It replaces no TPU kernel: the JAX package runs this step as compiled XLA
// programs (librosa_tpu/core/spectrum.py, _db_log_core, _db_maxref_core,
// _power_to_db_core). The plain PyTorch version takes six elementwise and
// reduction passes over the tensor; this one reads it twice and writes it once.
//
// Bound on an H100: bytes. 12 bytes per element against some 30 instructions
// for a log10f, and the card offers about 20 float32 operations per byte. So
// the design only arranges for the fewest passes with every access a whole
// 16-byte load or store of neighbouring threads:
//
//   db_peak   each block takes the maximum of L over a strided part of one
//             channel and writes it to partial[channel][part];
//   db_apply  each block first reduces its channel's partials (a few hundred
//             floats from L2) to the peak, then writes its part of the output.
//
// There are no atomics and nothing to initialise, the result does not depend
// on the order blocks run in, and nothing is copied to the host. The peak is
// the maximum of the logarithms themselves, not the logarithm of the
// maximum, so it is one of the values L takes whether or not log10f is
// monotone in its last bit. Products and differences use __fmul_rn and
// __fsub_rn: a fused multiply-add would subtract the peak from an unrounded
// product and leave the peak element beside 0 instead of on it. NaN
// propagates as in the plain version: a NaN in a channel makes its peak NaN.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// max(a, b) where a NaN on either side wins
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float level_db(float s, float amin, bool square) {
    if (square) s = __fmul_rn(s, s);
    if (s < amin) s = amin;  // NaN stays
    return __fmul_rn(10.0f, log10f(s));
}

// The block's maximum, valid in every thread. scratch holds kWarps floats.
__device__ float block_max(float v, float* scratch) {
    for (int offset = 16; offset > 0; offset >>= 1)
        v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, offset));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();  // scratch may still be read from an earlier call
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    v = scratch[0];
    for (int w = 1; w < kWarps; ++w) v = nan_max(v, scratch[w]);
    return v;
}

// VEC is 4 where every channel starts on a 16-byte boundary and N % 4 == 0, else 1.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
db_peak(const float* __restrict__ s, float* __restrict__ partial, long long n, int parts,
        int square, float amin) {
    __shared__ float scratch[kWarps];
    const long long channel = blockIdx.x / parts;
    const int part = blockIdx.x % parts;
    const float* src = s + channel * n;
    const long long stride = (long long)parts * kThreads * VEC;
    float best = -INFINITY;
    for (long long i = ((long long)part * kThreads + threadIdx.x) * VEC; i < n; i += stride) {
        if (VEC == 4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(src + i));
            best = nan_max(best, level_db(v.x, amin, square));
            best = nan_max(best, level_db(v.y, amin, square));
            best = nan_max(best, level_db(v.z, amin, square));
            best = nan_max(best, level_db(v.w, amin, square));
        } else {
            best = nan_max(best, level_db(__ldg(src + i), amin, square));
        }
    }
    best = block_max(best, scratch);
    if (threadIdx.x == 0) partial[channel * parts + part] = best;
}

__device__ __forceinline__ float clamp_db(float level, float ref_db, float floor_db) {
    float v = __fsub_rn(level, ref_db);
    if (!(v >= floor_db)) v = (v != v) ? v : floor_db;  // NaN in v or in the floor stays NaN
    return v;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
db_apply(const float* __restrict__ s, float* __restrict__ out,
         const float* __restrict__ partial, long long n, int parts, int square, float amin,
         int ref_is_max, float ref_abs, int has_top, float top_db) {
    __shared__ float scratch[kWarps];
    const long long channel = blockIdx.x / parts;
    const int part = blockIdx.x % parts;

    float peak = -INFINITY;
    for (int p = threadIdx.x; p < parts; p += kThreads)
        peak = nan_max(peak, partial[channel * parts + p]);
    peak = block_max(peak, scratch);
    // a numeric reference goes through the same floor and the same log10f as the data
    const float ref_db = ref_is_max ? peak : level_db(ref_abs, amin, square);
    const float floor_db = has_top ? __fsub_rn(__fsub_rn(peak, ref_db), top_db) : -INFINITY;

    const float* src = s + channel * n;
    float* dst = out + channel * n;
    const long long stride = (long long)parts * kThreads * VEC;
    for (long long i = ((long long)part * kThreads + threadIdx.x) * VEC; i < n; i += stride) {
        if (VEC == 4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(src + i));
            float4 r;
            r.x = clamp_db(level_db(v.x, amin, square), ref_db, floor_db);
            r.y = clamp_db(level_db(v.y, amin, square), ref_db, floor_db);
            r.z = clamp_db(level_db(v.z, amin, square), ref_db, floor_db);
            r.w = clamp_db(level_db(v.w, amin, square), ref_db, floor_db);
            *reinterpret_cast<float4*>(dst + i) = r;
        } else {
            dst[i] = clamp_db(level_db(__ldg(src + i), amin, square), ref_db, floor_db);
        }
    }
}

}  // namespace

// Both launches on `stream`. `partial` is scratch of channels * parts floats.
// Returns 0 or the CUDA error of the launch that was refused.
extern "C" int db_scale_launch(const float* s, float* out, float* partial, long long channels,
                               long long n, int parts, int square, float amin, int ref_is_max,
                               float ref_abs, int has_top, float top_db, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (channels <= 0 || n <= 0 || parts <= 0 || channels * parts > 2147483647LL) return 1;
    const unsigned blocks = static_cast<unsigned>(channels * parts);
    const bool vec = n % 4 == 0 && reinterpret_cast<size_t>(s) % 16 == 0 &&
                     reinterpret_cast<size_t>(out) % 16 == 0;
    if (vec)
        db_peak<4><<<blocks, kThreads, 0, stream>>>(s, partial, n, parts, square, amin);
    else
        db_peak<1><<<blocks, kThreads, 0, stream>>>(s, partial, n, parts, square, amin);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (vec)
        db_apply<4><<<blocks, kThreads, 0, stream>>>(s, out, partial, n, parts, square, amin,
                                                     ref_is_max, ref_abs, has_top, top_db);
    else
        db_apply<1><<<blocks, kThreads, 0, stream>>>(s, out, partial, n, parts, square, amin,
                                                     ref_is_max, ref_abs, has_top, top_db);
    return static_cast<int>(cudaGetLastError());
}
