// The synthesis step of the inverse STFT in one launch: window, overlap-add, trim, normalise.
//
// The function: from frames (B, T, n_fft) (the inverse real FFT of each
// spectrogram column), a window (n_fft) and the window's sum-of-squares
// envelope wss (out_len, already trimmed),
//
//   y[b, n] = sum_t frames[b, t, p - t * hop] * window[p - t * hop],   p = n + start,
//
// over the frames t that cover sample p (0 <= p - t * hop < n_fft), divided
// by wss[n] where wss[n] > tiny. A sample past the last frame gets 0.
//
// It replaces the tail of the JAX package's _istft_core
// (librosa_tpu/core/spectrum.py:304-318), which XLA compiles into one program
// on the TPU; no Pallas kernel computes it. The plain PyTorch version
// (ops/ola_norm.py: ola_norm_reference) multiplies the frame tensor by the
// window, overlap-adds it in ceil(n_fft / hop) passes, slices, and divides
// under a mask: some five passes over the frame tensor and as many over the
// signal.
//
// Bound on an H100: bytes. Every frame element is read once and every
// output sample written once, against one multiply and one add per frame
// element. So the design is a gather that moves the fewest bytes with whole,
// coalesced accesses:
//
//   - one thread per output sample, or per four neighbouring samples
//     (16-byte loads) when hop, n_fft and start are multiples of four, which
//     puts the four samples into the same frames at a 16-byte-aligned offset;
//   - neighbouring threads read neighbouring floats of the same frames, and
//     each frame element is read by exactly one thread;
//   - a loop over the at most ceil(n_fft / hop) frames that cover the
//     sample, from the latest frame to the earliest, which is the order the
//     plain version adds in. Products and sums are __fmul_rn and __fadd_rn
//     (no fused multiply-add) and the quotient is __fdiv_rn, so the result
//     has the plain version's bits.
//
// There are no atomics, nothing to initialise and no second pass: the
// result is the same on every run. Nothing is copied to the host.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float normalised(float acc, float envelope, float tiny) {
    return envelope > tiny ? __fdiv_rn(acc, envelope) : acc;
}

// VEC is 4 where hop, n_fft and start are multiples of 4 and frames and window
// start on 16-byte boundaries, else 1. ROW4 says that out_len is a multiple of
// 4 and y and wss start on 16-byte boundaries too, so that a thread's four
// outputs are one store.
template <int VEC, bool ROW4>
__global__ void __launch_bounds__(kThreads)
ola_norm_kernel(const float* __restrict__ frames, const float* __restrict__ window,
                const float* __restrict__ wss, float* __restrict__ y, long long n_tracks,
                int n_frames, int n_fft, int hop, int start, int out_len, float tiny) {
    // a track's sample positions fit 32 bits (the launch function sees to it), so the two
    // divisions are 32-bit ones; only offsets into the whole frame tensor need 64
    const int n0 = (blockIdx.x * kThreads + threadIdx.x) * VEC;
    if (n0 >= out_len) return;
    // the frames that cover sample p: t * hop <= p < t * hop + n_fft. With VEC 4 the
    // three samples after p lie in the same frames.
    const int p = n0 + start;
    int t_hi = p / hop;
    if (t_hi > n_frames - 1) t_hi = n_frames - 1;
    const int t_lo = p < n_fft ? 0 : (p - n_fft) / hop + 1;

    for (long long b = blockIdx.y; b < n_tracks; b += gridDim.y) {
        const float* track = frames + b * n_frames * n_fft;  // 64-bit: b is long long
        float* out = y + b * out_len + n0;
        if (VEC == 4) {
            float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            for (int t = t_hi; t >= t_lo; --t) {
                const int i = p - t * hop;
                const float4 f =
                    __ldg(reinterpret_cast<const float4*>(track + (long long)t * n_fft + i));
                const float4 w = __ldg(reinterpret_cast<const float4*>(window + i));
                acc.x = __fadd_rn(acc.x, __fmul_rn(f.x, w.x));
                acc.y = __fadd_rn(acc.y, __fmul_rn(f.y, w.y));
                acc.z = __fadd_rn(acc.z, __fmul_rn(f.z, w.z));
                acc.w = __fadd_rn(acc.w, __fmul_rn(f.w, w.w));
            }
            if (ROW4) {
                const float4 e = __ldg(reinterpret_cast<const float4*>(wss + n0));
                float4 r;
                r.x = normalised(acc.x, e.x, tiny);
                r.y = normalised(acc.y, e.y, tiny);
                r.z = normalised(acc.z, e.z, tiny);
                r.w = normalised(acc.w, e.w, tiny);
                *reinterpret_cast<float4*>(out) = r;
            } else {
                const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (n0 + k < out_len) out[k] = normalised(a[k], __ldg(wss + n0 + k), tiny);
            }
        } else {
            float acc = 0.0f;
            for (int t = t_hi; t >= t_lo; --t) {
                const int i = p - t * hop;
                acc = __fadd_rn(acc, __fmul_rn(__ldg(track + (long long)t * n_fft + i),
                                               __ldg(window + i)));
            }
            out[0] = normalised(acc, __ldg(wss + n0), tiny);
        }
    }
}

inline bool aligned16(const void* ptr) { return reinterpret_cast<size_t>(ptr) % 16 == 0; }

}  // namespace

// One launch on `stream`. Returns 0, 1 for arguments the kernel does not
// take (a track must end below 2**31 samples), or the CUDA error of a launch
// that was refused.
extern "C" int ola_norm_launch(const float* frames, const float* window, const float* wss,
                               float* y, long long n_tracks, long long n_frames, int n_fft,
                               int hop, long long start, long long out_len, float tiny,
                               void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (n_tracks <= 0 || n_frames <= 0 || n_fft <= 0 || hop <= 0 || hop > n_fft || start < 0 ||
        out_len <= 0 || n_frames > 2147483647LL ||
        start + out_len + 1024 > 2147483647LL || n_frames * hop + n_fft > 2147483647LL)
        return 1;
    const bool vec = hop % 4 == 0 && n_fft % 4 == 0 && start % 4 == 0 && aligned16(frames) &&
                     aligned16(window);
    const bool row4 = vec && out_len % 4 == 0 && aligned16(wss) && aligned16(y);
    const long long per_block = (long long)kThreads * (vec ? 4 : 1);
    const long long blocks_x = (out_len + per_block - 1) / per_block;
    const int frames_i = static_cast<int>(n_frames), start_i = static_cast<int>(start),
              out_i = static_cast<int>(out_len);
    const dim3 grid(static_cast<unsigned>(blocks_x),
                    static_cast<unsigned>(n_tracks < 65535 ? n_tracks : 65535));
    if (row4)
        ola_norm_kernel<4, true><<<grid, kThreads, 0, stream>>>(
            frames, window, wss, y, n_tracks, frames_i, n_fft, hop, start_i, out_i, tiny);
    else if (vec)
        ola_norm_kernel<4, false><<<grid, kThreads, 0, stream>>>(
            frames, window, wss, y, n_tracks, frames_i, n_fft, hop, start_i, out_i, tiny);
    else
        ola_norm_kernel<1, false><<<grid, kThreads, 0, stream>>>(
            frames, window, wss, y, n_tracks, frames_i, n_fft, hop, start_i, out_i, tiny);
    return static_cast<int>(cudaGetLastError());
}
