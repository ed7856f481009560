// Griffin-Lim's phase update in one launch, in place:
//
//   z = rebuilt - w * tprev            (z = rebuilt where there is no tprev: the first round)
//   estimate = S * z / (|z| + tiny)
//
// over four tensors that griffinlim keeps in one layout: the complex64 estimate (written),
// the complex64 rebuilt spectrum and the one before it (read), the float32 magnitudes S
// (read). Element k of each is at offset k from its base, so the kernel walks one flat range.
//
// It replaces no TPU kernel: the JAX package computes this step with XLA inside its jitted
// loop (librosa_tpu/core/spectrum.py:1337-1338). The plain PyTorch version
// (ops/phase_update.py: phase_update_reference) takes six passes over the complex tensor
// and a real temporary: the weighted sum, |z|, + tiny, a copy that widens |z| + tiny to
// complex, the complex quotient, the product by S.
//
// Bound on an H100: bytes. Each element needs some thirty floating-point operations (hypotf's
// among them) against 20 bytes read and 8 written with tprev (12 and 8 without): at 16 x 1025
// x 5945 (97.5 M elements) that is 2.73 GB a round with tprev and 1.95 GB without, 0.82 and
// 0.58 ms at 3.35 TB/s. So the design moves each byte once, in whole accesses:
//
//   - a thread takes two elements at a time: one 16-byte load of each complex tensor, one
//     8-byte load of S, one 16-byte store; neighbouring threads take neighbouring pairs;
//   - a block a run of 512 elements, as many blocks as the range needs: on the card this
//     reads 92 % of the bound against 87 % for a grid-stride loop over 8 blocks an SM (0.8859
//     against 0.9380 ms); the loop stays for ranges past the grid's 2**31 - 1 blocks;
//   - at most one element before the first 16-byte boundary and one after the last pair go
//     through the scalar path, and where the four bases do not share an alignment every
//     element does;
//   - tprev absent is a template flag: the first round reads nothing in its place;
//   - no temporary: |z| + tiny lives in a register.
//
// Arithmetic: the plain version's on the card, operation by operation, each rounded once
// (__f*_rn, no fused multiply-add), so the result has its bits there. torch's CUDA add with
// alpha multiplies by the complex alpha (-w, 0) before it adds; its |z| is hypotf, as here;
// its complex quotient by (d, 0) follows numpy's (Smith's) scaling, which with a zero
// imaginary part is (re + im * 0) * (1 / d) and (im - re * 0) * (1 / d); its product by the
// widened (S, 0) is re * S - im * 0 and re * 0 + im * S. The terms in 0 keep torch's signed
// zeros and its NaN wherever z is infinite. A zero z gives 0 (0 * (1 / tiny)), as 0 / tiny
// does. On the CPU torch's vectorised |z| and quotient are other code: under g++ this source
// gives their bits wherever |z| is normal, and within 4 ulps of the element's larger part
// where z is subnormal (3 seen; tests/test_torch_phase_update.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 2147483647;  // gridDim.x

// the weighted difference z = r - w * t, as torch's add with alpha = -w computes it
__device__ __forceinline__ float2 weighted(float2 r, float2 t, float negw) {
    return make_float2(__fadd_rn(r.x, __fadd_rn(__fmul_rn(negw, t.x), -__fmul_rn(0.0f, t.y))),
                       __fadd_rn(r.y, __fadd_rn(__fmul_rn(negw, t.y), __fmul_rn(0.0f, t.x))));
}

// S * z / (|z| + tiny)
__device__ __forceinline__ float2 updated(float2 z, float s, float tiny) {
    const float scale = __fdiv_rn(1.0f, __fadd_rn(hypotf(z.x, z.y), tiny));
    const float ur = __fmul_rn(__fadd_rn(z.x, __fmul_rn(z.y, 0.0f)), scale);
    const float ui = __fmul_rn(__fadd_rn(z.y, -__fmul_rn(z.x, 0.0f)), scale);
    return make_float2(__fadd_rn(__fmul_rn(ur, s), -__fmul_rn(ui, 0.0f)),
                       __fadd_rn(__fmul_rn(ur, 0.0f), __fmul_rn(ui, s)));
}

template <bool PREV>
__device__ __forceinline__ void update_one(float2* est, const float2* reb, const float2* prev,
                                           const float* mag, long long k, float negw,
                                           float tiny) {
    const float2 z = PREV ? weighted(__ldg(reb + k), __ldg(prev + k), negw) : __ldg(reb + k);
    est[k] = updated(z, __ldg(mag + k), tiny);
}

// VEC: the elements from `head` (0 or 1) on lie in pairs on 16-byte boundaries of every
// complex tensor and 8-byte boundaries of S; else every element takes the scalar path.
template <bool PREV, bool VEC>
__global__ void __launch_bounds__(kThreads)
phase_update_kernel(float2* __restrict__ est, const float2* __restrict__ reb,
                    const float2* __restrict__ prev, const float* __restrict__ mag, long long n,
                    int head, float negw, float tiny) {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (!VEC) {
        for (long long k = first; k < n; k += stride)
            update_one<PREV>(est, reb, prev, mag, k, negw, tiny);
        return;
    }
    const long long pairs = (n - head) / 2;
    float4* e4 = reinterpret_cast<float4*>(est + head);
    const float4* r4 = reinterpret_cast<const float4*>(reb + head);
    const float4* t4 = PREV ? reinterpret_cast<const float4*>(prev + head) : nullptr;
    const float2* s2 = reinterpret_cast<const float2*>(mag + head);
    for (long long i = first; i < pairs; i += stride) {
        const float4 r = __ldg(r4 + i);
        const float2 s = __ldg(s2 + i);
        float2 z0 = make_float2(r.x, r.y), z1 = make_float2(r.z, r.w);
        if (PREV) {
            const float4 t = __ldg(t4 + i);
            z0 = weighted(z0, make_float2(t.x, t.y), negw);
            z1 = weighted(z1, make_float2(t.z, t.w), negw);
        }
        const float2 o0 = updated(z0, s.x, tiny), o1 = updated(z1, s.y, tiny);
        e4[i] = make_float4(o0.x, o0.y, o1.x, o1.y);
    }
    // the element before the first pair and the one after the last, if any
    const long long tail = head + 2 * pairs;
    if (first == 0 && head == 1) update_one<PREV>(est, reb, prev, mag, 0, negw, tiny);
    if (first == stride - 1 && tail < n)
        update_one<PREV>(est, reb, prev, mag, tail, negw, tiny);
}

template <bool PREV, bool VEC>
int launch(unsigned blocks, cudaStream_t stream, float2* est, const float2* reb,
           const float2* prev, const float* mag, long long n, int head, float negw, float tiny) {
    phase_update_kernel<PREV, VEC><<<blocks, kThreads, 0, stream>>>(est, reb, prev, mag, n, head,
                                                                    negw, tiny);
    return static_cast<int>(cudaGetLastError());
}

inline unsigned long long offset16(const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16;
}

}  // namespace

// One launch on `stream` over n elements: estimate <- S * unit(rebuilt - w * tprev), with
// tprev null for none. Returns 0, 1 for an empty range, or the CUDA error of a refused launch.
extern "C" int phase_update_launch(void* estimate, const void* rebuilt, const void* tprev,
                                   const float* S, long long n, float weight, float tiny,
                                   void* stream_ptr) {
    if (n <= 0) return 1;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    float2* est = static_cast<float2*>(estimate);
    const float2* reb = static_cast<const float2*>(rebuilt);
    const float2* prev = static_cast<const float2*>(tprev);
    // pairs on 16-byte boundaries need every complex base at the same offset (0 or 8) from
    // one, and S at half that offset from an 8-byte boundary
    const unsigned long long off = offset16(est);
    const bool vec = (off == 0 || off == 8) && offset16(reb) == off &&
                     (prev == nullptr || offset16(prev) == off) &&
                     reinterpret_cast<unsigned long long>(S) % 8 == off / 2;
    const int head = vec && off == 8 ? 1 : 0;
    // threads wanted: one a pair, the tail's included; the head needs a thread of its own
    // only where no pair follows it (n == 1)
    const long long work = vec ? (n - head + 1) / 2 + head : n;
    const long long want = (work + kThreads - 1) / kThreads;
    const unsigned blocks = static_cast<unsigned>(want < kMaxBlocks ? want : kMaxBlocks);
    const float negw = -weight;
    if (prev != nullptr)
        return vec ? launch<true, true>(blocks, stream, est, reb, prev, S, n, head, negw, tiny)
                   : launch<true, false>(blocks, stream, est, reb, prev, S, n, head, negw, tiny);
    return vec ? launch<false, true>(blocks, stream, est, reb, prev, S, n, head, negw, tiny)
               : launch<false, false>(blocks, stream, est, reb, prev, S, n, head, negw, tiny);
}
