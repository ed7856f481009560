// Max-plus Viterbi decoding of a batch of sequences, one block per sequence.
//
// The function, for each row r (log_prob (R, T, S), log_trans (S, S), log_p_init (S)):
//
//   v_0[n]   = log_prob[0, n] + log_p_init[n]
//   v_t[n]   = log_prob[t, n] + max_p (v_{t-1}[p] + log_trans[p, n]),   t = 1 .. T-1
//   ptr_t[n] = the p of that maximum, the first p on ties,
//
// then logp = max_n v_{T-1}[n], states[T-1] its first argmax, and states[t-1] =
// ptr_t[states[t]] back to the first frame.
//
// It replaces the JAX package's _viterbi_scan (librosa_tpu/sequence.py:609-638), a
// lax.scan of dense max-plus products that XLA compiles for the TPU; no Pallas kernel
// computes it. The plain PyTorch version (ops/viterbi.py: viterbi_reference) is a loop
// over frames of a broadcast add and a max over (R, S, S), then a loop of gathers.
//
// Bound on an H100: operations. R (T - 1) S^2 add-and-compare pairs (9.9e10 for pYIN's
// 870 states on 16 tracks of 8193 frames) against R T S floats read and as many
// pointers written; max-plus has no tensor-core form. The design is the simple one:
//
//   - one block per row, up to 1024 threads, each owning the next states n = tid,
//     tid + blockDim, ...; v_{t-1} and v_t are double-buffered in shared memory, and
//     a frame ends with one __syncthreads();
//   - a thread reads v_{t-1}[p] from shared memory (the same address across the warp:
//     a broadcast) and log_trans[p, n] from global memory (neighbouring n: coalesced;
//     the matrix, 3 MB at 870 states, stays in the L2), in order of p with a strict >
//     (the first p on ties), and every sum is __fadd_rn: the plain version's floats
//     in its order, so states and logp have its bits;
//   - the pointers go to an (R, T, S) int32 buffer in device memory; thread 0 then
//     takes the first argmax of v_{T-1} and walks the pointers back.
//
// Only R blocks run, so most of the card idles at R = 16: this kernel is right first
// and fast later. Nothing is copied to the host and nothing synchronises.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(1024)
viterbi_kernel(const float* __restrict__ log_prob, const float* __restrict__ log_trans,
               const float* __restrict__ log_p_init, int T, int S, int* __restrict__ ptr,
               int* __restrict__ states, float* __restrict__ logp) {
    extern __shared__ float v[];
    float* cur = v;
    float* nxt = v + S;
    const long long r = blockIdx.x;
    const float* lp = log_prob + r * T * S;
    int* pr = ptr + r * T * S;

    for (int n = threadIdx.x; n < S; n += blockDim.x) cur[n] = __fadd_rn(lp[n], log_p_init[n]);
    __syncthreads();

    for (int t = 1; t < T; ++t) {
        const float* lpt = lp + (long long)t * S;
        int* pt = pr + (long long)t * S;
        for (int n = threadIdx.x; n < S; n += blockDim.x) {
            float best = __fadd_rn(cur[0], __ldg(log_trans + n));
            int best_p = 0;
            const float* col = log_trans + n;
#pragma unroll 8
            for (int p = 1; p < S; ++p) {
                const float s = __fadd_rn(cur[p], __ldg(col + (long long)p * S));
                if (s > best) {
                    best = s;
                    best_p = p;
                }
            }
            nxt[n] = __fadd_rn(lpt[n], best);
            pt[n] = best_p;
        }
        __syncthreads();
        float* swap = cur;
        cur = nxt;
        nxt = swap;
    }

    if (threadIdx.x == 0) {
        float best = cur[0];
        int s = 0;
        for (int n = 1; n < S; ++n) {
            if (cur[n] > best) {
                best = cur[n];
                s = n;
            }
        }
        logp[r] = best;
        int* st = states + r * T;
        st[T - 1] = s;
        for (int t = T - 1; t > 0; --t) {
            s = pr[(long long)t * S + s];
            st[t - 1] = s;
        }
    }
}

}  // namespace

extern "C" int viterbi_launch(const void* log_prob, const void* log_trans, const void* log_p_init,
                              int rows, int T, int S, void* ptr, void* states, void* logp,
                              void* stream) {
    if (rows <= 0 || T <= 0 || S <= 0) return 0;
    const int threads = S >= 1024 ? 1024 : ((S + 31) / 32) * 32;
    const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    viterbi_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(log_prob), static_cast<const float*>(log_trans),
        static_cast<const float*>(log_p_init), T, S, static_cast<int*>(ptr),
        static_cast<int*>(states), static_cast<float*>(logp));
    return static_cast<int>(cudaGetLastError());
}
