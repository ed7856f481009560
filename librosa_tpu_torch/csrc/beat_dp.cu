// The beat tracker's dynamic program over a batch of onset envelopes, one block per row.
//
// The function, for each row r and frame i in order (Ellis 2007):
//
//   candidates d = 1 .. 1024 with round(fpb_i / 2) <= d <= 2 fpb_i and d <= i,
//   score(d)  = cumscore[i - d] - tightness * (log d - log fpb_i)^2,
//   best      = the largest score, the smallest d on ties,
//   cumscore[i] = localscore[i] + best   (localscore[i] where no d is valid),
//   backlink[i] = i - d_best              (-1 where no d is valid),
//
// and until the first frame whose localscore reaches thresh = 0.01 * max(localscore)
// of its row, backlink is -1 (first-beat gating). fpb is per frame or one per row.
//
// It replaces the JAX package's _beat_dp_scan (librosa_tpu/beat.py:35-91), a lax.scan
// vmapped over rows that XLA compiles for the TPU; no Pallas kernel computes it. The
// plain PyTorch version (ops/beat_dp.py: beat_dp_reference) is a loop over frames of
// some fifteen torch ops on (rows, 1024) tensors.
//
// Bound on an H100: neither bytes nor operations. A row reads its localscore (and
// fpb) once and writes backlink and cumscore once, 12 bytes a frame, and does about
// five flops per candidate; but frame i needs cumscore of the frames before it. Not of
// all of them: only of frames i - d with d >= lo_i = max(round(fpb_i / 2), 1), so frames
// i .. i + k - 1 do not depend on each other while lo_{i+m} > m for every m < k
// (csrc/beat_steps.cuh). At 78-144 BPM and 43 frames a second lo is 9-17, and a row is a
// chain of some T / 9 to T / 16 steps, not of T frames. The design:
//
//   - one block per row, 16 warps; a step scores up to 16 frames that do not depend on
//     each other, one warp a frame, and ends with one __syncthreads();
//   - a warp's lanes split its frame's candidate window, then a shuffle reduction picks
//     the best (score, d) with the smallest d on ties; lane 0 writes the ring of the
//     last 2048 cumscores in shared memory (2048, not 1024: a step's writes must not
//     land on frames that its other warps still read), cumscore and backlink;
//   - before the barrier each warp prepares its frame of the next step: its inputs
//     (staged in shared memory by cp.async, 256 frames at a time, some 750 frames
//     ahead), its window, the penalties of its first 128 candidates, and its flag, may
//     it join the step (the flags give the next step's length);
//   - the first-beat gate is the first frame whose localscore reaches thresh, found by
//     one block-wide minimum before the loop;
//   - log d comes from a table in shared memory, log fpb from the wrapper: the logs are
//     torch.log's, the penalty __fsub_rn / __fmul_rn in the plain version's order (no
//     fused multiply-add), and the max of a set of floats is exact with ties broken by
//     d, so any split of the candidates gives the plain version's bits.
//
// beat_dp_step_probe_kernel runs only a step's skeleton (the flags, one ring read a
// lane, the reduction, the ring write, the barrier) over a given number of full steps:
// its time is the bound by the chain of this design. Nothing is copied to the host and
// nothing synchronises.

#include <cuda_runtime.h>

#include <climits>

#include "beat_steps.cuh"

namespace {

using beat_steps::kWindow;
constexpr int kWarps = beat_steps::kStepFrames;  // one frame of a step each
constexpr int kThreads = 32 * kWarps;
constexpr int kRing = 2 * kWindow;  // cumscores kept: a step reads back at most kWindow
constexpr int kStage = 1024;        // frames of input staged in shared memory (a ring)
constexpr int kBatch = 256;         // frames staged by one batch of copies
constexpr int kPen = 4;             // penalties a lane prepares: the first 128 candidates
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void copy_async4(float* dst_smem, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the two newest batches have landed
__device__ __forceinline__ void copy_wait_older() {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the flags of a step, one byte (0 or 1) a frame, as bits
__device__ __forceinline__ unsigned step_flags(const unsigned char* ok) {
    const uint4 w = *reinterpret_cast<const uint4*>(ok);
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
    unsigned flags = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const unsigned x = words[q];
        flags |= ((x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u)) << (4 * q);
    }
    return flags;
}

// (best, best_d) across the warp: the larger score, the smaller d on ties
__device__ __forceinline__ void warp_best(float& best, int& best_d) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int od = __shfl_xor_sync(kFull, best_d, off);
        if (ob > best || (ob == best && od < best_d)) {
            best = ob;
            best_d = od;
        }
    }
}

__global__ void __launch_bounds__(kThreads, 1)
beat_dp_kernel(const float* __restrict__ localscore, const float* __restrict__ fpb,
               const float* __restrict__ log_fpb, const float* __restrict__ log_d,
               const float* __restrict__ thresh, int T, int fpb_per_frame, float tightness,
               int* __restrict__ backlink, float* __restrict__ cumscore) {
    __shared__ float ring[kRing];
    __shared__ float logd[kWindow];
    __shared__ float ls_s[kStage];
    __shared__ float f_s[kStage];
    __shared__ float lf_s[kStage];
    __shared__ __align__(16) unsigned char ok[2][kWarps];
    __shared__ int gate;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const long long base = (long long)blockIdx.x * T;
    const float* ls = localscore + base;
    const long long fbase = fpb_per_frame ? base : blockIdx.x;
    const float* fr = fpb + fbase;
    const float* lfr = log_fpb + fbase;
    const float th = thresh[blockIdx.x];

    auto stage = [&](int from, int to) {
        for (int j = from + tid; j < to; j += kThreads) {
            const int q = j & (kStage - 1);
            copy_async4(ls_s + q, ls + j);
            if (fpb_per_frame) {
                copy_async4(f_s + q, fr + j);
                copy_async4(lf_s + q, lfr + j);
            }
        }
        copy_commit();
    };
    int staged = T < kStage ? T : kStage;
    stage(0, staged);
    for (int k = tid; k < kWindow; k += kThreads) logd[k] = log_d[k];
    if (tid == 0) gate = T;
    const float f_row = fpb_per_frame ? 0.0f : fr[0];
    const float lf_row = fpb_per_frame ? 0.0f : lfr[0];
    __syncthreads();
    // the first-beat gate: backlinks stay -1 before the first frame that reaches thresh
    for (int j = tid; j < T; j += kThreads) {
        if (!(ls[j] < th)) {
            atomicMin(&gate, j);
            break;
        }
    }
    copy_wait_all();
    __syncthreads();
    const int g = gate;

    // warp `warp`'s frame of the next step: inputs, candidates, penalties and flag
    float si = 0.0f, lf = 0.0f, pen[kPen];
    int lo = 1, hi = 0;
    auto prepare = [&](int i, int slot) {
        const int j = i + warp;
        const bool valid = j < T;
        lo = 1;
        hi = 0;
        if (valid) {
            const int q = j & (kStage - 1);
            si = ls_s[q];
            const float f = fpb_per_frame ? f_s[q] : f_row;
            lf = fpb_per_frame ? lf_s[q] : lf_row;
            const beat_steps::Window w = beat_steps::window(f, j);
            lo = w.lo;
            hi = w.hi;
        }
#pragma unroll
        for (int p = 0; p < kPen; ++p) {
            const int d = lo + lane + 32 * p;
            const float diff = __fsub_rn(logd[(d <= hi ? d : 1) - 1], lf);
            pen[p] = __fmul_rn(tightness, __fmul_rn(diff, diff));
        }
        if (lane == 0)
            ok[slot][warp] = valid && beat_steps::independent(beat_steps::Window{lo, hi}, warp);
    };

    prepare(0, 0);
    __syncthreads();
    int slot = 0;
    for (int i = 0; i < T;) {
        const int k = beat_steps::step_length(step_flags(ok[slot]));
        if (warp < k) {
            const int j = i + warp;
            float best = -INFINITY;
            int best_d = INT_MAX;
#pragma unroll
            for (int p = 0; p < kPen; ++p) {
                const int d = lo + lane + 32 * p;
                if (d <= hi) {
                    const float s = __fsub_rn(ring[(j - d) & (kRing - 1)], pen[p]);
                    if (s > best) {  // a lane's d rise: strict keeps its smallest d on ties
                        best = s;
                        best_d = d;
                    }
                }
            }
            for (int d = lo + lane + 32 * kPen; d <= hi; d += 32) {
                const float diff = __fsub_rn(logd[d - 1], lf);
                const float s = __fsub_rn(ring[(j - d) & (kRing - 1)],
                                          __fmul_rn(tightness, __fmul_rn(diff, diff)));
                if (s > best) {
                    best = s;
                    best_d = d;
                }
            }
            warp_best(best, best_d);
            const bool has = isfinite(best);
            const float cum = has ? __fadd_rn(si, best) : si;
            const int link = (has && j >= g) ? j - best_d : -1;
            if (lane == 0) {
                ring[j & (kRing - 1)] = cum;
                cumscore[base + j] = cum;
                backlink[base + j] = link;
            }
        }
        i += k;
        slot ^= 1;
        if (staged < T && staged - i < kStage - kBatch) {  // keep ~750 frames staged ahead
            const int to = staged + kBatch < T ? staged + kBatch : T;
            stage(staged, to);
            staged = to;
        }
        if (staged < T)
            copy_wait_older();  // frames below staged - 2 kBatch, beyond i + 32, have landed
        else
            copy_wait_all();    // the last batches: every frame has landed
        if (i < T) prepare(i, slot);
        __syncthreads();
    }
}

// The floor of this design's chain: `steps` full steps of what each step of
// beat_dp_kernel must do in order (the step's flags, one candidate a lane read from the
// ring, one subtraction, the (score, d) shuffle reduction, lane 0's ring write, the
// next flag, __syncthreads), kStepFrames frames each. Its time is the least that many
// steps of this design can take.
__global__ void __launch_bounds__(kThreads, 1)
beat_dp_step_probe_kernel(int steps, float* __restrict__ out) {
    __shared__ float ring[kRing];
    __shared__ __align__(16) unsigned char ok[2][kWarps];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    for (int k = tid; k < kRing; k += kThreads) ring[k] = 0.0f;
    if (tid < 2 * kWarps) (&ok[0][0])[tid] = 1;
    __syncthreads();
    int slot = 0, i = 0;
    for (int s = 0; s < steps; ++s) {
        const int k = beat_steps::step_length(step_flags(ok[slot]));
        if (warp < k) {
            const int j = i + warp;
            float best = __fsub_rn(ring[(j - kWarps - lane) & (kRing - 1)], 0.001f * (float)lane);
            int best_d = kWarps + lane;
            warp_best(best, best_d);
            if (lane == 0) ring[j & (kRing - 1)] = __fadd_rn(best, (float)(best_d & 1));
        }
        i += k;
        slot ^= 1;
        if (lane == 0) ok[slot][warp] = 1;
        __syncthreads();
    }
    if (tid == 0) out[blockIdx.x] = ring[(i - 1) & (kRing - 1)];
}

}  // namespace

extern "C" int beat_dp_step_probe_launch(int rows, int steps, void* out, void* stream) {
    if (rows <= 0 || steps <= 0) return 0;
    beat_dp_step_probe_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        steps, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int beat_dp_launch(const void* localscore, const void* fpb, const void* log_fpb,
                              const void* log_d, const void* thresh, int rows, int T,
                              int fpb_per_frame, float tightness, void* backlink,
                              void* cumscore, void* stream) {
    if (rows <= 0 || T <= 0) return 0;
    beat_dp_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(localscore), static_cast<const float*>(fpb),
        static_cast<const float*>(log_fpb), static_cast<const float*>(log_d),
        static_cast<const float*>(thresh), T, fpb_per_frame, tightness,
        static_cast<int*>(backlink), static_cast<float*>(cumscore));
    return static_cast<int>(cudaGetLastError());
}
