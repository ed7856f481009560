// The beat tracker's dynamic program over a batch of onset envelopes, one warp per row.
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
// five flops per candidate; but frame i needs cumscore of the frames before it, so a
// row is a chain of T steps, each at least one warp-wide max reduction (five dependent
// shuffles) and a round trip through shared memory. beat_dp_chain_probe_kernel below
// runs only that chain, so its time is the bound by the chain. The design keeps that
// chain short:
//
//   - one warp per row; its lanes split the candidate window (some 65 candidates at
//     120 BPM and 43 frames a second, so two or three per lane), then a shuffle
//     reduction picks the best (score, d) with the smallest d on ties;
//   - the last 1024 cumscores of the row live in a ring in shared memory, written by
//     lane 0 and read by every lane after __syncwarp();
//   - log d comes from a table in shared memory, log fpb from the wrapper: the logs
//     are torch.log's, the penalty __fsub_rn / __fmul_rn in the plain version's order
//     (no fused multiply-add), so the result has the plain version's bits;
//   - the next frame's inputs are loaded before the current frame's reduction, off
//     the chain.
//
// Nothing is copied to the host and nothing synchronises.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWindow = 1024;  // the largest predecessor distance (beat.py: _MAX_WINDOW)
constexpr int kWarps = 4;      // rows per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarps)
beat_dp_kernel(const float* __restrict__ localscore, const float* __restrict__ fpb,
               const float* __restrict__ log_fpb, const float* __restrict__ log_d,
               const float* __restrict__ thresh, int rows, int T, int fpb_per_frame,
               float tightness, int* __restrict__ backlink, float* __restrict__ cumscore) {
    __shared__ float ring[kWarps][kWindow];
    __shared__ float logd[kWindow];
    for (int k = threadIdx.x; k < kWindow; k += blockDim.x) logd[k] = log_d[k];
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + warp;
    if (row >= rows) return;  // the whole warp: no block-wide barrier follows

    const long long base = (long long)row * T;
    const float* ls = localscore + base;
    const long long fbase = fpb_per_frame ? base : row;
    const int fstep = fpb_per_frame ? 1 : 0;
    float* buf = ring[warp];
    const float th = thresh[row];
    bool first = true;

    float s_next = ls[0], f_next = fpb[fbase], lf_next = log_fpb[fbase];
    for (int i = 0; i < T; ++i) {
        const float si = s_next, fi = f_next, lf = lf_next;
        if (i + 1 < T) {
            s_next = ls[i + 1];
            f_next = fpb[fbase + (long long)(i + 1) * fstep];
            lf_next = log_fpb[fbase + (long long)(i + 1) * fstep];
        }
        // the candidates: integers d with d_min <= d <= d_max, 1 <= d <= min(1024, i)
        const float d_min = rintf(__fmul_rn(fi, 0.5f));
        const float lo_f = fmaxf(d_min, 1.0f);
        const float hi_f = fminf(floorf(__fmul_rn(2.0f, fi)), (float)min(kWindow, i));
        const bool any = lo_f <= hi_f;  // false for NaN too
        const int lo = any ? (int)lo_f : 1;
        const int hi = any ? (int)hi_f : 0;

        float best = -INFINITY;
        int best_d = INT_MAX;
        for (int d = lo + lane; d <= hi; d += 32) {
            const float diff = __fsub_rn(logd[d - 1], lf);
            const float pen = __fmul_rn(tightness, __fmul_rn(diff, diff));
            const float s = __fsub_rn(buf[(i - d) & (kWindow - 1)], pen);
            if (s > best) {  // a lane's d rise: strict keeps its smallest d on ties
                best = s;
                best_d = d;
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ob = __shfl_xor_sync(kFull, best, off);
            const int od = __shfl_xor_sync(kFull, best_d, off);
            if (ob > best || (ob == best && od < best_d)) {
                best = ob;
                best_d = od;
            }
        }
        const bool has = isfinite(best);
        const float cum = has ? __fadd_rn(si, best) : si;
        int link = has ? i - best_d : -1;
        if (first) {
            if (si < th) link = -1;
            else first = false;
        }
        if (lane == 0) {
            buf[i & (kWindow - 1)] = cum;
            cumscore[base + i] = cum;
            backlink[base + i] = link;
        }
        __syncwarp();
    }
}

// The floor of one step of the chain, for the bound: each frame does only what every
// step of beat_dp_kernel must do in order (one candidate a lane read from the ring, one
// subtraction, the same five-level (score, d) shuffle reduction, lane 0's write to the
// ring, __syncwarp). Its time over T is the least a step of this design can take.
__global__ void __launch_bounds__(32 * kWarps)
beat_dp_chain_probe_kernel(int rows, int T, float* __restrict__ out) {
    __shared__ float ring[kWarps][kWindow];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + warp;
    if (row >= rows) return;
    float* buf = ring[warp];
    for (int k = lane; k < kWindow; k += 32) buf[k] = 0.0f;
    __syncwarp();
    for (int i = 0; i < T; ++i) {
        float best = __fsub_rn(buf[(i - 1 - lane) & (kWindow - 1)], 0.001f * (float)lane);
        int best_d = lane + 1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ob = __shfl_xor_sync(kFull, best, off);
            const int od = __shfl_xor_sync(kFull, best_d, off);
            if (ob > best || (ob == best && od < best_d)) {
                best = ob;
                best_d = od;
            }
        }
        if (lane == 0) buf[i & (kWindow - 1)] = __fadd_rn(best, (float)(best_d & 1));
        __syncwarp();
    }
    if (lane == 0) out[row] = buf[(T - 1) & (kWindow - 1)];
}

}  // namespace

extern "C" int beat_dp_chain_probe_launch(int rows, int T, void* out, void* stream) {
    if (rows <= 0 || T <= 0) return 0;
    const dim3 grid((rows + kWarps - 1) / kWarps);
    beat_dp_chain_probe_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        rows, T, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int beat_dp_launch(const void* localscore, const void* fpb, const void* log_fpb,
                              const void* log_d, const void* thresh, int rows, int T,
                              int fpb_per_frame, float tightness, void* backlink,
                              void* cumscore, void* stream) {
    if (rows <= 0 || T <= 0) return 0;
    const dim3 grid((rows + kWarps - 1) / kWarps);
    beat_dp_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(localscore), static_cast<const float*>(fpb),
        static_cast<const float*>(log_fpb), static_cast<const float*>(log_d),
        static_cast<const float*>(thresh), rows, T, fpb_per_frame, tightness,
        static_cast<int*>(backlink), static_cast<float*>(cumscore));
    return static_cast<int>(cudaGetLastError());
}
