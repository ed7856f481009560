// Max-plus Viterbi decoding of a batch of sequences: a forward pass by one of two routes,
// then a backtrack.
//
// The function, for each row r (log_prob (R, T, S), log_trans (S, S), log_p_init (S)):
//
//   v_0[n]   = log_prob[0, n] + log_p_init[n]
//   v_t[n]   = log_prob[t, n] + max_p (v_{t-1}[p] + log_trans[p, n]),   t = 1 .. T-1
//   ptr_t[n] = the p of that maximum, the first p on ties (p = 0 where every sum is -inf),
//
// then logp = max_n v_{T-1}[n], states[T-1] its first argmax, and states[t-1] =
// ptr_t[states[t]] back to the first frame.
//
// It replaces the JAX package's _viterbi_scan (librosa_tpu/sequence.py:609-638), a
// lax.scan of dense max-plus products that XLA compiles for the TPU; no Pallas kernel
// computes it. The plain PyTorch version (ops/viterbi.py: viterbi_reference) is a loop
// over frames of a broadcast add and a max over (R, S, S), then a loop of gathers.
//
// Bound on an H100: operations, R (T - 1) x (the finite entries of log_trans) add-and-
// compare pairs. A max over p is the same, value and first p, whether or not it visits
// the p where log_trans[p, n] = -inf: those sums are -inf and never win while any sum is
// finite. pYIN prunes its transitions to 16.6 % finite entries (870 states: two runs of
// some 72 rows in every column), so the exact work is a sixth of the dense product's.
// Max-plus has no tensor-core form. Every sum is __fadd_rn, in the plain version's floats,
// and ties keep the first p, so states and logp have the plain version's bits.
//
// Routes of the forward pass (ops/viterbi.py picks one by the number of states):
//
//   cluster (viterbi_cluster_kernel): a thread-block cluster of 4 or 8 blocks per row,
//     launched with cudaLaunchKernelEx. Block b owns a contiguous share of the next
//     states n. The wrapper packs log_trans once per table into runs of finite entries
//     (ops/viterbi.py: RunTable); a block keeps its share's packed values in shared
//     memory where they fit (pYIN at cluster 8: 63 KB), else reads them from global
//     memory (a dense 870-state matrix). Each block holds v_{t-1} for every p, double-
//     buffered. A frame: groups of G lanes walk one column each over its runs
//     (csrc/viterbi_runs.cuh), combine their lanes by (score, first p), write the
//     pointer, and store v_t[n] into every block's next buffer through distributed
//     shared memory; then one cluster barrier (arrive.release / wait.acquire). The next
//     frame's log_prob comes into shared memory by cp.async during the frame. G is the
//     largest power of two 4-32 with which the block's threads take its whole share in
//     one round (ops/viterbi.py: RunTable.group; 4 for pYIN): a round of columns costs
//     about the same whatever G, so rounds matter first, and more lanes shorten a walk.
//   block (viterbi_block_kernel): one block per row, a thread per next state looping
//     over every p (the first design), for few states, where a cluster does not pay.
//
// Backtrack (viterbi_backtrack_kernel): the pointers are int16 (S <= 16384), an (R, T,
// S) buffer that never leaves the op. One block per row copies the pointer rows of the
// next frames into shared memory ahead of the chain (cp.async, 16 bytes a copy, two
// stages), so only the chain of s, one shared-memory load a frame, is sequential.
//
// viterbi_exchange_probe_kernel runs only the cluster route's frame skeleton (the
// distributed-shared-memory stores of v_t and one cluster barrier a frame): its time is
// the floor of that route's per-frame exchange. Nothing is copied to the host and
// nothing synchronises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "viterbi_runs.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockThreads = 1024;   // block route: at most, one thread per state
constexpr int kClusterThreads = 512;  // cluster route: at most
constexpr int kBackThreads = 256;     // backtrack: warp 0 walks, the others copy
constexpr long long kBackStageBytes = 96 * 1024;  // backtrack: each of its two stages
constexpr int kSmemLimit = 232448 - 1024;  // dynamic shared memory a block may ask for

__device__ __forceinline__ void copy_async4(void* dst_smem, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async16(void* dst_smem, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst_smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one barrier of every thread of the cluster: writes before it, local or remote, are
// seen by every thread after it
__device__ __forceinline__ void cluster_barrier() {
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n"
        "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// logp and states[T - 1] of a row from v_{T-1}: the first n of the largest value (0
// where every value is -inf, as the plain version's max). Every thread of the block calls it.
__device__ void write_last(const float* v, int S, long long r, int T, int* states, float* logp) {
    __shared__ float warp_best[32];
    __shared__ int warp_idx[32];
    float best = -INFINITY;
    int idx = INT_MAX;
    for (int n = threadIdx.x; n < S; n += blockDim.x) {
        if (v[n] > best) {
            best = v[n];
            idx = n;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        if (viterbi_runs::takes(ob, oi, best, idx)) {
            best = ob;
            idx = oi;
        }
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        warp_best[warp] = best;
        warp_idx[warp] = idx;
    }
    __syncthreads();
    if (warp == 0) {
        const int warps = (blockDim.x + 31) >> 5;
        best = lane < warps ? warp_best[lane] : -INFINITY;
        idx = lane < warps ? warp_idx[lane] : INT_MAX;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, best, off);
            const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
            if (viterbi_runs::takes(ob, oi, best, idx)) {
                best = ob;
                idx = oi;
            }
        }
        if (lane == 0) {
            const bool any = idx != INT_MAX;
            logp[r] = any ? best : v[0];
            states[r * T + T - 1] = any ? idx : 0;
        }
    }
}

// ---------------------------------------------------------------------------------------
// block route: one block per row, a thread per next state, every p in order
// ---------------------------------------------------------------------------------------

__global__ void __launch_bounds__(kBlockThreads)
viterbi_block_kernel(const float* __restrict__ log_prob, const float* __restrict__ log_trans,
                     const float* __restrict__ log_p_init, int T, int S,
                     int16_t* __restrict__ ptr, int* __restrict__ states,
                     float* __restrict__ logp) {
    extern __shared__ float v[];
    float* cur = v;
    float* nxt = v + S;
    const long long r = blockIdx.x;
    const float* lp = log_prob + r * T * S;
    int16_t* pr = ptr + r * T * S;

    for (int n = threadIdx.x; n < S; n += blockDim.x) cur[n] = __fadd_rn(lp[n], log_p_init[n]);
    __syncthreads();

    for (int t = 1; t < T; ++t) {
        const float* lpt = lp + (long long)t * S;
        int16_t* pt = pr + (long long)t * S;
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
            pt[n] = static_cast<int16_t>(best_p);
        }
        __syncthreads();
        float* swap = cur;
        cur = nxt;
        nxt = swap;
    }
    write_last(cur, S, r, T, states, logp);
}

// ---------------------------------------------------------------------------------------
// cluster route: a cluster per row, columns split over its blocks, v exchanged through
// distributed shared memory once a frame
// ---------------------------------------------------------------------------------------

struct Runs {
    const float* vals;       // the finite entries, column by column, ascending p
    const int* col_run;      // (S + 1): column n's runs are col_run[n] .. col_run[n + 1] - 1
    const int* col_val;      // (S + 1): column n's first packed value
    const int* run_start;    // first row p of each run
    const int* run_len;      // rows in each run
    const int* run_val;      // packed offset of each run's first value
};

// dynamic shared memory of the cluster route, in floats: v (2 S), the next log_prob
// of the block's columns (2 share), its packed values where they are kept (share_vals)
__host__ __device__ inline long long cluster_smem_floats(int S, int share, int share_vals) {
    return 2LL * S + 2LL * share + share_vals;
}

template <int G, bool kSmemVals>
__global__ void __launch_bounds__(kClusterThreads, 1)
viterbi_cluster_kernel(const float* __restrict__ log_prob, const float* __restrict__ log_p_init,
                       Runs runs, int T, int S, int16_t* __restrict__ ptr,
                       int* __restrict__ states, float* __restrict__ logp) {
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int csize = static_cast<int>(cluster.num_blocks());
    const long long r = blockIdx.x / csize;
    const int share = (S + csize - 1) / csize;
    const int n0 = min(S, rank * share);
    const int C = min(S, n0 + share) - n0;
    const int vbase = kSmemVals ? __ldg(runs.col_val + n0) : 0;
    const int n_vals = __ldg(runs.col_val + n0 + C) - __ldg(runs.col_val + n0);
    float* vbuf = smem;                 // [2][S]
    float* lps = smem + 2 * S;          // [2][share]
    float* vs = lps + 2 * share;        // [n_vals] where kept
    const float* vals = kSmemVals ? vs : runs.vals;
    const float* lp = log_prob + r * T * S;
    int16_t* pr = ptr + r * T * S;
    const int tid = threadIdx.x, bd = blockDim.x;

    for (int n = tid; n < S; n += bd) vbuf[n] = __fadd_rn(lp[n], log_p_init[n]);
    if (kSmemVals)
        for (int k = tid; k < n_vals; k += bd) vs[k] = runs.vals[vbase + k];
    if (T > 1)
        for (int c = tid; c < C; c += bd) lps[share + c] = lp[S + n0 + c];
    cluster.sync();  // every block has started and holds v_0 and its tables

    constexpr int kGroupsPerWarp = 32 / G;
    const int groups = (bd >> 5) * kGroupsPerWarp;
    const int gid = (tid >> 5) * kGroupsPerWarp + (tid & 31) / G;
    const int lane = tid & (G - 1);
    for (int t = 1; t < T; ++t) {
        const float* cur = vbuf + ((t - 1) & 1) * S;
        float* nxt = vbuf + (t & 1) * S;
        if (t + 1 < T) {
            float* dst = lps + ((t + 1) & 1) * share;
            const float* src = lp + (long long)(t + 1) * S + n0;
            for (int c = tid; c < C; c += bd) copy_async4(dst + c, src + c);
        }
        const float* lpt = lps + (t & 1) * share;
        int16_t* pt = pr + (long long)t * S;
        for (int c0 = 0; c0 < C; c0 += groups) {  // the same trip count across a warp
            const int c = c0 + gid;
            const bool active = c < C;
            const int n = n0 + c;
            float best = -INFINITY;
            int best_p = INT_MAX;
            if (active)
                viterbi_runs::lane_best(cur, vals, vbase, runs.run_start, runs.run_len,
                                        runs.run_val, __ldg(runs.col_run + n),
                                        __ldg(runs.col_run + n + 1), lane, G, best, best_p);
#pragma unroll
            for (int off = G / 2; off > 0; off >>= 1) {
                const float ob = __shfl_xor_sync(0xffffffffu, best, off, G);
                const int op = __shfl_xor_sync(0xffffffffu, best_p, off, G);
                if (viterbi_runs::takes(ob, op, best, best_p)) {
                    best = ob;
                    best_p = op;
                }
            }
            if (active) {
                const float vn = __fadd_rn(lpt[c], best);
                if (lane == 0) pt[n] = static_cast<int16_t>(viterbi_runs::pointer_of(best, best_p));
                for (int q = lane; q < csize; q += G) *cluster.map_shared_rank(nxt + n, q) = vn;
            }
        }
        copy_async_wait();
        cluster_barrier();
    }
    if (rank == 0) write_last(vbuf + ((T - 1) & 1) * S, S, r, T, states, logp);
}

// the frame skeleton of the cluster route alone: each block stores its share of v_t into
// every block through distributed shared memory, then one cluster barrier, T - 1 times
__global__ void __launch_bounds__(kClusterThreads, 1)
viterbi_exchange_probe_kernel(int T, int S, float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int csize = static_cast<int>(cluster.num_blocks());
    const long long r = blockIdx.x / csize;
    const int share = (S + csize - 1) / csize;
    const int n0 = min(S, rank * share);
    const int C = min(S, n0 + share) - n0;
    for (int n = threadIdx.x; n < 2 * S; n += blockDim.x) smem[n] = 0.0f;
    cluster.sync();
    for (int t = 1; t < T; ++t) {
        const float* cur = smem + ((t - 1) & 1) * S;
        float* nxt = smem + (t & 1) * S;
        for (int k = threadIdx.x; k < C * csize; k += blockDim.x) {
            const int n = n0 + k / csize;
            *cluster.map_shared_rank(nxt + n, k % csize) = __fadd_rn(cur[n], 1.0f);
        }
        cluster_barrier();
    }
    if (rank == 0 && threadIdx.x == 0) out[r] = smem[((T - 1) & 1) * S];
}

// ---------------------------------------------------------------------------------------
// backtrack: the pointer rows of the next frames staged in shared memory ahead of the chain
// ---------------------------------------------------------------------------------------

__global__ void __launch_bounds__(kBackThreads)
viterbi_backtrack_kernel(const int16_t* __restrict__ ptr, int T, int S, int chunk,
                         int stage_bytes, int* __restrict__ states) {
    extern __shared__ __align__(16) unsigned char stage[];
    const long long r = blockIdx.x;
    const unsigned char* bytes = reinterpret_cast<const unsigned char*>(ptr);
    int* st = states + r * T;
    // frames lo .. hi of the row: bytes [b0, b1), copied from the 16-byte boundary at or
    // below b0 (the wrapper leaves 16 bytes beyond the buffer's end); returns b0's offset
    auto first_byte = [&](int lo) { return (r * T + lo) * (long long)S * 2; };
    auto copy = [&](int buf, int lo, int hi, int first, int stride) {
        const long long b0 = first_byte(lo), b1 = first_byte(hi + 1);
        const long long a0 = b0 & ~15LL;
        const long long units = (b1 - a0 + 15) >> 4;
        unsigned char* dst = stage + (long long)buf * stage_bytes;
        for (long long u = first; u < units; u += stride)
            copy_async16(dst + 16 * u, bytes + a0 + 16 * u);
        copy_async_wait();
    };
    if (T <= 1) return;
    int hi = T - 1, lo = max(1, hi - chunk + 1), buf = 0;
    copy(0, lo, hi, threadIdx.x, blockDim.x);
    __syncthreads();
    int s = st[T - 1];
    while (true) {
        const int next_hi = lo - 1, next_lo = max(1, next_hi - chunk + 1);
        if (threadIdx.x < 32) {
            if (threadIdx.x == 0) {
                const unsigned char* base =
                    stage + (long long)buf * stage_bytes + (first_byte(lo) & 15);
                const int16_t* rows = reinterpret_cast<const int16_t*>(base);
                for (int t = hi; t >= lo; --t) {
                    s = rows[(long long)(t - lo) * S + s];
                    st[t - 1] = s;
                }
            }
        } else if (next_hi >= 1) {
            copy(buf ^ 1, next_lo, next_hi, threadIdx.x - 32, blockDim.x - 32);
        }
        __syncthreads();
        if (next_hi < 1) break;
        buf ^= 1;
        hi = next_hi;
        lo = next_lo;
    }
}

// threads of a cluster-route block: G lanes per column of the share, in whole warps
int cluster_threads(int S, int cluster, int G) {
    const long long share = (S + cluster - 1) / cluster;
    const long long want = (share * G + 31) / 32 * 32;
    return static_cast<int>(want < 32 ? 32 : want > kClusterThreads ? kClusterThreads : want);
}

template <int G, bool kSmemVals>
int cluster_config(int rows, int T, int S, int cluster, int share_vals, cudaStream_t stream,
                   const float* log_prob, const float* log_p_init, const Runs& runs,
                   int16_t* ptr, int* states, float* logp, int* max_clusters) {
    auto kernel = viterbi_cluster_kernel<G, kSmemVals>;
    const int share = (S + cluster - 1) / cluster;
    const long long floats = cluster_smem_floats(S, share, kSmemVals ? share_vals : 0);
    if (4 * floats > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(4 * floats);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(rows) * cluster));
    cfg.blockDim = dim3(cluster_threads(S, cluster, G));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (max_clusters != nullptr)
        return static_cast<int>(cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg));
    err = cudaLaunchKernelEx(&cfg, kernel, log_prob, log_p_init, runs, T, S, ptr, states, logp);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <bool kSmemVals>
int cluster_by_group(int group, int rows, int T, int S, int cluster, int share_vals,
                     cudaStream_t stream, const float* lp, const float* lpi, const Runs& runs,
                     int16_t* ptr, int* states, float* logp, int* max_clusters) {
    switch (group) {
        case 4:
            return cluster_config<4, kSmemVals>(rows, T, S, cluster, share_vals, stream, lp, lpi,
                                                runs, ptr, states, logp, max_clusters);
        case 8:
            return cluster_config<8, kSmemVals>(rows, T, S, cluster, share_vals, stream, lp, lpi,
                                                runs, ptr, states, logp, max_clusters);
        case 16:
            return cluster_config<16, kSmemVals>(rows, T, S, cluster, share_vals, stream, lp, lpi,
                                                 runs, ptr, states, logp, max_clusters);
        case 32:
            return cluster_config<32, kSmemVals>(rows, T, S, cluster, share_vals, stream, lp, lpi,
                                                 runs, ptr, states, logp, max_clusters);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

int cluster_dispatch(const void* log_prob, const void* log_p_init, const void* vals,
                     const void* col_run, const void* col_val, const void* run_start,
                     const void* run_len, const void* run_val, int rows, int T, int S,
                     int cluster, int group, int share_vals, void* ptr, void* states, void* logp,
                     void* stream, int* max_clusters) {
    if (rows <= 0 || T <= 0 || S <= 0 || cluster < 1 || cluster > 8) return 1;
    const Runs runs{static_cast<const float*>(vals), static_cast<const int*>(col_run),
                    static_cast<const int*>(col_val), static_cast<const int*>(run_start),
                    static_cast<const int*>(run_len), static_cast<const int*>(run_val)};
    const auto lp = static_cast<const float*>(log_prob);
    const auto lpi = static_cast<const float*>(log_p_init);
    const auto st = static_cast<cudaStream_t>(stream);
    const int share = (S + cluster - 1) / cluster;
    if (4 * cluster_smem_floats(S, share, share_vals) <= kSmemLimit)
        return cluster_by_group<true>(group, rows, T, S, cluster, share_vals, st, lp, lpi, runs,
                                      static_cast<int16_t*>(ptr), static_cast<int*>(states),
                                      static_cast<float*>(logp), max_clusters);
    return cluster_by_group<false>(group, rows, T, S, cluster, share_vals, st, lp, lpi, runs,
                                   static_cast<int16_t*>(ptr), static_cast<int*>(states),
                                   static_cast<float*>(logp), max_clusters);
}

}  // namespace

// Whether the cluster route keeps the packed values of a block's share in shared memory.
extern "C" int viterbi_cluster_smem_vals(int S, int cluster, int share_vals) {
    const int share = (S + cluster - 1) / cluster;
    return 4 * cluster_smem_floats(S, share, share_vals) <= kSmemLimit ? 1 : 0;
}

extern "C" int viterbi_block_forward(const void* log_prob, const void* log_trans,
                                     const void* log_p_init, int rows, int T, int S, void* ptr,
                                     void* states, void* logp, void* stream) {
    if (rows <= 0 || T <= 0 || S <= 0) return 0;
    const int threads = S >= kBlockThreads ? kBlockThreads : ((S + 31) / 32) * 32;
    const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            viterbi_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    viterbi_block_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(log_prob), static_cast<const float*>(log_trans),
        static_cast<const float*>(log_p_init), T, S, static_cast<int16_t*>(ptr),
        static_cast<int*>(states), static_cast<float*>(logp));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int viterbi_cluster_forward(const void* log_prob, const void* log_p_init,
                                       const void* vals, const void* col_run, const void* col_val,
                                       const void* run_start, const void* run_len,
                                       const void* run_val, int rows, int T, int S, int cluster,
                                       int group, int share_vals, void* ptr, void* states,
                                       void* logp, void* stream) {
    if (rows <= 0 || T <= 0 || S <= 0) return 0;
    return cluster_dispatch(log_prob, log_p_init, vals, col_run, col_val, run_start, run_len,
                            run_val, rows, T, S, cluster, group, share_vals, ptr, states, logp,
                            stream, nullptr);
}

// cudaOccupancyMaxActiveClusters for the cluster route's launch at this shape
extern "C" int viterbi_cluster_occupancy(int S, int cluster, int group, int share_vals,
                                         int* max_clusters) {
    return cluster_dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                            1, 2, S, cluster, group, share_vals, nullptr, nullptr, nullptr,
                            nullptr, max_clusters);
}

extern "C" int viterbi_backtrack(const void* ptr, int rows, int T, int S, void* states,
                                 void* stream) {
    if (rows <= 0 || T <= 1 || S <= 0) return 0;
    // frames of pointer rows a stage holds (96 KB each, two stages), and a stage's bytes
    long long c = (kBackStageBytes - 32) / (2LL * S);
    c = c < 1 ? 1 : c > T - 1 ? T - 1 : c;
    const int chunk = static_cast<int>(c);
    const int stage_bytes = static_cast<int>((c * S * 2 + 31) / 16 * 16);
    const size_t smem = 2 * static_cast<size_t>(stage_bytes);
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_backtrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    viterbi_backtrack_kernel<<<rows, kBackThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(ptr), T, S, chunk, stage_bytes, static_cast<int*>(states));
    return static_cast<int>(cudaGetLastError());
}

// the cluster route's frame skeleton with as many blocks and threads as its launch
extern "C" int viterbi_exchange_probe(int rows, int T, int S, int cluster, int group, void* out,
                                      void* stream) {
    if (rows <= 0 || T <= 0 || S <= 0 || cluster < 1 || cluster > 8) return 1;
    const size_t smem = 2 * static_cast<size_t>(S) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(viterbi_exchange_probe_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(rows) * cluster));
    cfg.blockDim = dim3(cluster_threads(S, cluster, group));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, viterbi_exchange_probe_kernel, T, S, static_cast<float*>(out));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
