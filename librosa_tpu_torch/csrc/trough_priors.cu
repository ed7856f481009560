// pYIN's trough priors in one pass over the frames, for sm_90a: the kernel behind
// core/pitch.py:_pyin_trough_probs on the card.
//
// The function, per frame (a column of the difference function yin (rows, P, T) and of its
// trough mask, lags p = 0 .. P-1 in order), with t_k = thresholds[k + 1] and beta_k in the
// working type, a the Boltzmann parameter and s = 1 - exp(-a), k = 0 .. K-1:
//
//   below_k(p) = trough(p) and yin(p) < t_k
//   rank_k(p)  = the troughs below t_k at lags before p;  n_k = the troughs below t_k
//   prior(p)   = the sum over k, ascending, of below_k(p) ? exp(-a rank_k(p)) s
//                / (1 - exp(-a max(n_k, 1))) beta_k : 0
//   empty      = the sum over k, ascending, of n_k == 0 ? beta_k : 0
//
// then no_trough_prob * empty (0 where the column has no trough) is added to the prior of
// the lowest trough: the first lag of the column's minimum where every lag that is no trough
// reads +inf, a NaN before any number (torch.argmin's order).
//
// It replaces the XLA program librosa_tpu/core/pitch.py:773 _pyin_trough_probs, a loop over
// the thresholds that XLA compiles for the TPU (no Pallas kernel computes it), and in the
// port the plain loop ops/trough_priors.py:trough_priors_reference: some 27 kernels a
// threshold over the whole (rows, P, T) array, 2711 launches a pyin call at 100 thresholds.
//
// Bound on an H100: bytes. Each element is read once (yin and its mask) and written once, 9
// bytes in float32 (370 MB, 0.111 ms at 3.35 TB/s on 16 tracks of 8193 frames at 314 lags);
// a frame needs a few hundred operations. The design does one pass:
//
// - A trough below t_k is below every later threshold (the thresholds are sorted), so a
//   trough needs only its first threshold k_i, found by a binary search with the plain
//   loop's comparison (yin < t_k in the working type, as PyTorch compares a tensor with a
//   Python float), and its terms from k_i up: adding 0 before them is exact. rank_k and n_k
//   are counts of troughs by first threshold, prefix-summed over k.
// - One warp a frame. First walk: the lanes read 32 lags at a time (coalesced where the lags
//   of a frame are contiguous, as pYIN's are), find k_i, count the troughs by k_i in shared
//   memory, keep k_i in the warp's column buffer and find the lowest trough by a warp
//   reduction. The counts become n_k by a warp scan. Second walk: the troughs are queued in
//   lag order by ballots and taken 32 at a time, one a lane; a batch walks k from its least
//   k_i up, and one ballot a threshold gives each lane its rank among the batch, to which
//   the count of earlier batches' troughs below t_k (kept by threshold) is added. So no lane
//   waits on another's loop over thresholds.
// - exp(-a r) s and 1 - exp(-a n) come from tables made once per configuration by the torch
//   ops the plain loop runs, so their bits are the loop's whatever the toolkit's exp. Each
//   term is __fdiv_rn, __fmul_rn and __fadd_rn (__d*_rn in double) in the loop's order, so
//   no FMA is contracted and the sums have the loop's bits. The empty mass is a table of
//   prefix sums of beta_k rounded as torch.where rounds a Python float, added in the working
//   type in ascending k.
// - The kernel writes every output element itself, zeros included, and the lowest trough's
//   extra mass: one launch, nothing to clear before it and nothing to scatter after it. A
//   block's warps take consecutive frames and store their columns together, lag by lag, so
//   the frames of a lag go out side by side into the (rows, P, T) output the plain loop
//   returns.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kMaxWarps = 8;         // warps a block, each on a frame of its own
constexpr int kBatch = 32;           // troughs a batch: one a lane
constexpr int kQueue = 2 * kBatch;   // a warp's queue of trough lags: under 32 + one walk's 32
constexpr int kSmemLimit = 232448 - 1024;  // dynamic shared memory a block may ask for
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
    long long r, p, t;
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// the bytes of dynamic shared memory a block of `warps` warps takes
long long smem_bytes(int P, int K, int warps, int itemsize) {
    return static_cast<long long>(itemsize) * (2LL * K + static_cast<long long>(warps) * P)
           + 4LL * warps * (2LL * K + kQueue) + static_cast<long long>(warps) * P;
}

// the first k in [0, K) with v < thr[k] (thr sorted), K where there is none (NaN included)
template <typename T>
__device__ __forceinline__ int first_below(const T* thr, int K, T v) {
    int lo = 0, hi = K;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (v < thr[mid]) {
            hi = mid;
        } else {
            lo = mid + 1;
        }
    }
    return lo;
}

// whether (va, la) comes before (vb, lb) in argmin's order: the first NaN, else the least
// value at its first lag
template <typename T>
__device__ __forceinline__ bool before_in_argmin(T va, int la, T vb, int lb) {
    const bool na = va != va, nb = vb != vb;
    if (na || nb) return na && (!nb || la < lb);
    return va < vb || (va == vb && la < lb);
}

// One batch of n <= 32 queued troughs, lane l on queue[l]: each lane's prior into col.
template <typename T>
__device__ __forceinline__ void prior_batch(int n, int lane, const unsigned* queue, T* col,
                                            const int* n_below, int* earlier, const T* beta,
                                            const T* __restrict__ num,
                                            const T* __restrict__ den, int K) {
    const bool mine = lane < n;
    const int p = mine ? static_cast<int>(queue[lane]) : 0;
    const int ki = mine ? static_cast<int>(col[p]) : K;
    const int k0 = __reduce_min_sync(kFull, ki);
    const unsigned lower = (1u << lane) - 1u;
    T prior = T(0);
    for (int k = k0; k < K; ++k) {
        const bool below = ki <= k;
        const unsigned batch_below = __ballot_sync(kFull, below);
        const int before = earlier[k];
        if (below) {
            const int rank = before + __popc(batch_below & lower);
            const T pmf = div_rn(__ldg(num + rank), __ldg(den + n_below[k]));
            prior = add_rn(prior, mul_rn(pmf, beta[k]));
        }
        __syncwarp();
        if (lane == 0) earlier[k] = before + __popc(batch_below);
    }
    __syncwarp();
    if (mine) col[p] = prior;
}

// One frame by one warp: its priors into col (P values), with the warp's counts, queue and
// flags as scratch.
template <typename T>
__device__ __forceinline__ void frame_priors(const T* y, long long y_step,
                                             const unsigned char* m, long long m_step, int P,
                                             int K, const T* thr, const T* beta,
                                             const T* __restrict__ empty,
                                             const T* __restrict__ num,
                                             const T* __restrict__ den, T no_trough, T* col,
                                             int* n_below, int* earlier, unsigned* queue,
                                             unsigned char* active, int lane) {
    for (int k = lane; k < K; k += 32) {
        n_below[k] = 0;
        earlier[k] = 0;
    }
    __syncwarp();

    // first walk: k_i, the counts by k_i, the lowest trough
    T low = T(INFINITY);
    int low_lag = INT_MAX, k_first = K;
    bool any = false;
    for (int p0 = 0; p0 < P; p0 += 32) {
        const int p = p0 + lane;
        if (p < P) {
            const bool trough = m[p * m_step] != 0;
            const T v = y[p * y_step];
            if (before_in_argmin(trough ? v : T(INFINITY), p, low, low_lag)) {
                low = trough ? v : T(INFINITY);
                low_lag = p;
            }
            int ki = K;
            if (trough) {
                any = true;
                ki = first_below(thr, K, v);
                k_first = min(k_first, ki);
            }
            const bool act = ki < K;
            col[p] = act ? static_cast<T>(ki) : T(0);
            active[p] = act;
            if (act) atomicAdd(n_below + ki, 1);
        }
    }
    any = __any_sync(kFull, any);
    k_first = __reduce_min_sync(kFull, k_first);
    for (int off = 16; off > 0; off >>= 1) {
        const T v = __shfl_xor_sync(kFull, low, off);
        const int lag = __shfl_xor_sync(kFull, low_lag, off);
        if (before_in_argmin(v, lag, low, low_lag)) {
            low = v;
            low_lag = lag;
        }
    }
    __syncwarp();
    int carry = 0;  // the counts into n_k
    for (int k0 = 0; k0 < K; k0 += 32) {
        const int k = k0 + lane;
        int c = k < K ? n_below[k] : 0;
        for (int off = 1; off < 32; off <<= 1) {
            const int up = __shfl_up_sync(kFull, c, off);
            if (lane >= off) c += up;
        }
        if (k < K) n_below[k] = carry + c;
        carry += __shfl_sync(kFull, c, 31);
    }
    __syncwarp();

    // second walk: the troughs in lag order, 32 at a time
    const unsigned lower = (1u << lane) - 1u;
    int queued = 0;
    for (int p0 = 0; p0 < P; p0 += 32) {
        const int p = p0 + lane;
        const bool act = p < P && active[p] != 0;
        const unsigned ballot = __ballot_sync(kFull, act);
        if (act) queue[queued + __popc(ballot & lower)] = static_cast<unsigned>(p);
        queued += __popc(ballot);
        __syncwarp();
        if (queued >= kBatch) {
            prior_batch(kBatch, lane, queue, col, n_below, earlier, beta, num, den, K);
            const bool rest = lane + kBatch < queued;
            const unsigned lag = rest ? queue[lane + kBatch] : 0u;
            __syncwarp();
            if (rest) queue[lane] = lag;
            queued -= kBatch;
            __syncwarp();
        }
    }
    if (queued > 0) prior_batch(queued, lane, queue, col, n_below, earlier, beta, num, den, K);
    __syncwarp();
    if (lane == 0) {  // the plain loop's scatter_add: prior + no_trough * empty
        col[low_lag] = add_rn(col[low_lag], mul_rn(no_trough, any ? empty[k_first] : T(0)));
    }
}

// A block of warps on as many consecutive frames; the output goes out by lag, each lag's
// frames side by side (contiguous in a (rows, P, T) output).
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
trough_priors_kernel(const T* __restrict__ yin, const unsigned char* __restrict__ mask,
                     Strides ys, Strides ms, Strides os, long long frames, long long n_t, int P,
                     int K, const T* __restrict__ thr_in, const T* __restrict__ beta_in,
                     const T* __restrict__ empty, const T* __restrict__ num,
                     const T* __restrict__ den, T no_trough, T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warps = static_cast<int>(blockDim.x >> 5);
    const int warp = static_cast<int>(threadIdx.x >> 5), lane = static_cast<int>(threadIdx.x & 31);
    T* thr = reinterpret_cast<T*>(smem);
    T* beta = thr + K;
    T* cols = beta + K;  // a column a warp: k_i, then the priors
    int* counts = reinterpret_cast<int*>(cols + static_cast<long long>(warps) * P);
    unsigned* queues = reinterpret_cast<unsigned*>(counts + 2 * K * warps);
    unsigned char* flags = reinterpret_cast<unsigned char*>(queues + kQueue * warps);

    for (int k = static_cast<int>(threadIdx.x); k < K; k += static_cast<int>(blockDim.x)) {
        thr[k] = thr_in[k];
        beta[k] = beta_in[k];
    }
    __syncthreads();
    const long long first = static_cast<long long>(blockIdx.x) * warps;
    const long long f = first + warp;
    if (f < frames) {  // warp-uniform
        const long long row = f / n_t, t = f - row * n_t;
        frame_priors(yin + row * ys.r + t * ys.t, ys.p, mask + row * ms.r + t * ms.t, ms.p, P, K,
                     thr, beta, empty, num, den, no_trough,
                     cols + static_cast<long long>(warp) * P, counts + 2 * K * warp,
                     counts + 2 * K * warp + K, queues + kQueue * warp,
                     flags + static_cast<long long>(warp) * P, lane);
    }
    __syncthreads();
    // thread i stores frame i % warps at lags i / warps, i / warps + 32, ...
    const int w = static_cast<int>(threadIdx.x) % warps;
    const long long g = first + w;
    if (g >= frames) return;
    const long long row = g / n_t, t = g - row * n_t;
    T* o = out + row * os.r + t * os.t;
    const T* col = cols + static_cast<long long>(w) * P;
    for (int p = static_cast<int>(threadIdx.x) / warps; p < P; p += 32) o[p * os.p] = col[p];
}

template <typename T>
int launch(const void* yin, const void* mask, Strides ys, Strides ms, Strides os, long long rows,
           long long n_t, int P, int K, const void* thr, const void* beta,
           const void* empty, const void* num, const void* den, double no_trough, void* out,
           void* stream) {
    if (P < 1 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long frames = rows * n_t;
    if (frames <= 0) return 0;
    int warps = kMaxWarps;  // the most of 8, 4, 2, 1 whose shared memory fits a block
    while (warps > 1 && smem_bytes(P, K, warps, sizeof(T)) > kSmemLimit) warps >>= 1;
    const long long smem = smem_bytes(P, K, warps, sizeof(T));
    const long long blocks = (frames + warps - 1) / warps;
    if (smem > kSmemLimit || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            trough_priors_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    trough_priors_kernel<T><<<static_cast<unsigned>(blocks), warps * 32, static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(yin), static_cast<const unsigned char*>(mask), ys, ms, os, frames,
        n_t, P, K, static_cast<const T*>(thr), static_cast<const T*>(beta),
        static_cast<const T*>(empty), static_cast<const T*>(num), static_cast<const T*>(den),
        static_cast<T>(no_trough), static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// yin, mask and out are (rows, P, n_t) with the element strides given (mask: bools as bytes);
// double_type selects float64 for yin, the tables and out. Returns a CUDA error code: 0 where
// the kernel was launched or there was no frame to launch on, cudaErrorInvalidValue where P
// and K need more shared memory than one warp's block may have.
extern "C" int trough_priors_launch(int double_type, const void* yin, const void* mask,
                                    long long ys_r, long long ys_p, long long ys_t,
                                    long long ms_r, long long ms_p, long long ms_t,
                                    long long os_r, long long os_p, long long os_t, long long rows,
                                    long long n_t, int P, int K, const void* thr,
                                    const void* beta, const void* empty, const void* num,
                                    const void* den, double no_trough, void* out, void* stream) {
    const Strides ys{ys_r, ys_p, ys_t}, ms{ms_r, ms_p, ms_t}, os{os_r, os_p, os_t};
    if (double_type) {
        return launch<double>(yin, mask, ys, ms, os, rows, n_t, P, K, thr, beta, empty, num,
                              den, no_trough, out, stream);
    }
    return launch<float>(yin, mask, ys, ms, os, rows, n_t, P, K, thr, beta, empty, num, den,
                         no_trough, out, stream);
}
