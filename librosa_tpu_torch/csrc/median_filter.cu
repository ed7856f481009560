// Centred sliding median along one axis of a (B, M, L) float32 tensor, in one launch.
//
// The function: out[b, o, f] is the median of x[b, o, refl(f - size/2 + j)],
// j = 0 .. size-1, along the filter axis f of length L (the other axis o has
// length M), where refl mirrors an index about the ends with the end sample
// repeated (numpy "symmetric", scipy.ndimage "reflect") over as many periods
// as it takes. The median is the order statistic of rank size/2 (for an even
// size the upper middle one); an odd window that holds a NaN gives NaN, and in
// an even window NaNs sort above everything. Zeros of either sign compare
// equal and come out as +0. The strides of all three axes are given, for the
// input and the output alike, so a (bins, T) view of time-major memory is read
// in place.
//
// It replaces librosa_tpu/ops/median.py:23 median_filter_1d, which the JAX
// package compiles with XLA (a stack of `size` shifted copies, then a sort);
// no Pallas kernel computes it. The plain PyTorch version
// (ops/median.py: median_filter_reference) pads, views the windows with
// Tensor.unfold and takes torch.median (or sorts, for an even size).
//
// Bound on an H100: the function reads each input once and writes each output
// once, so bytes; a selection costs O(size) integer operations per output, so
// the design keeps those few and every access coalesced:
//
//   - a block owns a tile of 32 positions of the other axis by kTile positions
//     of the filter axis. It stages the tile and its size-1 halo in shared
//     memory once, with the reflected indices resolved as it loads, as 32-bit
//     keys whose unsigned order is the sort's order (-inf .. +inf, then NaN);
//     the load runs along whichever axis is contiguous in memory;
//   - each thread owns one position of the other axis and a run of kRun
//     consecutive outputs along the filter axis. It keeps its window sorted in
//     a register array (WIDTH keys, fully unrolled: no indexing at run time) and
//     moves it one step per output with one pass of compares, selects, minima
//     and maxima that deletes the key leaving and inserts the key entering.
//     Sentinel keys below and above the real ones put the rank-size/2 key at
//     index WIDTH/2 whatever the size, so the median is read from a fixed
//     register;
//   - the outputs go through shared memory too and are stored along whichever
//     axis of the output is contiguous.
//
// Nothing is copied to the host and nothing needs initialising.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;        // positions of the other axis per block (one per lane)
constexpr int kRuns = 4;         // runs along the filter axis per block (one per warp)
constexpr int kRun = 32;         // outputs per thread
constexpr int kTile = kRuns * kRun;
constexpr int kMaxSize = 64;
constexpr int kThreads = kCols * kRuns;
// shared rows: the tile, its halo, and one word so that the pitch is odd (no bank conflicts)
constexpr int kInPitch = kTile + kMaxSize - 1;   // 191: odd
constexpr int kOutPitch = kTile + 1;             // 129: odd

constexpr uint32_t kLow = 0u;                 // below every key
constexpr uint32_t kHigh = 0xFFFFFFFFu;       // above every key
constexpr uint32_t kNaN = 0xFFFFFFFEu;        // every NaN: above +inf

__device__ __forceinline__ uint32_t to_key(float v) {
    if (v != v) return kNaN;
    const uint32_t u = __float_as_uint(__fadd_rn(v, 0.0f));  // -0 becomes +0
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
    if (k == kNaN) return __uint_as_float(0x7FC00000u);
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// index i of an axis of length n, mirrored with the end sample repeated, any number of periods
__device__ __forceinline__ long long mirror(long long i, long long n) {
    if (i >= 0 && i < n) return i;
    const long long period = 2 * n;
    long long m = i % period;
    if (m < 0) m += period;
    return m < n ? m : period - 1 - m;
}

template <int WIDTH>
__device__ __forceinline__ void insert(uint32_t (&s)[WIDTH], uint32_t key) {
    // s sorted; drop its last element and put `key` in order: t[i] = max(s[i-1], min(s[i], key))
    uint32_t prev = kLow;
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
        const uint32_t cur = s[i];
        s[i] = max(prev, min(cur, key));
        prev = cur;
    }
}

template <int WIDTH>
__device__ __forceinline__ void replace(uint32_t (&s)[WIDTH], uint32_t leaving, uint32_t entering) {
    // delete the first copy of `leaving` (the rest shift down, kHigh enters at the top), then
    // insert `entering`, in one pass: d is the array after the deletion
    uint32_t prev = kLow;
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
        const uint32_t next = (i + 1 < WIDTH) ? s[i + 1] : kHigh;
        const uint32_t d = s[i] < leaving ? s[i] : next;
        s[i] = max(prev, min(d, entering));
        prev = d;
    }
}

// filter axis: length L, strides xf / of; other axis: length M, strides xo / oo; batch: xb / ob
template <int WIDTH>
__global__ void __launch_bounds__(kThreads)
median_kernel(const float* __restrict__ x, float* __restrict__ out, long long L, long long M,
              long long xb, long long xo, long long xf, long long ob, long long oo, long long of,
              int size) {
    __shared__ uint32_t keys[kCols * kInPitch];
    __shared__ float result[kCols * kOutPitch];

    const long long f0 = static_cast<long long>(blockIdx.x) * kTile;
    const long long o0 = static_cast<long long>(blockIdx.y) * kCols;
    const long long b = blockIdx.z;
    const int tid = threadIdx.y * kCols + threadIdx.x;
    const int half = size / 2;
    const int span = kTile + size - 1;
    const float* xt = x + b * xb;

    // stage the tile and its halo as keys, reading along the contiguous axis
    if (xf == 1) {
        for (int e = tid; e < kCols * span; e += kThreads) {
            const int c = e / span, j = e - c * span;
            const long long o = o0 + c;
            if (o < M) keys[c * kInPitch + j] = to_key(__ldg(xt + o * xo + mirror(f0 - half + j, L)));
        }
    } else {
        for (int e = tid; e < kCols * span; e += kThreads) {
            const int c = e % kCols, j = e / kCols;
            const long long o = o0 + c;
            if (o < M) keys[c * kInPitch + j] = to_key(__ldg(xt + o * xo + mirror(f0 - half + j, L) * xf));
        }
    }
    __syncthreads();

    // this thread's run: column c, outputs r0 .. r0 + kRun - 1 of the tile
    const int c = threadIdx.x, r0 = threadIdx.y * kRun;
    if (o0 + c < M && f0 + r0 < L) {
        const uint32_t* row = keys + c * kInPitch;
        uint32_t s[WIDTH];
        const int lows = WIDTH / 2 - half;   // the median lands on s[WIDTH / 2]
#pragma unroll
        for (int i = 0; i < WIDTH; ++i) s[i] = i < lows ? kLow : kHigh;
        int nans = 0;
        for (int j = 0; j < size; ++j) {
            const uint32_t k = row[r0 + j];
            insert(s, k);
            nans += k == kNaN;
        }
        const bool odd = size & 1;
        float* res = result + c * kOutPitch;
        res[r0] = (odd && nans) ? from_key(kNaN) : from_key(s[WIDTH / 2]);
        const int last = static_cast<int>(min(static_cast<long long>(kRun), L - f0 - r0));
        for (int r = 1; r < last; ++r) {
            const uint32_t leaving = row[r0 + r - 1], entering = row[r0 + r + size - 1];
            replace(s, leaving, entering);
            nans += (entering == kNaN) - (leaving == kNaN);
            res[r0 + r] = (odd && nans) ? from_key(kNaN) : from_key(s[WIDTH / 2]);
        }
    }
    __syncthreads();

    // store the tile along the output's contiguous axis
    float* ot = out + b * ob;
    if (of == 1) {
        for (int e = tid; e < kCols * kTile; e += kThreads) {
            const int cc = e / kTile, r = e - cc * kTile;
            if (o0 + cc < M && f0 + r < L) ot[(o0 + cc) * oo + f0 + r] = result[cc * kOutPitch + r];
        }
    } else {
        for (int e = tid; e < kCols * kTile; e += kThreads) {
            const int cc = e % kCols, r = e / kCols;
            if (o0 + cc < M && f0 + r < L) ot[(o0 + cc) * oo + (f0 + r) * of] = result[cc * kOutPitch + r];
        }
    }
}

template <int WIDTH>
void launch(dim3 grid, cudaStream_t stream, const float* x, float* out, long long L, long long M,
            long long xb, long long xo, long long xf, long long ob, long long oo, long long of,
            int size) {
    median_kernel<WIDTH><<<grid, dim3(kCols, kRuns), 0, stream>>>(x, out, L, M, xb, xo, xf, ob,
                                                                  oo, of, size);
}

}  // namespace

// One launch on `stream`: the sliding median of `size` (2 .. 64) along the last axis
// (axis_last = 1) or the second-to-last axis (0) of a (batch, d, n) tensor whose element
// (b, i, k) lies at x + b * xs_b + i * xs_d + k * xs_n; the output at out + b * os_b + ...
// Returns 0, 1 for arguments the kernel does not take, or the CUDA error of a refused launch.
extern "C" int median_filter_launch(const float* x, float* out, long long batch, long long d,
                                    long long n, long long xs_b, long long xs_d, long long xs_n,
                                    long long os_b, long long os_d, long long os_n, int axis_last,
                                    int size, void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    if (batch <= 0 || d <= 0 || n <= 0 || size < 2 || size > kMaxSize) return 1;
    const long long L = axis_last ? n : d, M = axis_last ? d : n;
    const long long xf = axis_last ? xs_n : xs_d, xo = axis_last ? xs_d : xs_n;
    const long long of = axis_last ? os_n : os_d, oo = axis_last ? os_d : os_n;
    const long long tiles = (L + kTile - 1) / kTile, cols = (M + kCols - 1) / kCols;
    if (tiles > 2147483647LL || cols > 65535 || batch > 65535) return 1;
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(cols),
                    static_cast<unsigned>(batch));
    const int width = size + (size & 1);   // the sorted window plus room to centre the median
    if (width <= 4)
        launch<4>(grid, stream, x, out, L, M, xs_b, xo, xf, os_b, oo, of, size);
    else if (width <= 8)
        launch<8>(grid, stream, x, out, L, M, xs_b, xo, xf, os_b, oo, of, size);
    else if (width <= 16)
        launch<16>(grid, stream, x, out, L, M, xs_b, xo, xf, os_b, oo, of, size);
    else if (width <= 32)
        launch<32>(grid, stream, x, out, L, M, xs_b, xo, xf, os_b, oo, of, size);
    else
        launch<64>(grid, stream, x, out, L, M, xs_b, xo, xf, os_b, oo, of, size);
    return static_cast<int>(cudaGetLastError());
}
