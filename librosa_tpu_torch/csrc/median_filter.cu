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
// once, so bytes (0.32 ms for |STFT| of 16 tracks at n_fft 2048). What a kernel
// spends beyond that is the selection's integer operations, so the design
// keeps those few:
//
//   - a block owns 32 columns (positions of the other axis, one per lane) by a
//     tile of 128 positions of the filter axis. The columns run over the batch
//     and the other axis together, so the last block of a 1025-position axis
//     is not a block of one column. The block stages its tile and the size-1
//     halo in shared memory once, as 32-bit order keys, with the mirrored
//     indices resolved as it loads, reading along whichever axis is contiguous
//     in memory; the span stops where the tile's last output needs it, so a
//     tile that holds one output stages one window;
//   - each thread owns one column and a run of 32 consecutive outputs. It
//     computes them in groups of K (median_select.cuh): one sorting network
//     over the keys the group's windows share, then halving merges with each
//     half's own keys, all in registers indexed at compile time. For size 31
//     that is about 37 minimum/maximum operations per output (one delete-and-
//     insert pass over a sorted 32-key window, the earlier design, took about
//     190 with its run's first sort);
//   - the outputs go through shared memory too and are stored along whichever
//     axis of the output is contiguous.
//
// Nothing is copied to the host and nothing needs initialising.

#include <cuda_runtime.h>
#include <stdint.h>

#include "median_select.cuh"

namespace {

using median::kMaxSize;
using median::kNaN;

constexpr int kCols = 32;        // columns per block (one per lane)
constexpr int kRuns = 4;         // runs along the filter axis per block (one per warp)
constexpr int kRun = 32;         // outputs per thread: a multiple of every group size
constexpr int kTile = kRuns * kRun;
constexpr int kThreads = kCols * kRuns;
// shared rows: the tile, its halo, and room for the keys a group reads past its last window;
// odd pitches keep the lanes' rows in distinct banks
constexpr int kInPitch = kTile + kMaxSize - 1;   // 191
constexpr int kOutPitch = kTile + 1;             // 129

// filter axis: length L, strides xf / of. Columns: q = b * M + o over Q = B * M, with
// strides xb, xo / ob, oo. Blocks: tile fastest, then groups of 32 columns.
template <int W>
__global__ void __launch_bounds__(kThreads)
median_kernel(const float* __restrict__ x, float* __restrict__ out, long long L, long long M,
              long long Q, long long xb, long long xo, long long xf, long long ob, long long oo,
              long long of, int size, int tiles) {
    __shared__ uint32_t keys[kCols * kInPitch];
    __shared__ float result[kCols * kOutPitch];
    __shared__ long long xcol[kCols], ocol[kCols];

    const int lane = threadIdx.x, warp = threadIdx.y;
    const long long f0 = static_cast<long long>(blockIdx.x % tiles) * kTile;
    const long long q0 = static_cast<long long>(blockIdx.x / tiles) * kCols;
    const int n = static_cast<int>(min(static_cast<long long>(kTile), L - f0));  // outputs
    const int cols = static_cast<int>(min(static_cast<long long>(kCols), Q - q0));
    const int half = size / 2, span = n + size - 1;

    if (warp == 0) {
        const long long q = q0 + lane, b = q / M, o = q - b * M;
        xcol[lane] = b * xb + o * xo;
        ocol[lane] = b * ob + o * oo;
    }
    __syncthreads();

    // stage the tile and its halo as keys, reading along the contiguous axis
    bool nan_seen = false;
    if (xf == 1) {
        for (int c = warp; c < cols; c += kRuns) {
            const float* src = x + xcol[c];
            for (int j = lane; j < span; j += kCols) {
                const uint32_t k = median::to_key(__ldg(src + median::mirror(f0 - half + j, L)));
                keys[c * kInPitch + j] = k;
                nan_seen |= k == kNaN;
            }
        }
    } else if (lane < cols) {
        const float* src = x + xcol[lane];
        for (int j = warp; j < span; j += kRuns) {
            const uint32_t k = median::to_key(__ldg(src + median::mirror(f0 - half + j, L) * xf));
            keys[lane * kInPitch + j] = k;
            nan_seen |= k == kNaN;
        }
    }
    // an odd window with a NaN gives NaN: counted only where the tile holds one
    const bool nan_rule = __syncthreads_or(nan_seen) && (size & 1);

    const int r0 = warp * kRun;
    if (lane < cols && r0 < n)
        median::median_run<W>(keys + lane * kInPitch + r0, size, min(kRun, n - r0),
                              result + lane * kOutPitch + r0, nan_rule);
    __syncthreads();

    // store the tile along the output's contiguous axis
    if (of == 1) {
        for (int c = warp; c < cols; c += kRuns) {
            float* dst = out + ocol[c] + f0;
            for (int r = lane; r < n; r += kCols) dst[r] = result[c * kOutPitch + r];
        }
    } else if (lane < cols) {
        float* dst = out + ocol[lane];
        for (int r = warp; r < n; r += kRuns) dst[(f0 + r) * of] = result[lane * kOutPitch + r];
    }
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
    const long long tiles = (L + kTile - 1) / kTile, groups = (batch * M + kCols - 1) / kCols;
    if (tiles * groups > 2147483647LL) return 1;
    const dim3 grid(static_cast<unsigned>(tiles * groups)), block(kCols, kRuns);
    median::with_width(size, [&](auto w) {
        median_kernel<decltype(w)::value><<<grid, block, 0, stream>>>(
            x, out, L, M, batch * M, xs_b, xo, xf, os_b, oo, of, size, static_cast<int>(tiles));
    });
    return static_cast<int>(cudaGetLastError());
}
