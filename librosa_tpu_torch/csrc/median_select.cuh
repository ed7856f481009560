// The selection core of the sliding median: order keys, mirrored indices and the grouped
// selection that csrc/median_filter.cu runs in each thread. It is plain C++ behind the CUDA
// qualifiers (__device__ where a function calls a CUDA intrinsic), so that a host compiler
// can run the same code against the plain version: tests/test_torch_median_select.py
// defines the qualifiers and the three intrinsics it uses.
//
// Keys. A float becomes a 32-bit key whose unsigned order is the sort's order: -inf .. +inf,
// then every NaN (kNaN), with -0 first turned into +0. kLow and kHigh lie below and above
// every key.
//
// Sentinels. A window of `size` keys is completed to W = size rounded up to a multiple of 4
// keys by W/2 - size/2 copies of kLow and the rest kHigh. The median of the window (the
// order statistic of rank size/2, the upper middle one for an even size) is then the key of
// rank W/2 of the completed window, whatever the size: every register index below is known
// at compile time, and nothing is indexed at run time.
//
// Grouped selection. K adjacent outputs o .. o+K-1 (K a power of two fixed by W) share a
// core of size-K+1 keys, the positions o+K-1 .. o+size-1. With the sentinels the core holds
// C = W-K+1 keys. It is sorted once per group (Batcher's odd-even merge sort; constant kHigh
// pads fold away). Each output adds K-1 keys of its own, so only the K keys of rank
// W/2-K+1 .. W/2 of the core can be its median: that band is all that is kept. Then the
// group halves, recursively: the left half of a group of G outputs shares G/2 more keys on
// the left, the right half G/2 more on the right; each half sorts its G/2 keys, merges them
// with the band (one odd-even merge) and keeps the G/2 keys of ranks G/2 .. G-1, which is
// the new band. A group of one output has a band of one key: its median.
//
// Counted after constant folding and dead-code elimination, for size 31 (W 32, K 16) this is
// about 37 minimum/maximum operations per output, against some 190 integer operations per
// output of one delete-and-insert pass over a sorted 32-key window (and the 31 insertions
// that start each run of it).

#pragma once

#include <stdint.h>

#include <type_traits>

namespace median {

constexpr uint32_t kLow = 0u;             // below every key
constexpr uint32_t kHigh = 0xFFFFFFFFu;   // above every key
constexpr uint32_t kNaN = 0xFFFFFFFEu;    // every NaN: above +inf

constexpr int kMaxSize = 64;

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
__host__ __device__ __forceinline__ long long mirror(long long i, long long n) {
    if (i >= 0 && i < n) return i;
    const long long period = 2 * n;
    long long m = i % period;
    if (m < 0) m += period;
    return m < n ? m : period - 1 - m;
}

// the completed window's width for a window of `size` keys (2 .. 64)
__host__ __device__ constexpr int window_width(int size) { return size <= 4 ? 4 : (size + 3) & ~3; }

// outputs that share one sorted core, for a completed window of W keys (fewest operations
// per output by the count in the header)
__host__ __device__ constexpr int group_size(int W) {
    return W <= 4 ? 1 : W <= 12 ? 4 : W <= 28 ? 8 : W <= 60 ? 16 : 32;
}

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

__host__ __device__ __forceinline__ void exchange(uint32_t& a, uint32_t& b) {
    const uint32_t lo = a < b ? a : b;
    b = a < b ? b : a;
    a = lo;
}

// Batcher's odd-even merge of s[LO .. LO+N), whose two halves are sorted, in steps of R
template <int LO, int N, int R, int P>
__host__ __device__ __forceinline__ void oe_merge(uint32_t (&s)[P]) {
    constexpr int M = 2 * R;
    if constexpr (M < N - 1) {
        oe_merge<LO, N, M>(s);
        oe_merge<LO + R, N, M>(s);
#pragma unroll
        for (int i = LO + R; i + R < LO + N - 1; i += M) exchange(s[i], s[i + R]);
    } else {
        exchange(s[LO], s[LO + R]);
    }
}

// Batcher's odd-even merge sort of s[LO .. LO+N), N a power of two
template <int LO, int N, int P>
__host__ __device__ __forceinline__ void oe_sort(uint32_t (&s)[P]) {
    if constexpr (N > 1) {
        oe_sort<LO, N / 2>(s);
        oe_sort<LO + N / 2, N / 2>(s);
        oe_merge<LO, N, 1>(s);
    }
}

// keys of ranks G/2 .. G-1 of the union of sorted `band` (G keys) and sorted `add` (G/2 keys)
template <int G>
__host__ __device__ __forceinline__ void merge_band(const uint32_t (&band)[G],
                                                    const uint32_t (&add)[G / 2],
                                                    uint32_t (&out)[G / 2]) {
    uint32_t r[2 * G];
#pragma unroll
    for (int i = 0; i < G; ++i) r[i] = band[i];
#pragma unroll
    for (int i = 0; i < G; ++i) r[G + i] = i < G / 2 ? add[i] : kHigh;
    oe_merge<0, 2 * G, 1>(r);
#pragma unroll
    for (int i = 0; i < G / 2; ++i) out[i] = r[G / 2 + i];
}

// The medians of outputs P0 .. P0+G-1 of a group into med[P0 ..]: `band` holds the G keys
// that can still be their medians, `row` the keys from the group's first window on, `right`
// = row + size.
template <int K, int G, int P0>
__host__ __device__ __forceinline__ void descend(const uint32_t (&band)[G], const uint32_t* row,
                                                 const uint32_t* right, uint32_t (&med)[K]) {
    if constexpr (G == 1) {
        med[P0] = band[0];
    } else {
        constexpr int H = G / 2;
        uint32_t add[H], sub[H];
        // the left half's windows share the keys at P0+H-1 .. P0+G-2 beyond the group's
#pragma unroll
        for (int t = 0; t < H; ++t) add[t] = row[P0 + H - 1 + t];
        oe_sort<0, H>(add);
        merge_band<G>(band, add, sub);
        descend<K, H, P0>(sub, row, right, med);
        // the right half's windows share the keys at P0+size .. P0+size+H-1
#pragma unroll
        for (int t = 0; t < H; ++t) add[t] = right[P0 + t];
        oe_sort<0, H>(add);
        merge_band<G>(band, add, sub);
        descend<K, H, P0 + H>(sub, row, right, med);
    }
}

// The medians of the K windows that start at row[0 .. K-1], as keys. Reads row[0 .. W-1] and
// row[0 .. K+size-2]; keys beyond the windows are read and dropped.
template <int W>
__host__ __device__ __forceinline__ void group_medians(const uint32_t* row, int size,
                                                       uint32_t (&med)[group_size(W)]) {
    constexpr int K = group_size(W);
    constexpr int C = W - K + 1;                  // core keys, sentinels included
    constexpr int P = pow2_at_least(C);
    constexpr int SURE = (W == 4 ? 2 : W - 3) - K + 1;  // core keys inside every window of the class
    const int real = size - K + 1, lows = W / 2 - size / 2;
    uint32_t c[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
        if (i < SURE) {
            c[i] = row[K - 1 + i];
        } else if (i < C) {
            const uint32_t k = row[K - 1 + i];
            c[i] = i < real ? k : (i < real + lows ? kLow : kHigh);
        } else {
            c[i] = kHigh;
        }
    }
    oe_sort<0, P>(c);
    uint32_t band[K];
#pragma unroll
    for (int i = 0; i < K; ++i) band[i] = c[W / 2 - K + 1 + i];
    descend<K, K, 0>(band, row, row + size, med);
}

// One thread's run: out[j], j < count, is the median of row[j .. j+size-1]. `nan_rule` (an odd
// size and a NaN somewhere in the keys) turns every window that holds a NaN into NaN.
template <int W>
__device__ __forceinline__ void median_run(const uint32_t* row, int size, int count,
                                                    float* out, bool nan_rule) {
    constexpr int K = group_size(W);
#pragma unroll 1
    for (int g = 0; g < count; g += K) {
        uint32_t med[K];
        group_medians<W>(row + g, size, med);
#pragma unroll
        for (int j = 0; j < K; ++j)
            if (g + j < count) out[g + j] = from_key(med[j]);
    }
    if (nan_rule) {
        int nans = 0;
        for (int j = 0; j < size - 1; ++j) nans += row[j] == kNaN;
        for (int j = 0; j < count; ++j) {
            nans += row[j + size - 1] == kNaN;
            if (nans) out[j] = from_key(kNaN);
            nans -= row[j] == kNaN;
        }
    }
}

// f(std::integral_constant<int, W>{}) for the completed width W of `size` (2 .. 64)
template <class F>
inline void with_width(int size, F&& f) {
    switch (window_width(size)) {
        case 4: f(std::integral_constant<int, 4>{}); break;
        case 8: f(std::integral_constant<int, 8>{}); break;
        case 12: f(std::integral_constant<int, 12>{}); break;
        case 16: f(std::integral_constant<int, 16>{}); break;
        case 20: f(std::integral_constant<int, 20>{}); break;
        case 24: f(std::integral_constant<int, 24>{}); break;
        case 28: f(std::integral_constant<int, 28>{}); break;
        case 32: f(std::integral_constant<int, 32>{}); break;
        case 36: f(std::integral_constant<int, 36>{}); break;
        case 40: f(std::integral_constant<int, 40>{}); break;
        case 44: f(std::integral_constant<int, 44>{}); break;
        case 48: f(std::integral_constant<int, 48>{}); break;
        case 52: f(std::integral_constant<int, 52>{}); break;
        case 56: f(std::integral_constant<int, 56>{}); break;
        case 60: f(std::integral_constant<int, 60>{}); break;
        default: f(std::integral_constant<int, 64>{}); break;
    }
}

}  // namespace median
