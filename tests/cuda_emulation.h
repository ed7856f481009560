// CUDA's device built-ins and runtime calls for running a kernel source on the CPU under g++
// (C++20): one std::thread per CUDA thread, blocks one after another, barriers for the block and
// warp synchronisations, and warp collectives by an exchange through a per-warp buffer. A lane
// that skips a collective its warp calls deadlocks here, as it would hang on the card.
//
// Include it before the kernel's source (g++ -include), with the source's
//   extern __shared__ ... smem[];      replaced by   unsigned char* smem = emu_smem_base;
//   kernel<<<grid, block, smem, s>>>(args);   by   emu_launch(grid, block, smem, s, [=]() { kernel(args); });
// and the source's #include <cuda_runtime.h> satisfied by this file's directory or an empty one.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __align__(n) alignas(n)
#define __shared__

using std::max;
using std::min;

struct alignas(8) float2 {
    float x, y;
};
struct alignas(16) float4 {
    float x, y, z, w;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

struct EmuDim {
    unsigned x = 0, y = 1, z = 1;
};
inline thread_local EmuDim threadIdx, blockIdx;
inline EmuDim blockDim, gridDim;

struct EmuWarp {
    std::unique_ptr<std::barrier<>> bar;
    unsigned long long slot[32];
};
inline std::unique_ptr<std::barrier<>> emu_block_bar;
inline std::vector<EmuWarp> emu_warps;

inline void __syncthreads() { emu_block_bar->arrive_and_wait(); }
inline EmuWarp& emu_warp() { return emu_warps[threadIdx.x / 32]; }
inline unsigned emu_lane() { return threadIdx.x % 32; }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp().bar->arrive_and_wait(); }

// every lane's value, as bits
template <class V>
inline void emu_gather(V v, unsigned long long* all) {
    static_assert(sizeof(V) <= 8, "a lane's value is at most 8 bytes");
    EmuWarp& w = emu_warp();
    unsigned long long bits = 0;
    std::memcpy(&bits, &v, sizeof(V));
    w.bar->arrive_and_wait();  // every lane has read the last exchange
    w.slot[emu_lane()] = bits;
    w.bar->arrive_and_wait();
    std::memcpy(all, w.slot, sizeof(w.slot));
}

template <class V>
inline V emu_from(V v, unsigned src) {
    unsigned long long all[32];
    emu_gather(v, all);
    V out;
    std::memcpy(&out, &all[src % 32], sizeof(V));
    return out;
}

template <class V>
inline V __shfl_sync(unsigned, V v, int src) { return emu_from(v, static_cast<unsigned>(src)); }
template <class V>
inline V __shfl_xor_sync(unsigned, V v, int mask) { return emu_from(v, emu_lane() ^ mask); }
template <class V>
inline V __shfl_up_sync(unsigned, V v, unsigned delta) {
    const unsigned lane = emu_lane();
    return emu_from(v, lane >= delta ? lane - delta : lane);
}
inline unsigned __ballot_sync(unsigned, int pred) {
    unsigned long long all[32];
    emu_gather(static_cast<int>(pred != 0), all);
    unsigned b = 0;
    for (int l = 0; l < 32; ++l) b |= (all[l] & 1ull) << l;
    return b;
}
inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0; }
inline int __reduce_min_sync(unsigned, int v) {
    unsigned long long all[32];
    emu_gather(v, all);
    int out = INT_MAX;
    for (int l = 0; l < 32; ++l) {
        int x;
        std::memcpy(&x, &all[l], sizeof(int));
        out = std::min(out, x);
    }
    return out;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class V>
inline V __ldg(const V* p) { return *p; }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// the kernel's dynamic shared memory, filled with a marker before each block
inline unsigned char* emu_smem_base = nullptr;

inline void emu_launch(unsigned grid, unsigned threads, size_t smem, cudaStream_t,
                       const std::function<void()>& body) {
    std::vector<unsigned char> smem_buf(smem + 16);
    blockDim.x = threads;
    gridDim.x = grid;
    for (unsigned b = 0; b < grid; ++b) {
        std::fill(smem_buf.begin(), smem_buf.end(), 0xA5);
        emu_smem_base = smem_buf.data();
        emu_block_bar = std::make_unique<std::barrier<>>(threads);
        emu_warps = std::vector<EmuWarp>(threads / 32);
        for (auto& w : emu_warps) w.bar = std::make_unique<std::barrier<>>(32);
        std::vector<std::thread> pool;
        for (unsigned t = 0; t < threads; ++t) {
            pool.emplace_back([&, t, b] {
                threadIdx.x = t;
                blockIdx.x = b;
                body();
            });
        }
        for (auto& th : pool) th.join();
    }
}
