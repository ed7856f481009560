// Wait-spaced peak selection over rows of candidate flags, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package runs this selection as two XLA
// scans vmapped over rows (librosa_tpu/ops/peaks.py: greedy_mask's
// countdown :99, dp_values' backward DP :158). Both are one dependence
// chain of T steps per row, so what bounds them on an H100 is that chain's
// latency, not bytes (a (16, 8193) batch moves 0.8 MB) or operations.
//
//   greedy_scan: take[n] = cand[n] && countdown == 0;
//                countdown = take ? wait : max(countdown - 1, 0)
//   dp_scan:     with_n = v[min(T, n + wait + 1)] + gain[n];
//                take[n] = cand[n] && with_n > v[n + 1];  (strict)
//                v[n] = take ? with_n : v[n + 1], for n = T-1 .. 0, v[T] = 0
//
// Design: one thread per row, rows in warps of 32. The countdown and v[n + 1]
// are register carries. v, whose reach back (wait) is not bounded, lives in a
// (rows, T + 1) float32 scratch in device memory that each thread writes and
// reads for its own row only; where wait is 0, v[n + 1] is the register. The
// candidate flags and gains are read through the read-only cache. Additions
// are __fadd_rn, in the order of ops/peaks.py's plain loops, so both agree to
// the bit. A third entry point runs only the chains, on flags made in
// registers, for the bound: the least time T dependent steps take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 32;

__global__ void greedy_scan_kernel(const uint8_t* __restrict__ cand, uint8_t* __restrict__ out,
                                   int64_t rows, int64_t T, int wait) {
  const int64_t r = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (r >= rows) return;
  const uint8_t* c = cand + r * T;
  uint8_t* o = out + r * T;
  int countdown = 0;
#pragma unroll 8
  for (int64_t n = 0; n < T; ++n) {
    const bool take = __ldg(c + n) != 0 && countdown == 0;
    o[n] = take;
    countdown = take ? wait : max(countdown - 1, 0);
  }
}

__global__ void dp_scan_kernel(const uint8_t* __restrict__ cand, const float* __restrict__ gain,
                               float* __restrict__ values, uint8_t* __restrict__ taken,
                               int64_t rows, int64_t T, int64_t wait) {
  const int64_t r = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (r >= rows) return;
  const uint8_t* c = cand + r * T;
  const float* g = gain + r * T;
  float* v = values + r * (T + 1);
  uint8_t* t = taken + r * T;
  v[T] = 0.0f;
  float next = 0.0f;  // v[n + 1]
  for (int64_t n = T - 1; n >= 0; --n) {
    const int64_t j = min(T, n + wait + 1);
    const float reach = j == n + 1 ? next : v[j];
    const float with_n = __fadd_rn(reach, __ldg(g + n));
    const bool take = __ldg(c + n) != 0 && with_n > next;
    t[n] = take;
    next = take ? with_n : next;
    v[n] = next;
  }
}

// The chains alone: T steps of each scan's carry on flags drawn from a register
// pattern, no memory traffic but one word a row at the end.
__global__ void chain_probe_kernel(int64_t rows, int64_t T, int wait, int dp, float* out) {
  const int64_t r = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (r >= rows) return;
  uint32_t pattern = 0x9e3779b9u * (uint32_t)(r + 1);
  if (!dp) {
    int countdown = 0, count = 0;
    for (int64_t n = 0; n < T; ++n) {
      const bool take = ((pattern >> (n & 31)) & 1u) && countdown == 0;
      count += take;
      countdown = take ? wait : max(countdown - 1, 0);
    }
    out[r] = (float)(count + countdown);
  } else {
    float next = 0.0f, reach = 0.0f;
    for (int64_t n = T - 1; n >= 0; --n) {
      const float with_n = __fadd_rn(reach, 1.0f);
      const bool take = ((pattern >> (n & 31)) & 1u) && with_n > next;
      next = take ? with_n : next;
      reach = (n & 7) == 0 ? next : reach;  // a value from steps ago, as v[n + wait + 1] is
    }
    out[r] = next;
  }
}

unsigned blocks_for(int64_t rows) {
  return (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

int launch_checked(int64_t rows) {
  if (rows <= 0 || (rows + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  return 0;
}

}  // namespace

// cand, out: (rows, T) bytes of 0 or 1 (torch.bool), row-major. Returns
// cudaGetLastError() (0 on success).
extern "C" int greedy_scan_launch(const void* cand, void* out, long long rows, long long T,
                                  int wait, void* stream) {
  if (int err = launch_checked(rows)) return err;
  if (wait < 0) return (int)cudaErrorInvalidValue;
  greedy_scan_kernel<<<blocks_for(rows), kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cand, (uint8_t*)out, rows, T, wait);
  return (int)cudaGetLastError();
}

// cand, taken: (rows, T) bytes of 0 or 1; gain float32 (rows, T); values float32
// scratch (rows, T + 1). Returns cudaGetLastError() (0 on success).
extern "C" int dp_scan_launch(const void* cand, const float* gain, float* values, void* taken,
                              long long rows, long long T, long long wait, void* stream) {
  if (int err = launch_checked(rows)) return err;
  if (wait < 0) return (int)cudaErrorInvalidValue;
  dp_scan_kernel<<<blocks_for(rows), kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cand, gain, values, (uint8_t*)taken, rows, T, wait);
  return (int)cudaGetLastError();
}

// The chain probe: `dp` 0 for the countdown, 1 for the DP's compare and select;
// out float32 (rows,). Returns cudaGetLastError() (0 on success).
extern "C" int peak_chain_probe_launch(long long rows, long long T, int wait, int dp, float* out,
                                       void* stream) {
  if (int err = launch_checked(rows)) return err;
  chain_probe_kernel<<<blocks_for(rows), kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      rows, T, wait, dp, out);
  return (int)cudaGetLastError();
}
