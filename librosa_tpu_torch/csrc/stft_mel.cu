// Fused |STFT(y)|^power projected onto a dense basis, for sm_90a.
//
// Replaces the TPU kernel librosa_tpu/ops/pallas_stft.py:_kernel (reached
// through stft_mel_pallas). It computes the same function, not the same
// blocks:
//
//   out[track, m, t] = sum_k basis[m, k] * |X_t[k]|^power,
//   X_t = rfft(window * padded(y[track])[t*hop : t*hop + n_fft])
//
// for k in [0, n_fft/2]. Centre padding ("constant" zeros or "reflect") is
// synthesised by index, so no padded copy of the signal exists.
//
// What bounds it on an H100: bytes and operations about equally. Each
// frame moves hop samples in and n_out values out (2.5 KB at n_fft 2048 /
// hop 512 / 128 mels) against the work the function needs
// (ops/fused_stft.py:flops_per_frame): a real FFT, 2.5 n log2 n flops, and
// the projection through the basis's nonzeros, ~2 per bin for a mel basis.
// That is ~26 flops per byte, near the card's float32 balance of ~20.
// This kernel does about six times that work: a complex FFT of real input
// (twice the real FFT) and a dense projection through the zeros of a
// banded basis (n_out * (1 + n_fft/2) multiply-adds per frame). A
// real-input FFT and a banded projection are the next speed steps.
//
// Design, one block per (track, tile of `tt` frames), one warp per frame:
//   1. The block copies its tile's span of samples, (tt-1)*hop + n_fft of
//      them, into shared memory once (frames overlap), writing the centre
//      padding and zeros past the end by index. It also stages the FFT
//      twiddles (made in float64 on the host, rounded to float32).
//   2. Each warp windows its frame into a complex buffer in bit-reversed
//      order and runs an in-place radix-2 FFT over log2(n_fft) stages,
//      synchronising with __syncwarp only: no frame leaves the SM.
//   3. Each warp replaces bins 0..n_fft/2 of its real part by |X|^power.
//   4. After one __syncthreads, each thread projects one basis row onto
//      four of the tile's frames, reading the transposed basis (k, m) so a
//      warp's loads are coalesced, and writes (track, m, t) directly.
// Frames, spectra and power spectra live only in shared memory. All
// arithmetic is float32 (no TF32, no bf16); indices into device memory are
// 64-bit. Speed is not tuned yet: wgmma for the projection, TMA for the
// span, and a persistent schedule are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFramesPerThread = 4;  // frames one thread projects at once
constexpr int kChunk = 64;           // bins summed before adding to the total

__global__ void stft_mel_kernel(
    const float* __restrict__ y, const float* __restrict__ win,
    const float* __restrict__ twiddle, const float* __restrict__ basis_t,
    float* __restrict__ out, int64_t sig_len, int64_t n_frames,
    int n_fft, int log2_n, int hop, int64_t lpad, int reflect, int n_out,
    int tt, int64_t tiles_per_track, float power) {
  extern __shared__ float smem[];
  const int N = n_fft;
  const int span_len = (tt - 1) * hop + N;
  float* frames = smem;                              // tt x (re[N], im[N])
  float* span = frames + (size_t)tt * 2 * N;         // span_len samples
  float* tw_re = span + span_len;                    // cos(2 pi k / N)
  float* tw_im = tw_re + N / 2;                      // -sin(2 pi k / N)

  const int64_t track = blockIdx.x / tiles_per_track;
  const int64_t t0 = (blockIdx.x % tiles_per_track) * tt;
  const int64_t p0 = t0 * hop;  // padded-signal index of span[0]
  const float* yt = y + track * sig_len;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // 1. the tile's samples, padding synthesised by index
  for (int i = tid; i < span_len; i += nthreads) {
    const int64_t p = p0 + i;
    int64_t src = -1;
    if (p < lpad) {
      if (reflect) src = lpad - p;
    } else if (p < lpad + sig_len) {
      src = p - lpad;
    } else if (p < 2 * lpad + sig_len) {
      if (reflect) src = 2 * sig_len - 2 - (p - lpad);
    }
    span[i] = src >= 0 ? yt[src] : 0.0f;
  }
  for (int i = tid; i < N / 2; i += nthreads) {
    tw_re[i] = twiddle[i];
    tw_im[i] = twiddle[N / 2 + i];
  }
  __syncthreads();

  // 2. one warp per frame: window, bit-reverse, radix-2 FFT in place
  const int warp = tid >> 5, lane = tid & 31;
  float* re = frames + (size_t)warp * 2 * N;
  float* im = re + N;
  const float* x = span + (size_t)warp * hop;
  for (int n = lane; n < N; n += 32) {
    const int r = (int)(__brev((unsigned)n) >> (32 - log2_n));
    re[r] = x[n] * win[n];
    im[r] = 0.0f;
  }
  __syncwarp();
  for (int half = 1, stride = N / 2; half < N; half <<= 1, stride >>= 1) {
    for (int b = lane; b < N / 2; b += 32) {
      const int j = b & (half - 1);
      const int i0 = ((b - j) << 1) + j;
      const int i1 = i0 + half;
      const float wr = tw_re[j * stride], wi = tw_im[j * stride];
      const float xr = re[i1], xi = im[i1];
      const float vr = xr * wr - xi * wi;
      const float vi = xr * wi + xi * wr;
      const float ur = re[i0], ui = im[i0];
      re[i0] = ur + vr;
      im[i0] = ui + vi;
      re[i1] = ur - vr;
      im[i1] = ui - vi;
    }
    __syncwarp();
  }

  // 3. |X|^power over bins 0..N/2, into the real part (each bin is read
  //    and written by the same lane)
  for (int k = lane; k <= N / 2; k += 32) {
    const float a = re[k], b = im[k];
    float pw = a * a + b * b;
    if (power == 1.0f) {
      pw = sqrtf(pw);
    } else if (power != 2.0f) {
      pw = powf(pw, 0.5f * power);
    }
    re[k] = pw;
  }
  __syncthreads();

  // 4. basis projection: thread -> (row m, group g of 4 frames)
  const int n_bins = N / 2 + 1;
  const int groups = (tt + kFramesPerThread - 1) / kFramesPerThread;
  for (int o = tid; o < n_out * groups; o += nthreads) {
    const int m = o % n_out, g = o / n_out;
    const float* pf[kFramesPerThread];
#pragma unroll
    for (int f = 0; f < kFramesPerThread; ++f) {
      const int fr = min(g * kFramesPerThread + f, tt - 1);
      pf[f] = frames + (size_t)fr * 2 * N;
    }
    float total[kFramesPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < n_bins; k0 += kChunk) {
      const int k1 = min(k0 + kChunk, n_bins);
      float part[kFramesPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float w = basis_t[(int64_t)k * n_out + m];
#pragma unroll
        for (int f = 0; f < kFramesPerThread; ++f) part[f] = fmaf(w, pf[f][k], part[f]);
      }
#pragma unroll
      for (int f = 0; f < kFramesPerThread; ++f) total[f] += part[f];
    }
#pragma unroll
    for (int f = 0; f < kFramesPerThread; ++f) {
      const int fr = g * kFramesPerThread + f;
      const int64_t t = t0 + fr;
      if (fr < tt && t < n_frames) {
        out[(track * n_out + m) * n_frames + t] = total[f];
      }
    }
  }
}

constexpr int kMaxDevices = 64;
int g_smem_limit[kMaxDevices];  // largest dynamic shared memory allowed so far, per device

}  // namespace

// Launch on `stream` with `smem` bytes of dynamic shared memory per block
// (ops/fused_stft.py:_smem_bytes). Returns cudaGetLastError() (0 on success).
extern "C" int stft_mel_launch(
    const float* y, const float* win, const float* twiddle,
    const float* basis_t, float* out, long long n_tracks, long long sig_len,
    long long n_frames, int n_fft, int hop, long long lpad, int reflect,
    int n_out, int tt, float power, int smem, void* stream) {
  int log2_n = 0;
  while ((1 << log2_n) < n_fft) ++log2_n;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > g_smem_limit[device]) {  // raised only when a larger size first comes
    err = cudaFuncSetAttribute(
        stft_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    g_smem_limit[device] = smem;
  }
  const long long tiles = (n_frames + tt - 1) / tt;
  const long long blocks = tiles * n_tracks;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  stft_mel_kernel<<<(unsigned)blocks, 32 * tt, (size_t)smem, (cudaStream_t)stream>>>(
      y, win, twiddle, basis_t, out, sig_len, n_frames, n_fft, log2_n, hop,
      lpad, reflect, n_out, tt, tiles, power);
  return (int)cudaGetLastError();
}
