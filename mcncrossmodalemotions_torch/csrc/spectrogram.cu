// K1: fused pre-emphasis + framing + Hamming-windowed DFT magnitude.
//
// Replaces the TPU kernel mcncrossmodalemotions_tpu/ops/pallas_spectrogram.py
// (spectrogram_pallas, body _kernel). Same function, not the same layout:
// the Mosaic kernel's three row-shifted DMA copies and its 3x256-row padded
// DFT matrices existed to keep TPU slices tile-aligned; none of that is
// needed here.
//
//   out[b, k, t] = | sum_i y[b, t*hop + i] * W[i] * exp(-2*pi*j*i*k/nfft) |
//   y[n] = x[n] - alpha * x[n-1],  y[0] = x[0]          (pre-emphasis)
//
// for the nfft/2+1 non-redundant bins; bin nfft-k is stored as a mirror of
// bin k, so the output is the full [B, nfft, T] float32, freq-major.
//
// What bounds it on the card: arithmetic. 2 * 257 * 400 FMAs per frame
// against 160 new input samples and 512 output floats per frame, so the
// work is ~100 FMAs per byte moved. This first version uses plain fp32
// FFMA (no TF32, no tensor cores), register-tiled:
//  - one block per (utterance, tile of FT frames, tile of KT bins); the
//    tile's waveform span ((FT-1)*hop + win samples) is loaded from device
//    memory once, pre-emphasised on the way, and kept in shared memory,
//    because frames overlap 2.5x. No frames tensor is ever written;
//  - the windowed cos/sin matrices ([win, nfft/2+1] each, built in float64
//    on the host and cast to fp32; the plain version's [win, cos|sin]
//    matrix, so leading dimension ld) are read from device memory
//    (L2-resident, 0.8 MB) in chunks of ICH rows staged through shared
//    memory;
//  - each thread accumulates 4 frames x 4 bins x (re, im) in registers;
//  - the span is stored with one padding word every 32 samples so that the
//    16 frames a half-warp reads (160 samples apart, a multiple of 32 banks)
//    fall on distinct banks;
//  - the Nyquist bin (k = nfft/2) is one extra block column in which four
//    threads share each frame, instead of a whole KT-wide tile for one bin.
// Making it fast (mma.sync 3xTF32 or wgmma) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 64;        // frames per block
constexpr int KT = 64;        // bins per block
constexpr int ICH = 8;        // DFT-matrix rows staged per step
constexpr int THREADS = 256;  // 16 frame lanes x 16 bin lanes

__host__ __device__ __forceinline__ int pad_idx(int n) { return n + (n >> 5); }

__global__ void __launch_bounds__(THREADS)
spectrogram_kernel(const float* __restrict__ x, const float* __restrict__ cosm,
                   const float* __restrict__ sinm, float* __restrict__ out,
                   int n, int t_frames, int win, int hop, int nfft, int ld,
                   float alpha) {
  extern __shared__ float smem[];
  const int half = nfft / 2;
  const int span = (FT - 1) * hop + win;
  float* ys = smem;                         // pre-emphasised waveform span
  float* cs = smem + pad_idx(span - 1) + 1; // [ICH][KT] cos chunk
  float* ss = cs + ICH * KT;                // [ICH][KT] sin chunk

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * FT;
  const float* xb = x + (size_t)b * n;
  const int s0 = t0 * hop;
  for (int j = threadIdx.x; j < span; j += THREADS) {
    const int s = s0 + j;
    float v = 0.f;  // past the end: only frames t >= t_frames read it
    if (s < n) {
      v = xb[s];
      if (s > 0) v -= alpha * xb[s - 1];
    }
    ys[pad_idx(j)] = v;
  }

  if (blockIdx.y == gridDim.y - 1) {
    // Nyquist column: 4 threads per frame, i = q, q+4, ...; then reduce.
    __syncthreads();
    const int f = threadIdx.x >> 2, q = threadIdx.x & 3;
    const int base = f * hop;
    float re = 0.f, im = 0.f;
    for (int i = q; i < win; i += 4) {
      const float y = ys[pad_idx(base + i)];
      re = fmaf(y, cosm[(size_t)i * ld + half], re);
      im = fmaf(y, sinm[(size_t)i * ld + half], im);
    }
    for (int off = 1; off < 4; off <<= 1) {
      re += __shfl_xor_sync(0xffffffffu, re, off);
      im += __shfl_xor_sync(0xffffffffu, im, off);
    }
    const int t = t0 + f;
    if (q == 0 && t < t_frames)
      out[((size_t)b * nfft + half) * t_frames + t] = sqrtf(re * re + im * im);
    return;
  }

  const int k0 = blockIdx.y * KT;
  const int tx = threadIdx.x & 15;  // frames tx + 16*j
  const int ty = threadIdx.x >> 4;  // bins k0 + ty + 16*m
  float re[4][4], im[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int m = 0; m < 4; ++m) re[j][m] = im[j][m] = 0.f;

  for (int i0 = 0; i0 < win; i0 += ICH) {
    __syncthreads();  // span staged / previous chunk consumed
    for (int e = threadIdx.x; e < ICH * KT; e += THREADS) {
      const size_t g = (size_t)(i0 + e / KT) * ld + k0 + e % KT;
      cs[e] = cosm[g];
      ss[e] = sinm[g];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ICH; ++r) {
      float yv[4], cv[4], sv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        yv[j] = ys[pad_idx((tx + 16 * j) * hop + i0 + r)];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        cv[m] = cs[r * KT + ty + 16 * m];
        sv[m] = ss[r * KT + ty + 16 * m];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          re[j][m] = fmaf(yv[j], cv[m], re[j][m]);
          im[j][m] = fmaf(yv[j], sv[m], im[j][m]);
        }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int t = t0 + tx + 16 * j;
    if (t >= t_frames) continue;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int k = k0 + ty + 16 * m;
      const float mag = sqrtf(re[j][m] * re[j][m] + im[j][m] * im[j][m]);
      out[((size_t)b * nfft + k) * t_frames + t] = mag;
      if (k > 0) out[((size_t)b * nfft + (nfft - k)) * t_frames + t] = mag;
    }
  }
}

}  // namespace

// x [batch, n] float32 (decoded); cosm/sinm [win, nfft/2+1] float32 with
// row stride ld; out [batch, nfft, t_frames] float32. Launches on
// `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int spectrogram_f32(const float* x, const float* cosm,
                               const float* sinm, float* out, int batch, int n,
                               int t_frames, int win, int hop, int nfft,
                               int ld, float alpha, void* stream) {
  if (batch <= 0 || t_frames <= 0 || hop <= 0 || win % ICH != 0 ||
      nfft % (2 * KT) != 0 || win > nfft || batch > 65535 ||
      ld < nfft / 2 + 1 ||
      (long long)(t_frames - 1) * hop + win > n)
    return (int)cudaErrorInvalidValue;
  const int span = (FT - 1) * hop + win;
  const size_t smem =
      sizeof(float) * ((size_t)pad_idx(span - 1) + 1 + 2 * ICH * KT);
  cudaError_t err = cudaFuncSetAttribute(
      spectrogram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_frames + FT - 1) / FT, nfft / 2 / KT + 1, batch);
  spectrogram_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, cosm, sinm, out, n, t_frames, win, hop, nfft, ld, alpha);
  return (int)cudaGetLastError();
}
