// K2: 3x3 stride-2 VALID max pool over NHWC, forward only.
//
// Replaces the forward of the TPU kernel
// mcncrossmodalemotions_tpu/ops/pallas_pool.py (max_pool_3x3s2 ->
// _pool_fwd_pallas, body _fwd_kernel). The Mosaic kernel built the
// stride-2 column selection from pair-reshapes and a roll because Mosaic
// lowers strided sublane access badly; on Hopper a thread simply reads its
// window.
//
// What bounds it on the card: device-memory bytes. It does 8 compares per
// output and reads each input element about 2.25 times, of which L1/L2
// serve the overlap (window 3, stride 2), so the floor is one read of x
// plus one write of y. Design: one thread per output element, threads
// consecutive along C, so each of the 9 window reads of a warp is one
// contiguous, coalesced run of C values; a grid-stride loop covers any
// size.
//
// Semantics are PyTorch's max_pool2d (and XLA's reduce_window max):
// running max from -inf in row-major window order, replaced when a value
// is strictly greater or is NaN. Max is exact, so the output is bitwise
// equal to F.max_pool2d in bf16 and in fp32, ties and signed zeros
// included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  // exact for every bf16 value and -inf; NaN is stored as 0x7FC0, the NaN
  // that F.max_pool2d's float -> bf16 store gives (measured on the card;
  // __float2bfloat16 would give 0x7FFF)
  *p = isnan(v) ? __ushort_as_bfloat16((unsigned short)0x7FC0)
                : __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pool_kernel(const T* __restrict__ x, T* __restrict__ y, int h, int w, int c,
            int ho, int wo, long long total) {
  for (long long o = (long long)blockIdx.x * THREADS + threadIdx.x; o < total;
       o += (long long)gridDim.x * THREADS) {
    const int ch = (int)(o % c);
    long long r = o / c;
    const int oj = (int)(r % wo);
    r /= wo;
    const int oi = (int)(r % ho);
    const long long b = r / ho;
    const T* base = x + ((b * h + 2 * oi) * w + 2 * oj) * c + ch;
    float m = -__int_as_float(0x7f800000);  // -inf
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float v = to_float(base[((long long)dy * w + dx) * c]);
        if (v > m || isnan(v)) m = v;
      }
    store(y + o, m);
  }
}

template <typename T>
int launch(const T* x, T* y, int batch, int h, int w, int c, void* stream) {
  if (batch <= 0 || h < 3 || w < 3 || c <= 0) return (int)cudaErrorInvalidValue;
  const int ho = (h - 3) / 2 + 1, wo = (w - 3) / 2 + 1;
  const long long total = (long long)batch * ho * wo * c;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  pool_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, y, h, w, c, ho, wo, total);
  return (int)cudaGetLastError();
}

}  // namespace

// x [batch, h, w, c] contiguous, y [batch, (h-3)/2+1, (w-3)/2+1, c].
// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int max_pool_3x3s2_f32(const float* x, float* y, int batch, int h,
                                  int w, int c, void* stream) {
  return launch<float>(x, y, batch, h, w, c, stream);
}

extern "C" int max_pool_3x3s2_bf16(const void* x, void* y, int batch, int h,
                                   int w, int c, void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                               static_cast<__nv_bfloat16*>(y), batch, h, w, c,
                               stream);
}
