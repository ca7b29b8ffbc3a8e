// K2: 3x3 stride-2 VALID max pool over NHWC: forward, forward with the
// in-window argmax, and the backward that routes dy to those argmaxes.
//
// Replaces the TPU kernel mcncrossmodalemotions_tpu/ops/pallas_pool.py:
// the forward (max_pool_3x3s2 -> _pool_fwd_pallas, body _fwd_kernel) and
// its custom_vjp backward (_bwd -> _sas_grad, XLA's SelectAndScatterAdd
// with the `ge` select). The Mosaic kernel built the stride-2 column
// selection from pair-reshapes and a roll because Mosaic lowers strided
// sublane access badly; on Hopper a thread simply reads its window.
//
// Forward. What bounds it on the card: device-memory bytes. It does 8
// compares per output and reads each input element about 2.25 times, of
// which L1/L2 serve the overlap (window 3, stride 2), so the floor is one
// read of x plus one write of y. Design: one thread per output element,
// threads consecutive along C, so each of the 9 window reads of a warp is
// one contiguous, coalesced run of C values; a grid-stride loop covers any
// size. The with-index variant also writes one uint8 per output: the
// winner's position in its window, dy * 3 + dx (0..8).
//
// Semantics are PyTorch's max_pool2d (and XLA's reduce_window max):
// running max from -inf in row-major window order, replaced when a value
// is strictly greater or is NaN. Max is exact, so the output is bitwise
// equal to F.max_pool2d in bf16 and in fp32, ties and signed zeros
// included. Tie rule: the FIRST maximum in row-major window order wins,
// which is also what XLA's SelectAndScatter with `ge` picks. For NaN the
// rule is PyTorch's (the last NaN of the window wins); XLA's `ge` differs
// there.
//
// Backward. dx[b, i, j, c] = sum over the at most 2x2 windows (oi, oj)
// that cover (i, j) of dy[b, oi, oj, c] where the window's stored argmax
// is (i - 2 oi, j - 2 oj). What bounds it: bytes again. At pool1 with
// B=128 in bf16 it reads dy (303 MB) and the index (152 MB) and writes dx
// (1.23 GB): a floor of about 0.5 ms at 3.35 TB/s. Design: a gather over
// the windows that cover each input element instead of a scatter from
// each window: no atomics, no memset of dx, deterministic. One thread per
// input column (b, j, c), threads consecutive along C, walks down the
// rows: each output row's index and dy are loaded once for the up to
// three input rows they serve, and the loads of several rows are in
// flight at once (the first version, one thread per input element with
// two dependent loads each, waited on memory latency: 8.8 ms at pool1).
// It accumulates in fp32 in a fixed order (oi ascending, then oj) from +0
// and rounds once to the output type, which is the order and precision of
// PyTorch's max_pool2d backward, so dx is bitwise equal to autograd of
// F.max_pool2d given the same winners.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132LL * 64;  // grid-stride beyond this

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  // exact for every bf16 value and -inf; NaN is stored as 0x7FC0, the NaN
  // that F.max_pool2d's float -> bf16 store gives (measured on the card;
  // __float2bfloat16 would give 0x7FFF). Sums round to nearest even, as
  // PyTorch's float -> bf16 conversion does.
  *p = isnan(v) ? __ushort_as_bfloat16((unsigned short)0x7FC0)
                : __float2bfloat16(v);
}

// `idx` is null for the index-free forward.
template <typename T>
__global__ void __launch_bounds__(THREADS)
pool_kernel(const T* __restrict__ x, T* __restrict__ y,
            uint8_t* __restrict__ idx, int h, int w, int c, int ho, int wo,
            long long total) {
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
    int arg = 0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float v = to_float(base[((long long)dy * w + dx) * c]);
        if (v > m || isnan(v)) {
          m = v;
          arg = dy * 3 + dx;
        }
      }
    store(y + o, m);
    if (idx != nullptr) idx[o] = (uint8_t)arg;
  }
}

// `code` is the in-window position a winner must have to route dy here;
// a miss adds +0.0, which leaves every sum bitwise as a skipped add would
// (sums start at +0 and never become -0), and never reads dy as a factor.
template <typename T>
__device__ __forceinline__ float routed(uint8_t arg, int code, T g) {
  return arg == code ? to_float(g) : 0.0f;
}

// One thread per input column (b, j, c), walking down the rows: output
// row k's index and dy (at the one or two window columns oj0 <= oj1 that
// cover j) are loaded once and serve input rows 2k, 2k+1 and 2k+2; the
// unrolled loop keeps several output rows' loads in flight. Sums per
// input element run over oi ascending, then oj, from +0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
pool_bwd_kernel(const T* __restrict__ dy, const uint8_t* __restrict__ idx,
                T* __restrict__ dx, int h, int w, int c, int ho, int wo,
                long long columns) {
  for (long long col = (long long)blockIdx.x * THREADS + threadIdx.x;
       col < columns; col += (long long)gridDim.x * THREADS) {
    const int ch = (int)(col % c);
    const long long r = col / c;
    const int j = (int)(r % w);
    const long long b = r / w;
    const int oj0 = j >= 1 ? (j - 1) >> 1 : 0;
    const int oj1 = min(j >> 1, wo - 1);
    const long long row_out = (long long)wo * c, row_in = (long long)w * c;
    T* out = dx + b * h * row_in + (long long)j * c + ch;
    if (oj0 > oj1) {  // the last column of an even width: in no window
      for (int i = 0; i < h; ++i) store(out + (long long)i * row_in, 0.0f);
      continue;
    }
    const bool two = oj1 > oj0;
    const int dj0 = j - 2 * oj0, dj1 = j - 2 * oj1;
    const T* g = dy + b * ho * row_out + (long long)oj0 * c + ch;
    const uint8_t* a = idx + b * ho * row_out + (long long)oj0 * c + ch;
    const long long step1 = (long long)(oj1 - oj0) * c;  // oj0 -> oj1
    float carry = 0.0f;  // output row k-1's share of input row 2k
#pragma unroll 4
    for (int k = 0; k < ho; ++k) {
      const long long o = k * row_out;
      const uint8_t a0 = a[o], a1 = two ? a[o + step1] : (uint8_t)255;
      const T g0 = g[o], g1 = two ? g[o + step1] : g0;
      const float top = (carry + routed(a0, dj0, g0)) + routed(a1, dj1, g1);
      const float mid = (0.0f + routed(a0, 3 + dj0, g0)) + routed(a1, 3 + dj1, g1);
      carry = (0.0f + routed(a0, 6 + dj0, g0)) + routed(a1, 6 + dj1, g1);
      store(out + (2LL * k) * row_in, top);
      store(out + (2LL * k + 1) * row_in, mid);
    }
    for (int i = 2 * ho; i < h; ++i) {  // below the last window: its share
      store(out + (long long)i * row_in, i == 2 * ho ? carry : 0.0f);
    }
  }
}

template <typename T>
int launch(const T* x, T* y, uint8_t* idx, int batch, int h, int w, int c,
           void* stream) {
  if (batch <= 0 || h < 3 || w < 3 || c <= 0) return (int)cudaErrorInvalidValue;
  const int ho = (h - 3) / 2 + 1, wo = (w - 3) / 2 + 1;
  const long long total = (long long)batch * ho * wo * c;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  pool_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, y, idx, h, w, c, ho, wo, total);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const T* dy, const uint8_t* idx, T* dx, int batch, int h,
               int w, int c, void* stream) {
  if (batch <= 0 || h < 3 || w < 3 || c <= 0) return (int)cudaErrorInvalidValue;
  const int ho = (h - 3) / 2 + 1, wo = (w - 3) / 2 + 1;
  const long long columns = (long long)batch * w * c;
  long long blocks = (columns + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  pool_bwd_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      dy, idx, dx, h, w, c, ho, wo, columns);
  return (int)cudaGetLastError();
}

}  // namespace

// x [batch, h, w, c] contiguous, y [batch, (h-3)/2+1, (w-3)/2+1, c],
// idx (the with-index variants) uint8 of y's shape. dy/idx/dx: the
// backward of the pool of an [batch, h, w, c] input. Each function
// launches on `stream` and returns the cudaError_t of the launch
// (0 = success).
extern "C" int max_pool_3x3s2_f32(const float* x, float* y, int batch, int h,
                                  int w, int c, void* stream) {
  return launch<float>(x, y, nullptr, batch, h, w, c, stream);
}

extern "C" int max_pool_3x3s2_bf16(const void* x, void* y, int batch, int h,
                                   int w, int c, void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                               static_cast<__nv_bfloat16*>(y), nullptr, batch,
                               h, w, c, stream);
}

extern "C" int max_pool_3x3s2_idx_f32(const float* x, float* y, uint8_t* idx,
                                      int batch, int h, int w, int c,
                                      void* stream) {
  return launch<float>(x, y, idx, batch, h, w, c, stream);
}

extern "C" int max_pool_3x3s2_idx_bf16(const void* x, void* y, uint8_t* idx,
                                       int batch, int h, int w, int c,
                                       void* stream) {
  return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                               static_cast<__nv_bfloat16*>(y), idx, batch, h,
                               w, c, stream);
}

extern "C" int max_pool_3x3s2_bwd_f32(const float* dy, const uint8_t* idx,
                                      float* dx, int batch, int h, int w,
                                      int c, void* stream) {
  return launch_bwd<float>(dy, idx, dx, batch, h, w, c, stream);
}

extern "C" int max_pool_3x3s2_bwd_bf16(const void* dy, const uint8_t* idx,
                                       void* dx, int batch, int h, int w,
                                       int c, void* stream) {
  return launch_bwd<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(dy), idx,
                                   static_cast<__nv_bfloat16*>(dx), batch, h,
                                   w, c, stream);
}
