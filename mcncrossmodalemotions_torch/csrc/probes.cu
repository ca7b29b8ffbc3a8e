// Hopper probe kernels: the counterparts of the Mosaic lowering probes in
// tools/probe_mosaic.py (P1-P11, `pcall` -> pl.pallas_call) and
// tools/probe_mosaic2.py (P4r, P4s, P4b, P12 through `pcall`, P1r through
// its inline pl.pallas_call).
//
// Each TPU probe jits one tiny Pallas kernel to learn whether Mosaic
// lowers a data movement (a gather, repeat, reshape, roll or strided slice
// along the sublane or lane axis, a selection matmul, the pool gradient's
// column-candidate expansion) and whether it computes numpy's answer. On
// Hopper no axis is special: a thread reads any address, so every one of
// those movements is an index map, and three kernels cover all seventeen
// probes:
//
// - probe_gather: out[o, j, i] = x[o, idx[j], i] over an [outer, n_in,
//   inner] view of x (f32 or bf16 in, f32 out; idx int32 on the device,
//   checked on the host before the launch). A repeat, a shifted repeat, a
//   strided slice, a roll, a gather along any axis and a reshape (a gather
//   of the flat view) are all such maps. One thread per output element,
//   threads consecutive along the innermost axis, so a warp's reads are
//   contiguous wherever inner > 1; a grid-stride loop covers any size.
// - probe_select_matmul (P9): c = a @ b in fp32 FFMA on the CUDA cores,
//   never TF32 tensor cores: the probe's input is arange(4096), and TF32's
//   11-bit significand would round every value above 2048. With a 0/1
//   selection matrix each output is one exact product plus exact zeros,
//   so any summation order is exact there. Its bound is launch latency:
//   at the probe's [16, 128] @ [128, 256] the bytes take 0.05 us. One
//   FFMA chain per output would make each thread wait out k = 128
//   dependent FFMAs, so K is split: a block takes one row of
//   a and 32 consecutive columns (lanes, so loads of b are coalesced
//   along n), each of its 8 warps sums one eighth of K into shared
//   memory, and warp 0 adds the 8 partials in a fixed order: a chain of
//   k/8 FFMAs and 7 adds, and 128 blocks at the probe's shape.
// - probe_col_candidates (P12): the body of the probe's k12, the pool
//   gradient's column-candidate expansion: for k2 in {0, 1} the candidate
//   window column of input column w is w / 2 + 1 - k2 (repeat y[:, 1-k2:]
//   twice along W, cut to W), the mask is x == y there (AND w even for
//   k2 = 1), and out = (0 + where(m0, dy0, 0)) + where(m1, dy1, 0) in fp32,
//   the probe's own order, so the result is bitwise its plain version's.
//
// What bounds them on the card: launch cost. At the probes' shapes (P1
// moves 32 KB, P12 about 6 MB) the bytes take well under a microsecond at
// 3.35 TB/s, so a launch (a few microseconds) is the time. The gather and
// P12 are the simplest correct designs; P9's split keeps its dependent
// chain short enough to hide behind the launch.

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

unsigned blocks_for(long long total) {
  long long blocks = (total + THREADS - 1) / THREADS;
  return (unsigned)(blocks > MAX_BLOCKS ? MAX_BLOCKS : blocks);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
              float* __restrict__ out, int n_in, int n_out, long long inner,
              long long total) {
  for (long long o = (long long)blockIdx.x * THREADS + threadIdx.x; o < total;
       o += (long long)gridDim.x * THREADS) {
    const long long i = o % inner;
    const long long r = o / inner;
    const int j = (int)(r % n_out);
    const long long outer = r / n_out;
    out[o] = to_float(x[(outer * n_in + idx[j]) * inner + i]);
  }
}

constexpr int MM_COLS = 32;                 // output columns a block, one a lane
constexpr int MM_SPLIT = THREADS / MM_COLS;  // warps, each one slice of K
constexpr int MAX_GRID_Y = 65535;

// Block (x, y): columns [32 x, 32 x + 32) of rows y, y + gridDim.y, ...;
// thread (j, s) sums p in [s chunk, (s + 1) chunk) for column j.
__global__ void __launch_bounds__(THREADS)
select_matmul_kernel(const float* __restrict__ a, long long lda,
                     const float* __restrict__ b, float* __restrict__ c, int m,
                     int k, int n) {
  __shared__ float part[MM_SPLIT][MM_COLS];
  const int j = threadIdx.x, s = threadIdx.y;
  const int col = blockIdx.x * MM_COLS + j;
  const int chunk = (k + MM_SPLIT - 1) / MM_SPLIT;
  const int p0 = s * chunk, p1 = min(k, p0 + chunk);
  for (long long row = blockIdx.y; row < m; row += gridDim.y) {
    const float* ar = a + row * lda;
    float acc = 0.0f;
    if (col < n) {
#pragma unroll 4
      for (int p = p0; p < p1; ++p)
        acc = fmaf(ar[p], b[(long long)p * n + col], acc);
    }
    part[s][j] = acc;
    __syncthreads();
    if (s == 0 && col < n) {
      float sum = part[0][j];
#pragma unroll
      for (int q = 1; q < MM_SPLIT; ++q) sum += part[q][j];
      c[row * n + col] = sum;
    }
    __syncthreads();  // part is rewritten for the next row
  }
}

__global__ void __launch_bounds__(THREADS)
col_candidates_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ dy, float* __restrict__ out,
                      int w, int wh, int c, long long total) {
  for (long long o = (long long)blockIdx.x * THREADS + threadIdx.x; o < total;
       o += (long long)gridDim.x * THREADS) {
    const int ch = (int)(o % c);
    const long long r = o / c;
    const int col = (int)(r % w);
    const long long t = r / w;
    const float xv = x[o];
    const long long base = t * wh * c + ch;
    const long long c0 = base + (long long)(col / 2 + 1) * c;  // k2 = 0
    const long long c1 = base + (long long)(col / 2) * c;      // k2 = 1
    float g = 0.0f;
    g = g + (xv == y[c0] ? dy[c0] : 0.0f);
    g = g + ((xv == y[c1] && col % 2 == 0) ? dy[c1] : 0.0f);
    out[o] = g;
  }
}

template <typename T>
int launch_gather(const T* x, const int32_t* idx, float* out, long long outer,
                  int n_in, int n_out, long long inner, void* stream) {
  if (outer <= 0 || n_in <= 0 || n_out <= 0 || inner <= 0)
    return (int)cudaErrorInvalidValue;
  const long long total = outer * n_out * inner;
  gather_kernel<T><<<blocks_for(total), THREADS, 0, (cudaStream_t)stream>>>(
      x, idx, out, n_in, n_out, inner, total);
  return (int)cudaGetLastError();
}

}  // namespace

// x [outer, n_in, inner] contiguous, idx [n_out] int32 with every entry in
// [0, n_in), out [outer, n_out, inner] float32. a [m, k] with row stride
// lda (elements, unit column stride), b [k, n] and c [m, n] contiguous.
// x [t, w, c], y and dy [t, wh, c] contiguous with 2 * (wh - 1) >= w,
// out [t, w, c]. Each function launches on `stream` and returns the
// cudaError_t of the launch (0 = success).
extern "C" int probe_gather_f32(const float* x, const int32_t* idx, float* out,
                                long long outer, int n_in, int n_out,
                                long long inner, void* stream) {
  return launch_gather<float>(x, idx, out, outer, n_in, n_out, inner, stream);
}

extern "C" int probe_gather_bf16(const void* x, const int32_t* idx, float* out,
                                 long long outer, int n_in, int n_out,
                                 long long inner, void* stream) {
  return launch_gather<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                                      idx, out, outer, n_in, n_out, inner,
                                      stream);
}

extern "C" int probe_select_matmul_f32(const float* a, long long lda,
                                       const float* b, float* c, int m, int k,
                                       int n, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || lda < k) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + MM_COLS - 1) / MM_COLS, m < MAX_GRID_Y ? m : MAX_GRID_Y);
  select_matmul_kernel<<<grid, dim3(MM_COLS, MM_SPLIT), 0,
                         (cudaStream_t)stream>>>(a, lda, b, c, m, k, n);
  return (int)cudaGetLastError();
}

extern "C" int probe_col_candidates_f32(const float* x, const float* y,
                                        const float* dy, float* out, int t,
                                        int w, int wh, int c, void* stream) {
  if (t <= 0 || w <= 0 || c <= 0 || 2LL * (wh - 1) < w)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)t * w * c;
  col_candidates_kernel<<<blocks_for(total), THREADS, 0,
                          (cudaStream_t)stream>>>(x, y, dy, out, w, wh, c,
                                                  total);
  return (int)cudaGetLastError();
}
