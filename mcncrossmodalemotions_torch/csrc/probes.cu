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
// probes, one launch a probe (each TPU probe is its own pallas_call with
// its own verdict).
//
// What bounds them on the card: launch cost. At the probes' shapes (P1
// moves 32 KB, P12 about 3.65 MB) the bytes take at most about a
// microsecond at 3.35 TB/s, and a launch a few. What a kernel adds to the
// launch floor is the latency of its threads, so the designs cut the
// instructions and the dependent loads a thread waits on:
//
// - probe_gather: out[o, j, i] = x[o, idx[j], i] over an [outer, n_in,
//   inner] view of x (f32 or bf16 in, f32 out; idx int32 on the device,
//   checked on the host before the launch). A repeat, a shifted repeat, a
//   strided slice, a roll, a gather along any axis and a reshape (a gather
//   of the flat view) are all such maps. A block is (bx, by) threads: bx
//   along inner, V elements a thread, by along the output rows j; the grid
//   maps to (inner tile, row tile, outer), so no element divides (PR 3's
//   first design took three 64-bit divisions and remainders an element).
//   A thread reads idx[j] once into a register and reuses it for its V
//   elements and every outer row of its stride (a warp's threads along
//   inner read the same entry: one broadcast). V is 16 bytes' worth (4 f32,
//   8 bf16, each bf16 widened by __bfloat162float) where inner is a
//   multiple of V and x and out are 16-byte aligned, else 1. Offsets are
//   32-bit where x and out hold fewer than 2^31 elements (every probe),
//   else 64-bit. Where inner == 1 (the lane gathers), bx = 1, so
//   consecutive threads take consecutive j and the stores coalesce.
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
//   Columns 2m and 2m + 1 share their candidates (m + 1 for k2 = 0; m for
//   k2 = 1, which only 2m takes), so a thread takes one t, the column pair
//   (2m, 2m + 1) and V channels: it reads y and dy at columns m and m + 1
//   once, x at both columns, and writes both outputs, 3 loads an output
//   where PR 3's first design made 5 and four 64-bit divisions. V = 4
//   (float4) where C is a multiple of 4 and all four pointers are 16-byte
//   aligned, else 1. A block is (bx, by): bx along channel vectors, by
//   along pairs; the grid maps to (pair tile, t), with no division; an
//   odd W ends on a half pair. 32-bit offsets below 2^31 elements, as in
//   the gather.
//
// Each launcher picks its path on the host from its arguments alone;
// probe_gather_route and probe_col_candidates_route return the path it
// takes (V x 2, plus 1 for 64-bit offsets), which ops/probes.py's
// gather_route and col_candidates_route compute the same way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_GRID_YZ = 65535;
constexpr long long NARROW = 1LL << 31;  // 32-bit offsets below this

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

long long min_ll(long long a, long long b) { return a < b ? a : b; }

// V elements of x at p to float at q; V > 1: p and q 16-byte aligned.
template <typename T, int V>
__device__ __forceinline__ void copy_vec(const T* __restrict__ p,
                                         float* __restrict__ q);

template <>
__device__ __forceinline__ void copy_vec<float, 1>(const float* __restrict__ p,
                                                   float* __restrict__ q) {
  *q = __ldg(p);
}

template <>
__device__ __forceinline__ void copy_vec<__nv_bfloat16, 1>(
    const __nv_bfloat16* __restrict__ p, float* __restrict__ q) {
  *q = to_float(*p);
}

template <>
__device__ __forceinline__ void copy_vec<float, 4>(const float* __restrict__ p,
                                                   float* __restrict__ q) {
  *reinterpret_cast<float4*>(q) = __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return to_float(__ushort_as_bfloat16((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return to_float(__ushort_as_bfloat16((unsigned short)(w >> 16)));
}

template <>
__device__ __forceinline__ void copy_vec<__nv_bfloat16, 8>(
    const __nv_bfloat16* __restrict__ p, float* __restrict__ q) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  float4* o = reinterpret_cast<float4*>(q);
  o[0] = make_float4(bf16_lo(r.x), bf16_hi(r.x), bf16_lo(r.y), bf16_hi(r.y));
  o[1] = make_float4(bf16_lo(r.z), bf16_hi(r.z), bf16_lo(r.w), bf16_hi(r.w));
}

// Thread (tx, ty) of block (x, y, z): elements [i, i + V) along inner,
// i = (x bx + tx) V, of output rows j = y by + ty (stride gridDim.y by),
// for outer rows o = z (stride gridDim.z). I: the offset type.
template <typename T, int V, typename I>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const T* __restrict__ x, const int32_t* __restrict__ idx,
              float* __restrict__ out, I outer, I n_in, I n_out, I inner) {
  const I i = ((I)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i >= inner) return;
  const I j_step = (I)gridDim.y * blockDim.y;
  for (I j = (I)blockIdx.y * blockDim.y + threadIdx.y; j < n_out; j += j_step) {
    const I src = (I)__ldg(idx + j);
    for (I o = blockIdx.z; o < outer; o += gridDim.z)
      copy_vec<T, V>(x + (o * n_in + src) * inner + i,
                     out + (o * n_out + j) * inner + i);
  }
}

// The gather's path: V x 2 + (1 for 64-bit offsets).
int gather_route(const void* x, const void* out, int elem_bytes,
                 long long outer, int n_in, int n_out, long long inner) {
  const int vec = 16 / elem_bytes;
  const bool wide =
      outer * (n_in > n_out ? n_in : n_out) * inner >= NARROW;
  const bool vector = inner % vec == 0 && aligned16(x) && aligned16(out);
  return (vector ? vec : 1) * 2 + (wide ? 1 : 0);
}

template <typename T, int V, typename I>
int launch_gather_as(const T* x, const int32_t* idx, float* out,
                     long long outer, int n_in, int n_out, long long inner,
                     cudaStream_t stream) {
  const long long vecs = inner / V;
  const int bx = (int)min_ll(vecs, 32);
  const int by = (int)min_ll(THREADS / bx, n_out);
  const dim3 grid((unsigned)((vecs + bx - 1) / bx),
                  (unsigned)min_ll((n_out + by - 1) / by, MAX_GRID_YZ),
                  (unsigned)min_ll(outer, MAX_GRID_YZ));
  gather_kernel<T, V, I><<<grid, dim3(bx, by), 0, stream>>>(
      x, idx, out, (I)outer, (I)n_in, (I)n_out, (I)inner);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gather(const T* x, const int32_t* idx, float* out, long long outer,
                  int n_in, int n_out, long long inner, void* stream) {
  if (outer <= 0 || n_in <= 0 || n_out <= 0 || inner <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr int VEC = 16 / sizeof(T);
  const int route =
      gather_route(x, out, sizeof(T), outer, n_in, n_out, inner);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (route) {
    case 2 * VEC:
      return launch_gather_as<T, VEC, unsigned>(x, idx, out, outer, n_in,
                                                n_out, inner, s);
    case 2 * VEC + 1:
      return launch_gather_as<T, VEC, unsigned long long>(
          x, idx, out, outer, n_in, n_out, inner, s);
    case 2:
      return launch_gather_as<T, 1, unsigned>(x, idx, out, outer, n_in, n_out,
                                              inner, s);
    default:
      return launch_gather_as<T, 1, unsigned long long>(
          x, idx, out, outer, n_in, n_out, inner, s);
  }
}

constexpr int MM_COLS = 32;                 // output columns a block, one a lane
constexpr int MM_SPLIT = THREADS / MM_COLS;  // warps, each one slice of K

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

template <typename Vec>
__device__ __forceinline__ Vec load(const float* __restrict__ p);
template <>
__device__ __forceinline__ float load<float>(const float* __restrict__ p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float4 load<float4>(const float* __restrict__ p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// One output: (0 + where(xv == y1, d1, 0)) + where(even & xv == y0, d0, 0),
// added in this order in fp32 (y1, d1: candidate column m + 1, k2 = 0;
// y0, d0: column m, k2 = 1).
__device__ __forceinline__ float expand(float xv, float y1, float d1,
                                        float y0, float d0, bool even) {
  float g = 0.0f;
  g = g + (xv == y1 ? d1 : 0.0f);
  g = g + ((even && xv == y0) ? d0 : 0.0f);
  return g;
}
__device__ __forceinline__ float4 expand(float4 xv, float4 y1, float4 d1,
                                         float4 y0, float4 d0, bool even) {
  return make_float4(expand(xv.x, y1.x, d1.x, y0.x, d0.x, even),
                     expand(xv.y, y1.y, d1.y, y0.y, d0.y, even),
                     expand(xv.z, y1.z, d1.z, y0.z, d0.z, even),
                     expand(xv.w, y1.w, d1.w, y0.w, d0.w, even));
}

// Thread (tx, ty) of block (x, y): the column pair (2m, 2m + 1),
// m = x by + ty, of image t = y (stride gridDim.y), channels [cv V,
// cv V + V) for cv = tx, tx + bx, ... below c / V.
template <int V, typename I>
__global__ void __launch_bounds__(THREADS)
col_candidates_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ dy, float* __restrict__ out,
                      I t_count, I w, I wh, I c) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const I m = (I)blockIdx.x * blockDim.y + threadIdx.y;
  if (2 * m >= w) return;
  const bool both = 2 * m + 1 < w;  // an odd w ends on a half pair
  const I cvecs = c / V;
  for (I t = blockIdx.y; t < t_count; t += gridDim.y) {
    const I xrow = (t * w + 2 * m) * c;  // x[t, 2m, 0]
    const I yrow = (t * wh + m) * c;     // y[t, m, 0]
    for (I cv = threadIdx.x; cv < cvecs; cv += blockDim.x) {
      const I xo = xrow + cv * V, yo = yrow + cv * V;
      const Vec y0 = load<Vec>(y + yo), y1 = load<Vec>(y + yo + c);
      const Vec d0 = load<Vec>(dy + yo), d1 = load<Vec>(dy + yo + c);
      const Vec xa = load<Vec>(x + xo);
      const Vec xb = both ? load<Vec>(x + xo + c) : xa;
      // column 2m: k2 = 0 at m + 1, k2 = 1 at m (even)
      store(out + xo, expand(xa, y1, d1, y0, d0, true));
      // column 2m + 1: k2 = 0 at m + 1, k2 = 1 masked (odd)
      if (both) store(out + xo + c, expand(xb, y1, d1, y0, d0, false));
    }
  }
}

// The expansion's path: V x 2 + (1 for 64-bit offsets).
int col_candidates_route(const void* x, const void* y, const void* dy,
                         const void* out, int t, int w, int wh, int c) {
  const bool wide = (long long)t * (w > wh ? w : wh) * c >= NARROW;
  const bool vector = c % 4 == 0 && aligned16(x) && aligned16(y) &&
                      aligned16(dy) && aligned16(out);
  return (vector ? 4 : 1) * 2 + (wide ? 1 : 0);
}

template <int V, typename I>
int launch_col_candidates_as(const float* x, const float* y, const float* dy,
                             float* out, int t, int w, int wh, int c,
                             cudaStream_t stream) {
  const long long cvecs = c / V, pairs = (w + 1) / 2;
  const int bx = (int)min_ll(cvecs, 32);
  const int by = (int)min_ll(THREADS / bx, pairs);
  const dim3 grid((unsigned)((pairs + by - 1) / by),
                  (unsigned)min_ll(t, MAX_GRID_YZ));
  col_candidates_kernel<V, I><<<grid, dim3(bx, by), 0, stream>>>(
      x, y, dy, out, (I)t, (I)w, (I)wh, (I)c);
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
  const dim3 grid((n + MM_COLS - 1) / MM_COLS,
                  (unsigned)min_ll(m, MAX_GRID_YZ));
  select_matmul_kernel<<<grid, dim3(MM_COLS, MM_SPLIT), 0,
                         (cudaStream_t)stream>>>(a, lda, b, c, m, k, n);
  return (int)cudaGetLastError();
}

extern "C" int probe_col_candidates_f32(const float* x, const float* y,
                                        const float* dy, float* out, int t,
                                        int w, int wh, int c, void* stream) {
  if (t <= 0 || w <= 0 || c <= 0 || 2LL * (wh - 1) < w)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (col_candidates_route(x, y, dy, out, t, w, wh, c)) {
    case 8:
      return launch_col_candidates_as<4, unsigned>(x, y, dy, out, t, w, wh, c,
                                                   s);
    case 9:
      return launch_col_candidates_as<4, unsigned long long>(x, y, dy, out, t,
                                                             w, wh, c, s);
    case 2:
      return launch_col_candidates_as<1, unsigned>(x, y, dy, out, t, w, wh, c,
                                                   s);
    default:
      return launch_col_candidates_as<1, unsigned long long>(x, y, dy, out, t,
                                                             w, wh, c, s);
  }
}

// The path probe_gather_f32 (elem_bytes 4) or probe_gather_bf16 (2) and
// probe_col_candidates_f32 take for these arguments: V x 2, plus 1 for
// 64-bit offsets. No launch.
extern "C" int probe_gather_route(const void* x, const void* out,
                                  int elem_bytes, long long outer, int n_in,
                                  int n_out, long long inner) {
  return gather_route(x, out, elem_bytes, outer, n_in, n_out, inner);
}

extern "C" int probe_col_candidates_route(const void* x, const void* y,
                                          const void* dy, const void* out,
                                          int t, int w, int wh, int c) {
  return col_candidates_route(x, y, dy, out, t, w, wh, c);
}
