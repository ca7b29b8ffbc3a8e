// The face teachers' eval-mode BatchNorm epilogues: per-channel affines
// applied to raw convolution outputs, with the ReLU, the squeeze of the
// squeeze-excitation block, its gate and the residual add of a bottleneck,
// or the 2x2/2 max pool that ends a VGG block, folded into the same
// passes, so that each activation is written once.
//
// Replaces no TPU kernel: the JAX package leaves eval BatchNorm, ReLU, the
// SE squeeze and gate, the residual add and VGG's 2x2 pools to XLA, which
// fuses them into the convolutions' neighbours by itself. The port's eager
// forward ran each as its own PyTorch kernel (about 12 block outputs'
// worth of bytes a bottleneck); the first three kernels move about 5. A
// VGG block's last conv output was read and written three times and read
// once more by its pool; the fourth reads it once.
//
// Every tensor is NHWC, [rows, c] with rows = batch x h x w, contiguous;
// s and t are fp32 [c]: s = gamma * rsqrt(running_var + eps), t = beta -
// running_mean * s (+ s x the conv's bias, where it has one). Arithmetic is fp32 from the loaded values with one
// rounding to the output type.
//
// 1. affine_relu: out = relu(s y + t); out may be y (in place).
// 2. affine_squeeze: out[b, c] = mean over h, w of (s y + t), summed in
//    fp32; nothing else is written.
// 3. affine_gate_add_relu: out = relu((s y + t) gate[b, c] + r), with r
//    the block input as it is (identity shortcut) or rs yd + rt (the raw
//    projection conv's output under its own BatchNorm); no gate for a
//    block without squeeze-excitation. out may be y or r.
// 4. affine_relu_pool2x2: out[b, i, j] = max over the 2x2 window at
//    (2i, 2j) of relu(s y + t), [b, h / 2, w / 2, c] (floor: an odd last
//    row or column is not read). The affine comes before the max, since s
//    may be negative; the ReLU may come after it, being monotone. VGG's
//    convs carry a bias and no BatchNorm: s = 1, t = the bias.
//
// What bounds them on the card: device-memory bytes. Each does a few
// fused multiply-adds an element against 2 (squeeze) to 6 (projection
// tail) bytes of traffic, far below the 295 operations a byte at which an
// H100's bf16 tensor cores, let alone its fp32 units, would be the limit.
// At batch 128 in bf16 a stage-1 block output is 205.5 MB, so the tail of
// a projection block moves 617 MB (0.18 ms at 3.35 TB/s). The design:
// - A lane owns one 16-byte channel vector (8 bf16 or 4 fp32) of a row;
//   LANES = 8 lanes cover 128 contiguous bytes of a row and the block's
//   other lanes take the next rows, so a warp reads whole 128-byte lines.
//   Loads and stores are 16 bytes a lane, held as 32-bit words until used.
// - A lane's channels are fixed for the whole launch: its s and t (and the
//   projection's) are loaded once into registers, a few loads a thread.
// - The elementwise kernels walk the rows grid-stride, UNROLL rows in
//   flight a lane (four 16-byte loads, eight for a projection tail), with
//   about FILL_BLOCKS blocks: eight 256-thread blocks on each of 132 SMs,
//   twice over.
// - The squeeze gives each (image, 8-lane channel tile) its own block, so
//   the mean over h x w is a register sum down the block's rows and one
//   shared-memory sum across them, written once: no atomics and no second
//   pass. At batch 128 that is 512 blocks at stage 1 (4 tiles) up to 4,096
//   at stage 4 (32 tiles), each lane with UNROLL rows in flight.
// - The gate's 16-byte vector of a row's image is read per row; it is
//   batch x c x 2 bytes in all (512 KB at stage 4), so L1 and L2 serve it.
// - The pool walks output pixels as the elementwise kernels walk rows; a
//   lane loads its vector of the window's four input pixels (two pairs of
//   neighbours, each pair 2 c contiguous elements), POOL_UNROLL outputs in
//   flight, and writes one vector: y is read once and a quarter of it
//   written (VGG-VD-16's conv1_2 output at batch 128 is 822 MB in bf16, so
//   its pool moves 1.03 GB, 0.31 ms at 3.35 TB/s). An output pixel's
//   image, row and column are two 32-bit divisions (the launcher refuses
//   2^31 output pixels or more).
// - There is no narrower path: the launchers refuse a c that is not a
//   multiple of the vector, or a base pointer of y, out, r or the gate
//   that is not 16-byte aligned (cudaErrorInvalidValue; ops/epilogue.py
//   raises before that). The teachers' tensors (fresh, c a multiple of 64)
//   always take 16 bytes.
// ReLU keeps a NaN (PyTorch's relu does); fmaxf would make it 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 8;      // channel vectors across a block: 128 bytes
constexpr int UNROLL = 4;     // rows a lane has in flight
constexpr int POOL_UNROLL = 2;  // output pixels a lane has in flight (x4 loads)
constexpr long long FILL_BLOCKS = 132LL * 8 * 2;

// A 16-byte vector of T (V = 8 bf16 or 4 fp32) as four 32-bit words; bf16
// element i is the high half of a float, exactly.
template <typename T, int V>
struct Words {
  static_assert(V * sizeof(T) == 16, "16-byte vectors only");
  uint32_t u[4];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, Words<T, V>& w) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  w.u[0] = r.x, w.u[1] = r.y, w.u[2] = r.z, w.u[3] = r.w;
}

template <typename T, int V>
__device__ __forceinline__ float element(const Words<T, V>& w, int i) {
  if constexpr (std::is_same<T, float>::value) return __uint_as_float(w.u[i]);
  else
    return __uint_as_float(i & 1 ? w.u[i / 2] & 0xFFFF0000u : w.u[i / 2] << 16);
}

// Round a 16-byte vector's V floats to T (round to nearest even) and store
// them.
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&v)[V]) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

__device__ __forceinline__ float relu(float v) {
  return v > 0.0f || v != v ? v : 0.0f;
}

template <int V>
__device__ __forceinline__ void load_affine(const float* __restrict__ s,
                                            const float* __restrict__ t,
                                            int ch, float (&sv)[V],
                                            float (&tv)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) sv[i] = s[ch + i], tv[i] = t[ch + i];
}

// out = relu(s y + t). Block (lx, ly): threadIdx.x a channel vector of the
// tile blockIdx.y, threadIdx.y a row; rows walked grid-stride.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    affine_relu_kernel(const T* y, T* out, const float* __restrict__ s,
                       const float* __restrict__ t, long long rows, int c) {
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  if (lane * V >= c) return;
  float sv[V], tv[V];
  load_affine<V>(s, t, lane * V, sv, tv);
  const long long step = (long long)gridDim.x * blockDim.y;
  for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       r < rows; r += UNROLL * step) {
    Words<T, V> w[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      if (r + k * step < rows) load<T, V>(y + (r + k * step) * c + lane * V, w[k]);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (r + k * step >= rows) break;
      float v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = relu(fmaf(sv[i], element(w[k], i), tv[i]));
      store<T, V>(out + (r + k * step) * c + lane * V, v);
    }
  }
}

// out[b, c] = mean over the hw rows of image b of (s y + t). Block (lx,
// ly): threadIdx.x a channel vector of the tile blockIdx.x, threadIdx.y a
// row; blockIdx.y the image. The lanes' sums meet in shared memory.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    affine_squeeze_kernel(const T* __restrict__ y, T* __restrict__ out,
                          const float* __restrict__ s,
                          const float* __restrict__ t, int hw, int c) {
  __shared__ float part[THREADS * V];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = lane * V < c;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  if (live) {
    float sv[V], tv[V];
    load_affine<V>(s, t, lane * V, sv, tv);
    const T* img = y + (long long)blockIdx.y * hw * c + lane * V;
    const int step = blockDim.y;
    for (int r = threadIdx.y; r < hw; r += UNROLL * step) {
      Words<T, V> w[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k)
        if (r + k * step < hw) load<T, V>(img + (long long)(r + k * step) * c, w[k]);
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        if (r + k * step >= hw) break;
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += fmaf(sv[i], element(w[k], i), tv[i]);
      }
    }
  }
  const int width = blockDim.x * V;  // channels of the tile
#pragma unroll
  for (int i = 0; i < V; ++i)
    part[threadIdx.y * width + threadIdx.x * V + i] = acc[i];
  __syncthreads();
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int ch = blockIdx.x * width + tid;
  if (tid < width && ch < c) {
    float sum = 0.0f;
    for (int r = 0; r < blockDim.y; ++r) sum += part[r * width + tid];
    const float mean = sum / (float)hw;
    if constexpr (std::is_same<T, float>::value) out[(long long)blockIdx.y * c + ch] = mean;
    else out[(long long)blockIdx.y * c + ch] = __float2bfloat16_rn(mean);
  }
}

// out = relu((s y + t) gate[b] + r'), r' = r (identity) or rs r + rt
// (projection). Laid out as affine_relu_kernel; a row's image is a 32-bit
// division (the launcher refuses 2^31 rows or more).
template <typename T, int V, bool GATE, bool PROJ>
__global__ void __launch_bounds__(THREADS)
    affine_gate_add_relu_kernel(const T* y, const float* __restrict__ s,
                                const float* __restrict__ t,
                                const T* __restrict__ gate, const T* r,
                                const float* __restrict__ rs,
                                const float* __restrict__ rt, T* out,
                                long long rows, int hw, int c) {
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  if (lane * V >= c) return;
  float sv[V], tv[V], rsv[V], rtv[V];
  load_affine<V>(s, t, lane * V, sv, tv);
  if constexpr (PROJ) load_affine<V>(rs, rt, lane * V, rsv, rtv);
  const long long step = (long long)gridDim.x * blockDim.y;
  for (long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       row < rows; row += UNROLL * step) {
    Words<T, V> wy[UNROLL], wr[UNROLL], wg[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long q = row + k * step;
      if (q < rows) {
        load<T, V>(y + q * c + lane * V, wy[k]);
        load<T, V>(r + q * c + lane * V, wr[k]);
        if constexpr (GATE)
          load<T, V>(gate + (long long)((unsigned)q / (unsigned)hw) * c + lane * V,
                     wg[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const long long q = row + k * step;
      if (q >= rows) break;
      float v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float a = fmaf(sv[i], element(wy[k], i), tv[i]);
        if constexpr (GATE) a *= element(wg[k], i);
        float b = element(wr[k], i);
        if constexpr (PROJ) b = fmaf(rsv[i], b, rtv[i]);
        v[i] = relu(a + b);
      }
      store<T, V>(out + q * c + lane * V, v);
    }
  }
}

// out[b, i, j] = relu(max over the 2x2 window of s y + t). Laid out as
// affine_relu_kernel over the output pixels; a NaN in the window wins.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    affine_relu_pool2x2_kernel(const T* __restrict__ y, T* __restrict__ out,
                               const float* __restrict__ s,
                               const float* __restrict__ t, long long pixels,
                               int ho, int wo, int h, int w, int c) {
  const int lane = blockIdx.y * blockDim.x + threadIdx.x;
  if (lane * V >= c) return;
  float sv[V], tv[V];
  load_affine<V>(s, t, lane * V, sv, tv);
  const long long step = (long long)gridDim.x * blockDim.y;
  const long long below = (long long)w * c;  // the window's second row
  for (long long p = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       p < pixels; p += POOL_UNROLL * step) {
    Words<T, V> win[POOL_UNROLL][4];
#pragma unroll
    for (int k = 0; k < POOL_UNROLL; ++k) {
      const long long q = p + k * step;
      if (q < pixels) {
        const unsigned bi = (unsigned)q / (unsigned)wo;  // b ho + i
        const unsigned j = (unsigned)q - bi * (unsigned)wo;
        const unsigned b = bi / (unsigned)ho;
        const unsigned i = bi - b * (unsigned)ho;
        const T* src = y + (((long long)b * h + 2 * i) * w + 2 * j) * c + lane * V;
        load<T, V>(src, win[k][0]);
        load<T, V>(src + c, win[k][1]);
        load<T, V>(src + below, win[k][2]);
        load<T, V>(src + below + c, win[k][3]);
      }
    }
#pragma unroll
    for (int k = 0; k < POOL_UNROLL; ++k) {
      const long long q = p + k * step;
      if (q >= pixels) break;
      float v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float m = fmaf(sv[i], element(win[k][0], i), tv[i]);
#pragma unroll
        for (int n = 1; n < 4; ++n) {
          const float a = fmaf(sv[i], element(win[k][n], i), tv[i]);
          m = a > m || a != a ? a : m;
        }
        v[i] = relu(m);
      }
      store<T, V>(out + q * c + lane * V, v);
    }
  }
}

// Block shape for c / V channel vectors: up to LANES lanes across, the
// rest of the 256 threads down the rows.
struct Shape {
  int lx, ly, tiles;
};

inline Shape shape(int vectors) {
  const int lx = vectors < LANES ? vectors : LANES;
  return {lx, THREADS / lx, (vectors + lx - 1) / lx};
}

inline dim3 walk_grid(long long rows, const Shape& sh) {
  long long blocks = (rows + sh.ly - 1) / sh.ly;
  long long cap = FILL_BLOCKS / sh.tiles;
  if (cap < 1) cap = 1;
  return dim3((unsigned)(blocks < cap ? blocks : cap), (unsigned)sh.tiles);
}

inline bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

// Elements of T in a lane's 16-byte vector.
template <typename T>
constexpr int WIDE = 16 / (int)sizeof(T);

template <typename T, int V>
int launch_relu(const T* y, T* out, const float* s, const float* t,
                long long rows, int c, cudaStream_t stream) {
  const Shape sh = shape(c / V);
  affine_relu_kernel<T, V><<<walk_grid(rows, sh), dim3(sh.lx, sh.ly), 0,
                             stream>>>(y, out, s, t, rows, c);
  return (int)cudaGetLastError();
}

template <typename T>
int run_relu(const T* y, T* out, const float* s, const float* t, int batch,
         int hw, int c, void* stream) {
  if (batch <= 0 || hw <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  if (c % WIDE<T> != 0 || !aligned(y) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  return launch_relu<T, WIDE<T>>(y, out, s, t, (long long)batch * hw, c,
                                 (cudaStream_t)stream);
}

template <typename T, int V>
int launch_squeeze(const T* y, T* out, const float* s, const float* t,
                   int batch, int hw, int c, cudaStream_t stream) {
  const Shape sh = shape(c / V);
  affine_squeeze_kernel<T, V><<<dim3((unsigned)sh.tiles, (unsigned)batch),
                                dim3(sh.lx, sh.ly), 0, stream>>>(y, out, s, t,
                                                                 hw, c);
  return (int)cudaGetLastError();
}

// One block a (channel tile, image): at most 65535 images.
template <typename T>
int run_squeeze(const T* y, T* out, const float* s, const float* t, int batch,
            int hw, int c, void* stream) {
  if (batch <= 0 || batch > 65535 || hw <= 0 || c <= 0)
    return (int)cudaErrorInvalidValue;
  if (c % WIDE<T> != 0 || !aligned(y)) return (int)cudaErrorInvalidValue;
  return launch_squeeze<T, WIDE<T>>(y, out, s, t, batch, hw, c,
                                    (cudaStream_t)stream);
}

template <typename T, int V, bool GATE, bool PROJ>
int launch_tail(const T* y, const float* s, const float* t, const T* gate,
                const T* r, const float* rs, const float* rt, T* out,
                long long rows, int hw, int c, cudaStream_t stream) {
  const Shape sh = shape(c / V);
  affine_gate_add_relu_kernel<T, V, GATE, PROJ>
      <<<walk_grid(rows, sh), dim3(sh.lx, sh.ly), 0, stream>>>(
          y, s, t, gate, r, rs, rt, out, rows, hw, c);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int tail_variant(const T* y, const float* s, const float* t, const T* gate,
                 const T* r, const float* rs, const float* rt, T* out,
                 long long rows, int hw, int c, cudaStream_t stream) {
  if (gate && rs)
    return launch_tail<T, V, true, true>(y, s, t, gate, r, rs, rt, out, rows,
                                         hw, c, stream);
  if (gate)
    return launch_tail<T, V, true, false>(y, s, t, gate, r, rs, rt, out, rows,
                                          hw, c, stream);
  if (rs)
    return launch_tail<T, V, false, true>(y, s, t, gate, r, rs, rt, out, rows,
                                          hw, c, stream);
  return launch_tail<T, V, false, false>(y, s, t, gate, r, rs, rt, out, rows,
                                         hw, c, stream);
}

template <typename T>
int run_tail(const T* y, const float* s, const float* t, const T* gate,
         const T* r, const float* rs, const float* rt, T* out, int batch,
         int hw, int c, void* stream) {
  const long long rows = (long long)batch * hw;
  if (batch <= 0 || hw <= 0 || c <= 0 || rows > INT_MAX ||
      (rs == nullptr) != (rt == nullptr))
    return (int)cudaErrorInvalidValue;
  if (c % WIDE<T> != 0 || !aligned(y) || !aligned(r) || !aligned(out) ||
      (gate != nullptr && !aligned(gate)))
    return (int)cudaErrorInvalidValue;
  return tail_variant<T, WIDE<T>>(y, s, t, gate, r, rs, rt, out, rows, hw, c,
                                  (cudaStream_t)stream);
}

template <typename T, int V>
int launch_pool(const T* y, T* out, const float* s, const float* t,
                long long pixels, int ho, int wo, int h, int w, int c,
                cudaStream_t stream) {
  const Shape sh = shape(c / V);
  affine_relu_pool2x2_kernel<T, V><<<walk_grid(pixels, sh),
                                     dim3(sh.lx, sh.ly), 0, stream>>>(
      y, out, s, t, pixels, ho, wo, h, w, c);
  return (int)cudaGetLastError();
}

template <typename T>
int run_pool(const T* y, T* out, const float* s, const float* t, int batch,
             int h, int w, int c, void* stream) {
  if (batch <= 0 || h < 2 || w < 2 || c <= 0) return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)batch * (h / 2) * (w / 2);
  if (pixels > INT_MAX) return (int)cudaErrorInvalidValue;
  if (c % WIDE<T> != 0 || !aligned(y) || !aligned(out))
    return (int)cudaErrorInvalidValue;
  return launch_pool<T, WIDE<T>>(y, out, s, t, pixels, h / 2, w / 2, h, w, c,
                                 (cudaStream_t)stream);
}

using bf16 = __nv_bfloat16;

}  // namespace

// y, out, r [batch, hw, c] contiguous (NHWC with hw = h x w); gate
// [batch, c] or NULL (no gate); rs, rt fp32 [c] or both NULL (identity
// shortcut); s, t fp32 [c]; squeeze's out [batch, c]; the pool's y
// [batch, h, w, c] and out [batch, h / 2, w / 2, c]. Each function
// launches on `stream` and returns the cudaError_t of the launch
// (0 = success).
extern "C" int affine_relu_f32(const float* y, float* out, const float* s,
                               const float* t, int batch, int hw, int c,
                               void* stream) {
  return run_relu<float>(y, out, s, t, batch, hw, c, stream);
}

extern "C" int affine_relu_bf16(const void* y, void* out, const float* s,
                                const float* t, int batch, int hw, int c,
                                void* stream) {
  return run_relu<bf16>(static_cast<const bf16*>(y), static_cast<bf16*>(out), s, t,
                    batch, hw, c, stream);
}

extern "C" int affine_squeeze_f32(const float* y, float* out, const float* s,
                                  const float* t, int batch, int hw, int c,
                                  void* stream) {
  return run_squeeze<float>(y, out, s, t, batch, hw, c, stream);
}

extern "C" int affine_squeeze_bf16(const void* y, void* out, const float* s,
                                   const float* t, int batch, int hw, int c,
                                   void* stream) {
  return run_squeeze<bf16>(static_cast<const bf16*>(y), static_cast<bf16*>(out), s,
                       t, batch, hw, c, stream);
}

extern "C" int affine_gate_add_relu_f32(const float* y, const float* s,
                                        const float* t, const float* gate,
                                        const float* r, const float* rs,
                                        const float* rt, float* out, int batch,
                                        int hw, int c, void* stream) {
  return run_tail<float>(y, s, t, gate, r, rs, rt, out, batch, hw, c, stream);
}

extern "C" int affine_gate_add_relu_bf16(const void* y, const float* s,
                                         const float* t, const void* gate,
                                         const void* r, const float* rs,
                                         const float* rt, void* out, int batch,
                                         int hw, int c, void* stream) {
  return run_tail<bf16>(static_cast<const bf16*>(y), s, t,
                    static_cast<const bf16*>(gate), static_cast<const bf16*>(r),
                    rs, rt, static_cast<bf16*>(out), batch, hw, c, stream);
}

extern "C" int affine_relu_pool2x2_f32(const float* y, float* out,
                                       const float* s, const float* t,
                                       int batch, int h, int w, int c,
                                       void* stream) {
  return run_pool<float>(y, out, s, t, batch, h, w, c, stream);
}

extern "C" int affine_relu_pool2x2_bf16(const void* y, void* out,
                                        const float* s, const float* t,
                                        int batch, int h, int w, int c,
                                        void* stream) {
  return run_pool<bf16>(static_cast<const bf16*>(y), static_cast<bf16*>(out),
                        s, t, batch, h, w, c, stream);
}
