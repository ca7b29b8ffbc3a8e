// The student's train-mode BatchNorm and the ReLU that follows it, forward
// and backward, in bf16 with fp32 statistics.
//
// Replaces no TPU kernel: the JAX package leaves Flax's masked BatchNorm
// to XLA, which fuses its reductions and elementwise work by itself. The
// port's eager version (models/vggm.py, _batch_norm_train, then F.relu)
// cast the bf16 activation to an fp32 copy and ran the masked sums, the
// square, the centring, the scale, the shift, the cast back and the ReLU
// as separate passes over tensors of the activation's size, and autograd
// replayed about as many in the backward: two thirds of the distillation
// step's device time and about 390 of its 684 launches.
//
// The function (the eager _batch_norm_train computes it op by op):
// w[n] = (mask[n] > 0), or 1 without a mask; count = sum(w) x h x w;
// mean = s1 / count, var = clamp(s2 / count - mean^2, 0) with s1, s2 the
// w-weighted sums of x and x^2 in fp32; scale = gamma rsqrt(var + eps),
// shift = beta - mean scale; y = relu(x scale + shift) (RELU) or the
// affine alone, rounded to bf16 once; with `update` the running
// statistics become keep x running + take x batch (Flax: 0.9 and 0.1,
// the biased variance). Rows with w = 0 are normalised all the same but
// add nothing to the statistics or to their gradient.
//
// The backward recomputes z = x scale + shift (the same fmaf as the
// forward, so the ReLU's mask is the forward's own): g = dy where z > 0
// (RELU) or dy. Over all rows: Sg = sum g, Sgc = sum g (x - mean). Then
// dbeta = Sg, dgamma = r Sgc (r = rsqrt(var + eps)), dvar = -Sgc gamma
// r^3 / 2 where the clamp let the variance through (s2/count - mean^2
// >= 0, autograd's rule for clamp) and 0 elsewhere, dmean = -scale Sg -
// 2 mean dvar, dmean2 = dvar; dx = g scale + w[n] (a + b x) with a =
// dmean / count and b = 2 dmean2 / count.
//
// What bounds them on the card: device-memory bytes. A few operations an
// element against 2 to 6 bytes. The least traffic is 10 bytes an element
// (x in and y out forward; dy and x in and dx out backward); two passes
// each way move 16: stats reads x (2), apply reads x and writes y (4),
// the backward reduction reads dy and x (4), dx reads both and writes dx
// (6). At the student's batch 64 the six BatchNorms see 395.6M elements a
// step, 6.33 GB, 1.89 ms at 3.35 TB/s. The design:
// - Every tensor is NHWC, [batch, hw, c] contiguous (the student keeps
//   its activations channels_last). A lane owns one 16-byte vector of 8
//   channels of a row; the block's lanes across (lx, a divisor of the
//   row's vectors between 8 and 32 where there is one, so that no lane
//   idles) cover lx x 16 bytes of a row and its other threads the next
//   rows: a warp reads contiguous memory.
// - The row walks (all four passes) give each block one image and a
//   chunk of its rows, blockIdx.x = image x chunks + chunk, blockIdx.y
//   the channel tile: a row's weight w[n] is the block's, read once, and
//   a block of an image with w = 0 reads nothing in the stats pass.
// - The two reductions (stats, backward) keep their sums in registers,
//   two per channel of the lane's vector, meet in shared memory down the
//   block's rows in a fixed order and write one row of fp32 partials a
//   block, [blocks, 2c]; at most one wave of blocks (132 SMs x 4, the
//   residency their 64 registers allow), so that none waits on a second
//   wave and the partials stay few (512 rows at the student's first
//   layer).
// - A finalize kernel (32 channels x 32 row groups a block) sums a
//   column of partials in a fixed order, then a tree: no atomics, so a
//   run repeats bit for bit. The forward's forms the count from the mask
//   on the device (no host read), scale, shift and the statistics the
//   backward needs, and updates the running ones; the backward's forms
//   dgamma, dbeta, a and b.
// - The apply passes walk the same grid with more blocks (132 x 8 x 2).
//   UNROLL rows of 16-byte loads in flight a lane.
// There is no narrower path: the launchers refuse c that is not a
// multiple of 8, a base pointer that is not 16-byte aligned, or sizes
// past what the offsets hold (cudaErrorInvalidValue; ops/train_bn.py
// raises before that).
// ReLU keeps a NaN (PyTorch's relu does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr int V = 8;            // bf16 channels in a lane's 16-byte vector
constexpr int MIN_LANES = 8;
constexpr int MAX_LANES = 32;
constexpr int UNROLL = 4;       // rows a lane has in flight
constexpr long long REDUCE_BLOCKS = 132LL * 4;    // one wave: 4 blocks an SM
constexpr long long APPLY_BLOCKS = 132LL * 8 * 2;
constexpr int FIN_X = 32;       // finalize: channels a block
constexpr int FIN_Y = 32;       // finalize: partial-row groups a block

using bf16 = __nv_bfloat16;

struct Vec {
  uint32_t u[4];
};

__device__ __forceinline__ void load(const bf16* p, Vec& w) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  w.u[0] = r.x, w.u[1] = r.y, w.u[2] = r.z, w.u[3] = r.w;
}

// bf16 element i of a vector is the high half of a float, exactly.
__device__ __forceinline__ float element(const Vec& w, int i) {
  return __uint_as_float(i & 1 ? w.u[i / 2] & 0xFFFF0000u : w.u[i / 2] << 16);
}

// Round eight floats to bf16 (round to nearest even) and store them.
__device__ __forceinline__ void store(bf16* p, const float (&v)[V]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ float relu(float v) {
  return v > 0.0f || v != v ? v : 0.0f;
}

// Eight consecutive floats of a per-channel vector.
__device__ __forceinline__ void load8(const float* __restrict__ p, int ch,
                                      float (&v)[V]) {
  const float4 a = *reinterpret_cast<const float4*>(p + ch);
  const float4 b = *reinterpret_cast<const float4*>(p + ch + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// The block's image, its lane and the rows [r0, r1) of the image it walks.
struct Walk {
  int image, lane, r0, r1;
};

__device__ __forceinline__ Walk walk(int hw, int chunks, int span) {
  Walk k;
  k.image = blockIdx.x / chunks;
  const int chunk = blockIdx.x - k.image * chunks;
  k.lane = blockIdx.y * blockDim.x + threadIdx.x;
  k.r0 = chunk * span;
  k.r1 = min(hw, k.r0 + span);
  return k;
}

// Sum each thread's a and b down the block's rows in a fixed order and
// write the block's row of partials: part[row][ch] the a sums,
// part[row][c + ch] the b sums, for the channels of the block's tile.
__device__ __forceinline__ void block_partials(const float (&a)[V],
                                               const float (&b)[V],
                                               float* __restrict__ part,
                                               long long row, int c) {
  __shared__ float sh[THREADS * 2 * V];
  const int width = blockDim.x * V;  // channels of the tile
  float* mine = sh + threadIdx.y * 2 * width + threadIdx.x * V;
#pragma unroll
  for (int i = 0; i < V; ++i) mine[i] = a[i], mine[width + i] = b[i];
  __syncthreads();
  const int threads = blockDim.x * blockDim.y;
  for (int t = threadIdx.y * blockDim.x + threadIdx.x; t < 2 * width;
       t += threads) {
    float s = 0.0f;
    for (int y = 0; y < (int)blockDim.y; ++y) s += sh[y * 2 * width + t];
    const int which = t >= width;
    const int ch = blockIdx.y * width + t - which * width;
    if (ch < c) part[row * 2 * c + which * c + ch] = s;
  }
}

// The w-weighted sums of x and x^2 of the block's rows: one row of
// partials a block. A block of an image with w = 0 writes zeros.
__global__ void __launch_bounds__(THREADS, 4)
    bn_stats_kernel(const bf16* __restrict__ x, const float* __restrict__ mask,
                    float* __restrict__ part, int hw, int c, int chunks,
                    int span) {
  const Walk k = walk(hw, chunks, span);
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = 0.0f, s2[i] = 0.0f;
  if (k.lane * V < c && (mask == nullptr || mask[k.image] > 0.0f)) {
    const bf16* base = x + (long long)k.image * hw * c + k.lane * V;
    const int step = blockDim.y;
    for (int r = k.r0 + threadIdx.y; r < k.r1; r += UNROLL * step) {
      Vec w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (r + u * step < k.r1)
          load(base + (long long)(r + u * step) * c, w[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r + u * step >= k.r1) break;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float v = element(w[u], i);
          s1[i] += v;
          s2[i] = fmaf(v, v, s2[i]);
        }
      }
    }
  }
  block_partials(s1, s2, part, blockIdx.x, c);
}

// g = dy where z = x scale + shift > 0 (RELU) or dy; the sums of g and of
// g (x - mean) over the block's rows, every row whatever its weight: one
// row of partials a block.
template <bool RELU>
__global__ void __launch_bounds__(THREADS, 4)
    bn_grad_reduce_kernel(const bf16* __restrict__ dy,
                          const bf16* __restrict__ x,
                          const float* __restrict__ scale,
                          const float* __restrict__ shift,
                          const float* __restrict__ mean,
                          float* __restrict__ part, int hw, int c, int chunks,
                          int span) {
  constexpr int U = UNROLL / 2;  // two loads a row
  const Walk k = walk(hw, chunks, span);
  float sg[V], sgc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sg[i] = 0.0f, sgc[i] = 0.0f;
  if (k.lane * V < c) {
    const int ch = k.lane * V;
    float sc[V], sf[V], mu[V];
    load8(scale, ch, sc);
    load8(shift, ch, sf);
    load8(mean, ch, mu);
    const long long off = (long long)k.image * hw * c + ch;
    const int step = blockDim.y;
    for (int r = k.r0 + threadIdx.y; r < k.r1; r += U * step) {
      Vec wd[U], wx[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u * step < k.r1) {
          const long long q = off + (long long)(r + u * step) * c;
          load(dy + q, wd[u]);
          load(x + q, wx[u]);
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * step >= k.r1) break;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xv = element(wx[u], i);
          float g = element(wd[u], i);
          if (RELU && !(fmaf(xv, sc[i], sf[i]) > 0.0f)) g = 0.0f;
          sg[i] += g;
          sgc[i] = fmaf(g, xv - mu[i], sgc[i]);
        }
      }
    }
  }
  block_partials(sg, sgc, part, blockIdx.x, c);
}

// y = relu(x scale + shift) (RELU) or x scale + shift.
template <bool RELU>
__global__ void __launch_bounds__(THREADS)
    bn_apply_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, int hw, int c, int chunks,
                    int span) {
  const Walk k = walk(hw, chunks, span);
  if (k.lane * V >= c) return;
  const int ch = k.lane * V;
  float sc[V], sf[V];
  load8(scale, ch, sc);
  load8(shift, ch, sf);
  const long long off = (long long)k.image * hw * c + ch;
  const int step = blockDim.y;
  for (int r = k.r0 + threadIdx.y; r < k.r1; r += UNROLL * step) {
    Vec w[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (r + u * step < k.r1)
        load(x + off + (long long)(r + u * step) * c, w[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u * step >= k.r1) break;
      float v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        v[i] = fmaf(element(w[u], i), sc[i], sf[i]);
        if (RELU) v[i] = relu(v[i]);
      }
      store(y + off + (long long)(r + u * step) * c, v);
    }
  }
}

// dx = g scale + w[n] (a + b x); coef is [4, c]: dgamma, dbeta, a, b.
template <bool RELU>
__global__ void __launch_bounds__(THREADS)
    bn_dx_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ x,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift,
                 const float* __restrict__ coef, const float* __restrict__ mask,
                 bf16* __restrict__ dx, int hw, int c, int chunks, int span) {
  constexpr int U = UNROLL / 2;
  const Walk k = walk(hw, chunks, span);
  if (k.lane * V >= c) return;
  const int ch = k.lane * V;
  const bool counted = mask == nullptr || mask[k.image] > 0.0f;
  float sc[V], sf[V], ca[V], cb[V];
  load8(scale, ch, sc);
  load8(shift, ch, sf);
  load8(coef + 2 * c, ch, ca);
  load8(coef + 3 * c, ch, cb);
  const long long off = (long long)k.image * hw * c + ch;
  const int step = blockDim.y;
  for (int r = k.r0 + threadIdx.y; r < k.r1; r += U * step) {
    Vec wd[U], wx[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + u * step < k.r1) {
        const long long q = off + (long long)(r + u * step) * c;
        load(dy + q, wd[u]);
        load(x + q, wx[u]);
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * step >= k.r1) break;
      float v[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xv = element(wx[u], i);
        float g = element(wd[u], i);
        if (RELU && !(fmaf(xv, sc[i], sf[i]) > 0.0f)) g = 0.0f;
        v[i] = counted ? fmaf(g, sc[i], fmaf(cb[i], xv, ca[i])) : g * sc[i];
      }
      store(dx + off + (long long)(r + u * step) * c, v);
    }
  }
}

// The sums of column ch of part's first and second halves ([rows, 2c]),
// in a fixed order: thread (x, y) adds rows y, y + FIN_Y, ... in turn,
// then a tree over y. Every thread of the block returns its column's.
__device__ __forceinline__ void column_sums(const float* __restrict__ part,
                                            int rows, int c, int ch,
                                            float& a, float& b) {
  __shared__ float sa[FIN_Y][FIN_X + 1], sb[FIN_Y][FIN_X + 1];
  float p = 0.0f, q = 0.0f;
  if (ch < c) {
#pragma unroll 4
    for (int r = threadIdx.y; r < rows; r += FIN_Y) {
      p += part[(long long)r * 2 * c + ch];
      q += part[(long long)r * 2 * c + c + ch];
    }
  }
  sa[threadIdx.y][threadIdx.x] = p;
  sb[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  for (int s = FIN_Y / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.y < s) {
      sa[threadIdx.y][threadIdx.x] += sa[threadIdx.y + s][threadIdx.x];
      sb[threadIdx.y][threadIdx.x] += sb[threadIdx.y + s][threadIdx.x];
    }
    __syncthreads();
  }
  a = sa[0][threadIdx.x];
  b = sb[0][threadIdx.x];
}

// scale, shift and saved ([4, c]: mean, var, 1 where the clamp let the
// variance through else 0, count) from the stats partials; the running
// statistics updated in place with `update`. The arithmetic is written
// out with _rn intrinsics, so that no step is contracted into an fma:
// each is one rounding, as each of the eager code's ops is.
__global__ void __launch_bounds__(FIN_X * FIN_Y)
    bn_finalize_kernel(const float* __restrict__ part, int rows,
                       const float* __restrict__ mask, int batch, int hw, int c,
                       const float* __restrict__ weight,
                       const float* __restrict__ bias, float* running_mean,
                       float* running_var, float eps, float keep, float take,
                       int update, float* __restrict__ scale,
                       float* __restrict__ shift, float* __restrict__ saved) {
  const int ch = blockIdx.x * FIN_X + threadIdx.x;
  float s1, s2;
  column_sums(part, rows, c, ch, s1, s2);
  if (threadIdx.y != 0 || ch >= c) return;
  float n = (float)batch;
  if (mask != nullptr) {
    n = 0.0f;
    for (int i = 0; i < batch; ++i) n += mask[i] > 0.0f ? 1.0f : 0.0f;
  }
  const float count = __fmul_rn(n, (float)hw);
  const float mean = __fdiv_rn(s1, count);
  const float d = __fsub_rn(__fdiv_rn(s2, count), __fmul_rn(mean, mean));
  const float var = d < 0.0f ? 0.0f : d;  // a NaN stays NaN, as clamp's
  if (update) {
    running_mean[ch] = __fadd_rn(__fmul_rn(keep, running_mean[ch]),
                                 __fmul_rn(take, mean));
    running_var[ch] = __fadd_rn(__fmul_rn(keep, running_var[ch]),
                                __fmul_rn(take, var));
  }
  const float sc = __fmul_rn(__fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps))),
                             weight[ch]);
  scale[ch] = sc;
  shift[ch] = __fsub_rn(bias[ch], __fmul_rn(mean, sc));
  saved[ch] = mean;
  saved[c + ch] = var;
  saved[2 * c + ch] = d >= 0.0f ? 1.0f : 0.0f;
  saved[3 * c + ch] = count;
}

// coef ([4, c]: dgamma, dbeta, a, b) from the backward partials (Sg, Sgc)
// and the forward's saved statistics.
__global__ void __launch_bounds__(FIN_X * FIN_Y)
    bn_grad_finalize_kernel(const float* __restrict__ part, int rows, int c,
                            const float* __restrict__ saved,
                            const float* __restrict__ weight,
                            const float* __restrict__ scale, float eps,
                            float* __restrict__ coef) {
  const int ch = blockIdx.x * FIN_X + threadIdx.x;
  float sg, sgc;
  column_sums(part, rows, c, ch, sg, sgc);
  if (threadIdx.y != 0 || ch >= c) return;
  const float mean = saved[ch], var = saved[c + ch];
  const bool live = saved[2 * c + ch] != 0.0f;
  const float count = saved[3 * c + ch];
  const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  const float dvar = live ? -0.5f * sgc * weight[ch] * (r * r * r) : 0.0f;
  const float dmean = -scale[ch] * sg - (live ? 2.0f * mean * dvar : 0.0f);
  coef[ch] = r * sgc;
  coef[c + ch] = sg;
  coef[2 * c + ch] = dmean / count;
  coef[3 * c + ch] = 2.0f * dvar / count;
}

// Block shape for `vectors` 16-byte vectors a row: lx lanes across (a
// divisor of vectors in [MIN_LANES, MAX_LANES] where one exists, else
// all of them up to MAX_LANES, the last tile partly idle), the rest of
// the threads down the rows.
struct Layout {
  int lx, ly, tiles;
};

inline Layout layout(int vectors) {
  int lx = vectors < MAX_LANES ? vectors : MAX_LANES;
  for (int d = lx; d >= MIN_LANES; --d)
    if (vectors % d == 0) {
      lx = d;
      break;
    }
  return {lx, THREADS / lx, (vectors + lx - 1) / lx};
}

// Chunks of an image's rows for about `target` blocks, each thread with
// at least one row: at most `target` where `whole_wave` (the reductions,
// whose blocks then all run at once, with no second wave to wait on),
// else at least `target`.
inline int chunks_for(int batch, int hw, const Layout& l, long long target,
                      bool whole_wave) {
  const long long per_image = (long long)batch * l.tiles;
  long long per = whole_wave ? target / per_image
                             : (target + per_image - 1) / per_image;
  const long long most = (hw + l.ly - 1) / l.ly;
  if (per > most) per = most;
  return per < 1 ? 1 : (int)per;
}

inline bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

// The checks every row walk makes; the grid's x is batch x chunks.
inline bool valid(int batch, int hw, int c, int chunks) {
  return batch > 0 && hw > 0 && c > 0 && c % V == 0 && chunks > 0 &&
         (long long)batch * chunks <= INT_MAX &&
         (c / V + MIN_LANES - 1) / MIN_LANES <= 65535;
}

struct Grid {
  dim3 grid, block;
  int span;
};

inline Grid grid(int batch, int hw, int c, int chunks) {
  const Layout l = layout(c / V);
  return {dim3((unsigned)(batch * chunks), (unsigned)l.tiles),
          dim3((unsigned)l.lx, (unsigned)l.ly), (hw + chunks - 1) / chunks};
}

}  // namespace

// x, y, dy, dx [batch, hw, c] bf16 contiguous (NHWC with hw = h x w), c a
// multiple of 8, every base pointer 16-byte aligned; mask fp32 [batch] or
// NULL (every row counted); part fp32 [batch x chunks, 2c]; weight, bias,
// the running statistics, scale, shift and mean fp32 [c]; saved and coef
// fp32 [4, c]. Each function but the first launches on `stream` and
// returns the cudaError_t of the launch (0 = success).

// The chunks of an image's rows the two reductions walk: their partials
// have batch x chunks rows. -1 for sizes the kernels refuse.
extern "C" int train_bn_chunks(int batch, int hw, int c) {
  if (batch <= 0 || hw <= 0 || c <= 0 || c % V != 0) return -1;
  const int chunks = chunks_for(batch, hw, layout(c / V), REDUCE_BLOCKS, true);
  return valid(batch, hw, c, chunks) ? chunks : -1;
}

extern "C" int train_bn_stats_bf16(const void* x, const float* mask,
                                   float* part, int batch, int hw, int c,
                                   int chunks, void* stream) {
  if (!valid(batch, hw, c, chunks) || !aligned(x))
    return (int)cudaErrorInvalidValue;
  const Grid g = grid(batch, hw, c, chunks);
  bn_stats_kernel<<<g.grid, g.block, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), mask, part, hw, c, chunks, g.span);
  return (int)cudaGetLastError();
}

extern "C" int train_bn_finalize(const float* part, int rows,
                                 const float* mask, int batch, int hw, int c,
                                 const float* weight, const float* bias,
                                 float* running_mean, float* running_var,
                                 float eps, float keep, float take, int update,
                                 float* scale, float* shift, float* saved,
                                 void* stream) {
  if (rows <= 0 || batch <= 0 || hw <= 0 || c <= 0)
    return (int)cudaErrorInvalidValue;
  bn_finalize_kernel<<<(unsigned)((c + FIN_X - 1) / FIN_X),
                       dim3(FIN_X, FIN_Y), 0, (cudaStream_t)stream>>>(
      part, rows, mask, batch, hw, c, weight, bias, running_mean, running_var,
      eps, keep, take, update, scale, shift, saved);
  return (int)cudaGetLastError();
}

extern "C" int train_bn_apply_bf16(const void* x, void* y, const float* scale,
                                   const float* shift, int batch, int hw,
                                   int c, int relu, void* stream) {
  if (batch <= 0 || hw <= 0 || c <= 0 || c % V != 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = chunks_for(batch, hw, layout(c / V), APPLY_BLOCKS, false);
  if (!valid(batch, hw, c, chunks) || !aligned(x) || !aligned(y) ||
      !aligned(scale) || !aligned(shift))
    return (int)cudaErrorInvalidValue;
  const Grid g = grid(batch, hw, c, chunks);
  const bf16* xs = static_cast<const bf16*>(x);
  bf16* ys = static_cast<bf16*>(y);
  if (relu)
    bn_apply_kernel<true><<<g.grid, g.block, 0, (cudaStream_t)stream>>>(
        xs, ys, scale, shift, hw, c, chunks, g.span);
  else
    bn_apply_kernel<false><<<g.grid, g.block, 0, (cudaStream_t)stream>>>(
        xs, ys, scale, shift, hw, c, chunks, g.span);
  return (int)cudaGetLastError();
}

extern "C" int train_bn_reduce_bf16(const void* dy, const void* x,
                                    const float* scale, const float* shift,
                                    const float* mean, float* part, int batch,
                                    int hw, int c, int chunks, int relu,
                                    void* stream) {
  if (!valid(batch, hw, c, chunks) || !aligned(dy) || !aligned(x) ||
      !aligned(scale) || !aligned(shift) || !aligned(mean))
    return (int)cudaErrorInvalidValue;
  const Grid g = grid(batch, hw, c, chunks);
  const bf16* d = static_cast<const bf16*>(dy);
  const bf16* xs = static_cast<const bf16*>(x);
  if (relu)
    bn_grad_reduce_kernel<true><<<g.grid, g.block, 0,
                                   (cudaStream_t)stream>>>(
        d, xs, scale, shift, mean, part, hw, c, chunks, g.span);
  else
    bn_grad_reduce_kernel<false><<<g.grid, g.block, 0,
                                    (cudaStream_t)stream>>>(
        d, xs, scale, shift, mean, part, hw, c, chunks, g.span);
  return (int)cudaGetLastError();
}

extern "C" int train_bn_grad_finalize(const float* part, int rows, int c,
                                      const float* saved, const float* weight,
                                      const float* scale, float eps,
                                      float* coef, void* stream) {
  if (rows <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  bn_grad_finalize_kernel<<<(unsigned)((c + FIN_X - 1) / FIN_X),
                            dim3(FIN_X, FIN_Y), 0, (cudaStream_t)stream>>>(
      part, rows, c, saved, weight, scale, eps, coef);
  return (int)cudaGetLastError();
}

extern "C" int train_bn_dx_bf16(const void* dy, const void* x,
                                const float* scale, const float* shift,
                                const float* coef, const float* mask, void* dx,
                                int batch, int hw, int c, int relu,
                                void* stream) {
  if (batch <= 0 || hw <= 0 || c <= 0 || c % V != 0)
    return (int)cudaErrorInvalidValue;
  const int chunks = chunks_for(batch, hw, layout(c / V), APPLY_BLOCKS, false);
  if (!valid(batch, hw, c, chunks) || !aligned(dy) || !aligned(x) ||
      !aligned(dx) || !aligned(scale) || !aligned(shift) || !aligned(coef))
    return (int)cudaErrorInvalidValue;
  const Grid g = grid(batch, hw, c, chunks);
  const bf16* d = static_cast<const bf16*>(dy);
  const bf16* xs = static_cast<const bf16*>(x);
  bf16* out = static_cast<bf16*>(dx);
  if (relu)
    bn_dx_kernel<true><<<g.grid, g.block, 0, (cudaStream_t)stream>>>(
        d, xs, scale, shift, coef, mask, out, hw, c, chunks, g.span);
  else
    bn_dx_kernel<false><<<g.grid, g.block, 0, (cudaStream_t)stream>>>(
        d, xs, scale, shift, coef, mask, out, hw, c, chunks, g.span);
  return (int)cudaGetLastError();
}
