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
// compares per output; the least traffic is one read of x and one write
// of y (and of idx): at the train step's pool1 in bf16 1.22 GB in and
// 0.45 GB out, 0.50 ms at 3.35 TB/s. The first design (one thread per
// output element, 9 scalar 2-byte loads and a 64-bit index decode each)
// issued 9 load instructions per 2 bytes of output and reached a third of
// that bound. This design, the register walk:
// - A thread owns (b, oj, one channel vector) and a strip of output rows.
//   A channel vector is 16 bytes (8 bf16 or 4 fp32): loads of x and stores
//   of y are 16 bytes a lane, idx stores 8 (bf16) or 4 (fp32) bytes.
// - Rows first, then down the rows: for each input row the maximum over
//   columns 2oj, 2oj+1, 2oj+2 with its column, then rows 2oi, 2oi+1,
//   2oi+2 combined in that order by the same rule. Row 2oi+2's result is
//   carried as row 0 of output row oi+1 (its code offset 6 becomes 0), so
//   a thread loads and reduces each input row once; only a strip's first
//   row is read again, by the strip above (1 row in 2S+1). Column 2oj+2 is
//   also column 0 of the neighbouring lane group's window: L1 serves it.
// - The strip length S is chosen so that the grid holds about two full
//   waves of threads on 132 SMs, within 4..16 output rows: at the train
//   step's pool1 the cap of 16 leaves about 4.4 waves.
// - A thread decodes (b, oj, vector) once, in 32-bit; per row it only
//   advances its pointers (64-bit only for base pointers).
// - The columns and codes of the with-index walk are packed (4 bits a
//   column, a byte a code): with an int each, the bf16 walk held 91
//   registers, two blocks an SM, and reached 73% of its bound at pool1
//   against 83-88% without the index; packed, 80 registers and 79%.
// - Where C x the element size is not a multiple of 16 bytes, or a base
//   pointer is not 16-byte aligned, the launcher takes the same kernel
//   one element a lane. The model's pools (C = 96, 256, fresh tensors)
//   always take 16 bytes.
// Measured against it on an H100 (in turns, one card): the same walk fed
// from shared memory, each input row's band of 2 x 21 + 1 columns copied
// by one cp.async.bulk into a ring of 6 slots under mbarriers. It read
// no fewer bytes from device memory and paid a __syncthreads a row and
// 50 KB of shared memory a block: 0.4% faster at pool1 with the index,
// 7% slower at pool2 and 6.5% slower over the extraction shapes. Unrolling
// the walk by two rows (more loads in flight) raised the registers and
// lost 24% at pool1.
//
// Semantics are PyTorch's max_pool2d (and XLA's reduce_window max):
// running max from -inf in row-major window order, replaced when a value
// is strictly greater or is NaN. Rows first, then down the rows, with the
// same rule at both levels, picks the same winner: the FIRST maximum in
// row-major window order wins a tie (also XLA's SelectAndScatter with
// `ge`), the last NaN of the window wins (PyTorch's rule; XLA's `ge`
// differs there), +0 and -0 keep their order, and an all -inf window
// gives code 0. Taking the maximum down the columns first (the TPU
// kernel's order) gives the same value but another winner under ties.
// Compares are element by element: fmaxf and __hmax make NaNs canonical,
// may return either signed zero, and lose the winner. Max is exact, so
// the output is bitwise equal to F.max_pool2d in bf16 and in fp32.
//
// Backward. dx[b, i, j, c] = sum over the at most 2x2 windows (oi, oj)
// that cover (i, j) of dy[b, oi, oj, c] where the window's stored argmax
// is (i - 2 oi, j - 2 oj). What bounds it: bytes again. At pool1 with
// B=128 in bf16 it reads dy (303 MB) and the index (152 MB) and writes dx
// (1.23 GB): 0.50 ms at 3.35 TB/s. It gathers over the windows that cover
// each input element instead of scattering from each window: no atomics,
// no memset of dx, deterministic. The first design, one thread per input
// element with two dependent loads, waited on latency (8.8 ms at pool1);
// the second, one thread per scalar input column (b, j, c) down all the
// rows, made 1- and 2-byte loads and 64-byte warp stores, loaded each dy
// and code once for each of the three columns its window covers, and
// decoded its column with 64-bit divisions in a grid-stride loop: 0.908
// ms, 55% of the bound. This design, the strip walk:
// - A thread owns (b, window column oj in 0..wo, one 16-byte channel
//   vector) and a strip of output rows, chosen as the forward's. Per
//   output row it loads dy (16 bytes) and the codes (8 bytes in bf16, 4 in
//   fp32) of windows oj-1 and oj, and stores input rows 2k and 2k+1 of
//   columns 2oj and 2oj+1 as 16-byte stores. Row 2k+2's shares are carried
//   into the next output row; a strip below the first reads the row above
//   it once to seed them (1 row in 17 at pool1). Window oj-1's vectors are
//   also read by the neighbouring lane group, as its window oj.
//   The lane oj = wo writes the last column(s) (in window wo-1 alone, or
//   in none for an even width).
// - Registers decide the rest. dy stays in registers as loaded (bf16
//   pairs in 32-bit words), each element widened when used: as float
//   arrays the bf16 walk held 102 registers and took 5% longer. Left to
//   itself ptxas then gives it 97, two blocks an SM; __launch_bounds__
//   asks for three (80, no spills), which took pool1 from 74% to 79% of
//   its bound. Four (64) gave 78.7%.
// - The launcher takes the same template one element a lane where C x the
//   element size is not a multiple of 16 bytes, dy or dx is not 16-byte
//   aligned, or idx is not aligned to the vector's V bytes.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, each step against the
// one before it in turns in one call: 0.635 ms at pool1 (79% of its
// bound) and 0.095 at pool2 (80%); the column walk took 0.908 and 0.156.
// Two window columns a thread (three dy and code loads for two windows
// instead of four) took 155 registers, one block an SM, and 0.765 ms at
// pool1, slower than one column's 0.702 in the same call.
// The rule is autograd of F.max_pool2d on the card: its channels-last
// backward sums in fp32 from +0 over the windows that cover an element,
// oi ascending, then oj, and rounds once (__float2bfloat16 for bf16), but
// copies dy as it is to an element that one window alone covers (its row
// and its column each odd, 0, or 2ho or 2wo): -0.0 and NaN bits stay.
// The walk follows both, so dx is bitwise equal to it given the same
// winners.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_STRIP = 4, MAX_STRIP = 16;  // output rows a thread walks
constexpr long long FILL = 132LL * 2048 * 2;  // two waves of 132 full SMs

// One aligned unit of BYTES bytes from (or to) 32-bit words; a unit of 1
// or 2 bytes (a code, a bf16) in the low bits of word 0.
template <int BYTES>
__device__ __forceinline__ void load_words(const void* p, uint32_t* u) {
  if constexpr (BYTES == 16) {
    const uint4 r = *static_cast<const uint4*>(p);
    u[0] = r.x, u[1] = r.y, u[2] = r.z, u[3] = r.w;
  } else if constexpr (BYTES == 8) {
    const uint2 r = *static_cast<const uint2*>(p);
    u[0] = r.x, u[1] = r.y;
  } else if constexpr (BYTES == 4) {
    u[0] = *static_cast<const uint32_t*>(p);
  } else if constexpr (BYTES == 2) {
    u[0] = *static_cast<const unsigned short*>(p);
  } else {
    u[0] = *static_cast<const uint8_t*>(p);
  }
}

template <int BYTES>
__device__ __forceinline__ void store_words(void* p, const uint32_t* u) {
  if constexpr (BYTES == 16) {
    *static_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  } else if constexpr (BYTES == 8) {
    *static_cast<uint2*>(p) = make_uint2(u[0], u[1]);
  } else if constexpr (BYTES == 4) {
    *static_cast<uint32_t*>(p) = u[0];
  } else if constexpr (BYTES == 2) {
    *static_cast<unsigned short*>(p) = (unsigned short)u[0];
  } else {
    *static_cast<uint8_t*>(p) = (uint8_t)u[0];
  }
}

// Element i of V elements of T held as 32-bit words (bf16: the high half
// of a float, exactly).
template <typename T>
__device__ __forceinline__ float element(const uint32_t* u, int i) {
  if constexpr (std::is_same<T, float>::value) return __uint_as_float(u[i]);
  else return __uint_as_float(i & 1 ? u[i / 2] & 0xFFFF0000u : u[i / 2] << 16);
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  constexpr int BYTES = V * (int)sizeof(T);
  uint32_t u[(BYTES + 3) / 4];
  load_words<BYTES>(p, u);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = element<T>(u, i);
}

// y's V elements, each the winner's own bits: every m is an input element
// moved through a float register (bf16 as its high half), never computed.
// F.max_pool2d on the card also returns the winning NaN's payload (a bf16
// NaN 0xFFFF comes out as 0xFFFF), so no NaN is made canonical here.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&m)[V]) {
  constexpr int BYTES = V * (int)sizeof(T);
  uint32_t u[(BYTES + 3) / 4];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      u[i] = __float_as_uint(m[i]);
    } else {
      const uint32_t half = __float_as_uint(m[i]) >> 16;
      if (i & 1) u[i / 2] |= half << 16;
      else u[i / 2] = half;
    }
  }
  store_words<BYTES>(p, u);
}

// The replace rule of the running max: strictly greater, or NaN.
__device__ __forceinline__ bool wins(float v, float m) {
  return v > m || isnan(v);
}

// One input row of a window column triple: per element the maximum over
// columns 0, 1, 2 (p, p + c, p + 2c), and its column in `cols`, 4 bits an
// element (V <= 8), so that the with-index walk keeps three rows' columns
// in three registers.
template <typename T, int V>
__device__ __forceinline__ void reduce_row(const T* p, int c, float (&m)[V],
                                           uint32_t& cols) {
  float a[V], b[V];
  load_vec<T, V>(p, m);
  load_vec<T, V>(p + c, a);
  load_vec<T, V>(p + 2 * c, b);
  cols = 0;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    uint32_t col = 0;
    if (wins(a[i], m[i])) m[i] = a[i], col = 1;
    if (wins(b[i], m[i])) m[i] = b[i], col = 2;
    cols |= col << (4 * i);
  }
}

// Output row from the carried row 0 (top) and rows 1 and 2, then row 2
// becomes the next output row's row 0. Codes 3 * row + col, one byte each.
template <typename T, int V, bool IDX>
__device__ __forceinline__ void emit(float (&top)[V], uint32_t& top_cols,
                                     const float (&mid)[V], uint32_t mid_cols,
                                     const float (&bot)[V], uint32_t bot_cols,
                                     T* y, uint8_t* idx) {
  float m[V];
  uint32_t code[(V + 3) / 4] = {};
#pragma unroll
  for (int i = 0; i < V; ++i) {
    uint32_t k = (top_cols >> (4 * i)) & 0xF;
    m[i] = top[i];
    if (wins(mid[i], m[i])) m[i] = mid[i], k = 3 + ((mid_cols >> (4 * i)) & 0xF);
    if (wins(bot[i], m[i])) m[i] = bot[i], k = 6 + ((bot_cols >> (4 * i)) & 0xF);
    code[i / 4] |= k << (8 * (i % 4));
    top[i] = bot[i];
  }
  top_cols = bot_cols;
  store_vec<T, V>(y, m);
  if constexpr (IDX) store_words<V>(idx, code);
}

// The register walk: one thread per (b, oj, vector) column and strip of
// output rows; V elements a vector. `columns` = batch * wo * (c / V).
template <typename T, int V, bool IDX>
__global__ void __launch_bounds__(THREADS)
pool_walk_kernel(const T* __restrict__ x, T* __restrict__ y,
                 uint8_t* __restrict__ idx, int h, int w, int c, int ho,
                 int wo, int strip, int columns) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  if (col >= columns) return;
  const int nv = c / V;
  const int t = col / nv, vec = col - t * nv;
  const int b = t / wo, oj = t - b * wo;
  const int oi0 = blockIdx.y * strip, rows = min(strip, ho - oi0);
  const long long row_in = (long long)w * c, row_out = (long long)wo * c;
  const T* p = x + ((long long)b * h + 2 * oi0) * row_in + 2LL * oj * c + vec * V;
  const long long o = ((long long)b * ho + oi0) * row_out + (long long)oj * c + vec * V;
  T* q = y + o;
  uint8_t* a = IDX ? idx + o : nullptr;
  float top[V], mid[V], bot[V];
  uint32_t top_cols, mid_cols, bot_cols;
  reduce_row<T, V>(p, c, top, top_cols);
  for (int k = 0; k < rows; ++k) {
    reduce_row<T, V>(p + row_in, c, mid, mid_cols);
    reduce_row<T, V>(p + 2 * row_in, c, bot, bot_cols);
    emit<T, V, IDX>(top, top_cols, mid, mid_cols, bot, bot_cols, q, a);
    p += 2 * row_in;
    q += row_out;
    if constexpr (IDX) a += row_out;
  }
}

// Byte i of V codes held as 32-bit words.
__device__ __forceinline__ uint32_t code_at(const uint32_t* u, int i) {
  return (u[i / 4] >> (8 * (i % 4))) & 0xFF;
}

// dy where the window's winner is at `at`, else +0.0: a miss never reads
// dy as a factor, and adds +0.0 to a sum, which leaves it bitwise as a
// skipped add would (sums start at +0 and never become -0).
__device__ __forceinline__ float routed(uint32_t code, uint32_t at, float g) {
  return code == at ? g : 0.0f;
}

// V fp32 sums, rounded once to T by the conversion PyTorch's own float ->
// bf16 store uses on sm_80 and later (__float2bfloat16: to nearest even).
template <typename T, int V>
__device__ __forceinline__ void store_sums(T* p, const float (&s)[V]) {
  constexpr int BYTES = V * (int)sizeof(T);
  uint32_t u[(BYTES + 3) / 4];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      u[i] = __float_as_uint(s[i]);
    } else {
      const uint32_t half = __bfloat16_as_ushort(__float2bfloat16(s[i]));
      if (i & 1) u[i / 2] |= half << 16;
      else u[i / 2] = half;
    }
  }
  store_words<BYTES>(p, u);
}

// The backward's strip walk: one thread per (b, window column oj in
// 0..wo, channel vector) and strip of output rows. It reads windows oj-1
// ("left") and oj ("right") and writes input columns 2oj (left's position
// 2, right's 0) and 2oj+1 (right's 1), where they are < w; the lane oj =
// wo writes the last column(s), in no window but oj-1. Per output row k:
// input row 2k gets the carry (window row k-1's position 2) and row k's
// positions 0, input row 2k+1 row k's positions 1, and positions 2 become
// the carry. The rule is PyTorch's channels-last backward: an element in
// two or more windows gets the fp32 sum from +0 over them, oi ascending,
// then oj, rounded once; an element in one window alone gets that
// window's dy as it is (or +0 where it lost): -0.0 and NaN bits kept.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS, 3)
pool_bwd_walk_kernel(const T* __restrict__ dy, const uint8_t* __restrict__ idx,
                     T* __restrict__ dx, int h, int w, int c, int ho, int wo,
                     int strip, int lanes) {
  constexpr int WORDS = (V * (int)sizeof(T) + 3) / 4, CODES = (V + 3) / 4;
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= lanes) return;
  const int nv = c / V;
  const int t = lane / nv, vec = lane - t * nv;
  const int b = t / (wo + 1), oj = t - b * (wo + 1);
  const int oi0 = blockIdx.y * strip, rows = min(strip, ho - oi0);
  const bool left = oj >= 1, right = oj < wo, both = left && right;
  const bool odd = 2 * oj + 1 < w;  // column 2oj+1 exists
  const long long row_in = (long long)w * c, row_out = (long long)wo * c;
  const long long o = ((long long)b * ho + oi0) * row_out + (long long)oj * c + vec * V;
  const T* g = dy + o;  // window oj; oj-1 is c elements back
  const uint8_t* a = idx + o;
  T* out = dx + ((long long)b * h + 2 * oi0) * row_in + 2LL * oj * c + vec * V;
  // a window outside the image keeps dy 0 and code 255, which no position
  // matches
  uint32_t gl[WORDS] = {}, gr[WORDS] = {}, al[CODES], ar[CODES];
#pragma unroll
  for (int j = 0; j < CODES; ++j) al[j] = ar[j] = 0xFFFFFFFFu;
  auto load = [&](long long k) {  // output row oi0 + k
    if (left) {
      load_words<V * (int)sizeof(T)>(g + k * row_out - c, gl);
      load_words<V>(a + k * row_out - c, al);
    }
    if (right) {
      load_words<V * (int)sizeof(T)>(g + k * row_out, gr);
      load_words<V>(a + k * row_out, ar);
    }
  };
  // An input row that one row of windows covers, from its positions base
  // (left's base + 2, right's base; right's base + 1 for column 2oj+1):
  // column 2oj sums where both windows exist, else it copies one; column
  // 2oj+1 copies.
  auto shares = [&](int base, float (&e)[V], float (&d)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float l = routed(code_at(al, i), base + 2, element<T>(gl, i));
      const float r = routed(code_at(ar, i), base, element<T>(gr, i));
      e[i] = both ? (0.0f + l) + r : left ? l : r;
      d[i] = routed(code_at(ar, i), base + 1, element<T>(gr, i));
    }
  };
  auto store_shares = [&](T* p, const float (&e)[V], const float (&d)[V]) {
    if (both) store_sums<T, V>(p, e);
    else store_vec<T, V>(p, e);  // dy's own bits
    if (odd) store_vec<T, V>(p + c, d);
  };
  float ce[V] = {}, co[V] = {};  // carry: row 2k as window row k-1 alone gives it
  float e[V], d[V];
  if (oi0 > 0) {
    load(-1);
    shares(6, ce, co);
  }
  for (int k = 0; k < rows; ++k) {
    load(k);
    if (oi0 + k == 0) {  // input row 0 lies in window row 0 alone
      shares(0, e, d);
      store_shares(out, e, d);
    } else {  // in window rows k-1 and k: sums
#pragma unroll
      for (int i = 0; i < V; ++i) {
        e[i] = ((0.0f + ce[i]) + routed(code_at(al, i), 2, element<T>(gl, i))) +
               routed(code_at(ar, i), 0, element<T>(gr, i));
        d[i] = (0.0f + co[i]) + routed(code_at(ar, i), 1, element<T>(gr, i));
      }
      store_sums<T, V>(out, e);
      if (odd) store_sums<T, V>(out + c, d);
    }
    shares(3, e, d);
    store_shares(out + row_in, e, d);
    shares(6, ce, co);
    out += 2 * row_in;
  }
  if (oi0 + rows == ho) {  // row 2ho in window row ho-1 alone, then none
    store_shares(out, ce, co);
    if (2 * ho + 1 < h) {
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = 0.0f;
      store_vec<T, V>(out + row_in, e);
      if (odd) store_vec<T, V>(out + row_in + c, e);
    }
  }
}

// Output rows a thread walks: about FILL threads over the whole grid,
// within [MIN_STRIP, MAX_STRIP] and at most 65535 strips.
int strip_rows(long long columns, int ho) {
  long long s = columns * ho / FILL;
  s = s < MIN_STRIP ? MIN_STRIP : s > MAX_STRIP ? MAX_STRIP : s;
  s = s > ho ? ho : s;
  const long long least = (ho + 65534) / 65535;
  return (int)(s < least ? least : s);
}

// A thread's 32-bit column index covers the grid: a launch of 2^31 or
// more columns (a y of 2^31 channel vectors) is refused.
template <typename T, int V, bool IDX>
int launch_walk(const T* x, T* y, uint8_t* idx, int batch, int h, int w,
                int c, int ho, int wo, cudaStream_t stream) {
  const long long columns = (long long)batch * wo * (c / V);
  if (columns > INT_MAX - THREADS) return (int)cudaErrorInvalidValue;
  const int strip = strip_rows(columns, ho);
  const dim3 grid((unsigned)((columns + THREADS - 1) / THREADS),
                  (unsigned)((ho + strip - 1) / strip));
  pool_walk_kernel<T, V, IDX><<<grid, THREADS, 0, stream>>>(
      x, y, idx, h, w, c, ho, wo, strip, (int)columns);
  return (int)cudaGetLastError();
}

// 16-byte vectors where c fills them and every base pointer is aligned to
// 16 bytes, else the same walk one element a lane.
template <typename T, bool IDX>
int launch(const T* x, T* y, uint8_t* idx, int batch, int h, int w, int c,
           void* stream_) {
  if (batch <= 0 || h < 3 || w < 3 || c <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_;
  const int ho = (h - 3) / 2 + 1, wo = (w - 3) / 2 + 1;
  constexpr int WIDE = 16 / (int)sizeof(T);
  const bool wide = c % WIDE == 0 && ((uintptr_t)x | (uintptr_t)y) % 16 == 0 &&
                    (!IDX || (uintptr_t)idx % WIDE == 0);
  if (wide)
    return launch_walk<T, WIDE, IDX>(x, y, idx, batch, h, w, c, ho, wo, stream);
  return launch_walk<T, 1, IDX>(x, y, idx, batch, h, w, c, ho, wo, stream);
}

// As launch_walk: one lane per window column and one more (the tail
// column); a launch of 2^31 or more lanes is refused.
template <typename T, int V>
int launch_bwd_walk(const T* dy, const uint8_t* idx, T* dx, int batch, int h,
                    int w, int c, int ho, int wo, cudaStream_t stream) {
  const long long lanes = (long long)batch * (wo + 1) * (c / V);
  if (lanes > INT_MAX - THREADS) return (int)cudaErrorInvalidValue;
  const int strip = strip_rows(lanes, ho);
  const dim3 grid((unsigned)((lanes + THREADS - 1) / THREADS),
                  (unsigned)((ho + strip - 1) / strip));
  pool_bwd_walk_kernel<T, V><<<grid, THREADS, 0, stream>>>(
      dy, idx, dx, h, w, c, ho, wo, strip, (int)lanes);
  return (int)cudaGetLastError();
}

// 16-byte dy and dx vectors where c fills them, dy and dx are 16-byte
// aligned and idx is aligned to its V bytes, else one element a lane.
template <typename T>
int launch_bwd(const T* dy, const uint8_t* idx, T* dx, int batch, int h,
               int w, int c, void* stream_) {
  if (batch <= 0 || h < 3 || w < 3 || c <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_;
  const int ho = (h - 3) / 2 + 1, wo = (w - 3) / 2 + 1;
  constexpr int WIDE = 16 / (int)sizeof(T);
  const bool wide = c % WIDE == 0 && ((uintptr_t)dy | (uintptr_t)dx) % 16 == 0 &&
                    (uintptr_t)idx % WIDE == 0;
  if (wide)
    return launch_bwd_walk<T, WIDE>(dy, idx, dx, batch, h, w, c, ho, wo, stream);
  return launch_bwd_walk<T, 1>(dy, idx, dx, batch, h, w, c, ho, wo, stream);
}

}  // namespace

// x [batch, h, w, c] contiguous, y [batch, (h-3)/2+1, (w-3)/2+1, c],
// idx (the with-index variants) uint8 of y's shape. dy/idx/dx: the
// backward of the pool of an [batch, h, w, c] input. Each function
// launches on `stream` and returns the cudaError_t of the launch
// (0 = success).
extern "C" int max_pool_3x3s2_f32(const float* x, float* y, int batch, int h,
                                  int w, int c, void* stream) {
  return launch<float, false>(x, y, nullptr, batch, h, w, c, stream);
}

extern "C" int max_pool_3x3s2_bf16(const void* x, void* y, int batch, int h,
                                   int w, int c, void* stream) {
  return launch<__nv_bfloat16, false>(static_cast<const __nv_bfloat16*>(x),
                                      static_cast<__nv_bfloat16*>(y), nullptr,
                                      batch, h, w, c, stream);
}

extern "C" int max_pool_3x3s2_idx_f32(const float* x, float* y, uint8_t* idx,
                                      int batch, int h, int w, int c,
                                      void* stream) {
  return launch<float, true>(x, y, idx, batch, h, w, c, stream);
}

extern "C" int max_pool_3x3s2_idx_bf16(const void* x, void* y, uint8_t* idx,
                                       int batch, int h, int w, int c,
                                       void* stream) {
  return launch<__nv_bfloat16, true>(static_cast<const __nv_bfloat16*>(x),
                                     static_cast<__nv_bfloat16*>(y), idx,
                                     batch, h, w, c, stream);
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
