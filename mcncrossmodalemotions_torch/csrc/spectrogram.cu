// K1: fused pre-emphasis + framing + Hamming window + 512-point real FFT
// magnitude, in shared memory.
//
// Replaces the TPU kernel mcncrossmodalemotions_tpu/ops/pallas_spectrogram.py
// (spectrogram_pallas, body _kernel). Same function, another algorithm: the
// Mosaic kernel multiplies frames by padded DFT matrices on the MXU, where
// a product is cheap; on Hopper's CUDA cores a product costs 2 x 400 x 2 x
// 257 operations a frame where an FFT needs about 5 N log2 N = 23k.
//
//   out[b, k, t] = | sum_{i<win} y[b, t*hop + i] * w[i] * exp(-2*pi*j*i*k/512) |
//   y[n] = x[n] - alpha * x[n-1],  y[0] = x[0]          (pre-emphasis)
//
// for k = 0..256; bin 512-k is stored as a mirror of bin k, so the output
// is the full [B, 512, T] float32, freq-major.
//
// What bounds it on the card: bytes. With an FFT a frame costs ~23k
// operations against 320 bytes of int16 in and 2 KB of float32 out, ~10
// operations a byte, half of the H100's fp32 balance (67 TFLOP/s over
// 3.35 TB/s). So the design reads the waveform once, never writes a frames
// tensor or a decoded copy, writes every output byte once, in whole 32-byte
// sectors, and keeps enough blocks on an SM that one block's stores run
// while others compute:
//  - one block per (utterance, tile of FT = 16 frames), one frame per
//    half-warp; ~51 KB of shared memory and at most 64 registers a thread,
//    so 4 blocks an SM. The tile's span of the waveform ((FT-1)*hop + win
//    samples, frames overlap 2.5x) is loaded once, pre-emphasised on the
//    way, into shared memory, each thread's loads all issued before its
//    first store. The int16 feed is read as it is and scaled by 2^-15,
//    bitwise the plain decode;
//  - the real 512-point FFT of a frame is a 256-point complex FFT of
//    z[n] = v[2n] + j v[2n+1] (v the windowed frame, 0 past win) and one
//    post-processing pass, X[k] = (Z[k] + conj Z[256-k])/2
//    - j W512^k (Z[k] - conj Z[256-k])/2: half the work of a complex
//    512-point FFT, and no second frame to pair with (packing two frames
//    into one 512-point FFT is the equal alternative; it needs twice the
//    registers a frame and a second exchange). Bins k and 256-k share
//    their two loads and one product, X[256-k] = conj(E - O) where
//    X[k] = E + O, so the pass takes bins in pairs, k <= 128;
//  - 256 = 16 x 16: lane l holds z[16 n1 + l] in 16 registers, runs a
//    16-point DFT (radix 4 x 4, in registers), multiplies by W256^(l k1),
//    exchanges once through shared memory (row stride 17: conflict-free)
//    and runs the second 16-point DFT. A frame never leaves its half-warp,
//    so the FFT needs __syncwarp only. Twiddles are read from shared
//    memory (broadcast, or laid out [k1][l]), not held in registers;
//  - the span is read as float2 (v[2n], v[2n+1]): a half-warp reads one
//    aligned 128-byte run (hop and win even, 640 bytes between frames), so
//    no bank padding is needed;
//  - the 257 magnitudes of each frame overwrite its exchange buffer (one
//    buffer of 546 floats a frame: 2 banks apart); then each half-warp
//    stores an output row's FT consecutive frames (64 bytes, two whole
//    sectors) for bin k and for its mirror 512-k. Plain stores: the
//    frontend's next pass reads the output, from L2 where it fits;
//  - the tables (Hamming window, W256^m, W512^k for k <= 128) are built on
//    the host in float64 and cast to fp32
//    (ops/spectrogram_kernel.py::fft_tables_np); no __sinf/__cosf. Plain
//    fp32 throughout: no tensor cores, no TF32.
// Frames past t_frames in the ragged last tile are computed from zeros and
// not stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NFFT = 512;
constexpr int HALF = NFFT / 2;        // the complex FFT's length, 256
constexpr int R = 16;                 // 256 = R x R
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FT = 2 * WARPS;         // frames per block, one per half-warp
constexpr int ROW = R + 1;            // exchange row stride, float2
constexpr int XBUF = R * ROW + 1;     // one frame's buffer, float2: 546
                                      // floats, 2 banks apart frame to frame
constexpr int SPAN_LOADS = 11;        // 11 x 256 >= (FT-1)*160 + 400: the
                                      // default span's loads in one go

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Where dft16 leaves X[k]: the 4 x 4 digit transpose.
__host__ __device__ constexpr int rev4(int k) { return 4 * (k & 3) + (k >> 2); }

size_t smem_bytes(int span, int win) {
  return sizeof(float) * ((size_t)round4(span) + round4(win) +
                          2 * (HALF / 2 + 2 + 10 + R * R + FT * XBUF));
}

__device__ __forceinline__ float sample(float v) { return v; }
__device__ __forceinline__ float sample(int16_t v) {
  return static_cast<float>(v) * (1.0f / 32768.0f);  // exact: a power of two
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In place: (a0, a1, a2, a3) -> their 4-point DFT (W4 = -j).
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 s02 = make_float2(a0.x + a2.x, a0.y + a2.y);
  const float2 d02 = make_float2(a0.x - a2.x, a0.y - a2.y);
  const float2 s13 = make_float2(a1.x + a3.x, a1.y + a3.y);
  const float2 d13 = make_float2(a1.x - a3.x, a1.y - a3.y);
  a0 = make_float2(s02.x + s13.x, s02.y + s13.y);
  a2 = make_float2(s02.x - s13.x, s02.y - s13.y);
  a1 = make_float2(d02.x + d13.y, d02.y - d13.x);  // d02 - j d13
  a3 = make_float2(d02.x - d13.y, d02.y + d13.x);  // d02 + j d13
}

// X[k] = sum_n v[n] W16^(nk), n = 4a + b, k = c + 4d: 4-point DFTs over a,
// twiddles W16^(bc) (w16[m] = W16^m, in shared memory), 4-point DFTs over
// b. X[k] is left at v[rev4(k)].
__device__ __forceinline__ void dft16(float2 (&v)[R], const float2* w16) {
#pragma unroll
  for (int b = 0; b < 4; ++b) dft4(v[b], v[4 + b], v[8 + b], v[12 + b]);
#pragma unroll
  for (int c = 1; c < 4; ++c)
#pragma unroll
    for (int b = 1; b < 4; ++b) v[4 * c + b] = cmul(v[4 * c + b], w16[b * c]);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    dft4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
}

// |X[k]| and |X[256-k]|, 0 <= k <= 128, from a = Z[k] and c = Z[256-k]
// (Z[256] = Z[0]): with E = (a + conj c)/2 and O = -j W512^k (a - conj c)/2,
// X[k] = E + O and X[256-k] = conj(E - O).
__device__ __forceinline__ void post_pair(float2 a, float2 c, float2 w,
                                          float& mag_k, float& mag_r) {
  const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
  const float2 d = make_float2(0.5f * (a.x - c.x), 0.5f * (a.y + c.y));
  const float2 o = cmul(make_float2(d.y, -d.x), w);  // -j d W512^k
  float re = e.x + o.x, im = e.y + o.y;
  mag_k = sqrtf(re * re + im * im);
  re = e.x - o.x;
  im = e.y - o.y;
  mag_r = sqrtf(re * re + im * im);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
spectrogram_kernel(const T* __restrict__ x, const float* __restrict__ window,
                   const float2* __restrict__ tw, const float2* __restrict__ post,
                   float* __restrict__ out, int n, int t_frames, int win,
                   int hop, float alpha) {
  extern __shared__ float4 smem4[];
  const int span = (FT - 1) * hop + win;
  float* ys = reinterpret_cast<float*>(smem4);        // [span] pre-emphasised
  float* ws = ys + round4(span);                        // [win] window
  float2* ps = reinterpret_cast<float2*>(ws + round4(win));  // [HALF/2+1] W512^k
  float2* w16 = ps + HALF / 2 + 2;   // [10] W16^m = W256^(16 m)
  float2* twl = w16 + 10;            // [R][R] W256^(l k1) at [k1][l]
  float2* xs = twl + R * R;  // [FT][XBUF] a frame's exchange buffer, then
                             // its 257 magnitudes (floats)

  const int tid = threadIdx.x;
  for (int i = tid; i < win; i += THREADS) ws[i] = window[i];
  for (int k = tid; k <= HALF / 2; k += THREADS) ps[k] = post[k];
  if (tid < 10) w16[tid] = tw[R * tid];
  static_assert(THREADS == R * R, "one twl entry a thread");
  twl[tid] = tw[(tid & (R - 1)) * (tid / R)];

  // The span: all of a thread's loads are issued before the first store,
  // so a block waits out one memory latency, not one per THREADS samples.
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FT;
  const T* xb = x + (size_t)b * n;
  const int s0 = t0 * hop;
  float cur[SPAN_LOADS], prev[SPAN_LOADS];
#pragma unroll
  for (int q = 0; q < SPAN_LOADS; ++q) {
    const int s = s0 + tid + q * THREADS;
    const bool in = s - s0 < span && s < n;  // past the end: zeros, which
    cur[q] = in ? sample(xb[s]) : 0.f;       // only frames t >= t_frames read
    prev[q] = in && s > 0 ? sample(xb[s - 1]) : 0.f;
  }
#pragma unroll
  for (int q = 0; q < SPAN_LOADS; ++q) {
    const int j = tid + q * THREADS;
    if (j < span) ys[j] = cur[q] - alpha * prev[q];
  }
  for (int j = tid + SPAN_LOADS * THREADS; j < span; j += THREADS) {
    const int s = s0 + j;  // a span longer than the default config's
    ys[j] = s < n ? sample(xb[s]) - alpha * sample(xb[s - 1]) : 0.f;
  }
  __syncthreads();

  const int lane = tid & 31, l = lane & (R - 1);
  // This half-warp's frame: the two of a warp 8 apart, so that their
  // magnitudes' stores (2 banks a frame) meet distinct banks.
  const int f = (tid >> 5) + WARPS * ((tid >> 4) & 1);
  float2* xf = xs + f * XBUF;
  const float* yf = ys + f * hop;
  float2 v[R];
#pragma unroll
  for (int n1 = 0; n1 < R; ++n1) {  // z[16 n1 + l] = v[i] + j v[i + 1]
    const int i = 2 * (R * n1 + l);
    v[n1] = make_float2(0.f, 0.f);
    if (i < win) {
      const float2 y = *reinterpret_cast<const float2*>(yf + i);
      const float2 w = *reinterpret_cast<const float2*>(ws + i);
      v[n1] = make_float2(y.x * w.x, y.y * w.y);
    }
  }
  dft16(v, w16);  // over n1: k1 at v[rev4(k1)]
#pragma unroll
  for (int k1 = 0; k1 < R; ++k1) {
    const float2 y = v[rev4(k1)];
    xf[k1 * ROW + l] = k1 ? cmul(y, twl[k1 * R + l]) : y;
  }
  __syncwarp();
#pragma unroll
  for (int n2 = 0; n2 < R; ++n2) v[n2] = xf[l * ROW + n2];
  dft16(v, w16);  // over n2: Z[l + 16 k2] at v[rev4(k2)]
  __syncwarp();
#pragma unroll
  for (int k2 = 0; k2 < R; ++k2) xf[l + R * k2] = v[rev4(k2)];
  __syncwarp();
  // Post-processing: lane l takes the pairs k = l + 16 m, m < 8, and lane
  // 0 also bin 128. Z is read into registers, then the frame's 257
  // magnitudes overwrite its buffer.
#pragma unroll
  for (int m = 0; m < R / 2; ++m) {
    const int k = l + R * m;
    v[2 * m] = xf[k];
    v[2 * m + 1] = xf[(HALF - k) & (HALF - 1)];
  }
  const float2 z128 = xf[HALF / 2];
  __syncwarp();
  float* mf = reinterpret_cast<float*>(xf);
#pragma unroll
  for (int m = 0; m < R / 2; ++m) {
    const int k = l + R * m;
    float mag_k, mag_r;
    post_pair(v[2 * m], v[2 * m + 1], ps[k], mag_k, mag_r);
    mf[k] = mag_k;
    mf[HALF - k] = mag_r;
  }
  if (l == 0) {  // bin 128 pairs with itself
    float mag_k, mag_r;
    post_pair(z128, z128, ps[HALF / 2], mag_k, mag_r);
    mf[HALF / 2] = mag_k;
  }
  __syncthreads();

  // The store: lane l of a warp reads frame l's magnitude of bin k (lanes
  // 0-15) or k + 1 (lanes 16-31), banks 2 l + k: distinct. Each half-warp
  // writes FT consecutive frames of output row k and of its mirror 512 - k.
  const int t = t0 + l;
  if (t < t_frames) {
    float* ob = out + (size_t)b * NFFT * t_frames + t;
    const float* mt = reinterpret_cast<const float*>(xs + l * XBUF);
    const size_t mirror = (size_t)NFFT * t_frames;
    for (int k = 2 * (tid >> 5) + (lane >> 4); k <= HALF; k += 2 * WARPS) {
      const float mag = mt[k];
      ob[(size_t)k * t_frames] = mag;
      if (k > 0 && k < HALF) ob[mirror - (size_t)k * t_frames] = mag;
    }
  }
}

template <typename T>
int launch(const T* x, const float* window, const float* tw, const float* post,
           float* out, int batch, int n, int t_frames, int win, int hop,
           int nfft, float alpha, void* stream) {
  if (batch <= 0 || batch > 65535 || t_frames <= 0 || hop <= 0 || hop % 2 ||
      win <= 0 || win % 2 || nfft != NFFT || win > NFFT ||
      (long long)(t_frames - 1) * hop + win > n)
    return (int)cudaErrorInvalidValue;
  const int span = (FT - 1) * hop + win;
  const size_t smem = smem_bytes(span, win);
  cudaError_t err = cudaFuncSetAttribute(
      spectrogram_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_frames + FT - 1) / FT, batch);
  spectrogram_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, window, reinterpret_cast<const float2*>(tw),
      reinterpret_cast<const float2*>(post), out, n, t_frames, win, hop, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// x [batch, n] float32 (decoded) or int16 PCM; window [win] float32;
// tw [256] and post [129] complex as (re, im) float32 pairs; out [batch,
// 512, t_frames] float32. win and hop even, nfft 512. Launches on `stream`;
// returns the cudaError_t of the launch (0 = success).
extern "C" int spectrogram_f32(const float* x, const float* window,
                               const float* tw, const float* post, float* out,
                               int batch, int n, int t_frames, int win, int hop,
                               int nfft, float alpha, void* stream) {
  return launch(x, window, tw, post, out, batch, n, t_frames, win, hop, nfft,
                alpha, stream);
}

extern "C" int spectrogram_i16(const int16_t* x, const float* window,
                               const float* tw, const float* post, float* out,
                               int batch, int n, int t_frames, int win, int hop,
                               int nfft, float alpha, void* stream) {
  return launch(x, window, tw, post, out, batch, n, t_frames, win, hop, nfft,
                alpha, stream);
}
