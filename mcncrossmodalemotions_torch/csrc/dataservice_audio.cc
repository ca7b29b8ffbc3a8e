// Host-side wav reader of the PyTorch port: threaded wav segment reads and
// the device-feed quantisation.
//
// A copy of the audio half of native/dataservice.cc (the JAX package's C++
// data service): the thread pool and ParallelFor, the RIFF/WAVE parser,
// ReadWavSegment and PackRow, and the C entry points ds_wav_info,
// ds_read_wav and ds_read_crops, unchanged, ds_read_crops_packed, which
// copies 16-bit PCM rows where the original decodes them (the same bytes)
// and counts the rows of each path, and one of its own: ds_wav_infos, a
// batch's headers in one threaded call. The JPEG face decode (and so
// libjpeg) is left out: this library needs only the C++ standard library
// and pthreads, so it builds on hosts without libjpeg.
//
// Built at first use by mcncrossmodalemotions_torch/ops/_build.py with the
// host compiler (g++ -O3 -std=c++17 -fPIC -shared -lpthread) and bound with
// ctypes in mcncrossmodalemotions_torch/data/native_audio.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Thread pool
// ---------------------------------------------------------------------------
class ThreadPool {
 public:
  explicit ThreadPool(int num_threads) { EnsureThreads(num_threads); }

  // Grow the pool to at least `num_threads` workers. The pool is a
  // process-global sized lazily by its callers; without this, the FIRST
  // caller's num_threads silently pinned every later call's parallelism.
  void EnsureThreads(int num_threads) {
    std::lock_guard<std::mutex> lock(grow_mu_);
    while (static_cast<int>(workers_.size()) < num_threads) {
      workers_.emplace_back([this] { Loop(); });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      done_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void Submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      queue_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void Loop() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lock(mu_);
        cv_.wait(lock, [this] { return done_ || !queue_.empty(); });
        if (done_ && queue_.empty()) return;
        fn = std::move(queue_.front());
        queue_.pop();
      }
      fn();
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> queue_;
  std::mutex mu_;
  std::mutex grow_mu_;
  std::condition_variable cv_;
  bool done_ = false;
};

ThreadPool* GlobalPool(int num_threads) {
  static ThreadPool* pool = new ThreadPool(num_threads > 0 ? num_threads : 8);
  if (num_threads > 0) pool->EnsureThreads(num_threads);
  return pool;
}

// Run `count` tasks on the pool and wait for completion. Returns the
// number of tasks that threw (e.g. bad_alloc on a corrupt input's size
// field): an exception escaping a pool thread would std::terminate the
// whole process, violating the corrupt-input contract, so it is caught
// here and surfaced as a failure count for the caller to add in.
int ParallelFor(int count, int num_threads,
                const std::function<void(int)>& body) {
  if (count <= 0) return 0;
  ThreadPool* pool = GlobalPool(num_threads);
  std::atomic<int> remaining(count);
  std::atomic<int> threw(0);
  std::mutex mu;
  std::condition_variable cv;
  for (int i = 0; i < count; ++i) {
    pool->Submit([&, i] {
      try {
        body(i);
      } catch (...) {
        threw.fetch_add(1);
      }
      if (remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lock(mu);
        cv.notify_one();
      }
    });
  }
  std::unique_lock<std::mutex> lock(mu);
  cv.wait(lock, [&] { return remaining.load() == 0; });
  return threw.load();
}

// ---------------------------------------------------------------------------
// WAV parsing (RIFF/WAVE, PCM int8/16/32 + IEEE float32)
// ---------------------------------------------------------------------------
struct WavHeader {
  int64_t num_samples = 0;
  int32_t sample_rate = 0;
  int16_t channels = 0;
  int16_t bits = 0;
  int16_t format = 0;  // 1 = PCM, 3 = IEEE float
  int64_t data_offset = 0;
};

bool ParseWavHeader(FILE* f, WavHeader* h) {
  unsigned char riff[12];
  if (fread(riff, 1, 12, f) != 12) return false;
  if (memcmp(riff, "RIFF", 4) != 0 || memcmp(riff + 8, "WAVE", 4) != 0)
    return false;
  unsigned char chunk[8];
  bool have_fmt = false;
  while (fread(chunk, 1, 8, f) == 8) {
    uint32_t size;
    memcpy(&size, chunk + 4, 4);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      if (size < 16) return false;  // PCM fmt chunk is >= 16 bytes
      // A real fmt chunk is <= ~40 bytes (EXTENSIBLE); a corrupt size
      // field must fail the parse, not attempt a ~4 GB allocation that
      // std::terminates the loader threads via bad_alloc.
      if (size > 4096) return false;
      std::vector<unsigned char> fmt(size + (size % 2));
      if (fread(fmt.data(), 1, fmt.size(), f) != fmt.size()) return false;
      memcpy(&h->format, fmt.data(), 2);
      memcpy(&h->channels, fmt.data() + 2, 2);
      memcpy(&h->sample_rate, fmt.data() + 4, 4);
      memcpy(&h->bits, fmt.data() + 14, 2);
      have_fmt = true;
    } else if (memcmp(chunk, "data", 4) == 0) {
      if (!have_fmt || h->channels <= 0 || h->bits <= 0) return false;
      const int frame_bytes = h->channels * h->bits / 8;
      h->num_samples = static_cast<int64_t>(size) / frame_bytes;
      h->data_offset = ftell(f);
      return true;
    } else {
      if (fseek(f, size + (size % 2), SEEK_CUR) != 0) return false;
    }
  }
  return false;
}

// Open `path` and parse its header; nullptr if either fails.
FILE* OpenWav(const char* path, WavHeader* h) {
  FILE* f = fopen(path, "rb");
  if (f && !ParseWavHeader(f, h)) {
    fclose(f);
    return nullptr;
  }
  return f;
}

// Decode `n` mono float32 samples starting at frame `start` of the open
// file `f`; zero-pads past EOF. Returns samples actually read (before
// padding), < 0 for a format the reader does not decode.
int64_t DecodeSegment(FILE* f, const WavHeader& h, int64_t start, int64_t n,
                      float* out) {
  // Mirror data/audio.py read_wav's decode support EXACTLY: float32
  // (format 3), else int16/int32/uint8 by bit depth. Anything else
  // (e.g. 24-bit PCM) must ERROR like the Python twin's ValueError —
  // silently returning silence would corrupt training undetectably.
  const bool is_float32 = (h.format == 3 && h.bits == 32);
  if (!is_float32 && h.bits != 16 && h.bits != 32 && h.bits != 8) return -1;
  const int frame_bytes = h.channels * h.bits / 8;
  start = std::max<int64_t>(0, start);
  int64_t avail = std::max<int64_t>(0, h.num_samples - start);
  int64_t to_read = std::min(n, avail);
  std::fill(out, out + n, 0.0f);
  if (to_read > 0) {
    fseek(f, h.data_offset + start * frame_bytes, SEEK_SET);
    std::vector<unsigned char> raw(to_read * frame_bytes);
    int64_t got = fread(raw.data(), 1, raw.size(), f) / frame_bytes;
    const int c = h.channels;
    for (int64_t i = 0; i < got; ++i) {
      // LEFT channel only for multi-channel files, matching the
      // reference (compute_audio_feats.m:176 `z = z(:,1)`) and the
      // python reader (data/audio.py read_wav)
      const unsigned char* p = raw.data() + (i * c) * (h.bits / 8);
      float v = 0.0f;
      if (h.format == 3 && h.bits == 32) {
        memcpy(&v, p, 4);
      } else if (h.bits == 16) {
        int16_t s;
        memcpy(&s, p, 2);
        v = s / 32768.0f;
      } else if (h.bits == 32) {
        int32_t s;
        memcpy(&s, p, 4);
        v = s / 2147483648.0f;
      } else if (h.bits == 8) {
        v = (p[0] - 128) / 128.0f;
      }
      out[i] = v;
    }
    to_read = got;
  }
  return to_read;
}

int64_t ReadWavSegment(const char* path, int64_t start, int64_t n,
                       float* out, int32_t* sample_rate) {
  WavHeader h;
  FILE* f = OpenWav(path, &h);
  if (!f) return -1;
  if (sample_rate) *sample_rate = h.sample_rate;
  const int64_t got = DecodeSegment(f, h, start, n, out);
  fclose(f);
  return got;
}

// ---------------------------------------------------------------------------
// Device-feed quantisation (pack_pcm16 / pack_mulaw8 twins)
// ---------------------------------------------------------------------------
// Row-wise peak normalisation (DOWN only: divisor >= 1) + quantisation,
// matching data/audio.py exactly: rounding is nearbyintf under the
// default to-nearest-EVEN mode (numpy's np.round convention), and the
// mu-law byte is the 64K lin->ulaw table applied to the pcm16 value
// (data/audio.pack_mulaw8's LUT composition).

int16_t QuantizePcm16(float x) {
  float v = nearbyintf(x * 32768.0f);
  v = std::min(32767.0f, std::max(-32768.0f, v));
  return static_cast<int16_t>(v);
}

const unsigned char* MulawLut() {
  static const std::vector<unsigned char> lut = [] {
    std::vector<unsigned char> t(65536);
    const double denom = std::log1p(255.0);
    for (int i = 0; i < 65536; ++i) {
      const int pcm = (i < 32768) ? i : i - 65536;
      const double x = pcm / 32768.0;
      const double y =
          std::copysign(std::log1p(255.0 * std::fabs(x)) / denom, x);
      double v = nearbyint((y + 1.0) * 127.5);
      v = std::min(255.0, std::max(0.0, v));
      t[i] = static_cast<unsigned char>(v);
    }
    return t;
  }();
  return lut.data();
}

// Quantise one float row into out (mode 0: int16 pcm; 1: uint8 mu-law).
// fp32 DIVISION by the peak (not reciprocal-multiply) so results are
// bit-identical to numpy's `waves / peak` on every platform.
void PackRow(const float* row, int64_t n, int mode, void* out) {
  float peak = 1.0f;
  for (int64_t i = 0; i < n; ++i) peak = std::max(peak, std::fabs(row[i]));
  if (mode == 0) {
    int16_t* o = static_cast<int16_t*>(out);
    for (int64_t i = 0; i < n; ++i) o[i] = QuantizePcm16(row[i] / peak);
  } else {
    const unsigned char* lut = MulawLut();
    unsigned char* o = static_cast<unsigned char*>(out);
    for (int64_t i = 0; i < n; ++i)
      o[i] = lut[static_cast<uint16_t>(QuantizePcm16(row[i] / peak))];
  }
}

// 16-bit PCM, the fast path of ds_read_crops_packed. The decode path's
// s / 32768 has |v| <= 1, so PackRow's peak is 1 and its quantisation gives
// s back: a packed row is the file's own left-channel samples, zero-padded
// (mode 1: the mu-law table of each, and of the padding's 0). So the
// samples are copied, with no float row, no decode and no peak.
bool IsPcm16(const WavHeader& h) { return h.format == 1 && h.bits == 16; }

void CopyPcm16Row(FILE* f, const WavHeader& h, int64_t start, int64_t n,
                  int mode, void* out) {
  const int c = h.channels;
  start = std::max<int64_t>(0, start);
  const int64_t to_read =
      std::min(n, std::max<int64_t>(0, h.num_samples - start));
  // a mono int16 row is read in place; other rows through a frame buffer
  thread_local std::vector<int16_t> frames;
  int16_t* dst = static_cast<int16_t*>(out);
  if (mode != 0 || c != 1) {
    frames.resize(std::max<int64_t>(to_read, 1) * c);
    dst = frames.data();
  }
  int64_t got = 0;
  if (to_read > 0 &&
      fseek(f, h.data_offset + start * 2 * c, SEEK_SET) == 0)
    got = fread(dst, size_t(2) * c, to_read, f);
  if (mode == 0) {
    int16_t* o = static_cast<int16_t*>(out);
    if (c != 1)
      for (int64_t i = 0; i < got; ++i) o[i] = dst[i * c];
    std::fill(o + got, o + n, int16_t(0));
  } else {
    const unsigned char* lut = MulawLut();
    unsigned char* o = static_cast<unsigned char*>(out);
    for (int64_t i = 0; i < got; ++i) o[i] = lut[uint16_t(dst[i * c])];
    std::fill(o + got, o + n, lut[0]);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

// audioinfo: fills [num_samples, sample_rate, channels, bits]; 0 on success.
int ds_wav_info(const char* path, int64_t* out4) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavHeader h;
  const bool ok = ParseWavHeader(f, &h);
  fclose(f);
  if (!ok) return -2;
  out4[0] = h.num_samples;
  out4[1] = h.sample_rate;
  out4[2] = h.channels;
  out4[3] = h.bits;
  return 0;
}

// Batched headers into out[count][4], each row ds_wav_info's, on the
// thread pool: one call (and so one release of the caller's interpreter
// lock) for a batch's files. A file that fails gets a row of -1. Returns
// 0 if every header parsed, else the number of failures.
int ds_wav_infos(const char** paths, int count, int num_threads,
                 int64_t* out) {
  std::atomic<int> failures(0);
  failures.fetch_add(ParallelFor(count, num_threads, [&](int i) {
    int64_t* row = out + size_t(i) * 4;
    if (ds_wav_info(paths[i], row) != 0) {
      std::fill(row, row + 4, int64_t(-1));
      failures.fetch_add(1);
    }
  }));
  return failures.load();
}

// Single segment read; returns samples read (zero-padded to n), < 0 on error.
int64_t ds_read_wav(const char* path, int64_t start, int64_t n, float* out,
                    int32_t* sample_rate) {
  return ReadWavSegment(path, start, n, out, sample_rate);
}

// Batched crop reads into out[count, n] using the thread pool.
// Returns 0 if every file decoded, else the number of failures.
int ds_read_crops(const char** paths, const int64_t* starts, int64_t n,
                  int count, int num_threads, float* out) {
  std::atomic<int> failures(0);
  failures.fetch_add(ParallelFor(count, num_threads, [&](int i) {
    int32_t rate = 0;
    if (ReadWavSegment(paths[i], starts[i], n, out + size_t(i) * n, &rate) < 0)
      failures.fetch_add(1);
  }));
  return failures.load();
}

// Batched crop reads + on-thread feed quantisation into out[count, n]:
// mode 0 writes int16 PCM (pack_pcm16 twin), mode 1 writes uint8 mu-law
// (pack_mulaw8 twin). Fuses the read and the pack so the Python
// producer thread ships device-ready bytes without touching the
// samples (and without holding the GIL for the pack). A 16-bit PCM file
// (its header says so) has its samples copied (CopyPcm16Row); any other
// is decoded to float and packed (PackRow), with the same result.
// rows[0] and rows[1] (rows may be null) get the rows that were copied
// and decoded. Returns 0 if every file decoded, else the number of
// failures.
int ds_read_crops_packed(const char** paths, const int64_t* starts, int64_t n,
                         int count, int num_threads, int mode, void* out,
                         int64_t* rows) {
  std::atomic<int> failures(0), copied(0), decoded(0);
  const size_t row_bytes = (mode == 0) ? n * 2 : n;
  failures.fetch_add(ParallelFor(count, num_threads, [&](int i) {
    char* row = static_cast<char*>(out) + size_t(i) * row_bytes;
    WavHeader h;
    FILE* f = OpenWav(paths[i], &h);
    if (f && IsPcm16(h)) {
      CopyPcm16Row(f, h, starts[i], n, mode, row);
      fclose(f);
      copied.fetch_add(1);
      return;
    }
    std::vector<float> scratch(n);
    const int64_t got = f ? DecodeSegment(f, h, starts[i], n, scratch.data())
                          : -1;
    if (f) fclose(f);
    if (got < 0) {
      failures.fetch_add(1);
      memset(row, 0, row_bytes);
      return;
    }
    PackRow(scratch.data(), n, mode, row);
    decoded.fetch_add(1);
  }));
  if (rows) {
    rows[0] = copied.load();
    rows[1] = decoded.load();
  }
  return failures.load();
}

}  // extern "C"
