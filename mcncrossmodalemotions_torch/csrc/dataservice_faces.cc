// Host-side face-frame decoder of the PyTorch port: baseline JPEG decode,
// center crop, gray and resize, threaded over a batch of frames.
//
// The face half of native/dataservice.cc (the JAX package's C++ data
// service) without libjpeg: the thread pool (its workers named "ds-faces")
// and ParallelFor, and the crop, gray and resize of DecodeJpegFace, are
// copied; the libjpeg calls are replaced by a decoder written from ITU-T
// T.81 that reproduces what libjpeg(-turbo) gives with its default
// decompression settings, bit for bit:
//  - SOF0 and SOF1 frames, 8-bit samples, Huffman coding, 1 or 3
//    components, luma sampling 1x1, 2x1, 1x2 or 2x2 over 1x1 chroma;
//    interleaved and non-interleaved sequential scans;
//  - DQT (8- and 16-bit), DHT, DRI and RSTn, byte stuffing and fill bytes;
//    APPn and COM are skipped;
//  - jpeg_idct_islow (jidctint.c: CONST_BITS 13, PASS1_BITS 2) with its
//    post-IDCT range-limit table;
//  - fancy upsampling (jdsample.c: h2v1, h2v2 and h1v2), context rows at
//    the image's top and bottom and edge columns as libjpeg's main
//    controller feeds them;
//  - ycc_rgb_convert's fixed-point tables (jdcolor.c, SCALEBITS 16);
//  - partial MCUs at the right and bottom edges;
//  - entropy data that ends early: libjpeg's rule of zero bits for the MCU
//    that runs out and zero coefficients for every MCU after it (up to a
//    restart marker that is present).
// Progressive, arithmetic-coded, 12-bit, 2- and 4-component (CMYK) files,
// other sampling factors, a missing Huffman table and images over 64 MP
// fail the single frame with a return code.
//
// Built at first use by mcncrossmodalemotions_torch/ops/_build.py with the
// host compiler (g++ -O3 -std=c++17 -fPIC -shared -lpthread) and bound with
// ctypes in mcncrossmodalemotions_torch/data/native_faces.py.

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
#include <pthread.h>
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
      workers_.emplace_back([this] {
        pthread_setname_np(pthread_self(), "ds-faces");  // for profiles
        Loop();
      });
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

// Run `count` tasks on at most `num_threads` workers of the pool (8 where
// num_threads <= 0) and wait for completion: min(count, num_threads) pool
// tasks each take the next index until none is left, so a call's
// parallelism is its own num_threads whatever size an earlier call grew
// the shared pool to. Returns the number of tasks that threw (e.g.
// bad_alloc on a corrupt input's size field): an exception escaping a pool
// thread would std::terminate the whole process, violating the
// corrupt-input contract, so it is caught here and surfaced as a failure
// count for the caller to add in.
int ParallelFor(int count, int num_threads,
                const std::function<void(int)>& body) {
  if (count <= 0) return 0;
  ThreadPool* pool = GlobalPool(num_threads);
  const int workers = std::min(count, num_threads > 0 ? num_threads : 8);
  std::atomic<int> next(0);
  std::atomic<int> remaining(workers);
  std::atomic<int> threw(0);
  std::mutex mu;
  std::condition_variable cv;
  for (int w = 0; w < workers; ++w) {
    pool->Submit([&] {
      for (int i = next.fetch_add(1); i < count; i = next.fetch_add(1)) {
        try {
          body(i);
        } catch (...) {
          threw.fetch_add(1);
        }
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
// Baseline JPEG decoder (ITU-T T.81, libjpeg-turbo's default output)
// ---------------------------------------------------------------------------
enum Status {
  kOk = 0,
  kOpenFailed = -1,   // the file cannot be read
  kCorrupt = -2,      // a malformed or truncated header
  kUnsupported = -3,  // progressive, arithmetic, 12-bit, CMYK, sampling
  kTooLarge = -4,     // over 64 MP
  kCapacity = -5,     // the caller's RGB buffer is too small
};

constexpr int64_t kMaxPixels = int64_t(64) << 20;  // dataservice.cc's cap

// Zigzag index -> natural index, with libjpeg's 16 extra entries that keep
// a corrupt run inside the block (jutils.c jpeg_natural_order).
constexpr int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};   // largest code of each length, -1 if none
  int32_t valoffset[18] = {};
  uint16_t lookup[1 << kLookBits] = {};  // (length << 8) | symbol; 0: longer

  // jdhuff.c jpeg_make_d_derived_tbl; false on a table libjpeg rejects.
  bool Build(const uint8_t counts[17], const uint8_t* symbols, int nsym,
             bool is_dc) {
    int huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < counts[l]; ++i) huffsize[p++] = l;
    huffsize[p] = 0;
    if (p != nsym) return false;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (uint32_t(1) << si)) return false;
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (counts[l]) {
        valoffset[l] = p - int32_t(huffcode[p]);
        p += counts[l];
        maxcode[l] = int32_t(huffcode[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memcpy(vals, symbols, nsym);
    std::memset(lookup, 0, sizeof(lookup));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 0; i < counts[l]; ++i, ++p) {
        const uint32_t base = huffcode[p] << (kLookBits - l);
        for (uint32_t e = 0; e < (uint32_t(1) << (kLookBits - l)); ++e)
          lookup[base | e] = uint16_t((l << 8) | symbols[p]);
      }
    }
    if (is_dc)
      for (int i = 0; i < nsym; ++i)
        if (symbols[i] > 15) return false;
    defined = true;
    return true;
  }
};

// Entropy-coded data reader with libjpeg's end-of-data rule: past a marker
// (or the end of the file, which libjpeg's source manager turns into an
// EOI) the reader yields zero bits, and `insufficient` is set once a read
// needs a bit that is not real data.
struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t buf = 0;
  int bits = 0;    // buffered bits (low end of buf)
  int pad = 0;     // of which the lowest `pad` are zero padding
  int marker = 0;  // marker met and not consumed by the scan (0: none)
  bool insufficient = false;

  void Fill() {
    while (bits <= 56) {
      if (marker == 0) {
        if (p >= end) {
          marker = 0xD9;  // jdatasrc.c inserts a fake EOI
          continue;
        }
        uint8_t c = *p;
        if (c == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;  // fill bytes
          if (q >= end) {
            p = q;
            marker = 0xD9;
            continue;
          }
          if (*q != 0) {
            marker = *q;
            p = q + 1;
            continue;
          }
          p = q + 1;  // stuffed zero byte
        } else {
          ++p;
        }
        buf = (buf << 8) | c;
        bits += 8;
      } else {
        buf <<= 8;
        bits += 8;
        pad += 8;
      }
    }
  }
  uint32_t Peek(int n) {
    if (bits < n) Fill();
    return uint32_t(buf >> (bits - n)) & ((uint32_t(1) << n) - 1);
  }
  void Skip(int n) {
    if (bits < n) Fill();
    bits -= n;
    if (bits < pad) {
      insufficient = true;
      pad = bits;
    }
  }
  uint32_t Get(int n) {
    const uint32_t v = Peek(n);
    Skip(n);
    return v;
  }
  int Decode(const HuffTable& t) {
    const uint16_t e = t.lookup[Peek(kLookBits)];
    if (e >> 8) {
      Skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      const int32_t code = int32_t(Peek(l));
      if (code <= t.maxcode[l]) {
        Skip(l);
        return t.vals[(code + t.valoffset[l]) & 0xFF];
      }
    }
    Skip(16);  // a code longer than 16 bits: jdhuff.c warns, yields 0
    return 0;
  }
  // HUFF_EXTEND of the next s bits
  int Receive(int s) {
    if (s == 0) return 0;
    const int r = int(Get(s));
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
  }
  // Discard the buffered bits (process_restart); `p` stays after the last
  // byte they came from.
  void DropBits() {
    bits = 0;
    pad = 0;
    buf = 0;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;  // downsampled width and height (samples)
  int bw = 0, bh = 0;  // allocated blocks across and down
  int td = 0, ta = 0;  // DC and AC table of the current scan
  int pred = 0;        // DC predictor
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
};

struct Decoder {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;  // MCUs across and down in an interleaved scan
  bool have_frame = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  Component comp[3];

  int U16(size_t at) const { return (data[at] << 8) | data[at + 1]; }

  // Next marker code from `pos` (libjpeg's next_marker: garbage bytes
  // before 0xFF and fill bytes are skipped); -1 at the end of the data.
  int NextMarker() {
    for (;;) {
      while (pos < size && data[pos] != 0xFF) ++pos;
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) return -1;
      const int c = data[pos++];
      if (c != 0) return c;
    }
  }

  Status Segment(size_t* seg, size_t* len) {
    if (pos + 2 > size) return kCorrupt;
    const size_t n = size_t(U16(pos));
    if (n < 2 || pos + n > size) return kCorrupt;
    *seg = pos + 2;
    *len = n - 2;
    pos += n;
    return kOk;
  }

  Status ReadDQT(size_t at, size_t len) {
    const size_t stop = at + len;
    while (at < stop) {
      const int pq = data[at] >> 4, tq = data[at] & 15;
      ++at;
      if (tq > 3 || pq > 1) return kCorrupt;
      const size_t need = pq ? 128 : 64;
      if (at + need > stop) return kCorrupt;
      for (int k = 0; k < 64; ++k)
        qt[tq][kNaturalOrder[k]] =
            uint16_t(pq ? U16(at + 2 * k) : data[at + k]);
      qt_defined[tq] = true;
      at += need;
    }
    return kOk;
  }

  Status ReadDHT(size_t at, size_t len) {
    const size_t stop = at + len;
    while (at < stop) {
      if (at + 17 > stop) return kCorrupt;
      const int tc = data[at] >> 4, th = data[at] & 15;
      if (tc > 1 || th > 3) return kCorrupt;
      uint8_t counts[17] = {0};
      int nsym = 0;
      for (int l = 1; l <= 16; ++l) nsym += counts[l] = data[at + l];
      at += 17;
      if (nsym > 256 || at + nsym > stop) return kCorrupt;
      HuffTable& t = tc ? ac[th] : dc[th];
      if (!t.Build(counts, data + at, nsym, tc == 0)) return kCorrupt;
      at += nsym;
    }
    return kOk;
  }

  Status ReadSOF(size_t at, size_t len) {
    if (have_frame || len < 6) return kCorrupt;
    if (data[at] != 8) return kUnsupported;  // 12-bit (and other) samples
    height = U16(at + 1);
    width = U16(at + 3);
    ncomp = data[at + 5];
    if (width <= 0 || height <= 0) return kCorrupt;
    if (int64_t(width) * height > kMaxPixels) return kTooLarge;
    if (ncomp != 1 && ncomp != 3) return kUnsupported;
    if (len < size_t(6 + 3 * ncomp)) return kCorrupt;
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.id = data[at + 6 + 3 * c];
      k.h = data[at + 7 + 3 * c] >> 4;
      k.v = data[at + 7 + 3 * c] & 15;
      k.tq = data[at + 8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        return kCorrupt;
      hmax = std::max(hmax, k.h);
      vmax = std::max(vmax, k.v);
    }
    if (ncomp == 1) {  // one component: its factors are moot (jdinput.c)
      comp[0].h = comp[0].v = hmax = vmax = 1;
    } else {
      if (hmax > 2 || vmax > 2) return kUnsupported;
      for (int c = 1; c < 3; ++c)
        if (comp[c].h != 1 || comp[c].v != 1) return kUnsupported;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.dw = int((int64_t(width) * k.h + hmax - 1) / hmax);
      k.dh = int((int64_t(height) * k.v + vmax - 1) / vmax);
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.coef.assign(size_t(k.bw) * k.bh * 64, 0);
    }
    have_frame = true;
    return kOk;
  }

  // libjpeg's process_restart: read_restart_marker with
  // jpeg_resync_to_restart's choice among discarding the marker, scanning
  // to the next one, or leaving it unread (an empty segment follows).
  void Restart(BitReader& br, int* next_rst) {
    br.DropBits();
    if (br.marker == 0) {  // the marker has not been met yet: find it
      pos = size_t(br.p - data);
      const int m = NextMarker();
      br.marker = m < 0 ? 0xD9 : m;
      br.p = data + pos;
    }
    const int desired = *next_rst;
    int m = br.marker;
    for (;;) {
      int action;
      if (m == 0xD0 + desired) {
        action = 1;
      } else if (m < 0xC0) {
        action = 2;
      } else if (m < 0xD0 || m > 0xD7) {
        action = 3;
      } else if (m == 0xD0 + ((desired + 1) & 7) ||
                 m == 0xD0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (m == 0xD0 + ((desired - 1) & 7) ||
                 m == 0xD0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {  // discard the marker, resume after it
        br.marker = 0;
        break;
      }
      if (action == 3) break;  // leave it unread: an empty segment follows
      pos = size_t(br.p - data);
      const int nm = NextMarker();
      m = nm < 0 ? 0xD9 : nm;
      br.marker = m;
      br.p = data + pos;
    }
    *next_rst = (desired + 1) & 7;
    if (br.marker == 0) br.insufficient = false;
  }

  void DecodeBlock(BitReader& br, Component& k, int16_t* blk) {
    int s = br.Decode(dc[k.td]);
    const int diff = br.Receive(s);
    k.pred = int(uint32_t(k.pred) + uint32_t(diff));
    blk[0] = int16_t(k.pred);
    const HuffTable& t = ac[k.ta];
    for (int i = 1; i < 64; ++i) {
      const int rs = br.Decode(t);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        blk[kNaturalOrder[i]] = int16_t(br.Receive(s));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  Status ReadSOS(size_t at, size_t len) {
    if (!have_frame || len < 1) return kCorrupt;
    const int ns = data[at];
    if (ns < 1 || ns > ncomp || len < size_t(4 + 2 * ns)) return kCorrupt;
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      const int cid = data[at + 1 + 2 * i];
      Component* found = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == cid) found = &comp[c];
      if (!found) return kCorrupt;
      found->td = data[at + 2 + 2 * i] >> 4;
      found->ta = data[at + 2 + 2 * i] & 15;
      if (found->td > 3 || found->ta > 3) return kCorrupt;
      if (!dc[found->td].defined || !ac[found->ta].defined) return kCorrupt;
      found->pred = 0;
      sc[i] = found;
    }
    BitReader br;
    br.p = data + pos;
    br.end = data + size;
    int nx, ny;
    if (ns == 1) {  // non-interleaved: one block an MCU
      nx = (sc[0]->dw + 7) / 8;
      ny = (sc[0]->dh + 7) / 8;
    } else {
      nx = mcux;
      ny = mcuy;
    }
    int to_go = restart_interval;
    int next_rst = 0;
    int16_t scratch[64];
    for (int my = 0; my < ny; ++my) {
      for (int mx = 0; mx < nx; ++mx) {
        if (restart_interval) {
          if (to_go == 0) {
            Restart(br, &next_rst);
            for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
            to_go = restart_interval;
          }
          --to_go;
        }
        if (br.insufficient) continue;  // zero coefficients (jdhuff.c)
        for (int i = 0; i < ns; ++i) {
          Component& k = *sc[i];
          const int bh = ns == 1 ? 1 : k.v, bwid = ns == 1 ? 1 : k.h;
          for (int by = 0; by < bh; ++by) {
            for (int bx = 0; bx < bwid; ++bx) {
              const int x = mx * bwid + bx, y = my * bh + by;
              int16_t* blk = (x < k.bw && y < k.bh)
                                 ? &k.coef[(size_t(y) * k.bw + x) * 64]
                                 : scratch;
              if (blk == scratch) std::memset(scratch, 0, sizeof(scratch));
              DecodeBlock(br, k, blk);
            }
          }
        }
      }
    }
    // resume the marker parse after the entropy data
    pos = size_t(br.p - data);
    if (br.marker != 0) {
      // the reader consumed the marker's two bytes: step back onto it
      if (pos >= 2 && data[pos - 2] == 0xFF && data[pos - 1] == br.marker)
        pos -= 2;
      else
        pos = size;  // the fake EOI at the end of the data
    }
    return kOk;
  }

  Status Parse() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) return kCorrupt;
    pos = 2;
    bool scanned = false;
    for (;;) {
      const int m = NextMarker();
      if (m < 0) return scanned ? kOk : kCorrupt;  // EOF: fake EOI
      if (m == 0xD9) return scanned ? kOk : kCorrupt;
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // no length
      size_t seg, len;
      Status st = Segment(&seg, &len);
      if (st != kOk) return st;
      switch (m) {
        case 0xC0:
        case 0xC1:
          st = ReadSOF(seg, len);
          break;
        case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        case 0xCC:
          return kUnsupported;  // progressive, lossless, arithmetic
        case 0xC4:
          st = ReadDHT(seg, len);
          break;
        case 0xDB:
          st = ReadDQT(seg, len);
          break;
        case 0xDD:
          if (len < 2) return kCorrupt;
          restart_interval = U16(seg);
          break;
        case 0xDA:
          pos = seg + len;
          st = ReadSOS(seg, len);
          scanned = true;
          break;
        case 0xE0:
          if (len >= 14 && std::memcmp(data + seg, "JFIF\0", 5) == 0)
            saw_jfif = true;
          break;
        case 0xEE:
          if (len >= 12 && std::memcmp(data + seg, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = data[seg + 11];
          }
          break;
        default:
          break;  // APPn, COM and the rest: skipped
      }
      if (st != kOk) return st;
    }
  }
};

// jidctint.c jpeg_idct_islow, into an 8x8 tile of `out` (row stride
// `stride`), with the post-IDCT range-limit table of jdmaster.c.
struct Idct {
  uint8_t limit[1024];
  Idct() {
    // prepare_range_limit_table, seen from sample_range_limit + 128
    for (int j = 0; j < 1024; ++j) {
      int v;
      if (j < 128) v = 128 + j;
      else if (j < 512) v = 255;
      else if (j < 896) v = 0;
      else v = j - 896;
      limit[j] = uint8_t(v);
    }
  }

  void Run(const int16_t* in, const uint16_t* q, uint8_t* out,
           size_t stride) const {
    constexpr int kConst = 13, kPass1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433,
                      F0765 = 6270, F0899 = 7373, F1175 = 9633,
                      F1501 = 12299, F1847 = 15137, F1961 = 16069,
                      F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int n) {
      return (x + (int64_t(1) << (n - 1))) >> n;
    };
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* i = in + c;
      const uint16_t* qq = q + c;
      int* w = ws + c;
      if (i[8] == 0 && i[16] == 0 && i[24] == 0 && i[32] == 0 &&
          i[40] == 0 && i[48] == 0 && i[56] == 0) {
        const int dcval = int(int64_t(i[0]) * int16_t(qq[0])) * (1 << kPass1);
        for (int r = 0; r < 8; ++r) w[8 * r] = dcval;
        continue;
      }
      auto dq = [&](int r) { return int64_t(i[8 * r]) * int16_t(qq[8 * r]); };
      int64_t z2 = dq(2), z3 = dq(6);
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = dq(0);
      z3 = dq(4);
      int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConst);
      int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConst);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = dq(7);
      tmp1 = dq(5);
      tmp2 = dq(3);
      tmp3 = dq(1);
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int n = kConst - kPass1;
      w[0] = int(descale(tmp10 + tmp3, n));
      w[56] = int(descale(tmp10 - tmp3, n));
      w[8] = int(descale(tmp11 + tmp2, n));
      w[48] = int(descale(tmp11 - tmp2, n));
      w[16] = int(descale(tmp12 + tmp1, n));
      w[40] = int(descale(tmp12 - tmp1, n));
      w[24] = int(descale(tmp13 + tmp0, n));
      w[32] = int(descale(tmp13 - tmp0, n));
    }
    for (int r = 0; r < 8; ++r) {
      const int* w = ws + 8 * r;
      uint8_t* o = out + size_t(r) * stride;
      const int n = kConst + kPass1 + 3;
      if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
          w[6] == 0 && w[7] == 0) {
        const uint8_t v = limit[int(descale(w[0], kPass1 + 3)) & 1023];
        for (int c = 0; c < 8; ++c) o[c] = v;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConst);
      int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConst);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      o[0] = limit[int(descale(tmp10 + tmp3, n)) & 1023];
      o[7] = limit[int(descale(tmp10 - tmp3, n)) & 1023];
      o[1] = limit[int(descale(tmp11 + tmp2, n)) & 1023];
      o[6] = limit[int(descale(tmp11 - tmp2, n)) & 1023];
      o[2] = limit[int(descale(tmp12 + tmp1, n)) & 1023];
      o[5] = limit[int(descale(tmp12 - tmp1, n)) & 1023];
      o[3] = limit[int(descale(tmp13 + tmp0, n)) & 1023];
      o[4] = limit[int(descale(tmp13 - tmp0, n)) & 1023];
    }
  }
};

const Idct& IdctTables() {
  static const Idct idct;
  return idct;
}

// jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) {
      return int64_t(x * double(int64_t(1) << kScale) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

const YccTables& Ycc() {
  static const YccTables t;
  return t;
}

inline uint8_t Clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One component's samples at full size, [height][width], from its IDCT
// plane (`plane`, `pw` samples a row), by libjpeg's fancy upsampling:
// neighbours past the component's own downsampled_width/height are the
// edge samples themselves (the first row is its own row above; the main
// controller replicates the last real row below).
void Upsample(const Component& k, const uint8_t* plane, size_t pw, int hmax,
              int vmax, int width, int height, uint8_t* out) {
  const int fx = hmax / k.h, fy = vmax / k.v;
  const int dw = k.dw, dh = k.dh;
  auto row = [&](int r) {
    return plane + size_t(std::min(std::max(r, 0), dh - 1)) * pw;
  };
  if (fx == 1 && fy == 1) {
    for (int y = 0; y < height; ++y)
      std::memcpy(out + size_t(y) * width, row(y), width);
    return;
  }
  std::vector<uint8_t> line(size_t(2) * dw + 2);
  if (fy == 1) {  // h2v1
    for (int y = 0; y < height; ++y) {
      const uint8_t* in = row(y);
      if (dw > 2) {
        line[0] = in[0];
        line[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          const int v3 = in[x] * 3;
          line[2 * x] = uint8_t((v3 + in[x - 1] + 1) >> 2);
          line[2 * x + 1] = uint8_t((v3 + in[x + 1] + 2) >> 2);
        }
        const int x = dw - 1;
        line[2 * x] = uint8_t((in[x] * 3 + in[x - 1] + 1) >> 2);
        line[2 * x + 1] = in[x];
      } else {  // h2v1_upsample: plain replication
        for (int x = 0; x < dw; ++x) line[2 * x] = line[2 * x + 1] = in[x];
      }
      std::memcpy(out + size_t(y) * width, line.data(), width);
    }
    return;
  }
  if (fx == 1) {  // h1v2 (libjpeg-turbo's h1v2_fancy_upsample)
    for (int y = 0; y < height; ++y) {
      const int r = y >> 1, v = y & 1;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row(v ? r + 1 : r - 1);
      const int bias = v ? 2 : 1;
      uint8_t* o = out + size_t(y) * width;
      for (int x = 0; x < width; ++x)
        o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
    }
    return;
  }
  // h2v2
  std::vector<int> colsum(dw);
  for (int y = 0; y < height; ++y) {
    const int r = y >> 1, v = y & 1;
    const uint8_t* in0 = row(r);
    uint8_t* o = out + size_t(y) * width;
    if (dw > 2) {
      const uint8_t* in1 = row(v ? r + 1 : r - 1);
      for (int x = 0; x < dw; ++x) colsum[x] = in0[x] * 3 + in1[x];
      line[0] = uint8_t((colsum[0] * 4 + 8) >> 4);
      line[1] = uint8_t((colsum[0] * 3 + colsum[1] + 7) >> 4);
      for (int x = 1; x < dw - 1; ++x) {
        line[2 * x] = uint8_t((colsum[x] * 3 + colsum[x - 1] + 8) >> 4);
        line[2 * x + 1] = uint8_t((colsum[x] * 3 + colsum[x + 1] + 7) >> 4);
      }
      const int x = dw - 1;
      line[2 * x] = uint8_t((colsum[x] * 3 + colsum[x - 1] + 8) >> 4);
      line[2 * x + 1] = uint8_t((colsum[x] * 4 + 7) >> 4);
    } else {  // h2v2_upsample: plain replication
      for (int x = 0; x < dw; ++x) line[2 * x] = line[2 * x + 1] = in0[x];
    }
    std::memcpy(o, line.data(), width);
  }
}

// Whole file -> interleaved RGB [height][width][3].
Status DecodeJpegRgb(const char* path, std::vector<unsigned char>* rgb,
                     int* out_w, int* out_h) {
  FILE* f = fopen(path, "rb");
  if (!f) return kOpenFailed;
  std::vector<uint8_t> bytes;
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = fread(chunk, 1, sizeof(chunk), f)) > 0)
    bytes.insert(bytes.end(), chunk, chunk + got);
  fclose(f);
  Decoder d;
  d.data = bytes.data();
  d.size = bytes.size();
  Status st = d.Parse();
  if (st != kOk) return st;
  const int w = d.width, h = d.height;
  const Idct& idct = IdctTables();
  std::vector<std::vector<uint8_t>> full(d.ncomp);
  for (int c = 0; c < d.ncomp; ++c) {
    const Component& k = d.comp[c];
    if (!d.qt_defined[k.tq]) return kCorrupt;
    const size_t pw = size_t(k.bw) * 8;
    std::vector<uint8_t> plane(pw * size_t(k.bh) * 8);
    for (int by = 0; by < k.bh; ++by)
      for (int bx = 0; bx < k.bw; ++bx)
        idct.Run(&k.coef[(size_t(by) * k.bw + bx) * 64], d.qt[k.tq],
                 plane.data() + size_t(by) * 8 * pw + size_t(bx) * 8, pw);
    full[c].resize(size_t(w) * h);
    Upsample(k, plane.data(), pw, d.hmax, d.vmax, w, h, full[c].data());
  }
  rgb->resize(size_t(w) * h * 3);
  unsigned char* o = rgb->data();
  const size_t n = size_t(w) * h;
  if (d.ncomp == 1) {
    const uint8_t* y = full[0].data();
    for (size_t i = 0; i < n; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = y[i];
  } else {
    // jdapimin.c default_decompress_parms: JFIF or component ids 1,2,3
    // mean YCbCr; an Adobe marker with transform 0 or ids 'R','G','B'
    // mean RGB
    const Component* k = d.comp;
    bool is_rgb = false;
    if (!d.saw_jfif) {
      if (d.saw_adobe) is_rgb = d.adobe_transform == 0;
      else if (!(k[0].id == 1 && k[1].id == 2 && k[2].id == 3))
        is_rgb = k[0].id == 82 && k[1].id == 71 && k[2].id == 66;
    }
    const uint8_t *y = full[0].data(), *cb = full[1].data(),
                  *cr = full[2].data();
    if (is_rgb) {
      for (size_t i = 0; i < n; ++i) {
        o[3 * i] = y[i];
        o[3 * i + 1] = cb[i];
        o[3 * i + 2] = cr[i];
      }
    } else {
      const YccTables& t = Ycc();
      for (size_t i = 0; i < n; ++i) {
        const int yy = y[i];
        o[3 * i] = Clamp255(yy + t.cr_r[cr[i]]);
        o[3 * i + 1] =
            Clamp255(yy + int((t.cb_g[cb[i]] + t.cr_g[cr[i]]) >> 16));
        o[3 * i + 2] = Clamp255(yy + t.cb_b[cb[i]]);
      }
    }
  }
  *out_w = w;
  *out_h = h;
  return kOk;
}

// ---------------------------------------------------------------------------
// JPEG decode + center-crop + bilinear resize + grayscale
// ---------------------------------------------------------------------------
// native/dataservice.cc DecodeJpegFace with the port's decoder in place of
// libjpeg; the crop, gray and resize below are that function's, with one
// change: each sum of products is written as the fused multiply-adds that
// the committed native/libdataservice.so computes (its Makefile builds with
// -march=native, and g++ 12 contracts the gray sum as
// fma(b, .114, fma(r, .2989, g * .587)) and `a * wa + b * wb` as
// fma(a, wa, b * wb), in its vector and scalar loops alike).
// With the explicit std::fma and -ffp-contract=off the frames are bit for
// bit that library's whatever the host compiler and its flags.
bool DecodeJpegFace(const char* path, int out_size, double crop_ratio,
                    unsigned char* out /* [out_size * out_size] */) {
  std::vector<unsigned char> rgb;
  int w = 0, h = 0;
  if (DecodeJpegRgb(path, &rgb, &w, &h) != kOk) return false;

  // center-crop: vl_imreadjpeg's CropSize is a fraction of the largest
  // OUTPUT-aspect crop contained in the image — square output, so a
  // centered square of side crop_ratio * min(w, h)
  // (1/1.6 for the EmoVoxCeleb build, fetch_emovoxceleb_imdb.m:169;
  // 1.0 for external faces, compute_visual_feats.m:123-143)
  const int side = std::max(
      1, static_cast<int>(std::lround(crop_ratio * std::min(w, h))));
  const int cw = side;
  const int ch = side;
  const int left = (w - cw) / 2;
  const int top = (h - ch) / 2;

  // ITU-R 601 grayscale FIRST (both grayscale and bilinear resize are
  // linear, so the order commutes exactly; gray-first does 1/3 of the
  // interpolation work), restricted to the crop region.
  std::vector<float> gray(static_cast<size_t>(cw) * ch);
  for (int y = 0; y < ch; ++y) {
    const unsigned char* src = rgb.data() + (size_t(top + y) * w + left) * 3;
    float* dst = gray.data() + size_t(y) * cw;
    for (int x = 0; x < cw; ++x) {
      dst[x] = std::fma(float(src[3 * x + 2]), 0.1140f,
                        std::fma(float(src[3 * x]), 0.2989f,
                                 src[3 * x + 1] * 0.5870f));
    }
  }

  // separable align-corners bilinear: rows first (ch x out_size), then
  // columns, with the tap positions/weights precomputed per axis
  const double sx = cw > 1 ? double(cw - 1) / (out_size - 1) : 0.0;
  const double sy = ch > 1 ? double(ch - 1) / (out_size - 1) : 0.0;
  std::vector<int> x0(out_size), x1(out_size), y0(out_size), y1(out_size);
  std::vector<float> wx(out_size), wy(out_size);
  for (int o = 0; o < out_size; ++o) {
    const double fx = o * sx;
    x0[o] = static_cast<int>(fx);
    x1[o] = std::min(x0[o] + 1, cw - 1);
    wx[o] = static_cast<float>(fx - x0[o]);
    const double fy = o * sy;
    y0[o] = static_cast<int>(fy);
    y1[o] = std::min(y0[o] + 1, ch - 1);
    wy[o] = static_cast<float>(fy - y0[o]);
  }
  std::vector<float> rows(static_cast<size_t>(ch) * out_size);
  for (int y = 0; y < ch; ++y) {
    const float* src = gray.data() + size_t(y) * cw;
    float* dst = rows.data() + size_t(y) * out_size;
    for (int o = 0; o < out_size; ++o) {
      dst[o] = std::fma(src[x0[o]], 1.0f - wx[o], src[x1[o]] * wx[o]);
    }
  }
  for (int oy = 0; oy < out_size; ++oy) {
    const float* r0 = rows.data() + size_t(y0[oy]) * out_size;
    const float* r1 = rows.data() + size_t(y1[oy]) * out_size;
    const float w1 = wy[oy];
    const float w0 = 1.0f - w1;
    unsigned char* dst = out + size_t(oy) * out_size;
    for (int ox = 0; ox < out_size; ++ox) {
      const float v = std::fma(r0[ox], w0, r1[ox] * w1);
      const long rounded = std::lround(v);
      dst[ox] = static_cast<unsigned char>(std::clamp<long>(rounded, 0, 255));
    }
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI (the face entry points of native/dataservice.cc, plus the full RGB)
// ---------------------------------------------------------------------------
extern "C" {

// Single face-frame decode: JPEG -> crop(ratio) -> resize -> gray uint8.
int ds_decode_face(const char* path, int out_size, double crop_ratio,
                   unsigned char* out) {
  return DecodeJpegFace(path, out_size, crop_ratio, out) ? 0 : -1;
}

// Batched face decodes into out[count, out_size, out_size].
int ds_decode_faces(const char** paths, int count, int out_size,
                    double crop_ratio, int num_threads, unsigned char* out) {
  std::atomic<int> failures(0);
  const size_t stride = size_t(out_size) * out_size;
  failures.fetch_add(ParallelFor(count, num_threads, [&](int i) {
    if (!DecodeJpegFace(paths[i], out_size, crop_ratio, out + i * stride))
      failures.fetch_add(1);
  }));
  return failures.load();
}

// The full decoded image as RGB [height, width, 3] into `out`, which holds
// `capacity` bytes; width and height are written whenever the decode
// succeeds. Returns 0, or a Status: -1 unreadable file, -2 malformed
// header, -3 unsupported coding, -4 over 64 MP, -5 `capacity` too small
// (nothing written to `out`).
int ds_decode_jpeg_rgb(const char* path, int64_t capacity, unsigned char* out,
                       int32_t* width, int32_t* height) {
  std::vector<unsigned char> rgb;
  int w = 0, h = 0;
  const Status st = DecodeJpegRgb(path, &rgb, &w, &h);
  if (st != kOk) return st;
  *width = w;
  *height = h;
  if (int64_t(rgb.size()) > capacity) return kCapacity;
  std::memcpy(out, rgb.data(), rgb.size());
  return kOk;
}

}  // extern "C"
