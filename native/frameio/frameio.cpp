// frameio: native frame output runtime for the raytracer.
//
// The reference's presentation path is native C++ (CUDA–GL interop PBO +
// glTexSubImage2D + GLUT swap, main.cpp:103-226). A headless GPU host has
// no GL swapchain; the equivalent runtime concern is getting rendered frames OFF
// the hot loop fast: encode + write on a background thread with a bounded
// ring of reusable buffers, so the Python render loop never blocks on disk.
//
// Provides, via a C ABI (consumed through ctypes — no pybind11 in image):
//   fio_write_png    — PNG encode: stored-deflate blocks at level 0
//                      (memcpy-speed, valid PNG, no zlib needed), real
//                      Sub-filtered zlib compression at levels 1-9 when
//                      built with -DFIO_HAVE_ZLIB (Makefile autodetects)
//   fio_set_png_level— global encode level (0 = stored, default)
//   fio_writer_*     — async frame writer (ring buffer + worker threads;
//                      fio_writer_create2 takes a thread count so
//                      compressed encodes parallelize across frames)
//   fio_now_ns       — monotonic clock for frame pacing / FPS accounting
//
// Build: native/Makefile → libframeio.so. Loaded by
// raytracing_cuda_tpu/utils/frameio.py, which falls back to PIL when the
// library has not been built.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>       // clock_gettime — do not rely on transitive includes
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#ifdef FIO_HAVE_ZLIB
#include <zlib.h>
#endif

namespace {

// PNG encode level: 0 = stored-deflate (default), 1-9 = zlib when built
// with it (silently treated as 0 otherwise — output stays a valid PNG).
std::atomic<int> g_png_level{0};

// ---------------------------------------------------------------------------
// CRC-32 (PNG chunk checksums) and Adler-32 (zlib stream checksum)
// ---------------------------------------------------------------------------

uint32_t crc_table[256];
std::once_flag crc_once;

void init_crc() {
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t c = n;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[n] = c;
  }
}

uint32_t crc32(uint32_t crc, const uint8_t* buf, size_t len) {
  std::call_once(crc_once, init_crc);
  crc ^= 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++)
    crc = crc_table[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t adler32(const uint8_t* buf, size_t len) {
  uint32_t a = 1, b = 0;
  while (len > 0) {
    size_t n = len < 5552 ? len : 5552;  // avoid overflow before mod
    len -= n;
    while (n--) {
      a += *buf++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24);
  v.push_back(x >> 16);
  v.push_back(x >> 8);
  v.push_back(x);
}

void chunk(std::vector<uint8_t>& out, const char type[4],
           const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  out.insert(out.end(), data, data + len);
  put_be32(out, crc32(0, out.data() + start, len + 4));
}

// Encode RGB8 rows into a PNG. Level 0: stored (uncompressed) deflate
// blocks — ~memcpy speed, files w*h*3 + ~2%, the right trade for hot-loop
// frame dumps. Levels 1-9 (zlib builds): per-row Sub filter + deflate —
// ~4-6x smaller on rendered frames, for archival records (encode runs on
// writer threads, off the render loop).
void encode_png(std::vector<uint8_t>& out, const uint8_t* rgb, int w, int h,
                int level) {
  static const uint8_t sig[8] = {137, 'P', 'N', 'G', '\r', '\n', 26, '\n'};
  out.insert(out.end(), sig, sig + 8);

  uint8_t ihdr[13];
  ihdr[0] = w >> 24; ihdr[1] = w >> 16; ihdr[2] = w >> 8; ihdr[3] = w;
  ihdr[4] = h >> 24; ihdr[5] = h >> 16; ihdr[6] = h >> 8; ihdr[7] = h;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type: truecolor RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  chunk(out, "IHDR", ihdr, 13);

  const size_t stride = (size_t)w * 3;

#ifdef FIO_HAVE_ZLIB
  if (level > 0) {
    // scanline stream with the Sub filter (type 1): b[i] - b[i-bpp].
    // Rendered frames are dominated by horizontal gradients (sky, sea),
    // which Sub turns into near-zero runs that deflate eats.
    std::vector<uint8_t> raw((stride + 1) * h);
    for (int y = 0; y < h; y++) {
      uint8_t* row = raw.data() + (size_t)y * (stride + 1);
      const uint8_t* src = rgb + y * stride;
      row[0] = 1;  // Sub
      row[1] = src[0]; row[2] = src[1]; row[3] = src[2];
      for (size_t i = 3; i < stride; i++)
        row[1 + i] = (uint8_t)(src[i] - src[i - 3]);
    }
    uLongf zcap = compressBound((uLong)raw.size());
    std::vector<uint8_t> z(zcap);
    if (compress2(z.data(), &zcap, raw.data(), (uLong)raw.size(),
                  level > 9 ? 9 : level) == Z_OK) {
      chunk(out, "IDAT", z.data(), zcap);
      chunk(out, "IEND", nullptr, 0);
      return;
    }
    // compress2 failure (can't happen with a sound cap, but stay valid):
    // fall through to the stored path below
  }
#else
  (void)level;
#endif

  // raw scanline stream: filter byte 0 + row
  std::vector<uint8_t> raw;
  raw.reserve((stride + 1) * h);
  for (int y = 0; y < h; y++) {
    raw.push_back(0);
    raw.insert(raw.end(), rgb + y * stride, rgb + (y + 1) * stride);
  }

  // zlib wrapper + stored deflate blocks (max 65535 bytes each)
  std::vector<uint8_t> z;
  z.reserve(raw.size() + raw.size() / 65535 * 5 + 16);
  z.push_back(0x78);
  z.push_back(0x01);
  size_t off = 0;
  while (off < raw.size()) {
    size_t n = raw.size() - off;
    if (n > 65535) n = 65535;
    bool last = off + n == raw.size();
    z.push_back(last ? 1 : 0);
    z.push_back(n & 0xFF);
    z.push_back(n >> 8);
    z.push_back(~n & 0xFF);
    z.push_back((~n >> 8) & 0xFF);
    z.insert(z.end(), raw.data() + off, raw.data() + off + n);
    off += n;
  }
  put_be32(z, adler32(raw.data(), raw.size()));
  chunk(out, "IDAT", z.data(), z.size());
  chunk(out, "IEND", nullptr, 0);
}

// ---------------------------------------------------------------------------
// async frame writer
// ---------------------------------------------------------------------------

struct Frame {
  std::string path;
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  bool full = false;
};

struct Writer {
  std::vector<Frame> ring;
  size_t head = 0, tail = 0, count = 0;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<long> written{0};
  std::atomic<long> failed{0};
  int inflight = 0;   // frames popped from the ring but not yet on disk

  explicit Writer(int capacity, int threads = 1) : ring(capacity) {
    if (threads < 1) threads = 1;
    for (int i = 0; i < threads; i++)
      workers.emplace_back([this] { run(); });
  }

  void run() {
    for (;;) {
      Frame f;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_get.wait(lk, [this] { return count > 0 || stop.load(); });
        if (count == 0 && stop.load()) return;
        f = std::move(ring[tail]);
        ring[tail].full = false;
        tail = (tail + 1) % ring.size();
        count--;
        inflight++;
        cv_put.notify_one();
      }
      std::vector<uint8_t> png;
      png.reserve((size_t)f.w * f.h * 3 + 1024);
      encode_png(png, f.rgb.data(), f.w, f.h, g_png_level.load());
      FILE* fp = std::fopen(f.path.c_str(), "wb");
      if (fp) {
        size_t n = std::fwrite(png.data(), 1, png.size(), fp);
        if (std::fclose(fp) == 0 && n == png.size()) {
          written.fetch_add(1);
        } else {
          failed.fetch_add(1);   // disk full / IO error mid-write
        }
      } else {
        failed.fetch_add(1);     // unwritable path: surfaced via fio_writer_failed
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        inflight--;
        cv_put.notify_all();   // drain() waits on count==0 && inflight==0
      }
    }
  }

  void submit(const char* path, const uint8_t* rgb, int w, int h) {
    std::unique_lock<std::mutex> lk(mu);
    cv_put.wait(lk, [this] { return count < ring.size(); });
    Frame& f = ring[head];
    f.path = path;
    f.w = w;
    f.h = h;
    f.rgb.assign(rgb, rgb + (size_t)w * h * 3);
    f.full = true;
    head = (head + 1) % ring.size();
    count++;
    cv_get.notify_one();
  }

  void drain() {
    std::unique_lock<std::mutex> lk(mu);
    cv_put.wait(lk, [this] { return count == 0 && inflight == 0; });
  }

  ~Writer() {
    drain();
    stop.store(true);
    cv_get.notify_all();
    for (auto& w : workers) w.join();
  }
};

}  // namespace

extern "C" {

// Global PNG encode level: 0 = stored-deflate (default), 1-9 = zlib
// compression with the Sub filter (needs a -DFIO_HAVE_ZLIB build; returns
// the level actually in effect — 0 on zlib-less builds).
int fio_set_png_level(int level) {
#ifdef FIO_HAVE_ZLIB
  if (level < 0) level = 0;
  if (level > 9) level = 9;
#else
  level = 0;
#endif
  g_png_level.store(level);
  return level;
}

int fio_get_png_level() { return g_png_level.load(); }

int fio_write_png(const char* path, const uint8_t* rgb, int w, int h) {
  std::vector<uint8_t> png;
  png.reserve((size_t)w * h * 3 + 1024);
  encode_png(png, rgb, w, h, g_png_level.load());
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return -1;
  size_t n = std::fwrite(png.data(), 1, png.size(), fp);
  std::fclose(fp);
  return n == png.size() ? 0 : -2;
}

// Encode into a caller-readable buffer; returns encoded size (≤ cap) or -1.
long fio_encode_png(const uint8_t* rgb, int w, int h, uint8_t* out, long cap) {
  std::vector<uint8_t> png;
  png.reserve((size_t)w * h * 3 + 1024);
  encode_png(png, rgb, w, h, g_png_level.load());
  if ((long)png.size() > cap) return -1;
  std::memcpy(out, png.data(), png.size());
  return (long)png.size();
}

void* fio_writer_create(int ring_capacity) {
  return new Writer(ring_capacity > 0 ? ring_capacity : 4);
}

// Multi-worker variant: compressed encodes parallelize across frames
// (frames are independent; the ring pop is the only shared state).
void* fio_writer_create2(int ring_capacity, int threads) {
  return new Writer(ring_capacity > 0 ? ring_capacity : 4,
                    threads > 0 ? threads : 1);
}

void fio_writer_submit(void* wr, const char* path, const uint8_t* rgb,
                       int w, int h) {
  static_cast<Writer*>(wr)->submit(path, rgb, w, h);
}

long fio_writer_written(void* wr) {
  return static_cast<Writer*>(wr)->written.load();
}

long fio_writer_failed(void* wr) {
  return static_cast<Writer*>(wr)->failed.load();
}

void fio_writer_drain(void* wr) { static_cast<Writer*>(wr)->drain(); }

void fio_writer_destroy(void* wr) { delete static_cast<Writer*>(wr); }

long long fio_now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (long long)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

}  // extern "C"
