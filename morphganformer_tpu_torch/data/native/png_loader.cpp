// Native threaded PNG batch loader for the training input pipeline.
//
// The counterpart of the reference's DataLoader worker processes
// (training_loop.py:53-67): decode + batch assembly run in C++ worker
// threads with a prefetch ring, so the Python host loop only hands
// ready-made uint8 NHWC batches to the device.
//
// Scope: non-interlaced 8-bit PNG (gray / gray+alpha / RGB / RGBA), the
// format written by the dataset tool (PIL default output). Decoding is
// zlib inflate + per-scanline unfiltering (the 5 standard PNG filters).
//
// C API (ctypes-friendly):
//   void* loader_create(const char** paths, int num_files, int height,
//                       int width, int channels, int batch_size,
//                       int num_threads, int queue_depth, uint64_t seed,
//                       int shard_index, int num_shards);
//   int   loader_next(void* handle, unsigned char* out);  // blocks; 0 = ok
//   void  loader_destroy(void* handle);
//   int   png_decode_file(const char* path, unsigned char* out,
//                         int height, int width, int channels);

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct PngImage {
  uint32_t width = 0, height = 0;
  int channels = 0;
  std::vector<uint8_t> pixels;  // HWC uint8
};

uint32_t read_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode a PNG byte buffer. Returns false on unsupported/corrupt input.
bool decode_png(const uint8_t* data, size_t size, PngImage* out) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (size < 8 || memcmp(data, kSig, 8) != 0) return false;

  size_t pos = 8;
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = -1, interlace = 0;
  std::vector<uint8_t> idat;

  while (pos + 8 <= size) {
    uint32_t len = read_be32(data + pos);
    const char* type = reinterpret_cast<const char*>(data + pos + 4);
    const uint8_t* chunk = data + pos + 8;
    if (pos + 12 + len > size) return false;
    if (memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return false;
      width = read_be32(chunk);
      height = read_be32(chunk + 4);
      bit_depth = chunk[8];
      color_type = chunk[9];
      interlace = chunk[12];
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), chunk, chunk + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (width == 0 || height == 0 || bit_depth != 8 || interlace != 0)
    return false;

  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // RGB
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // RGBA
    default: return false;        // palette unsupported
  }

  const size_t stride = size_t(width) * channels;
  std::vector<uint8_t> raw((stride + 1) * height);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return false;

  out->width = width;
  out->height = height;
  out->channels = channels;
  out->pixels.resize(stride * height);

  // Unfilter scanlines in place, one specialized loop per filter type
  // (hoisting the filter switch out of the byte loop is ~3x faster).
  const size_t bpp = channels;  // bytes per pixel (8-bit)
  for (uint32_t y = 0; y < height; ++y) {
    const uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = raw.data() + (stride + 1) * y + 1;
    uint8_t* dst = out->pixels.data() + stride * y;
    const uint8_t* prev = y > 0 ? out->pixels.data() + stride * (y - 1)
                                : nullptr;
    switch (filter) {
      case 0:
        memcpy(dst, src, stride);
        break;
      case 1:  // Sub
        memcpy(dst, src, bpp);
        for (size_t x = bpp; x < stride; ++x)
          dst[x] = uint8_t(src[x] + dst[x - bpp]);
        break;
      case 2:  // Up
        if (prev) {
          for (size_t x = 0; x < stride; ++x)
            dst[x] = uint8_t(src[x] + prev[x]);
        } else {
          memcpy(dst, src, stride);
        }
        break;
      case 3:  // Average
        for (size_t x = 0; x < bpp; ++x)
          dst[x] = uint8_t(src[x] + (prev ? prev[x] : 0) / 2);
        for (size_t x = bpp; x < stride; ++x)
          dst[x] = uint8_t(src[x] + (dst[x - bpp] + (prev ? prev[x] : 0)) / 2);
        break;
      case 4:  // Paeth
        for (size_t x = 0; x < bpp; ++x)
          dst[x] = uint8_t(src[x] + (prev ? prev[x] : 0));
        if (prev) {
          for (size_t x = bpp; x < stride; ++x)
            dst[x] = uint8_t(src[x] + paeth(dst[x - bpp], prev[x],
                                            prev[x - bpp]));
        } else {
          for (size_t x = bpp; x < stride; ++x)
            dst[x] = uint8_t(src[x] + dst[x - bpp]);
        }
        break;
      default:
        return false;
    }
  }
  return true;
}

bool decode_png_file(const std::string& path, PngImage* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n);
  size_t got = fread(buf.data(), 1, n, f);
  fclose(f);
  if (long(got) != n) return false;
  return decode_png(buf.data(), buf.size(), out);
}

// Copy decoded image into an NHWC slot, converting channel count.
void blit(const PngImage& img, uint8_t* dst, int channels) {
  const size_t pixels = size_t(img.width) * img.height;
  if (img.channels == channels) {
    memcpy(dst, img.pixels.data(), pixels * channels);
    return;
  }
  for (size_t i = 0; i < pixels; ++i) {
    uint8_t r, g, b;
    switch (img.channels) {
      case 1: r = g = b = img.pixels[i]; break;
      case 2: r = g = b = img.pixels[i * 2]; break;
      case 3:
      case 4:
        r = img.pixels[i * img.channels];
        g = img.pixels[i * img.channels + 1];
        b = img.pixels[i * img.channels + 2];
        break;
      default: r = g = b = 0;
    }
    if (channels == 1) {
      dst[i] = uint8_t((r * 299 + g * 587 + b * 114) / 1000);
    } else {
      dst[i * channels] = r;
      dst[i * channels + 1] = g;
      dst[i * channels + 2] = b;
      if (channels == 4) dst[i * channels + 3] = 255;
    }
  }
}

struct Loader {
  std::vector<std::string> paths;
  int height, width, channels, batch_size, queue_depth;
  int shard_index, num_shards;
  uint64_t seed;

  std::vector<std::thread> workers;
  std::deque<std::vector<uint8_t>> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<bool> stop{false};
  std::atomic<int> errors{0};

  // Producer state: an endless reshuffled index stream, sharded.
  std::mutex idx_mu;
  std::vector<uint32_t> order;
  size_t cursor = 0;
  std::mt19937_64 rng;

  size_t image_bytes() const {
    return size_t(height) * width * channels;
  }

  uint32_t next_index() {
    std::lock_guard<std::mutex> lk(idx_mu);
    while (true) {
      if (cursor >= order.size()) {
        order.resize(paths.size());
        for (uint32_t i = 0; i < paths.size(); ++i) order[i] = i;
        std::shuffle(order.begin(), order.end(), rng);
        // Shard: keep indices shard_index::num_shards.
        std::vector<uint32_t> mine;
        for (size_t i = shard_index; i < order.size(); i += num_shards)
          mine.push_back(order[i]);
        order.swap(mine);
        cursor = 0;
        if (order.empty()) return 0;
      }
      return order[cursor++];
    }
  }

  void worker() {
    PngImage img;
    while (!stop.load()) {
      std::vector<uint8_t> batch(image_bytes() * batch_size);
      for (int b = 0; b < batch_size && !stop.load(); ++b) {
        uint32_t idx = next_index();
        if (!decode_png_file(paths[idx], &img) ||
            img.height != uint32_t(height) || img.width != uint32_t(width)) {
          errors.fetch_add(1);
          memset(batch.data() + image_bytes() * b, 0, image_bytes());
          continue;
        }
        blit(img, batch.data() + image_bytes() * b, channels);
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || int(ready.size()) < queue_depth;
      });
      if (stop.load()) return;
      ready.push_back(std::move(batch));
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int num_files, int height, int width,
                    int channels, int batch_size, int num_threads,
                    int queue_depth, uint64_t seed, int shard_index,
                    int num_shards) {
  // Reject degenerate configs instead of letting a worker thread index an
  // empty path vector (undefined behavior) later.
  if (paths == nullptr || num_files <= 0 || batch_size <= 0 || height <= 0 ||
      width <= 0 || channels <= 0)
    return nullptr;
  auto* l = new Loader();
  l->paths.assign(paths, paths + num_files);
  l->height = height;
  l->width = width;
  l->channels = channels;
  l->batch_size = batch_size;
  l->queue_depth = queue_depth > 0 ? queue_depth : 4;
  l->seed = seed;
  l->shard_index = shard_index;
  l->num_shards = num_shards > 0 ? num_shards : 1;
  l->rng.seed(seed);
  for (int i = 0; i < (num_threads > 0 ? num_threads : 2); ++i)
    l->workers.emplace_back([l] { l->worker(); });
  return l;
}

int loader_next(void* handle, unsigned char* out) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv_ready.wait(lk, [&] { return l->stop.load() || !l->ready.empty(); });
  if (l->ready.empty()) return -1;
  std::vector<uint8_t> batch = std::move(l->ready.front());
  l->ready.pop_front();
  l->cv_space.notify_one();
  lk.unlock();
  memcpy(out, batch.data(), batch.size());
  return 0;
}

int loader_error_count(void* handle) {
  return static_cast<Loader*>(handle)->errors.load();
}

void loader_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  l->cv_ready.notify_all();
  l->cv_space.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

int png_decode_file(const char* path, unsigned char* out, int height,
                    int width, int channels) {
  PngImage img;
  if (!decode_png_file(path, &img)) return -1;
  if (img.height != uint32_t(height) || img.width != uint32_t(width))
    return -2;
  blit(img, out, channels);
  return 0;
}

}  // extern "C"
