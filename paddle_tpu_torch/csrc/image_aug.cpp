// Batched image augmentation: the host-side hot loop of the ResNet/flowers
// input pipeline (resize_short -> random/center crop -> flip -> CHW float32
// -> mean subtract), multithreaded across the batch.
//
// Counterpart of python/paddle/dataset/image.py:simple_transform in the
// reference (cv2-backed there) and the port's own copy of the JAX
// package's csrc/image_aug.cpp. Host code, not a device kernel.
// paddle_tpu_torch/dataset/image.py's _transform_batch_plain is its plain
// numpy version: the same xorshift64* draws, the same float32 operations in
// the same order and the same rounding, so the two agree bit for bit.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// xorshift64* — per-image deterministic stream from (seed, index)
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ? seed : 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    s ^= s >> 12;
    s ^= s << 25;
    s ^= s >> 27;
    return s * 0x2545F4914F6CDD1DULL;
  }
  // uniform integer in [0, n)
  uint64_t below(uint64_t n) { return n ? next() % n : 0; }
};

// bilinear resize (half-pixel centers) HWC uint8 -> HWC uint8.
// Column sample positions/weights are row-invariant: precompute them once,
// then each output row is two source-row passes the compiler can vectorize.
void resize_bilinear_u8(const uint8_t* src, int h, int w, int c,
                        uint8_t* dst, int oh, int ow) {
  const float sy = static_cast<float>(h) / oh;
  const float sx = static_cast<float>(w) / ow;
  std::vector<int> xo0(ow), xo1(ow);
  std::vector<float> wx(ow);
  for (int x = 0; x < ow; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    int x0 = std::min(std::max(static_cast<int>(std::floor(fx)), 0), w - 1);
    xo0[x] = x0 * c;
    xo1[x] = std::min(x0 + 1, w - 1) * c;
    wx[x] = std::min(std::max(fx - x0, 0.0f), 1.0f);
  }
  // horizontal pass scratch for the two source rows feeding an output row
  std::vector<float> rowa(static_cast<size_t>(ow) * c);
  std::vector<float> rowb(static_cast<size_t>(ow) * c);
  int cached_y0 = -1, cached_y1 = -1;

  auto hpass = [&](const uint8_t* srow, float* out) {
    for (int x = 0; x < ow; ++x) {
      const uint8_t* p0 = srow + xo0[x];
      const uint8_t* p1 = srow + xo1[x];
      const float fx = wx[x];
      float* o = out + static_cast<size_t>(x) * c;
      for (int k = 0; k < c; ++k)   // same formula as the numpy path
        o[k] = p0[k] * (1.0f - fx) + p1[k] * fx;
    }
  };

  for (int y = 0; y < oh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = std::min(std::max(static_cast<int>(std::floor(fy)), 0), h - 1);
    int y1 = std::min(y0 + 1, h - 1);
    float fwy = std::min(std::max(fy - y0, 0.0f), 1.0f);
    // consecutive output rows usually share source rows: reuse the pass
    if (y0 == cached_y1) {
      rowa.swap(rowb);
      cached_y0 = y0;
      if (y1 != y0) {
        hpass(src + static_cast<size_t>(y1) * w * c, rowb.data());
        cached_y1 = y1;
      } else {
        rowb = rowa;
        cached_y1 = y1;
      }
    } else if (y0 != cached_y0) {
      hpass(src + static_cast<size_t>(y0) * w * c, rowa.data());
      cached_y0 = y0;
      hpass(src + static_cast<size_t>(y1) * w * c, rowb.data());
      cached_y1 = y1;
    } else if (y1 != cached_y1) {
      hpass(src + static_cast<size_t>(y1) * w * c, rowb.data());
      cached_y1 = y1;
    }
    uint8_t* orow = dst + static_cast<size_t>(y) * ow * c;
    const float* ra = rowa.data();
    const float* rb = rowb.data();
    const int nn = ow * c;
    for (int i = 0; i < nn; ++i) {
      float v = ra[i] * (1.0f - fwy) + rb[i] * fwy;
      orow[i] = static_cast<uint8_t>(
          std::min(std::max(std::nearbyint(v), 0.0f), 255.0f));
    }
  }
}

void transform_one(const uint8_t* img, int h, int w, int c, int resize_size,
                   int crop_size, bool is_train, const float* mean,
                   int mean_len, Rng* rng, float* out) {
  // shorter-edge resize
  int oh, ow;
  if (h > w) {
    ow = resize_size;
    oh = static_cast<int>(
        std::nearbyint(static_cast<double>(h) * resize_size / w));
  } else {
    oh = resize_size;
    ow = static_cast<int>(
        std::nearbyint(static_cast<double>(w) * resize_size / h));
  }
  std::vector<uint8_t> resized;
  const uint8_t* rptr = img;
  if (oh != h || ow != w) {
    resized.resize(static_cast<size_t>(oh) * ow * c);
    resize_bilinear_u8(img, h, w, c, resized.data(), oh, ow);
    rptr = resized.data();
  }

  // crop offsets
  int y0, x0;
  bool flip = false;
  if (is_train) {
    y0 = static_cast<int>(rng->below(oh - crop_size + 1));
    x0 = static_cast<int>(rng->below(ow - crop_size + 1));
    flip = rng->below(2) == 0;
  } else {
    y0 = (oh - crop_size) / 2;
    x0 = (ow - crop_size) / 2;
  }

  // crop (+flip) -> CHW float32 - mean (scalar, per-channel, or a full
  // CHW mean image of crop_size^2 * c elements)
  const bool mean_image = mean && mean_len == c * crop_size * crop_size;
  for (int k = 0; k < c; ++k) {
    float m = 0.0f;
    if (mean && mean_len == c) m = mean[k];
    else if (mean && mean_len == 1) m = mean[0];
    const size_t plane_off = static_cast<size_t>(k) * crop_size * crop_size;
    float* plane = out + plane_off;
    const float* mplane = mean_image ? mean + plane_off : nullptr;
    for (int y = 0; y < crop_size; ++y) {
      const uint8_t* row = rptr + ((y0 + y) * ow + x0) * c;
      for (int x = 0; x < crop_size; ++x) {
        int sx = flip ? (crop_size - 1 - x) : x;
        float mm = mplane ? mplane[y * crop_size + x] : m;
        plane[y * crop_size + x] =
            static_cast<float>(row[sx * c + k]) - mm;
      }
    }
  }
}

}  // namespace

extern "C" {

// Transform a batch of same-sized raw images.
//   src:  n contiguous HWC uint8 images [n, h, w, c]
//   out:  n contiguous CHW float32 crops [n, c, crop, crop]
//   mean: nullptr, [1], or [c] per-channel values subtracted after cast
//   seed: deterministic stream; image i draws from (seed, i) independently
// Returns 0 on success, -1 on bad arguments.
int ptim_transform_batch(const uint8_t* src, int n, int h, int w, int c,
                         int resize_size, int crop_size, int is_train,
                         const float* mean, int mean_len, uint64_t seed,
                         float* out) {
  if (!src || !out || n <= 0 || c <= 0 || crop_size <= 0) return -1;
  int short_edge = std::min(h, w);
  if (resize_size <= 0 || crop_size > resize_size ||
      short_edge <= 0)
    return -1;
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = static_cast<int>(std::min<uint64_t>(hw ? hw : 2, n));
  std::atomic<int> next(0);
  const size_t in_stride = static_cast<size_t>(h) * w * c;
  const size_t out_stride = static_cast<size_t>(c) * crop_size * crop_size;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      Rng rng(seed * 0x9E3779B97F4A7C15ULL + 0xBF58476D1CE4E5B9ULL * (i + 1));
      transform_one(src + i * in_stride, h, w, c, resize_size, crop_size,
                    is_train != 0, mean, mean_len, &rng, out + i * out_stride);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nthreads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return 0;
}

}  // extern "C"
