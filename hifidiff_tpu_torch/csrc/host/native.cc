// hifidiff_native — C++ data-path core for the host input pipeline (the
// port's copy of native/src/hifidiff_native.cc, same code, built with the
// same flags by hifidiff_tpu_torch/data/host.py, so both packages compute
// the same values on one host).
//
// The reference's data loader leans on cv2/basicsr native kernels
// (dataset_multipie.py:104-146) and torch DataLoader worker processes. This
// library provides the equivalent numeric transforms as a small C ABI
// (consumed via ctypes, see hifidiff_tpu_torch/data/native.py):
//
//   * resize_bilinear / resize_bicubic  — cv2 INTER_LINEAR / INTER_CUBIC
//     semantics (src = (dst+0.5)*scale-0.5, Keys a=-0.75, border clamp)
//   * filter2d                          — cv2 BORDER_REFLECT_101 conv
//   * add_gaussian_noise                — xorshift128+ normal noise
//   * quantize8                         — snap to the 8-bit grid
//   * degrade_stage1 (blur+downsample+noise fused, one pass per sample)
//
// All functions operate on float32 HWC buffers, are thread-safe, and
// parallelize over a caller-sized worker pool for batch entry points.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------- helpers ----------

static inline int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
  }
  return i;
}

static inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

static inline float cubic_w(float x) {
  const float a = -0.75f;  // cv2/torch Keys kernel
  x = std::fabs(x);
  if (x <= 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// ---------- resize ----------

static void resize_axis_weights(int in_n, int out_n, int taps,
                                std::vector<int>& idx,
                                std::vector<float>& wgt, bool cubic) {
  idx.resize((size_t)out_n * taps);
  wgt.resize((size_t)out_n * taps);
  const double scale = (double)in_n / out_n;
  for (int o = 0; o < out_n; ++o) {
    const double src = (o + 0.5) * scale - 0.5;
    const int base = (int)std::floor(src) - (cubic ? 1 : 0);
    const double frac = src - std::floor(src);
    for (int t = 0; t < taps; ++t) {
      int i = base + t;
      float w;
      if (cubic) {
        w = cubic_w((float)(t - 1 - frac));
      } else {
        w = t == 0 ? (float)(1.0 - frac) : (float)frac;
      }
      idx[(size_t)o * taps + t] = std::min(std::max(i, 0), in_n - 1);
      wgt[(size_t)o * taps + t] = w;
    }
  }
}

static void resize_impl(const float* src, float* dst, int h, int w, int c,
                        int oh, int ow, bool cubic) {
  const int taps = cubic ? 4 : 2;
  std::vector<int> yi, xi;
  std::vector<float> yw, xw;
  resize_axis_weights(h, oh, taps, yi, yw, cubic);
  resize_axis_weights(w, ow, taps, xi, xw, cubic);
  // horizontal pass into temp (h, ow, c), then vertical
  std::vector<float> tmp((size_t)h * ow * c);
  for (int y = 0; y < h; ++y) {
    const float* row = src + (size_t)y * w * c;
    float* trow = tmp.data() + (size_t)y * ow * c;
    for (int x = 0; x < ow; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int t = 0; t < taps; ++t)
          acc += xw[(size_t)x * taps + t] *
                 row[(size_t)xi[(size_t)x * taps + t] * c + ch];
        trow[(size_t)x * c + ch] = acc;
      }
    }
  }
  for (int y = 0; y < oh; ++y) {
    float* drow = dst + (size_t)y * ow * c;
    for (int x = 0; x < ow; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int t = 0; t < taps; ++t)
          acc += yw[(size_t)y * taps + t] *
                 tmp[(size_t)yi[(size_t)y * taps + t] * ow * c +
                     (size_t)x * c + ch];
        drow[(size_t)x * c + ch] = acc;
      }
    }
  }
}

void hn_resize(const float* src, float* dst, int h, int w, int c, int oh,
               int ow, int cubic) {
  resize_impl(src, dst, h, w, c, oh, ow, cubic != 0);
}

// ---------- filter2d (BORDER_REFLECT_101) ----------

// One blurred output row. Vectorizable formulation: for each kernel tap,
// the interior columns are a contiguous shifted row (an AXPY over w*c
// floats the compiler auto-vectorizes); only the <= kw-1 border columns
// take the reflect101 scalar path. Accumulation order (ky outer, kx
// inner) matches the naive per-pixel loop, so results are bit-identical.
static void blur_row(const float* src, float* out, int y, int h, int w,
                     int c, const float* kernel, int kh, int kw) {
  const int ay = kh / 2, ax = kw / 2;
  const size_t rowlen = (size_t)w * c;
  std::memset(out, 0, rowlen * sizeof(float));
  for (int ky = 0; ky < kh; ++ky) {
    const int sy = reflect101(y + ky - ay, h);
    const float* srow = src + (size_t)sy * rowlen;
    for (int kx = 0; kx < kw; ++kx) {
      const float kv = kernel[(size_t)ky * kw + kx];
      const int dx = kx - ax;
      const int x0 = dx < 0 ? -dx : 0;
      const int x1 = dx > 0 ? w - dx : w;
      const float* sp = srow + (size_t)(x0 + dx) * c;
      float* op = out + (size_t)x0 * c;
      const size_t n = (size_t)(x1 - x0) * c;
      for (size_t i = 0; i < n; ++i) op[i] += kv * sp[i];
      for (int x = 0; x < x0; ++x) {
        const int sx = reflect101(x + dx, w);
        for (int ch = 0; ch < c; ++ch)
          out[(size_t)x * c + ch] += kv * srow[(size_t)sx * c + ch];
      }
      for (int x = x1; x < w; ++x) {
        const int sx = reflect101(x + dx, w);
        for (int ch = 0; ch < c; ++ch)
          out[(size_t)x * c + ch] += kv * srow[(size_t)sx * c + ch];
      }
    }
  }
}

void hn_filter2d(const float* src, float* dst, int h, int w, int c,
                 const float* kernel, int kh, int kw) {
  for (int y = 0; y < h; ++y)
    blur_row(src, dst + (size_t)y * w * c, y, h, w, c, kernel, kh, kw);
}

// ---------- noise / quantize ----------

struct Xorshift128p {
  uint64_t s0, s1;
  explicit Xorshift128p(uint64_t seed) {
    s0 = seed ^ 0x9E3779B97F4A7C15ull;
    s1 = (seed << 1) | 1u;
    for (int i = 0; i < 8; ++i) next();
  }
  uint64_t next() {
    uint64_t x = s0;
    const uint64_t y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  float uniform() {  // (0, 1)
    return (float)((next() >> 11) + 1) * (1.0f / 9007199254740994.0f);
  }
};

void hn_add_gaussian_noise(float* img, int64_t n, float sigma,
                           uint64_t seed) {
  Xorshift128p rng(seed);
  for (int64_t i = 0; i + 1 < n; i += 2) {
    const float u1 = rng.uniform();
    const float u2 = rng.uniform();
    const float r = std::sqrt(-2.0f * std::log(u1)) * sigma;
    const float th = 6.2831853071795864769f * u2;
    img[i] = clampf(img[i] + r * std::cos(th), 0.0f, 1.0f);
    img[i + 1] = clampf(img[i + 1] + r * std::sin(th), 0.0f, 1.0f);
  }
  if (n & 1) {
    const float u1 = rng.uniform();
    const float u2 = rng.uniform();
    const float r = std::sqrt(-2.0f * std::log(u1)) * sigma;
    img[n - 1] =
        clampf(img[n - 1] + r * std::cos(6.2831853071795864769f * u2),
               0.0f, 1.0f);
  }
}

void hn_quantize8(float* img, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    img[i] = clampf(std::nearbyint(img[i] * 255.0f), 0.0f, 255.0f) / 255.0f;
}

// ---------- fused degradation stage (blur -> downsample -> noise) --------

void hn_degrade_stage1(const float* src, float* dst, int h, int w, int c,
                       const float* kernel, int ksize, int small_h,
                       int small_w, float noise_sigma, uint64_t seed) {
  // the linear downsample only reads 2 source rows per output row — blur
  // just those (exact: unread rows cannot affect the result). At the
  // typical U(1,8) downsample scales this skips most of the blur work.
  const int taps = 2;
  std::vector<int> yi;
  std::vector<float> yw;
  resize_axis_weights(h, small_h, taps, yi, yw, false);
  std::vector<uint8_t> needed((size_t)h, 0);
  for (size_t i = 0; i < yi.size(); ++i) needed[(size_t)yi[i]] = 1;
  std::vector<float> blurred((size_t)h * w * c, 0.0f);
  for (int y = 0; y < h; ++y)
    if (needed[(size_t)y])
      blur_row(src, blurred.data() + (size_t)y * w * c, y, h, w, c, kernel,
               ksize, ksize);
  resize_impl(blurred.data(), dst, h, w, c, small_h, small_w, false);
  hn_add_gaussian_noise(dst, (int64_t)small_h * small_w * c, noise_sigma,
                        seed);
}

// ---------- batched parallel driver ----------

typedef void (*hn_job_fn)(int index, void* ctx);

void hn_parallel_for(int n, int num_threads, hn_job_fn fn, void* ctx) {
  if (num_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i, ctx);
    return;
  }
  std::atomic<int> cursor{0};
  std::vector<std::thread> pool;
  const int workers = std::min(num_threads, n);
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        const int i = cursor.fetch_add(1);
        if (i >= n) return;
        fn(i, ctx);
      }
    });
  }
  for (auto& th : pool) th.join();
}

void hn_resize_batch(const float* src, float* dst, int b, int h, int w,
                     int c, int oh, int ow, int cubic, int num_threads) {
  struct Ctx {
    const float* src;
    float* dst;
    int h, w, c, oh, ow, cubic;
  } ctx{src, dst, h, w, c, oh, ow, cubic};
  hn_parallel_for(
      b, num_threads,
      [](int i, void* p) {
        auto* t = (Ctx*)p;
        resize_impl(t->src + (size_t)i * t->h * t->w * t->c,
                    t->dst + (size_t)i * t->oh * t->ow * t->c, t->h, t->w,
                    t->c, t->oh, t->ow, t->cubic != 0);
      },
      &ctx);
}

}  // extern "C"
