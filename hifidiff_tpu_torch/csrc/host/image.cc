// The port's host image path: the PNG row filters, passes and pixel
// layouts, the BMP pixel layouts and RLE, cv2's and PIL's resizes and cv2's
// filter2D, each computing what the numpy version in hifidiff_tpu_torch/data
// (image_io.decode_png_plain, image_io.decode_bmp_plain,
// resize.resize_cv2_plain / resize_pil_plain, degradations.filter2d_plain)
// computes, bit for bit. Host code with a plain C interface, bound with
// ctypes by those modules; ctypes releases the GIL for the call, so loader
// threads run it in parallel.
//
// Bit-exactness rests on three things:
//   * every sum runs in the numpy version's order and type: float32 where
//     numpy sums float32 arrays, double where it sums float64, int64 (or a
//     type that cannot overflow at these sizes) where it sums integers;
//   * the file is built with -ffp-contract=off and without -ffast-math
//     (data/host.py), so no a*b + c becomes one fused multiply-add;
//   * on x86-64 float and double arithmetic runs in SSE registers at its
//     own width, as numpy's does.
//
// Each function takes its output buffer from the caller, sized by the
// caller, and returns 0, or a code that names the refusal.

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------------- PNG

// One scanline of `stride` bytes unfiltered in place of `line` into `cur`,
// on the previous reconstructed scanline `prior` (zeros before the first).
// Average and Paeth read the reconstructed byte bpp to the left (0 before
// the row); Paeth's ties go to left (a), then above (b).
bool unfilter_row(int kind, const uint8_t* line, const uint8_t* prior,
                  uint8_t* cur, size_t stride, size_t bpp) {
  switch (kind) {
    case 0:
      std::memcpy(cur, line, stride);
      return true;
    case 1:
      for (size_t i = 0; i < stride; ++i)
        cur[i] = uint8_t(line[i] + (i >= bpp ? cur[i - bpp] : 0));
      return true;
    case 2:
      for (size_t i = 0; i < stride; ++i) cur[i] = uint8_t(line[i] + prior[i]);
      return true;
    case 3:
      for (size_t i = 0; i < stride; ++i) {
        int a = i >= bpp ? cur[i - bpp] : 0;
        cur[i] = uint8_t(line[i] + ((a + prior[i]) >> 1));
      }
      return true;
    case 4:
      for (size_t i = 0; i < stride; ++i) {
        int a = i >= bpp ? cur[i - bpp] : 0;
        int b = prior[i];
        int c = i >= bpp ? prior[i - bpp] : 0;
        int pa = std::abs(b - c), pb = std::abs(a - c),
            pc = std::abs(a + b - 2 * c);
        int p = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        cur[i] = uint8_t(line[i] + p);
      }
      return true;
    default:
      return false;
  }
}

// -------------------------------------------------------------- cv2 resize

// cv2's resize taps along one axis: per output index the clamped source
// taps and their float32 coefficients (4 for cubic, 2 for linear), the
// source coordinate (d + 0.5) * scale - 0.5 in double, then float32.
void cv2_taps(int in, int out, bool cubic, std::vector<int>& taps,
              std::vector<float>& coef) {
  const int k = cubic ? 4 : 2;
  taps.resize(size_t(out) * k);
  coef.resize(size_t(out) * k);
  const double scale = 1.0 / (double(out) / double(in));
  for (int d = 0; d < out; ++d) {
    float f = float((double(d) + 0.5) * scale - 0.5);
    float fl = std::floor(f);
    int base = int(fl);
    float x = f - fl;
    float* c = &coef[size_t(d) * k];
    int first;
    if (cubic) {
      const float a = -0.75f, one = 1.0f;
      float x1 = x + one;
      c[0] = ((a * x1 - 5.0f * a) * x1 + 8.0f * a) * x1 - 4.0f * a;
      c[1] = ((a + 2.0f) * x - (a + 3.0f)) * x * x + one;
      float y = one - x;
      c[2] = ((a + 2.0f) * y - (a + 3.0f)) * y * y + one;
      c[3] = one - c[0] - c[1] - c[2];
      first = base - 1;
    } else {
      // a coordinate outside [0, in - 1] is pinned to the edge pixel
      if (base < 0 || base >= in - 1) {
        x = 0.0f;
        base = base < 0 ? 0 : in - 1;
      }
      c[0] = 1.0f - x;
      c[1] = x;
      first = base;
    }
    for (int t = 0; t < k; ++t)
      taps[size_t(d) * k + t] = std::min(std::max(first + t, 0), in - 1);
  }
}

// The horizontal pass: (h, ow * ch) float32 rows, taps summed in order.
void cv2_rows_f32(const float* src, float* rows, int h, int w, int ch,
                  int ow, int k, const std::vector<int>& taps,
                  const std::vector<float>& coef) {
  for (int y = 0; y < h; ++y) {
    const float* s = src + size_t(y) * w * ch;
    float* r = rows + size_t(y) * ow * ch;
    for (int xo = 0; xo < ow; ++xo) {
      const int* t = &taps[size_t(xo) * k];
      const float* c = &coef[size_t(xo) * k];
      for (int q = 0; q < ch; ++q) {
        float acc = s[t[0] * ch + q] * c[0];
        for (int j = 1; j < k; ++j) acc = acc + s[t[j] * ch + q] * c[j];
        r[xo * ch + q] = acc;
      }
    }
  }
}

// ------------------------------------------------------------- PIL resize

const int kPilBits = 32 - 8 - 2;

double pil_bicubic(double x) {
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

// Pillow's precompute_coeffs (bicubic, the box (0, in)) and
// normalize_coeffs_8bpc: per output index the first tap, the number of
// taps and `ksize` fixed-point coefficients.
int pil_coeffs(int in, int out, std::vector<int>& xmin,
               std::vector<int>& xmax, std::vector<int64_t>& kk) {
  const double scale = double(in) / double(out);
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  const int ksize = int(std::ceil(support)) * 2 + 1;
  const double ss = 1.0 / filterscale;
  xmin.resize(out);
  xmax.resize(out);
  kk.assign(size_t(out) * ksize, 0);
  std::vector<double> w(ksize);
  for (int d = 0; d < out; ++d) {
    const double center = (double(d) + 0.5) * scale;
    int64_t lo = int64_t(center - support + 0.5);
    lo = std::max<int64_t>(lo, 0);
    int64_t hi = std::min<int64_t>(int64_t(center + support + 0.5), in) - lo;
    xmin[d] = int(lo);
    xmax[d] = int(hi);
    double ww = 0.0;
    for (int j = 0; j < ksize; ++j) {
      double v = pil_bicubic((double(j + lo) - center + 0.5) * ss);
      w[j] = j < hi ? v : 0.0;
      ww = ww + w[j];
    }
    for (int j = 0; j < ksize; ++j) {
      double v = ww != 0.0 ? w[j] / ww : w[j];
      double fixed = v * double(1 << kPilBits);
      kk[size_t(d) * ksize + j] = int64_t(v < 0 ? fixed - 0.5 : fixed + 0.5);
    }
  }
  return ksize;
}

// One PIL pass along an axis of a uint8 image seen as (outer, n, inner):
// out (outer, on, inner); int64 sums from 1 << 21, >> 22, clipped. Taps
// past xmax weigh 0 and are not summed. `Inner` > 0 fixes `inner` at
// compile time (the horizontal pass over 1-4 channels).
template <int Inner>
void pil_pass(const uint8_t* src, uint8_t* dst, int outer, int n, int inner,
              int on) {
  if (Inner) inner = Inner;
  std::vector<int> xmin, xmax;
  std::vector<int64_t> kk;
  const int ksize = pil_coeffs(n, on, xmin, xmax, kk);
  std::vector<int32_t> k32(kk.begin(), kk.end());  // |kk| < 2^23
  std::vector<int64_t> accv(inner);
  int64_t* __restrict__ acc = accv.data();
  for (int o = 0; o < outer; ++o) {
    const uint8_t* s = src + size_t(o) * n * inner;
    uint8_t* r = dst + size_t(o) * on * inner;
    for (int d = 0; d < on; ++d) {
      const int32_t* k = &k32[size_t(d) * ksize];
      const int taps = std::min(xmax[d], ksize);
      for (int q = 0; q < inner; ++q) acc[q] = int64_t(1) << (kPilBits - 1);
      for (int j = 0; j < taps; ++j) {
        const uint8_t* __restrict__ t =
            s + size_t(std::min(xmin[d] + j, n - 1)) * inner;
        const int64_t kj = k[j];
        for (int q = 0; q < inner; ++q) acc[q] += int64_t(int32_t(t[q])) * kj;
      }
      for (int q = 0; q < inner; ++q) {
        int64_t v = acc[q] >> kPilBits;
        r[size_t(d) * inner + q] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }
}

// The horizontal pass of (h, w, ch) to (h, ow, ch).
void pil_rows(const uint8_t* src, uint8_t* dst, int h, int w, int ch,
              int ow) {
  switch (ch) {
    case 1: pil_pass<1>(src, dst, h, w, 1, ow); break;
    case 2: pil_pass<2>(src, dst, h, w, 2, ow); break;
    case 3: pil_pass<3>(src, dst, h, w, 3, ow); break;
    case 4: pil_pass<4>(src, dst, h, w, 4, ow); break;
    default: pil_pass<0>(src, dst, h, w, ch, ow);
  }
}

// Pillow's nearest source index: the position accumulated in double,
// step after step, from step / 2.
void pil_nearest_index(int in, int out, std::vector<int>& idx) {
  const double step = double(in) / double(out);
  idx.resize(out);
  double pos = step * 0.5;
  for (int d = 0; d < out; ++d) {
    if (d) pos = pos + step;
    int64_t i = int64_t(pos);
    idx[d] = int(std::min<int64_t>(std::max<int64_t>(i, 0), in - 1));
  }
}

// Four doubles, added and multiplied lane by lane (GCC's vector extension).
typedef double V4 __attribute__((vector_size(32)));

V4 load4(const double* p) {
  V4 v;
  std::memcpy(&v, p, sizeof v);
  return v;
}

// np.pad(mode="reflect") along an axis of n: reflection without repeating
// the edge, repeated where the pad is longer than the axis; a singleton
// axis repeats its one value.
int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

}  // namespace

extern "C" {

// Every hi_* entry point returns kNoMemory where an allocation failed: no
// exception may leave the C interface (it would abort the calling process).
enum { kNoMemory = 99 };

// Return codes of hi_png_rgb.
enum { kPngShort = 1, kPngFilter = 2, kPngPalette = 3, kPngArgs = 4 };

// The inflated IDAT stream `raw` (n bytes) of a PNG of `height` x `width`,
// bit depth `depth`, colour type `color` and interlace method `interlace`
// (0 none, 1 Adam7), as (height, width, 3) uint8 RGB into `out`: each pass
// (one, or Adam7's seven; a pass with no columns or no rows has no bytes)
// unfiltered on its own rows from a zero prior row, samples of 1, 2 or 4
// bits unpacked (grey scaled to 8 bits), 16-bit samples cut to 8 (the high
// byte, or, with `saturate16`, the sample clamped to 255), palette entries
// looked up, grey repeated over three channels and alpha dropped. Returns
// 0; kPngShort when `raw` holds fewer bytes than the passes' rows; kPngFilter
// with detail = {pass, row, filter type} at the first row of an unknown
// filter; kPngPalette with detail[0] = the largest index when an index
// reaches past the palette's `palette_n` entries; kPngArgs for a colour
// type, depth or interlace method the decoder does not take.
int hi_png_rgb(const uint8_t* raw, size_t n, int height, int width,
               int depth, int color, const uint8_t* palette, int palette_n,
               int interlace, int saturate16, uint8_t* out, int* detail) try {
  int ch;
  switch (color) {
    case 0: case 3: ch = 1; break;
    case 2: ch = 3; break;
    case 4: ch = 2; break;
    case 6: ch = 4; break;
    default: return kPngArgs;
  }
  if (!(depth == 8 || (depth == 16 && color != 3) ||
        ((color == 0 || color == 3) &&
         (depth == 1 || depth == 2 || depth == 4))))
    return kPngArgs;
  if (height < 0 || width < 0 || (interlace != 0 && interlace != 1))
    return kPngArgs;
  // (x0, y0, dx, dy) of each pass
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                   {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                   {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = interlace ? kAdam7 : kWhole;
  const int npass = interlace ? 7 : 1;
  auto pass_size = [&](int p, int& pw, int& ph) {
    pw = (width - passes[p][0] + passes[p][2] - 1) / passes[p][2];
    ph = (height - passes[p][1] + passes[p][3] - 1) / passes[p][3];
    if (pw <= 0 || ph <= 0) pw = ph = 0;
  };
  size_t need = 0;
  for (int p = 0; p < npass; ++p) {
    int pw, ph;
    pass_size(p, pw, ph);
    if (ph) need += size_t(ph) * ((size_t(pw) * ch * depth + 7) / 8 + 1);
  }
  if (n < need) return kPngShort;
  const int bpp = std::max(1, ch * depth / 8);
  const int scale = color == 0 && depth < 8 ? 255 / ((1 << depth) - 1) : 1;
  const int mask = (1 << std::min(depth, 8)) - 1;
  // a big-endian 16-bit sample cut to 8 bits
  auto sample16 = [&](const uint8_t* s) -> uint8_t {
    return saturate16 ? uint8_t(std::min((s[0] << 8) | s[1], 255)) : s[0];
  };
  std::vector<uint8_t> rows;
  int top = -1;
  const uint8_t* line = raw;
  for (int p = 0; p < npass; ++p) {
    int pw, ph;
    pass_size(p, pw, ph);
    if (!ph) continue;
    const size_t stride = (size_t(pw) * ch * depth + 7) / 8;
    rows.assign(2 * stride + 1, 0);
    uint8_t* prior = rows.data();
    uint8_t* cur = rows.data() + stride;
    const int x0 = passes[p][0], y0 = passes[p][1];
    const int dx = passes[p][2], dy = passes[p][3];
    for (int y = 0; y < ph; ++y, line += stride + 1) {
      if (!unfilter_row(line[0], line + 1, prior, cur, stride, bpp)) {
        detail[0] = p;
        detail[1] = y;
        detail[2] = line[0];
        return kPngFilter;
      }
      uint8_t* o = out + (size_t(y0 + y * dy) * width + x0) * 3;
      const size_t step = size_t(dx) * 3;
      if (depth < 8 || color == 3) {
        for (int x = 0; x < pw; ++x, o += step) {
          int v;
          if (depth == 8) {
            v = cur[x];
          } else {
            const int bit = x * depth;
            v = (cur[bit >> 3] >> (8 - depth - (bit & 7))) & mask;
          }
          if (color == 3) {
            top = std::max(top, v);
            const uint8_t* e = v < palette_n ? palette + 3 * v : nullptr;
            o[0] = e ? e[0] : 0;
            o[1] = e ? e[1] : 0;
            o[2] = e ? e[2] : 0;
          } else {
            o[0] = o[1] = o[2] = uint8_t(v * scale);
          }
        }
      } else if (depth == 8) {
        if (ch <= 2) {
          for (int x = 0; x < pw; ++x, o += step)
            o[0] = o[1] = o[2] = cur[size_t(x) * ch];
        } else if (ch == 3 && dx == 1) {
          std::memcpy(o, cur, size_t(pw) * 3);
        } else {
          for (int x = 0; x < pw; ++x, o += step) {
            const uint8_t* s = cur + size_t(x) * ch;
            o[0] = s[0];
            o[1] = s[1];
            o[2] = s[2];
          }
        }
      } else if (ch <= 2) {
        for (int x = 0; x < pw; ++x, o += step)
          o[0] = o[1] = o[2] = sample16(cur + 2 * size_t(x) * ch);
      } else {
        for (int x = 0; x < pw; ++x, o += step) {
          const uint8_t* s = cur + 2 * size_t(x) * ch;
          o[0] = sample16(s);
          o[1] = sample16(s + 2);
          o[2] = sample16(s + 4);
        }
      }
      std::swap(prior, cur);
    }
  }
  if (color == 3 && top >= palette_n) {
    detail[0] = top;
    return kPngPalette;
  }
  return 0;
} catch (...) {
  return kNoMemory;
}

// Return codes of hi_bmp_rgb.
enum { kBmpShort = 1, kBmpRleShort = 2, kBmpRleDelta = 3, kBmpArgs = 4 };
// Its pixel layouts: palette indices of `bits` bits; PIL's "1" and "L" raw
// modes, which it reads a file of a grey palette with whatever its bit
// count (1 bit a pixel to 0 / 255, a byte a pixel as grey); 16-bit 5-5-5 and
// 5-6-5 (each field times 255 over its maximum, rounded down); 24 or 32 bits
// with the red, green and blue bytes at given places in the pixel.
enum { kBmpIndex = 0, kBmpBit = 1, kBmpByte = 2, kBmp555 = 3, kBmp565 = 4,
       kBmpBytes = 5 };

// The pixel data of a BMP file (all `n` bytes of it, pixels from `offset`)
// of `width` x `height` as (height, width, 3) uint8 RGB into `out`, as PIL
// 12.1 decodes it (BmpImagePlugin.py): rows of ((width * bits + 31) >> 3) &
// ~3 bytes, bottom-up unless `topdown`; or, with `rle` 1 (RLE8) or 2 (RLE4),
// PIL's BmpRleDecoder: runs clipped at the row's end, end-of-line escapes
// that pad the row with index 0, a delta escape that reads four bytes and
// moves by its last two, absolute runs (RLE4: byte_count = count / 2 bytes)
// realigned to an even position in the file, the image read from the
// indices as raw rows. Indices past the palette's `palette_n` RGB entries
// read black. Returns 0; kBmpShort with detail = {bytes there, bytes
// wanted} when the rows run past the file; kBmpRleShort with detail =
// {pixels, pixels wanted} when RLE data stops before the image is full;
// kBmpRleDelta when the file ends inside a delta escape; kBmpArgs for a
// layout the decoder does not take.
int hi_bmp_rgb(const uint8_t* data, size_t n, size_t offset, int width,
               int height, int topdown, int layout, int bits, int rpos,
               int gpos, int bpos, const uint8_t* palette, int palette_n,
               int rle, uint8_t* out, int* detail) try {
  if (width <= 0 || height <= 0 || layout < 0 || layout > kBmpBytes)
    return kBmpArgs;
  const size_t w = size_t(width), h = size_t(height);
  auto put_index = [&](uint8_t* o, int v) {
    if (layout == kBmpByte) {
      o[0] = o[1] = o[2] = uint8_t(v);
      return;
    }
    const uint8_t* e = v < palette_n ? palette + 3 * v : nullptr;
    o[0] = e ? e[0] : 0;
    o[1] = e ? e[1] : 0;
    o[2] = e ? e[2] : 0;
  };
  auto row_of = [&](size_t r) { return topdown ? r : h - 1 - r; };
  if (rle) {
    if (layout != kBmpIndex && layout != kBmpByte) return kBmpArgs;
    const size_t dest = w * h;
    std::vector<uint8_t> px;
    px.reserve(dest);
    size_t pos = offset, x = 0;
    while (px.size() < dest) {
      if (pos + 2 > n) break;
      size_t count = data[pos];
      const int byte = data[pos + 1];
      pos += 2;
      if (count) {
        if (x + count > w) count = x < w ? w - x : 0;
        for (size_t i = 0; i < count; ++i)
          px.push_back(uint8_t(rle == 2 ? (i % 2 ? byte & 15 : byte >> 4)
                                        : byte));
        x += count;
      } else if (byte == 0) {
        while (px.size() % w) px.push_back(0);
        x = 0;
      } else if (byte == 1) {
        break;
      } else if (byte == 2) {
        if (pos + 2 > n) break;
        pos += 2;
        if (pos + 2 > n) return kBmpRleDelta;
        // the loop ends at dest and the indices are cut there, so growth
        // past dest changes nothing: clamped, as a file's delta can ask for
        // up to 255 rows of the widest image
        px.resize(std::min(px.size() + data[pos] + size_t(data[pos + 1]) * w,
                           dest), 0);
        pos += 2;
        x = px.size() % w;
      } else {
        const size_t want = rle == 2 ? size_t(byte) / 2 : size_t(byte);
        const size_t got = pos < n ? std::min(want, n - pos) : 0;
        for (size_t i = 0; i < got; ++i) {
          const int b = data[pos + i];
          if (rle == 2) {
            px.push_back(uint8_t(b >> 4));
            px.push_back(uint8_t(b & 15));
          } else {
            px.push_back(uint8_t(b));
          }
        }
        pos += got;
        if (got < want) break;
        x += size_t(byte);
        if (pos % 2) ++pos;
      }
    }
    if (px.size() < dest) {
      detail[0] = int(std::min(px.size(), size_t(1) << 30));
      detail[1] = int(std::min(dest, size_t(1) << 30));
      return kBmpRleShort;
    }
    for (size_t r = 0; r < h; ++r) {
      uint8_t* o = out + row_of(r) * w * 3;
      for (size_t c = 0; c < w; ++c) put_index(o + 3 * c, px[r * w + c]);
    }
    return 0;
  }
  const size_t stride = ((w * size_t(bits) + 31) >> 3) & ~size_t(3);
  size_t row_bytes;
  switch (layout) {
    case kBmpIndex: row_bytes = (w * size_t(bits) + 7) / 8; break;
    case kBmpBit: row_bytes = (w + 7) / 8; break;
    case kBmpByte: row_bytes = w; break;
    case kBmp555: case kBmp565: row_bytes = 2 * w; break;
    default: row_bytes = w * size_t(bits / 8);
  }
  if (row_bytes > stride) return kBmpArgs;
  const size_t wanted = (h - 1) * stride + row_bytes;
  const size_t there = offset < n ? n - offset : 0;
  if (there < wanted) {
    detail[0] = int(std::min(there, size_t(1) << 30));
    detail[1] = int(std::min(wanted, size_t(1) << 30));
    return kBmpShort;
  }
  const int bpp = bits / 8;
  for (size_t r = 0; r < h; ++r) {
    const uint8_t* row = data + offset + r * stride;
    uint8_t* o = out + row_of(r) * w * 3;
    for (size_t c = 0; c < w; ++c, o += 3) {
      switch (layout) {
        case kBmpIndex: {
          const size_t bit = c * size_t(bits);
          const int v = bits == 8 ? row[c]
                                  : (row[bit >> 3] >> (8 - bits - (bit & 7))) &
                                        ((1 << bits) - 1);
          put_index(o, v);
          break;
        }
        case kBmpBit:
          o[0] = o[1] = o[2] = (row[c >> 3] >> (7 - (c & 7))) & 1 ? 255 : 0;
          break;
        case kBmpByte:
          o[0] = o[1] = o[2] = row[c];
          break;
        case kBmp555:
        case kBmp565: {
          const int v = row[2 * c] | (row[2 * c + 1] << 8);
          const bool six = layout == kBmp565;
          const int g = six ? (v >> 5) & 63 : (v >> 5) & 31;
          o[0] = uint8_t(((six ? v >> 11 : v >> 10) & 31) * 255 / 31);
          o[1] = uint8_t(g * 255 / (six ? 63 : 31));
          o[2] = uint8_t((v & 31) * 255 / 31);
          break;
        }
        default: {
          const uint8_t* q = row + c * size_t(bpp);
          o[0] = q[rpos];
          o[1] = q[gpos];
          o[2] = q[bpos];
        }
      }
    }
  }
  return 0;
} catch (...) {
  return kNoMemory;
}

// cv2.resize(INTER_CUBIC (mode 0) / INTER_LINEAR (mode 1)) of a float32
// (h, w, ch) image to (oh, ow, ch): the horizontal pass summing the taps in
// order; the vertical pass, for cubic, over the first floor(ow * ch / 4) * 4
// values of each output row from the last tap, b0*S0 + (b1*S1 + (b2*S2 +
// b3*S3)), as cv2's 4-lane vector loop, and over the rest in order; for
// linear, in order.
int hi_resize_cv2_f32(const float* src, float* dst, int h, int w, int ch,
                      int oh, int ow, int mode) try {
  if (mode != 0 && mode != 1) return 1;
  const bool cubic = mode == 0;
  const int k = cubic ? 4 : 2;
  std::vector<int> tx, ty;
  std::vector<float> cx, cy;
  cv2_taps(w, ow, cubic, tx, cx);
  cv2_taps(h, oh, cubic, ty, cy);
  const int row = ow * ch;
  std::vector<float> rows(size_t(h) * row);
  cv2_rows_f32(src, rows.data(), h, w, ch, ow, k, tx, cx);
  const int cut = cubic ? row / 4 * 4 : 0;
  for (int yo = 0; yo < oh; ++yo) {
    const int* t = &ty[size_t(yo) * k];
    const float* c = &cy[size_t(yo) * k];
    const float* s[4];
    for (int j = 0; j < k; ++j) s[j] = rows.data() + size_t(t[j]) * row;
    float* o = dst + size_t(yo) * row;
    for (int x = 0; x < cut; ++x)
      o[x] = s[0][x] * c[0] + (s[1][x] * c[1] + (s[2][x] * c[2] +
                                                  s[3][x] * c[3]));
    for (int x = cut; x < row; ++x) {
      float acc = s[0][x] * c[0];
      for (int j = 1; j < k; ++j) acc = acc + s[j][x] * c[j];
      o[x] = acc;
    }
  }
  return 0;
} catch (...) {
  return kNoMemory;
}

// cv2.resize(INTER_CUBIC) of a uint8 (h, w, ch) image: the coefficients
// rounded half to even at 11 bits, the horizontal pass in integers, the
// vertical pass in float32 from the last tap, rounded half to even and
// saturated, as cv2's vector code computes it.
int hi_resize_cv2_u8_cubic(const uint8_t* src, uint8_t* dst, int h, int w,
                           int ch, int oh, int ow) try {
  const float one = float(1 << 11);
  std::vector<int> tx, ty;
  std::vector<float> cx, cy;
  cv2_taps(w, ow, true, tx, cx);
  cv2_taps(h, oh, true, ty, cy);
  std::vector<int> ix(cx.size());
  for (size_t i = 0; i < cx.size(); ++i) ix[i] = int(std::rint(cx[i] * one));
  std::vector<float> beta(cy.size());
  const float unit = float(1.0 / (double(one) * double(one)));
  for (size_t i = 0; i < cy.size(); ++i)
    beta[i] = std::rint(cy[i] * one) * unit;
  const int row = ow * ch;
  std::vector<int32_t> rows(size_t(h) * row);
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src + size_t(y) * w * ch;
    int32_t* r = rows.data() + size_t(y) * row;
    for (int xo = 0; xo < ow; ++xo) {
      const int* t = &tx[size_t(xo) * 4];
      const int* c = &ix[size_t(xo) * 4];
      for (int q = 0; q < ch; ++q)
        r[xo * ch + q] = s[t[0] * ch + q] * c[0] + s[t[1] * ch + q] * c[1] +
                         s[t[2] * ch + q] * c[2] + s[t[3] * ch + q] * c[3];
    }
  }
  for (int yo = 0; yo < oh; ++yo) {
    const int* t = &ty[size_t(yo) * 4];
    const float* b = &beta[size_t(yo) * 4];
    const int32_t* s[4];
    for (int j = 0; j < 4; ++j) s[j] = rows.data() + size_t(t[j]) * row;
    uint8_t* o = dst + size_t(yo) * row;
    for (int x = 0; x < row; ++x) {
      float acc = float(s[3][x]) * b[3];
      acc = float(s[2][x]) * b[2] + acc;
      acc = float(s[1][x]) * b[1] + acc;
      acc = float(s[0][x]) * b[0] + acc;
      float v = std::rint(acc);
      o[x] = uint8_t(v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v));
    }
  }
  return 0;
} catch (...) {
  return kNoMemory;
}

// Image.resize(BICUBIC (mode 0) / NEAREST (mode 1)) of a uint8 (h, w, ch)
// image to (oh, ow, ch). Bicubic: a horizontal pass, then a vertical one,
// each skipped where its size does not change.
int hi_resize_pil(const uint8_t* src, uint8_t* dst, int h, int w, int ch,
                  int oh, int ow, int mode) try {
  if (mode == 1) {
    std::vector<int> iy, ix;
    pil_nearest_index(h, oh, iy);
    pil_nearest_index(w, ow, ix);
    for (int y = 0; y < oh; ++y) {
      const uint8_t* s = src + size_t(iy[y]) * w * ch;
      uint8_t* o = dst + size_t(y) * ow * ch;
      for (int x = 0; x < ow; ++x)
        std::memcpy(o + size_t(x) * ch, s + size_t(ix[x]) * ch, ch);
    }
    return 0;
  }
  if (mode != 0) return 1;
  if (ow != w && oh != h) {
    std::vector<uint8_t> tmp(size_t(h) * ow * ch);
    pil_rows(src, tmp.data(), h, w, ch, ow);
    pil_pass<0>(tmp.data(), dst, 1, h, ow * ch, oh);
  } else if (ow != w) {
    pil_rows(src, dst, h, w, ch, ow);
  } else if (oh != h) {
    pil_pass<0>(src, dst, 1, h, w * ch, oh);
  } else {
    std::memcpy(dst, src, size_t(h) * w * ch);
  }
  return 0;
} catch (...) {
  return kNoMemory;
}

// cv2.filter2D(img, -1, kernel) of a float32 (h, w, ch) image with a
// (kh, kw) kernel given in double: correlation, the anchor at (kh / 2, kw / 2),
// borders as np.pad(mode="reflect") gives them (BORDER_REFLECT_101); each
// value summed in double over (i, j) in row-major order from 0.0, then
// rounded to float32.
int hi_filter2d(const float* src, float* dst, int h, int w, int ch,
                const double* kernel, int kh, int kw) try {
  const int ay = kh / 2, ax = kw / 2;
  const int hp = h + kh - 1, wp = w + kw - 1;
  const size_t prow = size_t(wp) * ch;
  std::vector<double> pad(size_t(hp) * prow);
  std::vector<int> col(wp);
  for (int x = 0; x < wp; ++x) col[x] = reflect101(x - ax, w);
  for (int y = 0; y < hp; ++y) {
    const float* s = src + size_t(reflect101(y - ay, h)) * w * ch;
    double* p = pad.data() + size_t(y) * prow;
    for (int x = 0; x < wp; ++x)
      for (int q = 0; q < ch; ++q)
        p[size_t(x) * ch + q] = double(s[size_t(col[x]) * ch + q]);
  }
  // The row in blocks of kBlock values whose sums stay in registers (as
  // vectors of 4 doubles) over the whole kernel; each value still sums over
  // (i, j) in row-major order, lanes apart, and the tail sums one by one.
  constexpr int kVecs = 8, kBlock = 4 * kVecs;
  const size_t row = size_t(w) * ch;
  for (int y = 0; y < h; ++y) {
    float* o = dst + size_t(y) * row;
    size_t x0 = 0;
    for (; x0 + kBlock <= row; x0 += kBlock) {
      V4 acc[kVecs];
#pragma GCC unroll 8
      for (int t = 0; t < kVecs; ++t) acc[t] = V4{0.0, 0.0, 0.0, 0.0};
      for (int i = 0; i < kh; ++i) {
        const double* srow = pad.data() + size_t(y + i) * prow + x0;
        for (int j = 0; j < kw; ++j) {
          const double kv = kernel[i * kw + j];
          const V4 k4 = V4{kv, kv, kv, kv};
          const double* s = srow + size_t(j) * ch;
#pragma GCC unroll 8
          for (int t = 0; t < kVecs; ++t) acc[t] = acc[t] + k4 * load4(s + 4 * t);
        }
      }
#pragma GCC unroll 8
      for (int t = 0; t < kVecs; ++t)
        for (int l = 0; l < 4; ++l) o[x0 + 4 * t + l] = float(acc[t][l]);
    }
    for (; x0 < row; ++x0) {
      double acc = 0.0;
      for (int i = 0; i < kh; ++i) {
        const double* s = pad.data() + size_t(y + i) * prow + x0;
        for (int j = 0; j < kw; ++j) acc = acc + kernel[i * kw + j] * s[size_t(j) * ch];
      }
      o[x0] = float(acc);
    }
  }
  return 0;
} catch (...) {
  return kNoMemory;
}

}  // extern "C"
