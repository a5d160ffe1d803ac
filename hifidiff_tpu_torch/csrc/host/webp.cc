// The port's WebP decoder: the lossless (VP8L, RFC 9649) and lossy (VP8,
// RFC 6386) bitstreams of a WebP file's image chunk, computing what libwebp
// 1.6 computes on x86-64 (its C code, and its SSE2 IDCT where that build
// runs it), bit for bit. data/webp.py parses the RIFF container and each
// bitstream's first bytes, then makes one call here; ctypes releases the
// GIL for it. Host code with a plain C interface, integers only.
//
// VP8L: the transforms (predictor with modes 0-13, and 14-15
// read as mode 0 as libwebp reads them; cross-colour; subtract-green;
// colour-indexing with pixel bundling), canonical Huffman codes (simple and
// normal, the code-length code, one-symbol codes that read no bits), meta
// Huffman codes, LZ77 with the 120-entry distance map, the colour cache.
// A stream that reads past its last bit is refused.
//
// VP8 (and hw_vp8_coefficients): libwebp's boolean decoder (56-bit
// window, the same end-of-data rule), the frame header, segments, the
// quantizers, the token probabilities, intra modes, coefficient tokens,
// the WHT and the IDCT (libwebp's choice per block: its SSE2 IDCT, which
// x86-64 builds run, past 3 coefficients and on a chroma plane with a block
// past 1, else its C code; they differ only far outside what an encoder
// writes, where 16-bit lanes wrap), prediction from unfiltered
// neighbours, the simple and normal loop filters in macroblock raster order
// on the whole reconstructed frame, then libwebp's fancy upsampler and its
// 14-bit fixed-point YUV -> RGB.
//
// ALPH (hw_alpha; alpha_dec.c): the header byte (compression, filter,
// pre-processing, reserved bits, refused as ALPHInit refuses them); raw
// data or a headerless VP8L stream of the frame's size whose green channel
// is the alpha (decoded as DecodeAlphaData decodes it where libwebp takes
// that path: a stream whose only transform is colour indexing, no colour
// cache and one-symbol red, blue and alpha codes may end within its last
// symbol); the horizontal, vertical and gradient unfilters of
// dsp/filters.c. No dequantize smoothing: neither WebPDecode nor
// WebPAnimDecoder asks for alpha dithering. The alpha never changes the
// RGB; a stream libwebp refuses makes the frame's decode fail.
//
// The first frame (hw_webp_rgb; anim_decode.c): drawn at its offset on a
// zero canvas, the key frame's pixels as they are (libwebp blends no key
// frame, whatever its blend bit), alpha dropped.
//
// The constant tables are libwebp's (RFC 6386's, with libwebp's order of the
// 4x4 intra modes: DC TM VE HE RD VR LD VL HD HU).
//
// Each function takes its output buffers from the caller and returns 0, a
// code naming the refusal (data/webp.py words it), or kNoMemory.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kNoMemory = 99;  // host.NO_MEMORY

struct Refusal {
  int code, a, b;
};

[[noreturn]] void refuse(int code, int a = 0, int b = 0) {
  throw Refusal{code, a, b};
}

// refusal codes (data/webp.py's _MESSAGES)
enum {
  kLosslessEnds = 1,
  kBadHuffman = 2,
  kTransformTwice = 3,
  kCacheBits = 4,
  kBadCopy = 5,
  kPart0Length = 11,
  kSegmentHeader = 12,
  kFilterHeader = 13,
  kPartitions = 14,
  kModesEnd = 15,
  kTokensEnd = 16,
  kAlpha = 20,        // + a lossless code: the same refusal in the ALPH data
  kAlphaEmpty = 26,
  kAlphaHeader = 27,
  kAlphaRaw = 28,
};

// ----------------------------------------------------------------- VP8L

// LSB-first bits of `len` bytes, zeros past them, ended once more bits were
// read than it holds. (libwebp's reader reads zeros up to the 64th bit of a
// stream under 8 bytes; no such stream decodes: its fifth prefix code
// starts past bit 58.)
class LosslessBits {
 public:
  LosslessBits(const uint8_t* p, size_t len)
      : p_(p), len_(len), limit_(uint64_t(len) * 8) {}

  uint32_t peek(int n) const {  // n <= 32
    const uint64_t byte = pos_ >> 3;
    uint64_t w = 0;
    if (byte + 8 <= len_) {
      for (int i = 7; i >= 0; --i) w = (w << 8) | p_[byte + i];
    } else {
      for (uint64_t i = 0; i < 8 && byte + i < len_; ++i)
        w |= uint64_t(p_[byte + i]) << (8 * i);
    }
    return uint32_t((w >> (pos_ & 7)) & ((uint64_t(1) << n) - 1));
  }
  uint32_t read(int n) {
    const uint32_t v = peek(n);
    pos_ += n;
    return v;
  }
  void skip(int n) { pos_ += n; }
  bool ended() const { return pos_ > limit_; }

 private:
  const uint8_t* p_;
  uint64_t len_, limit_, pos_ = 0;
};

// A canonical prefix code: codes by (length, symbol), the first bit read is
// the code's most significant. One coded symbol reads no bits.
struct Huffman {
  int single = -1;
  int count[16] = {0}, first[16] = {0}, offset[16] = {0};
  std::vector<uint16_t> sorted;
  uint16_t root[256] = {0};  // symbol | length << 12 for codes of <= 8 bits
};

// libwebp's BuildHuffmanTable's test: at least one coded symbol, and either
// exactly one or a complete code (no length over-subscribed).
bool build_huffman(Huffman& h, const int* lengths, int n) {
  int count[16] = {0};
  for (int s = 0; s < n; ++s) ++count[lengths[s]];
  if (count[0] == n) return false;
  for (int len = 1; len < 15; ++len)
    if (count[len] > (1 << len)) return false;
  h = Huffman();
  if (n - count[0] == 1) {
    for (int s = 0; s < n; ++s)
      if (lengths[s]) h.single = s;
    return true;
  }
  int64_t open = 1;
  for (int len = 1; len <= 15; ++len) {
    open = 2 * open - count[len];
    if (open < 0) return false;
  }
  if (open != 0) return false;
  int code = 0, at = 0;
  for (int len = 1; len <= 15; ++len) {
    h.count[len] = count[len];
    h.first[len] = code;
    h.offset[len] = at;
    code = (code + count[len]) << 1;
    at += count[len];
  }
  h.sorted.resize(at);
  int fill[16];
  std::memcpy(fill, h.offset, sizeof(fill));
  for (int s = 0; s < n; ++s)
    if (lengths[s]) h.sorted[fill[lengths[s]]++] = uint16_t(s);
  for (int len = 1; len <= 8; ++len) {
    for (int i = 0; i < count[len]; ++i) {
      const int c = h.first[len] + i;
      int rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((c >> b) & 1) << (len - 1 - b);
      const uint16_t entry = uint16_t(h.sorted[h.offset[len] + i] | len << 12);
      for (int k = rev; k < 256; k += 1 << len) h.root[k] = entry;
    }
  }
  return true;
}

int read_symbol(const Huffman& h, LosslessBits& br) {
  if (h.single >= 0) return h.single;
  const uint32_t bits = br.peek(15);
  const uint16_t e = h.root[bits & 255];
  if (e) {
    br.skip(e >> 12);
    return e & 0xfff;
  }
  int code = 0;
  for (int len = 1; len <= 15; ++len) {
    code |= (bits >> (len - 1)) & 1;
    if (code - h.first[len] < h.count[len]) {
      br.skip(len);
      return h.sorted[h.offset[len] + code - h.first[len]];
    }
    code <<= 1;
  }
  return -1;  // a complete code always ends within 15 bits
}

const int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};

void read_code_lengths(LosslessBits& br, const int* cl_lengths, int n,
                       int* lengths) {
  Huffman cl;
  if (!build_huffman(cl, cl_lengths, 19)) refuse(kBadHuffman);
  int max_symbol = n;
  if (br.read(1)) {
    const int nbits = 2 + 2 * int(br.read(3));
    max_symbol = 2 + int(br.read(nbits));
    if (max_symbol > n) refuse(kBadHuffman);
  }
  int symbol = 0, prev = 8;
  while (symbol < n) {
    if (max_symbol-- == 0) break;
    const int code = read_symbol(cl, br);
    if (code < 16) {
      lengths[symbol++] = code;
      if (code) prev = code;
    } else {
      static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
      int repeat = int(br.read(kExtra[code - 16])) + kOffset[code - 16];
      if (symbol + repeat > n) refuse(kBadHuffman);
      const int v = code == 16 ? prev : 0;
      while (repeat-- > 0) lengths[symbol++] = v;
    }
  }
}

void read_huffman_code(LosslessBits& br, int n, Huffman& h,
                       std::vector<int>& lengths) {
  lengths.assign(n, 0);
  if (br.read(1)) {  // simple: one or two symbols of length 1
    const int num = int(br.read(1)) + 1;
    int s = int(br.read(br.read(1) ? 8 : 1));
    if (s < n) lengths[s] = 1;
    if (num == 2) {
      s = int(br.read(8));
      if (s < n) lengths[s] = 1;
    }
  } else {
    int cl[19] = {0};
    const int num = int(br.read(4)) + 4;
    for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = int(br.read(3));
    read_code_lengths(br, cl, n, lengths.data());
  }
  if (br.ended()) refuse(kLosslessEnds);
  if (!build_huffman(h, lengths.data(), n)) refuse(kBadHuffman);
}

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Group {
  Huffman h[5];  // green (+ lengths + cache), red, blue, alpha, distance
};

struct Codes {
  int bits = 0, xsize = 0, cache_bits = 0;
  // whether every group libwebp builds has one-symbol red, blue and alpha
  // codes (Is8bOptimizable's test, past the colour cache's)
  bool single_rba = true;
  std::vector<uint32_t> image;  // the group of each tile
  std::vector<Group> groups;
  std::vector<int> slot;        // group -> index in groups, -1 unused
};

void decode_stream(LosslessBits& br, int xsize, int ysize, bool level0,
                   std::vector<uint32_t>& out, struct Transforms* t,
                   bool alpha = false);

void read_codes(LosslessBits& br, int xsize, int ysize, bool level0,
                Codes& c) {
  int num_groups = 1;
  if (level0 && br.read(1)) {
    c.bits = int(br.read(3)) + 2;
    c.xsize = subsample(xsize, c.bits);
    decode_stream(br, c.xsize, subsample(ysize, c.bits), false, c.image,
                  nullptr);
    for (uint32_t& v : c.image) {
      v = (v >> 8) & 0xffff;
      num_groups = std::max(num_groups, int(v) + 1);
    }
  }
  c.slot.assign(num_groups, -1);
  if (c.image.empty()) {
    c.slot[0] = 0;
  } else {
    for (uint32_t v : c.image) c.slot[v] = 0;
  }
  int used = 0;
  for (int& s : c.slot)
    if (s == 0) s = used++;
  c.groups.resize(used);
  Group scratch;
  std::vector<int> lengths;
  const int alphabet[5] = {
      256 + 24 + (c.cache_bits ? 1 << c.cache_bits : 0), 256, 256, 256, 40};
  // libwebp keeps the unused groups too unless there are more than 1000,
  // or more than pixels, when it maps the used ones to a dense range
  const bool all_kept = num_groups <= 1000 &&
                        int64_t(num_groups) <= int64_t(xsize) * ysize;
  for (int g = 0; g < num_groups; ++g) {
    Group& dst = c.slot[g] >= 0 ? c.groups[c.slot[g]] : scratch;
    for (int j = 0; j < 5; ++j)
      read_huffman_code(br, alphabet[j], dst.h[j], lengths);
    if (c.slot[g] >= 0 || all_kept)
      for (int j = 1; j < 4; ++j) c.single_rba &= dst.h[j].single >= 0;
  }
}

const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

int plane_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int dist_code = kCodeToPlane[code - 1];
  const int dist = (dist_code >> 4) * xsize + (8 - (dist_code & 0xf));
  return dist >= 1 ? dist : 1;
}

int copy_value(int symbol, LosslessBits& br) {  // a length or a distance
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + int(br.read(extra)) + 1;
}

// The entropy-coded image: literals, backward references, cache hits. With
// `lenient` (DecodeAlphaData's reading) the end of the stream is looked at
// only after each symbol or copy, and a stream that ends within the last
// one is read.
void decode_pixels(LosslessBits& br, const Codes& c, int w, int h,
                   std::vector<uint32_t>& px, bool lenient) {
  const size_t n = size_t(w) * size_t(h);
  px.assign(n, 0);
  std::vector<uint32_t> cache(c.cache_bits ? size_t(1) << c.cache_bits : 0);
  const int shift = 32 - c.cache_bits;
  size_t i = 0, cached = 0;
  int x = 0, y = 0;
  auto insert = [&](size_t upto) {
    for (; cached < upto; ++cached)
      cache[(0x1e35a7bdu * px[cached]) >> shift] = px[cached];
  };
  while (i < n && !(lenient && br.ended())) {
    const Group& g = c.groups[c.slot[c.image.empty() ? 0 : c.image[
        size_t(y >> c.bits) * c.xsize + (x >> c.bits)]]];
    const int code = read_symbol(g.h[0], br);
    if (br.ended() && !lenient) break;
    if (code < 256) {
      const int red = read_symbol(g.h[1], br);
      const int blue = read_symbol(g.h[2], br);
      const int alpha = read_symbol(g.h[3], br);
      if (br.ended() && !lenient) break;
      px[i++] = uint32_t(alpha) << 24 | uint32_t(red) << 16 |
                uint32_t(code) << 8 | uint32_t(blue);
      if (++x == w) x = 0, ++y;
    } else if (code < 256 + 24) {
      const int length = copy_value(code - 256, br);
      const int dist_symbol = read_symbol(g.h[4], br);
      const int dist = plane_distance(w, copy_value(dist_symbol, br));
      if (br.ended() && !lenient) break;
      if (i < size_t(dist) || n - i < size_t(length)) refuse(kBadCopy);
      for (int k = 0; k < length; ++k, ++i) px[i] = px[i - dist];
      x += length;
      while (x >= w) x -= w, ++y;
    } else {
      if (c.cache_bits) insert(i);
      px[i++] = cache[code - 280];
      if (++x == w) x = 0, ++y;
    }
    if (c.cache_bits && x == 0) insert(i);
  }
  if (br.ended() && (i < n || !lenient)) refuse(kLosslessEnds);
}

struct Transform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};
struct Transforms {
  std::vector<Transform> list;
};

// `alpha`: the level-0 stream of an ALPH chunk, read as libwebp reads one
// (decode_pixels' `lenient` where DecodeAlphaData would run).
void decode_stream(LosslessBits& br, int xsize, int ysize, bool level0,
                   std::vector<uint32_t>& out, Transforms* t, bool alpha) {
  int txsize = xsize;
  if (level0) {
    unsigned seen = 0;
    while (br.read(1)) {
      const int type = int(br.read(2));
      if (seen & (1u << type)) refuse(kTransformTwice, type);
      seen |= 1u << type;
      Transform tr{type, 0, txsize, {}};
      if (type == 0 || type == 1) {
        tr.bits = int(br.read(3)) + 2;
        decode_stream(br, subsample(txsize, tr.bits),
                      subsample(ysize, tr.bits), false, tr.data, nullptr);
      } else if (type == 3) {
        const int colors = int(br.read(8)) + 1;
        tr.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
        txsize = subsample(tr.xsize, tr.bits);
        std::vector<uint32_t> pal;
        decode_stream(br, colors, 1, false, pal, nullptr);
        tr.data.assign(size_t(1) << (8 >> tr.bits), 0);
        tr.data[0] = pal[0];
        for (int k = 1; k < colors; ++k) {  // deltas, byte by byte
          uint32_t v = 0;
          for (int b = 0; b < 32; b += 8)
            v |= ((((pal[k] >> b) & 0xff) + ((tr.data[k - 1] >> b) & 0xff))
                  & 0xff) << b;
          tr.data[k] = v;
        }
      }
      t->list.push_back(std::move(tr));
    }
  }
  Codes c;
  if (br.read(1)) {
    c.cache_bits = int(br.read(4));
    if (c.cache_bits < 1 || c.cache_bits > 11) refuse(kCacheBits, c.cache_bits);
  }
  read_codes(br, txsize, ysize, level0, c);
  const bool lenient = alpha && t->list.size() == 1 &&
                       t->list[0].type == 3 && !c.cache_bits && c.single_rba;
  decode_pixels(br, c, txsize, ysize, out, lenient);
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {  // T, L, TL
  int d = 0;
  for (int s = 0; s < 32; s += 8) {
    const int ca = (a >> s) & 0xff, cb = (b >> s) & 0xff, cc = (c >> s) & 0xff;
    d += std::abs(cb - cc) - std::abs(ca - cc);
  }
  return d <= 0 ? a : b;
}
inline uint32_t add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t v = 0;
  for (int s = 0; s < 32; s += 8)
    v |= uint32_t(clip255(int((a >> s) & 0xff) + int((b >> s) & 0xff) -
                          int((c >> s) & 0xff))) << s;
  return v;
}
inline uint32_t add_sub_half(uint32_t a, uint32_t b) {  // a: average, b: TL
  uint32_t v = 0;
  for (int s = 0; s < 32; s += 8) {
    const int ca = (a >> s) & 0xff, cb = (b >> s) & 0xff;
    v |= uint32_t(clip255(ca + (ca - cb) / 2)) << s;
  }
  return v;
}

uint32_t predict(int mode, uint32_t L, const uint32_t* top) {
  switch (mode) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select(top[0], L, top[-1]);
    case 12: return add_sub_full(L, top[0], top[-1]);
    case 13: return add_sub_half(average2(L, top[0]), top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

void inverse_transform(const Transform& t, int h, std::vector<uint32_t>& px) {
  const int w = t.xsize;
  if (t.type == 0) {
    const int tiles = subsample(w, t.bits);
    px[0] = add_pixels(px[0], 0xff000000u);
    for (int x = 1; x < w; ++x) px[x] = add_pixels(px[x], px[x - 1]);
    for (int y = 1; y < h; ++y) {
      uint32_t* row = px.data() + size_t(y) * w;
      const uint32_t* top = row - w;
      const uint32_t* modes = t.data.data() + size_t(y >> t.bits) * tiles;
      row[0] = add_pixels(row[0], top[0]);
      for (int x = 1; x < w; ++x) {
        const int mode = (modes[x >> t.bits] >> 8) & 0xf;
        row[x] = add_pixels(row[x], predict(mode, row[x - 1], top + x));
      }
    }
  } else if (t.type == 1) {
    const int tiles = subsample(w, t.bits);
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        const uint32_t m = t.data[size_t(y >> t.bits) * tiles + (x >> t.bits)];
        const int8_t g2r = int8_t(m & 0xff), g2b = int8_t((m >> 8) & 0xff),
                     r2b = int8_t((m >> 16) & 0xff);
        uint32_t& p = px[size_t(y) * w + x];
        const int8_t green = int8_t(p >> 8);
        int red = (p >> 16) & 0xff, blue = p & 0xff;
        red = (red + ((int(g2r) * green) >> 5)) & 0xff;
        blue += (int(g2b) * green) >> 5;
        blue += (int(r2b) * int8_t(red)) >> 5;
        p = (p & 0xff00ff00u) | uint32_t(red) << 16 | uint32_t(blue & 0xff);
      }
    }
  } else if (t.type == 2) {
    for (uint32_t& p : px) {
      const uint32_t g = (p >> 8) & 0xff;
      p = (p & 0xff00ff00u) | ((((p >> 16) + g) & 0xff) << 16) |
          ((p + g) & 0xff);
    }
  } else {
    const int packed = subsample(w, t.bits);
    const int bpp = 8 >> t.bits, mask = (1 << bpp) - 1;
    std::vector<uint32_t> out(size_t(w) * h);
    for (int y = 0; y < h; ++y) {
      const uint32_t* src = px.data() + size_t(y) * packed;
      for (int x = 0; x < w; ++x) {
        const int idx = ((src[x >> t.bits] >> 8) >> (bpp * (x & ((1 << t.bits) - 1)))) & mask;
        out[size_t(y) * w + x] = t.data[idx];
      }
    }
    px.swap(out);
  }
}

void decode_lossless(const uint8_t* data, size_t len, int w, int h,
                     std::vector<uint32_t>& px) {
  LosslessBits br(data, len);
  br.skip(40);  // signature, size, alpha hint, version: data/webp.py's
  Transforms t;
  decode_stream(br, w, h, true, px, &t);
  for (size_t k = t.list.size(); k-- > 0;) inverse_transform(t.list[k], h, px);
}

// ----------------------------------------------------------------- ALPH

// dsp/filters.c's unfilters, row by row from the previous output row (none
// above the first: it takes the horizontal one from 0).
void unfilter_row(int filter, const uint8_t* prev, const uint8_t* in,
                  uint8_t* out, int w) {
  if (filter == 0) {
    std::memcpy(out, in, size_t(w));
  } else if (filter == 1 || prev == nullptr) {
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < w; ++i) out[i] = pred = uint8_t(pred + in[i]);
  } else if (filter == 2) {
    for (int i = 0; i < w; ++i) out[i] = uint8_t(prev[i] + in[i]);
  } else {
    uint8_t top_left = prev[0], left = prev[0];
    for (int i = 0; i < w; ++i) {
      const int g = left + prev[i] - top_left;
      left = uint8_t(in[i] + (g < 0 ? 0 : g > 255 ? 255 : g));
      top_left = prev[i];
      out[i] = left;
    }
  }
}

// An ALPH chunk's payload as w x h alpha.
void decode_alpha(const uint8_t* data, size_t len, int w, int h,
                  uint8_t* out) {
  if (len <= 1) refuse(kAlphaEmpty, int(len));
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  if (method > 1 || (data[0] >> 4) > 1) refuse(kAlphaHeader, data[0]);
  const size_t n = size_t(w) * h;
  std::vector<uint8_t> rows(n);
  if (method == 0) {
    if (len - 1 < n) refuse(kAlphaRaw, int(len - 1), int(n));
    std::memcpy(rows.data(), data + 1, n);
  } else {
    std::vector<uint32_t> px;
    try {
      LosslessBits br(data + 1, len - 1);
      Transforms t;
      decode_stream(br, w, h, true, px, &t, true);
      for (size_t k = t.list.size(); k-- > 0;)
        inverse_transform(t.list[k], h, px);
    } catch (const Refusal& r) {
      refuse(kAlpha + r.code, r.a, r.b);
    }
    for (size_t i = 0; i < n; ++i) rows[i] = uint8_t(px[i] >> 8);
  }
  for (int y = 0; y < h; ++y)
    unfilter_row(filter, y ? out + size_t(y - 1) * w : nullptr,
                 rows.data() + size_t(y) * w, out + size_t(y) * w, w);
}

// ------------------------------------------------------------------ VP8

// libwebp's VP8BitReader (BITS = 56): the same loads, so the same point at
// which a partition is found to end early.
class BoolReader {
 public:
  void init(const uint8_t* start, size_t size) {
    range_ = 255 - 1;
    value_ = 0;
    bits_ = -8;
    eof_ = false;
    buf_ = start;
    end_ = start + size;
    max_ = size >= 8 ? start + size - 8 + 1 : start;
    load();
  }
  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * uint32_t(prob)) >> 8;
    const uint32_t value = uint32_t(value_ >> pos);
    const int b = value > split;
    if (b) {
      range -= split;
      value_ -= uint64_t(split + 1) << pos;
    } else {
      range = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return b;
  }
  int sign(int v) {  // VP8GetSigned
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = range_ >> 1;
    const uint32_t value = uint32_t(value_ >> pos);
    const int32_t mask = int32_t(split - value) >> 31;
    bits_ -= 1;
    range_ += uint32_t(mask);
    range_ |= 1;
    value_ -= uint64_t((split + 1) & uint32_t(mask)) << pos;
    return (v ^ mask) - mask;
  }
  int value(int nbits) {
    int v = 0;
    while (nbits-- > 0) v |= bit(0x80) << nbits;
    return v;
  }
  int signed_value(int nbits) {
    const int v = value(nbits);
    return value(1) ? -v : v;
  }
  bool eof() const { return eof_; }

 private:
  void load() {
    if (buf_ < max_) {
      uint64_t bits = 0;
      for (int i = 0; i < 7; ++i) bits = (bits << 8) | buf_[i];
      buf_ += 7;
      value_ = bits | (value_ << 56);
      bits_ += 56;
    } else if (buf_ < end_) {
      bits_ += 8;
      value_ = uint64_t(*buf_++) | (value_ << 8);
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
  uint32_t range_ = 0;
  uint64_t value_ = 0;
  int bits_ = 0;
  bool eof_ = false;
  const uint8_t *buf_ = nullptr, *end_ = nullptr, *max_ = nullptr;
};

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// the intra modes, libwebp's numbering; 4-6 are DC without top / left / both
enum { DC = 0, TM, VE, HE, RD, VR, LD, VL, HD, HU, DC_NOTOP = 4, DC_NOLEFT,
       DC_NOTOPLEFT };

struct Header {
  int width, height, mb_w, mb_h;
  int filter_type, sharpness, level, use_lf_delta;
  int ref_delta0, mode_delta0;
  int use_segment, update_map, absolute, quant[4], fstrength[4];
  uint8_t seg_proba[3];
  int dq[4][3][2];  // segment, (y1, y2, uv), (dc, ac)
  uint8_t proba[4][8][3][11];
  int use_skip, skip_p, num_parts;
  BoolReader br;
  BoolReader parts[8];
};

int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

// VP8GetHeaders from the frame tag on (the tag, start code and size that
// data/webp.py checked are re-read, not re-checked).
void parse_header(const uint8_t* data, size_t size, Header& h) {
  const uint32_t tag = data[0] | data[1] << 8 | data[2] << 16;
  const size_t part0 = tag >> 5;
  h.width = (data[7] << 8 | data[6]) & 0x3fff;
  h.height = (data[9] << 8 | data[8]) & 0x3fff;
  h.mb_w = (h.width + 15) >> 4;
  h.mb_h = (h.height + 15) >> 4;
  const uint8_t* buf = data + 10;
  size_t buf_size = size - 10;
  if (part0 > buf_size) refuse(kPart0Length, int(part0), int(buf_size));
  BoolReader& br = h.br;
  br.init(buf, part0);
  buf += part0;
  buf_size -= part0;
  br.value(1);  // colour space
  br.value(1);  // clamping type
  h.use_segment = br.value(1);
  h.update_map = 0;
  h.absolute = 1;
  std::memset(h.quant, 0, sizeof(h.quant));
  std::memset(h.fstrength, 0, sizeof(h.fstrength));
  std::memset(h.seg_proba, 255, sizeof(h.seg_proba));
  if (h.use_segment) {
    h.update_map = br.value(1);
    if (br.value(1)) {
      h.absolute = br.value(1);
      for (int s = 0; s < 4; ++s) h.quant[s] = br.value(1) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s)
        h.fstrength[s] = br.value(1) ? br.signed_value(6) : 0;
    }
    if (h.update_map)
      for (int s = 0; s < 3; ++s)
        h.seg_proba[s] = uint8_t(br.value(1) ? br.value(8) : 255);
  }
  if (br.eof()) refuse(kSegmentHeader);
  const int simple = br.value(1);
  h.level = br.value(6);
  h.sharpness = br.value(3);
  h.use_lf_delta = br.value(1);
  int ref_delta[4] = {0}, mode_delta[4] = {0};
  if (h.use_lf_delta && br.value(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.value(1)) ref_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.value(1)) mode_delta[i] = br.signed_value(6);
  }
  h.ref_delta0 = ref_delta[0];
  h.mode_delta0 = mode_delta[0];
  h.filter_type = h.level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof()) refuse(kFilterHeader);
  h.num_parts = 1 << br.value(2);
  const size_t last = size_t(h.num_parts - 1);
  if (buf_size < 3 * last) refuse(kPartitions);
  const uint8_t* sz = buf;
  const uint8_t* start = buf + 3 * last;
  size_t left = buf_size - 3 * last;
  for (size_t p = 0; p < last; ++p, sz += 3) {
    size_t psize = sz[0] | sz[1] << 8 | sz[2] << 16;
    if (psize > left) psize = left;
    h.parts[p].init(start, psize);
    start += psize;
    left -= psize;
  }
  h.parts[last].init(start, left);
  if (left == 0) refuse(kPartitions);
  const int base_q0 = br.value(7);
  int dq_delta[5];
  for (int& d : dq_delta) d = br.value(1) ? br.signed_value(4) : 0;
  for (int s = 0; s < 4; ++s) {
    int q;
    if (h.use_segment) {
      q = h.quant[s] + (h.absolute ? 0 : base_q0);
    } else if (s > 0) {
      std::memcpy(h.dq[s], h.dq[0], sizeof(h.dq[0]));
      continue;
    } else {
      q = base_q0;
    }
    h.dq[s][0][0] = kDcTable[clip(q + dq_delta[0], 127)];
    h.dq[s][0][1] = kAcTable[clip(q, 127)];
    h.dq[s][1][0] = kDcTable[clip(q + dq_delta[1], 127)] * 2;
    h.dq[s][1][1] = std::max(8, (kAcTable[clip(q + dq_delta[2], 127)] * 101581) >> 16);
    h.dq[s][2][0] = kDcTable[clip(q + dq_delta[3], 117)];
    h.dq[s][2][1] = kAcTable[clip(q + dq_delta[4], 127)];
  }
  br.value(1);  // refresh_entropy_probs: ignored
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int k = ((t * 8 + b) * 3 + c) * 11 + p;
          h.proba[t][b][c][p] = uint8_t(
              br.bit(kCoeffsUpdateProba[k]) ? br.value(8) : kCoeffsProba0[k]);
        }
  h.use_skip = br.value(1);
  h.skip_p = h.use_skip ? br.value(8) : 0;
}

struct Macroblock {
  uint8_t segment, skip, is_i4x4, uvmode, imodes[16];
  bool coded;     // any coefficient that makes libwebp transform a block
  // per block (16 Y, 4 U, 4 V), libwebp's choice of transform: 3 past 3
  // coefficients, 2 past 1, 1 a DC only, 0 none
  uint8_t code[24];
  int16_t y2[16];
  int16_t coeffs[384];  // 16 Y, 4 U, 4 V blocks, dequantized; Y DC from WHT
};

void parse_modes(BoolReader& br, const Header& h, uint8_t* top, uint8_t* left,
                 Macroblock& mb) {
  mb.segment = 0;
  if (h.update_map)
    mb.segment = uint8_t(!br.bit(h.seg_proba[0]) ? br.bit(h.seg_proba[1])
                                                 : br.bit(h.seg_proba[2]) + 2);
  mb.skip = uint8_t(h.use_skip ? br.bit(h.skip_p) : 0);
  mb.is_i4x4 = uint8_t(!br.bit(145));
  if (!mb.is_i4x4) {
    const int ymode = br.bit(156) ? (br.bit(128) ? TM : HE)
                                  : (br.bit(163) ? VE : DC);
    std::memset(mb.imodes, ymode, 16);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* p = kBModesProba + (top[x] * 10 + ymode) * 9;
        ymode = !br.bit(p[0]) ? DC
              : !br.bit(p[1]) ? TM
              : !br.bit(p[2]) ? VE
              : !br.bit(p[3]) ? (!br.bit(p[4]) ? HE : (!br.bit(p[5]) ? RD : VR))
              : (!br.bit(p[6]) ? LD
                 : (!br.bit(p[7]) ? VL : (!br.bit(p[8]) ? HD : HU)));
        top[x] = uint8_t(ymode);
      }
      std::memcpy(mb.imodes + 4 * y, top, 4);
      left[y] = uint8_t(ymode);
    }
  }
  mb.uvmode = uint8_t(!br.bit(142) ? DC : !br.bit(114) ? VE : br.bit(183) ? TM : HE);
}

int large_value(BoolReader& br, const uint8_t* p) {
  if (!br.bit(p[3])) {
    if (!br.bit(p[4])) return 2;
    return 3 + br.bit(p[5]);
  }
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  const int bit1 = br.bit(p[8]);
  const int bit0 = br.bit(p[9 + bit1]);
  const int cat = 2 * bit1 + bit0;
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
  return v + 3 + (8 << cat);
}

// GetCoeffs: the index after the last non-zero coefficient read.
int coeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx,
           const int* dq, int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = bands[kBands[n + 1]][1];
    } else {
      v = large_value(br, p);
      p = bands[kBands[n + 1]][2];
    }
    out[kZigzag[n]] = int16_t(br.sign(v) * dq[n > 0]);
  }
  return 16;
}

void wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i, out += 64) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
  }
}

// Non-zero contexts: 4 Y, 2 U, 2 V columns (or rows) and the Y2 flag.
struct Nz {
  uint8_t y[4], u[2], v[2], dc;
};

// ParseResiduals; returns whether libwebp sees no coefficient at all (no
// block's code above 0).
bool residuals(BoolReader& br, const Header& h, Nz& top, Nz& left,
               Macroblock& mb) {
  const int(*q)[2] = h.dq[mb.segment];
  int16_t* dst = mb.coeffs;
  std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
  std::memset(mb.y2, 0, sizeof(mb.y2));
  std::memset(mb.code, 0, sizeof(mb.code));
  bool any = false;
  int block = 0;
  auto code = [&](int nz, const int16_t* c) {
    mb.code[block++] = uint8_t(nz > 3 ? 3 : nz > 1 ? 2 : c[0] != 0);
    if (nz > 1 || c[0] != 0) any = true;
  };
  int first;
  const uint8_t(*ac)[3][11];
  if (!mb.is_i4x4) {
    const int nz = coeffs(br, h.proba[1], top.dc + left.dc, q[1], 0, mb.y2);
    top.dc = left.dc = nz > 0;
    wht(mb.y2, dst);
    first = 1;
    ac = h.proba[0];
  } else {
    first = 0;
    ac = h.proba[3];
  }
  for (int y = 0; y < 4; ++y) {
    int l = left.y[y];
    for (int x = 0; x < 4; ++x, dst += 16) {
      const int nz = coeffs(br, ac, l + top.y[x], q[0], first, dst);
      l = nz > first;
      top.y[x] = uint8_t(l);
      code(nz, dst);
    }
    left.y[y] = uint8_t(l);
  }
  for (int ch = 0; ch < 2; ++ch) {
    uint8_t* t = ch ? top.v : top.u;
    uint8_t* lf = ch ? left.v : left.u;
    for (int y = 0; y < 2; ++y) {
      int l = lf[y];
      for (int x = 0; x < 2; ++x, dst += 16) {
        const int nz = coeffs(br, h.proba[2], l + t[x], q[2], 0, dst);
        l = nz > 0;
        t[x] = uint8_t(l);
        code(nz, dst);
      }
      lf[y] = uint8_t(l);
    }
  }
  return !any;
}

// Parses every macroblock in libwebp's order (a row's modes from the first
// partition, then each macroblock's tokens from its row's partition) and
// hands each finished row to `row`.
template <class RowFn>
void parse_frame(Header& h, RowFn row) {
  std::vector<uint8_t> intra_top(size_t(h.mb_w) * 4, DC);
  std::vector<Nz> nz_top(h.mb_w);
  std::memset(nz_top.data(), 0, sizeof(Nz) * nz_top.size());
  std::vector<Macroblock> mbs(h.mb_w);
  for (int mb_y = 0; mb_y < h.mb_h; ++mb_y) {
    uint8_t intra_left[4] = {DC, DC, DC, DC};
    Nz nz_left;
    std::memset(&nz_left, 0, sizeof(nz_left));
    for (int mb_x = 0; mb_x < h.mb_w; ++mb_x)
      parse_modes(h.br, h, intra_top.data() + 4 * mb_x, intra_left, mbs[mb_x]);
    if (h.br.eof()) refuse(kModesEnd, mb_y);
    BoolReader& tokens = h.parts[mb_y & (h.num_parts - 1)];
    for (int mb_x = 0; mb_x < h.mb_w; ++mb_x) {
      Macroblock& mb = mbs[mb_x];
      bool skip = mb.skip;
      if (!skip) {
        skip = residuals(tokens, h, nz_top[mb_x], nz_left, mb);
      } else {
        std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
        std::memset(mb.y2, 0, sizeof(mb.y2));
        std::memset(mb.code, 0, sizeof(mb.code));
        std::memset(nz_top[mb_x].y, 0, 8);
        std::memset(nz_left.y, 0, 8);
        if (!mb.is_i4x4) nz_top[mb_x].dc = nz_left.dc = 0;
      }
      mb.coded = !skip;
      if (tokens.eof()) refuse(kTokensEnd, mb_x, mb_y);
    }
    row(mb_y, mbs);
  }
}

// ----------------------------------------------------- VP8 reconstruction

constexpr int BPS = 32;  // libwebp's work buffer: Y, U, V with their borders
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

const int kScan[16] = {0,        4,        8,        12,
                       4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                       8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};
const int kScanUV[4] = {0, 4, 4 * BPS, 4 + 4 * BPS};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : uint8_t(v); }
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// The IDCT as libwebp's C code computes it (TransformOne_C, and its DC-only
// and AC3 shortcuts, which give the same values), in 32-bit integers.
void idct_add(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

// The IDCT as libwebp's SSE2 code computes it (Transform_SSE2), which x86-64
// builds take for every block libwebp sends to VP8Transform: 16-bit lanes
// that wrap, each product of a constant past 1 as the product of its part
// below 1 (its high 16 bits, _mm_mulhi_epi16) plus the input, the sum with
// the prediction wrapped to 16 bits and saturated to 8. It equals the C
// code until a coefficient stream is far outside what an encoder writes.
inline int16_t w16(int v) { return int16_t(v); }
inline int16_t mulhi(int16_t x, int k) { return int16_t((int(x) * k) >> 16); }
inline void simd_1d(int16_t x0, int16_t x1, int16_t x2, int16_t x3,
                    int16_t* out) {
  const int16_t a = w16(x0 + x2), b = w16(x0 - x2);
  const int16_t c =
      w16(w16(x1 - x3) + w16(mulhi(x1, -30068) - mulhi(x3, 20091)));
  const int16_t d =
      w16(w16(x1 + x3) + w16(mulhi(x1, 20091) + mulhi(x3, -30068)));
  out[0] = w16(a + d);
  out[1] = w16(b + c);
  out[2] = w16(b - c);
  out[3] = w16(a - d);
}
void idct_add_simd(const int16_t* in, uint8_t* dst) {
  int16_t v[4][4];  // v[column][row] after the vertical pass
  for (int i = 0; i < 4; ++i) simd_1d(in[i], in[4 + i], in[8 + i], in[12 + i], v[i]);
  for (int j = 0; j < 4; ++j, dst += BPS) {
    int16_t o[4];
    simd_1d(w16(v[0][j] + 4), v[1][j], v[2][j], v[3][j], o);
    for (int k = 0; k < 4; ++k) {
      const int16_t sum = w16(dst[k] + int16_t(o[k] >> 3));
      dst[k] = sum < 0 ? 0 : sum > 255 ? 255 : uint8_t(sum);
    }
  }
}

// libwebp's DoTransform: the SIMD IDCT for a block past 3 coefficients.
void transform_y(int code, const int16_t* in, uint8_t* dst) {
  if (code == 3) idct_add_simd(in, dst);
  else if (code) idct_add(in, dst);
}
// DoUVTransform: the SIMD IDCT on all four blocks of a plane where one of
// them is past 1 coefficient.
void transform_uv(const uint8_t* code, const int16_t* in, uint8_t* dst) {
  const bool ac = code[0] >= 2 || code[1] >= 2 || code[2] >= 2 || code[3] >= 2;
  for (int n = 0; n < 4; ++n) {
    if (ac) idct_add_simd(in + 16 * n, dst + kScanUV[n]);
    else if (code[n]) idct_add(in + 16 * n, dst + kScanUV[n]);
  }
}

inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}
void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

void predict16(int mode, uint8_t* dst) {
  int dc = 0;
  switch (mode) {
    case DC:
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      return fill(dst, 16, (dc + 16) >> 5);
    case TM: return true_motion(dst, 16);
    case VE:
      for (int y = 0; y < 16; ++y) std::memcpy(dst + y * BPS, dst - BPS, 16);
      return;
    case HE:
      for (int y = 0; y < 16; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], 16);
      return;
    case DC_NOTOP:
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      return fill(dst, 16, (dc + 8) >> 4);
    case DC_NOLEFT:
      for (int j = 0; j < 16; ++j) dc += dst[j - BPS];
      return fill(dst, 16, (dc + 8) >> 4);
    default: return fill(dst, 16, 0x80);
  }
}

void predict8(int mode, uint8_t* dst) {
  int dc = 0;
  switch (mode) {
    case DC:
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      return fill(dst, 8, (dc + 8) >> 4);
    case TM: return true_motion(dst, 8);
    case VE:
      for (int y = 0; y < 8; ++y) std::memcpy(dst + y * BPS, dst - BPS, 8);
      return;
    case HE:
      for (int y = 0; y < 8; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], 8);
      return;
    case DC_NOTOP:
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      return fill(dst, 8, (dc + 4) >> 3);
    case DC_NOLEFT:
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      return fill(dst, 8, (dc + 4) >> 3);
    default: return fill(dst, 8, 0x80);
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
void predict4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS];
  switch (mode) {
    case DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      return fill(dst, 4, dc >> 3);
    }
    case TM: return true_motion(dst, 4);
    case VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      return;
    }
    case HE:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      return;
    case RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      return;
    case VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      return;
    case LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      return;
    case VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      return;
    case HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      return;
    default:  // HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      return;
  }
}
#undef DST

int check_mode(int mb_x, int mb_y, int mode) {
  if (mode != DC) return mode;
  if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
  return mb_y == 0 ? DC_NOTOP : DC;
}

struct Frame {
  int y_stride, uv_stride;
  std::vector<uint8_t> y, u, v;
  std::vector<uint8_t> top_y, top_u, top_v;  // unfiltered bottom rows
  uint8_t work[YUV_SIZE];
};


// libwebp's ReconstructRow: prediction from the unfiltered neighbours kept
// in the work buffer (left) and the saved bottom rows (top).
void reconstruct_row(const Header& h, int mb_y,
                     const std::vector<Macroblock>& mbs, Frame& f) {
  uint8_t* const y_dst = f.work + Y_OFF;
  uint8_t* const u_dst = f.work + U_OFF;
  uint8_t* const v_dst = f.work + V_OFF;
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {
    std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    std::memset(u_dst - BPS - 1, 127, 8 + 1);
    std::memset(v_dst - BPS - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < h.mb_w; ++mb_x) {
    const Macroblock& mb = mbs[mb_x];
    if (mb_x > 0) {
      for (int j = -1; j < 16; ++j)
        std::memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
      for (int j = -1; j < 8; ++j) {
        std::memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
        std::memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
      }
    }
    uint8_t* top_y = f.top_y.data() + 16 * mb_x;
    uint8_t* top_u = f.top_u.data() + 8 * mb_x;
    uint8_t* top_v = f.top_v.data() + 8 * mb_x;
    if (mb_y > 0) {
      std::memcpy(y_dst - BPS, top_y, 16);
      std::memcpy(u_dst - BPS, top_u, 8);
      std::memcpy(v_dst - BPS, top_v, 8);
    }
    if (mb.is_i4x4) {
      uint8_t* const top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= h.mb_w - 1)
          std::memset(top_right, top_y[15], 4);
        else
          std::memcpy(top_right, top_y + 16, 4);
      }
      for (int k = 1; k < 4; ++k)
        std::memcpy(top_right + 4 * k * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n) {
        uint8_t* const dst = y_dst + kScan[n];
        predict4(mb.imodes[n], dst);
        transform_y(mb.code[n], mb.coeffs + n * 16, dst);
      }
    } else {
      predict16(check_mode(mb_x, mb_y, mb.imodes[0]), y_dst);
      for (int n = 0; n < 16; ++n)
        transform_y(mb.code[n], mb.coeffs + n * 16, y_dst + kScan[n]);
    }
    const int uvmode = check_mode(mb_x, mb_y, mb.uvmode);
    predict8(uvmode, u_dst);
    predict8(uvmode, v_dst);
    transform_uv(mb.code + 16, mb.coeffs + 256, u_dst);
    transform_uv(mb.code + 20, mb.coeffs + 320, v_dst);
    if (mb_y < h.mb_h - 1) {
      std::memcpy(top_y, y_dst + 15 * BPS, 16);
      std::memcpy(top_u, u_dst + 7 * BPS, 8);
      std::memcpy(top_v, v_dst + 7 * BPS, 8);
    }
    uint8_t* yo = f.y.data() + size_t(mb_y) * 16 * f.y_stride + mb_x * 16;
    uint8_t* uo = f.u.data() + size_t(mb_y) * 8 * f.uv_stride + mb_x * 8;
    uint8_t* vo = f.v.data() + size_t(mb_y) * 8 * f.uv_stride + mb_x * 8;
    for (int j = 0; j < 16; ++j)
      std::memcpy(yo + size_t(j) * f.y_stride, y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(uo + size_t(j) * f.uv_stride, u_dst + j * BPS, 8);
      std::memcpy(vo + size_t(j) * f.uv_stride, v_dst + j * BPS, 8);
    }
  }
}

// --------------------------------------------------------- VP8 loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
inline int abs0(int v) { return v < 0 ? -v : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
            a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
  return abs0(p[-2 * step] - p[-step]) > thresh || abs0(p[step] - p[0]) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * abs0(p[-step] - p[0]) + abs0(p[-2 * step] - p[step]) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step],
            q3 = p[3 * step];
  if (4 * abs0(p0 - q0) + abs0(p1 - q1) > t) return false;
  return abs0(p3 - p2) <= it && abs0(p2 - p1) <= it && abs0(p1 - p0) <= it &&
         abs0(q3 - q2) <= it && abs0(q2 - q1) <= it && abs0(q1 - q0) <= it;
}

// the simple filter on one edge of 16 pixels: hstride across it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t)) filter2(p, hstride);
}
void complex_edge(uint8_t* p, int hstride, int vstride, int size, int thresh,
                  int ithresh, int hev_t, bool inner) {
  const int t = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t, ithresh)) continue;
    if (hev(p, hstride, hev_t))
      filter2(p, hstride);
    else if (inner)
      filter4(p, hstride);
    else
      filter6(p, hstride);
  }
}

struct FilterInfo {
  int limit, ilevel, hev_thresh;
};

// PrecomputeFilterStrengths for one (segment, i4x4)
FilterInfo strength(const Header& h, int segment, int i4x4) {
  int level = h.level;
  if (h.use_segment) {
    level = h.fstrength[segment] + (h.absolute ? 0 : h.level);
  }
  if (h.use_lf_delta) {
    level += h.ref_delta0;
    if (i4x4) level += h.mode_delta0;
  }
  level = clip(level, 63);
  FilterInfo f{0, 0, 0};
  if (level > 0) {
    int ilevel = level;
    if (h.sharpness > 0) {
      ilevel >>= h.sharpness > 4 ? 2 : 1;
      if (ilevel > 9 - h.sharpness) ilevel = 9 - h.sharpness;
    }
    if (ilevel < 1) ilevel = 1;
    f.ilevel = ilevel;
    f.limit = 2 * level + ilevel;
    f.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
  }
  return f;
}

void filter_mb(const Header& h, Frame& f, int mb_x, int mb_y,
               const FilterInfo& fi, bool inner) {
  const int limit = fi.limit;
  if (limit == 0) return;
  const int ys = f.y_stride, uvs = f.uv_stride;
  uint8_t* y = f.y.data() + size_t(mb_y) * 16 * ys + mb_x * 16;
  if (h.filter_type == 1) {
    if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
    if (inner)
      for (int k = 1; k < 4; ++k) simple_edge(y + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
    if (inner)
      for (int k = 1; k < 4; ++k) simple_edge(y + 4 * k * ys, ys, 1, limit);
    return;
  }
  uint8_t* u = f.u.data() + size_t(mb_y) * 8 * uvs + mb_x * 8;
  uint8_t* v = f.v.data() + size_t(mb_y) * 8 * uvs + mb_x * 8;
  const int il = fi.ilevel, ht = fi.hev_thresh;
  if (mb_x > 0) {
    complex_edge(y, 1, ys, 16, limit + 4, il, ht, false);
    complex_edge(u, 1, uvs, 8, limit + 4, il, ht, false);
    complex_edge(v, 1, uvs, 8, limit + 4, il, ht, false);
  }
  if (inner) {
    for (int k = 1; k < 4; ++k) complex_edge(y + 4 * k, 1, ys, 16, limit, il, ht, true);
    complex_edge(u + 4, 1, uvs, 8, limit, il, ht, true);
    complex_edge(v + 4, 1, uvs, 8, limit, il, ht, true);
  }
  if (mb_y > 0) {
    complex_edge(y, ys, 1, 16, limit + 4, il, ht, false);
    complex_edge(u, uvs, 1, 8, limit + 4, il, ht, false);
    complex_edge(v, uvs, 1, 8, limit + 4, il, ht, false);
  }
  if (inner) {
    for (int k = 1; k < 4; ++k)
      complex_edge(y + 4 * k * ys, ys, 1, 16, limit, il, ht, true);
    complex_edge(u + 4 * uvs, uvs, 1, 8, limit, il, ht, true);
    complex_edge(v + 4 * uvs, uvs, 1, 8, limit, il, ht, true);
  }
}

// ------------------------------------------------ upsampling, YUV -> RGB

inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline uint8_t yuv_clip(int v) {
  return (v & ~16383) == 0 ? uint8_t(v >> 6) : v < 0 ? 0 : 255;
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  const int yy = mult_hi(y, 19077);
  rgb[0] = yuv_clip(yy + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip(yy + mult_hi(u, 33050) - 17685);
}

// libwebp's UpsampleRgbLinePair, one chroma plane pair at a time: each
// output chroma sample from the four nearest, in two rounding steps.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* tu, const uint8_t* tv, const uint8_t* cu,
                   const uint8_t* cv, uint8_t* top_dst, uint8_t* bottom_dst,
                   int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = tu[0], tl_v = tv[0], l_u = cu[0], l_v = cv[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
             top_dst);
  if (bottom_y)
    yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2,
               (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = tu[x], t_v = tv[x], u = cu[x], v = cv[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3;
    const int d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3;
    const int d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
               top_dst + 3 * (2 * x - 1));
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1,
               top_dst + 3 * (2 * x));
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                 bottom_dst + 3 * (2 * x - 1));
      yuv_to_rgb(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1,
                 bottom_dst + 3 * (2 * x));
    }
    tl_u = t_u, tl_v = t_v, l_u = u, l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2,
               (3 * tl_v + l_v + 2) >> 2, top_dst + 3 * (len - 1));
    if (bottom_y)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2,
                 (3 * l_v + tl_v + 2) >> 2, bottom_dst + 3 * (len - 1));
  }
}

void to_rgb(const Frame& f, int w, int h, uint8_t* out) {
  auto Y = [&](int r) { return f.y.data() + size_t(r) * f.y_stride; };
  auto U = [&](int r) { return f.u.data() + size_t(r) * f.uv_stride; };
  auto V = [&](int r) { return f.v.data() + size_t(r) * f.uv_stride; };
  auto O = [&](int r) { return out + size_t(r) * 3 * w; };
  upsample_pair(Y(0), nullptr, U(0), V(0), U(0), V(0), O(0), nullptr, w);
  int k = 1;
  for (; 2 * k < h; ++k)
    upsample_pair(Y(2 * k - 1), Y(2 * k), U(k - 1), V(k - 1), U(k), V(k),
                  O(2 * k - 1), O(2 * k), w);
  if (!(h & 1))
    upsample_pair(Y(h - 1), nullptr, U(k - 1), V(k - 1), U(k - 1), V(k - 1),
                  O(h - 1), nullptr, w);
}

void decode_lossy(const uint8_t* data, size_t size, uint8_t* out) {
  Header h;
  parse_header(data, size, h);
  Frame f;
  f.y_stride = h.mb_w * 16;
  f.uv_stride = h.mb_w * 8;
  f.y.assign(size_t(f.y_stride) * h.mb_h * 16, 0);
  f.u.assign(size_t(f.uv_stride) * h.mb_h * 8, 0);
  f.v.assign(f.u.size(), 0);
  f.top_y.assign(size_t(h.mb_w) * 16 + 4, 0);
  f.top_u.assign(size_t(h.mb_w) * 8, 0);
  f.top_v.assign(size_t(h.mb_w) * 8, 0);
  std::memset(f.work, 0, sizeof(f.work));
  // (limit, ilevel, hev) per (segment, i4x4), and per macroblock its
  // strengths' index and whether its inner edges are filtered
  FilterInfo fs[4][2];
  for (int s = 0; s < 4; ++s)
    for (int i = 0; i < 2; ++i) fs[s][i] = strength(h, s, i);
  std::vector<uint8_t> fidx(size_t(h.mb_w) * h.mb_h);
  parse_frame(h, [&](int mb_y, const std::vector<Macroblock>& mbs) {
    for (int mb_x = 0; mb_x < h.mb_w; ++mb_x) {
      const Macroblock& mb = mbs[mb_x];
      fidx[size_t(mb_y) * h.mb_w + mb_x] = uint8_t(
          mb.segment * 4 + mb.is_i4x4 * 2 + (mb.is_i4x4 || mb.coded));
    }
    reconstruct_row(h, mb_y, mbs, f);
  });
  if (h.filter_type > 0)
    for (int mb_y = 0; mb_y < h.mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < h.mb_w; ++mb_x) {
        const int k = fidx[size_t(mb_y) * h.mb_w + mb_x];
        filter_mb(h, f, mb_x, mb_y, fs[k >> 2][(k >> 1) & 1], k & 1);
      }
  to_rgb(f, h.width, h.height, out);
}

}  // namespace

extern "C" {

// Every hw_* entry point returns kNoMemory where an allocation failed, and
// writes a refusal's numbers into detail[0..1].

// What the lossy decode parses, per macroblock in raster order: info (20
// bytes: segment, skip flag, i4x4, chroma mode, 16 luma modes) and coeffs
// (25 blocks of 16: the Y2 block, 16 Y blocks with the WHT's DCs, 4 U, 4 V;
// dequantized, as int16 as libwebp keeps them).
int hw_vp8_coefficients(const uint8_t* data, size_t size, uint8_t* info,
                        int16_t* coeffs, int* detail) try {
  Header h;
  parse_header(data, size, h);
  parse_frame(h, [&](int mb_y, const std::vector<Macroblock>& mbs) {
    for (int mb_x = 0; mb_x < h.mb_w; ++mb_x) {
      const Macroblock& mb = mbs[mb_x];
      const size_t k = size_t(mb_y) * h.mb_w + mb_x;
      uint8_t* in = info + 20 * k;
      in[0] = mb.segment;
      in[1] = mb.skip;
      in[2] = mb.is_i4x4;
      in[3] = mb.uvmode;
      std::memcpy(in + 4, mb.imodes, 16);
      std::memcpy(coeffs + 400 * k, mb.y2, sizeof(mb.y2));
      std::memcpy(coeffs + 400 * k + 16, mb.coeffs, sizeof(mb.coeffs));
    }
  });
  return 0;
} catch (const Refusal& r) {
  detail[0] = r.a;
  detail[1] = r.b;
  return r.code;
} catch (...) {
  return kNoMemory;
}

// An ALPH chunk's payload (data[0, len)) as width x height alpha.
int hw_alpha(const uint8_t* data, size_t len, int width, int height,
             uint8_t* out, int* detail) try {
  decode_alpha(data, len, width, height, out);
  return 0;
} catch (const Refusal& r) {
  detail[0] = r.a;
  detail[1] = r.b;
  return r.code;
} catch (...) {
  return kNoMemory;
}

// A WebP file's image: the bitstream in image[0, len) (lossless or lossy,
// width x height; the chunk's payload and its pad byte, as libwebp's
// demuxer hands it over) and its ALPH payload (alpha, NULL where none:
// decoded, never drawn), drawn at (x, y) on a zero canvas_w x canvas_h RGB
// canvas.
int hw_webp_rgb(const uint8_t* image, size_t len, int lossless, int width,
                int height, const uint8_t* alpha, size_t alpha_len,
                int canvas_w, int canvas_h, int x, int y, uint8_t* out,
                int* detail) try {
  std::vector<uint8_t> rgb(size_t(width) * height * 3);
  if (lossless) {
    std::vector<uint32_t> px;
    decode_lossless(image, len, width, height, px);
    for (size_t i = 0; i < px.size(); ++i) {
      rgb[3 * i] = uint8_t(px[i] >> 16);
      rgb[3 * i + 1] = uint8_t(px[i] >> 8);
      rgb[3 * i + 2] = uint8_t(px[i]);
    }
  } else {
    decode_lossy(image, len, rgb.data());
  }
  if (alpha != nullptr) {
    std::vector<uint8_t> a(size_t(width) * height);
    decode_alpha(alpha, alpha_len, width, height, a.data());
  }
  std::memset(out, 0, size_t(canvas_w) * canvas_h * 3);
  for (int r = 0; r < height; ++r)
    std::memcpy(out + (size_t(y + r) * canvas_w + x) * 3,
                rgb.data() + size_t(r) * width * 3, size_t(width) * 3);
  return 0;
} catch (const Refusal& r) {
  detail[0] = r.a;
  detail[1] = r.b;
  return r.code;
} catch (...) {
  return kNoMemory;
}

}  // extern "C"
