// The port's JPEG codec: a baseline / extended-sequential / progressive
// 8-bit Huffman decoder and a baseline encoder, each held bit for bit to
// libjpeg-turbo's defaults (the library under cv2 and PIL). Host code with a
// plain C interface, bound with ctypes by hifidiff_tpu_torch/data/jpeg.py.
//
// Decoder (libjpeg-turbo's jdhuff.c, jdphuff.c, jdcoefct.c, jidctint.c,
// jdsample.c, jdcolor.c):
//   * SOF0 / SOF1 at 8 bits, interleaved and non-interleaved scans,
//     restart intervals, any size, partial MCUs;
//   * SOF2 (progressive) at 8 bits: DC first / refine scans, interleaved
//     over the MCU grid with its padding blocks or over one component's
//     blocks; AC first / refine scans of one component over its own blocks;
//     EOB runs across blocks, reset at each restart marker; successive
//     approximation. The scans fill a whole-image coefficient buffer, which
//     then goes through the same IDCT, upsampling and colour conversion.
//     A file whose coefficients libjpeg would smooth (do_block_smoothing:
//     the first nine AC coefficients of a component not all refined to
//     bit 0) is refused: its output is not the coefficients' own;
//   * the islow IDCT as libjpeg-turbo's x86-64 SIMD code computes it
//     (16-bit lanes; see idct_islow);
//   * fancy upsampling: h2v1 / h1v2 / h2v2 triangle filters with their
//     rounding biases and clamped edges (box replication where libjpeg
//     takes it: h2v1 / h2v2 on a plane of at most two columns, and every
//     other whole ratio); never the merged upsampler;
//   * the colour space of jdapimin.c's default_decompress_parms: three
//     components are YCbCr, or RGB where an Adobe marker says transform 0
//     (without a JFIF marker) or, with neither marker, the component ids
//     are 'R', 'G', 'B'; four are CMYK, or YCCK where an Adobe marker says
//     transform 2 (or any but 0);
//   * fixed-point YCbCr -> RGB; RGB copied; grey repeated over three
//     channels; YCCK -> CMYK (jdcolor.c's ycck_cmyk_convert, the same
//     tables); CMYK -> RGB as the reader named converts libjpeg's CMYK:
//     Pillow's "CMYK;I" raw mode then cmyk2rgb (libImaging/Convert.c), or
//     OpenCV's icvCvt_CMYK2BGR_8u_C4C3R (imgcodecs/src/utils.cpp). A
//     four-component file decoded without a reader raises.
//   Lossless, hierarchical and arithmetic-coded files, 12-bit samples and
//   truncated data raise, naming what they are.
//
// Encoder (cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, q]) as
// libjpeg-turbo runs it: jcparam.c, jccolor.c, jcsample.c, jcprepct.c,
// jfdctint.c, jcdctmgr.c, jccoefct.c, jchuff.c, jcmarker.c):
//   * Annex K tables scaled by jpeg_set_quality(q, force_baseline=TRUE);
//   * fixed-point RGB -> YCbCr, 4:2:0 with h2v2_downsample's alternating
//     bias and edge replication, dummy blocks carrying the DC to their left
//     (or above);
//   * the islow FDCT and the reciprocal quantizer of a SIMD build (16-bit
//     DCTELEM);
//   * the standard Huffman tables, no restart markers, a JFIF APP0.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// the colour spaces of a frame (data/jpeg.py's SPACES), and the readers
// whose CMYK -> RGB a four-component file takes (data/jpeg.py's READERS)
enum { kGrey, kYcbcr, kRgb, kCmyk, kYcck };
enum { kNoReader, kPil, kCv2 };

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for a corrupt run past the block (jutils.c)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- Huffman

struct HuffSpec {
  uint8_t bits[17] = {0};  // bits[l]: codes of length l
  uint8_t vals[256] = {0};
  int count = 0;
  bool defined = false;
};

// Canonical codes (JPEG Annex C) from the bits / vals lists.
void canonical_codes(const HuffSpec& s, std::vector<uint16_t>& code,
                     std::vector<uint8_t>& size) {
  code.clear();
  size.clear();
  uint32_t c = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < s.bits[l]; ++i) {
      code.push_back((uint16_t)c);
      size.push_back((uint8_t)l);
      ++c;
    }
    if (c > (1u << l)) throw Error("corrupt data: bad Huffman table");
    c <<= 1;
  }
}

struct HuffDec {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t lookup[512];  // (length << 8) | value for codes of <= 9 bits
  uint8_t vals[256];
};

void build_decoder(const HuffSpec& s, HuffDec& d) {
  std::vector<uint16_t> code;
  std::vector<uint8_t> size;
  canonical_codes(s, code, size);
  std::memcpy(d.vals, s.vals, sizeof d.vals);
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (s.bits[l]) {
      d.valoffset[l] = p - (int)code[p];
      p += s.bits[l];
      d.maxcode[l] = code[p - 1];
    } else {
      d.maxcode[l] = -1;
    }
  }
  d.maxcode[17] = 0x7fffffff;
  std::memset(d.lookup, 0, sizeof d.lookup);
  for (int i = 0; i < (int)code.size(); ++i) {
    if (size[i] > 9) continue;
    const int shift = 9 - size[i];
    const int base = code[i] << shift;
    for (int j = 0; j < (1 << shift); ++j)
      d.lookup[base + j] = (uint16_t)((size[i] << 8) | s.vals[i]);
  }
}

// ---------------------------------------------------------------- decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;          // coefficient blocks stored (MCU-padded)
  int wib = 0, hib = 0;        // width / height in blocks
  int dw = 0, dh = 0;          // downsampled width / height
  bool latched = false;
  int quant[64];               // natural order, latched at its first scan
  std::vector<int16_t> coef;   // bh x bw blocks of 64
  int dc_pred = 0;
  // progressive: the bit each coefficient was last coded down to (its Al),
  // -1 before any scan holds it (jdphuff.c's coef_bits)
  int coef_bits[64];
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  int64_t phantom = 0;  // zero bits appended past a marker or the data
  bool at_marker = false;

  void fill() {
    while (bits <= 56) {
      uint32_t byte = 0;
      if (!at_marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            p += 2;
          } else {
            at_marker = true;  // a marker: supply zeros from here
            byte = 0;
            phantom += 8;
          }
        } else {
          ++p;
        }
      } else {
        phantom += 8;
      }
      buf |= (uint64_t)byte << (56 - bits);
      bits += 8;
    }
  }
  uint32_t peek(int n) {
    if (bits < n) fill();
    return (uint32_t)(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    bits -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return (int)v;
  }
  // Ran past the entropy-coded data: some zeros supplied were consumed.
  bool overran() const { return phantom > bits; }
  void reset() {
    buf = 0;
    bits = 0;
    phantom = 0;
    at_marker = false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

int huff_decode(BitReader& br, const HuffDec& d) {
  const uint32_t look = br.peek(16);
  const uint16_t e = d.lookup[look >> 7];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  for (int l = 10; l <= 16; ++l) {
    const int32_t c = (int32_t)(look >> (16 - l));
    if (c <= d.maxcode[l]) {
      br.skip(l);
      return d.vals[(c + d.valoffset[l]) & 0xFF];
    }
  }
  throw Error("corrupt data: a Huffman code no table defines");
}

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0;
  bool frame = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int space = 0;  // kGrey ... kYcck: the colour space parse() settles
  int restart_interval = 0;
  int qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffSpec dc_spec[4], ac_spec[4];
  HuffDec dc_dec[4], ac_dec[4];
  std::vector<Component> comps;
  int max_h = 1, max_v = 1, mcus_per_row = 0, mcu_rows = 0;
  int scans = 0;
  bool progressive = false;
  int eobrun = 0;  // progressive AC scans: blocks left in the current run

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  uint8_t byte() {
    if (pos >= n) throw Error("truncated data: the file ends in a header");
    return data[pos++];
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  // The next marker code, skipping fill bytes (and, after entropy-coded
  // data, any stray bytes as libjpeg's next_marker does).
  int next_marker() {
    for (;;) {
      if (pos >= n) return -1;
      if (data[pos] != 0xFF) {
        ++pos;
        continue;
      }
      while (pos < n && data[pos] == 0xFF) ++pos;
      if (pos >= n) return -1;
      const int m = data[pos++];
      if (m != 0) return m;
    }
  }

  void read_dqt() {
    int len = word() - 2;
    while (len > 0) {
      const int pq_tq = byte();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) throw Error("corrupt data: DQT table index > 3");
      for (int i = 0; i < 64; ++i)
        qt[tq][kNatural[i]] = pq ? word() : byte();
      qt_defined[tq] = true;
      len -= 1 + 64 * (pq ? 2 : 1);
    }
    if (len != 0) throw Error("corrupt data: bad DQT length");
  }

  void read_dht() {
    int len = word() - 2;
    while (len > 16) {
      const int tc_th = byte();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error("corrupt data: bad DHT index");
      HuffSpec& s = tc ? ac_spec[th] : dc_spec[th];
      s = HuffSpec();
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += (s.bits[l] = byte());
      if (count > 256 || count > len - 17)
        throw Error("corrupt data: bad DHT length");
      for (int i = 0; i < count; ++i) s.vals[i] = byte();
      s.count = count;
      s.defined = true;
      build_decoder(s, tc ? ac_dec[th] : dc_dec[th]);
      len -= 17 + count;
    }
    if (len != 0) throw Error("corrupt data: bad DHT length");
  }

  void read_app(int m) {
    const int len = word() - 2;
    if (len < 0 || pos + len > n)
      throw Error("truncated data: the file ends in a header");
    const uint8_t* d = data + pos;
    if (m == 0xE0 && len >= 14 && !std::memcmp(d, "JFIF\0", 5))
      saw_jfif = true;
    if (m == 0xEE && len >= 12 && !std::memcmp(d, "Adobe", 5)) {
      saw_adobe = true;
      adobe_transform = d[11];
    }
    pos += len;
  }

  void skip_segment() {
    const int len = word() - 2;
    if (len < 0 || pos + len > n)
      throw Error("truncated data: the file ends in a header");
    pos += len;
  }

  void read_sof(bool prog) {
    if (frame) throw Error("corrupt data: a second frame header");
    progressive = prog;
    word();
    const int precision = byte();
    if (precision != 8)
      throw Error(std::to_string(precision) +
                  "-bit samples are not supported (8-bit only)");
    height = word();
    width = word();
    const int nc = byte();
    if (height == 0) throw Error("a zero or DNL-defined height is not "
                                 "supported");
    if (width == 0) throw Error("corrupt data: zero width");
    if (nc != 1 && nc != 3 && nc != 4)
      throw Error(std::to_string(nc) + "-component JPEG is not supported");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw Error("corrupt data: bad component parameters");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    mcus_per_row = (width + 8 * max_h - 1) / (8 * max_h);
    mcu_rows = (height + 8 * max_v - 1) / (8 * max_v);
    for (auto& c : comps) {
      if (max_h % c.h || max_v % c.v)
        throw Error("sampling factors that are not whole ratios are not "
                    "supported");
      c.dw = (int)(((int64_t)width * c.h + max_h - 1) / max_h);
      c.dh = (int)(((int64_t)height * c.v + max_v - 1) / max_v);
      c.wib = (int)(((int64_t)width * c.h + 8 * max_h - 1) / (8 * max_h));
      c.hib = (int)(((int64_t)height * c.v + 8 * max_v - 1) / (8 * max_v));
      c.bw = mcus_per_row * c.h;
      c.bh = mcu_rows * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
    }
    frame = true;
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    const HuffDec& dc = dc_dec[c.dc_tbl];
    const HuffDec& ac = ac_dec[c.ac_tbl];
    int s = huff_decode(br, dc);
    if (s > 16) throw Error("corrupt data: bad DC magnitude");
    int diff = s ? extend(br.get(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = (int16_t)c.dc_pred;
    for (int k = 1; k < 64; ++k) {
      const int rs = huff_decode(br, ac);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        const int v = extend(br.get(s), s);
        blk[kNatural[k]] = (int16_t)v;
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c's four block decoders. Coefficients are JCOEF (int16_t);
  // values are shifted left by Al as libjpeg's LEFT_SHIFT does.
  void dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    const int s = huff_decode(br, dc_dec[c.dc_tbl]);
    if (s > 16) throw Error("corrupt data: bad DC magnitude");
    c.dc_pred += s ? extend(br.get(s), s) : 0;
    blk[0] = (int16_t)(int)((unsigned)c.dc_pred << al);
  }

  void dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  void ac_first(BitReader& br, Component& c, int16_t* blk, int ss, int se,
                int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const HuffDec& ac = ac_dec[c.ac_tbl];
    for (int k = ss; k <= se; ++k) {
      const int rs = huff_decode(br, ac);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] =
            (int16_t)(int)((unsigned)extend(br.get(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  // A correction bit for an already nonzero coefficient: set bit Al on its
  // side of zero where it is not set yet.
  static void correct(BitReader& br, int16_t& t, int p1, int m1) {
    if (br.get(1) && (t & p1) == 0) t = (int16_t)(t >= 0 ? t + p1 : t + m1);
  }

  void ac_refine(BitReader& br, Component& c, int16_t* blk, int ss, int se,
                 int al) {
    const int p1 = 1 << al, m1 = -p1;
    int k = ss;
    if (eobrun == 0) {
      const HuffDec& ac = ac_dec[c.ac_tbl];
      for (; k <= se; ++k) {
        const int rs = huff_decode(br, ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;   // libjpeg takes any size as 1
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;   // the rest of the band: the EOB run below
        }
        // over the nonzero coefficients (a correction bit each) and r
        // zero ones, to the zero coefficient the new value goes to
        do {
          int16_t& t = blk[kNatural[k]];
          if (t != 0) {
            correct(br, t, p1, m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& t = blk[kNatural[k]];
        if (t != 0) correct(br, t, p1, m1);
      }
      --eobrun;
    }
  }

  // Past the entropy-coded data of an interval or a scan: drop the bits
  // left over, check none was made up, and step to the marker.
  void finish_segment(BitReader& br) {
    if (br.overran())
      throw Error("truncated data: the entropy-coded data ends early");
    pos = (size_t)(br.p - data);
    br.reset();
  }

  // The scan's parameters against jdphuff.c's start_pass_phuff_decoder
  // (a progressive scan) or a sequential scan's fixed ones; the Huffman
  // tables the scan reads defined; coef_bits updated as libjpeg updates it.
  void check_scan(const std::vector<Component*>& sc, int ss, int se, int ah,
                  int al) {
    if (!progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        throw Error("corrupt data: a sequential scan with spectral "
                    "selection or approximation");
    } else if ((ss == 0 && se != 0) ||
               (ss != 0 && (ss > se || se > 63 || sc.size() != 1)) ||
               (ah != 0 && al != ah - 1) || al > 13) {
      throw Error("corrupt data: bad progressive scan parameters Ss=" +
                  std::to_string(ss) + " Se=" + std::to_string(se) +
                  " Ah=" + std::to_string(ah) + " Al=" + std::to_string(al));
    }
    for (auto* c : sc) {
      const bool dc = !progressive || (ss == 0 && ah == 0);
      const bool ac = !progressive || ss != 0;
      if ((dc && !dc_spec[c->dc_tbl].defined) ||
          (ac && !ac_spec[c->ac_tbl].defined))
        throw Error("corrupt data: a scan uses an undefined Huffman table");
      if (progressive)
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
    }
  }

  void read_sos() {
    if (!frame) throw Error("corrupt data: a scan before the frame header");
    word();
    const int ns = byte();
    if (ns < 1 || ns > 4 || ns > (int)comps.size())
      throw Error("corrupt data: bad scan component count");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int id = byte();
      const int t = byte();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) throw Error("corrupt data: a scan names no component");
      found->dc_tbl = t >> 4;
      found->ac_tbl = t & 15;
      if (found->dc_tbl > 3 || found->ac_tbl > 3)
        throw Error("corrupt data: a scan uses an undefined Huffman table");
      if (!found->latched) {
        if (!qt_defined[found->tq])
          throw Error("corrupt data: a component's quantization table is "
                      "not defined");
        std::memcpy(found->quant, qt[found->tq], sizeof found->quant);
        found->latched = true;
      }
      sc.push_back(found);
    }
    const int ss = byte(), se = byte(), ahal = byte();
    const int ah = ahal >> 4, al = ahal & 15;
    check_scan(sc, ss, se, ah, al);
    for (auto* c : sc) c->dc_pred = 0;
    eobrun = 0;
    BitReader br{data + pos, data + n};
    int next_rst = 0, todo = restart_interval;
    auto restart = [&]() {
      finish_segment(br);
      const int m = next_marker();
      if (m == -1) throw Error("truncated data: the file ends in a scan");
      if (m != 0xD0 + next_rst)
        throw Error("corrupt data: restart marker RST" +
                    std::to_string(next_rst) + " expected");
      next_rst = (next_rst + 1) & 7;
      for (auto* c : sc) c->dc_pred = 0;
      eobrun = 0;
      br = BitReader{data + pos, data + n};
      todo = restart_interval;
    };
    // every block of the scan in order: one component's own blocks, or the
    // MCU grid (padding blocks included) of an interleaved scan
    auto each_block = [&](auto&& decode) {
      if (ns == 1) {
        Component& c = *sc[0];
        for (int by = 0; by < c.hib; ++by)
          for (int bx = 0; bx < c.wib; ++bx) {
            if (restart_interval && todo == 0) restart();
            decode(c, &c.coef[((size_t)by * c.bw + bx) * 64]);
            --todo;
          }
        return;
      }
      int blocks = 0;
      for (auto* c : sc) blocks += c->h * c->v;
      if (blocks > 10)
        throw Error("corrupt data: more than 10 blocks in an MCU");
      for (int my = 0; my < mcu_rows; ++my)
        for (int mx = 0; mx < mcus_per_row; ++mx) {
          if (restart_interval && todo == 0) restart();
          for (auto* c : sc)
            for (int y = 0; y < c->v; ++y)
              for (int x = 0; x < c->h; ++x) {
                const size_t b = (size_t)(my * c->v + y) * c->bw +
                                 (size_t)(mx * c->h + x);
                decode(*c, &c->coef[b * 64]);
              }
          --todo;
        }
    };
    if (!progressive) {
      each_block([&](Component& c, int16_t* b) { decode_block(br, c, b); });
    } else if (ss == 0 && ah == 0) {
      each_block([&](Component& c, int16_t* b) { dc_first(br, c, b, al); });
    } else if (ss == 0) {
      each_block([&](Component&, int16_t* b) { dc_refine(br, b, al); });
    } else if (ah == 0) {
      each_block([&](Component& c, int16_t* b) {
        ac_first(br, c, b, ss, se, al);
      });
    } else {
      each_block([&](Component& c, int16_t* b) {
        ac_refine(br, c, b, ss, se, al);
      });
    }
    finish_segment(br);
    ++scans;
  }

  // jdcoefct.c's smoothing_ok at the end of the input: libjpeg smooths the
  // coefficients of a progressive file (do_block_smoothing, its default)
  // when every component's DC is known and its quantizers at the first
  // nine AC positions are nonzero, and some component's first nine AC
  // coefficients were not all coded down to bit 0.
  bool libjpeg_would_smooth() const {
    if (!progressive) return false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const auto& c : comps) {
      for (int p : kPos)
        if (c.quant[p] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  void parse() {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8)
      throw Error("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m == -1)
        throw Error("truncated data: the file ends before its EOI marker");
      if (m == 0xD9) break;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          read_sof(m == 0xC2);
          break;
        case 0xC6:
          throw Error("hierarchical JPEG (SOF6, differential progressive) "
                      "is not supported");
        case 0xC3:
        case 0xC7:
          throw Error("lossless JPEG (SOF" + std::to_string(m - 0xC0) +
                      ") is not supported");
        case 0xC5:
          throw Error("hierarchical JPEG (SOF5) is not supported");
        case 0xCA:
          throw Error("arithmetic-coded JPEG (SOF10, progressive) is not "
                      "supported");
        case 0xC9:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
        case 0xCC:
          throw Error("arithmetic-coded JPEG is not supported");
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD:
          word();
          restart_interval = word();
          break;
        case 0xDA:
          read_sos();
          break;
        case 0xD8:
          throw Error("corrupt data: a second SOI marker");
        default:
          if (m >= 0xD0 && m <= 0xD7) break;  // stray RSTn: no segment
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m);
          } else {
            skip_segment();
          }
      }
    }
    if (!frame) throw Error("corrupt data: no frame header");
    if (!scans) throw Error("corrupt data: no scan");
    for (auto& c : comps)
      if (!c.latched) throw Error("truncated data: a component no scan "
                                  "holds");
    if (libjpeg_would_smooth())
      throw Error("incomplete progressive JPEG: libjpeg would smooth it "
                  "(the first AC coefficients are not all refined to bit "
                  "0)");
    space = colour_space();
  }

  // default_decompress_parms (libjpeg-turbo's jdapimin.c)
  int colour_space() const {
    if (comps.size() == 1) return kGrey;
    if (comps.size() == 4)
      return saw_adobe && adobe_transform != 0 ? kYcck : kCmyk;
    if (saw_jfif) return kYcbcr;
    if (saw_adobe) return adobe_transform == 0 ? kRgb : kYcbcr;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B'
               ? kRgb
               : kYcbcr;
  }
};

#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// The islow IDCT of one block into an 8x8 window of `out`, as PIL and cv2
// run it on x86-64: libjpeg-turbo's SIMD version (jidctint-sse2.asm and
// -avx2.asm, which agree bit for bit), not jidctint.c. It is jidctint.c's
// arithmetic with its products rearranged into pairs (the same sums), but
// in 16-bit lanes: the dequantized coefficients and the sums and
// differences of two inputs wrap at 16 bits, the products are summed in
// 32 bits (wrapping), pass 1's outputs saturate to 16 bits and pass 2's to
// [0, 255] (jidctint.c keeps every value in range and wraps the output
// through its range-limit table). The two agree where nothing leaves its
// range, as on every block an encoder writes; they part on blocks whose
// dequantized values an encoder would never give (a quantization table
// raised after the fact, a corrupt stream). Pass 1 takes its DC shortcut
// only where rows 1-7 of the whole block are zero, in every column at once.
namespace simd_idct {

// [input or output k][transform l]: the eight 1-D transforms of a pass side
// by side, as the SIMD code holds them (and as g++ vectorizes the loops).
typedef int32_t Lanes[8][8];

inline int32_t wrap16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int32_t add32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
inline int32_t sub32(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}
inline int32_t sat16(int32_t x) {
  return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
}
// x + 2^(n-1) (wrapping at 32 bits), shifted right by n
inline int32_t descale(int32_t x, int n) {
  return add32(x, 1 << (n - 1)) >> n;
}

// One pass on 16-bit inputs: each output k the 32-bit sum before the
// descale. Every product and pair of products fits 32 bits (inputs of 16,
// constants of 15); only the last sums can wrap, as paddd does.
void pass(const Lanes in, Lanes out) {
  const int32_t F298 = FIX_0_298631336, F390 = FIX_0_390180644,
                F541 = FIX_0_541196100, F765 = FIX_0_765366865,
                F899 = FIX_0_899976223, F1175 = FIX_1_175875602,
                F1501 = FIX_1_501321110, F1847 = FIX_1_847759065,
                F1961 = FIX_1_961570560, F2053 = FIX_2_053119869,
                F2562 = FIX_2_562915447, F3072 = FIX_3_072711026;
  for (int l = 0; l < 8; ++l) {
    const int32_t z2 = in[2][l], z3 = in[6][l];
    const int32_t tmp3 = z2 * (F541 + F765) + z3 * F541;
    const int32_t tmp2 = z2 * F541 + z3 * (F541 - F1847);
    const int32_t tmp0 = wrap16(in[0][l] + in[4][l]) * 8192;
    const int32_t tmp1 = wrap16(in[0][l] - in[4][l]) * 8192;
    const int32_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const int32_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    const int32_t i7 = in[7][l], i5 = in[5][l], i3 = in[3][l], i1 = in[1][l];
    const int32_t z3o = wrap16(i7 + i3), z4o = wrap16(i5 + i1);
    const int32_t z3r = z3o * (F1175 - F1961) + z4o * F1175;
    const int32_t z4r = z3o * F1175 + z4o * (F1175 - F390);
    const int32_t o0 = add32(i7 * (F298 - F899) + i1 * -F899, z3r);
    const int32_t o3 = add32(i7 * -F899 + i1 * (F1501 - F899), z4r);
    const int32_t o1 = add32(i5 * (F2053 - F2562) + i3 * -F2562, z4r);
    const int32_t o2 = add32(i5 * -F2562 + i3 * (F3072 - F2562), z3r);
    out[0][l] = add32(t10, o3);
    out[7][l] = sub32(t10, o3);
    out[1][l] = add32(t11, o2);
    out[6][l] = sub32(t11, o2);
    out[2][l] = add32(t12, o1);
    out[5][l] = sub32(t12, o1);
    out[3][l] = add32(t13, o0);
    out[4][l] = sub32(t13, o0);
  }
}

}  // namespace simd_idct

void idct_islow(const int16_t* in, const int* q, uint8_t* out, int stride) {
  using namespace simd_idct;
  const int P1 = 2, CB = 13;
  Lanes a, b;   // pass 1: a[row][column]; pass 2: b[column][row]
  bool ac = false;
  for (int k = 8; k < 64; ++k) ac |= in[k] != 0;
  for (int k = 0; k < 64; ++k) a[k >> 3][k & 7] = wrap16(in[k] * q[k]);
  if (!ac) {   // a DC shortcut, shifted in 16 bits
    for (int c = 0; c < 8; ++c)
      for (int r = 0; r < 8; ++r) b[c][r] = wrap16(a[0][c] * 4);
  } else {
    Lanes s;
    pass(a, s);
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) b[c][r] = sat16(descale(s[r][c], CB - P1));
  }
  Lanes s;
  pass(b, s);
  for (int r = 0; r < 8; ++r) {
    uint8_t* op = out + (size_t)r * stride;
    for (int c = 0; c < 8; ++c) {
      const int32_t v = sat16(descale(s[c][r], CB + P1 + 3));
      op[c] = (uint8_t)((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
    }
  }
}

// A component's samples: its blocks through the IDCT, bw*8 x bh*8.
std::vector<uint8_t> component_plane(const Component& c) {
  const int stride = c.bw * 8;
  std::vector<uint8_t> plane((size_t)stride * c.bh * 8);
  // Only the blocks that hold samples of the image are needed.
  for (int by = 0; by < c.bh && by * 8 < c.dh; ++by)
    for (int bx = 0; bx < c.bw && bx * 8 < c.dw; ++bx)
      idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.quant,
                 &plane[(size_t)by * 8 * stride + (size_t)bx * 8], stride);
  return plane;
}

// The component upsampled to width x height (jdsample.c, fancy).
std::vector<uint8_t> upsample(const Component& c, const uint8_t* plane,
                              int width, int height, int max_h, int max_v) {
  const int stride = c.bw * 8;
  const int rh = max_h / c.h, rv = max_v / c.v;
  std::vector<uint8_t> out((size_t)width * height);
  auto at = [&](int y, int x) -> int {
    y = y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y);
    x = x < 0 ? 0 : (x >= c.dw ? c.dw - 1 : x);
    return plane[(size_t)y * stride + x];
  };
  if (rh == 1 && rv == 1) {
    for (int y = 0; y < height; ++y)
      std::memcpy(&out[(size_t)y * width], plane + (size_t)y * stride,
                  width);
    return out;
  }
  const bool fancy_h = rh == 2 && c.dw > 2;
  if (rh == 2 && rv == 1 && fancy_h) {  // h2v1
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x) {
        const int i = x >> 1;
        const int v3 = at(y, i) * 3;
        out[(size_t)y * width + x] =
            (x & 1) ? (uint8_t)((v3 + at(y, i + 1) + 2) >> 2)
                    : (uint8_t)((v3 + at(y, i - 1) + 1) >> 2);
      }
    return out;
  }
  if (rh == 1 && rv == 2) {  // h1v2
    for (int y = 0; y < height; ++y) {
      const int i = y >> 1;
      const int nb = (y & 1) ? i + 1 : i - 1;
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; ++x)
        out[(size_t)y * width + x] =
            (uint8_t)((at(i, x) * 3 + at(nb, x) + bias) >> 2);
    }
    return out;
  }
  if (rh == 2 && rv == 2 && fancy_h) {  // h2v2
    for (int y = 0; y < height; ++y) {
      const int i = y >> 1;
      const int nb = (y & 1) ? i + 1 : i - 1;
      for (int x = 0; x < width; ++x) {
        const int j = x >> 1;
        const int cur = at(i, j) * 3 + at(nb, j);
        const int side = (x & 1) ? at(i, j + 1) * 3 + at(nb, j + 1)
                                 : at(i, j - 1) * 3 + at(nb, j - 1);
        out[(size_t)y * width + x] =
            (x & 1) ? (uint8_t)((cur * 3 + side + 7) >> 4)
                    : (uint8_t)((cur * 3 + side + 8) >> 4);
      }
    }
    return out;
  }
  // Box replication (int_upsample, h2v1_upsample, h2v2_upsample).
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      out[(size_t)y * width + x] = plane[(size_t)(y / rv) * stride + x / rh];
  return out;
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int SB = 16;
    const int64_t half = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jdcolor.c's ycck_cmyk_convert: the YCbCr -> RGB of the first three
// components, each inverted and clamped; K as it is.
void ycck_cmyk(const uint8_t* in, size_t np, uint8_t* out) {
  for (size_t i = 0; i < np; ++i, in += 4, out += 4) {
    const int y = in[0], cb = in[1], cr = in[2];
    out[0] = clamp255(255 - (y + kYcc.cr_r[cr]));
    out[1] =
        clamp255(255 - (y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
    out[2] = clamp255(255 - (y + kYcc.cb_b[cb]));
    out[3] = in[3];
  }
}

// libjpeg's CMYK as each reader turns it into RGB. PIL: the "CMYK;I" raw
// mode inverts every sample, then cmyk2rgb gives nk - nk * c / 255 with
// nk = 255 - k (MULDIV255's rounding); OpenCV: k - (255 - c) * k >> 8.
void cmyk_rgb(const uint8_t* in, size_t np, int reader, uint8_t* out) {
  for (size_t i = 0; i < np; ++i, in += 4, out += 3) {
    const int k = in[3];
    for (int c = 0; c < 3; ++c) {
      if (reader == kPil) {
        const int t = (255 - in[c]) * k + 128;
        out[c] = clamp255(k - (((t >> 8) + t) >> 8));
      } else {
        out[c] = (uint8_t)(k - (((255 - in[c]) * k) >> 8));
      }
    }
  }
}

// The decoded components, upsampled to the image's size and interleaved
// (h, w, number of components), before any colour conversion.
std::vector<uint8_t> components(Decoder& d) {
  const int W = d.width, H = d.height;
  const size_t np = (size_t)W * H, nc = d.comps.size();
  std::vector<uint8_t> out(np * nc);
  for (size_t k = 0; k < nc; ++k) {
    const Component& c = d.comps[k];
    const std::vector<uint8_t> p = component_plane(c);
    const std::vector<uint8_t> up =
        upsample(c, p.data(), W, H, d.max_h, d.max_v);
    for (size_t i = 0; i < np; ++i) out[i * nc + k] = up[i];
  }
  return out;
}

std::vector<uint8_t> decode(const uint8_t* data, size_t n, int reader,
                            int* h, int* w) {
  Decoder d(data, n);
  d.parse();
  if ((d.space == kCmyk || d.space == kYcck) && reader == kNoReader)
    throw Error(std::string("a ") + (d.space == kCmyk ? "CMYK" : "YCCK") +
                " JPEG: pass reader='cv2' or 'pil', the two libraries "
                "turn CMYK into RGB differently");
  std::vector<uint8_t> px = components(d);
  const size_t np = (size_t)d.width * d.height;
  std::vector<uint8_t> rgb(np * 3);
  if (d.space == kGrey) {
    for (size_t i = 0; i < np; ++i)
      rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = px[i];
  } else if (d.space == kRgb) {
    rgb.swap(px);
  } else if (d.space == kYcbcr) {
    for (size_t i = 0; i < np; ++i) {
      const int y = px[3 * i], cb = px[3 * i + 1], cr = px[3 * i + 2];
      rgb[3 * i] = clamp255(y + kYcc.cr_r[cr]);
      rgb[3 * i + 1] =
          clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      rgb[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
    }
  } else {
    if (d.space == kYcck) ycck_cmyk(px.data(), np, px.data());
    cmyk_rgb(px.data(), np, reader, rgb.data());
  }
  *h = d.height;
  *w = d.width;
  return rgb;
}

// The decoder's coefficients, for the tests and chip_smoke.py to hold to
// data/jpeg.py's coefficients_plain: int32 count of components, then for
// each its h, v, bw, bh and quantization table (64 int32, natural order),
// then each component's bh x bw blocks of 64 int16 coefficients (natural
// order), as the scans left them.
std::vector<uint8_t> coefficients(const uint8_t* data, size_t n) {
  Decoder d(data, n);
  d.parse();
  std::vector<int32_t> head{(int32_t)d.comps.size()};
  size_t ncoef = 0;
  for (const auto& c : d.comps) {
    head.insert(head.end(), {c.h, c.v, c.bw, c.bh});
    head.insert(head.end(), c.quant, c.quant + 64);
    ncoef += c.coef.size();
  }
  std::vector<uint8_t> out(head.size() * 4 + ncoef * 2);
  std::memcpy(out.data(), head.data(), head.size() * 4);
  uint8_t* p = out.data() + head.size() * 4;
  for (const auto& c : d.comps) {
    std::memcpy(p, c.coef.data(), c.coef.size() * 2);
    p += c.coef.size() * 2;
  }
  return out;
}

// ---------------------------------------------------------------- encoder

const unsigned kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const unsigned kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

HuffSpec spec_of(const uint8_t* bits, const uint8_t* vals) {
  HuffSpec s;
  std::memcpy(s.bits, bits, 17);
  for (int l = 1; l <= 16; ++l) s.count += bits[l];
  std::memcpy(s.vals, vals, s.count);
  s.defined = true;
  return s;
}

struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
};

HuffEnc encoder_of(const HuffSpec& s) {
  HuffEnc e;
  std::memset(e.size, 0, sizeof e.size);
  std::vector<uint16_t> code;
  std::vector<uint8_t> size;
  canonical_codes(s, code, size);
  for (int i = 0; i < s.count; ++i) {
    e.code[s.vals[i]] = code[i];
    e.size[s.vals[i]] = size[i];
  }
  return e;
}

// jcparam.c: jpeg_quality_scaling + jpeg_add_quant_table(force_baseline).
void quant_table(const unsigned* basic, int quality, int* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = ((long)basic[i] * scale + 50L) / 100L;
    if (t <= 0L) t = 1L;
    if (t > 32767L) t = 32767L;
    if (t > 255L) t = 255L;
    out[i] = (int)t;
  }
}

// jcdctmgr.c's compute_reciprocal with a 16-bit DCTELEM (a SIMD build),
// for the islow divisors (quantval << 3, never 1).
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(unsigned divisor) {
  Divisor d;
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t)((1ull << r) / divisor);
  const uint32_t fr = (uint32_t)((1ull << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  d.recip = fq & 0xFFFF;
  d.corr = c & 0xFFFF;
  d.shift = r - 16;
  return d;
}

// jfdctint.c's jpeg_fdct_islow, in place, 16-bit elements.
void fdct_islow(int16_t* data) {
  const int CB = 13, P1 = 2;
  for (int r = 0; r < 8; ++r) {
    int16_t* d = data + 8 * r;
    int64_t tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
    int64_t tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
    int64_t tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
    int64_t tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    d[0] = (int16_t)((t10 + t11) * (1 << P1));
    d[4] = (int16_t)((t10 - t11) * (1 << P1));
    int64_t z1 = (t12 + t13) * FIX_0_541196100;
    d[2] = (int16_t)descale(z1 + t13 * FIX_0_765366865, CB - P1);
    d[6] = (int16_t)descale(z1 + t12 * -FIX_1_847759065, CB - P1);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    d[7] = (int16_t)descale(tmp4 + z1 + z3, CB - P1);
    d[5] = (int16_t)descale(tmp5 + z2 + z4, CB - P1);
    d[3] = (int16_t)descale(tmp6 + z2 + z3, CB - P1);
    d[1] = (int16_t)descale(tmp7 + z1 + z4, CB - P1);
  }
  for (int c = 0; c < 8; ++c) {
    int16_t* d = data + c;
    int64_t tmp0 = d[0] + d[56], tmp7 = d[0] - d[56];
    int64_t tmp1 = d[8] + d[48], tmp6 = d[8] - d[48];
    int64_t tmp2 = d[16] + d[40], tmp5 = d[16] - d[40];
    int64_t tmp3 = d[24] + d[32], tmp4 = d[24] - d[32];
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    d[0] = (int16_t)descale(t10 + t11, P1);
    d[32] = (int16_t)descale(t10 - t11, P1);
    int64_t z1 = (t12 + t13) * FIX_0_541196100;
    d[16] = (int16_t)descale(z1 + t13 * FIX_0_765366865, CB + P1);
    d[48] = (int16_t)descale(z1 + t12 * -FIX_1_847759065, CB + P1);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    d[56] = (int16_t)descale(tmp4 + z1 + z3, CB + P1);
    d[40] = (int16_t)descale(tmp5 + z2 + z4, CB + P1);
    d[24] = (int16_t)descale(tmp6 + z2 + z3, CB + P1);
    d[8] = (int16_t)descale(tmp7 + z1 + z4, CB + P1);
  }
}

struct Writer {
  std::vector<uint8_t> out;
  uint64_t buf = 0;
  int bits = 0;
  void byte(int b) { out.push_back((uint8_t)b); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  void marker(int m) {
    byte(0xFF);
    byte(m);
  }
  void put(uint32_t code, int size) {
    if (!size) return;
    buf = (buf << size) | (code & ((1u << size) - 1));
    bits += size;
    while (bits >= 8) {
      const uint8_t b = (uint8_t)(buf >> (bits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      bits -= 8;
    }
  }
  void flush() {  // the partial byte filled with ones
    if (bits) put(0x7F, 8 - bits);
  }
};

struct EncComponent {
  int id, h, v, tbl;          // tbl: quantization and Huffman table
  int wib, hib;             // blocks holding samples
  int sw;                   // sample plane width (wib * 8)
  std::vector<uint8_t> s;   // samples, (hib*8 rows padded to iMCU) x sw
  int rows;                 // rows in s
  Divisor div[64];
  int dc_pred = 0;
};

void encode_block(Writer& w, const int16_t* coef, int& dc_pred,
                  const HuffEnc& dc, const HuffEnc& ac) {
  int temp = coef[0] - dc_pred, temp2 = temp;
  dc_pred = coef[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = 0;
  while (temp) {
    ++nbits;
    temp >>= 1;
  }
  if (nbits > 11) throw Error("DC coefficient out of range");
  w.put(dc.code[nbits], dc.size[nbits]);
  w.put((uint32_t)temp2, nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kNatural[k]];
    if (v == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      w.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    int t2 = v;
    if (v < 0) {
      v = -v;
      --t2;
    }
    nbits = 0;
    while (v) {
      ++nbits;
      v >>= 1;
    }
    if (nbits > 10) throw Error("AC coefficient out of range");
    const int i = (r << 4) + nbits;
    w.put(ac.code[i], ac.size[i]);
    w.put((uint32_t)t2, nbits);
    r = 0;
  }
  if (r > 0) w.put(ac.code[0], ac.size[0]);
}

void forward_block(const EncComponent& c, int by, int bx, int16_t* coef) {
  int16_t ws[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x)
      ws[8 * y + x] =
          (int16_t)(c.s[(size_t)(by * 8 + y) * c.sw + bx * 8 + x] - 128);
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    int t = ws[i];
    const Divisor& d = c.div[i];
    const bool neg = t < 0;
    if (neg) t = -t;
    uint32_t product = (uint32_t)(t + (int)d.corr) * d.recip;
    product >>= d.shift + 16;
    t = (int16_t)product;
    coef[i] = (int16_t)(neg ? -t : t);
  }
}

std::vector<uint8_t> encode(const uint8_t* img, int H, int W, int quality) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535)
    throw Error("image size out of JPEG's range");
  int qt[2][64];
  quant_table(kStdLuma, quality, qt[0]);
  quant_table(kStdChroma, quality, qt[1]);
  const int max_h = 2, max_v = 2, nc = 3;
  std::vector<EncComponent> comps;
  for (int ci = 0; ci < nc; ++ci) {
    EncComponent c;
    c.id = ci + 1;
    c.h = ci == 0 ? max_h : 1;
    c.v = ci == 0 ? max_v : 1;
    c.tbl = ci == 0 ? 0 : 1;
    c.wib = (int)(((int64_t)W * c.h + 8 * max_h - 1) / (8 * max_h));
    c.hib = (int)(((int64_t)H * c.v + 8 * max_v - 1) / (8 * max_v));
    c.sw = c.wib * 8;
    for (int i = 0; i < 64; ++i) c.div[i] = reciprocal(qt[c.tbl][i] << 3);
    comps.push_back(std::move(c));
  }
  const int mcus_per_row = (W + 8 * max_h - 1) / (8 * max_h);
  const int mcu_rows = (H + 8 * max_v - 1) / (8 * max_v);

  // Colour conversion (jccolor.c) into full-size planes.
  std::vector<std::vector<uint8_t>> full(nc,
                                         std::vector<uint8_t>((size_t)H * W));
  const int64_t half = (int64_t)1 << 15, cbcr = (int64_t)128 << 16;
  auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
  const int64_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
  const int64_t rcb = -fix(0.16874), gcb = -fix(0.33126), bcb = fix(0.5);
  const int64_t gcr = -fix(0.41869), bcr = -fix(0.08131);
  for (size_t i = 0; i < (size_t)H * W; ++i) {
    const int64_t r = img[3 * i], g = img[3 * i + 1], b = img[3 * i + 2];
    full[0][i] = (uint8_t)((ry * r + gy * g + by * b + half) >> 16);
    full[1][i] =
        (uint8_t)((rcb * r + gcb * g + bcb * b + cbcr + half - 1) >> 16);
    full[2][i] =
        (uint8_t)((bcb * r + gcr * g + bcr * b + cbcr + half - 1) >> 16);
  }

  // Downsampling with edge replication (jcprepct.c, jcsample.c), padded
  // at the bottom to whole iMCU rows.
  for (int ci = 0; ci < nc; ++ci) {
    EncComponent& c = comps[ci];
    c.rows = mcu_rows * c.v * 8;
    c.s.assign((size_t)c.rows * c.sw, 0);
    const uint8_t* f = full[ci].data();
    if (c.h == max_h && c.v == max_v) {
      for (int y = 0; y < c.rows; ++y) {
        const int sy = y < H ? y : H - 1;
        for (int x = 0; x < c.sw; ++x)
          c.s[(size_t)y * c.sw + x] = f[(size_t)sy * W + (x < W ? x : W - 1)];
      }
    } else {  // h2v2_downsample
      const int real = (H + 1) / 2;
      for (int y = 0; y < c.rows; ++y) {
        const int oy = y < real ? y : real - 1;
        const int r0 = 2 * oy, r1 = 2 * oy + 1 < H ? 2 * oy + 1 : H - 1;
        int bias = 1;
        for (int x = 0; x < c.sw; ++x) {
          const int c0 = 2 * x < W ? 2 * x : W - 1;
          const int c1 = 2 * x + 1 < W ? 2 * x + 1 : W - 1;
          c.s[(size_t)y * c.sw + x] =
              (uint8_t)((f[(size_t)r0 * W + c0] + f[(size_t)r0 * W + c1] +
                         f[(size_t)r1 * W + c0] + f[(size_t)r1 * W + c1] +
                         bias) >> 2);
          bias ^= 3;
        }
      }
    }
  }

  Writer w;
  w.out.reserve((size_t)H * W + 1024);
  w.marker(0xD8);
  // JFIF APP0 1.01, no units, density 1:1, no thumbnail.
  w.marker(0xE0);
  w.word(16);
  for (char ch : std::string("JFIF")) w.byte(ch);
  w.byte(0);
  w.byte(1);
  w.byte(1);
  w.byte(0);
  w.word(1);
  w.word(1);
  w.byte(0);
  w.byte(0);
  for (int t = 0; t < 2; ++t) {
    w.marker(0xDB);
    w.word(67);
    w.byte(t);
    for (int i = 0; i < 64; ++i) w.byte(qt[t][kNatural[i]]);
  }
  w.marker(0xC0);
  w.word(8 + 3 * nc);
  w.byte(8);
  w.word(H);
  w.word(W);
  w.byte(nc);
  for (auto& c : comps) {
    w.byte(c.id);
    w.byte((c.h << 4) | c.v);
    w.byte(c.tbl);
  }
  const HuffSpec specs[2][2] = {
      {spec_of(kDcLumaBits, kDcVals), spec_of(kAcLumaBits, kAcLumaVals)},
      {spec_of(kDcChromaBits, kDcVals),
       spec_of(kAcChromaBits, kAcChromaVals)}};
  for (int t = 0; t < 2; ++t)
    for (int k = 0; k < 2; ++k) {
      const HuffSpec& s = specs[t][k];
      w.marker(0xC4);
      w.word(2 + 1 + 16 + s.count);
      w.byte(t | (k << 4));
      for (int l = 1; l <= 16; ++l) w.byte(s.bits[l]);
      for (int i = 0; i < s.count; ++i) w.byte(s.vals[i]);
    }
  w.marker(0xDA);
  w.word(6 + 2 * nc);
  w.byte(nc);
  for (auto& c : comps) {
    w.byte(c.id);
    w.byte((c.tbl << 4) | c.tbl);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  const HuffEnc enc[2][2] = {
      {encoder_of(specs[0][0]), encoder_of(specs[0][1])},
      {encoder_of(specs[1][0]), encoder_of(specs[1][1])}};
  int16_t blocks[10][64];
  for (int my = 0; my < mcu_rows; ++my)
    for (int mx = 0; mx < mcus_per_row; ++mx) {
      int blkn = 0;
      for (auto& c : comps) {
        const int last_col = c.wib % c.h ? c.wib % c.h : c.h;
        const int last_row = c.hib % c.v ? c.hib % c.v : c.v;
        const int blockcnt = mx < mcus_per_row - 1 ? c.h : last_col;
        for (int y = 0; y < c.v; ++y) {
          if (my < mcu_rows - 1 || y < last_row) {
            for (int x = 0; x < blockcnt; ++x)
              forward_block(c, my * c.v + y, mx * c.h + x,
                            blocks[blkn + x]);
            for (int x = blockcnt; x < c.h; ++x) {  // right-edge dummy
              std::memset(blocks[blkn + x], 0, sizeof blocks[0]);
              blocks[blkn + x][0] = blocks[blkn + x - 1][0];
            }
          } else {  // a row of dummy blocks at the bottom
            for (int x = 0; x < c.h; ++x) {
              std::memset(blocks[blkn + x], 0, sizeof blocks[0]);
              blocks[blkn + x][0] = blocks[blkn - 1][0];
            }
          }
          blkn += c.h;
        }
      }
      blkn = 0;
      for (auto& c : comps)
        for (int b = 0; b < c.h * c.v; ++b, ++blkn)
          encode_block(w, blocks[blkn], c.dc_pred, enc[c.tbl][0],
                       enc[c.tbl][1]);
    }
  w.flush();
  w.marker(0xD9);
  return w.out;
}

void set_error(const char* msg, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, (size_t)errlen - 1);
    err[errlen - 1] = 0;
  }
}

uint8_t* to_malloc(const std::vector<uint8_t>& v) {
  uint8_t* p = (uint8_t*)std::malloc(v.size() ? v.size() : 1);
  if (!p) throw Error("out of memory");
  std::memcpy(p, v.data(), v.size());
  return p;
}

}  // namespace

extern "C" {

// Decode `n` bytes to a malloc'd (h, w, 3) RGB buffer (free it with
// hj_free), a four-component file as `reader` (kPil or kCv2) converts it;
// NULL on failure with the reason in `err`.
uint8_t* hj_decode(const uint8_t* data, size_t n, int reader, int* h, int* w,
                   char* err, int errlen) {
  try {
    return to_malloc(decode(data, n, reader, h, w));
  } catch (const std::exception& e) {
    set_error(e.what(), err, errlen);
    return nullptr;
  }
}

// The upsampled components before colour conversion (see `components`) as
// a malloc'd (h, w, nc) buffer, with the frame's colour space (kGrey ...
// kYcck) in `space`; NULL on failure with the reason in `err`.
uint8_t* hj_components(const uint8_t* data, size_t n, int* h, int* w,
                       int* nc, int* space, char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.parse();
    *h = d.height;
    *w = d.width;
    *nc = (int)d.comps.size();
    *space = d.space;
    return to_malloc(components(d));
  } catch (const std::exception& e) {
    set_error(e.what(), err, errlen);
    return nullptr;
  }
}

// The coefficients (see `coefficients`) as malloc'd bytes, their count in
// `size`; NULL on failure with the reason in `err`.
uint8_t* hj_coefficients(const uint8_t* data, size_t n, size_t* size,
                         char* err, int errlen) {
  try {
    const std::vector<uint8_t> out = coefficients(data, n);
    *size = out.size();
    return to_malloc(out);
  } catch (const std::exception& e) {
    set_error(e.what(), err, errlen);
    return nullptr;
  }
}

// Encode an (h, w, 3) uint8 RGB image at `quality`; the malloc'd bytes
// and their count in `size`, or NULL.
uint8_t* hj_encode(const uint8_t* img, int h, int w, int quality,
                   size_t* size, char* err, int errlen) {
  try {
    const std::vector<uint8_t> out = encode(img, h, w, quality);
    *size = out.size();
    return to_malloc(out);
  } catch (const std::exception& e) {
    set_error(e.what(), err, errlen);
    return nullptr;
  }
}

// The two colour steps alone, on `np` pixels: YCCK -> CMYK (4 bytes a
// pixel in and out) and CMYK -> RGB by `reader` (4 in, 3 out).
void hj_ycck_cmyk(const uint8_t* in, size_t np, uint8_t* out) {
  ycck_cmyk(in, np, out);
}
void hj_cmyk_rgb(const uint8_t* in, size_t np, int reader, uint8_t* out) {
  cmyk_rgb(in, np, reader, out);
}

void hj_free(void* p) { std::free(p); }

}  // extern "C"
