// Host codecs of the TF-free TFDS reader (`rt1_tpu_torch/data/codecs.py`):
// CRC32C for TFRecord framing, and a baseline JPEG decoder that computes
// what `tf.io.decode_jpeg` computes by default.
//
// TensorFlow decodes with libjpeg-turbo, `dct_method` "" (JDCT_IFAST) and
// `fancy_upscaling` true. On x86-64 its build runs libjpeg-turbo's SSE2
// code, so this decoder follows those routines step by step:
//
// * dequantisation by the IFAST multiplier table (`jddctmgr.c`: quantval x
//   the AA&N scale, 14 bits, rounded down to IFAST_SCALE_BITS = 2);
// * the AA&N inverse DCT of `jidctfst.c` in 16-bit lanes as
//   `jidctfst-sse2.asm` computes it: every sum wraps at 16 bits, and
//   MULTIPLY(x, c) is pmulhw(x << 2, c << 6), which equals the C code's
//   (x * c) >> 8 and takes -2.613 as (x * -1.613 >> 8) - x;
// * the final descale, a plain arithmetic shift by 5, saturated to a
//   signed byte and re-centred on 128;
// * fancy (triangle) upsampling (`jdsample.c`): h2v1 and h2v2 with the
//   edge rows and columns replicated, box upsampling where a component is
//   2 samples wide or less;
// * the table-based YCbCr -> RGB of `jdcolor.c` (16-bit fixed point).
//
// Baseline and extended sequential Huffman scans (SOF0 / SOF1), 8-bit
// samples, 1 or 3 components, sampling 4:4:4, 4:2:2 and 4:2:0, restart
// markers, interleaved or not. Progressive, lossless, hierarchical and
// arithmetic-coded files are refused with the reason.
//
// Plain C interface, no Python headers; built with g++ and bound with
// ctypes. Every entry point returns 0 on success, else writes a message
// into `err` and returns a negative code.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- CRC32C

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (int s = 1; s < 8; s++)
      for (uint32_t i = 0; i < 256; i++) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTable kCrc;

uint32_t crc32c_update(uint32_t crc, const uint8_t* p, size_t n) {
  crc = ~crc;
  while (n >= 8) {
    uint32_t lo = crc ^ (uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
                         uint32_t(p[3]) << 24);
    crc = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF] ^ kCrc.t[5][(lo >> 16) & 0xFF] ^
          kCrc.t[4][lo >> 24] ^ kCrc.t[3][p[4]] ^ kCrc.t[2][p[5]] ^ kCrc.t[1][p[6]] ^
          kCrc.t[0][p[7]];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kCrc.t[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

// ------------------------------------------------------------------ JPEG

struct Error {
  std::string msg;
};

const int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                         12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                         35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                         58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jddctmgr.c's aanscales: cos(k pi / 16) sqrt(2) products, scaled by 2^14.
const int kAanScales[64] = {
    16384, 22725, 21407, 19266, 16384, 12873, 8867,  4520,  22725, 31521, 29692, 26722, 22725,
    17855, 12299, 6270,  21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,  19266, 26722,
    25172, 22654, 19266, 15137, 10426, 5315,  16384, 22725, 21407, 19266, 16384, 12873, 8867,
    4520,  12873, 17855, 16819, 15137, 12873, 10114, 6967,  3552,  8867,  12299, 11585, 10426,
    8867,  6967,  4799,  2446,  4520,  6270,  5906,  5315,  4520,  3552,  2446,  1247};

struct Huffman {
  bool defined = false;
  // Codes of each length (1-16): the canonical decoding tables of JPEG's
  // Annex F.2.2.3, and a 9-bit direct lookup for the short codes.
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t values[256];
  int16_t look_len[512];  // 0: longer than 9 bits
  uint8_t look_val[512];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;            // blocks allocated (whole MCUs)
  int dw = 0, dh = 0;            // downsampled width / height (samples)
  std::vector<int16_t> coef;     // bh * bw blocks of 64, natural order
  std::vector<uint8_t> plane;    // (bh * 8) x (bw * 8) samples
  int dc_pred = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool frame = false, adobe = false, jfif = false;
  int adobe_transform = -1;
  int scans = 0;
  // Bit reader state.
  uint32_t bits = 0;
  int nbits = 0;
  bool hit_marker = false;

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  [[noreturn]] void fail(const std::string& m) { throw Error{m}; }

  int u8() {
    if (pos >= size) fail("truncated JPEG");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  void build_huffman(Huffman& t, const uint8_t counts[16], const uint8_t* vals, int nvals) {
    t.defined = true;
    memcpy(t.values, vals, nvals);
    int code = 0, k = 0;
    for (int i = 0; i < 512; i++) t.look_len[i] = 0;
    for (int len = 1; len <= 16; len++) {
      int n = counts[len - 1];
      if (n) {
        t.valoffset[len] = k - code;
        for (int i = 0; i < n; i++, k++, code++) {
          if (len <= 9) {
            int shift = 9 - len;
            for (int j = 0; j < (1 << shift); j++) {
              t.look_len[(code << shift) | j] = len;
              t.look_val[(code << shift) | j] = vals[k];
            }
          }
        }
        t.maxcode[len] = code - 1;
      } else {
        t.maxcode[len] = -1;
      }
      if (code > (1 << len)) fail("bad Huffman table");
      code <<= 1;
    }
    t.maxcode[17] = 0x7FFFFFFF;
  }

  void read_dht(int len) {
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT table id");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; i++) total += (counts[i] = u8());
      if (total > 256) fail("bad DHT counts");
      uint8_t vals[256];
      for (int i = 0; i < total; i++) vals[i] = u8();
      build_huffman(tc ? ac[th] : dc[th], counts, vals, total);
    }
    if (pos != end) fail("bad DHT length");
  }

  void read_dqt(int len) {
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("bad DQT table id");
      if (pq != 0) fail("16-bit quantisation tables are not supported (12-bit JPEG)");
      for (int i = 0; i < 64; i++) qt[tq][kZigzag[i]] = u8();
      qt_defined[tq] = true;
    }
    if (pos != end) fail("bad DQT length");
  }

  void read_sof(int len) {
    if (frame) fail("more than one frame header");
    frame = true;
    int precision = u8();
    if (precision != 8) fail("only 8-bit samples are supported");
    height = u16();
    width = u16();
    int n = u8();
    if (height == 0) fail("a height of 0 (DNL marker) is not supported");
    if (width == 0) fail("a width of 0");
    if (n != 1 && n != 3) fail("only 1 or 3 components are supported, got " + std::to_string(n));
    if (len != 8 + 3 * n) fail("bad SOF length");
    comps.resize(n);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad component");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (auto& c : comps) {
      int rh = hmax / c.h, rv = vmax / c.v;
      bool ok = hmax % c.h == 0 && vmax % c.v == 0 &&
                ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) || (rh == 2 && rv == 2));
      if (!ok)
        fail("unsupported chroma sampling (4:4:4, 4:2:2 and 4:2:0 are supported)");
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
  }

  // -- entropy decoding
  void fill() {
    while (nbits <= 24) {
      int b = 0;
      if (!hit_marker && pos < size) {
        b = data[pos];
        if (b == 0xFF) {
          int next = pos + 1 < size ? data[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;  // a marker: feed zeros as libjpeg does
            b = 0;
          }
        } else {
          pos++;
        }
      }
      bits |= uint32_t(b) << (24 - nbits);
      nbits += 8;
    }
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = int(bits >> (32 - n));
    bits <<= n;
    nbits -= n;
    return v;
  }

  int decode_huffman(const Huffman& t) {
    if (nbits < 16) fill();
    int look = int(bits >> 23);
    int len = t.look_len[look];
    if (len) {
      bits <<= len;
      nbits -= len;
      return t.look_val[look];
    }
    int code = int(bits >> 22);
    len = 10;
    while (code > t.maxcode[len]) {
      len++;
      if (len > 16) fail("corrupt JPEG data: bad Huffman code");
      code = int(bits >> (32 - len));
    }
    bits <<= len;
    nbits -= len;
    return t.values[t.valoffset[len] + code];
  }

  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  void decode_block(Component& c, int16_t* blk) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = decode_huffman(hd);
    if (s > 16) fail("corrupt JPEG data: bad DC size");
    int diff = s ? extend(get_bits(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = int16_t(c.dc_pred);
    for (int k = 1; k < 64;) {
      int rs = decode_huffman(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt JPEG data: coefficient index past 63");
        blk[kZigzag[k]] = int16_t(extend(get_bits(s), s));
        k++;
      } else {
        if (r != 15) break;  // EOB
        k += 16;
      }
    }
  }

  void reset_bits() {
    bits = 0;
    nbits = 0;
    hit_marker = false;
  }

  void restart() {
    // Skip to the RSTn marker; libjpeg tolerates a missing one, so do we.
    reset_bits();
    while (pos + 1 < size && !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)) {
      if (data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF) break;
      pos++;
    }
    if (pos + 1 < size && data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)
      pos += 2;
    for (auto& c : comps) c.dc_pred = 0;
  }

  void read_sos(int len) {
    if (!frame) fail("scan before the frame header");
    int n = u8();
    if (n < 1 || n > int(comps.size()) || len != 6 + 2 * n) fail("bad SOS");
    std::vector<Component*> sc;
    for (int i = 0; i < n; i++) {
      int id = u8(), tables = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("scan names an unknown component");
      found->td = tables >> 4;
      found->ta = tables & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].defined || !ac[found->ta].defined)
        fail("scan uses an undefined Huffman table");
      sc.push_back(found);
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) fail("not a sequential scan");
    scans++;
    reset_bits();
    for (auto* c : sc) c->dc_pred = 0;
    int mcus_x, mcus_y;
    if (n == 1) {
      mcus_x = (sc[0]->dw + 7) / 8;
      mcus_y = (sc[0]->dh + 7) / 8;
    } else {
      mcus_x = mcux;
      mcus_y = mcuy;
    }
    int done = 0;
    for (int my = 0; my < mcus_y; my++) {
      for (int mx = 0; mx < mcus_x; mx++) {
        if (restart_interval && done && done % restart_interval == 0) restart();
        if (n == 1) {
          Component& c = *sc[0];
          decode_block(c, &c.coef[(size_t(my) * c.bw + mx) * 64]);
        } else {
          for (auto* cp : sc) {
            Component& c = *cp;
            for (int by = 0; by < c.v; by++)
              for (int bx = 0; bx < c.h; bx++) {
                int row = my * c.v + by, col = mx * c.h + bx;
                decode_block(c, &c.coef[(size_t(row) * c.bw + col) * 64]);
              }
          }
        }
        done++;
      }
    }
    // Leave pos at the next marker.
    reset_bits();
    while (pos + 1 < size && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                               !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
      pos++;
  }

  // headers_only: stop after the frame header.
  void parse(bool headers_only) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG (no SOI marker)");
    pos = 2;
    for (;;) {
      int b = u8();
      if (b != 0xFF) fail("corrupt JPEG data: expected a marker");
      int m = u8();
      while (m == 0xFF) m = u8();
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;
      if (m == 0x01) continue;
      int len = u16();
      if (len < 2 || pos + len - 2 > size) fail("truncated JPEG segment");
      size_t next = pos + len - 2;
      switch (m) {
        case 0xC0:
        case 0xC1:
          read_sof(len);
          if (headers_only) return;
          break;
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
          fail("progressive JPEG is not supported");
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          fail("lossless JPEG is not supported");
        case 0xC5:
          fail("hierarchical JPEG is not supported");
        case 0xC9:
        case 0xCD:
          fail("arithmetic-coded JPEG is not supported");
        case 0xC4:
          read_dht(len);
          break;
        case 0xCC:
          fail("arithmetic-coded JPEG is not supported");
        case 0xDB:
          read_dqt(len);
          break;
        case 0xDD:
          restart_interval = u16();
          break;
        case 0xDA:
          read_sos(len);
          continue;  // pos is at the next marker
        case 0xE0:
          if (len >= 7 && memcmp(data + pos, "JFIF", 4) == 0) jfif = true;
          break;
        case 0xEE:
          if (len >= 14 && memcmp(data + pos, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = data[pos + 11];
          }
          break;
        default:
          break;
      }
      pos = next;
    }
    if (!frame || scans == 0) fail("JPEG has no image data");
    for (auto& c : comps)
      if (!qt_defined[c.tq]) fail("component uses an undefined quantisation table");
  }

  // -- inverse DCT: jidctfst-sse2.asm's 16-bit lanes
  static inline int16_t w16(int x) { return int16_t(x); }
  static inline int16_t mul(int16_t x, int c) {
    return int16_t((int32_t(int16_t(x << 2)) * c) >> 16);
  }
  enum : int {
    F1414 = 362 << 6,
    F1847 = 473 << 6,
    F1082 = 277 << 6,
    MF1613 = -((669 - 256) << 6),
  };

  static void idct_1d(int16_t* p, int stride) {
    int16_t in0 = p[0], in1 = p[stride], in2 = p[2 * stride], in3 = p[3 * stride];
    int16_t in4 = p[4 * stride], in5 = p[5 * stride], in6 = p[6 * stride], in7 = p[7 * stride];
    // Even part.
    int16_t tmp10 = w16(in0 + in4), tmp11 = w16(in0 - in4);
    int16_t tmp13 = w16(in2 + in6);
    int16_t tmp12 = w16(mul(w16(in2 - in6), F1414) - tmp13);
    int16_t tmp0 = w16(tmp10 + tmp13), tmp3 = w16(tmp10 - tmp13);
    int16_t tmp1 = w16(tmp11 + tmp12), tmp2 = w16(tmp11 - tmp12);
    // Odd part.
    int16_t z13 = w16(in5 + in3), z10 = w16(in5 - in3);
    int16_t z11 = w16(in1 + in7), z12 = w16(in1 - in7);
    int16_t tmp7 = w16(z11 + z13);
    int16_t t11 = mul(w16(z11 - z13), F1414);
    int16_t z5 = mul(w16(z10 + z12), F1847);
    int16_t t10 = w16(mul(z12, F1082) - z5);
    int16_t t12 = w16(w16(mul(z10, MF1613) - z10) + z5);
    int16_t tmp6 = w16(t12 - tmp7);
    int16_t tmp5 = w16(t11 - tmp6);
    int16_t tmp4 = w16(t10 + tmp5);
    p[0] = w16(tmp0 + tmp7);
    p[7 * stride] = w16(tmp0 - tmp7);
    p[stride] = w16(tmp1 + tmp6);
    p[6 * stride] = w16(tmp1 - tmp6);
    p[2 * stride] = w16(tmp2 + tmp5);
    p[5 * stride] = w16(tmp2 - tmp5);
    p[4 * stride] = w16(tmp3 + tmp4);
    p[3 * stride] = w16(tmp3 - tmp4);
  }

  static void idct_ifast(const int16_t* coef, const int16_t* mult, uint8_t* out, int stride) {
    int16_t ws[64];
    for (int i = 0; i < 64; i++) ws[i] = w16(int(coef[i]) * mult[i]);
    for (int c = 0; c < 8; c++) idct_1d(ws + c, 8);  // pass 1: columns
    for (int r = 0; r < 8; r++) idct_1d(ws + 8 * r, 1);  // pass 2: rows
    for (int r = 0; r < 8; r++)
      for (int c = 0; c < 8; c++) {
        int v = ws[8 * r + c] >> 5;
        v = v < -128 ? -128 : (v > 127 ? 127 : v);
        out[r * stride + c] = uint8_t(v + 128);
      }
  }

  void inverse_dct() {
    for (auto& c : comps) {
      int16_t mult[64];
      for (int i = 0; i < 64; i++)
        mult[i] = int16_t((int32_t(qt[c.tq][i]) * kAanScales[i] + (1 << 11)) >> 12);
      int pw = c.bw * 8;
      c.plane.assign(size_t(pw) * c.bh * 8, 0);
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct_ifast(&c.coef[(size_t(by) * c.bw + bx) * 64], mult,
                     &c.plane[size_t(by) * 8 * pw + bx * 8], pw);
      std::vector<int16_t>().swap(c.coef);
    }
  }

  // -- upsampling to the full-size grid, (height x width) of uint8
  std::vector<uint8_t> upsample(const Component& c) {
    int pw = c.bw * 8;
    int rh = hmax / c.h, rv = vmax / c.v;
    std::vector<uint8_t> out(size_t(width) * height);
    auto at = [&](int row, int col) -> int { return c.plane[size_t(row) * pw + col]; };
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < height; y++) memcpy(&out[size_t(y) * width], &c.plane[size_t(y) * pw], width);
      return out;
    }
    int dw = c.dw, dh = c.dh;
    std::vector<uint8_t> row(size_t(2) * dw + 2);
    bool fancy = dw > 2;
    if (rv == 1) {  // h2v1
      for (int y = 0; y < height; y++) {
        if (fancy) {
          row[0] = uint8_t(at(y, 0));
          row[1] = uint8_t((at(y, 0) * 3 + at(y, 1) + 2) >> 2);
          for (int x = 1; x < dw - 1; x++) {
            int v = at(y, x) * 3;
            row[2 * x] = uint8_t((v + at(y, x - 1) + 1) >> 2);
            row[2 * x + 1] = uint8_t((v + at(y, x + 1) + 2) >> 2);
          }
          int v = at(y, dw - 1);
          row[2 * dw - 2] = uint8_t((v * 3 + at(y, dw - 2) + 1) >> 2);
          row[2 * dw - 1] = uint8_t(v);
        } else {
          for (int x = 0; x < dw; x++) row[2 * x] = row[2 * x + 1] = uint8_t(at(y, x));
        }
        memcpy(&out[size_t(y) * width], row.data(), width);
      }
      return out;
    }
    // h2v2
    for (int y = 0; y < height; y++) {
      int in = y >> 1;
      if (!fancy) {
        for (int x = 0; x < dw; x++) row[2 * x] = row[2 * x + 1] = uint8_t(at(in, x));
        memcpy(&out[size_t(y) * width], row.data(), width);
        continue;
      }
      int other = (y & 1) ? (in + 1 < dh ? in + 1 : dh - 1) : (in > 0 ? in - 1 : 0);
      auto colsum = [&](int x) { return at(in, x) * 3 + at(other, x); };
      int this_s = colsum(0), next_s = colsum(1), last_s;
      row[0] = uint8_t((this_s * 4 + 8) >> 4);
      row[1] = uint8_t((this_s * 3 + next_s + 7) >> 4);
      last_s = this_s;
      this_s = next_s;
      for (int x = 1; x < dw - 1; x++) {
        next_s = colsum(x + 1);
        row[2 * x] = uint8_t((this_s * 3 + last_s + 8) >> 4);
        row[2 * x + 1] = uint8_t((this_s * 3 + next_s + 7) >> 4);
        last_s = this_s;
        this_s = next_s;
      }
      row[2 * dw - 2] = uint8_t((this_s * 3 + last_s + 8) >> 4);
      row[2 * dw - 1] = uint8_t((this_s * 4 + 7) >> 4);
      memcpy(&out[size_t(y) * width], row.data(), width);
    }
    return out;
  }

  bool is_rgb_stored() const {
    if (comps.size() != 3) return false;
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }

  void write(uint8_t* out, int channels) {
    inverse_dct();
    size_t n = size_t(width) * height;
    if (comps.size() == 1) {
      std::vector<uint8_t> g = upsample(comps[0]);
      if (channels == 1) {
        memcpy(out, g.data(), n);
      } else {
        for (size_t i = 0; i < n; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
      }
      return;
    }
    if (channels == 1 && !is_rgb_stored()) {  // jdcolor.c grayscale_convert: Y alone
      std::vector<uint8_t> y = upsample(comps[0]);
      memcpy(out, y.data(), n);
      return;
    }
    std::vector<uint8_t> p0 = upsample(comps[0]), p1 = upsample(comps[1]), p2 = upsample(comps[2]);
    if (is_rgb_stored()) {
      for (size_t i = 0; i < n; i++) {
        if (channels == 1) {
          // jdcolor.c rgb_gray_convert: the YCbCr luma weights, 16-bit.
          out[i] = uint8_t((19595 * p0[i] + 38470 * p1[i] + 7471 * p2[i] + 32768) >> 16);
        } else {
          out[3 * i] = p0[i];
          out[3 * i + 1] = p1[i];
          out[3 * i + 2] = p2[i];
        }
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table + ycc_rgb_convert.
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = int((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < n; i++) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

int report(const std::string& m, char* err, int errlen) {
  if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", m.c_str());
  return -1;
}

}  // namespace

extern "C" {

uint32_t rt_crc32c(const uint8_t* data, size_t n, uint32_t crc) {
  return crc32c_update(crc, data, n);
}

// Parse the headers up to the frame header: height, width and components.
int rt_jpeg_info(const uint8_t* data, size_t n, int* height, int* width, int* components,
                 char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.parse(true);
    *height = d.height;
    *width = d.width;
    *components = int(d.comps.size());
    return 0;
  } catch (const Error& e) {
    return report(e.msg, err, errlen);
  } catch (const std::bad_alloc&) {
    return report("out of memory", err, errlen);
  }
}

// Decode into out (height x width x channels, uint8); channels 1 or 3.
int rt_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, int height, int width,
                   int channels, char* err, int errlen) {
  try {
    if (channels != 1 && channels != 3) return report("channels must be 1 or 3", err, errlen);
    Decoder d(data, n);
    d.parse(false);
    if (d.height != height || d.width != width)
      return report("output shape does not match the frame", err, errlen);
    d.write(out, channels);
    return 0;
  } catch (const Error& e) {
    return report(e.msg, err, errlen);
  } catch (const std::bad_alloc&) {
    return report("out of memory", err, errlen);
  }
}

}  // extern "C"
