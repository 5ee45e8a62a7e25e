// The port's JPEG codec and Pillow-exact resampling, host C++ with a plain C
// interface (loaded by ctypes from cxrmate_torch/data/native/__init__.py).
//
// Decode: baseline sequential Huffman, 8-bit, DRI/RST restarts, one component
// or three (JFIF YCbCr) at 4:4:4, 4:2:2 or 4:2:0, with libjpeg(-turbo)'s
// default output: the ISLOW integer IDCT (jidctint.c jpeg_idct_islow with its
// range-limit table), fancy upsampling (jdsample.c h2v1_fancy_upsample,
// h2v2_fancy_upsample) and the jdcolor.c ycc_rgb_convert tables. Anything
// else (progressive, arithmetic coding, 12-bit, Adobe RGB, CMYK, a truncated
// or corrupt stream) is refused with a message naming it.
//
// Encode: baseline gray or RGB (4:2:0) with libjpeg's defaults: the standard
// quantisation tables scaled as jpeg_quality_scaling, the ISLOW forward DCT
// (jfdctint.c), the standard Huffman tables, optionally a restart interval.
//
// Resample: Pillow's src/libImaging/Resample.c bilinear (support 1 scaled by
// the downscale factor, coefficients in fixed point with PRECISION_BITS 22,
// horizontal then vertical pass) and Geometry.c's nearest-neighbour affine
// transform, which Image.rotate uses.
//
// Every entry returns 0 on success or non-zero with a message in ``err``.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, errlen, "%s", msg.c_str());
  }
}

// zigzag position -> natural (row-major) position, with libjpeg's 16 extra
// entries that keep a corrupt run inside the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------------ IDCT
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

struct RangeLimit {
  uint8_t t[1024];  // jdmaster.c prepare_range_limit_table, seen from the IDCT
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      int x = (i < 512 ? i : i - 1024) + 128;
      t[i] = (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
    }
  }
};
const RangeLimit kRange;

struct YccTables {  // jdcolor.c build_ycc_rgb_table
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t ONE_HALF = (int64_t)1 << 15;
    auto FIX = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> 16);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> 16);
      cr_g[i] = (-FIX(0.71414)) * x;
      cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
  }
};
const YccTables kYcc;

// jidctint.c jpeg_idct_islow: coef in natural order, q the dequantisation
// table in natural order; writes 8 rows of 8 samples at out (stride bytes).
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int dc = (int)(((int64_t)in[0] * qt[0]) * (1 << PASS1_BITS));
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * qt[16], z3 = (int64_t)in[48] * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qt[0];
    z3 = (int64_t)in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qt[56];
    tmp1 = (int64_t)in[40] * qt[40];
    tmp2 = (int64_t)in[24] * qt[24];
    tmp3 = (int64_t)in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    w[0] = (int)descale(tmp10 + tmp3, n);
    w[56] = (int)descale(tmp10 - tmp3, n);
    w[8] = (int)descale(tmp11 + tmp2, n);
    w[48] = (int)descale(tmp11 - tmp2, n);
    w[16] = (int)descale(tmp12 + tmp1, n);
    w[40] = (int)descale(tmp12 - tmp1, n);
    w[24] = (int)descale(tmp13 + tmp0, n);
    w[32] = (int)descale(tmp13 - tmp0, n);
  }
  const uint8_t* rl = kRange.t;
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t v = rl[(int)descale(w[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; c++) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    o[0] = rl[(int)descale(tmp10 + tmp3, n) & 1023];
    o[7] = rl[(int)descale(tmp10 - tmp3, n) & 1023];
    o[1] = rl[(int)descale(tmp11 + tmp2, n) & 1023];
    o[6] = rl[(int)descale(tmp11 - tmp2, n) & 1023];
    o[2] = rl[(int)descale(tmp12 + tmp1, n) & 1023];
    o[5] = rl[(int)descale(tmp12 - tmp1, n) & 1023];
    o[3] = rl[(int)descale(tmp13 + tmp0, n) & 1023];
    o[4] = rl[(int)descale(tmp13 - tmp0, n) & 1023];
  }
}

// ------------------------------------------------------------- decoder
struct Huffman {
  bool defined = false;
  uint8_t look_len[512];  // 9-bit lookahead: code length, 0 = longer code
  uint8_t look_val[512];
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t vals[256];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    std::memset(look_len, 0, sizeof(look_len));
    std::memcpy(vals, symbols, nsym);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      // libjpeg's jpeg_make_d_derived_tbl check (no code of l bits may be all
      // ones), made before the lookahead writes so that they stay in bounds
      if (code + counts[l - 1] >= (1 << l)) fail("corrupt Huffman table (bad code lengths)");
      valoffset[l] = k - code;
      for (int i = 0; i < counts[l - 1]; i++, k++, code++) {
        if (l <= 9) {
          int shift = 9 - l;
          for (int j = 0; j < (1 << shift); j++) {
            look_len[(code << shift) | j] = (uint8_t)l;
            look_val[(code << shift) | j] = symbols[k];
          }
        }
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id, h, v, tq;
  int dc_tbl = 0, ac_tbl = 0;
  int width, height;      // downsampled size (ceil)
  int bw, bh;             // blocks of the interleaved MCU grid
  int stride;             // bw * 8
  std::vector<uint8_t> plane;
  int dc_pred = 0;
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : p_(data), n_(n) {}

  int width = 0, height = 0, ncomp = 0;

  void read_header() {
    if (n_ < 4 || p_[0] != 0xFF || p_[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xDA) {  // SOS: the first scan
        if (!frame_) fail("scan before frame header");
        sos_pos_ = pos_;
        return;
      }
      handle_segment(m);
    }
  }

  void decode(uint8_t* out) {
    pos_ = sos_pos_;
    bool first = true;
    for (;;) {
      if (!first) {
        int m = next_marker();
        if (m == 0xD9) break;
        if (m != 0xDA) {
          handle_segment(m);
          continue;
        }
      }
      first = false;
      decode_scan();
      if (done_all()) {
        break;
      }
    }
    if (!done_all()) fail("truncated file: image data ends before the last block");
    output(out);
  }

 private:
  const uint8_t* p_;
  size_t n_;
  size_t pos_ = 0, sos_pos_ = 0;
  bool frame_ = false, jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  Component comp_[3];
  std::vector<uint8_t> decoded_;  // per component: whether a scan has decoded it

  // bit reader
  uint64_t acc_ = 0;
  int cnt_ = 0;
  int padded_ = 0;  // zero bits appended past a marker or the end of data
  bool hit_marker_ = false;

  uint8_t byte() {
    if (pos_ >= n_) fail("truncated file: unexpected end of data");
    return p_[pos_++];
  }
  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }

  int next_marker() {
    // skip to 0xFF, then past fill bytes
    int c = byte();
    while (c != 0xFF) c = byte();
    do {
      c = byte();
    } while (c == 0xFF);
    return c;
  }

  void handle_segment(int m) {
    if (m == 0xC0 || m == 0xC1) return read_sof();
    if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) fail("progressive JPEG is not supported");
    if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) fail("lossless JPEG is not supported");
    if (m == 0xC5) fail("hierarchical JPEG is not supported");
    if (m == 0xC9 || m == 0xCC || m == 0xCD) fail("arithmetic-coded JPEG is not supported");
    if (m == 0xC4) return read_dht();
    if (m == 0xDB) return read_dqt();
    if (m == 0xDD) {
      int len = u16();
      if (len != 4) fail("corrupt DRI segment");
      restart_interval_ = u16();
      return;
    }
    if (m == 0xD9) fail("truncated file: EOI before the image data");
    if (m >= 0xD0 && m <= 0xD7) fail("corrupt data: restart marker outside a scan");
    if (m == 0x01) return;  // TEM, no length
    int len = u16();
    if (len < 2 || pos_ + len - 2 > n_) fail("truncated file: marker segment cut");
    const uint8_t* s = p_ + pos_;
    if (m == 0xE0 && len >= 7 && std::memcmp(s, "JFIF\0", 5) == 0) jfif_ = true;
    if (m == 0xEE && len >= 14 && std::memcmp(s, "Adobe", 5) == 0) {
      adobe_ = true;
      adobe_transform_ = s[11];
    }
    pos_ += len - 2;
  }

  void read_sof() {
    if (frame_) fail("corrupt data: two frame headers");
    int len = u16();
    int precision = byte();
    if (precision != 8) fail(std::to_string(precision) + "-bit JPEG is not supported");
    height = u16();
    width = u16();
    ncomp = byte();
    if (height == 0) fail("JPEG with DNL-defined height is not supported");
    if (width == 0) fail("corrupt frame header (zero width)");
    if (ncomp == 4) fail("CMYK/YCCK JPEG (4 components) is not supported");
    if (ncomp != 1 && ncomp != 3) fail(std::to_string(ncomp) + "-component JPEG is not supported");
    if (len != 8 + 3 * ncomp) fail("corrupt frame header");
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp_[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("corrupt frame header");
    }
    hmax_ = vmax_ = 1;
    for (int i = 0; i < ncomp; i++) {
      hmax_ = std::max(hmax_, comp_[i].h);
      vmax_ = std::max(vmax_, comp_[i].v);
    }
    if (ncomp == 3) {
      if (jfif_) {
      } else if (adobe_) {
        if (adobe_transform_ == 0) fail("Adobe RGB JPEG (no YCbCr transform) is not supported");
      } else if (comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B') {
        fail("RGB JPEG (component ids R, G, B) is not supported");
      }
      for (int i = 0; i < 3; i++) {
        Component& c = comp_[i];
        if (hmax_ % c.h || vmax_ % c.v) fail("unsupported chroma subsampling");
        int rh = hmax_ / c.h, rv = vmax_ / c.v;
        bool ok = (rh == 1 && rv == 1) || (i > 0 && ((rh == 2 && rv == 1) || (rh == 2 && rv == 2)));
        if (!ok) {
          fail("unsupported chroma subsampling (" + std::to_string(comp_[0].h) + "x" +
               std::to_string(comp_[0].v) + "," + std::to_string(comp_[1].h) + "x" +
               std::to_string(comp_[1].v) + "," + std::to_string(comp_[2].h) + "x" +
               std::to_string(comp_[2].v) + ")");
        }
      }
      if (comp_[1].h != comp_[2].h || comp_[1].v != comp_[2].v) fail("unsupported chroma subsampling");
    }
    mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    decoded_.assign(ncomp, 0);
    for (int i = 0; i < ncomp; i++) {
      Component& c = comp_[i];
      c.width = (int)(((int64_t)width * c.h + hmax_ - 1) / hmax_);
      c.height = (int)(((int64_t)height * c.v + vmax_ - 1) / vmax_);
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.stride = c.bw * 8;
      c.plane.assign((size_t)c.stride * c.bh * 8, 0);
    }
    frame_ = true;
  }

  void read_dht() {
    int len = u16() - 2;
    while (len > 0) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt Huffman table");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; i++) {
        counts[i] = byte();
        total += counts[i];
      }
      if (total > 256 || 17 + total > len) fail("corrupt Huffman table");
      uint8_t sym[256];
      for (int i = 0; i < total; i++) sym[i] = byte();
      (tc == 0 ? dc_[th] : ac_[th]).build(counts, sym, total);
      len -= 17 + total;
    }
    if (len != 0) fail("corrupt Huffman table segment");
  }

  void read_dqt() {
    int len = u16() - 2;
    while (len > 0) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("corrupt quantisation table");
      for (int i = 0; i < 64; i++) {
        int v = pq ? u16() : byte();
        qt_[tq][kNatural[i]] = (uint16_t)v;
      }
      qt_defined_[tq] = true;
      len -= 1 + (pq ? 128 : 64);
    }
    if (len != 0) fail("corrupt quantisation table segment");
  }

  bool done_all() const {
    for (int i = 0; i < ncomp; i++)
      if (!decoded_[i]) return false;
    return true;
  }

  // --- entropy-coded segment
  void reset_bits() {
    acc_ = 0;
    cnt_ = 0;
    padded_ = 0;
    hit_marker_ = false;
  }

  void fill() {
    while (cnt_ <= 56) {
      uint32_t b = 0;
      if (!hit_marker_) {
        if (pos_ >= n_) {
          hit_marker_ = true;
        } else if (p_[pos_] == 0xFF) {
          size_t q = pos_ + 1;
          while (q < n_ && p_[q] == 0xFF) q++;  // fill bytes
          if (q < n_ && p_[q] == 0x00) {
            b = 0xFF;
            pos_ = q + 1;
          } else {
            hit_marker_ = true;  // a marker: leave pos_ on its 0xFF
          }
        } else {
          b = p_[pos_++];
        }
      }
      if (hit_marker_) padded_ += 8;
      acc_ |= (uint64_t)b << (56 - cnt_);
      cnt_ += 8;
    }
  }

  void check_underrun() {
    if (padded_ > cnt_) {
      fail(pos_ >= n_ ? "truncated file: image data ends before the last block"
                      : "corrupt data: a marker inside the image data");
    }
  }

  inline int get_bits(int n) {
    if (n == 0) return 0;
    if (cnt_ < n) fill();
    int v = (int)(acc_ >> (64 - n));
    acc_ <<= n;
    cnt_ -= n;
    return v;
  }

  inline int decode_symbol(const Huffman& h) {
    if (cnt_ < 16) fill();
    int look = (int)(acc_ >> (64 - 9));
    int l = h.look_len[look];
    if (l) {
      acc_ <<= l;
      cnt_ -= l;
      return h.look_val[look];
    }
    for (l = 10; l <= 16; l++) {
      int code = (int)(acc_ >> (64 - l));
      if (code <= h.maxcode[l]) {
        acc_ <<= l;
        cnt_ -= l;
        return h.vals[(h.valoffset[l] + code) & 0xFF];
      }
    }
    check_underrun();
    fail("corrupt data: bad Huffman code");
  }

  static inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (-(1 << s) + 1) : v; }

  void decode_block(Component& c, int bx, int by) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const Huffman& dc = dc_[c.dc_tbl];
    const Huffman& ac = ac_[c.ac_tbl];
    int t = decode_symbol(dc);
    if (t > 15) fail("corrupt data: bad DC magnitude");
    int diff = t ? extend(get_bits(t), t) : 0;
    c.dc_pred += diff;
    coef[0] = (int16_t)c.dc_pred;
    for (int k = 1; k < 64; k++) {
      int rs = decode_symbol(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = (int16_t)extend(get_bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(coef, qt_[c.tq], c.plane.data() + (size_t)by * 8 * c.stride + bx * 8, c.stride);
  }

  void decode_scan() {
    int len = u16();
    int ns = byte();
    if (ns < 1 || ns > ncomp || len != 6 + 2 * ns) fail("corrupt scan header");
    int idx[3];
    for (int i = 0; i < ns; i++) {
      int cid = byte(), tbl = byte();
      int k = -1;
      for (int j = 0; j < ncomp; j++)
        if (comp_[j].id == cid) k = j;
      if (k < 0) fail("corrupt scan header (unknown component)");
      idx[i] = k;
      comp_[k].dc_tbl = tbl >> 4;
      comp_[k].ac_tbl = tbl & 15;
      if (comp_[k].dc_tbl > 3 || comp_[k].ac_tbl > 3 || !dc_[comp_[k].dc_tbl].defined ||
          !ac_[comp_[k].ac_tbl].defined)
        fail("corrupt scan header (undefined Huffman table)");
      if (!qt_defined_[comp_[k].tq]) fail("corrupt data: undefined quantisation table");
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0) fail("progressive JPEG is not supported");
    for (int i = 0; i < ns; i++) comp_[idx[i]].dc_pred = 0;
    reset_bits();
    int mx, my;
    if (ns == 1) {
      Component& c = comp_[idx[0]];
      mx = (c.width + 7) / 8;
      my = (c.height + 7) / 8;
    } else {
      mx = mcux_;
      my = mcuy_;
    }
    long done = 0;
    int next_rst = 0;
    for (int y = 0; y < my; y++) {
      for (int x = 0; x < mx; x++) {
        if (restart_interval_ && done > 0 && done % restart_interval_ == 0) restart(next_rst);
        if (ns == 1) {
          decode_block(comp_[idx[0]], x, y);
        } else {
          for (int i = 0; i < ns; i++) {
            Component& c = comp_[idx[i]];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++) decode_block(c, x * c.h + h, y * c.v + v);
          }
        }
        check_underrun();
        done++;
      }
    }
    for (int i = 0; i < ns; i++) decoded_[idx[i]] = 1;
    // leave pos_ at the next marker
    if (!hit_marker_) {
      while (pos_ < n_) {
        if (p_[pos_] == 0xFF && pos_ + 1 < n_ && p_[pos_ + 1] != 0x00 && p_[pos_ + 1] != 0xFF) break;
        pos_++;
      }
    }
  }

  void restart(int& next_rst) {
    // discard the bits left of this interval and read the expected RSTn
    reset_bits();
    if (pos_ + 1 >= n_) fail("truncated file: image data ends before the last block");
    size_t q = pos_;
    if (p_[q] != 0xFF) fail("corrupt data: missing restart marker");
    while (q < n_ && p_[q] == 0xFF) q++;
    if (q >= n_) fail("truncated file: image data ends before the last block");
    if (p_[q] != 0xD0 + next_rst) fail("corrupt data: restart marker out of sequence");
    pos_ = q + 1;
    next_rst = (next_rst + 1) & 7;
    for (int i = 0; i < ncomp; i++) comp_[i].dc_pred = 0;
  }

  // --- upsampling and colour conversion
  // one full-width row (image row y) of a subsampled component, upsampled as
  // libjpeg's fancy upsamplers do (or replicated where they do not apply)
  void upsample_row(const Component& c, int y, uint8_t* out) const {
    int rh = hmax_ / c.h, rv = vmax_ / c.v;
    const uint8_t* plane = c.plane.data();
    int cw = c.width;
    if (rh == 1 && rv == 1) {
      std::memcpy(out, plane + (size_t)y * c.stride, width);
      return;
    }
    bool fancy = cw > 2;
    if (rv == 1) {  // h2v1
      const uint8_t* in = plane + (size_t)y * c.stride;
      if (!fancy) {
        for (int x = 0; x < cw; x++) out[2 * x] = out[2 * x + 1] = in[x];
        return;
      }
      int iv = in[0];
      out[0] = (uint8_t)iv;
      out[1] = (uint8_t)((iv * 3 + in[1] + 2) >> 2);
      int o = 2;
      for (int x = 1; x < cw - 1; x++) {
        iv = in[x] * 3;
        out[o++] = (uint8_t)((iv + in[x - 1] + 1) >> 2);
        out[o++] = (uint8_t)((iv + in[x + 1] + 2) >> 2);
      }
      iv = in[cw - 1];
      out[o++] = (uint8_t)((iv * 3 + in[cw - 2] + 1) >> 2);
      out[o++] = (uint8_t)iv;
      return;
    }
    // h2v2
    int r = y / 2;
    const uint8_t* in0 = plane + (size_t)r * c.stride;
    if (!fancy) {
      for (int x = 0; x < cw; x++) out[2 * x] = out[2 * x + 1] = in0[x];
      return;
    }
    int rf = (y & 1) ? r + 1 : r - 1;
    if (rf < 0) rf = 0;
    if (rf > c.height - 1) rf = c.height - 1;
    const uint8_t* in1 = plane + (size_t)rf * c.stride;
    int thiscolsum = in0[0] * 3 + in1[0];
    int nextcolsum = in0[1] * 3 + in1[1];
    int lastcolsum;
    out[0] = (uint8_t)((thiscolsum * 4 + 8) >> 4);
    out[1] = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
    lastcolsum = thiscolsum;
    thiscolsum = nextcolsum;
    int o = 2;
    for (int x = 2; x < cw; x++) {
      nextcolsum = in0[x] * 3 + in1[x];
      out[o++] = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
      out[o++] = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
      lastcolsum = thiscolsum;
      thiscolsum = nextcolsum;
    }
    out[o++] = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
    out[o++] = (uint8_t)((thiscolsum * 4 + 7) >> 4);
  }

  void output(uint8_t* out) const {
    if (ncomp == 1) {
      const Component& c = comp_[0];
      for (int y = 0; y < height; y++)
        std::memcpy(out + (size_t)y * width, c.plane.data() + (size_t)y * c.stride, width);
      return;
    }
    size_t rowlen = (size_t)mcux_ * hmax_ * 8 + 16;
    std::vector<uint8_t> ry(rowlen), rcb(rowlen), rcr(rowlen);
    for (int y = 0; y < height; y++) {
      upsample_row(comp_[0], y, ry.data());
      upsample_row(comp_[1], y, rcb.data());
      upsample_row(comp_[2], y, rcr.data());
      uint8_t* o = out + (size_t)y * width * 3;
      for (int x = 0; x < width; x++) {
        int yy = ry[x], cb = rcb[x], cr = rcr[x];
        int r = yy + kYcc.cr_r[cr];
        int g = yy + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16);
        int b = yy + kYcc.cb_b[cb];
        o[3 * x] = (uint8_t)(r < 0 ? 0 : (r > 255 ? 255 : r));
        o[3 * x + 1] = (uint8_t)(g < 0 ? 0 : (g > 255 ? 255 : g));
        o[3 * x + 2] = (uint8_t)(b < 0 ? 0 : (b > 255 ? 255 : b));
      }
    }
  }
};

// ------------------------------------------------------------- encoder
const uint8_t kStdLumQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                              14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                              18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                                24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l - 1]; i++, k++) {
        code[vals[k]] = (uint16_t)c++;
        size[vals[k]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int cnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int size) {
    if (size == 0) fail("encoder: symbol missing from a Huffman table");
    acc = (acc << size) | (code & ((1u << size) - 1));
    cnt += size;
    while (cnt >= 8) {
      uint8_t b = (uint8_t)(acc >> (cnt - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      cnt -= 8;
    }
    acc &= (1u << cnt) - 1;
  }
  void flush() {  // pad with 1-bits to a byte
    if (cnt > 0) put((1u << (8 - cnt)) - 1, 8 - cnt);
  }
};

// jfdctint.c jpeg_fdct_islow, in place on level-shifted samples
void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; r++) {
    int32_t* p = d + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = (int32_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    p[6] = (int32_t)descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    p[7] = (int32_t)descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = (int32_t)descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = (int32_t)descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = (int32_t)descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  for (int c = 0; c < 8; c++) {
    int32_t* p = d + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int32_t)descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = (int32_t)descale(tmp10 - tmp11, PASS1_BITS);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = (int32_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    p[48] = (int32_t)descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    p[56] = (int32_t)descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = (int32_t)descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = (int32_t)descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = (int32_t)descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

struct EncPlane {
  std::vector<uint8_t> px;  // padded to whole blocks of the MCU grid, edges replicated
  int stride, rows;
};

class Encoder {
 public:
  Encoder(int w, int h, int comps, int quality, int restart)
      : w_(w), h_(h), nc_(comps), restart_(restart) {
    int q = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
    int scale = q < 50 ? 5000 / q : 200 - q * 2;  // jcparam.c jpeg_quality_scaling
    for (int i = 0; i < 64; i++) {
      long l = ((long)kStdLumQ[i] * scale + 50L) / 100L, c = ((long)kStdChromQ[i] * scale + 50L) / 100L;
      qt_[0][i] = (uint16_t)(l < 1 ? 1 : (l > 255 ? 255 : l));
      qt_[1][i] = (uint16_t)(c < 1 ? 1 : (c > 255 ? 255 : c));
    }
    dc_[0].build(kDcLumBits, kDcVals);
    ac_[0].build(kAcLumBits, kAcLumVals);
    dc_[1].build(kDcChromBits, kDcVals);
    ac_[1].build(kAcChromBits, kAcChromVals);
  }

  std::vector<uint8_t> encode(const uint8_t* px) {
    int hmax = nc_ == 3 ? 2 : 1, vmax = hmax;
    int mcux = (w_ + 8 * hmax - 1) / (8 * hmax), mcuy = (h_ + 8 * vmax - 1) / (8 * vmax);
    make_planes(px, mcux * 8 * hmax, mcuy * 8 * vmax);
    std::vector<uint8_t> out;
    out.reserve((size_t)w_ * h_ * nc_ / 4 + 1024);
    auto marker = [&](int m) {
      out.push_back(0xFF);
      out.push_back((uint8_t)m);
    };
    auto u16 = [&](int v) {
      out.push_back((uint8_t)(v >> 8));
      out.push_back((uint8_t)v);
    };
    marker(0xD8);
    marker(0xE0);  // JFIF 1.01, no density unit, 1:1
    u16(16);
    const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    out.insert(out.end(), jfif, jfif + 14);
    for (int t = 0; t < (nc_ == 3 ? 2 : 1); t++) {
      marker(0xDB);
      u16(67);
      out.push_back((uint8_t)t);
      for (int i = 0; i < 64; i++) out.push_back((uint8_t)qt_[t][kNatural[i]]);
    }
    marker(0xC0);
    u16(8 + 3 * nc_);
    out.push_back(8);
    u16(h_);
    u16(w_);
    out.push_back((uint8_t)nc_);
    for (int i = 0; i < nc_; i++) {
      out.push_back((uint8_t)(i + 1));
      out.push_back((uint8_t)(i == 0 ? (hmax << 4 | vmax) : 0x11));
      out.push_back((uint8_t)(i == 0 ? 0 : 1));
    }
    for (int t = 0; t < (nc_ == 3 ? 2 : 1); t++) {
      const uint8_t* bits[2] = {t ? kDcChromBits : kDcLumBits, t ? kAcChromBits : kAcLumBits};
      const uint8_t* vals[2] = {kDcVals, t ? kAcChromVals : kAcLumVals};
      for (int k = 0; k < 2; k++) {
        int total = 0;
        for (int i = 0; i < 16; i++) total += bits[k][i];
        marker(0xC4);
        u16(19 + total);
        out.push_back((uint8_t)(k << 4 | t));
        out.insert(out.end(), bits[k], bits[k] + 16);
        out.insert(out.end(), vals[k], vals[k] + total);
      }
    }
    if (restart_) {
      marker(0xDD);
      u16(4);
      u16(restart_);
    }
    marker(0xDA);
    u16(6 + 2 * nc_);
    out.push_back((uint8_t)nc_);
    for (int i = 0; i < nc_; i++) {
      out.push_back((uint8_t)(i + 1));
      out.push_back((uint8_t)(i == 0 ? 0x00 : 0x11));
    }
    out.push_back(0);
    out.push_back(63);
    out.push_back(0);
    BitWriter bw(out);
    int pred[3] = {0, 0, 0};
    long done = 0;
    int rst = 0;
    for (int my = 0; my < mcuy; my++) {
      for (int mx = 0; mx < mcux; mx++) {
        if (restart_ && done > 0 && done % restart_ == 0) {
          bw.flush();
          marker(0xD0 + rst);
          rst = (rst + 1) & 7;
          pred[0] = pred[1] = pred[2] = 0;
        }
        for (int c = 0; c < nc_; c++) {
          int hs = c == 0 ? hmax : 1, vs = c == 0 ? vmax : 1;
          int wb = c == 0 ? (w_ + 7) / 8 : mcux, hb = c == 0 ? (h_ + 7) / 8 : mcuy;
          int blocks[4][64];
          for (int v = 0; v < vs; v++) {
            for (int h = 0; h < hs; h++) {
              int* b = blocks[v * hs + h];
              int bx = mx * hs + h, by = my * vs + v;
              if (by >= hb) {  // a dummy row at the bottom: the DC of the block before
                std::memset(b, 0, sizeof(int) * 64);
                b[0] = blocks[v * hs - 1][0];
              } else if (bx >= wb) {  // a dummy block at the right edge: the DC of its left
                std::memset(b, 0, sizeof(int) * 64);
                b[0] = blocks[v * hs + h - 1][0];
              } else {
                quantize_block(planes_[c], bx * 8, by * 8, qt_[c ? 1 : 0], b);
              }
            }
          }
          for (int i = 0; i < hs * vs; i++) emit_block(bw, blocks[i], dc_[c ? 1 : 0], ac_[c ? 1 : 0], pred[c]);
        }
        done++;
      }
    }
    bw.flush();
    marker(0xD9);
    return out;
  }

 private:
  int w_, h_, nc_, restart_;
  uint16_t qt_[2][64];
  HuffEnc dc_[2], ac_[2];
  EncPlane planes_[3];

  void make_planes(const uint8_t* px, int pw, int ph) {
    auto clampx = [&](int x) { return x < w_ ? x : w_ - 1; };
    auto clampy = [&](int y) { return y < h_ ? y : h_ - 1; };
    if (nc_ == 1) {
      EncPlane& p = planes_[0];
      p.stride = pw;
      p.rows = ph;
      p.px.resize((size_t)pw * ph);
      for (int y = 0; y < ph; y++)
        for (int x = 0; x < pw; x++) p.px[(size_t)y * pw + x] = px[(size_t)clampy(y) * w_ + clampx(x)];
      return;
    }
    // jccolor.c rgb_ycc_convert
    const int64_t ONE_HALF = (int64_t)1 << 15, CBCR_OFFSET = (int64_t)128 << 16;
    auto FIX = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    std::vector<uint8_t> yp((size_t)pw * ph), cbp((size_t)pw * ph), crp((size_t)pw * ph);
    for (int y = 0; y < ph; y++) {
      for (int x = 0; x < pw; x++) {
        const uint8_t* s = px + ((size_t)clampy(y) * w_ + clampx(x)) * 3;
        int64_t r = s[0], g = s[1], b = s[2];
        size_t i = (size_t)y * pw + x;
        yp[i] = (uint8_t)((FIX(0.29900) * r + FIX(0.58700) * g + FIX(0.11400) * b + ONE_HALF) >> 16);
        cbp[i] = (uint8_t)((-FIX(0.16874) * r - FIX(0.33126) * g + FIX(0.50000) * b + CBCR_OFFSET +
                            ONE_HALF - 1) >> 16);
        crp[i] = (uint8_t)((FIX(0.50000) * r - FIX(0.41869) * g - FIX(0.08131) * b + CBCR_OFFSET +
                            ONE_HALF - 1) >> 16);
      }
    }
    planes_[0] = {std::move(yp), pw, ph};
    // jcsample.c h2v2_downsample (alternating bias 1, 2 along a row) over the
    // rows of the image (an odd last row paired with itself, as jcprepct.c
    // pads a row group); the rows below repeat the last downsampled row
    int cw = pw / 2, chh = ph / 2, real = (h_ + 1) / 2;
    for (int k = 1; k < 3; k++) {
      const std::vector<uint8_t>& src = k == 1 ? cbp : crp;
      EncPlane& p = planes_[k];
      p.stride = cw;
      p.rows = chh;
      p.px.resize((size_t)cw * chh);
      for (int y = 0; y < chh; y++) {
        int yd = y < real ? y : real - 1;
        int bias = 1;
        const uint8_t* r0 = src.data() + (size_t)(2 * yd) * pw;
        const uint8_t* r1 = src.data() + (size_t)clampy(2 * yd + 1) * pw;
        for (int x = 0; x < cw; x++) {
          p.px[(size_t)y * cw + x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
  }

  void quantize_block(const EncPlane& p, int x0, int y0, const uint16_t* q, int* coef) {
    int32_t d[64];
    for (int r = 0; r < 8; r++)
      for (int c = 0; c < 8; c++) d[8 * r + c] = (int32_t)p.px[(size_t)(y0 + r) * p.stride + x0 + c] - 128;
    fdct_islow(d);
    for (int i = 0; i < 64; i++) {  // jcdctmgr.c quantize: divisor quantval << 3
      int qv = q[i] << 3;
      int t = d[i];
      if (t < 0) {
        t = -t + (qv >> 1);
        t = t >= qv ? t / qv : 0;
        t = -t;
      } else {
        t += qv >> 1;
        t = t >= qv ? t / qv : 0;
      }
      coef[i] = t;
    }
  }

  static void emit_block(BitWriter& bw, const int* coef, const HuffEnc& dc, const HuffEnc& ac,
                         int& pred) {
    auto nbits = [](int v) {
      int a = v < 0 ? -v : v, n = 0;
      while (a) {
        n++;
        a >>= 1;
      }
      return n;
    };
    int diff = coef[0] - pred;
    pred = coef[0];
    int s = nbits(diff);
    bw.put(dc.code[s], dc.size[s]);
    if (s) bw.put(diff < 0 ? diff - 1 : diff, s);
    int run = 0;
    for (int k = 1; k < 64; k++) {
      int v = coef[kNatural[k]];
      if (v == 0) {
        run++;
        continue;
      }
      while (run > 15) {
        bw.put(ac.code[0xF0], ac.size[0xF0]);
        run -= 16;
      }
      int n = nbits(v);
      int sym = (run << 4) | n;
      bw.put(ac.code[sym], ac.size[sym]);
      bw.put(v < 0 ? v - 1 : v, n);
      run = 0;
    }
    if (run > 0) bw.put(ac.code[0], ac.size[0]);
  }
};

// ------------------------------------------------------------ resample
constexpr int PRECISION_BITS = 32 - 8 - 2;

inline double bilinear_filter(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

// Resample.c precompute_coeffs + normalize_coeffs_8bpc
int precompute_coeffs(int in_size, float in0, float in1, int out_size, std::vector<int>& bounds,
                      std::vector<int32_t>& kk) {
  double scale = (double)(in1 - in0) / out_size, filterscale = scale;
  if (filterscale < 1.0) filterscale = 1.0;
  double support = 1.0 * filterscale;
  int ksize = (int)std::ceil(support) * 2 + 1;
  std::vector<double> pre((size_t)out_size * ksize);
  bounds.assign((size_t)out_size * 2, 0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0, ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* k = &pre[(size_t)xx * ksize];
    int x;
    for (x = 0; x < xmax; x++) {
      double w = bilinear_filter((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (x = 0; x < xmax; x++)
      if (ww != 0.0) k[x] /= ww;
    for (; x < ksize; x++) k[x] = 0;
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  kk.resize(pre.size());
  for (size_t i = 0; i < pre.size(); i++) {
    kk[i] = pre[i] < 0 ? (int32_t)(-0.5 + pre[i] * (1 << PRECISION_BITS))
                       : (int32_t)(0.5 + pre[i] * (1 << PRECISION_BITS));
  }
  return ksize;
}

inline uint8_t clip8(int in) {
  if (in >= (1 << PRECISION_BITS << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> PRECISION_BITS);
}

void resample_bilinear(const uint8_t* in, int w, int h, int ch, uint8_t* out, int ow, int oh) {
  std::vector<int> bh, bv;
  std::vector<int32_t> kh, kv;
  bool need_h = ow != w, need_v = oh != h;
  int ksh = precompute_coeffs(w, 0.0f, (float)w, ow, bh, kh);
  int ksv = precompute_coeffs(h, 0.0f, (float)h, oh, bv, kv);
  int first = bv[0], last = bv[oh * 2 - 2] + bv[oh * 2 - 1];
  const uint8_t* src = in;
  int sw = w, sh = h;
  std::vector<uint8_t> tmp;
  if (need_h) {
    for (int i = 0; i < oh; i++) bv[i * 2] -= first;
    int rows = last - first;
    tmp.resize((size_t)rows * ow * ch);
    for (int yy = 0; yy < rows; yy++) {
      const uint8_t* row = in + (size_t)(yy + first) * w * ch;
      uint8_t* o = tmp.data() + (size_t)yy * ow * ch;
      for (int xx = 0; xx < ow; xx++) {
        int xmin = bh[xx * 2], xmax = bh[xx * 2 + 1];
        const int32_t* k = &kh[(size_t)xx * ksh];
        for (int c = 0; c < ch; c++) {
          int ss = 1 << (PRECISION_BITS - 1);
          for (int x = 0; x < xmax; x++) ss += row[(size_t)(x + xmin) * ch + c] * k[x];
          o[(size_t)xx * ch + c] = clip8(ss);
        }
      }
    }
    src = tmp.data();
    sw = ow;
    sh = rows;
  }
  if (need_v) {
    for (int yy = 0; yy < oh; yy++) {
      int ymin = bv[yy * 2], ymax = bv[yy * 2 + 1];
      const int32_t* k = &kv[(size_t)yy * ksv];
      uint8_t* o = out + (size_t)yy * ow * ch;
      for (int xc = 0; xc < sw * ch; xc++) {
        int ss = 1 << (PRECISION_BITS - 1);
        for (int y = 0; y < ymax; y++) ss += src[(size_t)(y + ymin) * sw * ch + xc] * k[y];
        o[xc] = clip8(ss);
      }
    }
  } else {
    std::memcpy(out, src, (size_t)sw * sh * ch);
  }
}

}  // namespace

extern "C" {

int cxr_jpeg_info(const uint8_t* data, size_t n, int* w, int* h, int* comps, char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.read_header();
    *w = d.width;
    *h = d.height;
    *comps = d.ncomp;
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
  }
  return 1;
}

// out: [h, w] (one component) or [h, w, 3] (RGB), as cxr_jpeg_info reports
int cxr_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, char* err, int errlen) {
  try {
    Decoder d(data, n);
    d.read_header();
    d.decode(out);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
  }
  return 1;
}

// px: [h, w] (comps 1) or [h, w, 3] (comps 3, encoded as YCbCr 4:2:0).
// *out is malloc'd; release it with cxr_free.
int cxr_jpeg_encode(const uint8_t* px, int w, int h, int comps, int quality, int restart_interval,
                    uint8_t** out, size_t* out_len, char* err, int errlen) {
  try {
    if (w < 1 || h < 1 || w > 65535 || h > 65535) fail("image size out of range for JPEG");
    if (comps != 1 && comps != 3) fail("only gray or RGB images are encoded");
    if (restart_interval < 0 || restart_interval > 65535) fail("restart interval out of range");
    Encoder e(w, h, comps, quality, restart_interval);
    std::vector<uint8_t> bytes = e.encode(px);
    *out = (uint8_t*)std::malloc(bytes.size());
    if (!*out) fail("out of memory");
    std::memcpy(*out, bytes.data(), bytes.size());
    *out_len = bytes.size();
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
  }
  return 1;
}

void cxr_free(void* p) { std::free(p); }

// Pillow's Image.resize((ow, oh), BILINEAR) of a [h, w, ch] uint8 image
int cxr_resize_bilinear(const uint8_t* in, int w, int h, int ch, uint8_t* out, int ow, int oh,
                        char* err, int errlen) {
  try {
    if (w < 1 || h < 1 || ow < 1 || oh < 1) fail("empty image");
    resample_bilinear(in, w, h, ch, out, ow, oh);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
  }
  return 1;
}

// Geometry.c ImagingTransformAffine with the nearest filter: out [h, w, ch]
// (zero where the source pixel falls outside), a the 6 inverse-affine terms.
// In 16.16 fixed point (affine_fixed) when every corner maps inside +-32768,
// as Pillow does; else in doubles, stepped as Pillow steps them.
void cxr_affine_nearest(const uint8_t* in, int w, int h, int ch, const double* a, uint8_t* out) {
  std::memset(out, 0, (size_t)w * h * ch);
  auto fits = [&](int x, int y) {
    return std::fabs(x * a[0] + y * a[1] + a[2]) < 32768.0 &&
           std::fabs(x * a[3] + y * a[4] + a[5]) < 32768.0;
  };
  if (fits(0, 0) && fits(w, h) && fits(0, h) && fits(w, 0)) {
    auto fix = [](double v) {
      double t = v * 65536.0 + 0.5;
      return t < 0.0 ? (int)std::floor(t) : (int)t;
    };
    int a0 = fix(a[0]), a1 = fix(a[1]), a3 = fix(a[3]), a4 = fix(a[4]);
    int a2 = fix(a[2] + a[0] * 0.5 + a[1] * 0.5);
    int a5 = fix(a[5] + a[3] * 0.5 + a[4] * 0.5);
    for (int y = 0; y < h; y++) {
      int xx = a2, yy = a5;
      uint8_t* o = out + (size_t)y * w * ch;
      for (int x = 0; x < w; x++) {
        int xin = xx >> 16;
        if (xin >= 0 && xin < w) {
          int yin = yy >> 16;
          if (yin >= 0 && yin < h) std::memcpy(o + (size_t)x * ch, in + ((size_t)yin * w + xin) * ch, ch);
        }
        xx += a0;
        yy += a3;
      }
      a2 += a1;
      a5 += a4;
    }
    return;
  }
  double xo = a[2] + a[1] * 0.5 + a[0] * 0.5;
  double yo = a[5] + a[4] * 0.5 + a[3] * 0.5;
  for (int y = 0; y < h; y++) {
    double xx = xo, yy = yo;
    uint8_t* o = out + (size_t)y * w * ch;
    for (int x = 0; x < w; x++) {
      int xin = xx < 0.0 ? -1 : (int)xx;
      int yin = yy < 0.0 ? -1 : (int)yy;
      if (xin >= 0 && xin < w && yin >= 0 && yin < h) {
        std::memcpy(o + (size_t)x * ch, in + ((size_t)yin * w + xin) * ch, ch);
      }
      xx += a[0];
      yy += a[3];
    }
    xo += a[1];
    yo += a[4];
  }
}

}  // extern "C"
