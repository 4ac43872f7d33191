// JPEG decoder: host code, no kernel.
//
// The native twin of uniir_tpu_torch/data/jpeg.py::decode_twin, which is the
// reference: the same function, bit for bit -- what Pillow's
// `Image.open(path).convert("RGB")` gives through libjpeg-turbo 3.1 at its
// defaults: jdhuff.c's sequential (SOF0 / SOF1) and jdphuff.c's progressive
// (SOF2) Huffman decoding (DC first / refinement scans, AC first scans with
// EOB runs, AC refinement scans), jdarith.c's arithmetic decoding (SOF9 /
// SOF10: the QM coder of T.81 Annex D with jaricom.c's table, DAC
// conditioning, statistics reset at every restart, a bad code leaving the
// rest of its restart interval undecoded) into one coefficient buffer over
// all scans, each component's quantisation table latched at its first scan
// (jdinput.c), jdcoefct.c's block smoothing of a progressive image whose
// scans leave zigzag 1-9 unrefined (decompress_smooth_data: the 5 x 5 DC
// neighbourhood, DC interpolation when no AC is known; rows read as Pillow's
// libjpeg-turbo 3.1 reads them, see data/jpeg.py::smooth_blocks),
// the integer IDCT (CONST_BITS 13, PASS1_BITS 2) as libjpeg-turbo's x86-64
// SIMD code computes it in SSE2 (16-bit products and sums that wrap, each
// pass packed with saturation, a first-row-only block's shortcut), jdsample.c's
// fancy upsampling (h2v1, h1v2, h2v2
// triangle filters with their alternating rounding bias, edges replicated;
// box replication where a 2x-wide component is at most 2 samples wide),
// lossless SOF3 (jdlhuff.c's differences, jdlossls.c's seven predictors and
// the point transform, box upsampling; YCbCr refused, as libjpeg refuses to
// convert it; damaged data as jddiffct.c decodes it a row of MCUs at a time:
// the row that runs out read on zeros, the interval's later rows differences
// 0 with the undifferencer restarted), the colour space jdapimin.c's default_decompress_parms picks
// (3 components: YCbCr under JFIF, RGB under Adobe transform 0 or, without
// either marker, ids 'R' 'G' 'B'; 4: CMYK under Adobe transform 0 or none,
// else YCCK), jdcolor.c's fixed-point YCbCr -> RGB tables (YCCK's YCC
// through the same tables), RGB copied, CMYK read as Pillow reads it
// (inverted, `CMYK;I`) and converted by Convert.c's cmyk2rgb, a greyscale
// image copied into three channels.  `uniir_jpeg_decode_samples` gives
// libjpeg's samples instead (data/jpeg.py::decode_samples, the TIFF
// decoder's JPEG strips).  Accepted and rejected forms are the twin's (see
// its module docstring): damaged data decodes where libjpeg-turbo decodes it
// with a warning (junk between markers skipped, a bad Huffman code read as
// symbol 0 after 17 bits, DC categories up to 15, a run past the band
// written where it reaches, data cut at a marker read as zeros to the end of
// the MCU and the rest of the interval left as it is, restart markers
// resynchronised as jpeg_resync_to_restart does, smoothing by
// last_good_iMCU_row), and what libjpeg refuses (data that ends before EOI,
// an unknown marker, a bad table or progression)
// returns an error with the twin's message; nothing reads or writes out of
// bounds.
//
// Why host code and not a kernel: entropy decoding is serial within a scan,
// and the images are resized on the host after decoding; a device IDCT would
// add a copy each way.  The decoder keeps no global state, so the loader's
// threads (ctypes releases the GIL) decode in parallel.
//
// Built by uniir_tpu_torch/_build.py with nvcc like the kernels' sources.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <emmintrin.h>  // SSE2: the IDCT is libjpeg-turbo's x86-64 SIMD code (an x86-64 host)
#include <string>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Error {
  std::string msg;
};

// jutils.c's jpeg_natural_order with its 16 extra entries: a corrupt run that carries past position 63 (or past a
// progressive band's end) writes its coefficient at the index it reached, 63 for every index past the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int cw = 0, ch = 0;  // sampled width and height
  int bw = 0, bh = 0;  // padded block grid (MCU multiples)
  std::vector<int16_t> coef;  // [bh * bw * 64], natural order
  int64_t q[64] = {0};  // the quantisation table latched at the component's first scan; zeros if none
  bool latched = false;
  int coef_bits[64];  // jdphuff.c: the Al each zigzag position was last sent at; -1: never
  int prev_bits[10];  // zigzag 0-9's as they were before the component's latest scan
  Component() {
    for (int& b : coef_bits) b = -1;
    for (int& b : prev_bits) b = -1;
  }
};

struct Scan {
  int n;
  int comp[4], dc[4], ac[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

// A DHT table as the segment gives it; checked and turned into a lookup table when a scan starts using it.
struct HuffTable {
  bool defined = false;
  uint8_t counts[16];
  uint8_t symbols[256];
};

// A marker: its code, the offset of its first FF and the offset just past it.
struct Marker {
  int code = 0;
  size_t at = 0, after = 0;
};

// jaricom.c's jpeg_aritab: Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS
const uint32_t kAritab[114] = {
    0x5A1D0181, 0x2586020E, 0x11140310, 0x080B0412, 0x03D80514, 0x01DA0617, 0x00E50719, 0x006F081C, 0x0036091E,
    0x001A0A21, 0x000D0B23, 0x00060C09, 0x00030D0A, 0x00010D0C, 0x5A7F0F8F, 0x3F251024, 0x2CF21126, 0x207C1227,
    0x17B91328, 0x1182142A, 0x0CEF152B, 0x09A1162D, 0x072F172E, 0x055C1830, 0x04061931, 0x03031A33, 0x02401B34,
    0x01B11C36, 0x01441D38, 0x00F51E39, 0x00B71F3B, 0x008A203C, 0x0068213E, 0x004E223F, 0x003B2320, 0x002C0921,
    0x5AE125A5, 0x484C2640, 0x3A0D2741, 0x2EF12843, 0x261F2944, 0x1F332A45, 0x19A82B46, 0x15182C48, 0x11772D49,
    0x0E742E4A, 0x0BFB2F4B, 0x09F8304D, 0x0861314E, 0x0706324F, 0x05CD3330, 0x04DE3432, 0x040F3532, 0x03633633,
    0x02D43734, 0x025C3835, 0x01F83936, 0x01A43A37, 0x01603B38, 0x01253C39, 0x00F63D3A, 0x00CB3E3B, 0x00AB3F3D,
    0x008F203D, 0x5B1241C1, 0x4D044250, 0x412C4351, 0x37D84452, 0x2FE84553, 0x293C4654, 0x23794756, 0x1EDF4857,
    0x1AA94957, 0x174E4A48, 0x14244B48, 0x119C4C4A, 0x0F6B4D4A, 0x0D514E4B, 0x0BB64F4D, 0x0A40304D, 0x583251D0,
    0x4D1C5258, 0x438E5359, 0x3BDD545A, 0x34EE555B, 0x2EAE565C, 0x299A575D, 0x25164756, 0x557059D8, 0x4CA95A5F,
    0x44D95B60, 0x3E225C61, 0x38245D63, 0x32B45E63, 0x2E17565D, 0x56A860DF, 0x4F466165, 0x47E56266, 0x41CF6367,
    0x3C3D6468, 0x375E5D63, 0x52316669, 0x4C0F676A, 0x4639686B, 0x415E6367, 0x56276AE9, 0x50E76B6C, 0x4B85676D,
    0x55976D6E, 0x504F6B6F, 0x5A106FEE, 0x55226D70, 0x59EB6FF0, 0x5A1D7171};

struct Decoder {
  const uint8_t* d;
  size_t n;
  bool libtiff = false;  // a TIFF strip as libtiff reads it: no error past a single-scan frame's scan
  int width = 0, height = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int64_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable tables[2][4];
  std::vector<uint16_t> huff[2][4];  // (code length << 8) | symbol for each 16-bit window; 0: a bad code
  int restart = 0;
  int n_scans = 0;
  bool multiscan = false;  // jdinput.c's has_multiple_scans, set at the first scan
  int last_good = 0;  // jdcoefct.c's last_good_iMCU_row: the iMCU row of the last MCU decoded with data left
  bool progressive = false;
  bool arith = false;     // SOF9 / SOF10
  bool lossless = false;  // SOF3
  int dac_l[16], dac_u[16], dac_k[16];  // arithmetic conditioning (jdmarker.c get_soi's defaults)
  // lossless: each component's differences [mcuy * v][mcux * h], its last scan's predictor and point
  // transform, and the rows at which that scan restarted jdlossls.c's undifferencer (first_rows[c][row])
  std::vector<std::vector<int32_t>> diffs;
  std::vector<std::vector<uint8_t>> first_rows;
  int psv[4] = {0, 0, 0, 0}, pt[4] = {0, 0, 0, 0};
  bool have_plane[4] = {false, false, false, false};
  Decoder() {
    for (int t = 0; t < 16; t++) dac_l[t] = 0, dac_u[t] = 1, dac_k[t] = 5;
  }
  bool jfif = false;
  int adobe_transform = -1;
  enum Colour { kGrey, kYCbCr, kRGB, kCMYK, kYCCK } colour = kGrey;

  [[noreturn]] void fail(const char* fmt, int a = 0, int b = 0, int c = 0, int d = 0, int e = 0) {
    char buf[200];
    snprintf(buf, sizeof(buf), fmt, a, b, c, d, e);
    throw Error{buf};
  }
};

// A marker segment the data ends inside: libjpeg suspends there, waiting for bytes that do not come.
struct Suspended {};

// ---------------------------------------------------------------- bit reader

// An MSB-first reader of the entropy-coded bytes from `pos`: 0xFF00 read as 0xFF, fill bytes skipped, zeros fed
// once a marker is met (pos then stays on it), as jdhuff.c's jpeg_fill_bit_buffer does; `at_marker` set from the
// start reads zeros only.  `over` says it read past the data (libjpeg's insufficient_data).
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  bool at_marker = false;
  uint64_t acc = 0;
  int bits = 0;
  int64_t real_bits = 0, used_bits = 0;  // bits from the stream / consumed

  void fill() {
    while (bits <= 56) {
      uint64_t byte = 0;
      if (!at_marker) {
        if (pos >= n) {
          at_marker = true;
        } else if (d[pos] != 0xFF) {
          byte = d[pos++];
          real_bits += 8;
        } else {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;  // fill bytes
          if (q < n && d[q] == 0x00) {
            byte = 0xFF;
            real_bits += 8;
            pos = q + 1;
          } else {
            at_marker = true;  // pos stays on the marker's first 0xFF
          }
        }
      }
      acc |= byte << (56 - bits);
      bits += 8;
    }
  }
  uint32_t peek32() {
    fill();
    return (uint32_t)(acc >> 32);
  }
  void skip(int k) {
    acc <<= k;
    bits -= k;
    used_bits += k;
  }
  bool over() const { return used_bits > real_bits; }
};

inline int extend(uint32_t v, int s) { return v < (1u << (s - 1)) ? (int)v + 1 - (1 << s) : (int)v; }

inline int16_t to16(int64_t v) { return (int16_t)(uint16_t)(v & 0xFFFF); }  // JCOEF is 16-bit

inline uint32_t get_bits(BitReader& br, int n) {
  if (!n) return 0;
  uint32_t v = br.peek32() >> (32 - n);
  br.skip(n);
  return v;
}

// The next symbol; a bad code (none of 16 bits or fewer) reads 17 bits and gives symbol 0, as jdhuff.c's
// jpeg_huff_decode and HUFF_DECODE_FAST do (JWRN_HUFF_BAD_CODE).
inline int huff(BitReader& br, const std::vector<uint16_t>& lut) {
  uint16_t e = lut[br.peek32() >> 16];
  if (!e) {
    br.skip(17);
    return 0;
  }
  br.skip(e >> 8);
  return e & 0xFF;
}

// jdphuff.c's decode_mcu_DC_first for one block
void dc_first(BitReader& br, const std::vector<uint16_t>& lut, int al, int64_t& pred, int16_t* out) {
  int s = huff(br, lut);
  pred += s ? extend(get_bits(br, s), s) : 0;
  out[0] = to16(pred * ((int64_t)1 << al));
}

// A correction bit of an already-nonzero coefficient.
inline void refine(BitReader& br, int16_t* c, int p1) {
  if (get_bits(br, 1) && !(*c & p1)) *c = to16(*c >= 0 ? *c + p1 : *c - p1);
}

// decode_mcu_AC_first over one block; returns the EOB run left.  A run past the band's end writes where it
// reached (kNatural).
int64_t ac_first(BitReader& br, const std::vector<uint16_t>& lut, const Scan& sc, int64_t eobrun, int16_t* out) {
  if (eobrun) return eobrun - 1;
  for (int k = sc.ss; k <= sc.se; k++) {
    int rs = huff(br, lut), r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      out[kNatural[k]] = to16((int64_t)extend(get_bits(br, s), s) * ((int64_t)1 << sc.al));
    } else if (r == 15) {
      k += 15;
    } else {
      return ((int64_t)1 << r) + get_bits(br, r) - 1;
    }
  }
  return 0;
}

// decode_mcu_AC_refine over one block; returns the EOB run left.  A newly nonzero coefficient whose run passes
// the band's end is written just past it (kNatural).
int64_t ac_refine(BitReader& br, const std::vector<uint16_t>& lut, const Scan& sc, int64_t eobrun, int16_t* out) {
  int p1 = 1 << sc.al, k = sc.ss;
  if (!eobrun) {
    for (; k <= sc.se; k++) {
      int rs = huff(br, lut), r = rs >> 4, s = rs & 15;
      if (s) {
        s = get_bits(br, 1) ? p1 : -p1;  // a newly nonzero coefficient (libjpeg warns when the size is not 1)
      } else if (r != 15) {
        eobrun = ((int64_t)1 << r) + get_bits(br, r);
        break;
      }
      for (; k <= sc.se; k++) {  // past already-nonzero coefficients (correcting them) and r zero ones
        int16_t* c = &out[kZigzag[k]];
        if (*c) {
          refine(br, c, p1);
        } else if (--r < 0) {
          break;
        }
      }
      if (s) out[kNatural[k]] = (int16_t)s;
    }
  }
  if (eobrun) {
    for (; k <= sc.se; k++)  // the band's rest after the end of block: corrections only
      if (out[kZigzag[k]]) refine(br, &out[kZigzag[k]], p1);
    eobrun--;
  }
  return eobrun;
}

// jdhuff.c's decode_mcu for one sequential block: a bad code is symbol 0 after 17 bits (a DC difference of 0,
// an end of block); a run past position 63 writes at 63.
void decode_block(BitReader& br, const std::vector<uint16_t>& dc, const std::vector<uint16_t>& ac, int64_t& pred,
                  int16_t* out) {
  uint32_t w = br.peek32();
  uint16_t e = dc[w >> 16];
  if (e) {
    int len = e >> 8, s = e & 0xFF;
    if (s) pred += extend((w >> (32 - len - s)) & ((1u << s) - 1), s);
    br.skip(len + s);
  } else {
    br.skip(17);
  }
  out[0] = (int16_t)(uint16_t)(pred & 0xFFFF);  // JCOEF is 16-bit
  for (int k = 1; k < 64;) {
    w = br.peek32();
    e = ac[w >> 16];
    if (!e) {
      br.skip(17);
      break;
    }
    int len = e >> 8, rs = e & 0xFF, run = rs >> 4, s = rs & 15;
    if (s) {
      k += run;
      out[kNatural[k]] = (int16_t)extend((w >> (32 - len - s)) & ((1u << s) - 1), s);
      br.skip(len + s);
      k++;
    } else {
      br.skip(len);
      if (run != 15) break;
      k += 16;
    }
  }
}

// ------------------------------------------------------- arithmetic decoding

// jdarith.c's decoder over the entropy-coded bytes from `pos`: 0xFF00 read as 0xFF, fill bytes skipped, zeros
// fed once a marker is met (pos then stays on it); `dead` is libjpeg's ct = -1 after a bad code.
struct Arith {
  const uint8_t* d;
  size_t n, pos;
  int64_t c = 0, a = 0;
  int ct = -16;  // two bytes to read into C first
  bool marker = false, dead = false;
  uint8_t fixed = 113;  // the fixed 0.5 estimate

  int byte() {
    if (marker) return 0;
    if (pos >= n) {
      marker = true;
      return 0;
    }
    if (d[pos] != 0xFF) return d[pos++];
    size_t q = pos + 1;
    while (q < n && d[q] == 0xFF) q++;
    if (q < n && d[q] == 0x00) {
      pos = q + 1;
      return 0xFF;
    }
    marker = true;
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalisation and data input (D.2.6)
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t e = kAritab[sv & 0x7F];
    int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    int64_t qe = e >> 16;
    a -= qe;
    int64_t temp = a << ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
      a = qe;
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// Decode_DC_DIFF (F.19, F.21-F.24) into diff; false on a magnitude overflow.
bool arith_dc(Arith& ar, uint8_t* st, int& ctx, int lo, int hi, int& diff) {
  if (!ar.decode(st + ctx)) {
    ctx = 0;
    diff = 0;
    return true;
  }
  int sign = ar.decode(st + ctx + 1);
  int p = ctx + 2 + sign;
  int m = ar.decode(st + p);
  if (m) {
    p = 20;
    while (ar.decode(st + p)) {
      if ((m <<= 1) == 0x8000) return false;
      p++;
    }
  }
  ctx = m < ((1 << lo) >> 1) ? 0 : (m > ((1 << hi) >> 1) ? 12 : 4) + 4 * sign;
  int v = m;
  p += 14;
  while (m >>= 1)
    if (ar.decode(st + p)) v |= m;
  v += 1;
  diff = sign ? -v : v;
  return true;
}

// decode_mcu's AC part / decode_mcu_AC_first over one block; false on an overflow.
bool arith_ac_first(Arith& ar, uint8_t* st, int ss, int se, int al, int kx, int16_t* out) {
  for (int k = ss; k <= se; k++) {
    int p = 3 * (k - 1);
    if (ar.decode(st + p)) break;  // end of block
    while (!ar.decode(st + p + 1)) {
      p += 3;
      if (++k > se) return false;
    }
    int sign = ar.decode(&ar.fixed);
    p += 2;
    int m = ar.decode(st + p);
    if (m && ar.decode(st + p)) {
      m <<= 1;
      p = k <= kx ? 189 : 217;
      while (ar.decode(st + p)) {
        if ((m <<= 1) == 0x8000) return false;
        p++;
      }
    }
    int v = m;
    p += 14;
    while (m >>= 1)
      if (ar.decode(st + p)) v |= m;
    v += 1;
    out[kZigzag[k]] = to16((int64_t)(sign ? -v : v) * ((int64_t)1 << al));
  }
  return true;
}

// decode_mcu_AC_refine over one block; false on a spectral overflow.
bool arith_ac_refine(Arith& ar, uint8_t* st, int ss, int se, int al, int16_t* out) {
  int p1 = 1 << al, m1 = -(1 << al);
  int kex = se;
  while (kex > 0 && !out[kZigzag[kex]]) kex--;
  for (int k = ss; k <= se; k++) {
    int p = 3 * (k - 1);
    if (k > kex && ar.decode(st + p)) break;
    for (;;) {
      int16_t* c = &out[kZigzag[k]];
      if (*c) {
        if (ar.decode(st + p + 2)) *c = to16(*c + (*c < 0 ? m1 : p1));
        break;
      }
      if (ar.decode(st + p + 1)) {
        *c = (int16_t)(ar.decode(&ar.fixed) ? m1 : p1);
        break;
      }
      p += 3;
      if (++k > se) return false;
    }
  }
  return true;
}

// ------------------------------------------------------------------ markers

int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

const char* sof_name(int m) {
  switch (m) {
    case 0xC5: return "SOF5 (differential sequential)";
    case 0xC6: return "SOF6 (differential progressive)";
    case 0xC7: return "SOF7 (differential lossless)";
    case 0xCB: return "SOF11 (arithmetic lossless)";
    case 0xCD: return "SOF13 (arithmetic differential sequential)";
    case 0xCE: return "SOF14 (arithmetic differential progressive)";
    case 0xCF: return "SOF15 (arithmetic differential lossless)";
    case 0xC8: return "JPG";
    case 0xDC: return "DNL";
    default: return nullptr;
  }
}

void read_sof(Decoder& dec, int marker, const uint8_t* seg, int len) {
  if (len < 6) dec.fail("marker 0xFF%02X: truncated frame header", marker);
  int precision = seg[0], nc = seg[5];
  dec.height = u16(seg + 1);
  dec.width = u16(seg + 3);
  if (precision != 8) dec.fail("marker 0xFF%02X: %d-bit samples are not supported (8 only)", marker, precision);
  if (nc != 1 && nc != 3 && nc != 4) dec.fail("marker 0xFF%02X: %d components are not supported (1, 3 or 4)", marker, nc);
  if (dec.height == 0 || dec.width == 0) dec.fail("marker 0xFF%02X: image size %d x %d (DNL is not supported)", marker, dec.width, dec.height);
  if (len != 6 + 3 * nc) dec.fail("marker 0xFF%02X: bad frame header length", marker);
  for (int c = 0; c < nc; c++) {
    Component comp;
    comp.id = seg[6 + 3 * c];
    comp.h = seg[7 + 3 * c] >> 4;
    comp.v = seg[7 + 3 * c] & 15;
    comp.tq = seg[8 + 3 * c];
    if (comp.h < 1 || comp.h > 4 || comp.v < 1 || comp.v > 4 || comp.tq > 3)
      dec.fail("marker 0xFF%02X: bad sampling factors or table id", marker);
    dec.comps.push_back(comp);
  }
  dec.hmax = dec.vmax = 1;
  for (auto& c : dec.comps) {
    dec.hmax = c.h > dec.hmax ? c.h : dec.hmax;
    dec.vmax = c.v > dec.vmax ? c.v : dec.vmax;
  }
  for (auto& c : dec.comps) {
    int fx = dec.hmax / c.h, fy = dec.vmax / c.v;
    if ((fx != 1 && fx != 2) || (fy != 1 && fy != 2) || dec.hmax % c.h || dec.vmax % c.v)
      dec.fail("marker 0xFF%02X: sampling %dx%d against %dx%d is not supported", marker, c.h, c.v, dec.hmax,
               dec.vmax);
  }
  int unit = dec.lossless ? 1 : 8;  // a lossless MCU holds samples, not blocks
  dec.mcux = (dec.width + unit * dec.hmax - 1) / (unit * dec.hmax);
  dec.mcuy = (dec.height + unit * dec.vmax - 1) / (unit * dec.vmax);
  for (auto& c : dec.comps) {
    c.cw = (int)(((int64_t)dec.width * c.h + dec.hmax - 1) / dec.hmax);
    c.ch = (int)(((int64_t)dec.height * c.v + dec.vmax - 1) / dec.vmax);
    c.bw = dec.mcux * c.h;
    c.bh = dec.mcuy * c.v;
  }
}

// The byte at seg[k] of a segment whose data may end early (`avail` bytes there).
inline int seg_byte(const uint8_t* seg, int avail, int k) {
  if (k >= avail) throw Suspended{};
  return seg[k];
}

// jdmarker.c get_dqt over the segment's `len` bytes (`avail` of them in the data): a table id below 4, a precision
// nibble other than 0 for 16-bit values, a table cut short by the length read as far as it goes (the rest 1).
void read_dqt(Decoder& dec, const uint8_t* seg, int len, int avail) {
  int k = 0;
  while (len > 0) {
    len--;
    int b = seg_byte(seg, avail, k++), prec = b >> 4, tq = b & 15;
    if (tq >= 4) dec.fail("marker 0xFFDB: bad quantisation table id %d", tq);
    int count = len >= (prec ? 128 : 64) ? 64 : (prec ? len >> 1 : len), width = prec ? 2 : 1;
    if (k + width * count > avail) throw Suspended{};
    for (int i = 0; i < 64; i++) dec.qt[tq][kZigzag[i]] = count < 64 ? 1 : 0;
    for (int i = 0; i < count; i++)
      dec.qt[tq][kZigzag[i]] = prec ? u16(seg + k + 2 * i) : seg[k + i];
    dec.qt_defined[tq] = true;
    k += width * count;
    len -= width * count;
  }
  if (len) dec.fail("marker 0xFFDB: bad quantisation table length");
}

// jdmarker.c get_dht: tables of at most 256 codes that fit the length, class 0 or 1 and id 0-3 (checked further
// when a scan uses them, build_lut).
void read_dht(Decoder& dec, const uint8_t* seg, int len, int avail) {
  int k = 0;
  while (len > 16) {
    if (k + 17 > avail) throw Suspended{};
    int index = seg[k], total = 0;
    for (int i = 0; i < 16; i++) total += seg[k + 1 + i];
    len -= 17;
    if (total > 256 || total > len) dec.fail("marker 0xFFC4: bad Huffman table");
    if (k + 17 + total > avail) throw Suspended{};
    len -= total;
    int cls = (index >> 4) & 1;
    if (index & 0x10) index -= 0x10;
    if (index > 3) dec.fail("marker 0xFFC4: bad Huffman table id");
    HuffTable& t = dec.tables[cls][index];
    t.defined = true;
    memcpy(t.counts, seg + k + 1, 16);
    memcpy(t.symbols, seg + k + 17, total);
    k += 17 + total;
  }
  if (len) dec.fail("marker 0xFFC4: bad Huffman table length");
}

// jdmarker.c get_dac: pairs of a table index (DC 0-15, AC 16-31) and its conditioning.
void read_dac(Decoder& dec, const uint8_t* seg, int len, int avail) {
  int k = 0;
  while (len > 0) {
    int index = seg_byte(seg, avail, k), val = seg_byte(seg, avail, k + 1);
    k += 2;
    len -= 2;
    if (index >= 32) dec.fail("marker 0xFFCC: bad arithmetic table index %d (DAC)", index);
    if (index >= 16) {
      dec.dac_k[index - 16] = val;
    } else {
      if ((val & 15) > (val >> 4)) dec.fail("marker 0xFFCC: bad DC conditioning %d (DAC)", val);
      dec.dac_l[index] = val & 15;
      dec.dac_u[index] = val >> 4;
    }
  }
  if (len) dec.fail("marker 0xFFCC: bad arithmetic conditioning length (DAC)");
}

// The Annex K tables (counts of codes of length 1..16, then the symbols), which libjpeg-turbo's
// jpeg_std_huff_table puts in place of a table 0 or 1 a scan uses and no DHT defined.
const uint8_t kAnnexK[2][2][16 + 162] = {
    {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11},
     {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11}},
    {{0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D,
      0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
      0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
      0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
      0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
      0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
      0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
      0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
      0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
      0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
     {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77,
      0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
      0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
      0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
      0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
      0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
      0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
      0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
      0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
      0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}}};

// The lookup table of Huffman table (cls, t) as a scan starting now uses it, with jdhuff.c's
// jpeg_make_d_derived_tbl checks: the codes fit their lengths with the all-ones code unused, and a DC table's
// symbols are at most 15 (16 in a lossless frame).
void build_lut(Decoder& dec, int cls, int t) {
  HuffTable& tab = dec.tables[cls][t];
  if (!tab.defined) {  // jpeg_std_huff_table
    if (t > 1) dec.fail(cls ? "marker 0xFFDA: scan uses an undefined AC Huffman table %d"
                            : "marker 0xFFDA: scan uses an undefined DC Huffman table %d", t);
    tab.defined = true;
    memcpy(tab.counts, kAnnexK[cls][t], 16);
    memcpy(tab.symbols, kAnnexK[cls][t] + 16, 162);
  }
  int total = 0;
  for (int i = 0; i < 16; i++) total += tab.counts[i];
  for (int i = 0; i < total && !cls; i++)
    if (tab.symbols[i] > (dec.lossless ? 16 : 15)) dec.fail("marker 0xFFDA: bad Huffman table (DC %d)", t);
  std::vector<uint16_t>& lut = dec.huff[cls][t];
  lut.assign(65536, 0);
  uint32_t code = 0;
  int k = 0;
  for (int length = 1; length <= 16; length++) {
    for (int i = 0; i < tab.counts[length - 1]; i++) {
      if (++code > (1u << length)) dec.fail(cls ? "marker 0xFFDA: bad Huffman table (AC %d)" : "marker 0xFFDA: bad Huffman table (DC %d)", t);
      uint32_t lo = (code - 1) << (16 - length), hi = code << (16 - length);
      for (uint32_t x = lo; x < hi; x++) lut[x] = (uint16_t)((length << 8) | tab.symbols[k]);
      k++;
    }
    if (code >= (1u << length)) dec.fail(cls ? "marker 0xFFDA: bad Huffman table (AC %d)" : "marker 0xFFDA: bad Huffman table (DC %d)", t);
    code <<= 1;
  }
}

// jdmarker.c's next_marker from p: the first marker -- an FF, any fill FFs, a byte other than 00 -- skipping any
// other bytes and FF 00 pairs; false where the data ends first.
bool next_marker(const Decoder& dec, size_t p, Marker& m) {
  for (;;) {
    while (p < dec.n && dec.d[p] != 0xFF) p++;
    size_t q = p + 1;
    while (q < dec.n && dec.d[q] == 0xFF) q++;
    if (q >= dec.n) return false;
    if (dec.d[q]) {
      m.code = dec.d[q];
      m.at = p;
      m.after = q + 1;
      return true;
    }
    p = q + 1;
  }
}

Marker must_next_marker(Decoder& dec, size_t p) {
  Marker m;
  if (!next_marker(dec, p, m)) dec.fail("truncated JPEG stream (no EOI marker)");
  return m;
}

// Where each restart interval of a scan starting at `start` reads from as libjpeg-turbo reads it (-1: zeros only,
// the marker found at its restart left unread), and the marker the scan ends at.  At each restart (jdhuff.c
// process_restart, jdmarker.c read_restart_marker and jpeg_resync_to_restart) the next marker is taken if it is
// the expected RSTn; otherwise a marker below SOF0 or one of the two RSTn before the expected one is discarded
// and the next marker looked at, any other marker and the next two RSTn are left unread, and the rest (the
// expected RSTn among them) discarded.
std::vector<int64_t> scan_intervals(Decoder& dec, size_t start, int64_t n_intervals, Marker& end) {
  std::vector<int64_t> starts((size_t)n_intervals);
  size_t pos = start;
  bool unread = false;
  int expected = 0;
  Marker m;
  for (int64_t k = 0; k < n_intervals; k++) {
    if (k) {
      if (m.code == 0xD0 + expected) {
        unread = false;
        pos = m.after;
      } else {
        for (;;) {
          bool rst = m.code >= 0xD0 && m.code <= 0xD7;
          int step = (m.code - 0xD0 - expected + 16) % 8;
          if (m.code < 0xC0 || (rst && (step == 6 || step == 7))) {
            m = must_next_marker(dec, m.after);
            continue;
          }
          if (!rst || step == 1 || step == 2) {
            unread = true;
          } else {
            unread = false;
            pos = m.after;
          }
          break;
        }
      }
      expected = (expected + 1) & 7;
    }
    if (unread) {
      starts[(size_t)k] = -1;
    } else {
      starts[(size_t)k] = (int64_t)pos;
      m = must_next_marker(dec, pos);
      unread = true;
    }
  }
  end = m;
  return starts;
}

// The scan whose header is `seg`, checked as jdmarker.c's get_sos and the entropy decoders' start_pass check it,
// decoded from `data_start`; `end` is set to the marker it ends at.
void read_scan(Decoder& dec, const uint8_t* seg, int len, size_t data_start, Marker& end) {
  if (dec.comps.empty()) dec.fail("marker 0xFFDA: a scan before the frame header");
  if (dec.n_scans && !dec.multiscan) dec.fail("marker 0xFFDA: a second scan in a single-scan file (EOI expected)");
  int ns = len ? seg[0] : 0;
  if (ns < 1 || ns > (int)dec.comps.size() || len != 4 + 2 * ns) dec.fail("marker 0xFFDA: bad scan header");
  Scan scan;
  scan.n = ns;
  scan.ss = seg[1 + 2 * ns];
  scan.se = seg[2 + 2 * ns];
  scan.ah = seg[3 + 2 * ns] >> 4;
  scan.al = seg[3 + 2 * ns] & 15;
  if (dec.lossless) {  // jdlossls.c start_pass_lossless
    if (scan.ss < 1 || scan.ss > 7 || scan.se || scan.ah || scan.al >= 8)
      dec.fail("marker 0xFFDA: bad lossless scan: predictor %d, %d / point transform %d, %d", scan.ss, scan.se, scan.ah,
               scan.al);
  } else if (!dec.progressive) {  // other values only warn (JWRN_NOT_SEQUENTIAL): a sequential scan reads 0..63
    scan.ss = 0, scan.se = 63, scan.ah = 0, scan.al = 0;
  }
  if (dec.progressive && ((scan.ss == 0 ? scan.se != 0 : (scan.ss > scan.se || scan.se > 63 || ns != 1)) ||
                          (scan.ah && scan.al != scan.ah - 1) || scan.al > 13))  // jdphuff.c's checks
    dec.fail("marker 0xFFDA: bad progression: spectral selection %d..%d / approximation %d, %d", scan.ss, scan.se,
             scan.ah, scan.al);
  // a DC refinement reads no table
  bool needs_dc = dec.lossless || (scan.ss == 0 && scan.ah == 0), needs_ac = scan.se > 0 && !dec.lossless;
  for (int s = 0; s < ns; s++) {
    int cid = seg[1 + 2 * s], t = seg[2 + 2 * s], found = -1;
    for (int c = 0; c < (int)dec.comps.size(); c++)
      if (dec.comps[c].id == cid && found < 0) found = c;
    if (found < 0) dec.fail("marker 0xFFDA: scan names an unknown component %d", cid);
    scan.comp[s] = found;
    scan.dc[s] = needs_dc ? t >> 4 : 0;  // a table the scan does not read is not looked up
    scan.ac[s] = needs_ac ? t & 15 : 0;
    if (!dec.arith) {
      if (needs_dc && scan.dc[s] > 3)
        dec.fail("marker 0xFFDA: scan uses an undefined DC Huffman table %d", scan.dc[s]);
      if (needs_ac && scan.ac[s] > 3)
        dec.fail("marker 0xFFDA: scan uses an undefined AC Huffman table %d", scan.ac[s]);
      if (needs_dc) build_lut(dec, 0, scan.dc[s]);
      if (needs_ac) build_lut(dec, 1, scan.ac[s]);
    }
    Component& c = dec.comps[found];
    if (!c.latched && !dec.lossless) {  // jdinput.c latches a component's table at its first scan
      if (!dec.qt_defined[c.tq]) dec.fail("marker 0xFFDA: component uses an undefined quantisation table %d", c.tq);
      for (int i = 0; i < 64; i++) c.q[i] = dec.qt[c.tq][i];
      c.latched = true;
    }
    if (dec.progressive) {
      for (int k = scan.ss < 1 ? scan.ss : 1; k < 10; k++) c.prev_bits[k] = dec.n_scans ? c.coef_bits[k] : 0;
      for (int k = scan.ss; k <= scan.se; k++) c.coef_bits[k] = scan.al;
    }
  }
  if (ns > 1) {  // jdinput.c's per_scan_setup: D_MAX_BLOCKS_IN_MCU
    int blocks = 0;
    for (int s = 0; s < ns; s++) blocks += dec.comps[scan.comp[s]].h * dec.comps[scan.comp[s]].v;
    if (blocks > 10) dec.fail("marker 0xFFDA: more than 10 blocks in an MCU (sampling factors too large for an interleaved scan)");
  }
  if (!dec.n_scans) dec.multiscan = dec.progressive || ns < (int)dec.comps.size();
  if (dec.lossless) {
    if (dec.diffs.empty())
      for (auto& c : dec.comps) {
        dec.diffs.emplace_back((size_t)c.bh * c.bw, 0);
        dec.first_rows.emplace_back((size_t)c.bh, 0);
      }
    for (int s = 0; s < ns; s++) std::fill(dec.first_rows[scan.comp[s]].begin(), dec.first_rows[scan.comp[s]].end(), 0);
  } else {
    for (auto& c : dec.comps)
      if (c.coef.empty()) c.coef.assign((size_t)c.bh * c.bw * 64, 0);
  }

  bool single = ns == 1;
  int unit = dec.lossless ? 1 : 8;
  int units_x, units_y, rows_per_imcu;
  if (single) {
    const Component& c = dec.comps[scan.comp[0]];
    units_x = (c.cw + unit - 1) / unit;
    units_y = (c.ch + unit - 1) / unit;
    rows_per_imcu = c.v;
  } else {
    units_x = dec.mcux;
    units_y = dec.mcuy;
    rows_per_imcu = 1;
  }
  int64_t total = (int64_t)units_x * units_y;
  int64_t interval = dec.restart ? dec.restart : total;
  int64_t n_intervals = (total + interval - 1) / interval;
  if (dec.lossless && interval % units_x)
    dec.fail("marker 0xFFDD: restart interval %d is not a multiple of the %d MCUs of a row (lossless)",
             (int)interval, units_x);
  std::vector<int64_t> starts = scan_intervals(dec, data_start, n_intervals, end);
  BitReader br{dec.d, dec.n, data_start};
  Arith ar{dec.d, dec.n, data_start};
  uint8_t dc_st[16][64], ac_st[16][256];
  int ctx[4] = {0, 0, 0, 0};
  bool dc_scan = !dec.progressive || (scan.ss == 0 && scan.ah == 0);
  int64_t pred[4] = {0, 0, 0, 0}, eobrun = 0;
  // libjpeg's insufficient_data: once an MCU has read past its interval's data (zeros), the interval's later MCUs
  // are left as they are; the next restart clears it unless its marker was left unread.  A lossless scan tests it
  // once a row of MCUs (jddiffct.c calls decode_mcus a row at a time): a short row's differences are 0 and it
  // restarts the undifferencer, as a restart does, at the first sample row of each component's iMCU row
  bool short_data = false;
  auto restart_undifferencer = [&](int r) {
    for (int s = 0; s < ns; s++) {
      int v = dec.comps[scan.comp[s]].v;
      dec.first_rows[scan.comp[s]][(size_t)(single ? r / v : r) * v] = 1;
    }
  };
  for (int64_t u = 0; u < total; u++) {
    if (!dec.arith && !short_data) dec.last_good = (int)(u / units_x / rows_per_imcu);  // before the restart
    if (u % interval == 0) {
      int64_t from = starts[(size_t)(u / interval)];
      br = BitReader{dec.d, dec.n, from < 0 ? 0 : (size_t)from};
      br.at_marker = from < 0;
      ar = Arith{dec.d, dec.n, from < 0 ? 0 : (size_t)from};
      ar.marker = from < 0;
      short_data = short_data && from < 0;
      pred[0] = pred[1] = pred[2] = pred[3] = 0;  // predictions, EOB run and statistics restart each interval
      ctx[0] = ctx[1] = ctx[2] = ctx[3] = 0;
      eobrun = 0;
      if (dec.lossless) restart_undifferencer((int)(u / units_x));
      if (dec.arith)
        for (int s = 0; s < ns; s++) {
          if (dc_scan) memset(dc_st[scan.dc[s]], 0, 64);
          if (!dec.progressive || scan.ss) memset(ac_st[scan.ac[s]], 0, 256);
        }
    }
    int r = (int)(u / units_x), q = (int)(u % units_x);
    if (dec.lossless && short_data) {
      if (q == 0) restart_undifferencer(r);
      for (int s = 0; s < ns; s++) {
        Component& c = dec.comps[scan.comp[s]];
        int ny = single ? 1 : c.v, nx = single ? 1 : c.h;
        for (int y = 0; y < ny; y++)
          for (int x = 0; x < nx; x++)
            dec.diffs[scan.comp[s]][(size_t)(single ? r : r * c.v + y) * c.bw + (single ? q : q * c.h + x)] = 0;
      }
      continue;
    }
    if (dec.arith ? ar.dead : short_data) continue;
    for (int s = 0; s < ns && !(dec.arith && ar.dead); s++) {
      Component& c = dec.comps[scan.comp[s]];
      int ny = single ? 1 : c.v, nx = single ? 1 : c.h;
      for (int y = 0; y < ny && !(dec.arith && ar.dead); y++)
        for (int x = 0; x < nx; x++) {
          int row = single ? r : r * c.v + y, col = single ? q : q * c.h + x;
          if (dec.lossless) {
            int sz = huff(br, dec.huff[0][scan.dc[s]]);
            dec.diffs[scan.comp[s]][(size_t)row * c.bw + col] = sz == 16 ? 32768 : (sz ? extend(get_bits(br, sz), sz) : 0);
            continue;
          }
          int16_t* out = &c.coef[((size_t)row * c.bw + col) * 64];
          if (dec.arith) {
            bool ok = true;
            if (dc_scan) {
              int t = scan.dc[s], diff;
              ok = arith_dc(ar, dc_st[t], ctx[s], dec.dac_l[t], dec.dac_u[t], diff);
              if (ok) {
                pred[s] = (pred[s] + diff) & 0xFFFF;
                out[0] = to16(pred[s] * ((int64_t)1 << (dec.progressive ? scan.al : 0)));
              }
            } else if (scan.ss == 0) {  // DC refinement: the next bit, at the fixed estimate
              if (ar.decode(&ar.fixed)) out[0] = to16(out[0] | (1 << scan.al));
            }
            if (ok && (!dec.progressive || scan.ss)) {
              int t = scan.ac[s];
              if (dec.progressive && scan.ah)
                ok = arith_ac_refine(ar, ac_st[t], scan.ss, scan.se, scan.al, out);
              else
                ok = arith_ac_first(ar, ac_st[t], dec.progressive ? scan.ss : 1, dec.progressive ? scan.se : 63,
                                    dec.progressive ? scan.al : 0, dec.dac_k[t], out);
            }
            if (!ok) {
              ar.dead = true;
              break;
            }
            continue;
          }
          const auto& dc = dec.huff[0][scan.dc[s]];
          const auto& ac = dec.huff[1][scan.ac[s]];
          if (!dec.progressive) {
            decode_block(br, dc, ac, pred[s], out);
          } else if (scan.ss == 0 && scan.ah == 0) {
            dc_first(br, dc, scan.al, pred[s], out);
          } else if (scan.ss == 0) {
            if (get_bits(br, 1)) out[0] = to16(out[0] | (1 << scan.al));
          } else {
            eobrun = scan.ah ? ac_refine(br, ac, scan, eobrun, out) : ac_first(br, ac, scan, eobrun, out);
          }
        }
    }
    if (!dec.lossless || q == units_x - 1) short_data = !dec.arith && br.over();
  }
  if (dec.arith) dec.last_good = dec.mcuy - 1;  // jdarith.c never runs short of data
  if (dec.lossless)
    for (int s = 0; s < ns; s++) {
      int c = scan.comp[s];
      dec.psv[c] = scan.ss;
      dec.pt[c] = scan.al;
      dec.have_plane[c] = true;
    }
}

// jdcoefct.c's smoothing_ok after the last scan: libjpeg-turbo smooths a progressive image's blocks when every
// component's table was latched with its first ten zigzag quantisers nonzero, every DC is at least partly known,
// and some coefficient of zigzag positions 1..9 is not final.
bool smooths(const Decoder& dec) {
  for (const auto& c : dec.comps) {
    if (!c.latched || c.coef_bits[0] < 0) return false;
    for (int k = 0; k < 10; k++)
      if (!c.q[kZigzag[k]]) return false;
  }
  for (const auto& c : dec.comps)
    for (int k = 1; k < 10; k++)
      if (c.coef_bits[k] != 0) return true;
  return false;
}

// decompress_smooth_data's estimates: for zigzag positions 1-9, the weights of the 5 x 5 DC neighbourhood with
// DC interpolation (every AC unknown) and without (positions 1-5 only); then the DC's own (data/jpeg.py's tables)
const int kSmoothAc[10][2][25] = {
    {},
    {{-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}},
    {{-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
     {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0}},
    {{0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
     {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0}},
    {{-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
     {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0}},
    {{0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
     {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}},
    {{0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0}, {}},
    {{0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0}, {}},
    {{0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0}, {}},
    {{0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0}, {}},
};
const int kSmoothDc[25] = {-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8,
                           -6, 6, 42, 6, -6, -2, -6, -8, -6, -2};

// jdcoefct.c's decompress_smooth_data over one component's blocks that hold samples, with its progression's Al
// at zigzag 1-9 as it stands after the last scan, or for the iMCU rows past last_good (where the last scan's data
// ran out) as it stood before the component's latest scan (`prev`); rows as data/jpeg.py::smooth_blocks reads
// them.
void smooth(Component& c, int imcu_rows, int last_good, const int* prev) {
  int wb = (c.cw + 7) / 8, hb = (c.ch + 7) / 8, v = c.v;
  int pad_rows = (hb + v - 1) / v * v;  // within the MCU padding rows the coefficient buffer holds
  std::vector<int16_t> out(c.coef);
  auto dc = [&](int row, int col) {
    col = col < 0 ? 0 : (col >= wb ? wb - 1 : col);
    return (int64_t)c.coef[((size_t)row * c.bw + col) * 64];
  };
  int64_t q00 = c.q[0];
  for (int r = 0; r < hb; r++) {
    const int* bits = r / v > last_good ? prev : c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc = change_dc && bits[k] == -1;
    int up1 = r > 0 ? r - 1 : r;
    int up2 = r > 1 ? r - 2 : up1;
    if (hb % v && imcu_rows == 2 && r == v) up2 = up1;
    int dn1 = r + 1 < hb ? r + 1 : hb - 1;
    int dn2 = r + 2 < pad_rows ? r + 2 : dn1;
    int rows[5] = {up2, up1, r, dn1, dn2};
    for (int b = 0; b < wb; b++) {
      int64_t win[25];
      for (int y = 0; y < 5; y++)
        for (int x = 0; x < 5; x++) win[5 * y + x] = dc(rows[y], b + x - 2);
      int16_t* blk = &out[((size_t)r * c.bw + b) * 64];
      for (int k = 1; k < 10; k++) {
        if (!change_dc && k > 5) break;
        int al = bits[k], pos = kZigzag[k];
        if (al == 0 || blk[pos] != 0) continue;
        const int* w = kSmoothAc[k][change_dc ? 0 : 1];
        int64_t num = 0;
        for (int i = 0; i < 25; i++) num += w[i] * win[i];
        num *= q00;
        int64_t qk = c.q[pos];
        int64_t pred = (((qk << 7) + (num >= 0 ? num : -num)) / (qk << 8));
        if (al > 0 && pred >= ((int64_t)1 << al)) pred = ((int64_t)1 << al) - 1;
        blk[pos] = (int16_t)(num >= 0 ? pred : -pred);
      }
      if (change_dc) {
        int64_t num = 0;
        for (int i = 0; i < 25; i++) num += kSmoothDc[i] * win[i];
        num *= q00;
        int64_t pred = (((q00 << 7) + (num >= 0 ? num : -num)) / (q00 << 8));
        blk[0] = (int16_t)(num >= 0 ? pred : -pred);
      }
    }
  }
  c.coef.swap(out);
}

// Reads markers up to EOI (or, with `header_only`, up to the frame header) as libjpeg-turbo's marker reader
// (jdmarker.c read_markers) walks them: bytes between markers skipped, RSTn and TEM outside a scan ignored, a
// DNL, APPn or COM segment skipped, the errors it raises before reading a segment's length raised first; past a
// single-scan file's scan, data that ends early only suspends libjpeg, which Pillow takes as the end.
void parse(Decoder& dec, bool header_only, int colour_override = -1) {
  if (dec.n < 2 || dec.d[0] != 0xFF || dec.d[1] != 0xD8) dec.fail("not a JPEG file (no SOI marker)");
  size_t i = 2;
  bool pending = false;
  Marker m;
  for (;;) {
    bool finished = dec.n_scans && !dec.multiscan;
    try {
      if (!pending) {
        if (!next_marker(dec, i, m)) {
          if (finished) break;
          dec.fail("truncated JPEG stream (no EOI marker)");
        }
      }
      pending = false;
      i = m.after;
      int marker = m.code;
      if (marker == 0xD9) break;
      if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;  // parameterless
      bool skipped = (marker >= 0xE0 && marker <= 0xEF) || marker == 0xFE || marker == 0xDC;  // APPn, COM, DNL
      bool sof = marker == 0xC0 || marker == 0xC1 || marker == 0xC2 || marker == 0xC3 || marker == 0xC9 ||
                 marker == 0xCA;
      if (marker == 0xD8) dec.fail("marker 0xFFD8: a second SOI");
      if (marker != 0xDC)
        if (const char* name = sof_name(marker)) {
          char buf[160];
          snprintf(buf, sizeof(buf), "marker 0xFF%02X: %s is not supported (SOF0-3, SOF9 and SOF10 only)", marker, name);
          throw Error{buf};
        }
      if (sof && !dec.comps.empty()) dec.fail("marker 0xFF%02X: a second frame header", marker);
      if (!(skipped || sof || marker == 0xC4 || marker == 0xCC || marker == 0xDA || marker == 0xDB || marker == 0xDD))
        dec.fail("marker 0xFF%02X: unexpected marker", marker);
      if (i + 2 > dec.n) {
        if (finished) break;
        dec.fail("truncated JPEG stream (marker 0xFF%02X)", marker);
      }
      int length = u16(dec.d + i);
      if (length < 2 && !skipped) dec.fail("truncated JPEG stream (marker 0xFF%02X)", marker);
      length = length < 2 ? 2 : length;
      const uint8_t* seg = dec.d + i + 2;
      int len = length - 2;
      int avail = i + 2 + (size_t)len <= dec.n ? len : (int)(dec.n - (i + 2));
      try {
        if (marker == 0xDB) {
          read_dqt(dec, seg, len, avail);
        } else if (marker == 0xC4) {
          read_dht(dec, seg, len, avail);
        } else if (marker == 0xCC) {
          read_dac(dec, seg, len, avail);
        } else if (marker == 0xDD) {  // jdmarker.c get_dri: a length of 4, then the interval
          if (len != 2) dec.fail("marker 0xFFDD: bad restart interval");
          dec.restart = (seg_byte(seg, avail, 0) << 8) | seg_byte(seg, avail, 1);
        } else if (avail < len) {
          if (marker == 0xDA && finished && avail > 0) {  // get_sos's checks of the part that is there
            int ns = seg[0];
            bool bad = length != 6 + 2 * ns || ns < 1 || ns > 4;
            for (int k = 1; k < avail && k < 1 + 2 * ns && !bad; k += 2) {
              bool known = false;
              for (auto& c : dec.comps) known = known || c.id == seg[k];
              bad = !known;
            }
            if (bad) dec.fail("marker 0xFFDA: bad scan header");
          }
          throw Suspended{};
        }
      } catch (const Suspended&) {
        if (finished) break;
        dec.fail("truncated JPEG stream (marker 0xFF%02X)", marker);
      }
      if (sof) {
        dec.progressive = marker == 0xC2 || marker == 0xCA;
        dec.arith = marker == 0xC9 || marker == 0xCA;
        dec.lossless = marker == 0xC3;
        read_sof(dec, marker, seg, len);
        if (header_only) return;
      } else if (marker == 0xDA) {
        if (header_only) dec.fail("marker 0xFFDA: a scan before the frame header");
        bool first = dec.n_scans == 0;
        read_scan(dec, seg, len, i + length, m);
        dec.n_scans++;
        if (first) {  // jdapimin.c: the colour space as the first scan finds it
          if (dec.comps.size() == 4) {
            dec.colour = dec.adobe_transform <= 0 ? Decoder::kCMYK : Decoder::kYCCK;
          } else if (dec.comps.size() == 3) {
            bool rgb_ids = dec.comps[0].id == 82 && dec.comps[1].id == 71 && dec.comps[2].id == 66;
            if (dec.jfif) dec.colour = Decoder::kYCbCr;
            else if (dec.adobe_transform >= 0) dec.colour = dec.adobe_transform == 0 ? Decoder::kRGB : Decoder::kYCbCr;
            else dec.colour = rgb_ids ? Decoder::kRGB : Decoder::kYCbCr;
          }
        }
        pending = true;
        continue;
      } else if (((marker == 0xE0 && len >= 4 && memcmp(seg, "JFIF", 4) == 0) ||
                  (marker == 0xEE && len >= 5 && memcmp(seg, "Adobe", 5) == 0)) && len < 7) {
        // Pillow reads the segment's version
        if (!dec.n_scans)
          dec.fail(marker == 0xE0 ? "marker 0xFFE0: truncated JFIF segment" : "marker 0xFFEE: truncated Adobe segment");
      } else if (marker == 0xE0 && len >= 14 && memcmp(seg, "JFIF\0", 5) == 0) {
        dec.jfif = true;
      } else if (marker == 0xEE && len >= 12 && memcmp(seg, "Adobe", 5) == 0) {
        dec.adobe_transform = seg[11];
      }
      i += length;
    } catch (const Error&) {
      if (finished && dec.libtiff) break;  // libtiff ignores what jpeg_finish_decompress raises
      throw;
    }
  }
  if (dec.comps.empty() || dec.n_scans == 0) dec.fail("no frame or no scan before EOI");
  if (colour_override >= 0) dec.colour = (Decoder::Colour)colour_override;
  if (dec.colour == Decoder::kYCbCr && dec.comps.size() != 3)  // jdcolor.c: JERR_BAD_J_COLORSPACE
    dec.fail("a frame of %d components read as YCbCr (3 only)", (int)dec.comps.size());
  if (dec.lossless && (dec.colour == Decoder::kYCbCr || dec.colour == Decoder::kYCCK))
    dec.fail(dec.colour == Decoder::kYCbCr
                 ? "marker 0xFFC3: a lossless YCBCR frame, which libjpeg does not convert (lossless RGB, CMYK or grey only)"
                 : "marker 0xFFC3: a lossless YCCK frame, which libjpeg does not convert (lossless RGB, CMYK or grey only)");
  if (dec.progressive && smooths(dec)) {
    int prev_none[10] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1};
    for (auto& c : dec.comps) smooth(c, dec.mcuy, dec.last_good, dec.n_scans > 1 ? c.prev_bits : prev_none);
  }
}

// ------------------------------------------------------------- pixel stages

// libjpeg-turbo's x86-64 SIMD islow IDCT (jidctint-sse2.asm / -avx2.asm, which give the same pixels):
// jidctint.c's CONST_BITS 13 / PASS1_BITS 2 products regrouped into pairs of 16-bit inputs times 16-bit
// constants (pmaddwd), e.g. tmp3 = z2 * (F_0_541 + F_0_765) + z3 * F_0_541.
const int32_t kF130 = 10703, kF054 = 4433, kMF130 = -10704, kMF078 = -6436, kF117 = 9633, kF078 = 6437,
              kMF060 = -4927, kMF089 = -7373, kF060 = 4926, kMF050 = -4176, kMF256 = -20995, kF050 = 4177;

inline int clamp255(int64_t v) { return v < 0 ? 0 : (v > 255 ? 255 : (int)v); }

// The IDCT in SSE2, as jidctint-sse2.asm computes it: 8 int16 lanes a register, the pairs of inputs times pairs of
// constants by pmaddwd, packssdw after each pass.
inline __m128i pairs(int16_t a, int16_t b) { return _mm_setr_epi16(a, b, a, b, a, b, a, b); }

// One pass over the 8 registers x[k] (the k-th input of each lane) into out[k], DESCALEd by `shift`.
inline void idct_pass(const __m128i* x, __m128i* out, int shift) {
  const __m128i f130_f054 = pairs(kF130, kF054), f054_mf130 = pairs(kF054, kMF130);
  const __m128i mf078_f117 = pairs(kMF078, kF117), f117_f078 = pairs(kF117, kF078);
  const __m128i mf060_mf089 = pairs(kMF060, kMF089), mf089_f060 = pairs(kMF089, kF060);
  const __m128i mf050_mf256 = pairs(kMF050, kMF256), mf256_f050 = pairs(kMF256, kF050);
  const __m128i zero = _mm_setzero_si128(), half = _mm_set1_epi32(1 << (shift - 1));
  const __m128i cnt = _mm_cvtsi32_si128(shift);
  __m128i lo = _mm_unpacklo_epi16(x[2], x[6]), hi = _mm_unpackhi_epi16(x[2], x[6]);
  __m128i tmp3l = _mm_madd_epi16(lo, f130_f054), tmp3h = _mm_madd_epi16(hi, f130_f054);
  __m128i tmp2l = _mm_madd_epi16(lo, f054_mf130), tmp2h = _mm_madd_epi16(hi, f054_mf130);
  __m128i sum = _mm_add_epi16(x[0], x[4]), dif = _mm_sub_epi16(x[0], x[4]);
  __m128i tmp0l = _mm_srai_epi32(_mm_unpacklo_epi16(zero, sum), 16 - 13);  // << CONST_BITS, sign kept
  __m128i tmp0h = _mm_srai_epi32(_mm_unpackhi_epi16(zero, sum), 16 - 13);
  __m128i tmp1l = _mm_srai_epi32(_mm_unpacklo_epi16(zero, dif), 16 - 13);
  __m128i tmp1h = _mm_srai_epi32(_mm_unpackhi_epi16(zero, dif), 16 - 13);
  __m128i tmp10l = _mm_add_epi32(tmp0l, tmp3l), tmp10h = _mm_add_epi32(tmp0h, tmp3h);
  __m128i tmp13l = _mm_sub_epi32(tmp0l, tmp3l), tmp13h = _mm_sub_epi32(tmp0h, tmp3h);
  __m128i tmp11l = _mm_add_epi32(tmp1l, tmp2l), tmp11h = _mm_add_epi32(tmp1h, tmp2h);
  __m128i tmp12l = _mm_sub_epi32(tmp1l, tmp2l), tmp12h = _mm_sub_epi32(tmp1h, tmp2h);
  __m128i z3 = _mm_add_epi16(x[3], x[7]), z4 = _mm_add_epi16(x[1], x[5]);
  lo = _mm_unpacklo_epi16(z3, z4), hi = _mm_unpackhi_epi16(z3, z4);
  __m128i z3l = _mm_madd_epi16(lo, mf078_f117), z3h = _mm_madd_epi16(hi, mf078_f117);
  __m128i z4l = _mm_madd_epi16(lo, f117_f078), z4h = _mm_madd_epi16(hi, f117_f078);
  lo = _mm_unpacklo_epi16(x[7], x[1]), hi = _mm_unpackhi_epi16(x[7], x[1]);
  __m128i t0l = _mm_add_epi32(_mm_madd_epi16(lo, mf060_mf089), z3l);
  __m128i t0h = _mm_add_epi32(_mm_madd_epi16(hi, mf060_mf089), z3h);
  __m128i t3l = _mm_add_epi32(_mm_madd_epi16(lo, mf089_f060), z4l);
  __m128i t3h = _mm_add_epi32(_mm_madd_epi16(hi, mf089_f060), z4h);
  lo = _mm_unpacklo_epi16(x[5], x[3]), hi = _mm_unpackhi_epi16(x[5], x[3]);
  __m128i t1l = _mm_add_epi32(_mm_madd_epi16(lo, mf050_mf256), z4l);
  __m128i t1h = _mm_add_epi32(_mm_madd_epi16(hi, mf050_mf256), z4h);
  __m128i t2l = _mm_add_epi32(_mm_madd_epi16(lo, mf256_f050), z3l);
  __m128i t2h = _mm_add_epi32(_mm_madd_epi16(hi, mf256_f050), z3h);
  auto out16 = [&](__m128i l, __m128i h) {
    return _mm_packs_epi32(_mm_sra_epi32(_mm_add_epi32(l, half), cnt), _mm_sra_epi32(_mm_add_epi32(h, half), cnt));
  };
  out[0] = out16(_mm_add_epi32(tmp10l, t3l), _mm_add_epi32(tmp10h, t3h));
  out[7] = out16(_mm_sub_epi32(tmp10l, t3l), _mm_sub_epi32(tmp10h, t3h));
  out[1] = out16(_mm_add_epi32(tmp11l, t2l), _mm_add_epi32(tmp11h, t2h));
  out[6] = out16(_mm_sub_epi32(tmp11l, t2l), _mm_sub_epi32(tmp11h, t2h));
  out[2] = out16(_mm_add_epi32(tmp12l, t1l), _mm_add_epi32(tmp12h, t1h));
  out[5] = out16(_mm_sub_epi32(tmp12l, t1l), _mm_sub_epi32(tmp12h, t1h));
  out[3] = out16(_mm_add_epi32(tmp13l, t0l), _mm_add_epi32(tmp13h, t0h));
  out[4] = out16(_mm_sub_epi32(tmp13l, t0l), _mm_sub_epi32(tmp13h, t0h));
}

inline void transpose8x16(__m128i* r) {
  __m128i a0 = _mm_unpacklo_epi16(r[0], r[1]), a1 = _mm_unpackhi_epi16(r[0], r[1]);
  __m128i a2 = _mm_unpacklo_epi16(r[2], r[3]), a3 = _mm_unpackhi_epi16(r[2], r[3]);
  __m128i a4 = _mm_unpacklo_epi16(r[4], r[5]), a5 = _mm_unpackhi_epi16(r[4], r[5]);
  __m128i a6 = _mm_unpacklo_epi16(r[6], r[7]), a7 = _mm_unpackhi_epi16(r[6], r[7]);
  __m128i b0 = _mm_unpacklo_epi32(a0, a2), b1 = _mm_unpackhi_epi32(a0, a2);
  __m128i b2 = _mm_unpacklo_epi32(a1, a3), b3 = _mm_unpackhi_epi32(a1, a3);
  __m128i b4 = _mm_unpacklo_epi32(a4, a6), b5 = _mm_unpackhi_epi32(a4, a6);
  __m128i b6 = _mm_unpacklo_epi32(a5, a7), b7 = _mm_unpackhi_epi32(a5, a7);
  r[0] = _mm_unpacklo_epi64(b0, b4), r[1] = _mm_unpackhi_epi64(b0, b4);
  r[2] = _mm_unpacklo_epi64(b1, b5), r[3] = _mm_unpackhi_epi64(b1, b5);
  r[4] = _mm_unpacklo_epi64(b2, b6), r[5] = _mm_unpackhi_epi64(b2, b6);
  r[6] = _mm_unpacklo_epi64(b3, b7), r[7] = _mm_unpackhi_epi64(b3, b7);
}

// One block: the 64 samples, row by row, as uint8.
inline void idct_block(const int16_t* coef, const int16_t* q16, uint8_t* px) {
  __m128i in[8], ws[8];
  __m128i any = _mm_setzero_si128();
  for (int v = 0; v < 8; v++) {
    in[v] = _mm_mullo_epi16(_mm_loadu_si128((const __m128i*)(coef + 8 * v)),
                            _mm_loadu_si128((const __m128i*)(q16 + 8 * v)));
    if (v) any = _mm_or_si128(any, _mm_loadu_si128((const __m128i*)(coef + 8 * v)));
  }
  if (_mm_movemask_epi8(_mm_cmpeq_epi16(any, _mm_setzero_si128())) == 0xFFFF) {  // the first-row shortcut
    __m128i dc = _mm_slli_epi16(in[0], 2);
    for (int y = 0; y < 8; y++) ws[y] = dc;
  } else {
    idct_pass(in, ws, 11);  // pass 1: columns; ws[y] holds row y
  }
  transpose8x16(ws);  // ws[k]: input k of each row
  idct_pass(ws, in, 18);  // pass 2: in[x] holds column x of the rows
  transpose8x16(in);  // in[y]: row y
  const __m128i centre = _mm_set1_epi8((char)0x80);
  for (int y = 0; y < 8; y += 2)
    _mm_storeu_si128((__m128i*)(px + 8 * y), _mm_add_epi8(_mm_packs_epi16(in[y], in[y + 1]), centre));
}

// Component c's samples, [ch][cw], through the SIMD islow IDCT: the dequantising product kept to 16 bits
// (pmullw, which wraps); pass 1 over the columns, or where every coefficient outside the first row is zero the
// shortcut in0 << PASS1_BITS in 16 bits (psllw, which wraps where the full pass saturates); pass 2 over the rows;
// the result packed to 8 bits with saturation and offset by 128 (packsswb, paddb).
std::vector<int32_t> plane(Decoder& dec, const Component& c) {
  std::vector<int32_t> out((size_t)c.cw * c.ch);
  alignas(16) int16_t q16[64];  // quantval as ISLOW_MULT_TYPE (short)
  for (int i = 0; i < 64; i++) q16[i] = (int16_t)(uint16_t)c.q[i];
  int nbw = (c.cw + 7) / 8, nbh = (c.ch + 7) / 8;
  alignas(16) uint8_t px[64];
  for (int br = 0; br < nbh; br++)
    for (int bc = 0; bc < nbw; bc++) {
      idct_block(&c.coef[((size_t)br * c.bw + bc) * 64], q16, px);
      int ny = c.ch - br * 8 < 8 ? c.ch - br * 8 : 8, nx = c.cw - bc * 8 < 8 ? c.cw - bc * 8 : 8;
      for (int y = 0; y < ny; y++) {
        int32_t* o = &out[(size_t)(br * 8 + y) * c.cw + bc * 8];
        for (int x = 0; x < nx; x++) o[x] = px[8 * y + x];
      }
    }
  return out;
}

// libjpeg-turbo's upsampling of one component by (fx, fy), to [h][w] (cropped).
std::vector<int32_t> upsample(const std::vector<int32_t>& p, int cw, int ch, int fx, int fy, int w, int h) {
  std::vector<int32_t> out((size_t)w * h);
  auto at = [&](int y, int x) {
    y = y < 0 ? 0 : (y >= ch ? ch - 1 : y);
    x = x < 0 ? 0 : (x >= cw ? cw - 1 : x);
    return p[(size_t)y * cw + x];
  };
  bool box = fx == 2 && cw <= 2;  // the 2x-wide filters need more than 2 samples
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++) {
      int32_t v;
      int r = y / fy, k = x / fx;
      if ((fx == 1 && fy == 1) || box) {
        v = at(r, k);
      } else if (fy == 1) {  // h2v1
        int c = at(r, k);
        v = (x & 1) ? (3 * c + at(r, k + 1) + 2) >> 2 : (3 * c + at(r, k - 1) + 1) >> 2;
      } else if (fx == 1) {  // h1v2
        int c = at(r, k);
        v = (y & 1) ? (3 * c + at(r + 1, k) + 2) >> 2 : (3 * c + at(r - 1, k) + 1) >> 2;
      } else {  // h2v2
        int near = (y & 1) ? r + 1 : r - 1;
        int s = 3 * at(r, k) + at(near, k);
        if (x & 1) {
          int nxt = 3 * at(r, k + 1) + at(near, k + 1);
          v = (3 * s + nxt + 7) >> 4;
        } else {
          int last = 3 * at(r, k - 1) + at(near, k - 1);
          v = (3 * s + last + 8) >> 4;
        }
      }
      out[(size_t)y * w + x] = v;
    }
  return out;
}

// jdlossls.c's undifferencing of lossless component ci and the point transform, [ch][cw].
std::vector<int32_t> lossless_plane(Decoder& dec, int ci) {
  const Component& c = dec.comps[ci];
  if (!dec.have_plane[ci]) dec.fail("marker 0xFFDA: a component no scan names (lossless)");
  const std::vector<int32_t>& d = dec.diffs[ci];
  int w = c.cw, h = c.ch, psv = dec.psv[ci], pt = dec.pt[ci];
  const std::vector<uint8_t>& first = dec.first_rows[ci];
  std::vector<int32_t> out((size_t)w * h);
  for (int y = 0; y < h; y++) {
    const int32_t* dy = &d[(size_t)y * c.bw];
    int32_t* row = &out[(size_t)y * w];
    if (y == 0 || first[y]) {  // jpeg_undifference_first_row
      int32_t ra = (dy[0] + (1 << (7 - pt))) & 0xFFFF;
      row[0] = ra;
      for (int x = 1; x < w; x++) row[x] = ra = (dy[x] + ra) & 0xFFFF;
    } else {
      const int32_t* prev = &out[(size_t)(y - 1) * w];
      int32_t rb = prev[0], ra = (dy[0] + rb) & 0xFFFF;  // the first column predicts from above
      row[0] = ra;
      for (int x = 1; x < w; x++) {
        int32_t rc = rb, p;
        rb = prev[x];
        switch (psv) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = ra + rb - rc; break;
          case 5: p = ra + ((rb - rc) >> 1); break;
          case 6: p = rb + ((ra - rc) >> 1); break;
          default: p = (ra + rb) >> 1; break;
        }
        row[x] = ra = (dy[x] + p) & 0xFFFF;
      }
    }
  }
  for (auto& v : out) v = (v << pt) & 0xFF;
  return out;
}

// libjpeg's output: each component upsampled to the image size (fancy after the IDCT, box for lossless).
std::vector<std::vector<int32_t>> upsampled(Decoder& dec) {
  std::vector<std::vector<int32_t>> planes;
  for (int ci = 0; ci < (int)dec.comps.size(); ci++) {
    const Component& c = dec.comps[ci];
    int fx = dec.hmax / c.h, fy = dec.vmax / c.v;
    if (dec.lossless) {
      std::vector<int32_t> p = lossless_plane(dec, ci), o((size_t)dec.width * dec.height);
      for (int y = 0; y < dec.height; y++)
        for (int x = 0; x < dec.width; x++) o[(size_t)y * dec.width + x] = p[(size_t)(y / fy) * c.cw + x / fx];
      planes.push_back(std::move(o));
    } else {
      planes.push_back(upsample(plane(dec, c), c.cw, c.ch, fx, fy, dec.width, dec.height));
    }
  }
  return planes;
}

// jdcolor.c build_ycc_rgb_table (SCALEBITS 16): R, G, B of (y, cb, cr), range-limited.
struct YccTables {
  int64_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = 1 << 15;
    const int64_t f1_402 = (int64_t)(1.40200 * 65536 + 0.5), f1_772 = (int64_t)(1.77200 * 65536 + 0.5);
    const int64_t f0_714 = (int64_t)(0.71414 * 65536 + 0.5), f0_344 = (int64_t)(0.34414 * 65536 + 0.5);
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = (f1_402 * x + one_half) >> 16;
      cb_b[i] = (f1_772 * x + one_half) >> 16;
      cr_g[i] = -f0_714 * x;
      cb_g[i] = -f0_344 * x + one_half;
    }
  }
  void rgb(int64_t y, int cb, int cr, int* v) const {
    v[0] = clamp255(y + cr_r[cr]);
    v[1] = clamp255(y + ((cb_g[cb] + cr_g[cr]) >> 16));
    v[2] = clamp255(y + cb_b[cb]);
  }
};

void to_rgb(Decoder& dec, uint8_t* out) {
  int w = dec.width, h = dec.height;
  std::vector<std::vector<int32_t>> planes = upsampled(dec);
  size_t npx = (size_t)w * h;
  if (dec.colour == Decoder::kGrey) {
    for (size_t i = 0; i < npx; i++) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = (uint8_t)planes[0][i];
    return;
  }
  if (dec.colour == Decoder::kRGB) {
    for (size_t i = 0; i < npx; i++)
      for (int k = 0; k < 3; k++) out[3 * i + k] = (uint8_t)planes[k][i];
    return;
  }
  YccTables t;
  for (size_t i = 0; i < npx; i++) {
    int v[3];  // RGB; for CMYK / YCCK, 255 - C as Pillow's CMYK;I gives it
    if (dec.colour == Decoder::kCMYK) {
      for (int k = 0; k < 3; k++) v[k] = 255 - planes[k][i];
    } else {  // YCbCr, or YCCK's YCC: C = 255 - R, range-limited (ycck_cmyk_convert)
      t.rgb(planes[0][i], planes[1][i], planes[2][i], v);
    }
    if (dec.colour == Decoder::kYCbCr) {
      for (int k = 0; k < 3; k++) out[3 * i + k] = (uint8_t)v[k];
    } else {  // Convert.c's cmyk2rgb: K - MULDIV255(255 - C, K)
      int kk = planes[3][i];
      for (int k = 0; k < 3; k++) {
        int tt = v[k] * kk + 128;
        out[3 * i + k] = (uint8_t)(kk - (((tt >> 8) + tt) >> 8));
      }
    }
  }
}

// decode_samples: libjpeg's output samples, [h][w][channels]: RGB for YCbCr, CMYK for YCCK (C = 255 - R), every
// component as it is otherwise.
void to_samples(Decoder& dec, uint8_t* out, int channels) {
  std::vector<std::vector<int32_t>> planes = upsampled(dec);
  size_t npx = (size_t)dec.width * dec.height;
  if (dec.colour == Decoder::kYCbCr || dec.colour == Decoder::kYCCK) {
    YccTables t;
    for (size_t i = 0; i < npx; i++) {
      int v[3];
      t.rgb(planes[0][i], planes[1][i], planes[2][i], v);
      for (int k = 0; k < 3; k++) out[channels * i + k] = (uint8_t)(dec.colour == Decoder::kYCCK ? 255 - v[k] : v[k]);
      if (channels == 4) out[4 * i + 3] = (uint8_t)planes[3][i];
    }
    return;
  }
  for (size_t i = 0; i < npx; i++)
    for (int k = 0; k < channels; k++) out[channels * i + k] = (uint8_t)planes[k][i];
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// size[0] = width, size[1] = height of the JPEG in data[0, n); 0 on success.
int uniir_jpeg_info(const uint8_t* data, size_t n, int* size, char* err, int errlen) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = n;
    parse(dec, true);
    if (dec.comps.empty()) dec.fail("no frame header");
    size[0] = dec.width;
    size[1] = dec.height;
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "out of memory or internal error decoding the JPEG");
  }
  return 1;
}

// Decodes into out, uint8 [h][w][3] (h and w from uniir_jpeg_info); 0 on success.
int uniir_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, int w, int h, char* err, int errlen) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = n;
    parse(dec, false);
    if (dec.width != w || dec.height != h) dec.fail("size %d x %d differs from the one asked for", dec.width, dec.height);
    to_rgb(dec, out);
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "out of memory or internal error decoding the JPEG");
  }
  return 1;
}

// decode_samples with `colour` -1 (the markers' colour space) or a Colour to use instead (kYCbCr, or kRGB:
// every component as it is, libtiff's JCS_UNKNOWN); size[0..2] = width, height, channels (the components);
// `libtiff`: the markers past a single-scan frame's scan read as libtiff's JPEG codec reads a strip.
int uniir_jpeg_samples_info(const uint8_t* data, size_t n, int colour, int* size, char* err, int errlen) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = n;
    parse(dec, true);
    if (dec.comps.empty()) dec.fail("no frame header");
    size[0] = dec.width;
    size[1] = dec.height;
    size[2] = (int)dec.comps.size();
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "out of memory or internal error decoding the JPEG");
  }
  return 1;
}

int uniir_jpeg_decode_samples(const uint8_t* data, size_t n, int colour, int libtiff, uint8_t* out, int w, int h,
                              int channels, char* err, int errlen) {
  try {
    Decoder dec;
    dec.d = data;
    dec.n = n;
    dec.libtiff = libtiff != 0;
    parse(dec, false, colour);
    if (dec.width != w || dec.height != h) dec.fail("size %d x %d differs from the one asked for", dec.width, dec.height);
    if (channels != (int)dec.comps.size()) dec.fail("%d channels asked for, %d decoded", channels, (int)dec.comps.size());
    to_samples(dec, out, channels);
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "out of memory or internal error decoding the JPEG");
  }
  return 1;
}

}  // extern "C"
