// Baseline and progressive JPEG decoder: host code, no kernel.
//
// The native twin of uniir_tpu_torch/data/jpeg.py::decode_twin, which is the
// reference: the same function, bit for bit -- what Pillow's
// `Image.open(path).convert("RGB")` gives through libjpeg-turbo at its
// defaults: jdhuff.c's sequential and jdphuff.c's progressive Huffman
// decoding (DC first / refinement scans, AC first scans with EOB runs, AC
// refinement scans) into one coefficient buffer over all scans, each
// component's quantisation table latched at its first scan (jdinput.c),
// jidctint.c's integer IDCT (CONST_BITS 13, PASS1_BITS 2, the
// 10-bit range-limit table), jdsample.c's fancy upsampling (h2v1, h1v2, h2v2
// triangle filters with their alternating rounding bias, edges replicated;
// box replication where a 2x-wide component is at most 2 samples wide),
// the colour space jdapimin.c's default_decompress_parms picks (3
// components: YCbCr under JFIF, RGB under Adobe transform 0 or, without
// either marker, ids 'R' 'G' 'B'; 4: CMYK under Adobe transform 0 or none,
// else YCCK), jdcolor.c's fixed-point YCbCr -> RGB tables (YCCK's YCC
// through the same tables), RGB copied, CMYK read as Pillow reads it
// (inverted, `CMYK;I`) and converted by Convert.c's cmyk2rgb, a greyscale
// image copied into three channels.  Accepted and rejected forms are the
// twin's (see its module docstring); a rejected, truncated or corrupt
// stream returns an error with a message, never reads or writes out of
// bounds.
//
// Why host code and not a kernel: Huffman decoding is serial within a scan,
// and the images are resized on the host after decoding; a device IDCT would
// add a copy each way.  The decoder keeps no global state, so the loader's
// threads (ctypes releases the GIL) decode in parallel.
//
// Built by uniir_tpu_torch/_build.py with nvcc like the kernels' sources.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
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

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int cw = 0, ch = 0;  // sampled width and height
  int bw = 0, bh = 0;  // padded block grid (MCU multiples)
  std::vector<int16_t> coef;  // [bh * bw * 64], natural order
  int64_t q[64] = {0};  // the quantisation table latched at the component's first scan; zeros if none
  bool latched = false;
  int coef_bits[64];  // jdphuff.c: the Al each zigzag position was last sent at; -1: never
  Component() {
    for (int& b : coef_bits) b = -1;
  }
};

struct Scan {
  int n;
  int comp[4], dc[4], ac[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 2;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int64_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  std::vector<uint16_t> huff[2][4];  // (code length << 8) | symbol for each 16-bit window; 0: no code
  int restart = 0;
  int n_scans = 0;
  bool progressive = false;
  bool jfif = false;
  int adobe_transform = -1;
  enum Colour { kGrey, kYCbCr, kRGB, kCMYK, kYCCK } colour = kGrey;

  [[noreturn]] void fail(const char* fmt, int a = 0, int b = 0) {
    char buf[200];
    snprintf(buf, sizeof(buf), fmt, a, b);
    throw Error{buf};
  }
};

// ---------------------------------------------------------------- bit reader

struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int bits = 0;
  bool at_marker = false;
  int64_t real_bits = 0, used_bits = 0;  // bits from the stream / consumed; past the end the reader feeds zeros

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
};

inline int extend(uint32_t v, int s) { return v < (1u << (s - 1)) ? (int)v + 1 - (1 << s) : (int)v; }

inline int16_t to16(int64_t v) { return (int16_t)(uint16_t)(v & 0xFFFF); }  // JCOEF is 16-bit

inline uint32_t get_bits(BitReader& br, int n) {
  if (!n) return 0;
  uint32_t v = br.peek32() >> (32 - n);
  br.skip(n);
  return v;
}

inline int huff(Decoder& dec, BitReader& br, const std::vector<uint16_t>& lut) {
  uint16_t e = lut[br.peek32() >> 16];
  if (!e) dec.fail("marker 0xFFDA: corrupt Huffman code");
  br.skip(e >> 8);
  return e & 0xFF;
}

// jdphuff.c's decode_mcu_DC_first / _DC_refine for one block
void dc_first(Decoder& dec, BitReader& br, const std::vector<uint16_t>& lut, int al, int64_t& pred, int16_t* out) {
  int s = huff(dec, br, lut);
  if (s > 15) dec.fail("marker 0xFFDA: corrupt DC difference");
  pred += s ? extend(get_bits(br, s), s) : 0;
  out[0] = to16(pred * ((int64_t)1 << al));
}

// A correction bit of an already-nonzero coefficient.
inline void refine(BitReader& br, int16_t* c, int p1) {
  if (get_bits(br, 1) && !(*c & p1)) *c = to16(*c >= 0 ? *c + p1 : *c - p1);
}

// decode_mcu_AC_first over one block; returns the EOB run left.
int64_t ac_first(Decoder& dec, BitReader& br, const std::vector<uint16_t>& lut, const Scan& sc, int64_t eobrun,
                 int16_t* out) {
  if (eobrun) return eobrun - 1;
  for (int k = sc.ss; k <= sc.se; k++) {
    int rs = huff(dec, br, lut), r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      if (k > sc.se) dec.fail("marker 0xFFDA: corrupt run length");
      out[kZigzag[k]] = to16((int64_t)extend(get_bits(br, s), s) * ((int64_t)1 << sc.al));
    } else if (r == 15) {
      k += 15;
    } else {
      return ((int64_t)1 << r) + get_bits(br, r) - 1;
    }
  }
  return 0;
}

// decode_mcu_AC_refine over one block; returns the EOB run left.
int64_t ac_refine(Decoder& dec, BitReader& br, const std::vector<uint16_t>& lut, const Scan& sc, int64_t eobrun,
                  int16_t* out) {
  int p1 = 1 << sc.al, k = sc.ss;
  if (!eobrun) {
    for (; k <= sc.se; k++) {
      int rs = huff(dec, br, lut), r = rs >> 4, s = rs & 15;
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
      if (s) {
        if (k > sc.se) dec.fail("marker 0xFFDA: corrupt run length");
        out[kZigzag[k]] = (int16_t)s;
      }
    }
  }
  if (eobrun) {
    for (; k <= sc.se; k++)  // the band's rest after the end of block: corrections only
      if (out[kZigzag[k]]) refine(br, &out[kZigzag[k]], p1);
    eobrun--;
  }
  return eobrun;
}

void decode_block(Decoder& dec, BitReader& br, const std::vector<uint16_t>& dc, const std::vector<uint16_t>& ac,
                  int64_t& pred, int16_t* out) {
  uint32_t w = br.peek32();
  uint16_t e = dc[w >> 16];
  if (!e) dec.fail("marker 0xFFDA: corrupt Huffman code");
  int len = e >> 8, s = e & 0xFF;
  if (s > 11) dec.fail("marker 0xFFDA: corrupt DC difference");
  int64_t diff = s ? extend((w >> (32 - len - s)) & ((1u << s) - 1), s) : 0;
  br.skip(len + s);
  pred += diff;
  out[0] = (int16_t)(uint16_t)(pred & 0xFFFF);  // JCOEF is 16-bit
  for (int k = 1; k < 64;) {
    w = br.peek32();
    e = ac[w >> 16];
    if (!e) dec.fail("marker 0xFFDA: corrupt Huffman code");
    len = e >> 8;
    int rs = e & 0xFF, run = rs >> 4;
    s = rs & 15;
    if (s) {
      k += run;
      if (k > 63) dec.fail("marker 0xFFDA: corrupt run length");
      out[kZigzag[k]] = (int16_t)extend((w >> (32 - len - s)) & ((1u << s) - 1), s);
      br.skip(len + s);
      k++;
    } else {
      br.skip(len);
      if (run != 15) break;
      k += 16;
    }
  }
}

// ------------------------------------------------------------------ markers

int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

const char* sof_name(int m) {
  switch (m) {
    case 0xC1: return "SOF1 (extended sequential)";
    case 0xC3: return "SOF3 (lossless)";
    case 0xC5: return "SOF5 (differential sequential)";
    case 0xC6: return "SOF6 (differential progressive)";
    case 0xC7: return "SOF7 (differential lossless)";
    case 0xC9: return "SOF9 (arithmetic sequential)";
    case 0xCA: return "SOF10 (arithmetic progressive)";
    case 0xCB: return "SOF11 (arithmetic lossless)";
    case 0xCD: return "SOF13 (arithmetic differential sequential)";
    case 0xCE: return "SOF14 (arithmetic differential progressive)";
    case 0xCF: return "SOF15 (arithmetic differential lossless)";
    case 0xCC: return "DAC (arithmetic coding)";
    case 0xC8: return "JPG";
    case 0xDC: return "DNL";
    default: return nullptr;
  }
}

void read_sof(Decoder& dec, const uint8_t* seg, int len) {
  if (!dec.comps.empty()) dec.fail("marker 0xFFC0: a second frame header");
  if (len < 6) dec.fail("marker 0xFFC0: truncated frame header");
  int precision = seg[0], nc = seg[5];
  dec.height = u16(seg + 1);
  dec.width = u16(seg + 3);
  if (precision != 8) dec.fail("marker 0xFFC0: %d-bit samples are not supported (8 only)", precision);
  if (nc != 1 && nc != 3 && nc != 4) dec.fail("marker 0xFFC0: %d components are not supported (1, 3 or 4)", nc);
  if (dec.height == 0 || dec.width == 0) dec.fail("marker 0xFFC0: image size %d x %d (DNL is not supported)", dec.width, dec.height);
  if (len != 6 + 3 * nc) dec.fail("marker 0xFFC0: bad frame header length");
  for (int c = 0; c < nc; c++) {
    Component comp;
    comp.id = seg[6 + 3 * c];
    comp.h = seg[7 + 3 * c] >> 4;
    comp.v = seg[7 + 3 * c] & 15;
    comp.tq = seg[8 + 3 * c];
    if (comp.h < 1 || comp.h > 4 || comp.v < 1 || comp.v > 4 || comp.tq > 3)
      dec.fail("marker 0xFFC0: bad sampling factors or table id");
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
      dec.fail("marker 0xFFC0: sampling %dx%d is not supported", c.h, c.v);
  }
  dec.mcux = (dec.width + 8 * dec.hmax - 1) / (8 * dec.hmax);
  dec.mcuy = (dec.height + 8 * dec.vmax - 1) / (8 * dec.vmax);
  for (auto& c : dec.comps) {
    c.cw = (int)(((int64_t)dec.width * c.h + dec.hmax - 1) / dec.hmax);
    c.ch = (int)(((int64_t)dec.height * c.v + dec.vmax - 1) / dec.vmax);
    c.bw = dec.mcux * c.h;
    c.bh = dec.mcuy * c.v;
  }
}

void read_dqt(Decoder& dec, const uint8_t* seg, int len) {
  int k = 0;
  while (k < len) {
    int pq = seg[k] >> 4, tq = seg[k] & 15, size = pq ? 128 : 64;
    if (pq > 1 || tq > 3 || k + 1 + size > len) dec.fail("marker 0xFFDB: bad quantisation table");
    for (int i = 0; i < 64; i++)
      dec.qt[tq][kZigzag[i]] = pq ? u16(seg + k + 1 + 2 * i) : seg[k + 1 + i];
    dec.qt_defined[tq] = true;
    k += 1 + size;
  }
}

void read_dht(Decoder& dec, const uint8_t* seg, int len) {
  int k = 0;
  while (k < len) {
    if (k + 17 > len) dec.fail("marker 0xFFC4: bad Huffman table");
    int tc = seg[k] >> 4, th = seg[k] & 15, total = 0;
    for (int i = 0; i < 16; i++) total += seg[k + 1 + i];
    if (tc > 1 || th > 3 || total > 256 || k + 17 + total > len) dec.fail("marker 0xFFC4: bad Huffman table");
    std::vector<uint16_t>& lut = dec.huff[tc][th];
    lut.assign(65536, 0);
    const uint8_t* sym = seg + k + 17;
    uint32_t code = 0;
    int s = 0;
    for (int length = 1; length <= 16; length++) {
      for (int i = 0; i < seg[k + length]; i++) {
        if (code >= (1u << length)) dec.fail("marker 0xFFC4: bad Huffman table (DHT)");
        uint32_t lo = code << (16 - length), hi = (code + 1) << (16 - length);
        for (uint32_t x = lo; x < hi; x++) lut[x] = (uint16_t)((length << 8) | sym[s]);
        code++;
        s++;
      }
      code <<= 1;
    }
    k += 17 + total;
  }
}

// Decodes the scan whose header is `seg`; on return dec.pos is at the marker after it.
void read_scan(Decoder& dec, const uint8_t* seg, int len, size_t data_start) {
  if (dec.comps.empty()) dec.fail("marker 0xFFDA: a scan before the frame header");
  int ns = len ? seg[0] : 0;
  if (ns < 1 || ns > (int)dec.comps.size() || len != 4 + 2 * ns) dec.fail("marker 0xFFDA: bad scan header");
  Scan scan;
  scan.n = ns;
  scan.ss = seg[1 + 2 * ns];
  scan.se = seg[2 + 2 * ns];
  scan.ah = seg[3 + 2 * ns] >> 4;
  scan.al = seg[3 + 2 * ns] & 15;
  if (!dec.progressive && (scan.ss != 0 || scan.se != 63 || scan.ah != 0 || scan.al != 0))
    dec.fail("marker 0xFFDA: spectral selection %d..%d is not baseline", scan.ss, scan.se);
  if (dec.progressive && ((scan.ss == 0 ? scan.se != 0 : (scan.ss > scan.se || scan.se > 63 || ns != 1)) ||
                          (scan.ah && scan.al != scan.ah - 1) || scan.al > 13))  // jdphuff.c's checks
    dec.fail("marker 0xFFDA: bad progression: spectral selection %d..%d", scan.ss, scan.se);
  bool needs_dc = scan.ss == 0 && scan.ah == 0, needs_ac = scan.se > 0;  // a DC refinement reads no table
  for (int s = 0; s < ns; s++) {
    int cid = seg[1 + 2 * s], t = seg[2 + 2 * s], found = -1;
    for (int c = 0; c < (int)dec.comps.size(); c++)
      if (dec.comps[c].id == cid && found < 0) found = c;
    if (found < 0) dec.fail("marker 0xFFDA: scan names an unknown component %d", cid);
    scan.comp[s] = found;
    scan.dc[s] = needs_dc ? t >> 4 : 0;  // a table the scan does not read is not looked up
    scan.ac[s] = needs_ac ? t & 15 : 0;
    if (needs_dc && (scan.dc[s] > 3 || dec.huff[0][scan.dc[s]].empty()))
      dec.fail("marker 0xFFDA: scan uses an undefined DC Huffman table %d", scan.dc[s]);
    if (needs_ac && (scan.ac[s] > 3 || dec.huff[1][scan.ac[s]].empty()))
      dec.fail("marker 0xFFDA: scan uses an undefined AC Huffman table %d", scan.ac[s]);
    Component& c = dec.comps[found];
    if (!c.latched) {  // jdinput.c latches a component's table at its first scan
      if (!dec.qt_defined[c.tq]) dec.fail("marker 0xFFDA: component uses an undefined quantisation table %d", c.tq);
      for (int i = 0; i < 64; i++) c.q[i] = dec.qt[c.tq][i];
      c.latched = true;
    }
    for (int k = scan.ss; k <= scan.se; k++) c.coef_bits[k] = scan.al;
  }
  if (ns > 1) {  // jdinput.c's per_scan_setup: D_MAX_BLOCKS_IN_MCU
    int blocks = 0;
    for (int s = 0; s < ns; s++) blocks += dec.comps[scan.comp[s]].h * dec.comps[scan.comp[s]].v;
    if (blocks > 10) dec.fail("marker 0xFFDA: more than 10 blocks in an MCU (sampling factors too large for an interleaved scan)");
  }
  for (auto& c : dec.comps)
    if (c.coef.empty()) c.coef.assign((size_t)c.bh * c.bw * 64, 0);

  bool single = ns == 1;
  int units_x, units_y;
  if (single) {
    const Component& c = dec.comps[scan.comp[0]];
    units_x = (c.cw + 7) / 8;
    units_y = (c.ch + 7) / 8;
  } else {
    units_x = dec.mcux;
    units_y = dec.mcuy;
  }
  int64_t total = (int64_t)units_x * units_y;
  int64_t interval = dec.restart ? dec.restart : total;
  BitReader br{dec.d, dec.n, data_start};
  int64_t pred[4] = {0, 0, 0, 0}, eobrun = 0;
  for (int64_t u = 0; u < total; u++) {
    if (u > 0 && u % interval == 0) {
      // the interval's leftover bits are dropped; the next one starts after an RSTn marker
      size_t p = br.pos;
      for (;;) {
        while (p < dec.n && dec.d[p] != 0xFF) p++;
        size_t q = p + 1;
        while (q < dec.n && dec.d[q] == 0xFF) q++;
        if (q >= dec.n) dec.fail("marker 0xFFDA: truncated JPEG stream (no marker after the scan)");
        if (dec.d[q] == 0x00) {
          p = q + 1;
          continue;
        }
        if (dec.d[q] < 0xD0 || dec.d[q] > 0xD7)
          dec.fail("marker 0xFFDA: corrupt or truncated scan (expected %d restart intervals)", (int)((total + interval - 1) / interval));
        p = q + 1;
        break;
      }
      br = BitReader{dec.d, dec.n, p};
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
    }
    int r = (int)(u / units_x), q = (int)(u % units_x);
    for (int s = 0; s < ns; s++) {
      Component& c = dec.comps[scan.comp[s]];
      const auto& dc = dec.huff[0][scan.dc[s]];
      const auto& ac = dec.huff[1][scan.ac[s]];
      int ny = single ? 1 : c.v, nx = single ? 1 : c.h;
      for (int y = 0; y < ny; y++)
        for (int x = 0; x < nx; x++) {
          int row = single ? r : r * c.v + y, col = single ? q : q * c.h + x;
          int16_t* out = &c.coef[((size_t)row * c.bw + col) * 64];
          if (!dec.progressive) {
            decode_block(dec, br, dc, ac, pred[s], out);
          } else if (scan.ss == 0 && scan.ah == 0) {
            dc_first(dec, br, dc, scan.al, pred[s], out);
          } else if (scan.ss == 0) {
            if (get_bits(br, 1)) out[0] = to16(out[0] | (1 << scan.al));
          } else {
            eobrun = scan.ah ? ac_refine(dec, br, ac, scan, eobrun, out) : ac_first(dec, br, ac, scan, eobrun, out);
          }
          if (br.used_bits > br.real_bits) dec.fail("marker 0xFFDA: truncated JPEG stream");
        }
    }
  }
  // on to the next marker that is not RSTn
  size_t p = br.pos;
  for (;;) {
    while (p < dec.n && dec.d[p] != 0xFF) p++;
    size_t q = p + 1;
    while (q < dec.n && dec.d[q] == 0xFF) q++;
    if (q >= dec.n) dec.fail("truncated JPEG stream (no marker after the scan)");
    if (dec.d[q] == 0x00 || (dec.d[q] >= 0xD0 && dec.d[q] <= 0xD7)) {
      p = q + 1;
      continue;
    }
    dec.pos = q - 1;
    break;
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

// Reads markers up to EOI (or, with `header_only`, up to the frame header).
void parse(Decoder& dec, bool header_only) {
  if (dec.n < 2 || dec.d[0] != 0xFF || dec.d[1] != 0xD8) dec.fail("not a JPEG file (no SOI marker)");
  for (;;) {
    size_t i = dec.pos;
    while (i + 1 < dec.n && dec.d[i] == 0xFF && dec.d[i + 1] == 0xFF) i++;
    if (i + 1 >= dec.n) dec.fail("truncated JPEG stream (no EOI marker)");
    if (dec.d[i] != 0xFF) dec.fail("corrupt JPEG stream (expected a marker at byte %d)", (int)i);
    int marker = dec.d[i + 1];
    if (marker == 0xD9) break;
    if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) {
      dec.pos = i + 2;
      continue;
    }
    if (i + 4 > dec.n) dec.fail("truncated JPEG stream (marker 0xFF%02X)", marker);
    int length = u16(dec.d + i + 2);
    if (length < 2 || i + 2 + (size_t)length > dec.n) dec.fail("truncated JPEG stream (marker 0xFF%02X)", marker);
    const uint8_t* seg = dec.d + i + 4;
    int len = length - 2;
    if (const char* name = sof_name(marker)) {
      char buf[160];
      snprintf(buf, sizeof(buf), "marker 0xFF%02X: %s is not supported (baseline SOF0 and progressive SOF2 only)",
               marker, name);
      throw Error{buf};
    }
    if (marker == 0xC0 || marker == 0xC2) {
      dec.progressive = marker == 0xC2;
      read_sof(dec, seg, len);
      if (header_only) return;
    } else if (marker == 0xDB) {
      read_dqt(dec, seg, len);
    } else if (marker == 0xC4) {
      read_dht(dec, seg, len);
    } else if (marker == 0xDD) {
      if (len != 2) dec.fail("marker 0xFFDD: bad restart interval");
      dec.restart = u16(seg);
    } else if (marker == 0xDA) {
      if (header_only) dec.fail("marker 0xFFDA: a scan before the frame header");
      read_scan(dec, seg, len, i + 2 + length);
      dec.n_scans++;
      continue;
    } else if (((marker == 0xE0 && len >= 4 && memcmp(seg, "JFIF", 4) == 0) ||
                (marker == 0xEE && len >= 5 && memcmp(seg, "Adobe", 5) == 0)) && len < 7) {
      // Pillow reads the segment's version
      dec.fail(marker == 0xE0 ? "marker 0xFFE0: truncated JFIF segment" : "marker 0xFFEE: truncated Adobe segment");
    } else if (marker == 0xE0 && len >= 14 && memcmp(seg, "JFIF\0", 5) == 0) {
      dec.jfif = true;
    } else if (marker == 0xEE && len >= 12 && memcmp(seg, "Adobe", 5) == 0) {
      dec.adobe_transform = seg[11];
    } else if (!((marker >= 0xE0 && marker <= 0xEF) || marker == 0xFE)) {
      dec.fail("marker 0xFF%02X: unexpected marker", marker);
    }
    dec.pos = i + 2 + length;
  }
  if (dec.comps.empty() || dec.n_scans == 0) dec.fail("no frame or no scan before EOI");
  if (dec.comps.size() == 4) {
    dec.colour = dec.adobe_transform <= 0 ? Decoder::kCMYK : Decoder::kYCCK;
  } else if (dec.comps.size() == 3) {
    bool rgb_ids = dec.comps[0].id == 82 && dec.comps[1].id == 71 && dec.comps[2].id == 66;
    if (dec.jfif) dec.colour = Decoder::kYCbCr;
    else if (dec.adobe_transform >= 0) dec.colour = dec.adobe_transform == 0 ? Decoder::kRGB : Decoder::kYCbCr;
    else dec.colour = rgb_ids ? Decoder::kRGB : Decoder::kYCbCr;
  }
  if (dec.progressive && smooths(dec))
    dec.fail("marker 0xFFDA: the scans leave low coefficients unrefined, which libjpeg decodes with block smoothing "
             "(not supported)");
}

// ------------------------------------------------------------- pixel stages

const int64_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433, F0_765366865 = 6270,
              F0_899976223 = 7373, F1_175875602 = 9633, F1_501321110 = 12299, F1_847759065 = 15137,
              F1_961570560 = 16069, F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

// One jpeg_idct_islow pass over 8 inputs; outputs DESCALEd by `shift`.
inline void idct_pass(const int64_t* x, int64_t* out, int shift) {
  int64_t z1 = (x[2] + x[6]) * F0_541196100;
  int64_t tmp2 = z1 + x[6] * -F1_847759065;
  int64_t tmp3 = z1 + x[2] * F0_765366865;
  int64_t tmp0 = (x[0] + x[4]) * 8192, tmp1 = (x[0] - x[4]) * 8192;  // << CONST_BITS
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  z1 = t0 + t3;
  int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  int64_t z5 = (z3 + z4) * F1_175875602;
  t0 *= F0_298631336;
  t1 *= F2_053119869;
  t2 *= F3_072711026;
  t3 *= F1_501321110;
  z1 *= -F0_899976223;
  z2 *= -F2_562915447;
  z3 = z3 * -F1_961570560 + z5;
  z4 = z4 * -F0_390180644 + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  int64_t half = (int64_t)1 << (shift - 1);
  out[0] = (tmp10 + t3 + half) >> shift;
  out[1] = (tmp11 + t2 + half) >> shift;
  out[2] = (tmp12 + t1 + half) >> shift;
  out[3] = (tmp13 + t0 + half) >> shift;
  out[4] = (tmp13 - t0 + half) >> shift;
  out[5] = (tmp12 - t1 + half) >> shift;
  out[6] = (tmp11 - t2 + half) >> shift;
  out[7] = (tmp10 - t3 + half) >> shift;
}

inline int clamp255(int64_t v) { return v < 0 ? 0 : (v > 255 ? 255 : (int)v); }

// Component c's samples, [ch][cw].
std::vector<int32_t> plane(Decoder& dec, const Component& c) {
  std::vector<int32_t> out((size_t)c.cw * c.ch);
  const int64_t* q = c.q;
  int nbw = (c.cw + 7) / 8, nbh = (c.ch + 7) / 8;
  int64_t ws[64], in[8], res[8];
  for (int br = 0; br < nbh; br++)
    for (int bc = 0; bc < nbw; bc++) {
      const int16_t* coef = &c.coef[((size_t)br * c.bw + bc) * 64];
      for (int u = 0; u < 8; u++) {  // pass 1: columns
        for (int v = 0; v < 8; v++) in[v] = (int64_t)coef[v * 8 + u] * q[v * 8 + u];
        idct_pass(in, res, 11);  // CONST_BITS - PASS1_BITS
        for (int y = 0; y < 8; y++) ws[y * 8 + u] = res[y];
      }
      for (int y = 0; y < 8; y++) {  // pass 2: rows
        idct_pass(&ws[y * 8], res, 18);  // CONST_BITS + PASS1_BITS + 3
        int py = br * 8 + y;
        if (py >= c.ch) break;
        for (int x = 0; x < 8; x++) {
          int px = bc * 8 + x;
          if (px >= c.cw) break;
          int64_t s = ((res[x] + 512) & 1023) - 512 + 128;  // range_limit[x & RANGE_MASK]
          out[(size_t)py * c.cw + px] = clamp255(s);
        }
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

void to_rgb(Decoder& dec, uint8_t* out) {
  int w = dec.width, h = dec.height;
  std::vector<std::vector<int32_t>> planes;
  for (auto& c : dec.comps)
    planes.push_back(upsample(plane(dec, c), c.cw, c.ch, dec.hmax / c.h, dec.vmax / c.v, w, h));
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
  // jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
  int64_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
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
  for (size_t i = 0; i < npx; i++) {
    int v[3];  // RGB; for CMYK / YCCK, 255 - C as Pillow's CMYK;I gives it
    if (dec.colour == Decoder::kCMYK) {
      for (int k = 0; k < 3; k++) v[k] = 255 - planes[k][i];
    } else {  // YCbCr, or YCCK's YCC: C = 255 - R, range-limited (ycck_cmyk_convert)
      int64_t y = planes[0][i];
      int cb = planes[1][i], cr = planes[2][i];
      v[0] = clamp255(y + cr_r[cr]);
      v[1] = clamp255(y + ((cb_g[cb] + cr_g[cr]) >> 16));
      v[2] = clamp255(y + cb_b[cb]);
    }
    if (dec.colour == Decoder::kYCbCr) {
      for (int k = 0; k < 3; k++) out[3 * i + k] = (uint8_t)v[k];
    } else {  // Convert.c's cmyk2rgb: K - MULDIV255(255 - C, K)
      int kk = planes[3][i];
      for (int k = 0; k < 3; k++) {
        int t = v[k] * kk + 128;
        out[3 * i + k] = (uint8_t)(kk - (((t >> 8) + t) >> 8));
      }
    }
  }
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

}  // extern "C"
