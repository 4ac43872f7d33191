// RGB to a baseline JPEG file with Pillow's bytes: host code, no kernel.
//
// The native half of uniir_tpu_torch/data/jpeg_encode.py::encode_twin, which
// is the reference and whose docstring lists libjpeg-turbo 3.1's steps as
// Pillow 12.1's default save runs them: jccolor.c's fixed-point YCbCr,
// jcsample.c's h2v2_downsample with its 1, 2 bias, the edges repeated out to
// whole MCUs, jfdctint.c's integer DCT, jcdctmgr.c's quantisation through
// compute_reciprocal (16-bit DCTELEM), jccoefct.c's dummy blocks, the Annex K
// tables at quality 75 and jchuff.c's sequential Huffman coding.  One MCU row
// at a time: the planes of 16 rows, then each MCU's six blocks (Y TL, TR, BL,
// BR, Cb, Cr) transformed and coded at once.
//
// Why host code and not a kernel: the image pass that calls it decodes,
// resizes and writes one file at a time on the host's cores, and the entropy
// coder is serial.  No global state, so the pool's processes and threads
// encode in parallel.
//
// Built by uniir_tpu_torch/_build.py with nvcc like the kernels' sources.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
                         41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
                         30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kLumaQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
                        14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
                        18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
                        49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
                          99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                          99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jccolor.c's FIX(x) with SCALEBITS 16
const int64_t kScale = 16, kHalf = int64_t(1) << 15, kCbCrOffset = int64_t(128) << 16;
const int64_t kFix0299 = 19595, kFix0587 = 38470, kFix0114 = 7471, kFix016874 = 11059, kFix033126 = 21709,
              kFix05 = 32768, kFix041869 = 27439, kFix008131 = 5329;

struct Divisor {
  int64_t recip, corr, shift;
};

struct HuffTable {
  uint32_t code[256];
  int len[256];
};

void make_table(const uint8_t* bits, const uint8_t* vals, HuffTable* t) {
  memset(t, 0, sizeof(*t));
  uint32_t code = 0;
  int k = 0;
  for (int length = 1; length <= 16; ++length) {
    for (int i = 0; i < bits[length - 1]; ++i) {
      t->code[vals[k]] = code++;
      t->len[vals[k]] = length;
      ++k;
    }
    code <<= 1;
  }
}

// compute_reciprocal of divisor q << 3 with a 16-bit DCTELEM
Divisor reciprocal(int q) {
  int64_t d = int64_t(q) << 3;
  int b = 63 - __builtin_clzll(uint64_t(d));
  int64_t r = 16 + b;
  int64_t fq = (int64_t(1) << r) / d, fr = (int64_t(1) << r) % d, c = d / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= d / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r};
}

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jpeg_fdct_islow of one block of samples less 128, in place (natural order, scaled by 8)
void fdct_islow(int64_t* data) {
  const int C = 13, P = 2;
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < 8; ++i) {
      int64_t* p = pass == 0 ? data + 8 * i : data + i;
      const int s = pass == 0 ? 1 : 8;
      int64_t tmp0 = p[0] + p[7 * s], tmp7 = p[0] - p[7 * s];
      int64_t tmp1 = p[s] + p[6 * s], tmp6 = p[s] - p[6 * s];
      int64_t tmp2 = p[2 * s] + p[5 * s], tmp5 = p[2 * s] - p[5 * s];
      int64_t tmp3 = p[3 * s] + p[4 * s], tmp4 = p[3 * s] - p[4 * s];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int odd = pass == 0 ? C - P : C + P;
      if (pass == 0) {
        p[0] = (tmp10 + tmp11) * (1 << P);
        p[4 * s] = (tmp10 - tmp11) * (1 << P);
      } else {
        p[0] = descale(tmp10 + tmp11, P);
        p[4 * s] = descale(tmp10 - tmp11, P);
      }
      int64_t z1 = (tmp12 + tmp13) * 4433;
      p[2 * s] = descale(z1 + tmp13 * 6270, odd);
      p[6 * s] = descale(z1 + tmp12 * -15137, odd);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * 9633;
      tmp4 *= 2446;
      tmp5 *= 16819;
      tmp6 *= 25172;
      tmp7 *= 12299;
      z1 *= -7373;
      z2 *= -20995;
      z3 = z3 * -16069 + z5;
      z4 = z4 * -3196 + z5;
      p[7 * s] = descale(tmp4 + z1 + z3, odd);
      p[5 * s] = descale(tmp5 + z2 + z4, odd);
      p[3 * s] = descale(tmp6 + z2 + z3, odd);
      p[s] = descale(tmp7 + z1 + z4, odd);
    }
  }
}

struct BitWriter {
  uint8_t* out;
  size_t cap, pos = 0;
  uint64_t acc = 0;
  int nacc = 0;
  bool overflow = false;

  void byte(uint8_t b) {
    if (pos < cap) out[pos] = b;
    else overflow = true;
    ++pos;
  }
  void put(uint32_t value, int n) {  // n <= 32
    acc = (acc << n) | (value & ((uint64_t(1) << n) - 1));
    nacc += n;
    while (nacc >= 8) {
      uint8_t b = uint8_t(acc >> (nacc - 8));
      byte(b);
      if (b == 0xFF) byte(0);
      nacc -= 8;
    }
  }
  void flush() {  // pad with 1-bits
    if (nacc) put(0x7F, 8 - nacc);
  }
};

int nbits(int64_t v) {
  uint64_t a = uint64_t(v < 0 ? -v : v);
  return a ? 64 - __builtin_clzll(a) : 0;
}

struct Encoder {
  HuffTable dc[2], ac[2];
  Divisor div[2][64];
  int qt[2][64];

  Encoder() {
    make_table(kDcLumaBits, kDcVals, &dc[0]);
    make_table(kDcChromaBits, kDcVals, &dc[1]);
    make_table(kAcLumaBits, kAcLumaVals, &ac[0]);
    make_table(kAcChromaBits, kAcChromaVals, &ac[1]);
    for (int i = 0; i < 64; ++i) {
      int q0 = (kLumaQ[i] * 50 + 50) / 100, q1 = (kChromaQ[i] * 50 + 50) / 100;
      qt[0][i] = q0 < 1 ? 1 : q0 > 255 ? 255 : q0;
      qt[1][i] = q1 < 1 ? 1 : q1 > 255 ? 255 : q1;
      div[0][i] = reciprocal(qt[0][i]);
      div[1][i] = reciprocal(qt[1][i]);
    }
  }

  // samples [8][8] at `src` with row stride `stride` -> quantised coefficients in zigzag order
  void transform(const int32_t* src, int stride, int table, int64_t* zz) const {
    int64_t blk[64];
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) blk[8 * y + x] = src[y * stride + x] - 128;
    fdct_islow(blk);
    for (int k = 0; k < 64; ++k) {
      int64_t v = blk[kZigzag[k]];
      const Divisor& d = div[table][kZigzag[k]];
      int64_t q = ((v < 0 ? -v : v) + d.corr) * d.recip >> d.shift;
      zz[k] = v < 0 ? -q : q;
    }
  }

  void code_block(BitWriter& w, const int64_t* zz, int table, int64_t* last_dc) const {
    int64_t diff = zz[0] - *last_dc;
    *last_dc = zz[0];
    int n = nbits(diff);
    w.put(dc[table].code[n], dc[table].len[n]);
    if (n) w.put(uint32_t((diff < 0 ? diff - 1 : diff) & ((int64_t(1) << n) - 1)), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int64_t v = zz[k];
      if (!v) {
        ++run;
        continue;
      }
      while (run > 15) {
        w.put(ac[table].code[0xF0], ac[table].len[0xF0]);
        run -= 16;
      }
      int m = nbits(v), sym = (run << 4) | m;
      w.put(ac[table].code[sym], ac[table].len[sym]);
      w.put(uint32_t((v < 0 ? v - 1 : v) & ((int64_t(1) << m) - 1)), m);
      run = 0;
    }
    if (run) w.put(ac[table].code[0], ac[table].len[0]);
  }
};

void segment(BitWriter& w, uint8_t marker, const uint8_t* payload, size_t n) {
  w.byte(0xFF);
  w.byte(marker);
  w.byte(uint8_t((n + 2) >> 8));
  w.byte(uint8_t((n + 2) & 0xFF));
  for (size_t i = 0; i < n; ++i) w.byte(payload[i]);
}

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

// rgb: uint8 [h][w][3]; comment[0, comment_len) (none when 0); out: out_cap bytes, the file's length in
// *out_len.  0 on success, 1 with a message in err.
int uniir_jpeg_encode(const uint8_t* rgb, int w, int h, const uint8_t* comment, int comment_len, uint8_t* out,
                      size_t out_cap, size_t* out_len, char* err, int errlen) {
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535 || comment_len < 0 || comment_len > 65533) {
    set_error(err, errlen, "image size or comment length out of range");
    return 1;
  }
  const Encoder tables;
  const Encoder* enc = &tables;
  BitWriter bw{out, out_cap};
  bw.byte(0xFF);
  bw.byte(0xD8);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  segment(bw, 0xE0, jfif, sizeof(jfif));
  if (comment_len) segment(bw, 0xFE, comment, size_t(comment_len));
  for (int t = 0; t < 2; ++t) {
    uint8_t dqt[65];
    dqt[0] = uint8_t(t);
    for (int k = 0; k < 64; ++k) dqt[1 + k] = uint8_t(enc->qt[t][kZigzag[k]]);
    segment(bw, 0xDB, dqt, sizeof(dqt));
  }
  const uint8_t sof[15] = {8, uint8_t(h >> 8), uint8_t(h), uint8_t(w >> 8), uint8_t(w), 3, 1, 0x22, 0, 2, 0x11, 1,
                           3, 0x11, 1};
  segment(bw, 0xC0, sof, sizeof(sof));
  struct {
    int cls, table;
    const uint8_t *bits, *vals;
    int nvals;
  } dht[4] = {{0, 0, kDcLumaBits, kDcVals, 12},
              {1, 0, kAcLumaBits, kAcLumaVals, 162},
              {0, 1, kDcChromaBits, kDcVals, 12},
              {1, 1, kAcChromaBits, kAcChromaVals, 162}};
  for (auto& t : dht) {
    uint8_t payload[1 + 16 + 162];
    payload[0] = uint8_t(t.cls << 4 | t.table);
    memcpy(payload + 1, t.bits, 16);
    memcpy(payload + 17, t.vals, size_t(t.nvals));
    segment(bw, 0xC4, payload, size_t(17 + t.nvals));
  }
  const uint8_t sos[10] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  segment(bw, 0xDA, sos, sizeof(sos));

  const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16, wb = (w + 7) / 8, hb = (h + 7) / 8, pw = 16 * mcux;
  // one MCU row of planes: Y [16][pw], Cb / Cr [8][pw / 2]
  std::vector<int32_t> yrows(size_t(16) * pw), cbrows(size_t(8) * pw / 2), crrows(size_t(8) * pw / 2);
  std::vector<int32_t> full(size_t(4) * pw);  // Cb, Cr of two full-size rows
  std::vector<int32_t> last_cb(size_t(pw) / 2), last_cr(size_t(pw) / 2);
  int64_t last_dc[3] = {0, 0, 0};
  int64_t zz[6][64];
  for (int my = 0; my < mcuy; ++my) {
    for (int r16 = 0; r16 < 16; r16 += 2) {
      const int row0 = 16 * my + r16;
      for (int r = 0; r < 2; ++r) {
        // rows past the image (an odd last row's pair, the bottom out to a whole MCU) repeat its last
        // row; columns past it repeat its last column
        const uint8_t* src = rgb + size_t(row0 + r < h ? row0 + r : h - 1) * w * 3;
        int32_t* yr = &yrows[size_t(r16 + r) * pw];
        int32_t* cbr = &full[size_t(r) * pw];
        int32_t* crr = &full[size_t(2 + r) * pw];
        for (int x = 0; x < pw; ++x) {
          const uint8_t* p = src + 3 * (x < w ? x : w - 1);
          int64_t R = p[0], G = p[1], B = p[2];
          yr[x] = int32_t((kFix0299 * R + kFix0587 * G + kFix0114 * B + kHalf) >> kScale);
          cbr[x] = int32_t((-kFix016874 * R - kFix033126 * G + kFix05 * B + kCbCrOffset + kHalf - 1) >> kScale);
          crr[x] = int32_t((kFix05 * R - kFix041869 * G - kFix008131 * B + kCbCrOffset + kHalf - 1) >> kScale);
        }
      }
      // chroma: h2v2_downsample of the pair, or past the image the last downsampled row repeated
      int32_t* cbo = &cbrows[size_t(r16 / 2) * pw / 2];
      int32_t* cro = &crrows[size_t(r16 / 2) * pw / 2];
      if (row0 < h) {
        const int32_t *c0 = &full[0], *c1 = &full[size_t(pw)], *d0 = &full[size_t(2) * pw],
                      *d1 = &full[size_t(3) * pw];
        for (int x = 0; x < pw / 2; ++x) {
          const int bias = (x & 1) ? 2 : 1;
          cbo[x] = (c0[2 * x] + c0[2 * x + 1] + c1[2 * x] + c1[2 * x + 1] + bias) >> 2;
          cro[x] = (d0[2 * x] + d0[2 * x + 1] + d1[2 * x] + d1[2 * x + 1] + bias) >> 2;
        }
        memcpy(last_cb.data(), cbo, sizeof(int32_t) * pw / 2);
        memcpy(last_cr.data(), cro, sizeof(int32_t) * pw / 2);
      } else {
        memcpy(cbo, last_cb.data(), sizeof(int32_t) * pw / 2);
        memcpy(cro, last_cr.data(), sizeof(int32_t) * pw / 2);
      }
    }
    for (int mx = 0; mx < mcux; ++mx) {
      for (int b = 0; b < 4; ++b) {
        int bx = 2 * mx + (b & 1), by = 2 * my + (b >> 1);
        if (by >= hb) {  // the bottom's dummy blocks: the DC of the MCU's top-right block
          memset(zz[b], 0, sizeof(zz[b]));
          zz[b][0] = zz[1][0];
        } else if (bx >= wb) {  // the right edge's: the DC of the block to the left
          memset(zz[b], 0, sizeof(zz[b]));
          zz[b][0] = zz[b - 1][0];
        } else {
          enc->transform(&yrows[size_t(8 * (b >> 1)) * pw + 8 * bx], pw, 0, zz[b]);
        }
      }
      enc->transform(&cbrows[size_t(8) * mx], pw / 2, 1, zz[4]);
      enc->transform(&crrows[size_t(8) * mx], pw / 2, 1, zz[5]);
      for (int b = 0; b < 4; ++b) enc->code_block(bw, zz[b], 0, &last_dc[0]);
      enc->code_block(bw, zz[4], 1, &last_dc[1]);
      enc->code_block(bw, zz[5], 1, &last_dc[2]);
    }
  }
  bw.flush();
  bw.byte(0xFF);
  bw.byte(0xD9);
  *out_len = bw.pos;
  if (bw.overflow) {
    set_error(err, errlen, "output buffer too small");
    return 1;
  }
  return 0;
}

}  // extern "C"
