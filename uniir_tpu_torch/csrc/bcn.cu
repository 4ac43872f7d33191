// DDS pixel data: the block-compressed formats BC1-BC7 and the uncompressed
// mask form, as Pillow 12.1 decodes them (BcnDecode.c and DdsImagePlugin's
// Python DdsRgbDecoder).  Host code, no kernel.
//
// The native half of uniir_tpu_torch/data/dds.py, whose numpy twins are the
// reference: each entry takes the file's bytes, the offset of the first mip
// level's data and the image's size, and writes convert("RGB") of the image
// as uint8 [height, width, 3], or returns 1 with the twin's message.
//
//   uniir_bcn_bc1        4-colour and 3-colour + transparent-black blocks
//   uniir_bcn_bc2        BC1 colours (always 4-colour) + 4-bit alpha
//   uniir_bcn_bc3        BC1 colours (always 4-colour) + interpolated alpha
//   uniir_bcn_bc4        one interpolated channel, grey
//   uniir_bcn_bc5        two interpolated channels (red, green; blue 0),
//                        signed ones offset by 128 as Pillow offsets them
//   uniir_bcn_bc6h       the 14 modes, unsigned or signed, half floats
//                        rounded to 8 bits as Pillow rounds them
//   uniir_bcn_bc7        the 8 modes, partitions, p-bits, rotation and the
//                        index selector; a zero mode byte decodes to black
//   uniir_bcn_rgb_masks  DdsRgbDecoder: each pixel's bytes read little-endian,
//                        each mask's bits scaled to 0..255 through a double
//
// Blocks run left to right, top to bottom, 4 x 4 pixels each; pixels past
// the image's width or height are dropped.  Data cut short before the last
// block raises (Pillow's "image file is truncated"); the mask form reads
// zeros past the end, as Pillow's decoder does.  The alpha of BC1 / BC2 /
// BC3 / BC7 is decoded and dropped, as convert("RGB") drops it.
//
// Why host code and not a kernel: the image is resized on the host after
// decoding, and one image is decoded at a time on each loader thread (ctypes
// releases the GIL).  No global state beyond constant tables.
//
// Built by uniir_tpu_torch/_build.py with nvcc like the kernels' sources.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

int fail(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg);
  return 1;
}

struct Rgba {
  uint8_t r, g, b, a;
};

// --- BC1-BC5 ------------------------------------------------------------------

Rgba decode_565(uint16_t x) {
  Rgba c;
  int r = (x & 0xf800) >> 8;
  r |= r >> 5;
  int g = (x & 0x7e0) >> 3;
  g |= g >> 6;
  int b = (x & 0x1f) << 3;
  b |= b >> 5;
  c.r = (uint8_t)r;
  c.g = (uint8_t)g;
  c.b = (uint8_t)b;
  c.a = 0xff;
  return c;
}

void bc1_colour(Rgba* dst, const uint8_t* src, bool four_colour_always) {
  uint16_t c0 = (uint16_t)(src[0] | src[1] << 8), c1 = (uint16_t)(src[2] | src[3] << 8);
  uint32_t lut = (uint32_t)src[4] | (uint32_t)src[5] << 8 | (uint32_t)src[6] << 16 | (uint32_t)src[7] << 24;
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || four_colour_always) {
    p[2] = {(uint8_t)((2 * r0 + r1) / 3), (uint8_t)((2 * g0 + g1) / 3), (uint8_t)((2 * b0 + b1) / 3), 0xff};
    p[3] = {(uint8_t)((r0 + 2 * r1) / 3), (uint8_t)((g0 + 2 * g1) / 3), (uint8_t)((b0 + 2 * b1) / 3), 0xff};
  } else {
    p[2] = {(uint8_t)((r0 + r1) / 2), (uint8_t)((g0 + g1) / 2), (uint8_t)((b0 + b1) / 2), 0xff};
    p[3] = {0, 0, 0, 0};
  }
  for (int k = 0; k < 16; ++k) dst[k] = p[3 & (lut >> (2 * k))];
}

// decode_bc3_alpha: eight levels from two endpoints into byte `o` of each pixel
void bc3_channel(Rgba* dst, const uint8_t* src, int o, bool sign) {
  int a0 = sign ? (int8_t)src[0] + 128 : src[0];
  int a1 = sign ? (int8_t)src[1] + 128 : src[1];
  uint8_t a[8];
  a[0] = (uint8_t)a0;
  a[1] = (uint8_t)a1;
  if (a0 > a1) {
    for (int k = 1; k < 7; ++k) a[k + 1] = (uint8_t)(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k < 5; ++k) a[k + 1] = (uint8_t)(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  uint32_t lut1 = src[2] | src[3] << 8 | src[4] << 16, lut2 = src[5] | src[6] << 8 | src[7] << 16;
  for (int k = 0; k < 8; ++k) {
    (&dst[k].r)[o] = a[7 & (lut1 >> (3 * k))];
    (&dst[8 + k].r)[o] = a[7 & (lut2 >> (3 * k))];
  }
}

void bc1_block(Rgba* col, const uint8_t* src, int) { bc1_colour(col, src, false); }

void bc2_block(Rgba* col, const uint8_t* src, int) {
  bc1_colour(col, src + 8, true);
  for (int k = 0; k < 16; ++k) {
    int av = 0xf & (src[k >> 1] >> ((4 * k) & 7));
    col[k].a = (uint8_t)(av << 4 | av);
  }
}

void bc3_block(Rgba* col, const uint8_t* src, int) {
  bc1_colour(col, src + 8, true);
  bc3_channel(col, src, 3, false);
}

void bc4_block(Rgba* col, const uint8_t* src, int) {
  bc3_channel(col, src, 0, false);
  for (int k = 0; k < 16; ++k) col[k].g = col[k].b = col[k].r;  // L, shown as grey
}

void bc5_block(Rgba* col, const uint8_t* src, int sign) {
  bc3_channel(col, src, 0, sign != 0);
  bc3_channel(col, src + 8, 1, sign != 0);
  if (sign)
    for (int k = 0; k < 16; ++k) col[k].b = 128;
}

// --- BC7 ----------------------------------------------------------------------

int get_bit(const uint8_t* src, int bit) { return (src[bit >> 3] >> (bit & 7)) & 1; }

int get_bits(const uint8_t* src, int bit, int count) {
  int v = 0;
  for (int i = 0; i < count; ++i) v |= get_bit(src, bit + i) << i;
  return v;
}

struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode BC7_MODES[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0}, {3, 6, 0, 0, 5, 0, 0, 0, 2, 0},
    {2, 6, 0, 0, 7, 0, 1, 0, 2, 0}, {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0},
};
// the subset of each pixel: two subsets, a bit a pixel; three subsets, two bits a pixel
const uint16_t BC7_P2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8,
    0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce, 0x088c, 0x3110,
    0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696,
    0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720,
    0xc936, 0x936c, 0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t BC7_P3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0, 0x5a5a5050,
    0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250,
    0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200,
    0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50,
    0x500aa550, 0xaaaa4444, 0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
// the anchor pixel of the second subset of two, and of the second and third of three
const uint8_t BC7_A2[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                            15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                            15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                            6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t BC7_A3B[64] = {3,  3, 15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                             3,  3, 8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                             8,  15, 3, 5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                             3,  15, 5, 5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t BC7_A3C[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                             15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                             15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                             15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const uint8_t W2[4] = {0, 21, 43, 64};
const uint8_t W3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t W4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) { return bits == 2 ? W2 : bits == 3 ? W3 : W4; }

int subset_of(int ns, int partition, int k) {
  if (ns == 2) return 1 & (BC7_P2[partition] >> k);
  if (ns == 3) return 3 & (BC7_P3[partition] >> (2 * k));
  return 0;
}

uint8_t expand(int v, int bits) {
  v = (v << (8 - bits)) & 0xff;
  return (uint8_t)(v | (v >> bits));
}

void bc7_lerp(Rgba* dst, const Rgba* e, int s0, int s1) {
  int t0 = 64 - s0, t1 = 64 - s1;
  dst->r = (uint8_t)((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst->g = (uint8_t)((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst->b = (uint8_t)((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst->a = (uint8_t)((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void bc7_block(Rgba* col, const uint8_t* src, int) {
  if (src[0] == 0) {
    for (int k = 0; k < 16; ++k) col[k] = {0, 0, 0, 255};
    return;
  }
  int bit = 0;
  while (!(src[0] & (1 << bit))) ++bit;
  const Bc7Mode& m = BC7_MODES[bit];
  ++bit;
  int cb = m.cb, ab = m.ab;
  const uint8_t* cw = weights(m.ib);
  const uint8_t* aw = weights(ab && m.ib2 ? m.ib2 : m.ib);
  int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  int rotation = get_bits(src, bit, m.rb);
  bit += m.rb;
  int index_sel = get_bits(src, bit, m.isb);
  bit += m.isb;
  int numep = m.ns * 2;
  int ep[6][4];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < numep; ++i) {
      ep[i][c] = get_bits(src, bit, cb);
      bit += cb;
    }
  for (int i = 0; i < numep; ++i) {
    ep[i][3] = ab ? get_bits(src, bit, ab) : 255;
    bit += ab;
  }
  if (m.epb) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; ++i) {
      int p = get_bit(src, bit++);
      for (int c = 0; c < (ab ? 4 : 3); ++c) ep[i][c] = (ep[i][c] << 1 | p) & 0xff;
    }
  }
  if (m.spb) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; i += 2) {
      int p = get_bit(src, bit++);
      for (int j = 0; j < 2; ++j)
        for (int c = 0; c < (ab ? 4 : 3); ++c) ep[i + j][c] = (ep[i + j][c] << 1 | p) & 0xff;
    }
  }
  Rgba e[6];
  for (int i = 0; i < numep; ++i) {
    e[i].r = expand(ep[i][0], cb);
    e[i].g = expand(ep[i][1], cb);
    e[i].b = expand(ep[i][2], cb);
    e[i].a = ab ? expand(ep[i][3], ab) : (uint8_t)ep[i][3];
  }
  int cibit = bit, aibit = cibit + 16 * m.ib - m.ns;
  for (int k = 0; k < 16; ++k) {
    int s = subset_of(m.ns, partition, k);
    int ib = m.ib;
    if (k == 0 || (m.ns == 2 && s == 1 && k == BC7_A2[partition]) ||
        (m.ns == 3 && ((s == 1 && k == BC7_A3B[partition]) || (s == 2 && k == BC7_A3C[partition]))))
      --ib;
    int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    if (ab && m.ib2) {
      int ib2 = k == 0 ? m.ib2 - 1 : m.ib2;
      int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel)
        bc7_lerp(&col[k], &e[2 * s], aw[i1], cw[i0]);
      else
        bc7_lerp(&col[k], &e[2 * s], cw[i0], aw[i1]);
    } else {
      bc7_lerp(&col[k], &e[2 * s], cw[i0], cw[i0]);
    }
    uint8_t t;
    if (rotation == 1) {
      t = col[k].r, col[k].r = col[k].a, col[k].a = t;
    } else if (rotation == 2) {
      t = col[k].g, col[k].g = col[k].a, col[k].a = t;
    } else if (rotation == 3) {
      t = col[k].b, col[k].b = col[k].a, col[k].a = t;
    }
  }
}

// --- BC6H ---------------------------------------------------------------------

struct Bc6Mode {
  int ns, tr, pb, epb, rb, gb, bb;
};
const Bc6Mode BC6_MODES[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4}, {2, 1, 5, 11, 4, 5, 4},
    {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},   {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},
    {2, 1, 5, 8, 5, 5, 6},  {2, 0, 5, 6, 6, 6, 6},   {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};
// each mode's endpoint bits in the order the block stores them after its mode bits: 16 * (endpoint value
// index, r0 g0 b0 r1 g1 b1 r2 g2 b2 r3 g3 b3) + bit
const uint8_t BC6_PACKINGS[14][75] = {
    {116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32,
     33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68,
     176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146,
     147, 148, 179},
    {117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20, 21, 22, 133, 178, 116, 32,
     33, 34, 35, 36, 37, 38, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68,
     69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146,
     147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
     36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161,
     162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
     36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161,
     162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145, 146, 147, 116, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
     36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161,
     162, 163, 80, 81, 82, 83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146, 147, 180, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116, 32, 33, 34, 35,
     36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161,
     162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178, 116, 32, 33, 34, 35,
     36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161,
     162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117, 116, 32, 33, 34, 35,
     36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161,
     162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133, 116, 32, 33, 34, 35,
     36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161,
     162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133, 178, 116, 32, 33, 34, 35,
     36, 37, 165, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161,
     162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
     36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 64, 65, 66, 67, 68, 69, 70, 71,
     72, 73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
     36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10, 64, 65, 66, 67, 68, 69, 70, 71,
     72, 26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
     36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10, 64, 65, 66, 67, 68, 69, 70, 71,
     27, 26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
     36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10, 64, 65, 66, 67, 31, 30, 29, 28,
     27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42},
};

int16_t sign_extend(int v, int prec) {
  v &= 0xffff;
  if (v & (1 << (prec - 1))) v |= -1 << prec;
  return (int16_t)v;
}

int bc6_unquantize(uint16_t v, int prec, bool sign) {
  if (!sign) {
    int x = v;
    if (prec >= 15) return x;
    if (x == 0) return 0;
    if (x == (1 << prec) - 1) return 0xffff;
    return ((x << 15) + 0x4000) >> (prec - 1);
  }
  int x = (int16_t)v;
  if (prec >= 16) return x;
  bool negative = x < 0;
  if (negative) x = -x;
  if (x != 0) x = x >= (1 << (prec - 1)) - 1 ? 0x7fff : ((x << 15) + 0x4000) >> (prec - 1);
  return negative ? -x : x;
}

float half_to_float(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = (uint32_t)(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= (uint32_t)(h & 0x8000) << 16;
  return o.f;
}

float bc6_finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) return half_to_float((uint16_t)(0x8000 | ((-v) * 31) / 32));
    return half_to_float((uint16_t)((v * 31) / 32));
  }
  return half_to_float((uint16_t)((v * 31) / 64));
}

uint8_t bc6_clamp(float value) {
  if (value < 0.0f) return 0;
  if (value > 1.0f) return 255;
  return (uint8_t)(value * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, int sign) {
  int mode = src[0] & 0x1f, bit = 5, epbits = 75, ib = 3;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {
    memset(col, 0, 16 * sizeof(Rgba));
    return;
  }
  const Bc6Mode& m = BC6_MODES[mode];
  const uint8_t* cw = weights(ib);
  int numep = m.ns == 2 ? 12 : 6;
  uint16_t ep[12] = {0};
  for (int i = 0; i < epbits; ++i) {
    int d = BC6_PACKINGS[mode][i];
    ep[d >> 4] |= (uint16_t)(get_bit(src, bit + i) << (d & 15));
  }
  bit += epbits;
  int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  int mask = (1 << m.epb) - 1;
  if (sign)
    for (int c = 0; c < 3; ++c) ep[c] = (uint16_t)sign_extend(ep[c], m.epb);
  if (sign || m.tr)
    for (int i = 3; i < numep; i += 3) {
      ep[i] = (uint16_t)sign_extend(ep[i], m.rb);
      ep[i + 1] = (uint16_t)sign_extend(ep[i + 1], m.gb);
      ep[i + 2] = (uint16_t)sign_extend(ep[i + 2], m.bb);
    }
  // the deltas added to the first endpoint and masked; Pillow does not sign-extend the sums, so a signed
  // block's negative sums unquantize as large positive values
  if (m.tr)
    for (int i = 3; i < numep; ++i) ep[i] = (uint16_t)((ep[i] + ep[i % 3]) & mask);
  int ue[12];
  for (int i = 0; i < numep; ++i) ue[i] = bc6_unquantize(ep[i], m.epb, sign != 0);
  for (int k = 0; k < 16; ++k) {
    int s = subset_of(m.ns, partition, k) * 6;
    int bits = ib;
    if (k == 0 || (m.ns == 2 && k == BC7_A2[partition])) --bits;
    int w = cw[get_bits(src, bit, bits)];
    bit += bits;
    int t = 64 - w;
    int rgb[3];
    for (int c = 0; c < 3; ++c) rgb[c] = (ue[s + c] * t + ue[s + 3 + c] * w) >> 6;
    col[k].r = bc6_clamp(bc6_finalize(rgb[0], sign != 0));
    col[k].g = bc6_clamp(bc6_finalize(rgb[1], sign != 0));
    col[k].b = bc6_clamp(bc6_finalize(rgb[2], sign != 0));
    col[k].a = 0;
  }
}

// --- the image ----------------------------------------------------------------

typedef void (*BlockFn)(Rgba*, const uint8_t*, int);

int run_blocks(const uint8_t* s, size_t n, size_t pos, int width, int height, int block_bytes, BlockFn decode, int arg,
               uint8_t* out, char* err, int errlen) {
  size_t bw = ((size_t)width + 3) / 4, bh = ((size_t)height + 3) / 4;
  if (pos > n || (n - pos) / block_bytes < bw * bh)
    return fail(err, errlen, "DDS block data cut short (image file is truncated)");
  Rgba col[16];
  for (size_t by = 0; by < bh; ++by)
    for (size_t bx = 0; bx < bw; ++bx) {
      memset(col, 0, sizeof(col));
      decode(col, s + pos + (by * bw + bx) * block_bytes, arg);
      for (size_t j = 0; j < 4 && 4 * by + j < (size_t)height; ++j)
        for (size_t i = 0; i < 4 && 4 * bx + i < (size_t)width; ++i) {
          uint8_t* px = out + ((4 * by + j) * width + 4 * bx + i) * 3;
          px[0] = col[4 * j + i].r;
          px[1] = col[4 * j + i].g;
          px[2] = col[4 * j + i].b;
        }
    }
  return 0;
}

}  // namespace

#define BCN_ENTRY(NAME, BYTES, FN)                                                                               \
  extern "C" int uniir_bcn_##NAME(const uint8_t* s, size_t n, size_t pos, int width, int height, int sign,      \
                                  uint8_t* out, char* err, int errlen) {                                         \
    return run_blocks(s, n, pos, width, height, BYTES, FN, sign, out, err, errlen);                               \
  }

BCN_ENTRY(bc1, 8, bc1_block)
BCN_ENTRY(bc2, 16, bc2_block)
BCN_ENTRY(bc3, 16, bc3_block)
BCN_ENTRY(bc4, 8, bc4_block)
BCN_ENTRY(bc5, 16, bc5_block)
BCN_ENTRY(bc6h, 16, bc6_block)
BCN_ENTRY(bc7, 16, bc7_block)

extern "C" int uniir_bcn_rgb_masks(const uint8_t* s, size_t n, size_t pos, int width, int height, size_t bytecount,
                                   const uint32_t* masks, int n_masks, uint8_t* out, char* err, int errlen) {
  (void)err;
  (void)errlen;
  int offset[4];
  uint32_t total[4];
  for (int c = 0; c < n_masks; ++c) {
    uint32_t m = masks[c];
    offset[c] = 0;
    if (m)
      while (!(m >> offset[c] & 1)) ++offset[c];
    total[c] = m >> offset[c];
  }
  size_t pixels = (size_t)width * height;
  for (size_t k = 0; k < pixels; ++k) {
    uint32_t value = 0;
    // the pixel's bytes from the file (none past its end), little-endian; masks see the low 32 bits
    if (pos < n)
      for (size_t b = 0; b < 4 && b < bytecount && pos + b < n; ++b) value |= (uint32_t)s[pos + b] << (8 * b);
    pos = pos + bytecount < pos ? (size_t)-1 : pos + bytecount;
    for (int c = 0; c < 3; ++c)
      out[3 * k + c] = total[c] ? (uint8_t)(int)((double)((value & masks[c]) >> offset[c]) / (double)total[c] * 255.0)
                                : 0;
  }
  return 0;
}
