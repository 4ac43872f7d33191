// WebP (VP8 lossy, VP8L lossless, ALPH, the first frame of an animation) to
// RGB: host code, no kernel.
//
// The native half of uniir_tpu_torch/data/webp.py::decode_twin, which is the
// reference, and of its two bitstream modules, data/vp8l.py and data/vp8.py,
// whose docstrings state the rules; this file holds the same function step
// for step: libwebp 1.6's demuxer over the RIFF (the first frame of an
// animation on a zero canvas, a still image of the canvas's size), the VP8L
// bitstream with its bit reader to the bit (transforms, meta-Huffman groups,
// colour cache, LZ77, the 8-bit path of an alpha plane coded through colour
// indexing alone), the VP8 key frame (boolean decoder, header, modes,
// tokens, WHT / DCT, intra prediction with libwebp's edges, the loop filter
// over the macroblock-aligned frame), the ALPH chunk decoded and unfiltered
// (so a broken one is refused; its values never reach RGB), libwebp's fancy
// upsampler and VP8YUVToR / G / B.  A file libwebp refuses returns an error
// with a message; nothing is read or written out of bounds.
//
// Why host code and not a kernel: every stage but the colour conversion is
// serial (an arithmetic or prefix-code decoder, a prediction from the pixels
// just decoded, a filter whose edges depend on the edges before), and the
// images are resized on the host after decoding.  No global state, so the
// loader's threads (ctypes releases the GIL) decode in parallel.
//
// Built by uniir_tpu_torch/_build.py with nvcc like the kernels' sources.

#include <algorithm>
#include <cstddef>
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

[[noreturn]] void fail(const char* fmt, long a = 0, long b = 0, long c = 0, long d = 0) {
  char buf[200];
  snprintf(buf, sizeof(buf), fmt, a, b, c, d);
  throw Error{buf};
}

inline uint32_t le32(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24; }
inline uint32_t le24(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16; }

// ===================================================================== VP8L

const int kNumLiteral = 256, kNumLength = 24, kNumDist = 40, kMaxCacheBits = 11;
const int kAlphabet[5] = {kNumLiteral + kNumLength, 256, 256, 256, kNumDist};
const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1A, 0x26, 0x2A, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1B,
    0x36, 0x3A, 0x25, 0x2B, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1C, 0x35, 0x3B, 0x46, 0x4A, 0x24, 0x2C, 0x58, 0x45,
    0x4B, 0x34, 0x3C, 0x03, 0x57, 0x59, 0x13, 0x1D, 0x56, 0x5A, 0x23, 0x2D, 0x44, 0x4C, 0x55, 0x5B, 0x33, 0x3D,
    0x68, 0x02, 0x67, 0x69, 0x12, 0x1E, 0x66, 0x6A, 0x22, 0x2E, 0x54, 0x5C, 0x43, 0x4D, 0x65, 0x6B, 0x32, 0x3E,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5D, 0x11, 0x1F, 0x64, 0x6C, 0x42, 0x4E, 0x76, 0x7A, 0x21, 0x2F, 0x75, 0x7B,
    0x31, 0x3F, 0x63, 0x6D, 0x52, 0x5E, 0x00, 0x74, 0x7C, 0x41, 0x4F, 0x10, 0x20, 0x62, 0x6E, 0x30, 0x73, 0x7D,
    0x51, 0x5F, 0x40, 0x72, 0x7E, 0x61, 0x6F, 0x50, 0x71, 0x7F, 0x60, 0x70,
};
enum { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2, kColorIndexing = 3 };

// libwebp's VP8LBitReader: a 64-bit window over the bytes.
struct LBits {
  const uint8_t* buf;
  size_t n, pos;
  uint64_t val = 0;
  int bit_pos = 0;
  bool eos = false;

  LBits(const uint8_t* d, size_t len) : buf(d), n(len) {
    size_t k = std::min<size_t>(8, n);
    for (size_t i = 0; i < k; ++i) val |= (uint64_t)d[i] << (8 * i);
    pos = k;
  }
  bool at_end() const { return eos || (pos == n && bit_pos > 64); }
  void shift() {
    while (bit_pos >= 8 && pos < n) {
      val = (val >> 8) | ((uint64_t)buf[pos++] << 56);
      bit_pos -= 8;
    }
    if (at_end()) {
      eos = true;
      bit_pos = 0;
    }
  }
  uint32_t prefetch() const { return (uint32_t)(val >> (bit_pos & 63)); }
  uint32_t read(int nbits) {
    if (eos) {
      bit_pos = 0;
      return 0;
    }
    uint32_t v = prefetch() & ((1u << nbits) - 1);
    bit_pos += nbits;
    shift();
    return v;
  }
  void fill() {
    if (bit_pos >= 32) shift();
  }
};

struct HCode {
  uint8_t bits;
  uint16_t value;
};

// A prefix code's table, laid out as libwebp's BuildHuffmanTable: 2^root_bits
// entries, a longer code's entry (root_bits + sub bits, index of its sub-table).
struct Table {
  std::vector<HCode> e;
  int root_bits = 8;
};

bool build_table(const int* lengths, int n, int root_bits, Table& t) {
  int count[16] = {0};
  int used = 0, only = 0;
  for (int s = 0; s < n; ++s)
    if (lengths[s]) {
      ++count[lengths[s]];
      ++used;
      only = s;
    }
  const int size = 1 << root_bits;
  t.root_bits = root_bits;
  t.e.assign(size, HCode{0, 0});
  if (used == 0) return false;
  if (used == 1) {
    for (int i = 0; i < size; ++i) t.e[i] = HCode{0, (uint16_t)only};
    return true;
  }
  long kraft = 0;
  for (int l = 1; l < 16; ++l) kraft += (long)count[l] << (15 - l);
  if (kraft != 1L << 15) return false;
  // canonical codes in (length, symbol) order
  int next[16];
  int code = 0;
  for (int l = 1; l < 16; ++l) {
    next[l] = code;
    code = (code + count[l]) << 1;
  }
  std::vector<int> codes(n, 0), rev(n, 0);
  int sub_bits[1 << 8];
  std::fill(sub_bits, sub_bits + size, 0);
  for (int s = 0; s < n; ++s) {
    int l = lengths[s];
    if (!l) continue;
    int c = next[l]++, r = 0;
    for (int k = 0; k < l; ++k) r |= ((c >> k) & 1) << (l - 1 - k);
    rev[s] = r;
    if (l > root_bits) sub_bits[r & (size - 1)] = std::max(sub_bits[r & (size - 1)], l - root_bits);
  }
  std::vector<int> offset(size, 0);
  for (int key = 0; key < size; ++key)
    if (sub_bits[key]) {
      offset[key] = (int)t.e.size();
      t.e[key] = HCode{(uint8_t)(root_bits + sub_bits[key]), (uint16_t)offset[key]};
      t.e.resize(t.e.size() + (1u << sub_bits[key]), HCode{0, 0});
    }
  for (int s = 0; s < n; ++s) {
    int l = lengths[s];
    if (!l) continue;
    if (l <= root_bits) {
      for (int k = rev[s]; k < size; k += 1 << l) t.e[k] = HCode{(uint8_t)l, (uint16_t)s};
    } else {
      int key = rev[s] & (size - 1), rest = rev[s] >> root_bits, sb = sub_bits[key];
      for (int k = rest; k < (1 << sb); k += 1 << (l - root_bits))
        t.e[offset[key] + k] = HCode{(uint8_t)(l - root_bits), (uint16_t)s};
    }
  }
  return true;
}

inline int read_symbol(const Table& t, LBits& br) {
  uint32_t val = br.prefetch();
  const HCode* h = &t.e[val & 0xFF];
  if (h->bits > 8) {
    const int nb = h->bits - 8, base = h->value;
    br.bit_pos += 8;
    val = br.prefetch();
    h = &t.e[base + (val & ((1u << nb) - 1))];
  }
  br.bit_pos += h->bits;
  return h->value;
}

void read_code_lengths(LBits& br, const int* cl_lengths, int num_symbols, int* lengths) {
  Table t;
  if (!build_table(cl_lengths, 19, 7, t)) fail("VP8L: invalid code-length code");
  int max_symbol;
  if (br.read(1)) {
    int nb = 2 + 2 * (int)br.read(3);
    max_symbol = 2 + (int)br.read(nb);
    if (max_symbol > num_symbols) fail("VP8L: code-length count past the alphabet");
  } else {
    max_symbol = num_symbols;
  }
  std::fill(lengths, lengths + num_symbols, 0);
  int symbol = 0, prev = 8;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    br.fill();
    const HCode& h = t.e[br.prefetch() & 0x7F];
    br.bit_pos += h.bits;
    int ln = h.value;
    if (ln < 16) {
      lengths[symbol++] = ln;
      if (ln) prev = ln;
    } else {
      static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
      int repeat = (int)br.read(kExtra[ln - 16]) + kOffset[ln - 16];
      if (symbol + repeat > num_symbols) fail("VP8L: code-length repeat past the alphabet");
      int v = ln == 16 ? prev : 0;
      while (repeat-- > 0) lengths[symbol++] = v;
    }
  }
}

void read_code(LBits& br, int alphabet, Table& t) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {
    int two = br.read(1);
    int first = br.read(br.read(1) ? 8 : 1);
    if (first < alphabet) lengths[first] = 1;
    if (two) {
      int second = br.read(8);
      if (second < alphabet) lengths[second] = 1;
    }
  } else {
    int cl[19] = {0};
    int num = (int)br.read(4) + 4;
    for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    read_code_lengths(br, cl, alphabet, lengths.data());
  }
  if (br.eos || !build_table(lengths.data(), alphabet, 8, t)) fail("VP8L: invalid prefix code");
}

struct Group {
  Table t[5];
  bool one[5];
  bool trivial_literal, trivial_code;
  uint32_t literal;
};

struct Meta {
  int bits = 0, xsize = 0;
  std::vector<uint32_t> index;  // empty: one group
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline int prefix_value(int symbol, LBits& br) {
  if (symbol < 4) return symbol + 1;
  int extra = (symbol - 2) >> 1;
  return ((2 + (symbol & 1)) << extra) + (int)br.read(extra) + 1;
}

inline int plane_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  int d = kCodeToPlane[code - 1];
  int dist = (d >> 4) * xsize + 8 - (d & 0xF);
  return dist >= 1 ? dist : 1;
}

struct Transform {
  int kind, xsize, ysize, bits;
  std::vector<uint32_t> data;
};

std::vector<uint32_t> decode_image_stream(LBits& br, int xsize, int ysize, bool level0, std::vector<Transform>* tr,
                                          int* coded_x, Meta* meta_out, std::vector<Group>* groups_out,
                                          int* cache_out);

int read_cache_bits(LBits& br) {
  if (!br.read(1)) return 0;
  int bits = br.read(4);
  if (bits < 1 || bits > kMaxCacheBits) fail("VP8L: colour cache of %ld bits", bits);
  return bits;
}

void read_codes(LBits& br, int xsize, int ysize, int cache_bits, bool allow_meta, Meta& meta,
                std::vector<Group>& groups) {
  int num_groups = 1;
  if (allow_meta && br.read(1)) {
    meta.bits = 2 + br.read(3);
    meta.xsize = subsample(xsize, meta.bits);
    std::vector<uint32_t> img =
        decode_image_stream(br, meta.xsize, subsample(ysize, meta.bits), false, nullptr, nullptr, nullptr, nullptr,
                            nullptr);
    meta.index.resize(img.size());
    uint32_t top = 0;
    for (size_t i = 0; i < img.size(); ++i) {
      meta.index[i] = (img[i] >> 8) & 0xFFFF;
      top = std::max(top, meta.index[i]);
    }
    num_groups = (int)top + 1;
  }
  if (br.eos) fail("VP8L: stream ends in its entropy image");
  groups.resize(num_groups);
  for (Group& g : groups) {
    for (int j = 0; j < 5; ++j) {
      int alphabet = kAlphabet[j] + ((j == 0 && cache_bits) ? (1 << cache_bits) : 0);
      read_code(br, alphabet, g.t[j]);
      g.one[j] = g.t[j].e[0].bits == 0;
    }
    g.trivial_literal = g.one[1] && g.one[2] && g.one[3];
    g.literal = ((uint32_t)g.t[3].e[0].value << 24) | ((uint32_t)g.t[1].e[0].value << 16) | g.t[2].e[0].value;
    g.trivial_code = g.trivial_literal && g.one[0] && g.one[4] && g.t[0].e[0].value < kNumLiteral;
    if (g.trivial_code) g.literal |= (uint32_t)g.t[0].e[0].value << 8;
  }
}

inline uint32_t cache_key(uint32_t p, int bits) { return (uint32_t)(p * 0x1E35A7BDu) >> (32 - bits); }

std::vector<uint32_t> decode_pixels(LBits& br, int width, int height, const Meta& meta,
                                    const std::vector<Group>& groups, int cache_bits) {
  const long end = (long)width * height;
  std::vector<uint32_t> data(end, 0);
  std::vector<uint32_t> cache(cache_bits ? (1u << cache_bits) : 0);
  long pos = 0, cached = 0;
  int col = 0, row = 0;
  const bool has_meta = !meta.index.empty();
  const Group* g = &groups[0];
  while (pos < end) {
    if (has_meta) g = &groups[meta.index[(row >> meta.bits) * meta.xsize + (col >> meta.bits)]];
    int code;
    if (g->trivial_code) {
      data[pos] = g->literal;
      code = -1;
    } else {
      br.fill();
      code = read_symbol(g->t[0], br);
      if (br.at_end()) break;
    }
    if (code < kNumLiteral) {
      if (code >= 0) {
        if (g->trivial_literal) {
          data[pos] = g->literal | ((uint32_t)code << 8);
        } else {
          uint32_t red = read_symbol(g->t[1], br);
          br.fill();
          uint32_t blue = read_symbol(g->t[2], br);
          uint32_t alpha = read_symbol(g->t[3], br);
          if (br.at_end()) break;
          data[pos] = (alpha << 24) | (red << 16) | ((uint32_t)code << 8) | blue;
        }
      }
      ++pos;
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < kNumLiteral + kNumLength) {
      int length = prefix_value(code - kNumLiteral, br);
      int dist_symbol = read_symbol(g->t[4], br);
      br.fill();
      int dist = plane_to_distance(width, prefix_value(dist_symbol, br));
      if (br.at_end()) break;
      if (pos < dist || end - pos < length) fail("VP8L: backward reference outside the image");
      for (long k = pos; k < pos + length; ++k) data[k] = data[k - dist];
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
    } else {
      if (!cache_bits) fail("VP8L: colour cache code without a cache");
      for (; cached < pos; ++cached) cache[cache_key(data[cached], cache_bits)] = data[cached];
      data[pos] = cache[code - kNumLiteral - kNumLength];
      ++pos;
      if (++col >= width) {
        col = 0;
        ++row;
      }
    }
  }
  if (br.at_end()) fail("VP8L: stream ends before the image");
  return data;
}

// DecodeAlphaData: libwebp's 8-bit path; the stream may end inside the last symbol.
std::vector<uint32_t> decode_alpha8(LBits& br, int width, int height, const Meta& meta,
                                    const std::vector<Group>& groups) {
  const long end = (long)width * height;
  std::vector<uint32_t> data(end, 0);
  long pos = 0;
  int col = 0, row = 0;
  const bool has_meta = !meta.index.empty();
  const Group* g = &groups[0];
  while (!br.eos && pos < end) {
    if (has_meta) g = &groups[meta.index[(row >> meta.bits) * meta.xsize + (col >> meta.bits)]];
    br.fill();
    int code = read_symbol(g->t[0], br);
    if (code < kNumLiteral) {
      data[pos++] = (uint32_t)code << 8;
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < kNumLiteral + kNumLength) {
      int length = prefix_value(code - kNumLiteral, br);
      int dist_symbol = read_symbol(g->t[4], br);
      br.fill();
      int dist = plane_to_distance(width, prefix_value(dist_symbol, br));
      if (!(pos >= dist && end - pos >= length)) fail("VP8L: backward reference outside the alpha plane");
      for (long k = pos; k < pos + length; ++k) data[k] = data[k - dist];
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
    } else {
      fail("VP8L: invalid alpha code");
    }
    br.eos = br.at_end();
  }
  if (br.at_end() && pos < end) fail("VP8L: alpha stream ends before the plane");
  return data;
}

std::vector<uint32_t> expand_palette(const std::vector<uint32_t>& pal, int bits) {
  int final_n = 1 << (8 >> bits);
  std::vector<uint32_t> out(std::max<size_t>(final_n, pal.size()), 0);
  uint8_t prev[4] = {0, 0, 0, 0};
  for (size_t i = 0; i < pal.size(); ++i) {
    uint32_t v = 0;
    for (int b = 0; b < 4; ++b) {
      prev[b] = (uint8_t)(prev[b] + ((pal[i] >> (8 * b)) & 0xFF));
      v |= (uint32_t)prev[b] << (8 * b);
    }
    out[i] = v;
  }
  out.resize(final_n);
  return out;
}

std::vector<uint32_t> decode_image_stream(LBits& br, int xsize, int ysize, bool level0, std::vector<Transform>* tr,
                                          int* coded_x, Meta* meta_out, std::vector<Group>* groups_out,
                                          int* cache_out) {
  if (level0) {
    unsigned seen = 0;
    while (br.read(1)) {
      int kind = br.read(2);
      if (seen & (1u << kind)) fail("VP8L: a transform used twice");
      seen |= 1u << kind;
      Transform t{kind, xsize, ysize, 0, {}};
      if (kind == kPredictor || kind == kCrossColor) {
        t.bits = br.read(3) + 2;
        t.data = decode_image_stream(br, subsample(xsize, t.bits), subsample(ysize, t.bits), false, nullptr, nullptr,
                                     nullptr, nullptr, nullptr);
      } else if (kind == kColorIndexing) {
        int num_colors = br.read(8) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        t.data = expand_palette(
            decode_image_stream(br, num_colors, 1, false, nullptr, nullptr, nullptr, nullptr, nullptr), t.bits);
        xsize = subsample(xsize, t.bits);
      }
      tr->push_back(std::move(t));
    }
  }
  int cache_bits = read_cache_bits(br);
  Meta meta;
  std::vector<Group> groups;
  read_codes(br, xsize, ysize, cache_bits, level0, meta, groups);
  if (level0) {
    *coded_x = xsize;
    *meta_out = std::move(meta);
    *groups_out = std::move(groups);
    *cache_out = cache_bits;
    return {};
  }
  std::vector<uint32_t> data = decode_pixels(br, xsize, ysize, meta, groups, cache_bits);
  if (br.eos) fail("VP8L: stream ends in a sub-image");
  return data;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {  // VP8LAddPixels: per byte, mod 256
  return (((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u) |
         (((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu);
}
inline uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b); }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline uint32_t select_px(uint32_t t, uint32_t l, uint32_t tl) {
  int d = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = (t >> s) & 0xFF, b = (l >> s) & 0xFF, c = (tl >> s) & 0xFF;
    d += std::abs(b - c) - std::abs(a - c);
  }
  return d <= 0 ? t : l;
}
inline uint32_t clamped_full(uint32_t l, uint32_t t, uint32_t tl) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((l >> s) & 0xFF) + (int)((t >> s) & 0xFF) - (int)((tl >> s) & 0xFF)) << s;
  return out;
}
inline uint32_t clamped_half(uint32_t l, uint32_t t, uint32_t tl) {
  uint32_t avg = avg2(l, t), out = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = (avg >> s) & 0xFF, b = (tl >> s) & 0xFF;
    out |= (uint32_t)clip255(a + (a - b) / 2) << s;
  }
  return out;
}
inline uint32_t predict(int mode, uint32_t l, uint32_t t, uint32_t tr, uint32_t tl) {
  switch (mode) {
    case 1: return l;
    case 2: return t;
    case 3: return tr;
    case 4: return tl;
    case 5: return avg2(avg2(l, tr), t);
    case 6: return avg2(l, tl);
    case 7: return avg2(l, t);
    case 8: return avg2(tl, t);
    case 9: return avg2(t, tr);
    case 10: return avg2(avg2(l, tl), avg2(t, tr));
    case 11: return select_px(t, l, tl);
    case 12: return clamped_full(l, t, tl);
    case 13: return clamped_half(l, t, tl);
    default: return 0xFF000000u;
  }
}

std::vector<uint32_t> inverse_transforms(std::vector<uint32_t> px, const std::vector<Transform>& trs) {
  for (auto it = trs.rbegin(); it != trs.rend(); ++it) {
    const Transform& t = *it;
    const int w = t.xsize, h = t.ysize;
    if (t.kind == kPredictor) {
      const int tiles = subsample(w, t.bits);
      px[0] = add_pixels(px[0], 0xFF000000u);
      for (int x = 1; x < w; ++x) px[x] = add_pixels(px[x], px[x - 1]);
      for (int y = 1; y < h; ++y) {
        uint32_t* row = &px[(size_t)y * w];
        const uint32_t* up = row - w;
        row[0] = add_pixels(row[0], up[0]);
        const uint32_t* modes = &t.data[(size_t)(y >> t.bits) * tiles];
        for (int x = 1; x < w; ++x) {
          int mode = (modes[x >> t.bits] >> 8) & 0xF;
          uint32_t tr = x + 1 < w ? up[x + 1] : row[0];
          row[x] = add_pixels(row[x], predict(mode, row[x - 1], up[x], tr, up[x - 1]));
        }
      }
    } else if (t.kind == kCrossColor) {
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t code = t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)];
          int g2r = (int8_t)(code & 0xFF), g2b = (int8_t)((code >> 8) & 0xFF), r2b = (int8_t)((code >> 16) & 0xFF);
          uint32_t argb = px[(size_t)y * w + x];
          int green = (int8_t)((argb >> 8) & 0xFF);
          int red = (((argb >> 16) & 0xFF) + ((g2r * green) >> 5)) & 0xFF;
          int blue = (int)(argb & 0xFF) + ((g2b * green) >> 5);
          blue = (blue + ((r2b * (int8_t)red) >> 5)) & 0xFF;
          px[(size_t)y * w + x] = (argb & 0xFF00FF00u) | ((uint32_t)red << 16) | (uint32_t)blue;
        }
    } else if (t.kind == kSubtractGreen) {
      for (uint32_t& p : px) {
        uint32_t g = (p >> 8) & 0xFF;
        p = (p & 0xFF00FF00u) | ((((p >> 16) + g) & 0xFF) << 16) | ((p + g) & 0xFF);
      }
    } else {
      const int coded = subsample(w, t.bits);
      std::vector<uint32_t> out((size_t)w * h);
      const int depth = 8 >> t.bits, mask = (1 << depth) - 1;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t idx = (px[(size_t)y * coded + (x >> t.bits)] >> 8) & 0xFF;
          if (t.bits) idx = (idx >> (depth * (x & ((1 << t.bits) - 1)))) & mask;
          out[(size_t)y * w + x] = t.data[idx];
        }
      px.swap(out);
    }
  }
  return px;
}

bool vp8l_header(const uint8_t* d, size_t n, int* w, int* h) {
  if (n < 5 || d[0] != 0x2F || (d[4] >> 5)) return false;
  LBits br(d, n);
  br.read(8);
  *w = br.read(14) + 1;
  *h = br.read(14) + 1;
  br.read(1);
  if (br.read(3) != 0 || br.eos) return false;
  return true;
}

// RGBA of a VP8L payload into rgb (frame_w x frame_h, canvas row stride `stride` pixels)
void vp8l_decode(const uint8_t* d, size_t n, uint8_t* rgb, int stride) {
  int width, height;
  if (!vp8l_header(d, n, &width, &height)) fail("VP8L: bad header");
  LBits br(d, n);
  br.read(8), br.read(14), br.read(14), br.read(1), br.read(3);
  std::vector<Transform> trs;
  int xsize, cache_bits;
  Meta meta;
  std::vector<Group> groups;
  decode_image_stream(br, width, height, true, &trs, &xsize, &meta, &groups, &cache_bits);
  std::vector<uint32_t> argb = inverse_transforms(decode_pixels(br, xsize, height, meta, groups, cache_bits), trs);
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x) {
      uint32_t p = argb[(size_t)y * width + x];
      uint8_t* o = rgb + ((size_t)y * stride + x) * 3;
      o[0] = (p >> 16) & 0xFF;
      o[1] = (p >> 8) & 0xFF;
      o[2] = p & 0xFF;
    }
}

// ===================================================================== ALPH

void decode_alpha(const uint8_t* a, size_t n, int width, int height) {
  if (n <= 1) fail("ALPH chunk without data");
  int head = a[0], method = head & 3, filt = (head >> 2) & 3, pre = (head >> 4) & 3, reserved = head >> 6;
  if (method > 1 || pre > 1 || reserved) fail("ALPH header %#04lx", head);
  std::vector<uint8_t> plane((size_t)width * height);
  if (method == 0) {
    if (n - 1 < (size_t)width * height) fail("ALPH chunk shorter than the plane");
    memcpy(plane.data(), a + 1, plane.size());
  } else {
    LBits br(a + 1, n - 1);
    std::vector<Transform> trs;
    int xsize, cache_bits;
    Meta meta;
    std::vector<Group> groups;
    decode_image_stream(br, width, height, true, &trs, &xsize, &meta, &groups, &cache_bits);
    bool eight = trs.size() == 1 && trs[0].kind == kColorIndexing && cache_bits == 0;
    for (const Group& g : groups) eight = eight && g.one[1] && g.one[2] && g.one[3];
    std::vector<uint32_t> px = eight ? decode_alpha8(br, xsize, height, meta, groups)
                                     : decode_pixels(br, xsize, height, meta, groups, cache_bits);
    px = inverse_transforms(std::move(px), trs);
    for (size_t i = 0; i < plane.size(); ++i) plane[i] = (px[i] >> 8) & 0xFF;
  }
  // the filters undone, as libwebp does, though the values are dropped by convert("RGB")
  if (filt == 0) return;
  std::vector<uint8_t> out(plane.size());
  uint8_t pred = 0;
  for (int x = 0; x < width; ++x) out[x] = pred = (uint8_t)(pred + plane[x]);
  for (int y = 1; y < height; ++y) {
    const uint8_t* prev = &out[(size_t)(y - 1) * width];
    const uint8_t* in = &plane[(size_t)y * width];
    uint8_t* o = &out[(size_t)y * width];
    if (filt == 1) {
      uint8_t p = prev[0];
      for (int x = 0; x < width; ++x) o[x] = p = (uint8_t)(p + in[x]);
    } else if (filt == 2) {
      for (int x = 0; x < width; ++x) o[x] = (uint8_t)(prev[x] + in[x]);
    } else {
      int left = prev[0], tl = prev[0];
      for (int x = 0; x < width; ++x) {
        int top = prev[x], g = left + top - tl;
        left = (in[x] + (g < 0 ? 0 : g > 255 ? 255 : g)) & 255;
        tl = top;
        o[x] = (uint8_t)left;
      }
    }
  }
}

// ===================================================================== VP8

enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
const int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0},
              kCat5[] = {180, 157, 141, 134, 130, 0},
              kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26,
    27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52,
    53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79,
    80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116,
    118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
    34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64,
    66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181, 185,
    189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
// RFC 6386 section 13: default token probabilities and their update probabilities [type][band][context][11]
const uint8_t kCoeffProbs[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128,
    128, 128, 128, 128, 189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214,
    209, 255, 255, 128, 128, 128, 1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238,
    254, 221, 234, 255, 154, 128, 128, 128, 78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1,
    185, 249, 255, 243, 255, 128, 128, 128, 128, 128, 184, 150, 247, 255, 236, 224, 128, 128, 128, 128,
    128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128, 1, 101, 251, 255, 241, 255, 128, 128,
    128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128, 37, 116, 196, 243, 228, 255,
    255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128, 207, 160, 250, 255,
    238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128, 1, 152,
    252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172,
    176, 220, 157, 252, 221, 1, 68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241,
    255, 221, 224, 255, 255, 128, 128, 128, 184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81,
    99, 181, 242, 176, 190, 249, 202, 255, 255, 128, 1, 129, 232, 253, 214, 197, 242, 196, 255, 255,
    128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128, 23, 91, 163, 242, 170, 187, 247, 210,
    255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128, 109, 178, 241, 255, 231, 245,
    255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128, 1, 132, 239, 251,
    219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128, 22, 100,
    174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128,
    128, 128, 1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255,
    255, 128, 128, 128, 45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213,
    255, 128, 128, 128, 128, 128, 203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177,
    255, 224, 255, 128, 128, 128, 128, 128, 253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175,
    13, 224, 243, 193, 185, 249, 198, 255, 255, 128, 73, 17, 171, 221, 161, 179, 236, 167, 255, 234,
    128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128, 239, 90, 244, 250, 211, 209, 255, 255,
    128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128, 1, 24, 239, 251, 218, 219,
    255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128, 69, 46, 190, 239,
    201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128, 223, 165,
    249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128,
    128, 128, 149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128,
    128, 128, 128, 128, 247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128,
    128, 128, 128, 128, 128, 128, 1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250,
    255, 255, 128, 128, 128, 128, 128, 128, 55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 202, 24, 213, 235, 186, 191, 220, 160,
    240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128, 61, 46, 138, 219, 151, 178,
    240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128, 166, 109, 228, 252,
    211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128, 1, 52,
    220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128,
    128, 128, 149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254,
    223, 255, 255, 128, 1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188,
    196, 255, 233, 128, 128, 128, 20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248,
    255, 216, 213, 128, 128, 128, 128, 128, 168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47,
    116, 215, 255, 211, 212, 255, 255, 128, 128, 128, 1, 121, 236, 253, 212, 214, 255, 255, 128, 128,
    128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128, 42, 80, 160, 240, 162, 185, 255, 205,
    128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 244, 1, 255, 128, 128, 128,
    128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffUpdateProbs[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 254, 255, 255, 255, 255, 255, 255, 255, 255, 239, 253, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254,
    253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255,
    255, 254, 255, 255, 255, 255, 234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238,
    253, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 247, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234,
    251, 244, 254, 255, 255, 255, 255, 255, 255, 255, 251, 251, 243, 253, 254, 255, 254, 255, 255, 255,
    255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 236, 253, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255, 248, 254, 249, 253, 255, 255,
    255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 246, 253, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 254,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
// RFC 6386 section 11.5: B_PRED sub-block mode probabilities [above][left][9], modes in libwebp's order
const uint8_t kBModeProbs[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95, 175, 69,
    143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152, 114, 26, 17, 163,
    44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85, 144, 71, 10, 38, 171, 213,
    144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71, 63, 20, 8, 114, 114, 208, 12, 9,
    226, 81, 40, 11, 96, 182, 84, 29, 16, 36, 134, 183, 89, 137, 98, 101, 106, 165, 148, 72,
    187, 100, 130, 157, 111, 32, 75, 80, 66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9,
    178, 241, 141, 26, 8, 107, 74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51,
    52, 31, 115, 128, 104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15,
    186, 23, 47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61, 39, 53,
    200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77, 39, 28, 85, 171,
    58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73, 107, 54, 32, 26, 51, 1,
    81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114, 34, 19, 21, 102, 132, 188, 16, 76,
    124, 62, 18, 78, 95, 85, 57, 50, 48, 51, 193, 101, 35, 159, 215, 111, 89, 46, 111, 60,
    148, 31, 172, 219, 228, 21, 18, 111, 112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1,
    196, 245, 209, 10, 25, 109, 88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67,
    45, 68, 1, 209, 100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34,
    197, 171, 41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179, 63, 59,
    90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175, 47, 15, 16, 183,
    34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183, 57, 46, 22, 24, 128, 1,
    54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205, 40, 3, 9, 115, 51, 192, 18, 6,
    223, 87, 37, 9, 115, 59, 77, 64, 21, 47, 104, 55, 44, 218, 9, 54, 53, 130, 226, 64,
    90, 70, 205, 40, 41, 23, 26, 57, 54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26,
    133, 152, 116, 10, 32, 134, 39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2,
    15, 1, 118, 73, 75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55,
    186, 85, 56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45, 75, 79,
    123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49, 38, 33, 13, 121,
    57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114, 115, 21, 2, 10, 102, 255,
    166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26, 57, 18, 10, 102, 102, 213, 34, 20,
    43, 117, 20, 15, 36, 163, 128, 68, 1, 26, 102, 61, 71, 37, 34, 53, 31, 243, 192, 69,
    60, 71, 38, 73, 119, 28, 222, 37, 68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19,
    70, 146, 85, 55, 62, 70, 37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28,
    64, 32, 201, 85, 75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25,
    248, 1, 56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158, 86, 40,
    64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209, 45, 16, 21, 91,
    64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213, 83, 12, 13, 54, 192, 255,
    68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171, 18, 11, 7, 63, 144, 171, 4, 4,
    246, 35, 27, 10, 146, 174, 171, 12, 26, 128, 190, 80, 35, 99, 180, 80, 126, 54, 45, 85,
    126, 47, 87, 176, 51, 41, 20, 32, 101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15,
    176, 236, 85, 37, 9, 62, 71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55,
    70, 43, 26, 142, 146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81,
    188, 64, 32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// libwebp's VP8BitReader, a byte at a time.
struct BoolReader {
  const uint8_t* buf = nullptr;
  size_t n = 0, pos = 0;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;

  void init(const uint8_t* d, size_t len) {
    buf = d;
    n = len;
    pos = 0;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (pos < n) {
      value = (value << 8) | buf[pos++];
      bits += 8;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  inline int bit(int prob) {
    if (bits < 0) load();
    uint32_t rng = range;
    const uint32_t split = (rng * (uint32_t)prob) >> 8;
    int b;
    if ((uint32_t)(value >> bits) > split) {
      rng -= split;
      value -= (uint64_t)(split + 1) << bits;
      b = 1;
    } else {
      rng = split + 1;
      b = 0;
    }
    int shift = 7 - (31 - __builtin_clz(rng));
    range = (rng << shift) - 1;
    bits -= shift;
    return b;
  }
  int value_bits(int nb) {
    int v = 0;
    while (nb-- > 0) v |= bit(128) << nb;
    return v;
  }
  int signed_value(int nb) {
    int v = value_bits(nb);
    return bit(128) ? -v : v;
  }
};

struct FrameHeader {
  int width, height, mb_w, mb_h;
  bool use_segment = false, update_map = false, absolute_delta = true;
  int seg_quant[4] = {0, 0, 0, 0}, seg_filter[4] = {0, 0, 0, 0};
  int seg_probs[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_delta[4] = {0, 0, 0, 0}, mode_delta[4] = {0, 0, 0, 0};
  int skip_prob = -1;
  int quant[4][3][2];  // segment, (y1, y2, uv), (dc, ac)
  uint8_t probs[4][17][3][11];  // type, position (through its band), context
};

bool vp8_info(const uint8_t* d, size_t n, uint32_t chunk_size, int* w, int* h) {
  if (n < 10 || d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return false;
  uint32_t bits = le24(d);
  *w = (d[6] | d[7] << 8) & 0x3FFF;
  *h = (d[8] | d[9] << 8) & 0x3FFF;
  if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk_size || !*w || !*h)
    return false;
  return true;
}

inline int clipi(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

void parse_header(const uint8_t* d, size_t n, FrameHeader& f, BoolReader& br, std::vector<BoolReader>& parts) {
  uint32_t part0 = le24(d) >> 5;
  f.width = (d[6] | d[7] << 8) & 0x3FFF;
  f.height = (d[8] | d[9] << 8) & 0x3FFF;
  f.mb_w = (f.width + 15) >> 4;
  f.mb_h = (f.height + 15) >> 4;
  if (part0 > n - 10) fail("VP8: bad partition length");
  br.init(d + 10, part0);
  br.bit(128), br.bit(128);
  f.use_segment = br.bit(128);
  if (f.use_segment) {
    f.update_map = br.bit(128);
    if (br.bit(128)) {
      f.absolute_delta = br.bit(128);
      for (int s = 0; s < 4; ++s) f.seg_quant[s] = br.bit(128) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s) f.seg_filter[s] = br.bit(128) ? br.signed_value(6) : 0;
    }
    if (f.update_map)
      for (int s = 0; s < 3; ++s) f.seg_probs[s] = br.bit(128) ? br.value_bits(8) : 255;
  }
  if (br.eof) fail("VP8: cannot parse segment header");
  f.simple = br.bit(128);
  f.level = br.value_bits(6);
  f.sharpness = br.value_bits(3);
  f.use_lf_delta = br.bit(128);
  if (f.use_lf_delta && br.bit(128)) {
    for (int i = 0; i < 4; ++i)
      if (br.bit(128)) f.ref_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.bit(128)) f.mode_delta[i] = br.signed_value(6);
  }
  if (br.eof) fail("VP8: cannot parse filter header");
  const uint8_t* rest = d + 10 + part0;
  const size_t rest_n = n - 10 - part0;
  const int last = (1 << br.value_bits(2)) - 1;
  if (rest_n < (size_t)(3 * last)) fail("VP8: cannot parse partitions");
  size_t start = 3 * last, left = rest_n - 3 * last;
  parts.resize(last + 1);
  for (int p = 0; p < last; ++p) {
    size_t size = std::min<size_t>(le24(rest + 3 * p), left);
    parts[p].init(rest + start, size);
    start += size;
    left -= size;
  }
  if (start >= rest_n) fail("VP8: cannot parse partitions (the last one is empty)");
  parts[last].init(rest + start, rest_n - start);
  int base = br.value_bits(7);
  int dq[5];
  for (int i = 0; i < 5; ++i) dq[i] = br.bit(128) ? br.signed_value(4) : 0;
  for (int s = 0; s < 4; ++s) {
    int q = f.use_segment ? f.seg_quant[s] + (f.absolute_delta ? 0 : base) : base;
    f.quant[s][0][0] = kDcTable[clipi(q + dq[0], 127)];
    f.quant[s][0][1] = kAcTable[clipi(q, 127)];
    f.quant[s][1][0] = kDcTable[clipi(q + dq[1], 127)] * 2;
    f.quant[s][1][1] = std::max((kAcTable[clipi(q + dq[2], 127)] * 101581) >> 16, 8);
    f.quant[s][2][0] = kDcTable[clipi(q + dq[3], 117)];
    f.quant[s][2][1] = kAcTable[clipi(q + dq[4], 127)];
  }
  br.bit(128);
  uint8_t band_probs[4][8][3][11];
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          band_probs[t][b][c][p] = br.bit(kCoeffUpdateProbs[t][b][c][p]) ? br.value_bits(8) : kCoeffProbs[t][b][c][p];
  for (int t = 0; t < 4; ++t)
    for (int k = 0; k < 17; ++k) memcpy(f.probs[t][k], band_probs[t][kBands[k]], sizeof(f.probs[t][k]));
  if (br.bit(128)) f.skip_prob = br.value_bits(8);
}

int large_value(BoolReader& br, const uint8_t* p) {
  if (!br.bit(p[3])) return !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  int bit1 = br.bit(p[8]);
  int cat = 2 * bit1 + br.bit(p[9 + bit1]);
  int v = 0;
  for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
  return v + 3 + (8 << cat);
}

int get_coeffs(BoolReader& br, const uint8_t (*prob)[3][11], int ctx, const int* dq, int n, int16_t* out) {
  const uint8_t* p = prob[n][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = prob[++n][0];
      if (n == 16) return 16;
    }
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = prob[n + 1][1];
    } else {
      v = large_value(br, p);
      p = prob[n + 1][2];
    }
    out[kZigzag[n]] = (int16_t)((br.bit(128) ? -v : v) * dq[n > 0]);  // libwebp keeps int16_t coefficients
  }
  return 16;
}

void wht(const int16_t* in, int16_t* out16) {  // the 16 Y blocks' DC values, stored as int16_t
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i], a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[4 * i] + 3;
    int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    out16[4 * i] = (int16_t)((a0 + a1) >> 3);
    out16[4 * i + 1] = (int16_t)((a3 + a2) >> 3);
    out16[4 * i + 2] = (int16_t)((a0 - a1) >> 3);
    out16[4 * i + 3] = (int16_t)((a3 - a2) >> 3);
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline uint8_t clip8b(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

// libwebp's Transform_SSE2, lane for lane: every sum wraps at 16 bits (equal to TransformOne for
// coefficients in VP8's range; a corrupt stream can leave it)
inline int16_t mulhi(int16_t x, int k) { return (int16_t)(((int32_t)x * k) >> 16); }
inline void butterfly16(int16_t i0, int16_t i1, int16_t i2, int16_t i3, int16_t* o) {
  const int16_t a = (int16_t)(i0 + i2), b = (int16_t)(i0 - i2);
  const int16_t c = (int16_t)((int16_t)(i1 - i3) + (int16_t)(mulhi(i1, -30068) - mulhi(i3, 20091)));
  const int16_t d = (int16_t)((int16_t)(i1 + i3) + (int16_t)(mulhi(i1, 20091) + mulhi(i3, -30068)));
  o[0] = (int16_t)(a + d);
  o[1] = (int16_t)(b + c);
  o[2] = (int16_t)(b - c);
  o[3] = (int16_t)(a - d);
}
void transform_sse2(const int16_t* in, uint8_t* dst, int stride) {
  int16_t col[4][4];  // [column][k]
  for (int i = 0; i < 4; ++i) butterfly16(in[i], in[4 + i], in[8 + i], in[12 + i], col[i]);
  for (int k = 0; k < 4; ++k) {
    int16_t o[4];
    butterfly16((int16_t)(col[0][k] + 4), col[1][k], col[2][k], col[3][k], o);
    uint8_t* row = dst + k * stride;
    for (int x = 0; x < 4; ++x) row[x] = clip8b(row[x] + (o[x] >> 3));
  }
}
void transform_ac3(const int16_t* in, uint8_t* dst, int stride) {  // TransformAC3 (C)
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]), c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int dc[4] = {a + d4, a + c4, a - c4, a - d4}, e[4] = {d1, c1, -c1, -d1};
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) dst[y * stride + x] = clip8b(dst[y * stride + x] + ((dc[y] + e[x]) >> 3));
}
void transform_dc(const int16_t* in, uint8_t* dst, int stride) {  // TransformDC (C)
  const int dc = (in[0] + 4) >> 3;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) dst[y * stride + x] = clip8b(dst[y * stride + x] + dc);
}
// DoTransform: the block's code picks the transform (3: SSE2, 2: AC3, 1: DC alone, 0: none)
void do_transform(int code, const int16_t* in, uint8_t* dst, int stride) {
  if (code == 3) transform_sse2(in, dst, stride);
  else if (code == 2) transform_ac3(in, dst, stride);
  else if (code == 1) transform_dc(in, dst, stride);
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2i(int a, int b) { return (a + b + 1) >> 1; }

// a 4x4 sub-block's prediction into dst (stride s); the neighbours sit around it as in libwebp's buffer
void pred4(int mode, uint8_t* dst, int s) {
  const uint8_t* top = dst - s;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
            H = top[7];
  const int I = dst[-1], J = dst[s - 1], K = dst[2 * s - 1], L = dst[3 * s - 1];
#define DST(x, y) dst[(x) + (y) * s]
  switch (mode) {
    case B_DC: {
      int v = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v;
      break;
    }
    case B_TM: {
      const int left[4] = {I, J, K, L};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = clip8b(left[y] + top[x] - X);
      break;
    }
    case B_VE: {
      const int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[x];
      break;
    }
    case B_HE: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) DST(x, y) = v[y];
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2i(X, A);
      DST(1, 0) = DST(2, 2) = avg2i(A, B);
      DST(2, 0) = DST(3, 2) = avg2i(B, C);
      DST(3, 0) = avg2i(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2i(A, B);
      DST(1, 0) = DST(0, 2) = avg2i(B, C);
      DST(2, 0) = DST(1, 2) = avg2i(C, D);
      DST(3, 0) = DST(2, 2) = avg2i(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2i(I, X);
      DST(0, 1) = DST(2, 2) = avg2i(J, I);
      DST(0, 2) = DST(2, 3) = avg2i(K, J);
      DST(0, 3) = avg2i(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU
      DST(0, 0) = avg2i(I, J);
      DST(2, 0) = DST(0, 1) = avg2i(J, K);
      DST(2, 1) = DST(0, 2) = avg2i(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
  }
#undef DST
}

// 16x16 or 8x8 prediction into dst (stride s) from the row above and the column to the left
void pred_block(int mode, uint8_t* dst, int s, int size, int mb_x, int mb_y) {
  const uint8_t* top = dst - s;
  if (mode == B_DC) {
    int shift = size == 8 ? 4 : 5, sum_t = 0, sum_l = 0, v;
    for (int k = 0; k < size; ++k) {
      sum_t += top[k];
      sum_l += dst[k * s - 1];
    }
    if (mb_x && mb_y)
      v = (sum_t + sum_l + (1 << (shift - 1))) >> shift;
    else if (mb_x)
      v = (sum_l + (1 << (shift - 2))) >> (shift - 1);
    else if (mb_y)
      v = (sum_t + (1 << (shift - 2))) >> (shift - 1);
    else
      v = 128;
    for (int y = 0; y < size; ++y) memset(dst + y * s, v, size);
  } else if (mode == B_TM) {
    for (int y = 0; y < size; ++y)
      for (int x = 0; x < size; ++x) dst[y * s + x] = clip8b(dst[y * s - 1] + top[x] - top[-1]);
  } else if (mode == B_VE) {
    for (int y = 0; y < size; ++y) memcpy(dst + y * s, top, size);
  } else {
    for (int y = 0; y < size; ++y) memset(dst + y * s, dst[y * s - 1], size);
  }
}

struct MB {
  int segment, skip, ymode;  // ymode -1: B_PRED
  uint8_t sub[16];
  int uvmode;
  bool inner;
  uint8_t code[24];  // each block's transform (do_transform)
  int16_t coeffs[384];
};

void parse_modes(BoolReader& br, const FrameHeader& f, uint8_t* top, uint8_t* left, MB& mb) {
  mb.segment = 0;
  if (f.update_map) mb.segment = br.bit(f.seg_probs[0]) ? 2 + br.bit(f.seg_probs[2]) : br.bit(f.seg_probs[1]);
  mb.skip = f.skip_prob >= 0 ? br.bit(f.skip_prob) : 0;
  if (br.bit(145)) {
    int y = br.bit(156) ? (br.bit(128) ? B_TM : B_HE) : (br.bit(163) ? B_VE : B_DC);
    mb.ymode = y;
    memset(top, y, 4);
    memset(left, y, 4);
  } else {
    mb.ymode = -1;
    for (int y = 0; y < 4; ++y) {
      int m = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* p = kBModeProbs[top[x]][m];
        if (!br.bit(p[0])) m = B_DC;
        else if (!br.bit(p[1])) m = B_TM;
        else if (!br.bit(p[2])) m = B_VE;
        else if (!br.bit(p[3])) m = !br.bit(p[4]) ? B_HE : (!br.bit(p[5]) ? B_RD : B_VR);
        else if (!br.bit(p[6])) m = B_LD;
        else if (!br.bit(p[7])) m = B_VL;
        else m = !br.bit(p[8]) ? B_HD : B_HU;
        top[x] = (uint8_t)m;
      }
      memcpy(mb.sub + 4 * y, top, 4);
      left[y] = (uint8_t)m;
    }
  }
  mb.uvmode = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE : (br.bit(183) ? B_TM : B_HE);
}

// ---- the loop filter (libwebp's dsp/dec.c, C versions)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8b(p0 + a2);
  p[0] = clip8b(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8b(p1 + a3);
  p[-step] = clip8b(p0 + a2);
  p[0] = clip8b(q0 - a1);
  p[step] = clip8b(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8b(p2 + a3);
  p[-2 * step] = clip8b(p1 + a2);
  p[-step] = clip8b(p0 + a1);
  p[0] = clip8b(q0 - a1);
  p[step] = clip8b(q1 - a2);
  p[2 * step] = clip8b(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int t) {
  return std::abs(p[-2 * step] - p[-step]) > t || std::abs(p[step] - p[0]) > t;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
// hstride: across the edge; vstride: along it
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t))
      do_filter2(p, hstride);
    else if (mb_edge)
      do_filter6(p, hstride);
    else
      do_filter4(p, hstride);
  }
}
void simple_loop(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

struct Planes {
  int w, h;  // visible size
  std::vector<uint8_t> y, u, v;  // cropped
};

// The loop filter's strengths (PrecomputeFilterStrengths): [segment][is_i4x4] -> limit, interior limit,
// high-edge-variance threshold; limit 0: the macroblock is not filtered.
void filter_strengths(const FrameHeader& f, int strength[4][2][3]) {
  for (int s = 0; s < 4; ++s) {
    int base = f.use_segment ? f.seg_filter[s] + (f.absolute_delta ? 0 : f.level) : f.level;
    for (int i4 = 0; i4 < 2; ++i4) {
      int level = base;
      if (f.use_lf_delta) level += f.ref_delta[0] + (i4 ? f.mode_delta[0] : 0);
      level = clipi(level, 63);
      if (level == 0) {
        strength[s][i4][0] = strength[s][i4][1] = strength[s][i4][2] = 0;
        continue;
      }
      int ilevel = level;
      if (f.sharpness > 0) {
        ilevel >>= f.sharpness > 4 ? 2 : 1;
        ilevel = std::min(ilevel, 9 - f.sharpness);
      }
      ilevel = std::max(ilevel, 1);
      strength[s][i4][0] = 2 * level + ilevel;
      strength[s][i4][1] = ilevel;
      strength[s][i4][2] = level >= 40 ? 2 : level >= 15 ? 1 : 0;
    }
  }
}

// One macroblock row: modes from partition 0, then each macroblock's tokens.
void parse_row(const FrameHeader& f, BoolReader& br, BoolReader& tok, std::vector<uint8_t>& intra_t,
               std::vector<uint8_t>& nz_top, std::vector<uint8_t>& nz_dc_top, std::vector<MB>& row) {
  uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
  for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) parse_modes(br, f, &intra_t[4 * mb_x], intra_l, row[mb_x]);
  if (br.eof) fail("VP8: premature end of partition 0");
  int nz_left = 0, nz_dc_left = 0;
  for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
    MB& mb = row[mb_x];
    memset(mb.coeffs, 0, sizeof(mb.coeffs));
    memset(mb.code, 0, sizeof(mb.code));
    if (!mb.skip) {
      const auto& q = f.quant[mb.segment];
      const int tnz = nz_top[mb_x], lnz = nz_left;
      int first;
      const uint8_t(*ac)[3][11];
      if (mb.ymode >= 0) {
        int16_t dc[16] = {0}, out16[16];
        int nz = get_coeffs(tok, f.probs[1], nz_dc_top[mb_x] + nz_dc_left, q[1], 0, dc);
        nz_dc_top[mb_x] = nz_dc_left = nz > 0;
        wht(dc, out16);
        for (int k = 0; k < 16; ++k) mb.coeffs[16 * k] = out16[k];
        first = 1;
        ac = f.probs[0];
      } else {
        first = 0;
        ac = f.probs[3];
      }
      int t = tnz & 0xF, l = lnz & 0xF;
      for (int y = 0; y < 4; ++y) {
        int lbit = (l >> y) & 1;
        for (int x = 0; x < 4; ++x) {
          int16_t* blk = mb.coeffs + 16 * (4 * y + x);
          int nz = get_coeffs(tok, ac, lbit + ((t >> x) & 1), q[0], first, blk);
          lbit = nz > first;
          mb.code[4 * y + x] = nz > 3 ? 3 : nz > 1 ? 2 : blk[0] != 0;
          t = (t & ~(1 << x)) | (lbit << x);
        }
        l = (l & ~(1 << y)) | (lbit << y);
      }
      int new_t = t, new_l = l;
      for (int ch = 0; ch < 2; ++ch) {
        t = (tnz >> (4 + 2 * ch)) & 3;
        l = (lnz >> (4 + 2 * ch)) & 3;
        for (int y = 0; y < 2; ++y) {
          int lbit = (l >> y) & 1;
          for (int x = 0; x < 2; ++x) {
            int16_t* blk = mb.coeffs + 16 * (16 + 4 * ch + 2 * y + x);
            int nz = get_coeffs(tok, f.probs[2], lbit + ((t >> x) & 1), q[2], 0, blk);
            lbit = nz > 0;
            mb.code[16 + 4 * ch + 2 * y + x] = nz > 3 ? 3 : nz > 1 ? 2 : blk[0] != 0;
            t = (t & ~(1 << x)) | (lbit << x);
          }
          l = (l & ~(1 << y)) | (lbit << y);
        }
        new_t |= t << (4 + 2 * ch);
        new_l |= l << (4 + 2 * ch);
        uint8_t* plane = mb.code + 16 + 4 * ch;  // TransformUV if any block has AC, else TransformDCUV
        if (*std::max_element(plane, plane + 4) >= 2) memset(plane, 3, 4);
      }
      nz_top[mb_x] = (uint8_t)new_t;
      nz_left = new_l;
    } else {
      nz_top[mb_x] = 0;
      nz_left = 0;
      if (mb.ymode >= 0) nz_dc_top[mb_x] = nz_dc_left = 0;
    }
    if (tok.eof) fail("VP8: premature end of a token partition");
    mb.inner = mb.ymode < 0 || *std::max_element(mb.code, mb.code + 24) > 0;
  }
}

// Decodes a key frame row by row: each macroblock row is parsed, predicted from the unfiltered pixels
// around it (the row above kept unfiltered in top_y / top_u / top_v), then filtered.
Planes vp8_decode(const uint8_t* d, size_t n) {
  FrameHeader f;
  BoolReader br;
  std::vector<BoolReader> parts;
  parse_header(d, n, f, br, parts);
  const int W = 16 * f.mb_w, H = 16 * f.mb_h, CW = W / 2;
  std::vector<MB> row(f.mb_w);
  std::vector<uint8_t> intra_t(4 * f.mb_w, B_DC), nz_top(f.mb_w, 0), nz_dc_top(f.mb_w, 0);
  std::vector<uint8_t> Y((size_t)W * H), U((size_t)CW * (H / 2)), V((size_t)CW * (H / 2));
  std::vector<uint8_t> top_y(W), top_u(CW), top_v(CW);
  int strength[4][2][3];
  filter_strengths(f, strength);
  uint8_t buf[17 * 21];
  const int S = 21;
  for (int mb_y = 0; mb_y < f.mb_h; ++mb_y) {
    parse_row(f, br, parts[mb_y & (parts.size() - 1)], intra_t, nz_top, nz_dc_top, row);
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      MB& mb = row[mb_x];
      const int y0 = 16 * mb_y, x0 = 16 * mb_x;
      if (mb_y == 0) {
        memset(buf, 127, S);
      } else {
        buf[0] = mb_x == 0 ? 129 : top_y[x0 - 1];
        memcpy(buf + 1, &top_y[x0], 16);
        if (mb_x == f.mb_w - 1)
          memset(buf + 17, top_y[x0 + 15], 4);
        else
          memcpy(buf + 17, &top_y[x0 + 16], 4);
      }
      for (int k = 0; k < 16; ++k) buf[(k + 1) * S] = mb_x == 0 ? 129 : Y[(size_t)(y0 + k) * W + x0 - 1];
      uint8_t* dst = buf + S + 1;
      if (mb.ymode < 0) {
        for (int r = 4; r <= 12; r += 4) memcpy(buf + r * S + 17, buf + 17, 4);
        for (int nb = 0; nb < 16; ++nb) {
          uint8_t* b = dst + 4 * (nb >> 2) * S + 4 * (nb & 3);
          pred4(mb.sub[nb], b, S);
          do_transform(mb.code[nb], mb.coeffs + 16 * nb, b, S);
        }
      } else {
        pred_block(mb.ymode, dst, S, 16, mb_x, mb_y);
        for (int nb = 0; nb < 16; ++nb)
          do_transform(mb.code[nb], mb.coeffs + 16 * nb, dst + 4 * (nb >> 2) * S + 4 * (nb & 3), S);
      }
      for (int k = 0; k < 16; ++k) memcpy(&Y[(size_t)(y0 + k) * W + x0], dst + k * S, 16);
      for (int ch = 0; ch < 2; ++ch) {
        std::vector<uint8_t>& P = ch ? V : U;
        const std::vector<uint8_t>& top = ch ? top_v : top_u;
        const int cy = 8 * mb_y, cx = 8 * mb_x;
        uint8_t cb[9 * 9];
        if (mb_y == 0) {
          memset(cb, 127, 9);
        } else {
          cb[0] = mb_x == 0 ? 129 : top[cx - 1];
          memcpy(cb + 1, &top[cx], 8);
        }
        for (int k = 0; k < 8; ++k) cb[(k + 1) * 9] = mb_x == 0 ? 129 : P[(size_t)(cy + k) * CW + cx - 1];
        uint8_t* cd = cb + 10;
        pred_block(mb.uvmode, cd, 9, 8, mb_x, mb_y);
        for (int nb = 0; nb < 4; ++nb) {
          const int blk = 16 + 4 * ch + nb;
          do_transform(mb.code[blk], mb.coeffs + 16 * blk, cd + 4 * (nb >> 1) * 9 + 4 * (nb & 1), 9);
        }
        for (int k = 0; k < 8; ++k) memcpy(&P[(size_t)(cy + k) * CW + cx], cd + k * 9, 8);
      }
    }
    // the next row predicts from this row's last lines before they are filtered
    memcpy(top_y.data(), &Y[(size_t)(16 * mb_y + 15) * W], W);
    memcpy(top_u.data(), &U[(size_t)(8 * mb_y + 7) * CW], CW);
    memcpy(top_v.data(), &V[(size_t)(8 * mb_y + 7) * CW], CW);
    if (!f.level) continue;
    for (int mb_x = 0; mb_x < f.mb_w; ++mb_x) {
      const MB& mb = row[mb_x];
      const int* st = strength[mb.segment][mb.ymode < 0];
      const int limit = st[0], ilevel = st[1], hev_t = st[2];
      if (limit == 0) continue;
      uint8_t* y = &Y[(size_t)16 * mb_y * W + 16 * mb_x];
      if (f.simple) {
        if (mb_x > 0) simple_loop(y, 1, W, limit + 4);
        if (mb.inner)
          for (int k = 4; k < 16; k += 4) simple_loop(y + k, 1, W, limit);
        if (mb_y > 0) simple_loop(y, W, 1, limit + 4);
        if (mb.inner)
          for (int k = 4; k < 16; k += 4) simple_loop(y + k * W, W, 1, limit);
        continue;
      }
      uint8_t* u = &U[(size_t)8 * mb_y * CW + 8 * mb_x];
      uint8_t* v = &V[(size_t)8 * mb_y * CW + 8 * mb_x];
      if (mb_x > 0) {
        filter_loop(y, 1, W, 16, limit + 4, ilevel, hev_t, true);
        filter_loop(u, 1, CW, 8, limit + 4, ilevel, hev_t, true);
        filter_loop(v, 1, CW, 8, limit + 4, ilevel, hev_t, true);
      }
      if (mb.inner) {
        for (int k = 4; k < 16; k += 4) filter_loop(y + k, 1, W, 16, limit, ilevel, hev_t, false);
        filter_loop(u + 4, 1, CW, 8, limit, ilevel, hev_t, false);
        filter_loop(v + 4, 1, CW, 8, limit, ilevel, hev_t, false);
      }
      if (mb_y > 0) {
        filter_loop(y, W, 1, 16, limit + 4, ilevel, hev_t, true);
        filter_loop(u, CW, 1, 8, limit + 4, ilevel, hev_t, true);
        filter_loop(v, CW, 1, 8, limit + 4, ilevel, hev_t, true);
      }
      if (mb.inner) {
        for (int k = 4; k < 16; k += 4) filter_loop(y + k * W, W, 1, 16, limit, ilevel, hev_t, false);
        filter_loop(u + 4 * CW, CW, 1, 8, limit, ilevel, hev_t, false);
        filter_loop(v + 4 * CW, CW, 1, 8, limit, ilevel, hev_t, false);
      }
    }
  }
  Planes out;
  out.w = f.width;
  out.h = f.height;
  const int cw = (f.width + 1) / 2, ch = (f.height + 1) / 2;
  out.y.resize((size_t)f.width * f.height);
  out.u.resize((size_t)cw * ch);
  out.v.resize((size_t)cw * ch);
  for (int r = 0; r < f.height; ++r) memcpy(&out.y[(size_t)r * f.width], &Y[(size_t)r * W], f.width);
  for (int r = 0; r < ch; ++r) {
    memcpy(&out.u[(size_t)r * cw], &U[(size_t)r * CW], cw);
    memcpy(&out.v[(size_t)r * cw], &V[(size_t)r * CW], cw);
  }
  return out;
}

// ===================================================================== to RGB

inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* o) {
  const int yy = (y * 19077) >> 8;
  o[0] = (uint8_t)yuv_clip8(yy + ((v * 26149) >> 8) - 14234);
  o[1] = (uint8_t)yuv_clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708);
  o[2] = (uint8_t)yuv_clip8(yy + ((u * 33050) >> 8) - 17685);
}

// One output row's chroma (UpsampleRgbLinePair): top / cur chroma rows, upper: nearer top.
void fancy_row(const uint8_t* top, const uint8_t* cur, int width, bool upper, int* out) {
  const uint8_t* near = upper ? top : cur;
  const uint8_t* far = upper ? cur : top;
  out[0] = (3 * near[0] + far[0] + 2) >> 2;
  const int pairs = (width - 1) >> 1;
  for (int x = 1; x <= pairs; ++x) {
    const int tl = top[x - 1], t = top[x], l = cur[x - 1], c = cur[x];
    const int avg = tl + t + l + c + 8;
    const int d12 = (avg + 2 * (t + l)) >> 3, d03 = (avg + 2 * (tl + c)) >> 3;
    if (upper) {
      out[2 * x - 1] = (d12 + tl) >> 1;
      out[2 * x] = (d03 + t) >> 1;
    } else {
      out[2 * x - 1] = (d03 + l) >> 1;
      out[2 * x] = (d12 + c) >> 1;
    }
  }
  if (!(width & 1)) {
    const int last = width / 2 - 1;
    out[width - 1] = (3 * near[last] + far[last] + 2) >> 2;
  }
}

void planes_to_rgb(const Planes& p, uint8_t* rgb, int stride) {
  const int cw = (p.w + 1) / 2, ch = (p.h + 1) / 2;
  std::vector<int> u(p.w), v(p.w);
  for (int r = 0; r < p.h; ++r) {
    const int k = (r + 1) >> 1;
    int top = r == 0 ? 0 : k - 1, cur = std::min(k, ch - 1);
    const bool upper = r == 0 || (r & 1);
    if (r == 0 || (r == p.h - 1 && p.h % 2 == 0)) cur = top;
    fancy_row(&p.u[(size_t)top * cw], &p.u[(size_t)cur * cw], p.w, upper, u.data());
    fancy_row(&p.v[(size_t)top * cw], &p.v[(size_t)cur * cw], p.w, upper, v.data());
    const uint8_t* y = &p.y[(size_t)r * p.w];
    uint8_t* o = rgb + (size_t)r * stride * 3;
    for (int x = 0; x < p.w; ++x) yuv_to_rgb(y[x], u[x], v[x], o + 3 * x);
  }
}

// ===================================================================== the container

const uint32_t kMaxChunkPayload = 0xFFFFFFF6u;
const uint64_t kMaxImageArea = 1ULL << 32;
const uint64_t kMaxPixels = 2ULL * (1024ULL * 1024 * 1024 / 4 / 3);
const int kAlphaFlag = 0x10, kAnimationFlag = 0x02, kValidFlags = 0x3E;

struct DFrame {
  int x = 0, y = 0, width = 0, height = 0, number = 0;
  size_t image_at = 0, image_size = 0, alpha_at = 0, alpha_size = 0;
  bool has_image = false, has_alpha = false, complete = false;
};

struct Demux {
  const uint8_t* d;
  size_t end, pos = 12;
  int flags = 0, anim = 0;
  bool ext = false;
  long cw = 0, ch = 0;
  std::vector<DFrame> frames;

  size_t left() const { return end - pos; }
  [[noreturn]] void refuse(const char* why, long a = 0, long b = 0, long c = 0, long e = 0) {
    char buf[160];
    snprintf(buf, sizeof(buf), why, a, b, c, e);
    throw Error{std::string("WebP demuxer refuses the file (") + buf + ")"};
  }

  bool features(size_t at, size_t size, int* w, int* h) {
    if (size < 12) return false;
    uint32_t declared = le32(d + at + 4);
    if (!memcmp(d + at, "VP8 ", 4)) return vp8_info(d + at + 8, size - 8, declared, w, h);
    return vp8l_header(d + at + 8, size - 8, w, h);
  }

  void store_frame(int number, size_t min_size, DFrame& f) {
    if (left() < 8 || left() < min_size) refuse("truncated frame");
    int alphas = 0, images = 0;
    while (true) {
      size_t start = pos;
      const uint8_t* fourcc = d + start;
      uint32_t size = le32(d + start + 4);
      pos = start + 8;
      if (size > kMaxChunkPayload) refuse("chunk size");
      uint64_t padded = (uint64_t)size + (size & 1);
      if (padded > left()) refuse("chunk past the RIFF end");
      if (!memcmp(fourcc, "ALPH", 4) && alphas == 0) {
        alphas = 1;
        f.has_alpha = true;
        f.alpha_at = start;
        f.alpha_size = 8 + padded;
        f.number = number;
        pos += padded;
      } else if ((!memcmp(fourcc, "VP8 ", 4) || !memcmp(fourcc, "VP8L", 4)) && images == 0) {
        if (!memcmp(fourcc, "VP8L", 4) && alphas) refuse("ALPH before VP8L");
        int w, h;
        if (!features(start, 8 + padded, &w, &h)) refuse("the image chunk's header (VP8GetInfo / VP8LGetInfo)");
        images = 1;
        f.has_image = true;
        f.image_at = start;
        f.image_size = 8 + padded;
        f.width = w;
        f.height = h;
        f.number = number;
        f.complete = true;
        pos += padded;
      } else {
        pos = start;
        return;
      }
      if (pos == end) return;
      if (left() < 8) refuse("truncated chunk header");
    }
  }

  void add_frame(const DFrame& f) {
    if (!frames.empty() && !frames.back().complete) refuse("a frame after an incomplete one");
    frames.push_back(f);
  }

  void single_image() {
    if (!frames.empty()) refuse("a second image");
    if (left() < 8) refuse("truncated");
    DFrame f;
    store_frame(1, 0, f);
    if (!(flags & kAlphaFlag)) f.has_alpha = false;
    if (!ext && f.width > 0 && f.height > 0) {
      cw = f.width;
      ch = f.height;
    }
    add_frame(f);
  }

  void animation_frame(uint64_t chunk_size) {
    if (16 > left() || chunk_size < 16) refuse("ANMF chunk too small");
    DFrame f;
    f.x = 2 * (int)le24(d + pos);
    f.y = 2 * (int)le24(d + pos + 3);
    uint64_t w = 1 + (uint64_t)le24(d + pos + 6), h = 1 + (uint64_t)le24(d + pos + 9);
    pos += 16;
    if (w * h >= kMaxImageArea) refuse("frame too large");
    size_t start = pos;
    store_frame((int)frames.size() + 1, chunk_size - 16, f);
    if (pos - start > chunk_size - 16) refuse("ANMF sub-chunks past the frame");
    if ((flags & kAnimationFlag) && f.number > 0) add_frame(f);
  }

  void run(size_t n) {
    if (n < 20 || memcmp(d, "RIFF", 4) || memcmp(d + 8, "WEBP", 4)) refuse("no RIFF / WEBP header");
    uint32_t riff = le32(d + 4);
    if (riff < 8 || riff > kMaxChunkPayload) refuse("RIFF size %ld", riff);
    end = (size_t)riff + 8;
    if (n < end) refuse("truncated: the RIFF size says %ld bytes, the file has %ld", (long)end, (long)n);
    if (!memcmp(d + 12, "VP8 ", 4) || !memcmp(d + 12, "VP8L", 4)) {
      single_image();
      if (frames.empty() || cw <= 0 || frames[0].width <= 0) refuse("no image");
      return;
    }
    if (memcmp(d + 12, "VP8X", 4)) refuse("first chunk");
    ext = true;
    uint32_t vp8x = le32(d + 16);
    pos = 20;
    if (vp8x > kMaxChunkPayload || vp8x < 10) refuse("VP8X size");
    uint64_t vp8x_padded = (uint64_t)vp8x + (vp8x & 1);
    if (vp8x_padded > left()) refuse("VP8X past the RIFF end");
    flags = d[pos];
    cw = 1 + (long)le24(d + pos + 4);
    ch = 1 + (long)le24(d + pos + 7);
    if ((uint64_t)cw * (uint64_t)ch >= kMaxImageArea) refuse("canvas too large");
    pos += vp8x_padded;
    if (left() < 8) refuse("no chunk after VP8X");
    const bool animation = flags & kAnimationFlag;
    while (true) {
      size_t start = pos;
      const uint8_t* fourcc = d + start;
      uint32_t size = le32(d + start + 4);
      pos = start + 8;
      if (size > kMaxChunkPayload) refuse("chunk size");
      uint64_t padded = (uint64_t)size + (size & 1);
      if (padded > left()) refuse("chunk past the RIFF end");
      if (!memcmp(fourcc, "VP8X", 4)) refuse("a second VP8X");
      if (!memcmp(fourcc, "ALPH", 4) || !memcmp(fourcc, "VP8 ", 4) || !memcmp(fourcc, "VP8L", 4)) {
        if (anim || animation) refuse("a still image in an animation");
        pos = start;
        single_image();
      } else if (!memcmp(fourcc, "ANIM", 4)) {
        if (padded < 6) refuse("ANIM chunk too small");
        ++anim;
        pos += padded;
      } else if (!memcmp(fourcc, "ANMF", 4)) {
        if (!anim) refuse("ANMF before ANIM");
        animation_frame(padded);
      } else {
        pos += padded;
      }
      if (pos == end) break;
      if (left() < 8) refuse("truncated chunk header");
    }
    if (frames.empty()) refuse("no frame");
    if (flags & ~kValidFlags) refuse("VP8X flags %#lx", flags);
    for (const DFrame& f : frames) {
      if (!animation && f.number > 1) refuse("frames in a still image");
      if (!f.complete) refuse("an incomplete frame");
      if (f.has_alpha && f.alpha_at > f.image_at) refuse("ALPH after the image");
      if (f.width <= 0 || f.height <= 0) refuse("empty frame");
      if (!animation && (f.x || f.y || f.width != cw || f.height != ch))
        refuse("image %ld x %ld on a canvas of %ld x %ld", f.width, f.height, cw, ch);
      if (animation && (f.x + f.width > cw || f.y + f.height > ch)) refuse("a frame past the canvas");
    }
  }
};

void demux(const uint8_t* data, size_t n, Demux& dm) {
  dm.d = data;
  dm.run(n);
  if ((uint64_t)dm.cw * (uint64_t)dm.ch > kMaxPixels)
    fail("WebP canvas of %ld x %ld pixels (decompression bomb)", dm.cw, dm.ch);
}

void decode(const uint8_t* data, size_t n, uint8_t* out, int w, int h) {
  Demux dm;
  demux(data, n, dm);
  if (dm.cw != w || dm.ch != h) fail("size %ld x %ld differs from the one asked for", dm.cw, dm.ch);
  const DFrame& f = dm.frames[0];
  memset(out, 0, (size_t)w * h * 3);
  const uint8_t* payload = data + f.image_at + 8;
  const size_t payload_n = f.image_size - 8;
  uint8_t* at = out + ((size_t)f.y * w + f.x) * 3;
  if (!memcmp(data + f.image_at, "VP8L", 4)) {
    vp8l_decode(payload, payload_n, at, w);
    return;
  }
  Planes p = vp8_decode(payload, payload_n);
  if (f.has_alpha) decode_alpha(data + f.alpha_at + 8, le32(data + f.alpha_at + 4), p.w, p.h);
  planes_to_rgb(p, at, w);
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// size[0] = width, size[1] = height of the WebP canvas in data[0, n); 0 on success.
int uniir_webp_info(const uint8_t* data, size_t n, int* size, char* err, int errlen) {
  try {
    Demux dm;
    demux(data, n, dm);
    size[0] = (int)dm.cw;
    size[1] = (int)dm.ch;
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "out of memory or internal error decoding the WebP file");
  }
  return 1;
}

// Decodes the first frame's canvas into out, uint8 [h][w][3] (h and w from uniir_webp_info); 0 on success.
int uniir_webp_decode(const uint8_t* data, size_t n, uint8_t* out, int w, int h, char* err, int errlen) {
  try {
    decode(data, n, out, w, h);
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "out of memory or internal error decoding the WebP file");
  }
  return 1;
}

}  // extern "C"
