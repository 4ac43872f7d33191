// Zstandard (RFC 8878) decoder: host code, no kernel.
//
// The native twin of uniir_tpu_torch/data/zstd.py, which is the reference
// and says what is decoded and what fails: libzstd 1.5.7's decoder and its
// checks -- `decompress` as ZSTD_decompress reads every frame, `stream` as
// libtiff's ZSTDDecode streams one strip out of the first frame with
// ZSTD_decompressStream (stopping once the output is full, one more block
// decoded where a block filled it exactly; the single-pass shortcut where
// the frame gives its size and lies whole in the data).  Bitstreams are read
// from their end with zeros past their start; each must end exactly at its
// marker bit (a double-symbol Huffman table's last symbol as libzstd's
// HUF_decodeLastSymbolX2 tests it).  Corrupt data throws Corrupt.
//
// Included by csrc/tiff.cu (ZSTD strips and tiles, one call an image).

#pragma once

#include <cstddef>
#include <cstdint>
#include <algorithm>
#include <cstring>
#include <string>
#include <vector>

namespace zstd {

struct Corrupt {
  std::string msg;
};

[[noreturn]] inline void corrupt(const char* what) { throw Corrupt{what}; }

constexpr uint32_t kMagic = 0xFD2FB528u, kSkippable = 0x184D2A50u;
constexpr size_t kBlockMax = 128 * 1024;
constexpr uint64_t kStreamWindowMax = 1ull << 27;

inline uint32_t le(const uint8_t* p, int k) {
  uint32_t v = 0;
  for (int i = 0; i < k; i++) v |= (uint32_t)p[i] << (8 * i);
  return v;
}
inline uint64_t le64(const uint8_t* p, int k) {
  uint64_t v = 0;
  for (int i = 0; i < k; i++) v |= (uint64_t)p[i] << (8 * i);
  return v;
}
inline int bit_length(uint64_t v) { return v ? 64 - __builtin_clzll(v) : 0; }

// ------------------------------------------------------------------ XXH64

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull, P3 = 1609587929392839161ull,
                   P4 = 9650029242287828579ull, P5 = 2870177450012600261ull;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

inline uint64_t xxh64(const uint8_t* p, size_t n) {
  size_t i = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
    for (; i + 32 <= n; i += 32)
      for (int k = 0; k < 4; k++) v[k] = xround(v[k], le64(p + i + 8 * k, 8));
    h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
    for (int k = 0; k < 4; k++) h = (h ^ xround(0, v[k])) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  for (; i + 8 <= n; i += 8) h = rotl(h ^ xround(0, le64(p + i, 8)), 27) * P1 + P4;
  if (i + 4 <= n) {
    h = rotl(h ^ ((uint64_t)le(p + i, 4) * P1), 23) * P2 + P3;
    i += 4;
  }
  for (; i < n; i++) h = rotl(h ^ (p[i] * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// -------------------------------------------------------------- bitstreams

// A stream read from its end: `pos` bits are left (below 0 once read past the start, where zeros are read).
struct Backward {
  const uint8_t* src;
  size_t n;
  int64_t pos;
  Backward(const uint8_t* s, size_t len) : src(s), n(len) {
    if (!len) corrupt("empty bitstream");
    if (!s[len - 1]) corrupt("bitstream without its end mark");
    pos = 8 * (int64_t)(len - 1) + bit_length(s[len - 1]) - 1;
  }
  uint32_t at(int64_t p, int k) const {  // bits [p, p + k), k <= 31
    if (p >= 0) {
      size_t b = (size_t)(p >> 3);
      uint64_t v = b + 8 <= n ? le64(src + b, 8) : le64(src + b, (int)(n - b));
      return (uint32_t)((v >> (p & 7)) & ((1ull << k) - 1));
    }
    if (p + k <= 0) return 0;
    uint64_t v = le64(src, n < 8 ? (int)n : 8);
    return (uint32_t)((v << -p) & ((1ull << k) - 1));
  }
  uint32_t read(int k) {
    if (!k) return 0;
    pos -= k;
    return at(pos, k);
  }
  uint32_t peek(int k) const { return at(pos - k, k); }
};

inline int ctz32(uint32_t v) { return __builtin_ctz(v); }

// FSE_readNCount, as libzstd reads it: normalized counts, tableLog, bytes read.
inline size_t read_ncount(const uint8_t* src, size_t n, int max_symbol, std::vector<int>& norm, int& table_log) {
  if (n < 8) {
    uint8_t buf[8] = {0};
    memcpy(buf, src, n);
    size_t used = read_ncount(buf, 8, max_symbol, norm, table_log);
    if (used > n) corrupt("FSE table description past its data");
    return used;
  }
  const int64_t iend = (int64_t)n;
  int64_t ip = 0;
  uint32_t bit_stream = le(src, 4);
  int nb_bits = (bit_stream & 0xF) + 5;
  if (nb_bits > 15) corrupt("FSE tableLog too large");
  table_log = nb_bits;
  bit_stream >>= 4;
  int bit_count = 4;
  int remaining = (1 << nb_bits) + 1, threshold = 1 << nb_bits;
  nb_bits++;
  const int max_sv1 = max_symbol + 1;
  std::vector<int> counts(max_sv1, 0);
  int charnum = 0;
  bool previous0 = false;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (bit_count >> 3) <= iend - 4) {
      ip += bit_count >> 3;
      bit_count &= 7;
    } else {
      bit_count -= (int)(8 * (iend - 4 - ip));
      bit_count &= 31;
      ip = iend - 4;
    }
    bit_stream = le(src + ip, 4) >> bit_count;
  };
  for (;;) {
    if (previous0) {
      int repeats = ctz32(~bit_stream | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          bit_count -= (int)(8 * (iend - 7 - ip));
          bit_count &= 31;
          ip = iend - 4;
        }
        bit_stream = le(src + ip, 4) >> bit_count;
        repeats = ctz32(~bit_stream | 0x80000000u) >> 1;
      }
      charnum += 3 * repeats;
      bit_stream >>= 2 * repeats;
      bit_count += 2 * repeats;
      charnum += bit_stream & 3;
      bit_count += 2;
      if (charnum >= max_sv1) break;
      advance();
    }
    int mx = (2 * threshold - 1) - remaining, count;
    if ((int)(bit_stream & (threshold - 1)) < mx) {
      count = bit_stream & (threshold - 1);
      bit_count += nb_bits - 1;
    } else {
      count = bit_stream & (2 * threshold - 1);
      if (count >= threshold) count -= mx;
      bit_count += nb_bits;
    }
    count--;
    remaining -= count >= 0 ? count : -count;
    counts[charnum++] = count;
    previous0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nb_bits = bit_length((uint64_t)remaining);
      threshold = 1 << (nb_bits - 1);
    }
    if (charnum >= max_sv1) break;
    advance();
  }
  if (remaining != 1) corrupt("FSE table description does not sum up");
  if (charnum > max_sv1) corrupt("FSE table description names too many symbols");
  if (bit_count > 32) corrupt("FSE table description read past its end");
  ip += (bit_count + 7) >> 3;
  norm.assign(counts.begin(), counts.begin() + charnum);
  return (size_t)ip;
}

struct Cell {
  uint16_t sym;
  uint8_t nb;
  uint32_t next;
};

// The FSE decoding table of normalized counts (FSE_buildDTable's spread, low-probability symbols at the top).
inline std::vector<Cell> fse_table(const std::vector<int>& norm, int log) {
  const int size = 1 << log;
  std::vector<uint16_t> symbols(size, 0);
  std::vector<int> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); s++) {
    if (norm[s] == -1) {
      symbols[high--] = (uint16_t)s;
      next[s] = 1;
    } else {
      next[s] = norm[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); s++)
    for (int i = 0; i < norm[s]; i++) {
      symbols[pos] = (uint16_t)s;
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  if (pos != 0) corrupt("FSE table does not cover its states");
  std::vector<Cell> table(size);
  for (int u = 0; u < size; u++) {
    int s = symbols[u], state = next[s]++;
    int nb = log - (bit_length((uint64_t)state) - 1);
    table[u] = Cell{(uint16_t)s, (uint8_t)nb, (uint32_t)((state << nb) - size)};
  }
  return table;
}

// ------------------------------------------------------------ Huffman literals

// HUF_readStats: the weights of every symbol with the implied last one, tableLog; returns the bytes read.
inline size_t huffman_weights(const uint8_t* src, size_t n, std::vector<int>& weights, int& log) {
  if (!n) corrupt("Huffman table description missing");
  size_t size = src[0];
  weights.clear();
  if (size >= 128) {
    size_t count = size - 127;
    size = (count + 1) / 2;
    if (size + 1 > n) corrupt("Huffman table description past its data");
    for (size_t k = 0; k < count; k++) weights.push_back(k & 1 ? src[1 + k / 2] & 15 : src[1 + k / 2] >> 4);
  } else {
    if (size + 1 > n) corrupt("Huffman table description past its data");
    std::vector<int> norm;
    int flog;
    const uint8_t* fse = src + 1;
    size_t used = read_ncount(fse, size, 255, norm, flog);
    if (flog > 6) corrupt("Huffman weights' FSE tableLog above 6");
    std::vector<Cell> table = fse_table(norm, flog);
    Backward bits(fse + used, size - used);
    uint32_t state[2];
    state[0] = bits.read(flog);
    state[1] = bits.read(flog);
    if (bits.pos < 0) corrupt("Huffman weights' bitstream too short");
    for (int k = 0;; k ^= 1) {
      if (weights.size() > 253) corrupt("too many Huffman weights");
      const Cell& c = table[state[k]];
      weights.push_back(c.sym);
      state[k] = c.next + bits.read(c.nb);
      if (bits.pos < 0) {
        weights.push_back(table[state[k ^ 1]].sym);
        break;
      }
    }
  }
  uint32_t total = 0;
  for (int w : weights) {
    if (w > 12) corrupt("Huffman weight above 12");
    total += (1u << w) >> 1;
  }
  if (!total) corrupt("Huffman weights all zero");
  log = bit_length(total);
  if (log > 12) corrupt("Huffman tableLog above 12");
  uint32_t rest = (1u << log) - total;
  if (rest & (rest - 1)) corrupt("Huffman weights leave no power of 2");
  weights.push_back(bit_length(rest));
  int ones = 0;
  for (int w : weights) ones += w == 1;
  if (ones < 2 || (ones & 1)) corrupt("Huffman weights: an odd count of the longest codes");
  return size + 1;
}

struct Huffman {
  int log = 0;
  bool dbl = false;
  std::vector<uint8_t> sym, nbits;
  void build(const std::vector<int>& weights, int table_log, bool double_symbol) {
    log = table_log;
    dbl = double_symbol;
    sym.assign((size_t)1 << log, 0);
    nbits.assign((size_t)1 << log, 0);
    int start[13] = {0};
    int at = 0;
    for (int w = 1; w <= log; w++) {
      start[w] = at;
      int count = 0;
      for (int v : weights) count += v == w;
      at += count << (w - 1);
    }
    for (size_t s = 0; s < weights.size(); s++) {
      int w = weights[s];
      if (!w) continue;
      for (int u = start[w]; u < start[w] + (1 << (w - 1)); u++) {
        sym[u] = (uint8_t)s;
        nbits[u] = (uint8_t)(log + 1 - w);
      }
      start[w] += 1 << (w - 1);
    }
  }
  // `count` symbols of one stream into out (see data/zstd.py HuffmanTable.decode).
  void decode(const uint8_t* src, size_t n, size_t count, uint8_t* out) const {
    Backward bits(src, n);
    std::vector<uint8_t> lens;
    if (dbl) lens.resize(count);
    int64_t left = 0;
    for (size_t i = 0; i < count; i++) {
      left = bits.pos;
      uint32_t v = bits.at(left - log, log);
      out[i] = sym[v];
      bits.pos = left - nbits[v];
      if (dbl) lens[i] = nbits[v];
    }
    if (dbl && count) {
      const int window = log == 12 ? 12 : 11;
      size_t i = 0;
      while (i + 1 < count) i += lens[i] + lens[i + 1] <= window ? 2 : 1;
      if (i == count - 1) {
        uint32_t v, v2;
        int n1;
        if (left == 0) {  // libzstd reads its stale bit container: the first 8 bytes
          uint64_t c = le64(src, n < 8 ? (int)n : 8);
          v = (uint32_t)(c >> (64 - log));
          n1 = nbits[v];
          v2 = (uint32_t)((c << n1) >> (64 - log));
        } else {
          v = bits.at(left - log, log);
          n1 = nbits[v];
          v2 = bits.at(left - n1 - log, log);
        }
        out[count - 1] = sym[v];
        int n2 = nbits[v2];
        bool ok = n1 + n2 > window ? left == n1 : (left >= 0 && left <= n1 + n2);
        if (!ok) corrupt("Huffman stream does not end at its marker");
        return;
      }
    }
    if (bits.pos != 0) corrupt("Huffman stream does not end at its marker");
  }
};

// HUF_selectDecoder: whether libzstd decodes four streams with its double-symbol table.
inline bool select_double(size_t dst, size_t src) {
  static const uint32_t t[16][2][2] = {
      {{0, 0}, {1, 1}},         {{0, 0}, {1, 1}},         {{150, 216}, {381, 119}},  {{170, 205}, {514, 112}},
      {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}}, {{221, 192}, {735, 107}},  {{256, 189}, {881, 106}},
      {{359, 188}, {1167, 109}}, {{582, 187}, {1570, 114}}, {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
      {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}}, {{1377, 185}, {1731, 202}}, {{1412, 185}, {1695, 202}}};
  uint32_t q = src >= dst ? 15 : (uint32_t)(src * 16 / dst);
  uint32_t d256 = (uint32_t)(dst >> 8);
  uint32_t t0 = t[q][0][0] + t[q][0][1] * d256, t1 = t[q][1][0] + t[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// n bits [pos - n, pos) of a literals buffer read from its end, as libzstd's bit container gives them once it holds
// the buffer's first 8 bytes (`stale`): zeros below bit 0, and where every bit was read the container shifted round.
inline uint32_t window(const uint8_t* buf, size_t len, int64_t pos, int n, uint64_t stale) {
  int64_t p = pos - n;
  if (p >= 0) {
    size_t b = (size_t)(p >> 3);
    uint64_t v = b + 8 <= len ? le64(buf + b, 8) : le64(buf + b, (int)(len - b));
    return (uint32_t)((v >> (p & 7)) & ((1ull << n) - 1));
  }
  if (pos > 0) return (uint32_t)((le64(buf, len < 8 ? (int)len : 8) << -p) & ((1ull << n) - 1));
  return (uint32_t)((stale << ((64 - pos) & 63)) >> (64 - n));
}

// libzstd's fast four-stream decoder (x86-64 with BMI2): see data/zstd.py _fast.
inline void fast(const Huffman& h, const uint8_t* src, size_t n, size_t count, const size_t* l, uint8_t* out) {
  const int shift = 11 - h.log;
  const uint64_t stale = le64(src, 8);
  size_t starts[4] = {6, 6 + l[0], 6 + l[0] + l[1], 6 + l[0] + l[1] + l[2]};
  size_t ends[4] = {starts[1], starts[2], starts[3], n};
  size_t seg = (count + 3) / 4, segs[4] = {seg, seg, seg, count - 3 * seg}, got[4] = {0, 0, 0, 0};
  int64_t pos[4], ip[4];
  for (int s = 0; s < 4; s++) {
    int last = src[ends[s] - 1];
    pos[s] = last ? 8 * (int64_t)(ends[s] - 1) + bit_length(last) - 1 : 8 * (int64_t)ends[s];
    ip[s] = (int64_t)ends[s] - 8;
  }
  auto lookup = [&](int s, size_t room) {
    uint8_t* o = out + s * seg;
    uint32_t w = window(src, n, pos[s], 11, stale), v = w >> shift;
    int n1 = h.nbits[v];
    o[got[s]++] = h.sym[v];
    if (h.dbl && room >= 2) {
      uint32_t v2 = ((w << n1) & 0x7FF) >> shift;
      int n2 = h.nbits[v2];
      if (n1 + n2 <= 11) {
        o[got[s]++] = h.sym[v2];
        pos[s] -= n1 + n2;
        return;
      }
    }
    pos[s] -= n1;
  };
  for (;;) {
    int64_t iters = ip[0] / 7;
    if (h.dbl) {
      for (int s = 0; s < 4; s++) iters = std::min<int64_t>(iters, (int64_t)(segs[s] - got[s]) / 10);
    } else {
      iters = std::min<int64_t>(iters, (int64_t)(segs[3] - got[3]) / 5);
    }
    if (iters <= 0 || ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
    size_t olimit = got[3] + 5 * (size_t)iters;
    for (;;) {
      for (int s = 0; s < 4; s++) {
        for (int k = 0; k < 5; k++) lookup(s, 2);
        ip[s] = (pos[s] + 7) / 8 - 8;
      }
      if (got[3] >= olimit) break;
    }
  }
  for (int s = 0; s < 4; s++) {
    if (ip[s] < (int64_t)starts[s] - 8) corrupt("Huffman stream read past its neighbour");
    while (got[s] < segs[s]) {
      size_t left = segs[s] - got[s];
      if (h.dbl && left == 1) {  // HUF_decodeLastSymbolX2: one symbol of the entry
        out[s * seg + got[s]++] = h.sym[window(src, n, pos[s], 11, stale) >> shift];
        break;
      }
      lookup(s, left);
    }
  }
}

// The literals of one or four Huffman streams: through libzstd's fast decoder where it takes them, else stream by
// stream.
inline void decode_streams(const Huffman& h, const uint8_t* src, size_t n, size_t count, bool four, uint8_t* out) {
  if (!four) return h.decode(src, n, count, out);
  if (n < 10) corrupt("four Huffman streams in fewer than 10 bytes");
  size_t l[4] = {le(src, 2), le(src + 2, 2), le(src + 4, 2), 0};
  bool fits = l[0] + l[1] + l[2] + 6 <= n;
  if (fits) l[3] = n - 6 - l[0] - l[1] - l[2];
  size_t seg = (count + 3) / 4;
  if (fits && count && h.log <= 11 && l[0] >= 8 && l[1] >= 8 && l[2] >= 8 && l[3] >= 8 && 3 * seg < count)
    return fast(h, src, n, count, l, out);
  if (!fits) corrupt("Huffman jump table past its data");
  if (3 * seg > count) corrupt("too few literals for four streams");
  size_t at = 6;
  for (int k = 0; k < 4; k++) {
    h.decode(src + at, l[k], k < 3 ? seg : count - 3 * seg, out + k * seg);
    at += l[k];
  }
}

// ------------------------------------------------------------------ blocks

constexpr int kMaxLL = 35, kMaxML = 52, kMaxOF = 31;
inline const uint32_t* ll_base() {
  static const uint32_t t[36] = {0,  1,  2,  3,  4,  5,   6,   7,   8,   9,    10,   11,   12,   13,   14,    15,    16,   18,
                                 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
  return t;
}
inline const uint8_t* ll_bits() {
  static const uint8_t t[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
  return t;
}
inline const uint32_t* ml_base() {
  static const uint32_t t[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,  14,  15,  16,   17,   18,   19,   20,
                                 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,  32,  33,  34,   35,   37,   39,   41,
                                 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
  return t;
}
inline const uint8_t* ml_bits() {
  static const uint8_t t[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
  return t;
}

struct SeqTable {
  std::vector<Cell> cells;
  int log = 0;
};

inline const SeqTable& predefined(int kind) {  // LL (0), OF (1), ML (2)
  static const std::vector<SeqTable> built = [] {
    std::vector<int> ll = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2,
                           2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
    std::vector<int> of = {1, 1, 1, 1, 1, 1, 2, 2, 2};
    for (int i = 0; i < 15; i++) of.push_back(1);
    for (int i = 0; i < 5; i++) of.push_back(-1);
    std::vector<int> ml = {1, 4, 3, 2, 2, 2, 2, 2, 2};
    for (int i = 0; i < 37; i++) ml.push_back(1);
    for (int i = 0; i < 7; i++) ml.push_back(-1);
    std::vector<SeqTable> t(3);
    t[0].cells = fse_table(ll, 6), t[0].log = 6;
    t[1].cells = fse_table(of, 5), t[1].log = 5;
    t[2].cells = fse_table(ml, 6), t[2].log = 6;
    return t;
  }();
  return built[kind];
}

// What one frame's blocks share: the block size limit, the repeat offsets, the last Huffman table and the last
// sequence tables.
struct Context {
  size_t block_max;
  uint64_t rep[3] = {1, 4, 8};
  Huffman huffman;
  bool has_huffman = false, has_tables = false;
  SeqTable tables[3];
};

// ZSTD_decodeLiteralsBlock: the literals into `lits`; returns the bytes read.
inline size_t literals(Context& ctx, const uint8_t* src, size_t n, size_t room, std::vector<uint8_t>& lits) {
  if (n < 2) corrupt("block too short for its literals");
  int kind = src[0] & 3, fmt = (src[0] >> 2) & 3;
  size_t limit = ctx.block_max < room ? ctx.block_max : room;
  if (kind >= 2) {
    if (kind == 3 && !ctx.has_huffman) corrupt("treeless literals without an earlier Huffman table");
    if (n < 5) corrupt("block too short for its literals header");
    uint32_t lhc = le(src, 4);
    size_t lh, size, csize;
    if (fmt < 2) {
      lh = 3, size = (lhc >> 4) & 0x3FF, csize = (lhc >> 14) & 0x3FF;
    } else if (fmt == 2) {
      lh = 4, size = (lhc >> 4) & 0x3FFF, csize = lhc >> 18;
    } else {
      lh = 5, size = (lhc >> 4) & 0x3FFFF, csize = (lhc >> 22) + ((size_t)src[4] << 10);
    }
    bool four = fmt != 0;
    if (size > ctx.block_max) corrupt("literals larger than a block");
    if (four && size < 6) corrupt("fewer than 6 literals in four streams");
    if (csize + lh > n) corrupt("literals past the block's end");
    if (limit < size) corrupt("literals larger than the output");
    lits.resize(size);
    const uint8_t* data = src + lh;
    if (kind == 3) {
      decode_streams(ctx.huffman, data, csize, size, four, lits.data());
      return lh + csize;
    }
    if (four && (size == 0 || csize == 0)) corrupt("empty Huffman literals");
    std::vector<int> weights;
    int log;
    size_t used = huffman_weights(data, csize, weights, log);
    if (used >= csize) corrupt("Huffman table fills the literals");
    ctx.huffman.build(weights, log, four && select_double(size, csize));
    ctx.has_huffman = true;
    decode_streams(ctx.huffman, data + used, csize - used, size, four, lits.data());
    return lh + csize;
  }
  size_t lh, size;
  if (fmt == 1) {
    lh = 2, size = le(src, 2) >> 4;
  } else if (fmt == 3) {
    if (n < (size_t)(kind == 0 ? 3 : 4)) corrupt("block too short for its literals header");
    lh = 3, size = le(src, 3) >> 4;
  } else {
    lh = 1, size = src[0] >> 3;
  }
  if (kind == 1 && fmt == 1 && n < 3) corrupt("block too short for its literals header");
  if (size > ctx.block_max) corrupt("literals larger than a block");
  if (limit < size) corrupt("literals larger than the output");
  if (kind == 1) {
    lits.assign(size, src[lh]);
    return lh + 1;
  }
  if (lh + size > n) corrupt("literals past the block's end");
  lits.assign(src + lh, src + lh + size);
  return lh + size;
}

// ZSTD_decodeSeqHeaders: the number of sequences (tables into ctx); returns the bytes read.
inline size_t sequence_tables(Context& ctx, const uint8_t* src, size_t n, int& nb, SeqTable* tables) {
  if (!n) corrupt("block without its sequences section");
  nb = src[0];
  size_t ip = 1;
  if (nb > 0x7F) {
    if (nb == 0xFF) {
      if (ip + 2 > n) corrupt("sequences header past the block's end");
      nb = (int)le(src + 1, 2) + 0x7F00, ip = 3;
    } else {
      if (ip >= n) corrupt("sequences header past the block's end");
      nb = ((nb - 0x80) << 8) + src[1], ip = 2;
    }
  }
  if (nb == 0) {
    if (ip != n) corrupt("data after an empty sequences section");
    return ip;
  }
  if (ip + 1 > n) corrupt("sequences header past the block's end");
  int modes = src[ip++];
  if (modes & 3) corrupt("reserved bits of the sequence modes set");
  const int shifts[3] = {6, 4, 2}, tops[3] = {kMaxLL, kMaxOF, kMaxML}, logs[3] = {9, 8, 9};
  for (int k = 0; k < 3; k++) {
    int mode = (modes >> shifts[k]) & 3;
    if (mode == 0) {
      tables[k] = predefined(k);
    } else if (mode == 1) {
      if (ip >= n) corrupt("RLE sequence code past the block's end");
      if (src[ip] > tops[k]) corrupt("RLE sequence code out of range");
      tables[k].cells.assign(1, Cell{src[ip], 0, 0});
      tables[k].log = 0;
      ip++;
    } else if (mode == 2) {
      std::vector<int> norm;
      int log;
      ip += read_ncount(src + ip, n - ip, tops[k], norm, log);
      if (log > logs[k]) corrupt("sequence table's tableLog too large");
      tables[k].cells = fse_table(norm, log);
      tables[k].log = log;
    } else {
      if (!ctx.has_tables) corrupt("repeated sequence table without an earlier one");
      tables[k] = ctx.tables[k];
    }
  }
  return ip;
}

inline uint64_t of_base(int c) { return c == 0 ? 0 : c < 3 ? 1 : c == 3 ? 5 : (1ull << c) - 3; }

// One compressed block appended to `out` (the frame's output begins at `start`), at most `room` bytes.
inline void block(Context& ctx, const uint8_t* src, size_t n, std::vector<uint8_t>& out, size_t start, size_t room) {
  if (n > ctx.block_max) corrupt("compressed block larger than the block size limit");
  std::vector<uint8_t> lits;
  size_t used = literals(ctx, src, n, room, lits);
  int nb;
  SeqTable tables[3];
  size_t used2 = sequence_tables(ctx, src + used, n - used, nb, tables);
  const size_t at0 = out.size();
  size_t lp = 0;
  if (nb) {
    for (int k = 0; k < 3; k++) ctx.tables[k] = tables[k];
    ctx.has_tables = true;
    Backward bits(src + used + used2, n - used - used2);
    uint32_t sll = bits.read(tables[0].log), sof = bits.read(tables[1].log), sml = bits.read(tables[2].log);
    uint64_t rep[3] = {ctx.rep[0], ctx.rep[1], ctx.rep[2]};
    const uint32_t *llb = ll_base(), *mlb = ml_base();
    const uint8_t *llx = ll_bits(), *mlx = ml_bits();
    for (int i = 0; i < nb; i++) {
      const Cell &lc = tables[0].cells[sll], &oc = tables[1].cells[sof], &mc = tables[2].cells[sml];
      int of_bits = oc.sym;
      bool ll0 = lc.sym == 0;
      uint64_t offset;
      if (of_bits > 1) {
        offset = of_base(oc.sym) + bits.read(of_bits);
        rep[2] = rep[1], rep[1] = rep[0], rep[0] = offset;
      } else if (of_bits == 0) {
        offset = ll0 ? rep[1] : rep[0];
        if (ll0) rep[1] = rep[0];
        rep[0] = offset;
      } else {
        int idx = 1 + ll0 + (int)bits.read(1);
        uint64_t temp = idx == 3 ? rep[0] - 1 : rep[idx];
        if (temp == 0) temp = ~0ull;  // 0 is no offset: libzstd makes it one that fails below
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0], rep[0] = temp;
        offset = temp;
      }
      uint64_t ml = mlb[mc.sym] + bits.read(mlx[mc.sym]);
      uint64_t ll = llb[lc.sym] + bits.read(llx[lc.sym]);
      if (i != nb - 1) {
        sll = lc.next + bits.read(lc.nb);
        sml = mc.next + bits.read(mc.nb);
        sof = oc.next + bits.read(oc.nb);
      }
      if (ll + ml > room - (out.size() - at0)) corrupt("a sequence past the output's end");
      if (ll > lits.size() - lp) corrupt("a sequence reads past its literals");
      out.insert(out.end(), lits.begin() + lp, lits.begin() + lp + ll);
      lp += ll;
      if (offset > out.size() - start) corrupt("an offset before the frame's start");
      size_t from = out.size() - offset;
      out.resize(out.size() + ml);
      uint8_t* o = out.data();
      size_t to = out.size() - ml;
      for (uint64_t k = 0; k < ml; k++) o[to + k] = o[from + k];
    }
    if (bits.pos != 0) corrupt("sequences bitstream does not end at its marker");
    for (int k = 0; k < 3; k++) ctx.rep[k] = rep[k];
  }
  if (lits.size() - lp > room - (out.size() - at0)) corrupt("literals past the output's end");
  out.insert(out.end(), lits.begin() + lp, lits.end());
  if (out.size() - at0 > ctx.block_max) corrupt("decompressed block larger than the block size limit");
}

// ------------------------------------------------------------------ frames

struct Header {
  size_t size, block_max;
  uint64_t window, content;
  bool has_content, checksum;
  uint32_t dict_id;
};

inline size_t header_size(const uint8_t* p) {
  int fhd = p[4], single = (fhd >> 5) & 1;
  static const int did[4] = {0, 1, 2, 4}, fcs[4] = {0, 2, 4, 8};
  return 5 + !single + did[fhd & 3] + fcs[fhd >> 6] + (single && !(fhd >> 6));
}

inline Header header(const uint8_t* p) {
  int fhd = p[4];
  if (fhd & 0x08) corrupt("reserved bit of the frame header set");
  Header h;
  h.size = header_size(p);
  size_t pos = 5;
  bool single = (fhd >> 5) & 1;
  uint64_t window = 0;
  if (!single) {
    int wl = p[pos++], log = (wl >> 3) + 10;
    if (log > 31) corrupt("window too large");
    window = (1ull << log) + ((1ull << log) >> 3) * (wl & 7);
  }
  static const int did[4] = {0, 1, 2, 4};
  h.dict_id = le(p + pos, did[fhd & 3]);
  pos += did[fhd & 3];
  int fcs = fhd >> 6;
  h.has_content = true;
  if (fcs == 0) {
    h.has_content = single;
    h.content = single ? p[pos] : 0;
  } else if (fcs == 1) {
    h.content = le(p + pos, 2) + 256;
  } else {
    h.content = le64(p + pos, fcs == 2 ? 4 : 8);
  }
  if (single) window = h.content;
  h.window = window;
  h.block_max = window < kBlockMax ? (size_t)window : kBlockMax;
  h.checksum = (fhd >> 2) & 1;
  return h;
}

// ZSTD_decompressFrame: the frame at `at` appended to out (at most `capacity` bytes in all); the offset past it.
inline size_t frame(const uint8_t* d, size_t n, size_t at, std::vector<uint8_t>& out, size_t capacity) {
  if (n - at < 9) corrupt("frame too short");
  if (le(d + at, 4) != kMagic) corrupt("unknown frame magic");
  size_t size = header_size(d + at);
  if (n - at < size + 3) corrupt("frame header past the data's end");
  Header h = header(d + at);
  if (h.dict_id) corrupt("frame needs a dictionary");
  Context ctx;
  ctx.block_max = h.block_max;
  size_t start = out.size(), p = at + size;
  for (;;) {
    if (n - p < 3) corrupt("block header past the data's end");
    uint32_t bh = le(d + p, 3);
    int last = bh & 1, kind = (bh >> 1) & 3;
    size_t bsize = bh >> 3;
    p += 3;
    if (kind == 3) corrupt("reserved block type");
    size_t csize = kind == 1 ? 1 : bsize;
    if (csize > n - p) corrupt("block past the data's end");
    size_t room = capacity - out.size();
    if (kind == 2) {
      block(ctx, d + p, csize, out, start, room);
    } else if (bsize > room) {
      corrupt("block past the output's end");
    } else if (kind == 0) {
      out.insert(out.end(), d + p, d + p + bsize);
    } else {
      out.insert(out.end(), bsize, d[p]);
    }
    p += csize;
    if (last) break;
  }
  if (h.has_content && out.size() - start != h.content) corrupt("frame content size differs from its header");
  if (h.checksum) {
    if (n - p < 4) corrupt("checksum past the data's end");
    if (le(d + p, 4) != (uint32_t)xxh64(out.data() + start, out.size() - start)) corrupt("checksum mismatch");
    p += 4;
  }
  return p;
}

// ZSTD_decompress: every frame in turn, skippable frames skipped.
inline void decompress(const uint8_t* d, size_t n, std::vector<uint8_t>& out, size_t capacity) {
  size_t at = 0;
  while (n - at >= 5) {
    uint32_t magic = le(d + at, 4);
    if ((magic & 0xFFFFFFF0u) == kSkippable) {
      if (n - at < 8) corrupt("skippable frame header past the data's end");
      uint64_t skip = (uint64_t)le(d + at + 4, 4) + 8;
      if (skip > 0xFFFFFFFFull || skip > n - at) corrupt("skippable frame past the data's end");
      at += skip;
      continue;
    }
    at = frame(d, n, at, out, capacity);
  }
  if (at != n) corrupt("data after the last frame");
}

// ZSTD_findFrameCompressedSize: the frame's bytes, or 0 where its blocks or checksum run past the data.
inline size_t frame_extent(const uint8_t* d, size_t n, const Header& h) {
  size_t p = h.size;
  for (;;) {
    if (n - p < 3) return 0;
    uint32_t bh = le(d + p, 3);
    int kind = (bh >> 1) & 3;
    if (kind == 3) return 0;
    size_t csize = kind == 1 ? 1 : bh >> 3;
    if (3 + csize > n - p) return 0;
    p += 3 + csize;
    if (bh & 1) break;
  }
  if (h.checksum) {
    if (n - p < 4) return 0;
    p += 4;
  }
  return p;
}

// libtiff's ZSTDDecode: what the ZSTD_decompressStream loop writes into `size` bytes; returns the bytes written
// (the caller fails a strip that comes up short).
inline size_t stream(const uint8_t* d, size_t n, uint8_t* out, size_t size) {
  if (n < 5) {
    uint8_t head[4], head2[4];
    for (int i = 0; i < 4; i++) {
      head[i] = i < (int)n ? d[i] : (uint8_t)(kMagic >> (8 * i));
      head2[i] = i < (int)n ? d[i] : (uint8_t)(kSkippable >> (8 * i));
    }
    if (n && le(head, 4) != kMagic && (le(head2, 4) & 0xFFFFFFF0u) != kSkippable) corrupt("unknown frame magic");
    return 0;
  }
  uint32_t magic = le(d, 4);
  if ((magic & 0xFFFFFFF0u) == kSkippable) return 0;
  if (magic != kMagic) corrupt("unknown frame magic");
  if (n < header_size(d)) return 0;
  Header h = header(d);
  std::vector<uint8_t> fr;
  if (h.has_content && size >= h.content) {  // libzstd's single-pass shortcut, when the frame is all there
    size_t total = frame_extent(d, n, h);
    if (total) {
      frame(d, total, 0, fr, size);
      memcpy(out, fr.data(), fr.size());
      return fr.size();
    }
  }
  if (h.dict_id) corrupt("frame needs a dictionary");
  if ((h.window > 1024 ? h.window : 1024) > kStreamWindowMax) corrupt("window larger than the streaming limit");
  Context ctx;
  ctx.block_max = h.block_max;
  size_t flushed = 0, p = h.size;
  auto flush = [&](size_t before) {  // copies what fits; false when the block did not fit
    size_t got = fr.size() - before, take = size - flushed < got ? size - flushed : got;
    memcpy(out + flushed, fr.data() + before, take);
    flushed += take;
    return take == got;
  };
  for (;;) {
    if (n - p < 3) return flushed;
    uint32_t bh = le(d + p, 3);
    int last = bh & 1, kind = (bh >> 1) & 3;
    size_t bsize = bh >> 3;
    if (kind == 3) corrupt("reserved block type");
    size_t csize = kind == 1 ? 1 : bsize;
    if (csize > h.block_max) corrupt("block larger than the block size limit");
    p += 3;
    size_t before = fr.size();
    if (csize) {
      if (kind == 0) {
        size_t take = csize < n - p ? csize : n - p;
        if (!take) return flushed;
        fr.insert(fr.end(), d + p, d + p + take);
        p += take;
        if (take < csize) {  // the rest of a raw block never comes
          flush(before);
          return flushed;
        }
      } else {
        if (n - p < csize) return flushed;
        if (kind == 1) {
          if (bsize > h.block_max) corrupt("RLE block larger than the block size limit");
          fr.insert(fr.end(), bsize, d[p]);
        } else {
          block(ctx, d + p, csize, fr, 0, h.block_max);
        }
        p += csize;
      }
      if (last && h.has_content && fr.size() != h.content) corrupt("frame content size differs from its header");
    }
    if (!flush(before)) return flushed;
    if (last) break;
  }
  if (h.checksum) {
    if (n - p < 4) return flushed;
    if (le(d + p, 4) != (uint32_t)xxh64(fr.data(), fr.size())) corrupt("checksum mismatch");
  }
  return flushed;
}

}  // namespace zstd
