// JPEG 2000 tiles to Pillow's unpacked image: host code, no kernel.
//
// The native half of uniir_tpu_torch/data/jpeg2000.py::decode_twin, which is the reference, and of its
// modules data/j2k_t2.py, data/j2k_t1.py and data/j2k_dwt.py, whose docstrings state the rules; this file
// holds the same function step for step.  Python reads the boxes and the codestream's headers and hands
// over a plan (`uniir_jpeg2000_decode`'s comment); this file decodes each tile as OpenJPEG 2.5.4 does
// (tier 2 in the tile's progression with its POC changes, packet headers from the data or from PPM / PPT,
// tier 1 with the MQ decoder and every code-block style, the 5/3 or 9/7 inverse DWT, the RCT / ICT and
// the level shift) and unpacks it as Pillow's Jpeg2KDecode.c does into Pillow's image buffer, through
// the tile buffer Pillow reuses from tile to tile.  The 9/7 path is float32 with every product and sum
// rounded on its own (built with -ffp-contract=off), as the SSE2 build of OpenJPEG computes it.  A tile
// OpenJPEG refuses returns an error with a message; nothing is read or written out of bounds.
//
// Why host code and not a kernel: tier 1 is an arithmetic decoder whose every decision depends on the one
// before, tier 2 a bit reader, and the images are resized on the host after decoding.  No global state,
// so the loader's threads (ctypes releases the GIL) decode in parallel.
//
// Built by uniir_tpu_torch/_build.py with nvcc like the kernels' sources.

#include <algorithm>
#include <array>
#include <cmath>
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

[[noreturn]] void fail(const char* fmt, long a = 0, long b = 0) {
  char buf[200];
  snprintf(buf, sizeof(buf), fmt, a, b);
  throw Error{buf};
}

inline int64_t ceildiv(int64_t a, int64_t b) { return a >= 0 ? (a + b - 1) / b : -((-a) / b); }
inline int64_t ceildivpow2(int64_t a, int b) { return -((-a) >> b); }

// ===================================================================== tier 1 (data/j2k_t1.py)

const int BYPASS = 1, RESET = 2, TERMALL = 4, VSC = 8, SEGSYM = 32;
const uint16_t QE[47] = {0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001,
                         0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801,
                         0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1,
                         0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009,
                         0x0005, 0x0001, 0x5601};
const uint8_t NMPS[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
                          25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t NLPS[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21,
                          22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const int CTX_RL = 17, CTX_UNI = 18;

struct Tables {
  uint8_t zc[4][45];
  uint8_t sc_ctx[25], sc_xor[25];
  Tables() {
    for (int orient = 0; orient < 4; ++orient)
      for (int h = 0; h < 3; ++h)
        for (int v = 0; v < 3; ++v)
          for (int d = 0; d < 5; ++d) {
            int hh = orient == 1 ? v : h, vv = orient == 1 ? h : v, n;
            if (orient == 3) {
              int hv = hh + vv;
              n = d == 0 ? (hv == 0 ? 0 : hv == 1 ? 1 : 2)
                  : d == 1 ? (hv == 0 ? 3 : hv == 1 ? 4 : 5)
                  : d == 2 ? (hv == 0 ? 6 : 7) : 8;
            } else if (hh == 0) {
              n = vv == 0 ? (d == 0 ? 0 : d == 1 ? 1 : 2) : vv == 1 ? 3 : 4;
            } else if (hh == 1) {
              n = vv == 0 ? (d == 0 ? 5 : 6) : 7;
            } else {
              n = 8;
            }
            zc[orient][h * 15 + v * 5 + d] = (uint8_t)n;
          }
    for (int h = -2; h <= 2; ++h)
      for (int v = -2; v <= 2; ++v) {
        int h1 = std::max(-1, std::min(1, h)), v1 = std::max(-1, std::min(1, v)), x = 0;
        if (h1 < 0) { h1 = -h1; v1 = -v1; x = 1; }
        else if (h1 == 0 && v1 < 0) { v1 = -v1; x = 1; }
        sc_ctx[(h + 2) * 5 + v + 2] = (uint8_t)(h1 ? 12 + v1 : 9 + v1);
        sc_xor[(h + 2) * 5 + v + 2] = (uint8_t)x;
      }
  }
};
const Tables T;

struct MQ {
  uint8_t state[19], mps[19];
  const uint8_t* buf = nullptr;  // the segment followed by FF FF
  size_t bp = 0;
  uint32_t a = 0, c = 0;
  int ct = 0;
  std::vector<uint8_t> seg;

  void reset() {
    memset(state, 0, sizeof(state));
    memset(mps, 0, sizeof(mps));
    state[CTX_UNI] = 46;
    state[CTX_RL] = 3;
    state[0] = 4;
  }
  void load(const uint8_t* p, size_t n) {
    seg.assign(p, p + n);
    seg.push_back(0xFF);
    seg.push_back(0xFF);
    buf = seg.data();
    bp = 0;
  }
  void bytein() {
    if (buf[bp] == 0xFF) {
      if (buf[bp + 1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        bp++;
        c += (uint32_t)buf[bp] << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += (uint32_t)buf[bp] << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* p, size_t n) {
    load(p, n);
    c = (uint32_t)buf[0] << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  int decode(int cx) {
    int st = state[cx];
    uint32_t qe = QE[st];
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = mps[cx];
        state[cx] = NMPS[st];
      } else {
        d = 1 - mps[cx];
        if (st == 0 || st == 6 || st == 14) mps[cx] = (uint8_t)d;
        state[cx] = NLPS[st];
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return mps[cx];
      if (a < qe) {
        d = 1 - mps[cx];
        if (st == 0 || st == 6 || st == 14) mps[cx] = (uint8_t)d;
        state[cx] = NLPS[st];
      } else {
        d = mps[cx];
        state[cx] = NMPS[st];
      }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
    return d;
  }
  void raw_init(const uint8_t* p, size_t n) {
    load(p, n);
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (buf[bp] > 0x8F) {
          ct = 8;
        } else {
          c = buf[bp++];
          ct = 7;
        }
      } else {
        c = buf[bp++];
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1;
  }
};

struct Block {
  int w, h, W;
  std::vector<int32_t> mag;
  std::vector<uint8_t> neg, sig, vis, ref, cnt;
  std::vector<int8_t> hs, vs;
  bool vsc;
  const uint8_t* zc;
  MQ mq;

  void significant(int p, int s, bool top) {
    int c = s ? -1 : 1;
    sig[p] = 1;
    cnt[p - 1] += 15;
    cnt[p + 1] += 15;
    hs[p - 1] += c;
    hs[p + 1] += c;
    cnt[p + W] += 5;
    vs[p + W] += c;
    cnt[p + W - 1] += 1;
    cnt[p + W + 1] += 1;
    if (!(vsc && top)) {
      cnt[p - W] += 5;
      vs[p - W] += c;
      cnt[p - W - 1] += 1;
      cnt[p - W + 1] += 1;
    }
  }
  int sign(int p) {
    int i = (hs[p] + 2) * 5 + vs[p] + 2;
    return mq.decode(T.sc_ctx[i]) ^ T.sc_xor[i];
  }
  void sigpass(int bp, bool raw) {
    int32_t one = 1 << bp, oph = one | (one >> 1);
    for (int y0 = 0; y0 < h; y0 += 4) {
      int rows = std::min(4, h - y0);
      for (int x = 0; x < w; ++x) {
        int p = (y0 + 1) * W + x + 1;
        for (int r = 0; r < rows; ++r, p += W) {
          if (sig[p] || !cnt[p]) continue;
          if (raw) {
            if (mq.raw()) {
              int s = mq.raw();
              mag[p] = oph;
              neg[p] = (uint8_t)s;
              significant(p, s, r == 0);
            }
          } else if (mq.decode(zc[cnt[p]])) {
            int s = sign(p);
            mag[p] = oph;
            neg[p] = (uint8_t)s;
            significant(p, s, r == 0);
          }
          vis[p] = 1;
        }
      }
    }
  }
  void refpass(int bp, bool raw) {
    int32_t half = (1 << bp) >> 1;
    for (int y0 = 0; y0 < h; y0 += 4) {
      int rows = std::min(4, h - y0);
      for (int x = 0; x < w; ++x) {
        int p = (y0 + 1) * W + x + 1;
        for (int r = 0; r < rows; ++r, p += W) {
          if (!sig[p] || vis[p]) continue;
          int v = raw ? mq.raw() : mq.decode(ref[p] ? 16 : cnt[p] ? 15 : 14);
          mag[p] += v ? half : -half;
          ref[p] = 1;
        }
      }
    }
  }
  void clnpass(int bp, int style) {
    int32_t one = 1 << bp, oph = one | (one >> 1);
    for (int y0 = 0; y0 < h; y0 += 4) {
      int rows = std::min(4, h - y0);
      for (int x = 0; x < w; ++x) {
        int p0 = (y0 + 1) * W + x + 1;
        int r = 0;
        if (rows == 4) {
          int p1 = p0 + W, p2 = p0 + 2 * W, p3 = p0 + 3 * W;
          if (!(sig[p0] | sig[p1] | sig[p2] | sig[p3] | vis[p0] | vis[p1] | vis[p2] | vis[p3] | cnt[p0] | cnt[p1] |
                cnt[p2] | cnt[p3])) {
            if (!mq.decode(CTX_RL)) continue;
            r = mq.decode(CTX_UNI) << 1;
            r |= mq.decode(CTX_UNI);
            int p = p0 + r * W;
            int s = sign(p);
            mag[p] = oph;
            neg[p] = (uint8_t)s;
            significant(p, s, r == 0);
            r++;
          }
        }
        int p = p0 + r * W;
        for (int rr = r; rr < rows; ++rr, p += W) {
          if (!(sig[p] || vis[p]) && mq.decode(zc[cnt[p]])) {
            int s = sign(p);
            mag[p] = oph;
            neg[p] = (uint8_t)s;
            significant(p, s, rr == 0);
          }
        }
      }
    }
    std::fill(vis.begin(), vis.end(), 0);
    if (style & SEGSYM)
      for (int i = 0; i < 4; ++i) mq.decode(CTX_UNI);
  }
};

struct Seg {
  int64_t len = 0, numpasses = 0, maxpasses = 0, newlen = 0, numnewpasses = 0, real_num_passes = 0;
};

// j2k_t1.decode_block: w x h values (one fractional bit, ROI shift undone) into out
void decode_block(const uint8_t* data, const std::vector<Seg>& segs, int nsegs, int w, int h, int64_t numbps,
                  int roishift, int orient, int style, std::vector<int32_t>& out) {
  Block b;
  b.w = w;
  b.h = h;
  b.W = w + 2;
  size_t size = (size_t)b.W * (h + 2);
  b.mag.assign(size, 0);
  b.neg.assign(size, 0);
  b.sig.assign(size, 0);
  b.vis.assign(size, 0);
  b.ref.assign(size, 0);
  b.cnt.assign(size, 0);
  b.hs.assign(size, 0);
  b.vs.assign(size, 0);
  b.vsc = style & VSC;
  b.zc = T.zc[orient];
  b.mq.reset();
  int64_t bpno = roishift + numbps;
  if (bpno >= 31) fail("code-block of %ld bit-planes", (long)bpno);
  int passtype = 2;
  size_t pos = 0;
  for (int s = 0; s < nsegs; ++s) {
    bool raw = bpno <= numbps - 4 && passtype < 2 && (style & BYPASS);
    size_t len = (size_t)segs[s].len;
    if (raw)
      b.mq.raw_init(data + pos, len);
    else
      b.mq.init(data + pos, len);
    pos += len;
    for (int64_t done = 0; done < segs[s].real_num_passes && bpno >= 1; ++done) {
      if (passtype == 0)
        b.sigpass((int)bpno, raw);
      else if (passtype == 1)
        b.refpass((int)bpno, raw);
      else
        b.clnpass((int)bpno, style);
      if ((style & RESET) && !raw) b.mq.reset();
      if (++passtype == 3) {
        passtype = 0;
        bpno--;
      }
    }
  }
  out.resize((size_t)w * h);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int p = (y + 1) * b.W + x + 1;
      out[(size_t)y * w + x] = b.neg[p] ? -b.mag[p] : b.mag[p];
    }
  if (roishift) {
    if (roishift >= 31) {
      std::fill(out.begin(), out.end(), 0);
    } else {
      int32_t thresh = 1 << roishift;
      for (auto& v : out) {
        int32_t m = v < 0 ? -v : v;
        if (m >= thresh) v = v < 0 ? -(m >> roishift) : (m >> roishift);
      }
    }
  }
}

// ===================================================================== tier 2 (data/j2k_t2.py)

struct TagTree {
  std::vector<int> parent, value, low;
  TagTree(int w, int h) {
    if (w * h == 0) return;
    std::vector<std::pair<int, int>> sizes;
    int nw = w, nh = h;
    while (true) {
      sizes.push_back({nw, nh});
      if (nw * nh <= 1) break;
      nw = (nw + 1) / 2;
      nh = (nh + 1) / 2;
    }
    std::vector<int> start(1, 0);
    for (auto& s : sizes) start.push_back(start.back() + s.first * s.second);
    for (size_t lvl = 0; lvl < sizes.size(); ++lvl)
      for (int j = 0; j < sizes[lvl].second; ++j)
        for (int i = 0; i < sizes[lvl].first; ++i)
          parent.push_back(lvl + 1 < sizes.size() ? start[lvl + 1] + (j >> 1) * sizes[lvl + 1].first + (i >> 1) : -1);
    reset();
  }
  void reset() {
    value.assign(parent.size(), 999);
    low.assign(parent.size(), 0);
  }
};

struct Bio {
  const uint8_t* buf;
  size_t start, bp, end;
  uint32_t word = 0;
  int ct = 0;
  Bio(const uint8_t* b, size_t s, size_t e) : buf(b), start(s), bp(s), end(e) {}
  void bytein() {
    word = (word << 8) & 0xFFFF;
    ct = word == 0xFF00 ? 7 : 8;
    if (bp < end) word |= buf[bp++];
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) {
      if (ct == 0) bytein();
      ct--;
      v |= ((word >> ct) & 1u) << i;
    }
    return v;
  }
  void inalign() {
    if ((word & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
};

int tgt_decode(TagTree& t, Bio& bio, int leaf, int threshold) {
  int stack[32], sp = 0;
  int node = leaf;
  while (t.parent[node] >= 0) {
    stack[sp++] = node;
    node = t.parent[node];
  }
  int low = 0;
  while (true) {
    if (low > t.low[node])
      t.low[node] = low;
    else
      low = t.low[node];
    while (low < threshold && low < t.value[node]) {
      if (bio.read(1))
        t.value[node] = low;
      else
        low++;
    }
    t.low[node] = low;
    if (sp == 0) break;
    node = stack[--sp];
  }
  return t.value[node] < threshold ? 1 : 0;
}

struct Codeblock {
  int64_t x0, y0, x1, y1;
  int64_t numbps = 0, numlenbits = 0, numnewpasses = 0;
  int numsegs = 0;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;
  bool any = false;
};

struct Precinct {
  int64_t cw, ch;
  std::vector<Codeblock> cblks;
  TagTree incl, imsb;
  Precinct(int64_t w, int64_t h) : cw(w), ch(h), incl((int)w, (int)h), imsb((int)w, (int)h) {}
};

struct Band {
  int bandno;
  int64_t x0, y0, x1, y1, numbps;
  float stepsize;
  std::vector<Precinct> precincts;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Resolution {
  int64_t x0, y0, x1, y1;
  int pdx, pdy;
  int64_t pw, ph;
  std::vector<Band> bands;
};

struct Tccp {
  int numres, cblkw, cblkh, cblksty, qmfbid, roishift, numgbits;
  int prcw[33], prch[33];
  std::vector<std::pair<int, int>> steps;
};

struct Comp {
  int dx, dy, prec, sgnd;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  std::vector<Resolution> res;
};

struct Tile {
  int64_t x0, y0, x1, y1;
  std::vector<TileComp> comps;
};

struct Image {
  int numcomps;
  int64_t x0, y0, x1, y1, tx0, ty0, tdx, tdy, tw, th;
  std::vector<Comp> comps;
};

struct Tcp {
  int csty, prg, numlayers, mct;
  std::vector<std::array<int64_t, 6>> pocs;
  std::vector<Tccp> tccps;
};

void tile_bounds(const Image& im, int64_t tileno, int64_t& x0, int64_t& y0, int64_t& x1, int64_t& y1) {
  int64_t p = tileno % im.tw, q = tileno / im.tw;
  x0 = std::max(im.tx0 + p * im.tdx, im.x0);
  y0 = std::max(im.ty0 + q * im.tdy, im.y0);
  x1 = std::min(im.tx0 + (p + 1) * im.tdx, im.x1);
  y1 = std::min(im.ty0 + (q + 1) * im.tdy, im.y1);
}

void build_tile(const Image& im, const Tcp& tcp, int64_t tileno, Tile& tile) {
  tile_bounds(im, tileno, tile.x0, tile.y0, tile.x1, tile.y1);
  tile.comps.resize(im.numcomps);
  for (int c = 0; c < im.numcomps; ++c) {
    const Tccp& tccp = tcp.tccps[c];
    TileComp& tc = tile.comps[c];
    const Comp& k = im.comps[c];
    tc.x0 = ceildiv(tile.x0, k.dx);
    tc.y0 = ceildiv(tile.y0, k.dy);
    tc.x1 = ceildiv(tile.x1, k.dx);
    tc.y1 = ceildiv(tile.y1, k.dy);
    tc.res.resize(tccp.numres);
    size_t stepno = 0;
    for (int r = 0; r < tccp.numres; ++r) {
      int level = tccp.numres - 1 - r;
      Resolution& res = tc.res[r];
      res.x0 = ceildivpow2(tc.x0, level);
      res.y0 = ceildivpow2(tc.y0, level);
      res.x1 = ceildivpow2(tc.x1, level);
      res.y1 = ceildivpow2(tc.y1, level);
      res.pdx = tccp.prcw[r];
      res.pdy = tccp.prch[r];
      int64_t px0 = (res.x0 >> res.pdx) << res.pdx, py0 = (res.y0 >> res.pdy) << res.pdy;
      int64_t px1 = ceildivpow2(res.x1, res.pdx) << res.pdx, py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
      res.pw = res.x0 == res.x1 ? 0 : (px1 - px0) >> res.pdx;
      res.ph = res.y0 == res.y1 ? 0 : (py1 - py0) >> res.pdy;
      if (res.pw * res.ph > (1 << 24)) fail("too many precincts (%ld)", (long)(res.pw * res.ph));
      int64_t cbgx, cbgy;
      int cbgw, cbgh;
      if (r == 0) {
        cbgx = px0; cbgy = py0; cbgw = res.pdx; cbgh = res.pdy;
      } else {
        cbgx = ceildivpow2(px0, 1); cbgy = ceildivpow2(py0, 1); cbgw = res.pdx - 1; cbgh = res.pdy - 1;
      }
      int cbw = std::min(tccp.cblkw, cbgw), cbh = std::min(tccp.cblkh, cbgh);
      int nb = r == 0 ? 1 : 3;
      for (int bi = 0; bi < nb; ++bi) {
        Band band;
        band.bandno = r == 0 ? 0 : bi + 1;
        if (r == 0) {
          band.x0 = res.x0; band.y0 = res.y0; band.x1 = res.x1; band.y1 = res.y1;
        } else {
          int64_t xb = band.bandno & 1, yb = band.bandno >> 1;
          band.x0 = ceildivpow2(tc.x0 - (xb << level), level + 1);
          band.y0 = ceildivpow2(tc.y0 - (yb << level), level + 1);
          band.x1 = ceildivpow2(tc.x1 - (xb << level), level + 1);
          band.y1 = ceildivpow2(tc.y1 - (yb << level), level + 1);
        }
        std::pair<int, int> st = stepno < tccp.steps.size() ? tccp.steps[stepno] : std::make_pair(0, 0);
        stepno++;
        band.numbps = (int64_t)st.first + tccp.numgbits - 1;
        band.stepsize = (float)((1.0 + st.second / 2048.0) * std::pow(2.0, (double)(k.prec - st.first)));
        for (int64_t precno = 0; precno < res.pw * res.ph; ++precno) {
          int64_t gx0 = cbgx + (precno % res.pw) * ((int64_t)1 << cbgw);
          int64_t gy0 = cbgy + (precno / res.pw) * ((int64_t)1 << cbgh);
          int64_t x0 = std::max(gx0, band.x0), y0 = std::max(gy0, band.y0);
          int64_t x1 = std::min(gx0 + ((int64_t)1 << cbgw), band.x1), y1 = std::min(gy0 + ((int64_t)1 << cbgh), band.y1);
          int64_t tlx = (x0 >> cbw) << cbw, tly = (y0 >> cbh) << cbh;
          int64_t brx = ceildivpow2(x1, cbw) << cbw, bry = ceildivpow2(y1, cbh) << cbh;
          int64_t cw = (brx - tlx) >> cbw, ch = (bry - tly) >> cbh;
          if (cw < 0 || ch < 0) fail("precinct of negative size");
          if (cw * ch > (1 << 24)) fail("too many code-blocks");
          band.precincts.emplace_back(cw, ch);
          Precinct& prc = band.precincts.back();
          prc.cblks.resize(cw * ch);
          for (int64_t i = 0; i < cw * ch; ++i) {
            int64_t cx0 = tlx + (i % cw) * ((int64_t)1 << cbw), cy0 = tly + (i / cw) * ((int64_t)1 << cbh);
            Codeblock& b = prc.cblks[i];
            b.x0 = std::max(cx0, x0);
            b.y0 = std::max(cy0, y0);
            b.x1 = std::min(cx0 + ((int64_t)1 << cbw), x1);
            b.y1 = std::min(cy0 + ((int64_t)1 << cbh), y1);
          }
        }
        res.bands.push_back(std::move(band));
      }
    }
  }
}

struct Packet {
  int l, r, c;
  int64_t p;
};

// j2k_t2.packets: the packets in OpenJPEG's iteration order
void packets(const Image& im, const Tcp& tcp, const Tile& tile, std::vector<Packet>& out) {
  int nc = im.numcomps;
  int max_res = 0;
  for (int c = 0; c < nc; ++c) max_res = std::max(max_res, tcp.tccps[c].numres);
  int64_t max_prec = 1;
  for (auto& tc : tile.comps)
    for (auto& res : tc.res) max_prec = std::max(max_prec, res.pw * res.ph);
  std::vector<std::array<int64_t, 6>> progs;
  if (!tcp.pocs.empty()) {
    for (auto& p : tcp.pocs)
      progs.push_back({p[5], p[0], p[1], std::min<int64_t>(p[2], tcp.numlayers), p[3], std::min<int64_t>(p[4], nc)});
  } else {
    progs.push_back({tcp.prg, 0, 0, tcp.numlayers, max_res, nc});
  }
  std::vector<uint8_t> seen((size_t)tcp.numlayers * max_res * nc * max_prec, 0);
  auto fresh = [&](int l, int r, int c, int64_t p) {
    size_t i = (((size_t)l * max_res + r) * nc + c) * max_prec + p;
    if (seen[i]) return false;
    seen[i] = 1;
    return true;
  };
  auto nres = [&](int c) { return (int)tile.comps[c].res.size(); };
  int64_t tx0 = tile.x0, ty0 = tile.y0, tx1 = tile.x1, ty1 = tile.y1;
  auto step = [&](int c0, int c1, int64_t& dx, int64_t& dy) {
    dx = dy = 0;
    for (int c = c0; c < c1; ++c) {
      int n = nres(c);
      for (int r = 0; r < n; ++r) {
        const Resolution& res = tile.comps[c].res[r];
        int ex = res.pdx + n - 1 - r, ey = res.pdy + n - 1 - r;
        if (ex < 32 && (uint64_t)im.comps[c].dx <= 0xFFFFFFFFull / (1ull << ex)) {
          int64_t v = (int64_t)im.comps[c].dx << ex;
          dx = dx ? std::min(dx, v) : v;
        }
        if (ey < 32 && (uint64_t)im.comps[c].dy <= 0xFFFFFFFFull / (1ull << ey)) {
          int64_t v = (int64_t)im.comps[c].dy << ey;
          dy = dy ? std::min(dy, v) : v;
        }
      }
    }
  };
  auto precinct_at = [&](int c, int r, int64_t x, int64_t y) -> int64_t {
    int64_t cdx = im.comps[c].dx, cdy = im.comps[c].dy;
    const Resolution& res = tile.comps[c].res[r];
    int level = nres(c) - 1 - r;
    if (level >= 32) return -1;
    int64_t trx0 = ceildiv(tx0, cdx << level), try0 = ceildiv(ty0, cdy << level);
    int64_t trx1 = ceildiv(tx1, cdx << level), try1 = ceildiv(ty1, cdy << level);
    int rpx = res.pdx + level, rpy = res.pdy + level;
    if (rpx >= 62 || rpy >= 62) return -1;
    if (!(y % (cdy << rpy) == 0 || (y == ty0 && ((try0 << level) % ((int64_t)1 << rpy))))) return -1;
    if (!(x % (cdx << rpx) == 0 || (x == tx0 && ((trx0 << level) % ((int64_t)1 << rpx))))) return -1;
    if (res.pw == 0 || res.ph == 0 || trx0 == trx1 || try0 == try1) return -1;
    int64_t prci = (ceildiv(x, cdx << level) >> res.pdx) - (trx0 >> res.pdx);
    int64_t prcj = (ceildiv(y, cdy << level) >> res.pdy) - (try0 >> res.pdy);
    return prci + prcj * res.pw;
  };
  for (auto& pg : progs) {
    int prg = (int)pg[0], r0 = (int)pg[1], c0 = (int)pg[2], l1 = (int)pg[3], r1 = (int)pg[4], c1 = (int)pg[5];
    if (prg == 0 || prg == 1) {
      int A = prg == 0 ? l1 : r1, B = prg == 0 ? r1 : l1;
      for (int a = prg == 0 ? 0 : r0; a < A; ++a)
        for (int b = prg == 0 ? r0 : 0; b < B; ++b) {
          int l = prg == 0 ? a : b, r = prg == 0 ? b : a;
          for (int c = c0; c < c1; ++c) {
            if (r >= nres(c)) continue;
            const Resolution& res = tile.comps[c].res[r];
            for (int64_t p = 0; p < res.pw * res.ph; ++p)
              if (fresh(l, r, c, p)) out.push_back({l, r, c, p});
          }
        }
    } else if (prg == 4) {
      for (int c = c0; c < c1; ++c) {
        int64_t dx, dy;
        step(c, c + 1, dx, dy);
        if (dx == 0 || dy == 0) return;
        for (int64_t y = ty0; y < ty1; y += dy - y % dy)
          for (int64_t x = tx0; x < tx1; x += dx - x % dx)
            for (int r = r0; r < std::min(r1, nres(c)); ++r) {
              int64_t p = precinct_at(c, r, x, y);
              if (p < 0) continue;
              for (int l = 0; l < l1; ++l)
                if (fresh(l, r, c, p)) out.push_back({l, r, c, p});
            }
      }
    } else if (prg == 2 || prg == 3) {
      int64_t dx, dy;
      step(0, nc, dx, dy);
      if (dx == 0 || dy == 0) return;
      if (prg == 2) {
        for (int r = r0; r < r1; ++r)
          for (int64_t y = ty0; y < ty1; y += dy - y % dy)
            for (int64_t x = tx0; x < tx1; x += dx - x % dx)
              for (int c = c0; c < c1; ++c) {
                if (r >= nres(c)) continue;
                int64_t p = precinct_at(c, r, x, y);
                if (p < 0) continue;
                for (int l = 0; l < l1; ++l)
                  if (fresh(l, r, c, p)) out.push_back({l, r, c, p});
              }
      } else {
        for (int64_t y = ty0; y < ty1; y += dy - y % dy)
          for (int64_t x = tx0; x < tx1; x += dx - x % dx)
            for (int c = c0; c < c1; ++c)
              for (int r = r0; r < std::min(r1, nres(c)); ++r) {
                int64_t p = precinct_at(c, r, x, y);
                if (p < 0) continue;
                for (int l = 0; l < l1; ++l)
                  if (fresh(l, r, c, p)) out.push_back({l, r, c, p});
              }
      }
    } else {
      fail("unknown progression order %ld", prg);
    }
  }
}

void init_seg(Codeblock& b, size_t index, int style, bool first) {
  int64_t maxpasses;
  if (style & TERMALL)
    maxpasses = 1;
  else if (style & BYPASS)
    maxpasses = first ? 10 : ((b.segs[index - 1].maxpasses == 1 || b.segs[index - 1].maxpasses == 10) ? 2 : 1);
  else
    maxpasses = 109;
  Seg s;
  s.maxpasses = maxpasses;
  if (index < b.segs.size())
    b.segs[index] = s;
  else
    b.segs.push_back(s);
}

int numpasses(Bio& bio) {
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  int n = (int)bio.read(2);
  if (n != 3) return 3 + n;
  n = (int)bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + (int)bio.read(7);
}

struct HeaderSource {
  const uint8_t* data = nullptr;
  size_t pos = 0, len = 0;
};

// j2k_t2.read_packets: returns per component the highest resolution a packet was read for
std::vector<int> read_packets(const Image& im, const Tcp& tcp, Tile& tile, const uint8_t* data, size_t end,
                              HeaderSource* hs) {
  std::vector<Packet> order;
  packets(im, tcp, tile, order);
  std::vector<int> decoded(im.numcomps, 0);
  size_t pos = 0;
  std::vector<Codeblock*> included;
  for (const Packet& pk : order) {
    const Tccp& tccp = tcp.tccps[pk.c];
    Resolution& res = tile.comps[pk.c].res[pk.r];
    decoded[pk.c] = std::max(decoded[pk.c], pk.r);
    if (pk.l == 0)
      for (Band& band : res.bands)
        if (!band.empty()) {
          Precinct& prc = band.precincts[pk.p];
          prc.incl.reset();
          prc.imsb.reset();
          for (auto& b : prc.cblks) b.numsegs = 0;
        }
    if (tcp.csty & 2)
      if (end - pos >= 6 && data[pos] == 0xFF && data[pos + 1] == 0x91) pos += 6;
    const uint8_t* hbuf;
    size_t hstart, hend;
    if (hs) {
      hbuf = hs->data; hstart = hs->pos; hend = hs->len;
    } else {
      hbuf = data; hstart = pos; hend = end;
    }
    Bio bio(hbuf, hstart, hend);
    uint32_t present = bio.read(1);
    included.clear();
    if (present) {
      for (Band& band : res.bands) {
        if (band.empty()) continue;
        Precinct& prc = band.precincts[pk.p];
        for (size_t cbn = 0; cbn < prc.cblks.size(); ++cbn) {
          Codeblock& b = prc.cblks[cbn];
          uint32_t inc = b.numsegs == 0 ? (uint32_t)tgt_decode(prc.incl, bio, (int)cbn, pk.l + 1) : bio.read(1);
          if (!inc) {
            b.numnewpasses = 0;
            continue;
          }
          if (!b.numsegs) {
            int i = 0;
            while (!tgt_decode(prc.imsb, bio, (int)cbn, i)) ++i;
            b.numbps = band.numbps + 1 - i;
            b.numlenbits = 3;
          }
          b.numnewpasses = numpasses(bio);
          while (bio.read(1)) b.numlenbits++;
          size_t segno = 0;
          if (!b.numsegs) {
            init_seg(b, 0, tccp.cblksty, true);
          } else {
            segno = b.numsegs - 1;
            if (b.segs[segno].numpasses == b.segs[segno].maxpasses) {
              segno++;
              init_seg(b, segno, tccp.cblksty, false);
            }
          }
          int64_t n = b.numnewpasses;
          while (true) {
            Seg& s = b.segs[segno];
            s.numnewpasses = std::min(s.maxpasses - s.numpasses, n);
            int64_t bits = b.numlenbits;
            for (int64_t v = s.numnewpasses; v > 1; v >>= 1) bits++;
            if (bits > 32) fail("invalid bit number %ld in a packet header", (long)bits);
            s.newlen = bio.read((int)bits);
            n -= s.numnewpasses;
            if (n <= 0) break;
            segno++;
            init_seg(b, segno, tccp.cblksty, false);
          }
          included.push_back(&b);
        }
      }
    }
    bio.inalign();
    size_t hpos = bio.bp;
    if ((tcp.csty & 4) && hend - hpos >= 2) {
      if (hbuf[hpos] != 0xFF || hbuf[hpos + 1] != 0x92) fail("Expected EPH marker");
      hpos += 2;
    }
    if (hs)
      hs->pos = hpos;
    else
      pos = hpos;
    if (!present) continue;
    for (Codeblock* bp : included) {
      Codeblock& b = *bp;
      size_t segno;
      if (!b.numsegs) {
        segno = 0;
        b.numsegs = 1;
      } else {
        segno = b.numsegs - 1;
        if (b.segs[segno].numpasses == b.segs[segno].maxpasses) {
          segno++;
          b.numsegs++;
        }
      }
      while (true) {
        Seg& s = b.segs[segno];
        if ((uint64_t)s.newlen > end - pos) fail("segment of %ld bytes past the tile's data (read: segment too long)", (long)s.newlen);
        b.data.insert(b.data.end(), data + pos, data + pos + s.newlen);
        b.any = true;
        pos += s.newlen;
        s.len += s.newlen;
        s.numpasses += s.numnewpasses;
        b.numnewpasses -= s.numnewpasses;
        s.real_num_passes = s.numpasses;
        if (b.numnewpasses <= 0) break;
        segno++;
        b.numsegs++;
      }
    }
  }
  return decoded;
}

// ===================================================================== DWT (data/j2k_dwt.py)

const float ALPHA = -1.586134342f, BETA = -0.052980118f, GAMMA = 0.882911075f, DELTA = 0.443506852f;
const float K = 1.230174105f, TWO_INV_K = 1.625732422f;

// one line of n samples (stride apart) through the 5/3 synthesis
void idwt53_line(int32_t* a, size_t stride, int n, int sn, int cas, std::vector<int32_t>& y) {
  if (n == 1) {
    if (cas) a[0] /= 2;
    return;
  }
  y.resize(n);
  for (int i = 0; i < sn; ++i) y[cas + 2 * i] = a[i * stride];
  for (int i = 0; i < n - sn; ++i) y[1 - cas + 2 * i] = a[(sn + i) * stride];
  auto L = [&](int p) { return p >= 1 ? p - 1 : p + 1; };
  auto R = [&](int p) { return p + 1 < n ? p + 1 : p - 1; };
  for (int p = cas; p < n; p += 2) {
    int l = L(p), r = R(p);
    uint32_t upd = l == r ? (uint32_t)((int32_t)((uint32_t)y[l] + 1u) >> 1)
                          : (uint32_t)((int32_t)((uint32_t)y[l] + (uint32_t)y[r] + 2u) >> 2);
    y[p] = (int32_t)((uint32_t)y[p] - upd);
  }
  for (int p = 1 - cas; p < n; p += 2) {
    int l = L(p), r = R(p);
    uint32_t upd = l == r ? (uint32_t)y[l] : (uint32_t)((int32_t)((uint32_t)y[l] + (uint32_t)y[r]) >> 1);
    y[p] = (int32_t)((uint32_t)y[p] + upd);
  }
  for (int p = 0; p < n; ++p) a[p * stride] = y[p];
}

void idwt97_line(float* a, size_t stride, int n, int sn, int cas, std::vector<float>& y) {
  int dn = n - sn;
  if ((cas == 0 && !(dn > 0 || sn > 1)) || (cas == 1 && !(sn > 0 || dn > 1))) return;
  y.resize(n);
  for (int i = 0; i < sn; ++i) y[cas + 2 * i] = a[i * stride];
  for (int i = 0; i < dn; ++i) y[1 - cas + 2 * i] = a[(sn + i) * stride];
  for (int p = cas; p < n; p += 2) y[p] = y[p] * K;
  for (int p = 1 - cas; p < n; p += 2) y[p] = y[p] * TWO_INV_K;
  const float cs[4] = {-DELTA, -GAMMA, -BETA, -ALPHA};
  for (int k = 0; k < 4; ++k) {
    int first = (k % 2 == 0) ? cas : 1 - cas;
    for (int p = first; p < n; p += 2) {
      int l = p >= 1 ? p - 1 : p + 1, r = p + 1 < n ? p + 1 : p - 1;
      float s = y[l] + y[r];
      float m = s * cs[k];
      y[p] = y[p] + m;
    }
  }
  for (int p = 0; p < n; ++p) a[p * stride] = y[p];
}

// ===================================================================== the plan

struct Reader {
  const int64_t* p;
  int64_t n, i = 0;
  int64_t next() {
    if (i >= n) fail("plan cut short");
    return p[i++];
  }
};

int csiz_of(int prec) {
  int c = (prec + 7) >> 3;
  return c == 3 ? 4 : c;
}

}  // namespace

extern "C" {

// Every tile of the plan decoded and unpacked into `image` (Pillow's buffer: uint16 [out_h][out_w] for the
// gray_i unpacker, else uint8 [out_h][out_w][4], zero-filled by the caller).  `blob` holds the tiles' data,
// PPT and PPM bytes.  The plan (int64): numcomps, x0, y0, x1, y1, tx0, ty0, tdx, tdy, tw, th, out_w, out_h,
// unpacker (0 gray_l, 1 gray_i, 2 gray_rgb, 3 graya_la, 4 srgb_rgb, 5 sycc_rgb, 6 srgba_rgba, 7
// sycca_rgba), ntiles, ppm offset, ppm length (-1: none); per component dx, dy, prec, sgnd; per tile:
// tile number, data offset, data length, ppt offset, ppt length (-1: none), csty, prg, numlayers, mct,
// number of POC entries, each (resno0, compno0, layno1, resno1, compno1, prg), then per component
// numres, cblkw, cblkh, cblksty, qmfbid, roishift, numgbits, prcw x numres, prch x numres, the number of
// step sizes and each (expn, mant).  `ycc` holds Pillow's YCbCr tables (R_CR, G_CB, G_CR, B_CB, 256 each) for
// the sycc unpackers.  Returns 0, or 1 with a message in err.
int uniir_jpeg2000_decode(const int64_t* plan, int64_t plan_len, const uint8_t* blob, size_t blob_len,
                          const int32_t* ycc, uint8_t* image, char* err, int errlen) {
  try {
    Reader rd{plan, plan_len};
    Image im;
    im.numcomps = (int)rd.next();
    im.x0 = rd.next(); im.y0 = rd.next(); im.x1 = rd.next(); im.y1 = rd.next();
    im.tx0 = rd.next(); im.ty0 = rd.next(); im.tdx = rd.next(); im.tdy = rd.next();
    im.tw = rd.next(); im.th = rd.next();
    const int64_t W = rd.next(), H = rd.next();
    const int unpacker = (int)rd.next();
    const int64_t ntiles = rd.next(), ppm_off = rd.next(), ppm_len = rd.next();
    if (im.numcomps < 1 || im.numcomps > 4) fail("%ld components", im.numcomps);
    for (int c = 0; c < im.numcomps; ++c) {
      Comp k;
      k.dx = (int)rd.next(); k.dy = (int)rd.next(); k.prec = (int)rd.next(); k.sgnd = (int)rd.next();
      im.comps.push_back(k);
    }
    auto span = [&](int64_t off, int64_t len) {
      if (off < 0 || len < 0 || (uint64_t)(off + len) > blob_len) fail("plan span outside the blob");
    };
    HeaderSource ppm;
    bool use_ppm = ppm_len >= 0;
    if (use_ppm) {
      span(ppm_off, ppm_len);
      ppm.data = blob + ppm_off;
      ppm.len = (size_t)ppm_len;
    }
    std::vector<uint8_t> buffer;  // Pillow's tile buffer, reused from tile to tile
    std::vector<int32_t> vals;
    std::vector<int32_t> line_i;
    std::vector<float> line_f;
    for (int64_t t = 0; t < ntiles; ++t) {
      int64_t tileno = rd.next(), doff = rd.next(), dlen = rd.next(), poff = rd.next(), plen = rd.next();
      span(doff, dlen);
      Tcp tcp;
      tcp.csty = (int)rd.next(); tcp.prg = (int)rd.next(); tcp.numlayers = (int)rd.next(); tcp.mct = (int)rd.next();
      int64_t npocs = rd.next();
      for (int64_t i = 0; i < npocs; ++i) {
        std::array<int64_t, 6> pc;
        for (auto& v : pc) v = rd.next();
        tcp.pocs.push_back(pc);
      }
      tcp.tccps.resize(im.numcomps);
      for (auto& tc : tcp.tccps) {
        tc.numres = (int)rd.next(); tc.cblkw = (int)rd.next(); tc.cblkh = (int)rd.next();
        tc.cblksty = (int)rd.next(); tc.qmfbid = (int)rd.next(); tc.roishift = (int)rd.next();
        tc.numgbits = (int)rd.next();
        if (tc.numres < 1 || tc.numres > 33) fail("%ld resolutions", tc.numres);
        for (int r = 0; r < tc.numres; ++r) tc.prcw[r] = (int)rd.next();
        for (int r = 0; r < tc.numres; ++r) tc.prch[r] = (int)rd.next();
        int64_t nsteps = rd.next();
        for (int64_t i = 0; i < nsteps; ++i) {
          int e = (int)rd.next(), m = (int)rd.next();
          tc.steps.push_back({e, m});
        }
      }
      Tile tile;
      build_tile(im, tcp, tileno, tile);
      HeaderSource ppt;
      HeaderSource* hs = nullptr;
      if (use_ppm) {
        hs = &ppm;
      } else if (plen >= 0) {
        span(poff, plen);
        ppt.data = blob + poff;
        ppt.len = (size_t)plen;
        hs = &ppt;
      }
      std::vector<int> decoded = read_packets(im, tcp, tile, blob + doff, (size_t)dlen, hs);
      // tier 1, dequantisation and the inverse DWT of each component
      std::vector<std::vector<int32_t>> out_i(im.numcomps);
      std::vector<std::vector<float>> out_f(im.numcomps);
      for (int c = 0; c < im.numcomps; ++c) {
        const Tccp& tccp = tcp.tccps[c];
        TileComp& tc = tile.comps[c];
        bool reversible = tccp.qmfbid == 1;
        if (decoded[c] != (int)tc.res.size() - 1) fail("a component's packets stop short of its highest resolution");
        int64_t w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
        if (reversible)
          out_i[c].assign((size_t)(w * h), 0);
        else
          out_f[c].assign((size_t)(w * h), 0.0f);
        for (size_t r = 0; r < tc.res.size(); ++r)
          for (Band& band : tc.res[r].bands) {
            if (band.empty()) continue;
            for (Precinct& prc : band.precincts)
              for (Codeblock& b : prc.cblks) {
                int64_t cw = b.x1 - b.x0, ch = b.y1 - b.y0;
                if (cw <= 0 || ch <= 0 || !b.any) continue;
                decode_block(b.data.data(), b.segs, b.numsegs, (int)cw, (int)ch, b.numbps, tccp.roishift, band.bandno,
                             tccp.cblksty, vals);
                int64_t x = b.x0 - band.x0, y = b.y0 - band.y0;
                if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
                if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
                float scale = 0.5f * band.stepsize;
                for (int64_t j = 0; j < ch; ++j)
                  for (int64_t i = 0; i < cw; ++i) {
                    int32_t v = vals[(size_t)(j * cw + i)];
                    size_t at = (size_t)((y + j) * w + x + i);
                    if (reversible)
                      out_i[c][at] = v / 2;
                    else
                      out_f[c][at] = (float)v * scale;
                  }
              }
          }
        int64_t rw = tc.res[0].x1 - tc.res[0].x0, rh = tc.res[0].y1 - tc.res[0].y0;
        for (size_t r = 1; r < tc.res.size(); ++r) {
          int64_t sw = rw, sh = rh;
          rw = tc.res[r].x1 - tc.res[r].x0;
          rh = tc.res[r].y1 - tc.res[r].y0;
          if (!rw || !rh) continue;
          int casx = (int)(tc.res[r].x0 & 1), casy = (int)(tc.res[r].y0 & 1);
          for (int64_t j = 0; j < rh; ++j) {
            if (reversible)
              idwt53_line(&out_i[c][(size_t)(j * w)], 1, (int)rw, (int)sw, casx, line_i);
            else
              idwt97_line(&out_f[c][(size_t)(j * w)], 1, (int)rw, (int)sw, casx, line_f);
          }
          for (int64_t i = 0; i < rw; ++i) {
            if (reversible)
              idwt53_line(&out_i[c][(size_t)i], (size_t)w, (int)rh, (int)sh, casy, line_i);
            else
              idwt97_line(&out_f[c][(size_t)i], (size_t)w, (int)rh, (int)sh, casy, line_f);
          }
        }
      }
      if (tcp.mct && im.numcomps >= 3) {
        for (int c = 1; c < 3; ++c) {
          if (tile.comps[c].res.size() != tile.comps[0].res.size()) fail("tiles don't all have the same dimension (MCT)");
          if (tile.comps[c].x1 - tile.comps[c].x0 != tile.comps[0].x1 - tile.comps[0].x0 ||
              tile.comps[c].y1 - tile.comps[c].y0 != tile.comps[0].y1 - tile.comps[0].y0)
            fail("tiles don't all have the same dimension (MCT)");
          if (tcp.tccps[c].qmfbid != tcp.tccps[0].qmfbid) fail("a component transform over mixed wavelets");
        }
        if (tcp.tccps[0].qmfbid == 1) {
          for (size_t i = 0; i < out_i[0].size(); ++i) {
            uint32_t y = (uint32_t)out_i[0][i], u = (uint32_t)out_i[1][i], v = (uint32_t)out_i[2][i];
            uint32_t g = y - (uint32_t)((int32_t)(u + v) >> 2);
            out_i[0][i] = (int32_t)(v + g);
            out_i[1][i] = (int32_t)g;
            out_i[2][i] = (int32_t)(u + g);
          }
        } else {
          for (size_t i = 0; i < out_f[0].size(); ++i) {
            float y = out_f[0][i], u = out_f[1][i], v = out_f[2][i];
            float vr = v * 1.402f, ug = u * 0.34413f, vg = v * 0.71414f, ub = u * 1.772f;
            float r = y + vr;
            float g1 = y - ug;
            float g = g1 - vg;
            float b = y + ub;
            out_f[0][i] = r;
            out_f[1][i] = g;
            out_f[2][i] = b;
          }
        }
      }
      // level shift and clamp, then the bytes opj_decode_tile_data writes
      std::vector<uint8_t> raw;
      for (int c = 0; c < im.numcomps; ++c) {
        const Comp& k = im.comps[c];
        int64_t lo = k.sgnd ? -((int64_t)1 << (k.prec - 1)) : 0;
        int64_t hi = k.sgnd ? ((int64_t)1 << (k.prec - 1)) - 1 : ((int64_t)1 << k.prec) - 1;
        int64_t shift = k.sgnd ? 0 : (int64_t)1 << (k.prec - 1);
        int cz = csiz_of(k.prec);
        bool reversible = tcp.tccps[c].qmfbid == 1;
        size_t n = reversible ? out_i[c].size() : out_f[c].size();
        for (size_t i = 0; i < n; ++i) {
          int64_t v;
          if (reversible) {
            v = (int32_t)((uint32_t)out_i[c][i] + (uint32_t)shift);
            v = std::min(std::max(v, lo), hi);
          } else {
            float f = out_f[c][i];
            if (f > 2147483648.0f)
              v = hi;
            else if (f < -2147483648.0f || std::isnan(f))
              v = lo;
            else
              v = std::min(std::max((int64_t)std::nearbyint(f) + shift, lo), hi);
          }
          uint32_t u = (uint32_t)v;
          for (int b = 0; b < cz; ++b) raw.push_back((uint8_t)(u >> (8 * b)));
        }
      }
      // Pillow's unpacker
      int64_t tx0, ty0, tx1, ty1;
      tile_bounds(im, tileno, tx0, ty0, tx1, ty1);
      int64_t w = tx1 - tx0, h = ty1 - ty0, x0 = tx0 - im.x0, y0 = ty0 - im.y0;
      if (x0 < 0 || y0 < 0 || x0 + w > W || y0 + h > H) fail("tile %ld outside the image", (long)tileno);
      int total_width = 0;
      for (auto& k : im.comps) total_width += csiz_of(k.prec);
      size_t need = std::max(raw.size(), (size_t)(w * h * total_width));
      if (buffer.size() < need) buffer.assign(need, 0);
      std::copy(raw.begin(), raw.end(), buffer.begin());
      auto word = [&](size_t offset, int cz, int64_t index) -> uint32_t {
        size_t at = offset + (size_t)cz * (size_t)index;
        uint32_t v = 0;
        for (int b = 0; b < cz; ++b) v |= (uint32_t)buffer[at + b] << (8 * b);
        return v;
      };
      auto shifted = [&](uint32_t wd, const Comp& k, int bits) -> uint32_t {
        int sh = bits - k.prec;
        uint32_t off = k.sgnd ? 1u << (k.prec - 1) : 0;
        if (sh < 0) off += 1u << (-sh - 1);
        uint32_t x = wd + off;
        x = sh < 0 ? x >> -sh : x << sh;
        return x & ((1u << bits) - 1);
      };
      if (unpacker <= 3) {
        const Comp& k0 = im.comps[0];
        int c0 = csiz_of(k0.prec);
        for (int64_t j = 0; j < h; ++j)
          for (int64_t i = 0; i < w; ++i) {
            uint32_t v = shifted(word(0, c0, j * w + i), k0, unpacker == 1 ? 16 : 8);
            size_t at = (size_t)((y0 + j) * W + x0 + i);
            if (unpacker == 1) {
              reinterpret_cast<uint16_t*>(image)[at] = (uint16_t)v;
            } else if (unpacker == 0) {
              image[at * 4] = (uint8_t)v;
            } else {
              image[at * 4] = image[at * 4 + 1] = image[at * 4 + 2] = (uint8_t)v;
              if (unpacker == 2) {
                image[at * 4 + 3] = 255;
              } else {
                const Comp& k1 = im.comps[1];
                image[at * 4 + 3] = (uint8_t)shifted(word((size_t)(c0 * w * h), csiz_of(k1.prec), j * w + i), k1, 8);
              }
            }
          }
      } else {
        int n = unpacker >= 6 ? 4 : 3;
        size_t offset = 0;
        for (int c = 0; c < n; ++c) {
          const Comp& k = im.comps[c];
          int cz = csiz_of(k.prec);
          int64_t cw = w / k.dx;
          for (int64_t j = 0; j < h; ++j)
            for (int64_t i = 0; i < w; ++i)
              image[(size_t)((y0 + j) * W + x0 + i) * 4 + c] = (uint8_t)shifted(word(offset, cz, (j / k.dy) * cw + i / k.dx), k, 8);
          offset += (size_t)cz * (size_t)cw * (size_t)(h / k.dy);
        }
        for (int64_t j = 0; j < h; ++j)
          for (int64_t i = 0; i < w; ++i) {
            uint8_t* px = image + (size_t)((y0 + j) * W + x0 + i) * 4;
            if (n == 3) px[3] = 255;
            if (unpacker == 5 || unpacker == 7) {  // ImagingConvertYCbCr2RGB
              int32_t y = px[0], cb = px[1], cr = px[2];
              int32_t rgb[3] = {y + (ycc[cr] >> 6), y + ((ycc[256 + cb] + ycc[512 + cr]) >> 6), y + (ycc[768 + cb] >> 6)};
              for (int k = 0; k < 3; ++k) px[k] = (uint8_t)std::min(255, std::max(0, rgb[k]));
            }
          }
      }
    }
    if (rd.i != rd.n) fail("plan longer than its tiles");
    return 0;
  } catch (const Error& e) {
    snprintf(err, errlen, "%s", e.msg.c_str());
  } catch (const std::bad_alloc&) {
    snprintf(err, errlen, "out of memory");
  }
  return 1;
}

}  // extern "C"
