// PNG scanlines to RGB: host code, no kernel.
//
// The native half of uniir_tpu_torch/data/png.py::decode_twin, which is the
// reference: Python parses the chunks and inflates the image data with zlib;
// this file undoes the five scanline filters (None, Sub, Up, Average, Paeth)
// pass by pass (Adam7 or one pass), unpacks 1 / 2 / 4 / 8 / 16-bit samples
// and writes what Pillow's `Image.open(path).convert("RGB")` gives: grey x
// 255 / 85 / 17 below 8 bits, 16-bit grey clipped at 255 (Pillow's I;16),
// the high byte of the other 16-bit samples, palette entries (the caller
// passes 768 bytes, zeros past PLTE), alpha dropped.  A bad filter type or
// too few bytes returns an error with a message, never reads or writes out
// of bounds.
//
// Why host code and not a kernel: the Average and Paeth filters are serial
// along a row and each row needs the one above, and the images are resized
// on the host after decoding.  No global state, so the loader's threads
// (ctypes releases the GIL) decode in parallel.
//
// Built by uniir_tpu_torch/_build.py with nvcc like the kernels' sources.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

namespace {

const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                          {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

int channels_of(int depth, int ctype) {
  switch (ctype) {
    case 0: return (depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16) ? 1 : 0;
    case 2: return (depth == 8 || depth == 16) ? 3 : 0;
    case 3: return (depth == 1 || depth == 2 || depth == 4 || depth == 8) ? 1 : 0;
    case 4: return (depth == 8 || depth == 16) ? 2 : 0;
    case 6: return (depth == 8 || depth == 16) ? 4 : 0;
    default: return 0;
  }
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  return (uint8_t)(pa <= pb && pa <= pc ? a : (pb <= pc ? b : c));
}

// Undoes one scanline's filter in place; prior is the unfiltered row above (zeros for the first).
bool unfilter(int type, uint8_t* line, const uint8_t* prior, size_t n, int bpp) {
  switch (type) {
    case 0: return true;
    case 1:
      for (size_t i = bpp; i < n; i++) line[i] = (uint8_t)(line[i] + line[i - bpp]);
      return true;
    case 2:
      for (size_t i = 0; i < n; i++) line[i] = (uint8_t)(line[i] + prior[i]);
      return true;
    case 3:
      for (size_t i = 0; i < n; i++) line[i] = (uint8_t)(line[i] + (((i >= (size_t)bpp ? line[i - bpp] : 0) + prior[i]) >> 1));
      return true;
    case 4:
      for (size_t i = 0; i < n; i++) {
        int a = i >= (size_t)bpp ? line[i - bpp] : 0, c = i >= (size_t)bpp ? prior[i - bpp] : 0;
        line[i] = (uint8_t)(line[i] + paeth(a, prior[i], c));
      }
      return true;
    default: return false;
  }
}

// Sample k (0-based) of pixel x of an unfiltered scanline.
inline int sample(const uint8_t* line, int x, int k, int depth, int channels) {
  if (depth == 16) {
    const uint8_t* p = line + 2 * ((size_t)x * channels + k);
    return (p[0] << 8) | p[1];
  }
  if (depth == 8) return line[(size_t)x * channels + k];
  size_t bit = (size_t)x * depth;  // one channel below 8 bits
  return (line[bit / 8] >> (8 - depth - (int)(bit % 8))) & ((1 << depth) - 1);
}

void set_error(char* err, int errlen, const char* fmt, int a = 0) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, fmt, a);
}

}  // namespace

extern "C" {

// raw[0, n): the inflated image data (a filter byte before each scanline of each pass); out: uint8
// [h][w][3]; palette: 768 bytes.  0 on success, 1 with a message in err.
int uniir_png_decode(const uint8_t* raw, size_t n, int w, int h, int depth, int ctype, int interlace,
                     const uint8_t* palette, uint8_t* out, char* err, int errlen) {
  int channels = channels_of(depth, ctype);
  if (!channels || w <= 0 || h <= 0) {
    set_error(err, errlen, "chunk IHDR: bit depth %d is not a PNG form for its colour type", depth);
    return 1;
  }
  int bits = depth * channels, bpp = bits >= 8 ? bits / 8 : 1;
  int scale = depth < 8 ? 255 / ((1 << depth) - 1) : 1;
  size_t at = 0;
  std::vector<uint8_t> prior, line;
  for (int p = 0; p < (interlace ? 7 : 1); p++) {
    int x0 = interlace ? kAdam7[p][0] : 0, y0 = interlace ? kAdam7[p][1] : 0;
    int dx = interlace ? kAdam7[p][2] : 1, dy = interlace ? kAdam7[p][3] : 1;
    int pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;
    size_t stride = ((size_t)pw * bits + 7) / 8;
    prior.assign(stride, 0);
    line.resize(stride);
    for (int r = 0; r < ph; r++) {
      if (at + 1 + stride > n) {
        set_error(err, errlen, "chunk IDAT: truncated PNG stream (pass %d)", p + 1);
        return 1;
      }
      int type = raw[at];
      for (size_t i = 0; i < stride; i++) line[i] = raw[at + 1 + i];
      at += 1 + stride;
      if (!unfilter(type, line.data(), prior.data(), stride, bpp)) {
        set_error(err, errlen, "chunk IDAT: unknown filter type %d", type);
        return 1;
      }
      uint8_t* row = out + (size_t)(y0 + r * dy) * w * 3;
      for (int c = 0; c < pw; c++) {
        uint8_t* px = row + (size_t)(x0 + c * dx) * 3;
        int v = sample(line.data(), c, 0, depth, channels);
        if (ctype == 3) {
          px[0] = palette[3 * v];
          px[1] = palette[3 * v + 1];
          px[2] = palette[3 * v + 2];
        } else if (ctype == 0 || ctype == 4) {  // grey: I;16 clips, the others keep the high byte
          uint8_t g = (uint8_t)(depth == 16 ? (ctype == 0 ? (v > 255 ? 255 : v) : v >> 8) : v * scale);
          px[0] = px[1] = px[2] = g;
        } else {
          for (int k = 0; k < 3; k++) {
            int s = k ? sample(line.data(), c, k, depth, channels) : v;
            px[k] = (uint8_t)(depth == 16 ? s >> 8 : s);
          }
        }
      }
      prior.swap(line);
    }
  }
  return 0;
}

}  // extern "C"
