// GIF first frame to RGB: host code, no kernel.
//
// The native half of uniir_tpu_torch/data/gif.py::decode_twin, which is the
// reference: Python parses the header, colour tables and extensions; this
// file runs the LZW code loop as Pillow's GifDecode.c does (the minimum code
// size as written, 0 to 12; the width grown after entry 2^width - 1 is
// added, up to 12 bits; no entry past 4096, the codes going on from the full
// table; a first code after a clear above the clear code, or a code past the
// next free entry, refused as broken; literals kept modulo 256; the data
// read as length-prefixed blocks past any terminator; an end-of-information
// code before the frame is full raising unless Pillow's 64 KiB reader had
// more of the file left), fills the frame's rows in interlace order, puts
// the frame on the canvas filled with `fill`, and looks each index up in the
// 768-byte palette (or, without one, writes it as grey).  A broken or
// truncated stream returns an error with a message, never reads or writes
// out of bounds.
//
// Why host code and not a kernel: the LZW codes are serial (each entry
// depends on the code before), and the images are resized on the host after
// decoding.  No global state, so the loader's threads (ctypes releases the
// GIL) decode in parallel.
//
// Built by uniir_tpu_torch/_build.py with nvcc like the kernels' sources.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

const int kTable = 4096;  // GIFTABLE
const int kMaxBits = 12;  // GIFBITS
const size_t kChunk = 65536;  // ImageFile.load's read size

void set_error(char* err, int errlen, const char* fmt, long a = 0, long b = 0) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, fmt, a, b);
}

}  // namespace

extern "C" {

// data[0, n): the whole file; the LZW blocks start at `offset` (after the minimum code size byte `bits`).
// out: uint8 [h][w][3]; palette: 768 bytes, or null for a grey image.  0 on success, 1 with a message in err.
int uniir_gif_decode(const uint8_t* data, size_t n, size_t offset, int bits, int w, int h, int x0, int y0, int fw,
                     int fh, int interlace, int fill, const uint8_t* palette, uint8_t* out, char* err, int errlen) {
  if (bits < 0 || bits > kMaxBits || w <= 0 || h <= 0 || fw <= 0 || fh <= 0 || x0 + fw > w || y0 + fh > h) {
    set_error(err, errlen, "LZW minimum code size %ld or frame geometry out of range", bits);
    return 1;
  }
  const size_t need = (size_t)fw * fh;
  std::vector<uint8_t> stream(need);
  std::vector<uint16_t> link(kTable);
  std::vector<uint8_t> suffix(kTable), stack(kTable + 1);
  const int clear = 1 << bits, end = clear + 1;
  size_t pos = offset, got = 0, block_left = 0, block_end = offset;
  uint64_t acc = 0;
  int nbits = 0, state = 1, width = 0, mask = 0, next = 0, last = 0;
  uint8_t last_first = 0;  // the first index of the last code's string
  while (got < need) {
    if (state == 1) {
      next = clear + 2;
      width = bits + 1;
      mask = (1 << width) - 1;
      state = 2;
    }
    while (nbits < width) {
      if (block_left) {
        acc |= (uint64_t)data[pos++] << nbits;
        nbits += 8;
        block_left--;
      } else {
        if (pos >= n || pos + 1 + data[pos] > n) {
          set_error(err, errlen, "truncated GIF image data (image file is truncated)");
          return 1;
        }
        block_left = data[pos++];
        block_end = pos + block_left;
      }
    }
    int c = (int)(acc & (uint64_t)mask);
    acc >>= width;
    nbits -= width;
    if (c == clear) {
      if (state != 2) state = 1;
      continue;
    }
    if (c == end) {
      size_t chunks = (block_end - offset + kChunk - 1) / kChunk;
      if (offset + chunks * kChunk >= n) {
        set_error(err, errlen, "truncated GIF image data (end of information after %ld of %ld pixels)", (long)got,
                  (long)need);
        return 1;
      }
      continue;
    }
    // the code's string onto the stack, last index first
    int depth = 0;
    if (state == 2) {
      if (c > clear) {
        set_error(err, errlen, "broken GIF data stream (first code %ld after a clear code)", c);
        return 1;
      }
      stack[depth++] = (uint8_t)c;
      state = 3;
    } else {
      if (c > next) {
        set_error(err, errlen, "broken GIF data stream (code %ld past the next entry %ld)", c, next);
        return 1;
      }
      int k = c;
      if (c == next) {  // KwKwK: the last string and its own first index
        stack[depth++] = last_first;
        k = last;
      }
      while (k >= clear) {  // k < next <= 4096: an entry added since the clear
        stack[depth++] = suffix[k];
        k = link[k];
      }
      stack[depth++] = (uint8_t)k;
      if (next < kTable) {
        link[next] = (uint16_t)last;
        suffix[next] = (uint8_t)k;
        if (next == mask && width < kMaxBits) {
          width++;
          mask = (1 << width) - 1;
        }
        next++;
      }
    }
    last = c;
    last_first = stack[depth - 1];
    while (depth && got < need) stream[got++] = stack[--depth];
  }
  // rows in stream order onto the canvas, then the palette (or grey)
  std::vector<uint8_t> canvas((size_t)w * h, (uint8_t)fill);
  static const int kPass[4][2] = {{0, 8}, {4, 8}, {2, 4}, {1, 2}};
  size_t row = 0;
  for (int p = 0; p < (interlace ? 4 : 1); p++) {
    int first = interlace ? kPass[p][0] : 0, step = interlace ? kPass[p][1] : 1;
    for (int y = first; y < fh; y += step, row++)
      memcpy(&canvas[(size_t)(y0 + y) * w + x0], &stream[row * fw], (size_t)fw);
  }
  for (size_t i = 0; i < (size_t)w * h; i++) {
    const uint8_t v = canvas[i];
    if (palette) {
      out[3 * i] = palette[3 * v];
      out[3 * i + 1] = palette[3 * v + 1];
      out[3 * i + 2] = palette[3 * v + 2];
    } else {
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = v;
    }
  }
  return 0;
}

}  // extern "C"
