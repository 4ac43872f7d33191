// The byte-serial stages of the small raster formats: host code, no kernel.
//
// The native half of uniir_tpu_torch/data/raster.py, whose Python twins are
// the reference: each entry takes the file's bytes and the geometry the
// Python side read from the header, and writes the image's rows in the
// order the file gives them, or returns 1 with the twin's message.
//
//   uniir_raster_qoi      Pillow's QoiDecoder: the op stream, the 64-entry
//                         index hashed with alpha, a run past the image
//                         dropped, a stream cut short refused.
//   uniir_raster_tga_rle  TgaRleDecode.c: a run may not pass its row's end,
//                         a literal goes on into the next rows.
//   uniir_raster_sgi_rle  SgiRleDecode.c: the start / length tables, one
//                         row buffer kept between rows, a last nonzero
//                         chunk stopping the image without an error.
//   uniir_raster_pcx_rle  PcxDecode.c: a run past the line refused, the
//                         planes moved together as the decoder moves them.
//   uniir_raster_sun_rle  SunRleDecode.c: the 0x80 escape, runs into the
//                         next rows.
//   uniir_raster_msp_rle  Pillow's MspDecoder: the row-length map, rows of
//                         any decoded length joined.
//   uniir_raster_packbits PackBitsDecode.c over a PSD file's channels in the
//                         order of their offsets: a packet past its row's
//                         end cut there, data cut short refused.
//   uniir_raster_icns_rle IcnsImagePlugin's read_32: three channels in turn,
//                         runs of b - 125 copies, literals of b + 1 bytes.
//   uniir_raster_fli      FliDecode.c over an FLI / FLC file's first frame as
//                         ImageFile.load feeds it: a frame's size of bytes a
//                         read, appended to what the decoder left; BRUN,
//                         COPY, BLACK, LC and SS2 chunks into a zeroed image,
//                         palettes and the postage stamp skipped.
//
// Why host code and not a kernel: each step depends on the bytes before it,
// and the images are resized on the host after decoding.  No global state,
// so the loader's threads (ctypes releases the GIL) decode in parallel.
// Every read is bounded by the input's length and every write by the
// output's; `out` is zero-filled by the caller.
//
// Built by uniir_tpu_torch/_build.py with nvcc like the kernels' sources.

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

int fail(char* err, int errlen, const char* fmt, long a = 0, long b = 0) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, fmt, a, b);
  return 1;
}

// Appends to a bounded output: bytes past `need` are counted and dropped,
// as the twins' slices drop them.
struct Sink {
  uint8_t* out;
  size_t need;
  size_t n = 0;
  void put(uint8_t v) {
    if (n < need) out[n] = v;
    ++n;
  }
  void put(const uint8_t* v, size_t k) {
    if (n < need) memcpy(out + n, v, k < need - n ? k : need - n);
    n += k;
  }
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

// expandrow / expandrow2 of SgiRleDecode.c on offsets into the data after the
// header: 0 done, 1 a last nonzero chunk (the image stops), -1 an overrun.
int sgi_row(uint8_t* buf, size_t at, const uint8_t* data, size_t src, long n, int z, int xsize, int bpc,
            size_t end) {
  int x = 0;
  while (n > 0) {
    if (src + (size_t)bpc - 1 > end) return -1;
    uint8_t pixel = data[src + bpc - 1];
    src += bpc;
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7F;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + (size_t)bpc * count > end) return -1;
      for (int i = 0; i < count; ++i) {
        memcpy(buf + at, data + src, bpc);
        src += bpc;
        at += (size_t)z * bpc;
      }
    } else {
      if (src + (bpc == 1 ? 0 : 2) > end) return -1;
      for (int i = 0; i < count; ++i) {
        memcpy(buf + at, data + src, bpc);
        at += (size_t)z * bpc;
      }
      src += bpc;
    }
    --n;
  }
  return 0;
}

}  // namespace

extern "C" int uniir_raster_qoi(const uint8_t* s, size_t n, size_t pos, int width, int height, int bands,
                                uint8_t* out, size_t need, char* err, int errlen) {
  (void)width;
  (void)height;
  uint8_t seen[64][4];
  memset(seen, 0, sizeof(seen));
  uint8_t prev[4] = {0, 0, 0, 255};
  Sink o{out, need};
  while (o.n < need) {
    if (pos >= n) return fail(err, errlen, "QOI data cut short");
    uint8_t b = s[pos++];
    uint8_t v[4];
    if (b == 0xFE || b == 0xFF) {
      size_t k = b == 0xFE ? 3 : 4;
      if (pos + k > n) return fail(err, errlen, "QOI data cut short");
      memcpy(v, s + pos, k);
      if (k == 3) v[3] = prev[3];
      pos += k;
    } else if (b >> 6 == 0) {
      memcpy(v, seen[b & 63], 4);
    } else if (b >> 6 == 1) {
      v[0] = (uint8_t)(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = (uint8_t)(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = (uint8_t)(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if (b >> 6 == 2) {
      if (pos >= n) return fail(err, errlen, "QOI data cut short");
      uint8_t second = s[pos++];
      int dg = (b & 63) - 32;
      v[0] = (uint8_t)(prev[0] + dg + (second >> 4) - 8);
      v[1] = (uint8_t)(prev[1] + dg);
      v[2] = (uint8_t)(prev[2] + dg + (second & 15) - 8);
      v[3] = prev[3];
    } else {
      for (int r = (b & 63) + 1; r > 0 && o.n < need; --r) o.put(prev, bands);
      continue;
    }
    memcpy(prev, v, 4);
    memcpy(seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v, 4);
    o.put(v, bands);
  }
  return 0;
}

extern "C" int uniir_raster_tga_rle(const uint8_t* s, size_t n, size_t pos, int row_bytes, int rows, int depth,
                                    uint8_t* out, size_t need, char* err, int errlen) {
  (void)rows;
  Sink o{out, need};
  while (o.n < need) {
    if (pos >= n) return fail(err, errlen, "TGA RLE data cut short");
    uint8_t h = s[pos];
    size_t count = (size_t)depth * ((h & 0x7F) + 1);
    if (h & 0x80) {
      if (n - pos < 1 + (size_t)depth) return fail(err, errlen, "TGA RLE data cut short");
      if (o.n % row_bytes + count > (size_t)row_bytes)
        return fail(err, errlen, "TGA RLE run past the row's end (buffer overrun)");
      for (size_t i = 0; depth && i < count / depth; ++i) o.put(s + pos + 1, depth);
      pos += 1 + depth;
    } else {
      if (n - pos < 1 + count) return fail(err, errlen, "TGA RLE data cut short");
      o.put(s + pos + 1, count);
      pos += 1 + count;
    }
  }
  return 0;
}

extern "C" int uniir_raster_sgi_rle(const uint8_t* s, size_t n, int xsize, int ysize, int bands, int bpc,
                                    uint8_t* out, size_t need, char* err, int errlen) {
  (void)need;
  const uint8_t* body = s + (n < 512 ? n : 512);
  size_t size = n < 512 ? 0 : n - 512;
  size_t tablen = (size_t)bands * ysize;
  if (size < 8 * tablen) return fail(err, errlen, "SGI RLE tables past the end of the file (buffer overrun)");
  size_t row = (size_t)xsize * bands * bpc;
  std::vector<uint8_t> buf(2 * (size_t)xsize * bands, 0);
  for (int r = 0; r < ysize; ++r) {
    for (int ch = 0; ch < bands; ++ch) {
      size_t k = (size_t)r + (size_t)ch * ysize;
      uint32_t start = be32(body + 4 * k), length = be32(body + 4 * (tablen + k));
      if (start < 512) return fail(err, errlen, "SGI RLE row inside the header (buffer overrun)");
      int status = sgi_row(buf.data(), (size_t)ch * bpc, body, start - 512, (long)(int32_t)length, bands, xsize, bpc,
                           size - 1);
      if (status == -1) return fail(err, errlen, "SGI RLE run past the row or the data (buffer overrun)");
      if (status == 1) return 0;
    }
    memcpy(out + (size_t)r * row, buf.data(), row);
  }
  return 0;
}

extern "C" int uniir_raster_pcx_rle(const uint8_t* s, size_t n, size_t pos, int xsize, int bits, int row_bytes,
                                    int rows, uint8_t* out, size_t need, char* err, int errlen) {
  (void)need;
  int plane, bands, stride;
  if (bits == 2 || bits == 4) {
    plane = (xsize + 7) / 8;
    bands = bits;
    stride = row_bytes / bits;
  } else {
    plane = xsize;
    bands = row_bytes / xsize;
    stride = bands ? row_bytes / bands : 0;
  }
  std::vector<uint8_t> line((size_t)row_bytes);
  int x = 0;
  for (int y = 0; y < rows;) {
    if (pos >= n) return fail(err, errlen, "PCX RLE data cut short");
    uint8_t b = s[pos];
    if ((b & 0xC0) == 0xC0) {
      if (pos + 1 >= n) return fail(err, errlen, "PCX RLE data cut short");
      int count = b & 0x3F;
      if (x + count > row_bytes) return fail(err, errlen, "PCX RLE run past the line's end (buffer overrun)");
      memset(line.data() + x, s[pos + 1], count);
      x += count;
      pos += 2;
    } else {
      line[x++] = b;
      pos += 1;
    }
    if (x >= row_bytes) {
      if (stride > plane)
        for (int i = 1; i < bands; ++i)
          memmove(line.data() + (size_t)i * plane, line.data() + (size_t)i * stride, plane);
      memcpy(out + (size_t)y * row_bytes, line.data(), row_bytes);
      x = 0;
      ++y;
    }
  }
  return 0;
}

extern "C" int uniir_raster_sun_rle(const uint8_t* s, size_t n, size_t pos, int row_bytes, int rows, uint8_t* out,
                                    size_t need, char* err, int errlen) {
  (void)row_bytes;
  (void)rows;
  Sink o{out, need};
  while (o.n < need) {
    if (pos >= n) return fail(err, errlen, "Sun raster RLE data cut short");
    if (s[pos] == 0x80) {
      if (pos + 1 >= n) return fail(err, errlen, "Sun raster RLE data cut short");
      if (s[pos + 1] == 0) {
        o.put(0x80);
        pos += 2;
      } else {
        if (pos + 2 >= n) return fail(err, errlen, "Sun raster RLE data cut short");
        for (int i = 0; i <= s[pos + 1] && o.n < need; ++i) o.put(s[pos + 2]);
        pos += 3;
      }
    } else {
      o.put(s[pos++]);
    }
  }
  return 0;
}

extern "C" int uniir_raster_msp_rle(const uint8_t* s, size_t n, int width, int height, uint8_t* out, size_t need,
                                    char* err, int errlen) {
  size_t stride = ((size_t)width + 7) / 8;
  if (n < 32 + 2 * (size_t)height) return fail(err, errlen, "truncated MSP file in row map");
  size_t pos = 32 + 2 * (size_t)height;
  Sink o{out, need};
  for (int r = 0; r < height; ++r) {
    size_t length = s[32 + 2 * r] | (size_t)s[33 + 2 * r] << 8;
    if (length == 0) {
      for (size_t i = 0; i < stride; ++i) o.put(0xFF);
      continue;
    }
    if (pos + length > n)
      return fail(err, errlen, "truncated MSP file, expected %ld bytes on row %ld", (long)length, (long)r);
    const uint8_t* row = s + pos;
    pos += length;
    size_t i = 0;
    while (i < length) {
      uint8_t kind = row[i++];
      if (kind == 0) {
        if (i + 2 > length) return fail(err, errlen, "corrupted MSP file in row %ld", (long)r);
        for (int k = 0; k < row[i]; ++k) o.put(row[i + 1]);
        i += 2;
      } else {
        o.put(row + i, kind < length - i ? kind : length - i);
        i += kind;
      }
    }
  }
  if (o.n < need) return fail(err, errlen, "not enough image data (%ld of %ld bytes)", (long)o.n, (long)need);
  return 0;
}

extern "C" int uniir_raster_packbits(const uint8_t* s, size_t n, const uint64_t* offsets, int channels, int row_bytes,
                                     int rows, uint8_t* out, size_t need, char* err, int errlen) {
  (void)need;
  std::vector<int> order((size_t)channels);
  for (int c = 0; c < channels; ++c) order[c] = c;
  for (int i = 1; i < channels; ++i)  // ImageFile.load's stable sort of the tiles by offset
    for (int j = i; j > 0 && offsets[order[j - 1]] > offsets[order[j]]; --j) std::swap(order[j - 1], order[j]);
  for (int c : order) {
    size_t pos = offsets[c];
    uint8_t* row = out + (size_t)c * rows * row_bytes;
    int y = 0, x = 0;
    while (y < rows) {
      if (pos >= n) return fail(err, errlen, "PackBits data cut short (image file is truncated)");
      uint8_t b = s[pos];
      if (b == 0x80) {
        ++pos;
        continue;
      }
      bool run = b & 0x80;
      int k = run ? 257 - b : b + 1;
      if (n - pos < (size_t)(run ? 2 : 1 + k)) return fail(err, errlen, "PackBits data cut short (image file is truncated)");
      int take = k < row_bytes - x ? k : row_bytes - x;  // a packet past the row's end is cut there
      if (run)
        memset(row + x, s[pos + 1], take);
      else
        memcpy(row + x, s + pos + 1, take);
      x += take;
      pos += run ? 2 : 1 + k;
      if (x == row_bytes) {
        x = 0;
        ++y;
        row += row_bytes;
      }
    }
  }
  return 0;
}

extern "C" int uniir_raster_icns_rle(const uint8_t* s, size_t n, size_t pos, int pixels, uint8_t* out, size_t need,
                                     char* err, int errlen) {
  (void)need;
  Sink o{out, 3 * (size_t)pixels};
  for (int band = 0; band < 3; ++band) {
    long left = pixels, got = 0;
    while (left > 0 && pos < n) {
      uint8_t b = s[pos++];
      long k;
      if (b & 0x80) {
        k = b - 125;
        if (pos < n) {
          for (long i = 0; i < k; ++i) o.put(s[pos]);
          got += k;
          ++pos;
        }
      } else {
        k = b + 1;
        size_t avail = n - pos < (size_t)k ? n - pos : (size_t)k;
        o.put(s + pos, avail);
        got += (long)avail;
        pos += avail;
      }
      left -= k;
    }
    if (left != 0) return fail(err, errlen, "ICNS RLE channel %ld: %ld bytes left (error reading channel)", band, left);
    if (got < pixels)
      return fail(err, errlen, "ICNS RLE channel %ld: %ld bytes short (not enough image data)", band, pixels - got);
  }
  return 0;
}

namespace {

uint16_t le16(const uint8_t* p) { return (uint16_t)(p[0] | p[1] << 8); }

uint32_t le32(const uint8_t* p) { return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24; }

// One call of ImagingFliDecode on buf[0, end): the bytes consumed (>= 0) or -1 at the frame's end; -2 with
// `err` set where it sets an error code.  Every read is bounded by the buffer's end, not by the chunk's size.
long fli_chunks(const uint8_t* buf, size_t end, uint8_t* img, int width, int height, char* err, int errlen) {
  if (end < 4) return 0;
  uint32_t framesize = le32(buf);
  if (end + end % 2 < framesize) return 0;  // one pad byte may be missing
  if (end < 8) return fail(err, errlen, "FLI frame header cut short (buffer overrun)"), -2;
  if (le16(buf + 4) != 0xF1FA) return fail(err, errlen, "FLI frame of another chunk type (unknown)"), -2;
  int chunks = le16(buf + 6);
  size_t ptr = 16;
  const size_t w = (size_t)width;
#define FLI_OOB(at)                                                              \
  if ((at) > end) {                                                              \
    fail(err, errlen, "FLI chunk data past the frame's bytes (buffer overrun)"); \
    return -2;                                                                   \
  }
  for (int c = 0; c < chunks; ++c) {
    if (ptr > end || end - ptr < 10) return fail(err, errlen, "FLI chunk header past the frame's bytes (buffer overrun)"), -2;
    size_t data = ptr + 6;
    int kind = le16(buf + ptr + 4);
    if (kind == 7) {  // SS2: word-oriented delta
      int lines = le16(buf + data);
      data += 2;
      long y = 0;
      int line = 0;
      for (; line < lines && y < height; ++line, ++y) {
        uint8_t* row = img + (size_t)y * w;
        FLI_OOB(data + 2)
        int packets = le16(buf + data);
        data += 2;
        while (packets & 0x8000) {
          if (packets & 0x4000) {  // skip lines
            y += 65536 - packets;
            if (y >= height) return fail(err, errlen, "FLI SS2 skips past the image (buffer overrun)"), -2;
            row = img + (size_t)y * w;
          } else {  // the last pixel of an odd-width line
            row[w - 1] = (uint8_t)packets;
          }
          FLI_OOB(data + 2)
          packets = le16(buf + data);
          data += 2;
        }
        int p = 0;
        size_t x = 0;
        for (; p < packets; ++p) {
          FLI_OOB(data + 2)
          x += buf[data];
          if (buf[data + 1] >= 128) {
            FLI_OOB(data + 4)
            size_t i = 256 - buf[data + 1];
            if (x + 2 * i > w) break;
            for (size_t j = 0; j < i; ++j) {
              row[x++] = buf[data + 2];
              row[x++] = buf[data + 3];
            }
            data += 4;
          } else {
            size_t i = 2 * (size_t)buf[data + 1];
            if (x + i > w) break;
            FLI_OOB(data + 2 + i)
            memcpy(row + x, buf + data + 2, i);
            data += 2 + i;
            x += i;
          }
        }
        if (p < packets) break;
      }
      if (line < lines) return fail(err, errlen, "FLI SS2 lines past the image or its packets (buffer overrun)"), -2;
    } else if (kind == 12) {  // LC: byte-oriented delta
      long y = le16(buf + data);
      long ymax = y + le16(buf + data + 2);
      data += 4;
      for (; y < ymax && y < height; ++y) {
        uint8_t* row = img + (size_t)y * w;
        FLI_OOB(data + 1)
        int packets = buf[data++];
        int p = 0;
        size_t x = 0, i = 0;
        for (; p < packets; ++p, x += i) {
          FLI_OOB(data + 2)
          x += buf[data];
          if (buf[data + 1] & 0x80) {
            i = 256 - buf[data + 1];
            if (x + i > w) break;
            FLI_OOB(data + 3)
            memset(row + x, buf[data + 2], i);
            data += 3;
          } else {
            i = buf[data + 1];
            if (x + i > w) break;
            FLI_OOB(data + 2 + i)
            memcpy(row + x, buf + data + 2, i);
            data += 2 + i;
          }
        }
        if (p < packets) break;
      }
      if (y < ymax) return fail(err, errlen, "FLI LC lines past the image or its packets (buffer overrun)"), -2;
    } else if (kind == 13) {  // BLACK
      memset(img, 0, w * (size_t)height);
    } else if (kind == 15) {  // BRUN: byte runs
      for (int y = 0; y < height; ++y) {
        uint8_t* row = img + (size_t)y * w;
        data += 1;  // the packet count, not read
        size_t x = 0, i = 0;
        for (; x < w; x += i) {
          FLI_OOB(data + 2)
          if (buf[data] & 0x80) {
            i = 256 - buf[data];
            if (x + i > w) break;
            FLI_OOB(data + i + 1)
            memcpy(row + x, buf + data + 1, i);
            data += i + 1;
          } else {
            i = buf[data];
            if (x + i > w) break;
            memset(row + x, buf[data + 1], i);
            data += 2;
          }
        }
        if (x != w) return fail(err, errlen, "FLI BRUN line not filled (buffer overrun)"), -2;
      }
    } else if (kind == 16) {  // COPY
      if (data + w * (size_t)height > end) return (long)ptr;  // the bytes before this chunk: the caller reads on
      memcpy(img, buf + data, w * (size_t)height);
    } else if (kind != 4 && kind != 11 && kind != 18) {  // palettes and the postage stamp are skipped
      return fail(err, errlen, "FLI chunk of unknown type %ld", (long)kind), -2;
    }
    int32_t advance = (int32_t)le32(buf + ptr);
    if (advance == 0) return fail(err, errlen, "FLI chunk of size 0 (broken)"), -2;
    if (advance < 0 || (size_t)advance > end - ptr) return fail(err, errlen, "FLI chunk past the frame's bytes (buffer overrun)"), -2;
    ptr += (size_t)advance;
  }
#undef FLI_OOB
  return -1;
}

}  // namespace

extern "C" int uniir_raster_fli(const uint8_t* s, size_t n, size_t pos, size_t block, int width, int height,
                                uint8_t* out, size_t need, char* err, int errlen) {
  (void)need;
  std::vector<uint8_t> buf;
  size_t start = 0;  // the decoder's bytes are buf[start, buf.size())
  for (;;) {
    size_t take = pos < n ? (n - pos < block ? n - pos : block) : 0;
    if (!take) return fail(err, errlen, "FLI frame cut short (image file is truncated)");
    buf.erase(buf.begin(), buf.begin() + (long)start);
    start = 0;
    buf.insert(buf.end(), s + pos, s + pos + take);
    pos += take;
    long used = fli_chunks(buf.data(), buf.size(), out, width, height, err, errlen);
    if (used == -2) return 1;
    if (used < 0) return 0;
    start = (size_t)used;
  }
}
