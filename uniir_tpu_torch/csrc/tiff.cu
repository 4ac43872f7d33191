// TIFF decoder: host code, no kernel.
//
// The native twin of uniir_tpu_torch/data/tiff.py::decode_twin, which is the
// reference: Python parses the IFD into a plan (each strip's or tile's bytes,
// where its rows go, how Pillow's raw mode unpacks them: `native_spec`) and
// runs zlib / lzma and the JPEG strips; this file decodes the image in one
// call: the codecs whose loops are serial, as libtiff 4.7 decodes them for
// Pillow's TiffDecode.c --
//
//   * LZW (5): tif_lzw.c's LZWDecode (MSB-first codes of 9-12 bits, the
//     early change) or, where the stream's first two bytes say so,
//     LZWDecodeCompat (LSB-first, widened an entry later); a first code
//     other than a clear, a code past the next free entry, a first code
//     after a clear above 255, or a stream that ends (or meets its EOI code)
//     before the chunk is full is an error;
//   * PackBits (32773): tif_packbits.c, a stream that ends short an error (a
//     run cut short by the data's end dropped);
//   * CCITT (2, 3, 4): tif_fax3.c's Fax3DecodeRLE, Fax3Decode1D /
//     Fax3Decode2D (T4Options bit 0) and Fax4Decode over tif_fax3sm.c's state
//     tables, with libtiff's bit accumulator (zeros padded where a request
//     runs past the data's end, which is an error only with no bit left),
//     its patching of bad code words and rows of the wrong length, and its
//     two run arrays, which keep what earlier rows and strips left in them.
//     A Group 3 strip that ends inside an EOL is read again from its first
//     bit without EOLs, FAXMODE_NOEOL kept for the image (libtiff 4.7's
//     retry); another premature end is an error, except where Fax4Decode
//     succeeds: the chunk's last row;
//   * ZSTD (50000): libtiff's ZSTDDecode over csrc/zstd.cuh's decoder of
//     libzstd's ZSTD_decompressStream (`uniir_zstd_decompress` also gives
//     the decoder alone, as ZSTD_decompress or as one strip);
//
// -- FillOrder 2 undone on the compressed bytes, 16 / 32-bit samples of a
// big-endian file swapped to native order, the predictors (2: horizontal,
// over PredictorSetup's rows of bytes for YCbCr data units; 3: libtiff's
// fpAcc), Pillow's unpackers of the raw modes (bits and bands,
// inverted grey, bit-reversed bytes, the high byte of 16-bit samples, RGBa
// unpremultiplied, 12 / 16 / 32-bit and float samples, separate planes, a
// LAB plane's sign bit, YCbCr data units as TIFFRGBAImage places them),
// Convert.c's conversions to RGB (I;16 clamped, I clipped, F truncated,
// palettes, cmyk2rgb; YCbCr by libtiff's tables, which Python computes) and
// exif_transpose's orientations.  A truncated or corrupt stream returns an
// error with a message, never reads or writes out of bounds -- except in a
// chunk of YCbCr data units, which TIFFRGBAImage reads on past with its
// buffer as the failed call left it: what each codec wrote and its zeros
// after (LZW, PackBits, Deflate in Python), zeros (a ZSTD error, a tile
// libtiff cannot read), the differences (a predictor whose rows do not
// divide the chunk).
//
// Why host code and not a kernel: each code depends on the one before, and
// the images are resized on the host after decoding.  One call an image and
// no global state, so the loader's threads (ctypes releases the GIL) decode
// in parallel.
//
// Built by uniir_tpu_torch/_build.py with nvcc like the kernels' sources.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "zstd.cuh"

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, long a = 0, long b = 0) {
  char buf[200];
  snprintf(buf, sizeof(buf), fmt, a, b);
  throw Error{buf};
}

// ----------------------------------------------------------------------- LZW

void lzw_decode(const uint8_t* src, size_t n, uint8_t* out, size_t size) {
  bool compat = n >= 2 && src[0] == 0 && (src[1] & 1);
  std::vector<uint16_t> prefix(4096), length(4096);
  std::vector<uint8_t> first(4096), last(4096), stack(4097);
  for (int i = 0; i < 256; i++) {
    prefix[i] = 0;
    length[i] = 1;
    first[i] = last[i] = (uint8_t)i;
  }
  int nbits = 9, free_ent = 258, old = -2;  // -2: before the first clear code (LZWPreDecode: no free entry)
  uint64_t acc = 0;
  int nacc = 0;
  size_t pos = 0, got = 0;
  while (got < size) {
    while (nacc < nbits) {
      if (pos >= n) fail("LZW stream ends before the strip is full (not enough data)");
      if (compat)
        acc |= (uint64_t)src[pos] << nacc;
      else
        acc = (acc << 8) | src[pos];
      pos++;
      nacc += 8;
    }
    int code;
    if (compat) {
      code = (int)(acc & ((1u << nbits) - 1));
      acc >>= nbits;
    } else {
      code = (int)((acc >> (nacc - nbits)) & ((1u << nbits) - 1));
      acc &= (((uint64_t)1) << (nacc - nbits)) - 1;
    }
    nacc -= nbits;
    if (code == 257) break;
    if (code == 256) {
      nbits = 9;
      free_ent = 258;
      old = -1;
      continue;
    }
    if (old == -2) fail("corrupted LZW table (code %ld before the first clear code)", code);
    if (old < 0) {
      if (code >= 256) fail("corrupted LZW table (a code above 255 after a clear)");
      out[got++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (code > free_ent) fail("corrupted LZW table (code %ld past the next free entry %ld)", code, free_ent);
    if (free_ent >= 4096) fail("corrupted LZW table (more than 4096 entries)");
    // the new entry: old's string and the first byte of code's (old's own first byte for code == free_ent)
    prefix[free_ent] = (uint16_t)old;
    first[free_ent] = first[old];
    last[free_ent] = code < free_ent ? first[code] : first[old];
    length[free_ent] = (uint16_t)(length[old] + 1);
    free_ent++;
    int len = length[code], c = code;
    for (int i = len - 1; i >= 0; i--) {
      stack[i] = last[c];
      c = prefix[c];
    }
    for (int i = 0; i < len && got < size; i++) out[got++] = stack[i];
    old = code;
    if (free_ent + (compat ? 0 : 1) >= (1 << nbits) && nbits < 12) nbits++;
  }
  if (got < size) fail("LZW stream ends before the strip is full (not enough data)");
}

// ------------------------------------------------------------------ PackBits

void packbits_decode(const uint8_t* src, size_t n, uint8_t* out, size_t size) {
  size_t i = 0, got = 0;
  while (i < n && got < size) {
    int c = src[i++];
    if (c >= 128) {
      if (c == 128) continue;
      size_t count = 257 - c;
      if (i >= n) break;
      for (size_t k = 0; k < count && got < size; k++) out[got++] = src[i];
      i++;
    } else {
      size_t take = (size_t)c + 1 < size - got ? (size_t)c + 1 : size - got;
      if (i + take > n) break;  // "Terminating PackBitsDecode due to lack of data": the run is dropped
      for (size_t k = 0; k < take; k++) out[got++] = src[i + k];
      i += take;
    }
  }
  if (got < size) fail("PackBits stream ends before the strip is full (not enough data)");
}

// --------------------------------------------------------------------- CCITT

enum State { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL };

struct Ent {
  uint8_t state, width;
  uint16_t param;
};

const char* kWhiteTerm[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100", "00111", "01000",
    "001000", "000011", "110100", "110101", "101010", "101011", "0100111", "0001100", "0001000", "0010111",
    "0000011", "0000100", "0101000", "0101011", "0010011", "0100100", "0011000", "00000010", "00000011", "00011010",
    "00011011", "00010010", "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010", "00001011", "01010010",
    "01010011", "01010100", "01010101", "00100100", "00100101", "01011000", "01011001", "01011010", "01011011",
    "01001010", "01001011", "00110010", "00110011", "00110100"};
const char* kWhiteMakeup[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101", "01101000",
    "01100111", "011001100", "011001101", "011010010", "011010011", "011010100", "011010101", "011010110",
    "011010111", "011011000", "011011001", "011011010", "011011011", "010011000", "010011001", "010011010",
    "011000", "010011011"};
const char* kBlackTerm[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100", "0000100", "0000101",
    "0000111", "00000100", "00000111", "000011000", "0000010111", "0000011000", "0000001000", "00001100111",
    "00001101000", "00001101100", "00000110111", "00000101000", "00000010111", "00000011000", "000011001010",
    "000011001011", "000011001100", "000011001101", "000001101000", "000001101001", "000001101010", "000001101011",
    "000011010010", "000011010011", "000011010100", "000011010101", "000011010110", "000011010111", "000001101100",
    "000001101101", "000011011010", "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100", "000000110111", "000000111000",
    "000000100111", "000000101000", "000001011000", "000001011001", "000000101011", "000000101100", "000001011010",
    "000001100110", "000001100111"};
const char* kBlackMakeup[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011", "000000110100", "000000110101",
    "0000001101100", "0000001101101", "0000001001010", "0000001001011", "0000001001100", "0000001001101",
    "0000001110010", "0000001110011", "0000001110100", "0000001110101", "0000001110110", "0000001110111",
    "0000001010010", "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"};
const char* kExtMakeup[13] = {"00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
                              "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
                              "000000011101", "000000011110", "000000011111"};

// A lookup table over every `bits`-bit window (the stream's first bit lowest): the code its first bits spell.
void fill_table(std::vector<Ent>& t, int bits, const char* code, int state, int param) {
  int n = (int)strlen(code), base = 0;
  for (int i = 0; i < n; i++) base |= (code[i] - '0') << i;
  for (int high = 0; high < (1 << (bits - n)); high++) t[base | (high << n)] = Ent{(uint8_t)state, (uint8_t)n, (uint16_t)param};
}

struct Tables {
  std::vector<Ent> main, white, black;
  Tables() : main(128, Ent{0, 0, 0}), white(4096, Ent{0, 0, 0}), black(8192, Ent{0, 0, 0}) {
    const struct { const char* c; int s, p; } modes[] = {
        {"0001", S_Pass, 0}, {"001", S_Horiz, 0}, {"1", S_V0, 0}, {"011", S_VR, 1}, {"000011", S_VR, 2},
        {"0000011", S_VR, 3}, {"010", S_VL, 1}, {"000010", S_VL, 2}, {"0000010", S_VL, 3}, {"0000001", S_Ext, 0},
        {"0000000", S_EOL, 0}};
    for (const auto& m : modes) fill_table(main, 7, m.c, m.s, m.p);
    for (int i = 0; i < 64; i++) fill_table(white, 12, kWhiteTerm[i], S_TermW, i);
    for (int i = 0; i < 27; i++) fill_table(white, 12, kWhiteMakeup[i], S_MakeUpW, 64 * (i + 1));
    for (int i = 0; i < 13; i++) fill_table(white, 12, kExtMakeup[i], S_MakeUp, 1792 + 64 * i);
    fill_table(white, 12, "00000000000", S_EOL, 0);
    for (int i = 0; i < 64; i++) fill_table(black, 13, kBlackTerm[i], S_TermB, i);
    for (int i = 0; i < 27; i++) fill_table(black, 13, kBlackMakeup[i], S_MakeUpB, 64 * (i + 1));
    for (int i = 0; i < 13; i++) fill_table(black, 13, kExtMakeup[i], S_MakeUp, 1792 + 64 * i);
    fill_table(black, 13, "00000000000", S_EOL, 0);
  }
};

const Tables& tables() {
  static const Tables t;  // built once, read-only after (C++11 thread-safe initialisation)
  return t;
}

uint8_t reverse8(uint8_t b) {
  b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

struct FaxEOF {};
struct NoEOL {};  // SYNC_EOL's zeros with no 1 after them before the data ended (libtiff's noEOLFound)

struct Fax {
  const uint8_t* src;
  size_t n, cp = 0;
  uint64_t acc = 0;
  int avail = 0;
  uint32_t* arrays[2];
  int nruns, lastx;
  int cur = 0, ref = 1, eol = 0;
  int pa = 0, a0 = 0, run_length = 0;

  void need(int k, bool two) {
    if (avail >= k) return;
    if (cp >= n) {
      if (avail == 0) throw FaxEOF{};
      avail = k;  // pad with zeros
      return;
    }
    acc |= (uint64_t)reverse8(src[cp++]) << avail;
    avail += 8;
    if (two && avail < k) {
      if (cp >= n) {
        avail = k;
      } else {
        acc |= (uint64_t)reverse8(src[cp++]) << avail;
        avail += 8;
      }
    }
  }
  uint32_t get(int k) const { return (uint32_t)(acc & ((1u << k) - 1)); }
  void clr(int k) {
    avail -= k;
    acc >>= k;
  }
  Ent lookup(const std::vector<Ent>& t, int k, bool two = true) {
    need(k, two);
    Ent e = t[get(k)];
    clr(e.width);
    return e;
  }
  void setvalue(int x) {
    if (pa >= nruns) fail("corrupt CCITT data (run array overflow)");
    arrays[cur][pa++] = (uint32_t)(run_length + x);
    a0 += x;
    run_length = 0;
  }
  void cleanup() {  // CLEANUP_RUNS
    uint32_t* runs = arrays[cur];
    if (run_length) setvalue(0);
    if (a0 != lastx) {
      while (a0 > lastx && pa > 0) a0 -= (int)runs[--pa];
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if (pa & 1) setvalue(0);
        setvalue(lastx - a0);
      } else if (a0 > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  }
  void fill(uint8_t* row) {  // _TIFFFax3fillruns; the row's bytes start zeroed
    uint32_t* runs = arrays[cur];
    int erun = pa;
    if (erun & 1) runs[erun++] = 0;
    int64_t x = 0;
    for (int k = 0; k < erun; k += 2)
      for (int j = k; j < k + 2; j++) {
        int64_t run = runs[j];
        if (x + run > lastx || run > lastx) {
          run = lastx - x;
          runs[j] = (uint32_t)run;
        }
        if (run) {
          if (j & 1)
            for (int64_t i = x; i < x + run; i++) row[i >> 3] |= (uint8_t)(0x80 >> (i & 7));
          x += run;
        }
      }
  }
  void expand_1d() {
    const Tables& t = tables();
    uint32_t* runs = arrays[cur];
    for (;;) {
      for (int colour = 0; colour < 2; colour++) {
        for (;;) {
          Ent e = colour ? lookup(t.black, 13) : lookup(t.white, 12);
          if (e.state == S_EOL) {
            eol = 1;
            cleanup();
            return;
          }
          if (e.state == (colour ? S_TermB : S_TermW)) {
            setvalue(e.param);
            break;
          }
          if (e.state == (colour ? S_MakeUpB : S_MakeUpW) || e.state == S_MakeUp) {
            a0 += e.param;
            run_length += e.param;
            continue;
          }
          cleanup();  // a bad code word
          return;
        }
        if (a0 >= lastx) {
          cleanup();
          return;
        }
      }
      if (pa >= 2 && runs[pa - 1] == 0 && runs[pa - 2] == 0) pa -= 2;
    }
  }
  void expand_2d() {
    const Tables& t = tables();
    uint32_t* refr = arrays[ref];
    int pb = 1;
    int64_t b1 = refr[0];
    auto check_b1 = [&]() {
      if (pa != 0)
        while (b1 <= a0 && b1 < lastx) {
          if (pb + 1 >= nruns) fail("corrupt CCITT data (reference run array overflow)");
          b1 += (int64_t)refr[pb] + refr[pb + 1];
          pb += 2;
        }
    };
    while (a0 < lastx) {
      if (pa >= nruns) fail("corrupt CCITT data (run array overflow)");
      Ent e = lookup(t.main, 7, false);
      if (e.state == S_Pass) {
        check_b1();
        if (pb >= nruns) fail("corrupt CCITT data (reference run array overflow)");
        b1 += refr[pb++];
        run_length += (int)(b1 - a0);
        a0 = (int)b1;
        b1 += refr[pb++];
      } else if (e.state == S_Horiz) {
        int colour = (pa & 1) ? 1 : 0;
        for (int half = 0; half < 2; half++, colour ^= 1) {
          for (;;) {
            Ent h = colour ? lookup(t.black, 13) : lookup(t.white, 12);
            if (h.state == (colour ? S_TermB : S_TermW)) {
              setvalue(h.param);
              break;
            }
            if (h.state == (colour ? S_MakeUpB : S_MakeUpW) || h.state == S_MakeUp) {
              a0 += h.param;
              run_length += h.param;
              continue;
            }
            cleanup();  // a bad code word
            return;
          }
        }
        check_b1();
      } else if (e.state == S_V0 || e.state == S_VR) {
        check_b1();
        setvalue((int)(b1 - a0) + (e.state == S_VR ? e.param : 0));
        if (pb >= nruns) fail("corrupt CCITT data (reference run array overflow)");
        b1 += refr[pb++];
      } else if (e.state == S_VL) {
        check_b1();
        if (b1 < a0 + e.param) {
          cleanup();  // unexpected VL
          return;
        }
        setvalue((int)(b1 - a0) - e.param);
        b1 -= refr[--pb];
      } else if (e.state == S_Ext) {
        arrays[cur][pa++] = (uint32_t)(lastx - a0);
        cleanup();
        return;
      } else if (e.state == S_EOL) {
        arrays[cur][pa++] = (uint32_t)(lastx - a0);
        need(4, false);
        clr(4);
        eol = 1;
        cleanup();
        return;
      } else {
        cleanup();
        return;
      }
    }
    if (run_length) {
      if (run_length + a0 < lastx) {  // a final V0 is expected
        need(1, false);
        if (!get(1)) {
          cleanup();
          return;
        }
        clr(1);
      }
      setvalue(0);
    }
    cleanup();
  }
  void sync_eol() {
    if (eol == 0)
      for (;;) {
        need(11, true);
        if (get(11) == 0) break;
        clr(1);
      }
    for (;;) {
      try {
        need(8, false);
      } catch (const FaxEOF&) {
        throw NoEOL{};
      }
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eol = 0;
  }
};

// `noeol`: libtiff's FAXMODE_NOEOL, set for the rest of the image once a Group 3 row's EOL is not found; the strip
// is then read again from its first bit, the rows written on from the one it stopped at (data/tiff.py
// ccitt_decode).  A Group 4 strip that stops before its last row leaves later rows as Pillow's buffer held
// them: "unsupported: " errors, which the caller raises as UnsupportedImageFormat.
void ccitt_decode(const uint8_t* src, size_t n, int compression, int options, int width, int rows, uint8_t* out,
                  size_t size, uint32_t* runs, bool& noeol) {
  bool needs_ref = compression == 4 || (compression == 3 && (options & 1));
  int nruns = (width + 1 + 31) / 32 * 32 * (needs_ref ? 2 : 1);
  size_t row_bytes = ((size_t)width + 7) / 8;
  if (row_bytes * rows > size) fail("CCITT chunk larger than its buffer");
  memset(out, 0, size);
  Fax fx{src, n};
  fx.arrays[0] = runs;
  fx.arrays[1] = runs + nruns;
  fx.nruns = nruns;
  fx.lastx = width;
  fx.arrays[fx.ref][0] = (uint32_t)width;  // Fax3PreDecode: an all-white reference row
  fx.arrays[fx.ref][1] = 0;
  int done = 0;
  while (done < rows) {
    fx.pa = fx.a0 = fx.run_length = 0;
    try {
      if (compression == 2) {
        fx.expand_1d();
        fx.clr(fx.avail & 7);
      } else if (compression == 3) {
        if (!noeol) {
          try {
            fx.sync_eol();
          } catch (const NoEOL&) {
            noeol = true;
            fx.cp = 0, fx.acc = 0, fx.avail = 0, fx.eol = 0;
            continue;
          }
        }
        if (options & 1) {
          fx.need(1, false);
          int is_1d = (int)fx.get(1);
          fx.clr(1);
          if (is_1d)
            fx.expand_1d();
          else
            fx.expand_2d();
        } else {
          fx.expand_1d();
        }
      } else {
        fx.expand_2d();
        if (fx.eol) throw FaxEOF{};
      }
    } catch (const FaxEOF&) {
      if (compression == 4 && done > 0 && done == rows - 1) {  // Fax4Decode: the last row filled, success
        fx.cleanup();
        fx.fill(out + row_bytes * done);
        return;
      }
      if (compression == 4 && done > 0)
        fail("unsupported: a Group 4 strip that ends at row %ld of %ld: libtiff leaves the later rows as Pillow's "
             "buffer held them, which the port does not know", done, rows);
      fail("CCITT data ends before the strip is full (premature EOF at row %ld)", done);
    }
    fx.fill(out + row_bytes * done);
    if (needs_ref) {
      if (fx.pa < fx.nruns) fx.setvalue(0);  // the imaginary change of the reference row
      fx.cur ^= 1;
      fx.ref ^= 1;
    }
    done++;
  }
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

// ------------------------------------------------------------ the image

// How one chunk's rows become mode pixels (data/tiff.py::native_spec builds these from Pillow's raw modes).
enum Op { kPacked = 0, kBytes = 1, kHigh16 = 2, kU16 = 3, kS16 = 4, kS32 = 5, kF32 = 6, kU12 = 7, kUnits = 8 };
struct Spec {
  int op, bits, nin, keep, invert, reverse, big_endian, premult, scale;  // keep: the kept input bands, 4 bits each
};
// How the mode pixels become RGB.
enum Mode { kGrey = 0, kI16 = 1, kI32 = 2, kF = 3, kPalette = 4, kRGB = 5, kCMYK = 6, kYCbCr = 7 };

struct Image {
  int w, h, bands;
  std::vector<uint8_t> u8;    // [h][w][bands] for the 8-bit modes
  std::vector<int32_t> i32;   // [h][w] for I;16 and I
  std::vector<float> f32;     // [h][w] for F
};

const uint8_t* reversed_table() {
  static uint8_t t[256];
  static bool built = [] {
    for (int b = 0; b < 256; b++) t[b] = reverse8((uint8_t)b);
    return true;
  }();
  (void)built;
  return t;
}

// One row of `w` pixels from `src` into row y of the image, from column x0 (band `band`, or every band at -1).
void unpack_row(const Spec& sp, const uint8_t* src, int w, Image& im, int y, int x0, int band) {
  const uint8_t* rev = reversed_table();
  auto byte = [&](size_t i) { return sp.reverse ? rev[src[i]] : src[i]; };
  int keep[4], nkeep = 0;
  for (int k = 0; k < 4; k++) {
    int b = (sp.keep >> (4 * k)) & 15;
    if (b == 15) break;
    keep[nkeep++] = b;
  }
  for (int x = 0; x < w; x++) {
    size_t px = ((size_t)y * im.w + x0 + x);
    if (sp.op == kPacked) {
      size_t bit = (size_t)x * sp.bits;
      int v = (byte(bit >> 3) >> (8 - sp.bits - (int)(bit & 7))) & ((1 << sp.bits) - 1);
      if (sp.invert) v = ~v & ((1 << sp.bits) - 1);
      im.u8[px * im.bands] = (uint8_t)(v * sp.scale);
    } else if (sp.op == kBytes || sp.op == kHigh16) {
      int step = sp.op == kBytes ? 1 : 2, hi = sp.op == kHigh16 ? (sp.big_endian ? 0 : 1) : 0;
      const size_t base = (size_t)x * sp.nin * step;
      int v[4];
      for (int k = 0; k < nkeep; k++) v[k] = byte(base + (size_t)keep[k] * step + hi);
      if (sp.invert == 1) v[0] = 255 - v[0];
      if (sp.invert == 2) v[0] ^= 0x80;  // a LAB plane's a or b
      if (sp.premult) {  // Unpack.c's unpackRGBa: unpremultiplied, all zero where alpha is 0
        int a = v[3];
        for (int k = 0; k < 3; k++) {
          int u = a == 0 ? 0 : (a == 255 ? v[k] : v[k] * 255 / a);
          v[k] = u > 255 ? 255 : u;
        }
      }
      if (band >= 0)
        im.u8[px * im.bands + band] = (uint8_t)v[0];
      else
        for (int k = 0; k < nkeep && k < im.bands; k++) im.u8[px * im.bands + k] = (uint8_t)v[k];
    } else if (sp.op == kU16 || sp.op == kS16) {
      int b0 = byte(2 * (size_t)x), b1 = byte(2 * (size_t)x + 1);
      int v = sp.big_endian ? (b0 << 8) | b1 : (b1 << 8) | b0;
      im.i32[px] = sp.op == kS16 ? (int16_t)(uint16_t)v : v;
    } else if (sp.op == kS32 || sp.op == kF32) {
      uint32_t v = 0;
      for (int k = 0; k < 4; k++) v |= (uint32_t)byte(4 * (size_t)x + k) << (sp.big_endian ? 8 * (3 - k) : 8 * k);
      if (sp.op == kS32) {
        im.i32[px] = (int32_t)v;
      } else {
        float f;
        memcpy(&f, &v, 4);
        im.f32[px] = f;
      }
    } else {  // kU12: two pixels in three bytes, big-endian
      size_t bit = (size_t)x * 12;
      int v = ((byte(bit >> 3) << 8) | byte((bit >> 3) + 1)) >> (4 - (int)(bit & 7));
      im.i32[px] = v & 0xFFF;
    }
  }
}

void predictor2(uint8_t* buf, int rows, int width, int spp, int bytes) {
  size_t row = (size_t)width * spp * bytes;
  for (int r = 0; r < rows; r++) {
    uint8_t* p = buf + r * row;
    for (int x = 1; x < width; x++)
      for (int c = 0; c < spp; c++) {
        size_t i = ((size_t)x * spp + c) * bytes, j = ((size_t)(x - 1) * spp + c) * bytes;
        if (bytes == 1) {
          p[i] = (uint8_t)(p[i] + p[j]);
        } else if (bytes == 2) {
          uint16_t v = (uint16_t)((p[i] | p[i + 1] << 8) + (p[j] | p[j + 1] << 8));
          p[i] = (uint8_t)v;
          p[i + 1] = (uint8_t)(v >> 8);
        } else {
          uint32_t a, b;
          memcpy(&a, p + i, 4);
          memcpy(&b, p + j, 4);
          a += b;
          memcpy(p + i, &a, 4);
        }
      }
  }
}

void predictor3(uint8_t* buf, int rows, int width, int spp, int bytes) {  // libtiff's fpAcc, native little-endian
  size_t wc = (size_t)width * spp, row = wc * bytes;
  std::vector<uint8_t> tmp(row);
  for (int r = 0; r < rows; r++) {
    uint8_t* p = buf + r * row;
    for (size_t i = spp; i < row; i++) p[i] = (uint8_t)(p[i] + p[i - spp]);
    memcpy(tmp.data(), p, row);
    for (size_t i = 0; i < wc; i++)
      for (int b = 0; b < bytes; b++) p[bytes * i + b] = tmp[(size_t)(bytes - b - 1) * wc + i];
  }
}

uint8_t clip8(int64_t v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// chunk rows: [kind, offset, length, x0, y0, width (pixels unpacked), rows, row stride, band, spec, decoded size,
// chunk width] with kind 0: file bytes as they stand (Pillow's raw decoder), 1: `pre` bytes (decoded by Python:
// zlib / lzma), 2: a codec of this file, 3: a chunk of data units libtiff cannot read (zeros), 4: `pre` bytes of
// a zlib chunk that failed (what the failed call left)
const int kChunkFields = 12;

// tif_predict.c's PredictorDecodeTile with horAcc8 over YCbCr data units: every third byte summed within each
// `rowsize` bytes; nothing where the rows do not divide the chunk or are not whole 3-byte strides (it fails).
void predictor2_units(std::vector<uint8_t>& buf, size_t rowsize) {
  if (!rowsize || buf.size() % rowsize || rowsize % 3) return;
  for (size_t r = 0; r < buf.size(); r += rowsize)
    for (size_t i = r + 3; i < r + rowsize; i++) buf[i] = (uint8_t)(buf[i] + buf[i - 3]);
}

}  // namespace

extern "C" {

// The whole image: its chunks decoded (codec, FillOrder, byte swap, predictor as `params` say), unpacked by their
// specs into mode pixels, converted to RGB (`params`' mode; `palette` 768 bytes, `ycc` 5 x 256 int64 tables) and
// transposed by the orientation into out (uint8 [out_h][out_w][3]).
// params: width, height, bands, storage (0 u8, 1 i32, 2 f32), mode, compression, t4options, predictor,
// fillorder, swap bytes (0, 2, 4), predictor samples per pixel, sample bytes, orientation, planar RGBa, the
// strip buffer of YCbCr data units, the predictor's row size for them
int uniir_tiff_decode(const uint8_t* data, size_t n, const int64_t* chunks, int n_chunks, const int32_t* specs,
                      int n_specs, const int32_t* params, const uint8_t* pre, size_t pre_n, const uint8_t* palette,
                      const int64_t* ycc, uint8_t* out, char* err, int errlen) {
  try {
    const int W = params[0], H = params[1], bands = params[2], storage = params[3], mode = params[4];
    const int compression = params[5], options = params[6], predictor = params[7], fillorder = params[8];
    const int swap = params[9], pred_spp = params[10], sample_bytes = params[11], orientation = params[12];
    const int planar_premult = params[13];
    const size_t unit_rowsize = (size_t)params[15];
    Image im{W, H, bands, {}, {}, {}};
    if (storage == 0) im.u8.assign((size_t)W * H * bands, 0);
    else if (storage == 1) im.i32.assign((size_t)W * H, 0);
    else im.f32.assign((size_t)W * H, 0.0f);
    std::vector<uint32_t> runs;  // libtiff's CCITT run arrays, from strip to strip
    bool noeol = false;          // and its FAXMODE_NOEOL
    std::vector<uint8_t> buf, raw;
    // TIFFRGBAImage's strip buffer of YCbCr data units (TIFFStripSize), zeroed for each strip, read into as far as
    // gtStripContig asks
    std::vector<uint8_t> held((size_t)params[14], 0);
    const uint8_t* rev = reversed_table();
    for (int k = 0; k < n_chunks; k++) {
      const int64_t* c = chunks + (size_t)k * kChunkFields;
      int64_t kind = c[0], off = c[1], len = c[2], x0 = c[3], y0 = c[4], w = c[5], rows = c[6], stride = c[7];
      int band = (int)c[8], spec = (int)c[9];
      int64_t size = c[10], cw = c[11];
      if (spec < 0 || spec >= n_specs) fail("bad unpacking spec %ld", spec);
      Spec sp;
      memcpy(&sp, specs + (size_t)spec * 9, sizeof(Spec));
      const uint8_t* rowsrc;
      const bool units = sp.op == kUnits;
      if (units && (kind == 3 || kind == 4)) {  // TIFFRGBAImage reads on: zeros, or what the failed zlib call left
        if (kind == 4 && (off < 0 || len < size || off + len > (int64_t)pre_n)) fail("bad decoded chunk %ld", k);
        buf.assign((size_t)size, 0);
        if (kind == 4) memcpy(buf.data(), pre + off, (size_t)size);
        rowsrc = buf.data();
      } else if (kind == 0) {  // Pillow's raw decoder: rows read with their stride from the file (size: one row's bytes)
        int64_t need = stride * (rows - 1) + size;
        if (off < 0 || off > (int64_t)n || (int64_t)n - off < need)
          fail("truncated TIFF file (image file is truncated)");
        rowsrc = data + off;
      } else {
        if (kind == 1) {
          if (off < 0 || len < size || off + len > (int64_t)pre_n) fail("bad decoded chunk %ld", k);
          buf.assign(pre + off, pre + off + size);
        } else {
          if (off < 0 || len < 0 || off + len > (int64_t)n)
            fail("truncated TIFF file (strip or tile %ld is cut short; read error)", k);
          raw.assign(data + off, data + off + len);
          if (fillorder == 2)
            for (auto& b : raw) b = rev[b];
          buf.assign((size_t)size, 0);
          try {
            if (compression == 5) {
              lzw_decode(raw.data(), raw.size(), buf.data(), buf.size());
            } else if (compression == 32773) {
              packbits_decode(raw.data(), raw.size(), buf.data(), buf.size());
            } else if (compression == 2 || compression == 3 || compression == 4) {
              if (runs.empty()) runs.assign((size_t)4 * (((int)cw + 1 + 31) / 32 * 32), 0);
              ccitt_decode(raw.data(), raw.size(), compression, options, (int)cw, (int)rows, buf.data(), buf.size(),
                           runs.data(), noeol);
            } else if (compression == 50000) {
              size_t got;
              try {
                got = zstd::stream(raw.data(), raw.size(), buf.data(), buf.size());
              } catch (const zstd::Corrupt& e) {  // one call of ZSTD_decompressStream fails: no output reported
                std::fill(buf.begin(), buf.end(), 0);
                throw Error{"corrupt ZSTD data (" + e.msg + ")"};
              }
              if (got < buf.size()) fail("ZSTD stream ends before the strip is full (not enough data)");
            } else {
              fail("compression %ld has no native chunk decoder", compression);
            }
          } catch (const Error&) {
            if (!units) throw;
            kind = 4;  // data units: TIFFRGBAImage reads on with the buffer as the codec left it
          }
        }
        if (swap == 2)
          for (size_t i = 0; i + 1 < buf.size(); i += 2) std::swap(buf[i], buf[i + 1]);
        else if (swap == 4)
          for (size_t i = 0; i + 3 < buf.size(); i += 4) std::swap(buf[i], buf[i + 3]), std::swap(buf[i + 1], buf[i + 2]);
        if (units) {
          if (predictor == 2 && kind != 4) predictor2_units(buf, unit_rowsize);
        } else if (predictor == 2) {
          predictor2(buf.data(), (int)rows, (int)cw, pred_spp, sample_bytes);
        } else if (predictor == 3) {
          predictor3(buf.data(), (int)rows, (int)cw, pred_spp, sample_bytes);
        }
        rowsrc = buf.data();
      }
      if (units) {  // YCbCr data units: h x v Y samples, then Cb and Cr (see data/tiff.py _units)
        if (buf.size() > held.size()) fail("YCbCr strip larger than its buffer");
        std::fill(held.begin(), held.end(), 0);
        memcpy(held.data(), buf.data(), buf.size());
        const int sh = sp.bits, sv = sp.nin, unit = sp.scale;
        for (int64_t r = 0; r < rows && y0 + r < H; r++)
          for (int64_t x = 0; x < w; x++) {
            size_t at = (size_t)((r / sv) * stride + (x / sh) * unit);
            if (at + unit > held.size()) fail("YCbCr data unit past its strip or tile");
            uint8_t* px = &im.u8[((size_t)(y0 + r) * W + x0 + x) * 3];
            px[0] = held[at + (r % sv) * sh + x % sh];
            px[1] = held[at + sh * sv];
            px[2] = held[at + sh * sv + 1];
          }
        continue;
      }
      for (int64_t r = 0; r < rows; r++) {
        if (y0 + r >= H) break;
        unpack_row(sp, rowsrc + r * stride, (int)w, im, (int)(y0 + r), (int)x0, band);
      }
    }
    if (planar_premult)  // TiffDecode.c's RGBa shuffle of a separate-planes RGBA image
      for (size_t i = 0; i < (size_t)W * H; i++) {
        uint8_t* v = &im.u8[i * 4];
        int a = v[3];
        for (int k = 0; k < 3; k++) {
          int u = a == 0 ? 0 : (a == 255 ? v[k] : v[k] * 255 / a);
          v[k] = (uint8_t)(u > 255 ? 255 : u);
        }
      }
    // convert("RGB"), then exif_transpose
    bool swap_wh = orientation >= 5 && orientation <= 8;
    int ow = swap_wh ? H : W, oh = swap_wh ? W : H;
    for (int oy = 0; oy < oh; oy++)
      for (int ox = 0; ox < ow; ox++) {
        int x, y;
        switch (orientation) {
          case 2: x = W - 1 - ox, y = oy; break;
          case 3: x = W - 1 - ox, y = H - 1 - oy; break;
          case 4: x = ox, y = H - 1 - oy; break;
          case 5: x = oy, y = ox; break;
          case 6: x = oy, y = H - 1 - ox; break;
          case 7: x = W - 1 - oy, y = H - 1 - ox; break;
          case 8: x = W - 1 - oy, y = ox; break;
          default: x = ox, y = oy; break;
        }
        size_t i = (size_t)y * W + x;
        uint8_t* o = out + ((size_t)oy * ow + ox) * 3;
        if (mode == kGrey) {
          o[0] = o[1] = o[2] = im.u8[i * bands];
        } else if (mode == kI16) {
          o[0] = o[1] = o[2] = (uint8_t)(im.i32[i] > 255 ? 255 : im.i32[i]);
        } else if (mode == kI32) {
          o[0] = o[1] = o[2] = clip8(im.i32[i]);
        } else if (mode == kF) {  // Convert.c: <= 0 -> 0, >= 255 -> 255, else truncated; NaN -> 0
          float f = im.f32[i];
          uint8_t v = f != f || f <= 0.0f ? 0 : (f >= 255.0f ? 255 : (uint8_t)f);
          o[0] = o[1] = o[2] = v;
        } else if (mode == kPalette) {
          for (int k = 0; k < 3; k++) o[k] = palette[3 * im.u8[i * bands] + k];
        } else if (mode == kRGB) {
          for (int k = 0; k < 3; k++) o[k] = im.u8[i * bands + k];
        } else if (mode == kCMYK) {  // Convert.c's cmyk2rgb
          int nk = 255 - im.u8[i * bands + 3];
          for (int k = 0; k < 3; k++) {
            int t = im.u8[i * bands + k] * nk + 128;
            o[k] = (uint8_t)(nk - (((t >> 8) + t) >> 8));
          }
        } else {  // YCbCr through libtiff's TIFFYCbCrToRGB tables: Y, Cr->R, Cb->B, Cr->G, Cb->G
          int yv = im.u8[i * bands], cb = im.u8[i * bands + 1], cr = im.u8[i * bands + 2];
          int64_t yy = ycc[yv];
          o[0] = clip8(yy + ycc[256 + cr]);
          o[1] = clip8(yy + ((ycc[1024 + cb] + ycc[768 + cr]) >> 16));
          o[2] = clip8(yy + ycc[512 + cb]);
        }
      }
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "out of memory or internal error decoding the TIFF");
  }
  return 1;
}

// The ZSTD decoder alone: `stream` 0 as ZSTD_decompress (every frame; at most `capacity` bytes), 1 as libtiff's
// ZSTDDecode of one strip of `capacity` bytes (what it writes; the caller fails a strip that comes up short).
// *size: the bytes written.
int uniir_zstd_decompress(const uint8_t* data, size_t n, uint8_t* out, size_t capacity, int stream, size_t* size,
                          char* err, int errlen) {
  try {
    if (stream) {
      *size = zstd::stream(data, n, out, capacity);
    } else {
      std::vector<uint8_t> buf;
      zstd::decompress(data, n, buf, capacity);
      memcpy(out, buf.data(), buf.size());
      *size = buf.size();
    }
    return 0;
  } catch (const zstd::Corrupt& e) {
    set_error(err, errlen, "corrupt ZSTD data (" + e.msg + ")");
  } catch (...) {
    set_error(err, errlen, "out of memory or internal error decoding ZSTD data");
  }
  return 1;
}

}  // extern "C"
