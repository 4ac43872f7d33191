"""The byte-serial stages of the small raster formats, as Pillow 12.1 runs them.

`data/qoi.py`, `tga.py`, `sgi.py`, `pcx.py`, `sun.py`, `msp.py`, `psd.py`,
`icns.py` and `fli.py` read a file's header, palette and orientation in numpy; what is left is a loop
over the file's bytes in which each step depends on the one before.  This
module holds that loop for each of them twice: a plain Python twin, the
reference, and a native entry in host C++ (`csrc/raster.cu`, built by
`_build` like the kernels and called through ctypes, which releases the
GIL).  Both take the same arguments and give the same bytes, or raise
ValueError with the same message:

  * `qoi`: Pillow's Python `QoiDecoder` (the op stream, the 64-entry index
    hashed with alpha and read as (0, 0, 0, 0) where nothing was stored, a
    run past the image dropped, a stream cut short refused);
  * `tga_rle`: `TgaRleDecode.c` (a run past its row's end is an overrun, a
    literal goes on into the next rows; a depth of 1 bit reads packets of
    no bytes, so such a stream never fills the image);
  * `sgi_rle`: `SgiRleDecode.c` (the row start and length tables after the
    512-byte header; rows expanded channel by channel into one row buffer
    kept between rows; a chunk count of the row's length, whatever the
    data left; a last chunk of a nonzero byte stopping the whole image
    without an error; an offset inside the header, and a chunk that reads
    past the data or its row, refused);
  * `pcx_rle`: `PcxDecode.c` (a run past the line's end refused; a line's
    planes moved together where it holds more than the unpacker reads);
  * `sun_rle`: `SunRleDecode.c` (the 0x80 escape; runs go on into the next
    rows; rows of the unpadded width);
  * `msp_rle`: Pillow's Python `MspDecoder` (the row-length map, rows of
    any decoded length joined, too few bytes refused);
  * `packbits`: `PackBitsDecode.c` over a PSD file's channels as
    ImageFile.load runs their tiles (in the order of their offsets, each
    from its offset on whatever the row byte counts say; 0x80 skipped; a
    packet past its row's end cut there; data cut short refused);
  * `icns_rle`: IcnsImagePlugin's `read_32` (three channels one after the
    other, runs of b - 125 copies and literals of b + 1 bytes whatever the
    entry's length, a channel whose counts miss its size or whose bytes
    run out refused);
  * `fli`: `FliDecode.c` over an FLI / FLC file's first frame as
    ImageFile.load feeds it (`fli_twin`'s docstring), into a zeroed image.

The output is the image's rows in the order the file gives them (the
caller flips and unpacks them).  `expander(native)` gives the twin or the
native entry; each native entry counts its calls in `native_calls`.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from uniir_tpu_torch.data.bmp import MAX_PIXELS

KINDS = ("qoi", "tga_rle", "sgi_rle", "pcx_rle", "sun_rle", "msp_rle", "packbits", "icns_rle", "fli")


class NotThisFormat(Exception):
    """What makes Pillow's `Image.open` try its next reader: the reader's `_open` raised SyntaxError,
    IndexError, TypeError, KeyError, EOFError or struct.error, or read a size of 0."""


def check_size(width: int, height: int, name: str) -> None:
    """Image.open's checks of a reader's size: not above 0 in both is not this format; more pixels than the
    decompression bomb limit raises."""
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: size {width} x {height}")
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: {width * height} pixels (decompression bomb)")


def raw_rows(data: bytes, offset: int, height: int, row_bytes: int, name: str, stride: int = 0) -> np.ndarray:
    """uint8 [height, row_bytes]: the rows Pillow's raw decoder (RawDecode.c) reads from `offset`, `stride` bytes
    apart (0: packed); ValueError where it fails: a negative offset, a stride below a row's bytes, data that
    ends first (Image.load: "image file is truncated")."""
    step = stride or row_bytes
    if offset < 0:
        raise ValueError(f"{name}: negative offset {offset} of the pixel data")
    if step < row_bytes:
        raise ValueError(f"{name}: row stride {stride} below a row's {row_bytes} bytes (raw decoder configuration)")
    if offset + (height - 1) * step + row_bytes > len(data):
        raise ValueError(f"{name}: pixel data cut short (image file is truncated)")
    return np.lib.stride_tricks.as_strided(np.frombuffer(data, np.uint8, offset=offset), (height, row_bytes),
                                           (step, 1)).copy()


# --- the twins -----------------------------------------------------------------


def qoi_twin(data: bytes, pos: int, width: int, height: int, bands: int, name: str) -> bytes:
    """width * height * bands bytes of a QOI op stream from `pos` (bands 3: alpha dropped)."""
    need = width * height * bands
    out = bytearray()
    seen = {}
    prev = (0, 0, 0, 255)
    n = len(data)
    while len(out) < need:
        if pos >= n:
            raise ValueError(f"{name}: QOI data cut short")
        b = data[pos]
        pos += 1
        if b == 0xFE or b == 0xFF:
            k = 3 if b == 0xFE else 4
            if pos + k > n:
                raise ValueError(f"{name}: QOI data cut short")
            value = tuple(data[pos : pos + k]) + (prev[3:] if k == 3 else ())
            pos += k
        elif b >> 6 == 0:
            value = seen.get(b & 63, (0, 0, 0, 0))
        elif b >> 6 == 1:
            value = ((prev[0] + (b >> 4 & 3) - 2) % 256, (prev[1] + (b >> 2 & 3) - 2) % 256,
                     (prev[2] + (b & 3) - 2) % 256, prev[3])
        elif b >> 6 == 2:
            if pos >= n:
                raise ValueError(f"{name}: QOI data cut short")
            second = data[pos]
            pos += 1
            dg = (b & 63) - 32
            value = ((prev[0] + dg + (second >> 4) - 8) % 256, (prev[1] + dg) % 256,
                     (prev[2] + dg + (second & 15) - 8) % 256, prev[3])
        else:
            out += bytes(prev[:bands]) * ((b & 63) + 1)
            continue
        prev = value
        seen[(value[0] * 3 + value[1] * 5 + value[2] * 7 + value[3] * 11) % 64] = value
        out += bytes(value[:bands])
    return bytes(out[:need])


def tga_rle_twin(data: bytes, pos: int, row_bytes: int, rows: int, depth: int, name: str) -> bytes:
    """rows * row_bytes bytes of TGA RLE packets from `pos` (`depth` bytes a pixel): a run may not pass its
    row's end, a literal goes on into the next rows."""
    need = rows * row_bytes
    out = bytearray()
    n = len(data)
    while len(out) < need:
        if pos >= n:
            raise ValueError(f"{name}: TGA RLE data cut short")
        count = depth * ((data[pos] & 0x7F) + 1)
        if data[pos] & 0x80:
            if n - pos < 1 + depth:
                raise ValueError(f"{name}: TGA RLE data cut short")
            if len(out) % row_bytes + count > row_bytes:
                raise ValueError(f"{name}: TGA RLE run past the row's end (buffer overrun)")
            out += data[pos + 1 : pos + 1 + depth] * (count // depth if depth else 0)
            pos += 1 + depth
        else:
            if n - pos < 1 + count:
                raise ValueError(f"{name}: TGA RLE data cut short")
            out += data[pos + 1 : pos + 1 + count]
            pos += 1 + count
    return bytes(out[:need])


def _sgi_row(buf: bytearray, at: int, data: bytes, src: int, n: int, z: int, xsize: int, bpc: int,
             end: int) -> int:
    """expandrow / expandrow2: 0 (done), 1 (a last nonzero chunk: the image stops) or -1 (overrun)."""
    x = 0
    while n > 0:
        if src + bpc - 1 > end:
            return -1
        pixel = data[src + bpc - 1]
        src += bpc
        if n == 1 and pixel != 0:
            return 1
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > xsize:
            return -1
        x += count
        if pixel & 0x80:
            if src + bpc * count > end:
                return -1
            for _ in range(count):
                buf[at : at + bpc] = data[src : src + bpc]
                src += bpc
                at += z * bpc
        else:
            if src + (0 if bpc == 1 else 2) > end:
                return -1
            value = data[src : src + bpc]
            for _ in range(count):
                buf[at : at + bpc] = value
                at += z * bpc
            src += bpc
        n -= 1
    return 0


def sgi_rle_twin(data: bytes, xsize: int, ysize: int, bands: int, bpc: int, name: str) -> bytes:
    """ysize rows of xsize * bands * bpc interleaved bytes, as the file's tables order them (rows past an
    early stop are zero)."""
    body = data[512:]
    size = len(body)
    tablen = bands * ysize
    if size < 8 * tablen:
        raise ValueError(f"{name}: SGI RLE tables past the end of the file (buffer overrun)")
    starts = [int.from_bytes(body[4 * i : 4 * i + 4], "big") for i in range(tablen)]
    lengths = [int.from_bytes(body[4 * (tablen + i) : 4 * (tablen + i) + 4], "big") for i in range(tablen)]
    row = xsize * bands * bpc
    buf = bytearray(2 * xsize * bands)
    out = bytearray(ysize * row)
    for r in range(ysize):
        for ch in range(bands):
            start, length = starts[r + ch * ysize], lengths[r + ch * ysize]
            if start < 512:
                raise ValueError(f"{name}: SGI RLE row inside the header (buffer overrun)")
            n = length - (1 << 32) if length >= 1 << 31 else length  # the C int it is passed as
            status = _sgi_row(buf, ch * bpc, body, start - 512, n, bands, xsize, bpc, size - 1)
            if status == -1:
                raise ValueError(f"{name}: SGI RLE run past the row or the data (buffer overrun)")
            if status == 1:
                return bytes(out)
        out[r * row : (r + 1) * row] = buf[:row]
    return bytes(out)


def pcx_rle_twin(data: bytes, pos: int, xsize: int, bits: int, row_bytes: int, rows: int, name: str) -> bytes:
    """rows * row_bytes bytes of PCX RLE from `pos`, each line's planes moved together as PcxDecode.c moves
    them for an unpacker of `bits` bits a pixel: planes of ceil(xsize / 8) bytes for 2 or 4, else of xsize
    bytes, where the line holds more than that a plane."""
    if bits in (2, 4):
        plane, bands = (xsize + 7) // 8, bits
        stride = row_bytes // bits
    else:
        plane, bands = xsize, row_bytes // xsize
        stride = row_bytes // bands if bands else 0
    out = bytearray()
    line = bytearray()
    n = len(data)
    while len(out) < rows * row_bytes:
        if pos >= n:
            raise ValueError(f"{name}: PCX RLE data cut short")
        b = data[pos]
        if b & 0xC0 == 0xC0:
            if pos + 1 >= n:
                raise ValueError(f"{name}: PCX RLE data cut short")
            count = b & 0x3F
            if len(line) + count > row_bytes:
                raise ValueError(f"{name}: PCX RLE run past the line's end (buffer overrun)")
            line += bytes((data[pos + 1],)) * count
            pos += 2
        else:
            line.append(b)
            pos += 1
        if len(line) >= row_bytes:
            if stride > plane:
                for i in range(1, bands):
                    line[i * plane : (i + 1) * plane] = line[i * stride : i * stride + plane]
            out += line
            line = bytearray()
    return bytes(out)


def sun_rle_twin(data: bytes, pos: int, row_bytes: int, rows: int, name: str) -> bytes:
    """rows * row_bytes bytes of Sun raster RLE from `pos`: a byte, 0x80 0x00 for 0x80, or 0x80 n v for
    n + 1 copies of v, which go on into the next rows."""
    need = rows * row_bytes
    out = bytearray()
    n = len(data)
    while len(out) < need:
        if pos >= n:
            raise ValueError(f"{name}: Sun raster RLE data cut short")
        if data[pos] == 0x80:
            if pos + 1 >= n:
                raise ValueError(f"{name}: Sun raster RLE data cut short")
            if data[pos + 1] == 0:
                out.append(0x80)
                pos += 2
            else:
                if pos + 2 >= n:
                    raise ValueError(f"{name}: Sun raster RLE data cut short")
                out += bytes((data[pos + 2],)) * (data[pos + 1] + 1)
                pos += 3
        else:
            out.append(data[pos])
            pos += 1
    return bytes(out[:need])


def msp_rle_twin(data: bytes, width: int, height: int, name: str) -> bytes:
    """height * ceil(width / 8) bytes of an MSP v2 file: the rows its row-length map names, each run-length
    decoded and joined whatever its length, a row of length 0 white."""
    stride = (width + 7) // 8
    need = height * stride
    if len(data) < 32 + 2 * height:
        raise ValueError(f"{name}: truncated MSP file in row map")
    lengths = [data[32 + 2 * i] | data[33 + 2 * i] << 8 for i in range(height)]
    pos = 32 + 2 * height
    out = bytearray()
    for r, length in enumerate(lengths):
        if length == 0:
            out += b"\xff" * stride
            continue
        row = data[pos : pos + length]
        pos += len(row)
        if len(row) != length:
            raise ValueError(f"{name}: truncated MSP file, expected {length} bytes on row {r}")
        i = 0
        while i < length:
            kind = row[i]
            i += 1
            if kind == 0:
                if i + 2 > length:
                    raise ValueError(f"{name}: corrupted MSP file in row {r}")
                out += bytes((row[i + 1],)) * row[i]
                i += 2
            else:
                out += row[i : i + kind]
                i += kind
    if len(out) < need:
        raise ValueError(f"{name}: not enough image data ({len(out)} of {need} bytes)")
    return bytes(out[:need])


def packbits_twin(data: bytes, offsets: tuple, row_bytes: int, rows: int, name: str) -> bytes:
    """len(offsets) * rows * row_bytes bytes: channel c's rows of PackBits from offsets[c]."""
    out = bytearray(len(offsets) * rows * row_bytes)
    n = len(data)
    for c in sorted(range(len(offsets)), key=lambda c: offsets[c]):  # ImageFile.load's order of the tiles
        pos, y, line = offsets[c], 0, bytearray()
        while y < rows:
            if pos >= n:
                raise ValueError(f"{name}: PackBits data cut short (image file is truncated)")
            b = data[pos]
            if b == 0x80:
                pos += 1
                continue
            run = b & 0x80
            k = 257 - b if run else b + 1
            if pos + (2 if run else 1 + k) > n:
                raise ValueError(f"{name}: PackBits data cut short (image file is truncated)")
            take = min(k, row_bytes - len(line))  # a packet past the row's end is cut there
            line += bytes((data[pos + 1],)) * take if run else data[pos + 1 : pos + 1 + take]
            pos += 2 if run else 1 + k
            if len(line) == row_bytes:
                at = (c * rows + y) * row_bytes
                out[at : at + row_bytes] = line
                line, y = bytearray(), y + 1
    return bytes(out)


def icns_rle_twin(data: bytes, pos: int, pixels: int, name: str) -> bytes:
    """3 * pixels bytes, the red, green and blue planes of an ICNS RLE entry from `pos`."""
    out = bytearray()
    n = len(data)
    for band in range(3):
        left, got = pixels, 0
        while left > 0:
            if pos >= n:
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                k = b - 125
                value = data[pos : pos + 1]
                pos += len(value)
                out += value * k
                got += len(value) * k
            else:
                k = b + 1
                chunk = data[pos : pos + k]
                pos += len(chunk)
                out += chunk
                got += len(chunk)
            left -= k
        if left != 0:
            raise ValueError(f"{name}: ICNS RLE channel {band}: {left} bytes left (error reading channel)")
        if got < pixels:
            raise ValueError(f"{name}: ICNS RLE channel {band}: {pixels - got} bytes short (not enough image data)")
    return bytes(out)


class _FliError(Exception):
    """FliDecode.c set an error code: ImageFile.load raises after its loop."""


def _fli_chunks(buf: bytes, img: bytearray, width: int, height: int) -> int:
    """One call of ImagingFliDecode on `buf`: the bytes it consumed, or -1 at the frame's end (_FliError where it
    sets an error code).  Every read is bounded by the buffer's end, not by the chunk's size."""
    end = len(buf)
    if end < 4:
        return 0
    framesize = int.from_bytes(buf[:4], "little")
    if end + end % 2 < framesize:  # one pad byte may be missing
        return 0
    if end < 8:
        raise _FliError("FLI frame header cut short (buffer overrun)")
    if buf[4] | buf[5] << 8 != 0xF1FA:
        raise _FliError("FLI frame of another chunk type (unknown)")
    chunks = buf[6] | buf[7] << 8
    ptr = 16

    def oob(at: int) -> None:
        if at > end:
            raise _FliError("FLI chunk data past the frame's bytes (buffer overrun)")

    for _ in range(chunks):
        if end - ptr < 10:
            raise _FliError("FLI chunk header past the frame's bytes (buffer overrun)")
        data = ptr + 6
        kind = buf[ptr + 4] | buf[ptr + 5] << 8
        if kind == 7:  # SS2: word-oriented delta
            lines = buf[data] | buf[data + 1] << 8
            data += 2
            y = line = 0
            while line < lines and y < height:
                row = y * width
                oob(data + 2)
                packets = buf[data] | buf[data + 1] << 8
                data += 2
                while packets & 0x8000:
                    if packets & 0x4000:  # skip lines
                        y += 65536 - packets
                        if y >= height:
                            raise _FliError("FLI SS2 skips past the image (buffer overrun)")
                        row = y * width
                    else:  # the last pixel of an odd-width line
                        img[row + width - 1] = packets & 0xFF
                    oob(data + 2)
                    packets = buf[data] | buf[data + 1] << 8
                    data += 2
                p = x = 0
                while p < packets:
                    oob(data + 2)
                    x += buf[data]
                    if buf[data + 1] >= 128:
                        oob(data + 4)
                        i = 256 - buf[data + 1]
                        if x + 2 * i > width:
                            break
                        img[row + x : row + x + 2 * i] = buf[data + 2 : data + 4] * i
                        x += 2 * i
                        data += 4
                    else:
                        i = 2 * buf[data + 1]
                        if x + i > width:
                            break
                        oob(data + 2 + i)
                        img[row + x : row + x + i] = buf[data + 2 : data + 2 + i]
                        data += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                line += 1
                y += 1
            if line < lines:
                raise _FliError("FLI SS2 lines past the image or its packets (buffer overrun)")
        elif kind == 12:  # LC: byte-oriented delta
            y = buf[data] | buf[data + 1] << 8
            ymax = y + (buf[data + 2] | buf[data + 3] << 8)
            data += 4
            while y < ymax and y < height:
                row = y * width
                oob(data + 1)
                packets = buf[data]
                data += 1
                p = x = 0
                while p < packets:
                    oob(data + 2)
                    x += buf[data]
                    if buf[data + 1] & 0x80:
                        i = 256 - buf[data + 1]
                        if x + i > width:
                            break
                        oob(data + 3)
                        img[row + x : row + x + i] = buf[data + 2 : data + 3] * i
                        data += 3
                    else:
                        i = buf[data + 1]
                        if x + i > width:
                            break
                        oob(data + 2 + i)
                        img[row + x : row + x + i] = buf[data + 2 : data + 2 + i]
                        data += 2 + i
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                raise _FliError("FLI LC lines past the image or its packets (buffer overrun)")
        elif kind == 13:  # BLACK
            img[:] = bytes(len(img))
        elif kind == 15:  # BRUN: byte runs
            for y in range(height):
                row = y * width
                data += 1  # the packet count, not read
                x = 0
                while x < width:
                    oob(data + 2)
                    if buf[data] & 0x80:
                        i = 256 - buf[data]
                        if x + i > width:
                            break
                        oob(data + i + 1)
                        img[row + x : row + x + i] = buf[data + 1 : data + 1 + i]
                        data += i + 1
                    else:
                        i = buf[data]
                        if x + i > width:
                            break
                        img[row + x : row + x + i] = buf[data + 1 : data + 2] * i
                        data += 2
                    x += i
                if x != width:
                    raise _FliError("FLI BRUN line not filled (buffer overrun)")
        elif kind == 16:  # COPY
            if data + width * height > end:
                return ptr  # the bytes before this chunk: ImageFile.load reads on
            img[:] = buf[data : data + width * height]
        elif kind not in (4, 11, 18):  # palettes (read by the header) and the postage stamp are skipped
            raise _FliError(f"FLI chunk of unknown type {kind}")
        advance = int.from_bytes(buf[ptr : ptr + 4], "little", signed=True)
        if advance == 0:
            raise _FliError("FLI chunk of size 0 (broken)")
        if advance < 0 or advance > end - ptr:
            raise _FliError("FLI chunk past the frame's bytes (buffer overrun)")
        ptr += advance
    return -1


def fli_twin(data: bytes, pos: int, block: int, width: int, height: int, name: str) -> bytes:
    """width * height palette indices of an FLI / FLC frame at `pos`: ImageFile.load's loop over the file,
    `block` (the frame's size) bytes a read appended to what the decoder left, each call of FliDecode.c on
    the whole; a read of nothing before the decoder ends the frame, or an error code, raises."""
    img = bytearray(width * height)
    buf = b""
    while True:
        s = data[pos : pos + block]
        pos += len(s)
        if not s:
            raise ValueError(f"{name}: FLI frame cut short (image file is truncated)")
        buf += s
        try:
            n = _fli_chunks(buf, img, width, height)
        except _FliError as err:
            raise ValueError(f"{name}: {err}") from None
        if n < 0:
            return bytes(img)
        buf = buf[n:]


TWINS = {"qoi": qoi_twin, "tga_rle": tga_rle_twin, "sgi_rle": sgi_rle_twin, "pcx_rle": pcx_rle_twin,
         "sun_rle": sun_rle_twin, "msp_rle": msp_rle_twin, "packbits": packbits_twin, "icns_rle": icns_rle_twin,
         "fli": fli_twin}


# --- the native entries ----------------------------------------------------------


native_calls = dict.fromkeys(KINDS, 0)  # stages that went through csrc/raster.cu (read by chip_smoke.py)
_calls_lock = threading.Lock()  # the loader's threads decode at once


def _run(kind: str, size: int, name: str, args: tuple) -> bytes:
    from uniir_tpu_torch import _build

    lib = _build.load("raster")
    out = ctypes.create_string_buffer(max(size, 1))
    err = ctypes.create_string_buffer(256)
    if getattr(lib, f"uniir_raster_{kind}")(*args, out, size, err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    with _calls_lock:
        native_calls[kind] += 1
    return out.raw[:size]


def qoi_native(data: bytes, pos: int, width: int, height: int, bands: int, name: str) -> bytes:
    return _run("qoi", width * height * bands, name, (data, len(data), pos, width, height, bands))


def tga_rle_native(data: bytes, pos: int, row_bytes: int, rows: int, depth: int, name: str) -> bytes:
    return _run("tga_rle", rows * row_bytes, name, (data, len(data), pos, row_bytes, rows, depth))


def sgi_rle_native(data: bytes, xsize: int, ysize: int, bands: int, bpc: int, name: str) -> bytes:
    return _run("sgi_rle", ysize * xsize * bands * bpc, name, (data, len(data), xsize, ysize, bands, bpc))


def pcx_rle_native(data: bytes, pos: int, xsize: int, bits: int, row_bytes: int, rows: int, name: str) -> bytes:
    return _run("pcx_rle", rows * row_bytes, name, (data, len(data), pos, xsize, bits, row_bytes, rows))


def sun_rle_native(data: bytes, pos: int, row_bytes: int, rows: int, name: str) -> bytes:
    return _run("sun_rle", rows * row_bytes, name, (data, len(data), pos, row_bytes, rows))


def msp_rle_native(data: bytes, width: int, height: int, name: str) -> bytes:
    return _run("msp_rle", height * ((width + 7) // 8), name, (data, len(data), width, height))


def packbits_native(data: bytes, offsets: tuple, row_bytes: int, rows: int, name: str) -> bytes:
    at = (ctypes.c_uint64 * max(len(offsets), 1))(*offsets)
    return _run("packbits", len(offsets) * rows * row_bytes, name,
                (data, len(data), at, len(offsets), row_bytes, rows))


def icns_rle_native(data: bytes, pos: int, pixels: int, name: str) -> bytes:
    return _run("icns_rle", 3 * pixels, name, (data, len(data), pos, pixels))


def fli_native(data: bytes, pos: int, block: int, width: int, height: int, name: str) -> bytes:
    return _run("fli", width * height, name, (data, len(data), pos, block, width, height))


NATIVES = {"qoi": qoi_native, "tga_rle": tga_rle_native, "sgi_rle": sgi_rle_native, "pcx_rle": pcx_rle_native,
           "sun_rle": sun_rle_native, "msp_rle": msp_rle_native, "packbits": packbits_native,
           "icns_rle": icns_rle_native, "fli": fli_native}


def expander(kind: str, native: bool):
    """The stage `kind` a decode uses: the native entry or its twin."""
    return (NATIVES if native else TWINS)[kind]
