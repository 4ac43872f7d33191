"""The ZSTD decoders (`uniir_tpu_torch.data.zstd`): the twin bit-equal to
libzstd 1.5.7 -- the one Pillow's wheel ships, loaded through ctypes --
in both of its readings: `decompress` against `ZSTD_decompress` and
`decode_stream` against libtiff's ZSTDDecode loop of
`ZSTD_decompressStream`, on frames libzstd writes at levels -5 to 22, with
and without a checksum, a small window, long-distance matching, several
frames and a skippable frame, and on every cut and many flipped bytes of
them, raising where libzstd fails and giving its bytes (damaged ones too)
where it does not; and (`-m gpu`, on the card's machine, where nvcc builds
csrc/tiff.cu) the native decoder bit-equal to the twin on frames of
chip_smoke.py's writer.

The module imports neither Pillow nor libzstd at its top, so its `-m gpu`
cases collect with `--noconftest` on a machine that has neither."""

import ctypes
import glob
import os

import numpy as np
import pytest
import torch

import chip_smoke
from uniir_tpu_torch.data import zstd

_LIB: list = []


def libzstd():
    """Pillow's bundled libzstd 1.5.7 (its wheel's pillow.libs)."""
    if not _LIB:
        import PIL

        paths = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs", "libzstd-*.so*"))
        assert paths, "Pillow's wheel ships libzstd"
        lib = ctypes.CDLL(paths[0])
        p, s, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
        for fn, args, res in [("ZSTD_compressBound", [s], s), ("ZSTD_decompress", [p, s, p, s], s),
                              ("ZSTD_isError", [s], ctypes.c_uint), ("ZSTD_createCCtx", [], p),
                              ("ZSTD_freeCCtx", [p], s), ("ZSTD_CCtx_setParameter", [p, i, i], s),
                              ("ZSTD_compress2", [p, p, s, p, s], s), ("ZSTD_compressStream2", [p, p, p, i], s),
                              ("ZSTD_createDStream", [], p), ("ZSTD_initDStream", [p], s),
                              ("ZSTD_freeDStream", [p], s), ("ZSTD_decompressStream", [p, p, p], s),
                              ("ZSTD_versionNumber", [], ctypes.c_uint)]:
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, res
        _LIB.append(lib)
    return _LIB[0]


class _Buffer(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


# ZSTD_cParameter values
LEVEL, WINDOW_LOG, CHECKSUM, LDM = 100, 101, 201, 160


def compress(data: bytes, level: int, streamed: bool = False, **params) -> bytes:
    """A libzstd frame of `data`: in one call (content size in the header), or streamed without a pledged size
    as libtiff's ZSTDEncode writes it (no content size, a window descriptor)."""
    lib = libzstd()
    cctx = lib.ZSTD_createCCtx()
    for key, value in ((LEVEL, level), *((dict(window_log=WINDOW_LOG, checksum=CHECKSUM, ldm=LDM)[k], v)
                                         for k, v in params.items())):
        assert not lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, key, value))
    out = ctypes.create_string_buffer(lib.ZSTD_compressBound(len(data)) + 64)
    if not streamed:
        n = lib.ZSTD_compress2(cctx, out, len(out), data, len(data))
        lib.ZSTD_freeCCtx(cctx)
        assert not lib.ZSTD_isError(n)
        return out.raw[:n]
    src = ctypes.create_string_buffer(data, max(len(data), 1))
    frame = b""
    for at in range(0, len(data), 4096):
        inb = _Buffer(ctypes.addressof(src) + at, min(4096, len(data) - at), 0)
        while inb.pos < inb.size:
            outb = _Buffer(ctypes.addressof(out), len(out), 0)
            assert not lib.ZSTD_isError(lib.ZSTD_compressStream2(cctx, ctypes.byref(outb), ctypes.byref(inb), 0))
            frame += out.raw[: outb.pos]
    while True:
        outb, inb = _Buffer(ctypes.addressof(out), len(out), 0), _Buffer(None, 0, 0)
        left = lib.ZSTD_compressStream2(cctx, ctypes.byref(outb), ctypes.byref(inb), 2)
        frame += out.raw[: outb.pos]
        if left == 0:
            break
    lib.ZSTD_freeCCtx(cctx)
    return frame


def libzstd_decompress(data: bytes, capacity: int):
    """ZSTD_decompress's bytes, or None where it fails."""
    lib = libzstd()
    out = ctypes.create_string_buffer(max(capacity, 1))
    n = lib.ZSTD_decompress(out, capacity, data, len(data))
    return None if lib.ZSTD_isError(n) else out.raw[:n]


def libtiff_decode(data: bytes, size: int):
    """libtiff 4.7's ZSTDDecode of a strip into `size` bytes: its loop of ZSTD_decompressStream calls; the bytes,
    or None where it fails (an error, or a strip that comes up short)."""
    lib = libzstd()
    ds = lib.ZSTD_createDStream()
    lib.ZSTD_initDStream(ds)
    src = ctypes.create_string_buffer(data, max(len(data), 1))
    dst = ctypes.create_string_buffer(max(size, 1))
    inb, outb = _Buffer(ctypes.addressof(src), len(data), 0), _Buffer(ctypes.addressof(dst), size, 0)
    try:
        while True:
            ret = lib.ZSTD_decompressStream(ds, ctypes.byref(outb), ctypes.byref(inb))
            if lib.ZSTD_isError(ret):
                return None
            if not (ret != 0 and inb.pos < inb.size and outb.pos < outb.size):
                break
    finally:
        lib.ZSTD_freeDStream(ds)
    return dst.raw[:size] if outb.pos == size else None


def twin(fn, *args):
    try:
        return fn(*args)
    except ValueError as err:
        assert str(err).startswith("f.zst: "), err
        return None


def sample(seed: int, n: int) -> bytes:
    """Seeded bytes that compress in every way: ramps with noise, a small alphabet, runs and a repeated block."""
    rng = np.random.default_rng(seed)
    parts = [((np.arange(n // 4) * (seed % 5 + 1) // 3 + rng.normal(0, 3, n // 4)) % 256).astype(np.uint8),
             np.minimum(rng.geometric(0.25, n // 4), 60).astype(np.uint8),
             np.repeat(rng.integers(0, 256, n // 64, dtype=np.uint8), 16)]
    block = rng.integers(0, 256, 700, dtype=np.uint8)
    parts.append(np.tile(block, n // 4 // 700 + 1)[: n - sum(len(p) for p in parts)])
    return np.concatenate(parts).tobytes()


LEVELS = (-5, 1, 3, 9, 19, 22)
FORMS = [(f"level{lv}-checksum{ck}", lv, dict(checksum=ck)) for lv in LEVELS for ck in (0, 1)] + [
    ("window10", 9, dict(window_log=10)), ("ldm", 19, dict(ldm=1, window_log=16)),
    ("ldm-checksum", 3, dict(ldm=1, checksum=1))]


@pytest.mark.parametrize("form,level,params", FORMS, ids=[f[0] for f in FORMS])
def test_libzstd_frames_decode_as_libzstd(form, level, params):
    """One-call and streamed frames (as libtiff writes them) of 48 KiB: `decompress` equals ZSTD_decompress and
    `decode_stream` libtiff's loop, to the last byte and to a strip shorter than the frame."""
    data = sample(level + 40, 48 * 1024)
    for streamed in (False, True):
        frame = compress(data, level, streamed, **params)
        assert libzstd_decompress(frame, len(data)) == data
        assert zstd.decompress(frame, len(data), "f.zst") == data
        for size in (len(data), len(data) - 1000, 7):
            assert libtiff_decode(frame, size) == data[:size]
            assert zstd.decode_stream(frame, size, "f.zst") == data[:size]


def test_several_frames_and_skippable_frames():
    """ZSTD_decompress reads every frame and skips skippable ones; libtiff's loop stops at the first frame's end,
    so a strip of two frames is short, and one that starts with a skippable frame gets nothing."""
    a, b = sample(1, 9000), sample(2, 13000)
    skip = (0x184D2A50 + 7).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    frames = compress(a, 3, checksum=1) + skip + compress(b, 19) + compress(b"", 1)
    assert libzstd_decompress(frames, len(a) + len(b)) == a + b
    assert zstd.decompress(frames, len(a) + len(b), "f.zst") == a + b
    assert zstd.decode_stream(frames, len(a), "f.zst") == libtiff_decode(frames, len(a)) == a
    assert libtiff_decode(frames, len(a) + len(b)) is None  # the stream ends with the first frame
    assert twin(zstd.decode_stream, frames, len(a) + len(b), "f.zst") is None
    assert libtiff_decode(skip + frames, len(a)) is None
    assert twin(zstd.decode_stream, skip + frames, len(a), "f.zst") is None
    for bad in (frames + b"\x00", frames + b"\x28\xb5\x2f", skip[:6]):  # trailing bytes, a cut skippable header
        assert libzstd_decompress(bad, len(a) + len(b)) is None
        assert twin(zstd.decompress, bad, len(a) + len(b), "f.zst") is None


@pytest.mark.parametrize("level", LEVELS)
def test_cuts_and_flips_as_libzstd(level):
    """Every 29th cut and 40 flipped bytes of a 12 KiB frame with a checksum and one without (streamed, as libtiff
    writes): the twin fails where libzstd fails and gives its bytes where it does not (damaged literals that
    libzstd's fast four-stream Huffman decoder takes included), in both readings."""
    rng = np.random.default_rng(level + 100)
    data = sample(level + 7, 12 * 1024)
    for frame in (compress(data, level, checksum=1), compress(data, level, True)):
        cases = [frame[:k] for k in range(0, len(frame), 29)]
        for _ in range(40):
            bad = bytearray(frame)
            bad[int(rng.integers(0, len(frame)))] ^= int(rng.integers(1, 256))
            cases.append(bytes(bad))
        for bad in cases:
            assert twin(zstd.decompress, bad, len(data), "f.zst") == libzstd_decompress(bad, len(data))
            assert twin(zstd.decode_stream, bad, len(data), "f.zst") == libtiff_decode(bad, len(data))


def test_xxh64_and_header_refusals():
    """XXH64's published value for no input; a frame naming a dictionary, a reserved bit, a window past 2^31 and
    a checksum that does not match fail as in libzstd."""
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    data = sample(5, 3000)
    frame = compress(data, 3, checksum=1)
    bad = [frame[:4] + bytes([frame[4] | 1]) + b"\x07" + frame[5:],  # dictionary ID 7
           frame[:4] + bytes([frame[4] | 8]) + frame[5:],  # the reserved bit
           frame[:-1] + bytes([frame[-1] ^ 1]),  # the checksum
           compress(data, 3, True)[:4] + b"\x00\xff" + compress(data, 3, True)[6:]]  # window log 41
    for b in bad:
        assert libzstd_decompress(b, len(data)) is None
        assert twin(zstd.decompress, b, len(data), "f.zst") is None


def test_reference_is_libzstd_1_5_7():
    """The decoder follows libzstd 1.5.7, the version Pillow 12.1's wheel ships."""
    assert libzstd().ZSTD_versionNumber() == 10507


# --- the native decoder (csrc/zstd.cuh in the TIFF library, built by nvcc on the card's machine)


@pytest.mark.gpu
def test_native_is_bit_equal_to_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/tiff.cu is built by nvcc, which is installed there")
    rng = np.random.default_rng(11)
    for k, form in enumerate(chip_smoke.ZSTD_FORMS):
        data = sample(k, int(rng.integers(1, 40000)))
        frame = chip_smoke.zstd_bytes(data, form, seed=k)
        cases = [frame] + [frame[: int(rng.integers(0, len(frame)))] for _ in range(3)]
        for _ in range(6):
            bad = bytearray(frame)
            bad[int(rng.integers(0, len(frame)))] ^= int(rng.integers(1, 256))
            cases.append(bytes(bad))
        for bad in cases:
            for fn, native in ((zstd.decompress, zstd.decompress_native),
                               (zstd.decode_stream, zstd.decode_stream_native)):
                want = twin(fn, bad, len(data), "f.zst")
                if want is None:
                    with pytest.raises(ValueError, match=r"^f\.zst: "):
                        native(bad, len(data), "f.zst")
                else:
                    assert native(bad, len(data), "f.zst") == want
