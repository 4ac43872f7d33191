"""The damaged-JPEG corpus (tests/data/jpeg_damage/, written by scripts/make_damaged_jpegs.py) and the
writers it is made with: seeded pictures saved by Pillow in the forms M-BEIR's sources hold (baseline 4:4:4
and 4:2:0, grey, CMYK, progressive, restart intervals) and by chip_smoke.py's arithmetic and lossless (SOF3,
grey and RGB with restart intervals) writers, each
damaged by `chip_smoke.jpeg_damage`; a grey baseline file of chosen quantised coefficients
(`coefficient_jpeg`: DC differences of every category up to 15, AC values up to 15 bits, 8- or 16-bit
quantisers), whose products leave 16 bits; and files Pillow refuses.  Pillow is imported only where a
function needs it."""

from __future__ import annotations

import io

import numpy as np

import chip_smoke

# natural-order index of each zigzag position
ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7,
          14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
          53, 60, 61, 54, 47, 55, 62, 63]


def photo(seed: int, h: int, w: int, grain: int = 10) -> np.ndarray:
    """A picture that compresses as a photograph does: gradients, a disc, stripes and seeded grain."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    r = xx * 255 // max(w - 1, 1)
    g = yy * 255 // max(h - 1, 1)
    disc = ((xx - w * 0.6) ** 2 + (yy - h * 0.4) ** 2 < (min(h, w) * 0.3) ** 2) * 90
    b = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 13.0)).astype(np.int64) + disc
    a = np.stack([r, g, b], -1) + rng.integers(-grain, grain + 1, (h, w, 3))
    return np.clip(a, 0, 255).astype(np.uint8)


def pillow_jpeg(array: np.ndarray, mode: str = "RGB", **save) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(array).convert(mode).save(buf, "JPEG", **save)
    return buf.getvalue()


def pillow_outcome(data: bytes):
    """Pillow's `Image.open(...).convert("RGB")` of `data`: the pixels, or the class name of its error."""
    from PIL import Image

    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as err:  # noqa: BLE001 -- what Pillow raises is the outcome
        return type(err).__name__


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def coefficient_jpeg(blocks: np.ndarray, q: np.ndarray) -> bytes:
    """A grey baseline JPEG of quantised coefficients `blocks` [rows, columns, 64] (natural order, int16
    values) and the quantisation table `q` [64] (natural order; 16-bit DQT where a value passes 255), with
    Huffman tables of every DC category 0-15 (5-bit codes) and every AC run / size (8-bit codes), so any
    coefficient a 16-bit JCOEF holds is written as it is."""
    rows, cols = blocks.shape[:2]
    ac_symbols = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 16)]
    dht = bytes([0x00, 0, 0, 0, 0, 16] + [0] * 11) + bytes(range(16))
    dht += bytes([0x10] + [0] * 7 + [len(ac_symbols)] + [0] * 8) + bytes(ac_symbols)
    qz = [int(q[ZIGZAG[k]]) for k in range(64)]
    dqt = bytes([0x10]) + b"".join(v.to_bytes(2, "big") for v in qz) if max(qz) > 255 else bytes([0]) + bytes(qz)
    sof = bytes([8]) + (8 * rows).to_bytes(2, "big") + (8 * cols).to_bytes(2, "big") + bytes([1, 1, 0x11, 0])
    codes, pred = [], 0

    def value(v: int) -> None:
        s = abs(v).bit_length()
        codes.append((v if v >= 0 else v + (1 << s) - 1, s))

    for block in blocks.reshape(-1, 64):
        block = [int(v) for v in block]
        diff = ((block[0] - pred + 32768) & 0xFFFF) - 32768  # the decoder keeps the DC in 16 bits
        pred = block[0]
        codes.append((abs(diff).bit_length(), 5))
        if diff:
            value(diff)
        zz = [block[ZIGZAG[k]] for k in range(64)]
        last = max([k for k in range(1, 64) if zz[k]] or [0])
        run = 0
        for k in range(1, last + 1):
            if not zz[k]:
                run += 1
                continue
            while run > 15:
                codes.append((ac_symbols.index(0xF0), 8))
                run -= 16
            codes.append((ac_symbols.index((run << 4) | abs(zz[k]).bit_length()), 8))
            value(zz[k])
            run = 0
        if last < 63:
            codes.append((0, 8))
    acc, n, out = 0, 0, bytearray()
    for v, bits in codes + [(0x7F, (-sum(b for _, b in codes)) % 8)]:  # padded with 1 bits to a byte
        acc, n = (acc << bits) | (v & ((1 << bits) - 1)), n + bits
        while n >= 8:
            n -= 8
            out.append((acc >> n) & 0xFF)
            if out[-1] == 0xFF:
                out.append(0)
    return (b"\xff\xd8" + _segment(0xDB, dqt) + _segment(0xC0, sof) + _segment(0xC4, dht)
            + _segment(0xDA, bytes([1, 1, 0x00, 0, 63, 0])) + bytes(out) + b"\xff\xd9")


def extreme_blocks(seed: int, rows: int, cols: int) -> np.ndarray:
    """Seeded quantised blocks whose products with 8-bit quantisers leave 16 bits: DCs of every category up
    to 15, some blocks of a first row only (the SIMD IDCT's shortcut), the others with a few AC values up to
    15 bits."""
    rng = np.random.default_rng(seed)
    blocks = np.zeros((rows, cols, 64), np.int64)
    for r in range(rows):
        for c in range(cols):
            blocks[r, c, 0] = int(rng.integers(-32767, 32768)) >> int(rng.integers(0, 15))
            if (r + c) % 3 == 0:
                blocks[r, c, 1:8] = rng.integers(-3000, 3001, 7)
            else:
                at = rng.choice(np.arange(1, 64), int(rng.integers(1, 7)), replace=False)
                blocks[r, c, at] = rng.integers(-32767, 32768, len(at)) >> rng.integers(0, 12, len(at))
    return blocks


def clean_sources() -> dict:
    """The clean files the damaged ones and the seeded derivatives are made from: name -> bytes."""
    small = photo(1, 64, 96)
    return {
        "clean_b444": pillow_jpeg(small, quality=90, subsampling=0),
        "clean_b420": pillow_jpeg(photo(2, 72, 96), quality=85),
        "clean_grey": pillow_jpeg(photo(3, 64, 80), "L", quality=85),
        "clean_cmyk": pillow_jpeg(photo(4, 56, 72), "CMYK", quality=85),
        "clean_prog": pillow_jpeg(small, quality=85, progressive=True),
        "clean_rst": pillow_jpeg(photo(5, 64, 96), quality=85, restart_marker_blocks=3),
        "clean_prog_rst": pillow_jpeg(photo(6, 64, 96), quality=85, progressive=True, restart_marker_blocks=2),
        "clean_arith": chip_smoke.jpeg_bytes(photo(7, 64, 80), 85, restart=3, coding="arithmetic"),
        "clean_arith_prog": chip_smoke.jpeg_bytes(photo(8, 64, 80), 85, coding="arithmetic", progressive=True),
        "clean_lossless_grey": chip_smoke.jpeg_bytes(photo(13, 60, 72)[..., 1], coding="lossless", predictor=4,
                                                     point_transform=1, restart=3),
        "clean_lossless_rgb": chip_smoke.jpeg_bytes(photo(14, 48, 64), form="rgb", coding="lossless", predictor=7,
                                                    restart=2),
    }


# the damaged files: (name, source, kinds of `chip_smoke.jpeg_damage` applied in turn)
DAMAGED = [(f"{form}_{kind}", f"clean_{form}", (kind,)) for form, kinds in (
    ("b444", ("flip", "zeros", "cut", "tail_zero", "junk_segment", "junk_eoi")),
    ("b420", ("flip", "zeros", "cut", "tail_zero", "junk_segment")),
    ("grey", ("flip", "zeros", "cut")),
    ("cmyk", ("flip", "zeros", "cut")),
    ("prog", ("flip", "zeros", "cut", "tail_zero", "junk_segment", "junk_eoi")),
    ("rst", ("flip", "zeros", "rst_missing", "rst_repeated", "rst_wrong", "rst_marker")),
    ("prog_rst", ("flip", "rst_missing", "rst_wrong", "cut")),
    ("arith", ("flip", "zeros", "rst_missing", "cut")),
    ("arith_prog", ("flip", "cut")),
    ("lossless_grey", ("flip", "zeros", "cut", "rst_missing")),
    ("lossless_rgb", ("flip", "zeros", "cut", "rst_missing")),
) for kind in kinds]


def refused(sources: dict) -> dict:
    """Files Pillow refuses: a scan cut with no EOI after it, an unknown marker in a baseline scan, a Huffman
    table whose last code is all ones, a DC table with symbol 16, a second SOI after the scan."""
    b420 = sources["clean_b420"]
    lo, hi = chip_smoke.jpeg_scan_span(b420)
    mid = (lo + hi) // 2
    dht = b420.index(b"\xff\xc4")
    all_ones = bytearray(b420)  # the first DC table: codes 0, 10 and 11, the last all ones
    all_ones[dht + 5 : dht + 21] = bytes([1, 2, 9] + [0] * 13)
    symbol_16 = bytearray(b420)
    symbol_16[dht + 21] = 16  # the first DC table's first symbol
    return {"refused_truncated_no_eoi": b420[:mid], "refused_unknown_marker": b420[:mid] + b"\xff\x12" + b420[mid:],
            "refused_dht_all_ones": bytes(all_ones), "refused_dc_symbol_16": bytes(symbol_16),
            "refused_second_soi": b420[:hi] + b"\xff\xd8" + b420[hi:]}


def decodable(source: bytes, kinds: tuple, seed: int):
    """`source` damaged by `kinds` from the first seed on at which Pillow still decodes the result: (bytes, seed)."""
    while True:
        rng = np.random.default_rng(seed)
        data = source
        for kind in kinds:
            data = chip_smoke.jpeg_damage(data, kind, rng)
        if not isinstance(pillow_outcome(data), str):
            return data, seed
        seed += 1


def corpus() -> dict:
    """name -> bytes of every corpus file, in a fixed order (each damage seeded by the file's place)."""
    sources = clean_sources()
    out = {f"{name}.jpg": data for name, data in sources.items()}
    for k, (name, source, kinds) in enumerate(DAMAGED):
        rng = np.random.default_rng(1000 + k)
        data = sources[source]
        for kind in kinds:
            data = chip_smoke.jpeg_damage(data, kind, rng)
        out[f"{name}.jpg"] = data
    out["coef_extreme_q8.jpg"] = coefficient_jpeg(extreme_blocks(1, 6, 8), np.random.default_rng(2).integers(1, 256, 64))
    out["coef_extreme_q16.jpg"] = coefficient_jpeg(extreme_blocks(3, 4, 6),
                                                   np.random.default_rng(4).integers(1, 65536, 64))
    out.update({f"{name}.jpg": data for name, data in refused(sources).items()})
    vga = pillow_jpeg(photo(9, 480, 640), quality=85)
    out["clean_vga_420.jpg"] = vga
    out["vga_420_flips.jpg"] = decodable(vga, ("flip", "flip", "flip"), 2000)[0]
    out["vga_420_zeros.jpg"] = decodable(vga, ("zeros",), 3000)[0]
    out["vga_restart_rst_missing.jpg"] = decodable(pillow_jpeg(photo(10, 480, 640), quality=85, restart_marker_rows=1),
                                                   ("rst_missing",), 4000)[0]
    out["hd_420_flips_zeros.jpg"] = decodable(pillow_jpeg(photo(11, 1080, 1920), quality=80),
                                              ("flip", "flip", "zeros"), 5000)[0]
    return out
