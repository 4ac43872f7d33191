"""Writers of the rarer formats Pillow reads through its raw decoder or its own Python decoders (McIdas, PIXAR,
SPIDER, XVThumb, GBR, IMT, FTEX, BLP), seeded with numpy, each following its Pillow plugin's `_open`; SPIDER and
BLP palette files also come from Pillow's own writers.  FTEX and BLP are `chip_smoke.ftex_bytes` /
`chip_smoke.blp_bytes` (the card's run writes them too).  Pillow is imported only where a function needs it."""

from __future__ import annotations

import io
import struct

import numpy as np

import chip_smoke


def mcidas_bytes(pixels: np.ndarray, prefix: int = 0, gap: int = 0) -> bytes:
    """A McIdas area file of uint8 / big-endian uint16 / int32 pixels [H, W] (1, 2 or 4 bytes a pixel): the
    64-word directory, then after `gap` bytes each row behind a `prefix` of seeded bytes."""
    h, w = pixels.shape
    nbytes = pixels.dtype.itemsize
    words = [0] * 64
    words[1], words[8], words[9], words[10], words[13], words[14], words[33] = 4, h, w, nbytes, 1, prefix, 256 + gap
    body = pixels.astype({1: ">u1", 2: ">u2", 4: ">i4"}[nbytes]).tobytes()
    rng = np.random.default_rng(h * 1000 + w)
    rows = b"".join(rng.integers(0, 256, prefix, dtype=np.uint8).tobytes() + body[y * w * nbytes:(y + 1) * w * nbytes]
                    for y in range(h))
    return struct.pack(">64i", *words) + bytes(gap) + rows


def pixar_bytes(rgb: np.ndarray, channels: int = 14, depth: int = 2) -> bytes:
    """A PIXAR file of uint8 [H, W, 3], "dumped" at offset 1024."""
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, channels, depth)
    return bytes(head) + rgb.astype(np.uint8).tobytes()


def xvthumb_bytes(indices: np.ndarray, comments=(b"#XVVERSION:Version 2.28  Rev: 9/26/92\n",
                                                 b"#IMGINFO:512x440 Color JPEG\n", b"#END_OF_COMMENTS\n")) -> bytes:
    """An XV thumbnail of 3-3-2 palette indices uint8 [H, W]."""
    h, w = indices.shape
    return b"P7 332\n" + b"".join(comments) + b"%d %d 255\n" % (w, h) + indices.astype(np.uint8).tobytes()


def gbr_bytes(pixels: np.ndarray, version: int = 2, comment: bytes = b"brush\0") -> bytes:
    """A GIMP brush of uint8 [H, W] (grey) or [H, W, 4] (RGBA)."""
    h, w = pixels.shape[:2]
    depth = 1 if pixels.ndim == 2 else 4
    head = (28 if version == 2 else 20) + len(comment)
    out = struct.pack(">5I", head, version, w, h, depth)
    if version == 2:
        out += b"GIMP" + struct.pack(">I", 25)
    return out + comment + pixels.astype(np.uint8).tobytes()


def imt_bytes(grey: np.ndarray, lines=(b"* IM Tools\n",)) -> bytes:
    """An IM Tools file of uint8 [H, W]: "key value" lines, a form feed, the pixels."""
    h, w = grey.shape
    head = b"".join(lines) + b"width %d\nheight %d\npixel n8\n" % (w, h)
    return head + b"\x0c" + grey.astype(np.uint8).tobytes()


def spider_bytes(values: np.ndarray, order: str = ">") -> bytes:
    """A SPIDER image of float32 [H, W] as SpiderImagePlugin's makeSpiderHeader lays it out (header records of a
    row's bytes, at least 1024 bytes of header), in byte order `order` (Pillow's save writes its machine's)."""
    h, w = values.shape
    lenbyt = 4 * w
    labrec = -(-1024 // lenbyt)
    hdr = [0.0] * (labrec * lenbyt // 4)
    hdr[1], hdr[2], hdr[3], hdr[5], hdr[12], hdr[13], hdr[22], hdr[23] = 1, h, h, 1, w, labrec, labrec * lenbyt, lenbyt
    hdr = hdr[1:] + [0.0]
    return struct.pack(f"{order}{len(hdr)}f", *hdr) + values.astype(f"{order}f4").tobytes()


def pillow_spider(grey: np.ndarray, scale: float = 1.0) -> bytes:
    """Pillow's SPIDER save of a float image (the grey values times `scale`)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(grey.astype(np.float32) * np.float32(scale), "F").save(buf, "SPIDER")
    return buf.getvalue()


def pillow_blp(rgb: np.ndarray, version: str = "BLP2", colours: int = 64) -> bytes:
    """Pillow's BLP save of an RGB image quantised to a palette."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).quantize(colours).save(buf, "BLP", blp_version=version)
    return buf.getvalue()


def image(seed: int, w: int, h: int) -> np.ndarray:
    return chip_smoke.raw_image(seed, w, h)


def corpus(seed: int = 0) -> dict:
    """name -> file bytes: every form of the eight formats at a small size, seeded."""
    rng = np.random.default_rng(seed)
    rgb = image(seed, 37, 23)
    grey = rgb[..., 1]
    big = rng.integers(0, 70000, (23, 37)).astype(np.int64)
    files = {
        "mcidas_l.area": mcidas_bytes(grey),
        "mcidas_l_prefix.area": mcidas_bytes(grey, prefix=5, gap=3),
        "mcidas_i16.area": mcidas_bytes((big % 600).astype(np.uint16)),
        "mcidas_i32.area": mcidas_bytes((big - 20000).astype(np.int32), prefix=2),
        "pixar.pxr": pixar_bytes(rgb),
        "spider.spi": pillow_spider(grey, 1.3),
        "spider_signed.spi": pillow_spider(grey.astype(np.float32) - 60.5, 1.0),
        "spider_big_endian.spi": spider_bytes(grey.astype(np.float32) * 2.5 - 100),
        "xvthumb.p7": xvthumb_bytes(rng.integers(0, 256, (23, 37))),
        "gbr_v1.gbr": gbr_bytes(grey, 1, b"v1\0"),
        "gbr_v2_grey.gbr": gbr_bytes(grey),
        "gbr_v2_rgba.gbr": gbr_bytes(np.concatenate([rgb, grey[..., None]], axis=2), 2, b"a longer brush name\0"),
        "imt.imt": imt_bytes(grey),
        "ftex_bc1.ftc": chip_smoke.ftex_bytes(37, 23, 0, chip_smoke.dxt1_encode(rgb)),
        "ftex_rgb.ftu": chip_smoke.ftex_bytes(37, 23, 1, rgb.tobytes()),
        "blp1_pillow.blp": pillow_blp(rgb, "BLP1"),
        "blp2_pillow.blp": pillow_blp(rgb, "BLP2"),
    }
    files.update({f"{form}.blp": chip_smoke.blp_bytes(form, rgb, np.random.default_rng(seed + k))
                  for k, form in enumerate(chip_smoke.BLP_FORMS)})
    return files


def pillow_pgm(grey: np.ndarray) -> bytes:
    """Pillow's PGM save of a grey image."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(grey).save(buf, "PPM")
    return buf.getvalue()


def fits_pcd_fli_iptc(seed: int = 0) -> dict:
    """name -> file bytes: every form of FITS, FLI / FLC, PCD and IPTC at a small size (PCD's base image is
    always 768 x 512), seeded; the samples of each FITS form are ones Pillow's reading puts inside 0-255."""
    rng = np.random.default_rng(seed)
    rgb = image(seed, 37, 23)
    grey = rgb[..., 1]
    idx = (grey // 8).astype(np.uint8)
    w, h = 37, 23
    files = {f"fits_{name}.fits": chip_smoke.fits_bytes(chip_smoke.fits_samples(grey, bitpix, rng), bitpix, w, h)
             for name, bitpix in (("8", 8), ("16", 16), ("32", 32), ("m32", -32), ("m64", -64))}
    files["fits_naxis1.fits"] = chip_smoke.fits_bytes(grey[:, 0].tobytes(), 8, 1, h, naxis=1)
    files["fits_naxis3.fits"] = chip_smoke.fits_bytes(grey[::-1].tobytes(), 8, w, h, naxis=3,
                                                      cards=(chip_smoke.fits_card("COMMENT"),))
    for name, bits, keep in (("8", 8, 1), ("16", 16, 2), ("32", 32, 4)):
        groups = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        groups[..., 4 - keep :] = 0
        groups[..., 4 - keep] = grey[::-1]  # the first kept byte: Pillow reads them little-endian
        files[f"fits_gzip_{name}.fits"] = chip_smoke.fits_gzip_bytes(groups.tobytes(), bits, w, h)
    files.update({f"{form}.fli": chip_smoke.fli_bytes(form, idx[:, :36] if "odd" not in form else idx, rng)
                  for form in chip_smoke.FLI_FORMS})
    big = image(seed + 1, 768, 512)
    for orientation in (0, 1, 3):
        files[f"pcd_{orientation}.pcd"] = chip_smoke.pcd_bytes(big, orientation, rng)
    files["iptc_raw.iim"] = chip_smoke.iptc_bytes(grey.tobytes(), w, h, pieces=3)
    files["iptc_raw_rgb_band2.iim"] = chip_smoke.iptc_bytes(grey.tobytes(), w, h, layers=3, component=1, band=2)
    files["iptc_raw_cmyk_band4.iim"] = chip_smoke.iptc_bytes(grey.tobytes(), w, h, layers=4, component=1, band=4)
    files["iptc_jpeg.iim"] = chip_smoke.iptc_bytes(chip_smoke.jpeg_bytes(rgb, 85), w, h, compression=5, pieces=2)
    files["iptc_jpeg_grey_band1.iim"] = chip_smoke.iptc_bytes(chip_smoke.jpeg_bytes(grey, 85), w, h, layers=3,
                                                             component=1, band=1, compression=5)
    files["iptc_pgm.iim"] = chip_smoke.iptc_bytes(pillow_pgm(grey), w, h, compression=5)
    return files
