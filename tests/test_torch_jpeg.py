"""The JPEG decoders (`uniir_tpu_torch.data.jpeg`): the twin bit-equal to
Pillow's `Image.open(...).convert("RGB")` (libjpeg-turbo at its defaults) on
Pillow-made files of every accepted form, baseline and progressive, and on
the colour spaces beyond YCbCr (CMYK and YCCK under Adobe markers, RGB by
Adobe transform 0 or by component ids; chip_smoke.py's writer and Pillow's
own CMYK and `keep_rgb` files), the rejected forms raising, the JPEG writer
of chip_smoke.py readable by Pillow, and (`-m gpu`, on the card's machine,
where nvcc builds csrc/jpeg.cu) the native decoder bit-equal to the twin and
to Pillow's digests.

The module imports no JAX and no Pillow at its top, so its `-m gpu` cases
collect with `--noconftest` on a machine that has neither."""

import base64
import hashlib
import io
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
from uniir_tpu_torch.data import jpeg

# Pillow-made JPEG files (base64) and the sha256 of Pillow's RGB pixels of each, made where Pillow
# is installed: the card's machine has none, so its decoders are held to these digests
PILLOW_FILES = {
    "rgb_420_q75_17x9": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAx"
        "NDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
        "MjIyMjIyMjL/wAARCAAJABEDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUF"
        "BAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVW"
        "V1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi"
        "4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAEC"
        "AxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVm"
        "Z2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq"
        "8vP09fb3+Pn6/9oADAMBAAIRAxEAPwDyWOxk5gUAP1IIIwOO3PpW7Z2TGDYiHJO7lOQ2eg6nj2qOP/j2T/rgv/slb8f+sl/30/ka"
        "9CNaV7P+tv8AM9HA1HflX9WKf2VfWP8A75P/AMVRXQ0V6Ptanc9L67UP/9k=",
        "ca42b47b239669e98a1aa6fa01809af54aa836d4e19d4821455c18e1482f2d05", 17, 9),
    "rgb_444_q95_8x8": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAIBAQEBAQIBAQECAgICAgQDAgICAgUEBAMEBgUGBgYFBgYGBwkIBgcJBwYGCAsICQoK"
        "CgoKBggLDAsKDAkKCgr/2wBDAQICAgICAgUDAwUKBwYHCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoK"
        "CgoKCgoKCgr/wAARCAAIAAgDAREAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUF"
        "BAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVW"
        "V1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi"
        "4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAEC"
        "AxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVm"
        "Z2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq"
        "8vP09fb3+Pn6/9oADAMBAAIRAxEAPwD8lfh/8JNX1PUrbUNQtvsFzJdCSJWRrXfEGRiYl2lwFUS/MgckZYg8Bf2WnjqUqblQqt8s"
        "W1e1RxjK6S96+7b99tWScVKMVyw9Ph3Fxlm8KFTSDV21eS5pWtCT3g0/ccZuDnJxs5Jty//Z",
        "c2f2eb3dde4a3c9eef4243a5ad208ed44f1140e7a5d49304f3ee6e94abfe9384", 8, 8),
    "rgb_422_q10_33x17": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAFA3PEY8MlBGQUZaVVBfeMiCeG5uePWvuZHI////////////////////////////////"
        "////////////////////2wBDAVVaWnhpeOuCguv/////////////////////////////////////////////////////////////"
        "////////////wAARCAARACEDASEAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUF"
        "BAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVW"
        "V1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi"
        "4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAEC"
        "AxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVm"
        "Z2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq"
        "8vP09fb3+Pn6/9oADAMBAAIRAxEAPwCsBTwtXcqI4LSOOcCqiXJ+6MwP8mitDEeFp4FcyZcR2MDNRYya0iKb2Q7afWiquTzAP6U9"
        "eorDoUhX/wBWaiXrWkdhT3JaKok//9k=",
        "9d1aae09cdf629477a15bea0825f7a808e47d8225b5e1720dfa332048669774b", 33, 17),
    "grey_q75_13x7": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAx"
        "NDQ0Hyc5PTgyPC4zNDL/wAALCAAHAA0BAREA/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUF"
        "BAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVW"
        "V1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi"
        "4+Tl5ufo6erx8vP09fb3+Pn6/9oACAEBAAA/APJrK2Bdsthw5Tg9OvtzyP8APNaAtfs8Y3bi5PzBAOOB3Jr/2Q==",
        "4b4a65137438140e9ae4bfe8ef2afbb357086e00d4065bd1fd6bc1a5ed25189c", 13, 7),
    "rgb_420_optimized_restart_40x24": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAYEBQYFBAYGBQYHBwYIChAKCgkJChQODwwQFxQYGBcUFhYaHSUfGhsjHBYWICwgIyYn"
        "KSopGR8tMC0oMCUoKSj/2wBDAQcHBwoIChMKChMoGhYaKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgo"
        "KCgoKCgoKCj/wAARCAAYACgDASIAAhEBAxEB/8QAFwABAQEBAAAAAAAAAAAAAAAAAAUGB//EACkQAAIBAgUEAgIDAQAAAAAAAAEC"
        "EQMEAAUSIUETMVFhInEGoTJSgZH/xAAXAQEAAwAAAAAAAAAAAAAAAAAFBAYH/8QAKhEAAQMDAgMIAwAAAAAAAAAAAQACAwQFESFx"
        "MUGxBhITFCJRUmGB0fD/3QAEAAL/2gAMAwEAAhEDEQA/AOE2WWqdTVAGbSWWBpniPrtjSW2VNTFFKpem7iJ6b6oJ8Tzv3/W2KNll"
        "zlUhAYQKKejgxAGw3nzxx4vWuXB6y9NKZ61EPEEGACYB8cRzhCOv+R0StplaR6tMKbZWOoKpQpUJJXcdu0CREdt+MSPyzTc3yWCJ"
        "orW66nSS0sY0rBPC7yP7H3jpdS0o2lDq1mo9GkSCvVAJ0gmIHMgciSfQnAW2XNeu1zXg1ahNR+qNOoSWkRHdt4n/ALiy2Wp77zIe"
        "SQ7R3dsFKykZxfqdh+z0K//Q5TluVoxgvtEhgCd+I99tvJPoYY3OWZc7VCiajTVpUzMcEr5MAntz2PYsbB588lPo3Ex5Az+cKtlu"
        "TLrpU2QuZ0FWqAhztvHg/L3vztjRZTlzInzhKcHdQxltvjqP0JPH7wwxgMMz34B+uqi2t5zsV//Rpfl1Dp29pb25cLWGtxTJEkGB"
        "tpIC/wApUSSYPffEywy0taIwoo6gEkFIDgn7+J9kb/7hhhm0yObAwD3VZu1ZLJdJS48DgbAfx3JV2wy41EGtKcj4lZ+R3G5kAmYm"
        "fX1hhhhnxn5OqfbUviY0NX//2Q==",
        "8b4a1aae035d74663a0bbe054c271b0ce3ebafd0ec4b666cf507ea812a95e6e9", 40, 24),
    "rgb_420_q75_3x5": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAx"
        "NDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
        "MjIyMjIyMjL/wAARCAAFAAMDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUF"
        "BAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVW"
        "V1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi"
        "4+Tl5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAEC"
        "AxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVm"
        "Z2hpanN0dXZ3eHl6goOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq"
        "8vP09fb3+Pn6/9oADAMBAAIRAxEAPwDx6OBDGvLfgxFFFFerztGfKv6bP//Z",
        "0cdb100c69e88ebe191aa2bf0b1c491c40c7540483d83237f027a9206cc64d6e", 3, 5),
}


def smooth_image(rng, w: int, h: int, noise: float = 25.0) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 9 + yy * 4) % 256, (yy * 7) % 256, (xx * 5 + 60) % 256], axis=2)
    return np.clip(base + rng.normal(0, noise, base.shape), 0, 255).astype(np.uint8)


def pillow_jpeg(arr: np.ndarray, **save) -> tuple:
    """(file bytes, Pillow's RGB pixels of them)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **save)
    data = buf.getvalue()
    return data, np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


SIZES = [(1, 1), (2, 2), (3, 5), (8, 8), (9, 17), (16, 16), (17, 9), (33, 17), (64, 48), (100, 75), (517, 263)]


@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_twin_is_bit_equal_to_pillow(size, subsampling, quality):
    rng = np.random.default_rng(size[0] * 1000 + size[1] + quality)
    data, ref = pillow_jpeg(smooth_image(rng, *size), quality=quality, subsampling=subsampling)
    got = jpeg.decode_twin(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("form", ["greyscale", "optimize", "restart_blocks", "restart_rows", "odd_restart"])
@pytest.mark.parametrize("size", [(1, 1), (13, 7), (64, 48), (517, 263)], ids=["1x1", "13x7", "64x48", "517x263"])
def test_twin_is_bit_equal_to_pillow_on_other_forms(size, form):
    """Greyscale (copied into three channels), Pillow's optimized Huffman
    tables, and restart intervals (also ones that do not divide the MCU count)."""
    from PIL import Image

    arr = smooth_image(np.random.default_rng(size[0] + size[1]), *size)
    save = {"greyscale": {}, "optimize": {"optimize": True}, "restart_blocks": {"restart_marker_blocks": 3},
            "restart_rows": {"restart_marker_rows": 1}, "odd_restart": {"restart_marker_blocks": 7, "optimize": True}}
    if form == "greyscale":
        buf = io.BytesIO()
        Image.fromarray(arr).convert("L").save(buf, "JPEG")
        data = buf.getvalue()
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    else:
        data, ref = pillow_jpeg(arr, **save[form])
    np.testing.assert_array_equal(jpeg.decode_twin(data), ref)


@pytest.mark.parametrize("name", sorted(PILLOW_FILES))
def test_twin_matches_pillow_digest(name):
    data, digest, w, h = base64.b64decode(PILLOW_FILES[name][0]), *PILLOW_FILES[name][1:]
    out = jpeg.decode_twin(data, name)
    assert out.shape == (h, w, 3)
    assert hashlib.sha256(out.tobytes()).hexdigest() == digest


@pytest.mark.parametrize("restart", [0, 3], ids=["no_restart", "restart3"])
@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
@pytest.mark.parametrize("size", SIZES[:-1], ids=[f"{w}x{h}" for w, h in SIZES[:-1]])
def test_progressive_twin_is_bit_equal_to_pillow(size, subsampling, quality, restart):
    """Pillow's `progressive=True` (libjpeg's simple progression: spectral
    selection, DC and AC successive approximation, a DHT before each scan),
    with and without restart intervals."""
    rng = np.random.default_rng(size[0] * 1000 + size[1] + quality + restart)
    save = {"progressive": True, "quality": quality, "subsampling": subsampling}
    data, ref = pillow_jpeg(smooth_image(rng, *size), **save, **({"restart_marker_blocks": restart} if restart else {}))
    assert b"\xff\xc2" in data
    np.testing.assert_array_equal(jpeg.decode_twin(data), ref)


@pytest.mark.parametrize("form", ["greyscale", "optimize", "large", "restart_rows"])
def test_progressive_twin_on_other_forms(form):
    from PIL import Image

    arr = smooth_image(np.random.default_rng(len(form)), 517, 263)
    if form == "greyscale":
        buf = io.BytesIO()
        Image.fromarray(arr).convert("L").save(buf, "JPEG", progressive=True)
        data = buf.getvalue()
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    else:
        save = {"optimize": {"optimize": True}, "large": {}, "restart_rows": {"restart_marker_rows": 2}}[form]
        data, ref = pillow_jpeg(arr, progressive=True, **save)
    np.testing.assert_array_equal(jpeg.decode_twin(data), ref)


def test_progressive_fixture_files_match_pillows_digests():
    """chip_smoke.py's progressive files, which the card's decoders are held to."""
    import chip_smoke
    from PIL import Image

    for name, (b64, digest, w, h) in chip_smoke.PROGRESSIVE_FILES.items():
        data = base64.b64decode(b64)
        out = jpeg.decode_twin(data, name)
        assert out.shape == (h, w, 3) and hashlib.sha256(out.tobytes()).hexdigest() == digest
        np.testing.assert_array_equal(out, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    at = data.index(marker) + offset
    return data[:at] + bytes([value]) + data[at + 1 :]


def _partial_progression(data: bytes) -> bytes:
    """A progressive file cut after its third scan, then EOI: low AC
    coefficients left unrefined, which libjpeg decodes with block smoothing."""
    sos = [i for i in range(len(data) - 1) if data[i : i + 2] == b"\xff\xda"]
    cut = data.rfind(b"\xff\xc4", sos[2], sos[3])
    return data[: cut if cut > 0 else sos[3]] + b"\xff\xd9"


def _two_components(base: bytes) -> bytes:
    """A baseline frame header cut to its first two components."""
    at = base.index(b"\xff\xc0")
    return base[:at] + b"\xff\xc0\x00\x0e" + base[at + 4 : at + 9] + b"\x02" + base[at + 10 : at + 16] + base[at + 19 :]


def _rejected():
    arr = smooth_image(np.random.default_rng(5), 40, 30)
    base, _ = pillow_jpeg(arr)
    progressive, _ = pillow_jpeg(arr, progressive=True)
    scan = base.index(b"\xff\xda")
    return {
        "two_components": (_two_components(base), r"0xFFC0.*2 components"),
        "mcu_too_large": (chip_smoke.jpeg_bytes(arr, form="rgb", factors=[(2, 2)] * 3), r"0xFFDA.*more than 10 blocks"),
        # a baseline scan (0..63) under a lossless frame header: jdlossls.c's bad scan parameters
        "sof3_lossless": (_patched(base, b"\xff\xc0", 1, 0xC3), r"0xFFDA.*bad lossless scan"),
        "twelve_bit": (_patched(base, b"\xff\xc0", 4, 12), r"0xFFC0.*12-bit"),
        "short_adobe": (base[:2] + b"\xff\xee\x00\x07Adobe" + base[2:], r"0xFFEE: truncated Adobe"),
        "truncated_scan": (base[: scan + (len(base) - scan) // 2], r"truncated"),
        "truncated_header": (base[:100], r"truncated"),
        "not_a_jpeg": (b"\x89PNG\r\n\x1a\n" + base[8:], r"no SOI"),
        # a baseline scan (0..63, no approximation) in a progressive frame: jdphuff.c's bad progression
        "baseline_scan_in_sof2": (_patched(base, b"\xff\xc0", 1, 0xC2), r"0xFFDA.*bad progression"),
        "progressive_twelve_bit": (_patched(progressive, b"\xff\xc2", 4, 12), r"0xFFC2.*12-bit"),
        "truncated_progressive": (progressive[: len(progressive) // 2], r"truncated"),
        # SOF11 (arithmetic lossless), which libjpeg-turbo does not implement either
        "sof11_lossless_arithmetic": (_patched(chip_smoke.jpeg_bytes(arr, coding="lossless", form="rgb"),
                                               b"\xff\xc3", 1, 0xCB), r"0xFFCB.*SOF11"),
        # libjpeg refuses to convert lossless YCbCr samples (a lossy conversion)
        "lossless_ycbcr": (chip_smoke.jpeg_bytes(arr, coding="lossless"), r"0xFFC3.*lossless YCBCR"),
    }


@pytest.mark.parametrize("form", ["sof3_lossless", "twelve_bit", "two_components", "mcu_too_large", "short_adobe",
                                  "truncated_scan", "truncated_header", "not_a_jpeg", "baseline_scan_in_sof2",
                                  "progressive_twelve_bit", "truncated_progressive", "sof11_lossless_arithmetic",
                                  "lossless_ycbcr"])
def test_rejected_forms_raise_naming_file_and_marker(form):
    data, pattern = _rejected()[form]
    with pytest.raises(ValueError, match=rf"^f\.jpg: .*{pattern}"):
        jpeg.decode_twin(data, "f.jpg")


@pytest.mark.parametrize("form", ["sof3_lossless", "twelve_bit", "progressive_twelve_bit", "two_components",
                                  "sof11_lossless_arithmetic", "lossless_ycbcr", "truncated_scan"])
def test_pillow_refuses_what_the_port_refuses(form):
    """Parity, not a fault: 12-bit samples (Pillow: "cannot handle 12-bit layers"), SOF11, lossless YCbCr,
    a lossless frame over baseline scans and the truncated / malformed files raise in Pillow too."""
    data, _ = _rejected()[form]
    with pytest.raises(Exception):
        pillow_rgb(data)


def pillow_rgb(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _once_refused():
    """Forms the decoders refused before: a Pillow CMYK file, and an Adobe
    transform-0 (RGB) marker before a JFIF file's own, whose JFIF marker still
    makes libjpeg read YCbCr; SOF1, arithmetic coding and block smoothing."""
    from PIL import Image

    arr = smooth_image(np.random.default_rng(5), 40, 30)
    base, _ = pillow_jpeg(arr)
    buf = io.BytesIO()
    Image.fromarray(arr).convert("CMYK").save(buf, "JPEG")
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"  # APP14, transform 0: RGB
    progressive, _ = pillow_jpeg(arr, progressive=True)
    return {"four_components": buf.getvalue(), "adobe_rgb": base[:2] + adobe + base[2:],
            # SOF1 decodes as baseline; the baseline file patched to SOF9 is arithmetic decoding of Huffman data
            # (a bad code early: libjpeg warns and leaves the rest of the scan zero); a progression cut after its
            # third scan is smoothed (jdcoefct.c's decompress_smooth_data)
            "sof1_extended": _patched(base, b"\xff\xc0", 1, 0xC1),
            "arithmetic": _patched(base, b"\xff\xc0", 1, 0xC9),
            "block_smoothing": _partial_progression(progressive)}


@pytest.mark.parametrize("form", ["four_components", "adobe_rgb", "sof1_extended", "arithmetic", "block_smoothing"])
def test_forms_once_refused_decode_as_pillow_does(form):
    data = _once_refused()[form]
    np.testing.assert_array_equal(jpeg.decode_twin(data, "f.jpg"), pillow_rgb(data))


COLOUR_SIZES = [(1, 1), (3, 2), (8, 8), (17, 9), (33, 18), (64, 48), (97, 64)]
# chip_smoke.py's writer: (form, per-component sampling or None for its default)
COLOUR_FORMS = {
    "cmyk_444": ("cmyk", None), "cmyk_420_k": ("cmyk", [(2, 2), (1, 1), (1, 1), (2, 2)]),
    "cmyk_422": ("cmyk", [(2, 1), (1, 1), (1, 1), (1, 1)]), "ycck_420": ("ycck", None),
    "ycck_444": ("ycck", [(1, 1)] * 4), "ycck_440": ("ycck", [(1, 2), (1, 2), (1, 1), (1, 2)]),
    "rgb_adobe": ("rgb", None), "rgb_adobe_420": ("rgb", [(2, 2), (1, 1), (1, 1)]),
    "rgb_ids": ("rgb_ids", None), "rgb_ids_422": ("rgb_ids", [(1, 1), (2, 1), (1, 1)]),
}


@pytest.mark.parametrize("restart", [0, 3], ids=["no_restart", "restart3"])
@pytest.mark.parametrize("form", sorted(COLOUR_FORMS))
@pytest.mark.parametrize("size", COLOUR_SIZES, ids=[f"{w}x{h}" for w, h in COLOUR_SIZES])
def test_colour_forms_are_bit_equal_to_pillow(size, form, restart):
    """CMYK (Adobe transform 0), YCCK (transform 2) and RGB (transform 0, or
    ids 'R' 'G' 'B' without a marker) from chip_smoke.py's writer, at each
    sampling it takes: Pillow's inverted CMYK and cmyk2rgb, bit for bit."""
    import chip_smoke

    kind, factors = COLOUR_FORMS[form]
    arr = smooth_image(np.random.default_rng(size[0] * 7 + size[1]), *size, noise=10)
    if kind in ("cmyk", "ycck"):
        arr = np.concatenate([arr, smooth_image(np.random.default_rng(size[1]), *size)[..., :1]], axis=2)
    data = chip_smoke.jpeg_bytes(arr, 80, restart=restart, form=kind, factors=factors)
    np.testing.assert_array_equal(jpeg.decode_twin(data), pillow_rgb(data))


@pytest.mark.parametrize("kind", ["cmyk", "keep_rgb"])
@pytest.mark.parametrize("save", ["baseline", "progressive", "optimize"])
@pytest.mark.parametrize("size", [(1, 1), (13, 7), (100, 75), (517, 263)], ids=["1x1", "13x7", "100x75", "517x263"])
def test_pillows_cmyk_and_rgb_files(size, save, kind):
    """Pillow's own CMYK files (inverted samples, an Adobe marker) and RGB
    files written with `keep_rgb=True`, baseline, progressive and optimised."""
    from PIL import Image

    arr = smooth_image(np.random.default_rng(size[0] + 3 * size[1]), *size)
    img = Image.fromarray(arr).convert("CMYK") if kind == "cmyk" else Image.fromarray(arr)
    buf = io.BytesIO()
    img.save(buf, "JPEG", **({"progressive": True} if save == "progressive" else {"optimize": True} if save == "optimize"
                             else {}), **({"keep_rgb": True} if kind == "keep_rgb" else {}))
    data = buf.getvalue()
    np.testing.assert_array_equal(jpeg.decode_twin(data), pillow_rgb(data))


def _marker_cases() -> dict:
    import chip_smoke

    rgb, cmyk = smooth_image(np.random.default_rng(2), 40, 30), smooth_image(np.random.default_rng(3), 40, 30)
    cmyk = np.concatenate([cmyk, rgb[..., :1]], axis=2)
    base = chip_smoke.jpeg_bytes(rgb)
    four = chip_smoke.jpeg_bytes(cmyk, form="cmyk")
    at = four.index(b"\xff\xee")

    def adobe(t):
        return b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([t])

    return {  # libjpeg's default_decompress_parms case by case
        "jfif_then_adobe0_is_ycbcr": base[:20] + adobe(0) + base[20:],
        "adobe1_is_ycbcr": base[:2] + adobe(1) + base[20:],
        "adobe2_three_components_is_ycbcr": base[:2] + adobe(2) + base[20:],
        "ids_123_without_markers_is_ycbcr": base[:2] + base[20:],
        "cmyk_without_adobe": four[:at] + four[at + 16 :],
        "four_components_adobe1_is_ycck": four[:at] + adobe(1) + four[at + 16 :],
        "four_components_adobe5_is_ycck": four[:at] + adobe(5) + four[at + 16 :],
        "adobe_too_short_to_read": four[:at] + b"\xff\xee\x00\x0bAdobe\x00\x64\x00\x00" + four[at + 16 :],
        "progressive_cmyk_restart": None,
    }


@pytest.mark.parametrize("case", sorted(_marker_cases()))
def test_colour_space_markers_are_read_as_libjpeg_reads_them(case):
    from PIL import Image

    data = _marker_cases()[case]
    if data is None:
        buf = io.BytesIO()
        Image.fromarray(smooth_image(np.random.default_rng(4), 61, 45)).convert("CMYK").save(
            buf, "JPEG", progressive=True, restart_marker_blocks=2)
        data = buf.getvalue()
    np.testing.assert_array_equal(jpeg.decode_twin(data), pillow_rgb(data))


def test_corrupt_streams_raise_or_decode_never_crash():
    """Random byte flips anywhere in the file (headers, tables, scan data): the twin raises ValueError
    where Pillow raises and otherwise returns Pillow's pixels, nothing else."""
    arr = smooth_image(np.random.default_rng(6), 24, 16)
    data, _ = pillow_jpeg(arr)
    rng = np.random.default_rng(7)
    decoded = 0
    for _ in range(60):
        bad = bytearray(data)
        for at in rng.integers(0, len(bad), size=3):
            bad[at] = int(rng.integers(0, 256))
        try:
            want = pillow_rgb(bytes(bad))
        except Exception:  # noqa: BLE001 -- whatever Pillow raises, the twin raises ValueError
            with pytest.raises(ValueError):
                jpeg.decode_twin(bytes(bad))
            continue
        out = jpeg.decode_twin(bytes(bad))
        assert out.dtype == np.uint8 and out.ndim == 3
        np.testing.assert_array_equal(out, want)
        decoded += 1
    assert decoded >= 20


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (1, 2), (2, 2)], ids=["444", "422", "440", "420"])
@pytest.mark.parametrize("restart", [0, 5])
@pytest.mark.parametrize("size", [(1, 1), (7, 3), (33, 18), (97, 64)], ids=["1x1", "7x3", "33x18", "97x64"])
def test_chip_smoke_writer_decodes_in_pillow_to_the_twins_pixels(size, sampling, restart):
    """chip_smoke.py's seeded writer (its luma 1x2 form is the one Pillow
    cannot write) makes files Pillow reads, to the twin's pixels."""
    import chip_smoke
    from PIL import Image

    arr = smooth_image(np.random.default_rng(size[0] + 3 * size[1]), *size, noise=10)
    data = chip_smoke.jpeg_bytes(arr, 75, sampling, restart)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(jpeg.decode_twin(data), ref)
    if sampling == (2, 2) and restart == 0:
        grey = chip_smoke.jpeg_bytes(arr[..., 1])
        np.testing.assert_array_equal(jpeg.decode_twin(grey), np.asarray(Image.open(io.BytesIO(grey)).convert("RGB")))


def test_chip_smoke_writer_headers_are_pillows():
    """Quality 75, 4:2:0: the JFIF, quantisation, frame and Huffman segments
    are the bytes Pillow writes at its defaults."""
    import chip_smoke

    arr = smooth_image(np.random.default_rng(8), 48, 32)
    ours, (theirs, _) = chip_smoke.jpeg_bytes(arr), pillow_jpeg(arr)
    assert ours[: ours.index(b"\xff\xda")] == theirs[: theirs.index(b"\xff\xda")]


# --- arithmetic coding, lossless frames and block smoothing

ARITH_FORMS = {
    "sequential": {}, "restart2": {"restart": 2}, "progressive": {"progressive": True},
    "progressive_restart3": {"progressive": True, "restart": 3}, "dac": {"dac": {0: (1, 3, 4), 1: (0, 0, 10)}},
    "cmyk": {"form": "cmyk"}, "ycck_progressive": {"form": "ycck", "progressive": True},
    "rgb_restart1": {"form": "rgb", "restart": 1}, "grey": {"grey": True},
    "grey_progressive": {"grey": True, "progressive": True},
}
FORM_SIZES = [(1, 1), (9, 7), (33, 17), (64, 48)]


def _writer_image(w: int, h: int, channels: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    field = np.stack([(xx * (3 + c) + yy * (2 + 2 * c) + 40 * c) % 256 for c in range(channels)], axis=2)
    return np.clip(field + rng.normal(0, 10, field.shape), 0, 255).astype(np.uint8)


def arith_file(form: str, w: int, h: int, seed: int = 0, coding: str = "arithmetic") -> bytes:
    kw = dict(ARITH_FORMS[form])
    grey = kw.pop("grey", False)
    arr = _writer_image(w, h, 4 if kw.get("form") in ("cmyk", "ycck") else 3, seed + w * 100 + h)
    if coding != "arithmetic":
        kw.pop("progressive", None)
        kw.pop("dac", None)
    return chip_smoke.jpeg_bytes(arr[..., 0] if grey else arr, 80, coding=coding, **kw)


@pytest.mark.parametrize("form", sorted(ARITH_FORMS))
@pytest.mark.parametrize("size", FORM_SIZES, ids=[f"{w}x{h}" for w, h in FORM_SIZES])
def test_arithmetic_forms_decode_as_pillow_does(size, form):
    """SOF9 / SOF10 from chip_smoke.py's jcarith.c encoder: Pillow's pixels, which for a sequential file are
    those of the Huffman-coded file of the same coefficients."""
    data = arith_file(form, *size)
    assert data[data.index(b"\xff\xc9" if "progressive" not in form else b"\xff\xca")]
    out = jpeg.decode_twin(data, "f.jpg")
    np.testing.assert_array_equal(out, pillow_rgb(data))
    if "progressive" not in form:
        np.testing.assert_array_equal(out, jpeg.decode_twin(arith_file(form, *size, coding="huffman")))


@pytest.mark.parametrize("form", ["sequential", "progressive_restart3", "cmyk", "restart2"])
def test_corrupt_arithmetic_data_decodes_as_pillow(form):
    """A byte of the arithmetic-coded data changed: libjpeg decodes on (a bad code leaves the rest of its
    restart interval zero) and so does the port, to Pillow's pixels, whatever the damaged data's
    coefficients: past what 8-bit samples give (|coefficient x quantiser| >= 1024) the port computes the 16-bit
    lanes of libjpeg-turbo's SIMD IDCT as Pillow's libjpeg-turbo does."""
    data = arith_file(form, 64, 48, seed=3)
    coded = []  # the entropy-coded bytes of every scan, markers and stuffing left as they are
    for sos in [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]:
        at = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
        while not (data[at] == 0xFF and data[at + 1] not in (0x00,) and not 0xD0 <= data[at + 1] <= 0xD7):
            if data[at] != 0xFF and data[at - 1] != 0xFF and data[at + 1] != 0xFF:
                coded.append(at)
            at += 1
    rng = np.random.default_rng(len(form))
    held = out_of_range = 0
    drawn = rng.choice(coded, size=min(64, len(coded)), replace=False)
    for at in drawn:
        bad = data[:at] + bytes([data[at] ^ 0x6B if data[at] ^ 0x6B != 0xFF else 0x11]) + data[at + 1:]
        frame = jpeg.parse(bad, "f.jpg")
        coefs = jpeg._decode_coefficients(frame, "f.jpg")
        out_of_range += max(int(np.abs(c * frame.latched[i]).max()) for i, c in enumerate(coefs)) >= 1024
        np.testing.assert_array_equal(jpeg.decode_twin(bad, "f.jpg"), pillow_rgb(bad))
        held += 1
    assert held == len(drawn) >= 32 and out_of_range >= 1


LOSSLESS_FORMS = {f"predictor{p}": {"predictor": p} for p in range(1, 8)}
LOSSLESS_FORMS.update({
    "point_transform2": {"predictor": 4, "point_transform": 2, "form": "rgb"},
    "restart_rows2": {"predictor": 7, "restart": 2, "form": "rgb"},
    "subsampled_rgb_ids": {"predictor": 5, "form": "rgb_ids", "factors": [(2, 2), (1, 1), (1, 1)]},
    "rgb_422": {"predictor": 1, "form": "rgb", "factors": [(1, 1), (2, 1), (1, 2)]},
    "cmyk": {"predictor": 3, "form": "cmyk"},
})


@pytest.mark.parametrize("form", sorted(LOSSLESS_FORMS))
@pytest.mark.parametrize("size", FORM_SIZES, ids=[f"{w}x{h}" for w, h in FORM_SIZES])
def test_lossless_forms_decode_as_pillow_does(size, form):
    """SOF3 from chip_smoke.py's writer (greyscale unless a form names one): the seven predictors, the point
    transform, restarts, box upsampling of subsampled components, CMYK."""
    kw = dict(LOSSLESS_FORMS[form])
    arr = _writer_image(*size, 4 if kw.get("form") == "cmyk" else 3, size[0] + size[1])
    data = chip_smoke.jpeg_bytes(arr if "form" in kw else arr[..., 0], coding="lossless", **kw)
    np.testing.assert_array_equal(jpeg.decode_twin(data, "f.jpg"), pillow_rgb(data))


@pytest.mark.parametrize("image", ["noise", "smooth"])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0", "grey"])
@pytest.mark.parametrize("size", [(9, 17), (20, 50), (33, 70), (40, 30), (17, 24)],
                         ids=["9x17", "20x50", "33x70", "40x30", "17x24"])
def test_block_smoothing_as_pillow(size, subsampling, image):
    """Pillow's progressive files cut after each scan (`_partial_progression`'s form): where the scans leave
    zigzag 1-9 unrefined libjpeg smooths the blocks (DC interpolation while no AC is known), and the port
    gives its pixels; the rows near the bottom of a 4:2:0 image are the ones jdcoefct.c's iMCU rows decide."""
    from PIL import Image

    rng = np.random.default_rng(size[0] * 31 + size[1])
    arr = (rng.integers(0, 256, (size[1], size[0], 3), np.uint8) if image == "noise"
           else smooth_image(rng, *size))
    buf = io.BytesIO()
    if subsampling == "grey":
        Image.fromarray(arr).convert("L").save(buf, "JPEG", progressive=True, quality=90)
    else:
        Image.fromarray(arr).save(buf, "JPEG", progressive=True, quality=90, subsampling=subsampling)
    data = buf.getvalue()
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    for k in range(1, len(sos)):
        cut = data.rfind(b"\xff\xc4", sos[k - 1], sos[k])
        part = data[: cut if cut > 0 else sos[k]] + b"\xff\xd9"
        np.testing.assert_array_equal(jpeg.decode_twin(part, "f.jpg"), pillow_rgb(part), err_msg=f"after scan {k}")


@pytest.mark.parametrize("name", sorted(chip_smoke.JPEG_FORM_PILLOW_FILES))
def test_form_files_match_pillows_digests(name):
    """chip_smoke.py's Pillow-made SOF1, arithmetic and smoothed files, which the card's decoders are held to."""
    b64, digest, w, h = chip_smoke.JPEG_FORM_PILLOW_FILES[name]
    data = base64.b64decode(b64)
    out = jpeg.decode_twin(data, name)
    assert out.shape == (h, w, 3) and hashlib.sha256(out.tobytes()).hexdigest() == digest
    np.testing.assert_array_equal(out, pillow_rgb(data))


@pytest.mark.parametrize("colour", [None, "ycbcr", "unknown"])
def test_decode_samples_is_libjpegs_output(colour):
    """decode_samples: RGB for YCbCr, every component as stored under "unknown" (libtiff's JCS_UNKNOWN), the
    stored CMYK of an Adobe file; decode_twin is Pillow's reading of it."""
    arr = _writer_image(19, 11, 3, 4)
    data = chip_smoke.jpeg_bytes(arr, 90, sampling=(1, 1))
    out = jpeg.decode_samples(data, "f.jpg", colour)
    if colour == "unknown":
        ycc = jpeg.decode_samples(data, "f.jpg", "ycbcr")
        assert out.shape == ycc.shape and not np.array_equal(out, ycc)
    else:
        np.testing.assert_array_equal(out, pillow_rgb(data))
    if colour is None:
        cmyk = chip_smoke.jpeg_bytes(_writer_image(19, 11, 4, 5), 90, form="cmyk")
        np.testing.assert_array_equal(jpeg.cmyk_to_rgb(255 - jpeg.decode_samples(cmyk, "f.jpg")), pillow_rgb(cmyk))


def test_decoder_follows_the_runs_device():
    assert jpeg.decoder_for("cpu") is jpeg.decode_twin
    assert jpeg.decoder_for(torch.device("cuda", 0)) is jpeg.decode_native


# --- the native decoder (csrc/jpeg.cu, built by nvcc on the card's machine)


@pytest.fixture
def native():
    if not torch.cuda.is_available():
        pytest.skip("needs the card's machine: csrc/jpeg.cu is built by nvcc, which is installed there")
    return jpeg.decode_native


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PILLOW_FILES))
def test_native_is_bit_equal_to_twin_and_pillow(native, name):
    data, digest, w, h = base64.b64decode(PILLOW_FILES[name][0]), *PILLOW_FILES[name][1:]
    before = jpeg.decode_native.calls
    out = native(data, name)
    assert jpeg.decode_native.calls == before + 1
    assert out.shape == (h, w, 3) and hashlib.sha256(out.tobytes()).hexdigest() == digest
    np.testing.assert_array_equal(out, jpeg.decode_twin(data, name))


@pytest.mark.gpu
def test_native_in_threads_and_on_the_writers_forms(native):
    """The loader's threads decode at once (no shared state); every sampling
    and a restart interval of the writer's files equal the twin."""
    import chip_smoke

    rng = np.random.default_rng(9)
    files = [chip_smoke.jpeg_bytes(smooth_image(rng, 37 + i, 21 + 2 * i, noise=10), 60 + i, s, r)
             for i, (s, r) in enumerate([(s, r) for s in [(1, 1), (2, 1), (1, 2), (2, 2)] for r in (0, 3)])]
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(native, files * 4))
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, jpeg.decode_twin(files[i % len(files)]))


@pytest.mark.gpu
def test_native_reads_the_colour_forms_as_the_twin(native):
    """chip_smoke.py's CMYK / YCCK / RGB files at every sampling and the
    marker cases: the native decoder bit-equal to the twin, in threads."""
    import chip_smoke

    files = []
    for i, (kind, factors) in enumerate(COLOUR_FORMS.values()):
        for w, h in COLOUR_SIZES:
            arr = smooth_image(np.random.default_rng(w + h + i), w, h, noise=10)
            if kind in ("cmyk", "ycck"):
                arr = np.concatenate([arr, arr[..., 1:2]], axis=2)
            files.append(chip_smoke.jpeg_bytes(arr, 70, restart=i % 2 * 2, form=kind, factors=factors))
    files += [d for d in _marker_cases().values() if d is not None] + list(_once_refused().values())
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(native, files))
    for data, out in zip(files, outs):
        np.testing.assert_array_equal(out, jpeg.decode_twin(data))
    for form in ("two_components", "mcu_too_large", "short_adobe"):
        data, pattern = _rejected()[form]
        with pytest.raises(ValueError, match=pattern):
            native(data, "f.jpg")


@pytest.mark.gpu
def test_native_rejects_what_the_twin_rejects(native):
    data = base64.b64decode(PILLOW_FILES["rgb_420_q75_17x9"][0])
    scan = data.index(b"\xff\xda")
    for bad, pattern in [(data[: scan + 40], "truncated"), (_patched(data, b"\xff\xc0", 1, 0xCB), "0xFFCB"),
                         (_patched(data, b"\xff\xc0", 1, 0xC2), "bad progression"),
                         (_patched(data, b"\xff\xc0", 4, 12), "12-bit"), (b"not a jpeg", "no SOI")]:
        with pytest.raises(ValueError, match=pattern):
            native(bad, "f.jpg")


@pytest.mark.gpu
def test_native_progressive_is_bit_equal_to_twin_and_pillow(native):
    """chip_smoke.py's Pillow-made progressive files against Pillow's digests,
    and progressive forms of the writer's images (restarts, a truncated file
    refused, a cut progression smoothed) against the twin."""
    import chip_smoke

    for name, (b64, digest, w, h) in chip_smoke.PROGRESSIVE_FILES.items():
        out = native(base64.b64decode(b64), name)
        assert out.shape == (h, w, 3) and hashlib.sha256(out.tobytes()).hexdigest() == digest
    for name in ("rgb_420_q75_17x9", "rgb_422_q10_33x17", "grey_q75_13x7"):
        data = base64.b64decode(PILLOW_FILES[name][0])
        np.testing.assert_array_equal(native(data, name), jpeg.decode_twin(data, name))
    for b64, *_ in chip_smoke.PROGRESSIVE_FILES.values():
        data = base64.b64decode(b64)
        with pytest.raises(ValueError, match="truncated"):
            native(data[: len(data) // 2], "f.jpg")
        np.testing.assert_array_equal(native(_partial_progression(data)), jpeg.decode_twin(_partial_progression(data)))


@pytest.mark.gpu
def test_native_new_forms_are_bit_equal_to_twin(native):
    """SOF1, arithmetic (SOF9 / SOF10, corrupt data too), lossless and smoothed files: the native decoder
    bit-equal to the twin and to Pillow's digests; decode_samples_native equal to decode_samples."""
    for name, (b64, digest, w, h) in chip_smoke.JPEG_FORM_PILLOW_FILES.items():
        assert hashlib.sha256(native(base64.b64decode(b64), name).tobytes()).hexdigest() == digest, name
    files = [arith_file(form, *size) for form in ARITH_FORMS for size in FORM_SIZES[1:]]
    for form, kw in LOSSLESS_FORMS.items():
        arr = _writer_image(33, 17, 4 if kw.get("form") == "cmyk" else 3, 8)
        files.append(chip_smoke.jpeg_bytes(arr if "form" in kw else arr[..., 0], coding="lossless", **kw))
    progressive = arith_file("progressive", 33, 70)  # cut after each scan: smoothed
    sos = [i for i in range(len(progressive) - 1) if progressive[i:i + 2] == b"\xff\xda"]
    files += [progressive[: sos[k]] + b"\xff\xd9" for k in range(1, len(sos))]
    data = arith_file("progressive_restart3", 64, 48, seed=3)
    files += [data[:at] + bytes([data[at] ^ 0x6B]) + data[at + 1:] for at in range(200, len(data) - 4, 97)]
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(lambda d: _either(native, d), files))
    for data, out in zip(files, outs):
        want = _either(jpeg.decode_twin, data)
        if isinstance(want, str):
            assert isinstance(out, str), want
        else:
            np.testing.assert_array_equal(out, want)
    base = chip_smoke.jpeg_bytes(_writer_image(19, 11, 3, 4), 90)
    for colour in (None, "ycbcr", "unknown"):
        np.testing.assert_array_equal(jpeg.decode_samples_native(base, "f.jpg", colour),
                                      jpeg.decode_samples(base, "f.jpg", colour))


def _either(fn, data):
    try:
        return fn(data, "f.jpg")
    except ValueError as err:
        return str(err)
