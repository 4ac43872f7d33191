"""OpenJPEG 2.5.4, the library Pillow 12.1's JPEG 2000 plugin links, called through ctypes: the encoder for
the forms Pillow's save does not pass on (code-block styles, SOP / EPH, tile-parts, POC, RGN, subsampled
components, precisions 1-16), and the decoder's int32 components (`opj_decode`) that the port's twin is held
to stage by stage.  Used only by the tests and scripts/make_jpeg2000_files.py; the port never loads it."""

from __future__ import annotations

import ctypes
import os
import tempfile
from pathlib import Path

import numpy as np

CODEC_J2K, CODEC_JP2 = 0, 2
PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
# code-block style bits (the COD's SPcod), as opj_cparameters_t.mode takes them
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
PATH_LEN, MAXRLVLS, JPWL_TILESPECS, JPWL_PACKSPECS = 4096, 33, 16, 16


def library_path() -> str:
    """The libopenjp2 Pillow's wheel ships beside its _imaging module."""
    import PIL

    libs = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    found = sorted(libs.glob("libopenjp2-*.so*"))
    if not found:
        raise FileNotFoundError(f"no libopenjp2 under {libs}")
    return str(found[0])


class Poc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("resno0", "compno0", "layno1", "resno1", "compno1", "layno0",
                                              "precno0", "precno1")] + \
               [("prg1", ctypes.c_int), ("prg", ctypes.c_int), ("progorder", ctypes.c_char * 5),
                ("tile", ctypes.c_uint32)] + \
               [(n, ctypes.c_int32) for n in ("tx0", "tx1", "ty0", "ty1")] + \
               [(n, ctypes.c_uint32) for n in ("layS", "resS", "compS", "prcS", "layE", "resE", "compE", "prcE",
                                              "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t", "res_t", "comp_t",
                                              "prc_t", "tx0_t", "ty0_t")]


class CParameters(ctypes.Structure):
    """openjpeg.h's opj_cparameters_t (2.5)."""
    _fields_ = [
        ("tile_size_on", ctypes.c_int), ("cp_tx0", ctypes.c_int), ("cp_ty0", ctypes.c_int),
        ("cp_tdx", ctypes.c_int), ("cp_tdy", ctypes.c_int), ("cp_disto_alloc", ctypes.c_int),
        ("cp_fixed_alloc", ctypes.c_int), ("cp_fixed_quality", ctypes.c_int),
        ("cp_matrice", ctypes.c_void_p), ("cp_comment", ctypes.c_char_p), ("csty", ctypes.c_int),
        ("prog_order", ctypes.c_int), ("POC", Poc * 32), ("numpocs", ctypes.c_uint32),
        ("tcp_numlayers", ctypes.c_int), ("tcp_rates", ctypes.c_float * 100),
        ("tcp_distoratio", ctypes.c_float * 100), ("numresolution", ctypes.c_int),
        ("cblockw_init", ctypes.c_int), ("cblockh_init", ctypes.c_int), ("mode", ctypes.c_int),
        ("irreversible", ctypes.c_int), ("roi_compno", ctypes.c_int), ("roi_shift", ctypes.c_int),
        ("res_spec", ctypes.c_int), ("prcw_init", ctypes.c_int * MAXRLVLS), ("prch_init", ctypes.c_int * MAXRLVLS),
        ("infile", ctypes.c_char * PATH_LEN), ("outfile", ctypes.c_char * PATH_LEN), ("index_on", ctypes.c_int),
        ("index", ctypes.c_char * PATH_LEN), ("image_offset_x0", ctypes.c_int), ("image_offset_y0", ctypes.c_int),
        ("subsampling_dx", ctypes.c_int), ("subsampling_dy", ctypes.c_int), ("decod_format", ctypes.c_int),
        ("cod_format", ctypes.c_int), ("jpwl_epc_on", ctypes.c_int), ("jpwl_hprot_MH", ctypes.c_int),
        ("jpwl_hprot_TPH_tileno", ctypes.c_int * JPWL_TILESPECS), ("jpwl_hprot_TPH", ctypes.c_int * JPWL_TILESPECS),
        ("jpwl_pprot_tileno", ctypes.c_int * JPWL_PACKSPECS), ("jpwl_pprot_packno", ctypes.c_int * JPWL_PACKSPECS),
        ("jpwl_pprot", ctypes.c_int * JPWL_PACKSPECS), ("jpwl_sens_size", ctypes.c_int),
        ("jpwl_sens_addr", ctypes.c_int), ("jpwl_sens_range", ctypes.c_int), ("jpwl_sens_MH", ctypes.c_int),
        ("jpwl_sens_TPH_tileno", ctypes.c_int * JPWL_TILESPECS), ("jpwl_sens_TPH", ctypes.c_int * JPWL_TILESPECS),
        ("cp_cinema", ctypes.c_int), ("max_comp_size", ctypes.c_int), ("cp_rsiz", ctypes.c_int),
        ("tp_on", ctypes.c_char), ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char),
        ("jpip_on", ctypes.c_int), ("mct_data", ctypes.c_void_p), ("max_cs_size", ctypes.c_int),
        ("rsiz", ctypes.c_uint16), ("_spare", ctypes.c_char * 256),
    ]


class ComponentParameters(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class ImageComponent(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                                              "resno_decoded", "factor")] + \
               [("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class Image(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("x0", "y0", "x1", "y1", "numcomps")] + \
               [("color_space", ctypes.c_int), ("comps", ctypes.POINTER(ImageComponent)),
                ("icc_profile_buf", ctypes.c_void_p), ("icc_profile_len", ctypes.c_uint32)]


_lib = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        L = ctypes.CDLL(library_path())
        P = ctypes.c_void_p
        for name, res, args in [
            ("opj_version", ctypes.c_char_p, []),
            ("opj_stream_create_default_file_stream", P, [ctypes.c_char_p, ctypes.c_int]),
            ("opj_stream_destroy", None, [P]),
            ("opj_create_decompress", P, [ctypes.c_int]), ("opj_create_compress", P, [ctypes.c_int]),
            ("opj_destroy_codec", None, [P]),
            ("opj_set_default_decoder_parameters", None, [P]),
            ("opj_set_default_encoder_parameters", None, [ctypes.POINTER(CParameters)]),
            ("opj_setup_decoder", ctypes.c_int, [P, P]),
            ("opj_setup_encoder", ctypes.c_int, [P, ctypes.POINTER(CParameters), ctypes.POINTER(Image)]),
            ("opj_read_header", ctypes.c_int, [P, P, ctypes.POINTER(ctypes.POINTER(Image))]),
            ("opj_decode", ctypes.c_int, [P, P, ctypes.POINTER(Image)]),
            ("opj_end_decompress", ctypes.c_int, [P, P]),
            ("opj_image_create", ctypes.POINTER(Image), [ctypes.c_uint32, ctypes.POINTER(ComponentParameters),
                                                         ctypes.c_int]),
            ("opj_image_destroy", None, [ctypes.POINTER(Image)]),
            ("opj_start_compress", ctypes.c_int, [P, ctypes.POINTER(Image), P]),
            ("opj_encode", ctypes.c_int, [P, P]), ("opj_end_compress", ctypes.c_int, [P, P]),
        ]:
            getattr(L, name).restype = res
            getattr(L, name).argtypes = args
        _lib = L
    return _lib


def default_encoder_parameters() -> CParameters:
    p = CParameters()
    lib().opj_set_default_encoder_parameters(ctypes.byref(p))
    return p


def check_layout() -> None:
    """The fields opj_set_default_encoder_parameters writes sit where CParameters puts them."""
    p = default_encoder_parameters()
    got = (p.numresolution, p.cblockw_init, p.cblockh_init, p.roi_compno, p.subsampling_dx, p.subsampling_dy,
           p.decod_format, p.cod_format, p.tcp_numlayers, p.prog_order, p.tcp_rates[0], p.max_comp_size,
           p.tp_on, p.tcp_mct, p.prcw_init[0], p.res_spec, p.rsiz)
    want = (6, 64, 64, -1, 1, 1, -1, -1, 0, 0, 0.0, 0, b"\0", b"\0", 0, 0, 0)
    if got != want:
        raise AssertionError(f"opj_cparameters_t layout: {got} != {want}")


def component_shape(height: int, width: int, dx: int, dy: int, x0: int = 0, y0: int = 0) -> tuple:
    """A component's (h, w) on an image of `width` x `height` at offset (x0, y0) subsampled by (dx, dy)."""
    return -(-(y0 + height) // dy) - -(-y0 // dy), -(-(x0 + width) // dx) - -(-x0 // dx)


def encode(planes: list, *, codec: int = CODEC_J2K, prec=8, sgnd=False, dx=1, dy=1, x0=0, y0=0,
           color_space: int = 0, **options) -> bytes:
    """A codestream (or JP2 file) of the integer planes `planes` (each [h_c, w_c], already subsampled:
    `component_shape`), through opj_encode.  `prec`, `sgnd`, `dx`, `dy` are one value or one per component;
    `x0`, `y0` the image offset on the reference grid.  `options` set opj_cparameters_t fields by name, with `rates`,
    `distortions` (layers), `precincts` [(w, h)] and `pocs` [dict of Poc fields] as lists."""
    L = lib()
    n = len(planes)

    def each(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * n

    precs, sgnds, dxs, dys = each(prec), each(sgnd), each(dx), each(dy)
    cp = (ComponentParameters * n)()
    for c, plane in enumerate(planes):
        h, w = plane.shape
        cp[c].dx, cp[c].dy, cp[c].w, cp[c].h = dxs[c], dys[c], w, h
        cp[c].x0, cp[c].y0 = -(-x0 // dxs[c]), -(-y0 // dys[c])
        cp[c].prec, cp[c].bpp, cp[c].sgnd = precs[c], precs[c], int(sgnds[c])
    img = L.opj_image_create(n, cp, color_space)
    if not img:
        raise RuntimeError("opj_image_create failed")
    im = img.contents
    im.x0, im.y0 = x0, y0
    im.x1 = x0 + options.pop("width", max((cp[c].x0 + cp[c].w - 1) * dxs[c] + 1 for c in range(n)) - x0)
    im.y1 = y0 + options.pop("height", max((cp[c].y0 + cp[c].h - 1) * dys[c] + 1 for c in range(n)) - y0)
    for c in range(n):
        if (cp[c].h, cp[c].w) != component_shape(im.y1 - y0, im.x1 - x0, dxs[c], dys[c], x0, y0):
            raise ValueError(f"component {c} of {cp[c].h} x {cp[c].w} on a {im.x1 - x0} x {im.y1 - y0} image")
    for c, plane in enumerate(planes):
        flat = np.ascontiguousarray(plane, dtype=np.int32).ravel()
        ctypes.memmove(im.comps[c].data, flat.ctypes.data, flat.nbytes)
    p = default_encoder_parameters()
    p.numresolution = max(1, min(6, min(min(a.shape) for a in planes).bit_length()))
    p.tcp_numlayers = 1
    p.tcp_rates[0] = 0
    p.cp_disto_alloc = 1
    rates = options.pop("rates", None)
    distortions = options.pop("distortions", None)
    if rates:
        p.tcp_numlayers = len(rates)
        for i, r in enumerate(rates):
            p.tcp_rates[i] = r
    if distortions:
        p.tcp_numlayers = len(distortions)
        p.cp_disto_alloc, p.cp_fixed_quality = 0, 1
        for i, d in enumerate(distortions):
            p.tcp_distoratio[i] = d
    for i, (w, h) in enumerate(options.pop("precincts", [])):
        p.prcw_init[i], p.prch_init[i] = w, h
        p.res_spec = i + 1
        p.csty |= 1
    for i, poc in enumerate(options.pop("pocs", [])):
        for k, v in poc.items():
            setattr(p.POC[i], k, v)
        p.numpocs = i + 1
    comment = options.pop("comment", None)
    if comment is not None:
        p.cp_comment = comment
    for k, v in options.items():
        if k in ("tp_on", "tp_flag", "tcp_mct") and isinstance(v, int):
            v = bytes([v])
        setattr(p, k, v)
    fd, path = tempfile.mkstemp(suffix=".j2k" if codec == CODEC_J2K else ".jp2")
    os.close(fd)
    codec_h = L.opj_create_compress(codec)
    stream = None
    try:
        if not L.opj_setup_encoder(codec_h, ctypes.byref(p), img):
            raise RuntimeError("opj_setup_encoder failed")
        stream = L.opj_stream_create_default_file_stream(path.encode(), 0)
        if not (L.opj_start_compress(codec_h, img, stream) and L.opj_encode(codec_h, stream)
                and L.opj_end_compress(codec_h, stream)):
            raise RuntimeError("opj_encode failed")
        L.opj_stream_destroy(stream)
        stream = None
        return Path(path).read_bytes()
    finally:
        if stream:
            L.opj_stream_destroy(stream)
        L.opj_destroy_codec(codec_h)
        L.opj_image_destroy(img)
        os.unlink(path)


def decode_components(data: bytes, codec: int = CODEC_J2K):
    """opj_decode of a codestream: (image (x0, y0, x1, y1, color_space), [component dict with dx, dy, w, h,
    x0, y0, prec, sgnd and `data` int32 [h, w]]), or None where OpenJPEG refuses it."""
    L = lib()
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.write(fd, data)
    os.close(fd)
    params = ctypes.create_string_buffer(1 << 16)
    codec_h = L.opj_create_decompress(codec)
    stream = L.opj_stream_create_default_file_stream(path.encode(), 1)
    img = ctypes.POINTER(Image)()
    try:
        L.opj_set_default_decoder_parameters(params)
        if not L.opj_setup_decoder(codec_h, params):
            return None
        if not L.opj_read_header(stream, codec_h, ctypes.byref(img)):
            return None
        if not L.opj_decode(codec_h, stream, img) or not L.opj_end_decompress(codec_h, stream):
            return None
        im = img.contents
        comps = []
        for c in range(im.numcomps):
            k = im.comps[c]
            arr = np.ctypeslib.as_array(k.data, shape=(k.h * k.w,)).copy().reshape(k.h, k.w)
            comps.append({"dx": k.dx, "dy": k.dy, "w": k.w, "h": k.h, "x0": k.x0, "y0": k.y0, "prec": k.prec,
                          "sgnd": k.sgnd, "data": arr})
        return (im.x0, im.y0, im.x1, im.y1, im.color_space), comps
    finally:
        if img:
            L.opj_image_destroy(img)
        L.opj_stream_destroy(stream)
        L.opj_destroy_codec(codec_h)
        os.unlink(path)
