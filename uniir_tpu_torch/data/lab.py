"""Lab -> sRGB as Pillow 12.1 converts it (`Image.convert("RGB")` of an "LAB"
image, through LittleCMS's transform), bit for bit: the PSD reader's Lab
mode and the TIFF reader's CIELAB images use it."""

from __future__ import annotations

import lzma
from pathlib import Path

import numpy as np

LAB_GRID = 33
_NODES = Path(__file__).resolve().parent / "lab_srgb_nodes.xz"
_lab_nodes: list = []


def lab_nodes() -> np.ndarray:
    """int64 [33 * 33 * 33, 3]: the 16-bit sRGB nodes of LittleCMS's Lab -> sRGB grid, the L axis outermost
    (derived from the LittleCMS that Pillow ships by scripts/pillow_colour_tables.py)."""
    if not _lab_nodes:
        d2 = np.frombuffer(lzma.decompress(_NODES.read_bytes()), "<u2").reshape(LAB_GRID, LAB_GRID, LAB_GRID, 3)
        nodes = np.cumsum(np.cumsum(d2, axis=2, dtype=np.uint16), axis=2, dtype=np.uint16)  # sums wrap as written
        _lab_nodes.append(nodes.astype(np.int64).reshape(-1, 3))
    return _lab_nodes[0]


def _prelin8() -> tuple:
    """LittleCMS's PrelinOpt8 tables: each 8-bit value's grid cell and 16-bit fraction within it."""
    v = np.arange(256, dtype=np.int64) * 257 * (LAB_GRID - 1)
    v = v + (v + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
    return v >> 16, v & 0xFFFF


def lab_to_rgb(px: np.ndarray, chunk: int = 1 << 20) -> np.ndarray:
    """uint8 [..., 3] RGB of uint8 [..., 3] Lab samples as Pillow stores them (its a and b offset by 128 from
    LittleCMS's 8-bit Lab): PrelinEval8's tetrahedral interpolation of the grid, its 16-bit result rounded
    to 8 bits as LittleCMS rounds it.  Equal to Pillow's convert("RGB") on all 2^24 triples."""
    nodes = lab_nodes()
    cell, frac = _prelin8()
    flat = px.reshape(-1, 3)
    out = np.empty(flat.shape, np.uint8)
    g2, g1 = LAB_GRID * LAB_GRID, LAB_GRID
    for at in range(0, len(flat), chunk):
        p = flat[at : at + chunk].astype(np.int64)
        l, a, b = p[:, 0], p[:, 1] ^ 0x80, p[:, 2] ^ 0x80
        x0, y0, z0 = cell[l] * g2, cell[a] * g1, cell[b]
        rx, ry, rz = frac[l], frac[a], frac[b]
        x1, y1, z1 = x0 + np.where(rx == 0, 0, g2), y0 + np.where(ry == 0, 0, g1), z0 + np.where(rz == 0, 0, 1)

        def d(x, y, z):
            return nodes[x + y + z]

        c0 = d(x0, y0, z0)
        # the six tetrahedra in LittleCMS's order of tests: (c1, c2, c3) along x, y, z
        cases = [
            ((rx >= ry) & (ry >= rz), lambda: (d(x1, y0, z0) - c0, d(x1, y1, z0) - d(x1, y0, z0),
                                               d(x1, y1, z1) - d(x1, y1, z0))),
            ((rx >= rz) & (rz >= ry), lambda: (d(x1, y0, z0) - c0, d(x1, y1, z1) - d(x1, y0, z1),
                                               d(x1, y0, z1) - d(x1, y0, z0))),
            ((rz >= rx) & (rx >= ry), lambda: (d(x1, y0, z1) - d(x0, y0, z1), d(x1, y1, z1) - d(x1, y0, z1),
                                               d(x0, y0, z1) - c0)),
            ((ry >= rx) & (rx >= rz), lambda: (d(x1, y1, z0) - d(x0, y1, z0), d(x0, y1, z0) - c0,
                                               d(x1, y1, z1) - d(x1, y1, z0))),
            ((ry >= rz) & (rz >= rx), lambda: (d(x1, y1, z1) - d(x0, y1, z1), d(x0, y1, z0) - c0,
                                               d(x0, y1, z1) - d(x0, y1, z0))),
            ((rz >= ry) & (ry >= rx), lambda: (d(x1, y1, z1) - d(x0, y1, z1), d(x0, y1, z1) - d(x0, y0, z1),
                                               d(x0, y0, z1) - c0)),
        ]
        c1, c2, c3 = (np.zeros_like(c0) for _ in range(3))
        taken = np.zeros(len(p), bool)
        for cond, deltas in cases:
            sel = (cond & ~taken)[:, None]
            t1, t2, t3 = deltas()
            c1, c2, c3 = np.where(sel, t1, c1), np.where(sel, t2, c2), np.where(sel, t3, c3)
            taken |= sel[:, 0]
        rest = c1 * rx[:, None] + c2 * ry[:, None] + c3 * rz[:, None] + 0x8001
        v16 = c0 + ((rest + (rest >> 16)) >> 16)
        out[at : at + chunk] = ((v16 * 65281 + 8388608) >> 24) & 0xFF
    return out.reshape(px.shape)
