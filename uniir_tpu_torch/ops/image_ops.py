"""Device-side fused image preprocessing: kernel K7 (counterpart of
uniir_tpu/ops/image_ops.py).

The host only decodes to a fixed-size uint8 array
(`data.preprocess.raw_resize_uint8`); resize to the model's resolution,
dtype conversion and normalisation run on the device.  Resampling is
separable, `out = A_h @ img @ A_w^T`, with the interpolation matrices of
`resize_matrix` (PIL window semantics).

  * `preprocess_images`: the plain path, as the JAX package's XLA function
    (it divides by 255 and by std).
  * `fused_preprocess`: K7 (`csrc/preprocess.cu`, the counterpart of
    `pallas_fused_preprocess`) on a CUDA tensor, its plain twin
    `fused_preprocess_reference` on a CPU tensor.  Both follow the Pallas
    body's arithmetic: multiply by 1/255, two fp32 products, subtract the
    mean, multiply by 1/std.  On the card `preprocess_route` picks the
    kernel: the band kernel, which does only the non-zero taps of
    `resize_band`'s form of the matrices, or where its strip does not fit
    in shared memory the dense kernel (`fused_preprocess_dense`, its own
    launch count), which multiplies the whole matrices; the two are
    bit-equal.
  * `preprocess_reference_numpy`: the matrix-resize reference for tests.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from uniir_tpu_torch import _build
from uniir_tpu_torch.data.preprocess import CLIP_MEAN, CLIP_STD

MAX_SMEM_BYTES = 232448  # opt-in shared memory per block on sm_90
BAND_ROWS = 4  # output rows per block of the band kernel (BAND_R in csrc/preprocess.cu)
DENSE_ROWS = 32  # output rows per block of the dense kernel (DR there)
OUT_DTYPES = (torch.float32, torch.bfloat16)


def _cubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic convolution kernel (PIL 'bicubic', a=-0.5)."""
    x = np.abs(x)
    return np.where(
        x <= 1,
        (a + 2) * x**3 - (a + 3) * x**2 + 1,
        np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0),
    )


def _triangle_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


@lru_cache(maxsize=64)
def resize_matrix(src: int, dst: int, method: str = "bilinear", antialias: bool = True) -> np.ndarray:
    """[dst, src] interpolation matrix with align_corners=False sampling.

    With `antialias` (the default, PIL / torchvision semantics) the filter
    support is widened by the downscale factor, as PIL's convolution
    resampling does: resize stays a fixed linear map with more taps a row.
    """
    kernel, base_support = (_triangle_kernel, 1.0) if method == "bilinear" else (_cubic_kernel, 2.0)
    scale = src / dst
    filt_scale = max(1.0, scale) if antialias else 1.0
    support = base_support * filt_scale
    centers = (np.arange(dst) + 0.5) * scale - 0.5
    A = np.zeros((dst, src), np.float32)
    for i in range(dst):
        # PIL window semantics: clip to the image and renormalise over the
        # clipped window (no edge-tap accumulation)
        lo = max(0, int(centers[i] - support + 1.0))
        hi = min(src, int(centers[i] + support + 1.0) + 1)
        taps = np.arange(lo, hi)
        weights = kernel((taps - centers[i]) / filt_scale)
        wsum = weights.sum()
        if wsum <= 0:
            taps = np.array([min(src - 1, max(0, int(round(centers[i]))))])
            weights = np.array([1.0])
            wsum = 1.0
        A[i, taps] = weights / wsum
    return A


def cubic_resize_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] weights of `jax.image.resize(method="bicubic")` along one
    axis, for `models.layers.interpolate_pos_embed`: half-pixel centres and
    the Keys kernel of `resize_matrix`, widened by src / dst when shrinking,
    but over the whole axis in fp32 rather than PIL's clipped window: taps
    that fall outside the image are dropped and each row renormalised.
    `F.interpolate(mode="bicubic")` uses a = -0.75 and replicates the border
    instead, and does not agree."""
    inv_scale = np.float32(src) / np.float32(dst)
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = (np.arange(dst, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = (sample_f[None, :] - np.arange(src, dtype=np.float32)[:, None]) / kernel_scale  # [src, dst]
    weights = _cubic_kernel(x).astype(np.float32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= src - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], weights, 0).T.astype(np.float32))


@lru_cache(maxsize=16)
def _matrices(H: int, W: int, out_size: int, method: str, device: str, transposed: bool):
    """(A_h, A_w) on `device`, or their transposes [H, O], [W, O] for K7."""
    mats = (resize_matrix(H, out_size, method), resize_matrix(W, out_size, method))
    return tuple(torch.from_numpy(np.ascontiguousarray(m.T if transposed else m)).to(device) for m in mats)


@lru_cache(maxsize=64)
def resize_band(src: int, dst: int, method: str = "bilinear") -> Tuple[np.ndarray, np.ndarray]:
    """`resize_matrix(src, dst, method)` as a band: (first int32 [dst],
    weights fp32 [dst, taps]) with A[i, first[i] + j] = weights[i, j] and
    every other entry of A zero.  The windows never step back (`first` is
    non-decreasing), so a strip of rows reads from its first row's window to
    its last row's: a row starts at its first non-zero entry, or at a later
    row's start where that lies earlier (an upscale whose output centre lands
    on a source pixel has an exact zero first tap, and the next row starts
    one source row earlier), or earlier still where its window would run past
    the last source index.  `taps` is the least width that covers every row's
    non-zero entries from there, so every window lies inside [0, src).  The
    weights are copied from the matrix: expanding the band gives it back bit
    for bit."""
    A = resize_matrix(src, dst, method)
    nonzero = A != 0
    lo = np.minimum.accumulate(nonzero.argmax(axis=1)[::-1])[::-1]
    hi = src - nonzero[:, ::-1].argmax(axis=1)
    taps = int((hi - lo).max())
    first = np.minimum(lo, src - taps).astype(np.int32)
    weights = np.take_along_axis(A, first[:, None] + np.arange(taps)[None, :], axis=1)
    return first, np.ascontiguousarray(weights)


@lru_cache(maxsize=64)
def band_rows_in(src: int, dst: int, method: str) -> int:
    """The most source rows a band-kernel block (BAND_ROWS output rows) reads:
    from its first row's window start to its last row's window end."""
    first, weights = resize_band(src, dst, method)
    last = np.minimum(np.arange(0, dst, BAND_ROWS) + BAND_ROWS, dst) - 1
    return int((first[last] + weights.shape[1] - first[::BAND_ROWS]).max())


def band_smem_bytes(H: int, W: int, out_size: int, method: str) -> int:
    """Shared memory of a band-kernel block (csrc/preprocess.cu:
    band_smem_bytes) with fp32 output: the strip's source rows as bytes or
    its staged output rows, whichever is larger, and the [BAND_ROWS, W * 3]
    fp32 intermediate; a row of bytes padded to a word, the first region to
    16 bytes."""
    cs = -(-W * 3 // 4) * 4
    strip = max(band_rows_in(H, out_size, method) * cs, BAND_ROWS * out_size * 3 * 4)
    return -(-strip // 16) * 16 + BAND_ROWS * cs * 4


def dense_smem_bytes(H: int, W: int) -> int:
    """Shared memory of a dense-kernel block: a strip of A_h^T, the [W, 36]
    intermediate strip and the uint8 plane of one channel."""
    return (H * DENSE_ROWS + W * (DENSE_ROWS + 4)) * 4 + H * W


def preprocess_route(H: int, W: int, out_size: int, method: str) -> Optional[str]:
    """The K7 kernel a CUDA call at these sizes launches: "band" where the
    band kernel's strip fits in a block's shared memory, else "dense" where
    the dense kernel's does, else None (no kernel takes the shape)."""
    if band_smem_bytes(H, W, out_size, method) <= MAX_SMEM_BYTES:
        return "band"
    if dense_smem_bytes(H, W) <= MAX_SMEM_BYTES:
        return "dense"
    return None


@lru_cache(maxsize=16)
def _bands(H: int, W: int, out_size: int, method: str, device: str):
    """(first_h, w_h, first_w, w_w) of `resize_band` on `device`, for the band kernel."""
    tensors = []
    for src in (H, W):
        first, weights = resize_band(src, out_size, method)
        tensors += [torch.from_numpy(first).to(device), torch.from_numpy(weights).to(device)]
    return tuple(tensors)


def _check_images(images_u8: torch.Tensor, out_dtype: torch.dtype) -> None:
    if images_u8.dim() != 4 or images_u8.shape[3] != 3 or images_u8.dtype != torch.uint8:
        raise ValueError(f"images must be uint8 [B, H, W, 3], got {images_u8.dtype} {tuple(images_u8.shape)}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")


def preprocess_images(
    images_u8: torch.Tensor, out_size: int = 224, method: str = "bilinear", out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8 [B, H, W, 3] square inputs -> normalised [B, out, out, 3].

    Shortest-side semantics are the host's (inputs already square, e.g.
    256 x 256); this resizes to out_size and normalises through two fp32
    products."""
    _check_images(images_u8, out_dtype)
    _, H, W, _ = images_u8.shape
    Ah, Aw = _matrices(H, W, out_size, method, str(images_u8.device), False)
    x = images_u8.float() / 255.0
    x = torch.einsum("oh,bhwc->bowc", Ah, x)
    x = torch.einsum("pw,bowc->bopc", Aw, x)
    mean, std = (torch.from_numpy(v).to(x.device) for v in (CLIP_MEAN, CLIP_STD))
    return ((x - mean) / std).to(out_dtype)


def _norm_constants():
    """(1/255, mean, 1/std) as the Pallas body takes them: fp32 values."""
    return float(np.float32(1.0 / 255.0)), [float(v) for v in CLIP_MEAN], [float(1.0 / v) for v in CLIP_STD]


def fused_preprocess_reference(
    images_u8: torch.Tensor, out_size: int = 224, method: str = "bilinear", out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain PyTorch twin of K7, with the kernel's arithmetic: per channel
    ((A_h @ (img * (1/255))) @ A_w^T - mean) * (1/std), fp32 throughout,
    cast to `out_dtype` at the end."""
    _check_images(images_u8, out_dtype)
    _, H, W, _ = images_u8.shape
    Ah, Aw = _matrices(H, W, out_size, method, str(images_u8.device), False)
    inv255, mean, inv_std = _norm_constants()
    x = images_u8.float() * inv255
    x = torch.einsum("oh,bhwc->bowc", Ah, x)
    x = torch.einsum("pw,bowc->bopc", Aw, x)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    inv_std_t = torch.tensor(inv_std, dtype=torch.float32, device=x.device)
    return ((x - mean_t) * inv_std_t).to(out_dtype)


def fused_preprocess(
    images_u8: torch.Tensor, out_size: int = 224, method: str = "bilinear", out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Fused convert + resize + normalise, uint8 NHWC in, NHWC `out_dtype`
    out: K7 on a CUDA tensor, through the kernel `preprocess_route` picks
    (or it raises), the twin on a CPU tensor."""
    _check_images(images_u8, out_dtype)
    if images_u8.device.type == "cpu":
        return fused_preprocess_reference(images_u8, out_size, method, out_dtype)
    _, H, W, _ = images_u8.shape
    route = preprocess_route(H, W, out_size, method)
    if route is None:
        raise ValueError(f"no K7 kernel takes {H} x {W} -> {out_size} ({method}): its strip needs more shared "
                         f"memory than one block has")
    return _launch(images_u8, out_size, method, out_dtype, route)


def fused_preprocess_dense(
    images_u8: torch.Tensor, out_size: int = 224, method: str = "bilinear", out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """K7's dense kernel: what `fused_preprocess` launches where
    `preprocess_route` says "dense".  It takes the band kernel's shapes too,
    which is how the two are timed side by side; the twin on a CPU tensor."""
    _check_images(images_u8, out_dtype)
    if images_u8.device.type == "cpu":
        return fused_preprocess_reference(images_u8, out_size, method, out_dtype)
    _, H, W, _ = images_u8.shape
    if dense_smem_bytes(H, W) > MAX_SMEM_BYTES:
        raise ValueError(f"a {H} x {W} plane needs {dense_smem_bytes(H, W)} bytes of shared memory, more than one block has")
    return _launch(images_u8, out_size, method, out_dtype, "dense")


def _launch(images_u8: torch.Tensor, out_size: int, method: str, out_dtype: torch.dtype, route: str) -> torch.Tensor:
    """Launch K7's `route` kernel ("band" or "dense") on a CUDA batch and
    count it on its wrapper."""
    if not images_u8.is_cuda or not images_u8.is_contiguous():
        raise ValueError(f"K7 takes a contiguous CUDA or CPU tensor, got one on {images_u8.device}")
    B, H, W, _ = images_u8.shape
    if not 0 < B <= 65535:
        raise ValueError(f"batch {B} outside the launch grid (1..65535)")
    device = str(images_u8.device)
    inv255, mean, inv_std = _norm_constants()
    lib = _build.load("preprocess")
    out = torch.empty((B, out_size, out_size, 3), dtype=out_dtype, device=images_u8.device)
    bf16, stream = int(out_dtype == torch.bfloat16), torch.cuda.current_stream(images_u8.device).cuda_stream
    if route == "band":
        first_h, w_h, first_w, w_w = _bands(H, W, out_size, method, device)
        err = lib.uniir_fused_preprocess(
            images_u8.data_ptr(), first_h.data_ptr(), w_h.data_ptr(), first_w.data_ptr(), w_w.data_ptr(),
            out.data_ptr(), B, H, W, out_size, w_h.shape[1], w_w.shape[1], band_rows_in(H, out_size, method), bf16,
            inv255, *mean, *inv_std, stream,
        )
        wrapper = fused_preprocess
    else:
        ahT, awT = _matrices(H, W, out_size, method, device, True)
        err = lib.uniir_fused_preprocess_dense(
            images_u8.data_ptr(), ahT.data_ptr(), awT.data_ptr(), out.data_ptr(), B, H, W, out_size, bf16, inv255,
            *mean, *inv_std, stream,
        )
        wrapper = fused_preprocess_dense
    _build.check(lib, err, f"fused preprocess {route} kernel")
    wrapper.launches += 1
    return out


fused_preprocess.launches = 0
fused_preprocess_dense.launches = 0


def preprocess_reference_numpy(images_u8: np.ndarray, out_size: int = 224, method: str = "bilinear") -> np.ndarray:
    """Matrix-resize reference in numpy for tests."""
    _, H, W, _ = images_u8.shape
    Ah = resize_matrix(H, out_size, method)
    Aw = resize_matrix(W, out_size, method)
    x = images_u8.astype(np.float32) / 255.0
    x = np.einsum("oh,bhwc->bowc", Ah, x)
    x = np.einsum("pw,bowc->bopc", Aw, x)
    return (x - CLIP_MEAN) / CLIP_STD
