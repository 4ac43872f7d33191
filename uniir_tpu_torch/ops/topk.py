"""Exact top-k inner-product search: the sweep kernels K2 / K4 / K11 and their epilogue.

Counterpart of `uniir_tpu/ops/topk_pallas.py` (and the numpy helpers of
`uniir_tpu/ops/topk.py`).  The pipeline is the reference's:

  1. a sweep over the whole pool that writes, per query, the fp32 maximum of
     every strided bucket -- member m of bucket (i, l) is pool row
     i*CHUNK + m*128 + l, its output column i*128 + l.  bf16 pools use K2
     (`bucket_max_scores`), int8 pools with one scale per row K4
     (`bucket_max_scores_i8`), int8 pools with one scale per bucket
     (`quantize_pool(per_bucket=True)`) K11 (`bucket_max_scores_i8b`, which
     takes the bucket maximum in int32 and dequantises only the maxima;
     `bucket_max_scores_i8` hands over to it by the shape of the scales); on
     a CPU tensor each runs its plain PyTorch twin.  K2, K4 and K11 launch
     the TMA-fed `wgmma` kernel at the widths `sweep_route` gives it and
     their general-width kernels (`bucket_max_scores_general`,
     `bucket_max_scores_i8_general`, `bucket_max_scores_i8b_general`, each
     with its own launch count) at the rest;
  2. a plain-torch epilogue (`topk`): hierarchical top-k over the maxima,
     gather of the selected buckets' rows, fp32-accumulated rescore against
     the bf16 pool, final top-k and, for int8, the certainty guard.

Unlike the TPU sweep, the CUDA kernels take any query count, and
`prepare_pool` pads the pool on the device, only to the CHUNK bucket
granularity.

Over several processes (`core.mesh`) the pool is sharded by rows, one
shard a rank (`shard_pool`, the JAX rule: shards of ceil(N / W) rows, the
last one short); `sharded_topk` runs `topk` over each rank's shard (K2 on
the card) and merges the [Q, k] partials of all ranks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from uniir_tpu_torch import _build
from uniir_tpu_torch.core import mesh

CHUNK = 2048  # rows per strided-bucket group
LANES = 128  # buckets per chunk
GROUP = CHUNK // LANES  # members per bucket
NEG = -3e38  # score of a padding row
ROWS_PER_STEP = 64 * CHUNK  # pool rows per step of the plain twins and of quantize_pool
# the widths each sweep takes (a multiple of the kernels' k step), and the widest the wgmma kernel takes
# (set with the C side's other build macros in _build.DEFINES)
D_MULTIPLE = {torch.bfloat16: 32, torch.int8: 64}
WGMMA_MAX_D = {torch.bfloat16: _build.DEFINES["topk"]["UNIIR_SWEEP_MAX_D_BF16"],
               torch.int8: _build.DEFINES["topk"]["UNIIR_SWEEP_MAX_D_I8"]}


def topk_numpy_reference(queries: np.ndarray, pool: np.ndarray, k: int):
    """Brute-force fp32 reference for tests."""
    scores = queries.astype(np.float32) @ pool.astype(np.float32).T
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=1), idx


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: (values int8, scale fp32), from fp32 math --
    each step of the pool (`_quantize_pool_impl`, jitted in the reference)."""
    x = x.float()
    # XLA compiles the reference's `/ 127.0` as a multiply by the fp32
    # reciprocal; doing the same keeps the scales bit-equal to the reference's
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    scale = x.abs().amax(dim=1).clamp_min(1e-6) * inv127
    q = torch.round(x / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_queries(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 of the queries of a stand-alone K4 / K11 call,
    as the JAX sweep quantises them when it is called outside any jit
    (topk_pallas.py:321-324): the scale is amax / 127 by a true division.
    Under jit (`pallas_topk`, hence `topk` and the search) XLA multiplies by
    the reciprocal, which is `quantize_rows`; the two scales differ by one
    fp32 step on a few rows in a hundred."""
    x = x.float()
    scale = x.abs().amax(dim=1).clamp_min(1e-6) / 127.0
    q = torch.round(x / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_buckets(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale per strided bucket, for whole chunks
    (`_quantize_pool_bucketed_impl`, topk_pallas.py:216-226): the bucket's
    amax over its GROUP members (rows i*CHUNK + m*LANES + l), the scale from
    it as in `quantize_rows`, every row divided by its bucket's scale.
    Returns (values int8 [n, D], scale fp32 [n / GROUP])."""
    n = x.shape[0]
    x = x.float()
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    amax = x.abs().amax(dim=1).view(n // CHUNK, GROUP, LANES).amax(dim=1)  # [chunks, LANES]
    scale = amax.clamp_min(1e-6) * inv127
    row_scale = scale[:, None, :].expand(-1, GROUP, -1).reshape(n)
    q = torch.round(x / row_scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale.reshape(-1)


def quantize_pool(pool: torch.Tensor, per_bucket: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 pool: (pool_q [N, D] int8, scale fp32).

    One scale per row ([N], for K4) or, with `per_bucket`, one per strided
    bucket ([N / GROUP], for K11; N must be a CHUNK multiple).  Quantised in
    row steps of whole chunks, so a multi-GB pool never gets a full fp32
    copy (17 GB at 5.6M x 768)."""
    N, D = pool.shape
    if per_bucket and N % CHUNK:
        raise ValueError(f"per-bucket scales need a pool of whole chunks: {N} rows is not a multiple of {CHUNK}")
    pool_q = torch.empty((N, D), dtype=torch.int8, device=pool.device)
    scale = torch.empty((N // GROUP if per_bucket else N,), dtype=torch.float32, device=pool.device)
    rows_per_scale = GROUP if per_bucket else 1
    quantize = quantize_buckets if per_bucket else quantize_rows
    for r0 in range(0, N, ROWS_PER_STEP):
        r1 = min(r0 + ROWS_PER_STEP, N)
        pool_q[r0:r1], scale[r0 // rows_per_scale : r1 // rows_per_scale] = quantize(pool[r0:r1])
    return pool_q, scale


def prepare_pool(
    embeds: np.ndarray, device, int8: bool = False, per_bucket: bool = False
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Upload a host pool once: bf16 [N_pad, D] (N_pad a CHUNK multiple, zero
    rows past N) and, with `int8`, its int8 quantisation: one scale per row,
    or with `per_bucket` one per strided bucket of the padded pool.

    Both come from the host values (fp16 in a DenseIndex) in row steps, as
    the reference quantises the fp16 pool and casts it to bf16 for the sweep."""
    N, D = embeds.shape
    n_pad = -(-N // CHUNK) * CHUNK
    pool = torch.zeros((n_pad, D), dtype=torch.bfloat16, device=device)
    quant = None
    if int8:
        quant = (
            torch.zeros((n_pad, D), dtype=torch.int8, device=device),
            torch.ones((n_pad // GROUP if per_bucket else n_pad,), dtype=torch.float32, device=device),  # padding: q = 0
        )
    for r0 in range(0, N, ROWS_PER_STEP):
        part = torch.from_numpy(np.ascontiguousarray(embeds[r0 : r0 + ROWS_PER_STEP])).to(device)
        r1 = r0 + len(part)
        pool[r0:r1] = part.to(torch.bfloat16)
        if int8 and per_bucket:
            r1 = -(-r1 // CHUNK) * CHUNK  # the last step's chunk is completed with zero rows, as the padded pool's
            part = torch.cat([part, part.new_zeros((r1 - r0 - len(part), D))])
            quant[0][r0:r1], quant[1][r0 // GROUP : r1 // GROUP] = quantize_buckets(part)
        elif int8:
            quant[0][r0:r1], quant[1][r0:r1] = quantize_rows(part)
    return pool, quant


def _bucket_max(scores: torch.Tensor) -> torch.Tensor:
    """[Q, n] scores of whole chunks -> [Q, n/GROUP] strided-bucket maxima."""
    Q, n = scores.shape
    return scores.view(Q, n // CHUNK, GROUP, LANES).amax(dim=2).reshape(Q, (n // CHUNK) * LANES)


def _masked(scores: torch.Tensor, r0: int, valid_n: int) -> torch.Tensor:
    rows = torch.arange(r0, r0 + scores.shape[1], device=scores.device)
    return torch.where(rows < valid_n, scores, NEG)


def bucket_max_scores_reference(queries: torch.Tensor, pool: torch.Tensor, valid_n: Optional[int] = None) -> torch.Tensor:
    """Plain twin of K2: bf16 operands, fp32 products and sums."""
    N = pool.shape[0]
    valid_n = N if valid_n is None else valid_n
    qf = queries.to(torch.bfloat16).float()
    out = []
    for r0 in range(0, N, ROWS_PER_STEP):
        rows = pool[r0 : r0 + ROWS_PER_STEP].to(torch.bfloat16).float()
        out.append(_bucket_max(_masked(qf @ rows.T, r0, valid_n)))
    return torch.cat(out, dim=1)


def bucket_max_scores_i8_reference(
    q_q: torch.Tensor, q_scale: torch.Tensor, pool_q: torch.Tensor, pool_scale: torch.Tensor, valid_n: Optional[int] = None
) -> torch.Tensor:
    """Plain twin of K4: int8 dot products, (acc * q_scale) * pool_scale.

    The integer sums are exact in fp32 while D * 127^2 < 2^24 (D <= 1040)."""
    N, D = pool_q.shape
    if D * 127 * 127 >= 2**24:
        raise ValueError(f"fp32 cannot hold int8 dot products of width {D} exactly")
    valid_n = N if valid_n is None else valid_n
    qf = q_q.float()
    out = []
    for r0 in range(0, N, ROWS_PER_STEP):
        acc = qf @ pool_q[r0 : r0 + ROWS_PER_STEP].float().T
        scores = acc * q_scale[:, None] * pool_scale[None, r0 : r0 + ROWS_PER_STEP]
        out.append(_bucket_max(_masked(scores, r0, valid_n)))
    return torch.cat(out, dim=1)


def bucket_max_scores_i8b_reference(
    q_q: torch.Tensor, q_scale: torch.Tensor, pool_q: torch.Tensor, bucket_scale: torch.Tensor,
    valid_n: Optional[int] = None
) -> torch.Tensor:
    """Plain twin of K11 (`_bucket_max_kernel_i8b`): int8 dot products, rows
    >= valid_n set to the int32 sentinel -(2^31 - 1), the bucket maximum in
    int32, then (max * q_scale) * bucket_scale; a bucket whose first member
    is >= valid_n scores NEG.  The products are summed in fp32 where it
    holds them exactly (D * 127^2 < 2^24, D <= 1040), else in fp64."""
    N, D = pool_q.shape
    exact = torch.float32 if D * 127 * 127 < 2**24 else torch.float64
    valid_n = N if valid_n is None else valid_n
    qf = q_q.to(exact)
    Q = qf.shape[0]
    out = []
    for r0 in range(0, N, ROWS_PER_STEP):
        acc = (qf @ pool_q[r0 : r0 + ROWS_PER_STEP].to(exact).T).to(torch.int32)  # exact integers
        n = acc.shape[1]
        rows = torch.arange(r0, r0 + n, device=acc.device)
        acc = torch.where(rows < valid_n, acc, -(2**31 - 1))
        out.append(acc.view(Q, n // CHUNK, GROUP, LANES).amax(dim=2).reshape(Q, n // GROUP))
    deq = torch.cat(out, dim=1).float() * q_scale[:, None] * bucket_scale[None, :]
    first = _bucket_rows(torch.arange(N // GROUP, device=deq.device))[:, 0]  # each bucket's first member
    return torch.where(first < valid_n, deq, NEG)


def _check_sweep_args(queries: torch.Tensor, pool: torch.Tensor, valid_n: int, dtype, d_multiple: int) -> None:
    Q, D = queries.shape
    N = pool.shape[0]
    if pool.dim() != 2 or pool.shape[1] != D:
        raise ValueError(f"pool {tuple(pool.shape)} does not match queries {tuple(queries.shape)}")
    if N % CHUNK or N == 0:
        raise ValueError(f"pool rows ({N}) must be a positive multiple of {CHUNK}: pad with prepare_pool")
    if not 0 <= valid_n <= N:
        raise ValueError(f"valid_n={valid_n} outside [0, {N}]")
    if D % d_multiple:
        raise ValueError(f"the sweep kernel needs a width that is a multiple of {d_multiple}, got {D}")
    for name, t in (("queries", queries), ("pool", pool)):
        if t.dtype != dtype or t.device != pool.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned {dtype} tensor on {pool.device}")


def sweep_route(dtype: torch.dtype, D: int) -> Optional[str]:
    """The K2 (bf16) / K4 and K11 (int8) kernel a CUDA sweep of this width
    launches: "wgmma" (the TMA-fed kernel, whose query tile stays in shared
    memory: bf16 D <= 768, int8 D <= 1152), "general" (the mma.sync kernel
    fed straight from device memory, any wider multiple of 32 / 64), or None
    where no kernel takes the width."""
    if dtype not in D_MULTIPLE or D <= 0 or D % D_MULTIPLE[dtype]:
        return None
    return "wgmma" if D <= WGMMA_MAX_D[dtype] else "general"


# each sweep by the pool it reads (the names of `UNIIR_TOPK_POOL`) and that pool's element type
_POOL_DTYPE = {"bf16": torch.bfloat16, "int8": torch.int8, "int8_bucket": torch.int8}


def _sweep_kernel(pool: str, D: int, general: bool):
    """The C entry a K2 ("bf16") / K4 ("int8") / K11 ("int8_bucket") launch
    of width D calls and the wrapper whose count it moves: the kernel
    `sweep_route` picks, or with `general` the general-width one."""
    return _SWEEP_KERNELS[pool, "general" if general else sweep_route(_POOL_DTYPE[pool], D)]


def _bf16_sweep(queries: torch.Tensor, pool: torch.Tensor, valid_n: Optional[int], general: bool) -> torch.Tensor:
    """K2 on a CUDA pool through `_sweep_kernel`; the twin on a CPU pool."""
    N = pool.shape[0]
    valid_n = N if valid_n is None else int(valid_n)
    if pool.device.type == "cpu":
        return bucket_max_scores_reference(queries, pool, valid_n)
    queries = queries.to(torch.bfloat16).contiguous()
    _check_sweep_args(queries, pool, valid_n, torch.bfloat16, D_MULTIPLE[torch.bfloat16])
    Q, D = queries.shape
    entry, counter = _sweep_kernel("bf16", D, general)
    out = torch.empty((Q, N // GROUP), dtype=torch.float32, device=pool.device)
    lib = _build.load("topk")
    err = getattr(lib, entry)(
        queries.data_ptr(), pool.data_ptr(), out.data_ptr(), Q, N, D, valid_n,
        torch.cuda.current_stream(pool.device).cuda_stream,
    )
    _build.check(lib, err, f"bf16 bucket-max kernel ({entry})")
    counter.launches += 1
    return out


def bucket_max_scores(queries: torch.Tensor, pool: torch.Tensor, valid_n: Optional[int] = None) -> torch.Tensor:
    """K2: [Q, D] x [N, D] -> strided-bucket maxima [Q, N/GROUP] fp32 (bf16
    sweep), through the kernel `sweep_route` picks for D."""
    return _bf16_sweep(queries, pool, valid_n, general=False)


def bucket_max_scores_general(queries: torch.Tensor, pool: torch.Tensor, valid_n: Optional[int] = None) -> torch.Tensor:
    """K2's general-width kernel: what `bucket_max_scores` launches where
    `sweep_route` says "general".  It takes the narrower widths too, which is
    how the two kernels are timed side by side."""
    return _bf16_sweep(queries, pool, valid_n, general=True)


bucket_max_scores.launches = 0
bucket_max_scores_general.launches = 0


def _int8_sweep(queries: torch.Tensor, pool_q: torch.Tensor, scale: torch.Tensor, valid_n: Optional[int],
                query_quant: Optional[Tuple[torch.Tensor, torch.Tensor]], general: bool,
                pool: Optional[str] = None) -> torch.Tensor:
    """What K4 and K11 share: take the queries' int8 values and scales from
    `query_quant`, or quantise them with `quantize_queries`, run the twin on
    a CPU pool, else check the arguments and launch through `_sweep_kernel`.
    `scale` holds one fp32 value per row (K4) or per bucket (K11); its
    length tells which, and must agree with `pool` ("int8" or
    "int8_bucket") where the caller names it."""
    N = pool_q.shape[0]
    valid_n = N if valid_n is None else int(valid_n)
    per_bucket = scale.shape == (N // GROUP,)
    if pool is not None and per_bucket != (pool == "int8_bucket"):
        want = N // GROUP if pool == "int8_bucket" else N
        raise ValueError(f"the {pool} sweep takes [{want}] scales, got {tuple(scale.shape)}")
    q_q, q_scale = quantize_queries(queries) if query_quant is None else query_quant
    if pool_q.device.type == "cpu":
        reference = bucket_max_scores_i8b_reference if per_bucket else bucket_max_scores_i8_reference
        return reference(q_q, q_scale, pool_q, scale, valid_n)
    _check_sweep_args(q_q, pool_q, valid_n, torch.int8, D_MULTIPLE[torch.int8])
    scales_per = "bucket" if per_bucket else "row"
    if (scale.shape not in ((N,), (N // GROUP,)) or scale.dtype != torch.float32 or not scale.is_contiguous()
            or scale.device != pool_q.device or scale.data_ptr() % 16):
        raise ValueError(f"the pool's scales must be a contiguous, 16-byte aligned fp32 [{N}] (one per row) or "
                         f"[{N // GROUP}] (one per bucket) tensor on {pool_q.device}")
    Q, D = q_q.shape
    entry, wrapper = _sweep_kernel("int8_bucket" if per_bucket else "int8", D, general)
    out = torch.empty((Q, N // GROUP), dtype=torch.float32, device=pool_q.device)
    lib = _build.load("topk")
    err = getattr(lib, entry)(
        q_q.data_ptr(), q_scale.data_ptr(), pool_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        Q, N, D, valid_n, torch.cuda.current_stream(pool_q.device).cuda_stream,
    )
    _build.check(lib, err, f"int8 bucket-max kernel (one scale per {scales_per})")
    wrapper.launches += 1
    return out


def bucket_max_scores_i8(
    queries: torch.Tensor, pool_q: torch.Tensor, pool_scale: torch.Tensor, valid_n: Optional[int] = None,
    query_quant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """K4: approximate strided-bucket maxima [Q, N/GROUP] fp32 over an int8
    pool with per-row scales, through the kernel `sweep_route` picks for D.
    The queries are quantised per row first (`quantize_queries`), unless the
    caller passes their int8 values and scales as `query_quant`.
    `pool_scale` selects the kernel by shape, as the reference does: [N] is
    K4, [N / GROUP] (one scale per bucket) hands over to K11."""
    return _int8_sweep(queries, pool_q, pool_scale, valid_n, query_quant, general=False)


def bucket_max_scores_i8_general(
    queries: torch.Tensor, pool_q: torch.Tensor, pool_scale: torch.Tensor, valid_n: Optional[int] = None,
    query_quant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """K4's general-width kernel (per-row scales): what
    `bucket_max_scores_i8` launches where `sweep_route` says "general"; it
    takes the narrower widths too."""
    return _int8_sweep(queries, pool_q, pool_scale, valid_n, query_quant, general=True, pool="int8")


bucket_max_scores_i8.launches = 0
bucket_max_scores_i8_general.launches = 0


def bucket_max_scores_i8b(
    queries: torch.Tensor, pool_q: torch.Tensor, bucket_scale: torch.Tensor, valid_n: Optional[int] = None,
    query_quant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """K11: approximate strided-bucket maxima [Q, N/GROUP] fp32 over an int8
    pool with one scale per bucket (`quantize_pool(per_bucket=True)`): the
    maximum is taken over the int32 dot products and only it is dequantised;
    through the kernel `sweep_route` picks for D."""
    return _int8_sweep(queries, pool_q, bucket_scale, valid_n, query_quant, general=False, pool="int8_bucket")


def bucket_max_scores_i8b_general(
    queries: torch.Tensor, pool_q: torch.Tensor, bucket_scale: torch.Tensor, valid_n: Optional[int] = None,
    query_quant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """K11's general-width kernel: what `bucket_max_scores_i8b` launches
    where `sweep_route` says "general"; it takes the narrower widths too."""
    return _int8_sweep(queries, pool_q, bucket_scale, valid_n, query_quant, general=True, pool="int8_bucket")


bucket_max_scores_i8b.launches = 0
bucket_max_scores_i8b_general.launches = 0

# (pool, sweep_route) -> the C entry of csrc/topk.cu and the wrapper that counts its launches
_SWEEP_KERNELS = {
    ("bf16", "wgmma"): ("uniir_bucket_max_bf16", bucket_max_scores),
    ("bf16", "general"): ("uniir_bucket_max_bf16_general", bucket_max_scores_general),
    ("int8", "wgmma"): ("uniir_bucket_max_i8", bucket_max_scores_i8),
    ("int8", "general"): ("uniir_bucket_max_i8_general", bucket_max_scores_i8_general),
    ("int8_bucket", "wgmma"): ("uniir_bucket_max_i8b", bucket_max_scores_i8b),
    ("int8_bucket", "general"): ("uniir_bucket_max_i8b_general", bucket_max_scores_i8b_general),
}


def _bucket_rows(bucket_ids: torch.Tensor) -> torch.Tensor:
    """Global pool rows of each strided bucket: [..., GROUP]."""
    m = torch.arange(GROUP, device=bucket_ids.device, dtype=bucket_ids.dtype)
    return (bucket_ids // LANES)[..., None] * CHUNK + m * LANES + (bucket_ids % LANES)[..., None]


def _top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index (lax.top_k's rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk(
    queries: torch.Tensor,
    pool: torch.Tensor,
    k: int,
    valid_n: Optional[int] = None,
    pool_quant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    overfetch: int = 2,
    with_guard: bool = False,
):
    """Exact top-k inner-product search (the `pallas_topk` contract).

    Returns (scores [Q, k] fp32, indices [Q, k] int64) and, with
    `with_guard`, a per-query bool `ok`.  `pool_quant=(pool_q, pool_scale)`
    runs the sweep on the int8 pool, selects `overfetch * k` buckets and
    rescores their rows exactly against the bf16 `pool`; `ok` says the k-th
    exact score clears the smallest selected int8 bucket maximum (always
    True on the bf16 path)."""
    Q = queries.shape[0]
    N = pool.shape[0]
    valid_n = N if valid_n is None else int(valid_n)
    if pool_quant is not None:
        # the JAX search jits `pallas_topk`, where XLA quantises the queries with a multiply by the reciprocal
        maxima = bucket_max_scores_i8(queries, pool_quant[0], pool_quant[1], valid_n, query_quant=quantize_rows(queries))
        k_sel = min(overfetch * k, maxima.shape[1])
    else:
        maxima = bucket_max_scores(queries, pool, valid_n)
        k_sel = k
    NB = maxima.shape[1]

    # hierarchical selection over the maxima: best 128-bucket tiles first
    if NB % LANES == 0 and NB > k_sel * LANES:
        tiles = maxima.view(Q, NB // LANES, LANES)
        tids = _top_k(tiles.amax(dim=-1), k_sel)[1]
        cand = torch.gather(tiles, 1, tids[:, :, None].expand(-1, -1, LANES)).reshape(Q, k_sel * LANES)
        pos = _top_k(cand, k_sel)[1]
        flat = (tids[:, :, None] * LANES + torch.arange(LANES, device=tids.device)).reshape(Q, k_sel * LANES)
        bucket_ids = torch.gather(flat, 1, pos)
    else:
        bucket_ids = _top_k(maxima, k_sel)[1]

    # rescore the selected buckets' rows: bf16 operands, fp32 sums
    row_ids = _bucket_rows(bucket_ids).reshape(Q, k_sel * GROUP)
    cand_rows = pool[row_ids].to(torch.bfloat16).float()  # [Q, k_sel*GROUP, D]
    q = queries.to(torch.bfloat16).float()
    scores = torch.bmm(cand_rows, q[:, :, None])[:, :, 0]
    scores = torch.where(row_ids < valid_n, scores, NEG)
    vals, pos = _top_k(scores, k)
    idx = torch.gather(row_ids, 1, pos)
    if not with_guard:
        return vals, idx
    if pool_quant is None:
        ok = torch.ones((Q,), dtype=torch.bool, device=vals.device)
    else:
        cut = torch.gather(maxima, 1, bucket_ids).amin(dim=1)
        ok = vals[:, k - 1] >= cut
    return vals, idx, ok


def shard_pool(embeds: np.ndarray, device) -> Tuple[torch.Tensor, int]:
    """This rank's row shard of a host pool, uploaded once as `prepare_pool`
    uploads a pool (bf16, zero rows to a CHUNK multiple, at least one chunk):
    rows [r * S, (r + 1) * S) of the pool padded to W * S rows, S =
    ceil(N / W), as the JAX `shard_pool` splits it.  Returns (shard, S)."""
    N = embeds.shape[0]
    shard_rows = -(-N // mesh.process_count())
    lo = min(mesh.process_index() * shard_rows, N)
    hi = min(lo + shard_rows, N)
    if hi == lo:
        return torch.zeros((CHUNK, embeds.shape[1]), dtype=torch.bfloat16, device=device), shard_rows
    return prepare_pool(embeds[lo:hi], device)[0], shard_rows


def merge_topk(scores: torch.Tensor, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best of [Q, M] candidates by score, ties to the lower id (the
    rule `lax.top_k` applies to a whole row): a stable sort by id, then a
    stable sort by score."""
    ids, order = torch.sort(ids, dim=1, stable=True)
    vals, pos = _top_k(torch.gather(scores, 1, order), k)
    return vals, torch.gather(ids, 1, pos)


def shard_topk(
    queries: torch.Tensor, pool_shard: torch.Tensor, k: int, valid_n: int, shard_rows: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's part of `sharded_topk`: `topk` over its shard (K2 on the
    card, its twin on the CPU), rows past the pool masked before the
    selection; returns (scores [Q, k], global ids [Q, k])."""
    base = mesh.process_index() * shard_rows
    local_valid = max(0, min(valid_n - base, shard_rows))
    scores, rows = topk(queries, pool_shard, min(k, pool_shard.shape[0]), valid_n=local_valid)
    return torch.where(rows < local_valid, scores, NEG), rows + base


def merge_shards(scores: torch.Tensor, ids: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's [Q, k] partials (scores and global ids), gathered and
    merged by `merge_topk`: the same result on every rank."""
    Q = scores.shape[0]
    all_scores = mesh.gather_rows(scores[None]).permute(1, 0, 2).reshape(Q, -1)
    all_ids = mesh.gather_rows(ids[None]).permute(1, 0, 2).reshape(Q, -1)
    return merge_topk(all_scores, all_ids, k)


def sharded_topk(
    queries: torch.Tensor, pool_shard: torch.Tensor, k: int, valid_n: int, shard_rows: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a pool sharded by rows over the ranks (the JAX
    `sharded_topk`): this rank's shard holds global rows [r * shard_rows,
    ...) of a pool of `valid_n` rows (`shard_pool`).  Each rank sweeps its
    shard (`shard_topk`) and the ranks merge their partials
    (`merge_shards`).  Every rank returns the same (scores [Q, k] fp32,
    global ids [Q, k] int64); k is clamped to `valid_n`."""
    k = min(k, valid_n)
    return merge_shards(*shard_topk(queries, pool_shard, k, valid_n, shard_rows), k)
