"""Fused attention over model-native [B, L, H*D] tensors: kernels K1, K3, K8, K9, K10.

`attention` is the one op the transformer blocks call for bf16
self-attention.  It is differentiable: a `torch.autograd.Function` whose
forward is K1 (`csrc/attention.cu`, the counterpart of
`uniir_tpu/ops/attention_pallas.py::mha_paired_stack`) and whose backward
is K3 (`csrc/attention_bwd.cu`, the counterpart of `mha_paired_stack_bwd`),
saving only q, k and v as the JAX package's `paired_attention` does.  On a
CUDA tensor each launches its kernel or raises; on a CPU tensor each runs
its plain PyTorch twin (`attention_reference`, `attention_bwd_reference`).
`attention_twin` is the same Function over the twins on any device: the
reference the kernels are held against.

Which kernel runs is a static rule over the shape, settled before any
launch (`forward_route`, `backward_route`, `kernel_supported`).  K1 and K3
each have two kernels of one function: the one-block-a-head kernels
(`attention_fused_fwd_kernel`, `attention_fused_bwd_kernel`: a head's K and V
staged once, the score row in registers) for L <= FUSED_MAX_L, which covers
every length the models use (77, 197, 257), and the general-length kernels
(`attention_fwd_general`, `attention_bwd_general`: a block per 64-row tile)
for longer sequences up to what their shared memory holds.  A head width
other than 64, or a length no kernel takes, has no kernel: the model's
attention layer asks `kernel_supported` and takes its einsum path, as the
JAX layer asks `paired_attention_supported`; called directly, the wrappers
raise.

With `splitk=True` (the JAX package's `UNIIR_ATTN_SPLITK=1`) a non-causal
call whose valid length is one past a multiple of 128 -- CLIP's vision
tower, L = 257 -- takes K10 as its forward (`attention_splitk`, the
counterpart of `_paired_stack_splitk_kernel`): K1's function with the last
key folded in as a rank-1 term at other rounding points, with the plain twin
`attention_splitk_reference`.  Every other call runs K1, as
`mha_paired_stack` does; the backward stays K3 either way.

`mha_nocausal` (K8, over [B, L, H, D]) and `mha_paired` (K9, over
[B, L, H*D], optionally causal) are the counterparts of the JAX package's
stand-alone Pallas kernels of those names.  They compute K1's function with
other rounding points (scores scaled in fp32 after the product, the
probabilities normalised and rounded to bf16 before the PV product): the
NORM_FIRST variant of `csrc/attention.cu`, with the plain twin
`attention_twopass_reference`.  Forward only, as in the JAX package.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional

import torch

from uniir_tpu_torch import _build

NEG = -1e30  # score of a masked key (the reference kernel's value)
HEAD_DIM = 64  # the CUDA kernels' head width
MAX_SMEM_BYTES = 232448  # opt-in shared memory per block on sm_90
FUSED_MAX_L = 272  # the one-block-a-head kernels keep a 64-row tile's scores over all keys in registers


def _general_fwd_smem(L: int) -> int:
    l_pad = -(-L // 16) * 16
    return l_pad * (HEAD_DIM + 8) * 2 + HEAD_DIM * (l_pad + 8) * 2  # K rows and V^T (smem_bytes in attention.cu)


def _general_bwd_smem(L: int) -> int:
    l_pad = -(-L // 16) * 16
    return 2 * l_pad * (HEAD_DIM + 8) * 2 + HEAD_DIM * (l_pad + 8) * 2  # K, V rows and K^T (dq_smem_bytes)


def _route(head_dim: int, L: int, general_smem: Callable[[int], int]) -> Optional[str]:
    if head_dim != HEAD_DIM or L < 1:
        return None
    if L <= FUSED_MAX_L:
        return "fused"
    return "general" if general_smem(L) <= MAX_SMEM_BYTES else None


def forward_route(head_dim: int, L: int) -> Optional[str]:
    """The K1 kernel a CUDA bf16 call of this shape launches: "fused" (one
    block a head, L <= 272), "general" (L <= 848), or None where no kernel
    takes the shape."""
    return _route(head_dim, L, _general_fwd_smem)


def backward_route(head_dim: int, L: int) -> Optional[str]:
    """The K3 kernel for this shape: "fused" (L <= 272), "general"
    (L <= 544), or None."""
    return _route(head_dim, L, _general_bwd_smem)


def kernel_supported(heads: int, width: int, L: int, training: bool) -> bool:
    """Whether `attention` has a kernel for [B, L, width] with `heads` heads:
    K1 for the forward and, when a gradient will be asked (`training`), K3
    for the backward.  The model's attention layer takes its einsum path
    where this is False, as the JAX layer does where
    `paired_attention_supported` is."""
    if heads < 1 or width % heads:
        return False
    head_dim = width // heads
    return forward_route(head_dim, L) is not None and (not training or backward_route(head_dim, L) is not None)


@functools.lru_cache(maxsize=None)
def _bf16_scale(scale: float) -> float:
    # the reference kernel multiplies bf16 q by bf16(scale); cached: the wrappers run it every launch
    return float(torch.tensor(scale, dtype=torch.bfloat16))


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, l_valid: Optional[int]) -> int:
    """Validate shapes; returns the number of valid positions."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 3:
        raise ValueError(f"q, k, v must share one [B, L, H*D] shape, got {q.shape}, {k.shape}, {v.shape}")
    L, W = q.shape[1], q.shape[2]
    if W % heads:
        raise ValueError(f"width {W} is not a multiple of {heads} heads")
    lv = L if l_valid is None else int(l_valid)
    if not 0 < lv <= L:
        raise ValueError(f"l_valid={lv} outside (0, {L}]")
    return lv


def _check_cuda(tensors: dict, heads: int) -> None:
    """What both CUDA kernels take: contiguous, 16-byte aligned bf16 with head_dim 64."""
    first = next(iter(tensors.values()))
    if not first.is_cuda:
        raise ValueError(f"attention runs on CUDA or CPU tensors, not {first.device}")
    D = first.shape[2] // heads
    if D != HEAD_DIM:
        raise ValueError(f"the CUDA kernels take head_dim {HEAD_DIM}, got {D}")
    for name, t in tensors.items():
        if t.dtype != torch.bfloat16 or t.device != first.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned bf16 tensor on {first.device}")


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    causal: bool = False,
    l_valid: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch twin of K1, with the kernel's rounding points.

    q is scaled and rounded to bf16; scores, max, exp and row sums are fp32;
    the unnormalised probabilities are rounded to bf16 for the PV product,
    which accumulates in fp32 and is then multiplied by 1/rowsum.  Keys
    >= l_valid (and future keys when causal) are masked by select, and V rows
    >= l_valid are zeroed by select.  Output rows >= l_valid are computed
    like any other and are the caller's to discard.
    """
    B, L, W = q.shape
    D = W // heads
    lv = L if l_valid is None else l_valid
    sc = _bf16_scale(D**-0.5 if scale is None else scale)
    key = torch.arange(L, device=q.device)
    qs = (q.float() * sc).to(torch.bfloat16).float().view(B, L, heads, D)
    kf = k.float().view(B, L, heads, D)
    vf = torch.where((key < lv)[None, :, None], v.float(), 0.0).view(B, L, heads, D)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    keep = (key < lv)[None, :]
    if causal:
        keep = keep & (key[None, :] <= key[:, None])
    s = torch.where(keep, s, NEG)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    inv = (1.0 / e.sum(-1, keepdim=True)).permute(0, 2, 1, 3)  # [B, Lq, H, 1]
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(torch.bfloat16).float(), vf) * inv
    return o.reshape(B, L, W).to(q.dtype)


def attn_splitk_from_env() -> bool:
    """`UNIIR_ATTN_SPLITK` (the JAX package's opt-in, default "0"): "1" makes
    K10 the forward of the attention calls it takes.  Read once, where a
    model is built (`models/registry.py`)."""
    value = os.environ.get("UNIIR_ATTN_SPLITK", "0")
    if value not in ("0", "1"):
        raise ValueError(f"UNIIR_ATTN_SPLITK must be 0 or 1, got {value!r}")
    return value == "1"


def splitk_applies(l_valid: int, causal: bool) -> bool:
    """The shapes `mha_paired_stack` gives its split-K kernel
    (attention_pallas.py:466-472, without the flag)."""
    return not causal and l_valid % 128 == 1 and l_valid > 128


def attention_splitk_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    l_valid: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch twin of K10, with the rounding points of
    `_paired_stack_splitk_kernel` (attention_pallas.py:352-403).

    qs = bf16(q * bf16(scale)); s_main = fp32 scores over the first Km =
    l_valid - 1 keys, unmasked; s_last = the fp32 sum over a head's lanes of
    bf16(qs * k_last), each product rounded to bf16; m = max(max(s_main),
    s_last); rsum = sum(exp(s_main - m)) + exp(s_last - m), in that order; o =
    (fp32(bf16(e) v_main) + fp32(bf16(bf16(e_last) * v_last))) * (1 / rsum).
    Non-causal; output rows >= l_valid are the caller's to discard."""
    B, L, W = q.shape
    D = W // heads
    lv = L if l_valid is None else l_valid
    km = lv - 1
    sc = _bf16_scale(D**-0.5 if scale is None else scale)
    qs = (q.float() * sc).to(torch.bfloat16).view(B, L, heads, D)
    kb, vb = (t.to(torch.bfloat16).view(B, L, heads, D) for t in (k, v))
    s_main = torch.einsum("bqhd,bkhd->bqhk", qs.float(), kb[:, :km].float())
    s_last = (qs * kb[:, km : km + 1]).float().sum(-1, keepdim=True)  # bf16 products, fp32 sum: [B, L, H, 1]
    m = torch.maximum(s_main.amax(-1, keepdim=True), s_last)
    e, e_last = torch.exp(s_main - m), torch.exp(s_last - m)
    rsum = e.sum(-1, keepdim=True) + e_last
    o = torch.einsum("bqhk,bkhd->bqhd", e.to(torch.bfloat16).float(), vb[:, :km].float())
    o = o + (e_last.to(torch.bfloat16) * vb[:, km : km + 1]).float()
    return (o * (1.0 / rsum)).reshape(B, L, W).to(q.dtype)


def attention_splitk(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    l_valid: Optional[int] = None,
) -> torch.Tensor:
    """K10, forward only: split-K attention over [B, L, H*64] for a valid
    length that is one past a multiple of 128.  On a CUDA tensor it launches
    the kernel or raises; on a CPU tensor it runs the twin."""
    lv = _check_args(q, k, v, heads, l_valid)
    if not splitk_applies(lv, causal=False):
        raise ValueError(f"split-K attention takes l_valid % 128 == 1 and l_valid > 128, got {lv}")
    if q.device.type == "cpu":
        return attention_splitk_reference(q, k, v, heads, scale, lv)
    _check_cuda({"q": q, "k": k, "v": v}, heads)
    B, L, W = q.shape
    km = lv - 1
    if km * (HEAD_DIM + 8) * 2 + HEAD_DIM * (km + 8) * 2 + 4 * HEAD_DIM > MAX_SMEM_BYTES:
        raise ValueError(f"sequence length {lv} needs more shared memory than one block has")
    lib = _build.load("attention")
    out = torch.empty_like(q)
    err = lib.uniir_attention_splitk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, heads, lv,
        _bf16_scale((W // heads) ** -0.5 if scale is None else scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "split-K attention kernel")
    attention_splitk.launches += 1
    return out


def _splitk_fwd(q, k, v, heads: int, scale: Optional[float], causal: bool, l_valid: int) -> torch.Tensor:
    return attention_splitk(q, k, v, heads, scale, l_valid)


def _splitk_twin(q, k, v, heads: int, scale: Optional[float], causal: bool, l_valid: int) -> torch.Tensor:
    return attention_splitk_reference(q, k, v, heads, scale, l_valid)


def attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    causal: bool = False,
    l_valid: Optional[int] = None,
):
    """Plain PyTorch twin of K3: (dq, dk, dv) of `attention_reference`'s
    function with the rounding points of `_paired_stack_bwd_kernel`
    (attention_pallas.py:576-649).

    Rows >= l_valid of q, k, v and g are zeroed by select; q * bf16(scale)
    and g are rounded to bf16; scores, row max and p = e / rowsum are fp32
    (keys >= l_valid and future keys masked to NEG by select); dv =
    bf16(p)^T g; dp = g v^T; ds = bf16(p * (dp - rowsum(p * dp))); dq =
    (ds k) * scale in fp32 after the product; dk = ds^T qs.  Products take
    bf16 values and sum in fp32; each gradient comes back in its input's
    dtype.
    """
    B, L, W = q.shape
    D = W // heads
    lv = L if l_valid is None else l_valid
    sc = D**-0.5 if scale is None else scale
    pos = torch.arange(L, device=q.device)
    row_ok = (pos < lv)[None, :, None]

    def rows(x: torch.Tensor) -> torch.Tensor:
        return torch.where(row_ok, x, 0.0).view(B, L, heads, D)

    qs = rows((q.float() * _bf16_scale(sc)).to(torch.bfloat16).float())
    kf, vf, gf = (rows(t.to(torch.bfloat16).float()) for t in (k, v, g))
    keep = (pos < lv)[None, :]
    if causal:
        keep = keep & (pos[None, :] <= pos[:, None])
    s = torch.where(keep, torch.einsum("bqhd,bkhd->bhqk", qs, kf), NEG)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(torch.bfloat16).float(), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * sc
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    return tuple(d.reshape(B, L, W).to(t.dtype) for d, t in ((dq, q), (dk, k), (dv, v)))


def _launch_fwd(entry: str, what: str, q, k, v, heads: int, scale: Optional[float], causal: bool, l_valid: int):
    B, L, W = q.shape
    lib = _build.load("attention")
    out = torch.empty_like(q)
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, heads, l_valid, int(causal),
        _bf16_scale((W // heads) ** -0.5 if scale is None else scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, what)
    return out


def attention_fwd_general(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    causal: bool = False,
    l_valid: Optional[int] = None,
) -> torch.Tensor:
    """K1's general-length kernel (a block per 64-query tile, K and V^T of
    all keys in shared memory), forward only, on CUDA tensors: what
    `attention` launches for 272 < L <= 848.  It takes the shorter lengths
    too, which is how the two kernels are timed side by side."""
    lv = _check_args(q, k, v, heads, l_valid)
    _check_cuda({"q": q, "k": k, "v": v}, heads)
    if _general_fwd_smem(q.shape[1]) > MAX_SMEM_BYTES:
        raise ValueError(f"sequence length {q.shape[1]} needs more shared memory than one block has")
    out = _launch_fwd("uniir_attention_fwd", "attention kernel (general length)", q, k, v, heads, scale, causal, lv)
    attention_fwd_general.launches += 1
    return out


def _attention_fwd(q, k, v, heads: int, scale: Optional[float], causal: bool, l_valid: int) -> torch.Tensor:
    """K1 on a CUDA tensor (the kernel `forward_route` names), its twin on a CPU tensor."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, heads, scale, causal, l_valid)
    _check_cuda({"q": q, "k": k, "v": v}, heads)
    route = forward_route(q.shape[2] // heads, q.shape[1])
    if route == "general":
        return attention_fwd_general(q, k, v, heads, scale, causal, l_valid)
    if route is None:
        raise ValueError(f"sequence length {q.shape[1]} needs more shared memory than one block has")
    out = _launch_fwd("uniir_attention_fused_fwd", "attention kernel", q, k, v, heads, scale, causal, l_valid)
    attention.launches += 1
    return out


def _launch_bwd(entry: str, what: str, q, k, v, g, heads: int, scale: Optional[float], causal: bool, l_valid: int,
                stats: Optional[torch.Tensor]):
    W = q.shape[2]
    lib = _build.load("attention_bwd")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sc = (W // heads) ** -0.5 if scale is None else scale
    scratch = () if stats is None else (stats.data_ptr(),)
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *scratch, q.shape[0], q.shape[1], heads, l_valid, int(causal), _bf16_scale(sc), sc,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, what)
    return dq, dk, dv


def _check_bwd_args(q, k, v, g, heads: int, l_valid: Optional[int]) -> int:
    lv = _check_args(q, k, v, heads, l_valid)
    if g.shape != q.shape:
        raise ValueError(f"g must have q's shape {q.shape}, got {g.shape}")
    return lv


def attention_bwd_general(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    causal: bool = False,
    l_valid: Optional[int] = None,
):
    """K3's general-length kernels (two launches, a block per 64-row tile,
    the row statistics through an fp32 scratch in device memory) on CUDA
    tensors: what `attention_bwd` launches for 272 < L <= 544.  It takes the
    shorter lengths too, which is how the two are timed side by side."""
    lv = _check_bwd_args(q, k, v, g, heads, l_valid)
    _check_cuda({"q": q, "k": k, "v": v, "g": g}, heads)
    B, L, _ = q.shape
    if _general_bwd_smem(L) > MAX_SMEM_BYTES:
        raise ValueError(f"sequence length {L} needs more shared memory than one backward block has")
    stats = torch.empty(3 * B * heads * L, dtype=torch.float32, device=q.device)  # row max, row sum, delta
    out = _launch_bwd("uniir_attention_bwd", "attention backward kernel (general length)", q, k, v, g, heads, scale,
                      causal, lv, stats)
    attention_bwd_general.launches += 1
    return out


def attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    g: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    causal: bool = False,
    l_valid: Optional[int] = None,
):
    """(dq, dk, dv) of `attention` for the cotangent g; see K3 in
    csrc/attention_bwd.cu.  On CUDA tensors the kernel `backward_route`
    names, on CPU tensors the twin."""
    lv = _check_bwd_args(q, k, v, g, heads, l_valid)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, g, heads, scale, causal, lv)
    _check_cuda({"q": q, "k": k, "v": v, "g": g}, heads)
    route = backward_route(q.shape[2] // heads, q.shape[1])
    if route == "general":
        return attention_bwd_general(q, k, v, g, heads, scale, causal, lv)
    if route is None:
        raise ValueError(f"sequence length {q.shape[1]} needs more shared memory than one backward block has")
    out = _launch_bwd("uniir_attention_fused_bwd", "attention backward kernel", q, k, v, g, heads, scale, causal, lv,
                      None)
    attention_bwd.launches += 1
    return out


class _Attention(torch.autograd.Function):
    """Forward `fwd`, backward `bwd`; saves q, k, v (the JAX `_paired_fwd`)."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale, causal, l_valid, fwd: Callable, bwd: Callable):
        ctx.save_for_backward(q, k, v)
        ctx.args = (heads, scale, causal, l_valid)
        ctx.bwd = bwd
        return fwd(q, k, v, heads, scale, causal, l_valid)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, g.contiguous(), *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    causal: bool = False,
    l_valid: Optional[int] = None,
    splitk: bool = False,
) -> torch.Tensor:
    """softmax(q k^T * scale) v per head over [B, L, H*D], differentiable:
    K1 forward (csrc/attention.cu), K3 backward (csrc/attention_bwd.cu), each
    through the kernel its route names (`forward_route`, `backward_route`).
    `splitk` makes K10 the forward where `splitk_applies`, K1 elsewhere."""
    lv = _check_args(q, k, v, heads, l_valid)
    fwd = _splitk_fwd if splitk and splitk_applies(lv, causal) else _attention_fwd
    return _Attention.apply(q, k, v, heads, scale, causal, lv, fwd, attention_bwd)


def attention_twin(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    causal: bool = False,
    l_valid: Optional[int] = None,
    splitk: bool = False,
) -> torch.Tensor:
    """`attention` through the plain twins of K1 (or K10) and K3 on any device."""
    lv = _check_args(q, k, v, heads, l_valid)
    fwd = _splitk_twin if splitk and splitk_applies(lv, causal) else attention_reference
    return _Attention.apply(q, k, v, heads, scale, causal, lv, fwd, attention_bwd_reference)


def attention_twopass_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: Optional[float] = None, causal: bool = False
) -> torch.Tensor:
    """Plain PyTorch twin of K8 / K9 over [B, L, H*D], with the rounding
    points of `_attn_kernel` / `_paired_kernel` (attention_pallas.py:35-52,
    137-155): q, k, v as bf16 values; s = fp32(q k^T) * scale in fp32; future
    keys (when causal) masked to NEG by select; p = bf16(exp(s - max) /
    rowsum); o = fp32-accumulated p v, cast to q's dtype.  Any head width."""
    B, L, W = q.shape
    D = W // heads
    sc = D**-0.5 if scale is None else scale
    qf, kf, vf = (t.to(torch.bfloat16).float().view(B, L, heads, D) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sc
    if causal:
        pos = torch.arange(L, device=q.device)
        s = torch.where(pos[None, :] <= pos[:, None], s, NEG)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).reshape(B, L, W).to(q.dtype)


def _norm_first_fwd(q, k, v, heads: int, scale: Optional[float], causal: bool) -> torch.Tensor:
    """The NORM_FIRST kernel over [B, L, H*64] CUDA tensors (the caller counts the launch)."""
    _check_cuda({"q": q, "k": k, "v": v}, heads)
    B, L, W = q.shape
    if _general_fwd_smem(L) > MAX_SMEM_BYTES:
        raise ValueError(f"sequence length {L} needs more shared memory than one block has")
    lib = _build.load("attention")
    out = torch.empty_like(q)
    err = lib.uniir_attention_norm_first_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, heads, L, int(causal),
        float((W // heads) ** -0.5 if scale is None else scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "attention kernel (normalise-first variant)")
    return out


def mha_nocausal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Fused non-causal attention, q / k / v [B, L, H, D] -> [B, L, H, D]
    (K8, the counterpart of `mha_nocausal`).  A contiguous [B, L, H, D] is a
    contiguous [B, L, H*D], so the kernel reads it in place.  On CUDA: bf16,
    D = 64, or it raises; on the CPU the twin takes any D."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, L, H, D] shape, got {q.shape}, {k.shape}, {v.shape}")
    B, L, H, D = q.shape
    flat = [t.reshape(B, L, H * D) for t in (q, k, v)]
    scale = D**-0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_twopass_reference(*flat, H, scale).view(B, L, H, D)
    out = _norm_first_fwd(*flat, H, scale, False)
    mha_nocausal.launches += 1
    return out.view(B, L, H, D)


def mha_paired(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: Optional[float] = None, causal: bool = False
) -> torch.Tensor:
    """Fused attention over model-native [B, L, H*D] tensors, optionally
    causal (K9, the counterpart of `mha_paired`).  On CUDA: bf16, D = 64, or
    it raises; on the CPU the twin takes any D."""
    _check_args(q, k, v, heads, None)
    if q.device.type == "cpu":
        return attention_twopass_reference(q, k, v, heads, scale, causal)
    out = _norm_first_fwd(q, k, v, heads, scale, causal)
    mha_paired.launches += 1
    return out


attention.launches = 0
attention_fwd_general.launches = 0
attention_splitk.launches = 0
attention_bwd.launches = 0
attention_bwd_general.launches = 0
mha_nocausal.launches = 0
mha_paired.launches = 0
