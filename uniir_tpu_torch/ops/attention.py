"""Fused attention over model-native [B, L, H*D] tensors: kernels K1 and K3.

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
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from uniir_tpu_torch import _build

NEG = -1e30  # score of a masked key (the reference kernel's value)
HEAD_DIM = 64  # the CUDA kernels' head width
MAX_SMEM_BYTES = 232448  # opt-in shared memory per block on sm_90


def _bf16_scale(scale: float) -> float:
    # the reference kernel multiplies bf16 q by bf16(scale)
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


def _attention_fwd(q, k, v, heads: int, scale: Optional[float], causal: bool, l_valid: int) -> torch.Tensor:
    """K1 on a CUDA tensor, its twin on a CPU tensor."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, heads, scale, causal, l_valid)
    _check_cuda({"q": q, "k": k, "v": v}, heads)
    B, L, W = q.shape
    l_pad = -(-L // 16) * 16
    if l_pad * (HEAD_DIM + 8) * 2 + HEAD_DIM * (l_pad + 8) * 2 > MAX_SMEM_BYTES:
        raise ValueError(f"sequence length {L} needs more shared memory than one block has")
    lib = _build.load("attention")
    out = torch.empty_like(q)
    err = lib.uniir_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, heads, l_valid, int(causal),
        _bf16_scale((W // heads) ** -0.5 if scale is None else scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "attention kernel")
    attention.launches += 1
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
    """(dq, dk, dv) of `attention` for the cotangent g; see K3 in csrc/attention_bwd.cu."""
    lv = _check_args(q, k, v, heads, l_valid)
    if g.shape != q.shape:
        raise ValueError(f"g must have q's shape {q.shape}, got {g.shape}")
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, g, heads, scale, causal, lv)
    _check_cuda({"q": q, "k": k, "v": v, "g": g}, heads)
    B, L, W = q.shape
    l_pad = -(-L // 16) * 16
    if 2 * l_pad * (HEAD_DIM + 8) * 2 + HEAD_DIM * (l_pad + 8) * 2 > MAX_SMEM_BYTES:
        raise ValueError(f"sequence length {L} needs more shared memory than one backward block has")
    lib = _build.load("attention_bwd")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(3 * B * heads * L, dtype=torch.float32, device=q.device)  # row max, row sum, delta
    sc = (W // heads) ** -0.5 if scale is None else scale
    err = lib.uniir_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), B, L, heads, lv, int(causal), _bf16_scale(sc), sc,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "attention backward kernel")
    attention_bwd.launches += 1
    return dq, dk, dv


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
) -> torch.Tensor:
    """softmax(q k^T * scale) v per head over [B, L, H*D], differentiable:
    K1 forward (csrc/attention.cu), K3 backward (csrc/attention_bwd.cu)."""
    lv = _check_args(q, k, v, heads, l_valid)
    return _Attention.apply(q, k, v, heads, scale, causal, lv, _attention_fwd, attention_bwd)


def attention_twin(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    causal: bool = False,
    l_valid: Optional[int] = None,
) -> torch.Tensor:
    """`attention` through the plain twins of K1 and K3 on any device."""
    lv = _check_args(q, k, v, heads, l_valid)
    return _Attention.apply(q, k, v, heads, scale, causal, lv, attention_reference, attention_bwd_reference)


attention.launches = 0
attention_bwd.launches = 0
