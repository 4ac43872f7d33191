"""Fused attention over model-native [B, L, H*D] tensors: kernel K1.

`attention` is the one op the transformer blocks call for bf16
self-attention.  On a CUDA tensor it launches the hand-written kernel in
`csrc/attention.cu` (the counterpart of
`uniir_tpu/ops/attention_pallas.py::mha_paired_stack`); on a CPU tensor it
runs `attention_reference`, the plain PyTorch twin of the same arithmetic.
"""

from __future__ import annotations

from typing import Optional

import torch

from uniir_tpu_torch import _build

NEG = -1e30  # score of a masked key (the reference kernel's value)
HEAD_DIM = 64  # the CUDA kernel's head width
MAX_SMEM_BYTES = 232448  # opt-in shared memory per block on sm_90


def _bf16_scale(scale: float) -> float:
    # the reference kernel multiplies bf16 q by bf16(scale)
    return float(torch.tensor(scale, dtype=torch.bfloat16))


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


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    heads: int,
    scale: Optional[float] = None,
    causal: bool = False,
    l_valid: Optional[int] = None,
) -> torch.Tensor:
    """softmax(q k^T * scale) v per head over [B, L, H*D]; see K1 in csrc/attention.cu."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 3:
        raise ValueError(f"q, k, v must share one [B, L, H*D] shape, got {q.shape}, {k.shape}, {v.shape}")
    B, L, W = q.shape
    if W % heads:
        raise ValueError(f"width {W} is not a multiple of {heads} heads")
    lv = L if l_valid is None else int(l_valid)
    if not 0 < lv <= L:
        raise ValueError(f"l_valid={lv} outside (0, {L}]")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, heads, scale, causal, lv)
    if not q.is_cuda:
        raise ValueError(f"attention runs on CUDA or CPU tensors, not {q.device}")
    D = W // heads
    if D != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head_dim {HEAD_DIM}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned bf16 tensor on {q.device}")
    l_pad = -(-L // 16) * 16
    if l_pad * (HEAD_DIM + 8) * 2 + HEAD_DIM * (l_pad + 8) * 2 > MAX_SMEM_BYTES:
        raise ValueError(f"sequence length {L} needs more shared memory than one block has")
    lib = _build.load("attention")
    out = torch.empty_like(q)
    err = lib.uniir_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, heads, lv, int(causal),
        _bf16_scale(D**-0.5 if scale is None else scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "attention kernel")
    attention.launches += 1
    return out


attention.launches = 0
