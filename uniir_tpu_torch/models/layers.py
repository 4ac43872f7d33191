"""Transformer building blocks, bf16 serving path (counterpart of uniir_tpu/models/layers.py).

Parameter names follow OpenAI CLIP's state dict (`attn.in_proj_weight`,
`mlp.c_fc`, `ln_1`, `transformer.resblocks.<i>`, ...), so a published
checkpoint loads directly.  Arithmetic follows the JAX package: LayerNorm
statistics in fp32 with eps 1e-6 (flax's default), matmuls in the module's
parameter dtype, fp32 softmax, and bf16 self-attention through kernel K1
(`ops.attention.attention`).

Not carried over here: int8 projections (`quant`), the padded-flat tower
(`flat`) and rematerialisation (`remat`).  Asking for quant or remat raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from uniir_tpu_torch.ops.attention import attention

LN_EPS = 1e-6  # flax nn.LayerNorm's default (PyTorch's and OpenAI CLIP's is 1e-5)


def _not_ported(what: str, queue: str):
    return NotImplementedError(f"{what} is not ported to uniir_tpu_torch yet (ROADMAP.md, {queue})")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated at 2 std, rescaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm: fp32 statistics and affine, output in the input's dtype."""

    def __init__(self, width: int):
        super().__init__(width, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.float(), self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape, w, b, self.eps).to(x.dtype)


def qkv_project(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, kv: Optional[torch.Tensor] = None):
    """The fused [3W, W] in_proj applied as three row-sliced products
    (layers.py:61-85): each of q, k, v comes out contiguous for K1."""
    W = weight.shape[1]
    kv = x if kv is None else kv
    return tuple(F.linear(inp, weight[i * W : (i + 1) * W], bias[i * W : (i + 1) * W]) for i, inp in enumerate((x, kv, kv)))


class MultiHeadAttention(nn.Module):
    """Multi-head attention with a fused in_proj (OpenAI CLIP's nn.MultiheadAttention layout).

    bf16 self-attention with no explicit mask goes through kernel K1; every
    other case (fp32, cross/pooled attention, an explicit mask) takes the
    plain einsum path, as in the JAX package."""

    def __init__(self, width: int, num_heads: int, causal: bool = False, quant: bool = False):
        super().__init__()
        if quant:
            raise _not_ported("int8 attention projections", "Queue 1 item 6")
        self.width, self.num_heads, self.causal = width, num_heads, causal
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.in_proj_weight, self.width, generator)
        self.in_proj_bias.zero_()
        nn.init.xavier_uniform_(self.out_proj.weight, generator=generator)
        self.out_proj.bias.zero_()

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None):
        q, k, v = qkv_project(x, self.in_proj_weight, self.in_proj_bias, kv)
        head_dim = self.width // self.num_heads
        scale = head_dim**-0.5
        if kv is None and mask is None and q.dtype == torch.bfloat16:
            return self.out_proj(attention(q, k, v, self.num_heads, scale, self.causal))

        B, Lq, Lk = x.shape[0], q.shape[1], k.shape[1]
        if self.causal and mask is None:
            mask = torch.tril(torch.ones((Lq, Lk), dtype=torch.bool, device=x.device))[None, None]
        q = q.view(B, Lq, self.num_heads, head_dim)
        k = k.view(B, Lk, self.num_heads, head_dim)
        v = v.view(B, Lk, self.num_heads, head_dim)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        if mask is not None:  # broadcastable to [B, H, Lq, Lk]; False -> masked
            logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, Lq, self.width)
        return self.out_proj(out)


class MLP(nn.Module):
    """c_fc -> QuickGELU -> c_proj; with `res` the residual add is part of it."""

    def __init__(self, width: int, hidden_width: int, quant: bool = False):
        super().__init__()
        if quant:
            raise _not_ported("int8 MLP projections", "Queue 1 item 6")
        self.width, self.hidden_width = width, hidden_width
        self.c_fc = nn.Linear(width, hidden_width)
        self.c_proj = nn.Linear(hidden_width, width)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.c_fc.weight, self.width, generator)
        lecun_normal_(self.c_proj.weight, self.hidden_width, generator)
        self.c_fc.bias.zero_()
        self.c_proj.bias.zero_()

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.c_proj(quick_gelu(self.c_fc(x)))
        return x if res is None else res + x


class TransformerBlock(nn.Module):
    """Pre-LN residual block (CLIP's ResidualAttentionBlock)."""

    def __init__(self, width: int, num_heads: int, causal: bool = False, quant: bool = False):
        super().__init__()
        self.causal = causal
        self.attn = MultiHeadAttention(width, num_heads, causal=causal, quant=quant)
        self.ln_1 = LayerNorm(width)
        self.mlp = MLP(width, 4 * width, quant=quant)
        self.ln_2 = LayerNorm(width)

    def forward(self, x: torch.Tensor, pool_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        if pool_idx is None:
            x = x + self.attn(self.ln_1(x))
            return self.mlp(self.ln_2(x), res=x)
        # Pooled-query block (layers.py:344-363): only the token at pool_idx
        # ([B]) is read downstream, so attention runs for that one query row
        # (keys: the whole sequence, or for a causal tower the positions <=
        # its own) and the MLP on one token -- exact for that token.
        B, L = x.shape[0], x.shape[1]
        rows = torch.arange(B, device=x.device)
        h = self.ln_1(x)
        hq, xq = h[rows, pool_idx][:, None], x[rows, pool_idx][:, None]  # [B, 1, W]
        qmask = None
        if self.causal:
            qmask = (torch.arange(L, device=x.device)[None, :] <= pool_idx[:, None])[:, None, None, :]
        xq = xq + self.attn(hq, kv=h, mask=qmask)
        return self.mlp(self.ln_2(xq), res=xq)


class Transformer(nn.Module):
    """Stack of pre-LN blocks; with `pool_idx` the last block computes only
    the pooled token and the stack returns [B, 1, W]."""

    def __init__(self, width: int, layers: int, num_heads: int, causal: bool = False, quant: bool = False,
                 remat: bool = False):
        super().__init__()
        if remat:
            raise _not_ported("activation checkpointing (remat)", "Queue 1 item 3, the training path")
        self.resblocks = nn.ModuleList(
            TransformerBlock(width, num_heads, causal=causal, quant=quant) for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, pool_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        last = len(self.resblocks) - 1
        for i, blk in enumerate(self.resblocks):
            x = blk(x, pool_idx if i == last else None)
        return x


class PatchEmbed(nn.Module):
    """Bias-free patch embedding over NHWC images with an OIHW weight.

    A VALID stride-p convolution is a product of each p x p patch with the
    flattened weight, computed here as one matmul."""

    def __init__(self, width: int, patch_size: int):
        super().__init__()
        self.width, self.patch_size = width, patch_size
        self.weight = nn.Parameter(torch.empty(width, 3, patch_size, patch_size))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, 3 * self.patch_size**2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [B, H, W, 3] -> [B, (H/p)*(W/p), width]
        B, H, W, C = x.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        x = x[:, : gh * p, : gw * p].reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(B, gh * gw, C * p * p) @ self.weight.reshape(self.width, -1).T
