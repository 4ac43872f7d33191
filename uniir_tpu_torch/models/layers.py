"""Transformer building blocks (counterpart of uniir_tpu/models/layers.py).

Parameter names follow OpenAI CLIP's state dict (`attn.in_proj_weight`,
`mlp.c_fc`, `ln_1`, `transformer.resblocks.<i>`, ...), so a published
checkpoint loads directly (BLIP's ViT maps timm's names onto them where its
state dict is read and written, `models/blip_vit.py`).  Arithmetic follows
the JAX package: the compute
dtype is the input's (the towers cast their input to it), and every
parameter is cast to it at each use, as flax's `dtype=` does, so training
keeps fp32 parameters while the residual stream and the matmuls run in
bf16 (serving casts the parameters once instead, with the same values).
LayerNorm statistics are fp32 with eps 1e-6 (flax's default; MED's BERT
layers pass 1e-12), softmax is
fp32, and bf16 self-attention goes through the differentiable
`ops.attention.attention` (kernels K1 forward, K3 backward; with
`attn_splitk` K10 is the forward at the lengths it takes, CLIP's L = 257).
`Transformer(remat=True)` recomputes each block in the backward pass
(`torch.utils.checkpoint`, the counterpart of `nn.remat`).

With `quant` the four Dense layers of each block are `QuantLinear`s over
int8 weights (`ops/quant.py`, kernel K5) in the activation mode
`int8_mode` ("dynamic", "wonly" or "static"), and under "static" with
calibrated `act_scales` the MLP half-block is one call of kernel K6
(`ops/mlp.py`) unless `mlp_route` is "xla".  Quantised layers are
inference only.  Calibration (`ops/calibrate.py`) hooks the outputs of
`ln_1`, `ln_2` and `c_fc` and the input of `out_proj` (the attention
output, the JAX package's `attn_pre_out` probe) on the float modules.

Not carried over here: the padded-flat tower (`flat`), whose math is that
of the 3-D path.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from uniir_tpu_torch.ops import mlp as mlp_ops
from uniir_tpu_torch.ops import quant as quant_ops
from uniir_tpu_torch.ops.attention import attention, kernel_supported
from uniir_tpu_torch.ops.image_ops import cubic_resize_matrix

LN_EPS = 1e-6  # flax nn.LayerNorm's default (PyTorch's and OpenAI CLIP's is 1e-5)


class _ActScales:
    """Mixin for quantised modules that may carry a calibrated `act_scales`
    buffer (two fp32 scales): a host copy is read once, at first use, so a
    forward never waits on the device for them."""

    def _init_act_scales(self) -> None:
        self.register_buffer("act_scales", None)  # absent from the state dict until calibrated
        self._act_host = None

    def set_act_scales(self, values) -> None:
        ref = next(self.buffers())
        self.register_buffer("act_scales", torch.as_tensor(values, dtype=torch.float32).to(ref.device))
        self._act_host = None

    def static_scales(self):
        """(a, b) as Python floats under the static mode when calibrated, else None."""
        if self.int8_mode != "static" or getattr(self, "act_scales", None) is None:
            return None
        if self._act_host is None:
            self._act_host = tuple(float(v) for v in self.act_scales.tolist())
        return self._act_host


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU (timm ViT and HF BERT), not the tanh form."""
    return F.gelu(x)


ACTIVATIONS: dict = {"gelu": gelu_exact, "quick_gelu": quick_gelu, "relu": F.relu}


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated at 2 std, rescaled to variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Linear(nn.Linear):
    """nn.Linear whose weight and bias are cast to the input's dtype at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm: fp32 statistics and affine, output in the input's dtype."""

    def __init__(self, width: int, eps: float = LN_EPS):
        super().__init__(width, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.float(), self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape, w, b, self.eps).to(x.dtype)


def qkv_project(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, kv: Optional[torch.Tensor] = None):
    """The fused [3W, W] in_proj applied as three row-sliced products
    (layers.py:61-85): each of q, k, v comes out contiguous for K1."""
    W, dtype = weight.shape[1], x.dtype
    kv = x if kv is None else kv
    return tuple(
        F.linear(inp, weight[i * W : (i + 1) * W].to(dtype), bias[i * W : (i + 1) * W].to(dtype))
        for i, inp in enumerate((x, kv, kv))
    )


class MultiHeadAttention(nn.Module, _ActScales):
    """Multi-head attention with a fused in_proj (OpenAI CLIP's
    nn.MultiheadAttention layout: `in_proj_weight`, `in_proj_bias`,
    `out_proj`).

    bf16 self-attention with no explicit mask goes through kernel K1 where
    `ops.attention.kernel_supported` has a kernel for the shape (head width
    64, a length within a kernel's budget; a CPU tensor runs K1's twin at any
    shape); every other case (fp32, cross/pooled attention, an explicit
    mask, another head width) takes the plain einsum path, as in the JAX
    package.

    With `quant` the projections are int8 (`qkv_proj`, `out_proj`): one
    fused [3W, W] weight whose thirds are applied as column-sliced products,
    so q, k and v share one activation quantisation and each comes out
    contiguous; calibrated `act_scales` = [a_qkv, a_out] make both static."""

    def __init__(self, width: int, num_heads: int, causal: bool = False, quant: bool = False,
                 int8_mode: str = "dynamic", attn_splitk: bool = False):
        super().__init__()
        self.width, self.num_heads, self.causal, self.attn_splitk = width, num_heads, causal, attn_splitk
        self.quant, self.int8_mode = quant, int8_mode
        if quant:
            self.qkv_proj = quant_ops.QuantLinear(width, 3 * width, mode=int8_mode)
            self.out_proj = quant_ops.QuantLinear(width, width, mode=int8_mode)
            self._init_act_scales()
            return
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = Linear(width, width)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.quant:  # quantised weights come from a float model, not from a seed
            return
        lecun_normal_(self.in_proj_weight, self.width, generator)
        self.in_proj_bias.zero_()
        nn.init.xavier_uniform_(self.out_proj.weight, generator=generator)
        self.out_proj.bias.zero_()

    def _qkv_int8(self, x: torch.Tensor, kv: Optional[torch.Tensor], a_in: Optional[float]):
        W, proj = self.width, self.qkv_proj
        if kv is None:
            # one quantisation of x for the three column-sliced products
            shared = None if self.int8_mode == "wonly" else quant_ops.quantize_input(x, self.int8_mode, a_in)
            return tuple(proj(x, columns=(i * W, (i + 1) * W), a_static=a_in, quantized=shared) for i in range(3))
        # cross operand: x pays only the q third, kv the k / v two thirds
        q = proj(x, columns=(0, W), a_static=a_in)
        kv_out = proj(kv, columns=(W, 3 * W), a_static=a_in)
        return q, kv_out[..., :W], kv_out[..., W:]

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None):
        if self.quant:
            a_attn = self.static_scales()
            q, k, v = self._qkv_int8(x, kv, None if a_attn is None else a_attn[0])
            out_proj = functools.partial(self.out_proj, a_static=None if a_attn is None else a_attn[1])
        else:
            q, k, v = qkv_project(x, self.in_proj_weight, self.in_proj_bias, kv)
            out_proj = self.out_proj
        head_dim = self.width // self.num_heads
        scale = head_dim**-0.5
        # the route is settled by shape before any launch: a head width or a length no kernel takes
        # runs the einsum below (the JAX layer asks `paired_attention_supported` the same way)
        training = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
        if (kv is None and mask is None and q.dtype == torch.bfloat16
                and (not q.is_cuda or kernel_supported(self.num_heads, self.width, q.shape[1], training))):
            return out_proj(attention(q, k, v, self.num_heads, scale, self.causal, splitk=self.attn_splitk))

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
        return out_proj(out)


class MLP(nn.Module, _ActScales):
    """c_fc -> act -> c_proj; `act` is one of
    ACTIVATIONS (CLIP's QuickGELU by default, "gelu" for BLIP's exact erf
    form).  With `res` the residual add is part of it.

    That ownership lets the static int8 mode run the whole half-block as one
    call of kernel K6 (`ops/mlp.py`), the hidden never leaving the chip: it
    needs `quant`, `int8_mode="static"`, calibrated `act_scales` = [a1, a2]
    and `res`.  `mlp_route="xla"`, or a shape K6 does not take, runs two
    static int8 products around a hidden in the compute dtype instead;
    without calibrated scales both products quantise dynamically."""

    def __init__(self, width: int, hidden_width: int, quant: bool = False, int8_mode: str = "dynamic",
                 mlp_route: str = "fused", act: str = "quick_gelu"):
        super().__init__()
        self.width, self.hidden_width, self.act = width, hidden_width, act
        self.quant, self.int8_mode, self.mlp_route = quant, int8_mode, mlp_route
        if quant:
            self.c_fc = quant_ops.QuantLinear(width, hidden_width, mode=int8_mode)
            self.c_proj = quant_ops.QuantLinear(hidden_width, width, mode=int8_mode)
            self._init_act_scales()
            return
        self.c_fc = Linear(width, hidden_width)
        self.c_proj = Linear(hidden_width, width)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.quant:
            return
        fc1, fc2 = self.c_fc, self.c_proj
        lecun_normal_(fc1.weight, self.width, generator)
        lecun_normal_(fc2.weight, self.hidden_width, generator)
        fc1.bias.zero_()
        fc2.bias.zero_()

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None) -> torch.Tensor:
        fc1, fc2 = self.c_fc, self.c_proj
        act = ACTIVATIONS[self.act]
        if not self.quant:
            x = fc2(act(fc1(x)))
            return x if res is None else res + x
        a = self.static_scales()
        if (a is not None and res is not None and self.mlp_route == "fused"
                and (x.device.type == "cpu" or mlp_ops.int8_mlp_supported(self.width, self.hidden_width, self.act))):
            return mlp_ops.int8_mlp(
                x, res, fc1.weight_q, fc1.scale, fc1.bias, fc2.weight_q, fc2.scale, fc2.bias, a[0], a[1],
                act=self.act,
            ).to(x.dtype)
        h = act(fc1(x, a_static=None if a is None else a[0]))
        h = fc2(h, a_static=None if a is None else a[1])
        return h if res is None else res + h


class TransformerBlock(nn.Module):
    """Pre-LN residual block (CLIP's ResidualAttentionBlock)."""

    def __init__(self, width: int, num_heads: int, causal: bool = False, quant: bool = False,
                 int8_mode: str = "dynamic", mlp_route: str = "fused", attn_splitk: bool = False):
        super().__init__()
        self.causal = causal
        self.attn = MultiHeadAttention(width, num_heads, causal=causal, quant=quant, int8_mode=int8_mode,
                                       attn_splitk=attn_splitk)
        self.ln_1 = LayerNorm(width)
        self.mlp = MLP(width, 4 * width, quant=quant, int8_mode=int8_mode, mlp_route=mlp_route)
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
    the pooled token and the stack returns [B, 1, W].  With `remat` each
    block keeps only its input for the backward pass and is recomputed
    there (every block, as `nn.remat(TransformerBlock)` at layers.py:400)."""

    def __init__(self, width: int, layers: int, num_heads: int, causal: bool = False, quant: bool = False,
                 remat: bool = False, int8_mode: str = "dynamic", mlp_route: str = "fused", attn_splitk: bool = False):
        super().__init__()
        if quant and remat:
            raise ValueError("int8 layers are inference only: quant and remat do not combine")
        self.remat = remat
        self.resblocks = nn.ModuleList(
            TransformerBlock(width, num_heads, causal=causal, quant=quant, int8_mode=int8_mode, mlp_route=mlp_route,
                             attn_splitk=attn_splitk)
            for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, pool_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        last = len(self.resblocks) - 1
        for i, blk in enumerate(self.resblocks):
            idx = pool_idx if i == last else None
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, idx, use_reentrant=False)
            else:
                x = blk(x, idx)
        return x


class PatchEmbed(nn.Module):
    """Patch embedding over NHWC images with an OIHW weight; bias-free for
    CLIP, with a bias (`use_bias`) for BLIP's ViT.

    A VALID stride-p convolution is a product of each p x p patch with the
    flattened weight, computed here as one matmul."""

    def __init__(self, width: int, patch_size: int, use_bias: bool = False):
        super().__init__()
        self.width, self.patch_size = width, patch_size
        self.weight = nn.Parameter(torch.empty(width, 3, patch_size, patch_size))
        self.bias = nn.Parameter(torch.empty(width)) if use_bias else None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, 3 * self.patch_size**2, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: [B, H, W, 3] -> [B, (H/p)*(W/p), width]
        B, H, W, C = x.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        x = x[:, : gh * p, : gw * p].reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, gh * gw, C * p * p) @ self.weight.reshape(self.width, -1).T.to(x.dtype)
        return x if self.bias is None else x + self.bias.to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm DropPath): identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def interpolate_pos_embed(pos_embed: torch.Tensor, num_patches_new: int, num_prefix_tokens: int = 1) -> torch.Tensor:
    """Bicubic 2-D resize of grid position embeddings on a resolution change
    (counterpart of layers.py:452-472, i.e. of `jax.image.resize`): two
    products with `ops.image_ops.cubic_resize_matrix`.  pos_embed: [L, D] or [1, L, D]
    with `num_prefix_tokens` leading tokens that are kept as they are."""
    squeeze = pos_embed.dim() == 2
    if squeeze:
        pos_embed = pos_embed[None]
    prefix, grid = pos_embed[:, :num_prefix_tokens], pos_embed[:, num_prefix_tokens:]
    gs_old, gs_new = int(round(grid.shape[1] ** 0.5)), int(round(num_patches_new**0.5))
    if gs_old != gs_new:
        D = grid.shape[-1]
        A = torch.from_numpy(cubic_resize_matrix(gs_old, gs_new)).to(grid.device)
        g = grid.reshape(gs_old, gs_old, D).float()
        g = torch.einsum("oh,hwd->owd", A, g)
        g = torch.einsum("pw,owd->opd", A, g)
        grid = g.reshape(1, gs_new * gs_new, D).to(pos_embed.dtype)
    out = torch.cat([prefix, grid], dim=1)
    return out[0] if squeeze else out
