"""2-layer T5 encoder stack for CLIP feature fusion (counterpart of
uniir_tpu/models/t5_fusion.py).

HF `T5Stack`'s semantics and parameter names (`block.<i>.layer.0.
SelfAttention.q|k|v|o.weight`, `block.0.layer.0.SelfAttention.
relative_attention_bias.weight`, `block.<i>.layer.0.layer_norm.weight`,
`block.<i>.layer.1.DenseReluDense.wi|wo.weight`, `block.<i>.layer.1.
layer_norm.weight`, `final_layer_norm.weight`), so a UniIR CLIP-FF
checkpoint's `t5_layers.*` keys load as they are:

  * RMS layer norm (fp32 variance, eps 1e-6, no bias, no mean subtraction),
    pre-LN residual blocks;
  * bias-free q / k / v / o and FFN layers, ReLU FFN (d_ff 2048);
  * bucketed bidirectional relative position bias, owned by block 0 and
    shared by the rest;
  * no 1/sqrt(d) attention scaling.

Attention is plain torch ops at the JAX module's rounding points: the q kᵀ
product comes out in the compute dtype, the logits and the [1, H, L, L]
bias add and the softmax are fp32, the probabilities are cast to the
compute dtype and dropped out.  The JAX package runs it as an einsum
outside any Pallas kernel too (L = 77 + 257 = 334 for ViT-L/14).

The relative-position buckets come from a host-built integer table (a
buffer): the JAX function truncates an fp32 logarithm, and a table made
once is held equal to it by the tests for every distance.

Dropout draws from an explicit `torch.Generator` (`set_dropout_generator`)
and is identity in eval mode.  Parameters are cast to the compute dtype at
each use (flax's `dtype=`); the norm weights and the bias table stay fp32.

With `quant` (serving only) q / k / v / o / wi / wo are bias-free
`QuantLinear`s (kernel K5, `ops/quant.py`) in the activation mode
`int8_mode`.  Calibrated `act_scales` make them static: [a_qkv, a_out] on
the attention (the attn layer norm's output, the attention output before
`o`), [a_ff_in, a_hidden] on the FFN (the ff layer norm's output, relu(wi)).
q, k and v share one quantisation of their input, as XLA's
common-subexpression elimination shares it in the JAX package.  The relu
FFN has no fused kernel: it is two K5 calls, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from uniir_tpu_torch.models.layers import Dropout as T5Dropout
from uniir_tpu_torch.models.layers import lecun_normal_, set_dropout_generator
from uniir_tpu_torch.ops.quant import ActScales, QuantLinear, quantize_input


@dataclasses.dataclass(frozen=True)
class T5FusionConfig:
    d_model: int = 512
    d_kv: int = 64
    num_heads: int = 12
    d_ff: int = 2048
    num_layers: int = 2
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """T5 bidirectional relative-position bucketing on the host (numpy,
    fp32 logarithm as t5_fusion.py:54-67): int array in, int32 buckets out."""
    relative_position = np.asarray(relative_position)
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int32) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    ratio = n.astype(np.float32) / np.float32(max_exact) + np.float32(1e-6)
    scaled = np.log(ratio) / np.float32(math.log(max_distance / max_exact)) * np.float32(num_buckets - max_exact)
    val_if_large = max_exact + scaled.astype(np.int32)  # truncation, as the JAX function's astype
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return (ret + np.where(n < max_exact, n, val_if_large)).astype(np.int32)


class T5LayerNorm(nn.Module):
    def __init__(self, width: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


class _Dense(nn.Linear):
    """Bias-free Linear whose weight is cast to the input's dtype at use."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__(in_features, out_features, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype))


def _dense(in_features: int, out_features: int, quant: bool, int8_mode: str) -> nn.Module:
    if quant:
        return QuantLinear(in_features, out_features, bias=False, mode=int8_mode)
    return _Dense(in_features, out_features)


class T5Attention(nn.Module, ActScales):
    def __init__(self, cfg: T5FusionConfig, has_relative_bias: bool = False, quant: bool = False,
                 int8_mode: str = "dynamic"):
        super().__init__()
        self.cfg, self.has_relative_bias = cfg, has_relative_bias
        self.quant, self.int8_mode = quant, int8_mode
        inner = cfg.num_heads * cfg.d_kv
        self.q = _dense(cfg.d_model, inner, quant, int8_mode)
        self.k = _dense(cfg.d_model, inner, quant, int8_mode)
        self.v = _dense(cfg.d_model, inner, quant, int8_mode)
        self.o = _dense(inner, cfg.d_model, quant, int8_mode)
        self.dropout = T5Dropout(cfg.dropout_rate)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)
            self.register_buffer("buckets", torch.zeros((0, 0), dtype=torch.long), persistent=False)
        if quant:
            self._init_act_scales()

    def position_bias(self, L: int) -> torch.Tensor:
        """[1, H, L, L] fp32 bias from the bucket table, which is rebuilt on
        the host when the sequence length changes."""
        if self.buckets.shape[0] != L:
            ctx = np.arange(L)
            table = relative_position_bucket(
                ctx[None, :] - ctx[:, None],  # memory - query
                self.cfg.relative_attention_num_buckets, self.cfg.relative_attention_max_distance,
            )
            self.buckets = torch.from_numpy(table).long().to(self.relative_attention_bias.weight.device)
        return self.relative_attention_bias.weight[self.buckets].permute(2, 0, 1)[None].float()

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor] = None):
        cfg = self.cfg
        B, L, _ = x.shape
        if self.quant:
            a_in, a_out = self.static_scales() or (None, None)
            shared = None if self.int8_mode == "wonly" else quantize_input(x, self.int8_mode, a_in)
            q, k, v = (proj(x, a_static=a_in, quantized=shared) for proj in (self.q, self.k, self.v))
            o = lambda ctx: self.o(ctx, a_static=a_out)  # noqa: E731
        else:
            q, k, v, o = self.q(x), self.k(x), self.v(x), self.o
        q = q.view(B, L, cfg.num_heads, cfg.d_kv)
        k = k.view(B, L, cfg.num_heads, cfg.d_kv)
        v = v.view(B, L, cfg.num_heads, cfg.d_kv)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()  # T5: no 1/sqrt(d) scaling
        if self.has_relative_bias:
            position_bias = self.position_bias(L)
        if position_bias is not None:
            logits = logits + position_bias
        probs = self.dropout(torch.softmax(logits, dim=-1).to(x.dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, cfg.num_heads * cfg.d_kv)
        return o(out), position_bias


class _SelfAttentionLayer(nn.Module):
    """HF's T5LayerSelfAttention: `layer.0` of a block."""

    def __init__(self, cfg: T5FusionConfig, has_relative_bias: bool, quant: bool, int8_mode: str):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias, quant, int8_mode)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.dropout = T5Dropout(cfg.dropout_rate)

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor]):
        out, position_bias = self.SelfAttention(self.layer_norm(x), position_bias)
        return x + self.dropout(out), position_bias


class _DenseReluDense(nn.Module, ActScales):
    def __init__(self, cfg: T5FusionConfig, quant: bool, int8_mode: str):
        super().__init__()
        self.quant, self.int8_mode = quant, int8_mode
        self.wi = _dense(cfg.d_model, cfg.d_ff, quant, int8_mode)
        self.wo = _dense(cfg.d_ff, cfg.d_model, quant, int8_mode)
        self.dropout = T5Dropout(cfg.dropout_rate)
        if quant:
            self._init_act_scales()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.quant:
            return self.wo(self.dropout(F.relu(self.wi(x))))
        a_in, a_hidden = self.static_scales() or (None, None)
        return self.wo(F.relu(self.wi(x, a_static=a_in)), a_static=a_hidden)


class _FFLayer(nn.Module):
    """HF's T5LayerFF: `layer.1` of a block."""

    def __init__(self, cfg: T5FusionConfig, quant: bool, int8_mode: str):
        super().__init__()
        self.DenseReluDense = _DenseReluDense(cfg, quant, int8_mode)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.dropout = T5Dropout(cfg.dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.dropout(self.DenseReluDense(self.layer_norm(x)))


class T5Block(nn.Module):
    def __init__(self, cfg: T5FusionConfig, has_relative_bias: bool = False, quant: bool = False,
                 int8_mode: str = "dynamic"):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg, has_relative_bias, quant, int8_mode),
                                    _FFLayer(cfg, quant, int8_mode)])

    def forward(self, x: torch.Tensor, position_bias: Optional[torch.Tensor] = None):
        x, position_bias = self.layer[0](x, position_bias)
        return self.layer[1](x), position_bias


class T5FusionStack(nn.Module):
    def __init__(self, cfg: T5FusionConfig, dtype: torch.dtype = torch.float32, quant: bool = False,
                 int8_mode: str = "dynamic"):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.block = nn.ModuleList(T5Block(cfg, has_relative_bias=(i == 0), quant=quant, int8_mode=int8_mode)
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.dropout = T5Dropout(cfg.dropout_rate)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded initialisation with the JAX module's initialisers:
        lecun_normal Dense kernels, normal(0.02) bias table, unit norms."""
        for m in self.modules():
            if isinstance(m, _Dense):
                lecun_normal_(m.weight, m.in_features, generator)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
            elif isinstance(m, T5LayerNorm):
                m.weight.fill_(1.0)

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """The generator every dropout of the stack draws from in train mode."""
        set_dropout_generator(self, generator)

    def fp32_parameters(self) -> list:
        """Parameters that stay fp32 when a model is cast for serving: the
        norm weights and the bias table (read in fp32 by the JAX module)."""
        keep = [p for m in self.modules() if isinstance(m, T5LayerNorm) for p in m.parameters()]
        return keep + [p for m in self.modules() if isinstance(m, nn.Embedding) for p in m.parameters()]

    def forward(self, inputs_embeds: torch.Tensor) -> torch.Tensor:
        x = self.dropout(inputs_embeds.to(self.dtype))
        position_bias = None
        for blk in self.block:
            x, position_bias = blk(x, position_bias)
        return self.dropout(self.final_layer_norm(x))
