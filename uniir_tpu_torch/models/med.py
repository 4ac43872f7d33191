"""MED: BERT with per-layer gated cross-attention, BLIP's text encoder
(counterpart of uniir_tpu/models/med.py).

  * post-LN BERT layers (attention -> add & LN -> FFN -> add & LN), eps 1e-12;
  * optional cross-attention in every layer, run when mode == "multimodal";
    its keys and values project from `encoder_width` (the vision width);
  * embeddings: word + learned position, LayerNorm, dropout.  There is no
    token-type table: BLIP always passes token type 0, and that row is folded
    into the position table where a checkpoint is loaded;
  * pooler: dense + tanh over the CLS token (BLIP-FF reads it).

`mode="text"` skips cross-attention (BLIP-SF's text tower); "multimodal"
needs `encoder_hidden_states` (BLIP-FF's fused encoder) and a model built
with `cross_attention=True`.  Parameter names are HF BERT's
(`embeddings.word_embeddings`, `encoder.layer.<i>.attention.self.query`,
`...attention.output.dense|LayerNorm`, `...crossattention...`,
`...intermediate.dense`, `...output.dense|LayerNorm`, `pooler.dense`).

Attention is the plain einsum path, as in the JAX package: the padding mask
is additive, (1 - mask) * -1e9 on fp32 logits, softmax in fp32, the
probabilities cast to the compute dtype.  Dropout is identity in eval mode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from uniir_tpu_torch.models.layers import LayerNorm, Linear, gelu_exact, lecun_normal_

NEG_INF = -1e9  # the additive mask's value, as the JAX package's


@dataclasses.dataclass(frozen=True)
class MedConfig:
    vocab_size: int = 30524  # 30522 + [DEC] + [ENC]
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    encoder_width: int = 768  # vision width for the cross-attention keys / values
    add_cross_attention: bool = True


MED_CONFIGS = {
    "base": MedConfig(),
    "large": MedConfig(encoder_width=1024),
    "test-tiny": MedConfig(
        vocab_size=128,
        hidden_size=32,
        num_hidden_layers=2,
        num_attention_heads=2,
        intermediate_size=64,
        max_position_embeddings=64,
        encoder_width=32,
    ),
}


class _QKV(nn.Module):
    """HF's BertSelfAttention parameters: separate query / key / value layers."""

    def __init__(self, hidden: int, kv_width: int):
        super().__init__()
        self.query = Linear(hidden, hidden)
        self.key = Linear(kv_width, hidden)
        self.value = Linear(kv_width, hidden)


class _Output(nn.Module):
    """HF's BertSelfOutput / BertOutput: dense, dropout, add & LayerNorm."""

    def __init__(self, in_width: int, hidden: int, eps: float, dropout: float):
        super().__init__()
        self.dense = Linear(in_width, hidden)
        self.LayerNorm = LayerNorm(hidden, eps)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dropout(self.dense(x)) + residual)


class _Dense(nn.Module):
    """A module holding one `dense` layer (HF's BertIntermediate, BertPooler)."""

    def __init__(self, in_width: int, out_width: int):
        super().__init__()
        self.dense = Linear(in_width, out_width)


class BertSelfAttentionBlock(nn.Module):
    """Self- or cross-attention, output projection, add & LN (post-LN)."""

    def __init__(self, cfg: MedConfig, is_cross: bool = False):
        super().__init__()
        self.heads, self.is_cross = cfg.num_attention_heads, is_cross
        H = cfg.hidden_size
        setattr(self, "self", _QKV(H, cfg.encoder_width if is_cross else H))
        self.attn_dropout = nn.Dropout(cfg.attention_probs_dropout_prob)
        self.output = _Output(H, H, cfg.layer_norm_eps, cfg.hidden_dropout_prob)

    def forward(self, hidden, attn_mask=None, kv=None, self_kv=None):
        """`self_kv`: the full sequence as key / value source of a trimmed
        (single-query) self-attention pass; the residual and the query still
        come from `hidden`."""
        kv_src = kv if self.is_cross else (hidden if self_kv is None else self_kv)
        proj = getattr(self, "self")
        B, Lq, H = hidden.shape
        Lk, D = kv_src.shape[1], H // self.heads
        q = proj.query(hidden).view(B, Lq, self.heads, D)
        k = proj.key(kv_src).view(B, Lk, self.heads, D)
        v = proj.value(kv_src).view(B, Lk, self.heads, D)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * D**-0.5
        if attn_mask is not None:
            logits = logits + attn_mask  # additive [B, 1, 1, Lk]
        probs = self.attn_dropout(torch.softmax(logits, dim=-1).to(v.dtype))
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, Lq, H)
        return self.output(ctx, hidden)


class BertLayer(nn.Module):
    """`pool_first` computes only the CLS (index-0) output row: exact for the
    last layer of a CLS-pooled consumer (self- and cross-attention keep the
    full keys / values; the additive masks broadcast over the query axis)."""

    def __init__(self, cfg: MedConfig, cross_attention: bool):
        super().__init__()
        self.attention = BertSelfAttentionBlock(cfg)
        if cross_attention:
            self.crossattention = BertSelfAttentionBlock(cfg, is_cross=True)
        self.intermediate = _Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = _Output(cfg.intermediate_size, cfg.hidden_size, cfg.layer_norm_eps, cfg.hidden_dropout_prob)

    def forward(self, hidden, attn_mask, mode: str, enc_hidden=None, enc_mask=None, pool_first: bool = False):
        if pool_first:
            hidden = self.attention(hidden[:, :1], attn_mask, self_kv=hidden)
        else:
            hidden = self.attention(hidden, attn_mask)
        if mode == "multimodal":
            if enc_hidden is None:
                raise ValueError("encoder_hidden_states must be given for multimodal mode")
            if not hasattr(self, "crossattention"):
                raise ValueError("this MED model was built without cross-attention (cross_attention=False)")
            hidden = self.crossattention(hidden, enc_mask, kv=enc_hidden)
        h = gelu_exact(self.intermediate.dense(hidden))
        return self.output(h, hidden)


class _Embeddings(nn.Module):
    def __init__(self, cfg: MedConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)


class _Encoder(nn.Module):
    def __init__(self, cfg: MedConfig, cross_attention: bool):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, cross_attention) for _ in range(cfg.num_hidden_layers))


def _extend_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] 1/0 -> additive fp32 [B, 1, 1, L]."""
    return (1.0 - mask[:, None, None, :].float()) * NEG_INF


class MedBertModel(nn.Module):
    def __init__(self, cfg: MedConfig, add_pooling_layer: bool = True, dtype: torch.dtype = torch.float32,
                 remat: bool = False, cross_attention: Optional[bool] = None):
        super().__init__()
        self.cfg, self.dtype, self.remat = cfg, dtype, remat
        cross_attention = cfg.add_cross_attention if cross_attention is None else cross_attention
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg, cross_attention)
        if add_pooling_layer:
            self.pooler = _Dense(cfg.hidden_size, cfg.hidden_size)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded initialisation with the JAX package's initialisers:
        normal(0.02) embeddings, lecun_normal Dense kernels, zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
            elif isinstance(m, Linear):
                lecun_normal_(m.weight, m.in_features, generator)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.reset_parameters()

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        encoder_attention_mask: Optional[torch.Tensor] = None,
        mode: str = "multimodal",
        trim_last: bool = False,
    ):
        """-> (hidden [B, L, H], pooled [B, H] or None).  `trim_last` makes
        the last layer compute only the CLS row (hidden is then [B, 1, H]):
        exact when the caller reads hidden[:, 0] or `pooled` only."""
        dtype = self.dtype
        B, L = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, L), dtype=torch.int32, device=input_ids.device)
        emb = self.embeddings
        x = emb.word_embeddings.weight.to(dtype)[input_ids.long()] + emb.position_embeddings.weight.to(dtype)[:L][None]
        x = emb.dropout(emb.LayerNorm(x))

        attn_mask = _extend_mask(attention_mask)
        enc_mask = None
        if encoder_hidden_states is not None:
            if encoder_attention_mask is None:
                encoder_attention_mask = torch.ones(encoder_hidden_states.shape[:2], dtype=torch.int32, device=x.device)
            enc_mask = _extend_mask(encoder_attention_mask)

        last = len(self.encoder.layer) - 1
        for i, layer in enumerate(self.encoder.layer):
            args = (x, attn_mask, mode, encoder_hidden_states, enc_mask, trim_last and i == last)
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, *args, use_reentrant=False)
            else:
                x = layer(*args)

        pooled = torch.tanh(self.pooler.dense(x[:, 0])) if hasattr(self, "pooler") else None
        return x, pooled
