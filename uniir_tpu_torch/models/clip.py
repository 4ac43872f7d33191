"""CLIP towers in PyTorch (counterpart of uniir_tpu/models/clip.py).

  * vision: NHWC patch embedding (no bias), class token, learned positions,
    ln_pre, pre-LN transformer with QuickGELU whose last block computes only
    the CLS row, ln_post and projection;
  * text: token and position embeddings, causal transformer whose last block
    computes only the EOT row (EOT has the highest token id), ln_final and
    text_projection.

Parameter names are OpenAI CLIP's.  Each tower computes in its `dtype`
(flax's `dtype=`): it casts its input and the parameters it uses there, so
fp32 parameters train with bf16 compute.  `quant` with `int8_mode` and
`mlp_route` makes the blocks' Dense layers int8 (`models/layers.py`).  Initialisers mirror the JAX package's
(clip.py:115-121,144-146,169-173,195-197 and flax's lecun_normal / xavier
defaults), so seeded ViT-L/14 activations stay finite in bf16.  Only the
pooled towers (`pool="cls"` / `pool="eot"`) are ported: CLIP-FF's full-token
outputs wait for that model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from uniir_tpu_torch.models.layers import LayerNorm, MultiHeadAttention, MLP, PatchEmbed, Transformer


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    # vision
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    # joint
    embed_dim: int = 512


CLIP_CONFIGS = {
    "ViT-B/32": CLIPConfig(),
    "ViT-B/16": CLIPConfig(patch_size=16),
    "ViT-L/14": CLIPConfig(
        patch_size=14, vision_width=1024, vision_layers=24, vision_heads=16,
        text_width=768, text_layers=12, text_heads=12, embed_dim=768,
    ),
    # tiny config for CPU tests
    "test-tiny": CLIPConfig(
        image_size=32, patch_size=8, vision_width=32, vision_layers=2, vision_heads=2,
        vocab_size=128, context_length=16, text_width=32, text_layers=2, text_heads=2, embed_dim=16,
    ),
}


def _check_pool(pool: str, expected: str) -> None:
    if pool != expected:
        raise NotImplementedError(
            f"pool={pool!r} (CLIP-FF's token outputs) is not ported to uniir_tpu_torch yet (ROADMAP.md, Queue 1 item 4)"
        )


@torch.no_grad()
def _reset_transformer(transformer: Transformer, generator: Optional[torch.Generator]) -> None:
    for m in transformer.modules():
        if isinstance(m, (MultiHeadAttention, MLP)):
            m.reset_parameters(generator)
        elif isinstance(m, LayerNorm):
            m.reset_parameters()


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, pool: str = "cls", remat: bool = False, quant: bool = False,
                 dtype: torch.dtype = torch.float32, int8_mode: str = "dynamic", mlp_route: str = "fused"):
        super().__init__()
        _check_pool(pool, "cls")
        self.cfg, self.dtype = cfg, dtype
        W = cfg.vision_width
        n_tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.conv1 = PatchEmbed(W, cfg.patch_size)
        self.class_embedding = nn.Parameter(torch.empty(W))
        self.positional_embedding = nn.Parameter(torch.empty(n_tokens, W))
        self.ln_pre = LayerNorm(W)
        self.transformer = Transformer(W, cfg.vision_layers, cfg.vision_heads, quant=quant, remat=remat,
                                       int8_mode=int8_mode, mlp_route=mlp_route)
        self.ln_post = LayerNorm(W)
        self.proj = nn.Parameter(torch.empty(W, cfg.embed_dim))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        std = self.cfg.vision_width**-0.5
        self.conv1.reset_parameters(generator)
        for p in (self.class_embedding, self.positional_embedding, self.proj):
            nn.init.normal_(p, 0.0, std, generator=generator)
        self.ln_pre.reset_parameters()
        self.ln_post.reset_parameters()
        _reset_transformer(self.transformer, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: [B, H, W, 3] NHWC -> [B, embed_dim] in the compute dtype."""
        dtype = self.dtype
        x = self.conv1(images.to(dtype))
        B = x.shape[0]
        cls = self.class_embedding.to(dtype).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.ln_pre(x)
        # pooled tower: the last block only computes the CLS row (exact)
        x = self.transformer(x, pool_idx=torch.zeros(B, dtype=torch.long, device=x.device))
        return self.ln_post(x[:, 0]) @ self.proj.to(dtype)


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig, pool: str = "eot", remat: bool = False, quant: bool = False,
                 dtype: torch.dtype = torch.float32, int8_mode: str = "dynamic", mlp_route: str = "fused"):
        super().__init__()
        _check_pool(pool, "eot")
        self.cfg, self.dtype = cfg, dtype
        W = cfg.text_width
        self.token_embedding = nn.Embedding(cfg.vocab_size, W)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, W))
        self.transformer = Transformer(W, cfg.text_layers, cfg.text_heads, causal=True, quant=quant, remat=remat,
                                       int8_mode=int8_mode, mlp_route=mlp_route)
        self.ln_final = LayerNorm(W)
        self.text_projection = nn.Parameter(torch.empty(W, cfg.embed_dim))
        CLIPTextTower.reset_parameters(self)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.normal_(self.token_embedding.weight, 0.0, 0.02, generator=generator)
        nn.init.normal_(self.positional_embedding, 0.0, 0.01, generator=generator)
        nn.init.normal_(self.text_projection, 0.0, self.cfg.text_width**-0.5, generator=generator)
        self.ln_final.reset_parameters()
        _reset_transformer(self.transformer, generator)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        """text: [B, L] int token ids -> [B, embed_dim] in the compute dtype."""
        dtype = self.dtype
        text = text.long()
        x = self.token_embedding(text).to(dtype) + self.positional_embedding.to(dtype)[: text.shape[1]]
        eot = text.argmax(dim=-1)  # EOT has the highest token id
        # pooled tower: the last block only computes the EOT row (exact; it
        # attends to positions <= its own)
        x = self.transformer(x, pool_idx=eot)
        return self.ln_final(x[:, 0]) @ self.text_projection.to(dtype)


def clip_logit_scale_init() -> float:
    return math.log(1.0 / 0.07)
