"""BLIP vision transformer (counterpart of uniir_tpu/models/blip_vit.py).

A timm-style ViT: patch-16 conv embedding with a bias, trainable zero-init
cls token and position embedding, pre-LN blocks with the exact erf GELU,
final LayerNorm (eps 1e-6), all tokens returned with CLS at index 0.  Large
adds stochastic depth (drop_path 0.1 on a linear schedule).  State-dict
names are timm's / BLIP's (`patch_embed.proj`, `cls_token`, `pos_embed`,
`blocks.<i>.norm1|attn.qkv|attn.proj|norm2|mlp.fc1|mlp.fc2`, `norm`), so a
BLIP state dict loads as it is: a block's attention and MLP are the shared
modules of `models/layers.py` under their own attribute names, and
`TIMM_NAMES` renames their entries where a block's state dict is read and
written.

bf16 self-attention goes through kernel K1 (`ops.attention`); with
`pool_cls` the last block computes only the CLS row, one query over all
keys through the plain einsum path.  `remat_from_layer=k` recomputes the
last k blocks in the backward pass (`torch.utils.checkpoint`).  Position
embeddings are resized for another resolution by
`models.layers.interpolate_pos_embed` where a checkpoint is loaded.

Not carried over: the padded-flat int8 tower (`flat`), a TPU layout
workaround whose math is that of the 3-D path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from uniir_tpu_torch.models.layers import MLP, DropPath, LayerNorm, MultiHeadAttention, PatchEmbed


@dataclasses.dataclass(frozen=True)
class BLIPViTConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.0


BLIP_VIT_CONFIGS = {
    "base": BLIPViTConfig(),
    "large": BLIPViTConfig(width=1024, layers=24, heads=16, drop_path_rate=0.1),
    "test-tiny": BLIPViTConfig(image_size=32, patch_size=8, width=32, layers=2, heads=2),
}


# timm's name of each state-dict entry of a block -> the shared modules' name
TIMM_NAMES = {
    "attn.qkv.weight": "attn.in_proj_weight",
    "attn.qkv.bias": "attn.in_proj_bias",
    "attn.proj.weight": "attn.out_proj.weight",
    "attn.proj.bias": "attn.out_proj.bias",
    "mlp.fc1.weight": "mlp.c_fc.weight",
    "mlp.fc1.bias": "mlp.c_fc.bias",
    "mlp.fc2.weight": "mlp.c_proj.weight",
    "mlp.fc2.bias": "mlp.c_proj.bias",
}


def _from_timm(state_dict: dict, prefix: str, *_unused) -> None:
    """Load pre-hook of a block: timm's names -> the modules'."""
    for timm, own in TIMM_NAMES.items():
        if prefix + timm in state_dict:
            state_dict[prefix + own] = state_dict.pop(prefix + timm)


def _to_timm(_module: nn.Module, state_dict: dict, prefix: str, _metadata) -> None:
    """State-dict hook of a block: the modules' names -> timm's."""
    for timm, own in TIMM_NAMES.items():
        state_dict[prefix + timm] = state_dict.pop(prefix + own)


class BLIPBlock(nn.Module):
    """Pre-LN block; `pool_first` computes only the CLS (index-0) output row:
    exact for the last block of a CLS-pooled consumer (attention keeps the
    full keys and values)."""

    def __init__(self, width: int, heads: int, mlp_ratio: float, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(width)
        self.attn = MultiHeadAttention(width, heads)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(width)
        self.mlp = MLP(width, int(width * mlp_ratio), act="gelu")
        self.drop_path2 = DropPath(drop_path)
        # the state dict speaks timm's names, in both directions
        self._register_load_state_dict_pre_hook(_from_timm)
        self._register_state_dict_hook(_to_timm)

    def forward(self, x: torch.Tensor, pool_first: bool = False) -> torch.Tensor:
        h = self.norm1(x)
        if pool_first:
            h = self.attn(h[:, :1], kv=h)  # one CLS query over the whole sequence, no mask
            x = x[:, :1]
        else:
            h = self.attn(h)
        x = x + self.drop_path1(h)
        return x + self.drop_path2(self.mlp(self.norm2(x)))


class _PatchEmbedProj(nn.Module):
    """timm's PatchEmbed keeps its convolution as `.proj`."""

    def __init__(self, width: int, patch_size: int):
        super().__init__()
        self.proj = PatchEmbed(width, patch_size, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class BLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: BLIPViTConfig, dtype: torch.dtype = torch.float32, remat_from_layer: int = 0):
        super().__init__()
        self.cfg, self.dtype, self.remat_from_layer = cfg, dtype, remat_from_layer
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = _PatchEmbedProj(cfg.width, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, cfg.width))
        # linear drop-path schedule like timm (rate * i / (layers - 1))
        self.blocks = nn.ModuleList(
            BLIPBlock(cfg.width, cfg.heads, cfg.mlp_ratio, cfg.drop_path_rate * i / max(1, cfg.layers - 1))
            for i in range(cfg.layers)
        )
        self.norm = LayerNorm(cfg.width)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded initialisation with the JAX package's initialisers."""
        self.patch_embed.proj.reset_parameters(generator)
        self.cls_token.zero_()
        self.pos_embed.zero_()
        for m in self.modules():
            if isinstance(m, (MultiHeadAttention, MLP)):
                m.reset_parameters(generator)
            elif isinstance(m, LayerNorm):
                m.reset_parameters()

    def forward(self, images: torch.Tensor, pool_cls: bool = False) -> torch.Tensor:
        """images: [B, H, W, 3] NHWC -> [B, L + 1, W], or [B, 1, W] with
        `pool_cls`: the last block then computes only the CLS row, exact when
        the caller reads feats[:, 0] only (BLIP-SF); keep it False when the
        whole sequence feeds cross-attention (BLIP-FF)."""
        dtype = self.dtype
        x = self.patch_embed(images.to(dtype))
        x = torch.cat([self.cls_token.to(dtype).expand(x.shape[0], 1, -1), x], dim=1) + self.pos_embed.to(dtype)
        last = len(self.blocks) - 1
        for i, blk in enumerate(self.blocks):
            trim = pool_cls and i == last
            if self.remat_from_layer and i > last - self.remat_from_layer and torch.is_grad_enabled():
                x = checkpoint(blk, x, trim, use_reentrant=False)
            else:
                x = blk(x, trim)
        return self.norm(x)
