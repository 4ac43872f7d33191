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
last k blocks in the backward pass (`torch.utils.checkpoint`).  Drop-path
draws one mask per sample from an explicit `torch.Generator`
(`set_dropout_generator`), identity in eval mode; a recomputed block draws
the masks its forward drew (`layers.checkpoint_with_generator`).  Position
embeddings are resized for another resolution by
`models.layers.interpolate_pos_embed` where a checkpoint is loaded.

With `quant` (serving only) each block's attention and MLP are int8
(`models/layers.py`: kernel K5, and under the static mode with calibrated
scales K6 with the exact GELU); drop-path is then identity, so the block
hands its residual to the MLP, which owns the whole half-block.  The trimmed
last block's single CLS query goes through the fused projection's cross
operand route (q third from the CLS row, k / v two thirds from the whole
sequence).  `QUANT_TIMM_NAMES` maps timm's names of the quantised entries
(`attn.qkv.weight_q`, ..., as the JAX converter writes them) onto the int8
modules'.

Not carried over: the padded-flat int8 tower (`flat`), a TPU layout
workaround whose math is that of the 3-D path.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch import nn
from uniir_tpu_torch.models.layers import (
    MLP,
    DropPath,
    LayerNorm,
    MultiHeadAttention,
    PatchEmbed,
    checkpoint_with_generator,
    set_dropout_generator,
)


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


# the same for a quantised block: weight_q / scale / bias of each int8 layer
QUANT_TIMM_NAMES = {
    f"{timm}.{leaf}": f"{own}.{leaf}"
    for timm, own in (("attn.qkv", "attn.qkv_proj"), ("attn.proj", "attn.out_proj"), ("mlp.fc1", "mlp.c_fc"),
                      ("mlp.fc2", "mlp.c_proj"))
    for leaf in ("weight_q", "scale", "bias")
}


def _from_timm(names: dict, state_dict: dict, prefix: str, *_unused) -> None:
    """Load pre-hook of a block: timm's names -> the modules'."""
    for timm, own in names.items():
        if prefix + timm in state_dict:
            state_dict[prefix + own] = state_dict.pop(prefix + timm)


def _to_timm(names: dict, _module: nn.Module, state_dict: dict, prefix: str, _metadata) -> None:
    """State-dict hook of a block: the modules' names -> timm's."""
    for timm, own in names.items():
        state_dict[prefix + timm] = state_dict.pop(prefix + own)


class BLIPBlock(nn.Module):
    """Pre-LN block; `pool_first` computes only the CLS (index-0) output row:
    exact for the last block of a CLS-pooled consumer (attention keeps the
    full keys and values)."""

    def __init__(self, width: int, heads: int, mlp_ratio: float, drop_path: float = 0.0, quant: bool = False,
                 int8_mode: str = "dynamic", mlp_route: str = "fused"):
        super().__init__()
        self.quant = quant
        self.norm1 = LayerNorm(width)
        self.attn = MultiHeadAttention(width, heads, quant=quant, int8_mode=int8_mode)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(width)
        self.mlp = MLP(width, int(width * mlp_ratio), quant=quant, int8_mode=int8_mode, mlp_route=mlp_route, act="gelu")
        self.drop_path2 = DropPath(drop_path)
        # the state dict speaks timm's names, in both directions
        names = QUANT_TIMM_NAMES if quant else TIMM_NAMES
        self._register_load_state_dict_pre_hook(functools.partial(_from_timm, names))
        self._register_state_dict_hook(functools.partial(_to_timm, names))

    def forward(self, x: torch.Tensor, pool_first: bool = False) -> torch.Tensor:
        h = self.norm1(x)
        if pool_first:
            h = self.attn(h[:, :1], kv=h)  # one CLS query over the whole sequence, no mask
            x = x[:, :1]
        else:
            h = self.attn(h)
        x = x + self.drop_path1(h)
        if self.quant:  # inference only: drop-path is identity, and the MLP adds the residual (K6's epilogue)
            return self.mlp(self.norm2(x), res=x)
        return x + self.drop_path2(self.mlp(self.norm2(x)))


class _PatchEmbedProj(nn.Module):
    """timm's PatchEmbed keeps its convolution as `.proj`."""

    def __init__(self, width: int, patch_size: int):
        super().__init__()
        self.proj = PatchEmbed(width, patch_size, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class BLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: BLIPViTConfig, dtype: torch.dtype = torch.float32, remat_from_layer: int = 0,
                 quant: bool = False, int8_mode: str = "dynamic", mlp_route: str = "fused"):
        super().__init__()
        if quant and remat_from_layer:
            raise ValueError("int8 layers are inference only: quant and remat do not combine")
        self.cfg, self.dtype, self.remat_from_layer = cfg, dtype, remat_from_layer
        self.dropout_generator: Optional[torch.Generator] = None
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = _PatchEmbedProj(cfg.width, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, cfg.width))
        # linear drop-path schedule like timm (rate * i / (layers - 1))
        self.blocks = nn.ModuleList(
            BLIPBlock(cfg.width, cfg.heads, cfg.mlp_ratio, cfg.drop_path_rate * i / max(1, cfg.layers - 1),
                      quant=quant, int8_mode=int8_mode, mlp_route=mlp_route)
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

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """The generator the drop-path layers draw from in train mode (also
        across a recomputed block's forward and recompute)."""
        self.dropout_generator = generator
        set_dropout_generator(self, generator)

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
                x = checkpoint_with_generator(blk, x, trim, generator=self.dropout_generator)
            else:
                x = blk(x, trim)
        return self.norm(x)
