"""CLIP-FeatureFusion retriever (counterpart of uniir_tpu/models/clip_ff.py).

CLIP towers that return token sequences -- vision: ln_post and the
projection applied to all 257 tokens; text: ln_final of the whole sequence,
no text_projection -- concatenated [txt_seq; img_seq] into a 2-layer T5
encoder and mean-pooled.  The mean runs in the compute dtype and is cast to
fp32 after, as `jnp.mean(fused, axis=1).astype(float32)` does.  Same
contrastive loss as CLIP-SF.

The modality masks are accepted and not applied to the token sequences, as
in the JAX package: padded modalities contribute their (empty-text /
black-image) tokens to the fusion.

The module has the UniIR checkpoint's layout: the CLIP towers and
`logit_scale` under `clip_model` with OpenAI CLIP's names, the fusion stack
under `t5_layers` with HF T5Stack's, so such a state dict loads as it is
(its `clip_model.text_projection` is dropped where it is loaded).  No
untrimmed last block: every one of the 24 + 12 blocks runs full
self-attention (K1; with `attn_splitk` the vision tower's are K10).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from uniir_tpu_torch.models.clip import CLIPConfig, CLIPTextTower, CLIPVisionTower, clip_logit_scale_init
from uniir_tpu_torch.models.layers import LayerNorm
from uniir_tpu_torch.models.t5_fusion import T5FusionConfig, T5FusionStack


def t5_config_for_clip(cfg: CLIPConfig) -> T5FusionConfig:
    # B/32 -> d_model 512, L/14 -> 768; both num_layers=2, num_heads=12, d_kv=64
    return T5FusionConfig(d_model=cfg.embed_dim, num_heads=12, d_kv=64, num_layers=2)


class _CLIPTokenTowers(CLIPTextTower):
    """OpenAI CLIP's layout (text tower at the root, `visual`, `logit_scale`)
    with token outputs and no text_projection."""

    def __init__(self, cfg: CLIPConfig, remat: bool, dtype: torch.dtype, attn_splitk: bool):
        super().__init__(cfg, pool="none", remat=remat, dtype=dtype)
        self.visual = CLIPVisionTower(cfg, pool="none", remat=remat, dtype=dtype, attn_splitk=attn_splitk)
        self.logit_scale = nn.Parameter(torch.full((), clip_logit_scale_init()))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        CLIPTextTower.reset_parameters(self, generator)
        self.visual.reset_parameters(generator)
        self.logit_scale.fill_(clip_logit_scale_init())


class CLIPFeatureFusion(nn.Module):
    def __init__(self, cfg: CLIPConfig, remat: bool = False, quant: bool = False, dtype: torch.dtype = torch.float32,
                 attn_splitk: bool = False):
        super().__init__()
        if quant:
            raise NotImplementedError(
                "int8 serving of CLIPFeatureFusion is not ported to uniir_tpu_torch yet (ROADMAP.md, Queue 1 item 4)"
            )
        if cfg.embed_dim != cfg.text_width:
            # the reference's constraint (ViT-B/32: 512, ViT-L/14: 768)
            raise ValueError("CLIPFeatureFusion requires text_width == embed_dim")
        self.cfg, self.dtype = cfg, dtype
        self.clip_model = _CLIPTokenTowers(cfg, remat, dtype, attn_splitk)
        self.t5_layers = T5FusionStack(t5_config_for_clip(cfg), dtype=dtype)

    @property
    def logit_scale(self) -> torch.Tensor:
        return self.clip_model.logit_scale

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded initialisation of every parameter (JAX package's initialisers)."""
        self.clip_model.reset_parameters(generator)
        self.t5_layers.reset_parameters(generator)

    @torch.no_grad()
    def to_compute_dtype(self, dtype: torch.dtype) -> "CLIPFeatureFusion":
        """Compute in `dtype` and cast the parameters once, in place, for
        serving.  LayerNorm and T5 norm weights, the relative-position bias
        table and logit_scale stay fp32, as the JAX package reads them."""
        self.dtype = self.clip_model.dtype = self.clip_model.visual.dtype = self.t5_layers.dtype = dtype
        fp32 = {id(p) for m in self.modules() if isinstance(m, LayerNorm) for p in m.parameters()}
        fp32 |= {id(p) for p in self.t5_layers.fp32_parameters()}
        fp32.add(id(self.clip_model.logit_scale))
        for p in self.parameters():
            if id(p) not in fp32:
                p.data = p.data.to(dtype)
        return self

    def encode_multimodal_input(self, txt, img, txt_mask=None, img_mask=None) -> torch.Tensor:
        """txt: int [N, Lt]; img: float [N, H, W, 3] NHWC; the masks are
        unused -> fp32 [N, embed_dim]."""
        txt_feat = self.clip_model(txt)  # [N, Lt, W] (W == embed_dim)
        img_feat = self.clip_model.visual(img)  # [N, Li + 1, embed_dim]
        fused = self.t5_layers(torch.cat([txt_feat, img_feat], dim=1))
        return fused.mean(dim=1).float()  # mean pool in the compute dtype, then fp32

    def get_logit_scale(self) -> torch.Tensor:
        return self.clip_model.logit_scale.exp()

    def forward(self, txt, img, txt_mask=None, img_mask=None) -> torch.Tensor:
        return self.encode_multimodal_input(txt, img, txt_mask, img_mask)
