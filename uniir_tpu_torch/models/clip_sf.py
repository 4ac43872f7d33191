"""CLIP-ScoreFusion retriever (counterpart of uniir_tpu/models/clip_sf.py).

Score-level fusion: fused = img_emb * img_mask + txt_emb * txt_mask, masked
in the compute dtype and returned in fp32 (clip_sf.py:45-47).

`dtype` is the compute dtype of both towers.  Training keeps fp32
parameters and casts them at each use (flax's `dtype=`); serving casts
them once in place (`to_compute_dtype`).

`quant=True` builds the int8 serving twin (inference only): the blocks'
Dense layers hold int8 weights, filled from a float model by
`ops.quant.quantize_state_dict`; `int8_mode` and `mlp_route` pick the
activation mode and the static MLP route (`ops/quant.py`).

The module has OpenAI CLIP's layout: the text tower's parameters sit at the
root (`token_embedding`, `transformer`, `ln_final`, ...) and the vision
tower under `visual`, so an OpenAI CLIP state dict loads as it is.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from uniir_tpu_torch.models.clip import CLIPConfig, CLIPTextTower, CLIPVisionTower, clip_logit_scale_init
from uniir_tpu_torch.models.layers import LayerNorm


class CLIPScoreFusion(CLIPTextTower):
    def __init__(self, cfg: CLIPConfig, remat: bool = False, quant: bool = False, dtype: torch.dtype = torch.float32,
                 int8_mode: str = "dynamic", mlp_route: str = "fused"):
        int8 = dict(quant=quant, int8_mode=int8_mode, mlp_route=mlp_route)
        super().__init__(cfg, pool="eot", remat=remat, dtype=dtype, **int8)
        self.visual = CLIPVisionTower(cfg, pool="cls", remat=remat, dtype=dtype, **int8)
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.logit_scale.data.fill_(clip_logit_scale_init())

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded initialisation of every parameter (JAX package's initialisers)."""
        CLIPTextTower.reset_parameters(self, generator)
        self.visual.reset_parameters(generator)
        self.logit_scale.fill_(clip_logit_scale_init())

    @torch.no_grad()
    def to_compute_dtype(self, dtype: torch.dtype) -> "CLIPScoreFusion":
        """Compute in `dtype` and cast the parameters once, in place, for
        serving (bf16 on the card).

        The JAX package keeps fp32 parameters and casts them at each use;
        casting once gives the same values.  LayerNorm parameters (flax
        normalises in fp32) and logit_scale stay fp32."""
        self.dtype = self.visual.dtype = dtype
        fp32 = {id(p) for m in self.modules() if isinstance(m, LayerNorm) for p in m.parameters()}
        fp32.add(id(self.logit_scale))
        for p in self.parameters():
            if id(p) not in fp32:
                p.data = p.data.to(dtype)
        return self

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        return CLIPTextTower.forward(self, text)

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def fuse_embeddings(self, img_emb: torch.Tensor, txt_emb: torch.Tensor) -> torch.Tensor:
        return img_emb + txt_emb

    def encode_multimodal_input(self, txt, img, txt_mask, img_mask) -> torch.Tensor:
        """txt: int [N, L]; img: float [N, H, W, 3] NHWC; masks: int [N] -> fp32 [N, embed_dim]."""
        txt_emb = self.encode_text(txt)
        txt_emb = txt_emb * txt_mask[:, None].to(txt_emb.dtype)
        img_emb = self.encode_image(img)
        img_emb = img_emb * img_mask[:, None].to(img_emb.dtype)
        return self.fuse_embeddings(img_emb, txt_emb).float()

    def get_logit_scale(self) -> torch.Tensor:
        return self.logit_scale.exp()

    def forward(self, txt, img, txt_mask, img_mask) -> torch.Tensor:
        return self.encode_multimodal_input(txt, img, txt_mask, img_mask)
