"""BLIP-ScoreFusion retriever (counterpart of uniir_tpu/models/blip_sf.py).

BLIP ViT + MED text encoder in mode="text" (no cross-attention modules: the
reference freezes and never runs them for this model), the CLS token and a
linear projection per tower, fused = masked add, returned in fp32.  The
momentum encoders and queues are train state, not module state, and wait
for the training slice.  `temp` is the learned temperature (0.07 at
initialisation).

`dtype` is the compute dtype of both towers.  Training keeps fp32
parameters and casts them at each use; serving casts them once in place
(`to_compute_dtype`).  Parameter names are BLIP's (`visual_encoder.*`,
`text_encoder.*`, `vision_proj`, `text_proj`, `temp`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from uniir_tpu_torch.models.blip_vit import BLIPVisionTransformer, BLIPViTConfig
from uniir_tpu_torch.models.layers import LayerNorm, Linear, lecun_normal_
from uniir_tpu_torch.models.med import MedBertModel, MedConfig

TEMP_INIT = 0.07


class BLIPScoreFusion(nn.Module):
    def __init__(self, vit_cfg: BLIPViTConfig, med_cfg: MedConfig, embed_dim: int = 768,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.vit_cfg, self.med_cfg, self.embed_dim, self.dtype = vit_cfg, med_cfg, embed_dim, dtype
        self.visual_encoder = BLIPVisionTransformer(vit_cfg, dtype=dtype, remat_from_layer=vit_cfg.layers if remat else 0)
        self.text_encoder = MedBertModel(med_cfg, add_pooling_layer=False, dtype=dtype, cross_attention=False)
        self.vision_proj = Linear(vit_cfg.width, embed_dim)
        self.text_proj = Linear(med_cfg.hidden_size, embed_dim)
        self.temp = nn.Parameter(torch.full((), TEMP_INIT))
        self._reset_heads(None)

    @torch.no_grad()
    def _reset_heads(self, generator: Optional[torch.Generator]) -> None:
        for proj in (self.vision_proj, self.text_proj):
            lecun_normal_(proj.weight, proj.in_features, generator)
            proj.bias.zero_()
        self.temp.fill_(TEMP_INIT)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded initialisation of every parameter (JAX package's initialisers)."""
        self.visual_encoder.reset_parameters(generator)
        self.text_encoder.reset_parameters(generator)
        self._reset_heads(generator)

    @torch.no_grad()
    def to_compute_dtype(self, dtype: torch.dtype) -> "BLIPScoreFusion":
        """Compute in `dtype` and cast the parameters once, in place, for
        serving.  LayerNorm parameters (normalised in fp32) and `temp` stay
        fp32; the values equal those of a cast at each use."""
        self.dtype = self.visual_encoder.dtype = self.text_encoder.dtype = dtype
        fp32 = {id(p) for m in self.modules() if isinstance(m, LayerNorm) for p in m.parameters()}
        fp32.add(id(self.temp))
        for p in self.parameters():
            if id(p) not in fp32:
                p.data = p.data.to(dtype)
        return self

    def encode_texts(self, txt_dict) -> torch.Tensor:
        hidden, _ = self.text_encoder(
            txt_dict["input_ids"], attention_mask=txt_dict["attention_mask"], mode="text",
            trim_last=True,  # only the CLS row is read below (exact)
        )
        return self.text_proj(hidden[:, 0, :])

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        feats = self.visual_encoder(images, pool_cls=True)
        return self.vision_proj(feats[:, 0, :])

    def fuse_embeddings(self, txt_emb: torch.Tensor, img_emb: torch.Tensor) -> torch.Tensor:
        return img_emb + txt_emb

    def encode_multimodal_input(self, txt_dict, images, txt_mask, img_mask) -> torch.Tensor:
        """txt_dict: {"input_ids", "attention_mask"} int [N, L]; images: float
        [N, H, W, 3] NHWC; txt_mask / img_mask: [N] modality-presence masks
        -> fp32 [N, embed_dim]."""
        txt_emb = self.encode_texts(txt_dict)
        txt_emb = txt_emb * txt_mask[:, None].to(txt_emb.dtype)
        img_emb = self.encode_images(images)
        img_emb = img_emb * img_mask[:, None].to(img_emb.dtype)
        return self.fuse_embeddings(txt_emb, img_emb).float()

    def forward(self, txt_dict, images, txt_mask, img_mask) -> torch.Tensor:
        return self.encode_multimodal_input(txt_dict, images, txt_mask, img_mask)
