"""BLIP-FeatureFusion retriever (counterpart of uniir_tpu/models/blip_ff.py).

One fused encoder: the BLIP ViT's image tokens (all of them: every MED layer
cross-attends to the whole sequence) feed the MED text encoder as
`encoder_hidden_states`; the pooler output (dense + tanh over CLS) is the
fused embedding, returned in fp32.  The last MED layer computes only the
CLS row (`trim_last`, exact).  `temp` is the learned temperature.  The
momentum encoder and the queues are train state
(`train.state.MomentumTrainState`).  In train mode the ViT's drop-path and
MED's dropout draw from the generator `set_dropout_generator` gives them;
with `remat` every ViT block and every MED layer is recomputed.

The modality masks are accepted and unused, as in the JAX package: a padded
(all-zero) image simply flows through cross-attention, under an all-ones
encoder attention mask.  Parameter names are BLIP's (`visual_encoder.*`,
`text_encoder.*` with `crossattention` and `pooler`, `temp`).

`quant=True` builds the int8 serving twin (inference only), as BLIP-SF's:
the ViT and MED (self- and cross-attention, FFNs, pooler) hold int8
weights (`models.registry.quantize_blip`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from uniir_tpu_torch.models.blip_sf import TEMP_INIT
from uniir_tpu_torch.models.blip_vit import BLIPVisionTransformer, BLIPViTConfig
from uniir_tpu_torch.models.layers import LayerNorm
from uniir_tpu_torch.models.med import MedBertModel, MedConfig


class BLIPFeatureFusion(nn.Module):
    def __init__(self, vit_cfg: BLIPViTConfig, med_cfg: MedConfig, embed_dim: int = 768,
                 dtype: torch.dtype = torch.float32, remat: bool = False, quant: bool = False,
                 int8_mode: str = "dynamic", mlp_route: str = "fused"):
        super().__init__()
        self.vit_cfg, self.med_cfg, self.embed_dim, self.dtype = vit_cfg, med_cfg, embed_dim, dtype
        int8 = dict(quant=quant, int8_mode=int8_mode)
        self.visual_encoder = BLIPVisionTransformer(
            vit_cfg, dtype=dtype, remat_from_layer=vit_cfg.layers if remat else 0, mlp_route=mlp_route, **int8)
        self.text_encoder = MedBertModel(med_cfg, add_pooling_layer=True, dtype=dtype, remat=remat, cross_attention=True,
                                         **int8)
        self.temp = nn.Parameter(torch.full((), TEMP_INIT))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Seeded initialisation of every parameter (JAX package's initialisers)."""
        self.visual_encoder.reset_parameters(generator)
        self.text_encoder.reset_parameters(generator)
        self.temp.fill_(TEMP_INIT)

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """The generator every drop-path and dropout draws from in train mode."""
        self.visual_encoder.set_dropout_generator(generator)
        self.text_encoder.set_dropout_generator(generator)

    @torch.no_grad()
    def to_compute_dtype(self, dtype: torch.dtype) -> "BLIPFeatureFusion":
        """Compute in `dtype` and cast the parameters once, in place, for
        serving; LayerNorm parameters and `temp` stay fp32."""
        self.dtype = self.visual_encoder.dtype = self.text_encoder.dtype = dtype
        fp32 = {id(p) for m in self.modules() if isinstance(m, LayerNorm) for p in m.parameters()}
        fp32.add(id(self.temp))
        for p in self.parameters():
            if id(p) not in fp32:
                p.data = p.data.to(dtype)
        return self

    def encode_multimodal_input(self, txt_dict, images, txt_mask=None, img_mask=None) -> torch.Tensor:
        """txt_dict: {"input_ids", "attention_mask"} int [N, L]; images: float
        [N, H, W, 3] NHWC; the modality masks are unused -> fp32 [N, hidden]."""
        image_embeds = self.visual_encoder(images)
        _, pooled = self.text_encoder(
            txt_dict["input_ids"],
            attention_mask=txt_dict["attention_mask"],
            encoder_hidden_states=image_embeds,
            encoder_attention_mask=None,  # all ones
            mode="multimodal",
            trim_last=True,  # the pooler reads CLS only (exact)
        )
        return pooled.float()

    def forward(self, txt_dict, images, txt_mask=None, img_mask=None) -> torch.Tensor:
        return self.encode_multimodal_input(txt_dict, images, txt_mask, img_mask)
