"""JAX parameter tree -> the port's state dict (inverse of the JAX converter).

`uniir_tpu/models/convert.py` maps an OpenAI CLIP state dict onto the JAX
package's CLIP-SF pytree (`convert_clip_sf_params`) and a BLIP state dict
onto its BLIP pytrees (`convert_blip_sf_params`, `convert_blip_vit`,
`convert_med_bert`).  The port's modules take the torch names directly, so
moving JAX weights (numpy) into the port inverts those maps:

  * conv HWIO -> OIHW;
  * Dense kernel [in, out] -> Linear weight [out, in];
  * LayerNorm `scale` -> `weight`;
  * fused `qkv_proj/kernel` [W, 3W] -> `attn.in_proj_weight` [3W, W]
    (CLIP) or `attn.qkv.weight` (BLIP's ViT);
  * `temp` / `logit_scale` as 0-d tensors.

`state_dict_from_jax` dispatches on the tree: CLIP-SF (float or quantised),
CLIP-FF (towers without `text_projection` under `clip_model.`, `t5_layers`
with HF T5Stack's names), BLIP-SF, BLIP-FF (cross-attention and pooler
kept, no projection heads), a bare `MedBertModel` tree (with or without
cross-attention and pooler), a bare `BLIPVisionTransformer` tree or a bare
`T5FusionStack` tree.

A tree quantised by the JAX package's `quantize_tree` converts too, onto the
state dict of the port's int8 modules, so both packages run the same int8
weights: `kernel_q` [in, out] int8 -> `weight_q` [out, in] int8, `scale` and
`bias` fp32, `act_scales` leaves -> `<module>.act_scales`; the fused
projection is `attn.qkv_proj` there.  Load such a state dict with
`ops.quant.load_quantized_state_dict`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(w) -> np.ndarray:
    return np.asarray(w).T


def _ln(p: dict, prefix: str) -> dict:
    return {f"{prefix}.weight": p["scale"], f"{prefix}.bias": p["bias"]}


def _dense(p: dict, prefix: str, fused_qkv: bool = False) -> dict:
    """One Dense layer: float {kernel, bias} or quantised {kernel_q, scale, bias}."""
    if "kernel_q" in p:
        if fused_qkv:
            prefix = prefix[: -len("in_proj")] + "qkv_proj"
        return {f"{prefix}.weight_q": _t(p["kernel_q"]), f"{prefix}.scale": p["scale"], f"{prefix}.bias": p["bias"]}
    if fused_qkv:  # OpenAI CLIP's fused in_proj has no `.weight` / `.bias` module
        return {f"{prefix}_weight": _t(p["kernel"]), f"{prefix}_bias": p["bias"]}
    return {f"{prefix}.weight": _t(p["kernel"]), f"{prefix}.bias": p["bias"]}


def _resblocks(tree: dict, prefix: str) -> dict:
    out = {}
    i = 0
    while f"resblocks_{i}" in tree:
        blk, p = tree[f"resblocks_{i}"], f"{prefix}.resblocks.{i}"
        attn, mlp = blk["attn"], blk["mlp"]
        out.update(_ln(blk["ln_1"], f"{p}.ln_1"))
        out.update(_ln(blk["ln_2"], f"{p}.ln_2"))
        out.update(_dense(attn["qkv_proj"], f"{p}.attn.in_proj", fused_qkv=True))
        out.update(_dense(attn["out_proj"], f"{p}.attn.out_proj"))
        out.update(_dense(mlp["fc1"], f"{p}.mlp.c_fc"))
        out.update(_dense(mlp["fc2"], f"{p}.mlp.c_proj"))
        for name, sub in (("attn", attn), ("mlp", mlp)):
            if "act_scales" in sub:
                out[f"{p}.{name}.act_scales"] = sub["act_scales"]
        i += 1
    return out


def _blip_vit(tree: dict, prefix: str = "") -> dict:
    """BLIPVisionTransformer params -> timm / BLIP names (inverse of `convert_blip_vit`)."""
    conv = tree["patch_embed"]["proj"]
    out = {
        f"{prefix}patch_embed.proj.weight": np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)),
        f"{prefix}patch_embed.proj.bias": conv["bias"],
        f"{prefix}cls_token": tree["cls_token"],
        f"{prefix}pos_embed": tree["pos_embed"],
        **_ln(tree["norm"], f"{prefix}norm"),
    }
    i = 0
    while f"blocks_{i}" in tree:
        blk, p = tree[f"blocks_{i}"], f"{prefix}blocks.{i}"
        out.update(_ln(blk["norm1"], f"{p}.norm1"))
        out.update(_ln(blk["norm2"], f"{p}.norm2"))
        out.update(_dense(blk["attn"]["qkv_proj"], f"{p}.attn.qkv"))
        out.update(_dense(blk["attn"]["out_proj"], f"{p}.attn.proj"))
        out.update(_dense(blk["mlp"]["fc1"], f"{p}.mlp.fc1"))
        out.update(_dense(blk["mlp"]["fc2"], f"{p}.mlp.fc2"))
        i += 1
    return out


def _bert_attention(tree: dict, prefix: str) -> dict:
    return {
        **_dense(tree["query"], f"{prefix}.self.query"),
        **_dense(tree["key"], f"{prefix}.self.key"),
        **_dense(tree["value"], f"{prefix}.self.value"),
        **_dense(tree["output_dense"], f"{prefix}.output.dense"),
        **_ln(tree["output_ln"], f"{prefix}.output.LayerNorm"),
    }


def _med_bert(tree: dict, prefix: str = "") -> dict:
    """MedBertModel params -> HF BERT names (inverse of `convert_med_bert`;
    the token-type row stays folded into the position table)."""
    out = {
        f"{prefix}embeddings.word_embeddings.weight": tree["word_embeddings"],
        f"{prefix}embeddings.position_embeddings.weight": tree["position_embeddings"],
        **_ln(tree["embeddings_ln"], f"{prefix}embeddings.LayerNorm"),
    }
    i = 0
    while f"layer_{i}" in tree:
        layer, p = tree[f"layer_{i}"], f"{prefix}encoder.layer.{i}"
        out.update(_bert_attention(layer["attention"], f"{p}.attention"))
        if "crossattention" in layer:
            out.update(_bert_attention(layer["crossattention"], f"{p}.crossattention"))
        out.update(_dense(layer["intermediate"], f"{p}.intermediate.dense"))
        out.update(_dense(layer["output_dense"], f"{p}.output.dense"))
        out.update(_ln(layer["output_ln"], f"{p}.output.LayerNorm"))
        i += 1
    if "pooler" in tree:
        out.update(_dense(tree["pooler"], f"{prefix}pooler.dense"))
    return out


def _blip(params_np: dict) -> dict:
    """BLIPScoreFusion / BLIPFeatureFusion params -> BLIP names (inverse of
    `convert_blip_sf_params` / `convert_blip_ff_params`; only score fusion
    has the projection heads)."""
    out = {
        **_blip_vit(params_np["visual_encoder"], "visual_encoder."),
        **_med_bert(params_np["text_encoder"], "text_encoder."),
        "temp": np.asarray(params_np["temp"]).reshape(()),
    }
    for head in ("vision_proj", "text_proj"):
        if head in params_np:
            out.update(_dense(params_np[head], head))
    return out


def _t5_stack(tree: dict, prefix: str = "") -> dict:
    """T5FusionStack params -> HF T5Stack names (inverse of `convert_t5_fusion_params`)."""
    out = {f"{prefix}final_layer_norm.weight": tree["final_ln"]["weight"]}
    i = 0
    while f"block_{i}" in tree:
        blk, p = tree[f"block_{i}"], f"{prefix}block.{i}"
        for name in ("q", "k", "v", "o"):
            out[f"{p}.layer.0.SelfAttention.{name}.weight"] = _t(blk["attn"][name]["kernel"])
        if "relative_attention_bias" in blk["attn"]:
            out[f"{p}.layer.0.SelfAttention.relative_attention_bias.weight"] = blk["attn"]["relative_attention_bias"]
        out[f"{p}.layer.0.layer_norm.weight"] = blk["attn_ln"]["weight"]
        out[f"{p}.layer.1.DenseReluDense.wi.weight"] = _t(blk["wi"]["kernel"])
        out[f"{p}.layer.1.DenseReluDense.wo.weight"] = _t(blk["wo"]["kernel"])
        out[f"{p}.layer.1.layer_norm.weight"] = blk["ff_ln"]["weight"]
        i += 1
    return out


def _clip(params_np: dict, prefix: str = "") -> dict:
    """CLIP towers and logit_scale -> OpenAI CLIP names under `prefix`; the
    token-output text tower of CLIP-FF has no `text_projection`."""
    vis, txt = params_np["visual"], params_np["text"]
    sd = {
        f"{prefix}visual.conv1.weight": np.transpose(np.asarray(vis["conv1"]["proj"]["kernel"]), (3, 2, 0, 1)),
        f"{prefix}visual.class_embedding": vis["class_embedding"],
        f"{prefix}visual.positional_embedding": vis["positional_embedding"],
        f"{prefix}visual.proj": vis["proj"],
        **_ln(vis["ln_pre"], f"{prefix}visual.ln_pre"),
        **_ln(vis["ln_post"], f"{prefix}visual.ln_post"),
        **_resblocks(vis["transformer"], f"{prefix}visual.transformer"),
        f"{prefix}token_embedding.weight": txt["token_embedding"],
        f"{prefix}positional_embedding": txt["positional_embedding"],
        **_ln(txt["ln_final"], f"{prefix}ln_final"),
        **_resblocks(txt["transformer"], f"{prefix}transformer"),
        f"{prefix}logit_scale": params_np["logit_scale"],
    }
    if "text_projection" in txt:
        sd[f"{prefix}text_projection"] = txt["text_projection"]
    return sd


def _tensors(sd: dict) -> Dict[str, torch.Tensor]:
    return {
        k: torch.from_numpy(np.array(v, dtype=np.int8 if k.endswith(".weight_q") else np.float32))
        for k, v in sd.items()
    }


def state_dict_from_jax(params_np) -> Dict[str, torch.Tensor]:
    """JAX params (numpy leaves) -> the state dict of the port's module of
    the same name: CLIPScoreFusion (float or quantised), CLIPFeatureFusion,
    BLIPScoreFusion, BLIPFeatureFusion, a bare MedBertModel, a bare
    BLIPVisionTransformer or a bare T5FusionStack tree (fp32; int8 for
    `weight_q`)."""
    if "visual_encoder" in params_np:
        return _tensors(_blip(params_np))
    if "word_embeddings" in params_np:
        return _tensors(_med_bert(params_np))
    if "patch_embed" in params_np:
        return _tensors(_blip_vit(params_np))
    if "final_ln" in params_np:
        return _tensors(_t5_stack(params_np))
    if "t5_layers" in params_np:
        return _tensors({**_clip(params_np, "clip_model."), **_t5_stack(params_np["t5_layers"], "t5_layers.")})
    return _tensors(_clip(params_np))
