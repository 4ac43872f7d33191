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

`state_dict_from_jax` dispatches on the tree, float or quantised: CLIP-SF,
CLIP-FF (towers without `text_projection` under `clip_model.`, `t5_layers`
with HF T5Stack's names), BLIP-SF, BLIP-FF (cross-attention and pooler
kept, no projection heads), a bare `MedBertModel` tree (with or without
cross-attention and pooler), a bare `BLIPVisionTransformer` tree or a bare
`T5FusionStack` tree.

A tree quantised by the JAX package's `quantize_tree` converts too, onto the
state dict of the port's int8 modules, so both packages run the same int8
weights: `kernel_q` [in, out] int8 -> `weight_q` [out, in] int8, `scale` and
`bias` fp32 (T5's layers have none), `act_scales` leaves ->
`<module>.act_scales` (pairs, and MED's attention triples); CLIP's fused
projection is `attn.qkv_proj` there, BLIP's keeps timm's `attn.qkv` (the
ViT block maps it on load).  Load such a state dict with
`ops.quant.load_quantized_state_dict`.

`load_momentum_state_from_jax` carries a whole JAX BLIP train state
(`params`, `params_m`, the queues and `queue_ptr`) into the port's, so both
packages can start training from the same state.
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
    """One Dense layer: float {kernel[, bias]} or quantised {kernel_q, scale[, bias]}."""
    if "kernel_q" in p:
        if fused_qkv:
            prefix = prefix[: -len("in_proj")] + "qkv_proj"
        out = {f"{prefix}.weight_q": _t(p["kernel_q"]), f"{prefix}.scale": p["scale"]}
    elif fused_qkv:  # OpenAI CLIP's fused in_proj has no `.weight` / `.bias` module
        return {f"{prefix}_weight": _t(p["kernel"]), f"{prefix}_bias": p["bias"]}
    else:
        out = {f"{prefix}.weight": _t(p["kernel"])}
    if "bias" in p:
        out[f"{prefix}.bias"] = p["bias"]
    return out


def _act_scales(p: dict, module: str) -> dict:
    """A calibrated `act_scales` leaf of a quantised tree, if `p` has one."""
    return {f"{module}.act_scales": p["act_scales"]} if "act_scales" in p else {}


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
        out.update(_act_scales(attn, f"{p}.attn"))
        out.update(_act_scales(mlp, f"{p}.mlp"))
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
        out.update(_act_scales(blk["attn"], f"{p}.attn"))
        out.update(_act_scales(blk["mlp"], f"{p}.mlp"))
        i += 1
    return out


def _bert_attention(tree: dict, prefix: str) -> dict:
    return {
        **_dense(tree["query"], f"{prefix}.self.query"),
        **_dense(tree["key"], f"{prefix}.self.key"),
        **_dense(tree["value"], f"{prefix}.self.value"),
        **_dense(tree["output_dense"], f"{prefix}.output.dense"),
        **_ln(tree["output_ln"], f"{prefix}.output.LayerNorm"),
        **_act_scales(tree, prefix),
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
        out.update(_act_scales(layer, p))
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
        attn, ffn = f"{p}.layer.0.SelfAttention", f"{p}.layer.1.DenseReluDense"
        for name in ("q", "k", "v", "o"):
            out.update(_dense(blk["attn"][name], f"{attn}.{name}"))
        if "relative_attention_bias" in blk["attn"]:
            out[f"{attn}.relative_attention_bias.weight"] = blk["attn"]["relative_attention_bias"]
        out[f"{p}.layer.0.layer_norm.weight"] = blk["attn_ln"]["weight"]
        out.update(_dense(blk["wi"], f"{ffn}.wi"))
        out.update(_dense(blk["wo"], f"{ffn}.wo"))
        out[f"{p}.layer.1.layer_norm.weight"] = blk["ff_ln"]["weight"]
        out.update(_act_scales(blk["attn"], attn))  # [a_qkv, a_out]
        out.update(_act_scales(blk, ffn))  # the JAX block's own leaf: [a_ff_in, a_hidden]
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
    the same name, float or quantised: CLIPScoreFusion, CLIPFeatureFusion,
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


def load_momentum_state_from_jax(state, params, params_m, queue_query, queue_cand, queue_idx, queue_ptr) -> None:
    """Carry a JAX `MomentumTrainState`, given as numpy arrays, into the
    port's `train.state.MomentumTrainState` in place: the online and the
    momentum parameters through `state_dict_from_jax` (every key required),
    the row-major queues and the ring pointer.  The optimizer state and the
    step stay the port's."""
    state.model.load_state_dict(state_dict_from_jax(params))
    state.model_m.load_state_dict(state_dict_from_jax(params_m))
    for name, value in (("queue_query", queue_query), ("queue_cand", queue_cand), ("queue_idx", queue_idx)):
        target = getattr(state, name)
        target.copy_(torch.from_numpy(np.array(value)).to(target.dtype))
    state.queue_ptr = int(queue_ptr)
