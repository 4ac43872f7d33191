"""JAX parameter tree -> the port's state dict (inverse of the JAX converter).

`uniir_tpu/models/convert.py::convert_clip_sf_params` maps an OpenAI CLIP
state dict onto the JAX package's CLIP-SF pytree.  The port's modules take
OpenAI CLIP's names directly, so moving JAX weights (numpy) into the port
inverts that map:

  * conv HWIO -> OIHW;
  * Dense kernel [in, out] -> Linear weight [out, in];
  * LayerNorm `scale` -> `weight`;
  * fused `qkv_proj/kernel` [W, 3W] -> `attn.in_proj_weight` [3W, W].
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(w) -> np.ndarray:
    return np.asarray(w).T


def _ln(p: dict, prefix: str) -> dict:
    return {f"{prefix}.weight": p["scale"], f"{prefix}.bias": p["bias"]}


def _resblocks(tree: dict, prefix: str) -> dict:
    out = {}
    i = 0
    while f"resblocks_{i}" in tree:
        blk, p = tree[f"resblocks_{i}"], f"{prefix}.resblocks.{i}"
        attn, mlp = blk["attn"], blk["mlp"]
        out.update(_ln(blk["ln_1"], f"{p}.ln_1"))
        out.update(_ln(blk["ln_2"], f"{p}.ln_2"))
        out[f"{p}.attn.in_proj_weight"] = _t(attn["qkv_proj"]["kernel"])
        out[f"{p}.attn.in_proj_bias"] = attn["qkv_proj"]["bias"]
        out[f"{p}.attn.out_proj.weight"] = _t(attn["out_proj"]["kernel"])
        out[f"{p}.attn.out_proj.bias"] = attn["out_proj"]["bias"]
        out[f"{p}.mlp.c_fc.weight"] = _t(mlp["fc1"]["kernel"])
        out[f"{p}.mlp.c_fc.bias"] = mlp["fc1"]["bias"]
        out[f"{p}.mlp.c_proj.weight"] = _t(mlp["fc2"]["kernel"])
        out[f"{p}.mlp.c_proj.bias"] = mlp["fc2"]["bias"]
        i += 1
    return out


def state_dict_from_jax(params_np) -> Dict[str, torch.Tensor]:
    """JAX CLIPScoreFusion params (numpy leaves) -> CLIPScoreFusion state dict (fp32)."""
    vis, txt = params_np["visual"], params_np["text"]
    sd = {
        "visual.conv1.weight": np.transpose(np.asarray(vis["conv1"]["proj"]["kernel"]), (3, 2, 0, 1)),
        "visual.class_embedding": vis["class_embedding"],
        "visual.positional_embedding": vis["positional_embedding"],
        "visual.proj": vis["proj"],
        **_ln(vis["ln_pre"], "visual.ln_pre"),
        **_ln(vis["ln_post"], "visual.ln_post"),
        **_resblocks(vis["transformer"], "visual.transformer"),
        "token_embedding.weight": txt["token_embedding"],
        "positional_embedding": txt["positional_embedding"],
        "text_projection": txt["text_projection"],
        **_ln(txt["ln_final"], "ln_final"),
        **_resblocks(txt["transformer"], "transformer"),
        "logit_scale": params_np["logit_scale"],
    }
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
