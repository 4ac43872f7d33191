"""JAX parameter tree -> the port's state dict (inverse of the JAX converter).

`uniir_tpu/models/convert.py::convert_clip_sf_params` maps an OpenAI CLIP
state dict onto the JAX package's CLIP-SF pytree.  The port's modules take
OpenAI CLIP's names directly, so moving JAX weights (numpy) into the port
inverts that map:

  * conv HWIO -> OIHW;
  * Dense kernel [in, out] -> Linear weight [out, in];
  * LayerNorm `scale` -> `weight`;
  * fused `qkv_proj/kernel` [W, 3W] -> `attn.in_proj_weight` [3W, W].

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


def state_dict_from_jax(params_np) -> Dict[str, torch.Tensor]:
    """JAX CLIPScoreFusion params (numpy leaves), float or quantised ->
    CLIPScoreFusion state dict (fp32; int8 for `weight_q`)."""
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
    return {
        k: torch.from_numpy(np.array(v, dtype=np.int8 if k.endswith(".weight_q") else np.float32))
        for k, v in sd.items()
    }
