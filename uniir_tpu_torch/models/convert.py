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

`load_optimizer_state_from_jax` carries a restored optax state into the
port's AdamW and its LambdaLR: `optax.adamw` (its decay mask a
`MaskedState`), `optax.multi_transform` over {backbone, fusion} (CLIP-FF)
or {train, frozen} (BLIP, the frozen label an `optax.set_to_zero`), either
inside `optax.MultiSteps`.  The moments move through the same key map as
the parameters, matched by name, and only through maps that move elements
(`element_map` checks it); `load_train_state_from_jax` does a whole train
state -- parameters, BLIP's momentum items, optimizer, schedule and step.
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


def _renamed(params_np) -> dict:
    """The port's names -> numpy arrays of a JAX tree (`state_dict_from_jax` before the dtype)."""
    if "visual_encoder" in params_np:
        return _blip(params_np)
    if "word_embeddings" in params_np:
        return _med_bert(params_np)
    if "patch_embed" in params_np:
        return _blip_vit(params_np)
    if "final_ln" in params_np:
        return _t5_stack(params_np)
    if "t5_layers" in params_np:
        return {**_clip(params_np, "clip_model."), **_t5_stack(params_np["t5_layers"], "t5_layers.")}
    return _clip(params_np)


def state_dict_from_jax(params_np) -> Dict[str, torch.Tensor]:
    """JAX params (numpy leaves) -> the state dict of the port's module of
    the same name, float or quantised: CLIPScoreFusion, CLIPFeatureFusion,
    BLIPScoreFusion, BLIPFeatureFusion, a bare MedBertModel, a bare
    BLIPVisionTransformer or a bare T5FusionStack tree (fp32; int8 for
    `weight_q`)."""
    return _tensors(_renamed(params_np))


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict in key order; a leaf is anything else."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _rebuild(tree, fn, path=()):
    """`tree` with each leaf replaced by fn(path, leaf)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def element_map(params_np) -> Dict[str, tuple]:
    """Port name -> the JAX leaf (path) it comes from, after checking that
    the key map only moves elements: every element of the tree, numbered,
    goes through `_renamed` and comes out exactly once and unchanged (a
    rename, transpose, reshape or concatenation), or ValueError names the
    port keys whose elements were combined or dropped."""
    offsets, paths, total = {}, [], 0
    for path, leaf in _leaves(params_np):
        offsets[path] = total
        paths.append(path)
        total += int(np.size(leaf))
    dtype = np.int32 if total < 2**31 else np.int64
    numbered = _rebuild(params_np, lambda path, leaf: np.arange(offsets[path], offsets[path] + np.size(leaf),
                                                                dtype=dtype).reshape(np.shape(leaf)))
    out = {k: np.asarray(v) for k, v in _renamed(numbered).items()}
    ids = np.concatenate([v.reshape(-1) for v in out.values()]) if out else np.zeros(0, dtype)
    ids.sort()
    if ids.shape != (total,) or not np.array_equal(ids, np.arange(total, dtype=dtype)):
        seen = np.bincount(np.clip(ids, 0, total), minlength=total + 1)
        bad = [k for k, v in out.items() if v.size and (v.min() < 0 or v.max() >= total or (seen[v.reshape(-1)] != 1).any())]
        raise ValueError(f"the JAX -> port key map does not only move elements (sums, drops or copies) for {bad[:5]} "
                         f"({len(ids)} elements out of {total})")
    starts = np.array([offsets[p] for p in paths])
    return {k: paths[int(np.searchsorted(starts, v.reshape(-1)[0], side="right")) - 1] for k, v in out.items() if v.size}


def _fields(node) -> tuple:
    return getattr(type(node), "_fields", ())


def _adam_groups(opt_state, groups: list, counts: list) -> None:
    """Walk an optax state (NamedTuples and tuples of numpy leaves, by their
    field names: no optax import): ScaleByAdamState (count, mu, nu) into
    `groups`, ScaleByScheduleState counts into `counts`; MultiStepsState
    unwrapped only at mini_step 0."""
    fields = _fields(opt_state)
    if "mini_step" in fields:
        mini_step = int(np.asarray(opt_state.mini_step))
        if mini_step:
            raise ValueError(f"the JAX optimizer state is inside a gradient accumulation (MultiStepsState mini_step "
                             f"{mini_step}): its accumulated gradients have no place in the port's checkpoint; save "
                             "it after a whole update")
        _adam_groups(opt_state.inner_opt_state, groups, counts)
    elif "inner_states" in fields:  # multi_transform: one state a label
        for label in sorted(opt_state.inner_states):
            _adam_groups(opt_state.inner_states[label], groups, counts)
    elif "inner_state" in fields:  # MaskedState
        _adam_groups(opt_state.inner_state, groups, counts)
    elif set(fields) == {"count", "mu", "nu"}:
        groups.append((int(np.asarray(opt_state.count)), opt_state.mu, opt_state.nu))
    elif fields == ("count",):
        counts.append(int(np.asarray(opt_state.count)))
    elif fields:
        raise ValueError(f"unknown optax state {type(opt_state).__name__} with fields {fields}")
    else:  # a chain's states; EmptyState (set_to_zero, the decay's) holds none
        for inner in opt_state:
            _adam_groups(inner, groups, counts)


def _is_masked(leaf) -> bool:
    """optax's MaskedNode: a leaf of another label's (or a masked) subtree."""
    return isinstance(leaf, tuple) and not leaf


def load_optimizer_state_from_jax(state, params, opt_state, step: int) -> None:
    """Carry a restored optax state (numpy leaves; `params` the JAX
    parameter tree it belongs to, `step` the JAX TrainState's micro-batch
    count) into the port's `train.state` in place: each parameter's AdamW
    `exp_avg` / `exp_avg_sq` from the `mu` / `nu` of the label that trains
    it, matched by name through `element_map`, its `step` that label's
    count; the scheduler at that many updates (`train.optimizer.
    set_schedule_position`); `state.step` = `step`.  A leaf no label trains
    (`set_to_zero`) carries nothing and must not be a port parameter; every
    parameter the port's optimizer holds must get state.  A state inside an
    accumulation (mini_step != 0) raises ValueError naming `mini_step`."""
    from uniir_tpu_torch.train.optimizer import set_schedule_position

    groups, schedule_counts = [], []
    _adam_groups(opt_state, groups, schedule_counts)
    if not groups:
        raise ValueError("no optax.adamw state (ScaleByAdamState) in the JAX optimizer state")
    updates = {count for count, _, _ in groups} | set(schedule_counts)
    if len(updates) != 1:
        raise ValueError(f"the JAX optimizer state's labels disagree on the update count: {sorted(updates)}")
    (updates,) = updates
    if step != updates * state.accumulation_steps:
        raise ValueError(f"JAX step {step} is not {updates} updates of {state.accumulation_steps} micro-batches: "
                         "the config's gradient_accumulation_steps differs from the checkpoint's")
    owner, mu, nu = {}, {}, {}  # JAX leaf path -> its label's moments
    for g, (_, mu_tree, nu_tree) in enumerate(groups):
        for (path, m), (_, v) in zip(_leaves(mu_tree), _leaves(nu_tree)):
            if _is_masked(m):
                continue
            if path in owner:
                raise ValueError(f"JAX parameter {'/'.join(path)} has state in two optimizer labels")
            owner[path], mu[path], nu[path] = g, m, v
    key_of = element_map(params)
    zeros = _rebuild(params, lambda path, leaf: np.zeros(np.shape(leaf), np.float32))
    moments = [_tensors(_renamed(_rebuild(zeros, lambda path, z: tree.get(path, z)))) for tree in (mu, nu)]
    # parameters by their state-dict names, the names `state_dict_from_jax` writes (the BLIP ViT's are timm's)
    by_name = {k: v for k, v in state.model.state_dict(keep_vars=True).items() if isinstance(v, torch.nn.Parameter)}
    for key, path in key_of.items():
        if path in owner and key not in by_name:
            raise ValueError(f"JAX parameter {'/'.join(path)} ({key}) trains but the port's model has no {key}")
    names = {id(p): n for n, p in by_name.items()}
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            key = names[id(p)]
            if key not in key_of or key_of[key] not in owner:
                raise ValueError(f"port parameter {key} has no optimizer state in the JAX checkpoint")
            state.optimizer.state[p] = {
                "step": torch.tensor(float(updates), dtype=torch.float32),
                "exp_avg": moments[0][key].to(p.device, p.dtype).reshape(p.shape).clone(),
                "exp_avg_sq": moments[1][key].to(p.device, p.dtype).reshape(p.shape).clone(),
            }
    set_schedule_position(state.scheduler, updates)
    state.step = int(step)


def load_train_state_from_jax(state, tree: dict) -> None:
    """A whole JAX train state as numpy trees -- the JAX package's
    checkpoint items: `step`, `params`, `opt_state`, and for BLIP
    `params_m`, the queues and `queue_ptr` -- into the port's
    `TrainState` / `MomentumTrainState` in place."""
    if hasattr(state, "model_m"):
        load_momentum_state_from_jax(state, **{k: tree[k] for k in ("params", "params_m", "queue_query", "queue_cand",
                                                                     "queue_idx", "queue_ptr")})
    else:
        state.model.load_state_dict(state_dict_from_jax(tree["params"]))
    load_optimizer_state_from_jax(state, tree["params"], tree["opt_state"], int(np.asarray(tree["step"])))


def load_momentum_state_from_jax(state, params, params_m, queue_query, queue_cand, queue_idx, queue_ptr) -> None:
    """Carry a JAX `MomentumTrainState`, given as numpy arrays, into the
    port's `train.state.MomentumTrainState` in place: the online and the
    momentum parameters through `state_dict_from_jax` (every port key
    required; a JAX leaf the port's model lacks -- BLIP-SF's frozen
    cross-attention, if the tree has it -- left out), the row-major queues
    and the ring pointer.  The optimizer state, the schedule and the step
    come from `load_optimizer_state_from_jax` (`load_train_state_from_jax`
    does both); without it they stay the port's."""
    for module, tree in ((state.model, params), (state.model_m, params_m)):
        wanted = module.state_dict()
        module.load_state_dict({k: v for k, v in state_dict_from_jax(tree).items()
                                if k in wanted or ".crossattention." not in k})
    for name, value in (("queue_query", queue_query), ("queue_cand", queue_cand), ("queue_idx", queue_idx)):
        target = getattr(state, name)
        target.copy_(torch.from_numpy(np.array(value)).to(target.dtype))
    state.queue_ptr = int(queue_ptr)
