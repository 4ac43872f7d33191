"""Static-int8 activation calibration (counterpart of uniir_tpu/ops/calibrate.py).

The static int8 mode needs one fp32 activation scale per quantised tensor.
`calibrate_act_scales` measures them by running the float model over probe
batches with forward hooks that record each tensor's largest magnitude (on
the device; one fetch at the end), one entry per owner of int8 layers:

  * a pre-LN block (CLIP's `TransformerBlock`, BLIP's `BLIPBlock`): the
    MLP's [a1, a2] (the ln_2 / norm2 output entering fc1, the activated
    hidden entering fc2: kernel K6's inputs) and the attention's
    [a_qkv, a_out] (the ln_1 / norm1 output entering the qkv projection,
    the attention output entering out_proj);
  * a T5 block (CLIP-FF's fusion stack): the attention's [attn_ln output,
    the attention output before `o`] and the FFN's [ff_ln output, relu(wi)];
  * MED (post-LN, no norm feeds a projection): each attention's
    [q_in, kv_in, attn_pre_out], the inputs of query, key and output.dense,
    and each layer's FFN [ffn_in, gelu(intermediate)].

    scales = calibrate_act_scales(model_bf16, [batch, ...])
    sd = quantize_state_dict(model, act_scales_by_module(scales, model))

The artifact (`save_act_scales` / `load_act_scales`) is the JAX package's:
an .npz whose keys are flax module paths joined by "/"
(`visual/transformer/resblocks_3/mlp`, `t5_layers/block_0/attn`,
`text_encoder/layer_2/crossattention`), each a float32 pair or MED
attention's triple, so one calibration file serves both packages (the JAX
package's own loader refuses the triples, which its CLI writes for BLIP).
`module_path` / `module_name` map between those paths and the port's module
names; CLIP-SF's text tower sits at the root of the port's module, CLIP-FF's
towers under `clip_model`.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from uniir_tpu_torch.models.blip_vit import BLIPBlock
from uniir_tpu_torch.models.layers import ACTIVATIONS, TransformerBlock, gelu_exact
from uniir_tpu_torch.models.med import BertLayer, BertSelfAttentionBlock
from uniir_tpu_torch.models.t5_fusion import T5Block
from uniir_tpu_torch.ops.quant import ActScales, QuantLinear
from uniir_tpu_torch.train.steps import to_device

_KEY_SEP = "/"  # flax module names hold no slash, so the join is reversible
_TEXT_ROOT = "text"  # the flax tree's name for CLIP's text tower
_CLIP_FF_ROOT = "clip_model"  # the port's module holding CLIP-FF's towers


def save_act_scales(path: str, scales: Dict[Tuple, np.ndarray]) -> None:
    """Persist calibrated activation scales, keyed by flax module path, to an .npz."""
    if not scales:  # AssertionErrors here and below, as the JAX package raises
        raise AssertionError("refusing to save an empty calibration")
    np.savez(path, **{_KEY_SEP.join(k): np.asarray(v, np.float32) for k, v in scales.items()})


def load_act_scales(path: str) -> Dict[Tuple, np.ndarray]:
    """Inverse of `save_act_scales`: npz -> {module-path tuple: float32 pair
    or triple}."""
    with np.load(path) as z:
        out = {tuple(k.split(_KEY_SEP)): z[k].astype(np.float32) for k in z.files}
    if not out:
        raise AssertionError(f"calibration artifact {path!r} is empty")
    for k, v in out.items():
        if v.shape not in ((2,), (3,)):
            raise AssertionError(f"calibration entry {k} has shape {v.shape}, expected (2,) or (3,)")
    return out


def module_path(name: str) -> Tuple[str, ...]:
    """The port's module name -> flax module path, for each model's layout:
    "visual.transformer.resblocks.3.mlp" -> ("visual", "transformer", "resblocks_3", "mlp")
    (also under CLIP-FF's "clip_model."; the root text tower is "text"),
    "t5_layers.block.0.layer.0.SelfAttention" -> ("t5_layers", "block_0", "attn"),
    "t5_layers.block.0.layer.1.DenseReluDense" -> ("t5_layers", "block_0"),
    "visual_encoder.blocks.2.attn" -> ("visual_encoder", "blocks_2", "attn"),
    "text_encoder.encoder.layer.1.crossattention" -> ("text_encoder", "layer_1", "crossattention")."""
    parts = name.split(".")
    if parts[0] == _CLIP_FF_ROOT:
        parts = parts[1:]
    if parts[0] == "t5_layers":
        block = ("t5_layers", f"block_{parts[2]}")
        return block + ("attn",) if parts[4] == "0" else block
    if parts[0] == "visual_encoder":
        return ("visual_encoder", f"blocks_{parts[2]}", *parts[3:])
    if parts[0] == "text_encoder":
        return ("text_encoder", f"layer_{parts[3]}", *parts[4:])
    parts = ".".join(parts).replace("resblocks.", "resblocks_").split(".")
    return tuple(parts) if parts[0] == "visual" else (_TEXT_ROOT, *parts)


def module_name(path: Tuple[str, ...]) -> str:
    """Inverse of `module_path`, CLIP paths in CLIP-SF's layout (text tower
    at the root); `act_scales_by_module` names CLIP-FF's from the model."""
    if path[0] == "t5_layers":
        block = f"t5_layers.block.{path[1][len('block_'):]}"
        return f"{block}.layer.0.SelfAttention" if path[2:] == ("attn",) else f"{block}.layer.1.DenseReluDense"
    if path[0] == "visual_encoder":
        return ".".join(("visual_encoder", "blocks", path[1][len("blocks_"):], *path[2:]))
    if path[0] == "text_encoder":
        return ".".join(("text_encoder", "encoder", "layer", path[1][len("layer_"):], *path[2:]))
    parts = list(path[1:] if path[0] == _TEXT_ROOT else path)
    return ".".join(p.replace("resblocks_", "resblocks.") for p in parts)


def act_scales_by_module(scales: Dict[Tuple, np.ndarray],
                         model: Optional[torch.nn.Module] = None) -> Dict[str, np.ndarray]:
    """{flax path: scales} -> {port module name: scales}, for
    `quantize_state_dict`: the names of `model`'s owners where given (a path
    that names none of them maps by `module_name` and is then refused)."""
    modules = [] if model is None else model.named_modules()
    owners = {module_path(n): n for n, m in modules if isinstance(m, ActScales) and n}
    return {owners.get(k) or module_name(k): v for k, v in scales.items()}


def _float32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def _entries(model: torch.nn.Module) -> Dict[Tuple, list]:
    """{flax path of an entry: its probes}; a probe is (module, "in" or
    "out", the function of that tensor whose magnitude is recorded)."""
    out: Dict[Tuple, list] = {}
    for name, m in model.named_modules():
        if isinstance(m, (TransformerBlock, BLIPBlock)):
            ln_1, ln_2 = (m.ln_1, m.ln_2) if isinstance(m, TransformerBlock) else (m.norm1, m.norm2)
            act = ACTIVATIONS[m.mlp.act]  # QuickGELU in CLIP, the exact GELU in BLIP's ViT, applied in fp32
            out[module_path(name + ".attn")] = [(ln_1, "out", _float32), (m.attn.out_proj, "in", _float32)]
            out[module_path(name + ".mlp")] = [(ln_2, "out", _float32), (m.mlp.c_fc, "out", lambda y, f=act: f(y.float()))]
        elif isinstance(m, T5Block):
            attn, ffn = m.layer[0], m.layer[1]
            out[module_path(name + ".layer.0.SelfAttention")] = [
                (attn.layer_norm, "out", _float32), (attn.SelfAttention.o, "in", _float32)]
            out[module_path(name + ".layer.1.DenseReluDense")] = [
                (ffn.layer_norm, "out", _float32), (ffn.DenseReluDense.wi, "out", lambda y: torch.relu(y.float()))]
        elif isinstance(m, BertSelfAttentionBlock):
            proj = getattr(m, "self")
            out[module_path(name)] = [(proj.query, "in", _float32), (proj.key, "in", _float32),
                                      (m.output.dense, "in", _float32)]
        elif isinstance(m, BertLayer):
            # the hidden as the layer feeds it on: GELU in the compute dtype
            out[module_path(name)] = [(m.intermediate.dense, "in", _float32),
                                      (m.intermediate.dense, "out", lambda y: gelu_exact(y).float())]
    return out


@torch.no_grad()
def calibrate_act_scales(model: torch.nn.Module, batches: Iterable[Tuple], margin: float = 1.0) -> Dict[Tuple, np.ndarray]:
    """Static activation scales from probe forwards of the FLOAT model.

    batches: iterable of positional-argument tuples for `model(...)` (numpy
    arrays, tensors, or BLIP's dict of token ids and mask).  margin:
    multiplier on the observed largest magnitude (> 1 leaves headroom before
    clipping).  Returns {flax module path: scales}, each scale =
    max(amax * margin, 1e-4) / 127, for every entry whose tensors the probes
    saw (see the module docstring)."""
    if any(isinstance(m, QuantLinear) for m in model.modules()):
        raise ValueError("calibrate the float model, not its int8 twin")
    entries = _entries(model)
    if not entries:
        raise ValueError("no transformer blocks to calibrate -- is this one of the four retrievers?")
    device = next(model.parameters()).device
    amax: Dict[Tuple, torch.Tensor] = {}  # running maxima stay on the device until the end

    def record(key, value: torch.Tensor) -> None:
        top = value.detach().abs().amax()
        amax[key] = top if key not in amax else torch.maximum(amax[key], top)

    handles = []
    for path, probes in entries.items():
        for j, (module, where, fn) in enumerate(probes):
            key = (path, j)
            if where == "in":
                handles.append(module.register_forward_pre_hook(lambda m, args, k=key, f=fn: record(k, f(args[0]))))
            else:
                handles.append(module.register_forward_hook(lambda m, args, y, k=key, f=fn: record(k, f(y))))
    try:
        for batch in batches:
            model(*(to_device(x, device) for x in batch))
    finally:
        for handle in handles:
            handle.remove()
    if not amax:
        raise ValueError("the probe batches ran no transformer block")
    seen = dict(zip(amax, torch.stack(list(amax.values())).tolist()))  # one fetch from the device

    def scale(value: float) -> float:
        return max(value * margin, 1e-4) / 127.0

    return {
        path: np.array([scale(seen[path, j]) for j in range(len(probes))], np.float32)
        for path, probes in entries.items()
        if all((path, j) in seen for j in range(len(probes)))
    }
