"""Static-int8 activation calibration (counterpart of uniir_tpu/ops/calibrate.py).

The static int8 mode needs one fp32 activation scale per quantised tensor:
for each transformer block, [a1, a2] for the MLP (the ln_2 output entering
fc1, the activated hidden entering fc2: kernel K6's inputs) and
[a_qkv, a_out] for the attention (the ln_1 output entering the fused qkv
projection, the attention output entering out_proj).  `calibrate_act_scales`
measures them by running the float model over probe batches with forward
hooks that record each tensor's largest magnitude:

    scales = calibrate_act_scales(model_bf16, [batch, ...])
    sd = quantize_state_dict(model.state_dict(), act_scales_by_module(scales))

The artifact (`save_act_scales` / `load_act_scales`) is the JAX package's:
an .npz whose keys are flax module paths joined by "/"
(`visual/transformer/resblocks_3/mlp`, `text/transformer/resblocks_0/attn`),
each a float32 pair, so one calibration file serves both packages.
`module_name` / `module_path` map between those paths and the port's module
names (`visual.transformer.resblocks.3.mlp`, `transformer.resblocks.0.attn`:
the text tower sits at the root of the port's CLIP modules).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from uniir_tpu_torch.models.layers import TransformerBlock, quick_gelu

_KEY_SEP = "/"  # flax module names hold no slash, so the join is reversible
_TEXT_ROOT = "text"  # the flax tree's name for the tower at the port's root


def save_act_scales(path: str, scales: Dict[Tuple, np.ndarray]) -> None:
    """Persist calibrated activation scales, keyed by flax module path, to an .npz."""
    if not scales:  # AssertionErrors here and below, as the JAX package raises
        raise AssertionError("refusing to save an empty calibration")
    np.savez(path, **{_KEY_SEP.join(k): np.asarray(v, np.float32) for k, v in scales.items()})


def load_act_scales(path: str) -> Dict[Tuple, np.ndarray]:
    """Inverse of `save_act_scales`: npz -> {module-path tuple: float32 pair}."""
    with np.load(path) as z:
        out = {tuple(k.split(_KEY_SEP)): z[k].astype(np.float32) for k in z.files}
    if not out:
        raise AssertionError(f"calibration artifact {path!r} is empty")
    for k, v in out.items():
        if v.shape != (2,):
            raise AssertionError(f"calibration entry {k} has shape {v.shape}, expected (2,)")
    return out


def module_name(path: Tuple[str, ...]) -> str:
    """Flax module path -> the port's module name:
    ("visual", "transformer", "resblocks_3", "mlp") -> "visual.transformer.resblocks.3.mlp";
    the leading "text" of the text tower drops (it is the port's root)."""
    parts = list(path[1:] if path and path[0] == _TEXT_ROOT else path)
    return ".".join(p.replace("resblocks_", "resblocks.") for p in parts)


def module_path(name: str) -> Tuple[str, ...]:
    """Inverse of `module_name` for a CLIP module."""
    parts = name.replace("resblocks.", "resblocks_").split(".")
    return tuple(parts) if parts[0] == "visual" else (_TEXT_ROOT, *parts)


def act_scales_by_module(scales: Dict[Tuple, np.ndarray]) -> Dict[str, np.ndarray]:
    """{flax path: pair} -> {port module name: pair}, for `quantize_state_dict`."""
    return {module_name(k): v for k, v in scales.items()}


@torch.no_grad()
def calibrate_act_scales(model: torch.nn.Module, batches: Iterable[Tuple], margin: float = 1.0) -> Dict[Tuple, np.ndarray]:
    """Per-block static activation scales from probe forwards of the FLOAT model.

    batches: iterable of positional-argument tuples for `model(...)` (numpy
    arrays or tensors).  margin: multiplier on the observed largest magnitude
    (> 1 leaves headroom before clipping).  Returns
    {(..., "mlp"): [a1, a2], (..., "attn"): [a_qkv, a_out]} keyed by flax
    module path, each scale = max(amax * margin, 1e-4) / 127.  The hidden's
    amax is taken over QuickGELU, in fp32, of fc1's output, as the JAX
    package's probe does."""
    blocks = {name: m for name, m in model.named_modules() if isinstance(m, TransformerBlock)}
    if not blocks:
        raise ValueError("no transformer blocks to calibrate -- is this a pre-LN transformer model?")
    if any(b.attn.quant for b in blocks.values()):
        raise ValueError("calibrate the float model, not its int8 twin")
    device = next(model.parameters()).device
    amax: Dict[Tuple[str, str], torch.Tensor] = {}  # running maxima stay on the device until the end

    def record(key, value: torch.Tensor) -> None:
        top = value.detach().float().abs().amax()
        amax[key] = top if key not in amax else torch.maximum(amax[key], top)

    handles = []
    for name, blk in blocks.items():
        handles += [
            blk.ln_1.register_forward_hook(lambda m, args, out, n=name: record((n, "ln_1"), out)),
            blk.ln_2.register_forward_hook(lambda m, args, out, n=name: record((n, "ln_2"), out)),
            blk.attn.out_proj.register_forward_pre_hook(lambda m, args, n=name: record((n, "attn_pre_out"), args[0])),
            blk.mlp.c_fc.register_forward_hook(lambda m, args, out, n=name: record((n, "hidden"), quick_gelu(out.float()))),
        ]
    try:
        for batch in batches:
            model(*(torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(device) for x in batch))
    finally:
        for handle in handles:
            handle.remove()
    if not amax:
        raise ValueError("the probe batches ran no transformer block")
    seen = dict(zip(amax, torch.stack(list(amax.values())).tolist()))  # one fetch from the device

    def scale(value: float) -> float:
        return max(value * margin, 1e-4) / 127.0

    out: Dict[Tuple, np.ndarray] = {}
    for name in blocks:
        out[module_path(name + ".mlp")] = np.array([scale(seen[name, "ln_2"]), scale(seen[name, "hidden"])], np.float32)
        out[module_path(name + ".attn")] = np.array(
            [scale(seen[name, "ln_1"]), scale(seen[name, "attn_pre_out"])], np.float32)
    return out
