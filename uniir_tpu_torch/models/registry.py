"""Model registry (counterpart of uniir_tpu/models/registry.py): CLIP-SF only.

`build_clip_sf` returns a `ModelBundle`: the module on its device, the
tokenizer and the image transforms.  For serving the parameters are cast
once to the compute dtype; for training (`train=True`) they stay fp32
masters, cast at each use, and `model.remat` switches on per-block
recomputation.  Weights come from a torch checkpoint in OpenAI CLIP / UniIR
layout (or the port's own train checkpoint directory) when the config
names one, otherwise from a seeded `torch.Generator` with the JAX
package's initialisers.  With `model.int8` the loaded fp32 weights are
quantised into the int8 serving twin (`quantize_clip_sf`); the activation
mode and the static MLP route are read from the environment once, here
(`UNIIR_INT8_BACKEND`, `UNIIR_INT8_MLP`; see `ops/quant.py`), and
`model.int8_calibration` names the .npz of calibrated activation scales the
static mode needs.  The other three retrievers raise until they are ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from uniir_tpu_torch.core.checkpoint import CHECKPOINT_FILE
from uniir_tpu_torch.data.preprocess import clip_transform
from uniir_tpu_torch.data.tokenizers.clip_bpe import CLIPTokenizer
from uniir_tpu_torch.models.clip import CLIP_CONFIGS, CLIPConfig
from uniir_tpu_torch.models.clip_sf import CLIPScoreFusion
from uniir_tpu_torch.ops.calibrate import act_scales_by_module, load_act_scales
from uniir_tpu_torch.ops.quant import (
    int8_mlp_route_from_env,
    int8_mode_from_env,
    load_quantized_state_dict,
    quantize_state_dict,
)

MODEL_NAMES = ("CLIPScoreFusion", "CLIPFeatureFusion", "BLIPScoreFusion", "BLIPFeatureFusion")


@dataclass
class ModelBundle:
    name: str
    model: Any  # nn.Module on its device
    tokenizer: Callable
    img_preprocess_fn: Callable
    img_preprocess_fn_eval: Callable
    image_size: tuple
    embed_dim: int


def _seeded(cfg: CLIPConfig, device, seed: int, **kwargs) -> CLIPScoreFusion:
    # built without storage and filled in place on the device, so a ViT-L/14
    # never takes a CPU round trip
    device = torch.device(device)
    with torch.device("meta"):
        model = CLIPScoreFusion(cfg, **kwargs)
    model = model.to_empty(device=device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return model


def seeded_clip_sf(cfg: CLIPConfig, device, seed: int = 0, dtype: torch.dtype = torch.bfloat16) -> CLIPScoreFusion:
    """CLIP-SF for serving: weights drawn from `seed` on `device`, cast to `dtype`."""
    return _seeded(cfg, device, seed).to_compute_dtype(dtype).eval()


def quantize_clip_sf(model: CLIPScoreFusion, int8_mode: str = "dynamic", mlp_route: str = "fused",
                     act_scales: Optional[dict] = None) -> CLIPScoreFusion:
    """The int8 serving twin of a float CLIP-SF, on its device, computing in
    its dtype: every block's Dense weights quantised per output channel from
    the model's weights as they are (quantise before `to_compute_dtype` to
    start from fp32).  `act_scales`: calibrated pairs keyed by flax module
    path (`ops.calibrate.load_act_scales`); a stale key is an error."""
    device = next(model.parameters()).device
    state = quantize_state_dict(model.state_dict(), None if act_scales is None else act_scales_by_module(act_scales))
    with torch.device("meta"):
        twin = CLIPScoreFusion(model.cfg, quant=True, dtype=model.dtype, int8_mode=int8_mode, mlp_route=mlp_route)
    twin = twin.to_empty(device=device)
    load_quantized_state_dict(twin, state)
    return twin.eval()


def seeded_clip_sf_train(
    cfg: CLIPConfig, device, seed: int = 0, dtype: torch.dtype = torch.bfloat16, remat: bool = False
) -> CLIPScoreFusion:
    """CLIP-SF for training: fp32 master weights drawn from `seed` on
    `device`, computing in `dtype`, with per-block recomputation if `remat`."""
    return _seeded(cfg, device, seed, dtype=dtype, remat=remat).train()


def _strip(sd: dict) -> dict:
    out = {}
    for k, v in sd.items():
        for prefix in ("module.", "clip_model."):
            if k.startswith(prefix):
                k = k[len(prefix) :]
        out[k] = v
    return out


def load_torch_checkpoint(model: CLIPScoreFusion, path: str) -> None:
    """Load an OpenAI CLIP / UniIR CLIP-SF state dict (.pt / .pth) into the module."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    wanted = model.state_dict()
    sd = {k: v for k, v in _strip(sd).items() if k in wanted}
    model.load_state_dict(sd, strict=True)


def _int8_settings(model_config):
    """(mode, MLP route, calibrated scales or None) of `model.int8`, read
    once; the static mode without a calibration artifact is an error."""
    mode, route = int8_mode_from_env(), int8_mlp_route_from_env()
    act_scales = None
    calib_path = getattr(model_config, "int8_calibration", None)
    if calib_path:
        act_scales = load_act_scales(calib_path)
        print(f"Loaded {len(act_scales)} calibrated act scales from {calib_path}")
    elif mode == "static":
        raise ValueError(
            "UNIIR_INT8_BACKEND=static needs calibrated activation scales: "
            "run tools/calibrate_int8.py and set model.int8_calibration to "
            "the .npz it writes"
        )
    return mode, route, act_scales


def build_clip_sf(config, device=None, train: bool = False) -> ModelBundle:
    model_config = config.model
    cfg = CLIP_CONFIGS[model_config.clip_vision_model_name]
    int8 = bool(getattr(model_config, "int8", False))
    if int8 and train:
        raise ValueError("model.int8 is a serving mode: int8 layers do not train")
    int8_settings = _int8_settings(model_config) if int8 else None
    device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    dtype = torch.bfloat16 if getattr(model_config, "bf16", True) else torch.float32
    seed = int(getattr(config, "seed", 0))
    if train:
        model = seeded_clip_sf_train(cfg, device, seed, dtype, remat=bool(getattr(model_config, "remat", False)))
    elif int8:
        model = _seeded(cfg, device, seed)  # fp32 until quantised: the weights quantise from fp32
    else:
        model = seeded_clip_sf(cfg, device, seed, dtype)

    ckpt_paths = [getattr(model_config, "pretrained_torch_ckpt", None)]
    ckpt_cfg = getattr(model_config, "ckpt_config", None)
    # in training, ckpt_config names the checkpoint to resume (the trainer's job)
    if not train and ckpt_cfg is not None and getattr(ckpt_cfg, "ckpt_name", ""):
        ckpt_paths.append(os.path.join(config.uniir_dir, ckpt_cfg.ckpt_dir, ckpt_cfg.ckpt_name))
    for path in filter(None, ckpt_paths):
        if os.path.isfile(os.path.join(path, CHECKPOINT_FILE)):  # the port's train checkpoint directory
            path = os.path.join(path, CHECKPOINT_FILE)
        if not path.endswith((".pt", ".pth")):
            raise NotImplementedError(
                f"{path}: only torch state dicts (.pt / .pth) and the port's train checkpoints load into "
                "uniir_tpu_torch; JAX (orbax) train-state checkpoints are not read yet (ROADMAP.md, Queue 1 item 3)"
            )
        load_torch_checkpoint(model, path)
        print(f"Loaded CLIPScoreFusion weights from {path}")

    if int8:
        mode, route, act_scales = int8_settings
        model = quantize_clip_sf(model, mode, route, act_scales).to_compute_dtype(dtype)
        print(f"Quantized CLIPScoreFusion to int8 serving mode ({mode})")

    tokenizer = CLIPTokenizer(bpe_path=getattr(model_config, "clip_bpe_path", None))

    def tokenizer_wrapper(txts):
        return tokenizer(txts, context_length=cfg.context_length, truncate=True)

    transform = clip_transform(cfg.image_size)
    return ModelBundle(
        name="CLIPScoreFusion",
        model=model,
        tokenizer=tokenizer_wrapper,
        img_preprocess_fn=transform,
        img_preprocess_fn_eval=transform,
        image_size=(cfg.image_size, cfg.image_size),
        embed_dim=cfg.embed_dim,
    )


def build_model_from_config(config, device=None, train: bool = False) -> ModelBundle:
    name = config.model.name
    if name == "CLIPScoreFusion":
        return build_clip_sf(config, device, train)
    if name in MODEL_NAMES:
        raise NotImplementedError(f"{name} is not ported to uniir_tpu_torch yet (ROADMAP.md, Queue 1 items 4-5)")
    raise ValueError(f"Unknown model name {name!r}; expected one of {MODEL_NAMES}")
