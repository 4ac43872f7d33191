"""Model registry (counterpart of uniir_tpu/models/registry.py): CLIP-SF only.

`build_clip_sf` returns a `ModelBundle`: the module on its device in its
compute dtype, the tokenizer and the image transforms.  Weights come from a
torch checkpoint in OpenAI CLIP / UniIR layout when the config names one,
otherwise from a seeded `torch.Generator` with the JAX package's
initialisers.  The other three retrievers raise until they are ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable

import torch

from uniir_tpu_torch.models.clip import CLIP_CONFIGS, CLIPConfig
from uniir_tpu_torch.models.clip_sf import CLIPScoreFusion

MODEL_NAMES = ("CLIPScoreFusion", "CLIPFeatureFusion", "BLIPScoreFusion", "BLIPFeatureFusion")


@dataclass
class ModelBundle:
    name: str
    model: Any  # nn.Module, on its device, in its compute dtype
    tokenizer: Callable
    img_preprocess_fn: Callable
    img_preprocess_fn_eval: Callable
    image_size: tuple
    embed_dim: int


def seeded_clip_sf(cfg: CLIPConfig, device, seed: int = 0, dtype: torch.dtype = torch.bfloat16) -> CLIPScoreFusion:
    """CLIP-SF with weights drawn from `seed` on `device`, cast to `dtype`.

    The module is built without storage and filled in place on the device,
    so a ViT-L/14 never takes a CPU round trip."""
    device = torch.device(device)
    with torch.device("meta"):
        model = CLIPScoreFusion(cfg)
    model = model.to_empty(device=device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return model.to_compute_dtype(dtype).eval()


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


def build_clip_sf(config, device=None) -> ModelBundle:
    from uniir_tpu.data.preprocess import clip_transform
    from uniir_tpu.data.tokenizers.clip_bpe import CLIPTokenizer

    model_config = config.model
    cfg = CLIP_CONFIGS[model_config.clip_vision_model_name]
    if getattr(model_config, "int8", False):
        raise NotImplementedError("int8 serving is not ported to uniir_tpu_torch yet (ROADMAP.md, Queue 1 item 6)")
    device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    dtype = torch.bfloat16 if getattr(model_config, "bf16", True) else torch.float32
    model = seeded_clip_sf(cfg, device, int(getattr(config, "seed", 0)), dtype)

    ckpt_paths = [getattr(model_config, "pretrained_torch_ckpt", None)]
    ckpt_cfg = getattr(model_config, "ckpt_config", None)
    if ckpt_cfg is not None and getattr(ckpt_cfg, "ckpt_name", ""):
        ckpt_paths.append(os.path.join(config.uniir_dir, ckpt_cfg.ckpt_dir, ckpt_cfg.ckpt_name))
    for path in filter(None, ckpt_paths):
        if not path.endswith((".pt", ".pth")):
            raise NotImplementedError(
                f"{path}: only torch state dicts (.pt / .pth) load into uniir_tpu_torch; "
                "JAX train-state checkpoints wait for core/checkpoint.py (ROADMAP.md, Queue 1 item 2)"
            )
        load_torch_checkpoint(model, path)
        print(f"Loaded CLIPScoreFusion weights from {path}")

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


def build_model_from_config(config, device=None) -> ModelBundle:
    name = config.model.name
    if name == "CLIPScoreFusion":
        return build_clip_sf(config, device)
    if name in MODEL_NAMES:
        raise NotImplementedError(f"{name} is not ported to uniir_tpu_torch yet (ROADMAP.md, Queue 1 items 4-5)")
    raise ValueError(f"Unknown model name {name!r}; expected one of {MODEL_NAMES}")
