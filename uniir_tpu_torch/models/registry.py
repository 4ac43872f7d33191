"""Model registry (counterpart of uniir_tpu/models/registry.py): the four
retrievers, CLIP-SF, CLIP-FF, BLIP-SF and BLIP-FF.

`build_clip_sf` / `build_clip_ff` / `build_blip_sf` / `build_blip_ff` return
a `ModelBundle`: the module on its device, the tokenizer and the image
transforms.  The device is the CUDA
card unless the caller names one: with no card and no device named the
build raises (`core.device.resolve_device`).  For serving the parameters are cast
once to the compute dtype; for training (`train=True`) they stay fp32
masters, cast at each use, and `model.remat` switches on per-block
recomputation.  Weights come from a torch checkpoint in OpenAI CLIP / UniIR
layout (or the port's own train checkpoint directory) when the config
names one, otherwise from a seeded `torch.Generator` with the JAX
package's initialisers.  With `model.int8` (serving only, any of the four
retrievers) the loaded fp32 weights are quantised into the int8 serving
twin (`quantize_clip_sf`, `quantize_clip_ff`, `quantize_blip`) and then
cast to the compute dtype; the activation mode and the static MLP route are
read from the environment once, here (`UNIIR_INT8_BACKEND`,
`UNIIR_INT8_MLP`; see `ops/quant.py`), and `model.int8_calibration` names
the .npz of calibrated activation scales the static mode needs.
`UNIIR_ATTN_SPLITK=1` is read here too, once, and handed to the CLIP models
as `attn_splitk`: the vision tower's attention forward is then kernel K10
(`ops/attention.py`).

CLIP-FF (`build_clip_ff`) serves and trains; a `.pt` / `.pth` in the UniIR
CLIP-FF layout (`clip_model.*`, `t5_layers.*`) or a bare OpenAI CLIP state
dict (towers only; the fusion stack stays seeded) loads through
`load_clip_ff_checkpoint`, `text_projection` dropped either way.

BLIP-SF (`build_blip_sf`) reads `vit`, `image_size`, `embed_dim`,
`tokenizer_max_length` and `bert_vocab_path` from the config; a missing
vocabulary path raises FileNotFoundError.  A BLIP `.pth` state dict loads
through `load_blip_checkpoint`, which for BLIP-FF (`build_blip_ff`) keeps
the cross-attention and pooler keys that BLIP-SF drops.  With `train=True`
a BLIP model keeps fp32 masters, computes in the config's dtype and reads
`model.vit_grad_ckpt` as `remat` (every ViT block, and in BLIP-FF every MED
layer too; `vit_ckpt_layer` is ignored, as the JAX package ignores it); its
bundle carries `queue_size`, `momentum` and `alpha` in `extra`, as the JAX
bundle's does.
"""

from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from uniir_tpu_torch.core.checkpoint import CHECKPOINT_FILE
from uniir_tpu_torch.core.device import resolve_device
from uniir_tpu_torch.data.preprocess import blip_transform, clip_transform
from uniir_tpu_torch.data.tokenizers.bert_wordpiece import BertTokenizer
from uniir_tpu_torch.data.tokenizers.clip_bpe import CLIPTokenizer
from uniir_tpu_torch.models.blip_ff import BLIPFeatureFusion
from uniir_tpu_torch.models.blip_sf import BLIPScoreFusion
from uniir_tpu_torch.models.blip_vit import BLIP_VIT_CONFIGS, BLIPViTConfig
from uniir_tpu_torch.models.clip import CLIP_CONFIGS, CLIPConfig
from uniir_tpu_torch.models.clip_ff import CLIPFeatureFusion
from uniir_tpu_torch.models.clip_sf import CLIPScoreFusion
from uniir_tpu_torch.models.layers import interpolate_pos_embed
from uniir_tpu_torch.models.med import MED_CONFIGS, MedConfig
from uniir_tpu_torch.ops.attention import attn_splitk_from_env
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
    extra: dict = field(default_factory=dict)  # BLIP: queue_size, momentum, alpha


def _seeded_module(factory: Callable, device, seed: int):
    # built without storage and filled in place on the device, so a ViT-L
    # never takes a CPU round trip
    device = torch.device(device)
    with torch.device("meta"):
        model = factory()
    model = model.to_empty(device=device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return model


def _seeded(cfg: CLIPConfig, device, seed: int, **kwargs) -> CLIPScoreFusion:
    return _seeded_module(lambda: CLIPScoreFusion(cfg, **kwargs), device, seed)


def seeded_blip_sf(vit_cfg: BLIPViTConfig, med_cfg: MedConfig, device, seed: int = 0,
                   dtype: torch.dtype = torch.bfloat16, embed_dim: int = 768) -> BLIPScoreFusion:
    """BLIP-SF for serving: weights drawn from `seed` on `device`, cast to `dtype`."""
    model = _seeded_module(lambda: BLIPScoreFusion(vit_cfg, med_cfg, embed_dim), device, seed)
    return model.to_compute_dtype(dtype).eval()


def seeded_blip_ff(vit_cfg: BLIPViTConfig, med_cfg: MedConfig, device, seed: int = 0,
                   dtype: torch.dtype = torch.bfloat16, embed_dim: int = 768) -> BLIPFeatureFusion:
    """BLIP-FF for serving: weights drawn from `seed` on `device`, cast to `dtype`."""
    model = _seeded_module(lambda: BLIPFeatureFusion(vit_cfg, med_cfg, embed_dim), device, seed)
    return model.to_compute_dtype(dtype).eval()


def seeded_blip_sf_train(vit_cfg: BLIPViTConfig, med_cfg: MedConfig, device, seed: int = 0,
                         dtype: torch.dtype = torch.bfloat16, embed_dim: int = 768, remat: bool = False) -> BLIPScoreFusion:
    """BLIP-SF for training: fp32 master weights drawn from `seed` on
    `device`, computing in `dtype`, every ViT block recomputed if `remat`."""
    factory = lambda: BLIPScoreFusion(vit_cfg, med_cfg, embed_dim, dtype=dtype, remat=remat)  # noqa: E731
    return _seeded_module(factory, device, seed).train()


def seeded_blip_ff_train(vit_cfg: BLIPViTConfig, med_cfg: MedConfig, device, seed: int = 0,
                         dtype: torch.dtype = torch.bfloat16, embed_dim: int = 768, remat: bool = False) -> BLIPFeatureFusion:
    """BLIP-FF for training: fp32 master weights drawn from `seed` on
    `device`, computing in `dtype`, every ViT block and MED layer recomputed
    if `remat`."""
    factory = lambda: BLIPFeatureFusion(vit_cfg, med_cfg, embed_dim, dtype=dtype, remat=remat)  # noqa: E731
    return _seeded_module(factory, device, seed).train()


def seeded_clip_sf(cfg: CLIPConfig, device, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                   attn_splitk: bool = False) -> CLIPScoreFusion:
    """CLIP-SF for serving: weights drawn from `seed` on `device`, cast to `dtype`."""
    return _seeded(cfg, device, seed, attn_splitk=attn_splitk).to_compute_dtype(dtype).eval()


def seeded_clip_ff(cfg: CLIPConfig, device, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                   attn_splitk: bool = False) -> CLIPFeatureFusion:
    """CLIP-FF for serving: weights drawn from `seed` on `device`, cast to `dtype`."""
    model = _seeded_module(lambda: CLIPFeatureFusion(cfg, attn_splitk=attn_splitk), device, seed)
    return model.to_compute_dtype(dtype).eval()


def seeded_clip_ff_train(cfg: CLIPConfig, device, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                         remat: bool = False, attn_splitk: bool = False) -> CLIPFeatureFusion:
    """CLIP-FF for training: fp32 master weights drawn from `seed` on
    `device`, computing in `dtype`, with per-block recomputation of the
    towers if `remat` (the fusion stack is never recomputed)."""
    factory = lambda: CLIPFeatureFusion(cfg, remat=remat, dtype=dtype, attn_splitk=attn_splitk)  # noqa: E731
    return _seeded_module(factory, device, seed).train()


def _int8_twin(model, make_twin: Callable, act_scales: Optional[dict]):
    """The int8 twin `make_twin()` (built without storage) of a float model,
    on its device, filled with the model's weights quantised as they are
    (quantise before `to_compute_dtype` to start from fp32).  `act_scales`:
    calibrated scales keyed by flax module path (`ops.calibrate.
    load_act_scales`); a stale key is an error."""
    device = next(model.parameters()).device
    scales = None if act_scales is None else act_scales_by_module(act_scales, model)
    state = quantize_state_dict(model, scales)
    with torch.device("meta"):
        twin = make_twin()
    twin = twin.to_empty(device=device)
    load_quantized_state_dict(twin, state)
    return twin.eval()


def quantize_clip_sf(model: CLIPScoreFusion, int8_mode: str = "dynamic", mlp_route: str = "fused",
                     act_scales: Optional[dict] = None, attn_splitk: bool = False) -> CLIPScoreFusion:
    """The int8 serving twin of a float CLIP-SF (`_int8_twin`), computing in its dtype."""
    return _int8_twin(model, lambda: CLIPScoreFusion(model.cfg, quant=True, dtype=model.dtype, int8_mode=int8_mode,
                                                     mlp_route=mlp_route, attn_splitk=attn_splitk), act_scales)


def quantize_clip_ff(model: CLIPFeatureFusion, int8_mode: str = "dynamic", mlp_route: str = "fused",
                     act_scales: Optional[dict] = None, attn_splitk: bool = False) -> CLIPFeatureFusion:
    """The int8 serving twin of a float CLIP-FF: both towers and the T5 stack."""
    return _int8_twin(model, lambda: CLIPFeatureFusion(model.cfg, quant=True, dtype=model.dtype, int8_mode=int8_mode,
                                                       mlp_route=mlp_route, attn_splitk=attn_splitk), act_scales)


def quantize_blip(model, int8_mode: str = "dynamic", mlp_route: str = "fused", act_scales: Optional[dict] = None):
    """The int8 serving twin of a float BLIPScoreFusion or BLIPFeatureFusion:
    the ViT, MED and (score fusion) the two heads."""
    return _int8_twin(model, lambda: type(model)(model.vit_cfg, model.med_cfg, model.embed_dim, dtype=model.dtype,
                                                 quant=True, int8_mode=int8_mode, mlp_route=mlp_route), act_scales)


def seeded_clip_sf_train(
    cfg: CLIPConfig, device, seed: int = 0, dtype: torch.dtype = torch.bfloat16, remat: bool = False,
    attn_splitk: bool = False,
) -> CLIPScoreFusion:
    """CLIP-SF for training: fp32 master weights drawn from `seed` on
    `device`, computing in `dtype`, with per-block recomputation if `remat`."""
    return _seeded(cfg, device, seed, dtype=dtype, remat=remat, attn_splitk=attn_splitk).train()


def _strip(sd: dict) -> dict:
    out = {}
    for k, v in sd.items():
        for prefix in ("module.", "clip_model."):
            if k.startswith(prefix):
                k = k[len(prefix) :]
        out[k] = v
    return out


def _read_state_dict(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return sd


def load_torch_checkpoint(model: CLIPScoreFusion, path: str) -> None:
    """Load an OpenAI CLIP / UniIR CLIP-SF state dict (.pt / .pth) into the module."""
    wanted = model.state_dict()
    sd = {k: v for k, v in _strip(_read_state_dict(path)).items() if k in wanted}
    model.load_state_dict(sd, strict=True)


def load_clip_ff_checkpoint(model: CLIPFeatureFusion, path: str) -> None:
    """Load a state dict (.pt / .pth) into CLIP-FF: the UniIR CLIP-FF layout
    (`clip_model.*` and `t5_layers.*`; also the port's own train checkpoint),
    every parameter required, or a bare OpenAI CLIP / CLIP-SF state dict,
    which fills the towers and logit_scale and leaves the fusion stack as it
    is.  A `text_projection` key is dropped, never loaded: the token-output
    text tower has none."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in _read_state_dict(path).items()}
    if any(k.startswith(("clip_model.", "t5_layers.")) for k in sd):
        wanted = model.state_dict()
        model.load_state_dict({k: v for k, v in sd.items() if k in wanted}, strict=True)
    else:
        wanted = model.clip_model.state_dict()
        model.clip_model.load_state_dict({k: v for k, v in sd.items() if k in wanted}, strict=True)


def _int8_settings(model_config, train: bool):
    """(mode, MLP route, calibrated scales or None) of `model.int8`, read
    once, or None without it; the static mode without a calibration artifact
    is an error, and so is training an int8 model."""
    if not getattr(model_config, "int8", False):
        return None
    if train:
        raise ValueError("model.int8 is a serving mode: int8 layers do not train")
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


def _checkpoint_paths(config, train: bool) -> list:
    """The torch state dicts the config names, in load order: `model.
    pretrained_torch_ckpt`, then (serving only: in training `ckpt_config`
    names the checkpoint to resume, the trainer's job) `model.ckpt_config`."""
    model_config = config.model
    paths = [getattr(model_config, "pretrained_torch_ckpt", None)]
    ckpt_cfg = getattr(model_config, "ckpt_config", None)
    if not train and ckpt_cfg is not None and getattr(ckpt_cfg, "ckpt_name", ""):
        paths.append(os.path.join(config.uniir_dir, ckpt_cfg.ckpt_dir, ckpt_cfg.ckpt_name))
    out = []
    for path in filter(None, paths):
        if os.path.isfile(os.path.join(path, CHECKPOINT_FILE)):  # the port's train checkpoint directory
            path = os.path.join(path, CHECKPOINT_FILE)
        if not path.endswith((".pt", ".pth")):
            raise NotImplementedError(
                f"{path}: only torch state dicts (.pt / .pth) and the port's train checkpoints load into "
                "uniir_tpu_torch; JAX (orbax) train-state checkpoints are not read: the bridge that would write "
                "them as checkpoint.pth is not ported (ROADMAP.md, Queue 1)"
            )
        out.append(path)
    return out


def _clip_bundle(name: str, model, model_config, cfg: CLIPConfig) -> ModelBundle:
    tokenizer = CLIPTokenizer(bpe_path=getattr(model_config, "clip_bpe_path", None))

    def tokenizer_wrapper(txts):
        return tokenizer(txts, context_length=cfg.context_length, truncate=True)

    transform = clip_transform(cfg.image_size)
    return ModelBundle(
        name=name,
        model=model,
        tokenizer=tokenizer_wrapper,
        img_preprocess_fn=transform,
        img_preprocess_fn_eval=transform,
        image_size=(cfg.image_size, cfg.image_size),
        embed_dim=cfg.embed_dim,
    )


def build_clip_sf(config, device=None, train: bool = False) -> ModelBundle:
    model_config = config.model
    cfg = CLIP_CONFIGS[model_config.clip_vision_model_name]
    int8_settings = _int8_settings(model_config, train)
    int8 = int8_settings is not None
    splitk = attn_splitk_from_env()
    device = resolve_device(device)
    dtype = torch.bfloat16 if getattr(model_config, "bf16", True) else torch.float32
    seed = int(getattr(config, "seed", 0))
    if train:
        model = seeded_clip_sf_train(cfg, device, seed, dtype, remat=bool(getattr(model_config, "remat", False)),
                                     attn_splitk=splitk)
    elif int8:
        model = _seeded(cfg, device, seed)  # fp32 until quantised: the weights quantise from fp32
    else:
        model = seeded_clip_sf(cfg, device, seed, dtype, attn_splitk=splitk)

    for path in _checkpoint_paths(config, train):
        load_torch_checkpoint(model, path)
        print(f"Loaded CLIPScoreFusion weights from {path}")

    if int8:
        model = quantize_clip_sf(model, *int8_settings, attn_splitk=splitk).to_compute_dtype(dtype)
        print(f"Quantized CLIPScoreFusion to int8 serving mode ({int8_settings[0]})")
    return _clip_bundle("CLIPScoreFusion", model, model_config, cfg)


def build_clip_ff(config, device=None, train: bool = False) -> ModelBundle:
    model_config = config.model
    cfg = CLIP_CONFIGS[model_config.clip_vision_model_name]
    int8_settings = _int8_settings(model_config, train)
    splitk = attn_splitk_from_env()
    device = resolve_device(device)
    dtype = torch.bfloat16 if getattr(model_config, "bf16", True) else torch.float32
    seed = int(getattr(config, "seed", 0))
    if train:
        model = seeded_clip_ff_train(cfg, device, seed, dtype, remat=bool(getattr(model_config, "remat", False)),
                                     attn_splitk=splitk)
    else:  # fp32 until quantised where int8: the weights quantise from fp32
        model = seeded_clip_ff(cfg, device, seed, torch.float32 if int8_settings else dtype, attn_splitk=splitk)
    for path in _checkpoint_paths(config, train):
        load_clip_ff_checkpoint(model, path)
        print(f"Loaded CLIPFeatureFusion weights from {path}")
    if int8_settings:
        model = quantize_clip_ff(model, *int8_settings, attn_splitk=splitk).to_compute_dtype(dtype)
        print(f"Quantized CLIPFeatureFusion to int8 serving mode ({int8_settings[0]})")
    return _clip_bundle("CLIPFeatureFusion", model, model_config, cfg)


# Keys of a published BLIP checkpoint that no module takes, by construction
# (the JAX converter's expected-unused list): momentum twins and queues
# (train state), HF buffers, the token-type table (folded into the
# positions), pretraining heads.  Score fusion also never runs the frozen
# cross-attention and the pooler, which feature fusion takes.
_BLIP_UNUSED = (
    r"_m\.", r"^(vision_proj_m|text_proj_m)\.", r"(^|\.)(image|text|idx|query|cand|ptr)_queue$", r"^queue_ptr$",
    r"\.position_ids$", r"\.token_type_embeddings\.weight$", r"^(itm_head|text_decoder)\.",
)
_BLIP_SF_UNUSED = _BLIP_UNUSED + (r"^text_encoder\.encoder\.layer\.\d+\.crossattention\.", r"^text_encoder\.pooler\.")


def load_blip_checkpoint(model, path: str, strict: bool = False) -> None:
    """Load a BLIP / UniIR BLIP state dict (.pth) into a BLIPScoreFusion or
    BLIPFeatureFusion module.

    `module.` prefixes are stripped; momentum and queue keys are dropped, as
    the JAX converter ignores them, and so are the cross-attention and pooler
    keys for score fusion (feature fusion takes them); row 0 of the token-type
    table is added to every position embedding (BLIP always passes token
    type 0, and the module has no such table); `pos_embed` is interpolated
    when the checkpoint's patch grid differs from the model's.  A key that is
    neither taken nor expected-unused is reported, and is an error with
    `strict`; a parameter the checkpoint lacks is always an error."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in _read_state_dict(path).items()}
    unused = _BLIP_UNUSED if isinstance(model, BLIPFeatureFusion) else _BLIP_SF_UNUSED
    pos_key, tt_key = "text_encoder.embeddings.position_embeddings.weight", "text_encoder.embeddings.token_type_embeddings.weight"
    if tt_key in sd:
        sd[pos_key] = sd[pos_key] + sd[tt_key][0][None, :]
    wanted = model.state_dict()
    n_tokens = wanted["visual_encoder.pos_embed"].shape[1]
    if sd["visual_encoder.pos_embed"].shape[1] != n_tokens:
        sd["visual_encoder.pos_embed"] = interpolate_pos_embed(sd["visual_encoder.pos_embed"].float(), n_tokens - 1)
    unexpected = [k for k in sd if k not in wanted and not any(re.search(p, k) for p in unused)]
    if unexpected:
        detail = "\n  ".join(unexpected[:40])
        if strict:
            raise ValueError(f"strict load: checkpoint keys the model does not take:\n  {detail}")
        print(f"WARNING checkpoint keys the model does not take:\n  {detail}")
    taken = {k: v.reshape(wanted[k].shape) if k == "temp" else v for k, v in sd.items() if k in wanted}
    model.load_state_dict(taken, strict=True)


def build_blip_sf(config, device=None, train: bool = False) -> ModelBundle:
    return _build_blip(config, "BLIPScoreFusion", seeded_blip_sf_train if train else seeded_blip_sf, device, train)


def build_blip_ff(config, device=None, train: bool = False) -> ModelBundle:
    return _build_blip(config, "BLIPFeatureFusion", seeded_blip_ff_train if train else seeded_blip_ff, device, train)


def _build_blip(config, name: str, seeded: Callable, device, train: bool) -> ModelBundle:
    model_config = config.model
    int8_settings = _int8_settings(model_config, train)
    vit = getattr(model_config, "vit", "base")
    vit_cfg = BLIP_VIT_CONFIGS[vit]
    image_size = getattr(model_config, "image_size", vit_cfg.image_size)
    if image_size != vit_cfg.image_size:
        vit_cfg = dataclasses.replace(vit_cfg, image_size=image_size)
    med_cfg = dataclasses.replace(MED_CONFIGS.get(vit, MED_CONFIGS["base"]), encoder_width=vit_cfg.width)
    embed_dim = getattr(model_config, "embed_dim", 768)
    dtype = torch.bfloat16 if getattr(model_config, "bf16", True) else torch.float32
    max_len = int(getattr(model_config, "tokenizer_max_length", 64))
    vocab_path = getattr(model_config, "bert_vocab_path", None)
    if vocab_path is None:
        raise FileNotFoundError("BLIP models need model.bert_vocab_path pointing at a bert-base-uncased vocab.txt")
    tokenizer = BertTokenizer(vocab_path)

    def tokenizer_wrapper(txts):
        return tokenizer(txts, max_length=max_len)

    device = resolve_device(device)
    seed = int(getattr(config, "seed", 0))
    if train:
        model = seeded(vit_cfg, med_cfg, device, seed, dtype, embed_dim,
                       remat=bool(getattr(model_config, "vit_grad_ckpt", False)))
    else:  # fp32 until quantised where int8: the weights quantise from fp32
        model = seeded(vit_cfg, med_cfg, device, seed, torch.float32 if int8_settings else dtype, embed_dim)
    strict = bool(getattr(model_config, "strict_convert", False))
    for path in _checkpoint_paths(config, train):
        load_blip_checkpoint(model, path, strict=strict)
        print(f"Loaded {name} weights from {path}")
    if int8_settings:
        model = quantize_blip(model, *int8_settings).to_compute_dtype(dtype)
        print(f"Quantized {name} to int8 serving mode ({int8_settings[0]})")
    return ModelBundle(
        name=name,
        model=model,
        tokenizer=tokenizer_wrapper,
        img_preprocess_fn=blip_transform(vit_cfg.image_size, is_train=True),
        img_preprocess_fn_eval=blip_transform(vit_cfg.image_size, is_train=False),
        image_size=(vit_cfg.image_size, vit_cfg.image_size),
        embed_dim=embed_dim,
        extra={
            "queue_size": int(getattr(model_config, "queue_size", 57600)),
            "momentum": float(getattr(model_config, "momentum", 0.995)),
            "alpha": float(getattr(model_config, "alpha", 0.4)),
        },
    )


def build_model_from_config(config, device=None, train: bool = False) -> ModelBundle:
    name = config.model.name
    if name == "CLIPScoreFusion":
        return build_clip_sf(config, device, train)
    if name == "CLIPFeatureFusion":
        return build_clip_ff(config, device, train)
    if name == "BLIPScoreFusion":
        return build_blip_sf(config, device, train)
    if name == "BLIPFeatureFusion":
        return build_blip_ff(config, device, train)
    raise ValueError(f"Unknown model name {name!r}; expected one of {MODEL_NAMES}")
