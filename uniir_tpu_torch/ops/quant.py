"""int8 quantised inference: weights, activations, the int8 matmul (kernel K5).

Counterpart of `uniir_tpu/ops/quant.py` and `uniir_tpu/ops/quant_pallas.py`.
Every Dense layer of a retriever (the blocks' qkv / out projections and
MLPs, T5's and MED's projections, BLIP-SF's heads, MED's pooler) runs on
int8 weights, quantised per output channel from the trained fp32 weights
(`quantize_state_dict`); attention itself, LayerNorms, embeddings and the
patch embedding stay in the compute dtype.  Three activation modes, chosen
where the model is built (`int8_mode_from_env`):

  * "dynamic": per-row int8 activations computed on the fly in bf16 math
    (`quantize_activation`), int8 x int8 -> int32 in K5, dequantised as
    (acc * a[row]) * w[col] + b -- the order of the TPU kernel
    (`quant_pallas.py::_kernel`);
  * "static": one calibrated fp32 scale per tensor (`ops/calibrate.py`),
    quantised as clip(round(fp32(x) * (1/a))), the same product in K5,
    dequantised as acc * (a * w[col]) + b (`quant.py::int8_matmul` with
    `a_static`); a layer without a calibrated scale falls back to dynamic;
  * "wonly": int8 weights cast to bf16 feed a plain bf16 product and the
    per-channel scale rides the epilogue; no kernel of the port is involved.

K5 (`csrc/int8_matmul.cu`, on the `wgmma` main loop of `csrc/int8_gemm.cuh`)
replaces `quant_pallas.py::fused_int8_matmul`.  `int8_matmul` launches it
for CUDA tensors (or raises) and runs its plain twin `int8_matmul_twin` for
CPU tensors; it counts its launches.  The weight is stored [out, in] (the
state-dict layout), K-contiguous like the activations: the K-major operand
pair `wgmma` reads from shared memory, with no transposed copy.

Inference only: a quantised layer refuses an input that requires grad.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from uniir_tpu_torch import _build

INT8_MODES = ("dynamic", "wonly", "static")
# exact fp32 sums of int8 products need K * 127^2 < 2^24
_EXACT_K = 1024


def int8_mode_from_env() -> str:
    """The activation mode named by UNIIR_INT8_BACKEND (the JAX package's
    switch): `xla` (default) and `pallas` both mean dynamic per-row
    quantisation through K5 here; `wonly` and `static` keep their names."""
    backend = os.environ.get("UNIIR_INT8_BACKEND", "xla")
    mode = {"xla": "dynamic", "pallas": "dynamic", "wonly": "wonly", "static": "static"}.get(backend)
    if mode is None:
        raise ValueError(f"UNIIR_INT8_BACKEND={backend!r}: expected xla, pallas, wonly or static")
    return mode


def int8_mlp_route_from_env() -> str:
    """The static-mode MLP route named by UNIIR_INT8_MLP: `fused` (the
    port's default: kernel K6) or `xla` (two static K5 calls around a bf16
    hidden).  The JAX package defaults to `xla` because of a TPU layout copy
    around its fused kernel that has no counterpart on a GPU."""
    route = os.environ.get("UNIIR_INT8_MLP", "fused")
    if route not in ("fused", "xla"):
        raise ValueError(f"UNIIR_INT8_MLP={route!r}: expected fused or xla")
    return route


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp weight [out, in] -> (int8 weight [out, in], fp32 scale [out]).

    Symmetric per output channel: scale = max|w| * fp32(1/127) (the multiply
    XLA compiles the reference's `/ 127` into), 1 for an all-zero channel."""
    w = weight.detach().float()
    w_max = w.abs().amax(dim=1)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=w.device)
    scale = torch.where(w_max > 0, w_max * inv127, torch.ones_like(w_max))
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 quantisation, all math in bf16
    (`quant.py::quantize_activation`): (int8 [..., K], bf16 scale [..., 1]).

    bf16 holds integers up to 256 exactly, so the rounded, clipped values
    are exact; the floor bf16(1e-4) keeps an all-zero row finite."""
    xb = x.to(torch.bfloat16)
    a_max = xb.abs().amax(dim=-1, keepdim=True)
    floor = torch.tensor(1e-4, dtype=torch.bfloat16, device=x.device)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.bfloat16, device=x.device)
    a_scale = torch.maximum(a_max, floor) * inv127
    xq = torch.round(xb / a_scale).clamp(-127, 127).to(torch.int8)
    return xq, a_scale


def quantize_activation_static(x: torch.Tensor, a: float) -> torch.Tensor:
    """Static per-tensor quantisation in fp32: clip(round(x * (1/a))) as int8;
    values past the calibrated range clip by design."""
    inv_a = float(np.float32(1.0) / np.float32(a))
    return torch.round(x.float() * inv_a).clamp(-127.0, 127.0).to(torch.int8)


def exact_int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 [M, N] = xq [M, K] @ wq [N, K]^T over int8 values, exactly, with
    plain fp32 products: K is cut into pieces of 1024, whose sums fp32 holds
    exactly (1024 * 127^2 < 2^24), and the pieces add in int32."""
    acc = None
    for k0 in range(0, xq.shape[1], _EXACT_K):
        part = (xq[:, k0 : k0 + _EXACT_K].float() @ wq[:, k0 : k0 + _EXACT_K].float().T).to(torch.int32)
        acc = part if acc is None else acc + part
    return acc


def _slice_columns(weight_q, w_scale, bias, columns):
    if columns is None:
        return weight_q, w_scale, bias
    lo, hi = columns
    return weight_q[lo:hi], w_scale[lo:hi], None if bias is None else bias[lo:hi]


def int8_matmul_twin(
    xq: torch.Tensor,
    a_scale: Union[torch.Tensor, float],
    weight_q: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    columns: Optional[Tuple[int, int]] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch twin of K5 on any device: exact integer products, then
    the kernel's fp32 epilogue in the kernel's order, each step rounded --
    (acc * a[row]) * w[col] + b for per-row scales (a tensor [M]),
    acc * (a * w[col]) + b for one static scale (a float)."""
    weight_q, w_scale, bias = _slice_columns(weight_q, w_scale, bias, columns)
    acc = exact_int_matmul(xq, weight_q).float()
    if isinstance(a_scale, torch.Tensor):
        y = acc * a_scale.float().reshape(-1, 1) * w_scale.float()
    else:
        y = acc * (float(a_scale) * w_scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def int8_matmul_supported(K: int, N: int) -> bool:
    """What K5 takes: rows of whole k32 steps (TMA needs K % 16), and output
    rows of whole 16-byte vectors."""
    return K % 32 == 0 and N % 8 == 0


def int8_matmul(
    xq: torch.Tensor,
    a_scale: Union[torch.Tensor, float],
    weight_q: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    columns: Optional[Tuple[int, int]] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """K5: [M, hi-lo] = dequant(xq [M, K] @ weight_q[lo:hi]^T) + bias[lo:hi].

    xq, weight_q int8 (weight_q [N, K]); a_scale fp32 [M] per-row scales, or
    a float for the static mode; w_scale, bias fp32 [N]; `columns=(lo, hi)`
    restricts the product to those output channels (the fused qkv
    projection's thirds).  Any M; K a multiple of 32; hi-lo a multiple of 8.
    On a CUDA tensor it launches the kernel (bf16 output) or raises; on a CPU
    tensor it runs `int8_matmul_twin`."""
    if xq.dim() != 2 or weight_q.dim() != 2 or xq.shape[1] != weight_q.shape[1]:
        raise ValueError(f"xq {tuple(xq.shape)} and weight_q {tuple(weight_q.shape)} must be [M, K] and [N, K]")
    if xq.dtype != torch.int8 or weight_q.dtype != torch.int8:
        raise ValueError(f"xq and weight_q must be int8, got {xq.dtype} and {weight_q.dtype}")
    lo, hi = (0, weight_q.shape[0]) if columns is None else columns
    if not 0 <= lo < hi <= weight_q.shape[0]:
        raise ValueError(f"columns {columns} outside [0, {weight_q.shape[0]}]")
    if xq.device.type == "cpu":
        return int8_matmul_twin(xq, a_scale, weight_q, w_scale, bias, columns, out_dtype)
    if not xq.is_cuda:
        raise ValueError(f"int8_matmul runs on CUDA or CPU tensors, not {xq.device}")
    M, K = xq.shape
    n = hi - lo
    if out_dtype != torch.bfloat16:
        raise ValueError(f"the int8 matmul kernel writes bf16, not {out_dtype}")
    if not int8_matmul_supported(K, n):
        raise ValueError(f"the int8 matmul kernel needs K % 32 == 0 and N % 8 == 0, got K={K}, N={n}")
    per_row = isinstance(a_scale, torch.Tensor)
    checks = {"xq": (xq, torch.int8), "weight_q": (weight_q, torch.int8), "w_scale": (w_scale, torch.float32)}
    if bias is not None:
        checks["bias"] = (bias, torch.float32)
    if per_row:
        a_scale = a_scale.reshape(-1)
        if a_scale.shape[0] != M:
            raise ValueError(f"a_scale must hold one scale per row ({M}), got {tuple(a_scale.shape)}")
        checks["a_scale"] = (a_scale, torch.float32)
    for name, (t, dtype) in checks.items():
        if t.dtype != dtype or t.device != xq.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {xq.device}")
    if xq.data_ptr() % 16 or weight_q.data_ptr() % 16:
        raise ValueError("xq and weight_q must be 16-byte aligned")
    if w_scale.shape[0] != weight_q.shape[0] or (bias is not None and bias.shape[0] != weight_q.shape[0]):
        raise ValueError("w_scale and bias must hold one value per output channel")
    out = _launch_int8_matmul(xq, a_scale, weight_q, w_scale, bias, lo, n)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


# the main loop's two output tiles (`int8_gemm.cuh::GemmTile`)
INT8_TILES = {"128x256": 1, "128x128 two blocks an SM": 2}


def _launch_int8_matmul(xq, a_scale, weight_q, w_scale, bias, lo: int, n: int, tile: int = 0) -> torch.Tensor:
    """Launch K5 on checked CUDA tensors: output columns lo .. lo + n.
    `tile` is a value of INT8_TILES, or 0 for the kernel's rule by shape
    (`int8_gemm.cuh::int8_gemm_tile`); `int8_matmul` passes 0, and the tests
    and chip_smoke.py hold and time the tiles against each other."""
    M, K = xq.shape
    per_row = isinstance(a_scale, torch.Tensor)
    out = torch.empty((M, n), dtype=torch.bfloat16, device=xq.device)
    lib = _build.load("int8_matmul")
    err = lib.uniir_int8_matmul(
        xq.data_ptr(), weight_q.data_ptr() + lo * K,
        a_scale.data_ptr() if per_row else None, 1.0 if per_row else float(a_scale),
        w_scale.data_ptr() + 4 * lo, None if bias is None else bias.data_ptr() + 4 * lo,
        out.data_ptr(), M, n, K, tile, torch.cuda.current_stream(xq.device).cuda_stream,
    )
    _build.check(lib, err, "int8 matmul kernel")
    return out


def weight_only_matmul(x: torch.Tensor, weight_q: torch.Tensor, w_scale: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The `wonly` mode: int8 weights cast to bf16 feed a product of bf16
    operands with an fp32 result; the per-channel scale and the bias ride the
    fp32 epilogue (x @ (Q * s) == (x @ Q) * s).  fp32 [..., out].

    On a CUDA tensor the product is `torch.mm(..., out_dtype=torch.float32)`
    (bf16 tensor cores, the fp32 sums kept); on a CPU tensor an fp32 product
    of the bf16-rounded operands, which is the same function (products of
    bf16 values are exact in fp32)."""
    xb = x.to(torch.bfloat16).reshape(-1, x.shape[-1])
    wb = weight_q.to(torch.bfloat16)
    if xb.is_cuda:
        acc = torch.mm(xb, wb.T, out_dtype=torch.float32)
    else:
        acc = xb.float() @ wb.float().T
    y = acc * w_scale.float()
    y = y if bias is None else y + bias.float()
    return y.reshape(*x.shape[:-1], y.shape[-1])


def quant_linear(
    x: torch.Tensor,
    weight_q: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mode: str = "dynamic",
    a_static: Optional[float] = None,
    columns: Optional[Tuple[int, int]] = None,
    quantized: Optional[tuple] = None,
) -> torch.Tensor:
    """y = dequant(quant(x) @ weight_q^T) + bias in x's dtype, for x [..., K]
    (`quant.py::int8_matmul`).  `quantized=(xq, a)` reuses an activation
    quantisation made by `quantize_input` (q, k and v share one)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("int8 layers are inference only: run them under torch.no_grad() / inference_mode()")
    lead = x.shape[:-1]
    if mode == "wonly":
        weight_q, w_scale, bias = _slice_columns(weight_q, w_scale, bias, columns)
        return weight_only_matmul(x, weight_q, w_scale, bias).to(x.dtype)
    xq, a = quantize_input(x, mode, a_static) if quantized is None else quantized
    y = int8_matmul(xq, a, weight_q, w_scale, bias, columns, out_dtype=x.dtype)
    return y.reshape(*lead, y.shape[-1])


def quantize_input(x: torch.Tensor, mode: str, a_static: Optional[float] = None):
    """(xq [M, K] int8, a) for `int8_matmul`: a float under the static mode
    with a calibrated scale, else fp32 per-row scales [M]."""
    x2 = x.reshape(-1, x.shape[-1])
    if mode == "static" and a_static is not None:
        return quantize_activation_static(x2, a_static), float(a_static)
    xq, a = quantize_activation(x2)
    return xq, a.float().reshape(-1)


class QuantLinear(nn.Module):
    """Linear layer over pre-quantised int8 weights (`quant.py::QuantDense`):
    buffers `weight_q` [out, in] int8, `scale` [out] fp32, `bias` [out] fp32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, mode: str = "dynamic"):
        super().__init__()
        if mode not in INT8_MODES:
            raise ValueError(f"int8 mode {mode!r}: expected one of {INT8_MODES}")
        self.in_features, self.out_features, self.mode = in_features, out_features, mode
        self.register_buffer("weight_q", torch.zeros((out_features, in_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones((out_features,), dtype=torch.float32))
        self.register_buffer("bias", torch.zeros((out_features,), dtype=torch.float32) if bias else None)

    def forward(self, x: torch.Tensor, columns: Optional[Tuple[int, int]] = None, a_static: Optional[float] = None,
                quantized: Optional[tuple] = None) -> torch.Tensor:
        return quant_linear(x, self.weight_q, self.scale, self.bias, self.mode, a_static, columns, quantized)


class ActScales:
    """Mixin for a module that owns int8 projections and may carry a
    calibrated `act_scales` buffer (fp32 scales: two, or three for MED's
    attention): a host copy is read once, at first use, so a forward never
    waits on the device for them.  Float modules of those kinds mix it in
    too, so the owners of calibration entries are known from a float model
    (`quantize_state_dict`).  `int8_mode` is the module's activation mode."""

    int8_mode = "dynamic"

    def _init_act_scales(self) -> None:
        self.register_buffer("act_scales", None)  # absent from the state dict until calibrated
        self._act_host = None

    def set_act_scales(self, values) -> None:
        ref = next(self.buffers())
        self.register_buffer("act_scales", torch.as_tensor(values, dtype=torch.float32).to(ref.device))
        self._act_host = None

    def static_scales(self):
        """The scales as Python floats under the static mode when calibrated, else None."""
        if self.int8_mode != "static" or getattr(self, "act_scales", None) is None:
            return None
        if self._act_host is None:
            self._act_host = tuple(float(v) for v in self.act_scales.tolist())
        return self._act_host


def _persistent_tensors(module: nn.Module):
    """(local name, tensor) of a module's own parameters and persistent buffers."""
    for name, t in module.named_parameters(recurse=False):
        yield name, t
    for name, t in module.named_buffers(recurse=False):
        if name not in module._non_persistent_buffers_set:
            yield name, t


def quantize_state_dict(model: nn.Module, act_scales: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, torch.Tensor]:
    """Float model -> the state dict of its int8 twin, by the JAX package's
    `quantize_tree` rule: every 2-D Dense weight (each `nn.Linear`, and the
    fused [3W, W] `in_proj_weight` of an attention, which becomes
    `qkv_proj`) turns into `weight_q` + `scale`, with its bias in fp32 if it
    has one; everything else (embeddings, the patch embedding, position
    tables, T5's bias table, norms) passes through.  The keys are module
    names, read from the modules and not from the state dict, whose BLIP ViT
    entries carry timm's names.

    `act_scales` maps module names of `ActScales` owners
    (`visual.transformer.resblocks.0.mlp`, `t5_layers.block.1.layer.0.
    SelfAttention`, `text_encoder.encoder.layer.2.crossattention`; see
    `ops/calibrate.py`) to calibrated fp32 scales, stored as
    `<module>.act_scales`.  A name that matches no owner is an error: it
    catches a stale calibration."""
    if any(isinstance(m, QuantLinear) for m in model.modules()):
        raise ValueError("quantise the float model, not its int8 twin")
    act_scales = dict(act_scales or {})
    out: Dict[str, torch.Tensor] = {}
    for name, module in model.named_modules():
        p = name + "." if name else ""
        if isinstance(module, nn.Linear):
            out[p + "weight_q"], out[p + "scale"] = quantize_weight(module.weight)
            if module.bias is not None:
                out[p + "bias"] = module.bias.detach().float()
            continue
        for local, t in _persistent_tensors(module):
            if local == "in_proj_weight":
                out[p + "qkv_proj.weight_q"], out[p + "qkv_proj.scale"] = quantize_weight(t)
            elif local == "in_proj_bias":
                out[p + "qkv_proj.bias"] = t.detach().float()
            else:
                out[p + local] = t.detach()
        if isinstance(module, ActScales) and name in act_scales:
            out[p + "act_scales"] = torch.as_tensor(np.asarray(act_scales.pop(name), np.float32),
                                                    device=next(module.parameters()).device)
    if act_scales:  # an AssertionError, as the JAX package's quantize_tree raises
        raise AssertionError(f"act_scales paths not found in params: {sorted(act_scales)}")
    return out


def load_quantized_state_dict(model: nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """Load a quantised state dict, creating the `act_scales` buffers it carries."""
    modules = dict(model.named_modules())
    for key, value in state_dict.items():
        if key.endswith(".act_scales"):
            modules[key[: -len(".act_scales")]].set_act_scales(value)
    model.load_state_dict(state_dict, strict=True)
