"""Fused static-int8 MLP half-block: kernel K6 and its plain twin.

Counterpart of `uniir_tpu/ops/mlp_pallas.py`.  One call computes the whole
pre-LN transformer MLP half-block on int8 tensor cores:

    y = res + fc2( quant_a2( act( fc1( quant_a1(h) ) ) ) )

with h = ln_2(x) in bf16, res the residual stream, and a1, a2 the calibrated
static activation scales (`ops/calibrate.py`).  The TPU kernel keeps the
[M, 4W] hidden on chip; on an H100 that forces 32-row blocks that each read
every weight from L2.  Here the hidden leaves the chip only as int8: K6
(`csrc/int8_mlp.cu`, which replaces `mlp_pallas.py::fused_int8_mlp`) runs
one quantising pass over h and then the `wgmma` main loop of
`csrc/int8_gemm.cuh` twice -- fc1 with the activation and the second
quantisation in its epilogue, writing the int8 hidden to a scratch tensor,
and fc2 with the dequantisation and the residual add in its epilogue.  The
hidden is `int8_mlp_hidden`'s tensor, rounded in the kernel as in the twin.

`int8_mlp` launches K6 for CUDA tensors, or raises, and runs
`int8_mlp_twin` for CPU tensors; it counts one launch a call.  The twin
repeats the kernel's arithmetic: multiply by 1/a1 and 1/a2 computed once in
fp32, exact integer sums, every fp32 step rounded on its own.
`reference_int8_mlp` is the JAX package's oracle, which divides by a1 and
a2 instead.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from uniir_tpu_torch import _build
from uniir_tpu_torch.ops.quant import exact_int_matmul

ACTS = ("quick_gelu", "gelu", "gelu_tanh")


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":  # CLIP: x * sigmoid(1.702 x)
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":  # exact erf form
        return F.gelu(x)
    if name == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"activation {name!r}: expected one of {ACTS}")


def _scalars(a1: float, a2: float) -> Tuple[float, float, float]:
    """(1/a1, 1/a2, a2) with the reciprocals taken once in fp32."""
    one = np.float32(1.0)
    return float(one / np.float32(a1)), float(one / np.float32(a2)), float(np.float32(a2))


def int8_mlp_hidden(h, w1_q, w1_scale, b1, a1: float, a2: float, act: str = "quick_gelu") -> torch.Tensor:
    """The quantised hidden [M, 4W] int8 of `int8_mlp_twin`: the tensor the
    kernel writes between its two products (exposed so tests can count values
    one step off)."""
    inv_a1, inv_a2, _ = _scalars(a1, a2)
    xq = torch.round(h.to(torch.bfloat16).float() * inv_a1).clamp(-127.0, 127.0).to(torch.int8)
    s1 = float(np.float32(a1)) * w1_scale.float()
    hf = exact_int_matmul(xq, w1_q).float() * s1 + b1.float()
    return torch.round(_act(act, hf) * inv_a2).clamp(-127.0, 127.0).to(torch.int8)


def int8_mlp_twin(h, res, w1_q, w1_scale, b1, w2_q, w2_scale, b2, a1: float, a2: float,
                  act: str = "quick_gelu") -> torch.Tensor:
    """Plain PyTorch twin of K6 on any device, for 2-D h, res [M, W]:
    bf16 [M, W].  Weights in the state-dict layout: w1_q [4W, W], w2_q [W, 4W]."""
    hq = int8_mlp_hidden(h, w1_q, w1_scale, b1, a1, a2, act)
    a2f = _scalars(a1, a2)[2]
    y = exact_int_matmul(hq, w2_q).float() * (a2f * w2_scale.float()) + b2.float()
    return (y + res.to(torch.bfloat16).float()).to(torch.bfloat16)


def reference_int8_mlp(h, res, w1_q, w1_scale, b1, w2_q, w2_scale, b2, a1: float, a2: float,
                       act: str = "quick_gelu") -> torch.Tensor:
    """The JAX package's oracle (`mlp_pallas.py::reference_int8_mlp`): the
    same math with divisions by a1 and a2."""
    a1, a2 = float(np.float32(a1)), float(np.float32(a2))
    xq = torch.round(h.float() / a1).clamp(-127, 127)
    hf = (xq @ w1_q.float().T) * (a1 * w1_scale.float()) + b1.float()
    hq = torch.round(_act(act, hf) / a2).clamp(-127, 127)
    y = (hq @ w2_q.float().T) * (a2 * w2_scale.float()) + b2.float()
    return (y + res.float()).to(torch.bfloat16)


def int8_mlp_supported(width: int, hidden: int, act: str) -> bool:
    """What K6 takes: widths of whole k32 steps and of whole 16-byte output
    vectors, and a known act.  No shared-memory term: the hidden no longer
    lives in a block, and the main loop's ring is the same at every width."""
    return width % 32 == 0 and hidden % 32 == 0 and act in ACTS


def _as_rows(h: torch.Tensor, res: torch.Tensor):
    """h, res [..., W] -> bf16 [M, W] each (the TPU kernel casts them to bf16 too)."""
    W = h.shape[-1]
    return h.reshape(-1, W).to(torch.bfloat16), res.reshape(-1, W).to(torch.bfloat16)


def int8_mlp_plain(h, res, w1_q, w1_scale, b1, w2_q, w2_scale, b2, a1: float, a2: float,
                   act: str = "quick_gelu") -> torch.Tensor:
    """`int8_mlp`'s function through the plain twin on any device (leading
    dimensions and input types as `int8_mlp` takes them)."""
    h2, r2 = _as_rows(h, res)
    return int8_mlp_twin(h2, r2, w1_q, w1_scale, b1, w2_q, w2_scale, b2, a1, a2, act).reshape(res.shape)


def int8_mlp(h, res, w1_q, w1_scale, b1, w2_q, w2_scale, b2, a1: float, a2: float,
             act: str = "quick_gelu") -> torch.Tensor:
    """K6: y = res + fc2(quant(act(fc1(quant(h; a1))); a2)) as bf16, shaped like res.

    h, res [..., W] (cast to bf16, as the TPU kernel does); w1_q [4W, W] and
    w2_q [W, 4W] int8 with per-output-channel fp32 scales and fp32 biases;
    a1, a2 the static activation scales.  On a CUDA tensor it launches the
    kernel or raises; on a CPU tensor it runs `int8_mlp_twin`."""
    if act not in ACTS:
        raise ValueError(f"activation {act!r}: expected one of {ACTS}")
    if torch.is_grad_enabled() and (h.requires_grad or res.requires_grad):
        raise RuntimeError("int8 layers are inference only: run them under torch.no_grad() / inference_mode()")
    W, H = h.shape[-1], w1_q.shape[0]
    if h.shape != res.shape or w1_q.shape != (H, W) or w2_q.shape != (W, H):
        raise ValueError(f"h {tuple(h.shape)}, res {tuple(res.shape)}, w1_q {tuple(w1_q.shape)}, "
                         f"w2_q {tuple(w2_q.shape)} do not form an MLP")
    if h.device.type == "cpu":
        return int8_mlp_plain(h, res, w1_q, w1_scale, b1, w2_q, w2_scale, b2, a1, a2, act)
    if not h.is_cuda:
        raise ValueError(f"int8_mlp runs on CUDA or CPU tensors, not {h.device}")
    if not int8_mlp_supported(W, H, act):
        raise ValueError(f"the fused int8 MLP kernel does not take width {W}, hidden {H}, act {act}")
    h2, r2 = (t.contiguous() for t in _as_rows(h, res))
    s1 = (float(np.float32(a1)) * w1_scale.float()).contiguous()
    tensors = {"h": (h2, torch.bfloat16), "res": (r2, torch.bfloat16), "w1_q": (w1_q, torch.int8),
               "w2_q": (w2_q, torch.int8), "b1": (b1, torch.float32), "w2_scale": (w2_scale, torch.float32),
               "b2": (b2, torch.float32)}
    for name, (t, dtype) in tensors.items():
        if t.dtype != dtype or t.device != h2.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned {dtype} tensor on {h2.device}")
    if s1.shape != (H,) or b1.shape != (H,) or w2_scale.shape != (W,) or b2.shape != (W,):
        raise ValueError("scales and biases must hold one value per output channel")
    M = h2.shape[0]
    out = torch.empty((M, W), dtype=torch.bfloat16, device=h2.device)
    # scratch of the three launches: quant_a1(h) and the int8 hidden
    xq = torch.empty((M, W), dtype=torch.int8, device=h2.device)
    hq = torch.empty((M, H), dtype=torch.int8, device=h2.device)
    inv_a1, inv_a2, a2f = _scalars(a1, a2)
    lib = _build.load("int8_mlp")
    err = lib.uniir_int8_mlp(
        h2.data_ptr(), r2.data_ptr(), w1_q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2_q.data_ptr(),
        w2_scale.data_ptr(), b2.data_ptr(), xq.data_ptr(), hq.data_ptr(), out.data_ptr(), M, W, H,
        inv_a1, inv_a2, a2f, ACTS.index(act), torch.cuda.current_stream(h2.device).cuda_stream,
    )
    _build.check(lib, err, "fused int8 MLP kernel")
    int8_mlp.launches += 1
    return out.reshape(res.shape)


int8_mlp.launches = 0
