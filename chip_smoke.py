#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py            # from the repo root; needs one CUDA card

1. builds the port's kernels (uniir_tpu_torch/csrc, nvcc for sm_90a) from the
   checkout and checks each against its plain PyTorch twin at the shapes the
   serving paths give it: K1 attention at CLIP-L vision and text shapes, at
   BLIP's L = 197 and the main path's batch -- its one-block-a-head kernel
   and its general-length kernel both, timed in turns, and the general one
   also at L = 577, which only it takes -- K10 (split-K attention) at the
   CLIP-L vision shape against its twin and against K1, and that the flag
   leaves L = 197 and the causal L = 77 to K1, K8 / K9 (the stand-alone
   `mha_nocausal` / `mha_paired`) at the BLIP and CLIP shapes, K7 (fused
   image preprocessing) at uint8 [64, 256, 256, 3] -> 224 in both methods
   and output types, K2 / K4 / K11 sweeps at the main path's small pool, K11
   on a pool cut inside a chunk's first rows, and all three on a seeded
   5.6M x 768 pool with 256 queries (also against brute force, and `topk`
   with the guard through K11),
   K5 (int8 matmul) at the CLIP-L projection shapes in its dynamic and
   static modes, K6 (fused int8 MLP) at the vision and text widths, with
   times for kernel, twin and, where one PyTorch call computes the same
   function, that call (used nowhere in the port);
2. drives the serving path once through the port's own entry points --
   seeded CLIP-SF ViT-L/14 in bf16 embeds collated query and candidate
   batches, `create_index`, then `run_retrieval` with the int8 pool (as
   shipped) and with the bf16 pool -- and checks that every kernel was
   launched there, that the embeddings are finite and agree with a run
   through the plain twins, that both pools return the same ids, and that
   every query that copies a candidate finds it in its top 10;
3. drives int8 model serving through the same entry points: calibrates the
   seeded ViT-L/14 on two batches, saves and loads the .npz artifact, builds
   the quantised model with `build_model_from_config` (`model.int8`) in the
   modes UNIIR_INT8_BACKEND = xla, wonly, static (and static with
   UNIIR_INT8_MLP=xla), embeds the same candidates and queries, indexes and
   retrieves, and checks the embeddings against the bf16 path's, the K5 / K6
   launch counts against what the depth implies, and the kernels against
   their twins inside the model;
4. drives CLIP-FeatureFusion serving at full width and depth (ViT-L/14, 24 +
   12 blocks, none trimmed; T5 fusion stack, 2 layers, d_model 768) through
   `build_model_from_config`, the embedder's loop, `create_index` and
   `run_retrieval` with the bf16, per-row int8 and per-bucket int8 (K11)
   pools: once with UNIIR_ATTN_SPLITK=1 (24 K10 + 12 K1 launches a batch)
   and once without (36 K1, no K10), and checks the counts, the cosine of
   the two runs' embeddings and of kernels against twins inside the model,
   the pools' ids and the copied candidates;
5. checks K3, the attention backward, against its twin at the CLIP-L vision
   and text shapes (and against autograd through the plain forward): its
   one-block-a-head kernel and its general-length kernels both, timed in
   turns, and the general ones also at L = 400, which only they take;
6. drives BLIP-ScoreFusion serving at the full width and depth of
   `configs/blip_sf/large` (ViT-L/16, 24 blocks; MED, 12 layers) in bf16
   through `build_model_from_config`:
   seeded uint8 256 x 256 images go through K7 on the card (bicubic, bf16)
   into collated batches of 64 with hash token ids and padding masks of
   mixed lengths, then the embedder's loop, `create_index` and
   `run_retrieval` with the int8 and the bf16 pool -- and checks the K7 / K1
   launch counts against the depth (23 K1 a vision batch, none from MED),
   finite embeddings, agreement with the same model through the twins, that
   padding does not leak, that both pools return the same ids and that
   copied candidates are found; then BLIP-FeatureFusion `large` the same
   way through `build_model_from_config` (24 K1 a batch: the ViT's token
   output feeds MED's cross-attention; retrieval also through K11);
7. drives the training path through the port's own entry points -- seeded
   CLIP-SF ViT-L/14 with fp32 masters and bf16 compute from
   `build_model_from_config(train=True)`, `make_clip_optimizer`,
   `make_clip_train_step`, `train_one_epoch` over synthetic collated batches
   of 32 pairs, then 105 pairs (the reference's per-GPU batch) with remat --
   and checks that K1 and K3 were launched, that the loss falls on a repeated
   batch, that one step's loss and gradients through the kernels agree with
   the twins, and that a saved train checkpoint restores bit-equal and serves;
8. drives CLIP-FF training the same way by configs/clip_ff/large/train/
   inbatch/inbatch.yaml (lr 1e-5, T5 group at 1e-4, fusion dropout on) at 32
   pairs, then with remat and UNIIR_ATTN_SPLITK=1 (K10 forward, K3
   backward), and checks the K1 / K10 / K3 counts, both learning rates read
   back from the optimizer, the falling loss, the gradients against the
   twins under the same dropout draws, and the checkpoint round trip.

With `--profile` it also prints torch.profiler breakdowns, by kernel group,
of the 32-pair train steps (CLIP-SF, CLIP-FF), of the CLIP-SF embed step at
batch 64 in bf16 and in each int8 mode, and of the CLIP-FF, BLIP-SF and
BLIP-FF forwards at batch 64.

Prints, before the last line, the card's name and power limit and one JSON
line with each kernel's launches, error, times and bound (the least time
the card could take: bytes moved over 3.35 TB/s or operations over the
peak rate for their type -- the tensor cores' dense peak, or for K7's fp32
products the CUDA cores' -- whichever is larger); the last line is
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when
there is no CUDA card or a check fails.  Weights and the tokenizer are
seeded stand-ins (the CLIP-L and BLIP checkpoints, the BPE files and BERT's
vocabulary are not in the repo).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"
SEED = 0
POOL_ROWS, POOL_DIM, N_QUERIES = 5_600_000, 768, 256
N_CANDS, N_QUERY_PAIRS, BATCH = 512, 256, 64
K = 10
MODEL, DEVICE = "ViT-L/14", "cuda"  # the main path's model and device
# the training path: 32 pairs (64 rows) without remat, then the reference's
# per-GPU batch of 105 pairs (840 over 8 GPUs) with remat; lr of
# configs/clip_sf/large/train/inbatch/inbatch.yaml
TRAIN_BS, REMAT_BS, TRAIN_LR = 32, 105, 1e-5
TRAIN_BATCHES, REMAT_BATCHES, REPEAT_STEPS = 6, 3, 8
# published dense peaks of one H100 SXM (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S, BF16_OPS_PER_S, INT8_OPS_PER_S = 3.35e12, 989e12, 1979e12
FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores (the same data sheet): K7's products
EXPT = "CLIP_SF/Large/Seeded/"  # the bf16 path's experiment directory
# the BLIP-SF path: configs/blip_sf/large (vit: large, tokenizer_max_length: 50), fed by uint8 images of this side
BLIP_SIZE, BLIP_EXPT, BLIP_MAX_LEN, RAW_SIDE = "large", "BLIP_SF/Large/Seeded/", 50, 256


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean device time of fn() over `iters` runs after one warm-up (CUDA
    events).  The runs are queued behind a few milliseconds of a spinning
    kernel, so the host has them enqueued before the first one starts and a
    short kernel's time is the device's, not the rate Python launches at."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(a.double().flatten(), b.double().flatten(), dim=0).item()


def bound(moved: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the HBM rate, or the operations at the tensor
    cores' dense peak for their type, whichever is larger."""
    by_bytes, by_ops = moved / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------- phase 1: K1


def check_attention(results: dict) -> None:
    """K1: the one-block-a-head kernel and the general-length kernel against
    the twin and timed in turns (new, old, new) at the three shapes the
    models use; then the general kernel at a length only it takes."""
    from uniir_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"K1": 0.0, "K1g": 0.0}
    shapes = {"vision": (BATCH, 257, 16, False), "text": (BATCH, 77, 12, True), "blip vision": (BATCH, 197, 16, False),
              "long (384-pixel BLIP)": (8, 577, 16, False)}
    for tag, (B, L, H, causal) in shapes.items():
        q, k, v = (torch.randn(B, L, H * 64, generator=g, device="cuda").bfloat16() for _ in range(3))
        before = (A.attention.launches, A.attention_fwd_general.launches)
        out = A.attention(q, k, v, H, causal=causal)
        torch.cuda.synchronize()
        routed = (A.attention.launches - before[0], A.attention_fwd_general.launches - before[1])
        route = A.forward_route(64, L)
        check(routed == ((1, 0) if route == "fused" else (0, 1)), f"attention at L={L} launched {routed}, route {route}")
        ref = A.attention_reference(q, k, v, H, causal=causal)
        old = A.attention_fwd_general(q, k, v, H, causal=causal)
        err, cos = (out.float() - ref.float()).abs().max().item(), cosine(out, ref)
        old_err, old_cos = (old.float() - ref.float()).abs().max().item(), cosine(old, ref)
        ms = cuda_ms(lambda: A.attention(q, k, v, H, causal=causal), 20)
        old_ms = cuda_ms(lambda: A.attention_fwd_general(q, k, v, H, causal=causal), 20)
        ms_again = cuda_ms(lambda: A.attention(q, k, v, H, causal=causal), 20)
        plain_ms = cuda_ms(lambda: A.attention_reference(q, k, v, H, causal=causal), 20)
        # the library call: F.scaled_dot_product_attention over [B, H, L, D] views of the same tensors
        heads = [t.view(B, L, H, 64).transpose(1, 2) for t in (q, k, v)]
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*heads, is_causal=causal), 20)
        limit = bound(nbytes(q, k, v, out), 4 * B * H * L * L * 64, BF16_OPS_PER_S)
        log(f"K1 attention {tag} [{B},{L},{H * 64}] H={H} causal={causal} route={route}: max_abs_err={err} cosine={cos} "
            f"kernel_ms={ms} / {ms_again} (general-length kernel between them: {old_ms}, max_abs_err={old_err} "
            f"cosine={old_cos}) plain_ms={plain_ms} library_ms={library_ms} {limit}")
        # same rounding points as the twin; fp32 sums in another order -> a
        # couple of bf16 ulps of outputs of magnitude < 4
        check(err <= 3e-2 and cos >= 0.9999, f"K1 disagrees with its twin at {tag} shapes")
        check(old_err <= 3e-2 and old_cos >= 0.9999, f"the general-length K1 disagrees with its twin at {tag} shapes")
        if route == "fused":
            check(max(ms, ms_again) < old_ms, f"the one-block-a-head K1 is not faster than the general kernel at {tag} shapes")
            worst["K1"] = max(worst["K1"], err)
        worst["K1g"] = max(worst["K1g"], old_err)
        if tag == "vision":
            results["K1"].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
        if route == "general":  # the general kernel's row: the length only it takes
            results["K1g"].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
    for name, err in worst.items():
        results[name]["max_abs_err"] = err


def check_attention_norm_first(results: dict) -> None:
    """K8 (`mha_nocausal`, [B, L, H, D]) and K9 (`mha_paired`, [B, L, H*D])
    against their twin at the BLIP and CLIP shapes."""
    from uniir_tpu_torch.ops.attention import attention_twopass_reference, mha_nocausal, mha_paired

    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    cases = [("K8", "blip vision", (BATCH, 197, 16, False)), ("K8", "clip vision", (BATCH, 257, 16, False)),
             ("K9", "blip vision", (BATCH, 197, 16, False)), ("K9", "clip text", (BATCH, 77, 12, True))]
    worst = {"K8": 0.0, "K9": 0.0}
    for name, tag, (B, L, H, causal) in cases:
        q, k, v = (torch.randn(B, L, H * 64, generator=g, device="cuda").bfloat16() for _ in range(3))
        if name == "K8":
            q4, k4, v4 = (t.view(B, L, H, 64) for t in (q, k, v))
            run = lambda: mha_nocausal(q4, k4, v4).view(B, L, H * 64)
        else:
            run = lambda: mha_paired(q, k, v, H, causal=causal)
        out = run()
        torch.cuda.synchronize()
        ref = attention_twopass_reference(q, k, v, H, causal=causal)
        err, cos = (out.float() - ref.float()).abs().max().item(), cosine(out, ref)
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(lambda: attention_twopass_reference(q, k, v, H, causal=causal), 10)
        heads = [t.view(B, L, H, 64).transpose(1, 2) for t in (q, k, v)]
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*heads, is_causal=causal), 20)
        limit = bound(nbytes(q, k, v, out), 4 * B * H * L * L * 64, BF16_OPS_PER_S)
        log(f"{name} {tag} [{B},{L},{H}x64] causal={causal}: max_abs_err={err} cosine={cos} kernel_ms={ms} "
            f"plain_ms={plain_ms} library_ms={library_ms} {limit}")
        # the twin's rounding points; the fp32 row sum in another order can move a probability by
        # one bf16 step: two bf16 steps of softmax-averaged outputs below 1 (2 x 2^-8)
        check(err <= 8e-3 and cos >= 0.9999, f"{name} disagrees with its twin at {tag} shapes")
        worst[name] = max(worst[name], err)
        if tag == "blip vision":
            results[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
    for name, err in worst.items():
        results[name]["max_abs_err"] = err


def check_attention_splitk(results: dict) -> None:
    """K10 against its twin and against K1 at the CLIP vision shape, and the
    flag's routing: lengths outside K10's condition launch K1."""
    from uniir_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    B, L, H = BATCH, 257, 16
    q, k, v = (torch.randn(B, L, H * 64, generator=g, device="cuda").bfloat16() for _ in range(3))
    before = (A.attention.launches, A.attention_splitk.launches)
    out = A.attention(q, k, v, H, splitk=True)
    torch.cuda.synchronize()
    check((A.attention.launches, A.attention_splitk.launches) == (before[0], before[1] + 1),
          "attention(splitk=True) at L = 257 did not launch K10 alone")
    ref = A.attention_splitk_reference(q, k, v, H)
    k1 = A.attention(q, k, v, H)
    err, cos = (out.float() - ref.float()).abs().max().item(), cosine(out, ref)
    err_k1, cos_k1 = (out.float() - k1.float()).abs().max().item(), cosine(out, k1)
    ms = cuda_ms(lambda: A.attention(q, k, v, H, splitk=True), 20)
    k1_ms = cuda_ms(lambda: A.attention(q, k, v, H), 20)
    ms_again = cuda_ms(lambda: A.attention(q, k, v, H, splitk=True), 20)  # K10, K1, K10: one card, in turns
    plain_ms = cuda_ms(lambda: A.attention_splitk_reference(q, k, v, H), 10)
    heads = [t.view(B, L, H, 64).transpose(1, 2) for t in (q, k, v)]
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*heads), 20)
    limit = bound(nbytes(q, k, v, out), 4 * B * H * L * L * 64, BF16_OPS_PER_S)  # K1's bytes and operations
    log(f"K10 split-K attention vision [{B},{L},{H * 64}] H={H}: max_abs_err={err} cosine={cos}; against K1 on the same "
        f"input max_abs_diff={err_k1} cosine={cos_k1}; kernel_ms={ms} / {ms_again} (K1 between them {k1_ms}) "
        f"plain_ms={plain_ms} library_ms={library_ms} {limit}")
    # the twin's rounding points, fp32 sums in another order: K1's limit, a couple of bf16 ulps of
    # outputs of magnitude < 4.  Against K1 only the last key's term rounds elsewhere (its score a
    # sum of bf16 products, its value term rounded on its own): the same few bf16 steps.
    check(err <= 3e-2 and cos >= 0.9999, "K10 disagrees with its twin at the vision shape")
    check(err_k1 <= 3e-2 and cos_k1 >= 0.9999, "K10 left K1's output at the vision shape")
    for tag, (L2, H2, causal) in {"blip vision": (197, 16, False), "text": (77, 12, True)}.items():
        q2, k2, v2 = (torch.randn(B, L2, H2 * 64, generator=g, device="cuda").bfloat16() for _ in range(3))
        before = (A.attention.launches, A.attention_splitk.launches)
        flagged = A.attention(q2, k2, v2, H2, causal=causal, splitk=True)
        torch.cuda.synchronize()
        routed = (A.attention.launches - before[0], A.attention_splitk.launches - before[1])
        same = torch.equal(flagged, A.attention(q2, k2, v2, H2, causal=causal))
        log(f"K10 routing with the flag on at {tag} L={L2} causal={causal}: launches (K1, K10)={routed}, equals K1's output={same}")
        check(routed == (1, 0) and same, f"the split-K flag did not leave {tag} shapes to K1")
    results["K10"].update(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)


def _off_path_kernels():
    from uniir_tpu_torch.ops import attention as attn_mod

    return (("K8", attn_mod.mha_nocausal), ("K9", attn_mod.mha_paired),
            ("K1g", attn_mod.attention_fwd_general), ("K3g", attn_mod.attention_bwd_general))


def zero_standalone() -> None:
    """K8 / K9 are stand-alone entry points, as in the JAX package, and the
    general-length K1 / K3 serve lengths past 272, which no model of these
    paths has: every path sets their counts to 0 with its own before it starts."""
    for _, fn in _off_path_kernels():
        fn.launches = 0


def read_standalone(results: dict, path: str) -> None:
    """Read their counts just after a path: no model calls K8 / K9, and the
    static route sends every length of these paths (77, 197, 257) to the
    one-block-a-head K1 / K3."""
    for name, fn in _off_path_kernels():
        results[name]["launches"] = results[name].get("launches", 0) + fn.launches
        check(fn.launches == 0, f"off-path kernel {name} was launched {fn.launches} times on the {path} path")


# ---------------------------------------------------------------- phase 1: K7


def library_preprocess(images_u8: torch.Tensor, out_size: int, method: str, mean, std, out_dtype):
    """K7's function through one library resize: `F.interpolate(antialias=True)`
    on the float NCHW batch, then the normalisation (timed beside the kernel
    only; its border taps differ from PIL's window)."""
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    x = torch.nn.functional.interpolate(x, size=(out_size, out_size), mode=method, antialias=True, align_corners=False)
    return ((x - mean[:, None, None]) / std[:, None, None]).permute(0, 2, 3, 1).to(out_dtype)


def check_preprocess(results: dict) -> None:
    """K7 against its twin (and the numpy reference on a few images) at the
    BLIP path's shape: uint8 [64, 256, 256, 3] -> 224."""
    from uniir_tpu_torch.ops import image_ops as I

    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    B, S, O = BATCH, RAW_SIDE, 224
    img = torch.randint(0, 256, (B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    mean, std = (torch.from_numpy(v).cuda() for v in (I.CLIP_MEAN, I.CLIP_STD))
    dense_ops = B * 3 * 2 * (O * S * S + O * S * O)  # both products multiplied densely, as the kernel does
    worst = 0.0
    for method, dtype in (("bilinear", torch.float32), ("bicubic", torch.bfloat16)):
        # what the function needs: a multiply-add for each non-zero tap of this run's [O, S] matrix,
        # as A_h over the S columns of a plane and as A_w over the O rows of the intermediate
        taps = int(np.count_nonzero(I.resize_matrix(S, O, method)))
        ops = B * 3 * 2 * taps * (S + O)
        out = I.fused_preprocess(img, O, method, dtype)
        torch.cuda.synchronize()
        ref = I.fused_preprocess_reference(img, O, method, dtype)
        err = (out.float() - ref.float()).abs().max().item()
        numpy_ref = torch.from_numpy(I.preprocess_reference_numpy(img[:4].cpu().numpy(), O, method)).cuda()
        err_np = (out[:4].float() - numpy_ref).abs().max().item()
        ms = cuda_ms(lambda: I.fused_preprocess(img, O, method, dtype), 20)
        plain_ms = cuda_ms(lambda: I.fused_preprocess_reference(img, O, method, dtype), 10)
        library_ms = cuda_ms(lambda: library_preprocess(img, O, method, mean, std, dtype), 10)
        matrices = 2 * O * S * 4
        limit = bound(nbytes(img, out) + matrices, ops, FP32_OPS_PER_S)
        log(f"K7 fused_preprocess uint8 [{B},{S},{S},3] -> {O} {method} {str(dtype).split('.')[-1]}: max_abs_err={err} "
            f"vs numpy reference (4 images)={err_np} kernel_ms={ms} ({dense_ops / ms / 1e9:.2f} TFLOP/s fp32 of the "
            f"{dense_ops / 1e9:.2f} GFLOP it multiplies densely; the {taps} taps of a matrix need {ops / 1e9:.3f} GFLOP) "
            f"plain_ms={plain_ms} library_ms={library_ms} (F.interpolate antialias + normalise; other border taps) {limit}")
        # against the twin, which has the kernel's arithmetic: the fp32 sums in another order move a
        # value below 4 by an fp32 step or two (2^-22 each), and in bf16 by at most one step (2^-6);
        # the numpy reference divides by 255 and std where the kernel multiplies: atol 1e-4 on top
        tol = 2.0**-21 if dtype == torch.float32 else 2.0**-6
        check(err <= tol, f"K7 disagrees with its twin ({method}, {dtype}): {err} > {tol}")
        check(err_np <= tol + 1e-4, f"K7 disagrees with the numpy reference ({method}, {dtype}): {err_np}")
        worst = max(worst, err)
        if method == "bicubic":  # the BLIP path's call
            results["K7"].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
    results["K7"]["max_abs_err"] = worst


# ----------------------------------------------------------- phase 1: K2 / K4


def brute_force_topk(queries: torch.Tensor, pool: torch.Tensor, valid_n: int, k: int):
    """fp32 top-k over the whole bf16 pool, in row steps."""
    qf = queries.bfloat16().float()
    best_s = torch.full((queries.shape[0], k), -float("inf"), device=pool.device)
    best_i = torch.zeros((queries.shape[0], k), dtype=torch.long, device=pool.device)
    step = 1 << 17
    for r0 in range(0, valid_n, step):
        s = qf @ pool[r0 : min(r0 + step, valid_n)].float().T
        vals, idx = torch.topk(s, min(k, s.shape[1]), dim=1)
        best_s, pos = torch.topk(torch.cat([best_s, vals], 1), k, dim=1)
        best_i = torch.gather(torch.cat([best_i, idx + r0], 1), 1, pos)
    return best_s, best_i


def same_ranking(idx: torch.Tensor, ref_idx: torch.Tensor, ref_scores: torch.Tensor, tie: float = 1e-5) -> bool:
    """Equal ids, except where the reference's neighbouring scores tie within `tie`."""
    diff = idx != ref_idx
    if not diff.any():
        return True
    near_tie = torch.zeros_like(diff)
    near_tie[:, 1:] |= (ref_scores[:, 1:] - ref_scores[:, :-1]).abs() < tie
    near_tie[:, :-1] |= (ref_scores[:, :-1] - ref_scores[:, 1:]).abs() < tie
    return bool((~diff | near_tie).all())


def library_bucket_max(queries, pool, valid_n: int, int8=None):
    """The sweeps' function through library products, in the twins' row
    steps: bf16 `torch.matmul`, or `torch._int_mm` on the int8 pool with the
    dequantisation in torch ops, then the strided-bucket maxima."""
    from uniir_tpu_torch.ops import topk as T

    out = []
    for r0 in range(0, pool.shape[0], T.ROWS_PER_STEP):
        rows = slice(r0, r0 + T.ROWS_PER_STEP)
        if int8 is None:
            scores = torch.matmul(queries, pool[rows].T).float()
        else:
            q_q, q_scale, pool_scale = int8
            scores = torch._int_mm(q_q, pool[rows].T).float() * q_scale[:, None] * pool_scale[None, rows]
        out.append(T._bucket_max(T._masked(scores, r0, valid_n)))
    return torch.cat(out, dim=1)


def library_bucket_max_i8b(q_q, q_scale, pool_q, bucket_scale, valid_n: int):
    """K11's function through `torch._int_mm` in the twins' row steps: the
    int32 scores masked, the strided-bucket `amax` in int32, then the
    dequantisation of the maxima in torch ops (timed beside the kernel only)."""
    from uniir_tpu_torch.ops import topk as T

    Q, out = q_q.shape[0], []
    for r0 in range(0, pool_q.shape[0], T.ROWS_PER_STEP):
        acc = torch._int_mm(q_q, pool_q[r0 : r0 + T.ROWS_PER_STEP].T)
        n = acc.shape[1]
        rows = torch.arange(r0, r0 + n, device=acc.device)
        acc = torch.where(rows < valid_n, acc, -(2**31 - 1))
        out.append(acc.view(Q, n // T.CHUNK, T.GROUP, T.LANES).amax(dim=2).reshape(Q, n // T.GROUP))
    deq = torch.cat(out, dim=1).float() * q_scale[:, None] * bucket_scale[None, :]
    first = T._bucket_rows(torch.arange(pool_q.shape[0] // T.GROUP, device=deq.device))[:, 0]
    return torch.where(first < valid_n, deq, T.NEG)


def check_sweeps(results: dict) -> None:
    from uniir_tpu_torch.ops import topk as T

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # the main path's sweep: its queries against its 512-row pool (one chunk)
    small_q = torch.randn(N_QUERY_PAIRS, POOL_DIM, generator=g, device="cuda")
    small_pool = torch.randn(T.CHUNK, POOL_DIM, generator=g, device="cuda").bfloat16()
    err = (T.bucket_max_scores(small_q, small_pool, N_CANDS)
           - T.bucket_max_scores_reference(small_q, small_pool, N_CANDS)).abs().max().item()
    q_q, q_scale = T.quantize_rows(small_q)
    pq, ps = T.quantize_pool(small_pool)
    exact8 = torch.equal(T.bucket_max_scores_i8(small_q, pq, ps, N_CANDS),
                         T.bucket_max_scores_i8_reference(q_q, q_scale, pq, ps, N_CANDS))
    pqb, psb = T.quantize_pool(small_pool, per_bucket=True)
    exact8b = torch.equal(T.bucket_max_scores_i8(small_q, pqb, psb, N_CANDS),
                          T.bucket_max_scores_i8b_reference(q_q, q_scale, pqb, psb, N_CANDS))
    log(f"K2 / K4 / K11 at the main path's pool [{T.CHUNK}, {POOL_DIM}], valid {N_CANDS}, {N_QUERY_PAIRS} queries: "
        f"K2 max_abs_err={err}, K4 bit-equal={exact8}, K11 bit-equal={exact8b}")
    check(err <= 1e-3 and exact8 and exact8b, "K2 / K4 / K11 disagree with their twins at the main path's pool")
    # a pool whose valid_n cuts a chunk inside its first 128 rows: buckets whose first member is
    # padding write NEG after the dequantisation, the rest mask their padding members in int32
    two = torch.randn(2 * T.CHUNK, POOL_DIM, generator=g, device="cuda").bfloat16()
    two_q, two_s = T.quantize_pool(two, per_bucket=True)
    cut = T.CHUNK + 100
    got = T.bucket_max_scores_i8(small_q, two_q, two_s, cut)
    want = T.bucket_max_scores_i8b_reference(q_q, q_scale, two_q, two_s, cut)
    n_neg = int((got == T.NEG).sum())
    log(f"K11 on a [{2 * T.CHUNK}, {POOL_DIM}] pool cut at valid_n={cut}: bit-equal={torch.equal(got, want)}, "
        f"padding buckets at NEG={n_neg} (expected {N_QUERY_PAIRS * (T.LANES - 100)})")
    check(torch.equal(got, want) and n_neg == N_QUERY_PAIRS * (T.LANES - 100), "K11 disagrees with its twin on a cut chunk")
    del two, two_q, two_s, got, want

    n_pad = -(-POOL_ROWS // T.CHUNK) * T.CHUNK
    pool = torch.zeros((n_pad, POOL_DIM), dtype=torch.bfloat16, device="cuda")
    for r0 in range(0, POOL_ROWS, 1 << 20):  # L2-normalised Gaussian rows, like index embeddings
        rows = torch.randn(min(1 << 20, POOL_ROWS - r0), POOL_DIM, generator=g, device="cuda")
        pool[r0 : r0 + len(rows)] = torch.nn.functional.normalize(rows, dim=1).bfloat16()
    queries = torch.nn.functional.normalize(torch.randn(N_QUERIES, POOL_DIM, generator=g, device="cuda"), dim=1)
    pool_q, pool_scale = T.quantize_pool(pool)
    log(f"sweep pool: [{POOL_ROWS}, {POOL_DIM}] bf16 padded to {n_pad} rows, {N_QUERIES} queries")

    out = T.bucket_max_scores(queries, pool, POOL_ROWS)
    torch.cuda.synchronize()
    ref = T.bucket_max_scores_reference(queries, pool, POOL_ROWS)
    err2 = (out - ref).abs().max().item()
    ms2 = cuda_ms(lambda: T.bucket_max_scores(queries, pool, POOL_ROWS), 5)
    plain2 = cuda_ms(lambda: T.bucket_max_scores_reference(queries, pool, POOL_ROWS), 3)
    qb = queries.bfloat16()
    lib2 = cuda_ms(lambda: library_bucket_max(qb, pool, POOL_ROWS), 3)
    limit2 = bound(nbytes(qb, pool, out), 2 * N_QUERIES * POOL_ROWS * POOL_DIM, BF16_OPS_PER_S)
    log(f"K2 bf16 sweep: max_abs_err={err2} kernel_ms={ms2} plain_ms={plain2} library_ms={lib2} {limit2}")
    check(err2 <= 1e-5, "K2 disagrees with its twin")  # fp32 sums of 768 products of |x| < 1
    del ref

    out8 = T.bucket_max_scores_i8(queries, pool_q, pool_scale, POOL_ROWS)
    torch.cuda.synchronize()
    q_q, q_scale = T.quantize_rows(queries)
    ref8 = T.bucket_max_scores_i8_reference(q_q, q_scale, pool_q, pool_scale, POOL_ROWS)
    err4 = (out8 - ref8).abs().max().item()
    ms4 = cuda_ms(lambda: T.bucket_max_scores_i8(queries, pool_q, pool_scale, POOL_ROWS), 5)
    plain4 = cuda_ms(lambda: T.bucket_max_scores_i8_reference(q_q, q_scale, pool_q, pool_scale, POOL_ROWS), 3)
    lib4 = cuda_ms(lambda: library_bucket_max(q_q, pool_q, POOL_ROWS, int8=(q_q, q_scale, pool_scale)), 3)
    limit4 = bound(nbytes(queries, pool_q, pool_scale, out8), 2 * N_QUERIES * POOL_ROWS * POOL_DIM, INT8_OPS_PER_S)
    log(f"K4 int8 sweep: max_abs_err={err4} kernel_ms={ms4} plain_ms={plain4} library_ms={lib4} {limit4}")
    check(err4 == 0.0, "K4 disagrees with its twin (int8 sums are exact in both)")
    del ref8, out, out8

    # K11: the same pool with one scale per strided bucket; valid_n = 5.6M cuts the last chunk
    pool_qb, bucket_scale = T.quantize_pool(pool, per_bucket=True)
    out11 = T.bucket_max_scores_i8(queries, pool_qb, bucket_scale, POOL_ROWS)  # hands over by the scales' shape
    torch.cuda.synchronize()
    ref11 = T.bucket_max_scores_i8b_reference(q_q, q_scale, pool_qb, bucket_scale, POOL_ROWS)
    err11 = (out11 - ref11).abs().max().item()
    ms11 = cuda_ms(lambda: T.bucket_max_scores_i8(queries, pool_qb, bucket_scale, POOL_ROWS), 5)
    ms4_again = cuda_ms(lambda: T.bucket_max_scores_i8(queries, pool_q, pool_scale, POOL_ROWS), 5)
    ms11_again = cuda_ms(lambda: T.bucket_max_scores_i8(queries, pool_qb, bucket_scale, POOL_ROWS), 5)
    plain11 = cuda_ms(lambda: T.bucket_max_scores_i8b_reference(q_q, q_scale, pool_qb, bucket_scale, POOL_ROWS), 3)
    lib11 = cuda_ms(lambda: library_bucket_max_i8b(q_q, q_scale, pool_qb, bucket_scale, POOL_ROWS), 3)
    limit11 = bound(nbytes(queries, pool_qb, bucket_scale, out11), 2 * N_QUERIES * POOL_ROWS * POOL_DIM, INT8_OPS_PER_S)
    log(f"K11 int8 per-bucket sweep: max_abs_err={err11} kernel_ms={ms11} / {ms11_again} (K4 between them {ms4_again}, "
        f"before them {ms4}) plain_ms={plain11} library_ms={lib11} {limit11}")
    # the integers are exact (|acc| <= 768 * 127^2 < 2^24) and the dequantisation is two rounded multiplies
    check(err11 == 0.0 and torch.equal(out11, ref11), "K11 disagrees with its twin (bit-equal expected)")
    del ref11, out11

    bf_s, bf_i = brute_force_topk(queries, pool, POOL_ROWS, K)
    s16, i16 = T.topk(queries, pool, K, valid_n=POOL_ROWS)
    s8, i8, ok = T.topk(queries, pool, K, valid_n=POOL_ROWS, pool_quant=(pool_q, pool_scale), with_guard=True)
    rerun = not bool(ok.all())
    if rerun:  # the search's whole-batch exact re-run
        s8, i8 = T.topk(queries, pool, K, valid_n=POOL_ROWS)
    eq16, eq8 = same_ranking(i16, bf_i, bf_s), same_ranking(i8, bf_i, bf_s)
    log(f"top-{K} vs brute force: bf16 ids equal={eq16}, int8 ids equal={eq8} "
        f"(guard_pass_rate={ok.float().mean().item()}, exact_rerun={rerun}), "
        f"max score err={(s16 - bf_s).abs().max().item()}")
    check(eq16 and eq8, "top-k ids differ from brute force")
    # topk through K11 with the guard: where the guard passes, the bf16 pool's ids
    _, i11, ok11 = T.topk(queries, pool, K, valid_n=POOL_ROWS, pool_quant=(pool_qb, bucket_scale), with_guard=True)
    eq11 = same_ranking(i11[ok11], i16[ok11], s16[ok11])
    log(f"top-{K} through K11 (per-bucket int8 pool): guard_pass_rate={ok11.float().mean().item()}, "
        f"ids equal to the bf16 pool's where the guard passed={eq11}")
    check(eq11 and bool(ok11.any()), "top-k through K11 differs from the bf16 pool's where its guard passed")
    results["K2"].update(max_abs_err=err2, ms=ms2, plain_ms=plain2, library_ms=lib2, **limit2)
    results["K4"].update(max_abs_err=err4, ms=ms4, plain_ms=plain4, library_ms=lib4, **limit4)
    results["K11"].update(max_abs_err=err11, ms=ms11, plain_ms=plain11, library_ms=lib11, **limit11)
    del pool, pool_q, pool_scale, pool_qb, bucket_scale
    torch.cuda.empty_cache()


# ------------------------------------------------------- phase 2: main path


def hash_tokenize(texts, context_length: int = 77, vocab_size: int = 49408) -> np.ndarray:
    """Deterministic stand-in for CLIP's BPE: SOT, one id per word, EOT (the highest id)."""
    sot, eot = vocab_size - 2, vocab_size - 1
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        ids = [sot] + [1 + zlib.crc32(w.encode()) % (vocab_size - 3) for w in text.split()][: context_length - 2] + [eot]
        out[i, : len(ids)] = ids
    return out


WORDS = "red blue green dress shirt cat dog news photo street city river mountain car bike chair table".split()
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def make_items(rng, n: int, image_size: int):
    """n (text, image, txt_mask, img_mask) items of mixed modality."""
    items = []
    for i in range(n):
        kind = i % 3  # 0: text, 1: image, 2: image + text
        text = " ".join(rng.choice(WORDS, size=rng.integers(3, 12))) if kind != 1 else ""
        img = None
        if kind != 0:
            img = ((rng.random((image_size, image_size, 3), dtype=np.float32) - CLIP_MEAN) / CLIP_STD).astype(np.float32)
        items.append((text, img, int(kind != 1), int(kind != 0)))
    return items


def collate_rows(items, cfg) -> dict:
    """The model inputs of a collated batch, one row per item."""
    zero = np.zeros((cfg.image_size, cfg.image_size, 3), np.float32)
    return {
        "txt_batched": hash_tokenize([t for t, _, _, _ in items], cfg.context_length, cfg.vocab_size),
        "image_batched": np.stack([zero if im is None else im for _, im, _, _ in items]),
        "txt_mask_batched": np.asarray([m for _, _, m, _ in items], np.int32),
        "image_mask_batched": np.asarray([m for _, _, _, m in items], np.int32),
    }


def collate(items, ids, id_key: str, cfg) -> dict:
    """A batch in the collator's format (MBEIRCandidatePoolCollator / MBEIRMainCollator, eval)."""
    n_valid = len(items)
    items = items + [items[-1]] * (BATCH - n_valid)  # pad_last: repeat the last row
    ids = list(ids) + [ids[-1]] * (BATCH - n_valid)
    return {**collate_rows(items, cfg), id_key: np.asarray(ids, np.int64), "n_valid": np.int32(n_valid)}


def make_train_batch(rng, bs: int, cfg) -> dict:
    """bs (query, positive) pairs in MBEIRMainCollator's train layout: rows
    [0, bs) queries, [bs, 2bs) positives, of mixed modality."""
    pairs = np.arange(bs, dtype=np.int32)[:, None]
    return {**collate_rows(make_items(rng, 2 * bs, cfg.image_size), cfg),
            "index_mapping": {"query": pairs, "pos_cand": bs + pairs}}


def batches(items, ids, id_key, cfg):
    for i in range(0, len(items), BATCH):
        yield collate(items[i : i + BATCH], ids[i : i + BATCH], id_key, cfg)


def eval_config(root: str, results_dir: str, pool_dtype: str, dim: int, expt: str = EXPT):
    from uniir_tpu_torch.core.config import Config

    return Config.from_dict({
        "uniir_dir": root,
        "mbeir_data_dir": os.path.join(root, "mbeir_data"),
        "experiment": {"path_suffix": expt},
        "index_config": {
            "embed_dir_name": "embed", "index_dir_name": "index",
            "cand_pools_config": {"enable_idx": True, "cand_pools_name_to_idx": ["mscoco_task0"]},
            "faiss_config": {"dim": dim},
        },
        "retrieval_config": {
            "qrel_dir_name": "qrels", "embed_dir_name": "embed", "index_dir_name": "index",
            "results_dir_name": results_dir, "write_to_tsv": True, "pool_dtype": pool_dtype,
            "test_datasets_config": {
                "enable_retrieve": True, "datasets_name": ["mscoco_task0"],
                "correspond_cand_pools_name": ["mscoco_task0"], "correspond_qrels_name": ["mscoco_task0"],
                "correspond_metrics_name": ["Recall@1, Recall@5, Recall@10"],
            },
        },
    })


def read_run(path: str) -> dict:
    """qid -> [(did, score), ...] in rank order."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            qid, _, did, _, score, *_ = line.split()
            out.setdefault(qid, []).append((did, float(score)))
    return out


def smoke_dataset() -> dict:
    """The serving paths' seeded candidates and queries: every fourth query
    copies a candidate, which retrieval must find."""
    from uniir_tpu_torch.data.registry import hash_did, hash_qid
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS

    image_size = CLIP_CONFIGS[MODEL].image_size
    rng = np.random.default_rng(SEED)
    cands = make_items(rng, N_CANDS, image_size)
    queries = make_items(rng, N_QUERY_PAIRS, image_size)
    copied = {j: int(rng.integers(0, N_CANDS)) for j in range(0, N_QUERY_PAIRS, 4)}
    for j, c in copied.items():
        queries[j] = cands[c]
    relevant = {j: copied.get(j, int(rng.integers(0, N_CANDS))) for j in range(N_QUERY_PAIRS)}
    return dict(cands=cands, queries=queries, copied=copied, relevant=relevant,
                dids=[hash_did(f"9:{i}") for i in range(N_CANDS)], qids=[hash_qid(f"9:{j}") for j in range(N_QUERY_PAIRS)])


def embed_and_save(embed_step, data: dict, cfg, embed_dir: str, make_batches=None) -> dict:
    """Embed the candidates and the queries through the embedder's loop and
    write the .npy artifacts `create_index` / `run_retrieval` read.
    `make_batches(items, ids, id_key, cfg)` yields the collated batches
    (`batches` unless given)."""
    from uniir_tpu_torch.retrieval.embedder import generate_embeds_and_ids_for_dataset

    make_batches = make_batches or batches

    out = {}
    for split, items, ids, key, name in (
        ("cand_pool", data["cands"], data["dids"], "did_list", "mscoco_task0_cand_pool"),
        ("test", data["queries"], data["qids"], "qid_list", "mscoco_task0_test"),
    ):
        emb, got_ids = generate_embeds_and_ids_for_dataset(embed_step, make_batches(items, ids, key, cfg))
        check(emb.shape == (len(items), cfg.embed_dim) and emb.dtype == np.float16, f"{split} embeddings {emb.shape}")
        check(bool(np.isfinite(emb).all()), f"{split} embeddings are not finite")
        os.makedirs(os.path.join(embed_dir, split), exist_ok=True)
        np.save(os.path.join(embed_dir, split, f"mbeir_{name}_embed.npy"), emb)
        np.save(os.path.join(embed_dir, split, f"mbeir_{name}_ids.npy"), got_ids)
        out[split] = emb.astype(np.float32)
    return out


def write_qrels(root: str, data: dict) -> None:
    os.makedirs(os.path.join(root, "mbeir_data", "qrels", "test"), exist_ok=True)
    with open(os.path.join(root, "mbeir_data", "qrels", "test", "mbeir_mscoco_task0_test_qrels.txt"), "w") as f:
        for j, c in data["relevant"].items():
            f.write(f"9:{j} 0 9:{c} 1 8\n")


def retrieve_and_check(root: str, expt: str, embed_dim: int, data: dict, tag: str,
                       pool_dtypes=("int8", "bf16"), must_find=None) -> None:
    """`create_index`, then `run_retrieval` with the int8 pool (as shipped),
    where asked the per-bucket int8 pool (K11), and the bf16 pool: all return
    the same ids, and every query that copies a candidate finds it in its
    top 10 (`must_find(candidate index)` says which copies are held to that;
    all of them unless given)."""
    from uniir_tpu_torch.retrieval.eval import run_retrieval
    from uniir_tpu_torch.retrieval.index import create_index

    create_index(eval_config(root, f"results_{tag}_int8", "int8", embed_dim, expt))
    stats = {}
    for dtype in pool_dtypes:
        out: list = []
        res = run_retrieval(eval_config(root, f"results_{tag}_{dtype}", dtype, embed_dim, expt), device=DEVICE, stats_out=out)
        stats[dtype] = (res, out[0])
    torch.cuda.synchronize()
    for dtype, (res, st) in stats.items():
        (row,) = res
        log(f"{tag} retrieval pool_dtype={dtype}: Recall@1={row['Recall@1']} Recall@5={row['Recall@5']} "
            f"Recall@10={row['Recall@10']} guard_pass_rate={st['guard_pass_rate']} exact_reruns={st['exact_reruns']}")
    runs = {d: read_run(os.path.join(root, f"results_{tag}_{d}", expt, "run_files",
                                     "mbeir_mscoco_task0_single_pool_test_k10_run.txt")) for d in stats}
    ids = {d: {q: [did for did, _ in rows] for q, rows in run.items()} for d, run in runs.items()}
    for dtype in (d for d in pool_dtypes if d != "bf16"):
        differ = [q for q in ids["bf16"] if ids["bf16"][q] != ids[dtype][q]]
        for q in differ[:3]:
            log(f"  {q} bf16: {runs['bf16'][q]}\n  {q} {dtype}: {runs[dtype][q]}")
        check(not differ, f"{tag}: {dtype} and bf16 retrieval returned different ids for {len(differ)} queries")
    missing = [j for j, c in data["copied"].items() if f"9:{c}" not in ids["bf16"][f"9:{j}"]]
    if must_find is not None:
        held = [j for j in missing if must_find(data["copied"][j])]
        log(f"{tag}: copied candidates missing from their queries' top 10: {len(missing)} of {len(data['copied'])}, "
            f"{len(held)} of them among the copies held to it")
        missing = held
    check(not missing, f"{tag}: duplicated candidates missing from their queries' top 10: {missing[:5]}")


def log_candidate_spread(embed_dir: str) -> None:
    cand_emb = np.load(os.path.join(embed_dir, "cand_pool", "mbeir_mscoco_task0_cand_pool_embed.npy")).astype(np.float32)
    cand_emb /= np.linalg.norm(cand_emb, axis=1, keepdims=True)
    sims = cand_emb @ cand_emb.T
    off = sims[~np.eye(len(sims), dtype=bool)]
    log(f"candidate embeddings: off-diagonal cosine mean {off.mean():.4f} max {off.max():.4f}")


def drive_main_path(results: dict, data: dict) -> None:
    from uniir_tpu_torch.models import layers
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import seeded_clip_sf
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.ops import topk as T
    from uniir_tpu_torch.train.steps import make_embed_step

    shutil.rmtree(WORK, ignore_errors=True)
    root = str(WORK)
    cfg = CLIP_CONFIGS[MODEL]
    cands, dids = data["cands"], data["dids"]
    write_qrels(root, data)

    t0 = time.perf_counter()
    model = seeded_clip_sf(cfg, DEVICE, seed=SEED, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"main path: seeded CLIP-SF {MODEL} bf16 ({sum(p.numel() for p in model.parameters())} parameters) "
        f"in {time.perf_counter() - t0:.1f} s; {N_CANDS} candidates, {N_QUERY_PAIRS} queries, batch {BATCH}")
    log(f"forward of one resident image+text batch of {BATCH}, bf16: {forward_ms(model, cfg)} ms")

    counters = (attn_mod.attention, T.bucket_max_scores, T.bucket_max_scores_i8)
    for fn in counters:
        fn.launches = 0
    zero_standalone()
    t0 = time.perf_counter()
    embed_step = make_embed_step(model)
    embed_dir = os.path.join(root, "embed", EXPT)
    embed_and_save(embed_step, data, cfg, embed_dir)
    torch.cuda.synchronize()
    t_embed = time.perf_counter() - t0
    retrieve_and_check(root, EXPT, cfg.embed_dim, data, "clip")
    launches = {"K1": attn_mod.attention.launches, "K2": T.bucket_max_scores.launches,
                "K4": T.bucket_max_scores_i8.launches}
    log(f"main path: embed {t_embed:.2f} s (host clock, includes first-call set-up); launches {launches}")
    for name, n in launches.items():
        results[name]["launches"] = n
        check(n > 0, f"kernel {name} was not launched on the main path")
    read_standalone(results, "main")
    log_candidate_spread(embed_dir)

    # the same forward through the plain twins, on a small batch
    small = collate(cands[:8], dids[:8], "did_list", cfg)
    small.pop("did_list"), small.pop("n_valid")
    with_kernel = embed_step(dict(small)).float()
    layers.attention = attn_mod.attention_twin
    try:
        plain = embed_step(dict(small)).float()
    finally:
        layers.attention = attn_mod.attention
    cos = torch.nn.functional.cosine_similarity(with_kernel, plain, dim=1).min().item()
    log(f"embeddings through K1 vs through its twin (8 candidates): min cosine {cos}")
    check(cos >= 0.999, "embeddings through the kernel disagree with the plain path")


def resident_batch(cfg, n: int = BATCH, seed: int = SEED + 5):
    """One image+text batch of n rows as model inputs on the card."""
    rng = np.random.default_rng(seed)
    items = [(" ".join(rng.choice(WORDS, size=8)),
              ((rng.random((cfg.image_size, cfg.image_size, 3), dtype=np.float32) - CLIP_MEAN) / CLIP_STD), 1, 1)
             for _ in range(n)]
    rows = collate_rows(items, cfg)
    return tuple(torch.as_tensor(rows[key]).to(DEVICE)
                 for key in ("txt_batched", "image_batched", "txt_mask_batched", "image_mask_batched"))


def forward_ms(model, cfg, iters: int = 3) -> float:
    """Device time of one forward over a resident image+text batch of BATCH rows."""
    batch = resident_batch(cfg)
    with torch.inference_mode():
        return cuda_ms(lambda: model(*batch), iters)


# ------------------------------------------------------- phase 1: K5 and K6


def library_int8_matmul(xq, a_rows, wq, w_scale, bias):
    """K5's function through `torch._int_mm` and torch ops (timed beside the kernel only)."""
    return ((torch._int_mm(xq, wq.T).float() * a_rows[:, None]) * w_scale + bias).to(torch.bfloat16)


def check_int8_matmul(results: dict) -> None:
    """K5 against its twin at the shapes int8 serving gives it at batch 64:
    vision M = 64 * 257, text M = 64 * 77, the trimmed last block M = 64;
    per-row (dynamic) and static scales, with and without bias, whole weights
    and column ranges (the thirds of the fused qkv projection)."""
    from uniir_tpu_torch.ops import quant as Q

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    MV, MT = BATCH * 257, BATCH * 77
    # (tag, M, K, rows of the weight, column range or None)
    cases = [("vision qkv third", MV, 1024, 3072, (1024, 2048)), ("vision out", MV, 1024, 1024, None),
             ("vision fc1", MV, 1024, 4096, None), ("vision fc2", MV, 4096, 1024, None),
             ("text qkv third", MT, 768, 2304, (0, 768)), ("text out", MT, 768, 768, None),
             ("text fc1", MT, 768, 3072, None), ("text fc2", MT, 3072, 768, None),
             ("trimmed block k/v", BATCH * 257, 1024, 3072, (1024, 3072)), ("trimmed block q", BATCH, 1024, 3072, (0, 1024)),
             ("trimmed block fc2", BATCH, 4096, 1024, None)]
    worst = 0.0
    for tag, M, K, N, cols in cases:
        xq = torch.randint(-127, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (N, K), generator=g, device="cuda", dtype=torch.int8)
        ws = torch.rand(N, generator=g, device="cuda") * 2e-4 + 1e-5
        bias = torch.randn(N, generator=g, device="cuda")
        a_rows = torch.rand(M, generator=g, device="cuda") * 0.05 + 1e-3
        errs = []
        for a in (a_rows, 0.0123):  # per-row (dynamic) and static
            for b in (bias, None):
                out = Q.int8_matmul(xq, a, wq, ws, b, cols)
                torch.cuda.synchronize()
                ref = Q.int8_matmul_twin(xq, a, wq, ws, b, cols)
                errs.append((out.float() - ref.float()).abs().max().item())
        worst = max(worst, *errs)
        n = N if cols is None else cols[1] - cols[0]
        ms = cuda_ms(lambda: Q.int8_matmul(xq, a_rows, wq, ws, bias, cols), 10)
        log(f"K5 int8_matmul {tag} M={M} K={K} N={n} (weight rows {N}): max_abs_err dynamic/static x bias/none={errs} "
            f"kernel_ms={ms} ({2 * M * K * n / ms / 1e9:.1f} TOP/s)")
        # exact integer sums, the same separately rounded fp32 epilogue: bit-equal bf16
        check(max(errs) == 0.0, f"K5 disagrees with its twin at {tag}")
        if tag == "vision fc1":
            plain_ms = cuda_ms(lambda: Q.int8_matmul_twin(xq, a_rows, wq, ws, bias), 3)
            library_ms = cuda_ms(lambda: library_int8_matmul(xq, a_rows, wq, ws, bias), 10)
            int_mm_ms = cuda_ms(lambda: torch._int_mm(xq, wq.T), 10)
            limit = bound(nbytes(xq, wq, a_rows, ws, bias) + 2 * M * N, 2 * M * K * N, INT8_OPS_PER_S)
            log(f"K5 {tag}: plain_ms={plain_ms} library_ms={library_ms} (torch._int_mm alone {int_mm_ms}) {limit}")
            results["K5"].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
        del xq, wq
    results["K5"]["max_abs_err"] = worst


def check_int8_mlp(results: dict) -> None:
    """K6 against its twin at the vision and text widths at batch 64, and the
    MLP module's two static routes (K6, or two K5 calls around a bf16 hidden)
    timed beside each other."""
    from uniir_tpu_torch.models.layers import MLP
    from uniir_tpu_torch.ops import mlp as M_
    from uniir_tpu_torch.ops import quant as Q

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst = 0.0
    for tag, M, W in (("vision", BATCH * 257, 1024), ("text", BATCH * 77, 768)):
        H = 4 * W
        h = (torch.randn(M, W, generator=g, device="cuda") * 0.5).bfloat16()
        res = torch.randn(M, W, generator=g, device="cuda").bfloat16()
        w1q, s1 = Q.quantize_weight(torch.randn(H, W, generator=g, device="cuda") * W**-0.5)
        w2q, s2 = Q.quantize_weight(torch.randn(W, H, generator=g, device="cuda") * H**-0.5)
        b1, b2 = torch.randn(H, generator=g, device="cuda") * 0.1, torch.randn(W, generator=g, device="cuda") * 0.1
        a1, a2 = float(h.float().abs().max()) / 127.0, 2.0 / 127.0  # a2 clips the hidden's top
        args = (h, res, w1q, s1, b1, w2q, s2, b2, a1, a2)
        for act in ("quick_gelu", "gelu"):
            out = M_.int8_mlp(*args, act=act)
            torch.cuda.synchronize()
            ref = M_.int8_mlp_twin(*args, act=act)
            diff = (out.float() - ref.float()).abs()
            err, share = diff.max().item(), (diff > 0).float().mean().item()
            log(f"K6 int8_mlp {tag} M={M} W={W} act={act}: max_abs_err={err} outputs that differ={share} "
                f"max_abs_ref={ref.float().abs().max().item()}")
            # exact integer sums and the same fp32 steps; only the last ulp of exp / erf can move a
            # hidden integer by one step (a2 * w2_scale ~ 1e-4 per output): at most one bf16 step
            # (2^-5 below 8) on a few outputs
            check(err <= 2.0**-5 and share <= 1e-3, f"K6 disagrees with its twin at {tag} shapes, {act}")
            worst = max(worst, err)
        ms = cuda_ms(lambda: M_.int8_mlp(*args), 10)
        plain_ms = cuda_ms(lambda: M_.int8_mlp_twin(*args), 3)
        # the two routes of the static MLP half-block, through the module the model calls
        routes = {}
        for route in ("fused", "xla"):
            mlp = MLP(W, H, quant=True, int8_mode="static", mlp_route=route).to(DEVICE)
            mlp.load_state_dict({"c_fc.weight_q": w1q, "c_fc.scale": s1, "c_fc.bias": b1, "c_proj.weight_q": w2q,
                                 "c_proj.scale": s2, "c_proj.bias": b2})
            mlp.set_act_scales([a1, a2])
            with torch.inference_mode():
                routes[route] = cuda_ms(lambda: mlp(h, res=res), 10)
        xq = torch.randint(-127, 128, (M, W), generator=g, device="cuda", dtype=torch.int8)
        hq = torch.randint(-127, 128, (M, H), generator=g, device="cuda", dtype=torch.int8)
        two_int_mm = cuda_ms(lambda: (torch._int_mm(xq, w1q.T), torch._int_mm(hq, w2q.T)), 10)
        del xq, hq
        limit = bound(nbytes(h, res, out, w1q, w2q, s1, b1, s2, b2), 4 * M * W * H, INT8_OPS_PER_S)
        log(f"K6 int8_mlp {tag}: kernel_ms={ms} ({4 * M * W * H / ms / 1e9:.1f} TOP/s) plain_ms={plain_ms} "
            f"MLP module static route fused (K6)={routes['fused']} ms, xla (two K5 + bf16 hidden)={routes['xla']} ms; "
            f"no single library call computes it: two torch._int_mm of these shapes alone take {two_int_mm} ms; {limit}")
        if tag == "vision":
            results["K6"].update(ms=ms, plain_ms=plain_ms, **limit)
    results["K6"]["max_abs_err"] = worst


# ------------------------------------------------ phase 3: int8 model serving

# UNIIR_INT8_BACKEND / UNIIR_INT8_MLP values of each int8 serving mode driven, and the least
# per-row cosine its embeddings must keep to the bf16 path's (seeded Gaussian weights; the
# static mode clips at scales calibrated on two batches)
INT8_MODES = {"xla": ("xla", "fused", 0.99), "wonly": ("wonly", "fused", 0.99), "static": ("static", "fused", 0.95),
              "static-mlp-xla": ("static", "xla", 0.95)}


def expected_int8_launches(cfg, mode: str, n_batches: int):
    """(K5, K6) launches of n_batches forwards.  A full block runs q, k, v,
    out, fc1, fc2 (6 K5); the trimmed last block of each tower q, k/v, out,
    fc1, fc2 (5 K5).  With the fused static MLP, fc1 + fc2 are one K6."""
    blocks, towers = cfg.vision_layers + cfg.text_layers, 2
    backend, route, _ = INT8_MODES[mode]
    if backend == "wonly":
        return 0, 0
    fused = backend == "static" and route == "fused"
    k5 = (blocks - towers) * (4 if fused else 6) + towers * (3 if fused else 5)
    return n_batches * k5, n_batches * (blocks if fused else 0)


def drive_int8_path(results: dict, data: dict) -> dict:
    """int8 model serving through the registry, the embedder's loop, the index
    and retrieval, in every activation mode; returns the quantised models by mode."""
    from uniir_tpu_torch.core.config import Config
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import build_model_from_config, seeded_clip_sf
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.ops import calibrate as C
    from uniir_tpu_torch.ops import mlp as M_
    from uniir_tpu_torch.ops import quant as Q
    from uniir_tpu_torch.retrieval.eval import run_retrieval
    from uniir_tpu_torch.retrieval.index import create_index
    from uniir_tpu_torch.train.steps import make_embed_step

    root = str(WORK)
    cfg = CLIP_CONFIGS[MODEL]
    n_batches = -(-N_CANDS // BATCH) + -(-N_QUERY_PAIRS // BATCH)
    bf16 = {split: np.load(os.path.join(root, "embed", EXPT, split, f"mbeir_mscoco_task0_{split}_embed.npy")).astype(np.float32)
            for split in ("cand_pool", "test")}

    # calibrate the float model (bf16 compute) on two seeded batches; the artifact goes through a file
    floats = seeded_clip_sf(cfg, DEVICE, seed=SEED, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    probes = [resident_batch(cfg, seed=SEED + 8), resident_batch(cfg, seed=SEED + 9)]
    scales = C.calibrate_act_scales(floats, probes, margin=1.1)
    calib_path = os.path.join(root, "calib_clip_sf_large.npz")
    C.save_act_scales(calib_path, scales)
    loaded = C.load_act_scales(calib_path)
    check(set(loaded) == set(scales) and len(scales) == 2 * (cfg.vision_layers + cfg.text_layers)
          and all(np.array_equal(loaded[k], v) and np.isfinite(v).all() and (v > 0).all() for k, v in scales.items()),
          "the calibration artifact does not round-trip")
    log(f"int8 path: calibrated {len(scales)} scale pairs on 2 batches of {BATCH} in {time.perf_counter() - t0:.2f} s "
        f"-> {os.path.basename(calib_path)}")
    del floats, probes

    # a BPE merges file for the registry's tokenizer (the batches here are hash-tokenised)
    merges = os.path.join(root, "merges.txt")
    with open(merges, "w") as f:
        f.write("#version: 0.2\nt h\nth e\n")
    saved_env = {k: os.environ.get(k) for k in ("UNIIR_INT8_BACKEND", "UNIIR_INT8_MLP")}
    models = {}
    try:
        for mode, (backend, route, min_cos) in INT8_MODES.items():
            os.environ["UNIIR_INT8_BACKEND"], os.environ["UNIIR_INT8_MLP"] = backend, route
            config = Config.from_dict({"uniir_dir": root, "seed": SEED, "model": {
                "name": "CLIPScoreFusion", "clip_vision_model_name": MODEL, "int8": True, "clip_bpe_path": merges,
                "int8_calibration": calib_path}})
            model = build_model_from_config(config, device=DEVICE).model
            models[mode] = model
            for fn in (attn_mod.attention, Q.int8_matmul, M_.int8_mlp):
                fn.launches = 0
            zero_standalone()
            expt = f"CLIP_SF/Large/SeededInt8-{mode}/"
            t0 = time.perf_counter()
            emb = embed_and_save(make_embed_step(model), data, cfg, os.path.join(root, "embed", expt))
            torch.cuda.synchronize()
            t_embed = time.perf_counter() - t0
            k1, k5, k6 = attn_mod.attention.launches, Q.int8_matmul.launches, M_.int8_mlp.launches
            want5, want6 = expected_int8_launches(cfg, mode, n_batches)
            fwd = forward_ms(model, cfg)  # after the counts were read
            log(f"int8 path mode={mode} (UNIIR_INT8_BACKEND={backend}, UNIIR_INT8_MLP={route}): embed {t_embed:.2f} s "
                f"(host clock, {n_batches} batches of {BATCH}); forward of a resident batch {fwd} ms = "
                f"{BATCH / fwd * 1e3:.1f} pairs/s; launches K1={k1} K5={k5} K6={k6}; expected K5={want5} K6={want6} "
                f"= {n_batches} batches x ((blocks - 2) x (6, or 4 with K6) + 2 x (5, or 3 with K6)), K6 = blocks")
            check(k5 == want5 and k6 == want6, f"K5 / K6 launched {k5} / {k6} times in mode {mode}, expected {want5} / {want6}")
            check(k1 == n_batches * (cfg.vision_layers + cfg.text_layers - 2), f"K1 launched {k1} times in mode {mode}")
            results["K1"]["launches"] += k1
            results["K5"]["launches"] += k5
            results["K6"]["launches"] += k6
            read_standalone(results, f"int8 ({mode})")

            cos = np.concatenate([np.sum(emb[s_] * bf16[s_], 1) / (np.linalg.norm(emb[s_], axis=1) * np.linalg.norm(bf16[s_], axis=1))
                                  for s_ in ("cand_pool", "test")])
            log(f"int8 path mode={mode}: cosine to the bf16 path's embeddings min {cos.min():.5f} mean {cos.mean():.5f}")
            check(cos.min() >= min_cos, f"int8 embeddings (mode {mode}) left the bf16 path's: min cosine {cos.min()}")

            create_index(eval_config(root, f"results_{mode}", "int8", cfg.embed_dim, expt))
            (row,) = run_retrieval(eval_config(root, f"results_{mode}", "int8", cfg.embed_dim, expt), device=DEVICE)
            run = read_run(os.path.join(root, f"results_{mode}", expt, "run_files",
                                        "mbeir_mscoco_task0_single_pool_test_k10_run.txt"))
            missing = [j for j, c in data["copied"].items() if f"9:{c}" not in [d for d, _ in run[f"9:{j}"]]]
            log(f"int8 path mode={mode}: Recall@1={row['Recall@1']} Recall@5={row['Recall@5']} Recall@10={row['Recall@10']}; "
                f"copied candidates missing from their queries' top 10: {len(missing)}")
            check(not missing, f"mode {mode}: duplicated candidates missing from their queries' top 10: {missing[:5]}")

            # the same int8 model through the plain twins of K5 / K6 (and K1), on a small batch
            if backend != "wonly":
                small = collate(data["cands"][:8], data["dids"][:8], "did_list", cfg)
                small.pop("did_list"), small.pop("n_valid")
                step = make_embed_step(model)
                with_kernels = step(dict(small)).float()
                kernels = (Q.int8_matmul, M_.int8_mlp)
                Q.int8_matmul, M_.int8_mlp = Q.int8_matmul_twin, M_.int8_mlp_plain
                try:
                    plain = step(dict(small)).float()
                finally:
                    Q.int8_matmul, M_.int8_mlp = kernels
                cos = torch.nn.functional.cosine_similarity(with_kernels, plain, dim=1).min().item()
                log(f"int8 path mode={mode}: embeddings through K5 / K6 vs through their twins (8 candidates): min cosine {cos}")
                check(cos >= 0.999, f"mode {mode}: embeddings through the int8 kernels disagree with the twins")
    finally:
        for k, v in saved_env.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
    for name in ("K5", "K6"):
        check(results[name]["launches"] > 0, f"kernel {name} was not launched on the int8 path")
    return models


# ------------------------------------ phase 6: BLIP-SF and BLIP-FF serving


def bert_hash_tokenize(texts, max_length: int = BLIP_MAX_LEN, vocab_size: int = 30524) -> dict:
    """Deterministic stand-in for the WordPiece tokenizer with its layout:
    [CLS] = 101, one id per word, [SEP] = 102, [PAD] = 0 under a 0 mask."""
    ids = np.zeros((len(texts), max_length), np.int32)
    mask = np.zeros((len(texts), max_length), np.int32)
    for i, text in enumerate(texts):
        row = [101] + [1000 + zlib.crc32(w.encode()) % (vocab_size - 1000) for w in text.split()][: max_length - 2] + [102]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return {"input_ids": ids, "attention_mask": mask}


def make_blip_items(rng, n: int):
    """n (text, uint8 image, txt_mask, img_mask) items of mixed modality; the
    texts have 3 to 46 words, so the padding masks have mixed lengths <= 50."""
    items = []
    for i in range(n):
        kind = i % 3  # 0: text, 1: image, 2: image + text
        text = " ".join(rng.choice(WORDS, size=rng.integers(3, 47))) if kind != 1 else ""
        img = rng.integers(0, 256, (RAW_SIDE, RAW_SIDE, 3), dtype=np.uint8) if kind != 0 else None
        items.append((text, img, int(kind != 1), int(kind != 0)))
    return items


def blip_dataset() -> dict:
    """As `smoke_dataset`, with raw uint8 images for the device-side preprocessing."""
    from uniir_tpu_torch.data.registry import hash_did, hash_qid

    rng = np.random.default_rng(SEED + 12)
    cands, queries = make_blip_items(rng, N_CANDS), make_blip_items(rng, N_QUERY_PAIRS)
    copied = {j: int(rng.integers(0, N_CANDS)) for j in range(0, N_QUERY_PAIRS, 4)}
    for j, c in copied.items():
        queries[j] = cands[c]
    relevant = {j: copied.get(j, int(rng.integers(0, N_CANDS))) for j in range(N_QUERY_PAIRS)}
    return dict(cands=cands, queries=queries, copied=copied, relevant=relevant,
                dids=[hash_did(f"9:{i}") for i in range(N_CANDS)], qids=[hash_qid(f"9:{j}") for j in range(N_QUERY_PAIRS)])


def blip_rows(items, image_size: int, preprocess) -> dict:
    """The model inputs of a collated BLIP batch: the uint8 images cross to
    the card as they are and `preprocess` (K7, or its twin) resizes and
    normalises them there; a missing image is a black one under a 0 mask."""
    black = np.zeros((RAW_SIDE, RAW_SIDE, 3), np.uint8)
    raw = torch.from_numpy(np.stack([black if im is None else im for _, im, _, _ in items])).to(DEVICE)
    return {
        "txt_batched": bert_hash_tokenize([t for t, _, _, _ in items]),
        "image_batched": preprocess(raw, image_size, "bicubic", torch.bfloat16),
        "txt_mask_batched": np.asarray([m for _, _, m, _ in items], np.int32),
        "image_mask_batched": np.asarray([m for _, _, _, m in items], np.int32),
    }


def drive_blip_path(results: dict, name: str, profile: bool = False) -> None:
    """BLIP `large` serving through the registry, for `name` =
    BLIPScoreFusion (the last ViT block trimmed to CLS: 23 K1 a batch) or
    BLIPFeatureFusion (the ViT's token output into MED's cross-attention:
    all 24 blocks through K1; retrieval also with the per-bucket int8 pool,
    K11): uint8 images through K7, then index and retrieval."""
    from uniir_tpu_torch.core.config import Config
    from uniir_tpu_torch.models import layers
    from uniir_tpu_torch.models.registry import build_model_from_config
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.ops import image_ops as I
    from uniir_tpu_torch.ops import topk as T
    from uniir_tpu_torch.train.steps import make_embed_step, model_inputs

    root = str(WORK)
    ff = name == "BLIPFeatureFusion"
    tag, expt = ("BLIP-FF", "BLIP_FF/Large/Seeded/") if ff else ("BLIP-SF", BLIP_EXPT)
    data = blip_dataset()
    write_qrels(root, data)
    n_batches = -(-N_CANDS // BATCH) + -(-N_QUERY_PAIRS // BATCH)
    vocab = os.path.join(root, "vocab.txt")  # for the registry's tokenizer; the batches here are hash-tokenised
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS) + "\n")
    config = Config.from_dict({"uniir_dir": root, "seed": SEED, "model": {
        "name": name, "vit": BLIP_SIZE, "tokenizer_max_length": BLIP_MAX_LEN, "bert_vocab_path": vocab}})

    t0 = time.perf_counter()
    bundle = build_model_from_config(config, device=DEVICE)
    model = bundle.model
    torch.cuda.synchronize()
    vit_cfg, med_cfg = model.vit_cfg, model.med_cfg
    shape = SimpleNamespace(embed_dim=bundle.embed_dim)  # what `embed_and_save` reads of a model configuration
    k1_blocks = vit_cfg.layers if ff else vit_cfg.layers - 1
    log(f"{tag} path: seeded {name} vit={BLIP_SIZE} (ViT-L/{vit_cfg.patch_size}, {vit_cfg.layers} blocks, L = "
        f"{(vit_cfg.image_size // vit_cfg.patch_size) ** 2 + 1}; MED {med_cfg.num_hidden_layers} layers, hidden {med_cfg.hidden_size}, "
        f"{BLIP_MAX_LEN} tokens) bf16 ({sum(p.numel() for p in model.parameters())} parameters) through "
        f"build_model_from_config in {time.perf_counter() - t0:.1f} s; {N_CANDS} candidates, {N_QUERY_PAIRS} queries, "
        f"batch {BATCH}, uint8 {RAW_SIDE} x {RAW_SIDE} images through K7")

    def make_batches(items, ids, id_key, _cfg):
        for i in range(0, len(items), BATCH):
            part, part_ids = items[i : i + BATCH], list(ids[i : i + BATCH])
            n_valid = len(part)
            part = part + [part[-1]] * (BATCH - n_valid)  # pad_last: repeat the last row
            part_ids = part_ids + [part_ids[-1]] * (BATCH - n_valid)
            yield {**blip_rows(part, vit_cfg.image_size, I.fused_preprocess), id_key: np.asarray(part_ids, np.int64),
                   "n_valid": np.int32(n_valid)}

    counters = (attn_mod.attention, attn_mod.attention_splitk, I.fused_preprocess, T.bucket_max_scores,
                T.bucket_max_scores_i8, T.bucket_max_scores_i8b)
    for fn in counters:
        fn.launches = 0
    zero_standalone()
    t0 = time.perf_counter()
    embed_step = make_embed_step(model)
    embed_dir = os.path.join(root, "embed", expt)
    embed_and_save(embed_step, data, shape, embed_dir, make_batches)
    torch.cuda.synchronize()
    t_embed = time.perf_counter() - t0
    k1, k10, k7 = attn_mod.attention.launches, attn_mod.attention_splitk.launches, I.fused_preprocess.launches
    if ff:
        # With seeded weights the text-only rows (a black image under cross-attention) collapse: their
        # embeddings' pairwise cosine is 0.9999 in fp32 as in bf16, below what a bf16 pool resolves, so
        # a text-only copy ties its neighbours.  The copies that carry an image are held to the top 10.
        has_image = lambda c: data["cands"][c][1] is not None  # noqa: E731
        retrieve_and_check(root, expt, shape.embed_dim, data, "blip_ff", ("int8", "int8_bucket", "bf16"), has_image)
    else:
        retrieve_and_check(root, expt, shape.embed_dim, data, "blip")
    k2, k4, k11 = T.bucket_max_scores.launches, T.bucket_max_scores_i8.launches, T.bucket_max_scores_i8b.launches
    log(f"{tag} path: embed {t_embed:.2f} s (host clock, {n_batches} batches of {BATCH}, seeded images made on the host); "
        f"launches K7={k7} K1={k1} K10={k10} K2={k2} K4={k4} K11={k11}; expected K7 = {n_batches} (one a batch), K1 = "
        f"{n_batches} x {k1_blocks} (" + ("every ViT block" if ff else "the trimmed last block takes the einsum path")
        + "; so does MED), K10 = 0 (L = 197)")
    check(k7 == n_batches and k1 == n_batches * k1_blocks and k10 == 0,
          f"K7 / K1 / K10 launched {k7} / {k1} / {k10} times on the {tag} path")
    check(k2 > 0 and k4 > 0 and (k11 > 0) == ff, f"the sweeps were launched K2={k2} K4={k4} K11={k11} times on the {tag} path")
    for kernel, n in (("K7", k7), ("K1", k1), ("K2", k2), ("K4", k4), ("K11", k11)):
        results[kernel]["launches"] += n
    read_standalone(results, tag)
    log_candidate_spread(embed_dir)
    cand_emb = torch.from_numpy(np.load(os.path.join(embed_dir, "cand_pool", "mbeir_mscoco_task0_cand_pool_embed.npy"))).float()
    cand_emb = torch.nn.functional.normalize(cand_emb, dim=1)
    for kind, kind_name in enumerate(("text only", "image only", "image + text")):
        rows = cand_emb[kind::3]
        sims = (rows @ rows.T)[~torch.eye(len(rows), dtype=torch.bool)]
        log(f"{tag} candidate embeddings, {kind_name}: off-diagonal cosine mean {sims.mean():.6f} min {sims.min():.6f}")

    # the same 8 candidates through K7 and K1, and through their twins
    small_items = data["cands"][:8]
    with_kernels = embed_step(blip_rows(small_items, vit_cfg.image_size, I.fused_preprocess)).float()
    layers.attention = attn_mod.attention_twin
    try:
        plain = embed_step(blip_rows(small_items, vit_cfg.image_size, I.fused_preprocess_reference)).float()
    finally:
        layers.attention = attn_mod.attention
    cos = torch.nn.functional.cosine_similarity(with_kernels, plain, dim=1).min().item()
    log(f"{tag} embeddings through K7 + K1 vs through their twins (8 candidates): min cosine {cos}")
    check(cos >= 0.999, f"{tag} embeddings through the kernels disagree with the plain path")

    # padding does not leak: other token ids under the 0 mask leave every row as it was
    rows = blip_rows(small_items, vit_cfg.image_size, I.fused_preprocess)
    txt = rows["txt_batched"]
    lengths = txt["attention_mask"].sum(1)
    noise = np.random.default_rng(SEED + 13).integers(1000, 30524, txt["input_ids"].shape).astype(np.int32)
    rows["txt_batched"] = {"input_ids": np.where(txt["attention_mask"] == 1, txt["input_ids"], noise),
                           "attention_mask": txt["attention_mask"]}
    leak = (embed_step(rows).float() - with_kernels).abs().max().item()
    log(f"{tag} padding: token lengths {lengths.tolist()} of {BLIP_MAX_LEN}; max abs change of the embeddings when "
        f"the ids under the padding mask change: {leak}")
    # a masked key's logit is -1e9 in fp32: its probability is exactly 0
    check(leak == 0.0, f"padding tokens leak into the {tag} embeddings")

    # one resident batch of image + text rows as model inputs on the card
    batch = model_inputs(blip_rows(data["cands"][2::3][:BATCH], vit_cfg.image_size, I.fused_preprocess), torch.device(DEVICE))
    with torch.inference_mode():
        fwd = cuda_ms(lambda: model(*batch), 3)
    log(f"{tag} forward of one resident image+text batch of {BATCH}, bf16: {fwd} ms = {BATCH / fwd * 1e3:.1f} pairs/s")
    if profile:
        profile_forward(model, batch, f"{tag} bf16")


# ------------------------------------------------ phase 4: CLIP-FF serving

FF_EXPT = "CLIP_FF/Large/Seeded"  # + "-splitk/" or "-k1/"
# configs/clip_ff/large/train/inbatch/inbatch.yaml: t5_learning_rate, seed (its learning_rate is TRAIN_LR)
FF_T5_LR, FF_SEED = 1e-4, 2023
FF_TRAIN_BATCHES, FF_REMAT_BATCHES = 4, 2


def build_clip(name: str, splitk: bool = False, seed: int = SEED, train: bool = False, **model):
    """A seeded CLIP retriever at ViT-L/14 (bf16) through the registry, with
    a BPE merges file for its tokenizer (the batches here are hash-tokenised)
    and `UNIIR_ATTN_SPLITK` set for the build, where it is read."""
    from uniir_tpu_torch.core.config import Config
    from uniir_tpu_torch.models.registry import build_model_from_config

    merges = os.path.join(str(WORK), "merges.txt")
    with open(merges, "w") as f:
        f.write("#version: 0.2\nt h\nth e\n")
    config = Config.from_dict({"uniir_dir": str(WORK), "seed": seed, "model": {
        "name": name, "clip_vision_model_name": MODEL, "clip_bpe_path": merges, **model}})
    saved = os.environ.get("UNIIR_ATTN_SPLITK")
    os.environ["UNIIR_ATTN_SPLITK"] = "1" if splitk else "0"
    try:
        return build_model_from_config(config, device=DEVICE, train=train)
    finally:
        os.environ.pop("UNIIR_ATTN_SPLITK", None) if saved is None else os.environ.__setitem__("UNIIR_ATTN_SPLITK", saved)


def drive_clip_ff_path(results: dict, data: dict, profile: bool = False) -> None:
    """CLIP-FF serving at full width and depth through the registry, the
    embedder's loop, the index and retrieval over three pool types: once
    with `UNIIR_ATTN_SPLITK=1` (the vision tower through K10) and once
    without (every block through K1)."""
    from uniir_tpu_torch.models import layers
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.ops import topk as T
    from uniir_tpu_torch.train.steps import make_embed_step

    root = str(WORK)
    cfg = CLIP_CONFIGS[MODEL]
    write_qrels(root, data)
    n_batches = -(-N_CANDS // BATCH) + -(-N_QUERY_PAIRS // BATCH)
    embeds, forwards = {}, {}
    for splitk in (True, False):
        tag = "splitk" if splitk else "k1"
        t0 = time.perf_counter()
        bundle = build_clip("CLIPFeatureFusion", splitk)
        model = bundle.model
        torch.cuda.synchronize()
        t5 = model.t5_layers.cfg
        log(f"CLIP-FF path ({tag}): seeded CLIP-FF {MODEL} bf16 ({cfg.vision_layers} + {cfg.text_layers} blocks, T5 "
            f"{t5.num_layers} layers, d_model {t5.d_model}, {t5.num_heads} heads; {sum(p.numel() for p in model.parameters())} "
            f"parameters) through build_model_from_config in {time.perf_counter() - t0:.1f} s, UNIIR_ATTN_SPLITK={int(splitk)}")
        counters = (attn_mod.attention, attn_mod.attention_splitk, T.bucket_max_scores, T.bucket_max_scores_i8,
                    T.bucket_max_scores_i8b)
        for fn in counters:
            fn.launches = 0
        zero_standalone()
        expt = f"{FF_EXPT}-{tag}/"
        t0 = time.perf_counter()
        embed_step = make_embed_step(model)
        embeds[tag] = embed_and_save(embed_step, data, cfg, os.path.join(root, "embed", expt))
        torch.cuda.synchronize()
        t_embed = time.perf_counter() - t0
        k1, k10 = attn_mod.attention.launches, attn_mod.attention_splitk.launches
        retrieve_and_check(root, expt, cfg.embed_dim, data, f"clip_ff_{tag}", ("int8", "int8_bucket", "bf16"))
        k2, k4, k11 = T.bucket_max_scores.launches, T.bucket_max_scores_i8.launches, T.bucket_max_scores_i8b.launches
        want = (n_batches * cfg.text_layers, n_batches * cfg.vision_layers) if splitk else \
            (n_batches * (cfg.vision_layers + cfg.text_layers), 0)
        log(f"CLIP-FF path ({tag}): embed {t_embed:.2f} s (host clock, {n_batches} batches of {BATCH}); launches K1={k1} "
            f"K10={k10} K2={k2} K4={k4} K11={k11}; expected K1, K10 = {want} ({n_batches} batches x "
            f"{cfg.text_layers} text + {cfg.vision_layers} vision blocks, none trimmed)")
        check((k1, k10) == want, f"K1 / K10 launched {k1} / {k10} times on the CLIP-FF path ({tag}), expected {want}")
        check(k2 > 0 and k4 > 0 and k11 > 0, f"a sweep was not launched on the CLIP-FF path ({tag}): K2={k2} K4={k4} K11={k11}")
        for name, n in (("K1", k1), ("K10", k10), ("K2", k2), ("K4", k4), ("K11", k11)):
            results[name]["launches"] += n
        read_standalone(results, f"CLIP-FF ({tag})")
        log_candidate_spread(os.path.join(root, "embed", expt))

        # the same forward through the plain twins (of K1, and of K10 where the flag is on), on a small batch
        small = collate(data["cands"][:8], data["dids"][:8], "did_list", cfg)
        small.pop("did_list"), small.pop("n_valid")
        with_kernel = embed_step(dict(small)).float()
        layers.attention = attn_mod.attention_twin
        try:
            plain = embed_step(dict(small)).float()
        finally:
            layers.attention = attn_mod.attention
        cos = torch.nn.functional.cosine_similarity(with_kernel, plain, dim=1).min().item()
        log(f"CLIP-FF embeddings through the kernels vs through their twins ({tag}, 8 candidates): min cosine {cos}")
        check(cos >= 0.999, f"CLIP-FF embeddings through the kernels disagree with the plain path ({tag})")
        forwards[tag] = forward_ms(model, cfg)
        log(f"CLIP-FF forward of one resident image+text batch of {BATCH}, bf16 ({tag}): {forwards[tag]} ms = "
            f"{BATCH / forwards[tag] * 1e3:.1f} pairs/s")
        if profile:
            profile_forward(model, resident_batch(cfg), f"CLIP-FF bf16 ({tag})")
        del model, bundle, embed_step
        torch.cuda.empty_cache()
    cos = np.concatenate([np.sum(embeds["splitk"][s_] * embeds["k1"][s_], 1)
                          / (np.linalg.norm(embeds["splitk"][s_], axis=1) * np.linalg.norm(embeds["k1"][s_], axis=1))
                          for s_ in ("cand_pool", "test")])
    log(f"CLIP-FF embeddings with K10 against without: per-row cosine min {cos.min():.6f} mean {cos.mean():.6f}; forward "
        f"{forwards['splitk']} ms with K10, {forwards['k1']} ms without")
    # 24 layers of attention outputs that may differ by a bf16 step; the direction of every embedding survives
    check(cos.min() >= 0.999, f"CLIP-FF embeddings with and without K10 disagree: min cosine {cos.min()}")


def profile_forward(model, batch, tag: str) -> None:
    """torch.profiler over 3 forwards of a resident batch: device time by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(*batch)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            model(*batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model(*batch)
            torch.cuda.synchronize()
    log(f"profile of the embed forward at batch {BATCH}, {tag}: forward_ms={wall * 1e3} "
        f"(host clock, without the profiler) = {BATCH / wall:.1f} pairs/s")
    log_device_time_by_group(prof, 3, wall * 1e3)


# -------------------------------------------------------------- phase 5: K3


def check_attention_bwd(results: dict) -> None:
    """K3: the one-block-a-head kernel and the general-length kernels against
    the twin and timed in turns (new, old, new) at the two shapes training
    uses; then the general kernels at a length only they take."""
    from uniir_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = {"K3": 0.0, "K3g": 0.0}
    shapes = {"vision": (BATCH, 257, 16, False), "text": (BATCH, 77, 12, True), "long": (8, 400, 16, False)}
    for tag, (B, L, H, causal) in shapes.items():
        q, k, v, do = (torch.randn(B, L, H * 64, generator=g, device="cuda").bfloat16() for _ in range(4))
        before = (A.attention_bwd.launches, A.attention_bwd_general.launches)
        out = A.attention_bwd(q, k, v, do, H, causal=causal)
        torch.cuda.synchronize()
        routed = (A.attention_bwd.launches - before[0], A.attention_bwd_general.launches - before[1])
        route = A.backward_route(64, L)
        check(routed == ((1, 0) if route == "fused" else (0, 1)), f"attention_bwd at L={L} launched {routed}, route {route}")
        ref = A.attention_bwd_reference(q, k, v, do, H, causal=causal)
        old = A.attention_bwd_general(q, k, v, do, H, causal=causal)
        for which, got in (("K3", out), ("K3g", old)):
            for name, o, r in zip(("dq", "dk", "dv"), got, ref):
                err, cos, top = (o.float() - r.float()).abs().max().item(), cosine(o, r), r.abs().max().item()
                log(f"{which} attention_bwd {tag} [{B},{L},{H * 64}] H={H} causal={causal} {name}: max_abs_err={err} "
                    f"cosine={cos} max_abs_ref={top}")
                # same rounding points as the twin; fp32 sums in another order can
                # flip a bf16 rounding of ds or of an output: ~2 ulps (2^-7 relative)
                check(err <= 1e-2 * max(1.0, top) and cos >= 0.9999, f"{which} {name} disagrees with its twin at {tag} shapes")
                if which == "K3g" or route == "fused":
                    worst[which] = max(worst[which], err)
        again = A.attention_bwd(q, k, v, do, H, causal=causal)
        check(all(torch.equal(a, b) for a, b in zip(out, again)), f"K3 is not deterministic at {tag} shapes")
        ms = cuda_ms(lambda: A.attention_bwd(q, k, v, do, H, causal=causal), 20)
        old_ms = cuda_ms(lambda: A.attention_bwd_general(q, k, v, do, H, causal=causal), 20)
        ms_again = cuda_ms(lambda: A.attention_bwd(q, k, v, do, H, causal=causal), 20)
        plain_ms = cuda_ms(lambda: A.attention_bwd_reference(q, k, v, do, H, causal=causal), 5)
        # the library call: the backward of F.scaled_dot_product_attention on the same tensors
        leaves = [t.view(B, L, H, 64).transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        sdpa = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=causal)
        g_heads = do.view(B, L, H, 64).transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(sdpa, leaves, g_heads, retain_graph=True), 20)
        del leaves, sdpa
        limit = bound(nbytes(q, k, v, do, *out), 10 * B * H * L * L * 64, BF16_OPS_PER_S)  # five L x L x D products a head
        log(f"K3 attention_bwd {tag} route={route}: kernel_ms={ms} / {ms_again} (general-length kernels between them: "
            f"{old_ms}) plain_ms={plain_ms} library_ms={library_ms} {limit}")
        if route == "fused":
            check(max(ms, ms_again) < old_ms, f"the one-block-a-head K3 is not faster than the general kernels at {tag} shapes")
        else:
            results["K3g"].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
        if tag == "vision":
            results["K3"].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
            # an independent oracle: fp32 autograd through the plain forward
            leaves = [t.float().requires_grad_() for t in (q, k, v)]
            oracle = torch.autograd.grad(A.attention_reference(*leaves, H, causal=causal), leaves, do.float())
            for name, o, r in zip(("dq", "dk", "dv"), out, oracle):
                err, cos = (o.float() - r).abs().max().item(), cosine(o, r)
                log(f"K3 {tag} {name} vs autograd through the plain forward: max_abs_err={err} cosine={cos}")
                # bf16 p and ds against fp32 ones: ~2^-8 relative per term
                check(err <= 6e-2 * max(1.0, r.abs().max().item()) and cos >= 0.999,
                      f"K3 {name} disagrees with autograd through the plain forward")
            del leaves, oracle
    for name, err in worst.items():
        results[name]["max_abs_err"] = err


# -------------------------------------- phases 7 and 8: the training paths


def train_setup(name: str, remat: bool = False, splitk: bool = False, seed: int = SEED):
    """(train state, train step) of a seeded CLIP retriever through the
    registry: CLIP-SF by configs/clip_sf/large/train/inbatch/inbatch.yaml (lr
    1e-5), CLIP-FF by configs/clip_ff/... (the T5 group at 1e-4 on its own
    cosine schedule, fusion dropout on)."""
    from uniir_tpu_torch.train.optimizer import make_clip_optimizer
    from uniir_tpu_torch.train.state import TrainState
    from uniir_tpu_torch.train.steps import make_clip_train_step

    ff = name == "CLIPFeatureFusion"
    model = build_clip(name, splitk, seed, train=True, remat=remat).model
    optimizer = make_clip_optimizer(model, TRAIN_LR, total_steps=1000, fusion_learning_rate=FF_T5_LR if ff else None)
    return TrainState(model, *optimizer), make_clip_train_step(model, with_dropout=ff, seed=FF_SEED)


def drive_train_path(results: dict, name: str) -> None:
    """Training of `name` (CLIPScoreFusion or CLIPFeatureFusion) through the
    registry, `make_clip_optimizer`, `make_clip_train_step` and
    `train_one_epoch`: 32 pairs, then CLIP-SF at the reference's 105 pairs
    with remat, CLIP-FF at 32 pairs with remat and UNIIR_ATTN_SPLITK=1 (K10
    forward, K3 backward)."""
    from uniir_tpu_torch.core.checkpoint import CHECKPOINT_FILE, load_train_checkpoint, save_train_checkpoint
    from uniir_tpu_torch.core.config import Config
    from uniir_tpu_torch.models import layers
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.train.engine import train_one_epoch
    from uniir_tpu_torch.train.steps import clip_loss, make_clip_eval_step, make_embed_step

    cfg = CLIP_CONFIGS[MODEL]
    ff = name == "CLIPFeatureFusion"
    rng = np.random.default_rng(SEED + (15 if ff else 3))
    # self-attention blocks through K1 (or K10) and K3 per step: CLIP-SF's pooled last block of each
    # tower attends from one row and stays plain; CLIP-FF's towers return every token, none trimmed
    vision, text = (cfg.vision_layers, cfg.text_layers) if ff else (cfg.vision_layers - 1, cfg.text_layers - 1)

    def train(bs: int, remat: bool, splitk: bool, n_batches: int):
        state, step = train_setup(name, remat, splitk)
        batches = [make_train_batch(rng, bs, cfg) for _ in range(n_batches + 1)]
        state, _ = step(state, batches.pop())  # warm-up: first-call set-up stays out of the times
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attn_mod.attention.launches = attn_mod.attention_splitk.launches = attn_mod.attention_bwd.launches = 0
        zero_standalone()
        config = Config.from_dict({"trainer_config": {"print_freq": n_batches}})
        t0 = time.perf_counter()
        state, stats = train_one_epoch(step, state, batches, 0, config)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / n_batches
        k1, k10, k3 = attn_mod.attention.launches, attn_mod.attention_splitk.launches, attn_mod.attention_bwd.launches
        peak = torch.cuda.max_memory_allocated()
        log(f"train {name} {MODEL} bs={bs} pairs ({2 * bs} rows) remat={remat} UNIIR_ATTN_SPLITK={int(splitk)} "
            f"dropout={'on' if ff else 'none'}: {n_batches} steps, step_ms={step_s * 1e3} pairs_per_s={bs / step_s} "
            f"max_memory_allocated={peak} ({peak / 2**30:.2f} GiB); loss={stats['loss']} "
            f"inbatch_accuracy={stats['inbatch_accuracy']}; launches K1={k1} K10={k10} K3={k3}")
        check(np.isfinite(float(stats["loss"])), f"{name} train loss is not finite at bs={bs}")
        # remat recomputes each block's forward in the backward pass; with the flag the vision tower's forward is K10
        fwd = n_batches * (2 if remat else 1)
        want = (fwd * text, fwd * vision) if splitk else (fwd * (text + vision), 0)
        check((k1, k10) == want and k3 == n_batches * (vision + text),
              f"K1 / K10 / K3 launched {k1} / {k10} / {k3} times in {n_batches} {name} steps (remat={remat}, splitk={splitk})")
        for kernel, n in (("K1", k1), ("K10", k10), ("K3", k3)):
            results[kernel]["launches"] += n
        read_standalone(results, f"{name} training")
        return state, step

    state, step = train(TRAIN_BS, False, False, FF_TRAIN_BATCHES if ff else TRAIN_BATCHES)
    model = state.model

    # the learning rates, read back from the optimizer after the updates so far
    lrs = [g["lr"] for g in state.optimizer.param_groups]
    sizes = [sum(p.numel() for p in g["params"]) for g in state.optimizer.param_groups]
    log(f"{name} optimizer groups (decay / no decay" + (", T5 decay / no decay" if ff else "") + f"): lr={lrs} parameters={sizes}")
    check(lrs[0] == lrs[1] and 0.99 * TRAIN_LR < lrs[0] <= TRAIN_LR, "the backbone groups do not train at the config's rate")
    if ff:
        check(len(lrs) == 4 and lrs[2] == lrs[3] and abs(lrs[2] / lrs[0] - FF_T5_LR / TRAIN_LR) < 1e-6
              and sizes[2] + sizes[3] == sum(p.numel() for p in model.t5_layers.parameters()),
              "the T5 group does not train at its own learning rate")

    # the loss falls on one batch repeated: the steps' own losses, and the eval step's (deterministic:
    # CLIP-FF's dropout off) before and after them
    batch = make_train_batch(rng, TRAIN_BS, cfg)
    eval_step = make_clip_eval_step(model)
    before = float(eval_step(dict(batch))["loss"])
    losses = []
    for _ in range(REPEAT_STEPS):
        state, metrics = step(state, dict(batch))
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]
    after = float(eval_step(dict(batch))["loss"])
    log(f"{name} loss over {REPEAT_STEPS} steps on one batch of {TRAIN_BS} pairs: {losses}; eval loss {before} -> {after}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0] and after < before,
          f"the {name} loss does not fall on a repeated batch")

    # one step's loss and gradients through K1/K3 against the plain twins (CLIP-FF: under the same dropout draws)
    params = list(model.parameters())

    def loss_and_grads():
        if ff:
            model.t5_layers.train()
            model.t5_layers.set_dropout_generator(torch.Generator(device=DEVICE).manual_seed(FF_SEED + 1))
        out = clip_loss(model, batch)
        return out["loss"].item(), torch.autograd.grad(out["loss"], params)

    loss, grads = loss_and_grads()
    layers.attention = attn_mod.attention_twin
    try:
        ref_loss, ref_grads = loss_and_grads()
    finally:
        layers.attention = attn_mod.attention
    names = [n for n, _ in model.named_parameters()]
    # per-tensor cosine; a 0-d parameter's cosine is only its sign, so logit_scale (whose gradient
    # is near 0 at a loss of log 32) is held by its value instead
    coss = {i: cosine(g_, ref_grads[i]) for i, g_ in enumerate(grads) if g_.numel() > 1}
    scalars = {names[i]: (grads[i].item(), ref_grads[i].item()) for i in range(len(grads)) if i not in coss}
    finite = all(bool(torch.isfinite(g_).all()) for g_ in grads)
    worst = min(coss, key=coss.get)
    log(f"{name} train step through K1/K3 vs the twins: loss {loss} vs {ref_loss}, min gradient cosine {coss[worst]} "
        f"({names[worst]}) over {len(coss)} tensors, scalar gradients (kernels, twins) {scalars}, all gradients finite={finite}")
    # bf16 attention outputs and gradients that round in other places: each gradient's direction and the
    # loss (~log 32) survive
    check(finite and abs(loss - ref_loss) <= 1e-2 and coss[worst] >= 0.99
          and all(abs(a - b) <= 1e-3 for a, b in scalars.values()),
          f"{name} train-step gradients through K1/K3 disagree with the twins")
    del grads, ref_grads

    # checkpoint round trip, and the saved model serves through the registry
    path = save_train_checkpoint(str(WORK / "ckpt"), name.lower(), state, 0)
    fresh, _ = train_setup(name, seed=SEED + 1)
    fresh, epoch = load_train_checkpoint(path, fresh)
    same = all(torch.equal(p, q) for p, q in zip(model.parameters(), fresh.model.parameters()))
    a, b = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    same_opt = a["param_groups"] == b["param_groups"] and all(
        torch.equal(v, b["state"][i][key]) for i, st in a["state"].items() for key, v in st.items())
    log(f"{name} train checkpoint round trip: parameters bit-equal={same}, optimizer state bit-equal={same_opt}, "
        f"step {fresh.step}, epoch {epoch}")
    check(same and same_opt and fresh.step == state.step and epoch == 0, f"{name} train checkpoint round trip is not exact")
    del fresh
    served = build_clip(name, seed=SEED + 1, pretrained_torch_ckpt=os.path.join(path, CHECKPOINT_FILE)).model
    small = make_train_batch(rng, 4, cfg)
    emb = make_embed_step(served)(small).float()
    model.eval()  # CLIP-FF: the fusion dropout off, as the served model's
    emb_train = make_embed_step(model)(small).float()
    cos = torch.nn.functional.cosine_similarity(emb, emb_train, dim=1).min().item()
    log(f"the saved {name} model serves: embeddings {tuple(emb.shape)}, min cosine to the trained module's {cos}")
    check(emb.shape == (8, cfg.embed_dim) and bool(torch.isfinite(emb).all()) and cos >= 0.9999,
          f"the saved {name} train checkpoint does not serve")
    del state, step, model, params, served, eval_step
    shutil.rmtree(WORK / "ckpt", ignore_errors=True)
    torch.cuda.empty_cache()

    if ff:
        train(TRAIN_BS, True, True, FF_REMAT_BATCHES)
    else:
        train(REMAT_BS, True, False, REMAT_BATCHES)
    torch.cuda.empty_cache()


def profile_train_step(name: str) -> None:
    """torch.profiler over 3 train steps of TRAIN_BS pairs of `name`: device time by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    from uniir_tpu_torch.models.clip import CLIP_CONFIGS

    cfg = CLIP_CONFIGS[MODEL]
    state, step = train_setup(name)
    rng = np.random.default_rng(SEED + 4)
    batches = [make_train_batch(rng, TRAIN_BS, cfg) for _ in range(3)]
    state, _ = step(state, make_train_batch(rng, TRAIN_BS, cfg))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the step without the profiler's overhead
    for b in batches:
        state, _ = step(state, dict(b))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / len(batches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            state, _ = step(state, b)
        torch.cuda.synchronize()
    log(f"profile of a {TRAIN_BS}-pair {name} train step: step_ms={wall * 1e3} (host clock, without the profiler)")
    log_device_time_by_group(prof, len(batches), wall * 1e3)


PROFILE_GROUPS = {
    "K1 attention_fwd": ("attention_fused_fwd", "attention_fwd"), "K10 attention_splitk": ("attention_splitk",),
    "K3 attention_bwd": ("attention_fused_bwd", "attention_bwd"),
    "K5 int8_matmul": ("int8_matmul_kernel",), "K6 int8_mlp": ("int8_mlp_kernel",),
    "K7 preprocess": ("preprocess_kernel",),
    "GEMM": ("gemm", "xmma", "cutlass", "nvjet", "cublas"), "AdamW": ("multi_tensor", "adam"),
    "reduction / norm / softmax": ("reduce", "norm", "softmax"), "elementwise / copy": ("elementwise", "copy"),
    "host-to-device copy": ("memcpy htod",),
}


def log_device_time_by_group(prof, n_steps: int, wall_ms: float) -> None:
    """Device time per step of a torch.profiler run, by kernel group, and the device's idle share."""
    totals: dict = {}
    # device kernels and copies; record_function ranges would count their kernels twice
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    for e in rows:
        name = e.key.lower()
        group = next((g for g, keys in PROFILE_GROUPS.items() if any(k in name for k in keys)), "other")
        totals[group] = totals.get(group, 0.0) + e.self_device_time_total / 1e3 / n_steps
    busy = sum(totals.values())
    log(f"  device busy_ms={busy} (idle share {1 - busy / wall_ms:.4f})")
    for group, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        log(f"  {group}: {ms} ms per step ({ms / busy:.4f} of device time)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:25]:
        log(f"  {e.self_device_time_total / 1e3 / n_steps:10.3f} ms  x{e.count // n_steps:4d}  {e.key[:110]}")


def profile_embed_steps(int8_models: dict) -> None:
    """torch.profiler over 3 forwards of a resident image+text batch of
    BATCH rows, in bf16 and in each int8 mode: device time by kernel group."""
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import seeded_clip_sf

    cfg = CLIP_CONFIGS[MODEL]
    batch = resident_batch(cfg)
    models = {"bf16": seeded_clip_sf(cfg, DEVICE, seed=SEED, dtype=torch.bfloat16), **int8_models}
    for mode, model in models.items():
        profile_forward(model, batch, f"CLIP-SF mode {mode}")


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs the port's kernels on an NVIDIA GPU")
    if not (REPO / "uniir_tpu_torch").is_dir():
        fail(f"run from a checkout of the repo: {REPO / 'uniir_tpu_torch'} is missing")
    sys.path.insert(0, str(REPO))
    from uniir_tpu_torch import _build

    # the twins are the references: full fp32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {torch.cuda.get_device_name(0)}")
    names = ("attention", "attention_bwd", "topk", "int8_matmul", "int8_mlp", "preprocess")
    _build.build_all(names)  # one nvcc per source, all at once
    for name in names:
        _build.load(name)
        log(f"built {name}: {_build.build_seconds[name]:.1f} s\n{_build.ptxas_report(name)}")

    results = {
        "K1": {"name": "attention_fwd", "route": "cuda", "source": "uniir_tpu_torch/csrc/attention.cu",
               "replaces": "uniir_tpu/ops/attention_pallas.py:413"},
        "K2": {"name": "bucket_max_bf16", "route": "cuda", "source": "uniir_tpu_torch/csrc/topk.cu",
               "replaces": "uniir_tpu/ops/topk_pallas.py:118"},
        "K4": {"name": "bucket_max_i8", "route": "cuda", "source": "uniir_tpu_torch/csrc/topk.cu",
               "replaces": "uniir_tpu/ops/topk_pallas.py:291"},
        "K3": {"name": "attention_bwd", "route": "cuda", "source": "uniir_tpu_torch/csrc/attention_bwd.cu",
               "replaces": "uniir_tpu/ops/attention_pallas.py:652", "launches": 0},
        "K5": {"name": "int8_matmul", "route": "cuda", "source": "uniir_tpu_torch/csrc/int8_matmul.cu",
               "replaces": "uniir_tpu/ops/quant_pallas.py:145", "launches": 0},
        "K6": {"name": "int8_mlp", "route": "cuda", "source": "uniir_tpu_torch/csrc/int8_mlp.cu",
               "replaces": "uniir_tpu/ops/mlp_pallas.py:94", "launches": 0, "library_ms": None},
        "K7": {"name": "fused_preprocess", "route": "cuda", "source": "uniir_tpu_torch/csrc/preprocess.cu",
               "replaces": "uniir_tpu/ops/image_ops.py:106", "launches": 0},
        # K8 / K9 are stand-alone entry points, as in the JAX package: no model calls them, and
        # `read_standalone` holds their counts to 0 after every path
        "K8": {"name": "mha_nocausal", "route": "cuda", "source": "uniir_tpu_torch/csrc/attention.cu",
               "replaces": "uniir_tpu/ops/attention_pallas.py:55"},
        "K9": {"name": "mha_paired", "route": "cuda", "source": "uniir_tpu_torch/csrc/attention.cu",
               "replaces": "uniir_tpu/ops/attention_pallas.py:158"},
        "K10": {"name": "attention_splitk", "route": "cuda", "source": "uniir_tpu_torch/csrc/attention.cu",
                "replaces": "uniir_tpu/ops/attention_pallas.py:314", "launches": 0},
        # the general-length kernels of K1 / K3 (272 < L): timed at a length only they take; the static
        # route sends every length of the main paths to the one-block-a-head kernels, so `read_standalone`
        # holds their counts to 0 after every path
        "K1g": {"name": "attention_fwd_general", "route": "cuda", "source": "uniir_tpu_torch/csrc/attention.cu",
                "replaces": "uniir_tpu/ops/attention_pallas.py:413"},
        "K3g": {"name": "attention_bwd_general", "route": "cuda", "source": "uniir_tpu_torch/csrc/attention_bwd.cu",
                "replaces": "uniir_tpu/ops/attention_pallas.py:652"},
        "K11": {"name": "bucket_max_i8b", "route": "cuda", "source": "uniir_tpu_torch/csrc/topk.cu",
                "replaces": "uniir_tpu/ops/topk_pallas.py:254", "launches": 0},
    }
    check_attention(results)
    check_attention_splitk(results)
    check_attention_norm_first(results)
    check_preprocess(results)
    check_sweeps(results)
    check_int8_matmul(results)
    check_int8_mlp(results)
    data = smoke_dataset()
    drive_main_path(results, data)
    int8_models = drive_int8_path(results, data)  # adds its K1 launches to the bf16 serving path's
    if "--profile" in sys.argv[1:]:
        profile_embed_steps(int8_models)
    del int8_models
    torch.cuda.empty_cache()
    drive_clip_ff_path(results, data, profile="--profile" in sys.argv[1:])  # K10, K11; adds its K1 / K2 / K4 launches too
    del data  # the training phases read peak memory
    torch.cuda.empty_cache()
    for name in ("BLIPScoreFusion", "BLIPFeatureFusion"):  # add their K7 / K1 / K2 / K4 / K11 launches too
        drive_blip_path(results, name, profile="--profile" in sys.argv[1:])
        torch.cuda.empty_cache()
    check_attention_bwd(results)
    for name in ("CLIPScoreFusion", "CLIPFeatureFusion"):  # add their K1 / K10 / K3 launches too
        drive_train_path(results, name)
    if "--profile" in sys.argv[1:]:
        profile_train_step("CLIPScoreFusion")
        profile_train_step("CLIPFeatureFusion")
    for name in ("K10", "K11"):
        check(results[name]["launches"] > 0, f"kernel {name} was not launched on a main path")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s, kernel builds included")

    fields = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms")
    print(json.dumps({"kernels": [{f: r[f] for f in fields} for r in results.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
