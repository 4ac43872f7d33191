#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py            # from the repo root; needs one CUDA card

1. builds the port's kernels (uniir_tpu_torch/csrc, nvcc for sm_90a) from the
   checkout and checks each against its plain PyTorch twin at the shapes the
   serving paths give it: K1 attention at CLIP-L vision and text shapes, at
   BLIP's L = 197, the `base` configs' shapes (ViT-B/32 vision L = 50 and
   text L = 77 at width 512) and the main path's batch -- its
   one-block-a-head kernel and its general-length kernel both, timed in
   turns, and the general one also at L = 577, which only it takes -- K10
   (split-K attention) at the CLIP-L vision shape against its twin and
   against K1, its two kernels timed in turns and the general one also at
   l_valid = 385, and that the flag leaves L = 197 and the causal L = 77 to
   K1, K8 / K9 (the stand-alone `mha_nocausal` / `mha_paired`) at the BLIP,
   CLIP and `base` shapes, their two kernels timed in turns and the general
   one also at L = 577, K7 (fused
   image preprocessing) at uint8 [64, 256, 256, 3] -> 224 in both methods
   and output types -- its band kernel against the twin, bit-equal to its
   dense kernel, the two timed in turns band / dense / band -- K2 / K4 / K11
   sweeps at the main path's small pool, K11 on a pool cut inside a chunk's
   first rows, and on a seeded 5.6M x 768 pool K2, K4 and K11 at 256
   queries and at the search's batch of 1024 -- the TMA-fed wgmma kernel
   (its machine code checked for wgmma products fed by TMA and no mma.sync)
   and the general-width kernel both, timed in turns new / general / new --
   `topk` with the guard through K11 against brute force, and `topk` over
   one 1024-query batch at k = 50, bf16, int8 and int8_bucket with the
   guard, with the sweep's share of it,
   K5 (int8 matmul) at the CLIP-L projection shapes in its dynamic and
   static modes (beside `torch._int_mm` alone, and at the vision and text
   shapes its main loop's two tiles in turns) and at the int8 CLIP-FF /
   BLIP paths' shapes (T5 over 334 tokens, MED over 50 and its
   cross-attention's k / v over 197, the BLIP ViT-L/16, the heads and the
   pooler), K6 (fused int8 MLP) at the CLIP vision and text widths and at
   the BLIP ViT-L/16's with the exact GELU (beside K5 at its two product
   shapes), with times for kernel, twin and, where one PyTorch call
   computes the same function, that call (used nowhere in the port);
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
   the pools' ids and the copied candidates; then int8 CLIP-FF serving:
   calibrates the bf16 model on two batches (the towers' and the T5
   stack's entries), round-trips the .npz, builds the quantised model with
   `build_model_from_config` (`model.int8`) under UNIIR_INT8_BACKEND = xla
   (K5) and static (K5 + K6), embeds, indexes and retrieves, and checks
   the K1 / K5 / K6 counts against `expected_int8_model_launches`, the
   cosine to the bf16 embeddings, the copied candidates and the model
   through the twins of K5 / K6;
5. checks K3, the attention backward, against its twin at the CLIP-L vision
   and text shapes, the BLIP ViT-L's L = 197 and the `base` shapes (and
   against autograd through the
   plain forward): its
   one-block-a-head kernel and its general-length kernels both, timed in
   turns, and the general ones also at L = 400, which only they take;
6. drives BLIP-ScoreFusion serving at the full width and depth of
   `configs/blip_sf/large` (ViT-L/16, 24 blocks; MED, 12 layers) in bf16
   through `build_model_from_config`:
   seeded uint8 256 x 256 images go through K7's band kernel on the card (bicubic, bf16)
   into collated batches of 64 with hash token ids and padding masks of
   mixed lengths, then the embedder's loop, `create_index` and
   `run_retrieval` with the int8 and the bf16 pool -- and checks the K7 / K1
   launch counts against the depth (23 K1 a vision batch, none from MED),
   finite embeddings, agreement with the same model through the twins, that
   padding does not leak, that both pools return the same ids and that
   copied candidates are found; then BLIP-FeatureFusion `large` the same
   way through `build_model_from_config` (24 K1 a batch: the ViT's token
   output feeds MED's cross-attention; retrieval also through K11); after
   each, its int8 serving as CLIP-FF's above (MED's attention entries are
   triples; K6 runs with the exact GELU; K7 one a batch; BLIP-FF holds
   only image-bearing copies to the top 10);
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
   twins under the same dropout draws, and the checkpoint round trip;
9. drives BLIP-SF and BLIP-FF momentum-distillation training at `large` by
   configs/blip_{sf,ff}/large/train/inbatch/inbatch.yaml (queue 57960,
   momentum 0.995, alpha 0.4, lr 1e-5, wd 0.05; remat off for BLIP-SF, on
   for BLIP-FF) through `build_model_from_config(train=True)`,
   `MomentumTrainState`, `make_blip_train_step` (dropout on) and
   `train_one_epoch` at 40 pairs, then BLIP-FF at the reference's 115 pairs
   a card, and checks the K1 / K3 counts (46 / 23 a BLIP-SF step, 72 / 24 a
   BLIP-FF step with remat), a finite loss, the queue pointer, that the
   momentum twin moved and differs from the online model, and logs step
   time, pairs/s, peak memory and the device's idle share;
10. drives the retrieval tools over phase 2's index, embeddings and run
   files with phase 2's CLIP-SF (re-seeded, held to phase 2's embeddings)
   in a bundle built in code: one request of 16 text queries through the
   interactive retriever (K1, K2; its time split into embed, pool upload
   and sweep, and the upload and sweep again over a 5.6M x 768 host pool),
   held to `search_dense_index` over the same queries embedded through the
   twins; UniRAG's raw retrieval with complement pairs over the int8 pool
   (queries that copy the text candidates: K4 for them, K1 and K2 for the
   complement queries); hard-negative mining (k = 50, 10 a query; K2)
   against an fp32 search; and the error analyst over phase 2's run file;
11. drives the port over several processes on the one card through
   `parallel/multihost.py`'s launcher, each rank a process that loads the
   kernels built above: (a) one rank over NCCL (world size 1, its device
   `cuda:LOCAL_RANK`) runs phase 7's CLIP-SF step and is held to the
   one-process step on the same weights and batch (loss, each gradient and
   each parameter after the update within 1e-6 relative; bit-equality
   reported; its K1 / K3 counts equal), with an NCCL all-reduce of the
   gradients timed alone; (b) two ranks share the card over gloo (NCCL
   takes one rank a card): a probe of the collectives gloo takes on CUDA
   tensors, CLIP-SF at 16 + 16 pairs against the one-process 32-pair step
   (loss within 1e-3, gradient cosine >= 0.99, logit_scale's gradient within
   1e-3), BLIP-SF `large` at 20 + 20 pairs (dropout off) against the
   one-process 40-pair step (loss within 1e-3; queues equal on both ranks,
   queue_ptr 40), phase 2's candidates and queries embedded into part
   files (joined by rank 0: ids equal to phase 2's, cosine >= 0.9999, no
   part file left) with `create_index` and `run_retrieval` (the pool
   sharded, K2 on each half: phase 2's bf16 run-file ids), and
   `sharded_topk` over phase 1's pool, each rank drawing its 2.8M-row
   shard from the pool's seeds (ids those of phase 1's `topk` over the
   whole pool, each rank's sweep and the merge timed).

With `--profile` it also prints torch.profiler breakdowns, by kernel group,
of the 32-pair train steps (CLIP-SF, CLIP-FF, and CLIP-FF with remat and
UNIIR_ATTN_SPLITK=1), of the CLIP-SF embed step at
batch 64 in bf16 and in each int8 mode, and of the CLIP-FF, BLIP-SF and
BLIP-FF forwards at batch 64 in bf16 and in the static int8 mode.

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
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"
SEED = 0
POOL_ROWS, POOL_DIM, N_QUERIES = 5_600_000, 768, 256
# the search's query batch (retrieval/search.py) and the shipped retrieval.yaml's k
SEARCH_BATCH, SEARCH_K = 1024, 50
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
# BLIP training: the model and trainer sections of configs/blip_{sf,ff}/large/train/inbatch/inbatch.yaml
# (queue 57960, momentum 0.995, alpha 0.4, lr 1e-5, wd 0.05, seed 2023; tokenizer_max_length 50 / 100;
# vit_grad_ckpt false / true); 40 pairs divide the queue, and 115 pairs a card are the reference's
# 920 over 8 GPUs (57960 / 115 = 504)
BLIP_TRAIN = {"queue_size": 57960, "momentum": 0.995, "alpha": 0.4, "embed_dim": 768, "bf16": True, "vit": BLIP_SIZE}
BLIP_LR, BLIP_WD, BLIP_SEED = 1e-5, 0.05, 2023
BLIP_TRAIN_BS, BLIP_FF_BS, BLIP_TRAIN_BATCHES = 40, 115, 3
# the ViT's attention in those steps: both sides of every pair have an image row
BLIP_TRAIN_SHAPES = {f"blip train {bs} pairs": (2 * bs, 197, 16, False) for bs in (BLIP_TRAIN_BS, BLIP_FF_BS)}


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
    events).  The runs are queued behind a spinning kernel, so the host has
    them enqueued before the first one starts and a short kernel's time is
    the device's, not the rate Python launches at.  Where the host took
    longer to queue them than the spin lasted (a call whose host side is
    slow, as autograd's, or a pause of the host), the device may have waited
    for it: the runs are timed once more behind a spin half as long again as
    the host took.  If the host is slower than that spin too, it was waiting
    for the device, which was busy all along."""
    fn()
    torch.cuda.synchronize()
    spin = 5_000_000  # clocks: a few milliseconds
    for _ in range(2):
        spun, start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        spun.record()
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spin_ms = spun.elapsed_time(start)
        if host_ms < spin_ms:
            break
        spin = int(spin * min(1.5 * host_ms, 1000.0) / spin_ms)  # at most a second
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
    large models use, the BLIP ViT-L's at the two batches of its training
    phases, and the two of the `base` configs (ViT-B/32); then the general
    kernel at a length only it takes."""
    from uniir_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"K1": 0.0, "K1g": 0.0}
    shapes = {"vision": (BATCH, 257, 16, False), "text": (BATCH, 77, 12, True), "blip vision": (BATCH, 197, 16, False),
              **BLIP_TRAIN_SHAPES, "base vision": (BATCH, 50, 12, False), "base text": (BATCH, 77, 8, True),
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
    """K8 (`mha_nocausal`, [B, L, H, D]) and K9 (`mha_paired`, [B, L, H*D]):
    the normalise-first variant of the one-block-a-head kernel and the
    general-length kernel against their twin and timed in turns (new, old,
    new) at the BLIP, CLIP and `base` shapes; then the general kernel at a
    length only it takes."""
    from uniir_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    cases = [("K8", "blip vision", (BATCH, 197, 16, False)), ("K8", "clip vision", (BATCH, 257, 16, False)),
             ("K9", "blip vision", (BATCH, 197, 16, False)), ("K9", "clip vision", (BATCH, 257, 16, False)),
             ("K9", "clip text", (BATCH, 77, 12, True)), ("K8", "base vision", (BATCH, 50, 12, False)),
             # BLIP's length less the fourth query tile's 5 rows: what the partial tile costs at L = 197
             ("K9", "blip vision, whole tiles", (BATCH, 192, 16, False)),
             ("K9", "base text", (BATCH, 77, 8, True)), ("K8", "long", (8, 577, 16, False)),
             ("K9", "long", (8, 577, 16, False))]
    worst = {"K8": 0.0, "K9": 0.0, "K9g": 0.0}
    for name, tag, (B, L, H, causal) in cases:
        q, k, v = (torch.randn(B, L, H * 64, generator=g, device="cuda").bfloat16() for _ in range(3))
        if name == "K8":
            q4, k4, v4 = (t.view(B, L, H, 64) for t in (q, k, v))
            run, counter = (lambda: A.mha_nocausal(q4, k4, v4).view(B, L, H * 64)), A.mha_nocausal
        else:
            run, counter = (lambda: A.mha_paired(q, k, v, H, causal=causal)), A.mha_paired
        general = lambda: A.norm_first_general(q, k, v, H, causal=causal)
        before = (counter.launches, A.norm_first_general.launches)
        out = run()
        torch.cuda.synchronize()
        routed = (counter.launches - before[0], A.norm_first_general.launches - before[1])
        route = A.norm_first_route(64, L)
        check(routed == ((1, 0) if route == "fused" else (0, 1)), f"{name} at L={L} launched {routed}, route {route}")
        ref = A.attention_twopass_reference(q, k, v, H, causal=causal)
        old = general()
        err, cos = (out.float() - ref.float()).abs().max().item(), cosine(out, ref)
        old_err, old_cos = (old.float() - ref.float()).abs().max().item(), cosine(old, ref)
        ms = cuda_ms(run, 20)
        old_ms = cuda_ms(general, 20)
        ms_again = cuda_ms(run, 20)
        plain_ms = cuda_ms(lambda: A.attention_twopass_reference(q, k, v, H, causal=causal), 10)
        heads = [t.view(B, L, H, 64).transpose(1, 2) for t in (q, k, v)]
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*heads, is_causal=causal), 20)
        limit = bound(nbytes(q, k, v, out), 4 * B * H * L * L * 64, BF16_OPS_PER_S)
        log(f"{name} {tag} [{B},{L},{H}x64] causal={causal} route={route}: max_abs_err={err} cosine={cos} "
            f"kernel_ms={ms} / {ms_again} (general-length kernel between them: {old_ms}, max_abs_err={old_err} "
            f"cosine={old_cos}) plain_ms={plain_ms} library_ms={library_ms} {limit}")
        # the twin's rounding points; the fp32 row sum in another order, and one reciprocal a row where the
        # twin divides, can move a probability by one bf16 step: two bf16 steps of softmax-averaged outputs
        # below 1 (2 x 2^-8)
        check(err <= 8e-3 and cos >= 0.9999, f"{name} disagrees with its twin at {tag} shapes")
        check(old_err <= 8e-3 and old_cos >= 0.9999, f"the general-length {name} disagrees with its twin at {tag} shapes")
        if route == "fused":
            check(max(ms, ms_again) < old_ms, f"the one-block-a-head {name} is not faster than the general kernel at {tag} shapes")
            worst[name] = max(worst[name], err)
        worst["K9g"] = max(worst["K9g"], old_err)
        if tag == "blip vision":
            results[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
        if route == "general" and name == "K9":  # the general kernel's row: the length only it takes
            results["K9g"].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
    for name, err in worst.items():
        results[name]["max_abs_err"] = err


def check_attention_splitk(results: dict) -> None:
    """K10's one-block-a-head kernel and its general-length kernel against
    the twin and against K1 at the CLIP vision shape, timed in turns (new,
    K1, old, new); the general kernel at a valid length only it takes; and
    the flag's routing: lengths outside K10's condition launch K1."""
    from uniir_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    counters = (A.attention, A.attention_fwd_general, A.attention_splitk, A.attention_splitk_general)
    worst = {"K10": 0.0, "K10g": 0.0}
    for tag, (B, L, H) in {"vision": (BATCH, 257, 16), "long": (8, 385, 16)}.items():
        q, k, v = (torch.randn(B, L, H * 64, generator=g, device="cuda").bfloat16() for _ in range(3))
        route = A.splitk_route(64, L, L)
        before = [f.launches for f in counters]
        out = A.attention(q, k, v, H, splitk=True)
        torch.cuda.synchronize()
        routed = [f.launches - n for f, n in zip(counters, before)]
        check(routed == ([0, 0, 1, 0] if route == "fused" else [0, 0, 0, 1]),
              f"attention(splitk=True) at L = {L} launched (K1, K1g, K10, K10g) {routed}, route {route}")
        ref = A.attention_splitk_reference(q, k, v, H)
        k1 = A.attention(q, k, v, H)
        old = A.attention_splitk_general(q, k, v, H)
        err, cos = (out.float() - ref.float()).abs().max().item(), cosine(out, ref)
        err_k1, cos_k1 = (out.float() - k1.float()).abs().max().item(), cosine(out, k1)
        old_err, old_cos = (old.float() - ref.float()).abs().max().item(), cosine(old, ref)
        ms = cuda_ms(lambda: A.attention(q, k, v, H, splitk=True), 20)
        k1_ms = cuda_ms(lambda: A.attention(q, k, v, H), 20)
        old_ms = cuda_ms(lambda: A.attention_splitk_general(q, k, v, H), 20)
        ms_again = cuda_ms(lambda: A.attention(q, k, v, H, splitk=True), 20)  # one card, in turns
        plain_ms = cuda_ms(lambda: A.attention_splitk_reference(q, k, v, H), 10)
        heads = [t.view(B, L, H, 64).transpose(1, 2) for t in (q, k, v)]
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*heads), 20)
        limit = bound(nbytes(q, k, v, out), 4 * B * H * L * L * 64, BF16_OPS_PER_S)  # K1's bytes and operations
        log(f"K10 split-K attention {tag} [{B},{L},{H * 64}] H={H} route={route}: max_abs_err={err} cosine={cos}; "
            f"against K1 on the same input max_abs_diff={err_k1} cosine={cos_k1}; kernel_ms={ms} / {ms_again} (K1 "
            f"between them {k1_ms}, general-length K10 {old_ms}, max_abs_err={old_err} cosine={old_cos}) "
            f"plain_ms={plain_ms} library_ms={library_ms} {limit}")
        # the twin's rounding points, fp32 sums in another order: K1's limit, a couple of bf16 ulps of
        # outputs of magnitude < 4.  Against K1 only the last key's term rounds elsewhere (its score a
        # sum of bf16 products, its value term rounded on its own): the same few bf16 steps.
        check(err <= 3e-2 and cos >= 0.9999, f"K10 disagrees with its twin at the {tag} shape")
        check(err_k1 <= 3e-2 and cos_k1 >= 0.9999, f"K10 left K1's output at the {tag} shape")
        check(old_err <= 3e-2 and old_cos >= 0.9999, f"the general-length K10 disagrees with its twin at the {tag} shape")
        if route == "fused":
            check(max(ms, ms_again) < old_ms, f"the one-block-a-head K10 is not faster than the general kernel at {tag}")
            worst["K10"] = max(worst["K10"], err)
            results["K10"].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
        else:
            results["K10g"].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
        worst["K10g"] = max(worst["K10g"], old_err)
    for name, err in worst.items():
        results[name]["max_abs_err"] = err
    B = BATCH
    for tag, (L2, H2, causal) in {"blip vision": (197, 16, False), "text": (77, 12, True)}.items():
        q2, k2, v2 = (torch.randn(B, L2, H2 * 64, generator=g, device="cuda").bfloat16() for _ in range(3))
        before = (A.attention.launches, A.attention_splitk.launches)
        flagged = A.attention(q2, k2, v2, H2, causal=causal, splitk=True)
        torch.cuda.synchronize()
        routed = (A.attention.launches - before[0], A.attention_splitk.launches - before[1])
        same = torch.equal(flagged, A.attention(q2, k2, v2, H2, causal=causal))
        log(f"K10 routing with the flag on at {tag} L={L2} causal={causal}: launches (K1, K10)={routed}, equals K1's output={same}")
        check(routed == (1, 0) and same, f"the split-K flag did not leave {tag} shapes to K1")


def _off_path_kernels():
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.ops import image_ops as I
    from uniir_tpu_torch.ops import topk as T

    return (("K8", attn_mod.mha_nocausal), ("K9", attn_mod.mha_paired), ("K9g", attn_mod.norm_first_general),
            ("K1g", attn_mod.attention_fwd_general), ("K3g", attn_mod.attention_bwd_general),
            ("K10g", attn_mod.attention_splitk_general), ("K2g", T.bucket_max_scores_general),
            ("K4g", T.bucket_max_scores_i8_general), ("K11g", T.bucket_max_scores_i8b_general),
            ("K7g", I.fused_preprocess_dense))


def zero_standalone() -> None:
    """K8 / K9 are stand-alone entry points, as in the JAX package, the
    general-length K1 / K3 / K8 / K9 / K10 serve lengths past 272, the
    general-width K2 / K4 / K11 widths past 768 / 1152, and K7's dense kernel
    the shapes whose band strip does not fit, which no model of these paths
    has: every path sets their counts to 0 with its own before it starts."""
    for _, fn in _off_path_kernels():
        fn.launches = 0


def read_standalone(results: dict, path: str) -> None:
    """Read their counts just after a path: no model calls K8 / K9, the
    static routes send every length of these paths (77, 197, 257) to the
    one-block-a-head K1 / K3 / K10, every width (768, 256) to the wgmma
    K2 / K4 / K11 and the BLIP paths' 256 -> 224 to K7's band kernel."""
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
    """K7 at the BLIP path's shape, uint8 [64, 256, 256, 3] -> 224, in both
    methods and output types: the band kernel (the route `fused_preprocess`
    takes here) against its twin, bit-equal to the dense kernel, and against
    the numpy reference on a few images; the two timed in turns (band, dense,
    band)."""
    from uniir_tpu_torch.ops import image_ops as I

    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    B, S, O = BATCH, RAW_SIDE, 224
    img = torch.randint(0, 256, (B, S, S, 3), generator=g, device="cuda", dtype=torch.uint8)
    mean, std = (torch.from_numpy(v).cuda() for v in (I.CLIP_MEAN, I.CLIP_STD))
    dense_ops = B * 3 * 2 * (O * S * S + O * S * O)  # both products multiplied densely, as the dense kernel does
    worst = {"K7": 0.0, "K7g": 0.0}
    for method, dtype in (("bilinear", torch.float32), ("bicubic", torch.bfloat16)):
        # what the function needs: a multiply-add for each non-zero tap of this run's [O, S] matrix,
        # as A_h over the S columns of a plane and as A_w over the O rows of the intermediate
        taps = int(np.count_nonzero(I.resize_matrix(S, O, method)))
        ops = B * 3 * 2 * taps * (S + O)
        route = I.preprocess_route(S, S, O, method)
        before = (I.fused_preprocess.launches, I.fused_preprocess_dense.launches)
        out = I.fused_preprocess(img, O, method, dtype)
        dense = I.fused_preprocess_dense(img, O, method, dtype)
        torch.cuda.synchronize()
        check(route == "band" and (I.fused_preprocess.launches - before[0], I.fused_preprocess_dense.launches - before[1])
              == (1, 1), f"K7 at {S} -> {O} {method}: route {route}, launches band / dense not 1 / 1")
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        same = torch.equal(out.view(bits), dense.view(bits))
        ref = I.fused_preprocess_reference(img, O, method, dtype)
        err, err_g = (out.float() - ref.float()).abs().max().item(), (dense.float() - ref.float()).abs().max().item()
        numpy_ref = torch.from_numpy(I.preprocess_reference_numpy(img[:4].cpu().numpy(), O, method)).cuda()
        err_np = (out[:4].float() - numpy_ref).abs().max().item()
        ms = cuda_ms(lambda: I.fused_preprocess(img, O, method, dtype), 20)
        dense_ms = cuda_ms(lambda: I.fused_preprocess_dense(img, O, method, dtype), 20)
        ms_again = cuda_ms(lambda: I.fused_preprocess(img, O, method, dtype), 20)
        plain_ms = cuda_ms(lambda: I.fused_preprocess_reference(img, O, method, dtype), 10)
        library_ms = cuda_ms(lambda: library_preprocess(img, O, method, mean, std, dtype), 10)
        # the band kernel reads the band of each matrix (first index and taps a row), the dense one each
        # whole [O, S] fp32 matrix
        limit = bound(nbytes(img, out, *I._bands(S, S, O, method, str(img.device))), ops, FP32_OPS_PER_S)
        limit_g = bound(nbytes(img, out) + 2 * O * S * 4, ops, FP32_OPS_PER_S)
        log(f"K7 fused_preprocess uint8 [{B},{S},{S},3] -> {O} {method} {str(dtype).split('.')[-1]}: band kernel "
            f"max_abs_err={err} (dense kernel {err_g}; band bit-equal to dense: {same}) vs numpy reference (4 images)="
            f"{err_np} kernel_ms={ms} / {ms_again} (dense kernel between them {dense_ms} = "
            f"{dense_ops / dense_ms / 1e9:.2f} TFLOP/s fp32 of the {dense_ops / 1e9:.2f} GFLOP it multiplies; the "
            f"{taps} taps of a matrix need {ops / 1e9:.3f} GFLOP) plain_ms={plain_ms} library_ms={library_ms} "
            f"(F.interpolate antialias + normalise; other border taps) {limit} (dense kernel's {limit_g})")
        # against the twin, which has the kernels' arithmetic: the fp32 sums in another order move a
        # value below 4 by an fp32 step or two (2^-22 each), and in bf16 by at most one step (2^-6);
        # the numpy reference divides by 255 and std where the kernels multiply: atol 1e-4 on top
        tol = 2.0**-21 if dtype == torch.float32 else 2.0**-6
        check(err <= tol and err_g <= tol, f"K7 disagrees with its twin ({method}, {dtype}): band {err}, dense {err_g}")
        check(same, f"K7's band kernel is not bit-equal to its dense kernel ({method}, {dtype})")
        check(err_np <= tol + 1e-4, f"K7 disagrees with the numpy reference ({method}, {dtype}): {err_np}")
        check(max(ms, ms_again) < dense_ms, f"K7's band kernel is not faster than the dense kernel ({method}, {dtype})")
        worst = {"K7": max(worst["K7"], err), "K7g": max(worst["K7g"], err_g)}
        if method == "bicubic":  # the BLIP path's call
            results["K7"].update(ms=(ms + ms_again) / 2, plain_ms=plain_ms, library_ms=library_ms, **limit)
            results["K7g"].update(ms=dense_ms, plain_ms=plain_ms, library_ms=library_ms, **limit_g)
    for name, err in worst.items():
        results[name]["max_abs_err"] = err


# ----------------------------------------------------------- phase 1: K2 / K4

POOL_BLOCK = 350_000  # rows of the sweep pool drawn from one seed: 16 blocks, 8 for each rank of phase 11
PHASE1_TOPK: dict = {}  # phase 1's `topk` of the search's batch over the whole pool, for phase 11


def sweep_pool_rows(r0: int, r1: int) -> torch.Tensor:
    """Rows [r0, r1) of the seeded 5.6M x 768 sweep pool -- L2-normalised
    Gaussian rows, like index embeddings -- bf16 on the card, with zero rows
    to a CHUNK multiple.  Block b of POOL_BLOCK rows is drawn from its own
    seed, so a rank draws its shard alone (r0 a multiple of POOL_BLOCK)."""
    from uniir_tpu_torch.ops.topk import CHUNK

    out = torch.zeros((-(-(r1 - r0) // CHUNK) * CHUNK, POOL_DIM), dtype=torch.bfloat16, device="cuda")
    for b0 in range(r0, r1, POOL_BLOCK):
        g = torch.Generator(device="cuda").manual_seed(SEED + 1000 + b0 // POOL_BLOCK)
        rows = torch.randn(min(POOL_BLOCK, r1 - b0), POOL_DIM, generator=g, device="cuda")
        out[b0 - r0 : b0 - r0 + len(rows)] = torch.nn.functional.normalize(rows, dim=1).bfloat16()
    return out


def sweep_queries() -> torch.Tensor:
    """The search's batch of seeded unit queries for the sweep pool."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 999)
    return torch.nn.functional.normalize(torch.randn(SEARCH_BATCH, POOL_DIM, generator=g, device="cuda"), dim=1)


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


def check_sweep_machine_code() -> None:
    """The wgmma sweeps' machine code (`cuobjdump -sass` of the built
    library): K2's kernel multiplies with HGMMA (wgmma bf16), K4's and K11's
    with IGMMA (wgmma s8), all are fed by TMA (UTMALDG), and none holds an
    HMMA / IMMA (mma.sync)."""
    import re
    from collections import Counter

    from uniir_tpu_torch import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path("topk"))], capture_output=True, text=True,
                          check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split(":", 1)[1].strip()
            kernel = None
            if "bucket_max_wgmma_kernel" in name:
                kernel = "K11" if "I8Bucket" in name else ("K2" if "nv_bfloat16" in name else "K4")
            if kernel:
                counts[kernel] = Counter()
        elif kernel:
            counts[kernel].update(re.findall(r"\b(HGMMA|IGMMA|HMMA|IMMA|UTMALDG)\b", line))
    log(f"sweep machine code (SASS opcodes of bucket_max_wgmma_kernel): {dict((k, dict(v)) for k, v in counts.items())}")
    for kernel, product in (("K2", "HGMMA"), ("K4", "IGMMA"), ("K11", "IGMMA")):
        c = counts.get(kernel, Counter())
        check(c[product] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == c["IMMA"] == 0,
              f"{kernel}'s sweep kernel is not TMA-fed wgmma ({product}) without mma.sync: {dict(c)}")


def check_sweeps(results: dict) -> None:
    from uniir_tpu_torch.ops import topk as T

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # the main path's sweep: its queries against its 512-row pool (one chunk)
    small_q = torch.randn(N_QUERY_PAIRS, POOL_DIM, generator=g, device="cuda")
    small_pool = torch.randn(T.CHUNK, POOL_DIM, generator=g, device="cuda").bfloat16()
    err = (T.bucket_max_scores(small_q, small_pool, N_CANDS)
           - T.bucket_max_scores_reference(small_q, small_pool, N_CANDS)).abs().max().item()
    q_q, q_scale = T.quantize_queries(small_q)
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

    pool = sweep_pool_rows(0, POOL_ROWS)
    n_pad = pool.shape[0]
    all_queries = sweep_queries()
    pool_q, pool_scale = T.quantize_pool(pool)
    # K11's pool: the same rows with one scale per strided bucket; valid_n = 5.6M cuts the last chunk
    pool_qb, bucket_scale = T.quantize_pool(pool, per_bucket=True)
    log(f"sweep pool: [{POOL_ROWS}, {POOL_DIM}] bf16 padded to {n_pad} rows; {N_QUERIES} queries and the search's "
        f"batch of {SEARCH_BATCH}")
    sweep_ms = {}
    for n_q in (N_QUERIES, SEARCH_BATCH):
        queries = all_queries[:n_q]
        ops = 2 * n_q * POOL_ROWS * POOL_DIM
        iters, plain_iters = (5, 3) if n_q == N_QUERIES else (3, 1)
        q_q, q_scale = T.quantize_queries(queries)
        qb = queries.bfloat16()
        int8_args = (q_q, q_scale, pool_q, pool_scale, POOL_ROWS)
        i8b_args = (q_q, q_scale, pool_qb, bucket_scale, POOL_ROWS)
        kernels = (  # name, new wrapper, general wrapper, twin, error limit, library call, inputs, peak
            ("K2", lambda: T.bucket_max_scores(queries, pool, POOL_ROWS),
             lambda: T.bucket_max_scores_general(queries, pool, POOL_ROWS),
             lambda: T.bucket_max_scores_reference(queries, pool, POOL_ROWS), 1e-5,  # fp32 sums of 768 products of |x| < 1
             lambda: library_bucket_max(qb, pool, POOL_ROWS), (qb, pool), BF16_OPS_PER_S),
            ("K4", lambda: T.bucket_max_scores_i8(queries, pool_q, pool_scale, POOL_ROWS),
             lambda: T.bucket_max_scores_i8_general(queries, pool_q, pool_scale, POOL_ROWS),
             lambda: T.bucket_max_scores_i8_reference(*int8_args), 0.0,  # int8 sums are exact in both
             lambda: library_bucket_max(q_q, pool_q, POOL_ROWS, int8=(q_q, q_scale, pool_scale)),
             (queries, pool_q, pool_scale), INT8_OPS_PER_S),
            # through `bucket_max_scores_i8`, which hands over to K11 by the scales' shape
            ("K11", lambda: T.bucket_max_scores_i8(queries, pool_qb, bucket_scale, POOL_ROWS),
             lambda: T.bucket_max_scores_i8b_general(queries, pool_qb, bucket_scale, POOL_ROWS),
             lambda: T.bucket_max_scores_i8b_reference(*i8b_args), 0.0,  # exact integers, two rounded multiplies
             lambda: library_bucket_max_i8b(*i8b_args), (queries, pool_qb, bucket_scale), INT8_OPS_PER_S),
        )
        for name, new, general, twin, tol, library, inputs, peak in kernels:
            out = new()
            out_g = general()
            torch.cuda.synchronize()
            ref = twin()
            err, err_g = (out - ref).abs().max().item(), (out_g - ref).abs().max().item()
            check(err <= tol and err_g <= tol, f"{name} at {n_q} queries disagrees with its twin: new {err}, general {err_g}")
            if tol == 0.0:  # K4 and K11: bit-equal, NEG included
                check(torch.equal(out, ref) and torch.equal(out_g, ref), f"{name} at {n_q} queries is not bit-equal to its twin")
            del ref, out_g
            ms_new, ms_old, ms_new2 = cuda_ms(new, iters), cuda_ms(general, iters), cuda_ms(new, iters)
            plain = cuda_ms(twin, plain_iters)
            lib = cuda_ms(library, plain_iters)
            limit = bound(nbytes(*inputs, out), ops, peak)
            del out
            log(f"{name} sweep, {n_q} queries: max_abs_err={err} (general kernel {err_g}) kernel_ms={ms_new} / {ms_new2} "
                f"(general kernel between them {ms_old}; {ops / ms_new / 1e9:.1f} TOP/s) plain_ms={plain} "
                f"library_ms={lib} {limit}")
            sweep_ms[name, n_q] = ms_new
            if n_q == SEARCH_BATCH:  # the kernels line: the search's launch shape
                results[name].update(max_abs_err=err, ms=(ms_new + ms_new2) / 2, plain_ms=plain, library_ms=lib, **limit)
                results[name + "g"].update(max_abs_err=err_g, ms=ms_old, plain_ms=plain, library_ms=lib, **limit)
        log(f"K11 against K4 at {n_q} queries, the same pool bytes: {sweep_ms['K11', n_q]} / {sweep_ms['K4', n_q]} ms")
        torch.cuda.empty_cache()
    queries = all_queries[:N_QUERIES]

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

    # what a user of run_retrieval pays a batch: `topk` over the search's 1024 queries at the shipped
    # retrieval.yaml's k, bf16 and int8 with the guard (and the search's whole-batch re-run where it fails)
    reruns = {"int8": [], "int8_bucket": []}

    def search_batch(pool_name, quant):
        _, _, ok = T.topk(all_queries, pool, SEARCH_K, valid_n=POOL_ROWS, pool_quant=quant, with_guard=True)
        reruns[pool_name].append(not bool(ok.all()))
        if reruns[pool_name][-1]:
            T.topk(all_queries, pool, SEARCH_K, valid_n=POOL_ROWS)

    ms_b16 = cuda_ms(lambda: T.topk(all_queries, pool, SEARCH_K, valid_n=POOL_ROWS), 3)
    # the one-process search of the search's batch over the whole pool: phase 11's sharded search is held to it
    PHASE1_TOPK["scores"], PHASE1_TOPK["ids"] = (t.cpu() for t in T.topk(all_queries, pool, SEARCH_K, valid_n=POOL_ROWS))
    ms_b8 = cuda_ms(lambda: search_batch("int8", (pool_q, pool_scale)), 3)
    ms_b8b = cuda_ms(lambda: search_batch("int8_bucket", (pool_qb, bucket_scale)), 3)
    log(f"topk over one batch of {SEARCH_BATCH} queries, k={SEARCH_K}: bf16 {ms_b16} ms "
        f"({SEARCH_BATCH / ms_b16 * 1e3:.0f} queries/s; K2 sweep {sweep_ms['K2', SEARCH_BATCH] / ms_b16:.1%} of it), "
        f"int8 with the guard {ms_b8} ms ({SEARCH_BATCH / ms_b8 * 1e3:.0f} queries/s; K4 sweep "
        f"{sweep_ms['K4', SEARCH_BATCH] / ms_b8:.1%} of it; whole-batch exact re-runs {sum(reruns['int8'])} of "
        f"{len(reruns['int8'])}), int8_bucket with the guard {ms_b8b} ms ({SEARCH_BATCH / ms_b8b * 1e3:.0f} queries/s; "
        f"K11 sweep {sweep_ms['K11', SEARCH_BATCH] / ms_b8b:.1%} of it; whole-batch exact re-runs "
        f"{sum(reruns['int8_bucket'])} of {len(reruns['int8_bucket'])})")
    del pool, pool_q, pool_scale, pool_qb, bucket_scale, all_queries
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
    """`create_index`, then `run_retrieval` with each pool of `pool_dtypes`:
    the int8 pool (as shipped), where asked the per-bucket int8 pool (K11),
    and the last one, the bf16 pool where asked, which is the reference: all
    return its ids, and every query that copies a candidate finds it in its
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
    ref = pool_dtypes[-1]
    for dtype in pool_dtypes[:-1]:
        differ = [q for q in ids[ref] if ids[ref][q] != ids[dtype][q]]
        for q in differ[:3]:
            log(f"  {q} {ref}: {runs[ref][q]}\n  {q} {dtype}: {runs[dtype][q]}")
        check(not differ, f"{tag}: {dtype} and {ref} retrieval returned different ids for {len(differ)} queries")
    missing = [j for j, c in data["copied"].items() if f"9:{c}" not in ids[ref][f"9:{j}"]]
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


K5_MS: dict = {}  # K5's time by shape tag, for K6's comparison with its two products


def check_int8_matmul(results: dict) -> None:
    """K5 against its twin at the shapes int8 serving gives it at batch 64:
    vision M = 64 * 257, text M = 64 * 77, the trimmed last block M = 64;
    per-row (dynamic) and static scales, with and without bias, whole weights
    and column ranges (the thirds of the fused qkv projection).  At each
    shape `torch._int_mm` alone is timed beside it, and at the vision and
    text shapes the main loop's two tiles in turns (a, b, b, a)."""
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
    # the int8 CLIP-FF / BLIP paths' shapes: T5 over 77 + 257 tokens (bias-free), MED over 50 tokens and
    # its cross-attention's k / v over the ViT's 197, the BLIP ViT-L/16, the heads and pooler at M = 64
    MF, MM, MB = BATCH * 334, BATCH * BLIP_MAX_LEN, BATCH * 197
    new_cases = [("t5 q/k/v/o", MF, 768, 768, None), ("t5 wi", MF, 768, 3072, None), ("t5 wo", MF, 3072, 768, None),
                 ("med q/k/v/out", MM, 768, 768, None), ("med intermediate", MM, 768, 3072, None),
                 ("med output", MM, 3072, 768, None), ("med cross k/v", MB, 1024, 768, None),
                 ("blip vision qkv third", MB, 1024, 3072, (0, 1024)), ("blip vision out", MB, 1024, 1024, None),
                 ("blip vision fc1", MB, 1024, 4096, None), ("blip vision fc2", MB, 4096, 1024, None),
                 ("blip trimmed block k/v", MB, 1024, 3072, (1024, 3072)), ("pooler / text_proj", BATCH, 768, 768, None),
                 ("vision_proj", BATCH, 1024, 768, None)]
    cases += new_cases
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
        lo = 0 if cols is None else cols[0]
        ms = cuda_ms(lambda: Q.int8_matmul(xq, a_rows, wq, ws, bias, cols), 10)
        K5_MS[tag] = ms
        w_cols = wq[lo : lo + n]
        int_mm_ms = cuda_ms(lambda: torch._int_mm(xq, w_cols.T), 10) if M > 16 else None
        log(f"K5 int8_matmul {tag} M={M} K={K} N={n} (weight rows {N}): max_abs_err dynamic/static x bias/none={errs} "
            f"kernel_ms={ms} ({2 * M * K * n / ms / 1e9:.1f} TOP/s); torch._int_mm alone {int_mm_ms} ms")
        if tag.startswith("vision") or tag.startswith("text"):
            order = list(Q.INT8_TILES) + list(Q.INT8_TILES)[::-1]
            tiles = {name: [] for name in Q.INT8_TILES}
            for name in order:
                tiles[name].append(cuda_ms(
                    lambda: Q._launch_int8_matmul(xq, a_rows, wq, ws, bias, lo, n, Q.INT8_TILES[name]), 10))
            log(f"K5 {tag}: tiles of the main loop, ms in turns {order}: {tiles}")
        # exact integer sums, the same separately rounded fp32 epilogue: bit-equal bf16
        check(max(errs) == 0.0, f"K5 disagrees with its twin at {tag}")
        if tag == "vision fc1":
            plain_ms = cuda_ms(lambda: Q.int8_matmul_twin(xq, a_rows, wq, ws, bias), 3)
            library_ms = cuda_ms(lambda: library_int8_matmul(xq, a_rows, wq, ws, bias), 10)
            limit = bound(nbytes(xq, wq, a_rows, ws, bias) + 2 * M * N, 2 * M * K * N, INT8_OPS_PER_S)
            log(f"K5 {tag}: plain_ms={plain_ms} library_ms={library_ms} (torch._int_mm alone {int_mm_ms}) {limit}")
            results["K5"].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
        elif (tag, M, K, N, cols) in new_cases:
            # the operands this call reads (the weight rows of its column range) and its bf16 output
            plain_ms = cuda_ms(lambda: Q.int8_matmul_twin(xq, a_rows, wq, ws, bias, cols), 3)
            limit = bound(nbytes(xq, w_cols, a_rows) + 8 * n + 2 * M * n, 2 * M * K * n, INT8_OPS_PER_S)
            log(f"K5 {tag} M={M} K={K} N={n}: kernel_ms={ms} plain_ms={plain_ms} torch._int_mm alone {int_mm_ms} {limit}")
        del xq, wq
    results["K5"]["max_abs_err"] = worst


def check_int8_mlp(results: dict) -> None:
    """K6 against its twin at the CLIP vision and text widths and the BLIP
    ViT-L/16's (exact GELU, the activation it runs there) at batch 64, and
    the MLP module's two static routes (K6, or two K5 calls around a bf16
    hidden) timed beside each other, each in the activation of its model."""
    from uniir_tpu_torch.models.layers import MLP
    from uniir_tpu_torch.ops import mlp as M_
    from uniir_tpu_torch.ops import quant as Q

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst = 0.0
    both = ("quick_gelu", "gelu")
    for tag, M, W, acts in (("vision", BATCH * 257, 1024, both), ("text", BATCH * 77, 768, both),
                            ("blip vision", BATCH * 197, 1024, ("gelu",))):
        H = 4 * W
        h = (torch.randn(M, W, generator=g, device="cuda") * 0.5).bfloat16()
        res = torch.randn(M, W, generator=g, device="cuda").bfloat16()
        w1q, s1 = Q.quantize_weight(torch.randn(H, W, generator=g, device="cuda") * W**-0.5)
        w2q, s2 = Q.quantize_weight(torch.randn(W, H, generator=g, device="cuda") * H**-0.5)
        b1, b2 = torch.randn(H, generator=g, device="cuda") * 0.1, torch.randn(W, generator=g, device="cuda") * 0.1
        a1, a2 = float(h.float().abs().max()) / 127.0, 2.0 / 127.0  # a2 clips the hidden's top
        args = (h, res, w1q, s1, b1, w2q, s2, b2, a1, a2)
        for act in acts:
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
        act = acts[0]  # the model's: QuickGELU in CLIP, the exact GELU in BLIP's ViT
        ms = cuda_ms(lambda: M_.int8_mlp(*args, act=act), 10)
        plain_ms = cuda_ms(lambda: M_.int8_mlp_twin(*args, act=act), 3)
        # the two routes of the static MLP half-block, through the module the model calls
        routes = {}
        for route in ("fused", "xla"):
            mlp = MLP(W, H, quant=True, int8_mode="static", mlp_route=route, act=act).to(DEVICE)
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
        products = K5_MS[f"{tag} fc1"] + K5_MS[f"{tag} fc2"]
        log(f"K6 int8_mlp {tag} act={act}: kernel_ms={ms} ({4 * M * W * H / ms / 1e9:.1f} TOP/s) plain_ms={plain_ms} "
            f"MLP module static route fused (K6)={routes['fused']} ms, xla (two K5 + bf16 hidden)={routes['xla']} ms; "
            f"K5 at the fc1 and fc2 shapes together {products} ms (K6 over them: {ms - products} ms); "
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


def blip_batches(image_size: int):
    """`make_batches` for `embed_and_save` over BLIP items: collated batches
    of BATCH rows (the last one padded by repeating its last row), images
    through K7."""
    from uniir_tpu_torch.ops import image_ops as I

    def make_batches(items, ids, id_key, _cfg):
        for i in range(0, len(items), BATCH):
            part, part_ids = items[i : i + BATCH], list(ids[i : i + BATCH])
            n_valid = len(part)
            part = part + [part[-1]] * (BATCH - n_valid)  # pad_last: repeat the last row
            part_ids = part_ids + [part_ids[-1]] * (BATCH - n_valid)
            yield {**blip_rows(part, image_size, I.fused_preprocess), id_key: np.asarray(part_ids, np.int64),
                   "n_valid": np.int32(n_valid)}

    return make_batches


def blip_config(name: str, **model):
    """The registry config of a seeded BLIP `large` retriever, with a
    vocabulary file for its tokenizer (the batches here are hash-tokenised)."""
    from uniir_tpu_torch.core.config import Config

    root = str(WORK)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS) + "\n")
    return Config.from_dict({"uniir_dir": root, "seed": SEED, "model": {
        "name": name, "vit": BLIP_SIZE, "tokenizer_max_length": BLIP_MAX_LEN, "bert_vocab_path": vocab, **model}})


def drive_blip_path(results: dict, name: str, profile: bool = False) -> dict:
    """BLIP `large` serving through the registry, for `name` =
    BLIPScoreFusion (the last ViT block trimmed to CLS: 23 K1 a batch) or
    BLIPFeatureFusion (the ViT's token output into MED's cross-attention:
    all 24 blocks through K1; retrieval also with the per-bucket int8 pool,
    K11): uint8 images through K7, then index and retrieval.  Returns the
    seeded data it embedded."""
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

    t0 = time.perf_counter()
    bundle = build_model_from_config(blip_config(name), device=DEVICE)
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

    make_batches = blip_batches(vit_cfg.image_size)
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
    return data


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


# ---------------------------- phase 4b / 6b: int8 CLIP-FF, BLIP-SF and BLIP-FF serving

# the int8 model phases' modes: UNIIR_INT8_BACKEND, UNIIR_INT8_MLP and the least per-row cosine to
# the model's bf16 embeddings (as INT8_MODES'); `wonly` and static with UNIIR_INT8_MLP=xla are held
# by the CPU tests and the `-m gpu` cases
INT8_MODEL_MODES = {"xla": ("xla", "fused", 0.99), "static": ("static", "fused", 0.95)}


def expected_int8_model_launches(name: str, static: bool):
    """(K1, K5, K6) launches of one batch of a `large` int8 model, from the
    code: a full pre-LN block runs q, k, v, out, fc1, fc2 (6 K5), or q, k, v,
    out and one K6 under the static fused MLP; BLIP-SF's trimmed last ViT
    block q, k/v (one K5 over the fused weight's last two thirds), out, then
    the MLP, and its attention takes the einsum path (no K1); a MED layer
    runs query, key, value, output.dense (4 K5) for each attention and
    intermediate, output.dense (2 K5); T5 six K5 a block (no fused kernel
    for its relu FFN)."""
    per_block = 4 if static else 6
    if name == "CLIPFeatureFusion":  # 24 + 12 untrimmed tower blocks, two T5 blocks
        return 36, 36 * per_block + 2 * 6, 36 if static else 0
    if name == "BLIPScoreFusion":  # 23 ViT blocks + the trimmed one; MED text mode (12 x 6); two heads
        return 23, 23 * per_block + 3 + (per_block - 4) + 12 * 6 + 2, 24 if static else 0
    # BLIP-FF: 24 ViT blocks; MED self- and cross-attention and FFN (12 x 10); the pooler
    return 24, 24 * per_block + 12 * 10 + 1, 24 if static else 0


def drive_int8_model_path(results: dict, name: str, data: dict, profile: bool = False) -> None:
    """int8 serving of CLIP-FF (ViT-L/14, T5), BLIP-SF or BLIP-FF (`large`)
    through the port's entry points: calibrate the bf16 model on two seeded
    batches, round-trip the artifact through a file, then in each of
    INT8_MODEL_MODES `build_model_from_config` with `model.int8`, the
    embedder's loop, `create_index` and `run_retrieval` over the data the
    bf16 phase embedded; checks the K1 / K5 / K6 (and K7) counts against
    `expected_int8_model_launches`, the cosine to the bf16 phase's
    embeddings, the copied candidates, and the same model through the twins
    of K5 / K6 on 8 candidates."""
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import build_model_from_config
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.ops import calibrate as C
    from uniir_tpu_torch.ops import image_ops as I
    from uniir_tpu_torch.ops import mlp as M_
    from uniir_tpu_torch.ops import quant as Q
    from uniir_tpu_torch.ops import topk as T
    from uniir_tpu_torch.train.steps import make_embed_step, model_inputs

    root = str(WORK)
    blip = name.startswith("BLIP")
    tag = {"CLIPFeatureFusion": "CLIP-FF", "BLIPScoreFusion": "BLIP-SF", "BLIPFeatureFusion": "BLIP-FF"}[name]
    bf16_expt = {"CLIPFeatureFusion": f"{FF_EXPT}-k1/", "BLIPScoreFusion": BLIP_EXPT,
                 "BLIPFeatureFusion": "BLIP_FF/Large/Seeded/"}[name]
    write_qrels(root, data)
    n_batches = -(-N_CANDS // BATCH) + -(-N_QUERY_PAIRS // BATCH)
    bf16 = {split: np.load(os.path.join(root, "embed", bf16_expt, split,
                                        f"mbeir_mscoco_task0_{split}_embed.npy")).astype(np.float32)
            for split in ("cand_pool", "test")}
    if blip:
        from uniir_tpu_torch.models.blip_vit import BLIP_VIT_CONFIGS

        def build(**int8):
            return build_model_from_config(blip_config(name, **int8), device=DEVICE)

        image_size = BLIP_VIT_CONFIGS[BLIP_SIZE].image_size
        shape, make_batches = SimpleNamespace(embed_dim=768), blip_batches(image_size)
        rows = lambda items: blip_rows(items, image_size, I.fused_preprocess)  # noqa: E731
        # image + text rows: two probe batches, and the batch the bf16 phase timed
        both = data["cands"][2::3]
        *probes, timed = (model_inputs(rows(both[i : i + BATCH]), torch.device(DEVICE)) for i in (BATCH // 2, BATCH, 0))
        has_image = (lambda c: data["cands"][c][1] is not None) if name == "BLIPFeatureFusion" else None
    else:
        def build(**int8):
            return build_clip(name, **int8)

        shape, make_batches = CLIP_CONFIGS[MODEL], None
        rows = lambda items: {k: v for k, v in collate(items, [0] * len(items), "did_list", shape).items()  # noqa: E731
                              if k not in ("did_list", "n_valid")}
        *probes, timed = resident_batch(shape, seed=SEED + 8), resident_batch(shape, seed=SEED + 9), resident_batch(shape)
        has_image = None

    # calibrate the bf16 model (as the CLI does) on two seeded batches; the artifact goes through a file
    floats = build().model
    t0 = time.perf_counter()
    scales = C.calibrate_act_scales(floats, probes, margin=1.1)
    calib_path = os.path.join(root, f"calib_{tag}.npz")
    C.save_act_scales(calib_path, scales)
    loaded = C.load_act_scales(calib_path)
    owners = sum(isinstance(m, Q.ActScales) for m in floats.modules())
    triples = sum(v.shape == (3,) for v in scales.values())
    check(set(loaded) == set(scales) and len(scales) == owners
          and all(np.array_equal(loaded[k], v) and np.isfinite(v).all() and (v > 0).all() for k, v in scales.items()),
          f"the {tag} calibration artifact does not round-trip")
    check(triples == {"CLIPFeatureFusion": 0, "BLIPScoreFusion": 12, "BLIPFeatureFusion": 24}[name],
          f"{tag} calibration: {triples} MED attention triples")
    log(f"{tag} int8 path: calibrated {len(scales)} entries ({triples} MED attention triples) on 2 batches of {BATCH} "
        f"in {time.perf_counter() - t0:.2f} s -> {os.path.basename(calib_path)}")
    del floats, probes

    saved_env = {k: os.environ.get(k) for k in ("UNIIR_INT8_BACKEND", "UNIIR_INT8_MLP")}
    counters = (attn_mod.attention, attn_mod.attention_splitk, Q.int8_matmul, M_.int8_mlp, I.fused_preprocess,
                T.bucket_max_scores, T.bucket_max_scores_i8, T.bucket_max_scores_i8b)
    try:
        for mode, (backend, route, min_cos) in INT8_MODEL_MODES.items():
            os.environ["UNIIR_INT8_BACKEND"], os.environ["UNIIR_INT8_MLP"] = backend, route
            t0 = time.perf_counter()
            model = build(int8=True, int8_calibration=calib_path).model
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            for fn in counters:
                fn.launches = 0
            zero_standalone()
            expt = f"{tag}/Large/SeededInt8-{mode}/"
            t0 = time.perf_counter()
            embed_step = make_embed_step(model)
            emb = embed_and_save(embed_step, data, shape, os.path.join(root, "embed", expt), make_batches)
            torch.cuda.synchronize()
            t_embed = time.perf_counter() - t0
            k1, k10, k5, k6, k7 = (attn_mod.attention.launches, attn_mod.attention_splitk.launches, Q.int8_matmul.launches,
                                   M_.int8_mlp.launches, I.fused_preprocess.launches)
            want = tuple(n_batches * n for n in expected_int8_model_launches(name, backend == "static"))
            log(f"{tag} int8 path mode={mode} (UNIIR_INT8_BACKEND={backend}, UNIIR_INT8_MLP={route}): build {t_build:.1f} s, "
                f"embed {t_embed:.2f} s (host clock, {n_batches} batches of {BATCH}); launches K1={k1} K10={k10} K5={k5} "
                f"K6={k6} K7={k7}; expected K1, K5, K6 = {want} ({n_batches} batches), K7 = {n_batches if blip else 0}")
            check((k1, k5, k6) == want and k10 == 0 and k7 == (n_batches if blip else 0),
                  f"{tag} int8 mode {mode}: K1 / K5 / K6 / K10 / K7 launched {k1} / {k5} / {k6} / {k10} / {k7} times, "
                  f"expected {want}, 0 and {n_batches if blip else 0}")
            for kernel, n in (("K1", k1), ("K5", k5), ("K6", k6), ("K7", k7)):
                results[kernel]["launches"] += n

            cos = np.concatenate([np.sum(emb[s_] * bf16[s_], 1) / (np.linalg.norm(emb[s_], axis=1) * np.linalg.norm(bf16[s_], axis=1))
                                  for s_ in ("cand_pool", "test")])
            log(f"{tag} int8 path mode={mode}: cosine to the bf16 path's embeddings min {cos.min():.5f} mean {cos.mean():.5f}")
            check(cos.min() >= min_cos, f"{tag} int8 embeddings (mode {mode}) left the bf16 path's: min cosine {cos.min()}")
            retrieve_and_check(root, expt, shape.embed_dim, data, f"{tag}_int8_{mode}", ("int8",), has_image)
            k2, k4, k11 = T.bucket_max_scores.launches, T.bucket_max_scores_i8.launches, T.bucket_max_scores_i8b.launches
            # K2 runs only where the int8 pool's guard sends a batch to its exact re-run
            check(k4 > 0 and k11 == 0, f"{tag} int8 mode {mode}: sweeps launched K2={k2} K4={k4} K11={k11} times")
            for kernel, n in (("K2", k2), ("K4", k4)):
                results[kernel]["launches"] += n
            read_standalone(results, f"{tag} int8 ({mode})")

            # the same int8 model through the plain twins of K5 / K6, on 8 candidates
            small = rows(data["cands"][:8])
            with_kernels = embed_step(dict(small)).float()
            kernels = (Q.int8_matmul, M_.int8_mlp)
            Q.int8_matmul, M_.int8_mlp = Q.int8_matmul_twin, M_.int8_mlp_plain
            try:
                plain = embed_step(dict(small)).float()
            finally:
                Q.int8_matmul, M_.int8_mlp = kernels
            cos = torch.nn.functional.cosine_similarity(with_kernels, plain, dim=1).min().item()
            log(f"{tag} int8 path mode={mode}: embeddings through K5 / K6 vs through their twins (8 candidates): min cosine {cos}")
            check(cos >= 0.999, f"{tag} int8 mode {mode}: embeddings through the int8 kernels disagree with the twins")

            with torch.inference_mode():
                fwd = cuda_ms(lambda: model(*timed), 3)
            log(f"{tag} int8 forward of one resident image+text batch of {BATCH}, mode {mode}: {fwd} ms = "
                f"{BATCH / fwd * 1e3:.1f} pairs/s")
            if profile and backend == "static":
                profile_forward(model, timed, f"{tag} int8 {mode}")
            del model, embed_step
            torch.cuda.empty_cache()
    finally:
        for k, v in saved_env.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


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
    the twin and timed in turns (new, old, new) at the three shapes training
    uses (CLIP-L vision and text, the BLIP ViT-L's L = 197: three whole
    64-row tiles and one of 5 rows, also at the two batches of the BLIP
    training phases) and the two of the `base` configs; then the general
    kernels at a length only they take."""
    from uniir_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = {"K3": 0.0, "K3g": 0.0}
    shapes = {"vision": (BATCH, 257, 16, False), "text": (BATCH, 77, 12, True), "blip vision": (BATCH, 197, 16, False),
              **BLIP_TRAIN_SHAPES, "base vision": (BATCH, 50, 12, False), "base text": (BATCH, 77, 8, True),
              "long": (8, 400, 16, False)}
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
        # the library call: the backward of F.scaled_dot_product_attention on the same tensors (autograd's
        # host side is slower than the backward's device time: `cuda_ms` lengthens its spin until the host
        # has queued the 20 calls before the first one starts)
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


# --------------------------------------------- phase 9: BLIP training


def make_blip_train_batch(rng, gen, bs: int, max_length: int, image_size: int) -> dict:
    """bs (query, positive) pairs of seeded BLIP train rows in the collator's
    layout: hash token ids with padding masks of mixed lengths, float images
    made on the card (the train loaders run the host transform, as the JAX
    package's do), mixed modality masks and the positives' dids."""
    n = 2 * bs
    texts = [" ".join(rng.choice(WORDS, size=rng.integers(3, max_length - 1))) for _ in range(n)]
    return {
        "txt_batched": bert_hash_tokenize(texts, max_length),
        "image_batched": torch.rand(n, image_size, image_size, 3, generator=gen, device=DEVICE),
        "txt_mask_batched": np.array([int(i % 3 != 1) for i in range(n)], np.int32),
        "image_mask_batched": np.array([int(i % 3 != 0) for i in range(n)], np.int32),
        "p_did_list": rng.integers(0, 2**31 - 1, bs).astype(np.int64),
    }


def drive_blip_train_path(results: dict, name: str) -> None:
    """BLIP momentum-distillation training of `name` (BLIPScoreFusion, or
    BLIPFeatureFusion) at `large` through `build_model_from_config(train=
    True)`, `make_blip_optimizer`, `MomentumTrainState`,
    `make_blip_train_step` (dropout on) and `train_one_epoch` (alpha warmed
    up in epoch 0): 40 pairs, then BLIP-FF at the reference's 115 pairs a
    card.  Remat as the configs set it: off for BLIP-SF, on for BLIP-FF.
    At each batch, one step's loss and gradients through K1 / K3 are held
    against the same step through the twins, under the same dropout draws."""
    from uniir_tpu_torch.core.config import Config
    from uniir_tpu_torch.models import layers
    from uniir_tpu_torch.models.registry import build_model_from_config
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.train.engine import train_one_epoch
    from uniir_tpu_torch.train.optimizer import make_blip_optimizer
    from uniir_tpu_torch.train.state import MomentumTrainState
    from uniir_tpu_torch.train.steps import blip_loss, make_blip_train_step

    ff = name == "BLIPFeatureFusion"
    tag = "BLIP-FF" if ff else "BLIP-SF"
    vocab = os.path.join(str(WORK), "vocab.txt")  # for the registry's tokenizer; the batches here are hash-tokenised
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS) + "\n")
    max_length = 100 if ff else 50
    config = Config.from_dict({"uniir_dir": str(WORK), "seed": BLIP_SEED, "model": {
        **BLIP_TRAIN, "name": name, "tokenizer_max_length": max_length, "bert_vocab_path": vocab, "vit_grad_ckpt": ff}})
    rng = np.random.default_rng(SEED + 21 + ff)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)

    def train(bs: int) -> None:
        t0 = time.perf_counter()
        bundle = build_model_from_config(config, device=DEVICE, train=True)
        model, extra = bundle.model, bundle.extra
        state = MomentumTrainState.create(model, *make_blip_optimizer(model, BLIP_LR, 1000, weight_decay=BLIP_WD),
                                          queue_size=extra["queue_size"], embed_dim=bundle.embed_dim,
                                          momentum=extra["momentum"])
        step = make_blip_train_step(model, seed=BLIP_SEED)
        torch.cuda.synchronize()
        vit_cfg, med_cfg = model.vit_cfg, model.med_cfg
        remat = model.visual_encoder.remat_from_layer > 0
        check(remat == ff and model.text_encoder.remat == ff, f"{tag}: remat is not as configs/{tag} train sets it")
        initial_m = [p.detach().clone() for p in state.model_m.parameters()]
        log(f"train {tag} large: seeded {name} (ViT-L/{vit_cfg.patch_size}, {vit_cfg.layers} blocks, L = "
            f"{(vit_cfg.image_size // vit_cfg.patch_size) ** 2 + 1}, drop-path {vit_cfg.drop_path_rate}; MED "
            f"{med_cfg.num_hidden_layers} layers, hidden {med_cfg.hidden_size}, {max_length} tokens; "
            f"{sum(p.numel() for p in model.parameters())} parameters, fp32 masters, bf16 compute) through "
            f"build_model_from_config(train=True) and MomentumTrainState (queue {extra['queue_size']}, momentum "
            f"{extra['momentum']}, alpha {extra['alpha']}) in {time.perf_counter() - t0:.1f} s")
        batches = [make_blip_train_batch(rng, gen, bs, max_length, vit_cfg.image_size) for _ in range(BLIP_TRAIN_BATCHES + 3)]
        state, _ = step(state, batches.pop(), extra["alpha"])  # warm-up: first-call set-up stays out of the times
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attn_mod.attention.launches = attn_mod.attention_splitk.launches = attn_mod.attention_bwd.launches = 0
        zero_standalone()
        t0 = time.perf_counter()
        state, stats = train_one_epoch(step, state, batches[:BLIP_TRAIN_BATCHES],
                                       0, Config.from_dict({"trainer_config": {"print_freq": BLIP_TRAIN_BATCHES}}),
                                       is_blip=True, alpha=extra["alpha"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / BLIP_TRAIN_BATCHES
        k1, k10, k3 = attn_mod.attention.launches, attn_mod.attention_splitk.launches, attn_mod.attention_bwd.launches
        peak = torch.cuda.max_memory_allocated()
        read_standalone(results, f"{tag} training")
        log(f"train {tag} large bs={bs} pairs ({2 * bs} rows) remat={remat} dropout=on: {BLIP_TRAIN_BATCHES} steps, "
            f"step_ms={step_s * 1e3} pairs_per_s={bs / step_s} max_memory_allocated={peak} ({peak / 2**30:.2f} GiB); "
            f"loss={stats['loss']} inbatch_accuracy={stats['inbatch_accuracy']}; launches K1={k1} K10={k10} K3={k3}")
        check(np.isfinite(float(stats["loss"])), f"{tag} train loss is not finite at bs={bs}")
        # self-attention blocks through K1 per forward: BLIP-SF's CLS-pooled last block attends from one row
        # and stays plain, BLIP-FF feeds every token to MED; MED's masked attention is an einsum.  A step runs
        # the momentum twin's forward, the online forward and, with remat, its recompute; K3 once a block
        blocks = vit_cfg.layers if ff else vit_cfg.layers - 1
        want = (BLIP_TRAIN_BATCHES * blocks * (3 if remat else 2), BLIP_TRAIN_BATCHES * blocks)
        log(f"  expected per step: K1 = {want[0] // BLIP_TRAIN_BATCHES} ({blocks} online + {blocks} momentum"
            + (f" + {blocks} recomputed" if remat else "") + f"), K3 = {blocks}, K10 = 0")
        check((k1, k3) == want and k10 == 0, f"K1 / K10 / K3 launched {k1} / {k10} / {k3} times in "
              f"{BLIP_TRAIN_BATCHES} {tag} steps (remat={remat})")
        for kernel, n in (("K1", k1), ("K3", k3)):
            results[kernel]["launches"] += n

        # the device's idle share: torch.profiler over two more steps, against the host time above
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for b in batches[BLIP_TRAIN_BATCHES:]:
                state, _ = step(state, b, extra["alpha"])
            torch.cuda.synchronize()
        log(f"profile of 2 {tag} train steps at {bs} pairs (step_ms={step_s * 1e3} from the run above):")
        log_device_time_by_group(prof, 2, step_s * 1e3)

        n_steps = 1 + BLIP_TRAIN_BATCHES + 2
        moved = any(not torch.equal(a, b) for a, b in zip(state.model_m.parameters(), initial_m))
        apart = any(not torch.equal(a, b) for a, b in zip(state.model_m.parameters(), state.model.parameters()))
        filled = int((state.queue_idx != -100).sum())
        log(f"{tag} train state after {n_steps} steps: step {state.step}, queue_ptr {state.queue_ptr} "
            f"(want {n_steps * bs % extra['queue_size']}), {filled} queue ids filled, params_m moved={moved}, "
            f"params_m differs from params={apart}, temp={state.model.temp.item()}")
        check(state.step == n_steps and state.queue_ptr == n_steps * bs % extra["queue_size"]
              and filled == n_steps * bs, f"{tag}: the queue did not advance by the steps' pairs")
        check(moved and apart, f"{tag}: the momentum twin did not move, or equals the online model")
        del initial_m, prof

        # the EMA over every parameter, in place (the port's), against the form that first makes a list of
        # the p * (1 - m) products, timed in turns
        pm, p, m = list(state.model_m.parameters()), list(model.parameters()), state.momentum

        def ema_with_products():
            torch._foreach_mul_(pm, m)
            torch._foreach_add_(pm, torch._foreach_mul(p, 1.0 - m))

        ema = [cuda_ms(state.momentum_update), cuda_ms(ema_with_products), cuda_ms(state.momentum_update)]
        n = sum(t.numel() for t in p)
        log(f"{tag} momentum_update over {n} fp32 parameters: ms={ema[0]} / {ema[2]} (with a product list between "
            f"them: {ema[1]}) {bound(3 * 4 * n, 3 * n, FP32_OPS_PER_S)}")
        del pm, p

        # one step's loss and gradients through K1 / K3 against the same step through the twins: the momentum
        # and online forwards (and BLIP-FF's recompute) at this batch's [2 bs, 197, 1024], dropout drawn alike
        params = list(model.parameters())

        def loss_and_grads():
            model.train()
            model.set_dropout_generator(torch.Generator(device=DEVICE).manual_seed(BLIP_SEED + 1))
            out = blip_loss(state, batches[0], extra["alpha"])
            return out["loss"].item(), torch.autograd.grad(out["loss"], params)

        before = (attn_mod.attention.launches, attn_mod.attention_bwd.launches)
        loss, grads = loss_and_grads()
        check((attn_mod.attention.launches - before[0], attn_mod.attention_bwd.launches - before[1])
              == (want[0] // BLIP_TRAIN_BATCHES, blocks), f"{tag}: the kernels' step did not go through K1 / K3")
        layers.attention = attn_mod.attention_twin
        try:
            ref_loss, ref_grads = loss_and_grads()
        finally:
            layers.attention = attn_mod.attention
        names = [k for k, _ in model.named_parameters()]
        largest = max(r.abs().max().item() for r in ref_grads)
        # MED's key biases have a true gradient of 0 (a constant over a query's logits): rounding noise on
        # both sides, held to 1 % of the largest gradient; temp, a scalar, by its value
        noise = {names[i]: max(g_.abs().max().item(), ref_grads[i].abs().max().item())
                 for i, g_ in enumerate(grads) if names[i].endswith("key.bias")}
        coss = {i: cosine(g_, ref_grads[i]) for i, g_ in enumerate(grads) if g_.numel() > 1 and names[i] not in noise}
        scalars = {names[i]: (grads[i].item(), ref_grads[i].item()) for i in range(len(grads)) if grads[i].numel() == 1}
        finite = all(bool(torch.isfinite(g_).all()) for g_ in grads)
        worst = min(coss, key=coss.get)
        log(f"{tag} train step at {bs} pairs through K1/K3 vs the twins: loss {loss} vs {ref_loss}, min gradient "
            f"cosine {coss[worst]} ({names[worst]}) over {len(coss)} tensors, largest key-bias gradient "
            f"{max(noise.values())} (largest gradient {largest}), scalar gradients (kernels, twins) {scalars}, "
            f"all gradients finite={finite}")
        # bf16 attention outputs and gradients that round in other places: each gradient's direction, the
        # loss and temp's gradient survive
        check(finite and abs(loss - ref_loss) <= 1e-2 and coss[worst] >= 0.99
              and max(noise.values()) <= 1e-2 * largest
              and all(abs(a - b) <= 1e-2 * max(1.0, abs(b)) for a, b in scalars.values()),
              f"{tag} train-step gradients through K1/K3 disagree with the twins at {bs} pairs")
        del state, step, model, bundle, batches, params, grads, ref_grads
        torch.cuda.empty_cache()

    train(BLIP_TRAIN_BS)
    if ff:
        train(BLIP_FF_BS)


# ------------------------------------------ phase 10: UniRAG and the retrieval tools

# the UniRAG run's queries (copies of the text candidates) and hard-negative mining's train split
RAG_DS, MINE_DS = "mscoco_rag", "mscoco_mine"
NUM_HARD_NEGS, MINE_K = 10, 50  # retrieval_config of every shipped retrieval.yaml
REQUEST_QUERIES = 16  # one interactive request: 8 text queries towards images, 8 towards texts


def tools_config(root: str, retrieval: dict = None, analysis: dict = None):
    """The phase's config, as `Config` objects are built from a yaml: the
    embedder's data and loader sections (the complement retriever's), and
    the retrieval or analysis section where given."""
    from uniir_tpu_torch.core.config import Config
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS

    size = CLIP_CONFIGS[MODEL].image_size
    d = {
        "uniir_dir": root, "mbeir_data_dir": os.path.join(root, "mbeir_data"), "experiment": {"path_suffix": EXPT},
        "data_config": {"image_size": f"{size}, {size}", "enable_query_instruct": False,
                        "query_instruct_path": "instructions/query_instructions.tsv"},
        "dataloader_config": {"batch_size": BATCH, "num_workers": 2},
    }
    if retrieval is not None:
        d["retrieval_config"] = {
            "qrel_dir_name": "qrels", "embed_dir_name": "embed", "index_dir_name": "index", "query_dir_name": "query",
            "candidate_dir_name": "cand_pool", "hard_negs_dir_name": "hard_negs", "write_to_tsv": True, **retrieval,
        }
    if analysis is not None:
        d["analysis_config"] = {"write_to_tsv": True, **analysis}
    return Config.from_dict(d)


def write_tools_tree(root: str, data: dict) -> list:
    """The M-BEIR files the phase reads, from phase 2's seeded items: the
    candidate pool's jsonl (image entries name files that are never opened:
    no query of the phase has an image), the query instructions, and for the
    analyst phase 2's queries with qrels whose tasks follow their modality.
    Returns the candidate entries."""
    from uniir_tpu_torch.data.dataset import save_jsonl

    mbeir = os.path.join(root, "mbeir_data")
    modality = {0: "text", 1: "image", 2: "image,text"}  # make_items' kinds
    cands = []
    for i, (txt, _, _, _) in enumerate(data["cands"]):
        entry = {"did": f"9:{i}", "modality": modality[i % 3]}
        entry.update({"txt": txt} if i % 3 != 1 else {})
        entry.update({"img_path": f"images/cand_{i}.jpg"} if i % 3 != 0 else {})
        cands.append(entry)
    save_jsonl(cands, os.path.join(mbeir, "cand_pool", "mbeir_mscoco_task0_cand_pool.jsonl"))
    os.makedirs(os.path.join(mbeir, "instructions"), exist_ok=True)
    with open(os.path.join(mbeir, "instructions", "query_instructions.tsv"), "w") as f:
        f.write("query_modality\tcand_modality\tdataset\tdataset_id\tprompt1\n")
        for qm in modality.values():
            for cm in modality.values():
                f.write(f"{qm}\t{cm}\tMSCOCO\t9\tfind the {cm} for this {qm}\n")
    queries = [{"qid": f"9:{j}", "query_modality": modality[j % 3], "query_txt": txt,
                "pos_cand_list": [f"9:{data['relevant'][j]}"], "neg_cand_list": []}
               for j, (txt, _, _, _) in enumerate(data["queries"])]
    save_jsonl(queries, os.path.join(mbeir, "test", "mbeir_mscoco_task0_test.jsonl"))
    task = {"text": 0, "image": 3, "image,text": 8}  # text -> image, image -> text, image,text -> image,text
    os.makedirs(os.path.join(mbeir, "qrels_analyst", "test"), exist_ok=True)
    with open(os.path.join(mbeir, "qrels_analyst", "test", "mbeir_mscoco_task0_test_qrels.txt"), "w") as f:
        f.writelines(f"{q['qid']} 0 {q['pos_cand_list'][0]} 1 {task[q['query_modality']]}\n" for q in queries)
    return cands


def tools_counters() -> dict:
    """The wrappers of the kernels phase 10 drives, by name."""
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.ops import topk as T

    return {"K1": attn_mod.attention, "K2": T.bucket_max_scores, "K4": T.bucket_max_scores_i8}


def zero_tools_counts() -> None:
    for fn in tools_counters().values():
        fn.launches = 0
    zero_standalone()


def read_tools_counts(results: dict, path: str, want: dict) -> dict:
    """The counts of a part of phase 10, just after it: held to `want` and
    added to the kernels' line; the off-path kernels held to 0."""
    launches = {name: fn.launches for name, fn in tools_counters().items()}
    read_standalone(results, path)
    check(launches == want, f"{path}: launches {launches}, expected {want}")
    for name, n in launches.items():
        results[name]["launches"] += n
    return launches


def synced_s(fn, repeats: int = 3) -> float:
    """Median host time of fn() with the card synchronised after it, in seconds."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def twin_embeds(retriever) -> np.ndarray:
    """The retriever's queries embedded with K1 swapped for its plain twin."""
    from uniir_tpu_torch.models import layers
    from uniir_tpu_torch.ops import attention as attn_mod

    layers.attention = attn_mod.attention_twin
    try:
        return retriever._embed_queries()
    finally:
        layers.attention = attn_mod.attention


def bf16_scores(embeds: np.ndarray, pool_embeds: np.ndarray) -> torch.Tensor:
    """fp32 scores of the L2-normalised queries against every pool row, both
    rounded to bf16 first, as the sweeps and `brute_force_topk` take them."""
    from uniir_tpu_torch.retrieval.index import normalize_l2

    q = torch.from_numpy(normalize_l2(embeds)).bfloat16().float()
    return q @ torch.from_numpy(pool_embeds).bfloat16().float().T


def path_sweeps(batches: list, pool_embeds: np.ndarray, valid_n: int, int8: bool = False) -> list:
    """K2 (with `int8`, K4 over the per-row int8 pool) on a phase-10 path's
    own query batches and pool, beside its twin: [(queries, max abs error,
    bit-equal)].  The path's query counts end in part-filled query blocks,
    which phase 1's counts fill exactly.  Called after the path's counts
    are read, so these launches are not counted."""
    from uniir_tpu_torch.ops import topk as T
    from uniir_tpu_torch.retrieval.index import normalize_l2

    pool, quant = T.prepare_pool(pool_embeds, DEVICE, int8=int8)
    out = []
    for batch in batches:
        q = torch.from_numpy(normalize_l2(batch)).to(DEVICE)
        if int8:
            got = T.bucket_max_scores_i8(q, *quant, valid_n)
            want = T.bucket_max_scores_i8_reference(*T.quantize_queries(q), *quant, valid_n)
        else:
            got, want = T.bucket_max_scores(q, pool, valid_n), T.bucket_max_scores_reference(q, pool, valid_n)
        out.append((len(batch), (got - want).abs().max().item(), torch.equal(got, want)))
    return out


def check_path_sweeps(path: str, batches: list, pool_embeds: np.ndarray, valid_n: int, int8: bool = False) -> None:
    """`path_sweeps`, logged and held to phase 1's limits: K2 within 1e-5, K4 bit-equal."""
    name = "K4" if int8 else "K2"
    sweeps = path_sweeps(batches, pool_embeds, valid_n, int8)
    log(f"{path}: {name} against its twin at the path's own query counts [(queries, max_abs_err, bit-equal)]: {sweeps}")
    check(all(eq if int8 else err <= 1e-5 for _, err, eq in sweeps),
          f"{path}: {name} disagrees with its twin at the path's own query counts")


def drive_interactive_retriever(results: dict, bundle, cfg, cands: list) -> None:
    """(a) One request of REQUEST_QUERIES text queries through the
    interactive retriever over phase 2's index: the candidates of an fp32
    search over the bf16 pool of the queries embedded through the plain
    twins (ties within the two embeddings' score difference aside); K1 and K2
    counted, and K2 held against its twin at the request's query count; the
    request's time split into embed, pool upload and sweep, and the upload
    and sweep again at the 5.6M pool's size."""
    from uniir_tpu_torch.data.registry import hash_did
    from uniir_tpu_torch.ops import topk as T
    from uniir_tpu_torch.retrieval.index import DenseIndex, normalize_l2
    from uniir_tpu_torch.retrieval.interactive import InteractiveRetriever

    root = str(WORK)
    index_path = os.path.join(root, "index", EXPT, "cand_pool", "mbeir_mscoco_task0_cand_pool.index")
    cands_path = os.path.join(root, "mbeir_data", "cand_pool", "mbeir_mscoco_task0_cand_pool.jsonl")
    retriever = InteractiveRetriever(index_path, cands_path, "MSCOCO", tools_config(root), bundle=bundle, device=DEVICE)
    rng = np.random.default_rng(SEED + 10)
    texts = [" ".join(rng.choice(WORDS, size=rng.integers(3, 12))) for _ in range(REQUEST_QUERIES)]
    retriever.add_queries([("text", t, None, "image" if j % 2 else "text") for j, t in enumerate(texts)])
    zero_tools_counts()
    t0 = time.perf_counter()
    got = retriever.retrieve(k=K)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    per_batch = cfg.vision_layers + cfg.text_layers - 2  # both towers a batch, each last block trimmed
    launches = read_tools_counts(results, "interactive retriever", {
        "K1": -(-REQUEST_QUERIES // BATCH) * per_batch, "K2": -(-REQUEST_QUERIES // 100), "K4": 0})
    log(f"interactive retriever: {REQUEST_QUERIES} text queries, first request {t_first:.3f} s; launches {launches}")
    index = DenseIndex.load(index_path)
    emb = retriever._embed_queries()
    check_path_sweeps("interactive retriever", [emb], index.embeds, index.ntotal)

    # one request again, then its parts as the retriever runs them
    q = torch.from_numpy(normalize_l2(emb)).to(DEVICE)
    t_request = synced_s(lambda: retriever.retrieve(k=K))
    t_embed = synced_s(retriever._embed_queries)
    t_batches = synced_s(lambda: list(retriever._query_loader()))  # the host's part: dataset, tokens, collation
    t_upload = synced_s(lambda: T.prepare_pool(index.embeds, DEVICE))
    pool, _ = T.prepare_pool(index.embeds, DEVICE)
    t_sweep = synced_s(lambda: T.topk(q, pool, K, valid_n=index.ntotal))
    log(f"interactive request ({REQUEST_QUERIES} queries, {index.ntotal}-row pool; host clock, synchronised, "
        f"median of 3): {t_request * 1e3:.3f} ms; embed {t_embed * 1e3:.3f} ms (of it the collated batches "
        f"{t_batches * 1e3:.3f} ms), pool upload {t_upload * 1e3:.3f} ms, sweep + top-k {t_sweep * 1e3:.3f} ms")

    # the same request's upload and sweep at the union pool's 5.6M rows (fp16 on the host, as a DenseIndex holds it)
    big = torch.nn.functional.normalize(
        torch.randn((POOL_ROWS, POOL_DIM), device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(SEED + 11)),
        dim=1).half().cpu().numpy()
    t_big_upload = synced_s(lambda: T.prepare_pool(big, DEVICE), repeats=1)
    big_pool, _ = T.prepare_pool(big, DEVICE)
    t_big_sweep = synced_s(lambda: T.topk(q, big_pool, K, valid_n=POOL_ROWS))
    big_request = t_embed + t_big_upload + t_big_sweep
    log(f"the same request over a {POOL_ROWS} x {POOL_DIM} pool: pool upload {t_big_upload * 1e3:.3f} ms "
        f"(bf16, one run), sweep + top-k {t_big_sweep * 1e3:.3f} ms (median of 3); the sum of the three parts, "
        f"each timed on its own, {big_request * 1e3:.3f} ms, the upload {t_big_upload / big_request:.4f} of it")
    del big, big_pool, pool
    torch.cuda.empty_cache()

    # the same queries through the plain twins, searched in fp32 over the bf16 pool
    plain = twin_embeds(retriever)
    cos = torch.nn.functional.cosine_similarity(torch.from_numpy(emb).float(), torch.from_numpy(plain).float(), dim=1)
    log(f"interactive queries through K1 vs through its twin: min cosine {cos.min().item()}")
    check(cos.min().item() >= 0.999, "interactive query embeddings through the kernel disagree with the plain path")
    ref_scores, ref_rows = brute_force_topk(torch.from_numpy(normalize_l2(plain)).to(DEVICE),
                                            torch.from_numpy(index.embeds).to(DEVICE).bfloat16(), index.ntotal, K)
    ids = torch.from_numpy(index.ids[ref_rows.cpu().numpy()])
    tie = 2 * (bf16_scores(emb, index.embeds) - bf16_scores(plain, index.embeds)).abs().max().item() + 1e-5
    got_ids = torch.tensor([[hash_did(c["did"]) for c in row] for row in got])
    by_did = {c["did"]: c for c in cands}
    hits = dict(Counter(c["modality"] for row in got for c in row))
    log(f"interactive retriever against the twins' fp32 search: {int((got_ids != ids).sum())} of "
        f"{got_ids.numel()} ranks differ, tie allowance {tie}; the hits' modalities {hits}")
    check(same_ranking(got_ids, ids, ref_scores.cpu(), tie),
          "the interactive retriever's candidates differ from the twins' search beyond ties")
    check(all(c == by_did[c["did"]] for row in got for c in row), "the retriever returned altered candidate entries")


def rag_candidates(cands: list) -> list:
    """The UniRAG run's candidate entries: `cands`, with every third text
    entry labelled an image (an img_path that is never opened; its pool row
    still holds the text's embedding).  Seeded weights put a text query near
    texts only, so these rows are the image hits its complement query can
    find."""
    out, n_text = [], 0
    for c in cands:
        if c["modality"] == "text":
            n_text += 1
            if n_text % 3 == 2:
                c = {"did": c["did"], "modality": "image", "img_path": f"images/rag_{c['did'].split(':')[1]}.jpg"}
        out.append(c)
    return out


def complement_query(cand: dict) -> tuple:
    """The complement query UniRAG sends for a text or image candidate."""
    return cand["modality"], cand.get("txt"), cand.get("img_path"), {"text": "image", "image": "text"}[cand["modality"]]


def check_complements(rows: list, kernel: np.ndarray, plain: np.ndarray, index, cands: list, k: int = 10) -> tuple:
    """Every complement of a UniRAG run's retrieved rows, against the rule
    applied to an fp32 search over the bf16 pool of the complement queries
    embedded through the plain twins: the first hit of the top k in the other
    modality that is not the row's query's own image or text, else None.
    Ties within the kernel and twin embeddings' score difference aside: a
    complement must be eligible, in the top k and the best eligible row, each
    up to that allowance, and None only where no eligible row is clearly in
    the top k.  `kernel` / `plain` are the complement queries' embeddings in
    the run's order.  Returns (every complement held, found, equal to the
    reference's choice, tie allowance)."""
    from uniir_tpu_torch.data.registry import unhash_did

    by_did = {c["did"]: c for c in cands}
    row_cands = [by_did[unhash_did(h)] for h in index.ids.tolist()]
    s = bf16_scores(plain, index.embeds)
    tie = 2 * (bf16_scores(kernel, index.embeds) - s).abs().max().item() + 1e-5
    held, found, exact, j = True, 0, 0, 0
    for row in rows:
        query = row["query"]
        pairs = [c for c in row["candidates"] if c["modality"] in ("text", "image")]
        held &= len(pairs) == len(row.get("complement_candidates", []))
        for cand, got in zip(pairs, row.get("complement_candidates", [])):
            want_modality = complement_query(cand)[3]
            eligible = torch.tensor([
                c["modality"] == want_modality and bool(
                    (c.get("img_path") and c.get("img_path") != query.get("query_img_path"))
                    or (c.get("txt") and c.get("txt") != query.get("query_txt")))
                for c in row_cands])
            scores = s[j]
            order = torch.argsort(scores, descending=True)[:k]
            kth = scores[order[-1]].item()
            best = scores[eligible].max().item() if eligible.any() else -float("inf")
            ref = next((row_cands[r] for r in order.tolist() if eligible[r]), None)
            if got is None:
                held &= best <= kth + tie
            else:
                r = next(i for i, c in enumerate(row_cands) if c["did"] == got["did"])
                held &= (got == row_cands[r] and bool(eligible[r]) and scores[r].item() >= kth - tie
                         and scores[r].item() >= best - tie)
                found += 1
            exact += got == ref
            j += 1
    return held and j == len(plain), found, exact, tie


def drive_raw_retrieval(results: dict, bundle, cfg, cands: list) -> None:
    """(b) UniRAG's retrieval.yaml (raw retrieval, image-text pairs, the int8
    pool) over queries that copy the text candidates' embeddings, Recall@1:
    each retrieves its own text candidate through K4, and each complement
    query is a text query (K1, then K2 over the bf16 pool).  The run reads
    the split-named candidate jsonl, `rag_candidates`, so that complements
    are found; each is held to the rule over the twins' search
    (`check_complements`), and K4 and K2 to their twins at the run's own
    query counts."""
    from uniir_tpu_torch.data.dataset import save_jsonl
    from uniir_tpu_torch.data.registry import hash_qid
    from uniir_tpu_torch.retrieval.eval import run_retrieval
    from uniir_tpu_torch.retrieval.index import DenseIndex
    from uniir_tpu_torch.retrieval.interactive import InteractiveRetriever

    root = str(WORK)
    mbeir = os.path.join(root, "mbeir_data")
    rag = rag_candidates(cands)
    rag_path = os.path.join(mbeir, "cand_pool", "mbeir_mscoco_task0_test_cand_pool.jsonl")
    save_jsonl(rag, rag_path)
    text_rows = [i for i, c in enumerate(rag) if c["modality"] == "text"]
    queries = [{"qid": f"9:{j}", "query_modality": "text", "query_txt": rag[i]["txt"],
                "pos_cand_list": [rag[i]["did"]], "neg_cand_list": []} for j, i in enumerate(text_rows)]
    save_jsonl(queries, os.path.join(mbeir, "query", "test", f"mbeir_{RAG_DS}_test.jsonl"))
    with open(os.path.join(mbeir, "qrels", "test", f"mbeir_{RAG_DS}_test_qrels.txt"), "w") as f:
        f.writelines(f"{q['qid']} 0 {q['pos_cand_list'][0]} 1 1\n" for q in queries)
    embed_dir = os.path.join(root, "embed", EXPT)
    cand_emb = np.load(os.path.join(embed_dir, "cand_pool", "mbeir_mscoco_task0_cand_pool_embed.npy"))
    np.save(os.path.join(embed_dir, "test", f"mbeir_{RAG_DS}_test_embed.npy"), cand_emb[text_rows])
    np.save(os.path.join(embed_dir, "test", f"mbeir_{RAG_DS}_test_ids.npy"),
            np.asarray([hash_qid(q["qid"]) for q in queries], np.int64))
    config = tools_config(root, retrieval={
        "results_dir_name": "results_unirag", "raw_retrieval": True, "retrieve_image_text_pairs": True,
        "pool_dtype": "int8",
        "test_datasets_config": {"enable_retrieve": True, "datasets_name": [RAG_DS],
                                 "correspond_cand_pools_name": ["mscoco_task0"], "correspond_qrels_name": [RAG_DS],
                                 "correspond_metrics_name": ["Recall@1"]},
    })
    zero_tools_counts()
    stats: list = []
    t0 = time.perf_counter()
    (row,) = run_retrieval(config, device=DEVICE, stats_out=stats, query_embedder_config=tools_config(root),
                           bundle=bundle)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    n = len(queries)
    per_batch = cfg.vision_layers + cfg.text_layers - 2
    launches = read_tools_counts(results, "raw retrieval", {
        "K1": -(-n // BATCH) * per_batch, "K2": -(-n // 100) + stats[0]["exact_reruns"], "K4": -(-n // SEARCH_BATCH)})
    with open(os.path.join(root, "results_unirag", EXPT, "retrieved_candidates",
                           f"mbeir_{RAG_DS}_single_pool_test_k1_retrieved.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    comps = [c for r in rows for c in r.get("complement_candidates", [])]
    log(f"raw retrieval with complements ({n} queries, int8 pool): {t_run:.3f} s; Recall@1={row['Recall@1']} "
        f"guard_pass_rate={stats[0]['guard_pass_rate']} exact_reruns={stats[0]['exact_reruns']}; launches {launches}")
    check(len(rows) == n, f"{len(rows)} retrieved rows for {n} queries")
    check(row["Recall@1"] == 1.0 and all([c["did"] for c in r["candidates"]] == q["pos_cand_list"]
                                          for r, q in zip(rows, queries)),
          "a query that copies a text candidate did not retrieve it first")
    check(len(comps) == n and all(c is None or c["modality"] == "image" for c in comps),
          "a text candidate's complement is not None or an image")

    # the complement queries again, through the kernels and through the twins
    index_path = os.path.join(root, "index", EXPT, "cand_pool", "mbeir_mscoco_task0_cand_pool.index")
    retriever = InteractiveRetriever(index_path, rag_path, "MSCOCO", tools_config(root), bundle=bundle, device=DEVICE)
    retriever.add_queries([complement_query(c) for r in rows for c in r["candidates"] if c["modality"] in ("text", "image")])
    kernel, plain = retriever._embed_queries(), twin_embeds(retriever)
    index = DenseIndex.load(index_path)
    held, found, exact, tie = check_complements(rows, kernel, plain, index, rag)
    log(f"complements found {found} of {len(comps)}; equal to the twins' fp32 search's choice {exact} of {len(comps)}, "
        f"the rest within the tie allowance {tie}: {held}")
    check(held and found > 0, "a complement breaks the rule over the twins' search, or none was found")
    check_path_sweeps("raw retrieval's main sweep", [cand_emb[text_rows]], index.embeds, index.ntotal, int8=True)
    check_path_sweeps("raw retrieval's complement pass", [kernel[i : i + 100] for i in range(0, len(kernel), 100)],
                      index.embeds, index.ntotal)


def drive_hard_negative_mining(results: dict, data: dict) -> None:
    """(c) Mining over a train split made of phase 2's queries and their
    embeddings: no mined negative is a positive, each list grew by
    NUM_HARD_NEGS, and the mined ids are those of an fp32 search of the same
    bf16 values, ties aside (`mined_negatives_held`); K2 counted, and held
    against its twin at the split's query count."""
    from uniir_tpu_torch.data.dataset import save_jsonl
    from uniir_tpu_torch.data.registry import unhash_did
    from uniir_tpu_torch.retrieval.hard_negs import run_hard_negative_mining
    from uniir_tpu_torch.retrieval.index import DenseIndex, normalize_l2

    root = str(WORK)
    modality = {0: "text", 1: "image", 2: "image,text"}
    queries = [{"qid": f"9:{j}", "query_modality": modality[j % 3], "query_txt": txt,
                "pos_cand_list": [f"9:{data['relevant'][j]}"],
                "neg_cand_list": [f"9:{(data['relevant'][j] + 1) % N_CANDS}"]}
               for j, (txt, _, _, _) in enumerate(data["queries"])]
    save_jsonl(queries, os.path.join(root, "mbeir_data", "train", f"mbeir_{MINE_DS}_train.jsonl"))
    embed_dir = os.path.join(root, "embed", EXPT)
    os.makedirs(os.path.join(embed_dir, "train"), exist_ok=True)
    q_emb = np.load(os.path.join(embed_dir, "test", "mbeir_mscoco_task0_test_embed.npy"))
    for kind, arr in (("embed", q_emb), ("ids", np.load(os.path.join(embed_dir, "test", "mbeir_mscoco_task0_test_ids.npy")))):
        np.save(os.path.join(embed_dir, "train", f"mbeir_{MINE_DS}_train_{kind}.npy"), arr)
    config = tools_config(root, retrieval={
        "num_hard_negs": NUM_HARD_NEGS, "k": MINE_K,
        "train_datasets_config": {"enable_retrieve": True, "datasets_name": [MINE_DS],
                                  "correspond_cand_pools_name": ["mscoco_task0"]},
    })
    zero_tools_counts()
    t0 = time.perf_counter()
    path = run_hard_negative_mining(config, device=DEVICE)
    torch.cuda.synchronize()
    t_mine = time.perf_counter() - t0
    launches = read_tools_counts(results, "hard-negative mining",
                                 {"K1": 0, "K2": -(-len(queries) // SEARCH_BATCH), "K4": 0})
    log(f"hard-negative mining ({len(queries)} queries, k={MINE_K}, {NUM_HARD_NEGS} a query): {t_mine:.3f} s; "
        f"launches {launches}")

    with open(path) as f:
        mined = [json.loads(line) for line in f]
    index = DenseIndex.load(os.path.join(root, "index", EXPT, "cand_pool", "mbeir_mscoco_task0_cand_pool.index"))
    pool = torch.from_numpy(index.embeds).to(DEVICE).bfloat16()
    scores, rows = brute_force_topk(torch.from_numpy(normalize_l2(q_emb)).to(DEVICE), pool, index.ntotal, MINE_K)
    dids = [unhash_did(h) for h in index.ids.tolist()]
    held, differ = mined_negatives_held(mined, queries, scores.cpu(), rows.cpu(), dids, NUM_HARD_NEGS)
    log(f"hard negatives equal to the fp32 search's for {len(queries) - differ} of {len(queries)} queries "
        f"(the rest differ only where the search's neighbouring scores tie): {held}")
    check(held, "mined negatives differ from the fp32 search's beyond ties, or a positive was mined")
    check_path_sweeps("hard-negative mining", [q_emb], index.embeds, index.ntotal)


def mined_negatives_held(mined: list, queries: list, scores: torch.Tensor, rows: torch.Tensor, dids: list,
                         num_hard_negs: int, tie: float = 1e-5) -> tuple:
    """Each mined list against `mine_hard_negatives` over an fp32 search's
    top rows (`scores`, `rows`: [Q, k]): every list grew by num_hard_negs
    with no positive among them, and a negative differs from the search's
    only where the search's scores of it and of a neighbour in its list tie
    within `tie` (`same_ranking`).  Returns (all held, lists that differ)."""
    from uniir_tpu_torch.retrieval.hard_negs import mine_hard_negatives

    held, differ = True, 0
    for m, q, s, r in zip(mined, queries, scores, rows.tolist()):
        new = m["neg_cand_list"][len(q["neg_cand_list"]):]
        held &= len(new) == num_hard_negs and not set(new) & set(q["pos_cand_list"])
        ranked = [dids[i] for i in r]
        want = mine_hard_negatives(ranked, q["pos_cand_list"], q["neg_cand_list"], num_hard_negs)
        if new != want:
            differ += 1
            score_of = dict(zip(ranked, s.tolist()))
            code = {d: i for i, d in enumerate(dict.fromkeys(ranked + new))}
            held &= all(d in score_of for d in new) and same_ranking(
                torch.tensor([[code[d] for d in new]]), torch.tensor([[code[d] for d in want]]),
                torch.tensor([[score_of[d] for d in want]]), tie)
    return held, differ


def drive_error_analyst() -> None:
    """(d) The analyst over phase 2's int8-pool run file: rates in [0, 1] and a TSV."""
    from uniir_tpu_torch.retrieval.analyst import run_automatic_error_analysis

    root = str(WORK)
    config = tools_config(root, analysis={
        "qrel_dir_name": "qrels_analyst", "results_dir_name": "results_clip_int8",
        "test_datasets_config": {"enable_retrieve": True, "datasets_name": ["mscoco_task0"],
                                 "correspond_cand_pools_name": ["mscoco_task0"],
                                 "correspond_qrels_name": ["mscoco_task0"],
                                 "correspond_metrics_name": ["Recall@1, Recall@5, Recall@10"]},
    })
    rows = run_automatic_error_analysis(config)
    tsv_dir = os.path.join(root, "results_clip_int8", EXPT, "error_tsv")
    log(f"error analyst over phase 2's run file: {rows}")
    check(rows and all(0.0 <= r[t] <= 1.0 for r in rows for t in ("Type1", "Type2", "Type3")),
          "error rates outside [0, 1]")
    check(len(os.listdir(tsv_dir)) == 1, "the analyst wrote no TSV")


def drive_tools_path(results: dict) -> None:
    """Phase 10: the interactive retriever, UniRAG's raw retrieval with
    complement pairs, hard-negative mining and the error analyst, over phase
    2's index, embeddings and run files, with phase 2's model (the same
    seed) in a bundle built in code (hash tokens: the card's machine has no
    BPE file)."""
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import ModelBundle, seeded_clip_sf
    from uniir_tpu_torch.train.steps import make_embed_step

    cfg = CLIP_CONFIGS[MODEL]
    data = smoke_dataset()
    model = seeded_clip_sf(cfg, DEVICE, seed=SEED, dtype=torch.bfloat16)
    bundle = ModelBundle("CLIPScoreFusion", model, lambda t: hash_tokenize(t, cfg.context_length, cfg.vocab_size),
                         None, None, (cfg.image_size, cfg.image_size), cfg.embed_dim)
    # phase 2's model again: its first candidate batch embeds as phase 2 saved it
    saved = np.load(os.path.join(str(WORK), "embed", EXPT, "cand_pool", "mbeir_mscoco_task0_cand_pool_embed.npy"))
    first = collate(data["cands"][:BATCH], data["dids"][:BATCH], "did_list", cfg)
    first.pop("did_list"), first.pop("n_valid")
    again = make_embed_step(model)(first).cpu().numpy()
    err = float(np.abs(again.astype(np.float32) - saved[:BATCH].astype(np.float32)).max())
    log(f"phase 10: CLIP-SF {MODEL} bf16 re-seeded; its first candidate batch against phase 2's: max abs {err}")
    check(err <= 1e-3, "the re-seeded model does not embed as phase 2's did")
    cands = write_tools_tree(str(WORK), data)
    drive_interactive_retriever(results, bundle, cfg, cands)
    drive_raw_retrieval(results, bundle, cfg, cands)
    drive_hard_negative_mining(results, data)
    drive_error_analyst()


# ------------------------------------------- phase 11: processes on the one card

# the multi-process phase: CLIP-SF at phase 7's 32 pairs (16 a rank in 11b), BLIP-SF at phase 9's 40 (20 a
# rank), each step after the first timed MH_TIMED times on the same batch; each launch is held to these limits (s)
MH_SEEDS = {"clip": SEED + 40, "blip": SEED + 42}
MH_TIMED = 3
# 11b's gradients against the one-process step's, relative to each tensor's norm: bf16 GEMMs of
# another M (a cosine of 0.999994 is a relative error near sqrt(2 (1 - cos)) = 3.5e-3), where a
# gradient summed over the two ranks in place of averaged is off by 1
MH_GRAD_RTOL = 1e-2
MH_LAUNCH_S = {"11a": 300, "11b": 600}
GLOO_PROBE_S = 20  # a collective the probe tries that never completes fails after this long


def phase11_dir() -> Path:
    return WORK / "phase11"


def flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().float().flatten() for t in tensors])


def timed_steps(run) -> float:
    """Median of MH_TIMED host-clock times of run() (a step), the card synchronised."""
    times = []
    for _ in range(MH_TIMED):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def clip_step_once(name: str = "CLIPScoreFusion", block=None) -> dict:
    """Phase 7's CLIP-SF step (seeded ViT-L/14, fp32 masters, bf16 compute) on
    its seeded 32-pair batch, or on this rank's host-major `block(batch)` of
    it: the loss, the averaged gradients and the parameters after the first
    update, the K1 / K3 launches of that step and of all the steps, and the
    median time of MH_TIMED more steps on the same batch (`timed_steps`)."""
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.ops import attention as attn_mod

    cfg = CLIP_CONFIGS[MODEL]
    state, step = train_setup(name)
    batch = make_train_batch(np.random.default_rng(MH_SEEDS["clip"]), TRAIN_BS, cfg)
    batch.pop("index_mapping")
    if block is not None:
        batch = block(batch)
    params = list(state.model.parameters())
    seen = {}

    def first_update(*_):  # the first update's averaged gradients
        if "grads" not in seen:
            seen["grads"] = flat(p.grad for p in params)

    state.optimizer.register_step_pre_hook(first_update)
    attn_mod.attention.launches = attn_mod.attention_bwd.launches = 0
    state, metrics = step(state, dict(batch))
    torch.cuda.synchronize()
    counts = {"K1": attn_mod.attention.launches, "K3": attn_mod.attention_bwd.launches}
    scale = [i for i, (n, _) in enumerate(state.model.named_parameters()) if n.endswith("logit_scale")]
    out = {"loss": metrics["loss"].item(), "grads": seen["grads"], "params": flat(params), "counts": counts,
           "offsets": np.cumsum([0] + [p.numel() for p in params]).tolist(), "scalar_index": scale[0]}
    out["step_ms"] = timed_steps(lambda: step(state, dict(batch)))
    out["launches"] = {"K1": attn_mod.attention.launches, "K3": attn_mod.attention_bwd.launches}
    return out


def blip_step_once(block=None) -> dict:
    """Phase 9's BLIP-SF `large` (its config; dropout off) one step on a
    seeded 40-pair batch, or on this rank's `block(batch)`: loss, accuracy,
    the queues' checksum and pointer, the K1 / K3 launches of that step and
    of all; MH_TIMED more steps timed as `clip_step_once` times them."""
    from uniir_tpu_torch.core.config import Config
    from uniir_tpu_torch.models.registry import build_model_from_config
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.train.optimizer import make_blip_optimizer
    from uniir_tpu_torch.train.state import MomentumTrainState
    from uniir_tpu_torch.train.steps import make_blip_train_step

    os.makedirs(WORK, exist_ok=True)
    vocab = os.path.join(str(WORK), "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS) + "\n")
    config = Config.from_dict({"uniir_dir": str(WORK), "seed": BLIP_SEED, "model": {
        **BLIP_TRAIN, "name": "BLIPScoreFusion", "tokenizer_max_length": BLIP_MAX_LEN, "bert_vocab_path": vocab,
        "vit_grad_ckpt": False}})
    bundle = build_model_from_config(config, device=DEVICE, train=True)
    model, extra = bundle.model, bundle.extra
    state = MomentumTrainState.create(model, *make_blip_optimizer(model, BLIP_LR, 1000, weight_decay=BLIP_WD),
                                      queue_size=extra["queue_size"], embed_dim=bundle.embed_dim,
                                      momentum=extra["momentum"])
    step = make_blip_train_step(model, seed=BLIP_SEED, with_dropout=False)
    gen = torch.Generator(device=DEVICE).manual_seed(MH_SEEDS["blip"])
    batch = make_blip_train_batch(np.random.default_rng(MH_SEEDS["blip"]), gen, BLIP_TRAIN_BS, BLIP_MAX_LEN,
                                  model.vit_cfg.image_size)
    if block is not None:
        batch = block(batch)
    attn_mod.attention.launches = attn_mod.attention_bwd.launches = 0
    state, metrics = step(state, batch, extra["alpha"])
    torch.cuda.synchronize()
    counts = {"K1": attn_mod.attention.launches, "K3": attn_mod.attention_bwd.launches}
    queues = [getattr(state, k).cpu().numpy() for k in ("queue_query", "queue_cand", "queue_idx")]
    out = {"loss": metrics["loss"].item(), "accuracy": metrics["inbatch_accuracy"].item(), "queue_ptr": state.queue_ptr,
           "queue_crc": [zlib.crc32(q.tobytes()) for q in queues], "counts": counts}
    out["step_ms"] = timed_steps(lambda: step(state, batch, extra["alpha"]))
    out["launches"] = {"K1": attn_mod.attention.launches, "K3": attn_mod.attention_bwd.launches}
    return out


def host_block_rows(n_pairs: int, rank: int, world: int) -> np.ndarray:
    """Rows of rank `rank`'s block [q_r | p_r] of a flat batch of n_pairs pairs."""
    per = n_pairs // world
    return np.r_[rank * per : (rank + 1) * per, n_pairs + rank * per : n_pairs + (rank + 1) * per]


def take_block(batch: dict, n_pairs: int, rank: int, world: int) -> dict:
    rows = host_block_rows(n_pairs, rank, world)
    per = n_pairs // world

    def take(key, x):
        if isinstance(x, dict):
            return {k: take(k, v) for k, v in x.items()}
        if key == "p_did_list":
            return x[rank * per : (rank + 1) * per]
        return x[torch.as_tensor(rows, device=x.device)] if isinstance(x, torch.Tensor) else x[rows]

    return {key: take(key, value) for key, value in batch.items()}


def held_to_reference(got: dict, ref_dir: str) -> dict:
    """This rank's CLIP step against the one-process step saved in
    `ref_dir`: the loss, each parameter's gradient and, where asked, the
    parameters after the update (relative to each tensor's norm), the
    gradients' cosine per tensor, and whether all is bit-equal."""
    ref = {k: torch.load(os.path.join(ref_dir, f"{k}.pt"), mmap=True, weights_only=True) for k in ("grads", "params")}
    offsets = got["offsets"]
    with open(os.path.join(ref_dir, "loss.json")) as f:
        ref_loss = json.load(f)
    out = {"loss_rel": abs(got["loss"] - ref_loss) / abs(ref_loss)}
    for key in ("grads", "params"):
        mine, theirs = got[key], ref[key].to(got[key].device)
        rels, coss = [], []
        for i in range(len(offsets) - 1):
            a, b = mine[offsets[i] : offsets[i + 1]].double(), theirs[offsets[i] : offsets[i + 1]].double()
            rels.append(((a - b).norm() / b.norm().clamp_min(1e-30)).item())
            if a.numel() > 1:
                coss.append(torch.nn.functional.cosine_similarity(a, b, dim=0).item())
        out[f"{key}_max_rel"], out[f"{key}_min_cos"] = max(rels), min(coss)
        out[f"{key}_bit_equal"] = torch.equal(mine, theirs)
        if key == "grads":
            j = offsets[got["scalar_index"]]
            out["logit_scale_grad"] = (mine[j].item(), theirs[j].item())
        del theirs
    return out


def phase11a_rank(args) -> dict:
    """11a: one rank over NCCL (world size 1), `cuda:LOCAL_RANK`: phase 7's
    step through the launcher, held to the one-process step, and one NCCL
    all-reduce of the step's gradients timed alone."""
    from uniir_tpu_torch.core import mesh

    check(mesh.process_count() == 1 and torch.distributed.get_backend() == "nccl", "11a is not one NCCL rank")
    got = clip_step_once()
    out = held_to_reference(got, args.task_args["ref"])
    grads = got["grads"]
    done = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.distributed.all_reduce(grads)  # warm-up: the communicator's first use
    done[0].record()
    torch.distributed.all_reduce(grads)
    done[1].record()
    torch.cuda.synchronize()
    return {**out, "step_ms": got["step_ms"], "counts": got["counts"], "launches": got["launches"],
            "all_reduce_ms": done[0].elapsed_time(done[1]),
            "device": str(torch.cuda.current_device()), "grad_bytes": grads.numel() * 4}


def gloo_probe(device) -> dict:
    """Which collectives this gloo takes on tensors of `device`: each tried
    once on a group of its own with a short timeout (a collective that
    fails on one rank cannot hang the phase)."""
    from datetime import timedelta

    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    group = dist.new_group(backend="gloo", timeout=timedelta(seconds=GLOO_PROBE_S))
    x = torch.ones(world * 4, device=device)
    ops = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "broadcast": lambda: dist.broadcast(x.clone(), 0, group=group),
        "reduce": lambda: dist.reduce(x.clone(), 0, group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x, group=group),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(torch.empty(world * x.numel(), device=device), x,
                                                                      group=group),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(torch.empty(4, device=device), x, group=group),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x, group=group),
        "gather": lambda: dist.gather(x, [torch.empty_like(x) for _ in range(world)] if rank == 0 else None, 0,
                                      group=group),
        "scatter": lambda: dist.scatter(torch.empty_like(x), [x.clone() for _ in range(world)] if rank == 0 else None,
                                        0, group=group),
    }
    taken = {}
    for name, op in ops.items():
        try:  # the probe's answer is whether the call raises; no kernel of the port runs here
            op()
            torch.cuda.synchronize()
            taken[name] = "yes"
        except Exception as e:  # noqa: BLE001 -- any refusal is the answer
            taken[name] = f"no ({type(e).__name__}: {str(e).splitlines()[0][:120]})"
    return taken


def phase11b_rank(args) -> dict:
    """11b: one of two ranks sharing the card over gloo: the gloo probe, the
    CLIP-SF and BLIP-SF steps on this rank's half of the global batch, the
    embedder's part files of phase 2's candidates and queries with
    `create_index` and `run_retrieval`, and `sharded_topk` over this rank's
    half of phase 1's pool."""
    from uniir_tpu_torch.core import mesh
    from uniir_tpu_torch.data.loader import ContiguousSampler
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import seeded_clip_sf
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.ops import topk as T
    from uniir_tpu_torch.retrieval.embedder import generate_embeds_and_ids_for_dataset, save_embeddings
    from uniir_tpu_torch.retrieval.eval import run_retrieval
    from uniir_tpu_torch.retrieval.index import create_index
    from uniir_tpu_torch.train.steps import make_embed_step

    global WORK
    world, rank = mesh.process_count(), mesh.process_index()
    check(world == 2 and torch.distributed.get_backend() == "gloo", "11b is not two gloo ranks")
    root = str(phase11_dir())
    WORK = phase11_dir() / f"rank{rank}"  # this rank's files for the registry's tokenizers
    WORK.mkdir(parents=True, exist_ok=True)
    out = {"probe": gloo_probe(torch.device(args.device))}

    got = clip_step_once(block=lambda b: take_block(b, TRAIN_BS, rank, world))
    out["clip"] = {**held_to_reference(got, args.task_args["ref"]), "step_ms": got["step_ms"],
                   "counts": got["counts"], "launches": got["launches"], "loss": got["loss"]}
    grads = [got["grads"][i : i + (1 << 26)].clone() for i in range(0, got["grads"].numel(), 1 << 26)]
    times = []
    for _ in range(MH_TIMED):  # each behind a barrier, so no rank's time holds its wait for the other
        mesh.barrier("all_reduce_timing")
        t0 = time.perf_counter()
        mesh.all_reduce_mean_(grads)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["clip"]["all_reduce_ms"] = float(np.median(times))
    del got, grads
    torch.cuda.empty_cache()

    out["blip"] = blip_step_once(block=lambda b: take_block(b, BLIP_TRAIN_BS, rank, world))
    torch.cuda.empty_cache()

    # phase 2's candidates and queries, each rank its contiguous half, into part files; rank 0 joins them
    cfg = CLIP_CONFIGS[MODEL]
    data = smoke_dataset()
    model = seeded_clip_sf(cfg, DEVICE, seed=SEED, dtype=torch.bfloat16)
    embed_step = make_embed_step(model)
    embed_dir = os.path.join(root, "embed", EXPT)
    if rank == 0:
        write_qrels(root, data)
    attn_mod.attention.launches = T.bucket_max_scores.launches = 0
    for split, items, ids, key, name in (
        ("cand_pool", data["cands"], data["dids"], "did_list", "mscoco_task0_cand_pool"),
        ("test", data["queries"], data["qids"], "qid_list", "mscoco_task0_test"),
    ):
        mine = ContiguousSampler(len(items), world, rank).indices()
        emb, got_ids = generate_embeds_and_ids_for_dataset(
            embed_step, batches([items[i] for i in mine], [ids[i] for i in mine], key, cfg))
        os.makedirs(os.path.join(embed_dir, split), exist_ok=True)
        save_embeddings(os.path.join(embed_dir, split, f"mbeir_{name}_embed.npy"),
                        os.path.join(embed_dir, split, f"mbeir_{name}_ids.npy"), emb, got_ids, name)
    k1_embed = attn_mod.attention.launches
    config = eval_config(root, "results_11", "bf16", cfg.embed_dim)
    create_index(config)
    recall = run_retrieval(config, device=DEVICE)
    out["embed"] = {"K1": k1_embed, "K2": T.bucket_max_scores.launches, "recall": recall[0]}
    del model, embed_step
    torch.cuda.empty_cache()

    # phase 1's 5.6M x 768 pool: this rank's 2.8M-row shard drawn on the card from the pool's seeds
    shard_rows = -(-POOL_ROWS // world)
    lo, hi = rank * shard_rows, min((rank + 1) * shard_rows, POOL_ROWS)
    shard = sweep_pool_rows(lo, hi)
    queries = sweep_queries()
    T.bucket_max_scores.launches = 0
    scores, ids = T.sharded_topk(queries, shard, SEARCH_K, POOL_ROWS, shard_rows)
    torch.cuda.synchronize()
    k2 = T.bucket_max_scores.launches
    np.save(os.path.join(root, f"topk_ids_rank{rank}.npy"), ids.cpu().numpy())
    # its parts timed apart, both ranks at once (they share the card): the shard's sweep and top-k, then the merge
    mesh.barrier("topk_timing")
    sweep_ms = cuda_ms(lambda: T.shard_topk(queries, shard, SEARCH_K, POOL_ROWS, shard_rows), 3)
    partial = T.shard_topk(queries, shard, SEARCH_K, POOL_ROWS, shard_rows)
    mesh.barrier("merge_timing")
    merge_ms = timed_steps(lambda: T.merge_shards(*partial, SEARCH_K))
    out["topk"] = {"K2": k2, "sweep_ms": sweep_ms, "merge_ms": merge_ms, "rows": hi - lo}
    return out


def drive_processes_path(results: dict) -> None:
    """Phase 11: the port over several processes on the one card, through
    `parallel.multihost.launch` (each rank a process of its own, loading
    the kernels built above).  11a: one rank over NCCL runs phase 7's step,
    held to the one-process step.  11b: two ranks share the card over gloo
    (NCCL takes one rank a card): the CLIP-SF and BLIP-SF steps at the same
    global batches, phase 2's embedding in part files with `create_index`
    and `run_retrieval`, and `sharded_topk` over phase 1's pool, each held
    to its one-process result."""
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.parallel.multihost import launch

    cfg = CLIP_CONFIGS[MODEL]
    root = phase11_dir()
    shutil.rmtree(root, ignore_errors=True)
    ref_dir = root / "reference"
    ref_dir.mkdir(parents=True)
    ref = clip_step_once()
    torch.save(ref["grads"].cpu(), ref_dir / "grads.pt")
    torch.save(ref["params"].cpu(), ref_dir / "params.pt")
    with open(ref_dir / "loss.json", "w") as f:
        json.dump(ref["loss"], f)
    ref_scale_grad = ref["grads"][ref["offsets"][ref["scalar_index"]]].item()
    log(f"phase 11: one-process CLIP-SF {MODEL} step (phase 7's) at {TRAIN_BS} pairs: loss {ref['loss']}, "
        f"step_ms {ref['step_ms']} (median of {MH_TIMED}), launches {ref['counts']} a step")
    del ref["grads"], ref["params"]
    torch.cuda.empty_cache()
    blip_ref = blip_step_once()
    log(f"phase 11: one-process BLIP-SF large step at {BLIP_TRAIN_BS} pairs, dropout off: loss {blip_ref['loss']}, "
        f"step_ms {blip_ref['step_ms']}, queue_ptr {blip_ref['queue_ptr']}, launches {blip_ref['counts']}")
    torch.cuda.empty_cache()
    per_step = {"K1": cfg.vision_layers - 1 + cfg.text_layers - 1, "K3": cfg.vision_layers - 1 + cfg.text_layers - 1}
    check(ref["counts"] == per_step, f"the one-process step launched {ref['counts']}, not {per_step}")

    t0 = time.perf_counter()
    (a,) = launch(1, str(root / "11a"), device=None, task="chip_smoke:phase11a_rank",
                  task_args={"ref": str(ref_dir)}, timeout=MH_LAUNCH_S["11a"])
    log(f"phase 11a: one rank over NCCL (cuda:{a['device']}) in {time.perf_counter() - t0:.1f} s: loss rel err "
        f"{a['loss_rel']}, gradients max rel err {a['grads_max_rel']} (bit-equal={a['grads_bit_equal']}), "
        f"parameters after the update max rel err {a['params_max_rel']} (bit-equal={a['params_bit_equal']}); "
        f"step_ms {a['step_ms']} against the one-process {ref['step_ms']}; NCCL all-reduce of the "
        f"{a['grad_bytes']}-byte gradients alone {a['all_reduce_ms']} ms (world size 1: a check that it runs, "
        f"it moves nothing); launches {a['counts']}")
    check(a["loss_rel"] <= 1e-6 and a["grads_max_rel"] <= 1e-6 and a["params_max_rel"] <= 1e-6,
          "11a: the NCCL rank's step differs from the one-process step")
    check(a["counts"] == ref["counts"], f"11a: launches {a['counts']}, not the one-process step's {ref['counts']}")
    for kernel in ("K1", "K3"):
        results[kernel]["launches"] += a["launches"][kernel]

    t0 = time.perf_counter()
    ranks = launch(2, str(root / "11b"), device="cuda:0", backend="gloo", task="chip_smoke:phase11b_rank",
                   task_args={"ref": str(ref_dir)}, timeout=MH_LAUNCH_S["11b"])
    log(f"phase 11b: two ranks on cuda:0 over gloo in {time.perf_counter() - t0:.1f} s")
    log(f"phase 11b: collectives the installed gloo takes on CUDA tensors: {ranks[0]['probe']}")
    for r, out in enumerate(ranks):
        c = out["clip"]
        log(f"phase 11b rank {r}: CLIP-SF {TRAIN_BS // 2} + {TRAIN_BS // 2} pairs: loss {c['loss']} (rel err "
            f"{c['loss_rel']} to the one-process {TRAIN_BS}-pair step), gradient min cosine {c['grads_min_cos']}, "
            f"max rel err {c['grads_max_rel']}, parameters after the update max rel err {c['params_max_rel']}, "
            f"logit_scale gradient {c['logit_scale_grad']}, step_ms {c['step_ms']}, gloo all-reduce of the "
            f"gradients alone {c['all_reduce_ms']} ms (behind a barrier, median of {MH_TIMED}), launches {c['counts']}")
        b = out["blip"]
        log(f"phase 11b rank {r}: BLIP-SF {BLIP_TRAIN_BS // 2} + {BLIP_TRAIN_BS // 2} pairs: loss {b['loss']} "
            f"(one process {blip_ref['loss']}), queue_ptr {b['queue_ptr']}, queue checksums {b['queue_crc']}, "
            f"step_ms {b['step_ms']}, launches {b['counts']}")
        t = out["topk"]
        log(f"phase 11b rank {r}: sharded_topk over {t['rows']} rows of the {POOL_ROWS}-row pool, {SEARCH_BATCH} "
            f"queries, k={SEARCH_K}: K2 launches {t['K2']}; the shard's sweep and top-k {t['sweep_ms']} ms (CUDA "
            f"events, both ranks sweeping), the merge with its collectives {t['merge_ms']} ms (host clock); "
            f"embedding K1 {out['embed']['K1']}, retrieval K2 {out['embed']['K2']}")
        check(c["loss_rel"] <= 1e-3 and c["grads_min_cos"] >= 0.99 and c["grads_max_rel"] <= MH_GRAD_RTOL
              and abs(c["logit_scale_grad"][0] - ref_scale_grad) <= 1e-3,
              f"11b rank {r}: the two-rank CLIP-SF step differs from the one-process step")
        check(c["counts"] == ref["counts"], f"11b rank {r}: CLIP launches {c['counts']}")
        check(abs(b["loss"] - blip_ref["loss"]) <= 1e-3 * abs(blip_ref["loss"]) and b["queue_ptr"] == BLIP_TRAIN_BS,
              f"11b rank {r}: the two-rank BLIP-SF step differs from the one-process step")
        check(b["counts"] == blip_ref["counts"] and t["K2"] == 1 and out["embed"]["K1"] > 0 and out["embed"]["K2"] > 0,
              f"11b rank {r}: launches BLIP {b['counts']} (one process {blip_ref['counts']}), sharded_topk K2 "
              f"{t['K2']}, embedding {out['embed']}")
        for kernel in ("K1", "K3"):
            results[kernel]["launches"] += c["launches"][kernel] + b["launches"][kernel]
        results["K1"]["launches"] += out["embed"]["K1"]
        results["K2"]["launches"] += out["embed"]["K2"] + t["K2"]
    check(ranks[0]["clip"]["loss"] == ranks[1]["clip"]["loss"] and ranks[0]["blip"]["loss"] == ranks[1]["blip"]["loss"],
          "11b: the ranks' global losses differ")
    check(ranks[0]["blip"]["queue_crc"] == ranks[1]["blip"]["queue_crc"], "11b: the ranks' queues differ")

    # the joined part files against phase 2's, and the run file of the sharded search against phase 2's bf16 one
    for split, name in (("cand_pool", "mscoco_task0_cand_pool"), ("test", "mscoco_task0_test")):
        got_ids, want_ids = (np.load(os.path.join(d, "embed", EXPT, split, f"mbeir_{name}_ids.npy"))
                             for d in (str(root), str(WORK)))
        got, want = (np.load(os.path.join(d, "embed", EXPT, split, f"mbeir_{name}_embed.npy")).astype(np.float32)
                     for d in (str(root), str(WORK)))
        cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
        parts = [f for f in os.listdir(os.path.join(str(root), "embed", EXPT, split)) if ".part" in f]
        log(f"phase 11b: {split} joined from two ranks' part files: {len(got_ids)} rows, ids equal to phase 2's "
            f"{np.array_equal(got_ids, want_ids)}, min cosine {cos.min()}, bit-equal {np.array_equal(got, want)}, "
            f"part files left {parts}")
        check(np.array_equal(got_ids, want_ids) and cos.min() >= 0.9999 and not parts,
              f"11b: the {split} embeddings from part files differ from phase 2's")
    run_name = "mbeir_mscoco_task0_single_pool_test_k10_run.txt"
    got_run = read_run(os.path.join(str(root), "results_11", EXPT, "run_files", run_name))
    want_run = read_run(os.path.join(str(WORK), "results_clip_bf16", EXPT, "run_files", run_name))
    differ = [q for q in want_run if [d for d, _ in got_run[q]] != [d for d, _ in want_run[q]]]
    log(f"phase 11b: run_retrieval over two ranks (the pool sharded, K2 on each half) against phase 2's bf16 run "
        f"file: {len(want_run)} queries, {len(differ)} with other ids")
    check(not differ, f"11b: the sharded run file differs from phase 2's for {differ[:3]}")

    ids = [np.load(os.path.join(str(root), f"topk_ids_rank{r}.npy")) for r in range(2)]
    want_s, want_i = PHASE1_TOPK["scores"], PHASE1_TOPK["ids"]
    exact = np.array_equal(ids[0], want_i.numpy())
    held = same_ranking(torch.from_numpy(ids[0]), want_i, want_s)
    log(f"phase 11b: sharded_topk ids over two ranks against phase 1's one-process topk over the whole pool: "
        f"equal on both ranks {np.array_equal(ids[0], ids[1])}, bit-equal ids {exact}, equal but for reference "
        f"ties within 1e-5 {held}")
    check(np.array_equal(ids[0], ids[1]) and held, "11b: sharded_topk ids differ from phase 1's topk")


def profile_train_step(name: str, remat: bool = False, splitk: bool = False) -> None:
    """torch.profiler over 3 train steps of TRAIN_BS pairs of `name` (with
    remat and UNIIR_ATTN_SPLITK=1 where asked): device time by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    from uniir_tpu_torch.models.clip import CLIP_CONFIGS

    cfg = CLIP_CONFIGS[MODEL]
    state, step = train_setup(name, remat, splitk)
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
    log(f"profile of a {TRAIN_BS}-pair {name} train step (remat={remat}, UNIIR_ATTN_SPLITK={int(splitk)}): "
        f"step_ms={wall * 1e3} (host clock, without the profiler)")
    log_device_time_by_group(prof, len(batches), wall * 1e3)


PROFILE_GROUPS = {
    "K1 attention_fwd": ("attention_fused_fwd", "attention_fwd"), "K10 attention_splitk": ("attention_splitk",),
    "K3 attention_bwd": ("attention_fused_bwd", "attention_bwd"),
    # K5 and K6 share int8_gemm.cuh's kernel; its epilogue type, in the name, tells them apart
    "K5 int8_matmul": ("dequantbf16",), "K6 int8_mlp": ("actquanti8", "dequantresbf16", "quantise_rows"),
    "K7 preprocess": ("preprocess_band", "preprocess_dense"),
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
        # the general-length kernels of K1 / K3 / K8 and K9 (one kernel) / K10 (272 < L): timed at a length
        # only they take; the static routes send every length of the main paths to the one-block-a-head
        # kernels, so `read_standalone` holds their counts to 0 after every path
        "K9g": {"name": "norm_first_general", "route": "cuda", "source": "uniir_tpu_torch/csrc/attention.cu",
                "replaces": "uniir_tpu/ops/attention_pallas.py:158"},
        "K10g": {"name": "attention_splitk_general", "route": "cuda", "source": "uniir_tpu_torch/csrc/attention.cu",
                 "replaces": "uniir_tpu/ops/attention_pallas.py:314"},
        "K1g": {"name": "attention_fwd_general", "route": "cuda", "source": "uniir_tpu_torch/csrc/attention.cu",
                "replaces": "uniir_tpu/ops/attention_pallas.py:413"},
        "K3g": {"name": "attention_bwd_general", "route": "cuda", "source": "uniir_tpu_torch/csrc/attention_bwd.cu",
                "replaces": "uniir_tpu/ops/attention_pallas.py:652"},
        "K11": {"name": "bucket_max_i8b", "route": "cuda", "source": "uniir_tpu_torch/csrc/topk.cu",
                "replaces": "uniir_tpu/ops/topk_pallas.py:254", "launches": 0},
        # the general-width kernels of K2 / K4 / K11 (bf16 D > 768, int8 D > 1152): timed beside the wgmma
        # kernels; `sweep_route` sends every width of the main paths to the wgmma kernels, so
        # `read_standalone` holds their counts to 0 after every path
        "K2g": {"name": "bucket_max_bf16_general", "route": "cuda", "source": "uniir_tpu_torch/csrc/topk.cu",
                "replaces": "uniir_tpu/ops/topk_pallas.py:118"},
        "K4g": {"name": "bucket_max_i8_general", "route": "cuda", "source": "uniir_tpu_torch/csrc/topk.cu",
                "replaces": "uniir_tpu/ops/topk_pallas.py:291"},
        "K11g": {"name": "bucket_max_i8b_general", "route": "cuda", "source": "uniir_tpu_torch/csrc/topk.cu",
                 "replaces": "uniir_tpu/ops/topk_pallas.py:254"},
        # K7's dense kernel (the route where the band kernel's strip does not fit): timed beside the band
        # kernel; `preprocess_route` sends the BLIP paths' 256 -> 224 to the band kernel, so
        # `read_standalone` holds its count to 0 after every path
        "K7g": {"name": "fused_preprocess_dense", "route": "cuda", "source": "uniir_tpu_torch/csrc/preprocess.cu",
                "replaces": "uniir_tpu/ops/image_ops.py:106"},
    }
    check_attention(results)
    check_attention_splitk(results)
    check_attention_norm_first(results)
    check_preprocess(results)
    check_sweep_machine_code()
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
    drive_int8_model_path(results, "CLIPFeatureFusion", data, profile="--profile" in sys.argv[1:])  # K5 / K6 in T5
    del data  # the training phases read peak memory
    torch.cuda.empty_cache()
    for name in ("BLIPScoreFusion", "BLIPFeatureFusion"):  # add their K7 / K1 / K2 / K4 / K11 (/ K5 / K6) launches too
        blip_data = drive_blip_path(results, name, profile="--profile" in sys.argv[1:])
        torch.cuda.empty_cache()
        drive_int8_model_path(results, name, blip_data, profile="--profile" in sys.argv[1:])  # K5 in MED, K6 with GELU
        del blip_data
        torch.cuda.empty_cache()
    check_attention_bwd(results)
    for name in ("CLIPScoreFusion", "CLIPFeatureFusion"):  # add their K1 / K10 / K3 launches too
        drive_train_path(results, name)
    for name in ("BLIPScoreFusion", "BLIPFeatureFusion"):  # add their K1 / K3 launches too
        drive_blip_train_path(results, name)
    if "--profile" in sys.argv[1:]:
        profile_train_step("CLIPScoreFusion")
        profile_train_step("CLIPFeatureFusion")
        profile_train_step("CLIPFeatureFusion", remat=True, splitk=True)
    torch.cuda.empty_cache()
    drive_tools_path(results)  # adds its K1 / K2 / K4 launches too
    torch.cuda.empty_cache()
    drive_processes_path(results)  # adds its ranks' K1 / K3 / K2 launches too
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
