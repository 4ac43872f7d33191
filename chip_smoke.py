#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py            # from the repo root; needs one CUDA card

0. builds the port's kernels, host image decoders and JPEG encoder (uniir_tpu_torch/csrc,
   nvcc for sm_90a) from the checkout, one nvcc a source at once, and (the
   decoder phase) holds the native GIF decoder, the native JPEG decoder's
   CMYK, YCCK and RGB forms and the native WebP decoder bit-equal to their
   twins over 120 seeded files each, sizes 1-600 px (both WebP decoders
   also to Pillow's digests of seven Pillow-made files), the native PSD
   (PackBits), DDS (BC1-BC7, the mask form) and ICNS (RLE) stages of
   csrc/raster.cu and csrc/bcn.cu over 200 seeded files and at 640 x 480
   (BC7 also at 2048 x 2048), and the native JPEG 2000 decoder
   (csrc/jpeg2000.cu) to Pillow's digests of the stored corpus
   (tests/data/jpeg2000, scripts/make_jpeg2000_files.py) and to its twin
   over 200 seeded derivatives (flipped code-block bytes, cuts, damaged
   headers), the native TIFF decoder over 200 seeded files each of ZSTD,
   CIELAB, subsampled YCbCr and CCITT strips cut short (their outcome,
   pixels or the exception raised, the twin's; Pillow's digests of the
   stored ZSTD / CIELAB / YCbCr / cut-CCITT / JPEG-strip files) and the
   native ZSTD decoder over 200 seeded frames (`zstd_bytes`: whole, cut,
   flipped) in both its readings, the native JPEG decoder on the
   damaged-JPEG corpus and its seeded derivatives (damaged lossless SOF3
   scans among them), subsampled YCbCr TIFFs predicted or with a strip
   damaged, and FTEX's BC1 blocks through csrc/bcn.cu, and the AVIF decoder (numpy on both hosts) to
   Pillow's digests of the stored corpus (tests/data/avif, scripts/make_avif_files.py) up to 160 px a side,
   printing their images/s on one thread
   and on the loader's threads (JPEG 2000's at 640 x 480 and 1920 x 1080,
   on 1 and 16; TIFF's ZSTD levels 3 / 19, CIELAB and 2 x 2 YCbCr at
   640 x 480 on one);
1. checks each kernel against its plain PyTorch twin at the shapes the
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
   turns, and the general ones also at L = 400, which only they take; then
   K1 and K3 50 times each on the same inputs at the partial-tile lengths
   L = 17 ([2, 17, 128] H2) and 197 ([64, 197, 1024] H16), every output
   bit-equal to the first;
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
   twins, and one request each of one PNG, one GIF, one BMP, one CMYK JPEG,
   one lossy WebP and one lossless WebP (with alpha) image query and one
   each of an LZW TIFF, a ZSTD TIFF, an arithmetic JPEG, an RLE TGA, a QOI,
   a BC7 DDS, a PackBits PSD, a lossless JP2, an irreversible J2K file,
   an FTEX file of BC1 blocks, an FLC file and an AVIF file (the native
   PNG / GIF / JPEG / WebP / TIFF / JPEG 2000 decoders and
   the native stages of csrc/raster.cu and csrc/bcn.cu -- BMP and AVIF have
   one decoder, numpy --, K1, K2) held
   the same way to the twins, the twin decoders among them, the GIF / BMP /
   CMYK / WebP queries' embeddings also to the same pixels sent as a
   baseline JPEG (cosine >= 0.999);
   UniRAG's raw retrieval with complement pairs over the int8 pool
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
   whole pool, each rank's sweep and the merge timed);
12. runs the entry points as a user does: writes a seeded M-BEIR tree in a
   temporary directory (1024 candidates, 256 queries and 120 train queries
   of `mscoco_task0`, about 830 image files: JPEG files from the script's
   own writer in Pillow's default form -- 4:2:0, quality 75, short side 256
   --, PNG files from its own PNG writer in five forms through every
   scanline filter, three Pillow-made progressive JPEGs kept below as
   base64, and a GIF, a BMP (RLE8), CMYK, YCCK and RGB JPEGs and WebP files
   (lossy, lossless with alpha, VP8X with an ALPH chunk) from its writers,
   under the paths `P12_FORMS` names; a BPE merges file learned
   from the captions, a `vocab.txt`, phase 2's CLIP-SF and a seeded BLIP-SF
   `large` saved as `.pth`), reads the shipped
   `configs/clip_sf/large/eval/inbatch/{embed,index,retrieval}.yaml`,
   `configs/clip_sf/large/train/inbatch/inbatch.yaml`,
   `configs/blip_sf/large/eval/inbatch/embed.yaml` and
   `configs/blip_sf/large/train/inbatch/inbatch.yaml` with the port's
   reader, changes only what the fixture forces (one printed line lists the
   keys) and writes them with its writer; then runs each CLI as a process of
   its own with `yaml`, `PIL` and `regex` stubbed out of its PYTHONPATH:
   `config_updater`, the pipeline's embed, index and retrieval (int8 pool as
   shipped, then bf16), BLIP-SF's embed, CLIP-SF's trainer for three steps
   of 32 pairs and BLIP-SF's for three of 40 at full width (the numpy train
   transform on the files), each checkpoint then embedded by the pipeline;
   and checks the native decoders bit-equal to the twins on every file (the
   progressive ones also to Pillow's digests, the PNG, GIF, BMP and lossless
   WebP ones to the samples written), the CLIs' embeddings against the in-code embed path over the
   decoded arrays (cosine >= 0.9999 every row, ids equal; BLIP-SF's trained
   checkpoint too), the int8 run's ids against the bf16 run's, the TSV's
   Recall@1/5/10 against the port's search called in code, each run's
   launches (K1 / K2 / K3 / K4 and the native decoders where implied, no
   other kernel; BLIP-SF's trainer 46 K1 / 23 K3 a step), the trainers'
   losses and BLIP-SF's queue pointer; it prints the native decode rates
   (all files on one thread and on the loader's threads; each format on
   one thread), BLIP's train transform's time an image, the share of decode
   plus transform in the embed loop and of the train transform in the
   BLIP-SF trainer's step, and that step's device idle share, beside the
   card's name and power limit and the host CPU.
13. runs the offline M-BEIR construction as a user does: writes seeded raw
   trees for the ten source datasets in each converter's layout (about 600
   images at the sources' sizes, COCO's 640 x 480 kinds up to 1600 px for
   OVEN: the writer's baseline JPEGs, JPEGs with COM segments, Pillow's
   progressive files, palette PNGs with tRNS, PNGs with a comment, GIFs with
   a comment, lossless WebP, CMYK JPEG, ICO, PPM / PGM; a truncated JPEG, an
   HTML error page under a .jpg name, a JP2 file and FITS, FLC, PCD, IPTC and
   AVIF files under .jpg names (which the pass converts), a PSD file no reader
   identifies under a
   .png name and an EPS file under a .jpg name), then each converter's CLI with every step
   (`--enable_image_processing`, the candidate pool, the conversion, the
   training pool) and the union generator's (union pools, the union train
   split, task ids, qrels), each a process of its own on the card's default
   device with yaml, PIL and regex stubbed out; holds the native JPEG
   encoder to Pillow 12.1's digests of a fixed set and every file the CLIs
   wrote (the JPEG files of the image pass, every JSON-lines file) to the
   same mains run in this process through the twins (`--device cpu`), the
   truncated file, the HTML page and the PSD file deleted, the EPS file left in
   place and all four counted, each
   pass's native decodes and encodes counted in its workers; times the image
   pass on one process by stage (decode, comment, resize, encode, write: the
   encoder's share) and on the pass's pool; then embeds, indexes and
   retrieves the constructed MSCOCO test split through the pipeline CLI
   (CLIP-SF ViT-L/14, bf16: K1, K4 and K2, no other kernel; ids equal to the
   in-code path; each retrieval run's top 10 ids for every query equal to
   the search called in code, the int8 run's to the bf16 run's; Recall equal
   to the search called in code).

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
vocabulary are not in the repo; phase 12 makes seeded stand-ins for the last
two).  `chip_smoke.py --cli COUNTS MODULE ARGS...` is one of phase 12's runs:
`python -m MODULE ARGS...`, then every kernel's launch count into COUNTS.
"""

from __future__ import annotations

import base64
import heapq
import json
import os
import re
import shutil
import struct
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


T_IMPORT = time.perf_counter()


def log(msg: str) -> None:
    """A line of the log, after the seconds since the script started."""
    print(f"[{time.perf_counter() - T_IMPORT:.1f} s] {msg}", flush=True)


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


# ------------------------------------ the decoder phase: GIF, JPEG's colour forms and WebP

DECODER_CASES = 200  # seeded files of each native decoder's new forms, sizes 1-600 px
GIF_CASE_FORMS = ("plain", "interlaced", "local_palette", "short_palette", "transparency", "deferred_clear",
                  "frame_offset", "grey_palette", "min_code_size")
# (writer form, per-component sampling or None for the writer's default)
JPEG_CASE_FORMS = (("cmyk", None), ("cmyk", [(2, 2), (1, 1), (1, 1), (2, 2)]), ("ycck", None), ("ycck", [(1, 1)] * 4),
                   ("rgb", None), ("rgb", [(2, 2), (1, 1), (1, 1)]), ("rgb_ids", None),
                   ("rgb_ids", [(1, 1), (2, 1), (1, 1)]))


# the TIFF writer's forms of the decoder phase: (samples kind, tiff_bytes keywords); sizes from the case
TIFF_CASE_FORMS = {
    "lzw_rgb_strips": ("rgb", dict(photometric=2, compression=5, rows_per_strip=16)),
    "lzw_predictor2": ("rgb", dict(photometric=2, compression=5, predictor=2, rows_per_strip=8)),
    "lzw_compat_grey": ("grey", dict(photometric=1, compression=5, lzw_compat=True)),
    "deflate_tiles_mm": ("rgb", dict(photometric=2, compression=8, tile=(32, 16), order="MM")),
    "packbits_palette4": ("index4", dict(photometric=3, compression=32773, bits=4, colormap=True, rows_per_strip=5)),
    "raw_planar_bigtiff": ("rgb", dict(photometric=2, compression=1, planar=2, bigtiff=True, rows_per_strip=9)),
    "lzw_planar_rgba_assoc": ("rgba", dict(photometric=2, compression=5, planar=2, extra=(1,))),
    "jpeg_ycbcr": ("rgb", dict(photometric=6, compression=7, rows_per_strip=16)),
    "jpeg_grey_tiles": ("grey", dict(photometric=1, compression=7, tile=(16, 32))),
    "ccitt_rle": ("bilevel", dict(photometric=0, compression=2, bits=1, rows_per_strip=24)),
    "ccitt_g3_fillorder2": ("bilevel", dict(photometric=1, compression=3, bits=1, fillorder=2, t4options=4)),
    "lzw_bilevel": ("bilevel", dict(photometric=0, compression=5, bits=1, rows_per_strip=33)),
    "deflate_float_predictor3": ("float", dict(photometric=1, compression=8, predictor=3, rows_per_strip=12)),
    "lzw_rgb16_mm_orientation6": ("rgb16", dict(photometric=2, compression=5, order="MM", orientation=6)),
    "packbits_cmyk_orientation3": ("rgba", dict(photometric=5, compression=32773, orientation=3)),
}
# forms of `zstd_bytes`: raw or RLE blocks; compressed blocks of greedy LZ77 matches with raw, RLE or Huffman literals
# (direct weights; one or four streams; a later block reusing the table), sequences under the predefined, RLE or
# repeated tables, repeat offsets; several frames with skippable frames between them
ZSTD_FORMS = ("raw_blocks", "rle_blocks", "lz_raw", "lz_huffman1", "lz_huffman4", "lz_rle_tables", "lz_repeat",
              "frames_skippable")

# the TIFF forms of ZSTD, CIELAB, subsampled YCbCr (predicted, and damaged strips TIFFRGBAImage reads on past) and
# CCITT strips that end early, DECODER_CASES files of each kind: (samples kind, tiff_bytes keywords; "flip": a
# byte of a strip flipped)
TIFF_KINDS = {
    "tiff_zstd": {**{f"zstd_{f}": ("rgb", dict(photometric=2, compression=50000, zstd_form=f, rows_per_strip=16))
                     for f in ZSTD_FORMS[:-1]},
                  "zstd_predictor2_rgb16_mm": ("rgb16", dict(photometric=2, compression=50000, predictor=2, order="MM",
                                                             rows_per_strip=8)),
                  "zstd_predictor3_float": ("float", dict(photometric=1, compression=50000, predictor=3)),
                  "zstd_tiles_planar_rgba": ("rgba", dict(photometric=2, extra=(2,), compression=50000, planar=2,
                                                          tile=(32, 16)))},
    "tiff_lab": {"lab_raw": ("rgb", dict(photometric=8, compression=1, rows_per_strip=7)),
                 "lab_lzw_planar": ("rgb", dict(photometric=8, compression=5, planar=2)),
                 "lab_zstd_tiles": ("rgb", dict(photometric=8, compression=50000, tile=(16, 32))),
                 "lab_packbits_orientation6": ("rgb", dict(photometric=8, compression=32773, orientation=6))},
    "tiff_ycbcr": {**{f"ycbcr{h}{v}_c{c}": ("rgb", dict(photometric=6, compression=c, subsampling=(h, v), **lay))
                      for (h, v), c, lay in (((2, 2), 5, dict(rows_per_strip=8)), ((2, 1), 8, dict(tile=(16, 16))),
                                             ((1, 2), 32773, dict(rows_per_strip=6)), ((4, 4), 50000, dict(tile=(32, 32))),
                                             ((4, 2), 5, dict(rows_per_strip=5)), ((4, 1), 50000, {}))},
                   "ycbcr22_orientation7_c8": ("rgb", dict(photometric=6, compression=8, subsampling=(2, 2),
                                                           orientation=7, rows_per_strip=4)),
                   "ycbcr44_strips_c50000": ("rgb", dict(photometric=6, compression=50000, subsampling=(4, 4),
                                                         rows_per_strip=6)),
                   "ycbcr11_planar_c5": ("rgb", dict(photometric=6, compression=5, planar=2)),
                   "ycbcr22_predictor2_c5": ("rgb", dict(photometric=6, compression=5, subsampling=(2, 2), predictor=2,
                                                         rows_per_strip=8)),
                   "ycbcr21_predictor2_tiles_c8": ("rgb", dict(photometric=6, compression=8, subsampling=(2, 1),
                                                               predictor=2, tile=(16, 16))),
                   "ycbcr42_predictor2_c50000": ("rgb", dict(photometric=6, compression=50000, subsampling=(4, 2),
                                                             predictor=2, rows_per_strip=6)),
                   "ycbcr22_flip_c5": ("rgb", dict(photometric=6, compression=5, subsampling=(2, 2), rows_per_strip=8,
                                                   flip=True)),
                   "ycbcr42_cut_c8": ("rgb", dict(photometric=6, compression=8, subsampling=(4, 2), predictor=2,
                                                  rows_per_strip=10, cut=0.7)),
                   "ycbcr12_cut_c32773": ("rgb", dict(photometric=6, compression=32773, subsampling=(1, 2),
                                                      rows_per_strip=6, cut=0.8)),
                   "ycbcr44_flip_c50000": ("rgb", dict(photometric=6, compression=50000, subsampling=(4, 4),
                                                       rows_per_strip=8, flip=True))},
    "tiff_ccitt": {"g3_cut": ("bilevel", dict(photometric=0, compression=3, bits=1, rows_per_strip=9, cut=0.6)),
                   "g3_fill_cut": ("bilevel", dict(photometric=1, compression=3, bits=1, t4options=4, cut=0.8,
                                                   rows_per_strip=17)),
                   "g3_flip": ("bilevel", dict(photometric=0, compression=3, bits=1, rows_per_strip=12, flip=True)),
                   "rle_cut": ("bilevel", dict(photometric=0, compression=2, bits=1, rows_per_strip=10, cut=0.7))},
}


# the JPEG forms of the decoder phase: SOF1, arithmetic sequential / progressive, lossless, and progressive
# arithmetic files cut after a scan (smoothed)
JPEG_FORM_CASE_FORMS = ("sof1", "arith_420", "arith_444_restart_dac", "arith_progressive", "arith_cmyk_progressive",
                        "lossless_grey", "lossless_rgb_restart", "smoothed_arith")


def tiff_case(form: str, rng, w: int, h: int, forms: dict = TIFF_CASE_FORMS) -> bytes:
    """A seeded TIFF of one of `forms` (TIFF_CASE_FORMS, or a kind of TIFF_KINDS): a smooth field with noise
    (LZW and PackBits find runs in it)."""
    kind, kw = forms[form]
    yy, xx = np.mgrid[0:h, 0:w]
    field = np.stack([(xx * (3 + c) + yy * (2 + 2 * c) + 40 * c) % 256 for c in range(4)], axis=2)
    img = np.clip(field + rng.normal(0, 6, field.shape), 0, 255).astype(np.uint8)
    samples = {"rgb": img[..., :3], "rgba": img, "grey": img[..., :1],
               "index4": img[..., :1] >> 4, "bilevel": (img[..., :1] > 127).astype(np.uint8),
               "float": (img[..., :1].astype(np.float32) * 1.5 - 40),
               "rgb16": img[..., :3].astype(np.uint16) * 257 + rng.integers(0, 256, img[..., :3].shape).astype(np.uint16)}[kind]
    kw = dict(kw)
    if kw.pop("colormap", False):
        kw["colormap"] = [int(v) for v in rng.integers(0, 65536, 3 << kw["bits"])]
    flip = kw.pop("flip", False)
    data = tiff_bytes(samples, **kw)
    if flip:  # a byte of the first strip's data flipped
        from uniir_tpu_torch.data import tiff

        t = tiff.parse(data)
        at = t.tags[273][0] + int(rng.integers(0, t.tags[279][0]))
        data = data[:at] + bytes([data[at] ^ int(rng.integers(1, 256))]) + data[at + 1:]
    return data


def jpeg_form_case(form: str, rng, w: int, h: int) -> bytes:
    """A seeded JPEG of one of JPEG_FORM_CASE_FORMS."""
    yy, xx = np.mgrid[0:h, 0:w]
    field = np.stack([(xx * (3 + c) + yy * (2 + 2 * c) + 40 * c) % 256 for c in range(4)], axis=2)
    img = np.clip(field + rng.normal(0, 8, field.shape), 0, 255).astype(np.uint8)
    q = int(rng.integers(30, 96))
    if form == "sof1":
        data = jpeg_bytes(img[..., :3], q, restart=int(rng.choice([0, 3])))
        at = data.index(b"\xff\xc0")
        return data[:at + 1] + b"\xc1" + data[at + 2:]
    if form == "arith_420":
        return jpeg_bytes(img[..., :3], q, coding="arithmetic")
    if form == "arith_444_restart_dac":
        return jpeg_bytes(img[..., :3], q, sampling=(1, 1), restart=int(rng.integers(1, 6)), coding="arithmetic",
                          dac={0: (1, 4, 3), 1: (0, 2, 9)})
    if form == "arith_progressive":
        return jpeg_bytes(img[..., :3], q, coding="arithmetic", progressive=True, restart=int(rng.choice([0, 4])))
    if form == "arith_cmyk_progressive":
        return jpeg_bytes(img, q, form="cmyk", coding="arithmetic", progressive=True)
    if form == "lossless_grey":
        return jpeg_bytes(img[..., 0], coding="lossless", predictor=int(rng.integers(1, 8)),
                          point_transform=int(rng.integers(0, 3)))
    if form == "lossless_rgb_restart":
        return jpeg_bytes(img[..., :3], form="rgb", coding="lossless", predictor=int(rng.integers(1, 8)),
                          restart=int(rng.integers(1, 4)))
    data = jpeg_bytes(img[..., :3], q, coding="arithmetic", progressive=True)  # smoothed_arith
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return data[: sos[int(rng.integers(1, len(sos)))]] + b"\xff\xd9"


def decoder_case(job: tuple) -> tuple:
    """(file bytes, sha256 of the twin decoder's pixels) of seeded case k of `kind`: a GIF of one of
    GIF_CASE_FORMS (indices in runs and noise, so the LZW table fills), a JPEG of one of JPEG_CASE_FORMS
    (a smooth field with noise, quality 30-95, restarts now and then), a WebP file of one of
    WEBP_CASE_FORMS (`webp_bytes`), a TIFF or JPEG form, or a file of one of RASTER_CASE_FORMS
    (`raster_case`); a worker of the decoder phase's pool."""
    import hashlib

    from uniir_tpu_torch.data import gif, jpeg, tiff, webp

    kind, k = job
    rng = np.random.default_rng(SEED + 7000 + k + {"gif": 0, "jpeg": 100_000, "webp": 200_000, "tiff": 300_000,
                                                   "jpeg_forms": 400_000, "raster": 500_000,
                                                   "containers": 600_000, "tiff_zstd": 700_000, "tiff_lab": 800_000,
                                                   "tiff_ycbcr": 900_000, "tiff_ccitt": 1_000_000,
                                                   "zstd": 1_100_000}[kind])
    w, h = int(rng.integers(1, 601)), int(rng.integers(1, 601))
    if kind in ("webp", "tiff", "jpeg_forms") and k % 4:  # three cases in four log-uniform over 1-600 px: the
        w, h = int(round(600 ** rng.random())), int(round(600 ** rng.random()))  # Python twins are slow at 600
    if kind == "webp":
        data = webp_bytes(WEBP_CASE_FORMS[k % len(WEBP_CASE_FORMS)], SEED + 9000 + k, w, h)
        return data, hashlib.sha256(webp.decode_twin(data).tobytes()).hexdigest()
    if kind == "tiff":
        data = tiff_case(list(TIFF_CASE_FORMS)[k % len(TIFF_CASE_FORMS)], rng, w, h)
        return data, hashlib.sha256(tiff.decode_twin(data).tobytes()).hexdigest()
    if kind in TIFF_KINDS:  # log-uniform over 1-600 px
        w, h = int(round(600 ** rng.random())), int(round(600 ** rng.random()))
        forms = TIFF_KINDS[kind]
        data = tiff_case(list(forms)[k % len(forms)], rng, w, h, forms)
        return data, outcome_digest(tiff.decode_twin, data, f"{kind} case {k}")
    if kind == "zstd":
        return zstd_case(k, rng)
    if kind == "jpeg_forms":
        data = jpeg_form_case(JPEG_FORM_CASE_FORMS[k % len(JPEG_FORM_CASE_FORMS)], rng, w, h)
        return data, hashlib.sha256(jpeg.decode_twin(data).tobytes()).hexdigest()
    if kind in ("raster", "containers"):  # log-uniform over 1-160 / 200 px: some twins are Python loops over bytes
        top = 160 if kind == "raster" else 200
        w, h = int(round(top ** rng.random())), int(round(top ** rng.random()))
        forms, case = (RASTER_CASE_FORMS, raster_case) if kind == "raster" else (CONTAINER_CASE_FORMS, container_case)
        data = case(forms[k % len(forms)], rng, w, h)
        return data, hashlib.sha256(jpeg.decode_image(data, f"{kind} case {k}", "cpu").tobytes()).hexdigest()
    if kind == "gif":
        form = GIF_CASE_FORMS[k % len(GIF_CASE_FORMS)]
        n_colors = int(rng.integers(1, 257))
        palette, top, kw = rng.integers(0, 256, 3 * n_colors, dtype=np.uint8).tobytes(), n_colors, {}
        if form == "interlaced":
            kw["interlace"] = True
        elif form == "local_palette":
            kw["local"] = True
        elif form == "short_palette":
            palette, top = palette[: 3 * int(rng.integers(1, 9))], 256
        elif form == "transparency":
            kw.update(transparency=int(rng.integers(0, top)), screen=(w + 5, h + 3))
        elif form == "deferred_clear":
            kw["deferred_clear"] = True
        elif form == "frame_offset":
            kw.update(offset=(int(rng.integers(0, 20)), int(rng.integers(0, 20))),
                      screen=(int(rng.integers(1, w + 30)), int(rng.integers(1, h + 30))))
        elif form == "grey_palette":
            palette, top = bytes(v for i in range(n_colors) for v in (i, i, i)), 256
        idx = rng.integers(0, top, (h, w))
        idx = np.where(rng.random((h, 1)) < 0.5, idx[:, :1], idx).astype(np.uint8)
        bits = int(idx.max()).bit_length()
        kw["min_code_size"] = max(2, bits, max(1, (max(1, len(palette) // 3) - 1).bit_length()))
        if form == "min_code_size":
            kw["min_code_size"] = int(rng.integers(1 if bits <= 1 else bits, 9))
        data = gif_bytes(idx, palette, **kw)
        twin = gif.decode_twin
    else:
        form, factors = JPEG_CASE_FORMS[k % len(JPEG_CASE_FORMS)]
        channels = 4 if form in ("cmyk", "ycck") else 3
        yy, xx = np.mgrid[0:h, 0:w]
        field = np.stack([(xx * (3 + c) + yy * (2 + 2 * c) + 40 * c) % 256 for c in range(channels)], axis=2)
        arr = np.clip(field + rng.normal(0, 8, field.shape), 0, 255).astype(np.uint8)
        data = jpeg_bytes(arr, int(rng.integers(30, 96)), restart=int(rng.choice([0, 0, 3, 7])), form=form,
                          factors=factors)
        twin = jpeg.decode_twin
    return data, hashlib.sha256(twin(data).tobytes()).hexdigest()


def outcome_digest(fn, *args) -> str:
    """sha256 of the bytes (or pixels) `fn(*args)` gives, or "raises <exception class>"."""
    import hashlib

    try:
        out = fn(*args)
    except ValueError as err:
        return f"raises {type(err).__name__}"
    return hashlib.sha256(out if isinstance(out, bytes) else out.tobytes()).hexdigest()


def zstd_case(k: int, rng) -> tuple:
    """(frame bytes, (content size, the twin's outcome of decompress, and of decode_stream into the content
    size)) of seeded case k of the "zstd" kind: frames of ZSTD_FORMS over a raw image's bytes, up to 300 KiB,
    every third one cut and every third one with a byte flipped."""
    from uniir_tpu_torch.data import zstd

    n = int(round(300_000 ** rng.random()))
    data = raw_image(int(rng.integers(0, 1 << 30)), max(1, n // 96), 32).tobytes()[:n]
    if k % 2:  # a small alphabet, where Huffman literals with direct weights pay
        data = (np.frombuffer(data, np.uint8) >> 4).tobytes()
    frame = zstd_bytes(data, ZSTD_FORMS[k % len(ZSTD_FORMS)], seed=k)
    if k % 3 == 1:
        frame = frame[: int(rng.integers(0, len(frame) + 1))]
    elif k % 3 == 2 and frame:
        at = int(rng.integers(0, len(frame)))
        frame = frame[:at] + bytes([frame[at] ^ int(rng.integers(1, 256))]) + frame[at + 1:]
    name = f"zstd case {k}"
    return frame, (len(data), outcome_digest(zstd.decompress, frame, len(data), name),
                   outcome_digest(zstd.decode_stream, frame, len(data), name))


DECODER_KINDS = ("gif", "jpeg", "webp", "tiff", "jpeg_forms", "raster", "containers")
# kinds whose cases may raise (their digest names the exception): the TIFF_KINDS, and "zstd" frames (of ZSTD_FORMS,
# whole, cut or with a byte flipped) through both of the ZSTD decoder's readings
RAISING_KINDS = (*TIFF_KINDS, "zstd")
# the forms whose bytes csrc/raster.cu decodes: each file goes through one of its entries once
RASTER_CASE_FORMS = ("qoi_rgb", "qoi_rgba", "tga_rle_rgb", "tga_rle_rgba", "tga_rle_grey", "tga_rle_cmap16",
                     "sgi_rle", "sgi_rle_16", "pcx_rgb", "pcx_palette", "pcx_planar", "dcx", "sun_rle",
                     "sun_rle_palette", "msp_v2", "fli_brun", "fli_color64_lc", "flc_brun_ss2", "flc_copy_lc",
                     "flc_black_ss2_odd", "flc_pstamp", "flc_palette_mid", "flc_two_frames")


def raster_case(form: str, rng, w: int, h: int) -> bytes:
    """A seeded file of `form` (RASTER_CASE_FORMS) at w x h: samples in runs along rows, repeated rows and
    noise, so each format's runs and literals both occur (FLI / FLC: the first band as palette indices, each
    delta from a seeded change of them)."""
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img = np.where(rng.random((h, w, 1)) < 0.6, img[:, :1], img)
    img = np.where(rng.random((h, 1, 1)) < 0.3, img[:1], img).astype(np.uint8)
    idx = (img[..., 0] >> 4).astype(np.uint8)
    palette = rng.integers(0, 256, 768, dtype=np.uint8).tobytes()
    if form.startswith("qoi"):
        return qoi_bytes(img if form == "qoi_rgba" else img[..., :3])
    if form.startswith("tga"):
        if form == "tga_rle_cmap16":
            return tga_bytes(idx, palette=palette[:48], cmap_first=int(rng.integers(0, 3)), cmap_depth=16)
        return tga_bytes({"tga_rle_rgb": img[..., :3], "tga_rle_rgba": img, "tga_rle_grey": img[..., 0]}[form],
                         top_down=bool(rng.random() < 0.5))
    if form.startswith("sgi"):
        return sgi_bytes(img[..., :3].astype(np.uint16) * 257 + 1 if form == "sgi_rle_16" else img[..., :3])
    if form == "pcx_rgb":
        return pcx_bytes(img[..., :3])
    if form == "pcx_palette":
        return pcx_bytes(img[..., 0], palette=palette)
    if form == "pcx_planar":
        return pcx_bytes(idx, palette=palette[:48], planes_of_bits=4)
    if form == "dcx":
        return dcx_bytes([pcx_bytes(img[..., :3]), pcx_bytes(idx, palette=palette[:48], planes_of_bits=4)])
    if form == "sun_rle":
        return sun_bytes(img[..., :3])
    if form == "sun_rle_palette":
        return sun_bytes(idx, palette=palette[:48])
    if form in FLI_FORMS:
        return fli_bytes(form, img[..., 0], rng)
    return msp_bytes(img[..., 0] > 127)


class RasterNative:
    """The native path of RASTER_CASE_FORMS' files (`data.jpeg.decode_image` on a CUDA run's host, where
    each decode runs one entry of csrc/raster.cu); `calls` counts those entries' calls."""

    def __call__(self, data: bytes, name: str = "raster") -> np.ndarray:
        from uniir_tpu_torch.data import jpeg

        return jpeg.decode_image(data, name, "cuda")

    @property
    def calls(self) -> int:
        from uniir_tpu_torch.data import raster

        return sum(raster.native_calls.values())


RASTER_SIZE = (640, 480)  # COCO's size, at which a Python loop over a file's bytes costs seconds

# the PSD, DDS, ICNS and FTEX forms: PSD's and FTEX's raw forms are numpy on both paths (no native stage), the
# others run one entry of csrc/raster.cu (PSD's PackBits, ICNS's RLE) or csrc/bcn.cu (DDS, FTEX's BC1) a file
CONTAINER_CASE_FORMS = ("psd_rgb_raw", "psd_rgb_rle", "psd_cmyk_raw", "psd_cmyk_rle", "psd_p_raw", "psd_p_rle",
                        "dds_bc1", "dds_bc3", "dds_bc5", "dds_bc6h", "dds_bc7", "dds_rgb_masks", "icns_rle",
                        "ftex_bc1", "ftex_rgb_raw")


def container_case(form: str, rng, w: int, h: int) -> bytes:
    """A seeded file of `form` (CONTAINER_CASE_FORMS) at w x h (an ICNS file at the RLE size nearest w): PSD
    planes of samples in runs and noise, with an image resource and a layer section half the time; DDS
    blocks of seeded bits (`bc_blocks`), or 16 / 24 / 32-bit pixels under seeded masks; ICNS RLE channels
    and a mask; FTEX BC1 blocks of seeded bits or packed RGB."""
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img = np.where(rng.random((h, w, 1)) < 0.6, img[:, :1], img)
    img = np.where(rng.random((h, 1, 1)) < 0.3, img[:1], img).astype(np.uint8)
    if form.startswith("psd"):
        _, mode, coding = form.split("_")
        planes = {"rgb": img[..., :3], "cmyk": img, "p": img[..., :1]}[mode].transpose(2, 0, 1)
        extra = {}
        if rng.random() < 0.5:
            extra = {"resources": psd_resource(1005, b"res", rng.bytes(int(rng.integers(0, 9)))),
                     "layers": struct.pack(">I", 4) + rng.bytes(4)}
        palette = rng.bytes(768) if mode == "p" else b""
        return psd_bytes(np.ascontiguousarray(planes), mode.upper(), compression=int(coding == "rle"),
                         palette=palette, **extra)
    if form.startswith("ftex"):
        return ftex_bytes(w, h, 0, bc_blocks("bc1", rng, w, h)) if form == "ftex_bc1" else \
            ftex_bytes(w, h, 1, img[..., :3].tobytes())
    if form == "icns_rle":
        s = min(ICNS_RLE_TYPES, key=lambda t: abs(t - w))
        plane = np.ascontiguousarray(np.resize(img[..., :3], (s, s, 3)))
        return icns_bytes(icns_rle_entries(plane, np.ascontiguousarray(np.resize(img[..., 3], (s, s)))))
    if form == "dds_rgb_masks":
        bitcount, masks = [(16, (0xF800, 0x7E0, 0x1F, 0)), (24, (0xFF0000, 0xFF00, 0xFF, 0)),
                           (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
                           (32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000))][int(rng.integers(0, 4))]
        flags = DDS_PF["rgb"] | (DDS_PF["alpha_pixels"] if masks[3] else 0)
        return dds_bytes(rng.bytes(w * h * bitcount // 8), w, h, flags=flags, bitcount=bitcount, masks=masks)
    fourcc, dxgi = BC_DDS[form[4:]]
    return dds_bytes(bc_blocks(form[4:], rng, w, h), w, h, fourcc=fourcc, dxgi=dxgi)


def container_native_calls(form: str) -> int:
    """Native stage calls a decode of a file of `form` makes on a CUDA run."""
    return 0 if form.endswith("_raw") else 1


class ContainerNative:
    """The native path of CONTAINER_CASE_FORMS' files (`data.jpeg.decode_image` on a CUDA run's host);
    `calls` counts the calls of PSD's and ICNS's stages of csrc/raster.cu and of csrc/bcn.cu's entries."""

    def __call__(self, data: bytes, name: str = "container") -> np.ndarray:
        from uniir_tpu_torch.data import jpeg

        return jpeg.decode_image(data, name, "cuda")

    @property
    def calls(self) -> int:
        from uniir_tpu_torch.data import dds, raster

        return raster.native_calls["packbits"] + raster.native_calls["icns_rle"] + sum(dds.native_calls.values())


# (form, size) of the size check: each form at RASTER_SIZE (ICNS at its largest RLE size, 128 x 128), and BC7
# at 2048 x 2048, a texture's size
CONTAINER_SIZES = tuple((form, (128, 128) if form == "icns_rle" else RASTER_SIZE) for form in CONTAINER_CASE_FORMS) \
    + (("dds_bc7", (2048, 2048)),)


def container_size_case(job: tuple) -> tuple:
    """(file bytes, sha256 of the twin's pixels, the twin's seconds) of CONTAINER_SIZES' (form, size); a
    worker of the decoder phase's pool."""
    import hashlib

    from uniir_tpu_torch.data import jpeg

    form, (w, h) = job
    data = container_case(form, np.random.default_rng(SEED + 8500 + CONTAINER_SIZES.index(job)), w, h)
    t0 = time.perf_counter()
    pixels = jpeg.decode_image(data, form, "cpu")
    return data, hashlib.sha256(pixels.tobytes()).hexdigest(), time.perf_counter() - t0


def raster_size_case(form: str) -> tuple:
    """(file bytes, sha256 of the twin's pixels, the twin's seconds) of `form` (RASTER_CASE_FORMS) at
    RASTER_SIZE; a worker of the decoder phase's pool."""
    import hashlib

    from uniir_tpu_torch.data import jpeg

    data = raster_case(form, np.random.default_rng(SEED + 8000 + RASTER_CASE_FORMS.index(form)), *RASTER_SIZE)
    t0 = time.perf_counter()
    pixels = jpeg.decode_image(data, form, "cpu")
    return data, hashlib.sha256(pixels.tobytes()).hexdigest(), time.perf_counter() - t0


def start_decoder_cases(pool) -> dict:
    """The decoder phase's seeded files and their twins' digests, DECODER_CASES of each kind and one of each
    raster form at RASTER_SIZE ("raster_size"), submitted to `pool` (a spawn pool: the twins are numpy) so
    that they are written and decoded while the card checks its kernels; kind -> futures."""
    # JPEG 2000's twin work first, the longest items (a Python tier 1), so they do not make the pool's tail
    pending = {"jpeg2000_twin": [pool.submit(jpeg2000_twin_digest, name) for name in jpeg2000_small()],
               "avif": [pool.submit(avif_digest, name) for name in avif_small()],
               "jpeg2000": [pool.submit(jpeg2000_case, k) for k in range(DECODER_CASES)],
               "jpeg_damage": [pool.submit(jpeg_damage_case, k) for k in range(JPEG_DAMAGE_CASES)]}
    pending.update({kind: [pool.submit(decoder_case, (kind, k)) for k in range(DECODER_CASES)]
                    for kind in DECODER_KINDS + RAISING_KINDS})
    pending["raster_size"] = [pool.submit(raster_size_case, form) for form in RASTER_CASE_FORMS]
    pending["container_size"] = [pool.submit(container_size_case, job) for job in CONTAINER_SIZES]
    return pending


def check_raising_kinds(cases: dict, smi: str) -> None:
    """The native TIFF decoder (csrc/tiff.cu) on the TIFF_KINDS' files and the native ZSTD decoder
    (csrc/zstd.cuh, in the TIFF library) on the "zstd" frames in both readings: each case's outcome (its pixels'
    or bytes' digest, or the exception it raises) the twin's; the TIFF kinds' rates on one thread."""
    from uniir_tpu_torch.data import tiff, zstd

    for kind, forms in TIFF_KINDS.items():
        calls = tiff.decode_native.calls
        t0 = time.perf_counter()
        got = [outcome_digest(tiff.decode_native, data, f"{kind} case {k}") for k, (data, _) in enumerate(cases[kind])]
        dt = time.perf_counter() - t0
        differ = [k for k, (g, (_, want)) in enumerate(zip(got, cases[kind])) if g != want]
        check(not differ, f"decoder phase: the native {kind} decoder differs from its twin on cases {differ[:5]}")
        decoded = sum(not g.startswith("raises") for g in got)
        check(tiff.decode_native.calls - calls == decoded, f"decoder phase: the native {kind} decoder counted "
              f"{tiff.decode_native.calls - calls} calls for {decoded} decodes")
        raised = sorted({g for g in got if g.startswith("raises")})
        log(f"decoder phase: native {kind} equal to its twin on {len(got)} files ({', '.join(forms)}; "
            f"{len(got) - decoded} raise as the twin raises: {raised}); {len(got) / dt:.1f} images/s on one "
            f"thread (host CPU {host_cpu()}; card {smi})")
    t0 = time.perf_counter()
    differ, raised = [], 0
    for k, (frame, (size, one, streamed)) in enumerate(cases["zstd"]):
        name = f"zstd case {k}"
        got = (outcome_digest(zstd.decompress_native, frame, size, name),
               outcome_digest(zstd.decode_stream_native, frame, size, name))
        raised += sum(g.startswith("raises") for g in got)
        if got != (one, streamed):
            differ.append(k)
    check(not differ, f"decoder phase: the native ZSTD decoder differs from its twin on frames {differ[:5]}")
    size = sum(c[1][0] for c in cases["zstd"])
    log(f"decoder phase: native ZSTD equal to its twin on {len(cases['zstd'])} frames ({', '.join(ZSTD_FORMS)}; "
        f"whole, cut and flipped; {raised} of {2 * len(cases['zstd'])} readings raise as the twin's), "
        f"{size / 1e6:.1f} MB in {time.perf_counter() - t0:.2f} s (host CPU {host_cpu()}; card {smi})")


# the 640 x 480 TIFFs whose single-thread decode rates PERF.md keeps: ZSTD strips at libzstd levels 3 and 19
# (made by libzstd as libtiff streams them; the card's machine has none, so they are stored with Pillow's
# digests), and CIELAB / 2x2 YCbCr files of the writer
TIFF_RATE_DIR = REPO / "tests" / "data" / "tiff"
TIFF_RATE_FILES = {"zstd_level3_640x480.tif": "d5ed311ba69959beac208b61cf9128220560930306ce413792334bc28458e204",
                   "zstd_level19_640x480.tif": "d5ed311ba69959beac208b61cf9128220560930306ce413792334bc28458e204"}


def tiff_rate_image() -> np.ndarray:
    """The 640 x 480 image of the rate files: a noiseless colour gradient (ZSTD keeps it to 41-87 KB, which a
    photo's noise would not)."""
    yy, xx = np.mgrid[0:480, 0:640]
    return np.stack([(xx * (0.3 + c * 0.1) + yy * (0.2 + c * 0.05) + 40 * c) % 256 for c in range(3)], 2).astype(np.uint8)


def check_tiff_rates(smi: str) -> None:
    """Single-thread decode rates of the native TIFF decoder and its twin at 640 x 480: the stored ZSTD files
    (held to Pillow's digests), CIELAB (ZSTD) and 2x2 YCbCr (Deflate) files of the writer (held to the twin)."""
    import hashlib

    from uniir_tpu_torch.data import tiff

    img = tiff_rate_image()
    files = {name: ((TIFF_RATE_DIR / name).read_bytes(), digest) for name, digest in TIFF_RATE_FILES.items()}
    files["lab_zstd_640x480"] = (tiff_bytes(img, 8, compression=50000, rows_per_strip=32), None)
    files["ycbcr22_deflate_640x480"] = (tiff_bytes(img, 6, compression=8, subsampling=(2, 2), rows_per_strip=32), None)
    for name, (data, digest) in files.items():
        t0 = time.perf_counter()
        want = tiff.decode_twin(data, name)
        twin_s = time.perf_counter() - t0
        got = tiff.decode_native(data, name)
        check(np.array_equal(got, want) and (digest is None or hashlib.sha256(got.tobytes()).hexdigest() == digest),
              f"decoder phase: {name} differs from {'Pillow' if digest else 'the twin'}")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            tiff.decode_native(data, name)
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        log(f"decoder phase: TIFF rate {name} ({len(data)} bytes): native {ms:.3f} ms ({1e3 / ms:.1f} images/s, "
            f"{640 * 480 / ms / 1e3:.2f} Mpixel/s) on one thread, median of 5; twin {twin_s * 1e3:.1f} ms "
            f"(host CPU {host_cpu()}; card {smi})")


def check_raster_size(cases: list, threads: int, smi: str) -> None:
    """The native raster stages at RASTER_SIZE, one file of each form: bit-equal to the twin's digest; each
    form's native time (median of 5) beside its twin's (one decode in the pool, beside other work); all
    forms' images/s and Mpixel/s on one thread and on the loader's threads."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    native = RasterNative()
    w, h = RASTER_SIZE
    for form, (data, digest, twin_s) in zip(RASTER_CASE_FORMS, cases):
        out = native(data, form)
        check(hashlib.sha256(out.tobytes()).hexdigest() == digest,
              f"decoder phase: the native {form} decode at {w} x {h} differs from its twin")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            native(data, form)
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        log(f"decoder phase: raster {form} at {w} x {h} ({len(data)} bytes): native {ms:.3f} ms, twin "
            f"{twin_s * 1e3:.1f} ms in the pool ({twin_s * 1e3 / ms:.0f} x)")
    files = [data for data, _, _ in cases] * 4
    t0 = time.perf_counter()
    for data in files:
        native(data)
    one = len(files) / (time.perf_counter() - t0)
    with ThreadPoolExecutor(threads) as loader_threads:
        t0 = time.perf_counter()
        list(loader_threads.map(native, files))
        many = len(files) / (time.perf_counter() - t0)
    log(f"decoder phase: native raster at {w} x {h}, all {len(cases)} forms: {one:.1f} images/s "
        f"({one * w * h / 1e6:.2f} Mpixel/s) on one thread, {many:.1f} images/s ({many * w * h / 1e6:.2f} "
        f"Mpixel/s) on the loader's {threads} threads (host CPU {host_cpu()}; card {smi})")


def check_container_size(cases: list, smi: str) -> None:
    """The native PSD / DDS / ICNS stages at CONTAINER_SIZES, one file each: bit-equal to the twin's digest;
    each one's native time (median of 5) beside its twin's (one decode in the pool, beside other work); all
    forms' images/s and Mpixel/s at RASTER_SIZE on one thread and on 16."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    native = ContainerNative()
    for (form, (w, h)), (data, digest, twin_s) in zip(CONTAINER_SIZES, cases):
        calls = native.calls
        out = native(data, form)
        check(native.calls - calls == container_native_calls(form) and out.shape == (h, w, 3) and
              hashlib.sha256(out.tobytes()).hexdigest() == digest,
              f"decoder phase: the native {form} decode at {w} x {h} differs from its twin")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            native(data, form)
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        log(f"decoder phase: container {form} at {w} x {h} ({len(data)} bytes): native {ms:.3f} ms, twin "
            f"{twin_s * 1e3:.1f} ms in the pool ({twin_s * 1e3 / ms:.0f} x)")
    files = [data for (form, size), (data, _, _) in zip(CONTAINER_SIZES, cases) if size == RASTER_SIZE] * 4
    t0 = time.perf_counter()
    for data in files:
        native(data)
    one = len(files) / (time.perf_counter() - t0)
    with ThreadPoolExecutor(16) as threads:
        t0 = time.perf_counter()
        list(threads.map(native, files))
        many = len(files) / (time.perf_counter() - t0)
    w, h = RASTER_SIZE
    log(f"decoder phase: native containers at {w} x {h}, {len(files) // 4} forms: {one:.1f} images/s "
        f"({one * w * h / 1e6:.2f} Mpixel/s) on one thread, {many:.1f} images/s ({many * w * h / 1e6:.2f} "
        f"Mpixel/s) on 16 threads (host CPU {host_cpu()}; card {smi})")


# the JPEG 2000 corpus scripts/make_jpeg2000_files.py writes with Pillow and OpenJPEG, neither of which this
# machine has: each file beside the shape and SHA-256 of Pillow's pixels (digests.json)
JPEG2000_CORPUS = REPO / "tests" / "data" / "jpeg2000"
JPEG2000_TWIN_TOP = 160  # the twin (Python tier 1) decodes the corpus files up to this size a side
JPEG2000_CASE_TOP = 64  # the seeded derivatives' sources: up to this size a side (the pool decodes each twice)
JPEG2000_RATE_FILES = ("57_vga_lossless.jp2", "58_vga_irreversible.jp2", "60_hd_irreversible.jp2")


# the AVIF corpus scripts/make_avif_files.py writes with Pillow (libavif, aom), which this machine lacks: each
# file beside the shape and SHA-256 of Pillow's pixels (digests.json); the decoder (numpy, both hosts) is held
# to every file up to AVIF_TOP a side here, the 640 x 480 ones timed by scripts/rare_format_rates.py
AVIF_CORPUS = REPO / "tests" / "data" / "avif"
AVIF_TOP = 160
AVIF_QUERY = "04_default_33x65.avif"  # phase 10's AVIF query (the loader decodes it BATCH times)
P13_AVIF = "05_default_70x130.avif"  # MSCOCO's AVIF file under a .jpg name


def avif_small() -> list:
    corpus = json.loads((AVIF_CORPUS / "digests.json").read_text())
    return [name for name, e in corpus.items() if max(e["shape"][:2]) <= AVIF_TOP]


def avif_digest(name: str) -> tuple:
    """(name, shape, SHA-256 of the decoder's pixels, seconds) of one corpus file (a pool worker's job)."""
    import hashlib

    from uniir_tpu_torch.data import avif

    t0 = time.perf_counter()
    out = avif.decode((AVIF_CORPUS / name).read_bytes(), name)
    return name, list(out.shape), hashlib.sha256(out.tobytes()).hexdigest(), time.perf_counter() - t0


def check_avif(results: list, smi: str) -> None:
    """The AVIF decoder (data/avif.py and av1_*.py, numpy on both hosts) equal to Pillow's digests on every
    corpus file up to AVIF_TOP a side, decoded in the decoder phase's pool."""
    corpus = json.loads((AVIF_CORPUS / "digests.json").read_text())
    differ = [name for name, shape, digest, _ in results
              if shape != corpus[name]["shape"] or digest != corpus[name]["sha256"]]
    check(not differ, f"decoder phase: the AVIF decoder differs from Pillow's digests on {differ}")
    pixels = sum(int(np.prod(shape[:2])) for _, shape, _, _ in results)
    seconds = sum(dt for *_, dt in results)
    log(f"decoder phase: AVIF equal to Pillow's digests on all {len(results)} corpus files up to {AVIF_TOP} px a "
        f"side (of {len(corpus)}); {pixels / seconds / 1e6:.3f} Mpixel/s on one pool worker (host CPU "
        f"{host_cpu()}; card {smi})")


def jpeg2000_corpus() -> dict:
    return json.loads((JPEG2000_CORPUS / "digests.json").read_text())


def jpeg2000_small(top: int = JPEG2000_TWIN_TOP) -> list:
    """The corpus files of at most `top` pixels a side."""
    return [name for name, e in jpeg2000_corpus().items() if max(e["shape"][:2]) <= top]


def image_outcome(data: bytes, name: str, device: str) -> str:
    """`data.jpeg.decode_image`'s pixels' SHA-256 on `device`, or its error's type and message."""
    import hashlib

    from uniir_tpu_torch.data import jpeg

    try:
        out = jpeg.decode_image(data, name, device)
    except ValueError as e:
        return f"{type(e).__name__}: {e}"
    return hashlib.sha256(out.tobytes()).hexdigest()


def jpeg2000_case(k: int) -> tuple:
    """(bytes, the twin's outcome) of seeded derivative k of a corpus file of at most JPEG2000_CASE_TOP pixels
    a side: one or two bytes replaced inside the code-block data (k % 3 == 0), a cut (1), or one or two bytes
    replaced in the codestream's headers (2); a worker of the decoder phase's pool."""
    rng = np.random.default_rng(SEED + 7700 + k)
    small = jpeg2000_small(JPEG2000_CASE_TOP)
    data = bytearray((JPEG2000_CORPUS / small[k % len(small)]).read_bytes())
    start, sod = data.find(b"\xff\x4f\xff\x51"), data.find(b"\xff\x93") + 2
    if k % 3 == 1:
        data = data[: int(rng.integers(1, len(data)))]
    else:
        lo, hi = (sod, len(data) - 2) if k % 3 == 0 else (start, sod)
        for at in rng.integers(lo, hi, size=1 + k % 2):
            data[at] = int(rng.integers(0, 256))
    return bytes(data), image_outcome(bytes(data), f"jpeg2000 case {k}", "cpu")


def jpeg2000_twin_digest(name: str) -> str:
    """The twin's pixels' SHA-256 of a corpus file; a worker of the decoder phase's pool."""
    import hashlib

    from uniir_tpu_torch.data import jpeg2000

    return hashlib.sha256(jpeg2000.decode_twin((JPEG2000_CORPUS / name).read_bytes(), name).tobytes()).hexdigest()


def check_jpeg2000(cases: list, twin_digests: list, threads: int, smi: str) -> None:
    """The native JPEG 2000 decoder (csrc/jpeg2000.cu): every corpus file to Pillow's digest (and the twin to
    the same digest on the files up to JPEG2000_TWIN_TOP a side), DECODER_CASES seeded derivatives (flipped
    code-block bytes, cuts, damaged headers) to the twin's outcome, pixels or error alike; then its ms (median
    of 5) and images/s on one thread and on 16 at 640 x 480 and 1920 x 1080."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from uniir_tpu_torch.data import jpeg2000

    corpus = jpeg2000_corpus()
    calls = jpeg2000.decode_native.calls
    for name, entry in corpus.items():
        out = jpeg2000.decode_native((JPEG2000_CORPUS / name).read_bytes(), name)
        check(list(out.shape) == entry["shape"] and hashlib.sha256(out.tobytes()).hexdigest() == entry["sha256"],
              f"decoder phase: the native JPEG 2000 decoder differs from Pillow's pixels of {name}")
    check(jpeg2000.decode_native.calls - calls == len(corpus),
          f"decoder phase: the native JPEG 2000 decoder counted {jpeg2000.decode_native.calls - calls} calls for "
          f"{len(corpus)} files")
    small = jpeg2000_small()
    for name, digest in zip(small, twin_digests):
        check(digest == corpus[name]["sha256"], f"decoder phase: the JPEG 2000 twin differs from Pillow on {name}")
    log(f"decoder phase: native JPEG 2000 equal to Pillow's digests on all {len(corpus)} corpus files, the twin "
        f"on the {len(small)} of them up to {JPEG2000_TWIN_TOP} px a side")
    differ = []
    for k, (data, want) in enumerate(cases):
        got = image_outcome(data, f"jpeg2000 case {k}", "cuda")
        if got != want:
            differ.append((k, want[:80], got[:80]))
    check(not differ, f"decoder phase: native JPEG 2000 differs from its twin on derivatives {differ[:3]}")
    refused = sum(":" in want for _, want in cases)
    log(f"decoder phase: native JPEG 2000 equal to its twin on {len(cases)} seeded derivatives of the corpus files "
        f"up to {JPEG2000_CASE_TOP} px ({refused} refused alike, {len(cases) - refused} decoded to the same pixels)")
    for name in JPEG2000_RATE_FILES:
        data = (JPEG2000_CORPUS / name).read_bytes()
        h, w = corpus[name]["shape"][:2]
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jpeg2000.decode_native(data, name)
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        with ThreadPoolExecutor(16) as pool:
            t0 = time.perf_counter()
            list(pool.map(jpeg2000.decode_native, [data] * 32))
            many = 32 / (time.perf_counter() - t0)
        log(f"decoder phase: native JPEG 2000 {name} ({w} x {h}, {len(data)} bytes): {ms:.2f} ms a decode, "
            f"{1e3 / ms:.1f} images/s ({w * h / ms / 1e3:.2f} Mpixel/s) on one thread, {many:.1f} images/s "
            f"({many * w * h / 1e6:.2f} Mpixel/s) on 16 threads (host CPU {host_cpu()}; card {smi})")


# the damaged-JPEG corpus scripts/make_damaged_jpegs.py writes with Pillow (and the writers here), which this
# machine does not have: each file beside the shape and SHA-256 of Pillow's pixels or the class of Pillow's error
# (digests.json); its clean_* files are the sources of the seeded derivatives
JPEG_DAMAGE_CORPUS = REPO / "tests" / "data" / "jpeg_damage"
JPEG_DAMAGE_KINDS = ("flip", "zeros", "cut", "tail_zero", "junk_segment", "junk_eoi", "rst_missing", "rst_repeated",
                     "rst_wrong", "rst_marker")
JPEG_DAMAGE_CASES = 240  # seeded derivatives of the corpus's clean files, held native against twin
JPEG_CLEAN_RATE_FILE = "clean_vga_420.jpg"  # 640 x 480 baseline 4:2:0, Pillow's quality 85
JPEG_DAMAGE_RATE_FILES = ("vga_420_flips.jpg", "vga_420_zeros.jpg", "vga_restart_rst_missing.jpg",
                          "hd_420_flips_zeros.jpg")
# phase 10's damaged query: a small one (the 640 x 480 file's Python twin took ~4 s of phase 10; it is timed above)
JPEG_DAMAGE_QUERY = "b420_flip.jpg"


def jpeg_damage_corpus() -> dict:
    return json.loads((JPEG_DAMAGE_CORPUS / "digests.json").read_text())


def jpeg_scan_span(data: bytes) -> tuple:
    """(offset of the first scan's entropy-coded data, offset of the last EOI) of a JPEG file."""
    sos = data.index(b"\xff\xda")
    return sos + 2 + int.from_bytes(data[sos + 2 : sos + 4], "big"), data.rindex(b"\xff\xd9")


def jpeg_damage(data: bytes, kind: str, rng) -> bytes:
    """A clean JPEG file damaged as a web crawl's files are: one byte of the entropy-coded data XORed with a
    seeded nonzero byte ("flip"), 4-63 of them zeroed ("zeros"), the data cut inside a scan and EOI appended
    ("cut"), the data zeroed from a point up to EOI ("tail_zero"), 1-5 bytes other than FF put before a marker
    after SOI, between segments or scans ("junk_segment") or before EOI ("junk_eoi"); or a restart marker
    dropped ("rst_missing"), written twice ("rst_repeated"), given another number ("rst_wrong") or turned into
    another marker ("rst_marker": EOI, DHT, TEM, COM or APP1).  A restart kind on a file of none flips a byte."""
    lo, hi = jpeg_scan_span(data)
    b = bytearray(data)
    rst = [i for i in range(lo, hi - 1) if b[i] == 0xFF and 0xD0 <= b[i + 1] <= 0xD7]
    kind = "flip" if kind.startswith("rst") and not rst else kind
    if kind == "flip":
        b[int(rng.integers(lo, hi))] ^= int(rng.integers(1, 256))
    elif kind == "zeros":
        at = int(rng.integers(lo, hi))
        end = min(hi, at + int(rng.integers(4, 64)))
        b[at:end] = bytes(end - at)
    elif kind == "cut":
        b = b[: int(rng.integers(lo, hi))] + b"\xff\xd9"
    elif kind == "tail_zero":
        at = int(rng.integers(lo, hi))
        b[at:hi] = bytes(hi - at)
    elif kind.startswith("junk"):
        junk = bytes(int(v) for v in rng.integers(0, 255, int(rng.integers(1, 6))))
        if kind == "junk_eoi":
            at = hi
        else:  # the markers of the header segments, and those between scans (outside the entropy-coded data)
            at, marks = 2, []
            while b[at + 1] != 0xDA:
                marks.append(at)
                at += 2 + int.from_bytes(b[at + 2 : at + 4], "big")
            marks += [at] + [i for i in range(lo, hi - 1) if b[i] == 0xFF and b[i + 1] not in (0, 0xFF)
                             and not 0xD0 <= b[i + 1] <= 0xD7]
            at = marks[int(rng.integers(0, len(marks)))]
        b[at:at] = junk
    else:
        at = rst[int(rng.integers(0, len(rst)))]
        if kind == "rst_missing":
            del b[at : at + 2]
        elif kind == "rst_repeated":
            b[at:at] = b[at : at + 2]
        elif kind == "rst_wrong":
            b[at + 1] = 0xD0 + (b[at + 1] - 0xD0 + int(rng.integers(1, 8))) % 8
        else:
            b[at + 1] = int(rng.choice([0xD9, 0xC4, 0x01, 0xFE, 0xE1]))
    return bytes(b)


def jpeg_damage_sources() -> list:
    """The corpus's clean files of at most 96 pixels a side: the seeded derivatives' sources."""
    return [name for name, e in sorted(jpeg_damage_corpus().items())
            if name.startswith("clean_") and "shape" in e and max(e["shape"][:2]) <= 96]


def jpeg_damage_case(k: int) -> tuple:
    """(bytes, the twin's outcome) of seeded derivative k: `jpeg_damage` of kind JPEG_DAMAGE_KINDS[k % 10] on
    clean corpus file k // 10 % n; a worker of the decoder phase's pool."""
    sources = jpeg_damage_sources()
    data = (JPEG_DAMAGE_CORPUS / sources[k // len(JPEG_DAMAGE_KINDS) % len(sources)]).read_bytes()
    data = jpeg_damage(data, JPEG_DAMAGE_KINDS[k % len(JPEG_DAMAGE_KINDS)], np.random.default_rng(SEED + 7900 + k))
    return data, image_outcome(data, f"jpeg damage case {k}", "cpu")


def check_jpeg_damage(cases: list, threads: int, smi: str) -> None:
    """The native JPEG decoder on damaged data: every corpus file to Pillow's digest or refused where Pillow
    refuses, JPEG_DAMAGE_CASES seeded derivatives to the twin's outcome (pixels or error alike); then the native
    decode rate (median of 5 on one thread, and over 32 decodes on the loader's threads) at 640 x 480 baseline
    4:2:0 clean and on the damaged 640 x 480 and 1920 x 1080 files."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from uniir_tpu_torch.data import jpeg

    corpus = jpeg_damage_corpus()
    refused = 0
    for name, entry in corpus.items():
        got = image_outcome((JPEG_DAMAGE_CORPUS / name).read_bytes(), name, "cuda")
        if "error" in entry:
            refused += 1
            check(":" in got, f"decoder phase: the native JPEG decoder decodes {name}, which Pillow refuses "
                              f"({entry['error']})")
        else:
            check(got == entry["sha256"], f"decoder phase: the native JPEG decoder differs from Pillow on {name}: "
                                          f"{got[:100]}")
    log(f"decoder phase: native JPEG on the damaged corpus: {len(corpus) - refused} files to Pillow's digests, "
        f"{refused} refused as Pillow refuses them")
    differ, sources = [], jpeg_damage_sources()
    lossless = [k for k in range(len(cases)) if "lossless" in sources[k // len(JPEG_DAMAGE_KINDS) % len(sources)]]
    for k, (data, want) in enumerate(cases):
        calls = jpeg.decode_native.calls
        got = image_outcome(data, f"jpeg damage case {k}", "cuda")
        if got != want:
            differ.append((k, want[:80], got[:80]))
        if k in lossless and ":" not in got:
            check(jpeg.decode_native.calls > calls, f"decoder phase: damaged lossless case {k} decoded without a "
                                                    "native call")
    check(not differ, f"decoder phase: native JPEG differs from its twin on damaged derivatives {differ[:3]}")
    refused = sum(":" in want for _, want in cases)
    lossless_decoded = sum(":" not in cases[k][1] for k in lossless)
    check(lossless_decoded > 0, "decoder phase: no damaged lossless (SOF3) derivative decoded natively")
    log(f"decoder phase: native JPEG equal to its twin on {len(cases)} seeded damaged derivatives of "
        f"{len(sources)} clean files up to 96 px ({refused} refused alike, {len(cases) - refused} "
        f"decoded to the same pixels; {len(lossless)} of lossless SOF3 files, {lossless_decoded} decoded)")
    for name in (JPEG_CLEAN_RATE_FILE,) + JPEG_DAMAGE_RATE_FILES:
        data = (JPEG_DAMAGE_CORPUS / name).read_bytes()
        h, w = corpus[name]["shape"][:2]
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jpeg.decode_native(data, name)
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        with ThreadPoolExecutor(threads) as pool:
            t0 = time.perf_counter()
            list(pool.map(jpeg.decode_native, [data] * 32))
            many = 32 / (time.perf_counter() - t0)
        log(f"decoder phase: native JPEG {name} ({w} x {h}, {len(data)} bytes): {ms:.3f} ms a decode, "
            f"{1e3 / ms:.1f} images/s ({w * h / ms / 1e3:.2f} Mpixel/s) on one thread, {many:.1f} images/s "
            f"({many * w * h / 1e6:.2f} Mpixel/s) on the loader's {threads} threads (host CPU {host_cpu()}; "
            f"card {smi})")


def check_decoders(smi: str, pending: dict, t_started: float) -> None:
    """The decoder phase: the native GIF decoder (csrc/gif.cu), the native JPEG decoder's CMYK, YCCK and RGB
    forms and its SOF1, arithmetic, lossless and smoothed forms (csrc/jpeg.cu), the native WebP decoder
    (csrc/webp.cu), the native TIFF decoder (csrc/tiff.cu with the JPEG strips through csrc/jpeg.cu) and the
    native stages of QOI, TGA, SGI, PCX / DCX, Sun raster, MSP, PSD and ICNS (csrc/raster.cu) and of DDS
    (csrc/bcn.cu) held bit-equal to their twins over DECODER_CASES seeded files each, sizes 1-600 px (1-160
    for the raster forms, 1-200 for PSD / DDS / ICNS;
    `start_decoder_cases`' futures, `pending`, submitted at `t_started`), the WebP, TIFF and JPEG-form
    decoders also to Pillow's digests of WEBP_PILLOW_FILES, TIFF_PILLOW_FILES and JPEG_FORM_PILLOW_FILES;
    the native decoders' images/s and Mpixel/s on one thread and
    on the loader's threads (the shipped embed.yaml's num_workers), beside the card's name and power limit and
    the host CPU."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from uniir_tpu_torch.core.config import load_config
    from uniir_tpu_torch.data import gif, jpeg, tiff, webp

    t_phase = time.perf_counter()
    threads = int(load_config(str(REPO / P12_CONFIGS["embed"])).dataloader_config.num_workers)
    cases = {kind: [f.result() for f in futures] for kind, futures in pending.items()}
    log(f"decoder phase: {DECODER_CASES} GIF, JPEG, WebP, TIFF, SOF1 / arithmetic / lossless / smoothed JPEG and "
        f"QOI / TGA / SGI / PCX / DCX / Sun / MSP and PSD / DDS / ICNS files each written and decoded by the twins, "
        f"{t_phase - t_started:.1f} s after they were started beside "
        f"the kernel checks, done {time.perf_counter() - t_phase:.1f} s later")
    for files, module, label in ((WEBP_PILLOW_FILES, webp, "WebP"), (TIFF_PILLOW_FILES, tiff, "TIFF"),
                                 (JPEG_FORM_PILLOW_FILES, jpeg, "JPEG-form")):
        for name, (b64, digest, w, h) in files.items():
            data = base64.b64decode(b64)
            for fn in (module.decode_twin, module.decode_native):
                got = fn(data, name)
                check(got.shape == (h, w, 3) and hashlib.sha256(got.tobytes()).hexdigest() == digest,
                      f"decoder phase: {module.__name__}.{fn.__name__} differs from Pillow's pixels of {name}")
        log(f"decoder phase: both {label} decoders equal to Pillow's digests on the {len(files)} Pillow-made "
            f"files ({', '.join(files)})")
    for kind, native in (("gif", gif.decode_native), ("jpeg", jpeg.decode_native), ("webp", webp.decode_native),
                         ("tiff", tiff.decode_native), ("jpeg_forms", jpeg.decode_native), ("raster", RasterNative()),
                         ("containers", ContainerNative())):
        files = [data for data, _ in cases[kind]]
        calls = native.calls
        t0 = time.perf_counter()
        outs = [native(data, f"{kind} case {k}") for k, data in enumerate(files)]
        one_thread = len(files) / (time.perf_counter() - t0)
        with ThreadPoolExecutor(threads) as loader_threads:
            t0 = time.perf_counter()
            list(loader_threads.map(native, files))
            many = len(files) / (time.perf_counter() - t0)
        forms = {"gif": GIF_CASE_FORMS, "jpeg": sorted({f for f, _ in JPEG_CASE_FORMS}), "webp": WEBP_CASE_FORMS,
                 "tiff": tuple(TIFF_CASE_FORMS), "jpeg_forms": JPEG_FORM_CASE_FORMS, "raster": RASTER_CASE_FORMS,
                 "containers": CONTAINER_CASE_FORMS}[kind]
        want = 2 * (sum(container_native_calls(forms[k % len(forms)]) for k in range(len(files)))
                     if kind == "containers" else len(files))
        check(native.calls - calls == want, f"decoder phase: the native {kind} decoder counted "
              f"{native.calls - calls} calls for {want} native decodes")
        differ = [k for k, ((_, digest), out) in enumerate(zip(cases[kind], outs))
                  if hashlib.sha256(out.tobytes()).hexdigest() != digest]
        check(not differ, f"decoder phase: the native {kind} decoder differs from its twin on cases {differ[:5]}")
        pixels = sum(out.shape[0] * out.shape[1] for out in outs)
        log(f"decoder phase: native {kind} bit-equal to its twin on {len(files)} files ({', '.join(forms)}; "
            f"{pixels / len(files):.0f} pixels a file on average); {one_thread:.1f} images/s "
            f"({pixels * one_thread / len(files) / 1e6:.2f} Mpixel/s) on one thread, {many:.1f} images/s on the "
            f"loader's {threads} threads (host CPU {host_cpu()}; card {smi})")
        if kind in ("webp", "tiff", "jpeg_forms", "raster", "containers"):
            for form in forms:
                sel = [k for k in range(len(files)) if forms[k % len(forms)] == form]
                t0 = time.perf_counter()
                for k in sel:
                    native(files[k])
                dt = time.perf_counter() - t0
                px = sum(outs[k].shape[0] * outs[k].shape[1] for k in sel)
                log(f"decoder phase: native {kind} {form}: {len(sel) / dt:.1f} images/s, {px / dt / 1e6:.2f} "
                    f"Mpixel/s on one thread ({px / len(sel):.0f} pixels a file)")
    check_raising_kinds(cases, smi)
    check_tiff_rates(smi)
    check_raster_size(cases["raster_size"], threads, smi)
    check_plugin_rates(smi)
    check_container_size(cases["container_size"], smi)
    check_jpeg2000(cases["jpeg2000"], cases["jpeg2000_twin"], threads, smi)
    check_avif(cases["avif"], smi)
    check_jpeg_damage(cases["jpeg_damage"], threads, smi)
    log(f"decoder phase passed in {time.perf_counter() - t_phase:.1f} s")


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
    check_repeats()


REPEAT_CALLS = 50  # K1 / K3 calls on the same inputs, each held bit-equal to the first
REPEAT_SHAPES = ((2, 17, 2), (BATCH, 197, 16))  # partial last tiles: the remat test's L = 17, BLIP's 197


def check_repeats() -> None:
    """K1 and K3 are deterministic: REPEAT_CALLS calls of each on the same inputs give bit-equal outputs
    at partial-tile lengths (one block a head, no atomics; a race or a missing barrier would show here)."""
    from uniir_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for B, L, H in REPEAT_SHAPES:
        q, k, v, do = (torch.randn(B, L, H * 64, generator=g, device="cuda").bfloat16() for _ in range(4))
        first_out, first_grads = A.attention(q, k, v, H), A.attention_bwd(q, k, v, do, H)
        differ = [0, 0]
        for _ in range(REPEAT_CALLS):
            differ[0] += not torch.equal(A.attention(q, k, v, H), first_out)
            differ[1] += not all(torch.equal(a, b) for a, b in zip(A.attention_bwd(q, k, v, do, H), first_grads))
        torch.cuda.synchronize()
        log(f"K1 / K3 repeated {REPEAT_CALLS} times at [{B},{L},{H * 64}] H={H} (routes {A.forward_route(64, L)} / "
            f"{A.backward_route(64, L)}): outputs differing from the first call K1 {differ[0]}, K3 {differ[1]}")
        check(differ == [0, 0], f"K1 / K3 are not deterministic at [{B},{L},{H * 64}]: {differ}")


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


def drive_blip_train_path(results: dict, name: str) -> dict:
    """BLIP momentum-distillation training of `name` (BLIPScoreFusion, or
    BLIPFeatureFusion) at `large` through `build_model_from_config(train=
    True)`, `make_blip_optimizer`, `MomentumTrainState`,
    `make_blip_train_step` (dropout on) and `train_one_epoch` (alpha warmed
    up in epoch 0): 40 pairs, then BLIP-FF at the reference's 115 pairs a
    card.  Remat as the configs set it: off for BLIP-SF, on for BLIP-FF.
    At each batch, one step's loss and gradients through K1 / K3 are held
    against the same step through the twins, under the same dropout draws.  Returns the device's busy ms a
    step at each batch, by torch.profiler."""
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
        busy_ms[bs] = log_device_time_by_group(prof, 2, step_s * 1e3)

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

    busy_ms: dict = {}
    train(BLIP_TRAIN_BS)
    if ff:
        train(BLIP_FF_BS)
    return busy_ms


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
    and sweep again at the 5.6M pool's size.  (b) One request of one PNG
    image query, decoded natively, held to the twins the same way."""
    import dataclasses

    from uniir_tpu_torch.data import png
    from uniir_tpu_torch.data.preprocess import clip_transform
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
    hold_request_to_twins("interactive retriever", got, emb, twin_embeds(retriever), index, cands)

    # (b) one request of one PNG image query towards texts: the file through the native PNG decoder, K1, K2;
    # held to the same request through the twins (the PNG twin decoder, K1's twin, an fp32 search)
    png_rel = "images/query_0.png"
    png_path = os.path.join(root, "mbeir_data", png_rel)
    os.makedirs(os.path.dirname(png_path), exist_ok=True)
    Path(png_path).write_bytes(png_bytes(fixture_image(SEED + 12), 2))
    eval_fn = clip_transform(cfg.image_size)  # the phase's bundle has none: its other requests carry no image
    image_bundle = dataclasses.replace(bundle, img_preprocess_fn=eval_fn, img_preprocess_fn_eval=eval_fn)
    retriever = InteractiveRetriever(index_path, cands_path, "MSCOCO", tools_config(root), bundle=image_bundle,
                                     device=DEVICE)
    retriever.add_queries([("image", None, png_rel, "text")])
    zero_tools_counts()
    decoded = png.decode_native.calls
    got = retriever.retrieve(k=K)
    torch.cuda.synchronize()
    read_tools_counts(results, "interactive retriever, PNG query", {"K1": per_batch, "K2": 1, "K4": 0})
    decoded = png.decode_native.calls - decoded  # the loader pads the one query's batch by repeating its row
    check(decoded == BATCH, f"the PNG query went through the native PNG decoder {decoded} times, not once for each "
          f"of its padded batch's {BATCH} rows")
    emb = retriever._embed_queries()
    native_png = png.decoder_for
    png.decoder_for = lambda device: png.decode_twin  # `data.jpeg.read_image` looks it up at each call
    try:
        plain = twin_embeds(retriever)
    finally:
        png.decoder_for = native_png
    hold_request_to_twins("interactive retriever, PNG query", got, emb, plain, index, cands)
    log(f"interactive retriever, one PNG image query ({png_rel}, {fixture_image(SEED + 12).shape}, decoded natively "
        f"{decoded} times): its {K} candidates {[c['did'] for c in got[0]]}")
    for k, form in enumerate(TOOLS_FORMS):
        drive_image_query(results, image_bundle, index_path, cands_path, index, cands, form, SEED + 13 + k, per_batch)


# phase 10's image queries beyond PNG, as `fixture_file` writes them
TOOLS_FORMS = ("gif", "bmp", "jpeg_cmyk", "webp_lossy", "webp_lossless_alpha", "tiff", "jpeg_arith", "tga_rle", "qoi",
               "dds_bc7", "psd_rle", "jp2_lossless", "j2k_irreversible", "jpeg_damaged", "tiff_zstd", "ftex_bc1", "flc",
               "avif")
# phase 10's JPEG 2000 queries: files of the stored corpus (no JPEG 2000 writer here)
JPEG2000_QUERIES = {"jp2_lossless": "11_rlcp.jp2", "j2k_irreversible": "53_style_bypass_irreversible.j2k"}
QUERY_COS = 0.999  # an image query against the same pixels sent as a baseline JPEG


def swapped_decoders():
    """Every native image decoder swapped for its twin (`data.jpeg.read_image` looks each up at each call),
    each file's bytes decoded once: the loader pads a one-query batch by repeating its row, and the numpy
    twins would decode the same bytes to the same pixels BATCH times.  Call the result to swap them back."""
    from uniir_tpu_torch.data import dds, fli, ftex, gif, icns, jpeg, jpeg2000, msp, pcx, png, psd, qoi, sgi, sun, tga
    from uniir_tpu_torch.data import tiff, webp

    def decoded_once(twin):
        pixels = {}

        def decode(data: bytes, *args):
            if data not in pixels:
                pixels[data] = twin(data, *args)
            return pixels[data].copy()

        return decode

    saved = [(m, m.decoder_for) for m in (gif, jpeg, png, tiff, webp, qoi, tga, sgi, pcx, sun, msp, dds, icns, psd,
                                          jpeg2000, ftex, fli)]
    for module, _ in saved:
        module.decoder_for = lambda device, twin=decoded_once(module.decode_twin): twin

    def restore() -> None:
        for module, fn in saved:
            module.decoder_for = fn

    return restore


def drive_image_query(results: dict, bundle, index_path: str, cands_path: str, index, cands: list, form: str, seed: int,
                      per_batch: int) -> None:
    """One request of one image query from a file of `form` (`fixture_file`: a GIF, a BMP, a CMYK JPEG, a
    lossy WebP, a lossless WebP with alpha, an LZW TIFF, a ZSTD TIFF, an arithmetic-coded progressive JPEG, an RLE TGA, a
    QOI file, a BC7 DDS (`bc7_mode6`), a PackBits PSD, a lossless JP2 or an irreversible J2K file of the
    stored corpus, a damaged 4:2:0 JPEG of the damaged-JPEG corpus, an FTEX file of BC1 blocks
    (`dxt1_encode`), an FLC file of BRUN and SS2 chunks, or an AVIF file of the stored corpus (AVIF_QUERY)) through
    the interactive retriever: the native
    decoder (GIF / JPEG / WebP / TIFF / JPEG 2000, csrc/raster.cu for TGA, QOI, PSD and FLC, csrc/bcn.cu for
    DDS and FTEX; BMP and AVIF have one decoder), K1, K2; held to
    the same request through the twins (the twin decoders, K1's twin, an fp32 search over the bf16 pool), and
    its embedding held to the same pixels sent as a baseline JPEG (quality 95, 4:4:4) through the same path."""
    from uniir_tpu_torch.data import gif, jpeg, jpeg2000, tiff, webp
    from uniir_tpu_torch.retrieval.interactive import InteractiveRetriever

    root = str(WORK)
    rel = f"images/query_{form}.{FORM_SUFFIX.get(form, 'jpg')}"
    path = os.path.join(root, "mbeir_data", rel)
    Path(path).write_bytes(fixture_file(form, seed))
    native = {"gif": gif.decode_native, "jpeg_cmyk": jpeg.decode_native, "webp_lossy": webp.decode_native,
              "webp_lossless_alpha": webp.decode_native, "tiff": tiff.decode_native, "tiff_zstd": tiff.decode_native,
              "jpeg_arith": jpeg.decode_native, "tga_rle": RasterNative(), "qoi": RasterNative(),
              "dds_bc7": ContainerNative(), "psd_rle": ContainerNative(), "jp2_lossless": jpeg2000.decode_native,
              "j2k_irreversible": jpeg2000.decode_native, "jpeg_damaged": jpeg.decode_native,
              "ftex_bc1": ContainerNative(), "flc": RasterNative()}.get(form)

    def request(query_rel: str):
        retriever = InteractiveRetriever(index_path, cands_path, "MSCOCO", tools_config(root), bundle=bundle,
                                         device=DEVICE)
        retriever.add_queries([("image", None, query_rel, "text")])
        return retriever

    retriever = request(rel)
    zero_tools_counts()
    calls = native.calls if native else 0
    got = retriever.retrieve(k=K)
    torch.cuda.synchronize()
    read_tools_counts(results, f"interactive retriever, {form} query", {"K1": per_batch, "K2": 1, "K4": 0})
    if native:
        decoded = native.calls - calls  # the loader pads the one query's batch by repeating its row
        check(decoded == BATCH, f"the {form} query went through the native decoder {decoded} times, not {BATCH}")
    emb = retriever._embed_queries()
    restore = swapped_decoders()
    try:
        plain = twin_embeds(retriever)
        pixels = jpeg.read_image(path, "cpu")
    finally:
        restore()
    hold_request_to_twins(f"interactive retriever, {form} query", got, emb, plain, index, cands)
    baseline_rel = f"images/query_{form}_as_baseline.jpg"
    Path(os.path.join(root, "mbeir_data", baseline_rel)).write_bytes(jpeg_bytes(pixels, 95, sampling=(1, 1)))
    as_jpeg = request(baseline_rel)._embed_queries()
    cos = cosine(torch.from_numpy(emb).float(), torch.from_numpy(as_jpeg).float())
    log(f"interactive retriever, one {form} image query ({rel}, {pixels.shape}): its {K} candidates "
        f"{[c['did'] for c in got[0]]}; cosine to the same pixels as a baseline JPEG (q95, 4:4:4) {cos}")
    check(cos >= QUERY_COS, f"the {form} query embeds away from the same pixels as a baseline JPEG: cosine {cos}")


def hold_request_to_twins(path: str, got: list, emb: np.ndarray, plain: np.ndarray, index, cands: list) -> None:
    """A request's candidates against an fp32 search over the bf16 pool of its queries embedded through the
    plain twins (`plain`): equal but for ties within the two embeddings' score difference, and every
    returned entry the pool's own."""
    from uniir_tpu_torch.data.registry import hash_did
    from uniir_tpu_torch.retrieval.index import normalize_l2

    cos = torch.nn.functional.cosine_similarity(torch.from_numpy(emb).float(), torch.from_numpy(plain).float(), dim=1)
    log(f"{path}: queries through K1 vs through its twin: min cosine {cos.min().item()}")
    check(cos.min().item() >= 0.999, f"{path}: query embeddings through the kernel disagree with the plain path")
    ref_scores, ref_rows = brute_force_topk(torch.from_numpy(normalize_l2(plain)).to(DEVICE),
                                            torch.from_numpy(index.embeds).to(DEVICE).bfloat16(), index.ntotal, K)
    ids = torch.from_numpy(index.ids[ref_rows.cpu().numpy()])
    tie = 2 * (bf16_scores(emb, index.embeds) - bf16_scores(plain, index.embeds)).abs().max().item() + 1e-5
    got_ids = torch.tensor([[hash_did(c["did"]) for c in row] for row in got])
    by_did = {c["did"]: c for c in cands}
    hits = dict(Counter(c["modality"] for row in got for c in row))
    log(f"{path} against the twins' fp32 search: {int((got_ids != ids).sum())} of {got_ids.numel()} ranks "
        f"differ, tie allowance {tie}; the hits' modalities {hits}")
    check(same_ranking(got_ids, ids, ref_scores.cpu(), tie),
          f"{path}: the candidates differ from the twins' search beyond ties")
    check(all(c == by_did[c["did"]] for row in got for c in row), f"{path}: altered candidate entries returned")


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


def log_device_time_by_group(prof, n_steps: int, wall_ms: float) -> float:
    """Device time per step of a torch.profiler run, by kernel group, and the device's idle share; returns
    the device's busy ms a step."""
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
    return busy


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


# ------------------------------------------------ phase 12: the entry points as a user runs them

P12_SEED = SEED + 120
P12_CANDS, P12_QUERIES, P12_TRAIN_QUERIES = 1024, 256, 120
P12_WORDS, P12_MERGES = 1000, 3000
P12_BATCH, P12_TRAIN_BS = 256, 32  # batches the fixture fills: 4 of candidates, 1 of queries; 3 CLIP-SF train steps
P12_BLIP_TRAIN_BS = 40  # BLIP-SF's trainer: 3 steps of 40 pairs
P12_DECODE_REPEATS = 10  # decodes of each PNG / progressive file for their rates
P12_TRANSFORM_SAMPLE = 100  # images BLIP's train transform is timed on
# the image files that are not the writer's baseline JPEGs, by candidate index, test query and train query (the
# image-bearing ones: candidates with i % 3 != 0, queries with j % 4 == 2); any other image is `jpeg`
P12_FORMS = {
    "cand": {1: "png_rgb", 2: "png_palette", 4: "png_grey", 5: "png_rgba", 7: "png_rgb16", 8: "progressive_420_q75",
             10: "progressive_444_q75_restart5", 11: "progressive_grey_q75", 13: "gif", 14: "bmp", 16: "jpeg_cmyk",
             17: "jpeg_ycck", 19: "jpeg_rgb", 20: "webp_lossy", 22: "webp_lossless_alpha", 23: "webp_alpha",
             25: "tiff", 26: "jpeg_arith"},
    "query": {2: "png_rgb", 6: "progressive_420_q75", 10: "png_grey", 14: "gif", 18: "bmp", 22: "jpeg_cmyk",
              26: "webp_lossy", 30: "webp_lossless_alpha", 34: "webp_alpha", 38: "tiff", 42: "jpeg_arith"},
    "train": {2: "png_palette", 6: "png_rgb16", 10: "progressive_444_q75_restart5", 14: "png_rgba",
              18: "progressive_grey_q75", 22: "webp_lossy", 26: "webp_lossless_alpha", 30: "webp_alpha", 34: "tiff",
              38: "jpeg_arith"},
}
IMAGE_SHORT_SIDE = 256  # the M-BEIR construction's short side (uniir_tpu/data/registry.py)
P12_DATASET, P12_POOL, P12_DSID = "mscoco_task0", "mscoco_task0_test", 9  # as the shipped configs name them
P12_BLOCKED = ("yaml", "PIL", "regex")  # what the card's machine lacks; stubbed out in the runs' PYTHONPATH
P12_CONFIGS = {
    "embed": "configs/clip_sf/large/eval/inbatch/embed.yaml",
    "index": "configs/clip_sf/large/eval/inbatch/index.yaml",
    "retrieval": "configs/clip_sf/large/eval/inbatch/retrieval.yaml",
    "train": "configs/clip_sf/large/train/inbatch/inbatch.yaml",
    "blip_embed": "configs/blip_sf/large/eval/inbatch/embed.yaml",
    "blip_train": "configs/blip_sf/large/train/inbatch/inbatch.yaml",
}
P12_EXPT = {"clip": "CLIP_SF/Large/Instruct/InBatch/", "blip": "BLIP_SF/Large/Instruct/InBatch/"}
P12_QUERY_KINDS = ("text", "image", "image,text", "text")
P12_COS = 0.9999  # the CLI's embeddings against the in-code path's, every row


# --- the JPEG writer: Pillow's defaults, without Pillow

# ITU T.81 Annex K: the example quantisation tables (natural order) and Huffman tables (DHT payloads:
# class / id, 16 counts, symbols), which libjpeg -- and so Pillow -- writes by default
JPEG_LUMA_Q = [
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
]
JPEG_CHROMA_Q = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99,
                 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32
JPEG_DHT = [bytes.fromhex(h) for h in (
    "0000010501010101010100000000000000000102030405060708090a0b",
    "100002010303020403050504040000017d01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282"
    "090a161718191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a8384"
    "85868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3"
    "e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    "0100030101010101010101010000000000000102030405060708090a0b",
    "1100020102040403040705040400010277000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a"
    "162434e125f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82"
    "838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2"
    "e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa",
)]
JPEG_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
    28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
    54, 47, 55, 62, 63,
])


def jpeg_quant_table(base: list, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling of an Annex K table, clamped to 1..255 (baseline)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((np.asarray(base) * scale + 50) // 100, 1, 255)


def huffman_codes(dht: bytes):
    """(code, length) arrays indexed by symbol, from a DHT payload."""
    counts, symbols = dht[1:17], dht[17:]
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


def pack_bits(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """The codes' bits, most significant first, padded with 1s to a byte and 0xFF-stuffed."""
    total = int(lengths.sum())
    item = np.repeat(np.arange(len(codes)), lengths)
    offset = np.arange(total) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    bits = (codes[item] >> (lengths[item] - 1 - offset)) & 1
    data = np.packbits(np.concatenate([bits, np.ones(-total % 8, np.int64)]).astype(np.uint8))
    return np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0).tobytes()


class ArithEncoder:
    """jcarith.c's QM encoder (T.81 Annex D): `encode(stats, index, bit)`, `finish()` -> the stuffed bytes."""

    def __init__(self):
        self.out, self.c, self.a, self.sc, self.zc, self.ct, self.buffer = bytearray(), 0, 0x10000, 0, 0, 11, -1

    def _emit(self, byte: int) -> None:
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _flush_zeros(self) -> None:
        self.out += b"\x00" * self.zc
        self.zc = 0

    def _byte_out(self, temp: int) -> None:
        if temp > 0xFF:  # a carry over all stacked 0xFF bytes
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
            self.buffer = temp & 0xFF

    def encode(self, st: bytearray, i: int, val: int) -> None:
        from uniir_tpu_torch.data.jpeg import ARITAB

        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:  # renormalisation and output (D.1.6)
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _arith_value(enc: ArithEncoder, st: bytearray, v: int, first: int, wide_from: int) -> None:
    """F.8 / F.9 for |v| - 1 = `v` (> 0 done by the caller's nonzero decision): the magnitude category from
    bin `first` (then `wide_from`), then its bits from 14 bins further."""
    m = 0
    p = first
    if v:
        enc.encode(st, p, 1)
        m, v2 = 1, v
        v2 >>= 1
        if wide_from is None:  # DC: the category ladder starts at bin 20
            p = 20
            while v2:
                enc.encode(st, p, 1)
                m <<= 1
                p += 1
                v2 >>= 1
        elif v2:
            enc.encode(st, p, 1)
            m <<= 1
            p = wide_from
            v2 >>= 1
            while v2:
                enc.encode(st, p, 1)
                m <<= 1
                p += 1
                v2 >>= 1
    enc.encode(st, p, 0)
    p += 14
    m >>= 1
    while m:
        enc.encode(st, p, 1 if m & v else 0)
        m >>= 1


def _arith_dc(enc: ArithEncoder, st: bytearray, ctx: int, diff: int, lo: int, hi: int) -> int:
    """Encode_DC_DIFF (F.4): returns the next conditioning context."""
    if diff == 0:
        enc.encode(st, ctx, 0)
        return 0
    enc.encode(st, ctx, 1)
    sign = diff < 0
    enc.encode(st, ctx + 1, int(sign))
    v = abs(diff) - 1
    m = 1 << v.bit_length() >> 1 if v else 0  # the category's top bit, as the ladder leaves m
    _arith_value(enc, st, v, ctx + 2 + sign, None)
    return 0 if m < (1 << lo) >> 1 else (12 if m > (1 << hi) >> 1 else 4) + 4 * sign


def _arith_ac(enc: ArithEncoder, st: bytearray, fixed: bytearray, vals: list, ss: int, se: int, kx: int) -> None:
    """Encode_AC_Coefficients (F.5) of one block's zigzag values (point-transformed) over ss..se."""
    ke = se
    while ke >= ss and not vals[ke]:
        ke -= 1
    k = ss
    while k <= ke:
        p = 3 * (k - 1)
        enc.encode(st, p, 0)
        while not vals[k]:
            enc.encode(st, p + 1, 0)
            p += 3
            k += 1
        enc.encode(st, p + 1, 1)
        enc.encode(fixed, 0, int(vals[k] < 0))
        _arith_value(enc, st, abs(vals[k]) - 1, p + 2, 189 if k <= kx else 217)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _arith_ac_refine(enc: ArithEncoder, st: bytearray, fixed: bytearray, full: list, ss: int, se: int, ah: int,
                     al: int) -> None:
    """Encode_AC_Coefficients_SA (G.10): one block's zigzag values `full` refined from Ah to Al."""
    def shifted(v, a):
        return v >> a if v >= 0 else -((-v) >> a)

    ke = se
    while ke > 0 and not shifted(full[ke], al):
        ke -= 1
    kex = ke
    while kex > 0 and not shifted(full[kex], ah):
        kex -= 1
    k = ss
    while k <= ke:
        p = 3 * (k - 1)
        if k > kex:
            enc.encode(st, p, 0)
        while True:
            v = abs(full[k]) >> al
            if v:
                if v >> 1:  # already nonzero: its next bit
                    enc.encode(st, p + 2, v & 1)
                else:
                    enc.encode(st, p + 1, 1)
                    enc.encode(fixed, 0, int(full[k] < 0))
                break
            enc.encode(st, p + 1, 0)
            p += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def jpeg_arith_bytes(comps: list, order: list, factors: list, ids, tq, tables, jfif: bool, adobe, restart: int,
                     progressive: bool, dac: dict, w_img: int, h_img: int, n_mcus: int) -> bytes:
    """The arithmetic-coded file of `jpeg_bytes`'s quantised zigzag blocks (SOF9, or SOF10 in libjpeg's
    jpeg_simple_progression for 3 components and one DC / AC-band / refinement script otherwise)."""
    nc = len(comps)
    cond = [(dac.get(t, (0, 1, 5))) for t in range(16)]
    per_mcu = len(order) // n_mcus
    if not progressive:
        script = [(list(range(nc)), 0, 63, 0, 0)]
    elif nc == 3:
        script = [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1), ([1], 1, 63, 0, 1),
                  ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1), ([0, 1, 2], 0, 0, 1, 0), ([2], 1, 63, 1, 0),
                  ([1], 1, 63, 1, 0), ([0], 1, 63, 1, 0)]
    else:
        script = ([(list(range(nc)), 0, 0, 0, 1)] + [([c], 1, 5, 0, 2) for c in range(nc)]
                  + [([c], 6, 63, 0, 1) for c in range(nc)] + [([c], 1, 5, 2, 1) for c in range(nc)]
                  + [(list(range(nc)), 0, 0, 1, 0)] + [([c], 1, 63, 1, 0) for c in range(nc)])

    def shifted(v, a):
        return v >> a if v >= 0 else -((-v) >> a)

    scans = b""
    for comp_list, ss, se, ah, al in script:
        if len(comp_list) > 1 or not progressive:
            units = [[(c, r, q) for c, r, q in order[m * per_mcu: (m + 1) * per_mcu] if c in comp_list]
                     for m in range(n_mcus)]
        else:
            c = comp_list[0]
            h, v = factors[c]
            hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
            cw, ch = -(-w_img * h // hmax), -(-h_img * v // vmax)
            units = [[(c, r, q)] for r in range(-(-ch // 8)) for q in range(-(-cw // 8))]
        segs, enc = [], None
        for m, unit in enumerate(units):
            if m % (restart or len(units)) == 0:
                if enc is not None:
                    segs.append(enc.finish())
                enc, fixed = ArithEncoder(), bytearray([113])
                dc_st = {t: bytearray(64) for t in range(16)}
                ac_st = {t: bytearray(256) for t in range(16)}
                last, ctx = [0] * nc, [0] * nc
            for c, r, q in unit:
                zz = comps[c][r, q].tolist()
                t = tq[c]
                if ss == 0 and ah == 0:
                    val = zz[0] >> al
                    ctx[c] = _arith_dc(enc, dc_st[t], ctx[c], val - last[c], cond[t][0], cond[t][1])
                    last[c] = val
                elif ss == 0:
                    enc.encode(fixed, 0, (zz[0] >> al) & 1)
                if se and ah == 0:
                    _arith_ac(enc, ac_st[t], fixed, [shifted(x, al) for x in zz], max(ss, 1), se, cond[t][2])
                elif se:
                    _arith_ac_refine(enc, ac_st[t], fixed, zz, ss, se, ah, al)
        segs.append(enc.finish())
        data = b"".join(seg + (bytes([0xFF, 0xD0 + k % 8]) if k + 1 < len(segs) else b"")
                        for k, seg in enumerate(segs))
        sos = bytes([len(comp_list)]) + b"".join(bytes([ids[c], 0x11 * tq[c]]) for c in comp_list)
        scans += _jpeg_segment(0xDA, sos + bytes([ss, se, (ah << 4) | al])) + data

    out = b"\xff\xd8" + (_jpeg_segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00") if jfif else b"")
    if adobe is not None:
        out += _jpeg_segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    for t in sorted(set(tq)):
        out += _jpeg_segment(0xDB, bytes([t]) + bytes(tables[t][JPEG_ZIGZAG].astype(np.uint8)))
    sof = bytes([8]) + h_img.to_bytes(2, "big") + w_img.to_bytes(2, "big") + bytes([nc])
    for c, (h, v) in enumerate(factors):
        sof += bytes([ids[c], (h << 4) | v, tq[c]])
    out += _jpeg_segment(0xCA if progressive else 0xC9, sof)
    if dac:
        out += _jpeg_segment(0xCC, b"".join(bytes([t, (u << 4) | lo, 16 + t, kx]) for t, (lo, u, kx) in dac.items()))
    if restart:
        out += _jpeg_segment(0xDD, restart.to_bytes(2, "big"))
    return out + scans + b"\xff\xd9"


def _jpeg_segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


# one Huffman table of the 17 difference categories of lossless JPEG, every code 5 bits long
JPEG_LOSSLESS_DHT = bytes([0, 0, 0, 0, 0, 17] + [0] * 11 + list(range(17)))


def jpeg_lossless_bytes(planes: list, factors: list, ids, jfif: bool, adobe, restart_rows: int, predictor: int,
                        pt: int) -> bytes:
    """A lossless JPEG (SOF3) of `planes` (float, rounded to 8-bit samples, one interleaved scan): each sample
    >> pt predicted as jdlossls.c undoes it (the first row and each restart interval's first row from the
    left, starting at 2^(7 - pt); the first column from above), the differences modulo 2^16 Huffman-coded
    with JPEG_LOSSLESS_DHT; a restart every `restart_rows` MCU rows."""
    h_img, w_img = planes[0].shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-w_img // hmax), -(-h_img // vmax)
    code_of, len_of = huffman_codes(JPEG_LOSSLESS_DHT)
    diffs = []
    for plane, (h, v) in zip(planes, factors):
        fx, fy = hmax // h, vmax // v
        px = np.clip(np.rint(plane), 0, 255).astype(np.int64)
        px = np.pad(px, ((0, mcuy * vmax - h_img), (0, mcux * hmax - w_img)), mode="edge")
        px = px.reshape(px.shape[0] // fy, fy, px.shape[1] // fx, fx)[:, 0, :, 0] >> pt
        cw, ch = -(-w_img * h // hmax), -(-h_img * v // vmax)
        d = np.zeros_like(px)
        for y in range(ch):
            first = y == 0 or (restart_rows and y % (restart_rows * v) == 0)
            for x in range(cw):
                ra = px[y, x - 1] if x else None
                if first:
                    pred = (1 << (7 - pt)) if x == 0 else ra
                elif x == 0:
                    pred = px[y - 1, 0]
                else:
                    rb, rc = px[y - 1, x], px[y - 1, x - 1]
                    pred = [None, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                            (ra + rb) >> 1][predictor]
                d[y, x] = (px[y, x] - pred) & 0xFFFF
        diffs.append(d)
    units = [[(c, r * v + y, q * h + x) for c, (h, v) in enumerate(factors) for y in range(v) for x in range(h)]
             for r in range(mcuy) for q in range(mcux)]
    interval = restart_rows * mcux if restart_rows else len(units)
    segs = []
    for k in range(0, len(units), interval):
        codes, lengths = [], []
        for unit in units[k: k + interval]:
            for c, r, q in unit:
                dv = int(diffs[c][r, q])
                dv = dv - 65536 if dv > 32768 else dv
                s = 16 if dv == 32768 else (abs(dv).bit_length())
                extra = 0 if s in (0, 16) else (dv if dv >= 0 else dv + (1 << s) - 1)
                codes.append((int(code_of[s]) << (0 if s == 16 else s)) | extra)
                lengths.append(int(len_of[s]) + (0 if s == 16 else s))
        segs.append(pack_bits(np.array(codes, np.int64), np.array(lengths, np.int64)))
    data = b"".join(seg + (bytes([0xFF, 0xD0 + k % 8]) if k + 1 < len(segs) else b"") for k, seg in enumerate(segs))
    out = b"\xff\xd8" + (_jpeg_segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00") if jfif else b"")
    if adobe is not None:
        out += _jpeg_segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    sof = bytes([8]) + h_img.to_bytes(2, "big") + w_img.to_bytes(2, "big") + bytes([len(planes)])
    for c, (h, v) in enumerate(factors):
        sof += bytes([ids[c], (h << 4) | v, 0])
    out += _jpeg_segment(0xC3, sof) + _jpeg_segment(0xC4, JPEG_LOSSLESS_DHT)
    if restart_rows:
        out += _jpeg_segment(0xDD, interval.to_bytes(2, "big"))
    sos = bytes([len(planes)]) + b"".join(bytes([ids[c], 0x00]) for c in range(len(planes)))
    return out + _jpeg_segment(0xDA, sos + bytes([predictor, 0, pt])) + data + b"\xff\xd9"


# the colour forms the writer takes beyond YCbCr / grey: (component ids, quantisation and Huffman table of each,
# Adobe APP14 transform or None, JFIF); libjpeg's jpeg_set_colorspace writes RGB and CMYK with ids 'R' 'G' 'B' /
# 'C' 'M' 'Y' 'K', table 0 for every component and an Adobe marker, YCCK with ids 1-4, tables 0, 1, 1, 0
JPEG_FORMS = {
    "ycbcr": ((1, 2, 3), (0, 1, 1), None, True),
    "rgb": ((82, 71, 66), (0, 0, 0), 0, False),  # Adobe transform 0: RGB as stored
    "rgb_ids": ((82, 71, 66), (0, 0, 0), None, False),  # no marker: RGB by the component ids alone
    "cmyk": ((67, 77, 89, 75), (0, 0, 0, 0), 0, False),
    "ycck": ((1, 2, 3, 4), (0, 1, 1, 0), 2, False),
}


def jpeg_bytes(image: np.ndarray, quality: int = 75, sampling=(2, 2), restart: int = 0, form: str = "ycbcr",
               factors=None, coding: str = "huffman", progressive: bool = False, dac: dict = None,
               predictor: int = 1, point_transform: int = 0) -> bytes:
    """A baseline JPEG of uint8 [H, W, 3] (YCbCr, the luma sampled `sampling` = (h, v) times as finely as
    the chroma) or [H, W] (greyscale), in the form Pillow writes at its defaults: JFIF, Annex K tables
    scaled to `quality`, one interleaved scan; `restart` MCUs between RSTn markers (0: none).

    `form` (JPEG_FORMS) writes other colour spaces as libjpeg does: "rgb" (Adobe transform 0) and "rgb_ids"
    (no marker, ids 'R' 'G' 'B') store [H, W, 3] as it is; "cmyk" (Adobe transform 0) stores [H, W, 4] as it
    is, and "ycck" (Adobe transform 2) stores the YCbCr of (255 - C, 255 - M, 255 - Y) and K, libjpeg's
    cmyk_ycck_convert: the 4 channels are the CMYK values the file holds (Pillow writes 255 minus its
    CMYK).  `factors` gives each component's (h, v) sampling; by default every component of "rgb" /
    "cmyk" is 1x1 (libjpeg's default) and "ycck" samples Y and K by `sampling`.

    `coding` "arithmetic" writes the same coefficients arithmetic-coded (SOF9, or SOF10 with `progressive`
    in libjpeg's simple progression) with `jcarith.c`'s encoder; `dac` {table: (L, U, Kx)} writes a DAC
    marker.  "lossless" writes SOF3: the samples (no DCT) differenced by `predictor` (1-7) after the
    `point_transform`, Huffman-coded with one table; `restart` then counts MCU rows."""
    grey = image.ndim == 2
    h_img, w_img = image.shape[:2]
    px = image.astype(np.float64)
    ids, tq, adobe, jfif = ((1,), (0,), None, True) if grey else JPEG_FORMS[form]

    def ycc(r, g, b):
        return [0.299 * r + 0.587 * g + 0.114 * b, -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                0.5 * r - 0.418688 * g - 0.081312 * b + 128]

    if grey:
        planes, default = [px], [(1, 1)]
    elif form == "ycbcr":
        planes, default = ycc(px[..., 0], px[..., 1], px[..., 2]), [tuple(sampling), (1, 1), (1, 1)]
    elif form == "ycck":
        planes = ycc(255 - px[..., 0], 255 - px[..., 1], 255 - px[..., 2]) + [px[..., 3]]
        default = [tuple(sampling), (1, 1), (1, 1), tuple(sampling)]
    else:
        planes = [px[..., c] for c in range(image.shape[2])]
        default = [(1, 1)] * len(planes)
    if len(planes) != len(ids):
        raise ValueError(f"form {form} takes {len(ids)} channels, not {len(planes)}")
    factors = [tuple(f) for f in (factors or default)]
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    if coding == "lossless":
        return jpeg_lossless_bytes(planes, factors, ids, jfif, adobe, restart, predictor, point_transform)
    mcux, mcuy = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    tables = [jpeg_quant_table(JPEG_LUMA_Q, quality), jpeg_quant_table(JPEG_CHROMA_Q, quality)]
    dct = np.array([[np.sqrt((1 if u == 0 else 2) / 8) * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                    for u in range(8)])
    comps = []  # per component: zigzag-ordered quantised blocks [block rows, block columns, 64]
    for c, (plane, (h, v)) in enumerate(zip(planes, factors)):
        fx, fy = hmax // h, vmax // v
        plane = np.pad(plane, ((0, mcuy * vmax * 8 - h_img), (0, mcux * hmax * 8 - w_img)), mode="edge")
        plane = plane.reshape(plane.shape[0] // fy, fy, plane.shape[1] // fx, fx).mean(axis=(1, 3))
        blocks = plane.reshape(plane.shape[0] // 8, 8, plane.shape[1] // 8, 8).transpose(0, 2, 1, 3) - 128.0
        coef = np.einsum("ux,rqxy,vy->rquv", dct, blocks, dct).reshape(blocks.shape[0], blocks.shape[1], 64)
        comps.append(np.rint(coef / tables[tq[c]]).astype(np.int64)[:, :, JPEG_ZIGZAG])
    # the blocks in scan order: MCU by MCU, each component's h x v blocks
    order = [(c, r * v + y, q * h + x) for r in range(mcuy) for q in range(mcux)
             for c, (h, v) in enumerate(factors) for y in range(v) for x in range(h)]
    if coding == "arithmetic":
        return jpeg_arith_bytes(comps, order, factors, ids, tq, tables, jfif, adobe, restart, progressive,
                                dac or {}, w_img, h_img, mcux * mcuy)
    comp_of = np.array([o[0] for o in order])
    zz = np.stack([comps[c][r, q] for c, r, q in order])  # [blocks, 64]
    interval = (restart or mcux * mcuy) * (len(order) // (mcux * mcuy))  # blocks between restarts
    dc = zz[:, 0]
    prev = np.zeros_like(dc)  # each block predicts from its component's previous block in its interval
    for c in range(len(planes)):
        idx = np.flatnonzero(comp_of == c)
        pred = np.concatenate([[0], dc[idx][:-1]])
        pred[np.r_[True, idx[1:] // interval != idx[:-1] // interval]] = 0
        prev[idx] = pred
    huff = [huffman_codes(t) for t in JPEG_DHT]  # DC luma, AC luma, DC chroma, AC chroma

    def category(v):
        return np.where(v == 0, 0, np.floor(np.log2(np.maximum(np.abs(v), 1))).astype(np.int64) + 1)

    def extra(v, s):
        return np.where(v >= 0, v, v + (1 << s) - 1) & ((1 << s) - 1)

    def code(table_of, dc_or_ac: int, symbol):
        """(code, length) of `symbol` in the luma or chroma table of each item."""
        pick = [huff[dc_or_ac], huff[2 + dc_or_ac]]
        return (np.choose(table_of, [pick[0][0][symbol], pick[1][0][symbol]]),
                np.choose(table_of, [pick[0][1][symbol], pick[1][1][symbol]]))

    table = np.asarray(tq)[comp_of]  # 0: the luma tables, 1: the chroma ones
    # items (block, key within the block, code, length): the DC at key 0, an AC value at 2 * position with
    # its ZRLs (runs of 16 zeros) at 2 * position - 1, the EOB last
    diff = dc - prev
    s = category(diff)
    dc_code, dc_len = code(table, 0, s)
    items = [(np.arange(len(zz)), np.zeros(len(zz), np.int64), (dc_code << s) | extra(diff, s), dc_len + s)]
    blk, pos = np.nonzero(zz[:, 1:])
    pos = pos + 1
    val = zz[blk, pos]
    run = pos - np.where(np.r_[True, blk[1:] != blk[:-1]], 0, np.r_[0, pos[:-1]]) - 1
    s = category(val)
    ac_code, ac_len = code(table[blk], 1, ((run % 16) << 4) | s)
    items.append((blk, 2 * pos, (ac_code << s) | extra(val, s), ac_len + s))
    zblk = np.repeat(blk, run // 16)
    items.append((zblk, np.repeat(2 * pos - 1, run // 16), *code(table[zblk], 1, np.full(len(zblk), 0xF0))))
    eob = np.flatnonzero(zz[:, 63] == 0)
    items.append((eob, np.full(len(eob), 200), *code(table[eob], 1, np.zeros(len(eob), np.int64))))
    blocks_of, keys, codes, lengths = (np.concatenate(parts) for parts in zip(*items))
    ordered = np.lexsort((keys, blocks_of))
    blocks_of, codes, lengths = blocks_of[ordered], codes[ordered], lengths[ordered]
    starts = np.searchsorted(blocks_of, np.arange(0, len(zz), interval))
    scan = b""
    for k, (a, b) in enumerate(zip(starts, np.r_[starts[1:], len(blocks_of)])):
        if k:
            scan += bytes([0xFF, 0xD0 + (k - 1) % 8])
        scan += pack_bits(codes[a:b], lengths[a:b])

    def segment(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    out = b"\xff\xd8" + (segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00") if jfif else b"")
    if adobe is not None:  # libjpeg's write_marker for APP14: version 100, flags 0, 0, the transform
        out += segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    for t in sorted(set(tq)):
        out += segment(0xDB, bytes([t]) + bytes(tables[t][JPEG_ZIGZAG].astype(np.uint8)))
    sof = bytes([8]) + h_img.to_bytes(2, "big") + w_img.to_bytes(2, "big") + bytes([len(planes)])
    for c, (h, v) in enumerate(factors):
        sof += bytes([ids[c], (h << 4) | v, tq[c]])
    out += segment(0xC0, sof)
    for t in sorted(set(tq)):
        out += segment(0xC4, JPEG_DHT[2 * t]) + segment(0xC4, JPEG_DHT[2 * t + 1])
    if restart:
        out += segment(0xDD, restart.to_bytes(2, "big"))
    sos = bytes([len(planes)]) + b"".join(bytes([ids[c], 0x11 * tq[c]]) for c in range(len(planes)))
    return out + segment(0xDA, sos + bytes([0, 63, 0])) + scan + b"\xff\xd9"


# --- the ZSTD writer: Zstandard frames (RFC 8878) without libzstd, for the decoders' seeded cases



def _zstd_code(value: int, base: list, bits: list) -> int:
    """The sequence code whose baseline and extra bits cover `value`."""
    c = max(k for k in range(len(base)) if base[k] <= value)
    assert value < base[c] + (1 << bits[c])
    return c


def _zstd_backward(fields: list) -> bytes:
    """A bitstream the decoder reads from its end: `fields` (value, bits) in the order it reads them, then the
    end mark."""
    acc, n = 0, 0
    for value, bits in reversed(fields):
        acc |= value << n
        n += bits
    acc |= 1 << n
    return acc.to_bytes(n // 8 + 1, "little")


def _zstd_huffman(lits: bytes):
    """(weights with the last symbol's left out, {symbol: (code, length)}) of a Huffman code of at most 11 bits, or
    None where direct weights cannot describe it (one symbol, or one above 128)."""
    import heapq

    counts = np.bincount(np.frombuffer(lits, np.uint8), minlength=256)
    present = [int(v) for v in np.nonzero(counts)[0]]
    if len(present) < 2 or present[-1] > 128:
        return None
    weights_of = counts.astype(np.int64)
    while True:
        heap = [(int(weights_of[v]), i, (v,)) for i, v in enumerate(present)]
        heapq.heapify(heap)
        depth = dict.fromkeys(present, 0)
        tie = len(heap)
        while len(heap) > 1:
            a, _, sa = heapq.heappop(heap)
            b, _, sb = heapq.heappop(heap)
            for v in sa + sb:
                depth[v] += 1
            heapq.heappush(heap, (a + b, tie, sa + sb))
            tie += 1
        if max(depth.values()) <= 11:
            break
        weights_of = weights_of // 2 + (weights_of > 0)
    log = max(depth.values())
    weight = {v: log + 1 - depth[v] for v in present}
    start, codes = {}, {}
    at = 0
    for w in range(1, log + 1):
        start[w] = at
        at += sum(1 for v in present if weight[v] == w) << (w - 1)
    for v in present:
        w = weight[v]
        codes[v] = (start[w] >> (w - 1), depth[v])
        start[w] += 1 << (w - 1)
    return [weight.get(v, 0) for v in range(present[-1])], codes


def _zstd_literals(lits: bytes, form: str, last_table, whole=None):
    """(the literals section, the Huffman code used or None) of a compressed block; `whole`: the code "lz_repeat"
    sends in its first Huffman block and reuses after."""
    def plain(kind: int, size: int) -> bytes:
        if size < 32:
            return bytes([size << 3 | kind])
        if size < 4096:
            return (size << 4 | 1 << 2 | kind).to_bytes(2, "little")
        return (size << 4 | 3 << 2 | kind).to_bytes(3, "little")

    if lits and lits == lits[:1] * len(lits):
        return plain(1, len(lits)) + lits[:1], last_table
    huff = _zstd_huffman(lits) if form in ("lz_huffman1", "lz_huffman4", "lz_repeat") and len(lits) >= 6 else None
    if form == "lz_repeat" and whole is not None and len(lits) >= 6:
        huff = whole
    if huff is None:
        return plain(0, len(lits)) + lits, last_table
    reuse = form == "lz_repeat" and last_table is not None and all(v in last_table[1] for v in set(lits))
    weights, codes = last_table if reuse else huff
    four = form != "lz_huffman1" or len(lits) > 1023
    parts = [lits] if not four else [lits[k * ((len(lits) + 3) // 4): (k + 1) * ((len(lits) + 3) // 4)]
                                     for k in range(4)]
    streams = [_zstd_backward([codes[v] for v in part]) for part in parts]
    body = b"".join(streams)
    if four:
        body = b"".join(len(st).to_bytes(2, "little") for st in streams[:3]) + body
    if not reuse:
        n = len(weights)
        packed = bytes((weights[k] << 4) | (weights[k + 1] if k + 1 < n else 0) for k in range(0, n, 2))
        body = bytes([127 + n]) + packed + body
    size, csize = len(lits), len(body)
    fmt = 0 if not four else 1 if max(size, csize) < 1024 else 2 if max(size, csize) < 16384 else 3
    bits = (10, 10, 14, 18)[fmt]
    header = ((3 if reuse else 2) | fmt << 2 | size << 4 | csize << (4 + bits)).to_bytes((3, 3, 4, 5)[fmt], "little")
    return header + body, (weights, codes)


def _zstd_sequences(seqs: list, form: str, last_modes) -> tuple:
    """(the sequences section of (literal length, offset value, match length) triples, the table modes used): the
    predefined tables, RLE tables where every code of a kind is one, or the last block's tables again."""
    from uniir_tpu_torch.data import zstd

    nb = len(seqs)
    head = (bytes([nb]) if nb < 128 else bytes([(nb >> 8) + 0x80, nb & 0xFF]) if nb < 0x7F00
            else b"\xff" + (nb - 0x7F00).to_bytes(2, "little"))
    if not nb:
        return head, last_modes
    codes = [(_zstd_code(ll, zstd.LL_BASE, zstd.LL_BITS), ov.bit_length() - 1, _zstd_code(ml, zstd.ML_BASE, zstd.ML_BITS))
             for ll, ov, ml in seqs]
    modes, tables, rle = [], [], b""
    for k in range(3):  # LL, OF, ML
        if form == "lz_rle_tables" and len({c[k] for c in codes}) == 1:
            modes.append(1)
            tables.append(([(codes[0][k], 0, 0)], 0))
            rle += bytes([codes[0][k]])
        else:
            modes.append(3 if form == "lz_repeat" and last_modes == (0, 0, 0) else 0)
            tables.append(zstd._predefined(k))
    # the states, chosen backward: each one decodes its sequence's code and its update lands on the next one's
    states = [[0] * 3 for _ in range(nb)]
    for i in reversed(range(nb)):
        for k in range(3):
            table, log = tables[k]
            cands = [u for u, (sym, _, _) in enumerate(table) if sym == codes[i][k]]
            if i == nb - 1:
                states[i][k] = cands[0]
            else:
                nxt = states[i + 1][k]
                states[i][k] = next(u for u in cands if table[u][2] <= nxt < table[u][2] + (1 << table[u][1]))
    fields = [(states[0][0], tables[0][1]), (states[0][1], tables[1][1]), (states[0][2], tables[2][1])]
    for i, (ll, ov, ml) in enumerate(seqs):
        lc, oc, mc = codes[i]
        fields += [(ov - (1 << oc), oc), (ml - zstd.ML_BASE[mc], zstd.ML_BITS[mc]), (ll - zstd.LL_BASE[lc], zstd.LL_BITS[lc])]
        if i < nb - 1:
            for k in (0, 2, 1):  # the updates: LL, ML, OF
                table = tables[k][0]
                u = states[i][k]
                fields.append((states[i + 1][k] - table[u][2], table[u][1]))
    section = head + bytes([modes[0] << 6 | modes[1] << 4 | modes[2] << 2]) + rle + _zstd_backward(fields)
    return section, tuple(0 if m == 3 else m for m in modes)


def zstd_bytes(data: bytes, form: str, seed: int = 0) -> bytes:
    """Zstandard frames of `data` in one of ZSTD_FORMS; `seed` draws the header's fields (single segment or a
    window descriptor, content size, checksum) and the block size."""
    from uniir_tpu_torch.data import zstd

    rng = np.random.default_rng(seed)
    if form == "frames_skippable":
        cut = sorted(int(v) for v in rng.integers(0, len(data) + 1, 2))
        parts = [data[:cut[0]], data[cut[0]:cut[1]], data[cut[1]:]]
        skip = (0x184D2A50 + int(rng.integers(0, 16))).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"uni"
        return skip.join(zstd_bytes(p, ("lz_huffman4", "lz_raw", "rle_blocks")[k], seed + k + 1)
                         for k, p in enumerate(parts))
    n = len(data)
    single = bool(rng.integers(0, 2))
    checksum = bool(rng.integers(0, 2))
    if single:
        fcs = 0 if n < 256 else 1 if n < 65792 else 2
        window = n
    else:
        fcs = 0 if rng.integers(0, 2) else (1 if 256 <= n < 65792 else 2 if n >= 256 else 0)
        window_log = max(10, (max(n, 1) - 1).bit_length(), 12 if form == "lz_raw" else 10)
        window = 1 << window_log
    head = zstd.MAGIC.to_bytes(4, "little") + bytes([fcs << 6 | single << 5 | checksum << 2])
    if not single:
        head += bytes([(window_log - 10) << 3])
    if single and fcs == 0:
        head += bytes([n])
    elif fcs:
        head += ((n - 256) if fcs == 1 else n).to_bytes((0, 2, 4, 8)[fcs], "little")
    block_max = min(window, zstd.BLOCK_MAX)
    size = max(1, min(block_max, int(rng.choice([1024, 8192, 32768, 131072]))))
    blocks, rep, table, modes, hashes = [], [1, 4, 8], None, None, {}
    whole = _zstd_huffman(data) if form == "lz_repeat" else None
    for start in range(0, max(n, 1), size):
        end = min(n, start + size)
        last = end >= n
        chunk = data[start:end]
        if form == "raw_blocks" or (form == "rle_blocks" and chunk != chunk[:1] * len(chunk)) or not chunk:
            blocks.append((len(chunk) << 3 | last).to_bytes(3, "little") + chunk)
            continue
        if form == "rle_blocks":
            blocks.append((len(chunk) << 3 | 1 << 1 | last).to_bytes(3, "little") + chunk[:1])
            continue
        seqs, lits, i, lit_start = [], bytearray(), start, start
        while i + 4 <= end:
            key = data[i:i + 4]
            cand = hashes.get(key)
            hashes[key] = i
            if cand is None or i - cand > window:
                i += 1
                continue
            m = 4
            while i + m < end and data[cand + m] == data[i + m]:
                m += 1
            ll, off = i - lit_start, i - cand
            lits += data[lit_start:i]
            if ll and off == rep[0]:
                ov = 1
            elif not ll and off == rep[1]:
                ov, rep = 1, [rep[1], rep[0], rep[2]]
            else:
                ov, rep = off + 3, [off, rep[0], rep[1]]
            seqs.append((ll, ov, m))
            i += m
            lit_start = i
        lits += data[lit_start:end]
        section, table = _zstd_literals(bytes(lits), form, table, whole)
        seq_section, modes = _zstd_sequences(seqs, form, modes)
        payload = section + seq_section
        if len(payload) > block_max:  # (each sequence's code is drawn, so a compressed block may not pay)
            blocks.append((len(chunk) << 3 | last).to_bytes(3, "little") + chunk)
            continue
        blocks.append((len(payload) << 3 | 2 << 1 | last).to_bytes(3, "little") + payload)
    tail = (zstd.xxh64(data) & 0xFFFFFFFF).to_bytes(4, "little") if checksum else b""
    return head + b"".join(blocks) + tail


# --- the TIFF writer: strips or tiles, both byte orders, BigTIFF, every codec the decoders read but CCITT 2-D
# and LZMA, predictors, without Pillow

TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "L", 5: "LL", 7: "B", 11: "f", 16: "Q"}


def tiff_lzw(data: bytes, compat: bool = False) -> bytes:
    """TIFF LZW: 9-12 bit codes, Clear first and whenever the table would pass 4094 entries, EOI last; MSB
    first with the early change, or (`compat`) libtiff's old LSB-first code that widens one entry later."""
    codes, table, w = [256], {bytes([i]): i for i in range(256)}, b""
    widths, nbits, free = [9], 9, 258
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        codes.append(table[w])
        widths.append(nbits)
        table[wc] = free
        free += 1
        if free >= (1 << nbits) + compat and nbits < 12:  # the decoder, an entry behind, widens a code earlier
            nbits += 1
        if free >= 4094:
            codes.append(256)
            widths.append(nbits)
            table, nbits, free = {bytes([i]): i for i in range(256)}, 9, 258
        w = bytes([byte])
    if w:
        codes.append(table[w])
        widths.append(nbits)
        free += 1  # libtiff's LZWPostEncode: the entry this code would add may widen the EOI code
        if free >= (1 << nbits) + compat and nbits < 12:
            nbits += 1
    codes.append(257)
    widths.append(nbits)
    out, acc, nacc = bytearray(), 0, 0
    for code, width in zip(codes, widths):
        if compat:
            acc |= code << nacc
            nacc += width
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << width) | code
            nacc += width
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 0xFF)
                nacc -= 8
            acc &= (1 << nacc) - 1
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF if not compat else acc & 0xFF)
    return bytes(out)


def tiff_packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more equal bytes as repeats, the rest as literals of at most 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _fax_codes(colour: int) -> dict:
    from uniir_tpu_torch.data.tiff import RUN_CODES

    return {run: (code, length) for (length, code), run in RUN_CODES[colour].items()}


def tiff_fax_1d(bits: np.ndarray, compression: int, fill: bool = False) -> bytes:
    """Bilevel rows [rows, width] (1 = black) as CCITT modified Huffman: compression 2 (rows byte-aligned, no
    EOL) or 3 (T.4 1-D: an EOL before each row, byte-aligned by fill bits with `fill`)."""
    tables = (_fax_codes(0), _fax_codes(1))
    out = []  # bit strings

    def put(code, length):
        out.append(format(code, f"0{length}b"))

    width = bits.shape[1]
    for row in bits:
        if compression == 3:
            if fill:
                pad = (-(sum(map(len, out)) + 12)) % 8
                out.append("0" * pad)
            put(1, 12)
        edges = np.flatnonzero(np.diff(np.concatenate([[0], row, [1 - row[-1]]])))
        runs = np.diff(np.concatenate([[0], edges[edges < width], [width]])).tolist()
        colour = 0
        for run in runs:
            while run >= 2560:
                put(*tables[colour][2560])
                run -= 2560
            if run >= 64:
                put(*tables[colour][run // 64 * 64])
                run %= 64
            put(*tables[colour][run])
            colour ^= 1
        if compression == 2:
            out.append("0" * (-sum(map(len, out)) % 8))
    s = "".join(out)
    s += "0" * (-len(s) % 8)
    return bytes(int(s[k: k + 8], 2) for k in range(0, len(s), 8))


def tiff_bytes(samples: np.ndarray, photometric: int, *, compression: int = 1, order: str = "II",
               bigtiff: bool = False, rows_per_strip: int = None, tile=None, planar: int = 1, predictor: int = 1,
               fillorder: int = 1, orientation: int = None, extra=(), bits: int = None, colormap=None,
               t4options: int = 0, lzw_compat: bool = False, ycbcr_sampling=(2, 2), subsampling=(1, 1),
               tags: dict = None, zstd_form: str = "lz_huffman4", zstd=None, cut: float = 1.0) -> bytes:
    """A TIFF file of `samples` [H, W, samples per pixel] (uint8 / uint16 / int16 / int32 / float32, or 1, 2
    and 4-bit values in uint8 with `bits`): strips of `rows_per_strip` rows or tiles of `tile` = (width,
    length), contiguous or separate planes, byte order "II" / "MM", BigTIFF, and compression 1 (raw), 2 / 3
    (CCITT 1-D of a bilevel image, T4Options `t4options`), 5 (LZW), 7 (JPEG: each strip or tile a
    `jpeg_bytes` stream, its tables also in JPEGTables; YCbCr sampled by `ycbcr_sampling`), 8 / 32946
    (Deflate), 34925 (LZMA), 32773 (PackBits) or 50000 (ZSTD: `zstd_bytes` in `zstd_form`, or the bytes
    the callable `zstd` makes of a chunk); `predictor` 2 (horizontal) or 3 (floating point),
    `fillorder` 2 (each compressed byte's bits reversed), `orientation`, ExtraSamples `extra` and a ColorMap of
    3 * 2^bits 16-bit values.  YCbCr samples (photometric 6) under another codec than JPEG are packed in
    `subsampling` = (horizontal, vertical) data units (each block's Y samples, then its top-left pixel's Cb and
    Cr), differenced by `predictor` 2 as libtiff's PredictorEncodeTile does it (every third byte, over rows of
    TIFFScanlineSize / TIFFTileRowSize bytes where those are whole 3-byte strides); `tags`: more IFD entries,
    tag -> (type, values); `cut`: each strip's or tile's byte count cut to that share of it (its bytes all
    still in the file: a strip that ends early)."""
    e = "<" if order == "II" else ">"
    samples = samples if samples.ndim == 3 else samples[:, :, None]
    h, w, spp = samples.shape
    dt = samples.dtype
    bits = bits or dt.itemsize * 8
    sample_format = 3 if dt.kind == "f" else (2 if dt.kind == "i" else 1)
    tw, th = tile if tile else (w, rows_per_strip or h)
    across, down = (-(-w // tw), -(-h // th))
    planes = spp if planar == 2 else 1

    def chunk_raw(p: int, i: int, j: int) -> bytes:
        if tile:
            block = np.zeros((th, tw, spp), dt)
            part = samples[j * th:(j + 1) * th, i * tw:(i + 1) * tw]
            block[: part.shape[0], : part.shape[1]] = part
        else:
            block = samples[j * th:(j + 1) * th]
        if planar == 2:
            block = block[:, :, p:p + 1]
        rows, cols, n = block.shape
        if compression == 7:
            return b""
        if photometric == 6 and subsampling != (1, 1):  # YCbCr data units: h x v Y samples, then Cb, Cr
            sh, sv = subsampling
            br, bc = -(-rows // sv), -(-cols // sh)
            pad = np.zeros((br * sv, bc * sh, 3), dt)
            pad[:rows, :cols] = block
            ys = pad[..., 0].reshape(br, sv, bc, sh).transpose(0, 2, 1, 3).reshape(br, bc, sv * sh)
            units = np.concatenate([ys, pad[::sv, ::sh, 1:3]], axis=2).astype(np.uint8).tobytes()
            rowsize = tw * 3 if tile else -(-w // sh) * (sh * sv + 2) // sv  # libtiff's PredictorSetup rows
            if predictor == 2 and rowsize % 3 == 0:  # horDiff8 over whole rows of 3-byte strides
                n = len(units) // rowsize * rowsize
                a = np.frombuffer(units[:n], np.uint8).reshape(-1, rowsize // 3, 3).astype(np.int64)
                d = np.concatenate([a[:, :1], np.diff(a, axis=1)], axis=1) & 0xFF
                units = d.astype(np.uint8).tobytes() + units[n:]
            return units
        if bits < 8:
            packed = np.packbits(np.unpackbits(block.astype(np.uint8).reshape(rows, cols * n, 1), axis=2)[:, :, 8 - bits:]
                                 .reshape(rows, -1), axis=1)
            return packed.tobytes()
        v = block.reshape(rows, cols * n)
        if predictor == 2:
            u = v.view(f"u{dt.itemsize}").astype(np.int64) if dt.kind != "u" else v.astype(np.int64)
            u = u.reshape(rows, cols, n)
            d = np.concatenate([u[:, :1], np.diff(u, axis=1)], axis=1) & ((1 << bits) - 1)
            v = d.astype(f"u{dt.itemsize}").reshape(rows, cols * n)
        if predictor == 3:
            be = v.astype(dt.newbyteorder(">")).view(np.uint8).reshape(rows, cols * n, dt.itemsize)
            planes_b = be.transpose(0, 2, 1).reshape(rows, -1).astype(np.int64)
            d = np.concatenate([planes_b[:, :n], planes_b[:, n:] - planes_b[:, :-n]], axis=1) & 0xFF
            return d.astype(np.uint8).tobytes()
        return v.astype(v.dtype.newbyteorder(e)).tobytes()

    def compress(raw: bytes, p: int, i: int, j: int) -> bytes:
        if compression == 1:
            out = raw
        elif compression == 5:
            out = tiff_lzw(raw, lzw_compat)
        elif compression == 32773:
            out = tiff_packbits(raw)
        elif compression in (8, 32946):
            out = zlib.compress(raw)
        elif compression == 34925:
            import lzma

            out = lzma.compress(raw)
        elif compression == 50000:
            out = zstd(raw) if zstd else zstd_bytes(raw, zstd_form, seed=(p * down + j) * across + i)
        elif compression in (2, 3):
            rows = len(raw) // (-(-tw // 8))
            b = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(rows, -1), axis=1)[:, :tw]
            out = tiff_fax_1d(b, compression, fill=bool(t4options & 4))
        elif compression == 7:
            if tile:
                block = np.zeros((th, tw, spp), np.uint8)
                part = samples[j * th:(j + 1) * th, i * tw:(i + 1) * tw]
                block[: part.shape[0], : part.shape[1]] = part
                block[part.shape[0]:] = block[part.shape[0] - 1: part.shape[0]] if part.shape[0] else 0
            else:
                block = samples[j * th:(j + 1) * th]
            if planar == 2:
                out = jpeg_bytes(block[:, :, p])
            elif spp == 1:
                out = jpeg_bytes(block[:, :, 0])
            elif photometric == 6:
                out = jpeg_bytes(block, sampling=ycbcr_sampling)
            else:
                out = jpeg_bytes(block, form="rgb" if spp == 3 else "cmyk")
        else:
            raise ValueError(f"compression {compression}")
        if fillorder == 2 and compression != 7:
            out = _TIFF_REVERSE[np.frombuffer(out, np.uint8)].tobytes()
        return out

    chunks = [compress(chunk_raw(p, i, j), p, i, j) for p in range(planes) for j in range(down)
              for i in range(across)]
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if sample_format != 1:
        entries[339] = (3, [sample_format] * spp)
    if predictor != 1:
        entries[317] = (3, [predictor])
    if fillorder != 1:
        entries[266] = (3, [fillorder])
    if orientation is not None:
        entries[274] = (3, [orientation])
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(colormap))
    if t4options:
        entries[292] = (4, [t4options])
    if photometric == 6 and compression == 7:
        entries[530] = (3, list(ycbcr_sampling))
    if photometric == 6 and compression != 7:
        entries[530] = (3, list(subsampling))
    entries.update(tags or {})
    if compression == 7:
        first = chunks[0]
        sos = first.index(b"\xff\xc0")
        tables = b"\xff\xd8" + bytes(seg for seg in _jpeg_table_segments(first[:sos])) + b"\xff\xd9"
        entries[347] = (7, list(tables))
    head = 16 if bigtiff else 8
    data = bytearray()
    offsets = []
    pos = head
    for c in chunks:
        offsets.append(pos + len(data))
        data += c
        if len(data) % 2:
            data += b"\x00"
    off_type = 16 if bigtiff else 4
    counts = [max(1, int(len(c) * cut)) if cut < 1 else len(c) for c in chunks]
    if tile:
        entries.update({322: (3, [tw]), 323: (3, [th]), 324: (off_type, offsets), 325: (off_type, counts)})
    else:
        entries.update({278: (4, [th]), 273: (off_type, offsets), 279: (off_type, counts)})
    ifd_at = head + len(data)
    n = len(entries)
    entry_size, count_fmt, inline = (20, "Q", 8) if bigtiff else (12, "H", 4)
    ext_at = ifd_at + struct.calcsize(e + count_fmt) + n * entry_size + inline
    ifd, ext = bytearray(struct.pack(e + count_fmt, n)), bytearray()
    for tag in sorted(entries):
        typ, values = entries[tag]
        fmt = TIFF_TYPES[typ]
        if typ == 5:
            payload = b"".join(struct.pack(e + "LL", *v) for v in values)
        else:
            payload = struct.pack(f"{e}{len(values)}{fmt}", *values)
        ifd += struct.pack(e + ("HHQ" if bigtiff else "HHL"), tag, typ, len(values))
        if len(payload) <= inline:
            ifd += payload + b"\x00" * (inline - len(payload))
        else:
            ifd += struct.pack(e + ("Q" if bigtiff else "L"), ext_at + len(ext))
            ext += payload + b"\x00" * (len(payload) % 2)
    ifd += b"\x00" * inline
    if bigtiff:
        header = (b"II" if order == "II" else b"MM") + struct.pack(e + "HHHQ", 43, 8, 0, ifd_at)
    else:
        header = (b"II" if order == "II" else b"MM") + struct.pack(e + "HL", 42, ifd_at)
    return bytes(header + data + ifd + ext)


def _jpeg_table_segments(head: bytes):
    """The DQT and DHT segments of a JPEG header (everything between SOI and SOF0)."""
    i, out = 2, bytearray()
    while i + 4 <= len(head):
        marker, length = head[i + 1], int.from_bytes(head[i + 2:i + 4], "big")
        if marker in (0xDB, 0xC4):
            out += head[i:i + 2 + length]
        i += 2 + length
    return out


_TIFF_REVERSE = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)


# --- the PNG writer: every scanline filter, Adam7, bit depths 1 to 16, without Pillow

PNG_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_chunk(kind: bytes, data: bytes) -> bytes:
    return len(data).to_bytes(4, "big") + kind + data + zlib.crc32(kind + data).to_bytes(4, "big")


def png_bytes(samples: np.ndarray, color_type: int, bit_depth: int = 8, filters=(0, 1, 2, 3, 4),
              interlace: bool = False, palette: bytes = b"", trns: bytes = b"") -> bytes:
    """A PNG file of `samples`, uint [H, W, channels] at `bit_depth` (palette indices for colour type 3),
    each scanline filtered with filters[row % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth),
    Adam7-interlaced if asked, its zlib stream split over several IDAT chunks."""
    h, w, channels = samples.shape
    bits = channels * bit_depth
    bpp = max(1, bits // 8)
    raw, row_no = bytearray(), 0
    for x0, y0, dx, dy in PNG_ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if not sub.size:
            continue
        prev = np.zeros(-(-sub.shape[1] * bits // 8), np.int32)
        for row in sub:
            if bit_depth >= 8:
                line = row.astype(">u2" if bit_depth == 16 else np.uint8).tobytes()
            else:  # samples packed from the most significant bit, the row padded to a byte
                per = 8 // bit_depth
                vals = np.concatenate([row.reshape(-1), np.zeros(-row.size % per, row.dtype)]).astype(np.int64)
                line = (vals.reshape(-1, per) << (8 - bit_depth * np.arange(1, per + 1))).sum(axis=1).astype(np.uint8).tobytes()
            x = np.frombuffer(line, np.uint8).astype(np.int32)
            left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            kind = filters[row_no % len(filters)]
            pred = (0, left, prev, (left + prev) >> 1, paeth)[kind]
            raw.append(kind)
            raw += ((x - pred) & 255).astype(np.uint8).tobytes()
            prev, row_no = x, row_no + 1
    ihdr = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([bit_depth, color_type, 0, 0, int(interlace)])
    out = b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", ihdr)
    out += (png_chunk(b"PLTE", palette) if palette else b"") + (png_chunk(b"tRNS", trns) if trns else b"")
    z = zlib.compress(bytes(raw), 6)
    for i in range(0, len(z), 1 << 13):
        out += png_chunk(b"IDAT", z[i : i + (1 << 13)])
    return out + png_chunk(b"IEND", b"")


# --- the GIF writer: LZW, interlacing, colour tables, transparency, without Pillow

GIF_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))  # (first row, step) of the four interlace passes


def lzw_codes(indices: bytes, min_size: int, deferred_clear: bool = False) -> list:
    """GIF's LZW over `indices`: (code, width) pairs, a clear code first and the EOI last, each code at the
    width a decoder reads it at (the decoder adds an entry for every code but the first after a clear and
    widens after adding entry 2^width - 1, up to 12 bits).  At 4096 entries a clear code follows, or with
    `deferred_clear` none: the codes go on from the full table.  Below a minimum code size of 2 every index
    is written as a literal (a decoder's first free entry, clear + 2, is then past its first code mask, so
    its width never grows)."""
    clear = 1 << min_size
    out = [(clear, min_size + 1)]
    literal = min_size < 2
    table: dict = {}
    next_code = dec_next = clear + 2
    width, first = min_size + 1, True

    def emit(code: int) -> None:
        nonlocal dec_next, width, first
        out.append((code, width))
        if first:
            first = False
        elif dec_next < 4096:
            if dec_next == (1 << width) - 1 and width < 12:
                width += 1
            dec_next += 1

    w = indices[0] if indices else None
    for k in indices[1:]:
        key = (w << 8) | k
        if not literal and key in table:
            w = table[key]
            continue
        emit(w)
        if not literal and next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code == 4096 and not deferred_clear:
                out.append((clear, width))
                table, next_code, dec_next, width, first = {}, clear + 2, clear + 2, min_size + 1, True
        w = k
    if w is not None:
        emit(w)
    out.append((clear + 1, width))
    return out


def pack_codes(codes: list) -> bytes:
    """The codes' bits, least significant first, as GIF packs them."""
    acc, nbits, out = 0, 0, bytearray()
    for code, width in codes:
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def gif_sub_blocks(data: bytes, size: int = 255) -> bytes:
    return b"".join(bytes([len(data[i : i + size])]) + data[i : i + size] for i in range(0, len(data), size)) + b"\0"


def gif_bytes(indices: np.ndarray, palette: bytes = b"", *, local: bool = False, interlace: bool = False,
              transparency=None, screen=None, offset=(0, 0), min_code_size=None, deferred_clear: bool = False,
              background: int = 0, lzw: bytes = None) -> bytes:
    """A one-frame GIF89a of palette indices uint8 [h, w].  `palette` (RGB bytes; none: no colour table) is
    written padded to a power of two entries, as the global table or with `local` as the frame's own;
    `transparency` writes a graphic control extension naming that index; `screen` (w, h) is the logical
    screen (the frame's extent by default) and `offset` the frame's place on it; `min_code_size` defaults to
    the table's bits, at least 2.  `lzw` replaces the frame's LZW bytes (for broken streams)."""
    h, w = indices.shape
    bits = max(1, (max(1, len(palette) // 3) - 1).bit_length())
    table = (bytes([0x80 | (bits - 1)]), palette.ljust(3 << bits, b"\0")) if palette else (b"\0", b"")
    sw, sh = screen or (w + offset[0], h + offset[1])
    out = b"GIF89a" + sw.to_bytes(2, "little") + sh.to_bytes(2, "little")
    out += (bytes([table[0][0] | 0x70]) + bytes([background, 0]) + table[1]) if palette and not local else b"\0\0\0"
    if transparency is not None:
        out += b"\x21\xf9\x04\x01\x00\x00" + bytes([transparency]) + b"\0"
    out += b"\x2c" + b"".join(int(v).to_bytes(2, "little") for v in (*offset, w, h))
    out += bytes([(table[0][0] if local else 0) | (0x40 if interlace else 0)]) + (table[1] if local else b"")
    rows = [r for first, step in GIF_PASSES for r in range(first, h, step)] if interlace else range(h)
    min_size = min_code_size or max(2, bits)
    if lzw is None:
        lzw = pack_codes(lzw_codes(np.ascontiguousarray(indices[list(rows)]).tobytes(), min_size, deferred_clear))
    return out + bytes([min_size]) + gif_sub_blocks(lzw) + b"\x3b"


# --- the BMP writer: the header forms, palettes, bit fields and RLE, without Pillow

BMP_RGB, BMP_RLE8, BMP_RLE4, BMP_BITFIELDS = 0, 1, 2, 3


def bmp_rle(rows: np.ndarray, four: bool, absolute_from: int = 3) -> bytes:
    """RLE8 / RLE4 of index rows (first row first): runs of one value (RLE4: of an alternating pair) as
    encoded pairs, stretches without runs of `absolute_from` or more samples in absolute mode (padded to a
    16-bit word), an end of line after each row and an end of bitmap."""
    out = bytearray()
    for row in rows.tolist():
        i, n = 0, len(row)
        while i < n:
            pattern = row[i : i + 2] if four else row[i : i + 1]
            j = i
            while j < n and j - i < 255 and row[j] == pattern[(j - i) % len(pattern)]:
                j += 1
            if j - i >= absolute_from or j == n:
                out += bytes([j - i, (pattern[0] << 4 | (pattern[1] if len(pattern) > 1 else 0)) if four else pattern[0]])
                i = j
                continue
            j = i + 1  # an absolute stretch: up to the next run
            while j < n and j - i < 255 and not (j + absolute_from <= n and len(set(row[j : j + absolute_from])) == 1):
                j += 1
            count = j - i
            if count < 3:  # absolute mode needs 3 or more: an encoded pair each
                for v in row[i:j]:
                    out += bytes([1, v << 4 if four else v])
            else:
                vals = row[i:j]
                body = bytes((vals[k] << 4) | (vals[k + 1] if k + 1 < count else 0) for k in range(0, count, 2)) \
                    if four else bytes(vals)
                out += bytes([0, count]) + body + (b"\0" if len(body) % 2 else b"")
            i = j
        out += b"\0\0"
    return bytes(out[:-2]) + b"\0\1"


def bmp_bytes(image: np.ndarray, bits: int, *, palette: bytes = b"", compression: int = BMP_RGB, masks=None,
              header: int = 40, top_down: bool = False, colors_used: int = 0, rle: bytes = None) -> bytes:
    """A BMP of `image`: palette indices uint8 [h, w] at 1 / 4 / 8 bits (`palette` RGB bytes, written BGRX,
    or BGR under the 12-byte core header; `colors_used` entries, 0: the bit depth's count), or RGB(A) uint8
    [h, w, 3 | 4] at 16 / 24 / 32 bits: 16-bit BI_RGB is 5-5-5, 24-bit BGR, 32-bit BGRX, and BI_BITFIELDS
    packs each channel's high bits into its mask (`masks` (r, g, b[, a]); after a 40-byte header they
    follow it, in a longer one they are its fields).  `header` is 12, 40, 52, 56, 64, 108 or 124 bytes;
    rows are bottom-up unless `top_down` (a negative height); RLE8 / RLE4 encode indices by `bmp_rle`, or
    write `rle` as the pixel data."""
    h, w = image.shape[:2]
    if bits <= 8:
        if compression in (BMP_RLE8, BMP_RLE4):
            data = rle if rle is not None else bmp_rle((image if top_down else image[::-1]).astype(np.int64),
                                                       compression == BMP_RLE4)
        else:
            per = 8 // bits
            vals = np.concatenate([image, np.zeros((h, -w % per), image.dtype)], 1).astype(np.int64)
            packed = (vals.reshape(h, -1, per) << (8 - bits * np.arange(1, per + 1))).sum(2).astype(np.uint8)
            data = None
    else:
        px = image.astype(np.int64)
        if compression == BMP_BITFIELDS:
            value = np.zeros((h, w), np.int64)
            for c, m in enumerate(masks[: px.shape[2]]):
                if m:
                    shift, width = (m & -m).bit_length() - 1, bin(m).count("1")
                    value |= (px[..., c] >> (8 - width)) << shift if width <= 8 else px[..., c] << shift
        elif bits == 16:
            value = (px[..., 0] >> 3) << 10 | (px[..., 1] >> 3) << 5 | px[..., 2] >> 3
        else:
            value = px[..., 2] | px[..., 1] << 8 | px[..., 0] << 16
        packed = np.stack([(value >> (8 * k)) & 255 for k in range(bits // 8)], -1).reshape(h, -1).astype(np.uint8)
        data = None
    if data is None:
        stride = -(-w * bits // 32) * 4
        rows = np.zeros((h, stride), np.uint8)
        rows[:, : packed.shape[1]] = packed
        data = (rows if top_down else rows[::-1]).tobytes()
    n_colors = colors_used or (1 << bits if bits <= 8 else 0)
    entry = 3 if header == 12 else 4
    pal = palette.ljust(3 * n_colors, b"\0")[: 3 * n_colors]
    pal = b"".join(pal[3 * i : 3 * i + 3][::-1] + b"\0" * (entry - 3) for i in range(n_colors))
    if header == 12:
        info = (12).to_bytes(4, "little") + w.to_bytes(2, "little") + h.to_bytes(2, "little") \
            + (1).to_bytes(2, "little") + bits.to_bytes(2, "little")
    else:
        info = (header.to_bytes(4, "little") + w.to_bytes(4, "little") + (-h if top_down else h).to_bytes(4, "little", signed=True)
                + (1).to_bytes(2, "little") + bits.to_bytes(2, "little") + compression.to_bytes(4, "little")
                + len(data).to_bytes(4, "little") + (2835).to_bytes(4, "little") * 2
                + colors_used.to_bytes(4, "little") + b"\0" * 4)
        fields = b"".join(int(m).to_bytes(4, "little") for m in (masks or ())).ljust(16, b"\0")
        if header == 40:
            info += fields[:12] if compression == BMP_BITFIELDS else b""
        else:
            info += (fields if compression == BMP_BITFIELDS else b"\0" * 16)[: header - 40].ljust(header - 40, b"\0")
    offset = 14 + len(info) + len(pal)
    return b"BM" + (offset + len(data)).to_bytes(4, "little") + b"\0" * 4 + offset.to_bytes(4, "little") + info + pal + data


# ------------------------------------ writers of the small raster formats (no Pillow on the card's machine)


def qoi_bytes(image: np.ndarray) -> bytes:
    """A QOI file of uint8 [h, w, 3 | 4], every op of the format used where it applies (RUN, INDEX, DIFF,
    LUMA, RGB, RGBA)."""
    h, w, c = image.shape
    px = image.reshape(-1, c).tolist()
    out, seen, prev, run = bytearray(), [None] * 64, (0, 0, 0, 255), 0
    for i, p in enumerate(px):
        v = tuple(p) if c == 4 else (*p, prev[3])
        if v == prev:
            run += 1
            if run == 62 or i == len(px) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        slot = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64
        if seen[slot] == v:
            out.append(slot)
        elif v[3] != prev[3]:
            out += bytes((0xFF, *v))
        else:
            dr, dg, db = ((v[k] - prev[k] + 128) % 256 - 128 for k in range(3))
            if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
            elif -32 <= dg <= 31 and -8 <= dr - dg <= 7 and -8 <= db - dg <= 7:
                out += bytes((0x80 | (dg + 32), (dr - dg + 8) << 4 | (db - dg + 8)))
            else:
                out += bytes((0xFE, *v[:3]))
        seen[slot], prev = v, v
    return b"qoif" + w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes((c, 0)) + bytes(out) + b"\0" * 7 + b"\1"


def tga_rle(rows: np.ndarray, depth: int) -> bytes:
    """TGA RLE of uint8 [h, row bytes] rows: runs of 2-128 equal pixels, literals of up to 128 within a row."""
    out = bytearray()
    for row in rows:
        px = [bytes(row[i : i + depth]) for i in range(0, len(row), depth)]
        i = 0
        while i < len(px):
            j = i
            while j + 1 < len(px) and px[j + 1] == px[i] and j + 1 - i < 128:
                j += 1
            if j > i:
                out += bytes((0x80 | (j - i),)) + px[i]
                i = j + 1
                continue
            j = i
            while j + 1 < len(px) and j + 1 - i < 128 and not (j + 2 < len(px) and px[j + 1] == px[j + 2]):
                j += 1
            out += bytes((j - i,)) + b"".join(px[i : j + 1])
            i = j + 1
    return bytes(out)


def tga_bytes(image: np.ndarray, *, rle: bool = True, top_down: bool = False, palette: bytes = b"",
              cmap_first: int = 0, cmap_depth: int = 24, ident: bytes = b"") -> bytes:
    """A TGA file: uint8 [h, w] grey (type 3 / 11), or indices into `palette` (RGB bytes, written at
    `cmap_depth` 16 / 24 bits after `cmap_first` unlisted entries; type 1 / 9), or [h, w, 3 | 4] RGB(A)
    (type 2 / 10, BGR(A)); bottom-up unless `top_down`."""
    h, w = image.shape[:2]
    if image.ndim == 3:
        kind, depth = 2, 8 * image.shape[2]
        px = image[..., [2, 1, 0, 3][: image.shape[2]]]
    else:
        kind, depth, px = (1 if palette else 3), 8, image
    rows = np.ascontiguousarray((px if top_down else px[::-1]).reshape(h, -1))
    cmap = b""
    if palette:
        entries = np.frombuffer(palette, np.uint8).reshape(-1, 3).astype(np.int64)
        if cmap_depth == 16:
            v = (entries[:, 0] >> 3) << 10 | (entries[:, 1] >> 3) << 5 | entries[:, 2] >> 3
            cmap = v.astype("<u2").tobytes()
        else:
            cmap = entries[:, ::-1].astype(np.uint8).tobytes()
    n = len(palette) // 3
    head = bytes((len(ident), 1 if palette else 0, kind | (8 if rle else 0))) + cmap_first.to_bytes(2, "little") \
        + n.to_bytes(2, "little") + bytes((cmap_depth if palette else 0,)) + bytes(4) + w.to_bytes(2, "little") \
        + h.to_bytes(2, "little") + bytes((depth, 0x20 if top_down else 0))
    return head + ident + cmap + (tga_rle(rows, depth // 8) if rle else rows.tobytes())


def sgi_bytes(image: np.ndarray, rle: bool = True) -> bytes:
    """An SGI file of uint8 [h, w, 1 | 3 | 4] (1 byte a sample) or uint16 (2, big-endian), rows bottom-up,
    verbatim or RLE (runs and copies of up to 127 samples, a zero chunk ending each row)."""
    h, w, z = image.shape
    bpc = 2 if image.dtype == np.uint16 else 1
    head = (474).to_bytes(2, "big") + bytes((1 if rle else 0, bpc)) + (3 if z > 1 else 2).to_bytes(2, "big") \
        + w.to_bytes(2, "big") + h.to_bytes(2, "big") + z.to_bytes(2, "big") + bytes(500)
    planes = [image[::-1, :, c] for c in range(z)]
    if not rle:
        return head + b"".join(p.astype(">u2" if bpc == 2 else np.uint8).tobytes() for p in planes)

    def atom(v) -> bytes:
        return int(v).to_bytes(bpc, "big")

    rows = []
    for plane in planes:
        for line in plane.tolist():
            out, x = bytearray(), 0
            while x < w:
                run = 1
                while x + run < w and line[x + run] == line[x] and run < 127:
                    run += 1
                if run > 1:
                    out += atom(run) + atom(line[x])
                    x += run
                    continue
                k = 1
                while x + k < w and k < 127 and not (x + k + 1 < w and line[x + k] == line[x + k + 1]):
                    k += 1
                out += atom(0x80 | k) + b"".join(atom(v) for v in line[x : x + k])
                x += k
            rows.append(bytes(out + atom(0)))
    start = 512 + 8 * len(rows)
    offsets = np.cumsum([0] + [len(r) for r in rows[:-1]]) + start
    return head + b"".join(int(o).to_bytes(4, "big") for o in offsets) \
        + b"".join(len(r).to_bytes(4, "big") for r in rows) + b"".join(rows)


def pcx_rle(line: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(line):
        run = 1
        while i + run < len(line) and line[i + run] == line[i] and run < 63:
            run += 1
        if run > 1 or line[i] >= 0xC0:
            out += bytes((0xC0 | run, line[i]))
        else:
            out.append(line[i])
        i += run
    return bytes(out)


def pcx_bytes(image: np.ndarray, *, palette: bytes = b"", planes_of_bits: int = 0) -> bytes:
    """A PCX file (RLE, version 5): uint8 [h, w, 3] as three 8-bit planes; [h, w] 8-bit indices with `palette`
    (768 RGB bytes) after the data, or grey without; with `planes_of_bits` 4 (or 2), [h, w] indices below 16
    as that many 1-bit planes and `palette` (48 bytes) in the header.  Lines are padded to even lengths."""
    h, w = image.shape[:2]
    bits, planes = (1, planes_of_bits) if planes_of_bits else (8, 3 if image.ndim == 3 else 1)
    stride = ((w * bits + 7) // 8 + 1) // 2 * 2
    lines = []
    for y in range(h):
        if planes_of_bits:
            bitplanes = [np.packbits((image[y] >> k) & 1) for k in range(planes)]
        else:
            bitplanes = [image[y, :, c] for c in range(3)] if image.ndim == 3 else [image[y]]
        lines.append(b"".join(bytes(p).ljust(stride, b"\0") for p in bitplanes))
    head = bytearray(128)
    head[:4] = bytes((10, 5, 1, bits))
    head[8:12] = (w - 1).to_bytes(2, "little") + (h - 1).to_bytes(2, "little")
    if planes_of_bits:
        head[16 : 16 + len(palette)] = palette
    head[65] = planes
    head[66:68] = stride.to_bytes(2, "little")
    tail = b"\x0c" + palette if palette and not planes_of_bits else b""
    return bytes(head) + b"".join(pcx_rle(line) for line in lines) + tail


def dcx_bytes(pages: list) -> bytes:
    """A DCX file: the directory of `pages` (PCX files), then the pages."""
    at = 4 + 4 * (len(pages) + 1)
    offsets = []
    for page in pages:
        offsets.append(at)
        at += len(page)
    return (987654321).to_bytes(4, "little") + b"".join(o.to_bytes(4, "little") for o in offsets) + bytes(4) \
        + b"".join(pages)


def sun_bytes(image: np.ndarray, kind: int = 2, palette: bytes = b"") -> bytes:
    """A Sun raster file: uint8 [h, w] (8-bit grey, or indices into `palette`, RGB bytes written as planes) or
    [h, w, 3] (24-bit: BGR, RGB for type 3); type 2 is RLE (0x80 n v for runs of 3 or more, 0x80 0x00 for
    0x80), the others rows padded to 16 bits."""
    h, w = image.shape[:2]
    depth = 8 * (image.shape[2] if image.ndim == 3 else 1)
    px = image if image.ndim == 2 or kind == 3 else image[..., ::-1]
    rows = np.ascontiguousarray(px.reshape(h, -1))
    if kind == 2:
        flat, out, i = rows.tobytes(), bytearray(), 0
        while i < len(flat):
            run = 1
            while i + run < len(flat) and flat[i + run] == flat[i] and run < 256:
                run += 1
            if run >= 3:
                out += bytes((0x80, run - 1, flat[i]))
                i += run
            else:
                out += b"\x80\x00" if flat[i] == 0x80 else flat[i : i + 1]
                i += 1
        data = bytes(out)
    else:
        stride = (w * depth + 15) // 16 * 2
        data = b"".join(bytes(r).ljust(stride, b"\0") for r in rows)
    n = len(palette) // 3
    cmap = np.frombuffer(palette, np.uint8).reshape(n, 3).T.tobytes() if palette else b""
    head = b"".join(v.to_bytes(4, "big") for v in (0x59A66A95, w, h, depth, len(data), kind, 1 if palette else 0,
                                                    len(cmap)))
    return head + cmap + data


def msp_bytes(bits: np.ndarray, v2: bool = True) -> bytes:
    """An MSP file of bool [h, w] (True white): version 1 raw rows, or version 2's row-length map and each
    row's runs (0 n v for runs of 3 or more equal bytes, else literals)."""
    h, w = bits.shape
    rows = [bytes(np.packbits(r)) for r in bits]
    head = bytearray((b"LinS" if v2 else b"DanM") + w.to_bytes(2, "little") + h.to_bytes(2, "little") + bytes(24))
    check_word = 0
    for i in range(0, 30, 2):
        check_word ^= head[i] | head[i + 1] << 8
    head[30:32] = check_word.to_bytes(2, "little")
    if not v2:
        return bytes(head) + b"".join(rows)
    encoded = []
    for r in rows:
        out, i = bytearray(), 0
        while i < len(r):
            run = 1
            while i + run < len(r) and r[i + run] == r[i] and run < 255:
                run += 1
            if run >= 3:
                out += bytes((0, run, r[i]))
                i += run
                continue
            k = 1
            while i + k < len(r) and k < 255 and not (i + k + 2 < len(r) and r[i + k] == r[i + k + 1] == r[i + k + 2]):
                k += 1
            out += bytes((k,)) + r[i : i + k]
            i += k
        encoded.append(bytes(out))
    return bytes(head) + b"".join(len(e).to_bytes(2, "little") for e in encoded) + b"".join(encoded)


def packbits_row(row: bytes) -> bytes:
    """PackBits of one row: runs of 2-128 equal bytes as (257 - n, v), literals of 1-128 bytes as (n - 1, ...)."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        run = 1
        while i + run < n and row[i + run] == row[i] and run < 128:
            run += 1
        if run >= 2:
            out += bytes((257 - run, row[i]))
            i += run
            continue
        k = 1
        while i + k < n and k < 128 and not (i + k + 1 < n and row[i + k] == row[i + k + 1]):
            k += 1
        out += bytes((k - 1,)) + row[i : i + k]
        i += k
    return bytes(out)


PSD_MODES = {"1": 0, "L": 1, "P": 2, "RGB": 3, "CMYK": 4, "multichannel": 7, "duotone": 8, "LAB": 9}


def psd_bytes(planes: np.ndarray, mode: str, *, compression: int = 1, palette: bytes = b"", resources: bytes = b"",
              layers: bytes = b"", channels: int = 0) -> bytes:
    """A PSD file of uint8 [channels, h, w] planes (0 / 1 for mode "1", packed 8 to a byte, most significant
    first) in colour mode `mode` (PSD_MODES), raw (compression 0) or PackBits rows (1) after their byte
    counts; the colour mode data (an indexed image's 768-byte planar palette), image resources and layer
    section as given; `channels` the header's count where it differs from the planes'."""
    c, h, w = planes.shape
    bits = 1 if mode == "1" else 8
    rows = [(np.packbits(p, axis=1) if bits == 1 else p)[y].tobytes() for p in planes for y in range(h)]
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or c, h, w, bits, PSD_MODES[mode])
    head += struct.pack(">I", len(palette)) + palette + struct.pack(">I", len(resources)) + resources
    head += struct.pack(">I", len(layers)) + layers
    if compression != 1:
        return head + struct.pack(">H", compression) + b"".join(rows)
    packed = [packbits_row(r) for r in rows]
    return head + struct.pack(">H", 1) + b"".join(struct.pack(">H", len(r)) for r in packed) + b"".join(packed)


def psd_resource(ident: int, name: bytes, data: bytes) -> bytes:
    """One image resource block: '8BIM', its id, a padded Pascal name, its padded data."""
    pname = bytes((len(name),)) + name
    return (b"8BIM" + struct.pack(">H", ident) + pname + b"\0" * (len(pname) & 1) + struct.pack(">I", len(data)) + data
            + b"\0" * (len(data) & 1))


DDS_PF = {"fourcc": 0x4, "rgb": 0x40, "alpha_pixels": 0x1, "luminance": 0x20000, "pal8": 0x20}


def dds_bytes(data: bytes, w: int, h: int, *, fourcc: bytes = b"", dxgi: int = -1, flags: int = 0, bitcount: int = 0,
              masks=(0, 0, 0, 0), palette: bytes = b"") -> bytes:
    """A DDS file of `data` (the first mip level) at w x h: a FourCC (with `dxgi` after a DX10 header), or
    pixel format `flags` with `bitcount` and the RGBA `masks` (a palette after the header for PAL8)."""
    if dxgi >= 0:
        fourcc = b"DX10"
    pf_flags = flags | (DDS_PF["fourcc"] if fourcc else 0)
    pf = struct.pack("<2I4sI4I", 32, pf_flags, fourcc.ljust(4, b"\0"), bitcount, *masks)
    out = b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0) + bytes(44) + pf + struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    if dxgi >= 0:
        out += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return out + palette + data


BC_BLOCK_BYTES = {"bc1": 8, "bc2": 16, "bc3": 16, "bc4": 8, "bc5": 16, "bc6h": 16, "bc7": 16}
# the DDS form of each block format the smoke writes: (FourCC, DXGI format)
BC_DDS = {"bc1": (b"DXT1", -1), "bc2": (b"DXT3", -1), "bc3": (b"DXT5", -1), "bc4": (b"BC4U", -1),
          "bc5": (b"BC5U", -1), "bc5s": (b"BC5S", -1), "bc6h": (b"", 95), "bc6hs": (b"", 96), "bc7": (b"", 98)}


def bc_blocks(form: str, rng, w: int, h: int) -> bytes:
    """Seeded blocks of a BC `form` (BC_DDS) for w x h: random bits, with BC6H's and BC7's mode bits spread
    over every mode (BC6H's two reserved ones and BC7's zero mode byte among them)."""
    kind = form.rstrip("s") if form != "bc6hs" else "bc6h"
    n = ((w + 3) // 4) * ((h + 3) // 4)
    b = rng.integers(0, 256, (n, BC_BLOCK_BYTES[kind]), dtype=np.uint8)
    if kind == "bc7":
        mode = rng.integers(0, 9, n)
        b[:, 0] = np.where(mode == 8, 0, (b[:, 0] & ~((2 << mode) - 1) | (1 << mode)) & 0xFF)
    elif kind == "bc6h":
        modes = np.array([0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 31])
        b[:, 0] = (b[:, 0] & 0xE0) | modes[rng.integers(0, len(modes), n)]
    return b.tobytes()


def bc7_mode6(image: np.ndarray) -> bytes:
    """BC7 blocks of uint8 [h, w, 3] in mode 6 (one subset, 7-bit endpoints and a p-bit each, 4-bit
    indices): the block's channel minimum and maximum as endpoints, each pixel's nearest of the 16 weights
    along them, alpha 255.  Edges are repeated to whole blocks."""
    h, w = image.shape[:2]
    padded = np.pad(image, ((0, -h % 4), (0, -w % 4), (0, 0)), mode="edge").astype(np.int64)
    bh, bw = padded.shape[0] // 4, padded.shape[1] // 4
    px = padded.reshape(bh, 4, bw, 4, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 16, 3)
    lo, hi = px.min(axis=1) >> 1, px.max(axis=1) >> 1  # 7 bits; p-bit 0 below, 1 above
    e0, e1 = (lo << 1)[:, None], (hi << 1 | 1)[:, None]
    weights = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])
    levels = ((64 - weights[None, :, None]) * e0 + weights[None, :, None] * e1 + 32) >> 6  # [n, 16, 3]
    idx = ((px[:, :, None, :] - levels[:, None]) ** 2).sum(-1).argmin(-1)  # [n, 16]
    swap = idx[:, 0] >= 8  # the anchor's index has 3 bits: its top bit must be 0
    idx = np.where(swap[:, None], 15 - idx, idx)
    e0, e1 = np.where(swap[:, None], e1, e0)[:, 0] >> 1, np.where(swap[:, None], e0, e1)[:, 0] >> 1
    p0, p1 = np.where(swap, 1, 0), np.where(swap, 0, 1)
    fields = [(np.full(len(px), 64), 7)]
    for c in range(3):
        fields += [(e0[:, c], 7), (e1[:, c], 7)]
    fields += [(np.full(len(px), 127), 7), (np.full(len(px), 127), 7), (p0, 1), (p1, 1)]
    fields += [(idx[:, k], 3 if k == 0 else 4) for k in range(16)]
    bits, at = np.zeros((len(px), 128), np.uint8), 0
    for v, width in fields:
        for j in range(width):
            bits[:, at + j] = (v >> j) & 1
        at += width
    return np.packbits(bits, axis=1, bitorder="little").tobytes()


def dxt1_encode(image: np.ndarray) -> bytes:
    """DXT1 (BC1) blocks of uint8 [H, W, 3], rows of 4 x 4 blocks (edges padded by replication): each block's
    brightest and darkest pixels as its two 5-6-5 colours (colour 0 the larger, the four-colour form), every
    pixel the nearest of the four colours."""
    h, w = image.shape[:2]
    img = np.pad(image.astype(np.int64), ((0, -h % 4), (0, -w % 4), (0, 0)), mode="edge")
    bh, bw = img.shape[0] // 4, img.shape[1] // 4
    px = img.reshape(bh, 4, bw, 4, 3).transpose(0, 2, 1, 3, 4).reshape(bh, bw, 16, 3)
    luma = px @ np.array([2, 4, 1])
    hi = np.take_along_axis(px, luma.argmax(-1)[..., None, None], -2)[..., 0, :]
    lo = np.take_along_axis(px, luma.argmin(-1)[..., None, None], -2)[..., 0, :]
    c0 = (hi[..., 0] >> 3) << 11 | (hi[..., 1] >> 2) << 5 | hi[..., 2] >> 3
    c1 = (lo[..., 0] >> 3) << 11 | (lo[..., 1] >> 2) << 5 | lo[..., 2] >> 3
    c0, c1 = np.maximum(c0, c1), np.minimum(c0, c1)
    c0 = np.where(c0 == c1, np.minimum(c0 + 1, 0xFFFF), c0)
    c1 = np.where(c0 == c1, c1 - 1, c1)

    def rgb(c):
        return np.stack([(c >> 11 & 31) << 3, (c >> 5 & 63) << 2, (c & 31) << 3], -1)

    p0, p1 = rgb(c0), rgb(c1)
    table = np.stack([p0, p1, (2 * p0 + p1) // 3, (p0 + 2 * p1) // 3], -2)  # [bh, bw, 4, 3]
    idx = ((px[..., None, :] - table[..., None, :, :]) ** 2).sum(-1).argmin(-1)  # [bh, bw, 16]
    bits = (idx << (2 * np.arange(16))).sum(-1)
    out = np.stack([c0 & 255, c0 >> 8, c1 & 255, c1 >> 8] + [bits >> (8 * k) & 255 for k in range(4)], -1)
    return out.astype(np.uint8).tobytes()


def ftex_bytes(w: int, h: int, fmt: int, mip: bytes, *, formats: int = 1, where: int = 32,
               length: int = None) -> bytes:
    """An FTEX file (Pillow's FtexImagePlugin): "FTEX", version 1, the size, one mipmap of `formats` formats,
    format `fmt` (0: BC1 blocks, 1: packed RGB) at `where`, there its length (`length`, or the mip's) and
    bytes."""
    head = b"FTEX" + struct.pack("<i2i2i2i", 1, w, h, 1, formats, fmt, where)
    return head + bytes(max(0, where - len(head))) + struct.pack("<i", len(mip) if length is None else length) + mip


BLP_FORMS = ("blp1_jpeg", "blp1_palette", "blp2_palette", "blp2_dxt1", "blp2_dxt1_alpha", "blp2_dxt3", "blp2_dxt5")


def blp_bytes(form: str, image: np.ndarray, rng) -> bytes:
    """A BLP file of `form` (BLP_FORMS) for uint8 [H, W, 3] `image`, as Pillow's BlpImagePlugin reads it: BLP1
    a JPEG (this script's writer, its header up to the scan kept apart from the mipmap, the mipmap's offset
    past a seeded gap) or 256 BGRA palette entries and indices (encoding 4); BLP2 (compression 1) palette
    indices (encoding 1) or DXT blocks (encoding 2, alpha encoding 0 / 1 / 7; DXT1 of the image, DXT3 / DXT5
    seeded bits).  Palette forms quantise the image to a seeded palette; alpha forms set the alpha flag."""
    h, w = image.shape[:2]
    blp1 = form.startswith("blp1")
    alpha = form in ("blp2_dxt1_alpha", "blp2_dxt3", "blp2_dxt5", "blp1_palette")
    palette = rng.integers(0, 256, (256, 4), dtype=np.uint8)
    extra = b""
    if form == "blp1_jpeg":
        jpg = jpeg_bytes(image, 85)
        sos = jpg.index(b"\xff\xda")
        extra, mip = struct.pack("<I", sos) + jpg[:sos] + bytes(int(rng.integers(0, 5))), jpg[sos:]
    elif form.endswith("palette"):
        rgb = palette[:, [2, 1, 0]].astype(np.int64)
        dist = ((image.reshape(-1, 1, 3).astype(np.int64) - rgb[None]) ** 2).sum(-1)
        extra, mip = palette.tobytes(), dist.argmin(-1).astype(np.uint8).tobytes()
    else:
        n = ((w + 3) // 4) * ((h + 3) // 4)
        extra = palette.tobytes()
        mip = dxt1_encode(image) if "dxt1" in form else rng.integers(0, 256, n * 16, dtype=np.uint8).tobytes()
    base = 28 if blp1 else 20
    offset = 0 if form == "blp1_palette" else base + 128 + len(extra)  # BLP1's indices follow the palette
    if blp1:
        jpg = form == "blp1_jpeg"
        head = b"BLP1" + struct.pack("<iIIIii", 0 if jpg else 1, int(alpha), w, h, 0 if jpg else 4, 0)
    else:
        enc, aenc = (1, 0) if form == "blp2_palette" else (2, {"dxt3": 1, "dxt5": 7}.get(form[-4:], 0))
        head = b"BLP2" + struct.pack("<ibbbbII", 1, enc, 8 if alpha else 0, aenc, 0, w, h)
    offsets = struct.pack("<16I", offset, *([0] * 15))
    lengths = struct.pack("<16I", len(mip), *([0] * 15))
    return head + offsets + lengths + extra + mip


# ------------------------------- writers of FITS, FLI / FLC, PCD and IPTC files (Pillow writes none of them)


def fits_card(key: str, value=None) -> bytes:
    """An 80-byte FITS card: the keyword, and "= " and the value right-aligned to column 30 where given."""
    card = key.ljust(8).encode()
    if value is not None:
        card += b"= " + (value if isinstance(value, bytes) else str(value).encode()).rjust(20)
    return card.ljust(80)


def fits_header(cards: list) -> bytes:
    """Cards, END, and blanks to a multiple of 2880 bytes."""
    head = b"".join(cards) + fits_card("END")
    return head + b" " * (-len(head) % 2880)


def fits_bytes(pixels: bytes, bitpix: int, w: int, h: int, *, naxis: int = 2, cards: tuple = ()) -> bytes:
    """A FITS file of one primary image: SIMPLE = T, BITPIX, NAXIS (1: NAXIS1 = h, as Pillow reads it; 3: a
    second plane of zeros after the first), `cards`, then `pixels` (the file's bytes of h rows of w samples,
    the first row the bottom one as Pillow reads it), padded with zeros to a multiple of 2880."""
    axes = [fits_card("NAXIS1", h)] if naxis == 1 else [fits_card("NAXIS1", w), fits_card("NAXIS2", h)]
    if naxis == 3:
        axes.append(fits_card("NAXIS3", 2))
        pixels += bytes(len(pixels))
    head = fits_header([fits_card("SIMPLE", "T"), fits_card("BITPIX", bitpix), fits_card("NAXIS", naxis), *axes,
                        *cards])
    return head + pixels + bytes(-len(pixels) % 2880)


def fits_gzip_bytes(groups: bytes, zbitpix: int, w: int, h: int, table: tuple = (8, 1)) -> bytes:
    """A tiled FITS file as Pillow's GZIP_1 reader takes it: a primary header of NAXIS 0, a BINTABLE extension
    (ZIMAGE = T, ZCMPTYPE = 'GZIP_1  ', ZBITPIX, ZNAXIS1 / 2 = w / h) of `table` (NAXIS1, NAXIS2) bytes, then
    the gzip stream of `groups` (4 bytes a pixel, rows bottom-up as Pillow reads them) and zeros to 2880."""
    primary = fits_header([fits_card("SIMPLE", "T"), fits_card("BITPIX", 8), fits_card("NAXIS", 0),
                           fits_card("EXTEND", "T")])
    ext = fits_header([fits_card("XTENSION", b"'BINTABLE'"), fits_card("BITPIX", 8), fits_card("NAXIS", 2),
                       fits_card("NAXIS1", table[0]), fits_card("NAXIS2", table[1]), fits_card("ZIMAGE", "T"),
                       fits_card("ZCMPTYPE", b"'GZIP_1  '"), fits_card("ZBITPIX", zbitpix), fits_card("ZNAXIS", 2),
                       fits_card("ZNAXIS1", w), fits_card("ZNAXIS2", h)])
    data = bytes(table[0] * table[1]) + gzip_member(groups)
    return primary + ext + data + bytes(-len(data) % 2880)


def gzip_member(data: bytes) -> bytes:
    """A gzip member of `data` (zlib's deflate, no name, mtime 0)."""
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = c.compress(data) + c.flush()
    return b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff" + body + struct.pack("<II", zlib.crc32(data), len(data))


def fits_samples(image: np.ndarray, bitpix: int, rng) -> bytes:
    """A FITS data part whose samples Pillow reads as the grey image uint8 [H, W] (its rows bottom-up): BITPIX
    16 / 32 as the little-endian bytes Pillow's reading takes, a seeded few above 255 or below 0; -32 / -64
    as little-endian float32 within 0.5 of the value (-64: each sample's second 4 bytes seeded, since Pillow
    reads float32 from the first half of the rows' bytes)."""
    grey = image[::-1].astype(np.int64)
    odd = rng.random(grey.shape) < 0.05
    if bitpix == 8:
        return grey.astype(np.uint8).tobytes()
    if bitpix == 16:
        return np.where(odd, grey + 256 * rng.integers(1, 256, grey.shape), grey).astype("<u2").tobytes()
    if bitpix == 32:
        return np.where(odd, rng.integers(-(2 ** 31), 2 ** 31, grey.shape), grey).astype("<i4").tobytes()
    values = (grey + rng.uniform(-0.5, 0.5, grey.shape)).astype("<f4")
    if bitpix == -32:
        return values.tobytes()
    h, w = grey.shape  # Pillow reads 4 * w * h bytes from the 8 * w * h the rows hold
    return values.tobytes() + rng.bytes(4 * w * h)


def fli_chunk(kind: int, body: bytes, pad: bool = True) -> bytes:
    """An FLI subchunk: its size (6 + the body, made even where `pad`), type and body."""
    body += b"\0" * (pad and len(body) % 2)
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_frame(chunks: list, kind: int = 0xF1FA) -> bytes:
    """An FLI frame chunk of subchunks: its size, type, count and 8 reserved bytes."""
    body = b"".join(chunks)
    return struct.pack("<IHH8x", 16 + len(body), kind, len(chunks)) + body


def fli_palette(palette: np.ndarray, packets: list, shift: int) -> bytes:
    """A COLOR_256 (shift 0) / COLOR_64 (shift 2) chunk's body: packets of (skip, count) over the palette's
    [256, 3] entries (a count of 256 written as 0), each entry shifted right by `shift`."""
    out, i = bytearray(struct.pack("<H", len(packets))), 0
    for skip, count in packets:
        i += skip
        out += bytes((skip, count % 256)) + (palette[i : i + count] >> shift).astype(np.uint8).tobytes()
        i += count
    return bytes(out)


def _runs(row: np.ndarray) -> list:
    """(value, length) runs of a uint8 row."""
    edges = np.flatnonzero(np.diff(row.astype(np.int16))) + 1
    starts = np.concatenate([[0], edges])
    lengths = np.diff(np.concatenate([starts, [len(row)]]))
    return list(zip(row[starts].tolist(), lengths.tolist()))


def fli_brun(indices: np.ndarray) -> bytes:
    """A BRUN chunk's body: each row a packet count byte, runs of 2-127 equal bytes (count, value) and
    literals of 1-128 bytes (256 - count, bytes)."""
    out = bytearray()
    for row in indices:
        packets, line, literal = 0, bytearray(), bytearray()

        def flush():
            nonlocal packets, literal
            for k in range(0, len(literal), 128):
                part = literal[k : k + 128]
                line.extend(bytes((256 - len(part),)) + part)
                packets += 1
            literal = bytearray()

        for value, length in _runs(row):
            if length < 2:
                literal.append(value)
                continue
            flush()
            while length:
                n = min(length, 127)
                if n < 2:
                    literal.append(value)
                    flush()
                else:
                    line += bytes((n, value))
                    packets += 1
                length -= n
        flush()
        out += bytes((packets % 256,)) + line
    return bytes(out)


def fli_ss2(old: np.ndarray, new: np.ndarray) -> bytes:
    """An SS2 (word delta) chunk's body taking `old` to `new`: unchanged rows skipped by a skip word, an odd
    width's last pixel by its word, each row's changed words as runs of 2-128 equal words (-count) or literals
    of up to 127 words, skips of more than 255 pixels split by empty literals."""
    h, w = new.shape
    even = w - w % 2
    records, skip = [], 0
    for y in range(h):
        if np.array_equal(old[y], new[y]):
            skip += 1
            continue
        rec = bytearray()
        while skip:
            n = min(skip, 16384)
            rec += struct.pack("<H", 65536 - n)
            skip -= n
        if w % 2:
            rec += struct.pack("<H", 0x8000 | int(new[y, -1]))
        words = new[y, :even].view("<u2") if even else np.zeros(0, "<u2")
        changed = (old[y, :even].view("<u2") != words).tolist() if even else []
        values = words.tolist()
        packets, body, x, i, n = 0, bytearray(), 0, 0, len(values)
        while i < n:
            if not changed[i]:
                i += 1
                continue
            while 2 * i - x > 255:
                body += bytes((255, 0))
                x += 255
                packets += 1
            run = 1
            while i + run < n and run < 128 and values[i + run] == values[i]:
                run += 1
            if run >= 2:
                body += bytes((2 * i - x, 256 - run)) + struct.pack("<H", values[i])
            else:
                while i + run < n and run < 127 and changed[i + run] and values[i + run] != values[i + run - 1]:
                    run += 1
                body += bytes((2 * i - x, run)) + struct.pack(f"<{run}H", *values[i : i + run])
            packets += 1
            i += run
            x = 2 * i
        rec += struct.pack("<H", packets) + body
        records.append(bytes(rec))
    return struct.pack("<H", len(records)) + b"".join(records)


def fli_lc(old: np.ndarray, new: np.ndarray) -> bytes:
    """An LC (byte delta) chunk's body taking `old` to `new`: the first changed row and the rows' count, then
    each row's packets (skip, count): literals of up to 127 bytes, runs of 2-128 equal bytes as -count."""
    rows = np.flatnonzero((old != new).any(1))
    if not len(rows):
        return struct.pack("<HH", 0, 0)
    first, last = int(rows[0]), int(rows[-1])
    out = bytearray(struct.pack("<HH", first, last - first + 1))
    for y in range(first, last + 1):
        changed = np.flatnonzero(old[y] != new[y])
        packets, body, x, k = 0, bytearray(), 0, 0
        while k < len(changed):
            start = int(changed[k])
            while start - x > 255:
                body += bytes((255, 0))
                x += 255
                packets += 1
            run = 1
            while start + run < new.shape[1] and run < 128 and new[y, start + run] == new[y, start]:
                run += 1
            if run >= 2:
                body += bytes((start - x, 256 - run, int(new[y, start])))
            else:
                end = start + 1
                while end < new.shape[1] and end - start < 127 and new[y, end] != old[y, end]:
                    end += 1
                run = end - start
                body += bytes((start - x, run)) + new[y, start:end].tobytes()
            packets += 1
            x = start + run
            k = int(np.searchsorted(changed, x))
        out += bytes((packets,)) + body
    return bytes(out)


FLI_FORMS = ("fli_brun", "fli_color64_lc", "flc_brun_ss2", "flc_copy_lc", "flc_black_ss2_odd", "flc_pstamp",
             "flc_palette_mid", "flc_two_frames")


def fli_bytes(form: str, indices: np.ndarray, rng, palette: np.ndarray = None, packets: list = None) -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) file of `form` (FLI_FORMS) whose first frame gives the palette indices
    uint8 [H, W] as Pillow reads it: BRUN (15), COPY (16) or BLACK (13), and after it an LC (12) or SS2 (7)
    delta from a seeded change of the image, or a postage stamp (18); a COLOR_256 (4) or COLOR_64 (11)
    chunk of `packets` ((skip, count) pairs, seeded where None) over `palette` ([256, 3], seeded where None)
    first, or after the image chunk
    ("flc_palette_mid": the header's walk still reads it); "flc_two_frames" adds a second frame, which Pillow
    does not read for the first."""
    indices = np.ascontiguousarray(indices, np.uint8)
    h, w = indices.shape
    if palette is None:
        palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    shift = 2 if "color64" in form else 0
    start = int(rng.integers(0, 8))
    if packets is None:
        packets = [(start, int(rng.integers(1, 129))), (int(rng.integers(0, 4)), int(rng.integers(1, 64)))]
    colour = fli_chunk(11 if shift else 4, fli_palette(palette, packets, shift))
    base = indices.copy()
    rows = rng.random(h) < 0.7
    base[rows] = np.roll(indices[rows], int(rng.integers(1, 9)), axis=1)
    base[rng.random((h, w)) < 0.1] = int(rng.integers(0, 256))
    if form in ("fli_brun", "flc_pstamp", "flc_palette_mid", "flc_two_frames"):
        image = [fli_chunk(15, fli_brun(indices))]
    elif form == "flc_copy_lc":
        image = [fli_chunk(16, base.tobytes()), fli_chunk(12, fli_lc(base, indices))]
    elif form == "fli_color64_lc":
        image = [fli_chunk(15, fli_brun(base)), fli_chunk(12, fli_lc(base, indices))]
    elif form == "flc_brun_ss2":
        image = [fli_chunk(15, fli_brun(base)), fli_chunk(7, fli_ss2(base, indices))]
    else:  # flc_black_ss2_odd: BLACK, then SS2 from zeros
        image = [fli_chunk(13, b""), fli_chunk(7, fli_ss2(np.zeros_like(indices), indices))]
    if form == "flc_pstamp":
        image = [fli_chunk(18, struct.pack("<HHH", 20, 30, 1) + rng.bytes(40))] + image
    chunks = image[:1] + [colour] + image[1:] if form == "flc_palette_mid" else [colour] + image
    frames = [fli_frame(chunks)]
    if form == "flc_two_frames":
        frames.append(fli_frame([fli_chunk(13, b"")]))
    body = b"".join(frames)
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(body), 0xAF11 if form.startswith("fli") else 0xAF12,
                     len(frames), w, h, 8, 3 if form.startswith("flc") else 0, 70)
    return bytes(head) + body


PCD_SIZE = 96 * 2048 + 256 * 3 * 768


def pcd_bytes(image: np.ndarray, orientation: int = 0, rng=None) -> bytes:
    """A PhotoCD file of Photo YCC samples for uint8 [512, 768, 3] `image` (each pixel's luma from its RGB,
    chroma from its pair of rows and columns; a seeded preamble where `rng` is given), "PCD_" at 2048 and
    `orientation` at 2048 + 1538."""
    rgb = image.astype(np.float64)
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    luma = np.clip(y / 1.3584, 0, 255)
    c1 = np.clip((rgb[..., 2] - y) / 2.2179 + 156, 0, 255).reshape(256, 2, 384, 2).mean((1, 3))
    c2 = np.clip((rgb[..., 0] - y) / 1.8215 + 137, 0, 255).reshape(256, 2, 384, 2).mean((1, 3))
    chunks = np.concatenate([luma.reshape(256, 2 * 768), c1, c2], axis=1).round().astype(np.uint8)
    head = bytearray(rng.bytes(96 * 2048) if rng is not None else bytes(96 * 2048))
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    return bytes(head) + chunks.tobytes()


def iptc_field(record: int, dataset: int, data: bytes, long: bool = False) -> bytes:
    """An IPTC/NAA field: 0x1C, record, dataset, and its length: two bytes below 0x8000, or where `long` (or
    longer) as Pillow reads an extended length: 0x84, a byte it skips, then 4 bytes."""
    if long or len(data) > 0x7FFF:
        return bytes((0x1C, record, dataset, 0x84, 0)) + struct.pack(">I", len(data)) + data
    return bytes((0x1C, record, dataset)) + struct.pack(">H", len(data)) + data


def iptc_bytes(image: bytes, w: int, h: int, *, layers: int = 1, component: int = 0, band: int = None,
               compression: int = 1, pieces: int = 1) -> bytes:
    """An IPTC/NAA file as Pillow's IptcImagePlugin reads it: a record-2 field, the size (3, 20) / (3, 30),
    layers and component (3, 60), the band (3, 65) where given, the compression (3, 120; 1 raw, 5 a file
    Image.open reads), then `image` in `pieces` (8, 10) fields."""
    fields = [iptc_field(2, 0, b"\x00\x02"), iptc_field(3, 20, struct.pack(">H", w)),
              iptc_field(3, 30, struct.pack(">H", h)), iptc_field(3, 60, bytes((layers, component)))]
    if band is not None:
        fields.append(iptc_field(3, 65, bytes((band,))))
    fields.append(iptc_field(3, 120, bytes((compression,))))
    cuts = np.linspace(0, len(image), pieces + 1).astype(int)
    fields += [iptc_field(8, 10, image[a:b], long=k % 2 == 1) for k, (a, b) in enumerate(zip(cuts[:-1], cuts[1:]))]
    return b"".join(fields)



def plugin_file(form: str, seed: int, w: int, h: int) -> bytes:
    """One seeded w x h file of `form` (P13_PLUGINS): a FITS image of BITPIX 16 (the grey of a smooth field),
    an FLC file of the field's colour-cube indices (BRUN and an SS2 delta, the cube a COLOR_256 chunk), a
    PhotoCD file (its fixed 768 x 512, orientation 1), an IPTC file of a baseline JPEG (compression 5) or an
    AVIF file of the stored corpus (P13_AVIF: no AVIF writer here)."""
    rng = np.random.default_rng(seed)
    if form == "avif":  # no AVIF writer here: a file of the stored corpus
        return (AVIF_CORPUS / P13_AVIF).read_bytes()
    if form == "pcd":
        return pcd_bytes(raw_image(seed, 768, 512), 1, rng)
    img = raw_image(seed, w, h)
    if form == "fits":
        return fits_bytes(fits_samples(img[..., 1], 16, rng), 16, w, h)
    if form == "iptc":
        return iptc_bytes(jpeg_bytes(img), w, h, compression=5)
    idx, cube = colour_cube(img)
    palette = np.zeros((256, 3), np.uint8)
    palette[:216] = np.frombuffer(cube, np.uint8).reshape(216, 3)
    return fli_bytes("flc_brun_ss2", idx, rng, palette, packets=[(0, 256)])


def plugin_rate_files() -> dict:
    """name -> file bytes: the FITS, FLI / FLC, PCD and IPTC files whose one-thread decode rates the decoder
    phase and scripts/rare_format_rates.py report: FITS 640 x 480 at BITPIX 8, 16 and -32 and in GZIP_1 tiles
    (ZBITPIX 8), FLI 320 x 200 of BRUN, FLC 640 x 480 of BRUN and SS2, PCD (768 x 512), IPTC 640 x 480 raw and
    of a baseline JPEG."""
    w, h = RASTER_SIZE
    rng = np.random.default_rng(SEED + 8700)
    rgb = raw_image(SEED + 8701, w, h)
    grey = rgb[..., 1]
    groups = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    groups[..., 3] = grey[::-1]
    idx = colour_cube(rgb)[0]
    return {
        **{f"fits_{abs(bits)}{'' if bits > 0 else 'f'}": fits_bytes(fits_samples(grey, bits, rng), bits, w, h)
           for bits in (8, 16, -32)},
        "fits_gzip_8": fits_gzip_bytes(groups.tobytes(), 8, w, h),
        "fli_brun_320x200": fli_bytes("fli_brun", colour_cube(raw_image(SEED + 8702, 320, 200))[0], rng),
        "flc_brun_ss2_640x480": fli_bytes("flc_brun_ss2", idx, rng),
        "pcd_768x512": pcd_bytes(raw_image(SEED + 8703, 768, 512), 0, rng),
        "iptc_raw": iptc_bytes(grey.tobytes(), w, h),
        "iptc_jpeg": iptc_bytes(jpeg_bytes(rgb), w, h, compression=5),
    }


def check_plugin_rates(smi: str) -> None:
    """One-thread decode rates of plugin_rate_files() through `jpeg.decode_image` on the card's run (FLI /
    FLC through csrc/raster.cu, IPTC's JPEG through csrc/jpeg.cu, FITS / PCD / IPTC raw numpy on both paths),
    median of 5 after a first decode held to the twins' pixels, beside one decode on the twins' path."""
    from uniir_tpu_torch.data import jpeg, raster

    for name, data in plugin_rate_files().items():
        t0 = time.perf_counter()
        want = jpeg.decode_image(data, name, "cpu")
        twin_ms = (time.perf_counter() - t0) * 1e3
        calls = raster.native_calls["fli"]
        got = jpeg.decode_image(data, name, DEVICE)
        check(np.array_equal(got, want) and raster.native_calls["fli"] - calls == int(name.startswith("fl")),
              f"decoder phase: {name} differs from its twins, or missed the native FLI stage")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jpeg.decode_image(data, name, DEVICE)
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        h, w = got.shape[:2]
        log(f"decoder phase: {jpeg.image_format(data).upper()} rate {name} ({w} x {h}, {len(data)} bytes): {ms:.3f} ms "
            f"({1e3 / ms:.1f} images/s, {w * h / ms / 1e3:.2f} Mpixel/s) on one thread, median of 5; the twins' "
            f"path {twin_ms:.1f} ms (host CPU {host_cpu()}; card {smi})")

def icns_rle(plane: bytes) -> bytes:
    """An ICNS RLE channel: runs of 3-130 equal bytes as (n + 125, v), literals of 1-128 bytes as (n - 1, ...)."""
    out, i, n = bytearray(), 0, len(plane)
    while i < n:
        run = 1
        while i + run < n and plane[i + run] == plane[i] and run < 130:
            run += 1
        if run >= 3:
            out += bytes((run + 125, plane[i]))
            i += run
            continue
        k = 1
        while i + k < n and k < 128 and not (i + k + 2 < n and plane[i + k] == plane[i + k + 1] == plane[i + k + 2]):
            k += 1
        out += bytes((k - 1,)) + plane[i : i + k]
        i += k
    return bytes(out)


ICNS_RLE_TYPES = {16: (b"is32", b"s8mk"), 32: (b"il32", b"l8mk"), 48: (b"ih32", b"h8mk"), 128: (b"it32", b"t8mk")}


def icns_bytes(entries: list) -> bytes:
    """An ICNS file of (type, data) entries in order."""
    body = b"".join(kind + struct.pack(">I", 8 + len(data)) + data for kind, data in entries)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rle_entries(image: np.ndarray, mask: np.ndarray = None) -> list:
    """The RLE entry (it32's with its 4 zero bytes) of uint8 [s, s, 3], s one of ICNS_RLE_TYPES, and its mask;
    an RLE stream of exactly 3 s^2 bytes, which Pillow would read raw, gets a byte after it."""
    kind, mask_kind = ICNS_RLE_TYPES[image.shape[0]]
    data = b"".join(icns_rle(image[..., c].tobytes()) for c in range(3))
    data = (b"\0\0\0\0" if kind == b"it32" else b"") + data + (b"\0" if len(data) == image.size else b"")
    return [(kind, data)] + ([(mask_kind, mask.tobytes())] if mask is not None else [])


# --- the WebP writer: VP8L, VP8 key frames and the RIFF forms, without Pillow or libwebp


class LsbWriter:
    """VP8L's bit order: values least significant bit first."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value: int, bits: int) -> None:
        self.acc |= (value & ((1 << bits) - 1)) << self.n
        self.n += bits
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def code(self, code: int, length: int) -> None:  # a prefix code's bits, its first (most significant) bit first
        for k in range(length - 1, -1, -1):
            self.put((code >> k) & 1, 1)

    def bytes(self) -> bytes:
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")


def huffman_lengths(counts, limit: int) -> list:
    """Code lengths of a complete prefix code over the symbols with counts > 0 (Huffman's, or a balanced
    code where Huffman's is longer than `limit`); one used symbol: length 1."""
    used = [s for s, c in enumerate(counts) if c > 0]
    lengths = [0] * len(counts)
    if len(used) <= 1:
        for s in used:
            lengths[s] = 1
        return lengths
    heap = [(counts[s], i, [s]) for i, s in enumerate(used)]
    heapq.heapify(heap)
    tie = len(heap)
    while len(heap) > 1:
        c1, _, s1 = heapq.heappop(heap)
        c2, _, s2 = heapq.heappop(heap)
        for s in s1 + s2:
            lengths[s] += 1
        heapq.heappush(heap, (c1 + c2, tie, s1 + s2))
        tie += 1
    if max(lengths) > limit:
        k = (len(used) - 1).bit_length()
        short = (1 << k) - len(used)  # this many at k - 1 bits, the rest at k: a complete code
        for i, s in enumerate(sorted(used, key=lambda s: -counts[s])):
            lengths[s] = k - 1 if i < short else k
    return lengths


def canonical_codes(lengths) -> list:
    """Each symbol's code under canonical assignment in (length, symbol) order."""
    codes, code, prev = [0] * len(lengths), 0, 0
    for ln, s in sorted((ln, s) for s, ln in enumerate(lengths) if ln):
        code <<= ln - prev
        prev = ln
        codes[s] = code
        code += 1
    return codes


VP8L_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _code_length_tokens(lengths, stop: int, rng) -> list:
    """The code lengths [0, stop) as code-length symbols (symbol, extra bits, extra value): zero runs as
    17 / 18, repeats of the last non-zero length (8 before any) as 16, at random."""
    tokens, i, prev = [], 0, 8
    while i < stop:
        ln, j = lengths[i], i
        while j < stop and lengths[j] == ln:
            j += 1
        run = j - i
        if ln == 0 and run >= 3:
            take = min(run, 138)
            tokens.append((18, 7, take - 11) if take >= 11 else (17, 3, take - 3))
            i += take
        elif ln and ln == prev and run >= 3 and rng.random() < 0.8:
            take = min(run, 6)
            tokens.append((16, 2, take - 3))
            i += take
        else:
            tokens.append((ln, 0, 0))
            if ln:
                prev = ln
            i += 1
    return tokens


def vp8l_write_code(bw: LsbWriter, counts, rng) -> tuple:
    """One prefix code for the symbol counts: a simple code where one or two symbols below 256 are used
    (randomly the 1-bit form for symbol 0 / 1), else a normal code through the code-length code with
    repeat codes 16 / 17 / 18 and, at random, a count of lengths to read.  Returns (lengths, codes)."""
    used = [s for s, c in enumerate(counts) if c > 0] or [0]
    if len(used) <= 2 and max(used) < 256 and rng.random() < 0.7:
        bw.put(1, 1)
        bw.put(len(used) - 1, 1)
        small = used[0] < 2 and rng.random() < 0.5
        bw.put(0 if small else 1, 1)
        bw.put(used[0], 1 if small else 8)
        if len(used) == 2:
            bw.put(used[1], 8)
        lengths = [0] * len(counts)
        if len(used) == 2:  # one used symbol reads no bits
            lengths[used[0]] = lengths[used[1]] = 1
        return lengths, canonical_codes(lengths)
    lengths = huffman_lengths([c if s in used else 0 for s, c in enumerate(counts)] if any(counts)
                              else [1 if s == used[0] else 0 for s in range(len(counts))], 15)
    # the lengths as code-length symbols: (symbol, extra bits, extra value)
    n, last = len(lengths), max(s for s, ln in enumerate(lengths) if ln)
    stop = last + 1 if rng.random() < 0.5 else n  # with a count, the trailing zeros are not written
    tokens = _code_length_tokens(lengths, stop, rng)
    if stop < n and len(tokens) < 2:  # a count is at least 2
        stop = n
        tokens = _code_length_tokens(lengths, stop, rng)
    cl_counts = [0] * 19
    for sym, _, _ in tokens:
        cl_counts[sym] += 1
    cl_lengths = huffman_lengths(cl_counts, 7)
    cl_codes = canonical_codes(cl_lengths)
    num = max(4, max(k for k, s in enumerate(VP8L_CODE_LENGTH_ORDER) if cl_lengths[s]) + 1)
    bw.put(0, 1)
    bw.put(num - 4, 4)
    for k in range(num):
        bw.put(cl_lengths[VP8L_CODE_LENGTH_ORDER[k]], 3)
    if stop < n:
        count = len(tokens)
        nbits = max(2, (count - 2).bit_length() + ((count - 2).bit_length() & 1))
        bw.put(1, 1)
        bw.put((nbits - 2) // 2, 3)
        bw.put(count - 2, nbits)
    else:
        bw.put(0, 1)
    one = sum(1 for ln in cl_lengths if ln) == 1
    for sym, extra, value in tokens:
        if not one:
            bw.code(cl_codes[sym], cl_lengths[sym])
        bw.put(value, extra)
    if sum(1 for ln in lengths if ln) == 1:
        lengths = [0] * n  # one used symbol: read with no bits
    return lengths, canonical_codes(lengths)


def prefix_encode(value: int) -> tuple:
    """VP8L's prefix coding of a length or distance code >= 1: (symbol, extra bits, extra value)."""
    if value <= 4:
        return value - 1, 0, 0
    v = value - 1
    high = v.bit_length() - 1
    second = (v >> (high - 1)) & 1
    return 2 * high + second, high - 1, v & ((1 << (high - 1)) - 1)


VP8L_PLANE = [((d >> 4), 8 - (d & 15)) for d in bytes([
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1A, 0x26, 0x2A, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1B,
    0x36, 0x3A, 0x25, 0x2B, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1C, 0x35, 0x3B, 0x46, 0x4A, 0x24, 0x2C, 0x58, 0x45,
    0x4B, 0x34, 0x3C, 0x03, 0x57, 0x59, 0x13, 0x1D, 0x56, 0x5A, 0x23, 0x2D, 0x44, 0x4C, 0x55, 0x5B, 0x33, 0x3D,
    0x68, 0x02, 0x67, 0x69, 0x12, 0x1E, 0x66, 0x6A, 0x22, 0x2E, 0x54, 0x5C, 0x43, 0x4D, 0x65, 0x6B, 0x32, 0x3E,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5D, 0x11, 0x1F, 0x64, 0x6C, 0x42, 0x4E, 0x76, 0x7A, 0x21, 0x2F, 0x75, 0x7B,
    0x31, 0x3F, 0x63, 0x6D, 0x52, 0x5E, 0x00, 0x74, 0x7C, 0x41, 0x4F, 0x10, 0x20, 0x62, 0x6E, 0x30, 0x73, 0x7D,
    0x51, 0x5F, 0x40, 0x72, 0x7E, 0x61, 0x6F, 0x50, 0x71, 0x7F, 0x60, 0x70,
])]  # the distance map of RFC 9649 section 4.2.2: code - 1 -> (dy, dx)


def vp8l_entropy_image(bw: LsbWriter, pix: list, width: int, rng, *, cache_bits: int = 0, meta_bits: int = 0,
                       groups: int = 1, copies: float = 0.3, level0: bool = True) -> None:
    """The coded pixels (ARGB ints, `width` a row) as VP8L writes them after the transforms: a colour
    cache of `cache_bits`, a meta-Huffman image of `groups` groups over tiles of 2^meta_bits (level 0
    only), and ops drawn at random: a copy wherever one matches (its distance from the 120-entry map or
    direct), a cache hit where the cache holds the pixel, else a literal."""
    n = len(pix)
    height = n // width
    if cache_bits:
        bw.put(1, 1)
        bw.put(cache_bits, 4)
    else:
        bw.put(0, 1)
    tiles = None
    if level0:
        if meta_bits:
            bw.put(1, 1)
            bw.put(meta_bits - 2, 3)
            tw, th = -(-width // (1 << meta_bits)), -(-height // (1 << meta_bits))
            tiles = rng.integers(0, groups, tw * th).tolist()
            tiles[int(rng.integers(0, len(tiles)))] = groups - 1  # the largest index is used
            vp8l_entropy_image(bw, [t << 8 for t in tiles], tw, rng, level0=False, copies=0.1)
        else:
            bw.put(0, 1)
    ngroups = groups if tiles is not None else 1
    cache = [None] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    ops, pos = [], 0
    while pos < n:
        x, y = pos % width, pos // width
        g = tiles[(y >> meta_bits) * (-(-width // (1 << meta_bits))) + (x >> meta_bits)] if tiles is not None else 0
        op = None
        if pos and rng.random() < copies:
            if rng.random() < 0.7:
                code = int(rng.integers(1, 121))
                dy, dx = VP8L_PLANE[code - 1]
                dist = max(1, dy * width + dx)
            else:
                dist = int(rng.integers(1, pos + 1))
                code = dist + 120
            if dist <= pos:
                length = 1
                while pos + length < n and length < 4096 and pix[pos + length] == pix[pos + length - dist]:
                    length += 1
                if pix[pos] == pix[pos - dist] and (length > 1 or rng.random() < 0.3):
                    op = ("copy", g, length, code)
        if op is None and cache is not None:
            p = pix[pos]
            key = ((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift
            if cache[key] == p and rng.random() < 0.8:
                op = ("cache", g, key)
        if op is None:
            op = ("literal", g, pix[pos])
        step = op[2] if op[0] == "copy" else 1
        if cache is not None:
            for p in pix[pos : pos + step]:
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
        ops.append(op)
        pos += step
    alphabet = (280 + (1 << cache_bits if cache_bits else 0), 256, 256, 256, 40)
    counts = [[[0] * a for a in alphabet] for _ in range(ngroups)]
    for op in ops:
        c = counts[op[1]]
        if op[0] == "literal":
            p = op[2]
            c[0][(p >> 8) & 255] += 1
            c[1][(p >> 16) & 255] += 1
            c[2][p & 255] += 1
            c[3][p >> 24] += 1
        elif op[0] == "cache":
            c[0][280 + op[2]] += 1
        else:
            c[0][256 + prefix_encode(op[2])[0]] += 1
            c[4][prefix_encode(op[3])[0]] += 1
    tables = [[vp8l_write_code(bw, c, rng) for c in group] for group in counts]
    for op in ops:
        (gl, gc), (rl, rc), (bl, bc), (al, ac), (dl, dc) = tables[op[1]]

        def sym(table, s):
            ln, cd = table
            if ln[s]:
                bw.code(cd[s], ln[s])

        if op[0] == "literal":
            p = op[2]
            sym((gl, gc), (p >> 8) & 255)
            sym((rl, rc), (p >> 16) & 255)
            sym((bl, bc), p & 255)
            sym((al, ac), p >> 24)
        elif op[0] == "cache":
            sym((gl, gc), 280 + op[2])
        else:
            s, extra, value = prefix_encode(op[2])
            sym((gl, gc), 256 + s)
            bw.put(value, extra)
            s, extra, value = prefix_encode(op[3])
            sym((dl, dc), s)
            bw.put(value, extra)


def _vp8l_avg(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _vp8l_channels(f, *pixels) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        out |= min(255, max(0, f(*((p >> s) & 255 for p in pixels)))) << s
    return out


def vp8l_predict(mode: int, left: int, top: int, tr: int, tl: int) -> int:
    """RFC 9649's predictors 0-13 (14, 15: black as 0)."""
    if mode == 1:
        return left
    if mode in (2, 3, 4):
        return (top, tr, tl)[mode - 2]
    if mode in (5, 6, 7, 8, 9, 10):
        return (_vp8l_avg(_vp8l_avg(left, tr), top), _vp8l_avg(left, tl), _vp8l_avg(left, top),
                _vp8l_avg(tl, top), _vp8l_avg(top, tr),
                _vp8l_avg(_vp8l_avg(left, tl), _vp8l_avg(top, tr)))[mode - 5]
    if mode == 11:
        pl = sum(abs(((top >> s) & 255) - ((tl >> s) & 255)) for s in (0, 8, 16, 24))
        pt = sum(abs(((left >> s) & 255) - ((tl >> s) & 255)) for s in (0, 8, 16, 24))
        return left if pl < pt else top
    if mode == 12:
        return _vp8l_channels(lambda a, b, c: a + b - c, left, top, tl)
    if mode == 13:
        return _vp8l_channels(lambda a, c: a + int((a - c) / 2), _vp8l_avg(left, top), tl)
    return 0xFF000000


def _vp8l_sub(a: int, b: int) -> int:  # per byte, mod 256
    return (((a | 0x00FF00FF) - (b & 0xFF00FF00)) & 0xFF00FF00) | (((a | 0xFF00FF00) - (b & 0x00FF00FF)) & 0x00FF00FF)


def vp8l_bitstream(argb: np.ndarray, rng, *, header: bool = True, transforms=(), predictor_bits: int = 3,
                   cross_bits: int = 4, palette: np.ndarray = None, cache_bits: int = 0, meta_bits: int = 0,
                   groups: int = 1, copies: float = 0.3, alpha_hint: bool = True) -> bytes:
    """A VP8L stream that decodes to `argb` (uint32 [h, w]) exactly: the named transforms applied forward in
    order ("predictor": seeded modes 0-15 a tile; "cross": seeded multipliers a tile; "subtract_green";
    "palette": colour indexing through `palette`, which must hold every colour of the image, packing
    2 / 4 / 8 indices a byte at <= 16 colours), then `vp8l_entropy_image`.  `header` False: the headerless
    stream of an ALPH chunk."""
    h, w = argb.shape
    bw = LsbWriter()
    if header:
        bw.put(0x2F, 8)
        bw.put(w - 1, 14)
        bw.put(h - 1, 14)
        bw.put(int(alpha_hint), 1)
        bw.put(0, 3)
    pix = [int(v) for v in argb.reshape(-1)]
    width = w
    for t in transforms:
        bw.put(1, 1)
        if t == "predictor":
            bits = predictor_bits
            tw = -(-width // (1 << bits))
            modes = rng.integers(0, 16, tw * -(-h // (1 << bits))).tolist()
            bw.put(0, 2)
            bw.put(bits - 2, 3)
            vp8l_entropy_image(bw, [0xFF000000 | (m << 8) | int(rng.integers(0, 256)) << 16 for m in modes], tw, rng,
                               level0=False, copies=0.2)
            res = pix[:]
            for y in range(h):
                for x in range(width):
                    i = y * width + x
                    if y == 0:
                        pred = 0xFF000000 if x == 0 else pix[i - 1]
                    elif x == 0:
                        pred = pix[i - width]
                    else:
                        tr = pix[i - width + 1] if x + 1 < width else pix[y * width]
                        pred = vp8l_predict(modes[(y >> bits) * tw + (x >> bits)], pix[i - 1], pix[i - width], tr,
                                            pix[i - width - 1])
                    res[i] = _vp8l_sub(pix[i], pred)
            pix = res
        elif t == "cross":
            bits = cross_bits
            tw = -(-width // (1 << bits))
            codes = rng.integers(0, 1 << 24, tw * -(-h // (1 << bits))).tolist()
            bw.put(1, 2)
            bw.put(bits - 2, 3)
            vp8l_entropy_image(bw, [0xFF000000 | c for c in codes], tw, rng, level0=False, copies=0.2)
            s8 = lambda v: v - 256 if v > 127 else v  # noqa: E731
            for i, p in enumerate(pix):
                c = codes[((i // width) >> bits) * tw + ((i % width) >> bits)]
                g2r, g2b, r2b = s8(c & 255), s8((c >> 8) & 255), s8((c >> 16) & 255)
                g, r = s8((p >> 8) & 255), (p >> 16) & 255
                new_r = (r - ((g2r * g) >> 5)) & 255
                new_b = ((p & 255) - ((g2b * g) >> 5) - ((r2b * s8(r)) >> 5)) & 255
                pix[i] = (p & 0xFF00FF00) | (new_r << 16) | new_b
        elif t == "subtract_green":
            bw.put(2, 2)
            pix = [(p & 0xFF00FF00) | ((((p >> 16) - (p >> 8)) & 255) << 16) | ((p - (p >> 8)) & 255) for p in pix]
        else:
            colours = [int(v) for v in palette]
            bw.put(3, 2)
            bw.put(len(colours) - 1, 8)
            deltas = [colours[0]] + [_vp8l_sub(colours[k], colours[k - 1]) for k in range(1, len(colours))]
            vp8l_entropy_image(bw, deltas, len(colours), rng, level0=False, copies=0.1)
            index = {c: k for k, c in enumerate(colours)}
            bits = 0 if len(colours) > 16 else 1 if len(colours) > 4 else 2 if len(colours) > 2 else 3
            per, depth = 1 << bits, 8 >> bits
            packed_w = -(-width // per)
            packed = []
            for y in range(h):
                row = [index[p] for p in pix[y * width : (y + 1) * width]]
                for x in range(0, width, per):
                    v = sum(k << (depth * j) for j, k in enumerate(row[x : x + per]))
                    packed.append(0xFF000000 | (v << 8))
            pix, width = packed, packed_w
    bw.put(0, 1)
    vp8l_entropy_image(bw, pix, width, rng, cache_bits=cache_bits, meta_bits=meta_bits, groups=groups, copies=copies)
    return bw.bytes()


class BoolWriter:
    """RFC 6386 section 7.3's boolean encoder, flushed as libvpx does (32 zeros at probability 128)."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom = (self.bottom + split) & 0xFFFFFFFF
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                i = len(self.out) - 1
                while self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v: int, nbits: int) -> None:
        for k in range(nbits - 1, -1, -1):
            self.put((v >> k) & 1, 128)

    def signed(self, v: int, nbits: int) -> None:
        self.value(abs(v), nbits)
        self.put(int(v < 0), 128)

    def flag_value(self, v: int, nbits: int) -> None:  # a flag, then the signed value if it is not 0
        self.put(int(v != 0), 128)
        if v:
            self.signed(v, nbits)

    def bytes(self) -> bytes:
        for _ in range(32):
            self.put(0, 128)
        return bytes(self.out)


VP8_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
VP8_CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
            (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
VP8_BMODE_BITS = {  # (probability index, bit) down libwebp's sub-block mode tree, modes in its order
    0: ((0, 0),), 1: ((0, 1), (1, 0)), 2: ((0, 1), (1, 1), (2, 0)),
    3: ((0, 1), (1, 1), (2, 1), (3, 0), (4, 0)), 4: ((0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 0)),
    5: ((0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 1)), 6: ((0, 1), (1, 1), (2, 1), (3, 1), (6, 0)),
    7: ((0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 0)), 8: ((0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 0)),
    9: ((0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 1)),
}


def vp8_put_large(bw: BoolWriter, p, v: int) -> None:
    """GetLargeValue's tree, written: a magnitude of 2 or more."""
    if v <= 4:
        bw.put(0, p[3])
        bw.put(int(v > 2), p[4])
        if v > 2:
            bw.put(v - 3, p[5])
    elif v <= 10:
        bw.put(1, p[3])
        bw.put(0, p[6])
        bw.put(int(v > 6), p[7])
        if v <= 6:
            bw.put(v - 5, 159)
        else:
            bw.put((v - 7) >> 1, 165)
            bw.put((v - 7) & 1, 145)
    else:
        bw.put(1, p[3])
        bw.put(1, p[6])
        cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
        bw.put(cat >> 1, p[8])
        bw.put(cat & 1, p[9 + (cat >> 1)])
        extra, tab = v - 3 - (8 << cat), VP8_CATS[cat]
        for k, prob in enumerate(tab):
            bw.put((extra >> (len(tab) - 1 - k)) & 1, prob)


def vp8_put_block(bw: BoolWriter, probs, ctx: int, levels, first: int, zero_tail: bool = False) -> int:
    """One block's tokens (levels in zigzag order) from position `first`; returns what the decoder's
    GetCoeffs returns.  `zero_tail`: zeros to the end in place of the end-of-block token."""
    last = max((n for n in range(first, 16) if levels[n]), default=-1)
    p, n = probs[first][ctx], first
    while n < 16:
        if n > last:
            if not zero_tail:
                bw.put(0, p[0])
                return n
            bw.put(1, p[0])
            while n < 16:
                bw.put(0, p[1])
                n += 1
                p = probs[n][0]
            return 16
        bw.put(1, p[0])
        while levels[n] == 0:
            bw.put(0, p[1])
            n += 1
            p = probs[n][0]
        bw.put(1, p[1])
        v = abs(levels[n])
        if v == 1:
            bw.put(0, p[2])
            p = probs[n + 1][1]
        else:
            bw.put(1, p[2])
            vp8_put_large(bw, p, v)
            p = probs[n + 1][2]
        bw.put(int(levels[n] < 0), 128)
        n += 1
    return 16


VP8_AC = (4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
          33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60,
          62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110,
          112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170,
          173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259,
          264, 269, 274, 279, 284)
VP8_DC = (4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25,
          26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50,
          51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76,
          77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110,
          112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157)


def _vp8_fdct(block: np.ndarray) -> np.ndarray:
    """A forward 4x4 DCT at VP8's scale (libwebp's FTransform) of residuals int [..., 4, 4]."""
    d = block.astype(np.int64)
    a0, a1 = d[..., 0] + d[..., 3], d[..., 1] + d[..., 2]
    a2, a3 = d[..., 1] - d[..., 2], d[..., 0] - d[..., 3]
    t = np.stack([(a0 + a1) * 8, (a2 * 2217 + a3 * 5352 + 1812) >> 9, (a0 - a1) * 8,
                  (a3 * 2217 - a2 * 5352 + 937) >> 9], axis=-1)  # [..., row, k]
    a0, a1 = t[..., 0, :] + t[..., 3, :], t[..., 1, :] + t[..., 2, :]
    a2, a3 = t[..., 1, :] - t[..., 2, :], t[..., 0, :] - t[..., 3, :]
    out = np.stack([(a0 + a1 + 7) >> 4, ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0), (a0 - a1 + 7) >> 4,
                    (a3 * 2217 - a2 * 5352 + 51000) >> 16], axis=-2)  # [..., k (row), column]
    return out.reshape(*out.shape[:-2], 16)


def _vp8_idct(c: np.ndarray) -> np.ndarray:  # RFC 6386 section 14.3, natural order int [..., 16] -> [..., 4, 4]
    c = c.astype(np.int64).reshape(*c.shape[:-1], 4, 4)

    def m1(a):
        return ((a * 20091) >> 16) + a

    def m2(a):
        return (a * 35468) >> 16

    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a, b, cc, d = i0 + i2, i0 - i2, m2(i1) - m1(i3), m1(i1) + m2(i3)
    t = np.stack([a + d, b + cc, b - cc, a - d], axis=-1)
    t0, t1, t2, t3 = t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :]
    a, b, cc, d = t0 + 4 + t2, t0 + 4 - t2, m2(t1) - m1(t3), m1(t1) + m2(t3)
    return np.stack([a + d, b + cc, b - cc, a - d], axis=-1) >> 3


def _vp8_wht(dc: np.ndarray) -> np.ndarray:  # forward WHT of 16 DC values (raster block order) -> Y2's 16
    x = dc.astype(np.int64).reshape(4, 4)
    a0, a1, a2, a3 = x[:, 0] + x[:, 2], x[:, 1] + x[:, 3], x[:, 1] - x[:, 3], x[:, 0] - x[:, 2]
    t = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], axis=1)
    a0, a1, a2, a3 = t[0] + t[2], t[1] + t[3], t[1] - t[3], t[0] - t[2]
    return (np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], axis=0) >> 1).reshape(16)


def _vp8_iwht(y2: np.ndarray) -> np.ndarray:
    x = y2.astype(np.int64).reshape(4, 4)
    a0, a1, a2, a3 = x[0] + x[3], x[1] + x[2], x[1] - x[2], x[0] - x[3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=0)
    dc = t[:, 0] + 3
    a0, a1, a2, a3 = dc + t[:, 3], t[:, 1] + t[:, 2], t[:, 1] - t[:, 2], dc - t[:, 3]
    return (np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=1) >> 3).reshape(16)


def vp8_bitstream(rng, width: int, height: int, image: np.ndarray = None, *, partitions: int = 0, segments: int = 0,
                  simple: int = 0, level: int = 20, sharpness: int = 0, lf_delta: bool = False, b_pred: float = 0.5,
                  skip: bool = True, updates: float = 0.0, q: int = 40, density: float = 0.3,
                  zero_tails: bool = False) -> bytes:
    """A VP8 key frame of width x height.  Without `image`: seeded syntax (each macroblock B_PRED with
    probability `b_pred`, random 16x16 / sub-block / chroma modes, blocks holding tokens with probability
    `density`, magnitudes of every category kept within VP8's coefficient range).  With `image` (uint8
    RGB [h, w, 3], turned to BT.601 studio-range YUV 4:2:0): every macroblock 16x16 DC with chroma DC,
    coded closed-loop.  Options: 2^partitions token partitions, `segments` (0 off, 1 map
    only, 2 map and absolute values, 3 delta values without a map), the filter (`simple`, `level`,
    `sharpness`, `lf_delta`), the skip flag, token probability updates at rate `updates`, base index `q`."""
    from uniir_tpu_torch.data.vp8 import BMODE_PROBS, COEFF_PROBS, COEFF_UPDATE_PROBS

    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    hdr = BoolWriter()
    hdr.put(int(rng.integers(0, 2)), 128)  # colour space: read, unused
    hdr.put(int(rng.integers(0, 2)), 128)  # clamping type: read, unused
    seg_q, seg_f, seg_probs, absolute = [0] * 4, [0] * 4, [255] * 3, True
    hdr.put(int(segments > 0), 128)
    if segments:
        update_map = segments in (1, 2)
        hdr.put(int(update_map), 128)
        hdr.put(int(segments >= 2), 128)
        if segments >= 2:
            absolute = segments == 2
            hdr.put(int(absolute), 128)
            seg_q = [int(rng.integers(0, 128)) if absolute else int(rng.integers(-20, 21)) for _ in range(4)]
            seg_f = [int(rng.integers(0, 64)) if absolute else int(rng.integers(-20, 21)) for _ in range(4)]
            for v in seg_q:
                hdr.flag_value(v, 7)
            for v in seg_f:
                hdr.flag_value(v, 6)
        if update_map:
            seg_probs = [int(rng.integers(1, 256)) if rng.random() < 0.8 else 255 for _ in range(3)]
            for v in seg_probs:
                hdr.put(int(v != 255), 128)
                if v != 255:
                    hdr.value(v, 8)
    else:
        update_map = False
    hdr.put(simple, 128)
    hdr.value(level, 6)
    hdr.value(sharpness, 3)
    hdr.put(int(lf_delta), 128)
    if lf_delta:
        hdr.put(1, 128)
        for _ in range(8):
            hdr.flag_value(int(rng.integers(-20, 21)) if rng.random() < 0.7 else 0, 6)
    hdr.value(partitions, 2)
    deltas = [int(rng.integers(-15, 16)) if rng.random() < 0.5 else 0 for _ in range(5)]
    if image is not None:
        deltas = [0] * 5
    hdr.value(q, 7)
    for v in deltas:
        hdr.flag_value(v, 4)

    def quant(s):
        qq = (seg_q[s] + (0 if absolute else q)) if segments >= 2 else q
        clip = lambda v, m: min(max(v, 0), m)  # noqa: E731
        return ((VP8_DC[clip(qq + deltas[0], 127)], VP8_AC[clip(qq, 127)]),
                (VP8_DC[clip(qq + deltas[1], 127)] * 2, max(VP8_AC[clip(qq + deltas[2], 127)] * 101581 >> 16, 8)),
                (VP8_DC[clip(qq + deltas[3], 117)], VP8_AC[clip(qq + deltas[4], 127)]))

    hdr.put(int(rng.integers(0, 2)), 128)  # refresh entropy probabilities
    probs = COEFF_PROBS.astype(np.int64).copy()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    up = rng.random() < updates
                    hdr.put(int(up), int(COEFF_UPDATE_PROBS[t, b, c, p]))
                    if up:
                        probs[t, b, c, p] = int(rng.integers(0, 256))
                        hdr.value(int(probs[t, b, c, p]), 8)
    bands = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
    P = [[[probs[t, bands[n], c].tolist() for c in range(3)] for n in range(17)] for t in range(4)]
    skip_prob = int(rng.integers(1, 256)) if skip else None
    hdr.put(int(skip), 128)
    if skip:
        hdr.value(skip_prob, 8)
    bmodes = BMODE_PROBS.tolist()
    parts = [BoolWriter() for _ in range(1 << partitions)]
    intra_t = [0] * (4 * mb_w)
    nz_y, nz_u, nz_v, nz_dc = [0] * (4 * mb_w), [0] * (2 * mb_w), [0] * (2 * mb_w), [0] * mb_w
    if image is not None:
        img = image.astype(np.float64)
        yuv = [16 + (65.738 * img[..., 0] + 129.057 * img[..., 1] + 25.064 * img[..., 2]) / 256,
               128 + (-37.945 * img[..., 0] - 74.494 * img[..., 1] + 112.439 * img[..., 2]) / 256,
               128 + (112.439 * img[..., 0] - 94.154 * img[..., 1] - 18.285 * img[..., 2]) / 256]
        pad = lambda a, hh, ww: np.pad(a, ((0, hh - a.shape[0]), (0, ww - a.shape[1])), mode="edge")  # noqa: E731
        src_y = pad(np.round(yuv[0]), 16 * mb_h, 16 * mb_w)
        sub = [np.pad(np.round(c), ((0, c.shape[0] & 1), (0, c.shape[1] & 1)), mode="edge") for c in yuv[1:]]
        sub = [(c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2] + 2) // 4 for c in sub]
        src_uv = [pad(c, 8 * mb_h, 8 * mb_w) for c in sub]
        rec_y = np.zeros((16 * mb_h, 16 * mb_w), np.int64)
        rec_uv = [np.zeros((8 * mb_h, 8 * mb_w), np.int64) for _ in range(2)]
    for mb_y in range(mb_h):
        tok = parts[mb_y & ((1 << partitions) - 1)]
        left_y, left_u, left_v, left_dc = [0] * 4, [0] * 2, [0] * 2, 0
        intra_l = [0] * 4
        for mb_x in range(mb_w):
            seg = int(rng.integers(0, 4)) if update_map else 0
            qy, qy2, quv = quant(seg)
            levels = [[0] * 16 for _ in range(25)]  # 16 Y, 4 U, 4 V, Y2 (zigzag order)
            if image is None:
                i4 = rng.random() < b_pred
                ymode = None if i4 else int(rng.integers(0, 4))
                sub_modes = [int(rng.integers(0, 10)) for _ in range(16)] if i4 else None
                uvmode = int(rng.integers(0, 4))
                for k in range(25):
                    if rng.random() >= density:
                        continue
                    dq = (qy if k < 16 else quv if k < 24 else qy2)
                    first = 1 if (k < 16 and not i4) else 0
                    for n in rng.choice(np.arange(first, 16), size=int(rng.integers(1, 17 - first)), replace=False):
                        top = max(1, 2047 // dq[int(n > 0)])
                        mag = int(min(top, rng.choice([1, 1, 1, 2, 3, 5, 8, 15, 30, 60, 200, 2000])))
                        levels[k][n] = mag if rng.random() < 0.5 else -mag
            else:
                i4, ymode, sub_modes, uvmode = False, 0, None, 0
                y0, x0 = 16 * mb_y, 16 * mb_x

                def dc_pred(rec, r0, c0, size):
                    sh = 4 if size == 8 else 5
                    top = rec[r0 - 1, c0 : c0 + size].sum() if r0 else None
                    lft = rec[r0 : r0 + size, c0 - 1].sum() if c0 else None
                    if top is not None and lft is not None:
                        return (top + lft + (1 << (sh - 1))) >> sh
                    if lft is not None:
                        return (lft + (1 << (sh - 2))) >> (sh - 1)
                    if top is not None:
                        return (top + (1 << (sh - 2))) >> (sh - 1)
                    return 128

                pred = dc_pred(rec_y, y0, x0, 16)
                res = (src_y[y0 : y0 + 16, x0 : x0 + 16] - pred).astype(np.int64)
                coef = _vp8_fdct(res.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 4, 4))  # [block, 16]
                y2 = _vp8_wht(coef[:, 0])
                y2_lv = np.round(y2 / np.array([qy2[0]] + [qy2[1]] * 15)).astype(np.int64)
                ac_lv = np.round(coef / qy[1]).astype(np.int64)
                ac_lv[:, 0] = 0
                dcs = _vp8_iwht(y2_lv * np.array([qy2[0]] + [qy2[1]] * 15))
                deq = ac_lv * qy[1]
                deq[:, 0] = dcs
                blocks = _vp8_idct(deq) + pred
                rec_y[y0 : y0 + 16, x0 : x0 + 16] = np.clip(blocks, 0, 255).reshape(4, 4, 4, 4).transpose(
                    0, 2, 1, 3).reshape(16, 16)
                for k in range(16):
                    levels[k] = [int(ac_lv[k, VP8_ZIGZAG[n]]) for n in range(16)]
                levels[24] = [int(y2_lv[VP8_ZIGZAG[n]]) for n in range(16)]
                for ch in range(2):
                    cy, cx = 8 * mb_y, 8 * mb_x
                    pred = dc_pred(rec_uv[ch], cy, cx, 8)
                    res = (src_uv[ch][cy : cy + 8, cx : cx + 8] - pred).astype(np.int64)
                    coef = _vp8_fdct(res.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3).reshape(4, 4, 4))
                    lv = np.round(coef / np.array([quv[0]] + [quv[1]] * 15)).astype(np.int64)
                    blocks = _vp8_idct(lv * np.array([quv[0]] + [quv[1]] * 15)) + pred
                    rec_uv[ch][cy : cy + 8, cx : cx + 8] = np.clip(blocks, 0, 255).reshape(2, 2, 4, 4).transpose(
                        0, 2, 1, 3).reshape(8, 8)
                    for k in range(4):
                        levels[16 + 4 * ch + k] = [int(lv[k, VP8_ZIGZAG[n]]) for n in range(16)]
            empty = not any(any(b) for b in levels)
            skipped = skip and (empty or rng.random() < 0.1) if image is None else skip and empty
            # modes, in partition 0
            if update_map:
                hdr.put(int(seg >= 2), seg_probs[0])
                hdr.put(seg & 1, seg_probs[2] if seg >= 2 else seg_probs[1])
            if skip:
                hdr.put(int(skipped), skip_prob)
            hdr.put(int(not i4), 145)
            if not i4:
                hdr.put(int(ymode in (1, 3)), 156)
                hdr.put(int(ymode in (1, 2)), 128 if ymode in (1, 3) else 163)
                intra_t[4 * mb_x : 4 * mb_x + 4] = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    for x in range(4):
                        m = sub_modes[4 * y + x]
                        p = bmodes[intra_t[4 * mb_x + x]][intra_l[y]]
                        for idx, bit in VP8_BMODE_BITS[m]:
                            hdr.put(bit, p[idx])
                        intra_t[4 * mb_x + x] = intra_l[y] = m
            hdr.put(int(uvmode != 0), 142)
            if uvmode:
                hdr.put(int(uvmode != 2), 114)
                if uvmode != 2:
                    hdr.put(int(uvmode == 1), 183)
            # tokens, in the row's partition
            if skipped:
                for k in range(4):
                    nz_y[4 * mb_x + k] = left_y[k] = 0
                for k in range(2):
                    nz_u[2 * mb_x + k] = nz_v[2 * mb_x + k] = left_u[k] = left_v[k] = 0
                if not i4:
                    nz_dc[mb_x] = left_dc = 0
                continue
            tail = zero_tails and rng.random() < 0.3
            if not i4:
                nz = vp8_put_block(tok, P[1], nz_dc[mb_x] + left_dc, levels[24], 0, tail)
                nz_dc[mb_x] = left_dc = int(nz > 0)
            first, yp = (0, P[3]) if i4 else (1, P[0])
            for y in range(4):
                for x in range(4):
                    nz = vp8_put_block(tok, yp, left_y[y] + nz_y[4 * mb_x + x], levels[4 * y + x], first, tail)
                    nz_y[4 * mb_x + x] = left_y[y] = int(nz > first)
            for ch, (top, lft) in enumerate(((nz_u, left_u), (nz_v, left_v))):
                for y in range(2):
                    for x in range(2):
                        nz = vp8_put_block(tok, P[2], lft[y] + top[2 * mb_x + x], levels[16 + 4 * ch + 2 * y + x], 0,
                                           tail)
                        top[2 * mb_x + x] = lft[y] = int(nz > 0)
    first_part = hdr.bytes()
    tokens = [w.bytes() for w in parts]
    tag = (int(rng.integers(0, 4)) << 1) | (1 << 4) | (len(first_part) << 5)
    scale = int(rng.integers(0, 4))
    out = tag.to_bytes(3, "little") + b"\x9d\x01\x2a" + (width | scale << 14).to_bytes(2, "little")
    out += (height | (3 - scale) << 14).to_bytes(2, "little") + first_part
    out += b"".join(len(t).to_bytes(3, "little") for t in tokens[:-1])
    return out + b"".join(tokens)


def riff_chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + len(payload).to_bytes(4, "little") + payload + (b"\0" if len(payload) & 1 else b"")


def riff_webp(chunks: bytes) -> bytes:
    return b"RIFF" + (4 + len(chunks)).to_bytes(4, "little") + b"WEBP" + chunks


def vp8x_chunk(flags: int, width: int, height: int) -> bytes:
    return riff_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (width - 1).to_bytes(3, "little")
                      + (height - 1).to_bytes(3, "little"))


def alph_chunk(alpha: np.ndarray, rng, method: int, filt: int, pre: int = 0, **vp8l) -> bytes:
    """An ALPH chunk of the plane uint8 [h, w]: filtered forward (0 none, 1 horizontal, 2 vertical,
    3 gradient), then raw (method 0) or as a headerless VP8L stream whose green is the filtered plane."""
    a = alpha.astype(np.int64)
    d = a.copy()
    if filt:
        d[0, 1:] = a[0, 1:] - a[0, :-1]
        if filt == 1:
            d[1:, 0] = a[1:, 0] - a[:-1, 0]
            d[1:, 1:] = a[1:, 1:] - a[1:, :-1]
        elif filt == 2:
            d[1:] = a[1:] - a[:-1]
        else:
            d[1:, 0] = a[1:, 0] - a[:-1, 0]
            grad = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
            d[1:, 1:] = a[1:, 1:] - grad
    d = (d & 255).astype(np.uint8)
    head = bytes([method | filt << 2 | pre << 4])
    if method == 0:
        return riff_chunk(b"ALPH", head + d.tobytes())
    argb = (np.uint32(0xFF000000) | (d.astype(np.uint32) << 8))
    if vp8l.get("transforms") == ("palette",):
        vp8l["palette"] = np.unique(argb)
    return riff_chunk(b"ALPH", head + vp8l_bitstream(argb, rng, header=False, **vp8l))


WEBP_CASE_FORMS = ("lossless", "lossless_palette", "lossless_cache_meta", "lossy", "lossy_bpred", "lossy_segments",
                   "lossy_simple_filter", "alpha_raw", "alpha_lossless", "animation", "extended")


def webp_argb(rng, w: int, h: int, colours: int = 0) -> np.ndarray:
    """Seeded ARGB content with repeats for LZ77 and the cache: rows drawn from a small set of colours (or
    from `colours` colours exactly), some rows copies of earlier ones."""
    pal = rng.integers(0, 1 << 32, max(colours, int(rng.integers(2, 40))), dtype=np.uint64).astype(np.uint32)
    if colours:
        pal = np.unique(pal)
        while len(pal) < colours:
            pal = np.unique(np.concatenate([pal, rng.integers(0, 1 << 32, colours, dtype=np.uint64).astype(np.uint32)]))
        pal = pal[:colours]
    idx = rng.integers(0, len(pal), (h, w))
    runs = rng.random((h, w)) < 0.6
    for x in range(1, w):
        idx[:, x] = np.where(runs[:, x], idx[:, x - 1], idx[:, x])
    for y in range(1, h):
        if rng.random() < 0.3:
            idx[y] = idx[int(rng.integers(0, y))]
    return pal[idx]


def webp_bytes(form: str, seed: int, w: int, h: int, image: np.ndarray = None) -> bytes:
    """A WebP file of one of WEBP_CASE_FORMS, seeded: `lossless` (VP8L, a random subset and order of the
    predictor, cross-colour and subtract-green transforms, copies), `lossless_palette` (colour indexing at
    2 / 4 / 16 / 256 colours or any count, plus other transforms), `lossless_cache_meta` (a 1-11 bit cache,
    meta-Huffman groups); `lossy` (VP8: 1-8 partitions, skips, probability updates, any filter),
    `lossy_bpred` (B_PRED-heavy, zero tails), `lossy_segments` (segment maps and values),
    `lossy_simple_filter`; `alpha_raw` / `alpha_lossless` (VP8X, an ALPH chunk raw or VP8L-coded, each
    filter, beside a VP8 frame); `animation` (VP8X, ANIM and two ANMF frames, the first offset, lossy or
    lossless, a background colour and blend / dispose bits); `extended` (VP8X with ICCP / EXIF / XMP and an
    unknown chunk around a still VP8L or VP8 image).  With `image` (uint8 [h, w, 3] or [h, w, 4]) the
    lossless forms code its pixels exactly and the lossy ones code it closed-loop."""
    rng = np.random.default_rng(seed)
    if image is not None:
        h, w = image.shape[:2]

    def argb_of(colours=0):
        if image is None:
            return webp_argb(rng, w, h, colours)
        a = image[..., 3] if image.shape[2] == 4 else np.full((h, w), 255, np.uint8)
        px = image[..., :3].astype(np.uint32)
        return (a.astype(np.uint32) << 24) | (px[..., 0] << 16) | (px[..., 1] << 8) | px[..., 2]

    def lossless(kind: str) -> bytes:
        kw = {"copies": float(rng.uniform(0, 0.6))}
        transforms = [t for t in ("predictor", "cross", "subtract_green") if rng.random() < 0.6]
        rng.shuffle(transforms)
        if kind == "lossless_palette":
            colours = int(rng.choice([2, 4, 16, 256, int(rng.integers(1, 257))]))
            argb = argb_of(colours) if image is None else argb_of()
            kw["palette"] = np.unique(argb)
            if len(kw["palette"]) > 256:
                kw.pop("palette")
            else:
                transforms = ["palette"] + transforms[: int(rng.integers(0, 2))]
        else:
            argb = argb_of()
        if kind == "lossless_cache_meta" or rng.random() < 0.3:
            kw.update(cache_bits=int(rng.integers(1, 12)), meta_bits=int(rng.integers(2, 10)),
                      groups=int(rng.integers(1, 6)))
        return vp8l_bitstream(argb, rng, transforms=tuple(transforms), predictor_bits=int(rng.integers(2, 10)),
                              cross_bits=int(rng.integers(2, 10)), alpha_hint=bool(rng.integers(0, 2)), **kw)

    def lossy(kind: str, fw: int = None, fh: int = None, img=None) -> bytes:
        kw = dict(partitions=int(rng.integers(0, 4)), skip=bool(rng.integers(0, 2)), q=int(rng.integers(0, 128)),
                  level=int(rng.integers(0, 64)), sharpness=int(rng.integers(0, 8)), simple=int(rng.integers(0, 2)),
                  lf_delta=bool(rng.integers(0, 2)), updates=float(rng.choice([0, 0.02, 0.2])),
                  density=float(rng.uniform(0.05, 0.6)), b_pred=float(rng.uniform(0, 1)))
        if kind == "lossy_bpred":
            kw.update(b_pred=0.9, zero_tails=True)
        elif kind == "lossy_segments":
            kw["segments"] = int(rng.integers(1, 4))
        elif kind == "lossy_simple_filter":
            kw.update(simple=1, level=int(rng.integers(1, 64)))
        if img is not None:
            kw.update(q=int(rng.integers(10, 40)), b_pred=0.0)
        return vp8_bitstream(rng, fw or w, fh or h, img, **kw)

    if form.startswith("lossless"):
        return riff_webp(riff_chunk(b"VP8L", lossless(form)))
    if form.startswith("lossy"):
        return riff_webp(riff_chunk(b"VP8 ", lossy(form, img=None if image is None else image[..., :3])))
    if form in ("alpha_raw", "alpha_lossless"):
        alpha = (argb_of() >> 24).astype(np.uint8) if image is None or image.shape[2] == 4 else \
            rng.integers(0, 256, (h, w), dtype=np.uint8)
        filt = int(rng.integers(0, 4))
        if form == "alpha_raw":
            alph = alph_chunk(alpha, rng, 0, filt, int(rng.integers(0, 2)))
        else:
            transforms = ("palette",) if rng.random() < 0.5 else tuple(
                t for t in ("predictor", "subtract_green") if rng.random() < 0.5)
            alph = alph_chunk(alpha, rng, 1, filt, int(rng.integers(0, 2)), transforms=transforms,
                              cache_bits=0 if "palette" in transforms else int(rng.choice([0, 3])),
                              copies=float(rng.uniform(0, 0.5)))
        frame = riff_chunk(b"VP8 ", lossy("lossy", img=None if image is None else image[..., :3]))
        return riff_webp(vp8x_chunk(0x10, w, h) + alph + frame)
    if form == "animation":
        fw, fh = max(1, w - int(rng.integers(0, 9))), max(1, h - int(rng.integers(0, 9)))
        x, y = 2 * int(rng.integers(0, (w - fw) // 2 + 1)), 2 * int(rng.integers(0, (h - fh) // 2 + 1))
        frames = []
        for k, (ox, oy, ww, hh) in enumerate(((x, y, fw, fh), (0, 0, w, h))):
            if rng.random() < 0.5:
                frames.append(riff_chunk(b"VP8L", vp8l_bitstream(webp_argb(rng, ww, hh), rng, copies=0.3)))
            else:
                frames.append(riff_chunk(b"VP8 ", lossy("lossy", ww, hh)))
            head = (ox // 2).to_bytes(3, "little") + (oy // 2).to_bytes(3, "little")
            head += (ww - 1).to_bytes(3, "little") + (hh - 1).to_bytes(3, "little")
            head += int(rng.integers(0, 1000)).to_bytes(3, "little") + bytes([int(rng.integers(0, 4))])
            frames[-1] = riff_chunk(b"ANMF", head + frames[-1])
        anim = riff_chunk(b"ANIM", int(rng.integers(0, 1 << 32)).to_bytes(4, "little") + b"\0\0")
        return riff_webp(vp8x_chunk(0x02 | (0x10 if rng.random() < 0.5 else 0), w, h) + anim + b"".join(frames))
    if form == "extended":
        still = riff_chunk(b"VP8L", lossless("lossless")) if rng.random() < 0.5 else riff_chunk(b"VP8 ", lossy("lossy"))
        extra = [riff_chunk(b"ICCP", rng.integers(0, 256, 37, dtype=np.uint8).tobytes()),
                 riff_chunk(b"EXIF", b"Exif\0\0" + rng.integers(0, 256, 20, dtype=np.uint8).tobytes())]
        tail = [riff_chunk(b"XMP ", b"<x:xmpmeta/>"), riff_chunk(b"ABCD", b"odd")]
        return riff_webp(vp8x_chunk(0x20 | 0x08 | 0x04, w, h) + b"".join(extra) + still + b"".join(tail))
    raise ValueError(f"unknown WebP form {form}")


# Pillow-made progressive JPEG files of `fixture_image(P12_SEED + 9000 + k)` (base64), with the sha256 of
# Pillow's RGB pixels of each and their width and height: the card's machine has no Pillow, so its
# decoders are held to these digests (Pillow 12.1.0, libjpeg-turbo; `save(..., progressive=True)`)
PROGRESSIVE_FILES = {
    "progressive_420_q75": (
        ("/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5"
         "PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjL/wgAR"
         "CAEAAZMDASIAAhEBAxEB/8QAGQAAAwEBAQAAAAAAAAAAAAAAAQIDAAQF/8QAGgEAAwEBAQEAAAAAAAAAAAAAAgMEAQAFBv/aAAwDAQACEAMQ"
         "AAAB5V7lYnhXuXS4V710uBe8aXnjvBlwjuV28W7Q0uLdedvHS7nydAtKB6J1kXXo56yL6qczyhYxxMtolja6WY2ulmNaeQxE2TVLN1JMkrMl"
         "K+YUZwy0Fgy52ZWUg44VSHZqvpeIdoWfCO4AXAO8LPgX0FE+AdwMuAdymXCO1SLjPTiKL0K1q+ZYF5la7NBgC2iSG2iT62kTyukWYyheArhi"
         "gpGLVXXFAk8vNmJeYNoFgxL2O0PQ18X0nPugTnz7o05826dOzlXrVJ8idicfIvWnHyr1Lx8g6V4ucWQgmHUwUZTWQgMKmRJNTJiTQzJIplOp"
         "OGxeBALwYLABsCwSSENmo7HF+ZgX8dszu7coz6Dq3JkF1jkyD6xyBB9g48k+oc2w+hY7GVExjHUDiy5WAFKsAIysWoONZbNi8xcEqzuKptVw"
         "VzjoHKgLrq46o1cs4JSkk+UkuYDi08QXMOGMojmUrercqrLrHIFF1jkCy6zxMB9h5GxnUedsZcxbGVC7DK5TWVwMACrFjYkD0SqQNRWcRQ1n"
         "FXpRAcy9KkvnW6UJitloVFao9KZs0lzbaBtiftsVG22t8YENnUMB1VoB2Ypg2TlsLOGw2pNsZV4tzL6J4qie0XCjQYDEOIPDasaT50V56S51"
         "V5aS52U5KTZZJK1boiVpdFStTIEsS2TMNguypsmypsoytsux3l5y7z01CvJazBkN0EM5t0qPQ1QXTzIW4op7Qw27cwZZ20mUdMjKJirLOjxb"
         "F2fnbl9L8jcrsfhPL7ByZgdK84cHQsQ4LLMOGmniOmnsfTT2UPk2PbLubzsWJYZnWCNR1hJrOoOefbLA459UWjzztFoTm0GidAl3Q/O8z7tF"
         "5KatN5KHZWmfsqvVTSWua+51qm6tyLXP2niYg69ynt6tznN6NE9thPcddPYyhnuZTTPMfJuPUg842pzsAdD8zCHU/IwD1xmnAYmZgkbTYHPH"
         "qQw490Esi9XlfKjvJQju0tKmhmfFegUq5l6tdPxjsFyOIdwtn4j1A+5jZcNMy4RKKJ2MHzamZHaFHHSc2cM2zedpHy56mJLrNzku6DzY86hz"
         "7esJkBZSRyYthGG6CPQa5XsmqVlNnZZIXYCnqs7oG7U5zHpanOTdhp7z598WlxT64GXPO0DNJmJnV+amd0PCql1edFLd1okDnwB5eXePOcge"
         "dAgcVBMOKr89DK7xqjKOtEcz6s+KasnomuJczTECFsS1Ykhzl2GrtRrkajsbM3ZjuDm9DlefBzd3K9nHzdfLQfLz9HK8zWFcG9Y1nntWVZkV"
         "tG06Hxyl+RjowXMTcgpifMVxulRn4hTUWrUDrS1FcE0KlaiANJso03CbicyxF0Pzswul+V2b1NzM3etuUtJoNFpz57xa3n5+uTXcMPQi1vG/"
         "Qe6Tuy1LQFa3pLKVfSwBynGfztmK61LldSF2XVNnYWI7MUQYsUOdW2JxsUwGUKcAo2MFULG0wNV2gzQu3Ozk9DczPV0tys5NkQGbTbbRNLbX"
         "8yde2jjHWhHzC6b0g6FwypvU0dvUabxfOOyvPWWDz2By89aM7LOZoW+fNnZ3nTNC3zkFlZJBbIu+K1RfozSiL9FAVC9ipalihfJQzL46GefJ"
         "ZpNx0ebDS7KwUswcapyvEnRlaTWRlaTjjKsmsTDMK1IV8r5utJVUdHWqSNBVRhnYOm1CU02oSnm1GKaS9Ckvln0z6vnneeWQSs+tkjp1WILE"
         "YjNjbLmRsUzZLNJxKryddNHmyqaPN10aVJY+cqTN0pVkbZStI3T2xGK891+TesbAi1pXFD1W4Jzuwqm1GHZtRs2bUbNkvTPi5JdUTfzS6JG/"
         "nj0RY6E6yY7bYptgDjbLijOXFJV5OBVeTooq8qJoo8qIp0qTB85Vlz5zpPnynWfPnjub/8QAHhABAQEBAAMBAQEBAAAAAAAAABEBEhAgMEAC"
         "IVD/2gAIAQEAAQUC5cuXLly5cuXLly5cuXLlmMxmMYxjFVVVfy8uXLly5cuXLly5cuXLlyzGYjGM8Zqqq+L4v4+XLly5cuXLly5cuXLly5RE"
         "9aqqq+b+Ply5cuXLly5cuXLly5cuURPWqqqqqv4+XLly5cuXLly5cuXLly5RE9qqqv6Kr/H+P88/4/z/AJPTp06dOnTp06VVVV+8RERERPrX"
         "Tp06dOnTp06VVX8MRERE8T6dOnTp06dOnTp0qqq/eIiIiJ9unTp06dOnTp0qqq/XPGMxERETxPrVVVVVVVVVX54xjGMYz80RERET2qr8s1mq"
         "6Z/Tp06dKqr4vziIiIiJ7VVX41VV06dOnSqqqvziIiIiJ61VX5VVdOnTp0qqqr9YiI5contVVV+FVXTp06dOlVVVfnERERy3G41rWtbqqvxq"
         "qrp06dKqqqr9Kqqqt1uta1rcbiIiIiJ4iIjly5cuUT2q/KqqqqqvrERERETzERHLly5conrV+dVVVVVfSIiIiIiIiIiOXLly5RPG+l+dVVVV"
         "VfWIiIiIiIiIjly5ct/luNxuNa1ur86qqqqvtERERERPEREcuXLlv8txuNa1rWb4xjGMZ88Z4zxn5P6a/p/T+m4/rH9YzGYxjGMYvvPE859q"
         "qqqqqt1rWtbjcb/LlE9r8Iifgqqqqqq3Wta1uNxv8uUT1vwiIn4Kqqqqqr6xHLlE9r8J+Kqqqqqq+sRy5RPa/GIn46qqq+0RuNxvjW+N+cRE"
         "RERE/RrfGta1vyniIiIiIn6ta1rW+c8Z4xniIiIiIiIjfG/l3xvnfOMYxjGM8RERERG43G41vjW/i344xjGMYxETxEREbjcbjWta39f/xAAd"
         "EQEBAQADAQEBAQAAAAAAAAAAAQIDERIQEyEg/9oACAEDAQE/AXTp06dPLy8rlcrl5SImk5F5F5F2u2ttaarTpIkSJEjp5TLyuVyuXl189P0X"
         "kXkXkXa7XSq6RERIkSJHSxYuVy1Gmququ6uqul09fenn5K7SpUqVK7WrVq1VixcrlcrlYmUwnGnE/H727SpUqX5Vq1b86dPK5XK5WM5Zwzxs"
         "8T8XTp18iVKmnpb86eXl19qrFyxliMRiR/Hl5dfe3b09pfkjwuVirXfyx5ZyzGWa7XK5dLPnbt6TbNZZiY/jWWo01Xfzp5TKRErteRdvS6Wq"
         "qozWds8qc38a5WttVp06SOnXzt6e36Pb09O/89vb9X7P1e3fyR0kSLFWrp7e3p2/v+e1q6XVe6m6mqlRESJGo012127rLMTKYXCxV2/RNOnh"
         "+T83n52mkqIsXK8a8T8WGIxljDeHJHI5Npyf1jTDGE4v4vGuVWs6ZrLLp5eH5PxYwxGGNRybjlrlcsqYvbiy4suKM9dN9Nt1qs1ms1mpURI6"
         "icaRKnI1ytaaawnF/WMMZYS/xut1ut1ms1nTOkqVKnzXG1Gq1yP1evnhOJnDOWXf8brdbrVZrNZrOmazWaz8/8QAHxEAAwADAQEBAQEBAAAA"
         "AAAAAAECAxESExAhBBQg/9oACAECAQE/ATZ2egsosws4v6B/0fhecvKXQ3+iYmJio6Ozs9B5B0MaORjY7HkPU9hZxf0H+geceQdGxMTExUdH"
         "Z6Hoeh180clFFNlUztnoz0Z6s9WLIxWzbF92dDodDpjtk0yWSSjRSKkqCsZ5nmeZ5nmLGLGLGcHPxs6N/OTzFjFApEvjQ5HA8Z5nmeZ5nmLG"
         "LGKDgqSimOiWSTJOM8zg5/70aOTk4NfNodItloqWVjZGNkQRBEmjRo0aGMY/ujk5GNjseQ62aPM8BYRYhQJfdGjQxjGIQkJDn8LLZdjyfpFE"
         "IjGTgPE8jg190aNDyHQ2MQmKxZB5S8hdFmv0xmMx0RZ2b+aNfNnR0eh0b+7Oz0HlHkHQzklEk0TYqExCQ0MbGzommTRLJGUyqKtnbOmb+JCE"
         "JiomiWSSUUUUbFBoR0OxsY0cHJr6hCEhCYqFY7Gxjk4HA0MdHZv5o4OTXzYiSRL5s6Ozo385OCiiihCEI2MY0ckolEi+bNnQrFYrFaO0NjGN"
         "HP3Z0b+aORSJCQhjY2OhWLILILKeo39aOTXzZ0JiEhSKTRr5RTKZVHZ2eh6nsf/EABQQAQAAAAAAAAAAAAAAAAAAAKD/2gAIAQEABj8CTB//"
         "xAAfEAEBAQEBAQADAQEBAAAAAAABABEQIDAhMUBxYYH/2gAIAQEAAT8hehjGtfr8GAhypewNttlllmZmSIg6R8RX6/wQg6D6A3jeNllmZmZg"
         "siIj4g/x9PoFKQIiGPQG28bLbb1meZHgj5B/+Z5vN5PA7M7vyAG22+nmdI+wPta1jWPhM7tvoG22222+w8njS0sWLZs2aWksWOSk5OTl+JyZ"
         "mZmeEb3LGxssbGyyyyyyz+QAL55ssszMzMRZZBEPgwZZzLP54EZtttsvliIgggiEOx4ZxlnM/oABjbbbfLEEEEEQhxa8GZJZZZ/IAk5nDbbb"
         "bfREIIcCE/WYxiTEks+nvndq3btwoUQhCDDbbbb8QBAgQIDJCQkJJJmfhvcs9H/foHCGGOjbbbekMPQKcH6zGMa1rN422222222yz5D7LObl"
         "vkNtt6QwxCFKQ8xa8HhttttttttlnxL2J3Zj0bbD63g+qDzbbbbbbbbbLIIhwKcGsSSZZZhCEJsMRzbf4CZhtttttttsEEQhCFL+ljwHRS4k"
         "IQYYYYm23hj9dOG2222222wwwxCFKV7BcCHRKUpSEITJ4tfhFZ3bem+9tiEIcS/rNYszJMaUpSnAgWfQzSWc3oNtsMRHNt+I8zZs8Ep444Hy"
         "DNjWJCZZYgwwxERZbb8j5vc6nrQ6Dw5Dh+vkQPC4EGGGIiObb8B5RhiIIh8fgEQhSkIX9fFxjy58BlLwBZ6x5+YGEIhBwEF+OfjzsMMMJCQk"
         "JCWmSPEHYSWSEOilf47lllnGRAghBBER3ebbbbEIQhClL+vJ9R4uIUgQREPjllllnBCBBBERHdttttt4IcCFKd1dB7EWeW/97lllngECCCII"
         "jxttttvBDgUpS/rwszJMa+CzxvhkFllnAWWQWcPLLLLbb0PgFb3PCY1iSTMvBwssssg8DLLLLOszxlltttt9AJsRBZExBBCSHCythiIiIILP"
         "iAMYkkkzPx2GIjhEdH2AYiIggg4z4AGMSSSZn3ttsMQwxERM/AAeDg4EEeAOB0MYwScM+9tthhhiIiJ4eGeG/wDJeQEIQdDoOB4ACEkPk2GG"
         "GIiI4ZmZmeLyAhCOgIhwPIAIQ+RtsMMRDERMzMzM8//aAAwDAQACAAMAAAAQy2yLRVCqTrjjXkJDPF+p0hkVOB4Ch1WohvMPq/6beSZ85NFV"
         "5+SPpltguU1JpPKDQ04FTg1WbT4Rt+gpRcOvTG7BgRLEv967WqtDw74zWkPd8sw0+XOlctj+RbPIHoyd58COUKs7jC9BH50SWXRJ/mMibJk9"
         "0O6BOLHttseb6L672q+dU4mO/wARjjAnMARSoUMcbJB1K31llFpzf6Y9XjPvOgGbxFlu5Iy9NZqV6sfLWqhRLwt3NQTWHqq7CJRzjmMdsa/E"
         "EsPdC1rQDZIaFUlfnLFFc6vL+QnP+vtD3QGhQCkRJdWJlmcJsr1owwsEb2L/AEL/AD74oVYLeMe8uCKDKjr+o2AGybFx8BVDl3y0+x99KsTp"
         "glkLK4Lodoga+WAm/HCv2BQeJwhzzpl8KTUjFD+AHJKTXr3C/8QAHREAAwEBAQADAQAAAAAAAAAAAAERECEgMDFRcf/aAAgBAwEBPxBIQQQR"
         "RQQfPhX7kh4TIL4O8Dr2AFFYHz4VZ4LDgceWmhQY6wgggiECBAkawSJECCBwN8YJo0orIy2V+CeC9AA+nkA7+C9joUxqfwJiYgvIAb4N4AY6"
         "GX69ZQoXP4E4mKF4CjNRsbMbFYg4SKvFCROCfjxWsQWaFRdKn0IkjkkMMoMQ9go8jGGWexc7LlBMkc4dCOsQ92i9gw2PsTJEj9RQqVEogsqP"
         "AnBSck+WYbGxkFIoFAj0djslxW1gNMYn9iZiYTiY6dKVDTFmLv4spEQiEaCMYNh6KZXJkx4SPsUFQrEVIpEoKdp83L5Ww1KFCpFERoQwWFpf"
         "NMmLCegwh2dnZ1h6JjpChAJZ0NZLcECYjrDv4/WIGRAjKBEgQKFhaWyTJCwh4d9fg+vnyJEgQOhWJUVHYiQEnk/7/B/IMU//xAAeEQADAQEB"
         "AQEBAQEAAAAAAAAAAREQISBBMWFRcf/aAAgBAgEBPxBOCnCnOZ/cl9P9xT6UKlvIEQQRRoWHpTDQiQIiKP8AUh9Hz+lCpUdP2CTDKoVidFWa"
         "GerPxvo2xgTihUTEVhbqDAxlMptpoMsssrrwAuRwNQgORWLoqFW1IkQrvWHmyyvAF8khISJsqdFCgoFAglMaGkNIaRBBA1IEqFEIIBDKDw28"
         "zVggajQYYrRhhMXRBBwhYSJHxw6Ojr4T+EiRMaJ6Cww3jcgkIEMVChQt8OTg4OCE0goOyp0JCBAic/0oUOhkkGhA5Dodj6OhyNDgcZVCKsXR"
         "qDgcDnGhQ6P0SHhLxL0UJC5T2GYMh1MGYHQTBMxdECjjBwzBkQKsuOyiAoGgpwqdFRhYSCY+VyWeKqFhKVzAgNCIqFYuisYYcD4fofCZJCgU"
         "HArFQlRXmcKKxHRWOOiIQJjVG4IKNjDLzKF+dVc0EhCy6JTsXfm4/i+HgX/vBjWLDgY4F0UEpXURQQ3gTjz3/8QAJxAAAgICAwEAAQMFAQAA"
         "AAAAAAERITFhEEFRcZGBobEgweHw8dH/2gAIAQEAAT8QkHoOppJcI0DPDQPWR1wMU6Pk8wPUnlLhC+OJJEaRFA0ERjFsYmKZ+B9CaWfcF/o6"
         "yycRBMx9j0fYk9/oamJQj4EoYlS8EKCVFDrseg9R6D1oeh6UPQepbodcD0HofJ8GWBxcQQ9H+qIorhTA0Y4oIfD6PU/5EHuzQxPodcm0kyPQ"
         "0/Rs+mWhFNCHgJpEEoQTX6CErPg+jSHUd8D1HN4GTkObpD1lj0HoPvA6YH5Q9ZHpw1jl1RE8M6hYZkyL+CBf5N2L445Ctmj74/oMeF+h7Dbj"
         "I/vBO4EEhI0IqEhKr7EqgQQrtM+CyiD5J+DpgeljecDScUMIeh2dGShw6RoG3hpHJmkUehUE6IE6KCQsL/bPU8itkQXC6xI6DdjfvDhjiRNC"
         "VqRBKRIS5EgS+iXopjB8De6LvED1LrB8FujVD1G2IIOjQZKLbRoGro0DjixquhoUsayfoMOKmTwLBCpmhbcFVCvvj98X5ZMjdjfDQ1djP0Qk"
         "JCEYCVC8/gg1mslqDSXYs1D8jWPzPAMdDXj8FmES9DN0aBrKBPBDwVcGRD0Yd+ib7JFHbEn6xJ+iaRbBO7Jkw+olGaRIlVkoR04KwlUdiUih"
         "SJe/kSvAjvjEytn0fZH0v2R9PtG7GHubWPsOUjyH+Qx4CJG/4NJ8FhryfwEEcCl0Jf6EVoKi49x6jgdB6nbJCF9CCSXdCR3oikIVCWz7HQ+x"
         "l7D2PvhnbPs+hm2Hx+if5LUOjGJBtjY6QyxYRwJXD2snFzjjowOuB/rLbQ9B1fg4DuPwQLpAkJCyY4T84Yzpnri9iMZJrse5nkW4vDgRVhLO"
         "S3Yhh2MPax/kNyNjsZoLY6Ez8xXxzdEcrjTRaPwGkdmU4H1g0jYdCnRHRH+oSi4OouDw/Iv2KfY9j7HbNj6S5HnY6ZH1kewrxIgrknYp8K/4"
         "EVUdJkfSWMN3Y2N1Ix+C2L+xoXOtfHeLJBpNPBCWH4OB0II/yR4RZC46okUtDbZJD2DbwbOmPygaH3Y5cMTHhnWT4z6pjfGMMXDgsiNB0Gg2"
         "N+Z474fwEXYi/QqWehMoWULQxZoiTKO60ewQ+0IEX6CrqBV1HFeldELs7gcE2jKGTsg8mOxlq3SHCmi3RlgXchRvIomkXWP0KFB4tG0mfXHO"
         "x4FiSZMzcRkBRkuVkXZsFZZtNhJ3JsEYNlGwe5TY70VQw2GXPHBUKSVR6EL5Pij/AFReyvRThiaIngqueDwxUMzEQTqjuChuIXngjNh3ybSj"
         "I5rI/Q9h7ci68DtkiXFnz2GLefjglsXhfsL8uC1yLQWFQPUY0lOIGogdJtdjtwQvIl7wLcU0Kb0SidCciYszFCaF5FBlIthWyLumeZFdWXWR"
         "3yYjkOA7ZIMfH9cb9nkznBsO+WIKLLTQNnAr0hErZgobRg1Dl1xxMoRdlZnNpissyYBYSInIyk0yTFi+DE8H2WIGeT6FhZ9CkeBaky/ZofVc"
         "V35kvplwmulymjgk6OmDBxuGBAIGT6FyOVEaLM5LR3BOXZLiCBu0MOEjiPg7BvkfZORweUKYoxdi3EVsJWIqnDPPPnJmWss8kPSwh7ITZKIT"
         "YbjaJjJeTNoyWNkzdE6Jpo0mkrRoNBbji0cTqSND7QeCLdaHoPWB94HZUKsQJ0yvRVkNNUKrwUf0qLcwFPMidbExT+nCRGmJvRVKN8Gw2ihk"
         "hocxJ2WOyax5FsnkW2yTqxrwoNJo4KU2KvBj/wDCZnZ5gek/B/mZYHqdpQ+8D1HEZhHAf8jgOwpLhQWAyhpEYhH+yKL2RFbIodoRUE7F6Yq5"
         "Zjkc0Sd2ORJ1kaf8HLoc+vwPU03wKmBQ6F5NImSGeFmz0LMzPk+C/X7C0HTEnfBH0VuiM0GJEV3zO0mHns+TAQSxhfqjD/JXuDIyyUtQILYX"
         "tin2Tf8AYSeilRmhI+S9QKdwSdCWMCv0KHQvKFrwLSxacK0sWDQuJpEXZRH0Xvji4KtkU3f9Fc7RUh5Lii/gSrAxTswiTLJUfA9xXcZJMPhk"
         "guJSNZL8JehdhY1Z8GWCvQtRFQ64ZeCgS+jATukWYHY2pM9EKI5lF5BximOGTsn/AOmE8BpaG/ctHAmjP7j66HPo1shxkafpAnY09jXoYeRn"
         "rGSLIyrIvBISFMUR4El5wq6JXaJXhKqhp+BHgrQrw8CFPBTo8RGwOWkkWFCHQmakRWhloc5sZL8GpsQKGRo6hJjh2YQhQJEuw1ZFWfHD5LLB"
         "+AzIzzI/6Gl0VOkHRLH6JvJhng7/ANENyKRNXLMFmwsiR+pP2Sj2JknmUZMkk0iSSIWuiPohWvS5UVHhT2RxZJV/ciiFw/YZlTEsWaKLKUZz"
         "DQsITB1KDZI2sy0O8sx4TF04IBbWQ9iMEHfA6EhkGkQlEufDQNYtRR6FHikIThChxJESjsW4orQ9QK3Z+Aog0knQhgkojoMbn4NjsPsOhnkZ"
         "VlZJZtoUeDZ+vBD2brHOyfA04Fl0UP8A9474JaaHB4HEcevo4pDUDobgzGs5f5ErEpFpwKLgRRQbVMUUJY2dsCss0JCOUKkKUN9DY3Dkst/s"
         "OL/uOvwUGIbBFbi3EFuI6sv3ZLfZkufJ2cD0IFSIej8HDkoQaB6I+v8APBKhJEEggu/CgggtRP4Kwm8ExDXQ02yV+Ek24Gf6jbJecDBMK4nE"
         "4mQmE4nmxFliDCJiOvyJG8iH/kWYSLQkV/QLJQ2nBN2MXybmC8FJeFTFQUBaCGMMRWhc1lBbZGbRPBIQh2dfxxN8J9SJ2SLoSDVbGGoT2hqG"
         "gaH4M7GO5k/eCVHBKGrtkhmYHVoXpH5uLFAsPRFaCqKUCCj/AAL2hL4XCsH4yMzMUVQTgixH5E5gmRPYofD9wvwJBt8g35GwNI7Z36HyZFkx"
         "MsUSj6Gry1xNzKIaCtFAugrcIMoVDSLUUVxajyXBMJmuK9lEkw8kiZPvBdhWICjiwuhhhhhxq3x/MnGDyfB38GnNISQNXCQhAirjrmKFa0xa"
         "FmBBdCgT/glWKLSw9OGiCLgT8DsZJInJNDdidGRI8DuigYfAww8DQj+ZiXoWeK2e+uJh8UORcC/kmgq9K8FSoTCaMcrhEEfoKpoKHRAUuirB"
         "A2IrFofg/CSfME9Ek8IEjLB0MbB6HGH8d8XtsfiuBaYv6jTl/wDp/9k="),
        "6d253eed83deefb05676a2d7a48baaa3fb73ec4b64f5be83dae0e805fb5d0488", 403, 256),
    "progressive_444_q75_restart5": (
        ("/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5"
         "PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjL/wgAR"
         "CAFFAQADAREAAhEBAxEB/8QAGgAAAwEBAQEAAAAAAAAAAAAAAgMEAQUABv/EABoBAAMBAQEBAAAAAAAAAAAAAAECAwQABQb/3QAEAAX/2gAM"
         "AwEAAhADEAAAAekPBVcJtyrhNh//0Ee5887KzsbPxs7G3//R7HheP6vDpAaeHSP/0rtviLaypbUy2qlt/9OOXvgmhjxY+djw/9QqazeCSJz0"
         "zd//1eLredu+vweOmwVVf//WDd4ybKDh+Yvyn//Xqj41GYvzHz8Fj//Q6mfyQvw3K2qlNf8A/9HGslNSV1gt2mX/0lJ67mg4xY0knv/TCtZW"
         "aZjOT9Ni8r//1CbCqqpoiqqDL//Vm1+RRn6nOac/UQ7/1uz5vlDQjVgoRo3/16zlT2hI0oGhI0//0Ocnuu6dHSf0qBL/0elOqGMztKzTO/8A"
         "/9LiaN/dyeap0TRFOn//0+XrwCUpkKpdTEf/1Ohl8qqPeJFnBm//1enmxizKNUNZBt//1pl3IawdSlZ0qn//16I7aVm8Ilmkd//QAbpXpJR+"
         "rlwqef8A/9GEhTzS0xM6kX//0k959c1rQVTXVb//0+ziwB1B6giimf8A/9R2ak9KIeiHotn/AP/Vl70KprXNK0Sma//W7GPTI9ZK0keslKf/"
         "15pegppKMlNNJl//0Pn2hWEsVLFWxU//0e1DyyRwWopUUp//0un5bKNJ6mezT1b/0+a+0HNchZFbJL//1O1g0VSCXpHSslbf/9VU/ckrUo51"
         "dFJl/9bgz0KMh6NnJb0//9ckxWlLAmpQY1//0Ox50xlYJWUzz3H/0RyaptHT3AU62Pf/0mS0XQ62AsjyGt//0+x53pxVvHW8drAMX//U5S+o"
         "oRX0VCQ9L//V4qStM7ClpSwp/9bsphGNclYZWGVf/9e3yNSLBFgi6z3H/9Dm2pZHrY9bHrY9/9H6zx6Ie0dbx1vHW/8A/9KQfSprgWsliS1j"
         "/9P55TglUUqK1lf/1KGw1ldR8nUZV//V6GI5OocU0VVB/9ZUmVVRZa59XI//1+tkFc+pmUNWSt//0LM/pyUtHW6NOIEl/9Hj10gklpLyyoYf"
         "/9KE5qStTLQwJG//07uz4lPTpiUEd//UdmYGVbIsr4r/AP/VZKFKmpOqXqFP/9b6LGZHtJS0j3kpb//X5nobxnIJzGchSf8A/9DhrBzLQ3UM"
         "r2H/0aNGMg3kfFfyP//SpRsXh6Y8uCf/09jk8Fo40DqAf//U+hzZHhkNWR7SPb//1d7dK95PTyjKeSn/AP/W491GU/IjWD27/9ee2Vzc1+IH"
         "yt//0HXl5W8G1RiJ/9F083kTyTJVc3f/0upm85xL2LSUNX//0+qEla0ptK9o/Xh//9Tk+tT0Z5Gfoz9JP//V5jZGOWvzHLG7/9b23P7mIHeP"
         "gf/XbonspFKZSmUp/wD/0LvP8drljlrltD//0fpR5qGpK1pjaU2//9Ke2mH25bCfoJ6Cf//T5VcvpIbk3Y3P/9SbZnNyR7eO93//1fehLTxT"
         "U4SZCf8A/9a3P5RwmySHUnU//9fuy8Y6kqMlqTdb/9Cq8JutN1ZfZj6C/wD/0eZ6UfRX0F2Skx//0oq5Dcscmx8e/9Md0PA73e4lNf/Ua+Rk"
         "JnGTITOaf//V62DxSsSsSs22P//W6+rz5uqjrTdWfq//14fez5DvRGRHo9//0Of2Q242LG437//R9ry+4+BwHwP/0hvLUDIzZKbIy//Tv83y"
         "DRdudsd0N//U61/M2xSaoFUdX//VVtdAqW/ysj2SP//Wi1ZMifT5jcZ7/9cK5GNxnvAiD//Q9SAg4reUNlP/0XZMTJzZOZqvrn//0ujHy/aD"
         "7Q2XZRp//9NvoxSLJFUir9fg/wD/1Eep5wybItkmybf/1ZzmYQwhhDCP/9Z1MgqwKwKQV//XXCbEmyc2IjEn/9C/yvK9oYdJzQ2aW//Rq9XG"
         "o0UtVCqhX//Sg9HZbb5oZUGT5Kn/05qZPTc+DSGFf//Ue2JpAqVo60b/1RhFaP5OYs2qn//Wf5mFiIZUdLDqb//XovhHSw6WWarWv//Qm9eq"
         "1qta9NvkRlX/0R2eUM7BOmTo3h//0i7K3lZys5RVv//TojkUjqR1TfF7/9QPMixUaEYEJl//1aseANbL1MGtg0t//9ZPvIC1WtQWoLX/13el"
         "84CXCdhSoTt//9BJiwKzlaFby//R6C+eCMpGTOikf//Sm8xfLzORnI0J/9OjycJMoamDUy9bf//UD1c69Th1BSoLT//V5vsbRWvcl8etaglf"
         "/9YNWBa0BaMVTUf/19OM1DFUFZav/9AM2daUWreHMCf/0V+fmZyM5DKDob//0jOEbsGhxuw9T//Tl9UgtAFASve75j//1HbvKUHUKK51q/8A"
         "/9WTRmNASAkU17//1gljHnAOKsHP/9ePMp9MxM+Q+n//0CzeX6req2Vb1W//0fehlAUAUWrrWn//0udo096vhpLJ5klv/9OTfkVzbManbMf/"
         "1I+yFMZzZzZz/wD/1YUTObeBdM+n/9ZM8BdMuQnbWb//1yfz9dvMwh1h/wD/0EUVYda07+vzEMf/0d9DEglDFJ7JH//S5erL6Xel3p9vN//T"
         "5ix0nWfzNpX/1InhvTLpGJbyf//VBvIPnIEwxc3/1mDGsOsOoOtX/9fpas87iagncTP3/9DkexjGRyJyPZE//9HhSz6SbsTknb//0uZo4mXe"
         "kQlvR//Tj0+SYmxCxGZNv//UfLzGIwBlB1B//9VGOCg/0PqmWqTUH//Wn9bNLVJ2ARI52//X+d0ZhgRixEsqf//Q4dUOjMqSZd6P/9Hnb8W9"
         "H3SJZukf/9IW8Z0WbFnRKw//03ebgUGTzKDfRe1o/9S7ZOSqS2SWqTsv/9XhexhCDDBgzsEW/9b5pJMqWULa8yh//9fnejP3R3pe6W9L/9CL"
         "f4T4M6DOzs6Df//R6XleYsMrmTzpLf/Sm8rP9J7VZqpLWctU/9OP2fOndQkwxcYt/9Tg1yjFyPMbmP3/1eZogxwRXShdP//Wm2+VpQ1VsC6D"
         "/wD/17M3ltzu2LK50s//0GeZFDOhqfU+lKWs/wD/0bNuOas5qznogSf/0uZ6PmjKmSYZPvd//9PlvlMgyDIMr//UTo84iu8pFDHf/9V7eS2D"
         "tg7YOyL/AP/W6njwRSk70npSelP/1/omjNSc1ZT1nNWX/9Cb2PEFHydBm+JT/9Hn2y6OIIQUwv8A/9JLeYXAyDII9//TffyDHMhRkHZB/wD/"
         "1O15OY4ul6z1pPWv/9UM22etPsKeNPWc1Jf/1rN3kT1mh5itMSn/10b/ADMSmJTVUkT/0FN5hKhIhcDJ/9F/eObFhJ8xxf8A/9LsZcRwoyFC"
         "jRFK/wD/0+j5mmW9pr1mvb7Ofzn/1PoXwz0jPWU9IppP/9UvT8DFrgrgp5a//9bNOHZz2ctnPZz/AP/Xdn8A2ZjOxmYz/wD/0Ox3mnGhwoUK"
         "HCv/0fpfn3nraXTaXRaTTb//0o9H0X2+T5NFIIrJFI//07t3ziqJnU8K51v/1H+j5uCmzX0ZejL/1Xx8DYyIBjUa9P/W68fHY7s6pwpsa//X"
         "+l8lShTZVnveTVf/0Koe5JqvJqv9pi+OS8P/0e5fy0vBNIKeedX/0qvR8PBb3V91fTT/06beX6UtjL0pEvf/1L8vgmasaptU+r//1e9liUXK"
         "TlKhSf8A/9bvePuk03l03k1aJdN//9f6GoU0FvBT51tn/9Cv0fnMFM63hXBb/9Gjdm9NdSXpy2cv/9KuXgap3rEbb1v/0+lGOipoTmTmf//U"
         "73lOSMitpr3lvf8A/9UG+hmvf6Y/Og2YDn//1uju8wGzgY4K+Fv/16d3n4tcFdVdWX//0Ka+cSS1ZeU4NH//0a55PLfwv4VNR//S6OOxqpqD"
         "AS9v/9OzNvnreeuiel+/q8b/1Oj6D52YezZ2Yeh//9Wvf4orbBbwti1//9ajRLRPelonon//17H8oV0gmgU0Cmj/0Cy+kfTZ02cjBP8A/9Hq"
         "ZeU1UtdDXQ+j/9KQ/Rdf1PP8Mvhm8Mv/07PR8rwhi1xbCLf/1H6JYLbykZb0/wD/1bNOHTPFZc9K56v/1vS2LnpBLMaLTH//13Q0saDDJZqr"
         "r//QxPRX10nR0PczkuT/0X+s5rl1cmrDFr//0qteEVti2xLay//Tp0LrTJ5k0xV//9R1wmWpMdSY6wS3/9WTJ7jaZm0ztfMx4f/WcwUuha3W"
         "t1ro/9cff940yGmM0yGmT//Qs9DyMSopbFsKX//Ra19dSdCpIqJ//9K/08gCiIa58+ueOz//0+Zl+mXKza5W1ytrk//UCrNpmxXCegZX/9We"
         "PpjO/wD/xAAcEAEBAQEBAQEBAQAAAAAAAAAAARECIBAhMUH/2gAIAQEAAQUCtWrVqv/QSoiP/9Hz/9JVX5//079nz//UxixYsf/VsVatWv/W"
         "tWtRH//XiJ9//9D7Vf/Rqr8j/9KIkYsf/9OxYsVa/9S1VWtf/9WIiI//1vP/16qqr//QRER//9HPzqLHSx//0qq1atf/07UrlHL/1Inj/9X5"
         "VV//1qqIj//XiRn51HUf/9Dp06Wq/9G1aqVy/9Lly5T5/9PxX//UqqqP/9XlyjmM/P/W6jqOo6dP/9erVq1a/9CX95cuXL//0Z5//9JVVX//"
         "06jly5f/1OYk/Oo6jp//1eo6atWv/9a1U/vLl//X5cp9/9D7Vf/Rqqjl/9Lly5SfnUf/0+o6jp0r/9Sr9n9//9Xly5cpX//W1vj/16qqsf/Q"
         "kcxy5cv/0Z/OnTp0/9LrxX//00cuXL//1OUrfv8A/9X5VV//1liRy5f/1+XL/OnT/9Dp06+//9H7Ef/S5cola//T3z//1PuJH//V5iOUf5//"
         "1unTp06f/9fz/9CIiI//0ZWt+//S8//TSIiP/9SfOnTp/9XpfH//1vsR/9eIlb8//9Dz/9H5iRI//9KInyv/0+lV18//1PP/1YifNf/W3z//"
         "1/GP/9DGIiP/0VVVf//Svn//0/P/1PP/1fP/1vP/1/tV/9Cqv3//0fP/0vP/0/P/1PP/1futf//WtWqqv//X8//Q8//R8//S8//T8//U1q1a"
         "r//Vq+P/1vP/1/P/0PP/0fP/0vmtWv/TtVV+f//U8//V8//W8//X8//Q+61//9HVqqr/0r5//9P5Pv8A/9Tz/9XxH//W8//Xa1vz/9BfH//R"
         "8//SiJ9//9Oqq/P/1Ps+f//V+61//9bW+P/X8//QT7K//9HVqqr/0qnyfP/Tnn//1PP/1fP/1vutf//X1rWtf//Q8//R8//S8//T8V//1Kqr"
         "8//Va1rX/9bWt+//1/P/0PP/0fP/0lVVf//TvzWtf//U1rWtf//V8//W8//X8//Q+1X/0aq/f//S1rWtf//T1vj/1PP/1fP/1lX7/9eqqq//"
         "0Gta1//R1rW/P//S8//T+z5//9T5VV//1b8qun//1qv3X//X1rWtf//Q3z//0fEf/9KInyv/06qq6f/U6V1HUWP/1cYxjH//1sYxnz//12MY"
         "x//QkSJEiR//0VVVf//SrpVdR//TsWMYx//UxjGMf//Vz5jGP//WxiRIkf/XkSfKr//Qqqqv/9GrFjGP/9LGMYx//9PGMYx//9TGMYkf/9WR"
         "IkT5/9aqqq//16qxVj//0MYxjH//0cYxjH//0vmMY//TxjGJH//U+VVf/9WqqrH/1rFjGMf/18YxjH//0MYxjH//0cYxjH//0sZ9r//Tqqqv"
         "/9SqsWMf/9XGMYx//9bGMYx//9djGMf/0MYxjH//0XTp06f/0ulVVf/TsYxjH//UxjGMf//VxnzGP//WkYxjH//X+9On/9Dp06WrX//Rqr9/"
         "/9Lz/9Pz/9RrWtf/1da1rX//1uq6dOnT/9e1b4//0PP/0fP/0vGv/9PWta1//9TWqqv/1arW/P/W8//X8//Q8//Ra1rX/9LWtar/06qq1//U"
         "3z//1fP/1vP/1/utf//Q1K1rX//R1aqq/9Ktb9//0/P/1PP/1fP/1ta1K1//19a1ar//0Kqta//R8//S8//T8V//1Kq1a1//1ZUqVrX/1t8/"
         "/9fz/9Dz/9Hz/9JVVX//078lSo//1J5//9X5/8QAHREBAQEBAQEBAQEBAAAAAAAAAQACERAgEiEDMf/aAAgBAwEBPwH8X5vzfm/N/9Dly57/"
         "AP/R85cuX//S5YLBf52L/9PDLabTav/U1PvL/9Xly/N+b83/1vzfm5cuX//X58cv/9Dly/NgsF//0cWLDdlv/9LTNqfP/9Ply5cvzf/Uc3Ll"
         "y5f/1eXLnv8A/9a5cuX5v//XyWbNmy3/0OyyzN//0YuXIL//0uTmczmc3//Tc3Llzz//1PS5f//VCCCyWb//1iy3ZZb/12fCL//QCCMzmc3/"
         "0XMkly5f/9Llz0v/0yCCMwX/1AiIbt//1ey+Pn//1iCCCM3/13M5nM5kv//QS5c8b//RiIIL/9ILlz3/0+3bt3z/1PCCC//VCCczmc3/1tEk"
         "kkl//9dnzMX/0AgguXL/0fO3bt//0vjN/9PNkslklv/UWWZm/9VmZ8//1iIizf/X7du3bt//0O3bt27f/9Htlstlst//0sssyzf/02fj/9R8"
         "Ii//1SLt27f/1u3b9Xbt/9ft27ZbLf/Qy2Wyyy3/0Vln3//S+C//0yIiW//UZbst2//V7du3bt//1hhstls6v//XWWWZv//Q+f/RiIi//9Ls"
         "syy3/9Nbt27dv//U7dhhhv/Vy2WWWW//1mfj/9f5/9Dwllv/0Vllu3b/0u3bsMN//9MbLDGpb//UWWWfP//V+f/W+f/XWWWWW//Q7du3bt//"
         "0RhssMN//9IZZZZv/9N+f//U+f/V8Zm//9Zm77//1/SL/9AYYlu3/9Ffn//S+f/T+G//1GZnz//V+OX/1iCIi//X7du+/wD/0Pn/0fn/0pmZ"
         "v//TbnnLl//U5ciCC//VIu3bt//W+f/X+f/Q9Zv/0WZ9/9LnvIL/0yCIv1f/1Bux7//V+f/W+f/XZmZv/9D3nn//0QggiL//0iGGGL//0z5/"
         "/9T5/9Xxmb//1mfeX//X8IIv/9AIiGG//9EYj3//0vn/0yPCb//UZn3/1fOeF//WIiCC/9cIiLN//9D5/9GIjz//0iZmb//Tfn//1IiIv//V"
         "GIIIv//WI+P/1/gv/9AiJm//0WZ87f/S87EN/9MYYYYL/9QIiPP/1fn/1vCIv//XZmZv/9D0hv/R7EMMN//SG5c9/9P5/9T4L//ViZm//9Zm"
         "77//1/Ow3b//0BhhuXL/0efP/9L5/9P4b//UZmfP/9X5/9Yhhhhv/9fly57/AP/Q+f/R+f/SmZm//9N+f//UiG7Df//VG7cuef/Wn4//1/n/"
         "0PWb/9Fmff/S+f/T7du3Zv/UWZZbt//V7D8f/9a7du3b/9dZZmb/0POXIL//0eXLl+b83//S/MzLLf/TW7dhhv/U97dv/9Xt2WWb/9Znzly/"
         "/9fly5BBf//QMxmMzN//0WWW7Df/0hiPf//T7du3Zb//1O+vn//VIIIIL//WCCMxmM3/12Zllv/Q7DDEX//R87du3//S7du+/wD/0/CCC//U"
         "CCCCM3//1TMZmZb/1lluww3/1yPVv//Q7LLdu3//0fSC/9IIIIIL/9MIzGYzN//UZZZbt//VGGGPP//WZlllv//X7D6X/9AgiCC//9EILObO"
         "Yzf/0s5tWptN/9NbsRF//9QiZlv/1Vlhhi//1iIIIv/XCCCyQX//0M5s5s5tZtF//9HRaJLkF//SCCCCS//TSSSSC//UCMxmMxm//9UzBBEX"
         "/9bLZbLZs3//19ZtFotFov/Q5ERF/9Hkkkkl/9JILJZzZzf/085vzfm55//Uhstlst//1ctm1m0Wi//W0Wi5Zgv/1wggkkv/0Ekkslkv/9HO"
         "bObOb835v//S572y3//TzZbNltF//9TZaLRaLl//1SIIgv/WSSSSS//XyWSzmzmzm//Q/M5kmb//0bLZbLZb/9LLazbLRaL/09lyyWSyX//U"
         "CCSSS//VSSyWc2c3/9bObOb8zmS//9dLXmWzf//Qy2bNvNsv/9HZbLZc/tkv/9IILJBJf//TSSSSwX//1MFjNjNjM5v/1dZtFotS/wBv/9bL"
         "ZbLZbLf/19lstlst3//Qs2bNm//RJJkkv//SbBYLBYL/08En8tlst3//1Nz/ANs2bN//1c2b/8QAHBEBAQEBAQEBAQEAAAAAAAAAAAERAhAS"
         "ICFB/9oACAECAQE/AY5cpXNf/9Dq/wAd127dv//R6n9cxy5c1//S56XpatV//9OsREf/1NSta1//1d8iJX//1pUq3+O66f/X6duo5jl//9Dl"
         "zXNXpr//0av4/9LzWtf/09a3yP/UiVKlWv/V6rp06ix//9aRESp0/9f6a33/0M/Gv//R1rUrX//SiIiV/9OVa6qq/9SrGe//1dfT6a1//9bz"
         "Pf/Xa1Klf//QlSp5H//RlSpWrX//0qqrGP/T819J0//UlRPLH//Vqqta/9aVKlSo/9f3Wv/Q1v4//9HGL5a//9K9J0lSo//Tiqq1/9S1qVKl"
         "f//VlS/j/9bWtb5//9fzFiv/0KtWua5r/9Hly5V0/9Lp1XVWua//05UqVGP/1MZ+P//V9xj/1rFixYvL/9fnlzHKOa//0LXVdOnUf//RxIkS"
         "JH//0oxjGP/T/P8A/9RixYsf/9WxeUiRH//WiVaqv//XqxiRI//QkRGMf//RsX8f/9L3Fj//07FixeWP/9TPda//1b7jH//WkSJER//XsWLF"
         "iv/Q/Ef/0WLGLH//0vl8s9//09b+P//UYkSJH//V8sWLH//WsX8f/9fzGMf/0MfL5XlY/9FWt8//0vMYx//Txntj/9Sx1FXz/9WIief/1sYx"
         "j5f/17Fiqtf/0NSoiP/RkYxnn//SdOnTp//T69iP/9Sfn//V86x06f/W6dNRH//XiRIxj//QxnnVdP/R6dOvI//SiJ5r/9PWta6r/9Tquq6d"
         "I//V5cokSP/WxjPf/9euldK//9D8/wD/0da1rX//0tWrVqv/06jly5f/1OYkYxj/1c8qq//Wrr2P/9f3Wv/Q1rVq1//RtVUcv//S5cuYkY//"
         "08Yxiv/Uqqvn/9X8a//Wa1rX/9e1atVX/9Dly5cxzH//0eYxjGP/0sVVV//Tv5//1GrWtf/VtWtar//W85cuX//X5cxIxj//0PMVX//Rqr7/"
         "AP/S91a//9O1atWtf//U1vvL/9Xhw4cRzH//1sYzzH//16qqsf/Qz8//0VVVf//SsYxjH//TxzHDhw//1OK5rVrX/9XW/j//1rFjGMf/1/z/"
         "AP/QxYxj5f/R+Xy+UjmP/9LlzXNTp9P/0/p9Pp9ef//U9xY//9WxVXz/1vcY/9f5fL5fLH//0JERKlf/0Z0+n0+n0//S+vz/AP/TxixVf//U"
         "v4x//9XGPl8vl//W+Xy+Wef/12vp9Pp//9D6fT69/9HzFix//9KxVXz/02MY+X//1Pl8vl8sf//V919P/9b6fT6fT6f/14iIkf/QsWOnSv/R"
         "qIkSP//SkY+WPl//0/lixVf/1NXp9Pp9P//V+n0iI//WkSLHUdR//9fp0qI//9CJEj5Y/9H5fLFix//S6VavT6f/0/p9Pp9I/9SIiK//1enT"
         "p1Fj/9aIiVK//9fWta1//9C106dV0//Rv4x//9LEREr/0550qv/UqxPf/9VrWtf/1tarquq//9fquqvv/9DEjER//9GJU8r/0qqxYx//0/Na"
         "1//U1rWrX//V6rp06qv/1oiJEj//14iVEr//0FVVj//Rs/P/0ta1rX//09WunTp//9TpaiI//9WRIiI//9aJ5fP/11jPf//Qata1/9HWtWuq"
         "/9Lp06Vy/9Ply5jmI//UiInn/9X8Y//WqqtWv//X1rWpX//QtdOnTp//0f8AXLly5j//0uYiIj//05+f/9RjpVf/1bVqVrX/1tSq6V//1+nX"
         "nDh//9DlxHESJH//0ZET3//S/Ff/06qxYx//1MZ7X//VqrFj5f/W5jmOXLmv/9eRIk9//9D8/wD/0dVVWP/SsYz3/9NVVY//1LHy5jmOX//V"
         "5c1jGP/W/P8A/9f2+f/QrGMY/9H8/wD/0mMfKR//05ERKx//1MZ+P//V/P8A/9b3GP/XxixfP//Q9xj/0fljPI//0tYxnn//0/z/AP/U/P8A"
         "/9XGLFiv/9ar+P/Xxj5Yx//Q81jH/9HPb5//0l83z//TnmMWP//U6iq68//ViJEj5f/WsZ7r/9exVVX/0L5VV//RRESP/9KRYrpX/9PryIj/"
         "1JGLFV//1atf/8QAFRABAQAAAAAAAAAAAAAAAAAAIBD/2gAIAQEABj8CP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//U"
         "P//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//X"
         "P//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//S"
         "P//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//V"
         "P//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//Q"
         "P//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//T"
         "P//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//W"
         "P//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//R"
         "P//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//U"
         "P//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//XP//QP//RP//SP//TP//UP//VP//WP//X"
         "P//QP//RP//SP//TP//UP//Vn//EABsQAQEBAQEBAQEAAAAAAAAAAAEAEBEgITFB/9oACAEBAAE/IfAAr//QH7gtP//RPyZnP//SfAb/04Rg"
         "L//UJ+PFX//Vo+AP/9bAPqcr/9fP8Tn/0HHT/9HQfuP/0oMPxl//09qOH//UhSwPq//Vc9/xf//WZxz/1/IP/9A/dzC//9E0IZf/0jLwB//T"
         "j6Snj//Uv4nG/9VnxP/Wiv1k3//XORoH/9AQhgr/0cBX0lf/0lp+Zv/TZmc//9Tx36v/1YI4Ef/W0AQv/9deQD//0IKUsf/R/MzOf//SfP8A"
         "/9N370F//9TxAhf/1YE6D//WhSjnf//Xz/Mzf//Qcd//0d/7z//SpjoP/9PAEMf/1MGYz//V2K+V/9aMWW7f/9fYMP/Q+2Rjn//R8gf/0ozO"
         "P//TSH3wP//UV8sdu3//1e3dBf/WTD7Qhf/XwNH/0NDN/9FuSQ+5/9KKd8sf/9Odu3Zv/9RkkmfS/9WDqT//1vIP/9eZmS//0B93cr//0dDt"
         "2//Sl3l//9PmBjn/1Kfngf/V1c//1rkGn//Xi0dv/9Dt27dz/9G54B//0hDH8z//0/Lf/9TOXIL/1dAxP//Wnbt27f/X3mP/0CEGn//R/nn/"
         "AP/S3y5f/9PlyIi//9Qi7dz/1ewxEX//1iCAgi//1yG78nO//9Dfy5f/0eXLkEF//9IIIILl/9Pngv/UGIiL/9UYYYn4v//WynPP/9fly5cz"
         "/9Aggggv/9ELnj//0uxERf/TM7du3//U8AK//9V45cuX/9a5BBBf/9cIILmf/9DSL//RIjO3/9Lt3wH/04UpXL//1OXLlyD7f//VCCCCD5f/"
         "1kmZm//XGIiL/9C7d0//0XApSv/SVySS5f/Tg+wggv/UCCSSb//VZiMf/9YjFu3/11wxi3//0FlMly//0eXJIIL/0hCEHyS//9MeAN//1CI1"
         "/9VZZZjP/9ZjFllv/9dJmZv/0D9lDCQX/9EwKUr/0sCUN//TV35LM3//1GZmb//VZkkm/9ZluxCf/9chStZ//9BZZYhv/9EYYbvy7f/SZuSS"
         "X//TSSZMf//U0K7f/9UYhDP/1nJizf/XIiGG/9Dt3eX/0Ukkmb//0mHgf//Tnfvgf//U8+//1e4Qw3//1hhh3//XuXJJL//QSSTX/9HNy3b/"
         "0vJ//9PDt2L/1Ow3YYb/1RiIufL/1khCSb//1z47v//QXyP/0aUhBv/SM7dhv//T7DDgv//UC58hCF//1RMdv//WzWWZ/9d0lJ//0CDDnb//"
         "0e3bsMr/0sBB8hf/0xCEIX//1BHwB//VYxrG/wD/1ikIQL//1+eQ/9DygH//0Q+Qhp//0oIxw//TyGMb/9RzKUn/1SB4H//W8oH/18APkcf/"
         "0NRjf//RO04f/9JjpL//0yEIYf/UMCGD/9XQBc+X/9Yw8f8A/9cxyOX/0H68j//RpSEJ/9IIIhC//9MhCGD/1AufI7//1czHL//WynR//9fy"
         "b//QwIQn/9EhSFJ//9IhAufI3//TPjm//9Qx2n6v/9XyP//W8w//1wiEIT//0DYQn//RT5CGn//ShjGN/9OnwH//1PIP/9XAIhP/1oIaP//X"
         "C5J8hj//0PIT/9FSw5//0vP/0/Bf/9QYhCl//9WlIT8X/9aFLT//18BZZv/QfP8A/9Hz/9Le4//TpmUn/9Qn4nPP/9XNrFv/1lnx/9fz/9Dz"
         "/9HupS//0ilL+J3/0347P//Unbu//9Xz/9bTP//XZbsxv//QMpSE/9H8YLT/0tnbt//T8N//1PP/1YmWW//WY0+8S//XKT8YK//Q8g//0e3Y"
         "3//S8//TIjX/1ItE+7//1dVIT//WYszN/9cYYYi//9D+ef/RjS//0jx3f//TcP3QV//UUPyWXP/VZv/aAAwDAQACAAMAAAAQhx//0GIJ/9Hk"
         "5f/SgEH/09hb/9Rfe//Vxk//1k4t/9fAnf/QfTX/0UyV/9JFzf/Tcif/1IOb/9U3Lf/WjF3/18Rx/9BYRf/RfPH/0nXd/9Odif/Uqov/1Ydb"
         "/9bXtf/XTg3/0Gqh/9Hjc//SbF//03Qj/9R0mf/VsRf/1ijn/9fVhf/QwMv/0a4n/9Ipj//Tkmv/1JBz/9XOOf/W4v8A/9djT//Qb0P/0XPh"
         "/9Iihf/TP13/1Jy7/9WWg//WHCP/17U5/9BbAf/RpQX/0n0P/9OQ/f/Uo43/1eTV/9bCnf/XBnH/0I4F/9ELOf/Smdf/0/Un/9TgZf/VsxP/"
         "1gin/9ePIf/QVB//0dFN/9Kax//TNBf/1Clr/9Xo2f/Wflf/1wpN/9Aqm//R+6P/0nwZ/9OTCf/UhhX/1TDP/9bxCf/XFpP/0O/j/9FOif/S"
         "cJH/017N/9TJr//VQ3H/1jUJ/9e3Vf/QO5f/0fM9/9L0L//TGe//1Ipt/9UNi//WFEv/1zpx/9DnI//RtNf/0v8AZ//TKHn/1AQj/9WRc//W"
         "yYn/1ycj/9DVRf/RbKf/0kRL/9OxL//UFZ//1Qs//9bIWf/XF8v/0Krt/9EX+//SM3X/06+r/9Tgrf/VM3H/1j1B/9etlf/QEQX/0WLz/9JN"
         "0//TQA3/1D07/9VH3//WNtH/12MX/9AOYf/RiOH/0u7X/9M+u//Uci//1cLV/9YWH//XOen/0LvV/9HyM//SL2X/09rn/9RNHf/VgXH/1uY5"
         "/9dlyf/QtJX/0Thf/9LaYf/TYYP/1Izd/9W/6f/We4X/10Ij/9BFQf/RrBX/0tNR/9ONS//Ucj//1SL/AP/WpJf/14qZ/9DyW//RnT//0sYv"
         "/9OAn//UzY3/1dlV/9ZWFf/X3mv/0Hrb/9FOa//SAjn/08+3/9Q6Rf/V9Kn/1tMX/9dd/wD/0Oh7/9GVo//SNT3/09tB/9Sq5f/Vh8P/1vFz"
         "/9c40//QJi3/0ckd/9L5v//T22P/1AN9/9VsAf/W5dn/1yun/9D1cf/RAPX/0pE1/9MNL//U3Sf/1d6N/9bzzf/Xs1f/0OXH/9GxCf/SMG3/"
         "03mv/9QKe//VPlH/1tub/9cWEf/QgH3/0Tq//9ISgf/T4jX/1BQD/9X68//WVj3/15aB/9BJF//RKZH/0jmT/9NxJf/UPNv/1RrH/9YJwf/X"
         "fEP/0A4//9G4w//Saxv/0zy3/9QpD//VRRH/1kLB/9cfs//QjLn/0YyT/9I/lf/TtlX/1IMv/9U+l//WKM3/12JL/9BWhf/RFLv/0mCl/9NN"
         "O//Uwh//1VGh/9ZLVf/XVcv/0M4j/9HrQf/SVKP/0zpt/9T24f/VzDX/1lpb/9eS0f/Qt9v/0ddZ/9Jkuf/TmIn/1JqX/9XH/8QAHBEBAQEB"
         "AQEBAQEAAAAAAAAAAQAQESAhMUFR/9oACAEDAQE/ENTGf//QKUgQX//RLl9TG//S3w/J3//Tr44dJX//1Ffu5cx//9XNrWf/1mOJSf/XnIuY"
         "/9DVxw//0RyXMH4y/9KHLAX/0yHUUrf/1Ja1z//V0cz/1gjApP/Xs8y8v//Qfnaef//RYQIy/wD/0jzUP//Thrhy/9RLkEIn/9XyuP/WeD86"
         "H//XV9SfYQv/0PIm/wD/0Y+uLWf/0mMTX//THkR//9ShLlwm/wD/1XIuP7f/1j4L7X//1/Pl/wD/0JaxIX//0efYRye//9KykCG//9MxcFv/"
         "1HDtf//V8/1//9by6n//1xCf2Eb/0PNd/9G74X//0lu3Y/YX/9MaA5f/1Mpzlf/VUsCT7f/WO7lf/9djGNb/AP/Q8/8A/9E81X//0sZ5O//T"
         "cpmb/9QSfY7f/9VzmMZ//9Zr4v8A/9fE+9T/0PKtf//RynL9lv/SZm5C/9PBTw//1FcZ2//V8efV/9bzan//19ic7//QWWfs5//R59gaK//S"
         "MC1f/9Py/wD/1KePf//V8rF//9Zyl3//17lyIv/QGGWh/9HyL//SKU2//9PzvH//1NAV2//V7vLl/9YIi7Dy/9fyAv8A/9ClKZ//0fr5z//S"
         "8YC7f//Tx2Iv/9Qw3//Vvspzv//WbNuoXsLf/9cWFhZs2//Qaabiz//RhZuXL//Shhuxf//T8//UMYwuX//VCC5BH1f/1jkYxv/Xrl2b/9C5"
         "vb//0e3Yb9z/0ghCEb//0xgIw//UIQ7X/9Ux3J//1u+f/9fOwxf/0BiDAv/REIXPsF//0iB9gjF//9M5GMT/1IIouX//1Wcbt//WGIiL/9fA"
         "Qhf/0AggiBf/0dKMb//SPhR3/9Oc+TM3/9RbsMMX/9UiEIX/1hCCCJ//1wghkL//0KMd/wD/0aeefJv/0mZZf7Df/9PAhC//1BCEkF//1Qgi"
         "BC//1jH5Ha//12ixyuX/0P5MzJf/0XvYaF//0vIP/9NQ/YYY5f/UGRKcy//Vp7xv/9Y57dm//9dkuQQv/9AeQ//RjlDE/9IYYiy//9PwBfW/"
         "/9SBDHb/1Vm5Ny//1gghDH//18VKd//Q7DDLD//RIvAH/9KSlCC//9MiXf/UT/LkEGP/1S/WfjH/1lK6hhv/1xhjAT//0PIF/9EgZ27f/9Lu"
         "8gv/0wgggz//1MXK79v/1Rhhh5Df/9ZeQT//13JnJv/Q7EZy/9EIIIIv/9I3c7//03d+www3/9QZYGH/1ZK1iX//1k0MX//XMCCC/9AIIz+b"
         "/9Fzndhv/9IYYYYb/9MhClV//9SFofq//9UwDDD2/9YYhTH/1857/wD/0OQRDB//0SlKQn//0iqWh//Tj9RoP//UGG7r/9Xwor//1oIPsQn/"
         "1yENL//Q0Fzv/9FaBg//0oUolv/Tji5f/9Ri9mEF/9UeQH//1vKg/wD/11lbX//Q/WgpX//RGXkxjf/Sa5dm/9P9g+w0P//U8jp//9XLc8v/"
         "1so+tD//11KH5Lh//9B8lv/RHt2CHcP/0k8gf//Tv/Lfd//Ufio+r//V2Jw3/9ZT8A//1y9IYx//0BkNj//R8+F//9LAp4f/06Pqc53/1Kvk"
         "55f/1dt6Sv/Wg2jf/9fzU/8A/9DyAP8A/9HUj6y//9Lavhl//9PzXf8A/9Tz3v8A/9XB4XxO/9bQFK//1/I4f//QPqMYxv/RPjzVf//S82j/"
         "AP/TkpDmC//UPIB//9WF4v8A/9bIPqGX/9fK+G1//9DzUv8A/9HB67f/0nmSY+sv/9NYLT//1PDUfV//1THI3wv/1vMX/wD/1/P1/wD/0H50"
         "xn//0e/fJB//0vJPf//Tg+vAH//Ur4eAP//V8l1//9bLfm5Z/wD/18i/b/CV/9DhKWHG/9HVDA//0to+WH//0/II/wD/1PCD87//1cvlsf/W"
         "8gB//9coIIIX/9APsIQhf//RHyIgQYf/0h3AoIe3/9MY4BFj/9T5nHP52Tf/1VL5f//EABwRAQEBAQEBAQEBAAAAAAAAAAEAEBEhIDFBUf/a"
         "AAgBAgEBPxCqWz//0MQ8Ht//0cF5nn//0vmu/wD/0zHqGFf/1DCZE//VJ3Ly/9b4vDv/16L0wF//0FcdRv8A/9FYS5Bf/9KGKUv/0ykIN5v/"
         "1H8R+N//1Yez3v/WyvY//9f18XL/0ImLj//RpTAT/9JSlLD/048cHG//1DekQIeX/9UhCHcT/9YgmJLf/9dZ+Nf/0MBQyv/R0F85f//SWTh4"
         "v//Tu/Ef/9SVgMP/1YpYPu//1sVMFf/XGGGIX//QaxZJO3//0WOC4f/S+S7/AP/TMPPjv//Up9/HX//V2u3b/9b4L9v/17k7v//Q87auX//R"
         "WBDyF//S0Hrj/9PenN//1MuXLl//1SCCMP/W+b+//9fAGz//0PDBXrD/0X381X//0jO5n//TTAggv//UD5R//9X4RDy//9bB4zx//9c4Pvc/"
         "/9CBCa3/0eEJI/YL/9IIIL8Yf//TjrqF/9QgQxGf/9Vd8lkmPu//1uOgIX//1/hQF//Q57BBBC//0eThcv8A/9JweLk3/9N4wu//1OfMD//V"
         "CD48/9bL/YIL/9cIIjGf/9B/zMdB/9FMOA3/0j2CIUv/0yECCe//1Mwxv7f/1cBCC//Wfg2f/9fOPJ5f/9A96BC//9GTiIQL/9IIEDkCBf/T"
         "n9jT/9SFy4QF/9XhcIQGP//WUo9Tvd//1zl46f/Qw5dJX//RWn9x/9JSlDj/0/l3/9TEWP1f/9WCO1//1tHLl//Xcpyz/9D+xDDDf//RPkf/"
         "0n4/O//Td+sCF//Ujy+B/9WcnOd//9bL+wyv/9cYYZjP/9Br8b//0ac794//0jHDymf/0/gHf//Uc/j/AP/Vuww4/9ZZjWt//9fUFK//0P1G"
         "O1//0fCYxjP/0mOcvc//06527f/UHQxv/9XFa9yv/9ZZb9Rjf//XOXlMZ//QSSYpX//Rfzf/0u3buj//0/kF/wD/1Kzst+7/1YIYeF//1mMY"
         "kz//11ocP//QZy5jf//R7K6gwb//0kurq6u7/9Pu5sMIv//UCHkmGTf/1UyZZZL/1umDWM//10mZkv/QcLu//9HR74f/0s3O8pv/02sYxb//"
         "1GS5PWP/1YEMN//WkknP/9ePwP8A/9DjHnxv/9Hwmtepn//SZ3eX/9OPjAQv/9QTnMf/1T5R/9bAhC//1xjmK1v/0GMYMX//0SCOrxy//9Kj"
         "sX//0wiFMv/U0OP/1eZ3f//Wc2MZ/9dYEMP/0PHIQz//0f1gd0P/0vlr/9OOwr//1HI4s//VYx5F/9bC8dD/1xj98wb/0B8u/wD/0XTzy//S"
         "j5n7Z//T+Ad//9RznOXl/9WcQw9L/9YZe1//1/nX/9ClLBX/0X7vMf/SrnPL/9Ny+S3/AP/UOAghv//VGPjv/9bB+aH/18B+wwX/0DAVyv/R"
         "eTl8z//Sp2Cf/9Muxr//1KYk8r//1aUsF7f/1sBo/wD/13LJ5f/Q75K9Qw//0YSbt2//0t5Sf//TJ5Sl2V//1Fek8m//1c9T5O//1lO75Kb/"
         "13Bickv/0FnTL//RIQnlh//SUpS9x//TEMOs+X//1HKcrvl//9VZkkmf/9YYWz//1ylIYP/Q8pSlK//RWe4xu1//0rTOc7//03DvL//U5PiG"
         "/wD/1cpYhP/WFg/JTv/XUpfcC//QPyK//9GBCPzP/9Lt2W7n/9OnaL//1CEDkMr/1adv9X//1t68v//X1AIv/9C7iy3/0WLAw//S1uXL/9OW"
         "Bfwv/9Sf18I//9VYFIer/9YIMZb/11llw3//0BMa1n//0UkmWb//0kmN/Wf/08ruUX//1MOXM//VZZZZb//WXOTj/9drgEt//9Duc1//0YUg"
         "S5f/0iuTOX//00mZZb//1Flhzl//1SG8F//WjuxBf//XIU1f/9C7zDWf/9FiSYb/0llLMG//04EQz//Ug5UN/9WDRPF//9bjPEyzxf/XCECH"
         "Mf/Q/UsuYV//0V5LB7el/9KCjr//04Pt+Ixv/9T2gcyGP//Vd/a//8QAJxAAAgICAwEAAwABBQEAAAAAAAERIRAxQVFhcYGRobEgwdHw8eH/"
         "2gAIAQEAAT8QgIMNmH//0B1IngebNT//0VCCCWNH/9JE2cnhybHP/9NqIS8UK9Wf/9Sbgu9EU0UasZZ//9XZwil0bCzZuP/W2WWe4raNR//X"
         "Y22IEquBn//QSho8GrOZ/9FtwSkcbsOf/9JdYZIoW4/Mf//T7kOlndsnwf/UwaU81//V+JqH0MLy0f/WSP0INCR/6NQj/9dbPZzsfeP/0HsJ"
         "2JKIUi8//9Hag8cVrxf/0t9YfT8ERYf/0w2ZNJqGn0//1OLF/E+BqqEP/9VKEE51jE//1nVvE12TiyqOT//XLVWHS6wf/9DabTZCGPktP//R"
         "kTNhvxdcH//S0DF0kRHY/9NLE8EsQlJ//9SkoYaex6Y+2z//1eB4C6JIJ2o//9bZR0aEWoLX4NP/16XAju1mOA//0CdZOkKhGqg//9H3PQnR"
         "LkdH/9II5ZoNI8fD/9PY9nqLMCqjWf/UkSolei5mw3n/1dhvIjYUH//WZGF8tkqTNB//1212Mq5Y99H1h//Q0GsIC7P/0RKzkba5EmIP/9JZ"
         "hkYtpOxEjfR//9NUPk3G+ipjW9n/1OQlCp8C0QD/1UiDiPEF6tkSWf/WbYPUpH3P/9dtipiyb9l7o//Qt/TQaaGKCiR//9Frj/w5sfZqz//S"
         "Lj0Kn4Jyf//TLdE1GD6/h//USoIg07Psd6P/1WX0Y21J20TSf//Wnsk4LXRejUnB/9dUoNFI7k/8Dj2f/9DmVkXY1wQP/9FGxirAW+D/0rYN"
         "Z+wWP//TdvTUZdtjyf/UfomzXUr0/9WCGaxIRXofQ//WaZGo5HMXaP/XbwSf/Tlg/9DkITwpg9j/0arLFufxjvs//9JsQOxoZ//Tcy/RDCIB"
         "IP/UWBrjbhjccHI//9W0iuWN+mnoz//WdsdCwUrB/9d4o9j0ks9m5//Q1sR8Zf/Riuz4wt0Oqj//0otrNTuh9n//05D7OcyJTocKD//UGpws"
         "vhYf/9VH9KRY0Guyo//WWFT5FQUj/9dP2xCXYipH/9C/TPLCmoKKZP/RmC/o/Vm77Pmz/9Jd+EEXk//TlIrCsRqIRKUf/9Rn2M0hMxNAm/p/"
         "/9VNNHIx2xiMn//WRfBXwSSkVBE//9ePwURChV2f/9B9j7HIo25P/9EfGFmD/9KT6SYYdFEf/9P+ML0l1I5//9S5DjzA/o3p/9UYecNA5/Z/"
         "/9b0JmbTkHUn/9dxNYHiaP/QSx2D5Y//0WxrCIka7Gf/0mHHgex2f//T+xP0/gX9iif/1Kc0OpNzi3uT/9UHHEcdjP8A/9ZprBE2VEi1R//X"
         "BUFLHshqFFH/0Gv+sb+DdbH0Pez/0XcqB7kfQm4w/9Kh94OaJnwf/9PF1RJcPdxR/9R3wew/B0D/1Yo9Jj9Q84R//9aCRIE6NBok/9fuHsfS"
         "gfQ9n//Qmh+hvMElUjP/0aeMnLJQf//SZ4PwU6wuB//TarAkSZchU6P/1J6GpMr1i+z/1ecn2PI41TKP/9Z5Hc0NuCzY/wBz/9emRimGTcnv"
         "s//Q55wvs29j/E//0WHLBZ1i/9LsWHxOEfvP/9NmzlVHihvcX//Uf9DjNdjcjdI//9XgO0n5Oxkc3/T/1t1lxSL2ng//10X6JhAY/9BlwNH9"
         "FSfdgf/RS1wJ6F3SF8nQf//SeOxqUj/sQLP/00SMpjUZzs//1JTsRiO5Yj0Iz//VkhWyI3eH2f/WaDd/BXxdbP/X9y4pPfH/AP/Qf2TH5j7K"
         "vD//0cnuXgdKP//SCDtogx//0/IQxI/2OoRH/9RNlBoIDfij/9X1zfoJ42f/1gdreCWxpP/Xa+h/+yN+i+P8kfJ//9CbvZZse9DLPw//0R8y"
         "kSBdn//SWJ5PIX9i9IaP/p//03HD6wX7iP8A/9RXIwO2x8B0P//VfV0N/wCRuIwdDP/W9MPqJuRO/wAn/9dKRWNcfl+j/9ApkVC8CH//0eQx"
         "YQt8Y//S3oqIb7Ef/9NdsFfYugx//9RUwK+V/9XASRExKP/WXDKSCSLexaP/1y3axrclR//QtGJcDiPof//RcecrZPB6H//SYTwX7H6T/9NV"
         "psnY54Kf/9QlcJ/5IeDYf//VgFgqsVwxN0f/1n2OrJm8MDP/14BzONjo2V74P//QLhJiRdj/0VYQX6i5xf/SctQwt1h//9PwLMDEWH//1PE/"
         "PJZ0jZRK3R//1Zh/4PAhks0f/9apUayvWjmx/wD/11jQuz5/R//QsgjaZCf2LtH/0TxTOBd2eT//0jITy8eyEz//0+b/AAWOrwp6GdH/1P8A"
         "0NijWKo//9XFqXArUhN0f//WU+BaSi3g5Sfg/9eg8CF9lmhdn//QWyg+2LFdH//R3nMcUFzHfR//0oeMLmO2izR//9OEtuTkg4oFTiz/1JBQ"
         "LDxLdH//1R8OBHZCzcf/1qDcIIUP/9fzNpcLssc8H//Q6g/A1Y/Ix//Rfg0Vzh8Sg//S8Tzo7Mh//9OHjH5kRoP/1PicYxSL+fBT/9XlBf8A"
         "5NlEhJNWf//WwUTY+PB8n//XfkcV/wAGwvAv5P/QUXoUOCDFF2j/0cJ3nkfM/9KO4/0S+UH/0/KhRabH3BsP/9QZTZRBjf/V1NzWf9inA7aP"
         "/9ZU0KsxoTC6Gmj/1zo0TtHkXn//0PgLWhH9GL//0cIZYm+cP//S0YiBPgnyDaf/07GIkh1jA//UZayLHof/1UPizrFf3F//1kfkVCiD4iSO"
         "JEk7P//Xt0L5EyEWJs//0E3o5HL/ACcxRZ//0acVpg2rs0f/0nA7N8j3rH//0+RHwSplbP/UixfjLJPQ/9VeyREsXFEo7T//1pG4E/kY5G3J"
         "yo//12uW3gnTKjeT/9DYZL4xNH//0RMW9iX8EoZ//9KBVYnD4F7Fwk//01Dk9P6L1BdcQctn/9SUewrfRvHmT//VempOZ7EvOH//1tw1aHQ6"
         "o/B//9c/7ZzAhH//0EvRKqEujkmD/9E/4Hhlpbs//9IPQ9jZZOuj/9PgG4k3YknKf//UYchhtcD0f//Vw2Mmz//WQuhJEhKVEH//1/CIF4xx"
         "sRdkFo//0LNmiyo9cf8A/9H0NxWPzseZP//SF+cqS7s//9NORwjeGP/UeoY3YnrQrFo//9VLUCFeSIWf/9b2FLk7H5JHv+n2P//X9hcLsVxs"
         "J14f/9B5kaZZoL2Loz//0UUGOBn/0n/Rjwmf/9OT+YJLEicn/9R2Qo3WekFvo//VstkCPQ72UWf/1psb8d4zZ//XaxoweVIx/9DsM2h9SPR/"
         "/9HcDTEi2xOJLI//0towqM7GI//TaNYdXo1ejYP/1HtJj5vA5OBttH//1WqRLR//2Q=="),
        "d662a85784a021b7b45157bc4f4664de73e6103948745e6ee14d8a9cd2e08b8f", 256, 325),
    "progressive_grey_q75": (
        ("/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5"
         "PTgyPC4zNDL/wgALCAEYAQABAREA/8QAGgAAAwEBAQEAAAAAAAAAAAAAAgMEAQAFBv/aAAgBAQAAAAHzS0iLMHM7MzmVVV0vQhE6CYbGeOWk"
         "WjgjgiIiyimmlq0qUriItnLS3REBEAAAJ9D3tEAWOd2dRu6XAAgC1rUHOc5zOzMwRER9fd3eAFrBSlJVzGsazdLdBa1L+n3e3lgpa0pQlImb"
         "DNhMYS0pSn6/OzsEQEFJQlI6RaTDYw1qUpP1IiIZ27vLUlSR7uzTMyMQEA90FrWBtYbBUpSwEcHCIiLuzu9JKkpBz3veILWsAWCx3S3SIiJ6"
         "J0Trpqrqq4AWAKUpQd3drGNaxc00sy67brbdARBaUJSrOzua973STzTTLstuus1S1qWC1rDu7tY1jWyzzonXZbbbYKEIQHdncW7u6RaU6EoS"
         "Fdtlli5ZpZQYbDYRERYOCKlJUoarLLK0xRxRhQ99DjM2EClKUKlrWNVlldU0EEEA11110tYxjEzzTzaCwDKq6q6ZPP8AO87zhuuuurc1rWTy"
         "SSSkALDKKaKaJoYYYhssrsqa1jGJmmmn1YLAXPe5yZJZZcppopoYbGGtKUpwFrAGsY1i0JSjnOc5pkZmILEFgtaxIjIsAAHiNhkZEW73dilr"
         "WsO7e7d3d7u3uLd3TMjOda1rXg5gmxjGaIiOd29rGsa2dalqAREcNzWtIQwRzuzjY1jVqWpSwwRFjnucQiI4OYPExhs1SlKUAiIte99BYIiI"
         "iIiRmZuUlKlAICLaaKKGCOCIAADpGRVpSlKgABF1NVNLBzBFawWvS0t9FKkpUsFgDqqqamCI4AAsAzd3fXUtalpUlSm1U1UmAAAZmZ2dnZ7q"
         "wAFoRPOltNVFJqWpYaRbuYOD9DgiITSzSzspppp1KkpBjGMYIAIfTdnYMkckcp000U6idCAa9724tS1/V7pdkUMUMZ0U0UdPNPOqmmmmgVKS"
         "r//EACAQAQEBAQADAQEBAQEBAAAAAAABEQIQEiAwIUAxQVD/2gAIAQEAAQUCxjGMYxjGffLlKlc1q1VX51rGMYxjGMZ9xESpWrVqr861jGMY"
         "xjGfhESpUrWt+9axjGMYxjGfVRESpWt/DWsYxjGMYxniqqr5la1rW/drWMYxjGMYxiqqr51rWt+aqrVvjWtez2ezfirFixYxn46qqqxrWvZ7"
         "PZrfixYsWLGflvzjWrWvZ7Nb82LFixjPx35xatWrV6eyVKiJ4xjGMZ+O/OKtWr0vSdOa5rlynjGMYxZ5vzrU8RjFWrVq1L/ea5cuXP1VVV+4"
         "iIiqqrEn95jmOXLnxfGvZq3zjGPV6vV6pykREVVVYk/vMcuY5RVWrV6a3zjHq9Xq9Xq9WfFVVWJHLly5R06Wuqta3zjGPVj1erGfFVVVJ/eY"
         "5jlyn/OnTquq66SpURIx6vV6vV6rysVV+cSOY5cuU/507du66rnpzXLlzEj1er1Tl6rysVV+o5cuXL/zt27du3Lly5coiJiY/jp06dOvuJUq"
         "V7fzquq6dOo5jly5cpWtSp09lq1VX7iJUr2dV1XTp1EiIiVK1rXs9lq1VX8Naley1aqrEiIiVrWvZ7PZrfz1rXs1vnGM+Na1rXs1v561r2a3"
         "zjPjWta17PZrf/gTxEVV8X7iJ+8+qq/cRET/AA1VVfuIiJ/hqqq/cRET/Bqqqr9xERP8NVYsWLyxnxy5cuXPxrWt/OxjGLysWKviOURPOta1"
         "v54xjFixYq+IiIi+LWta388YxixYsVVRERFVatWtSon44xjF5dR1HTpURERVWrVrUqInxfjGMYsdR1HTpf8AsRERVWrVqVzUREVVVX//xAAU"
         "EAEAAAAAAAAAAAAAAAAAAACg/9oACAEBAAY/Agwf/8QAHRABAQADAQEBAQEAAAAAAAAAAQAQESAhMTBBUf/aAAgBAQABPyHGU7watcqXFr5w"
         "qWL9iIYhnn4SGrVrDhznn/nKLB+5HlzjmMYkkkzMynwT8zGLM53+L+xjGJJMzgpS5G3byzLg9PsYxjEhDgDDgIUzN5ZlwPXzGMYxg5AYYhCF"
         "IMMX8yLIb5ZrGLMkOQEwatYIhhhwWQZD2i3jXYANWrWCGGGG+JZmSYxwWs+opBi15J2ACc7hhw3jVrsCh7yiwHkkxjGsYkzxu3gMRBg+Tj0y"
         "iwHkkxjGuIk8N28ijAhHxU8sabnHkkkkhIQIQhg49x7/AJe7tsDCGcx5hRjDycFmscRZnpgyEQllMeIRxGPmL6Gt/kjF1FvgjB7QjGEfMFxO"
         "UgxG0YyHFsSbfAEOAAhD8EFjzCkIQnzkRkZkkmemAQhDKXLguAkIYPzmzi5mZJh7aYaWkJESlJk29vn1tdWlpkPi0tOAzMzH2fFZwdOZOClh"
         "KZp8Z54mZmZj7KWVPHCBkjzyUpSfGUWAmZmYhiGCeOEDIDBYClKQwNYuEmZmb+wxCGJrGSYQhDDEKU51vGpmZnG+yt2smuU54UgxBMzMzndu"
         "3DEQQSSWpJtc7hlDKXAcH8QQSSWpJLVq1wShhhmeA5Zt+8gLVqS1atSckQww9AZws9EbUlq1aktSTOCGGGHoDhm3b945jJaktWpJJJnJbhjo"
         "BmZxv3nzatWrVqSSZmcjbtwhyCNYkl/egLblmNaxZktWrXCYGseIgwfvNuWWYxzt41atWuEmMa8XDi/efcpcDHOGILVq1hwmRjx+Mb647nKX"
         "AP3gWBBJJMza5PyyghffX1Lgs94FgYPJJMGbXI+eaMer3OfFfrgeceQhwP/aAAgBAQAAABA44u5mokdh+aiAzFMjEvz4KlPTI1734b1Ur0Gf"
         "C7cMWYZmZUdA0S8Pr0MYydkJOpGDIY/HLLccUtbpqXmjw5e0RgmkwaQz517U3t5Cdk6dgpXdAcSfZmQhDyTsZu2/+UaoVyI+whv7UkIGv/8A"
         "spMny/8A2Usl3pL0nGqX59V+w1p8j1DMHCtSO6fpCbTz/8QAJRAAAgICAwACAgMBAQAAAAAAAAERITFBEFFhcYGRocHR8LHx/9oACAEBAAE/"
         "EEFLRBwKmD4jL8jg/Bw0MvqRBHeBjf0hihFqIme2DBZ8qjNZOZiDF4HaasjKlZE/5F5FahnQpsU9DglQ/I4UOg/8gZcGOw0UobjixmEoyfEO"
         "qySWiSToLb+xcv2KhMhFZXIgvNibgXmxWQ64G3XD4HiQ3B84nQnF9wxw1RfF6n5i6WSokJcGYlvsxgkfr9mR6FLQvH6FJY+j4CsOg24RDPMe"
         "IqMC6FKv0YoI8kOyMeKcfoc9ncbRA1Y0nrg1QQ7HCVJ6iviDAwPgZUSofkXpHkZjOJTJmLZU3HUkyPJQXkUXBokWN4FLhbPoiPAv7GXD+xSp"
         "shwW2RJOhX0JgVfh+4V9Dk7RNRDIot4Nh+ihHyHdz8+ye548x0EpFB643Ykr2PuN4Pke2OO8enQz0JeyQ+RkM8GYUyc8BqEFvAobFTkYeiLJ"
         "/tHziSMiWmNInaGuSWRiEZfoa9jnhidl5U8ZnZYyUSVw5CXj8TEoQNGcFGd8UqPcQSHQSWS0SzXFn9ICPdl+RTyZPvj9h5xkUm5yRf2eJllD"
         "zbQ4WJGqwOkITYhR8ENiH2Ms/wChzyXeBEGczEayZ7OxsniycmgnwN8HmTfya+DWQcKfozixPSE7yJ12KLyKopNQyQ6CDXFCqZSMgXBHs7Zg"
         "uingtB+oTtngWm48CIYtF4vSoSxuyaFxqCyK2c8D4EbNSRPhFw5SO+R90f6MeLUSilkbAkpEhRIgRB2hrZchqBXYiDMxbwI5ouMMfhly8jpk"
         "J6GeTgVtIwk+RfFYfZNMG41M6hiowD4VIvVcFUNGWRoiItk+yTZMLJJ4Z4PifAn0TxH5LVRA8EGiHRBDIILuWJkklmXgVKixaKUYHswF3JSy"
         "AiIt0QbHN5MMliJssogV7QvArYF5LakW0ChqiB4E6UEExdjGsCiVBP6bhjizHRhpjaIoosxmCnRBMlz0QTeCOWT7JPeC/AT0Lzk8DxF5PCHG"
         "SHKISg4GQgmCUlnouTxXJoxUVlwTI8TRFJeyx2jDck6VkkMSSaCrHBZg6l+jxPAg0bCGSlDQi4pNx5pXBxGMw0Y6LHwVnobJDJkI5UkkGOyS"
         "BZEUVLB5cXmWYPAh0RTWDxFieyJMwcipdCzIpCIUVoQGRbHoTnwQnZlgzNEx0XR6j068Jq2aWyDZSkQw8CMsiXyCXEsIrN4JW/BfXwy4bjsX"
         "owWYSOLLlk6eyaXJNtkkinNGIwleboRis9ymZh8Ge5J2yYmTHk6OKdGPFSnxIiOCJpSX5LtkmyRMsWOhjn+R5XweBB6EX/p3ldMxS69F+QkW"
         "SQ2FuJKO5dWRH+TP7MQqiOpGrfAn2iaf+DzJNRPItRRhFjiggwWIIVkgw+CPckuydEiHalYJIyZn5mZnKeSalCduD0PwnqLSRD7JF0xpRJJK"
         "Q6IhOKHfCzbE4k9RVzkVcl9kGi9SZLcep1IoxG494rZs+ZXZ8xS2KQpCkhOzO1RQiieiSEi/rhoL2L1fgurMNiasc9lrJLK5FpmeeP5jDehu"
         "Nklsbdk58Ht5HZNxPEpq1yrYsoSyQp7YpzImxN9iaVbJt8FRIIlCZEzwrgZoyGx5G+2N7dkw/RsM8cFkqPhPAZZHZ4DvRTRkQzCwKnA/RRmi"
         "Jyh3GvHIaxrY1wN/A3EjSM07LUHkc1FwzAOI5s8B5jL+JBSRAxk2OOYKO+eNBOGRkP8AgYbghUIbomxzWBBbJEhjIOLH1Q6H5R04Evg25ga4"
         "MBRng6RIEWixQ2yNY2h7GHJQbB8fgwQnggoKR+C0cR1ISiigSHwbSYn2xkIfSQCuGJZuZjeoe/RhvZGltDbVT9mAeYGlqjUW1kqwOR+Iy50M"
         "1zFRxL8mJnBlkTEzoEovY1z3x0GVDGUYPxEZCRcGsaIKQhqWBiC8jjJ+USroR9k2xEQTN5LEkjumIy+xZniaM54E2jzM9EBIuHSI0mUT9D4G"
         "wPEDkUcUZRfDZkdnZZjkx4HJjz4YekJFElfBKqRJqieaK8MQkRGWpEimLC3RqPhwOPg/EWMvlMoiWR44rtubFLDJXkajsMR9xwsaKOxuES54"
         "OdniUYKTN/RnM5mGqh8D44YJMRQT7ZksjIkKTXwyvJZC6IU6IRnQmjDFDcWJxWT4DV6OgRJwRSQzRG2UX5LR2NgekOxofhdozwzqwZBM/wAl"
         "uybZj/4Pa7GH3i8uKY4vAvIvApaFnKFcWsaI5Mn9EaYiHsWEUbKQThDUhtnZBkK3Z7ZMtl7hklGeprbINiyS8Gy0QSP8Q0JuT//Z"),
        "95fcc8848ae5f5940ca3049ceb9aed80721096ffb31a70caf86d309d8046ef8d", 256, 280),
}

# Pillow-made WebP files of `fixture_image(P12_SEED + 9100 + k)[::6, ::6]` (base64: lossy at quality 5 / 75 / 100,
# lossless at method 0 and 6, lossy with a gradient alpha (`exact`), a two-frame animation), with the sha256 of
# Pillow's RGB pixels of each and their width and height (Pillow 12.1.0, libwebp 1.6.0): the decoder phase holds
# both decoders to these digests on the card's machine, which has no Pillow
# Pillow-made TIFF files (base64; libtiff's own JPEG, Group 3 1-D / 2-D, Group 4, LZMA, ZSTD and CIELAB output, and
# files Pillow reads that it cannot write: ZSTD strips of libzstd at levels -5, 9 and 22, subsampled YCbCr, Group 3
# strips cut short, a JPEG strip that ends in an unknown marker, JPEG planes) and JPEG
# forms (SOF1, the baseline file patched to SOF9 -- arithmetic decoding of Huffman data, a bad code within the
# first interval --, and progressive files cut after their first or fourth scan, which libjpeg smooths), each
# with the sha256 of Pillow 12.1's RGB pixels, width and height: the card's machine has no Pillow
TIFF_PILLOW_FILES = {
    "jpeg_ycbcr_37x23": (
        "SUkqAHQBAAD/2P/AABEIABcAJQMBEQACEQEDEQH/2gAMAwEAAhEDEQA/AOOs9Pyoyua+jo1ux89GobtnYZI4Ir1qNbobxkLaWG7BIBPs"
        "K/I6NY9iMzdtbAcHbXq0ax0KZtQ6f8nTA+uK9OFbTU1UzkbSwJxlea66NU+JjNm9aWPIyOBzwK9SjV0N4z6iWen4HT2r8jo1j2Yzs7G/"
        "Z6fwMrx3PrXr0azNYTNqGwxH9zI7cV6cK2m50c5yNpYjI4HJFdVCqfERm7m5aWI4JA/xr1aVbojaMync3VhotslxfziCJnCKdjNlsE44"
        "B9DX5TgoVcRLlpK73Po8Hhq2LnyUY3e+6Xl19TLk+I+nQSBLDT5bsAkM8jiIexXgkg8nkCvr8HktWSvUny+mv+X4XPpMNw1XnG9aaj6K"
        "/wB+34XM+Txz4iumDRTQWyqoGyGFSD7/AD5Ofx7V9Rh8pwkI2acvVv8ASx9DRyDAQjaUXJ923+lj/9kADQAAAQMAAQAAACUAAAABAQMA"
        "AQAAABcAAAACAQMAAwAAABYCAAADAQMAAQAAAAcAAAAGAQMAAQAAAAYAAAARAQQAAQAAAAgAAAAVAQMAAQAAAAMAAAAWAQMAAQAAABcA"
        "AAAXAQQAAQAAAGsBAAAcAQMAAQAAAAEAAABbAQcAPgIAAEwCAAASAgMAAgAAAAEAAQAUAgUABgAAABwCAAAAAAAACAAIAAgAAAAAAAEA"
        "AAD/AAAAAQAAAIAAAAABAAAA/wAAAAEAAACAAAAAAQAAAP8AAAABAAAA/9j/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkSEw8UHRof"
        "Hh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2wBDAQkJCQwLDBgNDRgyIRwhMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
        "MjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjL/xAAfAAABBQEBAQEBAQAAAAAAAAAAAQIDBAUGBwgJCgv/xAC1EAACAQMDAgQDBQUEBAAA"
        "AX0BAgMABBEFEiExQQYTUWEHInEUMoGRoQgjQrHBFVLR8CQzYnKCCQoWFxgZGiUmJygpKjQ1Njc4OTpDREVGR0hJSlNUVVZXWFlaY2Rl"
        "ZmdoaWpzdHV2d3h5eoOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4eLj5OXm5+jp6vHy"
        "8/T19vf4+fr/xAAfAQADAQEBAQEBAQEBAAAAAAAAAQIDBAUGBwgJCgv/xAC1EQACAQIEBAMEBwUEBAABAncAAQIDEQQFITEGEkFRB2Fx"
        "EyIygQgUQpGhscEJIzNS8BVictEKFiQ04SXxFxgZGiYnKCkqNTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqCg4SF"
        "hoeIiYqSk5SVlpeYmZqio6Slpqeoqaqys7S1tre4ubrCw8TFxsfIycrS09TV1tfY2dri4+Tl5ufo6ery8/T19vf4+fr/2Q==",
        "6120184221db539c8e170c000e921077a3597c1e1ec903108b3ac5576c37f575", 37, 23),
    "jpeg_rgb_37x23": (
        "SUkqAB4CAAD/2P/AABEIABcAJQNSEQBHEQBCEQD/2gAMA1IARwBCAAA/APG9OtztUkD16c1zcOkZXDLn9K19D+6AoB6etdRYWhYg9M89"
        "e9X4NL5HBHfPc/5/rXpGitnaCQMdO1dPp9uX2nZlia0YtJDEZwT1wBnOa+SNEbdycE8Z4FdTZ2xIHynd3q9FpIOCF/z/AJxXpGikDAz0"
        "Of1ro7a2BTk7B6E4x7VoJpBxwnH+9iu/sOLcbl+lfPdjbtxwRz2NQQaVuAynJHpWPog3Y6nuCfWup0+2JKsQMHkAd60ItLG7DAkLzwK9"
        "H0PoMjnPSun0+22kDABHY1oQaScZ2nHA6Yr5F0T5QudvPXPWum062BySAR0JHfitCHSemUOAeSRXpmibiqgj6100FuFjHGB+NXY9K+TI"
        "jDDt8oNeg2AC2wBJPb72K+e9PtzuGACDjioYtLXj5VAJHTvWLoQAKAkZPPTtXTafbLkkgHnHPr/nFX4dLHBIUf1r0fRSDsA4JOeK6rTr"
        "YErgYPXioNd1XRfCVhHe61eC0tZJREjeU8mXKkgYUE9FP5V8j6I2SD+NdNYW42g/LwOuOled6r8fNDs7hYdG0O61JQzK0s8ot1IBwrJw"
        "xIPJ5CkcccnHpWiMMg8gY5x610tvAhi5Qk+xrhr74zeOtQnV7a9s9OjRAvlW1ojKTkncfNDnPI6HHHTrXoGmqTbYULgd8kZr/9kLAAAB"
        "AwABAAAAJQAAAAEBAwABAAAAFwAAAAIBAwADAAAAqAIAAAMBAwABAAAABwAAAAYBAwABAAAAAgAAABEBBAABAAAACAAAABUBAwABAAAA"
        "AwAAABYBAwABAAAAFwAAABcBBAABAAAAFgIAABwBAwABAAAAAQAAAFsBBwAhAQAArgIAAAAAAAAIAAgACAD/2P/bAEMACAYGBwYFCAcH"
        "BwkJCAoMFA0MCwsMGRITDxQdGh8eHRocHCAkLicgIiwjHBwoNyksMDE0NDQfJzk9ODI8LjM0Mv/EAB8AAAEFAQEBAQEBAAAAAAAAAAAB"
        "AgMEBQYHCAkKC//EALUQAAIBAwMCBAMFBQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGhCCNCscEVUtHwJDNicoIJChYXGBkaJSYn"
        "KCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6g4SFhoeIiYqSk5SVlpeYmZqio6Slpqeoqaqys7S1tre4ubrC"
        "w8TFxsfIycrS09TV1tfY2drh4uPk5ebn6Onq8fLz9PX29/j5+v/Z",
        "fc78f193d2b43f28b4bd68308a9167f2212f404ee5162298543e0ef801799e81", 37, 23),
    "jpeg_cmyk_37x23": (
        "SUkqADACAAD/2P/AABQIABcAJQRDEQBNEQBZEQBLEQD/2gAOBEMATQBZAEsAAD8A9j1G4G5gCfTrxXRzavhsq2P1rH1z7xLEjr6V8/1y"
        "9/dhQR1xx07VQn1Tg8g9sdh/n+leb60uNxAJz170VzGoXATcN+FArOl1YqDjIHTJOMYr631tdvAyBzjk0Vy15cgE/MNvaqMurEZBb/P+"
        "c15vrQJycdRj9KK5y5uSH4G8+oGc+9Z76uM8vz/u5rgL/m4O1vrRX0JfXC88g8dxU8+q7ScPwD61sa2dueg7ED0orltQuQAygnI4JPas"
        "+XVDtypALccmvONc6nB4x1ormNQudwJySD3FZ8+rDONwzyeua+utb+Ytjdx0x0ormdRuSMAEg9QD25rPm1bk4cZI4ANeZ63tDMQfpRXM"
        "z3BaQ85P4VSk1X58GQqe/wAxFefX5LXJIAHf7uaK+hNQuBtOSQRnmppdUbn5mJAPXtW1rpJDkA4HHXvRXM6hctgAEjjPHp/nNUJtUPIB"
        "Y/0rzjWgRvJ5AGOaK5XUbkgNk5HTmp9C0rWvFt/JZaLZm7uo4jK6+akeEDAE5YgdWH519ca2uAR+FFczf3B3EfNyemeteiaV8A9cvLdp"
        "tZ1y101iqssUERuGBIyyvyoBHA4LA888DPmutqcEcE54z6UVzVxO4lOHAHuK7mx+DPgXT4GS5srzUZHct5tzdurAYA2jyigxweozz16V"
        "5/qTAXOWLZPbAOKK/9kLAAABAwABAAAAJQAAAAEBAwABAAAAFwAAAAIBAwAEAAAAugIAAAMBAwABAAAABwAAAAYBAwABAAAABQAAABEB"
        "BAABAAAACAAAABUBAwABAAAABAAAABYBAwABAAAAFwAAABcBBAABAAAAKAIAABwBAwABAAAAAQAAAFsBBwAhAQAAwgIAAAAAAAAIAAgA"
        "CAAIAP/Y/9sAQwAIBgYHBgUIBwcHCQkICgwUDQwLCwwZEhMPFB0aHx4dGhwcICQuJyAiLCMcHCg3KSwwMTQ0NB8nOT04MjwuMzQy/8QA"
        "HwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0Kx"
        "wRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZ"
        "mqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3+Pn6/9k=",
        "9dce4f20e9ca4022951aa460c909f326a3f52ceb99fd825d8b655a8dc3ffbfb5", 37, 23),
    "group3_1d_64x40": (
        "SUkqADYBAAAAEDIi4YAIGRFwwAQMiLhgA9EFF1AfwAeiCi6gP4APRBRdQH8AE1uqUUXFShAAmt1Sii4qUIAE1uqUUXFShAAmohAY61hw"
        "ATUQgMdaw4AJqIQGOtYcAEigSlFxeACRQJSi4vABIoEpRcXgA9REUFSihgA9REUFSihgA9REUFSihgAmsXE6IKEACaxcTogoQAJrFxOi"
        "ChAAwJwfrUrABgTg/WpWADAnB+tSsAE1KC1DxEQ4AJqUFqHiIhwATUoLUPERDgA9QUURAkXIAHqCiiIEi5AA9QUURAkXIAE1oooE1uor"
        "ABNaKKBNbqKwATWiigTW6isAGCiT1KlCABgok9SpQgAYKJPUqUIAE1oIgoouoohwATWgiCii6iiHABNaCIKKLqKIcAHriigouKCHAAkA"
        "AAEDAAEAAABAAAAAAQEDAAEAAAAoAAAAAgEDAAEAAAABAAAAAwEDAAEAAAADAAAABgEDAAEAAAABAAAAEQEEAAEAAAAIAAAAFgEDAAEA"
        "AAAoAAAAFwEEAAEAAAAtAQAAHAEDAAEAAAABAAAAAAAAAA==",
        "942f4b81cf970d7f5ea689ccb22d289d5500786b726191425304589cd543f5e8", 64, 40),
    "group3_2d_64x40": (
        "SUkqABgBAAAAAYGRFwwAAX4AAYGRFwwAAR6JBQR6BEP4AAH0QUXUB/ABf/ABmt1Sii4qUIABf/+AAZrdUoouKlCAAUiECOCBqAABmohA"
        "Y61hwAF/wAGRQJSi4vABf/ABkUCUouLwAR6yRAogjRMMAAH1ERQVKKGAAX/+AAGaxcTogoQAAX/gAZrFxOiChAABAyJwIEC2AAHAnB+t"
        "SsABf8ABmpQWoeIiHAABf/ABmpQWoeIiHAABHowRiBGIBmIHAAH1BRRECRcgAX/+AAGa0UUCa3UVgAF//wABmtFFAmt1FYABA+J6BmpU"
        "AAHBRJ6lShAAAX/4AAGa0EQUUXUUQ4ABf//AAZrQRBRRdRRDgAEMEeKCBeDBYAoAAAEDAAEAAABAAAAAAQEDAAEAAAAoAAAAAgEDAAEA"
        "AAABAAAAAwEDAAEAAAADAAAABgEDAAEAAAABAAAAEQEEAAEAAAAIAAAAFgEDAAEAAAAoAAAAFwEEAAEAAAAQAQAAHAEDAAEAAAABAAAA"
        "JAEEAAEAAAAFAAAAAAAAAA==",
        "942f4b81cf970d7f5ea689ccb22d289d5500786b726191425304589cd543f5e8", 64, 40),
    "group4_64x40": (
        "SUkqAJwAAAAgZEiPD//PRIKCPQIh////8msDNQECBGIGSoaP/////IhAjgga///iYgREoaJ4h///+eskQKII0TD////8msIggZ6GDX//"
        "/BkTgQIFv//8ESgGdQ5iJF///89GCMQIxAMxA/////k1uCBA5uBGJ/////g+J6BmpX///8EaAZILMQM0AgS/////+MEeKCBeDBYAIAIA"
        "CQAAAQMAAQAAAEAAAAABAQMAAQAAACgAAAACAQMAAQAAAAEAAAADAQMAAQAAAAQAAAAGAQMAAQAAAAEAAAARAQQAAQAAAAgAAAAWAQMA"
        "AQAAACgAAAAXAQQAAQAAAJMAAAAcAQMAAQAAAAEAAAAAAAAA",
        "942f4b81cf970d7f5ea689ccb22d289d5500786b726191425304589cd543f5e8", 64, 40),
    "lzma_rgb_37x23": (
        "SUkqAHAJAAD9N3pYWgAAAP8S2UECAQMBACEBFnkgxO7gCfgJLl0AABBEAMlGp2cfvPUwGq3upkNRRfUOiJa55oSlh0Q9EFsZ/PnlT2mc"
        "8drtPCKLRG/8Sbye0HSPShWJP0uWGm03WkYyWnyDTJn7qe45ZnVJBAJ7gcCWhhYTdWD5N8ZAIpkZ40MzjBQTtgcqb2rZixeDOPcgd4Fb"
        "B7WA8Z7VBZNTBpOwL+i0NonrHle7Cv0XmIOqtiYCdO+IAyu9sEXcH0XX2EWDaLYqjPV1GhOVx9bI2j1ssGvHp6Pv/zTWS61Nn04Lknoo"
        "NMnwCPKdxlKssvFPoDBBFQdIYpdMOnBBeeNWo+eGxbkMxq8De9Jjb5cOQGdiMDko20yynIL6WCEhQK37u9/V186l9o2fm83Kn+3XHK8v"
        "K0vj7az9VZEiK+5po148CluIit5bpdMb7jgEwry9szpRiRc3IFYa9Sf5nWjJj7yL5agyRawg6+ZojGstc9vdU6Op4vCKC3gbDTy6LZih"
        "Q+msXbMAtzpgPOdvgy40JCVhlp0TiIEnaFAV6nv7TGt76hLmg7b9VD3UJOX9KFoYmJ6Bp6VlKX9jcXowSXJpLc5IFaZSxk5IBDESM4vX"
        "TNGUxixmxt8qODfRsjcW3+/gW45weuhc77u3LTpCg/ecPG0Ari0pj6HWC1tFCY4dT8G9N9gZIlt5akQEyBqNLIRuo5PXULL8q1Afv3gf"
        "WJuTTPFxICq0C6YCfAtV2zqlbudV8BOypaXwaK9C6pYa1APciubz3nhhnOcECCl4fwEBLCxPH3NqJmbkfThLA1+N4wp8XposoRZbLs6Q"
        "pJSysVyx7LaPPG+bnWa1er4FrFyR+PX1WjLy/CLBE8dzj8gba7p8GvH+KQW8NdlXESfXBaBLBoABrJh53IavYd52jgIJe6c9lRF3ROBB"
        "C4e4YuCltfZyzf3J2azCNBWM/o5D5ppAFs3y2a5k0zEzsyX3VPlv7gMVcS+06aRfoDfHHXYjcRsXsMPSS5DbMA5FQu8so0063rAPFw6T"
        "/yWADmYFSn2tcc9OtfmLmzUg2UtQXEaCOO3ONLb1Dv+ZS+lpQ9gmomcHtFQIVLjZOLg2FABDbpykmIxSPAIQCSGrGZCeajulzH68+yMj"
        "mz3FM2D0B5rwmBQWpOc5HTmjqzCsOXnfpbfkegt8Fc6IG2p+CNYrA8KUrnpKZY4whrtuimpJrR7rImrLj/ao678gbbLnw35riCpNn1oQ"
        "kNHdH/kRrY4MmP8WDA4NvPB6kst3trG77BjXtwpi7VEH+LsbHPOogMqXIE9EOquUjTv0839QI5uB13B0V/QqGIt/VRMDqClUsu7xizzc"
        "wRWtyZH/cIDvCoYdySDhfQDkVIPmoNznRZkmhhVm7UGZc4CQjKqhuGSDI5h0ciuOGGyBumOWUCV1T0oAsIwT53I32qIrqVEjAi9WwicU"
        "LiIOJJizFjxfK+s/by9ZqlZQ1IsVXFDPsIw7CN5wmQ46SuAjfejd0WKIWepnCMQWTJEevELotZzP65R8K8Fka4mE8xQcnqDVPLbP8wRN"
        "oyHg+5RYQIe/B/gDb5ebs4BJAK16tU3USkZj9UNmfnTtZ3SiQztgoi9f6+06NBjwiRo0h4SvsdG+UBANC22vs1/lrR2/Lklw8wWFktzZ"
        "48kP7UW/NM+7Tzh4W270fqhJEwOPTmi/rd0hhildIPgb/Omt04Kbwe9O+xc369v3teVoElSnj/5MztDOBKw9ryFHTGm4A0gPBGy+ci0S"
        "vtnXHIC7I5cS5+OjAwGXqrs0yph1PaOPSFT6EoJlYzgiKh12ZTqo15wSeqCLCW/cp13T0lkhle/BYw/SbCjaenvh9dJ6wEvtoyHlxK+J"
        "MWKtvIc9Q6ANn+16e5ulS112hYHswtJISwevcystHRoTm5K5HX83MvGCXf8iZYlc7oC0AEzhE/QjKVAHljUSNhzHAbtMFdKnlgSybS/D"
        "wA88XC6+LhgGyQ7XUCQD+fRyNlKdUbfM9/XBh36+SKo4+DbIdIIrzeUockRUkTdJKdYtLv7gYgBoYSvGwLc/BsqSrh2jAVYwkcokJP/r"
        "FNPyhvdhb2Rj8ncELPRDuCeQlh6Rc1MR5ypeUjLTrLLA4+fEd0myU7KnKcItrcMHNFyl2B2hl+aYYXdHE/jroI9UldruKWkzLmRdhFEO"
        "bSesVZiKNjqis4z39rcqkwmjyHEDkHCkpIFBchdo3fHCb2o8pSHv9DI8Bl0HtRYIsUMTMwfWfuJlwjpd7U4bEVTPvY55DjkhFEabmFqd"
        "PjBEFvgQbnAOiw6qR2gV1yqaRnTXwrIg9WTVou9ULJBUG79ZyW158ReqW/TS8zzFEJoU3LWDxMY5sXfKhLZS/qLG6MEPYlVAKuoJZQ47"
        "H+9G/NS7XGylpGwrzVa/JBb5Zk5nfianecfE4+KzoJITGil+E/ERjLcwJMgEQa5+t/iY8R1ngezxwBDUyL/NTdgX5hLkCS/Au9zYLn4n"
        "bQSOKGU/lcDDU4bz0ExNMhaNDkRNWG1pIWSk7v3tOJnTKibTTG7Xj/Hh/uQy+2M99aUHF1WEEv/fHEWyV/Y35qXu59qHCQgeiV9VvznJ"
        "eOYsq1QFj+nxIO684P4ht7Kiz+cB9bnvawF53uJ08x3stQPTwAhJu7twTQK3IOCyzlshchSJp/lpme4kMBQ1+DqC1jJlXg76/VFYi808"
        "DWGQvmj72XYIBSLbqaO6S7XjR2r5TAG3I5xPjO2u8DfcmuXvLMgGuT0hD7G5V/6eEi0cAGGWc1lWAD1xF6HO3UGxWOo2z78He8vM6pFZ"
        "GJJb1xTEwqDHMzw3QYfx7TLiYduwWq20hVL9+mH+ykLafO1DR5w5QfxPLEVxJl5geiVPkjkADOg6VrBr8AMLM5vVX9oI2W2qGi0747Is"
        "9GUgXmbQtEce772dDNJUnj6UDmLrmvo/HKGBWdrlQFP3K64bvwGtaSn0/YsmwCB3kVwf7iJpGS8pu+rZ0GiVwm3L+ZiZDdpMm6zbZwe3"
        "IIa411CtODrY1tNEy2OV7MetB9XrqMA/J7eFf3/dDy/b4sAlVInwm2yxOmWeY8oBkPFii7ODJUrk5hFYO+W5LdZCxiFDiVNNTdePhN/D"
        "NNEaY+dK/eZDfUryZ6wFCvAYCvlvdkcVr/bQaO+r/lmNVY+l3S83es/GgY3Y5Cu6AAAAAAABwhL5EwAAhOtbYKgACvwCAAAAAABZWgoA"
        "AAEDAAEAAAAlAAAAAQEDAAEAAAAXAAAAAgEDAAMAAADuCQAAAwEDAAEAAABtiAAABgEDAAEAAAACAAAAEQEEAAEAAAAIAAAAFQEDAAEA"
        "AAADAAAAFgEDAAEAAAAXAAAAFwEEAAEAAABoCQAAHAEDAAEAAAABAAAAAAAAAAgACAAIAA==",
        "f0d27abfd4fe2f7f40982421bd48808c944a0260b7d41ff859af646b08b9ac1e", 37, 23),
    "zstd_pillow_rgb_40x30": (
        "SUkqACIOAAAotS/9AGCBcAAAJVACLlQINl8QQWINQmkaR3QgTXwfVIMmVo0qaIwwZpc4bJk4cKQ/bqpBgLNMfbhOi8NZjMNYj9Bbnddmnd5n"
        "peV1p+xpru9yu/l4v/9+ygiKyQyOzw+KzyGS2hya1yqk5TGh6j2s70Cq+ES1AEm1AEu+CFXFEmUFK1UNL14PN2EPO2gVQXMZSX0aTnsnWYok"
        "YY4uaJgzapk4aqU/cqpCfLNGfL1RgL1XhcdYlctils9in91opdhyrOtyqfB5ufNyvf17xAWCww+IyBCU0heU3iOV5CWj5TWh7zOn8Des+0ez"
        "+ki8CEzBCFzCC2LIEGIIOVgJNGQOO20VPnEVTXYkVoIpUIouVpErYZQ1aZswcqZEcq88fLRLhLFOhsFLjMpTlM9gmNFfnOBfo+Jnruposu9w"
        "t/R9v/93xASEwwuKzwyN1B2S2yiZ4iac6TCb6zuj8Tmm/0es/U2uA0+8B1rCC17AGWbPHXEKOWEINmkSPHEZRXobUYMbWIYmZIwoZ5Q1Yp86"
        "baM9dKhAdLVIgLRHgcVRisJWkMpWl9Vcl9Vjo+ZorehstfRur+92vP6BvAR/zRiCyRGEzBiT2SaV2Smd2jOc7DSj8D6u+Uqy/kmzAVOxCVnE"
        "C1/CFGbJFGzVJ3cNPHINSWkKTHYbToAiUogiX40rXpUuZqA6aqM1aao9drVAerJNg7pJjMNVj8tYk9VdnOFgoeBioulvr/RrsPRwt/95vAyH"
        "wBB/zhKI1RyE1h+U3SqY7S6X6jOb7D6s+0au+E2vAVW1AF64EWO5FmjFHW3AInPVJHwOQXcXR30cS34bVocmX40mU5MyYpgwa6Exbas5crA9"
        "erxHh8FIkcROlMZTlNpbntljoOpcpfBsqudysvpnufR0twZ9wAyEzxaK1h2L1SGU1CSV4zGX6jqj7juk8Tuj/E6wAFC1C1e0B2C/Emu/HG/F"
        "HHLIHnzTJIYTPncWUX4YVYUZWJIhXJkmZJgwaaU2bKs9b7E/dLZEfsJMjMhIk8tRlNRaltpcm+Nnn+ZjqPVtr/pysv55vgKCwwh/yhZ9zyKN"
        "ziKP3SSY6i+a5zmf7Tqi90Wm+kqyAFGtCmGwB2G7DmG+GWzFG23MIIDLLIfaMooVTYAaUoUfVZImWZsha5wraKE4b6k2fbAzfrtBg81NksVP"
        "idBVj9hSltpXq+BkpepupPRnsvJvuP5ywQZ6yhN4xROJ0h6N0yeK2SaO5jGb6DOh5T2f7T2q+kqx/1WwCle5CWa7E2nAF3bEHHnMJnXJIIXI"
        "MoLaK40ZUIscWI0hXJQkYZ40Z6Y5cqw1cak8erNEeb5Lhr9HidVOjNRUltdVmelcm+pppOljrPdmtv9xuQJ1uwt6zRV90RmD0x2I1SiN3SyT"
        "4jSX6D6e8Eun9Eyl+EmpAV+2Clu4DGXBFG7DIHPLHYHHKIrYL4nYMY3XNpsbUY0iYpYoYp0uaKAwa6Q2bLMyc647hLs8gsZIi8xOktlSkNdc"
        "ouNZqutip+5erfpwsvtxuAVxxQt6yxZ7zx+G1h6F3CeJ2zSV5Tej7Tya8Uae+1Kq+VSlA1y0C1a7Fmm3D2+4GXfFJ33JI3vSK47UNpXeP5/a"
        "OpscV5YnYJwibKUrbqsycLUye7c8fr06gsA/itFJjthPlNxZmeVapudepvFgr/Zrs/92vAZ0wAh5xBp+zBt7zSeC1iWO3yuR5jeX7D2f7kSc"
        "80qr/VOpAGSsC2K0D2mzGHPHHHvBHIDEIYLGLYnYMZbYN57aOaHlQKYeYZ4sXqEtYqgpZ7Qxc7E7fr5AgMJAi8xNjNpYktxVmuJWoeRgoe9e"
        "qvForfdzuAVyvwp2xBV8yRqBzxyD1iGG3yqV2jqU5zSW6kWa90+e+1CsAFm0D1uzAma6D3G+HHrFH33CIoTMLJDUKY3VNpjbPKThQq3mS60g"
        "Y6YjbaoqcLkyeL83fMA6gso8hM9EjNNHltxPmehcm+daouthsf1ktf1ouQVqvwx2vxd4yxt70B2A0ymH3TWN5DaY6zyS6ESb9U2g+lmlAFO1"
        "BGKwEmuyDWq3HXPBIHzII4LJJYvSLpDXOZfgO6LaQqbkSbLnSrYiZKUparMwdbE0drw9gMQ/gctFj9hEl9xTnuBSnOxZn+1VsPpbs/9gtgZs"
        "wQpsvxN2yhF5zyOE3yuJ4TKM3jOO5TqR6UeU8kye9Uyf/0+uCmGnDWqyC2+xGHTAGn29HIHIJIvKK5PPMZbVPZ/WOa7mRazhSrLpUrolcbA3"
        "crg2froygMhFiM9Ii9VDidtLnOVWl+VXoe9kr/1lrP9ouAlsvg5vyhhvzxl60CF/yi6C2CmM3jeO5j2T5ESW8UOa+Feg+2CiDF+zCmCqE3Ky"
        "E3e7G3rIHIjDK4bKLZXRNaLROaTWR6neSLLgSrHhTMDvVsIucbM1d8U7e8FDh8dEjdtLmNtAleRUnuZZnvJaqvlirv9gtABmvAd5vxRxxRN5"
        "zh981CWC1SyF4TiF5jyV7EST9U+b81Od91ulAF+lCWGvEnS3FnGyIX3BKYW7KYnHJpLKMJfYN5/XP6PbRrHgTbbmT73lWMrsXsMye7s4esU0"
        "hdI/hMxMlN9LlN9MnO9PpPFfqPlcr/9luAFytA9nxRZ1xB50zR960SJ90yiH4jyK4zyP7UiS8UqT+E6c+VekAGSpBmSxDWmpE3mzGYC+IoK9"
        "K43IMpTKLpHXNaDUPK/URbPaUK/kUr7rVcPtXsvwZc8vfcY3hcJBhNY+kuBJk+RPn+lSnehXo/tZrf9irwhougxruxJyxBt1wyV60yJ91jOC"
        "2DaK4jqQ6UKU6k6T8FKh/1OiAF6kCWynEGuwGXW2F3y0IYa/J47CLJDBMZfONqHWQqXVRaXaS7zgTL7jVcfuXsbvXdP9Z9szf9Q7hNU8jNxK"
        "kN5FmedVpOpJpfdcq/9lswVjuxZsuhpuyBd3yiVyzyZ9zjKG3DeG4zuC6UeR8UWN9Vab+VmZAmCgBGaoCnGuEHW2Gn+8Ioa4IIbIJY7HM5jS"
        "O5vWO6bWO7HgTrbfRLbmU7/xYcrrU831a9n5bOI+gcpDkN9GkeBEkedGp+9Qp/5Ur/5cpgdguRJotA5tvhlxzSZszSR91jKA1jmE4TuL5kiQ"
        "8k2T7lia9Feg/1+iA2eoDHOnDnu4FIO2GH26I4/CI5i/KZ/ONJ/ROqDSQrHQSLPeQ7rhVb/mV8zqXtTvauD3a9/3beU6idZAkuFFlOhLp+5N"
        "qPFZpf9XqQRfqw5muxFoxRpxyCh4ySdv2jOA2jKE3T2G30OQ6k6Q9FWb+FqZ/1qeAGieBWapEG+rDnmrIX62JIXGJpO9KZnGMZ/QPaXSOanQ"
        "RrjXR8LdUrziWcvmWdbxZdnwbtr9b+T/cO5FiuE/nOpHlPFRovZRrfVUqwRftRBmuw9kxhxxyCNx0SdzzCd71jR83kmI4UKI7kiM8FmP9Vue"
        "/GGeCWigCW6tEHenHXyzGIK5HoLBKZC6MJTJNZ7KN6jIQq7ZRbLcTL3gUsHkWcTmXdfuXd7xa9z4beL7de8Cefc/l+VIpvVIpfJJqv5ZtApW"
        "tg1htg5nwB1qvyNrzihwzC142DR+3D196USI5lGN7FmT816d+F+XAGaeB2+kDXSuF32tGny2II27I5G5MaDCLZ/QOp/ROq7SQ7PPSrvXS8Lg"
        "VcnrW8zrY93radjsbuX8cukAg+0Afv9Anu9Knv5Ppf9PrAZVsQpethpfuhpfxB5rwTF1zip00jqA4z2B3UqI6FGH7luT9leS/1yWB2efAnSp"
        "EG+oEYCyHIavIpG3IYvAK5nAK6fJOqvKQa3KQrPaRbrgU8PgTsfgXM7nY9PzZNX1ZOjzc+z/evYDcP4LfwFKo/lIrvZasAtUtQNWvRJgwBFu"
        "yCVtzSxw0C542TF/1Tt740h/4kqM7VKT81aR+lmUA2WYAmuoDHynEnepEH62JYW2KZu0KZnCMJ7GO6fLPazPPbLPP73TTsbgWsfhVtDqWtjz"
        "YNv4Zufycef7bvUAe/8DfQIJiQVGpP9VrAlPpw5SuxFYvhhlvCJlyCln1C5t0jl02jp530SA5VKI61CE9lyR+l6a/2KjDG6dDXagEHqrFYqo"
        "IJC4I5m3KJu7LJy7NqDOPK7KP7rRRLXOScrbR9HlV9LkZtnsY97wZuf0cPT0d+3/gPYCfwANiwcOkQ5JqwVUtQxXrhRdtR1dwBxdyilw0TFy"
        "1jd30z9530KD6U2A6lKQ9FiP+WKX/2GbBXKZB3WeDnqrFYGxGoa3HJG0JprALKC/Nai/NrTNQLnRQ7/RSsbYWMXdT8/mXdXpYt3wcODpbuz5"
        "dvP7hPMAfwIJig0JkQsRkBNOrA9auhphtiBgzB5mxS9kyTFs1TV91jh12EWG5U996U+B9VOL9F6P/2OTAnSYBG+pC3ieE4apHouuHo6yI5m9"
        "LJm8MqnFOKvFRbPLTLrNR7/UTsrdWtDfY9LkXtvrZN/0bev5dfb/gPwAewcIiA4NjQcLkhUKkhpXtxJRth1gwSRivi1ozDFq0jJz3EFv4ER9"
        "5UyC6FGH8mGR+WKP9GeVA26XD26dEX+lFYemG4mzHpC4KJu5LZ63LKbFN6rDPrLRPr3QU8bQVc3aU9DdYdfkZd3qbeLscun2cvT6e//2gAAF"
        "hgwNiwcNkxQOnBkgmyNTtRlXwyNkxydqzSpizzht2UeB30F15kl861B+9V2L/V6I+2WPBW+QCHmeEIGkE3+kGYeqG4irK5S8KKa6MaW9MLDJ"
        "PLLGSbnXS8TXUNDaV9TgUd3mYNvmaubuY+/sbff6dvn+fAAHhwoSiRUJjxYRmBwQmSYfny4ACgAAAQMAAQAAACgAAAABAQMAAQAAAB4AAAAC"
        "AQMAAwAAAKAOAAADAQMAAQAAAFDDAAAGAQMAAQAAAAIAAAARAQQAAQAAAAgAAAAVAQMAAQAAAAMAAAAWAQMAAQAAAB4AAAAXAQQAAQAAABkO"
        "AAAcAQMAAQAAAAEAAAAAAAAACAAIAAgA",
        "4c64e41b30da16bdf0b6773bb5992ea3e6d25b95538a385b5627c8022343dc69", 40, 30),
    "zstd_pillow_predictor2_grey_40x30": (
        "SUkqAPoCAAAotS/9AGBNFwC6SngLM0BTkg5VYzt1jWU2R1H8yGisSrLlpn6ezxXpv5nCIJEB3nhTdPvt5We2kb2llDLJJOUmAaUAqACqAHib"
        "DrvkqFEtvbsEmWiKCT+cp5y17zKcv8+G0uf82QgBun5SVtD61xRE6ULR16WNB19fbigaEWilT32kDk/OKnmEgWkp5/3WTjpaHgsPALBLT/B+"
        "bSI2QS2QBBGZP0vttOxYFScGUp0eta8fr16xt7URbTVe/unoPRWwWQazdrfuGYw6SQ+9fyWapZEh2k9g04AcGqo0Zxl3zO81b6EyNMj3NJof"
        "EOW1PHza+YIz65mKrScjLal0TOwUIoQslPanBrOMhh/eJS9X5YR4reidWkt8UGmnaT6aoHr8TPJ6zrsQW3zHrDsPHSBezZb32DggXqPh724a"
        "P/vwaUfNrEHWaTrpjxOO+aho8CUDX4l/2qHvyiCHpqYFcZykYKrsltGoIWpzESXVRMr2WhacUaxMUwvm9I42L/YCT81pW1OJ6t0V1EryDl3h"
        "yHVrFZEojL/lHaNmzdC4tHw4gVa73/OWtjfXAlFbnTr58bsCT1oP9TuF6UwnFTxSjk3wcc2n9URmYRNxbijbG5XhHbOarfTQUxTToHQ0LSp+"
        "EaUWDCagxoJsdBhL1Qnq0RTQ1Hdcp/UYm87hD+QYxUqzaeeNXkpYzFe7rSx1gZjWavQ4+nm3k7xm5X2crSZivtNiOA+VjkKTcPfxNCvtbw9i"
        "c7XaqdFk8bSTQ7/OCGsBWmmO4oVewVXOiaf8Y7YaJGne6FGO++F4o2CRNt5aLWeUnOgfYpDkrYISCGM7IxT36QcnqD+9WjvlkVZlMd9Ki7J0"
        "MC8J3ckxkuz51PF3elPhPsqm8UFEyXK4U0JNbRbZrnNbPk3BcPzxWJl2S44ZIrQFCrvj0zlVppougGLIgPjHpEkzZDQxLoKGCdU6VMnBMqo1"
        "3jrm42lNi9e3vJBfiJQibYhrxjpGnWaPHg8BAGaQBUMFCgAAAQMAAQAAACgAAAABAQMAAQAAAB4AAAACAQMAAQAAAAgAAAADAQMAAQAAAFDD"
        "AAAGAQMAAQAAAAEAAAARAQQAAQAAAAgAAAAWAQMAAQAAAB4AAAAXAQQAAQAAAPICAAAcAQMAAQAAAAEAAAA9AQMAAQAAAAIAAAAAAAAA",
        "2caf25be97e54efc0b7d9265a97fed57a502a09e7823ef32a238ee53a9d1660d", 40, 30),
    "zstd_level_minus5_rgb_40x30": (
        "SUkqAEAOAAAotS/9AEgBHgAAJVACLlQINl8QQWINQmkaR3QgTXwfVIMmVo0qaIwwZpc4bJk4cKQ/bqpBgLNMfbhOi8NZjMNYj9Bbnddmnd5n"
        "peV1p+xpru9yu/l4v/9+ygiKyQyOzw+KzyGS2hya1yqk5TGh6j2s70Cq+ES1AEm1AEu+CFXFEmUFK1UNL14PN2EPO2gVQXMZSX0aTnsnWYok"
        "YY4uaJgzapk4aqU/cqpCfLNGfL1RgL1XhcdYlctils9in91opdhyrOtyqfB5ufNyvf17xAWCww+IyBCU0heU3iOV5CWj5TWh7zOn8Des+0ez"
        "+ki8CEzBCFzCC2LIEGIIOVgJNGQOO20VPnEVTXYkVoIpUIouVpErYZQ1aZswcqZEcq88fLRLhLFOhsFLjMpTlM9gmNFfnOBfo+Jnruposu9w"
        "t/R9v/93xASEwwuKzwyN1B2S2yiZ4iac6TCb6zuj8Tmm/0es/U2uA0+8B1rCC17AGWbPHXEKOWEINmkSPHEZRXobUYMbWIYmZIwoZ5Q1Yp86"
        "baM9dKhAdLVIgLRHgcVRisJWkMpWl9Vcl9Vjo+ZorehstfRur+92vP6BvAR/zRiCyRGEzBiT2SaV2Smd2jOc7DSj8D6u+Uqy/kmzAVOxCVnE"
        "C1/CFGbJFGzVJ3cNPHINSWkKTHYbToAiUogiX40rXpUuZqA6aqM1aao9drVAerJNg7pJjMNVj8tYk9VdnOFgoeBioulvr/RrsPRwt/95vAyH"
        "wBB/zhKI1RyE1h+U3SqY7S6X6jOb7D6s+0au+E2vAVW1AF64EWO5FmjFHW3AInPVJHwOQXcXR30cS34bVocmX40mU5MyYpgwa6Exbas5crA9"
        "erxHh8FIkcROlMZTlNpbntljoOpcpfBsqudysvpnufR0twZ9wAyEzxaK1h2L1SGU1CSV4zGX6jqj7juk8Tuj/E6wAFC1C1e0B2C/Emu/HG/F"
        "HHLIHnzTJIYTPncWUX4YVYUZWJIhXJkmZJgwaaU2bKs9b7E/dLZEfsJMjMhIk8tRlNRaltpcm+Nnn+ZjqPVtr/pysv55vgKCwwh/yhZ9zyKN"
        "ziKP3SSY6i+a5zmf7Tqi90Wm+kqyAFGtCmGwB2G7DmG+GWzFG23MIIDLLIfaMooVTYAaUoUfVZImWZsha5wraKE4b6k2fbAzfrtBg81NksVP"
        "idBVj9hSltpXq+BkpepupPRnsvJvuP5ywQZ6yhN4xROJ0h6N0yeK2SaO5jGb6DOh5T2f7T2q+kqx/1WwCle5CWa7E2nAF3bEHHnMJnXJIIXI"
        "MoLaK40AKLUv/QBIAR4AGVCLHFiNIVyUJGGeNGemOXKsNXGpPHqzRHm+S4a/R4nVTozUVJbXVZnpXJvqaaTpY6z3Zrb/cbkCdbsLes0VfdEZ"
        "g9MdiNUojd0sk+I0l+g+nvBLp/RMpfhJqQFftgpbuAxlwRRuwyBzyx2BxyiK2C+J2DGN1zabG1GNImKWKGKdLmigMGukNmyzMnOuO4S7PILG"
        "SIvMTpLZUpDXXKLjWarrYqfuXq36cLL7cbgFccULessWe88fhtYehdwnids0leU3o+08mvFGnvtSqvlUpQNctAtWuxZptw9vuBl3xSd9ySN7"
        "0iuO1DaV3j+f2jqbHFeWJ2CcImylK26rMnC1Mnu3PH69OoLAP4rRSY7YT5TcWZnlWqbnXqbxYK/2a7P/drwGdMAIecQafswbe80ngtYljt8r"
        "keY3l+w9n+5EnPNKq/1TqQBkrAtitA9psxhzxxx7wRyAxCGCxi2J2DGW2Dee2jmh5UCmHmGeLF6hLWKoKWe0MXOxO36+QIDCQIvMTYzaWJLc"
        "VZriVqHkYKHvXqrxaK33c7gFcr8KdsQVfMkagc8cg9Yhht8qldo6lOc0lupFmvdPnvtQrABZtA9bswJmug9xvhx6xR99wiKEzCyQ1CmN1TaY"
        "2zyk4UKt5kutIGOmI22qKnC5Mni/N3zAOoLKPITPRIzTR5bcT5noXJvnWqLrYbH9ZLX9aLkFar8Mdr8XeMsbe9AdgNMph901jeQ2mOs8kuhE"
        "m/VNoPpZpQBTtQRisBJrsg1qtx1zwSB8yCOCySWL0i6Q1zmX4Dui2kKm5Emy50q2ImSlKWqzMHWxNHa8PYDEP4HLRY/YRJfcU57gUpzsWZ/t"
        "VbD6W7P/YLYGbMEKbL8TdsoRec8jhN8rieEyjN4zjuU6kelHlPJMnvVMn/9Prgphpw1qsgtvsRh0wBp9vRyByCSLyiuTzzGW1T2f1jmu5kWs"
        "4Uqy6VK6JXGwN3K4Nn66MoDIRYjPSIvVQ4nbS5zlVpflV6HvZK/9Zaz/aLgJbL4Ob8oYb88ZetAhf8ougtgpjN43juY9k+RElvFDmvhXoPtg"
        "ogxfswpgqhNyshN3uxt6yByIwyuGyi2V0TWi0Tmk1kep3kiy4Eqx4UzA71bCLnGzNXfFO3vBQ4fHRI3bS5jbQJXkVJ7mWZ7yWqr5Yq7/YLQA"
        "ZrwHeb8UccUTec4ffNQlgtUsheE4heY8lexEk/VPm/NTnfdbpQBfpQlhrxJ0txZxsiF9wSmFuymJxyaSyjCX2Def1z+j20ax4E225k+95VjK"
        "7F7DACi1L/0ASAEeADJ7uzh6xTSF0j+EzEyU30uU30yc70+k8V+o+Vyv/2W4AXK0D2fFFnXEHnTNH3rRIn3TKIfiPIrjPI/tSJLxSpP4Tpz5"
        "V6QAZKkGZLENaakTebMZgL4igr0rjcgylMoukdc1oNQ8r9RFs9pQr+RSvutVw+1ey/Blzy99xjeFwkGE1j6S4EmT5E+f6VKd6Fej+1mt/2Kv"
        "CGi6DGu7EnLEG3XDJXrTIn3WM4LYNoriOpDpQpTqTpPwUqH/U6IAXqQJbKcQa7AZdbYXfLQhhr8njsIskMExl842odZCpdVFpdpLvOBMvuNV"
        "x+5exu9d0/1n2zN/1DuE1TyM3EqQ3kWZ51Wk6kml91yr/2WzBWO7Fmy6Gm7IF3fKJXLPJn3OMobcN4bjO4LpR5HxRY31Vpv5WZkCYKAEZqgK"
        "ca4QdbYaf7wihrgghsgljsczmNI7m9Y7ptY7seBOtt9EtuZTv/FhyutTzfVr2fls4j6BykOQ30aR4ESR50an71Cn/lSv/lymB2C5Emi0Dm2+"
        "GXHNJmzNJH3WMoDWOYThO4vmSJDyTZPuWJr0V6D/X6IDZ6gMc6cOe7gUg7YYfbojj8IjmL8pn840n9E6oNJCsdBIs95DuuFVv+ZXzOpe1O9q"
        "4Pdr3/dt5TqJ1kCS4UWU6Eun7k2o8Vml/1epBF+rDma7EWjFGnHIKHjJJ2/aM4DaMoTdPYbfQ5DqTpD0VZv4Wpn/Wp4AaJ4FZqkQb6sOeash"
        "frYkhcYmk70pmcYxn9A9pdI5qdBGuNdHwt1SvOJZy+ZZ1vFl2fBu2v1v5P9w7kWK4T+c6keU8VGi9lGt9VSrBF+1EGa7D2TGHHHII3HRJ3PM"
        "J3vWNHzeSYjhQojuSIzwWY/1W578YZ4JaKAJbq0Qd6cdfLMYgrkegsEpkLowlMk1nso3qMhCrtlFstxMveBSweRZxOZd1+5d3vFr3Pht4vt1"
        "7wJ59z+X5Uim9Uil8kmq/lm0Cla2DWG2DmfAHWq/I2vOKHDMLXjYNH7cPX3pRIjmUY3sWZPzXp34X5cAZp4Hb6QNdK4Xfa0afLYgjbsjkbkx"
        "oMItn9A6n9E6rtJDs89Ku9dLwuBVyetbzOtj3etp2Oxu5fxy6QCD7QB+/0Ce70qe/k+l/0+sBlWxCl62Gl+6Gl/EHmvBMXXOKnTSOoDjPYHd"
        "SojoUYfuW5P2V5L/XJYHZ58CdKkQb6gRgLIchq8ikbchi8ArmcArp8k6q8pBrcpCs9pFuuBTw+BOx+Bczudj0/Nk1fVk6PNz7P969gNw/gt/"
        "AQAotS/9AEiBFgBKo/lIrvZasAtUtQNWvRJgwBFuyCVtzSxw0C542TF/1Tt740h/4kqM7VKT81aR+lmUA2WYAmuoDHynEnepEH62JYW2KZu0"
        "KZnCMJ7GO6fLPazPPbLPP73TTsbgWsfhVtDqWtjzYNv4Zufycef7bvUAe/8DfQIJiQVGpP9VrAlPpw5SuxFYvhhlvCJlyCln1C5t0jl02jp5"
        "30SA5VKI61CE9lyR+l6a/2KjDG6dDXagEHqrFYqoIJC4I5m3KJu7LJy7NqDOPK7KP7rRRLXOScrbR9HlV9LkZtnsY97wZuf0cPT0d+3/gPYC"
        "fwANiwcOkQ5JqwVUtQxXrhRdtR1dwBxdyilw0TFy1jd30z9530KD6U2A6lKQ9FiP+WKX/2GbBXKZB3WeDnqrFYGxGoa3HJG0JprALKC/Nai/"
        "NrTNQLnRQ7/RSsbYWMXdT8/mXdXpYt3wcODpbuz5dvP7hPMAfwIJig0JkQsRkBNOrA9auhphtiBgzB5mxS9kyTFs1TV91jh12EWG5U996U+B"
        "9VOL9F6P/2OTAnSYBG+pC3ieE4apHouuHo6yI5m9LJm8MqnFOKvFRbPLTLrNR7/UTsrdWtDfY9LkXtvrZN/0bev5dfb/gPwAewcIiA4NjQcL"
        "khUKkhpXtxJRth1gwSRivi1ozDFq0jJz3EFv4ER95UyC6FGH8mGR+WKP9GeVA26XD26dEX+lFYemG4mzHpC4KJu5LZ63LKbFN6rDPrLRPr3Q"
        "U8bQVc3aU9DdYdfkZd3qbeLscun2cvT6e//2gAAFhgwNiwcNkxQOnBkgmyNTtRlXwyNkxydqzSpizzht2UeB30F15kl861B+9V2L/V6I+2WP"
        "BW+QCHmeEIGkE3+kGYeqG4irK5S8KKa6MaW9MLDJPLLGSbnXS8TXUNDaV9TgUd3mYNvmaubuY+/sbff6dvn+fAAHhwoSiRUJjxYRmBwQmSYf"
        "ny4ACgAAAQQAAQAAACgAAAABAQQAAQAAAB4AAAACAQMAAwAAAL4OAAADAQMAAQAAAFDDAAAGAQMAAQAAAAIAAAARAQQABAAAAMQOAAAVAQMA"
        "AQAAAAMAAAAWAQQAAQAAAAgAAAAXAQQABAAAANQOAAAcAQMAAQAAAAEAAAAAAAAACAAIAAgACAAAANIDAACcBwAAZgsAAMkDAADJAwAAyQMA"
        "ANkCAAA=",
        "4c64e41b30da16bdf0b6773bb5992ea3e6d25b95538a385b5627c8022343dc69", 40, 30),
    "zstd_level22_predictor2_rgb_40x30": (
        "SUkqAFoJAAAotS/9AIhFEwCmO5cnoCfpUhLSWqdVVVVV1bd8FfrlL2J8Dy+Cc1ojhOwtpUwppZRSSknKiACMAI4AqXrlIImoy9rjE4sqV0dB"
        "psUYsm5Kqq/lbUeGOzYTSawrVFETLI5H8VSC7wTbL3kNyWLp68jJ+KOyOOOrLpJja2QEAfLwdW4jJPmx1eWbTIscJVY8I8jiFHGZflVUP33r"
        "YA0tlyW/6M4tUv6RZfpGmKp9JKb8ShcC3XZ3sern2ZLu+Vmx7QAAEkbJbiu1hLLyKyvR9DtuQSwvfMTQMfaMYXEIB6XkjcOKBjOM5nkwS4j+"
        "EtZM7YeyluFDLvfw8xWHz9T8LWlj3cvqnJQCAf5oMFKI+ohMTZUidEr5bfme2v3NQ14xuutkNjyfTE4s/GxLDFyGJ5lb02GX2EhfaILwrVj2"
        "+7Sa3JCmjTQI3vamUZQEApgEru92RxSd/H8v1n4ansQvcqWg6bVjlFuNq+yqG6vdCHUa9kGCVSEPTYaD8XJGIGmn5yWPG8ZMdivdKg2jDoj2"
        "96+CqdoMCqC2BE1Frsksebheyl02GRuHN8y08MDf48rCtw0tIKKT/ZukLP6cLrYyHY/PdC+4T8L7w7sUh+b5eHUewrhuh3NJ4ZAFA84nAs+A"
        "SIh1NKSF8yUezHMzVtuvzz3nCStPanb+4NLUBf8ciEKdZu4zygox+HJvOJqQtolVX8EWDINI9CUtUrwnkxeEonHPZQMDCafGmpXILbb/R/ZJ"
        "usMVqyYP369oerI/bYaRdZhUaJNmo1m8zHWjF4ffaWrdpW8Xith4Zpre6ulJX5yLfK4s2iaOAYFEAgA4LjBFCNw0ACi1L/0AiH0TAHb7mCyA"
        "S9IBcu/NhgUzMIPQMEGKEsQ4UyI4L2NEuUB6kNY1sgnZW8qUUkoppZSkDI8AigCJAAsGKIni7fum4FYKqpHYjz4oit8FH+yJKYQcHTUkG+co"
        "LWxda7/xvLYm43pOIkiVW5p5QYgrhWlVG706KdHJKsdRPDvVNdqJjaBAgJELzaxN9CvGwomsud1M6QSgcUF1sBOvK3K+JZoiniPZhnfPfgYv"
        "Vqdji9w513UL4JST9hd777IU/WRFeN5iGh+EBAECfhUaFDCdrYpUP51lYeS+t9xtJ/y0j2HZwZ3GQfSEibNFWojk6L5cM81M/cTcZfzrubU6"
        "yovpGyf5G7RM7wtilMriucWYwIBA7p8Zq0mILDLLS7NgdPBei6z+EqfaD81ljVUV7Wkj1YvOcjgRTEO1/Y2fbW7Q0ul0VF30BOeh0nN747Zq"
        "3SjRfgkBFh4cYGbNRCHEoZxGepq85vxoS9uRaaX6vgfkj/NjzrMv4e3aWW4tGfFInnpvZfDRXuZpSijnFqmFeyCvZOgeY+8/qH4NXQoODOA5"
        "tI67eOv9zO62o7d93ohcibWRHIhYaKLMTs3LQvfPKvJFl5aHyN6gVWNEg4cci6uWJXTcfsicZq53MJX5uMUPuqnXmuamsYi8eI306wWhWTAf"
        "6JMFWdFubbCZ0VDxt2JFYBqEbo+qHmpeuiGdYlmPKkVedJBJa4deMphfBz2KWEFFdC88QGBuHHaWWR9OIw1N4j1s1ZEYJx13GkZaw1GJlbA+"
        "dVhc6ValshnqiXFpkXz+pHF0qejobDmGkdyPSd4VrCrRu2WFYYqhxQcJAgA6ESPDCO4ZKLUv/QCIzRMABnydLYBL0gF7bxaJGQE0zwiaABkD"
        "AnqAMYEZmFvCIIVgPECiJW3vLaVMKaWUUkpSpo4AkwCQAOwqLbP6u+8YHaBptxCxZ9pcJ4/13Zdd1LvXnurzxhhDoS5kkFfR+U4id8qRvq57"
        "1Ry+9mn0o9BcyyVSNO9KAbA8YbbgoADucZ+8NY4nr9hmrGJsUpKz+9/r9K/6oSJy2TTTcpvGNQcPeZo5AIbruUM1vXipRT6oJJ1uXYXxOHwH"
        "G7OlONLE+vSJL63QwEB6bBlGKHkxnUyJ24U6uiBsjJ69saq0scTjBC6sCJ+FWhkPvy7dTy5RptzzuHaqkcUWycD3TBb8CuwQbIyGOQs4a4sx"
        "F8DICxAStEFEwK/DxKtvYw3ESoW/2Rsev6vFediSLKs7o+or69nt5VAhmCxsIE1wLVWj9SYX6rSiDq5GeFFuVkUyHu6P7sVBtWxMMoYHBwKM"
        "m/j07KJujRV4bhEVfw8P0V/8GE8Dd4R6NlVdoEwTvUntbDJd4+QhBzXZiEMB2CRnWxxs25PSL0sX+RvLrbdUviK4JSY0SGDg5rhJptehf0Nj"
        "c+LVzRppweQocuXWC6HOsfepMF9O/y9pyqTtkvjr9u96zh8uQxASYplV1+3njvXDiYtS0JmjCt2T35ohAoJnMINAX4TGorBzDMrdVYYLa6V7"
        "hxo7a9BoZaa8Jxa/KvqOmLVQnhb9jNkrYeS69jdNmEPQgWtEcoWC0M3QHNmYumtm0zDnQGGBxMIQQcQjpVmoIWynv95rmFfJNoYZS2olbagF"
        "LxHtdavdU7V3lydMeq6yZlJ+02rURZxLpmF0neFq7O8oyA+URll2GL1hgoIAKLUv/QCI5Q4ABi12JaApHXKTTTJZVRX/w50DAACc4Bfy/+/+"
        "1vb33lLKlFJKKaUkpQxtAGkAawBIPt7xYSTVmI1QpW8w5aXrmYf3mWZCm4wztacncKkwnI/WYHBJD52rXEubZyTN02bsbpyTVB/4yKjBRNmP"
        "uYsZRoBmB9QypGhLHNGGqe+WoS6/Qg3VanhjrxndbTYBXu38YFSRjAEEsDxbMCAE3Jit+e9DSbPQMpLY4tZynq52imxrd40epq90DHdTTe3L"
        "I83UXZWbh1ii2JQ9mzqSZ3n3S4iX1ES8AcpNe9OrvLj1T4eD1bPpvV33L9Yoxz7MhfdoB/FlaiAXJTddY2kAujmIKFsfor8E77mnkB5GTpCa"
        "hPbQVNhZRzzzknMdNg7vowiX9oL2j28MgIiFNG0lW2Su4leOvj5n6kbdVhI10tS/mwraVVYGaSPaTP8nnsn8XzzRmygok8N8/OaY0CCFq0Sh"
        "ijsJJkbIkoUygqaN/ZWOh4Ssh5+mzUcpHr1/ryLqxc56we+GHdoMxb2U5lGyakEpfbvWDGBJEnIOUlbDTpmX33HfZcthpRxtLq8EQwUO/4Uq"
        "ThVR+cICCAVvANlHsVGSkx4nG9/4xjdRsirurjvmi0wPtDeLl+EvbuzyBAAACwAAAQQAAQAAACgAAAABAQQAAQAAAB4AAAACAQMAAwAAAOQJ"
        "AAADAQMAAQAAAFDDAAAGAQMAAQAAAAIAAAARAQQABAAAAOoJAAAVAQMAAQAAAAMAAAAWAQQAAQAAAAgAAAAXAQQABAAAAPoJAAAcAQMAAQAA"
        "AAEAAAA9AQMAAQAAAAIAAAAAAAAACAAIAAgACAAAAHoCAADyBAAAdAcAAHECAAB4AgAAggIAAOUBAAA=",
        "4c64e41b30da16bdf0b6773bb5992ea3e6d25b95538a385b5627c8022343dc69", 40, 30),
    "zstd_level9_checksum_rgb_40x30": (
        "SUkqAFAOAAAotS/9ZMACAR4AACVQAi5UCDZfEEFiDUJpGkd0IE18H1SDJlaNKmiMMGaXOGyZOHCkP26qQYCzTH24TovDWYzDWI/QW53XZp3e"
        "Z6Xldafsaa7vcrv5eL//fsoIiskMjs8Pis8hktocmtcqpOUxoeo9rO9AqvhEtQBJtQBLvghVxRJlBStVDS9eDzdhDztoFUFzGUl9Gk57J1mK"
        "JGGOLmiYM2qZOGqlP3KqQnyzRny9UYC9V4XHWJXLYpbPYp/daKXYcqzrcqnwebnzcr39e8QFgsMPiMgQlNIXlN4jleQlo+U1oe8zp/A3rPtH"
        "s/pIvAhMwQhcwgtiyBBiCDlYCTRkDjttFT5xFU12JFaCKVCKLlaRK2GUNWmbMHKmRHKvPHy0S4SxTobBS4zKU5TPYJjRX5zgX6PiZ67qaLLv"
        "cLf0fb//d8QEhMMLis8MjdQdktsomeImnOkwm+s7o/E5pv9HrP1NrgNPvAdawgtewBlmzx1xCjlhCDZpEjxxGUV6G1GDG1iGJmSMKGeUNWKf"
        "Om2jPXSoQHS1SIC0R4HFUYrCVpDKVpfVXJfVY6PmaK3obLX0bq/vdrz+gbwEf80YgskRhMwYk9kmldkpndoznOw0o/A+rvlKsv5JswFTsQlZ"
        "xAtfwhRmyRRs1Sd3DTxyDUlpCkx2G06AIlKIIl+NK16VLmagOmqjNWmqPXa1QHqyTYO6SYzDVY/LWJPVXZzhYKHgYqLpb6/0a7D0cLf/ebwM"
        "h8AQf84SiNUchNYflN0qmO0ul+ozm+w+rPtGrvhNrwFVtQBeuBFjuRZoxR1twCJz1SR8DkF3F0d9HEt+G1aHJl+NJlOTMmKYMGuhMW2rOXKw"
        "PXq8R4fBSJHETpTGU5TaW57ZY6DqXKXwbKrncrL6Z7n0dLcGfcAMhM8WitYdi9UhlNQkleMxl+o6o+47pPE7o/xOsABQtQtXtAdgvxJrvxxv"
        "xRxyyB580ySGEz53FlF+GFWFGViSIVyZJmSYMGmlNmyrPW+xP3S2RH7CTIzISJPLUZTUWpbaXJvjZ5/mY6j1ba/6crL+eb4CgsMIf8oWfc8i"
        "jc4ij90kmOovmuc5n+06ovdFpvpKsgBRrQphsAdhuw5hvhlsxRttzCCAyyyH2jKKFU2AGlKFH1WSJlmbIWucK2ihOG+pNn2wM367QYPNTZLF"
        "T4nQVY/YUpbaV6vgZKXqbqT0Z7Lyb7j+csEGesoTeMUTidIejdMnitkmjuYxm+gzoeU9n+09qvpKsf9VsApXuQlmuxNpwBd2xBx5zCZ1ySCF"
        "yDKC2iuN2SUp5Si1L/1kwAIBHgAZUIscWI0hXJQkYZ40Z6Y5cqw1cak8erNEeb5Lhr9HidVOjNRUltdVmelcm+pppOljrPdmtv9xuQJ1uwt6"
        "zRV90RmD0x2I1SiN3SyT4jSX6D6e8Eun9Eyl+EmpAV+2Clu4DGXBFG7DIHPLHYHHKIrYL4nYMY3XNpsbUY0iYpYoYp0uaKAwa6Q2bLMyc647"
        "hLs8gsZIi8xOktlSkNdcouNZqutip+5erfpwsvtxuAVxxQt6yxZ7zx+G1h6F3CeJ2zSV5Tej7Tya8Uae+1Kq+VSlA1y0C1a7Fmm3D2+4GXfF"
        "J33JI3vSK47UNpXeP5/aOpscV5YnYJwibKUrbqsycLUye7c8fr06gsA/itFJjthPlNxZmeVapudepvFgr/Zrs/92vAZ0wAh5xBp+zBt7zSeC"
        "1iWO3yuR5jeX7D2f7kSc80qr/VOpAGSsC2K0D2mzGHPHHHvBHIDEIYLGLYnYMZbYN57aOaHlQKYeYZ4sXqEtYqgpZ7Qxc7E7fr5AgMJAi8xN"
        "jNpYktxVmuJWoeRgoe9eqvForfdzuAVyvwp2xBV8yRqBzxyD1iGG3yqV2jqU5zSW6kWa90+e+1CsAFm0D1uzAma6D3G+HHrFH33CIoTMLJDU"
        "KY3VNpjbPKThQq3mS60gY6YjbaoqcLkyeL83fMA6gso8hM9EjNNHltxPmehcm+daouthsf1ktf1ouQVqvwx2vxd4yxt70B2A0ymH3TWN5DaY"
        "6zyS6ESb9U2g+lmlAFO1BGKwEmuyDWq3HXPBIHzII4LJJYvSLpDXOZfgO6LaQqbkSbLnSrYiZKUparMwdbE0drw9gMQ/gctFj9hEl9xTnuBS"
        "nOxZn+1VsPpbs/9gtgZswQpsvxN2yhF5zyOE3yuJ4TKM3jOO5TqR6UeU8kye9Uyf/0+uCmGnDWqyC2+xGHTAGn29HIHIJIvKK5PPMZbVPZ/W"
        "Oa7mRazhSrLpUrolcbA3crg2froygMhFiM9Ii9VDidtLnOVWl+VXoe9kr/1lrP9ouAlsvg5vyhhvzxl60CF/yi6C2CmM3jeO5j2T5ESW8UOa"
        "+Feg+2CiDF+zCmCqE3KyE3e7G3rIHIjDK4bKLZXRNaLROaTWR6neSLLgSrHhTMDvVsIucbM1d8U7e8FDh8dEjdtLmNtAleRUnuZZnvJaqvli"
        "rv9gtABmvAd5vxRxxRN5zh981CWC1SyF4TiF5jyV7EST9U+b81Od91ulAF+lCWGvEnS3FnGyIX3BKYW7KYnHJpLKMJfYN5/XP6PbRrHgTbbm"
        "T73lWMrsXsMbJHz9KLUv/WTAAgEeADJ7uzh6xTSF0j+EzEyU30uU30yc70+k8V+o+Vyv/2W4AXK0D2fFFnXEHnTNH3rRIn3TKIfiPIrjPI/t"
        "SJLxSpP4Tpz5V6QAZKkGZLENaakTebMZgL4igr0rjcgylMoukdc1oNQ8r9RFs9pQr+RSvutVw+1ey/Blzy99xjeFwkGE1j6S4EmT5E+f6VKd"
        "6Fej+1mt/2KvCGi6DGu7EnLEG3XDJXrTIn3WM4LYNoriOpDpQpTqTpPwUqH/U6IAXqQJbKcQa7AZdbYXfLQhhr8njsIskMExl842odZCpdVF"
        "pdpLvOBMvuNVx+5exu9d0/1n2zN/1DuE1TyM3EqQ3kWZ51Wk6kml91yr/2WzBWO7Fmy6Gm7IF3fKJXLPJn3OMobcN4bjO4LpR5HxRY31Vpv5"
        "WZkCYKAEZqgKca4QdbYaf7wihrgghsgljsczmNI7m9Y7ptY7seBOtt9EtuZTv/FhyutTzfVr2fls4j6BykOQ30aR4ESR50an71Cn/lSv/lym"
        "B2C5Emi0Dm2+GXHNJmzNJH3WMoDWOYThO4vmSJDyTZPuWJr0V6D/X6IDZ6gMc6cOe7gUg7YYfbojj8IjmL8pn840n9E6oNJCsdBIs95DuuFV"
        "v+ZXzOpe1O9q4Pdr3/dt5TqJ1kCS4UWU6Eun7k2o8Vml/1epBF+rDma7EWjFGnHIKHjJJ2/aM4DaMoTdPYbfQ5DqTpD0VZv4Wpn/Wp4AaJ4F"
        "ZqkQb6sOeashfrYkhcYmk70pmcYxn9A9pdI5qdBGuNdHwt1SvOJZy+ZZ1vFl2fBu2v1v5P9w7kWK4T+c6keU8VGi9lGt9VSrBF+1EGa7D2TG"
        "HHHII3HRJ3PMJ3vWNHzeSYjhQojuSIzwWY/1W578YZ4JaKAJbq0Qd6cdfLMYgrkegsEpkLowlMk1nso3qMhCrtlFstxMveBSweRZxOZd1+5d"
        "3vFr3Pht4vt17wJ59z+X5Uim9Uil8kmq/lm0Cla2DWG2DmfAHWq/I2vOKHDMLXjYNH7cPX3pRIjmUY3sWZPzXp34X5cAZp4Hb6QNdK4Xfa0a"
        "fLYgjbsjkbkxoMItn9A6n9E6rtJDs89Ku9dLwuBVyetbzOtj3etp2Oxu5fxy6QCD7QB+/0Ce70qe/k+l/0+sBlWxCl62Gl+6Gl/EHmvBMXXO"
        "KnTSOoDjPYHdSojoUYfuW5P2V5L/XJYHZ58CdKkQb6gRgLIchq8ikbchi8ArmcArp8k6q8pBrcpCs9pFuuBTw+BOx+Bczudj0/Nk1fVk6PNz"
        "7P969gNw/gt/Aa91SfwotS/9ZNABgRYASqP5SK72WrALVLUDVr0SYMARbsglbc0scNAueNkxf9U7e+NIf+JKjO1Sk/NWkfpZlANlmAJrqAx8"
        "pxJ3qRB+tiWFtimbtCmZwjCexjunyz2szz2yzz+9007G4FrH4VbQ6lrY82Db+Gbn8nHn+271AHv/A30CCYkFRqT/VawJT6cOUrsRWL4YZbwi"
        "ZcgpZ9QubdI5dNo6ed9EgOVSiOtQhPZckfpemv9iowxunQ12oBB6qxWKqCCQuCOZtyibuyycuzagzjyuyj+60US1zknK20fR5VfS5GbZ7GPe"
        "8Gbn9HD09Hft/4D2An8ADYsHDpEOSasFVLUMV64UXbUdXcAcXcopcNExctY3d9M/ed9Cg+lNgOpSkPRYj/lil/9hmwVymQd1ng56qxWBsRqG"
        "txyRtCaawCygvzWovza0zUC50UO/0UrG2FjF3U/P5l3V6WLd8HDg6W7s+Xbz+4TzAH8CCYoNCZELEZATTqwPWroaYbYgYMweZsUvZMkxbNU1"
        "fdY4ddhFhuVPfelPgfVTi/Rej/9jkwJ0mARvqQt4nhOGqR6Lrh6OsiOZvSyZvDKpxTirxUWzy0y6zUe/1E7K3VrQ32PS5F7b62Tf9G3r+XX2"
        "/4D8AHsHCIgODY0HC5IVCpIaV7cSUbYdYMEkYr4taMwxatIyc9xBb+BEfeVMguhRh/Jhkflij/RnlQNulw9unRF/pRWHphuJsx6QuCibuS2e"
        "tyymxTeqwz6y0T690FPG0FXN2lPQ3WHX5GXd6m3i7HLp9nL0+nv/9oAABYYMDYsHDZMUDpwZIJsjU7UZV8MjZMcnas0qYs84bdlHgd9BdeZJ"
        "fOtQfvVdi/1eiPtljwVvkAh5nhCBpBN/pBmHqhuIqyuUvCimujGlvTCwyTyyxkm510vE11DQ2lfU4FHd5mDb5mrm7mPv7G33+nb5/nwAB4cK"
        "EokVCY8WEZgcEJkmH58uOtf8kgoAAAEEAAEAAAAoAAAAAQEEAAEAAAAeAAAAAgEDAAMAAADODgAAAwEDAAEAAABQwwAABgEDAAEAAAACAAAA"
        "EQEEAAQAAADUDgAAFQEDAAEAAAADAAAAFgEEAAEAAAAIAAAAFwEEAAQAAADkDgAAHAEDAAEAAAABAAAAAAAAAAgACAAIAAgAAADWAwAApAcA"
        "AHILAADOAwAAzgMAAM4DAADeAgAA",
        "4c64e41b30da16bdf0b6773bb5992ea3e6d25b95538a385b5627c8022343dc69", 40, 30),
    "lab_pillow_lzw_40x30": (
        "SUkqAMAPAACACUBuEXP9yDd/OMhPlzkN9uQlP1wlB+uArvtwFp/tw0vVzGl9N83vlxHN9N45v5tIJ7t5BP1to58txIPtvJN+NhPvdtqF9tlT"
        "vlsqt+thXvhsLp7NpfPZsr1qkdfNojsNsklhtgisxrEpltsjNertprEdwNgkOZqEkyEAHW0GmohAo4EMCCwAuIYgNwDl/uMev9wkQAN4mv9u"
        "lB+OEuvxvmN8OE1vlwG3KG9/Ns7PxuH99N1A0VC5lFv9sJd8N5NPtuqF8tpTPZvq59NpWPxrLl7txePVsrhrEZcNkir1skZjNoks9qklqNMl"
        "Ne0N5qEtv110Wt0tYkmggg82EMDm27HEiAYcvp0jYAt8fAFvEH4E99OMsvtxFYBNsuAFtjKmw2n2b46Hwbo8H+bQ/pmQx7nERR9m2R6hEsfB"
        "tk2fJuk+fZrlIfBslcpZZHqbRbqWX8PlwaojFybQjGGa4kmOa4kGasppq6bJqCUbRprNHZ1GgJJ1R8MAfAQNIhPGIYDDcIIBDuIoAh0fpxhw"
        "ARuh/LAkgAboqH6bwtMoMx7HINJ7nCNAAG0OJ+QOk48n8bBBnybxDH6axGs+SZ9G4TKhE02pSn0a5WnsbZaqcWEPl4e5sFmbgimAagjF6a4j"
        "GBS5mGuI5mGwI5nG2IptmmJJvmoJBzqidbmjGIAEDGH4CDc843CEAQ5SkPgigBLRuCSe50CakgozAKyNjCygxH6bg1JgzBuDcf5rj2oo/T6Q"
        "7Pkc3ZJH0bZLn2nR9msUahFKfZqljQhYnwa5cHyapZGyIZb0jSYjmOaokGPHxnrKbZoiWbJpCTUgjOyJJzuCMIfgKMr5DQIAADUIB/DkIQAD"
        "iIB9j4Ix+iIAJuCWABuCef5vPub4xHycIsgEa4zn6bo3M/NpsDsfpsj8fhrkUfJtkkehvEqepv3AapQJ4Uh+GoU59GmVkLFofRqlueZtFabI"
        "hFqbIiGEqJkX0Y6ymQbIjmmagj4GI5u30cC1nQaIjYYBAyiAA27AANohH8N4gn6OQhn6OgiHxjp7iEAZtCmfRwiukIuH6bQwTkM7PjbyQ4zk"
        "Otpzia5BzxCZtEoepuEufJsNWa5PH4apRzwVR9mkWJ9moWh9mmWatOHSprCKYJp684hnVRgboxWblUHIaVUmkI4xVeMQfH9WJ/DVJ42iCfw4"
        "4xKJ7j0IR6kGIp8Iobwqn5MIAGyL4AmsNqWjZCI5n4bY/nsbxAQ+Q5+mmSY9RvCOH6NUSg/hqCZH0NYVI8hutOgUP8aQsh7DYFwPgawtRqBE"
        "F6pQXI1QiDFLKMYa4RRlNpGqNEJA2FUHSCK8kI450fDsUoGMHwBQ0N8DW9oN4Qx8OBHwHdvgdgiD0DyD8e4gQjj2CoP8bIW03BgfqGVnIbDT"
        "B2QiHRPofVvB/H+NYRKfRGj9GkJAfsB3UCdH6NAT4/RoinQ4K0fI0xbD3GoK4a4QxYDYCGL8aYRhhDSCMMVtK+QivECMNJSg1xphFG8NMIY4"
        "xqhFHK84LwPh+hmCAAQ7w/w3OCDkEEfgdgij2iAPEQL5BBSjEGEQd4VX1hlM+GZyT8huBvQiHIAA1A7G1EMPYbghV0COUIJVdAlHWijKQKoe"
        "o1xUrwFcPkaTUxqx2CELiRYvZFjBGkEVfinRoqdkcNVSg3RrBIG+NEIo5xnhEHPBkLgPR+hlB+AeHI/jvD5DWEAeodQgj4DsEMfQfQijzEEE"
        "MeIighjwEMEQeAW1phkH8NkkabCfh1H8NUPyHxAj6GwIV1CehqCSH4NNcA1BO0jFOPYa4qGnivHuNUWkcRYjYCILSDxwI9yRj4EIY8gBno+G"
        "rIAbUgBujUCKOAaIREiBFC+D8fQYZLSYH2GgH49g5uFDiEMeYcwhD0DwEEeUqR4iECIO2hY7RHBGHcGUnIZH3BoACNQNoARoh3XDRsa4hEOC"
        "NXaJEfw0RLwGE6Poagoh7jWaWNIVY+BqivsIK6PQs6bweF5B4YKlJujOGgEcZo2AhDWecNmRw451zqCKGAH4AQzKyDJKAuQ+W/VWCGPerg8g"
        "90JD8EYelBR4CICIOwRoRR1CSCGO0M9Fw4UcosNIPjTBALoEM7gRA/BpCPsIJgfA1BOD7jU/0UlhF2DSUSNQVo1AhCykcLQa4QpsNem2MV4I"
        "zRpBEGm3JHpYRpBDHENAIg5hohBC2D0AbDx/zyHy3YfQawfj4DiEEe0/x6h3CIPEPwRB5CEoMIoIo7hEhCHYJEIY6RJhEHQGhPAb4IB4H0Nk"
        "PUZa9DWTuNNbo0xMUvJ2NdDY0BRD7GiK8esER7DSFUNMIItL53oCELyQE2giWaCONBuQzpFjUnQNgaIQhvjPv1UkdQzgjBiB+P4L4PR7N2Hu"
        "GcH49Q4PhDeEIeQd6Eh6CGO4P2cxChCrNJISARR2CQCEOkS4Qh0RYGuHcf41RAofEG7gRjTBH0jEcP4Z4nh8DTE3GwUY+hoiw00K4fgzxWDU"
        "CCLK8wu7+C/Ge7++YvhrBAGTNvKQRIThEGpeYbw0AjDkGgEEc40QfhcB2PtvIYgejzDOEAeb2Z9hFHiHXZFtx2iBxCILP4iQfjqEdoIR+f7i"
        "DiE2EMc4dTcB8H+NAP8AxFUcEiPwaImoLCXH0NAUA+bCj9GeKsfOm94ioyIK8aQQhaR6msEQYF8xizoGM8EaF/BqDOCINqpI4RnBDHANIII5"
        "NfTvH2F0Hmwgfj0YoPgNQPh4h0CAPIOIPx3ZwHYHzDwhayiHw8IwIQ5xI68EqEMcomQgjgE6D8c61xrh/H8NIRF3LpjUXANLpaGxnClHwNF2"
        "I0FFjQFYNMIQqxshAFuNAIaKghC+qSMKdAxL5jR68NIaIQxtZaG9locYzQiDlGgEKd4+Avg+H1PIfUNB3hpCAO/Bo8g5g/HaHsII7XwDvEJn"
        "wQwQxyCJ4uI8Hw6hKhB53zoTwQRxijB+OQQLshDj3GyIkf4zxKbxEvp8UOlRPj6GkKYfozJnjPFKNYH4rrzCv1ELe8wtxqhAGJOgY+V9XhCG"
        "jUka/a2BhAG6NAIA6tUhaB6PsLwPR6BgzIGcH3IKwBs8MHMII7A7BAHaHja4gM/iHCCOsRAPx1iOCCOISIQhxiXCCOETwQBzCfCEHAFSCGHC"
        "EIH+GaES0k0e9Q3YQwGgFKpeFMHwGcFaH2GcFQ+CFcGkCAFeGqB+F0qSF46wGA68UmCAGYvyGk68GsGaCCG6GcqOGaCA7oCCCsB0HuC0B4Hs"
        "SMHkDIB+HknyHgDgCCHeDcCA5WCGHeD2CAHWEGCCHcEKxCoWHG5uHOEc7mEsCEHKFC/4E0CIG+FQB+HCFUCCG8EKf6Emu4mMGgEqH6GaFMHo"
        "GmFSH0GYpcGgE6GuB6FZAyFS1a1ICCF87qF8Gep4yup6CA4WCGhOCAG8GcCEG4GiB6HCGi+iGewAzIqgHiqgHaDWCEHcYoHjCCHUDq3ADq/s"
        "D+CGHU2oHW/YHIEQB8HGuCHEEq8+54G+82G8FMB+G4FSCAG+FUCAG4EYx4Eq9UH4GcFOHqGoFQHsGmFQH6GWE8GoB6FCGsB6FeyI66CEF1Ay"
        "F41EGQGWCEGU7WGav+GfEkysCAHAGcCA10CAHSGaCECyB4HpHiHqqgHoViHeDOB4HcDaB9CMHYDoCCHM8QHPCYHQEGCGHMERHQ5oG6Ek8+Ew"
        "B+G+E2CEG2FJF4FOB4HAFaCCG+FeCEG0EeAAGYE6HwGgEyH+GSFJAoFYHqGmFAGmB8FSGmB/GsCCFvEZG0CCGCy07ECEGMv+GaGeB6ygCCG1"
        "HeG4GdEgGaB8HQGgB+C0B2HoC4B4HjB5KtH28AHaDaCAHgn5IAB8HSD6CCHSD+4uEEB8HEEWCEHMEg/mEo/nIiHGE4CAG2FA7YFOB8G+FXEU"
        "FgB+JWAUFwT+GgFMHvAaHu6kHwGaFQ18FTKeyGCAFnAyvQB+F8GcCCF7EkGREEGW+gGrG+GoGgB6G0GhI1NKHKGiB8CqB2HlBuHgzGHgtWHe"
        "DMB8HfK4HSwaHSDrLSDxCwEE/awwHG/YHGETL0/kG8EtF4E4/nC0G2FGB6G+FPNGFe+cEQACGCEOAUFuE/AiFEH8GQjcGWFBEeFLNSFUGkB8"
        "Fa18FrHUFoGmB2F+v+GGGgB8GjEZHGB4GtKGG0GcB2HFHUHQGWCCCqB0HkwCHbHszAHUDU/gDWB8HLCIHWDs14iAHAEA84EGB+HGEIB+HAEY"
        "v0EoCAHEEmCGG8EyB8G8E/L0FI/yFMCIGwFYB6GyFoB+GyD6AkFiDqGkBgUGGYFYHmGmFJJiFQGfA1BgFlEFA9D9SKGBEoGQ4m4SB+GjKYGg"
        "GeB87bIlSKHIGYCACoByHkCsB2HgYYHYDCB6HeViHYDdH85SHGDhQ0q+HMD88+EECBQ2CEHCENEaEbFyEuB8HC/wG4E6CHOcCGG6FQ4eFUB6"
        "G2FcCGGsEKAYFqDmGkBeD8GeBkFMH0GUFCGmB6E5PeFbBgFhHVGsB8FyGcB+GHQEGEGcB8GTBgGbKYGmGcB4GxVQHAGUB6HKGZLDVQ+uHmC2"
        "B4HYC8B4HWtWHMDOB7Tc4uY0HG5MHIDuB6HIEG/tCYG4EPREEUCAGuEeCKGuEzEaE+B4G4FFLqFKCDRgCAmmB4RKB4G2DqGiBgEAGeBmEKGa"
        "BmE/NFSIB+FGGmB4FSGkB7SQCAF0GYB/J4CAGLHU+GB5ViB/BUB+GuGYB7HS8+GYB5HcB/HiHaCwB2HXKoHUnkHW8AHWb2HODeB+HEDu4uD1"
        "DBCSG0ELDGEREaEWCAG0EnI0EnJBLoG4FBZsFSB5FuB6GtL8GwFuByG5XgBgD+GeBjXtXqGcBlPGB4FbPoyGB4F2GWXpNEF1KUGJS4+KCAGO"
        "GeB4GnNEGrV4G+GTF4GaB4HQGUB8CoB2HSCuB2HcYYHfWIHIDMB6I+B+HNK4HE2cHMDvF4D6CAHCEHI0EQB4G+/eG4EdZtT8G4E4B2G9LoGz"
        "XKG1F8GzL8GsFwB6GwDkGkBcD6GeBgEEGcBmEMGaBldYBgFVKeFTbIFnSsFiGiB2F5VaGDBgGVKYGbbgGlKYGrKUG8GaB0HIGbYoGeBzQJY4"
        "ByHe44HOekHMDJb6DY/5WaDpQ0DnEVcOHED/RQ8fchXGEgB4GyEmCAGyE3XYE/NGFLXcFSB2RACAGsFoB8GoFUBUCSD4GhXlXoEPdaEeGWBo"
        "EeGaBjSIB6FpYMFxVQF7MuF9YmGOGYB2s0CAGkGVYiGXL0GSB4HNgyHIGUB2CkByHWCoB0HM44HNTMHU2IHNNoHQDWB2HIDoywDtQ6q+G2ED"
        "I6ELaC/kG65uGxFkGwEs1o/2G1OeQ6CHGZSkFjXUFWBeCUD5aaD+GgBeEIGcBiEYGYBkEaGYBeEkGaBcICAACwAAAQMAAQAAACgAAAABAQMA"
        "AQAAAB4AAAACAQMAAwAAAEoQAAADAQMAAQAAAAUAAAAGAQMAAQAAAAgAAAARAQQAAQAAAAgAAAAVAQMAAQAAAAMAAAAWAQMAAQAAAB4AAAAX"
        "AQQAAQAAALcPAAAcAQMAAQAAAAEAAABzhwcAPAIAAFAQAAAAAAAACAAIAAgAAAACPGxjbXMCEAAAYWJzdExhYiBMYWIgB+oACgASABQAKAAk"
        "YWNzcEFQUEwAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAPbWAAEAAAAA0y1sY21zAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
        "AAAAAAAAAAAAAAAAAAAFZGVzYwAAAMAAAACcY3BydAAAAVwAAAAhd3RwdAAAAYAAAAAUY2hhZAAAAZQAAAAsQTJCMAAAAcAAAAB8ZGVzYwAA"
        "AAAAAAAWTGFiIGlkZW50aXR5IGJ1aWx0LWluAAAAAAAAAAAWAEwAYQBiACAAaQBkAGUAbgB0AGkAdAB5ACAAYgB1AGkAbAB0AC0AaQBuAAAA"
        "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAdGV4dAAAAABObyBj"
        "b3B5cmlnaHQsIHVzZSBmcmVlbHkAAAAAWFlaIAAAAAAAAPbWAAEAAAAA0y1zZjMyAAAAAAABAAAAAAAAAAAAAAAAAAAAAQAAAAAAAAAAAAAA"
        "AAAAAAEAAG1mdDIAAAAAAwMCAAABAAAAAAAAAAAAAAAAAAAAAQAAAAAAAAAAAAAAAAAAAAEAAAACAAIAAP//AAD//wAA//8AAAAAAAAAAAAA"
        "//8AAP//AAAAAP///////wAAAAD//wAA////////AAD///////8AAP//AAD//wAA//8=",
        "ced66b5702c85dd655a461e74cfcef1fc01cc79039755fe3448593f81b8c79ae", 40, 30),
    "lab_pillow_zstd_40x30": (
        "SUkqAAgNAAAotS/9AGC9ZwAK4cgzVVBQOnrlC2sPzbcPEqgH/fa/XGFlSRHSni3Y7u4WQhlg9lVVETHyzInc1lEKnFsB5UhTLW5mqar+A08R"
        "qy0hKSW7YLzU377AsQsAAAAAAIBBZWdhq1k9AxkDEgPniwU3nJKDUO2RCVdL2Y0x4Wojr5EIfB/xyoa49455iIMXDMoVe3K2C55QB0djwjwT"
        "glcEgXdvMESHyj4KQhRo5vMYvc4Gz8LITRjLEgX0ErVWy6YF2rw6Ghx/aGebN0VnMKf7BcVtoc1TqNyCa0e99pXWbsLdTuCikthmQSYm6cqI"
        "0EQk3D0UG0+Ijz6ykYe+dXZ1CtlIgr5H9GoRrGoPaAC+kFZjeMq4zRi33zF+nZmeM0DPKYDj0Nitm9dnA+9q7Vx73docpoajsoHD1GAw54zl"
        "z1XoMlJwHZUbUnFrKW/xSU64BLaTemVFeGRCcsQecfHGfP/IRZ5d/WJ3p4g3gLAilujZIHhHDXQzGOhozptWw+48Mz+GsbOY6SpofI4AHIeG"
        "07p5t2hu7qadMWBzNZxac6lsYKra6wXVSZkzFEyciodX4voKbEOZiU5wtpJsJ+VqITrh0a7eoatvyDeN+PhCZ9zJ3Sx0dwkfEUd3DIF3c3BF"
        "zGBLeKPbwGfQGjRojA3/xQDniwC4iQK6iRvYqwZr2by9GzeH5tKabKvFNlrshRZvob1eUF0LslDLPLQyB7HkglXiGgpdszATjejqIbv6B+4u"
        "4hGHZOMJvHrGrshDz6iwEq4ABlH4iCF49we7mZvdBr7bcMHv9kCDAm3wLwYwdQj4KwooSdTcrpu168Prq7n0h3f+gHNruJtNTHUTx0CjX6DB"
        "U/OwCx2Uosug6KDTPHwS20o74pHcUIWZiJSze1wJi3TEIPo4YzeU0bN1eHZOjmZEbkMIVzaIX60Bj8bzaMoeTQVcdYcBTp4ATB0CTBcKeBU3"
        "OK6bd+sDrofBy7OR4w/uewOrNzQNtHkLOk/RcFNzmRad8AVckQpdO/WCUWgik53NAm+YJB9TyBmJ5DvHrg7SFX9yxh0fUcdHbGE1NNErkmBV"
        "3GB3zIA3c1odyd+xgw+ACK5oHAjAhGHAZ4FAP5FAP3HzZtnIvhqOvpljWq7qA86GyjHczDHUaC41eMsc5EIHs8jDJ/meMhOlzDaTnFBJLg7h"
        "2UB0xKPcLcQTCtHGHl7dc0Xc6dUrsspW6I4hfLYIvnsDq/sD0Da1iP9ntAB4fMAKAAYCWuaRK1MI10fa+kddnAfXF+Iyc4CZNMp0HzKoT5nX"
        "KdNTlCFLzPQcu2YEZ7X8CqStvP++Jwufboq2NXQcl7P9gqpdzhWG/0L5l4padGJrK2zthL2PuEMlqvHILSK9RR+uPTQPc8BHoLiWsfWTuD6Q"
        "LxQIFloE9onCzBthJgpjTKCxv1P2YZTxFMKeEyRNMPIStLTrZK9MtfdZGWVf1E1p7Fpb07P9Qmu1fBfqbKO829QGodqyJ9ZustpKsVAJFq7g"
        "1kLcuwhn63hvFOZ6Rnvcwd0qts4hXGaQr88jDO1BxtQxdt4gcwKVmT9BzzPkLeqeQ+Q5R58DACnCs1nnemW2Mc2laax7trfTnQFtwZzulh9H"
        "mS7Uf6u8QSzt8MpbP3FvpdVG8g5XeGuktmjk2kWwjeMt1miNPnINAzamADOFdKE/vk6jMaYQGe3GGJPG2O8Rmj1Bv0P8LIr+RAAcBQ0ngapa"
        "p/oz3bnW4r58q61pzaWivV9OWMsJT51wC6bs9NZP8HBKW3yCEzZ56ySvMYk1BomHP2JbR1znkG0glkbnpVGBozkhF3PCaEdgZxHYqYMMKjTm"
        "Z5D9njImz/DsCXIVdkdxlzg1NwF1u07Wh747WkvTWrjmqrSW6rtdULiLiZs64ahTvuISo2Dhk1svxUEpbjHJaye5RSFv/UMmEsl1jnl4Azb6"
        "zDYPTdyZjSfio4gxZ9EYswcZU6gMaqM2f4bep6y3IHoVRt+CAJ5zkyPOV+tUtVC2Z4Pb0V7YdG011lZzqdD2C+puQd2pHzvBdVRLdIKJTHFZ"
        "kzx0AheJwHaRuD6CbSJdsIiuf96ZGDl7R2e7oG8UuzpnngFB7BwKokJDNAeZDxREf4o+xm2+OHoVAXQUd1lCrcVC4Z/p8lA3pr0t7U1RmKr2"
        "zkBrwdDcLqZsxYydXqELLrFKbEthb6X1TiITjbw3kPb+oat54I5BudqGrpaRs3/ko4v5zskVSeyKIubjB8FaDiE/gez8MX6goRljaO4YfQvj"
        "VyFAaYL2ftVcrdqrQ+XY5pVtWLj2ikFjGmq4GU74Bdq7JWNmIcZqQChZrNnqm600ub6/Cu5r1VfDdHaLT7lwF6q3LXS3ia9MnF26DZtYIZRV"
        "GGUlGpkyQIjmVnh9Sq+UQptLch3Jj69w5YlceSBZP4WrUgjog7i8Da5Sxpf3GdN1wPqKsNkJMvwEmdkIspoQfN0qb1Zkqvs32rMrqd48S8Nn"
        "uZjqF99m+amUd5+4y1S6S9wyKqn9pIajkXWYxDaDRP+nnq/im0np9Se5f6THVwByIbvvw9eNssyhLT+k5WlkeRlfJlBYqRM2SyHGTZCVOGUz"
        "EGQzEP/G1VdgT32dlTurevZmsmJ+VRj/aultlr9KefeJxDEhXyVV95IbXHrLpKTFpLUuwto+dL2p15l0PArPK+l5I0Be5Ar98SuNgH6H1xfq"
        "MoN+30fL9OnyMMh0FmG/BViJQ6bECZIivNrVWSuS1f2U11nYXNfeUn2W6qtc/srFv1Adx9RbKmScZBU+2WomlyzK7S6yFoms9hD3JuL5Jiu+"
        "1DtZyOpMsL4KWOeRlg/yO4u4TKIwP+TVaYiZQGH9hZiHMaa3GOMnxkoSwVkIoYcQ/IrVbz403fkbzlxbs7X114u5evmulpPNwuGn3jp1eCm1"
        "q6TDKLAQyko8whaJqEUk1cjjdtRhZTL5vlJWV2Llk34/yJU/8uJGXn4H18fRxWeA9Z8v3wPGXYx5FmRliiBJgowswSZDoGpXX3e9nU02Pln2"
        "tzV8lgplZeiw1H+l/Pv0XyeOg6ISnWx3lLZWcodM1GLSWhNRjzxm4Y7WzgHkTn5eCZZpBMsX6SqRgJ4H0Cz6QnWIfRTAPA0w3jPmecT6CrHS"
        "RM1z6tKEITnir1jn7WeqPFOlTbY1V/ZsZUBZMCfL5cNT5irV5ynfpbIOrax2EzuEktpKrZ3U2klv0Wi1jVpjUFzf0OJJfN4IlllEywfR+j6+"
        "/g6wk+jr1/gygcI4z1iXQaZkMewsyHiOPSPBJkdwFuhbn5lanSx9pu+5rqdLA8rOcLZeTnfKlKN+++TdpbW2whKnqHeTl7hkrZNwQxbYYhC5"
        "7gHfQeuxBq7oEw/chEBg+yGBzUcEqQ4I1qAI1BofIJgC9yssX3LNJzHphO5K3lMFmReRfZCdP+LNiHo+R87P8PGf3pcBrGmxVaLIIkt0kThZ"
        "MxKyPHzg1aGDGjFALiZrVkOvrIq5mLavaY2NirRx8ekWnk5xWxSpLkVwQ6KgCkmC244JVBwc1ho3DTS9ZRSuO801TLkZFJpUomdH5j5kngHR"
        "zY50ZhGvDLrqNni958dl/DpPVneRRZ7IKktozUgQ6zACmAcQOqg+8gb0cOORKVze2lLMrbyJ6bcvZaqlhr1Sqi3MVCa+NnG4FUlwK5ogFeKg"
        "2nigjSGTUzhuZe5NdG8ydyS8GiS6MonuRzpu1JsZ+WZDVt1GrwNldZ+rrpPFV2SRKICzEsQ4TliNCFw1H5Ritma3Xq+hV9pgcnVnKlVnqbpN"
        "BjLNQq5SZhUMM7epXKvM2CUSpEQT3IgiUIM4sD66DlIyt4Ijo/BmTHRfoutI6D/ENxtC9xR034jniehOw4qjAPRAV3xH6+t49RVePKdrNsKr"
        "ZgSwGQh+45rZgDz1kbaY33D8dpuxMvR0hq5+4bYsXYUiW6aZ64SrS+SqNMGNaAIVBwfWJzeTomdOcKcieyi53kQ3U9J9IzGKFPceV32Hzg/9"
        "/hCQBAJ2Gb/OA/QwfmSKLI7Ca1bC10xEGbIEnnKVNixSjI+n8ix1y9ut32ooUzC+KgaevlC6Tz210m9ValwkpMtETB1FAvUGBG0PlgOIcKZT"
        "jmyiz6Wd6SRnJtH5JKsyScd/6H6R1dfx60JAfiPLz/hxGD/OE1a++OImxEicL44zpiaEsQ4fdBuwqz2u0qW6ljeWuzSYaRiveukqF89m+SpU"
        "vz11dal0n7hlqNhqKBxanysL2Jh51ExSkc8oVv5Jr1TilUZ45pCrTuTK9OHjOn586Odx+D6Qlv/x6i+wyhZenEUXL0FW4oCRIsY8gOCrtnp6"
        "VZPSpIqbsbefsuUag2e71LhRPcXC2Spl21SyUEh2SZUtJYyxSTpUkjJgxxcao11/okkpPdJJrjO58kh6XQWeP+qVPH5+x8/U4eWFsP6Mq9KH"
        "y/NwdR2xEoUYRzGGNCEACwAAAQMAAQAAACgAAAABAQMAAQAAAB4AAAACAQMAAwAAAJINAAADAQMAAQAAAFDDAAAGAQMAAQAAAAgAAAARAQQA"
        "AQAAAAgAAAAVAQMAAQAAAAMAAAAWAQMAAQAAAB4AAAAXAQQAAQAAAAANAAAcAQMAAQAAAAEAAABzhwcAPAIAAJgNAAAAAAAACAAIAAgAAAAC"
        "PGxjbXMCEAAAYWJzdExhYiBMYWIgB+oACgASABQAKAAkYWNzcEFQUEwAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAPbWAAEAAAAA0y1sY21z"
        "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAFZGVzYwAAAMAAAACcY3BydAAAAVwAAAAhd3RwdAAAAYAA"
        "AAAUY2hhZAAAAZQAAAAsQTJCMAAAAcAAAAB8ZGVzYwAAAAAAAAAWTGFiIGlkZW50aXR5IGJ1aWx0LWluAAAAAAAAAAAWAEwAYQBiACAAaQBk"
        "AGUAbgB0AGkAdAB5ACAAYgB1AGkAbAB0AC0AaQBuAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
        "AAAAAAAAAAAAAAAAAAAAAAAAAAAAdGV4dAAAAABObyBjb3B5cmlnaHQsIHVzZSBmcmVlbHkAAAAAWFlaIAAAAAAAAPbWAAEAAAAA0y1zZjMy"
        "AAAAAAABAAAAAAAAAAAAAAAAAAAAAQAAAAAAAAAAAAAAAAAAAAEAAG1mdDIAAAAAAwMCAAABAAAAAAAAAAAAAAAAAAAAAQAAAAAAAAAAAAAA"
        "AAAAAAEAAAACAAIAAP//AAD//wAA//8AAAAAAAAAAAAA//8AAP//AAAAAP///////wAAAAD//wAA////////AAD///////8AAP//AAD//wAA"
        "//8=",
        "ced66b5702c85dd655a461e74cfcef1fc01cc79039755fe3448593f81b8c79ae", 40, 30),
    "ycbcr22_deflate_orientation6_40x30": (
        "SUkqAEAHAAB4nAHgAR/+AAIFDSVQCBAPDzZfDRoVGUJpIB8aJ018JiokLlaNMDgzOGaXOD8/QnCkQUxGUYCzTllXWIvDWFtiYo/QZmdocp3e"
        "dWlyeafscnhye7v5foqCiMoIjoqUlM8PkpqVo9ocpKGhp+UxrKqss+9AtbW8wQBJvsXCyAhVCAkKCDlYDhUSGTttFSQbG012KS4mKFCKKzU1"
        "OmGUMEQ9QHKmPEtIR3y0TktRVobBU2BWXJTPX19jaJzgZ2hsbq7qcH12gbf0d4R/gsQEio2Ek88MkpmVndsonJuco+kwo6ausvE5rK6zsf1N"
        "vMLEwgdawM/J1RlmDQ0OFzxyChscG0x2IiImJlKIKy4yMF6VOjUxOWqjPUA9R3a1TUlIToO6VVhTW4/LXWBjXJzhYm9scqLpa3BndLD0eYd9"
        "hLwMf4iKi84ShJSUldYfmJeXo+0um6yko+w+rq+wtfhNtbi0vwBeucW/xRZowNXI0yJzExYVGj53GBkfJlWFISYhK1yZMDY4NmmlPT8zQW+x"
        "RExNT37CSFFVUpPLWlxXZJbaZ2NuZ5/mbXJvcq/6eYJ6eL4Cf32JjcoWjY+Kjs4imJqboeovn6Kfqu06prKxsPpKrbC5uwphu77AxA5hxczM"
        "yRtty9rI2iyHnabWyAB4nAHgAR/+GRwbIlCLISQoLlyUNDkwNmemNTwyO3GpREs8SHm+R05OUonVVFVcWZbXXGliXpvqY2Zwcaz3cXVxerkC"
        "en17hs0Vg4iFidMdjZOVo90sl56anug+p6WqpfRMqba0uwFfuMG3uAxlw8vFySBzx9jS1CiK2Nfe2jGNHCceLFeWIistKWylMjIxO3C1PDpA"
        "QH69P0lNWIrRT1lVVpTcWl5gXqbnYGtoc6/2dnRydrwGeX58gcQae4KDhs0njpGVlN8rl5+Wmuw9nKuerPNKqay0swBktLO6vg9px8HFwhx7"
        "xMbM1CGC2NjV2zGW2uXh5jmhICMiKWOmKjIwNHC5Nzo9P3zAPERFRITPR09TUpbcXFpZVZvnYWRbYLH9aGpsbLkFdnh2eb8Xe4CEidAdh42M"
        "jt01mJKRlOs8m6Cen/VNpbWupwBTsLKysRJrt8HAvR1zyMnIyiOC0tfP1S6Q4NrW5jui5Ofh6UmyJTcuNXGwNjI7Q366RUhES4jPQ0tAVInb"
        "VldZWpflZGViYK/9aGxmebgJb29xecoYen98gtAhgoyFhdgpjpOVk+Y9lpqbnfFDoKKlpftgs6qvtwpgsruywRN3yMO7xxyIytHK2C2V0dbX"
        "2zmk3uDg5kiy4e/l7EzAwq/1MgB4nAHgAR/+MjgvN3u7ND9BPoXSTEtJT5TfTE9SV5zvX1xZYqj5ZXJoa7gBZ3VydcUWdHp6fc0ffYeCitMo"
        "io+QlOM8kpOTofFKnKSipPlXqbGnsAZkqbO2tBN5vr2/wiKCyMrBzjKU19TW1TWg1Nra4EWz5Ovj7lK+7fDv/V7LMzs+Q3/UPEpGRIzcRVVG"
        "UJnnSVxUXKX3ZWNgaLMFbG5tcboad3JsfcolfYaAhM4yhoKLkOM7kY2TmvFFm5mgovlZoKiopwRmrra4thB1vLi6wiKGyMe/ziWO0tbR0jub"
        "1uDQ3jux3+bh5kS28evq72HK9fn392vZOkBFP4nWRUtHUZToTVlRVKjxV19fZqkEZmhkcbsRcXhxc8gob4B7fNozhIaIiN09kJCMj+pOm5me"
        "nvhanp6grQBoqaunsxBvq7a5wSF+xr26ySaTxtDKyDGf0tDZ3Dmp193g5EfC4ubm7lnL8fDx+GXZ/f/7Am/kP0hASpflSElPT6XyWVZVXrQK"
        "YWdfX7YOamtrdb8jcHh0gMwtfn2BiNw9iI2Hk+ZRk52SlvNel56fqQBmpK6osg10rbavtxp8u7nAwCORwtDJyi2f0dLK2jquz9fg4Eq74Ovg"
        "51XJ6+vz9WPd7Pzz/27lAAADC4PtTvgO5AB4nAFoAZf+SkhGVaP5WlRPUrALVmBYZb0Sbm1lZ8glcHhtdNAuf3t5gNU7f4yIhOJKk5GRmvNW"
        "lJijnQNlqKegqwx8qbaouBB+trS3uymbwsa7zjCey8/K0T2sz9PO2z+94OHl5FrH6vPs8FrY+PL09Gbn+wD/Am71AwkNDn0CSVROWqsFV11h"
        "YK4UXV1mZMAccHJsfdExd3l1htM/g4B9gelNkI+Lj/RYl5uTmP9hmZ6pngd1q7GprhWBt7SyvRyRwL+8xSygv83Fyza00dHN1EO/2N3d31jF"
        "5unk613V8On0+XDg+fv/AHbzAAkIDX8CCRELCpELV1FTV7cSYGJkasEkaGpibcwxc2+BddxBfYJ8fuVMh5GLiPJhj5WPkPRnl52epA9upaak"
        "qhWHs7irvB6Qube6vS2excPJxjeq0dDX1z690Nra4FXN3eTm5mHX6uzu7G3i9vr6/nL09gUHEoAADQ0JEYsHDiAQH5wZEHDEIwAMAAABBAAB"
        "AAAAKAAAAAEBBAABAAAAHgAAAAIBAwADAAAA1gcAAAMBAwABAAAACAAAAAYBAwABAAAABgAAABEBBAAEAAAA3AcAABIBAwABAAAABgAAABUB"
        "AwABAAAAAwAAABYBBAABAAAACAAAABcBBAAEAAAA7AcAABwBAwABAAAAAQAAABICAwACAAAAAgACAAAAAAAIAAgACAAIAAAA9AEAAOADAADM"
        "BQAA6wEAAOsBAADrAQAAcwEAAA==",
        "be2a3e520853e14291d2b0db3215bd8f6ba5ae66044a32b1efbe03726253542c", 30, 40),
    "ycbcr44_zstd_tiles_40x30": (
        "SUkqAPIFAAAotS/9ZCAAAQkAAAIIEAUNDw8ICQ4VCggSGSVQDRogHxUZGicVJCkuGxsmKEJpJiowOCQuMzgrNTBENTo9QFaNOD9BTD9CRlE8"
        "S05LSEdRVnCkDQ0KGw4XHBsTFhgZFRofJjxyIiIrLiYmMjAhJjA2ISs4NlKIOjU9QDE5PUc9P0RMM0FNT2qjTUlVWEhOU1tIUVpcVVJXZIO6"
        "GRwhJBsiKC4cJyIrHiwtKVCLNDk1PDA2MjsyMjw6MTtAQGemREtHTjxITlI/SU9ZTVhVVnm+VFVcaVxZYl5aXmBrYF5oc5bXICMqMiIpMDQl"
        "NzYyLjU7Q2OmNzo8RD0/RURFSENLREtAVHzAR09cWlNSWVVWV2RlWVpiYJbcYWRoaltgbGxobG9vZnlxebH9nC6V6Si1L/0EAB0JAAQSTllY"
        "W1dYYmJTYF9fVlxjaIvDZmd1aWhycnlnaHB9bG52gZ3ecnh+inJ7goh3hIqNf4KEk7v5joqSmpSUlaOSmZyblZ2co88PXWBib2NcbHJnY21y"
        "bmdvcpzha3B5h2d0fYR5gn99eniJjbD0f4iElIqLlJWNj5iaio6boc4SmJebrJejpKOfoqayn6qxsO0uY2ZxdXBxcXp2dHl+cnZ8gaz3en2D"
        "iHuGhYl7go6Rg4aVlM0VjZOXnpWjmp6Xn5yrlpqerN0sp6WptqqltLuprLSztLO6vvRMdnh7gHZ5hIl6f4KMfIKFhb8Xh42YkoyOkZSOk5aa"
        "lZObnd01m6CltZ6frqegorOqpaWvt/VNsLK3wbKxwL2yu8jDssG7xxJrABDK4ZootS/9YCAAFQUAJAmkoayqoaess6OmrK6usrOx5TG1tb7F"
        "vMHCyLzCwM/EwsnVAEkArq+1uLC1tL+tsLu+ubvAxPhNucXA1b/FyNPFzMvazMnI2hZoALjBw8u3uMXJx8HExsXCzNQMZcfY2NfS1N7a2Nja"
        "5dXb4eYoisjJ0tfIys/VytHR1srY19sjguDa5OfW5uHp3uDh7+Dm5ew7ogQADOTrJchHSiBfkeAJKLUv/WAgAIUIACQQMjg0Py83QT4zOzxK"
        "PkNGRHu7TEtMT0lPUldFVUlcRlBUXJTfX1xlclliaGtlY2xuYGhtcaj5Z3V0enJ1en13cn2GbH2AhMUWOkBFS0U/R1E/SEhJQEpPT4nWTVlX"
        "X1FUX2ZZVmFnVV5fX6jxZmhxeGRxcXNqa3B4a3V0gLsRb4CEhnt8iIh+fYiNgYiHk9ozSkhaVEZVT1JJVFddTlphYKP5VmBubVhlZWddXXBy"
        "ZmRsfb0ScHh/e210eYB3eYOAdYZ9gdAuf4yTkYiEkZqQj5ebi4+TmOJKV1FgYlNXZGoAtxJoanNvYm2BdQDMMX2Ch5F8fouI5UyPlZedj5Ce"
        "pPRnBACAoJrE08wonAEpKLUv/WQgAIUIACQQfYeKj4KKkJSGgpGNi5CTmtMokpOcpJOhoqSbmaCooKKop/FKqbGps6ewtrSutry4uLa6wgZk"
        "vr3Iyr/Cwc7Ix9LWv87R0iKCkJCbmYyPnp6TnZeekpafqepOnp6pq6Ctp7Okrq22qLKvtwBoq7bGvbnBusm7ucLQwMDJyiF+xtDS0MrI2dzR"
        "0s/Xytrg4DGflJiop6OdoKuZnquxqZ6prgNlqba2tKi4t7u3tMC/sr28xRB+wsbLz7vOytG/zdHRxcvN1DCez9Pg4c7b5eTY3ebp3d/k6z+9"
        "paazuKSqq7wAFYe5t8XDur3JxgAtntHQ0NrX19rgPr3d5Ors5ubu7GHXBACAoJrE08wonAEpXlHE4Ci1L/1kIADNBAAkCNfU1NrW1drg1uDf"
        "5tDe4eY1oOTr7fDj7u/98ev1+erv9/dSvgDX3eLm4OTm7uDr6+vg5/P1R8Lx8P3/8fj7Auz8AADz/wMLZdkA6vP48uzw9PTw6fn79Pn/AFrY"
        "+wADCf8CDQ4ACQkRCA0LCm719vr2Bfr+BxJy9A0NDiAJERAfiwcHACsMtBBck6CnBO8lyEdKIF+R4AnBbzELAAwAAAEEAAEAAAAoAAAAAQEE"
        "AAEAAAAeAAAAAgEDAAMAAACIBgAAAwEDAAEAAABQwwAABgEDAAEAAAAGAAAAFQEDAAEAAAADAAAAHAEDAAEAAAABAAAAQgEDAAEAAAAQAAAA"
        "QwEDAAEAAAAQAAAARAEEAAYAAACOBgAARQEEAAYAAACmBgAAEgIDAAIAAAAEAAQAAAAAAAgACAAIAAgAAAA2AQAAZgIAABIDAAAsBAAASgUA"
        "AC4BAAAwAQAArAAAABoBAAAeAQAApwAAAA==",
        "512d5cd4c335639c72cc9a60f52404ca065bdd4e45f11066dae08c962516040e", 40, 30),
    "g3_cut_pillow_41x30": (
        "SUkqALoAAAAAE1dikOzABNXYpDswATV2KQ7MAGbIFoADNkC0ABmyBaAAE1Ft2LNjgAmotuxZscAE1Ft2LNjgAzduYtoAGbtzFtAAzduYtoAA"
        "G3UC44ANuoFxwAbdQLjgAmrt2HsQAE1duw9iAAmrt2HsQAATV1OxbQAJq6nYtoAE1dTsW0ADYth5scAGxbDzY4ANi2HmxwAbduxbeAA27di2"
        "8ABt27Ft4ADMW3YIADMW3YIADMW3YIAACQAAAQMAAQAAACkAAAABAQMAAQAAAB4AAAACAQMAAQAAAAEAAAADAQMAAQAAAAMAAAAGAQMAAQAA"
        "AAEAAAARAQQABQAAAEABAAAWAQMAAQAAAAYAAAAXAQQABQAAACwBAAAcAQMAAQAAAAEAAAAAAAAAEgAAABUAAAATAAAAEwAAABIAAAAIAAAA"
        "KQAAAFAAAABzAAAAlwAAAA==",
        "f776d287a0285bd456edebbe99b49b8ec1806a7a8b2a661d90406453008381fe", 41, 30),
    "g3_2d_cut_pillow_41x30": (
        "SUkqAKIAAAAAGauxSHZgAv8AGauxSHZgAhlkTQNwAc2QLQAF8AAZqLbsWbHABf8AGai27FmxwARmzbMxVABzduYtoAF/gAAduoFxwAXwAduo"
        "FxwARNWbZsObEABmrt2HsQAF/gAZq6nYtoAF/gAzV1OxbQAI2KbDmbgA7FsPNjgAv4AAHbt2LbwAF/wAdu3YtvAARmLLsghqADmLbsEABfgA"
        "CgAAAQMAAQAAACkAAAABAQMAAQAAAB4AAAACAQMAAQAAAAEAAAADAQMAAQAAAAMAAAAGAQMAAQAAAAEAAAARAQQABQAAADQBAAAWAQMAAQAA"
        "AAYAAAAXAQQABQAAACABAAAcAQMAAQAAAAEAAAAkAQQAAQAAAAEAAAAAAAAADwAAABIAAAAQAAAAEQAAABAAAAAIAAAAJQAAAEYAAABkAAAA"
        "gwAAAA==",
        "95c230a01f4267244f399a10816ded62b6759d996da4717138619b7a87151041", 41, 30),
    "jpeg_strip_marker_32x24": (
        "SUkqADoDAAD/2P/gABBKRklGAAEBAAABAAEAAP/bAEMACAYGBwYFCAcHBwkJCAoMFA0MCwsMGRITDxQdGh8eHRocHCAkLicgIiwjHBwoNyks"
        "MDE0NDQfJzk9ODI8LjM0Mv/bAEMBCQkJDAsMGA0NGDIhHCEyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy"
        "MjIyMv/AABEIABgAIAMBIgACEQEDEQH/xAAfAAABBQEBAQEBAQAAAAAAAAAAAQIDBAUGBwgJCgv/xAC1EAACAQMDAgQDBQUEBAAAAX0BAgMA"
        "BBEFEiExQQYTUWEHInEUMoGRoQgjQrHBFVLR8CQzYnKCCQoWFxgZGiUmJygpKjQ1Njc4OTpDREVGR0hJSlNUVVZXWFlaY2RlZmdoaWpzdHV2"
        "d3h5eoOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4eLj5OXm5+jp6vHy8/T19vf4+fr/xAAf"
        "AQADAQEBAQEBAQEBAAAAAAAAAQIDBAUGBwgJCgv/xAC1EQACAQIEBAMEBwUEBAABAncAAQIDEQQFITEGEkFRB2FxEyIygQgUQpGhscEJIzNS"
        "8BVictEKFiQ04SXxFxgZGiYnKCkqNTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqCg4SFhoeIiYqSk5SVlpeYmZqio6Sl"
        "pqeoqaqys7S1tre4ubrCw8TFxsfIycrS09TV1tfY2dri4+Tl5ufo6ery8/T19vf4+fr/2gAMAwEAAhEDEQA/AOEsLbpxXUWFt04rPsLbpxXU"
        "WFt04r3jxTQsLbpxW+i+VEFU4dvTqB61XsrcKu48ADJq/bRmaXeRjPQelfOcSZn9Tw3s6b9+enour/y/4BtRhzO7PObC26cV1FhbdOKwbDtX"
        "UWHavozEv7M7YV7ctVHxXrA0LQjHEzLe3amOAqD8o43NkEYIB49yOOtaKf8AH234fyFcr8TP+YN/22/9p1+YYibxmdSjW1Sk18o3t+WvzPos"
        "jw8K2LpU57b/AHJv9D//uAwAAAEEAAEAAAAgAAAAAQEEAAEAAAAYAAAAAgEDAAMAAADQAwAAAwEDAAEAAAAHAAAABgEDAAEAAAAGAAAAEQEE"
        "AAEAAAAIAAAAFQEDAAEAAAADAAAAFgEEAAEAAAAYAAAAFwEEAAEAAAAyAwAAHAEDAAEAAAABAAAAWwEHAI4AAADWAwAAEgIDAAIAAAACAAIA"
        "AAAAAAgACAAIAP/Y/9sAQwAIBgYHBgUIBwcHCQkICgwUDQwLCwwZEhMPFB0aHx4dGhwcICQuJyAiLCMcHCg3KSwwMTQ0NB8nOT04MjwuMzQy"
        "/9sAQwEJCQkMCwwYDQ0YMiEcITIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIyMjIy/9k=",
        "8dc3fda88169eb101a94b9d051abdc72dc678eee2f4e7f754e67891edce6ca41", 32, 24),
    "jpeg_planes_40x30": (
        "SUkqACgLAAD/2P/gABBKRklGAAEBAAABAAEAAP/bAEMACAYGBwYFCAcHBwkJCAoMFA0MCwsMGRITDxQdGh8eHRocHCAkLicgIiwjHBwoNyks"
        "MDE0NDQfJzk9ODI8LjM0Mv/AAAsIABAAKAEBEQD/xAAfAAABBQEBAQEBAQAAAAAAAAAAAQIDBAUGBwgJCgv/xAC1EAACAQMDAgQDBQUEBAAA"
        "AX0BAgMABBEFEiExQQYTUWEHInEUMoGRoQgjQrHBFVLR8CQzYnKCCQoWFxgZGiUmJygpKjQ1Njc4OTpDREVGR0hJSlNUVVZXWFlaY2RlZmdo"
        "aWpzdHV2d3h5eoOEhYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4eLj5OXm5+jp6vHy8/T19vf4"
        "+fr/2gAIAQEAAD8A8asLb5hwK6jT7UfLwcdq6mwtjlePY8V0+n2hCqMZrqNPt8EccZHWvnextm2jjA4rqbG2xt+UnHvXT2NsODj8BXUWFuPl"
        "45611NhbgY4Nf//ZAP/Y/+AAEEpGSUYAAQEAAAEAAQAA/9sAQwAIBgYHBgUIBwcHCQkICgwUDQwLCwwZEhMPFB0aHx4dGhwcICQuJyAiLCMc"
        "HCg3KSwwMTQ0NB8nOT04MjwuMzQy/8AACwgADgAoAQERAP/EAB8AAAEFAQEBAQEBAAAAAAAAAAABAgMEBQYHCAkKC//EALUQAAIBAwMCBAMF"
        "BQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGhCCNCscEVUtHwJDNicoIJChYXGBkaJSYnKCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpj"
        "ZGVmZ2hpanN0dXZ3eHl6g4SFhoeIiYqSk5SVlpeYmZqio6Slpqeoqaqys7S1tre4ubrCw8TFxsfIycrS09TV1tfY2drh4uPk5ebn6Onq8fLz"
        "9PX29/j5+v/aAAgBAQAAPwDirC36Dt711Nhb528cV09jbdMCupsLbodtaep6vY+FtAu9b1MuLW1QO/loWZiSFVQPUsQOcDnkgZNeFafACUI9"
        "D39K6fT4VyuO/rXU2EC4H411FjbBSMkHHFeI/HbxRcX/AIjj8KRfJZaeY5pQyDLzsmQQc/dCSAAccls5wpH/2f/Y/+AAEEpGSUYAAQEAAAEA"
        "AQAA/9sAQwAIBgYHBgUIBwcHCQkICgwUDQwLCwwZEhMPFB0aHx4dGhwcICQuJyAiLCMcHCg3KSwwMTQ0NB8nOT04MjwuMzQy/8AACwgAEAAo"
        "AQERAP/EAB8AAAEFAQEBAQEBAAAAAAAAAAABAgMEBQYHCAkKC//EALUQAAIBAwMCBAMFBQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGh"
        "CCNCscEVUtHwJDNicoIJChYXGBkaJSYnKCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6g4SFhoeIiYqSk5SVlpeY"
        "mZqio6Slpqeoqaqys7S1tre4ubrCw8TFxsfIycrS09TV1tfY2drh4uPk5ebn6Onq8fLz9PX29/j5+v/aAAgBAQAAPwDjdM0/pwT6Adq7DTbA"
        "sASv4V1+m2GQvyd+prqUW203T7i/vH8u1tommlcqW2xqCWOBzwAegzXzd488a3HxB12KYW/2bS7PcllAQN+Gxudz/ebaOAcDAAzyT2Om2BO3"
        "iuw0zTs44H5V2Gm2GAOP0rwv4q/ECbxJqknh/R7mNtBtnXfLAxIvJBgkk8ZRW4AGQSN2T8u3ktNsOF+XjpX/2f/Y/+AAEEpGSUYAAQEAAAEA"
        "AQAA/9sAQwAIBgYHBgUIBwcHCQkICgwUDQwLCwwZEhMPFB0aHx4dGhwcICQuJyAiLCMcHCg3KSwwMTQ0NB8nOT04MjwuMzQy/8AACwgADgAo"
        "AQERAP/EAB8AAAEFAQEBAQEBAAAAAAAAAAABAgMEBQYHCAkKC//EALUQAAIBAwMCBAMFBQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGh"
        "CCNCscEVUtHwJDNicoIJChYXGBkaJSYnKCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6g4SFhoeIiYqSk5SVlpeY"
        "mZqio6Slpqeoqaqys7S1tre4ubrCw8TFxsfIycrS09TV1tfY2drh4uPk5ebn6Onq8fLz9PX29/j5+v/aAAgBAQAAPwDe02wIUcc8V1+m2GcY"
        "FeafGH4gRfZpfB+hXL+fu26lPE2FVQCDBnHJJxuwRjG05ywHlem2JGOBjHpXYabY4xmvZ9Msxlefesf4n+N5/AWhWkWnwhtU1ISLBO4BSAJt"
        "3OQfvN8wwOnc5xhvnbTbNcryOeK7DT7RAQc8gCuv02zTA4H5V//ZAP/Y/+AAEEpGSUYAAQEAAAEAAQAA/9sAQwAIBgYHBgUIBwcHCQkICgwU"
        "DQwLCwwZEhMPFB0aHx4dGhwcICQuJyAiLCMcHCg3KSwwMTQ0NB8nOT04MjwuMzQy/8AACwgAEAAoAQERAP/EAB8AAAEFAQEBAQEBAAAAAAAA"
        "AAABAgMEBQYHCAkKC//EALUQAAIBAwMCBAMFBQQEAAABfQECAwAEEQUSITFBBhNRYQcicRQygZGhCCNCscEVUtHwJDNicoIJChYXGBkaJSYn"
        "KCkqNDU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6g4SFhoeIiYqSk5SVlpeYmZqio6Slpqeoqaqys7S1tre4ubrCw8TF"
        "xsfIycrS09TV1tfY2drh4uPk5ebn6Onq8fLz9PX29/j5+v/aAAgBAQAAPwA0nSsbTt/Gu50vSiNvyVH438bWPgDTEjRUutauVJtbUngDp5km"
        "OQgPbgsQQMclfn7N9reqz6nqc8l1e3D75ZZOp6dugAGAAMAAADgYrrNL0nBXK/nXrGlaSGA+Wo/HHjew8AaWqIsdzrNwmbWzJ4A6eZJjkID2"
        "6sRgdCV+f/8AT9c1SbU9SuHuby4ffLLJ1Y9vYADAAHAAAGAK6zSdK4X5OM13WlaVwPl49q//2QD/2P/gABBKRklGAAEBAAABAAEAAP/bAEMA"
        "CAYGBwYFCAcHBwkJCAoMFA0MCwsMGRITDxQdGh8eHRocHCAkLicgIiwjHBwoNyksMDE0NDQfJzk9ODI8LjM0Mv/AAAsIAA4AKAEBEQD/xAAf"
        "AAABBQEBAQEBAQAAAAAAAAAAAQIDBAUGBwgJCgv/xAC1EAACAQMDAgQDBQUEBAAAAX0BAgMABBEFEiExQQYTUWEHInEUMoGRoQgjQrHBFVLR"
        "8CQzYnKCCQoWFxgZGiUmJygpKjQ1Njc4OTpDREVGR0hJSlNUVVZXWFlaY2RlZmdoaWpzdHV2d3h5eoOEhYaHiImKkpOUlZaXmJmaoqOkpaan"
        "qKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4eLj5OXm5+jp6vHy8/T19vf4+fr/2gAIAQEAAD8A7Txt43sfh/paIiJc61cJm1tM8KOn"
        "mSdwgOeOrEYGPmK+AYv9d1S41LUp5Lm8uG3yyydWPT6AAAAAYAAAGAMV1elaTgrhcgV3GlaVwoKY/wAK7WwsobW3e4uJEigiUvJJIwVY1AyS"
        "xPQAZPPSvmTzLrXNUn1TUrl7m9nbfLLJ1J6duABwABgADA4rq9K05CB0x16V3Gk6em0EY9Old1pemqNoG3n2rxL4qeO7zxBrF14Yst9rpNjc"
        "NBOpOGupY2wS2P4Aw+VfYMecBf/ZCwAAAQQAAQAAACgAAAABAQQAAQAAAB4AAAACAQMAAwAAALILAAADAQMAAQAAAAcAAAAGAQMAAQAAAAIA"
        "AAARAQQABgAAALgLAAAVAQMAAQAAAAMAAAAWAQQAAQAAABAAAAAXAQQABgAAANALAAAcAQMAAQAAAAIAAABbAQcASQAAAOgLAAAAAAAACAAI"
        "AAgACAAAAKIBAABqAwAAUAUAAB4HAAAUCQAAmQEAAMgBAADmAQAAzQEAAPUBAAAUAgAA/9j/2wBDAAgGBgcGBQgHBwcJCQgKDBQNDAsLDBkS"
        "Ew8UHRofHh0aHBwgJC4nICIsIxwcKDcpLDAxNDQ0Hyc5PTgyPC4zNDL/2QA=",
        "1dbb3f3de25e61b698ae5d4f991cfa5764e8fd9e94f85f679a451dfb9188c16b", 40, 30),
}
JPEG_FORM_PILLOW_FILES = {
    "sof1_37x23": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAYEBQYFBAYGBQYHBwYIChAKCgkJChQODwwQFxQYGBcUFhYaHSUfGhsjHBYWICwgIyYnKSop"
        "GR8tMC0oMCUoKSj/2wBDAQcHBwoIChMKChMoGhYaKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgo"
        "KCj/wQARCAAXACUDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQID"
        "AAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlq"
        "c3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3"
        "+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEI"
        "FEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImK"
        "kpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwDz"
        "/TdMyo3KD+ldNp2m5K8Ed/SrunaaWxlea6jT9O+YbhwOeBX1+X4/bU+TpVzi9P03eVJAJ68DNdPY6Z0O3kVd03TMAce1dRp2mZAyuRnk"
        "+tfkmX4/bU+opYjzM220z5Pu4H+9iiu1ttNAiHyAjtxmivqI47RanasQcDp2nDI4XBI4rptO04cFgv8AjRRXRgK0tD80pTehn3t5pvh+"
        "0judVuBbQO4jVtjPliCcYUHsprEn+Kul28yppWmT3yglWklcQrjsV4YkHk8gEcfgUV8jwpllDFUFXrXb7X0/DX8T9i4ZyPC4zDLEV027"
        "vS9lp6Wf4mXL8RfE94ytb3FtZoqgeXBArKepz8+45/HHFFFFfqNLA4ZQSVKP3I+7jlmCirKjD/wFP80f/9k=",
        "be1859851f8a642f915e6fb5ae45f2c6a731b0f7c9cacc0b39f948d7a2c412e8", 37, 23),
    "arithmetic_corrupt_37x23": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAYEBQYFBAYGBQYHBwYIChAKCgkJChQODwwQFxQYGBcUFhYaHSUfGhsjHBYWICwgIyYnKSop"
        "GR8tMC0oMCUoKSj/2wBDAQcHBwoIChMKChMoGhYaKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgo"
        "KCj/yQARCAAXACUDASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAAAgEDAwIEAwUFBAQAAAF9AQID"
        "AAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkKFhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlq"
        "c3R1dnd4eXqDhIWGh4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl5ufo6erx8vP09fb3"
        "+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREAAgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEI"
        "FEKRobHBCSMzUvAVYnLRChYkNOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOEhYaHiImK"
        "kpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwDz"
        "/TdMyo3KD+ldNp2m5K8Ed/SrunaaWxlea6jT9O+YbhwOeBX1+X4/bU+TpVzi9P03eVJAJ68DNdPY6Z0O3kVd03TMAce1dRp2mZAyuRnk"
        "+tfkmX4/bU+opYjzM220z5Pu4H+9iiu1ttNAiHyAjtxmivqI47RanasQcDp2nDI4XBI4rptO04cFgv8AjRRXRgK0tD80pTehn3t5pvh+"
        "0judVuBbQO4jVtjPliCcYUHsprEn+Kul28yppWmT3yglWklcQrjsV4YkHk8gEcfgUV8jwpllDFUFXrXb7X0/DX8T9i4ZyPC4zDLEV027"
        "vS9lp6Wf4mXL8RfE94ytb3FtZoqgeXBArKepz8+45/HHFFFFfqNLA4ZQSVKP3I+7jlmCirKjD/wFP80f/9k=",
        "ad7ccec70a2b66fafc97d8715cea7f40a02a5764dfa84ab5e231792d3902c374", 37, 23),
    "smoothed_420_k1_37x23": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAYEBQYFBAYGBQYHBwYIChAKCgkJChQODwwQFxQYGBcUFhYaHSUfGhsjHBYWICwgIyYnKSop"
        "GR8tMC0oMCUoKSj/2wBDAQcHBwoIChMKChMoGhYaKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgo"
        "KCj/wgARCAAXACUDASIAAhEBAxEB/8QAGAABAQEBAQAAAAAAAAAAAAAAAAUEAwb/xAAWAQEBAQAAAAAAAAAAAAAAAAAFBgP/2gAMAwEA"
        "AhADEAAAAfP0+1RcmLU7VJJTMtlNoFM0ms+EIscoqHf/2Q==",
        "36d90331e446164167bafe4094577794fb53f772277657bd3ab8d3b5c3e55505", 37, 23),
    "smoothed_420_k4_37x23": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAYEBQYFBAYGBQYHBwYIChAKCgkJChQODwwQFxQYGBcUFhYaHSUfGhsjHBYWICwgIyYnKSop"
        "GR8tMC0oMCUoKSj/2wBDAQcHBwoIChMKChMoGhYaKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgoKCgo"
        "KCj/wgARCAAXACUDASIAAhEBAxEB/8QAGAABAQEBAQAAAAAAAAAAAAAAAAUEAwb/xAAWAQEBAQAAAAAAAAAAAAAAAAAFBgP/2gAMAwEA"
        "AhADEAAAAfP0+1RcmLU7VJJTMtlNoFM0ms+EIscoqHf/xAAaEAEBAQADAQAAAAAAAAAAAAADAAIBBAUh/9oACAEBAAEFAjOM4zsHZOM4"
        "zjOM7J/DOM7ez6+efVLPPPo9nd//xAAcEQACAgIDAAAAAAAAAAAAAAAAAgEDBBMFQpH/2gAIAQMBAT8BVxbDYLJxmDVdXscjGpjpHh//"
        "xAAcEQACAwADAQAAAAAAAAAAAAAAAwECBAUREjL/2gAIAQIBAT8BzvM7yHiLycVmo2nu5VC+vmD/2Q==",
        "2d0e3167cfc9323af5bf9c0d16cdfa4280995d174b717cadef71dd6fdc9b4ef6", 37, 23),
    "smoothed_grey_k1_37x23": (
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAYEBQYFBAYGBQYHBwYIChAKCgkJChQODwwQFxQYGBcUFhYaHSUfGhsjHBYWICwgIyYnKSop"
        "GR8tMC0oMCUoKSj/wgALCAAXACUBAREA/8QAFQABAQAAAAAAAAAAAAAAAAAABQf/2gAIAQEAAAABnjbLjEmcZaak7LjLP//Z",
        "b402b08523d89b2214566b8acd9d05be2517063bcd6bfb854740e2dbbf2a3df6", 37, 23),
}


WEBP_PILLOW_FILES = {
    "webp_pillow_q5": (
        ("UklGRuYAAABXRUJQVlA4INoAAADQBgCdASoxACsAP32wy122OSmkt/VdUyAviWwAqSdViyVP0wQ9o2xYr7BpFKaGcsBt05YByXDOPulAkOkSySAA"
         "4CiMFrRfC+vkfCsWJBpivgG5KPuMTS+2Y2/3/jE2GjdBxo9E8r0fT034v0NuS/GN0AYEwU5LAKOmhTSAwPJ09E3nqDz7GCIRuEDM7iZXHzV26eQf"
         "WGIJUFWMeXOnxVbVWbDiqkZoJTbJ9Af9Vu8GE4UNapMM0FWyRANoFTR9wzq4cxGX/+7SCdlyE07MPorqO+9oyicaoAAAAA=="),
        "da759032aabb0cf6ab4663aea879c8ac8ca4e3046077220c23373bbcb12985cc", 49, 43),
    "webp_pillow_q75": (
        ("UklGRkYCAABXRUJQVlA4IDoCAADwDgCdASpEACsAPn00lUekoyIhN3i9+JAPiWwAnTKEePeu+YJUn75s7RLLGfqk/Pe9hZqXN/LsH7/kQXRmmjEq"
         "5xL07jU7fJHbUs7CDeSvqbFOZ20IyOjgEb4ji1XUa//Sz0wvKBRER9Fwaw2iq9TYjvK53hMht11Faj0aymUVQAD+8/aGNShywqefcB1WFz0NtENS"
         "9pjMPlXIFn0e+iknJohYBlLRso+I5AJ/Lbu85EYTgQDcwMIUaAeK7SGTnS0+UPkDoYczR95SgqnkoGrc7Vo0aJIOWSBIS2Xb652+89MOnL8oJqsR"
         "So4P0nzxdykos7YOF+UQdUWtLqEOkWq50NVrrCsVP6mify6FNv34N8TSEcUDqGnFm8CPDEXdW9wzqopFWO+LNo4URZHKg/kjja3cDlL8XiIy8/L/"
         "KcAg6NpjdfyVVrwkBvryHXXm97m65Li1mQh9Ila10O8Jt4afqsp+DDz2kmis/SbTb0A+MsELeoOorm7Ut+UpZTwGDUIQd1MLTVr2Lfze1Uc87FmU"
         "8174eXQdziGOmKWtv9YklYhy6yoNrGFAfPhg7Q5sZupsI95hRy1HSv0plS9LzlKMnsfiPAqFZkmzmxhL8x7XI5UDRiHLZl5M9qUtfRXZZupfvSSd"
         "FOT9Of/NwwmQznzv5hSpSq+GZVVIsN76t/4M574IfUfQJLchl/PZGjmvuQq7z6w45e1MkjhOr9c42RD90ivFO1/dn1Xf3l35leMkwc0BW+auGDQA"
         "AAA="),
        "b0e11b0c870333564a1f4b2483d37944547ef65703b773318775ed512cb8d800", 68, 43),
    "webp_pillow_q100": (
        ("UklGRnQGAABXRUJQVlA4IGgGAAAQHQCdASorADsAAAAAJbACdMoR1P4b+DX6q/6r5BKE/D/th+uP+Z3REgXTp9o/KL/Ae7P+gewD8Af5X3AP0k/v"
         "X5of2zuAeYT9m/1P9kv9gPcT+vX+q9yL+kf1zrO/QZ/bj0rP+l/gPhp/bL9gPaZwL3b78Z/ETzT8PPkbxM41nKP+d9Av4x9ifxHkT3x+7DJfvPYA"
         "N0D6ndAH+t8G+gB4tObl9v9QzpVHa3b3RfUliKTy8MEp/rbwl2CIqFxtvPaCk3AYX/CnXHYoZSsr8lvjnx/cQn/pFOPcAtUv4v13xvXDbPwv8XPI"
         "4Pn0qdAsTz0AAP7//nt0Yhs6ykatL51P6G53KKKIZWZYfVzDxc7SWbZuWwrJ6IAkYZ5CrA6M1dXfK4IMetCIW7PRZmjNfpESPhy8yStcao2ws1/1"
         "8mE/tL+hHnkU/kWKM1SyVfZdf/4TCJxHEgyAgl5muhe4pbdl1iEif/ctLwoDJZTTkqtO9MIjpWK6eKIqkQreyQ4NBpGTECbSFE1CrhlXmkPkb/ku"
         "rCE+HxiXreG4dbpWFh3eVPzilHAqJYKZCdgoA1+KT9XPTw6WQji58ttAvrexw6Ssgg6aD5mnbSAR5/+BtZHZjfMvGZ5CJvVVKCQixFAwNtL7AC6q"
         "gEJ+Dq6JxvvHXF1M3Th+uowzBHulTTSJ+9W3p/q/WxLElHGgdXatZk1yX4edLIYpC9QS1nl1C+lNW06uR4GssM8N/cPejATra70+Fk7t0SSNVU1X"
         "RjxijrMNvwk4QiZJKviMf10nebmBcjaGedhMwOkb7VPTG9RNOHyP69iadDzSWcClhKdTabt51Td/L+YFCCjaagW6rWSHCMmb+RvkNLfzJ0cyBuDk"
         "v7syt0KvwvSxp4uxpHR2s/b32FYWc6VTAqiduKzi6P1lXt1szbMB8DIN3bOdYHXVZ/iQs4oIbva1raf7b/PySPBfG+Iznh0khCTa+Db7zyZI/MO3"
         "fVd2KT1mQXoQYJyHz9UmZ2+JA/+Dam8/pTnno98DQTt1NDz7OvrlhZesm0uTWWnC5+fKZPCmVAbbdZjpVZ19cyAvP2BCrFme+DQF/UA3Na9rZrf6"
         "MP4GW/0FgO3Gx9AqNNBg5hYp4zPga29gxH8PRtQ+u0ST23yTFbjfghjB3tecWkuGMyt8KFbBHqrkLbURK0NkUdGpIjIaQVIa4IbiiQiOTZsFNmWT"
         "2B73Mgxgd5j4kD58bQWmQtXg1dHMLyN8hte/SnKOuR/+XGlszZ15Tc3u9pvx2eL/LRpzbpT3WtFdIuR9Xkc6tliPPBLWMY8jqR8UWNCOc7nRgeIM"
         "uPBqIJ0YoDIf3H+XIt+aK1ZpPQSJwt0uhunx1OUmguZzdsc6WPGTfMTMqSdRABLCXfZevs2z4LmspO+GRAtlZVdJBH//WYGcV0bpX2djpXKWoAKl"
         "PWt57v1aaqkxZ9LgD/nw5BqdltND+JnI1EV0l/9qZS/jjd2cck4t3nW6j1Y+5oYXqwKMo+myT+2xZKvs0FnrWYOlu46eVXJ3PjGwm3wm937x8Mkt"
         "EQBbBuWwOMT/X4TgdUuaGJQTN1XpgaBpcpeQH/RQROj49VoeXUHtTIj8TMpU6dhMNDiv36a03g2pcZX+08j5mBilMmZKRzYhp6g8hGFxS30g1QbL"
         "3LGdXiMD46bWydVTFp42lkSFQZxcm5hHr5sPmdS0QZ0q/h6PBGn2MNSAoKCSXJlel3UzOqCvh/qpFI/rZ4EOgrz8XIO2YrBxrcMsmgZrcF8KObc3"
         "8FZOgwUxMOkxaH2BJyG0MDFeD2kCxrFlK9D+J7ehoJM2X5uQNs4Fn4canWCqKkSb58QYnMwOAzGyvYl1um3PAb+KYRNpeUqEHvE//+o2paanjD0l"
         "5dYSTPPBDeWKb0Yax4HTnUM/LRQ1nneankNOAa9tdC/ittCJgqTOypxLEF1MNOgxBoGq+aqNVkbHPxMr66lX9DB337vueDwhCHSke21JnU/bToOk"
         "OI9SvuFjPUJPD61SxVYUbkP+33LxpiOb2LQdQUnPQah+FMZUadWSlKSjhrpW5c9zDT777lWnUHDsjFkpHS8i+xmuLu9IMpwS2dh+SOzBoIn+31NU"
         "o+152/EXkb+ngVtJaBuLlqxkQ5CCbMBhB05rMYzX4fJLD2ofwbNDMuKHuFK4ozZm7lyj7dR/KaPt6J5G8kAAAA=="),
        "2f0c4df110ce86b416fe6c1ab7febfb8e918d4194c1f5a29fd596351f69bc2e6", 43, 59),
    "webp_pillow_lossless_m0": (
        ("UklGRoYUAABXRUJQVlA4THoUAAAvOYAKAA11IaL/AQ8CwLZtaNsWQLBLspyy+97zH8qexupl77jEKuzANCgKAJC2lXAN0bbbzt31I+8fXZ9M06Yx"
         "JAE8CgCYts22bWIyhJviNbyZ4UTvQ2PGdlvaJGaQLIz47y+/azRr2u0HyUDlG1Y4zJqlgywkb4oCovpCMElckEpITUptUYDAiamkw/zFT63be7RX"
         "t1XT8AZiCJcGt/7Rfejg+P/upwPv7+WnJJ++i3db9z6Jw3exV3tz8OUwpma/VX5nobNxx77I+WNoLmM1zW66zh/Xytvp7dL+7fE6T8PX3c9SCRjI"
         "WsPOYarzalQvAVNQBG6cYUZhMWgJFAQgwm4SmznXM8Bm19hq07Qy9ySMz306yOV8YoYAUevBqTLap8ENi7ko3ETI3B8C2tieOrQSDsErj6ThislE"
         "+VbgKntV36rq5v3ZWXO49mdvPcinU39c5+rXj3/IFDQtm8kBaRZoSNJN7JowRJAdEXY2d7RaG2KDwezBzcPAGBye52bcTtwEPsDWuvM28y/nwVPD"
         "iHlQ0QmFqaQbLSsTSS6pNY2687AkshXigC2jkZUsqs1lN+ODJ4ZDzfp6dZEfqbr5/O8Nzee5vy6XjtRexLtfP/o5y6QIQYyYR6CIFVbZgEbAAkNJ"
         "e4UIQqVMsujnwYCeZxNHlWd7Ga31XA5q1VI5jaYuUNX55eHMvixSMkw6J0Qu1fKsSIW4qKkhW4xlAgSlUSUylBHNRyookLY9Bz8Yurn1l2V8+N6/"
         "tEodUT+aaQn98sPXvzU2GTk1yeM+IoXCmSFGciKVBBqKLsyXfsrtbJDUI9r8QYr2TbvJXBcMQ6sX7Yx9sqVEFhmC09kI/zJWnVWqMqVFixbdIDGZ"
         "uCv0OIjMI/IkSohIijsg0hcYECVkapfN9yMGd30zKLl39E7pO+Z3bnIa39+rHzw+/F5nwDKtAwuotih1rXzsmMHFXYt0l6Umfy0dFAHkBO16xWJw"
         "/irvN/reKj2qBYPuU4PTQdj7Xns7EK9IiAyNwVPxppZCbapxk74hfxyg2VAqsccORa5lVCpHnYgJ0iQ0BzVb6h7D20q6B5zs8v8kFl5fn3/59Dck"
         "nCPWAhv96DZH1GhEp+2NkMrNO2svpV3r/cSkbu8pwDW8N6G70t7S0mMz09lOb9veJvewDJgQps4LPS3MEgd6mC1j1ygoIn4dPjTh9mZpeIZaEsKm"
         "Vi4GORwNIaGAQxVWBffo/VNQUxynT/N/xqcjmVv9EIR/+uXDnwSy+NxryNdcmRiDneY8Ou7WqavqCfF58v9tVUnk1Axx+YWLIPWk5cneW25m1KMe"
         "I/a4KwIc9FaGtwEAddaC8DpUg7vKUedeiN0kqgjshdCGWr4KTaCUKSl0lS0IWJE7DfQjdJOWV9heJmc2ht/h6NQDgIv3Wx13vcLRzVYZ4nczReD2"
         "aNc5Bm+2axVOIMOdj73QV95oD2RS7iuiNze2undrH8u+VgPJxVYK3DTtZSzvy3bMaqdavQIVRXsDiSo9aWKRm2Otis3H/ApdOQPouIwMUZm7YrMk"
         "oGbLA5TBWmQMG8fR23tfTgEssqG9bHbaZsJxsl3crw7iy+QnrB3XROk8mgE7tSg4l2d6qO4obtD7W8XaudldejW5hN9jGK6vmmR2NId6ys114TZB"
         "gUw1SseDsKqKNpq41VY1jd1NWAdErnN9SVRV2SUTj0gg1Aumresb3oNyyCBHLML5HoU+yWzn5XL1ncE4bHqCUZGwgCVGoyGZpkljV8GEibLLwEkZ"
         "WV8hx+E5fBY6mmn2tnJ2+n96t9p6Y4+LfXPT2A/ELkM/MayDGELEciVMMXkyySmFHc9wul4rh8VCkWHl51gvOU4w8xKuazxUKaPvHr2g4JAOn/UA"
         "yxG9PlZz3xjmZqhnvyhGr2F0xEeUYnARWIDp4NgsySyR3aoFkzd/MMsLKn5+zO+iHdZQu1QzLGpRZlkcx83b5V/ldgcqYmms9nAElnvAUBX5ZUER"
         "uGWbL8m5SJaar4Esk1k4M5S9AxJJag4+ZXYmttrmIXNbDhtU+57VHUzu2SG2bGOAyRPoQZjSsgYtNXMcxKfhSPyhhIRy2ymfx12wFOGR8J7w+nAK"
         "4vLA7yZfX9K/fTbVbFy8pvf3dq/34njQfXmHOoSAY9MwD0ZLBkuMieyCw5zI23M1YbpCvl77FflLBAtxGz5smG109S2URT4RKJrm9+FJaZjbgEPw"
         "9IIHInCiyQMExE3BRqe74MgFTbjsgPcyoafml3vctNHc+D6E10DeJnD+jP9N7CmmUy43MX/pKpMbyZqI8R0VX+JBNYmkg5IEpi02bueLNQuK6xpX"
         "4NdI3rJdV/9ug5f5SdgfcpNE+r/ZfhXrmzlAPUtjH3o7rZe32VCNLouTli8pOgRjBjMAxMFsp3MUX2R7rFRfcQnbNLNbzspF3kM+sa8OtYt+bm57"
         "4uOAu2TWS/7fwp8Dqza6pUKemGvjg1hc1nOav4tDTMFnbVBYbP++2nVHS45/u/p3b6wS/3n1rz+74+/t9lWyEE3kjRfjr6fd6OD+LicSQFjhqXSE"
         "CCkmTiFphh13NiKT/FYmhBOGGfM8X6uX333eV/d8/3Geff46y7PTXxjQuHhF0xSNElQzRMo5CnsZFUMisiw5odAYNrvVIToQOyaFkaYg55AkTNpM"
         "DHycx1cdnrVJQh84nU3cKc3CD+IL55Uzjy1XVEmvAXPIFAmKdoZEkSoCz8g1MRyXddJRr3YZ++cqjrB5f770ARGtPH8Lp/Z9aPy+zH7ijF1KbASA"
         "ghlTiA61EYoQkgElAC6Jd0o1RO+L5RR2Sr6rNOHwdeDXbH77SK3e/L/y/3uXvFDxNH5ryNaiQ4tOURVAGmyIVigjag0z3qW98RoBzYPBQC1pM4nJ"
         "pV9zjAOGPm7D5/Atv0i55pa/Gj7O7bMu35Z5mpYQHTLd2SauFQICVQ6MPWDsl/munzCjRsRAgjLYKvG+zJ775y2f/OS4vfo4b9MCfcPdL3ffPQ7H"
         "TcbMlpP5isZH6QViqbgGc+UrD0bCTmGvUSAWFEkGevZk4Aq9sWs7X8995nIR45HrN5AGNFiYmm9y+/Y2zPJhb8xVs3nxBqGRiDWJXRVAsCSW29WA"
         "HDIamWaY22QGIGchHTOOTKkABsd7He9HN+/Lvbn5FjdP5U9RfJ3kLvh3uyNAR/KUAYFoik5tXnSUlKS21iGDOmYJfDD3fG9N+McqMho4LnPFb6V/"
         "m/RrSpXmQ/XxMqqb/tJrvutcViApUcI1GaAUxYWoGLWKvFUrGcDgioDviAmICcSXodfr5aWixsEa93XChP3T6G99fHV+J7uj9JsmA7pGcTaoHwVC"
         "N7jTeSgqKgoA6mRGZoGSocVlGgc2VYCRpnh+08/qfaz0M17+8sg1vtdwN+Ndp5qm32p72yocFObCV1BxxAwRaWJVlLKLe9Et7BFp7FFtWnlcO6Rf"
         "HQXhlPaW6v81MILqFIf/3aaHiXfDXpI3FbJwDbmWpJE2l5GjRTBrsGQdC0CoNEANm6dtGbQT0jWRDJjt6vzSz+tl/gsvf0dojGq79v6c34/R2iXM"
         "OsdoowGWGUUIDAoiYJdUW9g5YYAlskPscfOD+cSVpS1Rb1jnyDCMJal1NSR+3Iz5Vg9JvMvEbgK+Ssx5LdSWCfUJAvIM0Shnu4xVOzWBISzTiQFL"
         "THSABgq5kNs77PIfGDVvN6rcrJRu9ru1HBrRsUo+sOSNNqfoQu2rlITERw42o4maBX2ZW+1yISu6Fk2CTG+JDkQHTbutzB+1ImMNaTZKEwQnxeSs"
         "uLrEEVwFY9voTfP6nI9GNxUCoL30dHhZrFjimUVsErrJYQK1KFkVQ7Lhi/k1nP5FZsjiP6Gd0GV7fXW3VHRK9SWVchXqEelyGGb5pptvelD/85c6"
         "5qRkXnewyWkHcVUbZFaGXjJmA5ecSQVZAbwgIsQ1YCoIORn2Fm2btrV6rivcHfhmX+jTHey+AG1BOuFLnOBIJTJnHOlQCMeQQzfsPCoUYnmMz6/u"
         "Qg/0i9TJArtEfCI8JCY86VIoLK3gVXC/Lo/i8WDbe3OvntnOHnHJx3V7snXSO8TgZEfNqsJ3Q88hntpxdPCcZTwwPKQYyYx9gWls+wbsqObLGW5q"
         "LPPlzvBWi64vwpCJRWpBEJ4NmVENCgIAhHVZRVFN8Xp3/+dX7+AqwCv9rKKtHO207UM+2fW17lQuyLxJ+Cydu9JDUq+R+ZfrR/n/7oMaBCae8RrT"
         "TddIwS9Z7b08IYC1ZBBAYbyRlAvfwDjCcOabFl0NXVs3zRLqXzNYp1HNoqqXjIsYUOtRLRPzpLFTpMV754q5aZK3WuqZNLeDpMy8Knjz50/vQuiW"
         "8//DUNnwZRneXny39uc6qji9yP9c/0W/zZ1+oPe7d6rnR735Vu9gKwfbFZIGOSS6KdtmJFEzHxwPCDOiO8YcUN0TjTXPoszlSbfqjKSXPWVwz4w2"
         "cBg1aXHBdVtpNUlQlSvOBWKlLe4iRwiO9lDpGryETQnYZ7qK5zH0l9vH6+urt1Pv4su3MhZx+Kr+EXbq6E88esYXyb0YVvB0BLd5vnsr6+Y4Ug//"
         "q3C5F7sAnkda7VKBajDZglPHQx1zjuFkqJ2Z7ds0ZzJ2MJE0Z6fjWg5eTtu+m8FJX7y5QtPPRtgAo2RhbGq6qK1guOpgexR3hW4L2S6vpuvbvx+H"
         "/d5ur///r9kCdqTvo3kTzW/GvnHmH96vmX7B4YngJNu+2vHtod4PY0597PVpCLGZraH/G0gUhm/NGov/VuIrSZm4ZucxUOmZ6aP0lFdJuHdbZ93s"
         "6AKNIRTJxZo5utJUw453I+W5WJe0H1gVrgRvgHmNg5aw3yQlk3DGmuRmVY/yfjpsN5vH3WN4aja+P7odU7h1m9dpuxe4yaCJNbGuGjOgeo1qxOGs"
         "xQpaYfwvYH1Z/xRtAs1merVLb/vM3s8trJIHR3O6iv/Y3CmJDBtAIGN1E4SmmLaj5+dmFJMSJqYWrK6EVmJnFxZvAIhwepsaxWBvZRNyu8uvr79t"
         "n6wfXzzZx/P00j3a+1KsX4ebx/vF65Cdd3SUaEBHqK0ltGG0i7bWogPT0+L/RTo3BF/tv2uwCRYAm6cJ4+QpzbASGiyu4B393gQ/oRckYFSREmya"
         "9sQyoDneNcUsIp1tgDKERKdo9zg5d7F9lXmI81DCkdBOBJ3Px5VaFv1w+fXnj+h0VtvCyq0uUnkYVJYDSY2vhzG1E7E0v/l/64zxWs2YrhzPyrjG"
         "4sbc35hh8BbnFGfXjYjdNoRzjyAw8Jf0HyRw2r81KUQppkkngHuilaYyt5B0Kg1RFgOwfH7xpd2qbKdlQs4Ih0uoWSHV+jrS1ycbGe3X9/cwzpLd"
         "wddqQ+lQHB9IyPJsCVLEfJnCtbNwVpScVz0g1Jo+kjU21+ha5w2SJYRWQWe20abOIHfJUefZxekv8Q8jl7neZLICwFmokx4q3uaUqZUmcfTUZ8w1"
         "oXrBmsH5OqLiDnopBIPo6JIIbnpTCJZhrjxmh8g2J2Vmi4UC68JW7Lw3rYsN46FmBSyn3KWLdiZM4/AhXmoVFhWtstaP09B+BpXL5wn2OmqoXYSV"
         "A7US81/yH7+bDx69dHSfya5xNiBTPoKXBa+7VY5iYmBGluvcQ60ydc4GhObdNECJJ5QQGv6NZU+ggHGDOWNdCCFvtJ0TL/U6N87s4DpLzo0dCYUr"
         "Jt4E3ddknMWB+0H3zN1/PDwHp2pVmanPF3ad0unD24Cvc/7mdX/BLx/xb6/82ZLX03+Ypn4nD2c8tKjytqNEoC4m0ItjfgxWWhtDcClwY3k6BT6Y"
         "GpIXDLPE+w7vt1mz4H5Yd7jgtLjdcDRudeKWeRza5pFpyQ4nZJbkn8eRGc0pzNhdGAxCT8ANzqh6Feeov1yeSJCXz7W9iDbQy19AM8HOpmRx9zZO"
         "T/XOBRfBFJGb/bJMtshVGMfAnQ3eTGOUgNjiiVvTgDVrENxO+bRcnkXByUPp/Tq8iswgV2seh75hKIIz5oYvo4DWTseJT5erkT2OGZTO9tFMCQAS"
         "Juc0+Sejx3zdFhfD4mHI0Ie0DEo3LRG52BzjITi8se+Q89UNd/VxWc2czLJVb+gVreSSBuaQG8sTgDgTPQw89sExkhU158umxPxy+jpscZufXfk2"
         "nw9GKxM6arosiSnlp7hbPWvObnYjcAk8t2w0Bl1ITzNbTIMLfjdfXO/1iEj3UUyWz8ShUSSrrMF1X++Nai0IOtHowjJrdttD3da8bfn+VWw7KBK8"
         "fdteXFpYQQNp55GE9ZsRFTUwqWUVYdb04GJ5/tpI+uvbl1SwJGghSiU3cipM2b3qSWjI3dpYRjOjsZ8jxkE63aXpoQXP/hH/Pb3T6zN0Q7D0SjlZ"
         "qS2NQDIFCj0WUM7j+WiGPWMRfQqBTsFOcbm6mTL/m30t8AYjHToMFIEC4dbYqRkJwuMOBg/YX6taCXVJctH4FNvBHQLYiywZSpspMBe4NMAUtH0P"
         "VBDZY8h+HCiqZKRWBZI7ur40dDvNk59CF5807hCoUxQSCIShdarwW0jAxtkm5C2/XtO6hIbyt9EOpBpSf71eT3Zkwq720iMYlWMHGQNcGsAWgxOu"
         "syigiIyFKNQUByJagZAQKaJgURBjECshEkTjqXFSgVDAjMQhmQht5EuU7To1se2m8zK113np49hph2WnvLOkcr0xIGlkZb2tqdR+DVh0lnkPHPUh"
         "xzk6QWyA4u/2S91orVCD9vryrUBwKjqo5Qg2Ttk7MBEY08IPUVgAhyHEQCtlQOlQCijpICSVdyQ4IBBxU/lBiw6FSxoPCBV0wrvCraz1y/Q2t5f6"
         "utYnDBlvPOdi5B1q0JaSfdbRCiw3W4E5uQUQFNHSdTfrNiqCKigIctzGJ8sYTDujFeJ5/Vadz4TtlBwgamqxJpryMLwowZWkE9CtUAZxzVElqmiU"
         "BTnxOuEsl4Jium5mk5JY0BLPdLa11a225eJD77rzNC6fxbeaClv2OR6K3TiAEGeCtjUdqisB"),
        "c82bf0642f19b5594f267e8a5c3e152fb4068ed65dc34511abc2b4f20283d71c", 58, 43),
    "webp_pillow_lossless_m6": (
        ("UklGRlQRAABXRUJQVlA4TEcRAAAvKkANAAEGjSQpuoejSbd/wQcaIvo/AUke1apJ2NSKAdUKJm5RD2tyYeCKK+ouAU611o0GuOJq4DiSJEfJE0C/"
         "iNMGEPhv2wRPLY1wJcm2mnTQeHD4ZP8rc7d4uZFkW1X6u+FO9ve/GmIidw2d6n/CCJQf6AkJQy3AjBkEvmLITkYzQuldzQM5hE9hJXQORScWhCAn"
         "J+cgrPW2gecgjIwaZhxAScmHwddsDjbFXilktmhrU90oYbkNFkCx7L+wc0INl5thtrgO1EzLM4afGS48BgYKALRhhT/TwYI9foPhIKaBiNgDwQww"
         "4AV/C0cAPQDKb8+TRSplBHouAKWeEB06+MGCALBtG0loLJLseLa3u//fp3rvucSWWEAA3/Bg23bb2LZtDQsjUhHLp3dnd/m1IyQQBIbxIABs29a2"
         "taGyiIq9ezuDOvOfQj8niWwKJICI3/zv7+/66FHfx4/P7Nc4P1Gn//g26+Pf/eN7fL3212N/GftXo8hxVfjHtP/h8/OIz8D/IvxzPgd+1n72OJp1"
         "jZ94Hc9/F/gr6nvrf0T534i/NvnzFOH6nfN3CD/n48eUY8uvNUtySipBGLJrvycLjAn9plwU+ZjCeef47rUf7nte7wJJIfZu8B4KCyi5zqLIofpD"
         "KUCld5R4RC/19KinzKM5Qf+hp1w1FoeWfIPBd7zX0hybd4GsR9AGUUCoc6HzQfxALGxV4g6+x/p6BPFnJMwy547FGXs/A1QBcIAqAY1H91A+KqaE"
         "ems5rAWDHqItDL0kJVnZfQPcrn27ZvbcmSFKUkrwsd09Uxx2iuy9bD8cSrzhW4IqvNivSJr8fWF45ADl+Ro8QEV5SGdyRa6l0XmQbpinokocAtU+"
         "Kgjy8fDbO0TgPgPBbumpsNi5U+yuFbVaKySC7U7+JraXoOP1kT8V+bqk++LI75aKI58J0z+XnZHee79zbQRUO5TKpLzPj+7vwCbqBKh8RbRjdYql"
         "JmtazFzmsVo1ysYSnbxvQFV4zyJPviWhrHQANJP+dTo7kQXPzDlinBlm+lVfwsEsKS9udx2OWp6Kec7DITSK5w8wVejQ0EMp2qJiqdlW5gZWne+b"
         "IaqwZqqbla3y105l9VsJLiUa8UdcEdFoUcYNk+7pycs+hqzwz8FUBGFU1lZkLz1w3I5c6NeZSqkIpmUpf37pdTjw7W0hEsJnlu8HaIpaUXPiwcKi"
         "jFT5LHjuGuWwKV+rGXXoYIWgBTnw2HneaQHdzm2Ysng5E5eih9eeW08kfOz3THQB5RWsxENTf7Z6JIZxMYUovst7Czi5iHKYb8C82KvkUqsQleDm"
         "+tMVKQp81rk7zFXdmLJYWHM5U2NrEfFav1KNWm8wUtUuZaG+nj+OYnrs+eSPss/s1mdg7p8XRi5MCM/plIoRlsE4+OhvC8HqhpGL2efGT3/llwna"
         "4vWDzq9dUuYWGkdPeyYxPPYs+JTg58EtiuwVjDuW+GgwevZSev22X6RJIjOf11rxVdzDuUC2fGDxBZASUHoYGw5iVS2jiC+erDkLbTP1uhVZ+mEb"
         "AhTAa+z2ER1KA4hhP0R1pEr8EVf++PSG6opq+NKQsY1eKZfiu2JSi9EO3qD/r6ttOVKDwYIFjxAGrFhKJKnIWuDCi3Vb0WFtrTPbYiDWLVtcmkmp"
         "NPiBb5vO34QaOoYVt9Sx6oXIudU83PgFadl6HXnr2bJUbg3/W367wWvF3iEX9QS9F5J1mPMUUBdiGVYoihXm+VzTA3uKnpMpAbFn6MiZird+bkVb"
         "BVDpAIujG3DQdUVZGYYwTS597K153C0n6TzyQp0YDM1BBQXMkx0bwEwFqO7qzPMusKOlh9FeRpqckIjE8EPGMyNHY6lKna4a0nQcYUXWKr54xMxT"
         "bFr8P0Tz7aUyuYDOJxOwEv33KAm0APY5k9XSdIF4DuAjkAfBEnJpvFmx0k2xJBWh0MAf8xfWdGfmPqYoPsCBW8uhbRpr3GVH+1JYloJo8NvX0i0J"
         "ad98HUdowiGn9GWN8ap8gMhYeoNSEylpIgZUMNFotsvMjK0UNctwV3K8j6dxjxJRAwr3ztrZEfzgruxR5ntv02iK/5dwGV/9Jpw2EmoIroPA+D86"
         "GBLyAduCRsWKq4qMLgsvmLFWplrFEbqZ/eAAWVDxgVEKptyjPKs1XK1eSrOi/dD/J1Pc4//hHjCZN8JdSqitPJydWsYmeabqWp7v8JFMoUmiR3I+"
         "ogMBoNOEEOACc5gn66qwktaB8pB5MMvhZUL7ltuHFtbaCmL3q/FVXs6gng7vNCrNiFf1P/bOJ/1HVtsWlK6Knx8OP+biTxr2qOR6c7YEil6yb9gD"
         "Ybr1JYpUB+NbDJfMWg289n0C9keFB7jX/rhKRrHR6zzwTGw91O99tzEXzpY3H0Xor7ZTJq9IB5YzZULlaL9++fz/PnlLAygZTNgoYwts9DJOipnQ"
         "CRayOUcYRgB7XCnAEfm2rUovFwthINtXBi7ntc24JojfmOF4TWOPWIWlU8aYjcqBkZjk9R2UBJC8Qr4yZArI/p5+JRcwX86zXBbOOhnNbAO6ycFi"
         "LYEwliyTQLkjIdbbeIrKjcP3wlyYbhmxa+xQ2KugiGNpGNNUKtxy9DexJBX4vYccy9T3RpUhDf4HjAAJNzMA6PRXAGmyGewXzJfZIrgoCMkiJr9u"
         "qoRzX1GAIwD2JOY1CbcpohckSO0cZI9aQt8OQnp/KyWlH4sEXQgQMta/ywrFztudzSSZLzRlw2Bz0tg+Yxm/zwjHMs4NC24Mc88bQqzMFQpcnNT3"
         "jKVwoKZd7yFKVOFWoYMBSnkSb3uQbxQowE5z5q5GFGTG6gtnODtSIjD2henVGG+1OWG2cOvxTOJlRS6InTcQyMOg7O2p5kBlTaQW6FgHWSgtCFDP"
         "lQt5gDPGFwECTrGdVsWvfQamGn5b3oolc/g0YOJg2HWtUBDNqhzNYrnEwTympLIhh5HFgvYVOqV4mcNEYc8Vr3fxJ2kLRKsNAoIJGO7MdBQ7TMHm"
         "5uElKOcAY0+agahxWycBQGRGF/E69kHwNVieXs0no6PwGl6zCPNmvruXyyv6K3a0MoI0oaU9F3uHXApE7BgqVgyOwj+TKq8tMMDL2op53+uJAsBA"
         "XwMbCTmwh7uwstimAaCxnkAzeUr4pEOpmG2xefcCK79d0QlAe4yMptCYTcIwOB0bTaOHGjKvOe8ljzuDgCJtRarWth3buoZk5x1LKq+APCLORtdL"
         "9JlwkfaExRC2Q2mbjpbhPfkLgO9R9oDX6UbcQ2bgqfG5RIPlESmoPt42hR0g5194P+9cYAZMAK+v8FXVEFEn+sSBgEGj62ZCJAls1lJYo3N10tiH"
         "9auBCyTamkWMBOwljN8aSqPCGeFWeuUgllkrORvxoi2l2v0PNVPsK23NeVdfZEQw4sSSVw/MJ2gwMI+wbry9idX0LKaUmmORZctWFQCHQuV2ezpN"
         "ZiM6h13mqlifWAcKVkZsNLHuUizWa+9D/tzI5w0BHwvgBgeGL7Vku3Q2cSqJc8kHknrfY+KsZA3xlNzxZeXYuR58QJ7LC1YnmfS/0L6+f1T5Xw46"
         "sWgvo8NaHEh57Q1HmPGrZxO8+9/rHAnTGt9GHvMNl4G8O5wwTVYi6cAiEepNmRUfySjA6IUemD1Kym2Y9Hz2+3LD8uB1ddGLjZfQ0HGFj1uGuLWW"
         "jOG94z3ua9uU/EV/1bBvXkbL2Qb5ShmwNs2F9FBEZZIAjRoMhx7oUlDVKODHY713kmTU1rDeE5ip1f5/pTIBwBkcMOy7YtE1Z3+YCNIQPAiGvQpf"
         "kAP+rqdmhevdF80NeAdeRCMdVaBoU2chUtfqvQlHaMopDCqPAoekFROQA5aKtawXr5oOy72hCA1Q3ueS26H8nqMUpIdHS4tpMr0G7/vvJWPLMEg3"
         "tbFwb/+q67LQthjZhxWdrZYCWIhDxpHm6B8FelQhAHbT3KS/btzlWf0tDqmpuHysC9rBsDCXuQPDoTFLYGtWDhGaE77Hb+XJ9o7x7Jv5FfGtsEys"
         "8qLxqNEqcUglKmeSNksLrXgmcCX1/WqjEbR3X1rbCHHe3Plz2ZlSGJg2DI2cMDOBfRyKUTg+MA/7z/Yo8Yr39712jfe3/81lJ1mdTvFfUqsMSNRQ"
         "m9TKJy4VElkJ9oSjCTTgcrRCh8jtOQ7btbYblR2rmYcWkMW5fOjUSKGLZsoaGc0sAcSo+wt86M/e4v/w5ZD9ALS7Aj+YMizSVmpPj12pgFTXXiuw"
         "QE5nlURgGmtfS98kyYTVtlMBvPAqUmmaiyvSEmIaGOpp9glJdZFiS8qQPeAO9DPC42BOLiUPBHIS9SpyI1ydcun+6BUEb8VHLILYxPWWthyMypS2"
         "I14JQnBz7J0SV3Wnav4y3rLquveWNCAwoKOqBIDVgJWpOt3wKzwqxs6ZahQoW/NHBJ26umV51oTUyctRa4oPtsUEm0yEgNhDp8UbyFIKR7DtWMFe"
         "xwwgrphuWQB7ljxSW6ZJRkQ/XMFaIB2g9/zmix8nSsOKO6ukiqXDUd7S+j1BOwucmRdvRT7OpuJgHKHf7hElOr2AnTPzIg6jIHFJXugSHBS74rvA"
         "3xaviFdx42QysgNFCGA01NevEzJCbVBO2XFLh1SCm+SKUFsGwBD3jr1zQIrkbuy3ym38Dn9N+vcmthLCg4LJhZIwmCBjK4ycK/kN8QJ/I46ORogM"
         "LAbB7TaXn3flWm7HkoK50d6iqpdfICMFFm4qMKgqeFmpi1OqKd5cDfgCnu24KO+CgSYSJLfK1PJCcW0jcWsegkPtYr64LSyXrMDuWaWOADrp19Zy"
         "T4gsv3qRnRvHz5Rpw8dRHA1bVJe7u5LIEXF7UJAxGdMNeV/15UBsUReGZA5fGbhFUX1UHWUZl/c3vzm/wP6J8C5OUSRoYzdv9Ou/dwC+PaKWcpwo"
         "p2/Ptf2mtFC4mQrvGkwpm9+lExDcCZeqTXBHCspqN6YkB9h1mtDmxD1GeFtgGWnqPx7+/jT4csq0DU2XvLHhfCif78fv5S3DfjzuBf1405l4oHxu"
         "k7qE0q2oPW7RaAxYNQd9K/G4up+muQOmOyZowbgcU7RxEcDMIjATetm+OcSW7wLcYHD5mofevL7ON9eko3T/MZ6Dt6msWQrgM5lb4oDKWIL0/4NR"
         "6UpwkhNDGZ4jVL2NDt/7GpdDE7RrI1w+RRv6KkF3pFLpuqMZKS/MAnGYK7S8c9Z9CxZwpznvn60mPA7ZglymL0G4CpHVtvEKBeZe2SFfpD2+4VYL"
         "u6bovifNmYNG+urD7dw4xabzaguBCe7NXtZGslUoV0Izv1fBGe4tC7wVL0TGfyuUjhgFWxCQGp1p0Qt8giwTKNANR4t/YwDJy7c6w7TmOQN9gCJ6"
         "Nrtp3jJCBgs5QbkAwD6O/O83R0olFgdDWp6k7h6I2hIke9MfAKolA2MAJIIwmKbsPsoY7M8sk2EQ6mltXT5xOU1c9gXrC18LcMGogBgRdFY7y3ai"
         "DFJJIl6iy4ho3yxU050O88ym3qiuJr4If1VEoNKwMPhLTljg42uezzGyKfUCI2McszElsw+q8Z1tAtC6voNu8GySrW1XRFMJJFXEfpvuMmAiU59i"
         "ZIvplPyOw0bvefvCLO5cNX50OFbaAdkIcbsG0KHtX5qlOlFUf/XdknrfJwQMG9t0UZtEG/XvCKJJeIZ47lbpJN8+0C+RbYP81gEWMQHjF9hAtiDM"
         "b+GewQ1muvwRvlWkhbILLogM/We3T1bKpvHcEA8d5+5i5+0y14tjLohpHybmd9zBSlpIk1Tcn/c5BDVArKDEfWNm6lsmeM9kp2zjzvjuy/leSrs+"
         "iKrscPXxAmGem5WAFr83doJ5+CdD63B1ThM+afub/TXXnD5nv9mroOGTcKWNCp2Cnltoix9CX1Eh614ToMr+77LHijzLZgbnJIMGAA=="),
        "4fd86bfc84b2979307ed0ed9d7303ec0fc64b265ffbda9c54f180ba04fb8783f", 43, 54),
    "webp_pillow_alpha": (
        ("UklGRsgCAABXRUJQVlA4WAoAAAAQAAAATAAAKgAAQUxQSCQAAAABuQpE9D+goG0bpo8/7D0Ci5gAoWmCybY70Czq6xW3rID/JABWUDggfgIAAPAQ"
         "AJ0BKk0AKwA+WSSPRaOiIZ3c7gA4BYS2AE6ZQjpLzb8h/YEqr9b10KdPIsGd/PvsDfq900fNF+w9jk/szWqIhbETYS5h9v3NOBU0+5DA38nxm6YC"
         "Wv9c5zipBfcCEbJdbcDWzMHNU7SGj0rbt7It2/cKHUyXT9kT0RDErfRCwMgWQFxEG1/vtcToqL6C2AD+9e8Swe8xfv3yuy0gR0MYw//lxZn9pHVC"
         "W8kx2uH/zKB6sPHdNMoGnSNu+wfsCSwTNrktUmHy5iqIUoaoWCmImRAbrLJywxzYQ/3NK8w7XFGN1lC2Ul58kJsKox4XlLecP1AgSq7X4iRJQQ4p"
         "b1u/dy7SLekYFrDaNq1LC0iRug+LD23kHkgqE79RCu4xLZ+IWfg80E6FfpPsmpDuN1/Yd1MDW/zOFxbcxN8/OiVKcJrMnmn62C2TagZ+d4pllvXy"
         "OcxU/SZVyId5SepMZEX8EI1CuHd+VUGw0o4c1f1610vvi+MpcH+QajPVMVN2hpSfqqN7y4ot0eBN1Ic2XEhFYfFB+dB2wcQtJr6b1vr2V4E2USRQ"
         "bS/+7ZczaNVLoATa64BV3VwnMVWj+psOgfLUwm4UXgpC6lo/uwzJLgZvfL4rJiaBspTZ/0b/rMqy8N4WfxaOY+nvZk2K2mhun06oUvABYIDJlN+y"
         "Ecw4R2rrb9GfqBQlzJbsIbcw7m3/IF1C4EDnfvQxZCfSJPp51aSP4U9niJbGOf1x84aD7soQPy4dEN7rO9pryMDMlvenv3Vxvug0gNgYz9NiDLtm"
         "qb6320fjnvyJYOnl9qxOHGkl4/z5MkcfCOuugWr1rVecvSSMYTq5GWL7FDrfIgAA"),
        "32490bb75cb0d0790e4a545a2d34420cd67b4c9d5dbf7a688c8538ea7fa82233", 77, 43),
    "webp_pillow_animated": (
        ("UklGRmoFAABXRUJQVlA4WAoAAAACAAAAOQAAKgAAQU5JTQYAAAAAAAAAAABBTk1GngIAAAAAAAAAADkAACoAAGQAAAJWUDgghgIAAJANAJ0BKjoA"
         "KwA+jTqZSCUjoqEytJ5goBGJbF2cLbYTdHdQ8mWB/EP7l5i/9bxYJAlv4x+JumAfxj8gNcA/rv43Wyr5gP6B5AtAn6Rf5r+wTpjCOWvUvMYpT9j2"
         "NAk1b31Mfnbek+bOvyAtFBYfv4EqeeK6cAD+0DZEjsUv/u8F+udcwSwx+J8myj1URMJxRg6RobmH++8Ttp6ttnMmxzuBOaWDgdTEhtra38bnP5/4"
         "YnSd9N/uV5dWtNgx6mosCeJOnGx5vQ65/9HBnoMjWsFeVzPpXR3X5MPxl/FF3bg5wbpac5iwROgDFdNObMAXg7XcLItQJ4+45f5ITHwXvEzPfXGa"
         "228q04Ze/pH9b2/o37KWuSGnoCQ262N2M/MiIkrHmgveE4Q/Rd7tv9NFzPGE63eXsWn0tqfxVJ3XBkfoPN9ST6c9T/TH5BiQrTJU2CK1Bi/pVbHb"
         "ez8Ho5SbTJ3/5nvdS6cBldHpkUQdODF1P6O7eEo6DVPNdY84LzZ9IFKM9bzv/rC/Zk6ZmwSngC9DCvmkIED7jz/OryOTMpGh6YfRlHTQm5CoQ27U"
         "+74J3j/pXWfpGciv/+tuNa0OItPBAQJwdoqJIFIWhLIH6UB/CfxJPYBlwkzAgmJOBW7H1bNtfQxh87/8t8FVNtu0F05IOZ4efnxA7t4X5u0ao2Xk"
         "0JEoLgtq+6U4ENOHtYGAtpXEHCnR+m3NaFqQ0KCqBh1LCZJ4TKT+Hhiz1hUaMl6N1buI0ynNjS4OjcA1hk5UBeucL08j5nfeHjX15GCqmyHTo2Aq"
         "+LbssJ24mfdzsodoSJrualO0XvALG2MqE290lgOepfiK26RDS04m0BlPf550udZAAABBTk1GmAIAAAAAAAAAADkAACoAAGQAAABWUDgggAIAAHQN"
         "AJ0BKjoAKwA+hTKVSAPVi4AAAQiWw9E6UG8q5Z5PsT+If3jzGP6xitDMAzy38v/DnTAP4x+QGuAf0b8gLZV8un9J+2b2BaBP0k/z39TnTGEcDete"
         "YJUX6bs7RMq2Pqm/Nm8w82VfjhRuyYkHDwE6Ad0AAP7hJ5Q5Q0Z/vjA9qbcL5Pp1f4rzDcrOWd7Dq3PkPBL9uODTK07mJcH4m6lEdOAZKpZwQ+Rx"
         "fwdKk9McU4QvFzxG1nnffy8Kxe+tc8n68/kaqFXkDcGIZzefYBVfeb897rAvGLmYg/7/uT7v+IKBbfBONwvXUirRroB47k3hSupwOo5mH6Bq/1vY"
         "S0/JsLrPOcMbspDDrPSj9g5qPOOKzA1DDIbMMych9oQvQQiw8DcV9jX9JRaMkkWoGRmxzOwe+Lp2aafi3y3SPEC0lpJepU+cr8VRLgaq32/HThdx"
         "9ja5FgGv6E/jqtKk0/vzCMxT8bLAJ0/zvVug/MkNhVMQiZrtNbmqLwF23UL//hihLRtk8YfBiuKRxO97ApM8Ol5s0BFPKJr4xuIfzkqY1ztpeeLl"
         "k9TSS9ffnlXEfRH/9yXT8d7nkT7WqnwLqOthtGC/i0GYe9R/SKmICsGWN+G8UXd+jDD91+t8SO/59CFvRVj85j668MBlh13yl9MNk7TvBFqUa0lF"
         "kfI4FtJSxR6ivx9QJFBt9nOWNLfd743g4rjFkpldEpjibnxjG2DGW5JhaGAQOIvyiKeD2mlDQzVG4COUSYpcZCyueC0biMKCEVFb2XoJexwdIwdE"
         "4goUpx1bG4JvuPr+TCi+JUElV+jTaZRv984GiUivRMDmAlStbsfguzQS5zMkLsZQAAA="),
        "7b88bc139ba7ec8d63a5f9ae094ff1fb57a566d710d01905e9e6ae8db0b88c89", 58, 43),
}


# --- the fixture: an M-BEIR tree of JPEG files, captions, a BPE merges file and a BERT vocabulary


def fixture_image(seed: int) -> np.ndarray:
    """A seeded smooth colour field with a little noise: short side IMAGE_SHORT_SIDE, long side 256..512."""
    rng = np.random.default_rng(seed)
    side = int(rng.integers(IMAGE_SHORT_SIDE, 2 * IMAGE_SHORT_SIDE + 1))
    h, w = (IMAGE_SHORT_SIDE, side) if rng.random() < 0.5 else (side, IMAGE_SHORT_SIDE)
    grid = rng.integers(0, 256, (7, 7, 3)).astype(np.float64)
    ys, xs = np.linspace(0, 5.999, h), np.linspace(0, 5.999, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    img = (grid[y0][:, x0] * (1 - fy) * (1 - fx) + grid[y0 + 1][:, x0] * fy * (1 - fx)
           + grid[y0][:, x0 + 1] * (1 - fy) * fx + grid[y0 + 1][:, x0 + 1] * fy * fx)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


# a fixture file's name suffix by form: png_* .png, the rest .jpg
FORM_SUFFIX = {"gif": "gif", "bmp": "bmp", "webp_lossy": "webp", "webp_lossless_alpha": "webp", "webp_alpha": "webp",
               "tiff": "tif", "tiff_zstd": "tif", "tga_rle": "tga", "qoi": "qoi", "dds_bc7": "dds", "psd_rle": "psd", "jp2_lossless": "jp2",
               "j2k_irreversible": "j2k", "ftex_bc1": "ftc", "flc": "flc", "avif": "avif"}


def colour_cube(img: np.ndarray) -> tuple:
    """uint8 indices of `img` in a 6 x 6 x 6 colour cube, and the cube's 216-entry palette."""
    level = img.astype(np.int64) * 6 // 256
    cube = bytes(int(51 * v) for i in range(216) for v in (i // 36, i // 6 % 6, i % 6))
    return (level[..., 0] * 36 + level[..., 1] * 6 + level[..., 2]).astype(np.uint8), cube


def cmyk_planes(img: np.ndarray) -> np.ndarray:
    """The CMYK a file holds for an RGB image (Adobe's inverted samples): the inks with the grey in K."""
    ink = 255 - img.astype(np.int64)
    k = ink.min(axis=2, keepdims=True)
    return (255 - np.concatenate([ink - k, k], axis=2)).astype(np.uint8)


def fixture_file(form: str, seed: int) -> bytes:
    """The bytes of one image file of the tree: `jpeg` (the writer above, Pillow's defaults), a progressive
    JPEG of PROGRESSIVE_FILES, a PNG of `fixture_image(seed)` through every scanline filter: `png_rgb`,
    `png_palette` (a 6 x 6 x 6 colour cube), `png_grey`, `png_rgba` (Adam7-interlaced) or `png_rgb16`
    (the image in the high bytes, seeded noise in the low ones); `gif` (the colour cube, interlaced, a
    transparency index), `bmp` (the colour cube in RLE8); `jpeg_cmyk` / `jpeg_ycck` (the image's CMYK, Adobe
    transform 0 / 2, Y and K at 2x2 in YCCK) and `jpeg_rgb` (Adobe transform 0: RGB as stored); WebP from
    `webp_bytes`: `webp_lossy` (VP8, coded closed-loop), `webp_lossless_alpha` (VP8L of the image with a seeded
    alpha plane, exact) and `webp_alpha` (VP8X: a VP8 frame and a VP8L-coded ALPH chunk); `tiff` (LZW, the
    horizontal predictor, 32 x 32 tiles, big-endian), `tiff_zstd` (ZSTD strips, the horizontal predictor),
    `jpeg_arith` (arithmetic-coded, libjpeg's simple
    progression, quality 90), `tga_rle` (24-bit RLE, bottom-up), `qoi` (RGB), `dds_bc7` (BC7 mode 6 blocks,
    `bc7_mode6`), `psd_rle` (RGB, PackBits rows), `ftex_bc1` (FTEX of BC1 blocks, `dxt1_encode`), `flc` (the
    colour cube's indices in BRUN and an SS2 delta, the cube a COLOR_256 chunk), the JPEG 2000 files of
    JPEG2000_QUERIES (the stored corpus's) and `jpeg_damaged` (JPEG_DAMAGE_QUERY of the damaged-JPEG corpus)."""
    if form in PROGRESSIVE_FILES:
        return base64.b64decode(PROGRESSIVE_FILES[form][0])
    if form in JPEG2000_QUERIES:
        return (JPEG2000_CORPUS / JPEG2000_QUERIES[form]).read_bytes()
    if form == "avif":
        return (AVIF_CORPUS / AVIF_QUERY).read_bytes()
    if form == "jpeg_damaged":
        return (JPEG_DAMAGE_CORPUS / JPEG_DAMAGE_QUERY).read_bytes()
    img = fixture_image(seed)
    if form == "jpeg":
        return jpeg_bytes(img)
    if form == "tiff":
        return tiff_bytes(img, 2, compression=5, predictor=2, tile=(32, 32), order="MM")
    if form == "tiff_zstd":
        return tiff_bytes(img, 2, compression=50000, predictor=2, rows_per_strip=16)
    if form == "jpeg_arith":
        return jpeg_bytes(img, 90, coding="arithmetic", progressive=True)
    if form == "tga_rle":
        return tga_bytes(img)
    if form == "qoi":
        return qoi_bytes(img)
    if form == "dds_bc7":
        return dds_bytes(bc7_mode6(img), img.shape[1], img.shape[0], dxgi=98)
    if form == "psd_rle":
        return psd_bytes(np.ascontiguousarray(img.transpose(2, 0, 1)), "RGB", compression=1)
    if form == "ftex_bc1":
        return ftex_bytes(img.shape[1], img.shape[0], 0, dxt1_encode(img))
    if form == "flc":
        idx, cube = colour_cube(img)
        palette = np.zeros((256, 3), np.uint8)
        palette[:216] = np.frombuffer(cube, np.uint8).reshape(216, 3)
        return fli_bytes("flc_brun_ss2", idx, np.random.default_rng(seed), palette, packets=[(0, 256)])
    if form.startswith("webp"):
        alpha = np.random.default_rng(seed).integers(0, 256, img.shape[:2] + (1,), dtype=np.uint8)
        kind, image = {"webp_lossy": ("lossy", img), "webp_lossless_alpha": ("lossless", np.concatenate([img, alpha], 2)),
                       "webp_alpha": ("alpha_lossless", np.concatenate([img, alpha], 2))}[form]
        return webp_bytes(kind, seed, 0, 0, image=image)
    if form in ("gif", "bmp"):
        idx, cube = colour_cube(img)
        if form == "gif":
            return gif_bytes(idx, cube, interlace=True, transparency=215)
        return bmp_bytes(idx, 8, palette=cube, colors_used=216, compression=BMP_RLE8)
    if form in ("jpeg_cmyk", "jpeg_ycck"):
        return jpeg_bytes(cmyk_planes(img), 90, form=form[5:])
    if form == "jpeg_rgb":
        return jpeg_bytes(img, 90, form="rgb")
    rng = np.random.default_rng(seed)
    if form == "png_rgb":
        return png_bytes(img, 2)
    if form == "png_palette":
        level = img.astype(np.int64) * 6 // 256
        cube = bytes(int(51 * v) for i in range(216) for v in (i // 36, i // 6 % 6, i % 6))
        return png_bytes((level[..., 0] * 36 + level[..., 1] * 6 + level[..., 2])[..., None], 3, palette=cube)
    if form == "png_grey":
        return png_bytes(img.mean(axis=2).astype(np.uint8)[..., None], 0)
    if form == "png_rgba":
        return png_bytes(np.concatenate([img, rng.integers(0, 256, img.shape[:2] + (1,), dtype=np.uint8)], 2), 6,
                         interlace=True)
    if form == "png_rgb16":
        return png_bytes((img.astype(np.uint16) << 8) | rng.integers(0, 256, img.shape, dtype=np.uint16), 2, 16)
    raise ValueError(f"unknown fixture form {form}")


def fixture_pixels(form: str, seed: int) -> np.ndarray:
    """What `Image.open(...).convert("RGB")` gives for `fixture_file(form, seed)` where the writer alone
    says it (a PNG: the samples it wrote, as Pillow converts them): an oracle beside the twin."""
    img = fixture_image(seed)
    if form in ("png_rgb", "png_rgba", "png_rgb16", "webp_lossless_alpha", "tiff"):
        return img
    if form == "png_grey":
        return np.repeat(img.mean(axis=2).astype(np.uint8)[..., None], 3, axis=2)
    if form in ("png_palette", "gif", "bmp"):
        return (img.astype(np.int64) * 6 // 256 * 51).astype(np.uint8)
    raise ValueError(f"no oracle for {form}")


def write_fixture_image(job: tuple) -> None:
    path, seed, form = job
    with open(path, "wb") as f:
        f.write(fixture_file(form, seed))


def twin_digest(path: str) -> str:
    """sha256 of the twin decoders' pixels of the image file at `path` (a worker of the fixture's pool)."""
    import hashlib

    from uniir_tpu_torch.data import jpeg

    return hashlib.sha256(jpeg.read_image(path, "cpu").tobytes()).hexdigest()


def fixture_words(rng, n: int) -> list:
    syllables = [c + v for c in "bcdfghjklmnprstvwz" for v in "aeiou"]
    words: dict = {}
    while len(words) < n:
        words["".join(rng.choice(syllables, size=int(rng.integers(1, 5))))] = None
    return list(words)


def learn_merges(texts: list, n_merges: int) -> list:
    """Byte-level BPE merges learned greedily from `texts` as CLIP's tokenizer splits them (the most
    frequent pair first, ties to the larger pair)."""
    from uniir_tpu_torch.data.tokenizers.clip_bpe import _clean_text, bytes_to_unicode, words

    enc = bytes_to_unicode()
    freq = Counter("".join(enc[b] for b in w.encode()) for t in texts for w in words(_clean_text(t)))
    seqs = [list(w[:-1]) + [w[-1] + "</w>"] for w in freq]
    counts = [freq[w] for w in freq]
    pairs: Counter = Counter()
    where: dict = {}
    for i, s in enumerate(seqs):
        for p in zip(s, s[1:]):
            pairs[p] += counts[i]
            where.setdefault(p, set()).add(i)
    merges = []
    while len(merges) < n_merges and pairs:
        best = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))[0]
        merges.append(best)
        for i in sorted(where.pop(best, ())):
            s = seqs[i]
            for p in zip(s, s[1:]):
                pairs[p] -= counts[i]
                if pairs[p] <= 0:
                    del pairs[p]
            merged, j = [], 0
            while j < len(s):
                if j + 1 < len(s) and (s[j], s[j + 1]) == best:
                    merged.append(s[j] + s[j + 1])
                    j += 2
                else:
                    merged.append(s[j])
                    j += 1
            seqs[i] = merged
            for p in zip(merged, merged[1:]):
                pairs[p] += counts[i]
                where.setdefault(p, set()).add(i)
    return merges


def write_entry_point_tree(root: Path, pool) -> dict:
    """The M-BEIR tree (queries, candidate pool, qrels, instructions, train split, image files: the
    writer's JPEGs, and P12_FORMS' PNG and progressive JPEG files) under root/mbeir_data, a merges file and
    a vocab.txt under root; images written by `pool`'s workers.  Returns what the checks need."""
    from uniir_tpu_torch.data.registry import MBEIR_TASK

    rng = np.random.default_rng(P12_SEED)
    mbeir = root / "mbeir_data"
    for sub in ("query/test", "query/union_train", "cand_pool/local", "cand_pool/global", "qrels/test",
                "instructions", "mbeir_images/mscoco_images"):
        (mbeir / sub).mkdir(parents=True, exist_ok=True)
    vocab = fixture_words(rng, P12_WORDS)
    weights = 1.0 / np.arange(1, len(vocab) + 1) ** 0.8
    weights /= weights.sum()

    def caption(i: int) -> str:  # unique by its number: no two rows embed alike
        return " ".join(rng.choice(vocab, size=int(rng.integers(4, 12)), p=weights)) + f" {i}"

    jobs, cands = [], []

    def image_path(name: str, seed: int, form: str) -> str:
        path = f"mbeir_images/mscoco_images/{name}.{'png' if form.startswith('png') else FORM_SUFFIX.get(form, 'jpg')}"
        jobs.append((str(mbeir / path), seed, form))
        return path

    for i in range(P12_CANDS):
        modality = ("text", "image", "image,text")[i % 3]
        entry = {"did": f"{P12_DSID}:{i}", "modality": modality, "txt": caption(i) if modality != "image" else ""}
        if modality != "text":
            entry["img_path"] = image_path(f"cand_{i}", P12_SEED + 1000 + i, P12_FORMS["cand"].get(i, "jpeg"))
        cands.append(entry)

    def query(j: int, qid: str, kind: str, form: str) -> dict:
        valid = [c for c in cands if f"{kind} -> {c['modality']}" in MBEIR_TASK]
        pos = valid[int(rng.integers(0, len(valid)))]
        q = {"qid": qid, "query_modality": kind, "query_txt": caption(P12_CANDS + j) if kind != "image" else "",
             "pos_cand_list": [pos["did"]], "neg_cand_list": [],
             "task_id": MBEIR_TASK[f"{kind} -> {pos['modality']}"]}
        if kind != "text":
            if j % 4 == 1 and "img_path" in pos:  # a query that shows its positive's image
                q["query_img_path"] = pos["img_path"]
            else:
                q["query_img_path"] = image_path(f"query_{qid.replace(':', '_')}", P12_SEED + 5000 + j, form)
        return q

    queries = [query(j, f"{P12_DSID}:{j}", P12_QUERY_KINDS[j % 4], P12_FORMS["query"].get(j, "jpeg"))
               for j in range(P12_QUERIES)]
    train = [query(P12_QUERIES + j, f"{P12_DSID}:{P12_QUERIES + j}", P12_QUERY_KINDS[j % 4],
                   P12_FORMS["train"].get(j, "jpeg")) for j in range(P12_TRAIN_QUERIES)]
    writing = pool.map(write_fixture_image, jobs, chunksize=16)

    def save_jsonl(path: Path, rows: list) -> None:
        path.write_text("".join(json.dumps({k: v for k, v in r.items() if k != "task_id"}) + "\n" for r in rows))

    save_jsonl(mbeir / f"query/test/mbeir_{P12_DATASET}_test.jsonl", queries)
    save_jsonl(mbeir / f"cand_pool/local/mbeir_{P12_POOL}_cand_pool.jsonl", cands)
    save_jsonl(mbeir / "query/union_train/mbeir_union_up_train.jsonl", train)
    save_jsonl(mbeir / "cand_pool/global/mbeir_union_train_cand_pool.jsonl", cands)
    (mbeir / f"qrels/test/mbeir_{P12_DATASET}_test_qrels.txt").write_text(
        "".join(f"{q['qid']} 0 {q['pos_cand_list'][0]} 1 {q['task_id']}\n" for q in queries))
    keys = sorted({(q["query_modality"], cands[int(q["pos_cand_list"][0].split(":")[1])]["modality"])
                   for q in queries + train})
    (mbeir / "instructions/query_instructions.tsv").write_text(
        "query_modality\tcand_modality\tdataset\tdataset_id\tprompt_1\n"
        + "".join(f"{qm}\t{cm}\tMSCOCO\t{P12_DSID}\tFind a {cm.replace(',', ' and ')} that matches this {qm}.\n"
                  for qm, cm in keys))
    texts = [c["txt"] for c in cands] + [q["query_txt"] for q in queries + train]
    merges = learn_merges(texts, P12_MERGES)
    (root / "merges.txt").write_text("#version: seeded from the fixture's captions\n"
                                     + "".join(f"{a} {b}\n" for a, b in merges))
    pieces = [f"##{c}" for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    bert = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *".,!?", *"0123456789", *"abcdefghijklmnopqrstuvwxyz",
            *pieces, *sorted(vocab), "find", "a", "an", "and", "that", "matches", "this", "image", "text"]
    (root / "vocab.txt").write_text("".join(f"{w}\n" for w in dict.fromkeys(bert)))
    list(writing)
    return {"mbeir": mbeir, "cands": cands, "queries": queries, "train": train,
            "images": sorted({p for p, _, _ in jobs}), "forms": {p: (form, seed) for p, seed, form in jobs},
            "n_merges": len(merges)}


# --- configs: the shipped YAML files, changed only where the fixture forces it


def flat_items(d, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat_items(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def fixture_configs(root: Path, phase: int = 12) -> dict:
    """name -> path of each YAML file the runs read, written by the port's writer from the shipped file
    the port's reader read, with the keys the fixture forces; prints the keys changed."""
    from uniir_tpu_torch.core import yaml_subset

    shipped = {name: yaml_subset.load(REPO / path) for name, path in P12_CONFIGS.items()}
    cfg = {name: json.loads(json.dumps(d)) for name, d in shipped.items()}  # copies without the aliases

    def serve(d: dict, ckpt_name: str, extra: dict) -> None:
        e = d["embed_config"]
        e["test_datasets_config"]["datasets_name"] = [P12_DATASET]
        e["test_datasets_config"]["correspond_cand_pools_name"] = [P12_POOL]
        e["cand_pools_config"]["cand_pools_name_to_embed"] = [P12_POOL]
        d["dataloader_config"]["batch_size"] = P12_BATCH
        d["model"]["ckpt_config"]["ckpt_name"] = ckpt_name
        d["model"].update(extra)

    serve(cfg["embed"], "clip_sf_large.pth", {"clip_bpe_path": str(root / "merges.txt")})
    serve(cfg["blip_embed"], "blip_sf_large.pth", {"bert_vocab_path": str(root / "vocab.txt")})
    cfg["index"]["index_config"]["cand_pools_config"]["cand_pools_name_to_idx"] = [P12_POOL, "UNION"]
    test = cfg["retrieval"]["retrieval_config"]["test_datasets_config"]
    keep = [i for i, (name, pool) in enumerate(zip(test["datasets_name"], test["correspond_cand_pools_name"]))
            if name == P12_DATASET and pool in (P12_POOL, "UNION")]
    for key in ("datasets_name", "correspond_cand_pools_name", "correspond_qrels_name", "correspond_metrics_name"):
        test[key] = [test[key][i] for i in keep]
    train = cfg["train"]
    train["dataloader_config"]["train_batch_size"] = P12_TRAIN_BS
    train["trainer_config"]["num_train_epochs"] = 1
    train["model"]["clip_bpe_path"] = str(root / "merges.txt")
    blip_train = cfg["blip_train"]
    blip_train["dataloader_config"]["train_batch_size"] = P12_BLIP_TRAIN_BS
    blip_train["trainer_config"]["num_train_epochs"] = 1
    blip_train["model"]["bert_vocab_path"] = str(root / "vocab.txt")
    cfg["retrieval_bf16"] = json.loads(json.dumps(cfg["retrieval"]))
    cfg["retrieval_bf16"]["retrieval_config"]["pool_dtype"] = "bf16"
    cfg["embed_trained"] = json.loads(json.dumps(cfg["embed"]))  # the trainer's checkpoint, served
    cfg["embed_trained"]["model"]["ckpt_config"]["ckpt_name"] = "clip_sf_epoch_0"
    cfg["embed_trained"]["embed_config"]["embed_dir_name"] = "embed_trained"
    cfg["blip_embed_trained"] = json.loads(json.dumps(cfg["blip_embed"]))  # BLIP-SF's trained checkpoint, served
    cfg["blip_embed_trained"]["model"]["ckpt_config"]["ckpt_name"] = "blip_sf_epoch_0"
    cfg["blip_embed_trained"]["embed_config"]["embed_dir_name"] = "embed_trained"
    paths, changed = {}, []
    (root / "configs").mkdir(exist_ok=True)
    for name, d in cfg.items():
        source = name.replace("_bf16", "").replace("_trained", "")
        base = flat_items(shipped[source])
        keys = sorted(k for k, v in flat_items(d).items() if base.get(k, "<absent>") != v)
        changed.append(f"{name}.yaml (from {P12_CONFIGS[source]}): {', '.join(keys)}")
        paths[name] = root / "configs" / f"{name}.yaml"
        yaml_subset.dump(d, paths[name])
    log(f"phase {phase}: config keys changed for the fixture -- {'; '.join(changed)}")
    return paths


# --- the runs


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, the native JPEG, PNG, GIF, WebP and TIFF decoders' and the native
    JPEG encoder's calls, and those the last image pass's workers made (phase 13)."""
    from uniir_tpu_torch.data import gif, jpeg, jpeg_encode, png, tiff, webp
    from uniir_tpu_torch.data.preprocessing import io_utils
    from uniir_tpu_torch.ops import attention as A
    from uniir_tpu_torch.ops import image_ops as I
    from uniir_tpu_torch.ops import mlp as M
    from uniir_tpu_torch.ops import quant as Q
    from uniir_tpu_torch.ops import topk as T

    wrappers = {"K1": A.attention, "K3": A.attention_bwd, "K10": A.attention_splitk, "K2": T.bucket_max_scores,
                "K4": T.bucket_max_scores_i8, "K11": T.bucket_max_scores_i8b, "K5": Q.int8_matmul, "K6": M.int8_mlp,
                "K7": I.fused_preprocess}
    counts = {name: fn.launches for name, fn in wrappers.items()}
    counts.update({name: fn.launches for name, fn in _off_path_kernels()})
    counts["jpeg"] = jpeg.decode_native.calls
    counts["png"] = png.decode_native.calls
    counts["gif"] = gif.decode_native.calls
    counts["webp"] = webp.decode_native.calls
    counts["tiff"] = tiff.decode_native.calls
    counts["jpeg_encode"] = jpeg_encode.encode_native.calls
    counts["pass_decode"], counts["pass_encode"] = io_utils.NATIVE_CALLS["decode"], io_utils.NATIVE_CALLS["encode"]
    return counts


def run_cli(argv: list) -> None:
    """`python -m MODULE ARGS...` as a user runs it, then the launch counts into COUNTS:
    `chip_smoke.py --cli COUNTS MODULE ARGS...` (phase 12 starts it with the stubs on PYTHONPATH)."""
    import runpy

    counts_path, module, args = argv[0], argv[1], argv[2:]
    for name in P12_BLOCKED:
        try:
            __import__(name)
        except ImportError:
            continue
        fail(f"{name} could be imported in a run that must go without it")
    sys.argv = [module, *args]
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    with open(counts_path, "w") as f:
        json.dump(launch_counts(), f)


def run_chain(runs: list, env: dict, logs: Path) -> dict:
    """Run (name, module, args) after (name, module, args), each a process of its own; name -> (return
    code, seconds, counts); stops at the first that fails."""
    out = {}
    for name, module, args in runs:
        t0 = time.perf_counter()
        with open(logs / f"{name}.log", "w") as f:
            rc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--cli", str(logs / f"{name}.json"),
                                 module, *map(str, args)], env=env, stdout=f, stderr=subprocess.STDOUT,
                                timeout=900).returncode
        counts = json.loads((logs / f"{name}.json").read_text()) if rc == 0 else {}
        out[name] = (rc, time.perf_counter() - t0, counts)
        if rc:
            break
    return out


# --- the in-code reference


def in_code_embeds(model, tokenizer, transform, image_size: int, tree: dict, arrays: dict, timing: dict):
    """Phase 2's path over the decoded arrays: the candidates and queries as the datasets give them
    (the fixture's one prompt a key), collated in batches of P12_BATCH with the last one padded, through
    `generate_embeds_and_ids_for_dataset`.  -> {split: (embeddings, ids)}."""
    from uniir_tpu_torch.data.collator import MBEIRCandidatePoolCollator, MBEIRMainCollator
    from uniir_tpu_torch.data.dataset import Mode
    from uniir_tpu_torch.data.registry import format_string, hash_did, hash_qid
    from uniir_tpu_torch.retrieval.embedder import generate_embeds_and_ids_for_dataset
    from uniir_tpu_torch.train.steps import make_embed_step

    prompts = {}
    with open(tree["mbeir"] / "instructions/query_instructions.tsv") as f:
        next(f)
        for line in f:
            qm, cm, _, _, prompt = line.rstrip("\n").split("\t")
            prompts[(qm, cm)] = prompt
    modality = {c["did"]: c["modality"] for c in tree["cands"]}
    t0 = time.perf_counter()
    images = {p: transform(a) for p, a in arrays.items()}
    timing["transform_s"] = time.perf_counter() - t0

    def img(path):
        return images[str(tree["mbeir"] / path)] if path else None

    cand_items = [{"txt": format_string(c["txt"]), "img": img(c.get("img_path")), "modality": c["modality"],
                   "did": hash_did(c["did"])} for c in tree["cands"]]
    query_items = []
    for q in tree["queries"]:
        prompt = format_string(prompts[(q["query_modality"], modality[q["pos_cand_list"][0]])])
        query_items.append({"query": {"txt": format_string(f"{prompt} {q['query_txt']}"),
                                      "img": img(q.get("query_img_path"))}, "qid": hash_qid(q["qid"])})
    step = make_embed_step(model)
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for split, items, collate in (("cand_pool", cand_items, MBEIRCandidatePoolCollator(tokenizer, image_size)),
                                  ("test", query_items, MBEIRMainCollator(tokenizer, image_size, mode=Mode.EVAL))):
        batches = []
        for i in range(0, len(items), P12_BATCH):
            chunk = items[i : i + P12_BATCH]
            batch = collate(chunk + [chunk[-1]] * (P12_BATCH - len(chunk)))  # the loader's pad_last
            batches.append({**batch, "n_valid": np.int32(len(chunk))})
        out[split] = generate_embeds_and_ids_for_dataset(step, batches)
    torch.cuda.synchronize()
    timing["embed_s"] = time.perf_counter() - t0
    return out


def cli_embeds(uniir_dir: Path, embed_dir: str, expt: str) -> dict:
    base = uniir_dir / embed_dir / expt
    return {split: (np.load(base / split / f"mbeir_{name}_{split}_embed.npy"),
                    np.load(base / split / f"mbeir_{name}_{split}_ids.npy"))
            for split, name in (("cand_pool", P12_POOL), ("test", P12_DATASET))}


def hold_embeds(tag: str, cli: dict, ref: dict, phase: int = 12) -> None:
    """The CLI's embeddings against the in-code path's: ids equal, every row's cosine >= P12_COS."""
    for split in ("cand_pool", "test"):
        (emb, ids), (ref_emb, ref_ids) = cli[split], ref[split]
        check(np.array_equal(ids, ref_ids), f"phase {phase} {tag} {split}: the CLI's ids differ from the in-code path's")
        check(emb.shape == ref_emb.shape and bool(np.isfinite(emb).all()), f"phase {phase} {tag} {split}: {emb.shape}")
        cos = torch.nn.functional.cosine_similarity(torch.from_numpy(emb).double(), torch.from_numpy(ref_emb).double())
        log(f"phase {phase} {tag} {split}: {len(ids)} rows, CLI against in-code cosine min {cos.min().item()}")
        check(cos.min().item() >= P12_COS, f"phase {phase} {tag} {split}: a row's cosine {cos.min().item()} < {P12_COS}")


def run_files(results_dir: Path) -> dict:
    return {p.name: {q: [did for did, _ in rows] for q, rows in read_run(str(p)).items()}
            for p in sorted(results_dir.glob("*.txt"))}


def tsv_recall(tsv_dir: Path) -> dict:
    """(task id, metric) -> (pool value, union value) of the retrieval TSV."""
    import csv

    (path,) = tsv_dir.glob("*.tsv")
    with open(path) as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    return {(r["TaskID"], r["Metric"]): (float(r["Value"]), float(r["UnionValue"])) for r in rows}


def in_code_search(uniir_dir: Path, k: int = 10) -> tuple:
    """(found [queries, k] hashed dids, hashed qids): the port's search called in code on the CLI's query
    embeddings and index file (bf16 pool: the ranking the int8 run's guard holds its ids to)."""
    from uniir_tpu_torch.retrieval.index import DenseIndex
    from uniir_tpu_torch.retrieval.search import search_dense_index

    queries, qids = cli_embeds(uniir_dir, "embed", P12_EXPT["clip"])["test"]
    index = DenseIndex.load(str(uniir_dir / "index" / P12_EXPT["clip"] / "cand_pool"
                                / f"mbeir_{P12_POOL}_cand_pool.index"))
    _, found = search_dense_index(queries.astype(np.float32), index, k, pool_dtype="bf16", device=DEVICE)
    return found, qids


def in_code_recall(uniir_dir: Path, tree: dict, searched: tuple = None) -> dict:
    """(task id, metric) -> Recall of `in_code_search`'s ids (searched again where not given)."""
    from uniir_tpu_torch.retrieval.eval import evaluate_recall, load_qrel

    found, qids = searched or in_code_search(uniir_dir)
    qrel, task_of = load_qrel(str(tree["mbeir"] / f"qrels/test/mbeir_{P12_DATASET}_test_qrels.txt"))
    recall = evaluate_recall(found, qids, qrel, task_of, ["Recall@1", "Recall@5", "Recall@10"])
    return {(task, metric): value for task, row in recall.items() for metric, value in row.items()}


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (the first of model name, vendor, CPU part), its architecture
    and the threads this process may run on: decode is host work."""
    import platform

    fields = dict(line.split(":", 1) for line in Path("/proc/cpuinfo").read_text().splitlines() if ":" in line)
    fields = {k.strip(): v.strip() for k, v in fields.items()}
    name = next((fields[k] for k in ("model name", "vendor_id", "CPU part") if fields.get(k)), "not named")
    return f"{name} ({platform.machine()}), {len(os.sched_getaffinity(0))} threads"


def drive_entry_points(results: dict, smi: str, blip_sf_busy_ms: float) -> None:
    """Phase 12 (module docstring): the CLIs from the shipped YAML files over a tree of JPEG and PNG files,
    with yaml, PIL and regex stubbed out of their PYTHONPATH.  `blip_sf_busy_ms`: phase 9's device time of a
    BLIP-SF train step at P12_BLIP_TRAIN_BS pairs, against which the CLI's step reads its idle share."""
    import hashlib
    import multiprocessing
    import random
    import tempfile
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    from uniir_tpu_torch.data import bmp, gif, jpeg, png, tiff, webp
    from uniir_tpu_torch.data import preprocess as P
    from uniir_tpu_torch.data.tokenizers.clip_bpe import CLIPTokenizer
    from uniir_tpu_torch.models.blip_vit import BLIP_VIT_CONFIGS
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import build_model_from_config, seeded_clip_sf
    from uniir_tpu_torch.core.config import load_config

    t_phase = time.perf_counter()
    before = launch_counts()
    WORK.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase12-", dir=WORK) as tmp, \
            ProcessPoolExecutor(max_workers=os.cpu_count(), mp_context=multiprocessing.get_context("spawn")) as pool:
        root = Path(tmp)
        tree = write_entry_point_tree(root, pool)
        digests = pool.map(twin_digest, tree["images"], chunksize=8)
        paths = fixture_configs(root)
        forms = Counter(form for form, _ in tree["forms"].values())
        log(f"phase 12: tree of {len(tree['cands'])} candidates, {len(tree['queries'])} queries, "
            f"{P12_TRAIN_QUERIES} train queries, {len(tree['images'])} image files ({forms['jpeg']} baseline JPEG "
            f"from the writer: Pillow's defaults, 4:2:0, q75; the rest {dict((k, v) for k, v in forms.items() if k != 'jpeg')}), "
            f"{tree['n_merges']} BPE merges, in {time.perf_counter() - t_phase:.1f} s")

        # the decoders: native bit-equal to the twins on every image (the progressive files also to Pillow's
        # digests, the PNG files to the samples their writer wrote); the native rates
        blobs = {p: Path(p).read_bytes() for p in tree["images"]}
        natives = {"jpeg": jpeg.decode_native, "png": png.decode_native, "gif": gif.decode_native, "bmp": bmp.decode,
                   "webp": webp.decode_native, "tiff": tiff.decode_native}
        kind = {p: jpeg.image_format(b) for p, b in blobs.items()}

        def native(path: str) -> np.ndarray:
            return natives[kind[path]](blobs[path], path)

        t0 = time.perf_counter()
        arrays = {p: native(p) for p in blobs}
        one_thread = len(blobs) / (time.perf_counter() - t0)
        threads = int(load_config(str(paths["embed"])).dataloader_config.num_workers)
        with ThreadPoolExecutor(threads) as loader_threads:
            t0 = time.perf_counter()
            list(loader_threads.map(native, blobs))
            many = len(blobs) / (time.perf_counter() - t0)
        differ = [p for p, d in zip(tree["images"], digests) if hashlib.sha256(arrays[p].tobytes()).hexdigest() != d]
        check(not differ, f"phase 12: the native decoders differ from the twins on {len(differ)} images: {differ[:3]}")
        for p, (form, seed) in tree["forms"].items():
            if form in PROGRESSIVE_FILES:
                check(hashlib.sha256(arrays[p].tobytes()).hexdigest() == PROGRESSIVE_FILES[form][1],
                      f"phase 12: {p} ({form}) differs from Pillow's pixels")
            elif form != "jpeg" and not form.startswith("jpeg_") and form not in ("webp_lossy", "webp_alpha"):
                check(np.array_equal(arrays[p], fixture_pixels(form, seed)), f"phase 12: {p} ({form}) differs from "
                      "the samples its writer wrote")
        log(f"phase 12: native decoders bit-equal to the twins on all {len(blobs)} images (the progressive files "
            f"also to Pillow's digests, the PNG, GIF, BMP, lossless WebP and TIFF files to their samples); native decode "
            f"{one_thread:.1f} images/s "
            f"on one thread, {many:.1f} images/s on the loader's {threads} threads (host CPU {host_cpu()}; card {smi})")
        for group, member in (("baseline JPEG", lambda f: f == "jpeg"), ("progressive JPEG", PROGRESSIVE_FILES.__contains__),
                              ("PNG", lambda f: f.startswith("png")), ("GIF", lambda f: f == "gif"),
                              ("BMP (numpy, one decoder)", lambda f: f == "bmp"),
                              ("WebP", lambda f: f.startswith("webp")), ("TIFF", lambda f: f == "tiff"),
                              ("CMYK / YCCK / RGB / arithmetic JPEG", lambda f: f.startswith("jpeg_"))):
            files = [p for p, (form, _) in tree["forms"].items() if member(form)]
            repeats = 1 if group == "baseline JPEG" else P12_DECODE_REPEATS
            t0 = time.perf_counter()
            for _ in range(repeats):
                for p in files:
                    native(p)
            dt = time.perf_counter() - t0
            pixels = repeats * sum(arrays[p].shape[0] * arrays[p].shape[1] for p in files)
            log(f"phase 12: native decode of the {len(files)} {group} files ({repeats} times each, one thread): "
                f"{repeats * len(files) / dt:.1f} images/s, {pixels / dt / 1e6:.2f} Mpixel/s, "
                f"{repeats * sum(len(blobs[p]) for p in files) / dt / 1e6:.2f} MB/s of file (host CPU {host_cpu()})")

        # BLIP's train transform on the host: crop, flip and RandAugment per image, on the tree's arrays
        sample = [arrays[p] for p in tree["images"][:P12_TRANSFORM_SAMPLE]]
        size = BLIP_VIT_CONFIGS[BLIP_SIZE].image_size
        randaug = P.RandomAugment(2, 5)
        random.seed(P12_SEED)
        t0 = time.perf_counter()
        crops = [P.random_resized_crop(a, size) for a in sample]
        t1 = time.perf_counter()
        crops = [np.ascontiguousarray(c[:, ::-1]) if random.random() < 0.5 else c for c in crops]
        t2 = time.perf_counter()
        augmented = [randaug(c) for c in crops]
        t3 = time.perf_counter()
        for a in augmented:
            P.to_normalized_array(a)
        t4 = time.perf_counter()
        train_fn = P.blip_transform(size, is_train=True)
        t5 = time.perf_counter()
        for a in sample:
            train_fn(a)
        transform_ms = (time.perf_counter() - t5) / len(sample) * 1e3
        n = len(sample)
        log(f"phase 12: BLIP's train transform (blip_transform({size}, is_train=True)) on {n} of the tree's "
            f"decoded images, one thread: {transform_ms:.3f} ms an image; split: random_resized_crop "
            f"{(t1 - t0) / n * 1e3:.3f}, flip {(t2 - t1) / n * 1e3:.3f}, RandAugment(2, 5) "
            f"{(t3 - t2) / n * 1e3:.3f}, normalise {(t4 - t3) / n * 1e3:.3f} ms (host CPU {host_cpu()})")
        del sample, crops, augmented

        # the in-code reference: phase 2's CLIP-SF and a seeded BLIP-SF large, saved where the configs look
        clip_cfg = CLIP_CONFIGS[MODEL]
        model = seeded_clip_sf(clip_cfg, DEVICE, seed=SEED, dtype=torch.bfloat16)
        ckpt = root / "checkpoint" / P12_EXPT["clip"]
        ckpt.mkdir(parents=True)
        torch.save(model.state_dict(), ckpt / "clip_sf_large.pth")
        bpe = CLIPTokenizer(bpe_path=str(root / "merges.txt"))
        timing: dict = {}
        ref_clip = in_code_embeds(model, lambda t: bpe(t, context_length=clip_cfg.context_length, truncate=True),
                                  P.clip_transform(clip_cfg.image_size), clip_cfg.image_size, tree, arrays, timing)
        decode_s = len(arrays) / one_thread
        for label, d in (("one thread", decode_s + timing["transform_s"]),
                         (f"{threads} threads (decode only spread)", len(arrays) / many + timing["transform_s"])):
            log(f"phase 12: embed loop, decode + transform {d:.3f} s against embed step {timing['embed_s']:.3f} s "
                f"on {label}: share {d / (d + timing['embed_s']):.4f} (transform {timing['transform_s']:.3f} s, "
                f"{len(arrays)} images, host CPU {host_cpu()})")
        del model
        blip_config = load_config(str(paths["blip_embed"]))
        blip_config.model.ckpt_config.ckpt_name = ""  # seeded by the config's seed, then saved for the CLI
        blip = build_model_from_config(blip_config, DEVICE)
        ckpt = root / "checkpoint" / P12_EXPT["blip"]
        ckpt.mkdir(parents=True)
        torch.save(blip.model.state_dict(), ckpt / "blip_sf_large.pth")
        ref_blip = in_code_embeds(blip.model, blip.tokenizer, P.blip_transform(blip.image_size[0], is_train=False),
                                  blip.image_size[0], tree, arrays, {})
        del blip
        torch.cuda.empty_cache()
        after_reference = launch_counts()
        moved = {k: after_reference[k] - before[k] for k in before
                 if k not in ("K1", "jpeg", "png", "gif", "webp", "tiff") and after_reference[k] != before[k]}
        check(not moved, f"phase 12: the in-code reference launched kernels other than K1: {moved}")

        # the runs, as a user makes them: the run scripts' instruct switch, then the CLIs
        stubs, logs = root / "stubs", root / "logs"
        logs.mkdir()
        for name in P12_BLOCKED:
            (stubs / name).mkdir(parents=True)
            (stubs / name / "__init__.py").write_text(f"raise ImportError('{name} is not installed on this machine')\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = f"{stubs}:{REPO}"
        common = ["--uniir_dir", root, "--mbeir_data_dir", tree["mbeir"], "--device", DEVICE]
        pipeline, updater = "uniir_tpu_torch.tools.pipeline", "uniir_tpu_torch.tools.config_updater"
        eval_yamls = ("embed", "index", "retrieval", "retrieval_bf16", "blip_embed", "embed_trained",
                      "blip_embed_trained")
        chains = [
            [(f"instruct_{name}", updater, ["--update_mbeir_yaml_instruct_status", "--mbeir_yaml_file_path",
                                            paths[name], "--enable_instruct", "True"])] for name in eval_yamls]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(chains)) as runner:
            runs = {k: v for out in runner.map(lambda c: run_chain(c, env, logs), chains) for k, v in out.items()}
        chains = [
            [("clip_embed", pipeline, ["--config_path", paths["embed"], *common, "--enable_embed"]),
             ("clip_index", pipeline, ["--config_path", paths["index"], *common, "--enable_create_index"]),
             ("clip_retrieval_int8", pipeline, ["--config_path", paths["retrieval"], *common, "--enable_retrieval"])],
            [("blip_embed", pipeline, ["--config_path", paths["blip_embed"], *common, "--enable_embed"])],
            [("train", "uniir_tpu_torch.train.trainer", ["--config_path", paths["train"], *common]),
             ("trained_embed", pipeline, ["--config_path", paths["embed_trained"], *common, "--enable_embed"])],
            [("blip_train", "uniir_tpu_torch.train.trainer", ["--config_path", paths["blip_train"], *common]),
             ("blip_trained_embed", pipeline, ["--config_path", paths["blip_embed_trained"], *common,
                                               "--enable_embed"])],
        ]
        with ThreadPoolExecutor(len(chains)) as runner:
            for out in runner.map(lambda c: run_chain(c, env, logs), chains):
                runs.update(out)
        for name, (rc, _, _) in runs.items():
            check(rc == 0, f"phase 12: {name} exited with {rc}:\n{(logs / f'{name}.log').read_text()[-3000:]}")
        results_dir = root / "retrieval_results" / P12_EXPT["clip"]
        int8_run = {"run_files": run_files(results_dir / "run_files"), "tsv": tsv_recall(results_dir / "final_tsv")}
        runs.update(run_chain([("clip_retrieval_bf16", pipeline, ["--config_path", paths["retrieval_bf16"], *common,
                                                                  "--enable_retrieval"])], env, logs))
        rc = runs["clip_retrieval_bf16"][0]
        check(rc == 0, f"phase 12: clip_retrieval_bf16 exited with {rc}:\n"
                       f"{(logs / 'clip_retrieval_bf16.log').read_text()[-3000:]}")
        for name, (_, seconds, _) in runs.items():
            log(f"phase 12: {name} ran in {seconds:.1f} s (a process of its own; yaml, PIL and regex stubbed out)")
        log(f"phase 12: the runs took {time.perf_counter() - t0:.1f} s of wall time, four chains at once")
        moved = {k: v - after_reference[k] for k, v in launch_counts().items() if v != after_reference[k]}
        check(not moved, f"phase 12: this process launched kernels or decoded while the runs ran: {moved}")

        # what the runs launched: each kernel its run implies, no other
        want = {"clip_embed": {"K1", "jpeg", "png", "gif", "webp", "tiff"},
                "blip_embed": {"K1", "jpeg", "png", "gif", "webp", "tiff"},
                "train": {"K1", "K3", "jpeg"}, "trained_embed": {"K1", "jpeg", "png", "gif", "webp", "tiff"},
                "blip_train": {"K1", "K3", "jpeg", "png", "webp", "tiff"},
                "blip_trained_embed": {"K1", "jpeg", "png", "gif", "webp", "tiff"},
                "clip_retrieval_int8": {"K4"}, "clip_retrieval_bf16": {"K2"}, "clip_index": set()}
        # the guard's exact re-run of a batch; CLIP-SF's 3 steps of 32 leave 24 train pairs out, PNG ones maybe;
        # a train pair's positive may be the GIF or the TIFF candidate
        may = {"clip_retrieval_int8": {"K2"}, "train": {"png", "gif", "webp", "tiff"}, "blip_train": {"gif"}}
        for name, positive in want.items():
            counts = runs[name][2]
            log(f"phase 12: {name} launches {({k: v for k, v in counts.items() if v})}")
            check(all(counts[k] > 0 for k in positive), f"phase 12: {name} did not launch {positive}: {counts}")
            stray = {k: v for k, v in counts.items() if v and k not in positive | may.get(name, set())}
            check(not stray, f"phase 12: {name} launched kernels its run does not imply: {stray}")
            for k in ("K1", "K2", "K3", "K4"):
                results[k]["launches"] += counts[k]
        guard = re.findall(r"guard_pass_rate=([0-9.]+), exact_reruns=(\d+)", (logs / "clip_retrieval_int8.log").read_text())
        log(f"phase 12: int8 retrieval guard pass rate and exact re-runs per run: {guard}")

        # the outputs: embeddings against the in-code path, the int8 run against the bf16 run, Recall against
        # the in-code search, the trained checkpoint served
        hold_embeds("CLIP-SF", cli_embeds(root, "embed", P12_EXPT["clip"]), ref_clip)
        hold_embeds("BLIP-SF", cli_embeds(root, "embed", P12_EXPT["blip"]), ref_blip)
        bf16_files = run_files(results_dir / "run_files")
        check(set(bf16_files) == set(int8_run["run_files"]) and len(bf16_files) == 2,
              f"phase 12: run files {sorted(bf16_files)} / {sorted(int8_run['run_files'])}")
        for name, ids in bf16_files.items():
            differ = [q for q in ids if ids[q] != int8_run["run_files"][name].get(q)]
            check(not differ, f"phase 12: {name}: int8 and bf16 runs return different ids for {len(differ)} queries")
        tsv, ref_recall = tsv_recall(results_dir / "final_tsv"), in_code_recall(root, tree)
        check(tsv == int8_run["tsv"], "phase 12: the int8 and bf16 runs' TSV differ")
        check({k: v[0] for k, v in tsv.items()} == ref_recall and all(v[0] == v[1] for v in tsv.values()),
              f"phase 12: TSV Recall {tsv} differs from the in-code search's {ref_recall}")
        log(f"phase 12: Recall@1/5/10 by task (TSV = in-code search, pool = union): "
            f"{ {f'{t} {m}': v[0] for (t, m), v in sorted(tsv.items())} }")
        losses = re.findall(r"loss: (\S+) \((\S+)\)", (logs / "train.log").read_text())
        check(bool(losses) and all(np.isfinite(float(x)) for pair in losses for x in pair),
              f"phase 12: the trainer's losses {losses}")
        trained = cli_embeds(root, "embed_trained", P12_EXPT["clip"])
        for split, (emb, ids) in trained.items():
            check(bool(np.isfinite(emb).all()) and np.array_equal(ids, ref_clip[split][1]),
                  f"phase 12: the trained checkpoint's {split} embeddings")
        log(f"phase 12: trainer losses (median, average) {losses[-1]}; its checkpoint served: "
            f"{len(trained['cand_pool'][1])} candidates, {len(trained['test'][1])} queries embedded")
        check_blip_train_run(root, logs, runs["blip_train"], tree, transform_ms, blip_sf_busy_ms)
        trained_config = load_config(str(paths["blip_embed_trained"]))
        trained_config.uniir_dir = str(root)  # as the CLI's --uniir_dir sets it: the checkpoint's root
        blip_trained = build_model_from_config(trained_config, DEVICE)
        ref_trained = in_code_embeds(blip_trained.model, blip_trained.tokenizer,
                                     P.blip_transform(blip_trained.image_size[0], is_train=False),
                                     blip_trained.image_size[0], tree, arrays, {})
        hold_embeds("BLIP-SF trained", cli_embeds(root, "embed_trained", P12_EXPT["blip"]), ref_trained)
        del blip_trained, arrays
        torch.cuda.empty_cache()
    log(f"phase 12 passed in {time.perf_counter() - t_phase:.1f} s")


def check_blip_train_run(root: Path, logs: Path, run: tuple, tree: dict, transform_ms: float,
                         busy_ms: float) -> None:
    """BLIP-SF's trainer CLI run: K1 / K3 as phase 9 counts a BLIP-SF step (the online and momentum forwards
    through the ViT's untrimmed blocks, K3 once a block), finite losses, the checkpoint's queue pointer at
    the steps' pairs; its step time from the trainer's own log, the host transform's share of it and the
    device's idle share against phase 9's device time of the same step."""
    from uniir_tpu_torch.core.checkpoint import CHECKPOINT_FILE
    from uniir_tpu_torch.models.blip_vit import BLIP_VIT_CONFIGS

    _, seconds, counts = run
    steps = P12_TRAIN_QUERIES // P12_BLIP_TRAIN_BS
    blocks = BLIP_VIT_CONFIGS[BLIP_SIZE].layers - 1  # the CLS-pooled last block stays plain
    check(counts["K1"] == 2 * blocks * steps and counts["K3"] == blocks * steps,
          f"phase 12: BLIP-SF's trainer launched K1 {counts['K1']} / K3 {counts['K3']} times in {steps} steps, "
          f"not {2 * blocks} / {blocks} a step")
    text = (logs / "blip_train.log").read_text()
    losses = re.findall(r"loss: (\S+) \((\S+)\)", text)
    check(bool(losses) and all(np.isfinite(float(x)) for pair in losses for x in pair),
          f"phase 12: BLIP-SF's trainer losses {losses}")
    ckpt = root / "checkpoint" / P12_EXPT["blip"] / "blip_sf_epoch_0" / CHECKPOINT_FILE
    blob = torch.load(ckpt, map_location="cpu", mmap=True, weights_only=False)
    queue_size = int(blob["config"]["model"]["queue_size"])
    ptr, filled = int(blob["queue_ptr"]), int((blob["queue_idx"] != -100).sum())
    del blob
    want = steps * P12_BLIP_TRAIN_BS % queue_size
    check(ptr == want and filled == steps * P12_BLIP_TRAIN_BS,
          f"phase 12: BLIP-SF's checkpoint has queue_ptr {ptr} ({filled} ids filled), want {want}")
    # log_every prints the running averages of the step and loader-wait times at the first step and the last
    timed = re.findall(r"Train Epoch: \[0\] \[\s*\d+/\d+\].*time: ([0-9.]+)\s+data: ([0-9.]+)", text)
    check(len(timed) == 2, f"phase 12: BLIP-SF's trainer logged {len(timed)} step-time lines, not 2")
    (first_s, first_data_s), (avg_s, avg_data_s) = ((float(a), float(b)) for a, b in timed)
    step_ms = (steps * avg_s - first_s) / (steps - 1) * 1e3  # the steps after the first
    data_ms = (steps * avg_data_s - first_data_s) / (steps - 1) * 1e3
    train = tree["train"]
    has_img = {c["did"]: "img_path" in c for c in tree["cands"]}
    images = sum(("query_img_path" in q) + has_img[q["pos_cand_list"][0]] for q in train) / steps
    log(f"phase 12: BLIP-SF trainer CLI ({P12_BLIP_TRAIN_BS} pairs a step, {steps} steps; {seconds:.1f} s for the "
        f"process, three other CLIs running beside it): the first step {first_s * 1e3:.1f} ms, the later ones "
        f"{step_ms:.1f} ms each by the trainer's log, of it {data_ms:.1f} ms waiting for the loader; queue_ptr {ptr}; "
        f"K1 {counts['K1']}, K3 {counts['K3']}; losses (median, average) {losses[-1]}")
    log(f"phase 12: BLIP's train transform on {images:.1f} images a step at {transform_ms:.3f} ms each, one "
        f"thread: {images * transform_ms:.1f} ms, {images * transform_ms / step_ms:.4f} of the CLI's later steps; "
        f"the device's idle share of those steps {1 - busy_ms / step_ms:.4f} (phase 9's device time of a BLIP-SF step "
        f"at {P12_BLIP_TRAIN_BS} pairs, {busy_ms:.2f} ms, against it)")


# ------------------------------------------------ phase 13: the offline M-BEIR construction

P13_SEED = SEED + 130
# source records of each converter's raw tree: images (MSCOCO, CIRR, FashionIQ, Fashion200K, VisualNews,
# WebQA), queries over 4 candidates (EDIS), triplets (NIGHTS), wiki entities and query images (OVEN; InfoSeek
# asks about the same ones); about 600 image files in all
P13_COUNTS = {"mscoco": 110, "cirr": 40, "fashioniq": 40, "fashion200k": 40, "edis": 20, "nights": 20,
              "visualnews": 72, "webqa": 40, "oven": 30}
# the forms the raw images take in turn, whatever name their source gives them (the image pass reads a file
# by its first bytes): the writer's baseline JPEG (Pillow's defaults) most often, then every form the pass
# carries a comment from or converts through another mode
P13_FORMS = ("jpeg", "jpeg_comment", "progressive", "jpeg", "png_palette_trns", "png_comment", "jpeg",
             "gif_comment", "jpeg_cmyk", "jpeg", "ico", "ppm", "jpeg_444", "pgm", "png_rgb", "jpeg", "webp")
P13_SMALL = ("webp", "ico")  # forms written at most 160 px a side (the script's WebP writer is slow)
P13_PLUGINS = ("fits", "flc", "pcd", "iptc", "avif")  # one MSCOCO file of each under a .jpg name, converted by both passes
P13_JP2 = "58_vga_irreversible.jp2"  # MSCOCO's JPEG 2000 file, from the corpus (tests/data/jpeg2000)
P13_CONVERTERS = ("mscoco", "cirr", "fashioniq", "fashion200k", "edis", "nights", "visualnews", "webqa", "oven",
                  "infoseek")
P13_VN_SAMPLES = (12, 3, 3)  # VisualNews' --train_samples / --val_samples / --test_samples a source


def raw_image(seed: int, w: int, h: int) -> np.ndarray:
    """A seeded smooth colour field of w x h with some noise (a photograph's statistics, roughly)."""
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 256, (7, 7, 3)).astype(np.float64)
    ys, xs = np.linspace(0, 5.999, h), np.linspace(0, 5.999, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    img = (grid[y0][:, x0] * (1 - fy) * (1 - fx) + grid[y0 + 1][:, x0] * fy * (1 - fx)
           + grid[y0][:, x0 + 1] * (1 - fy) * fx + grid[y0 + 1][:, x0 + 1] * fy * fx)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def ico_bytes(image: np.ndarray, seed: int) -> bytes:
    """An icon of two entries: `image` as a PNG (the largest, which Pillow reads) and a 16 x 16 24-bit DIB
    with its AND mask."""
    small = raw_image(seed + 1, 16, 16)
    dib = bytearray(bmp_bytes(small, 24)[14:])
    dib[8:12] = (32).to_bytes(4, "little")  # the colour rows and the mask: twice the height
    dib += bytes(4 * 16)
    entries = [(png_bytes(image, 2), image.shape[1], image.shape[0], 32), (bytes(dib), 16, 16, 24)]
    out, offset = b"\0\0\1\0" + len(entries).to_bytes(2, "little"), 6 + 16 * len(entries)
    for data, w, h, bpp in entries:
        out += bytes([w % 256 if w < 256 else 0, h % 256 if h < 256 else 0, 0, 0]) + (1).to_bytes(2, "little")
        out += bpp.to_bytes(2, "little") + len(data).to_bytes(4, "little") + offset.to_bytes(4, "little")
        offset += len(data)
    return out + b"".join(data for data, *_ in entries)


def raw_file(form: str, seed: int, w: int, h: int) -> bytes:
    """The bytes of one raw image file of `form` (P13_FORMS, or `truncated`: a baseline JPEG cut in its scan,
    `garbage`: an HTML error page, which no image reader identifies, `psd`: a PSD header of no mode Pillow
    reads and noise after it, which no reader identifies either, `eps`: a format the port does not decode,
    an EPS header and noise after it (Pillow identifies it and, without Ghostscript, cannot load it), `jp2`: a JPEG 2000 file of
    the stored corpus, P13_JP2, `tiff_zstd`: ZSTD strips with the horizontal predictor, and the forms of
    P13_PLUGINS, `plugin_file`'s)."""
    if form == "progressive":  # Pillow-made files of their own size
        return base64.b64decode(PROGRESSIVE_FILES[sorted(PROGRESSIVE_FILES)[seed % 3]][0])
    if form == "garbage":  # what a scraper saves as the image when the server answers with an error page
        return b"<!DOCTYPE html>\n<html><head><title>404 Not Found</title></head><body>image %d</body></html>\n" % seed
    if form == "psd":
        body = np.random.default_rng(seed).integers(0, 256, 64, dtype=np.uint8).tobytes()
        return b"8BPS\x00\x01" + bytes(6) + (3).to_bytes(2, "big") + h.to_bytes(4, "big") + w.to_bytes(4, "big") \
            + (7).to_bytes(2, "big") + (3).to_bytes(2, "big") + body
    if form == "eps":
        body = np.random.default_rng(seed).integers(0, 256, 256, dtype=np.uint8).tobytes()
        return b"%%!PS-Adobe-3.0 EPSF-3.0\n%%%%BoundingBox: 0 0 %d %d\n%%%%EndComments\n" % (w, h) + body
    if form == "jp2":  # no JPEG 2000 writer here: a 640 x 480 file of the stored corpus
        return (JPEG2000_CORPUS / P13_JP2).read_bytes()
    if form == "tiff_zstd":
        return tiff_bytes(raw_image(seed, w, h), 2, compression=50000, predictor=2, rows_per_strip=32)
    if form in P13_PLUGINS:
        return plugin_file(form, seed, w, h)
    if form in P13_SMALL:
        w, h = min(w, 160), min(h, 160)
    img = raw_image(seed, w, h)
    if form == "jpeg":
        return jpeg_bytes(img)
    if form == "jpeg_444":
        return jpeg_bytes(img, 90, sampling=(1, 1))
    if form == "jpeg_comment":  # two COM segments: Pillow keeps the last
        data = jpeg_bytes(img)
        return data[:2] + _jpeg_segment(0xFE, b"first") + _jpeg_segment(0xFE, f"photo {seed}".encode()) + data[2:]
    if form == "truncated":
        data = jpeg_bytes(img)
        return data[: len(data) // 2]
    if form == "jpeg_cmyk":
        return jpeg_bytes(cmyk_planes(img), 90, form="cmyk")
    if form == "png_rgb":
        return png_bytes(img, 2)
    if form == "png_comment":  # a tEXt chunk keyed "comment", latin-1: the JPEG's COM gets its UTF-8
        data = png_bytes(img, 2)
        return data[:33] + png_chunk(b"tEXt", b"comment\0" + f"caf\xe9 {seed}".encode("latin-1")) + data[33:]
    if form == "webp":
        return webp_bytes("lossless", seed, 0, 0, image=img)
    if form == "ico":
        return ico_bytes(img, seed)
    if form == "ppm":
        return b"P6\n# a comment\n%d %d\n255\n" % (w, h) + img.tobytes()
    if form == "pgm":
        return b"P5 %d %d 255\n" % (w, h) + img.mean(axis=2).astype(np.uint8).tobytes()
    idx, cube = colour_cube(img)
    if form == "png_palette_trns":  # mode P with transparency: Pillow's pass goes through RGBA
        return png_bytes(idx[..., None], 3, palette=cube, trns=bytes(range(0, 256, 8)))
    if form == "gif_comment":
        data = gif_bytes(idx, cube)
        at = 13 + (3 << ((data[10] & 7) + 1))
        return data[:at] + b"\x21\xfe" + gif_sub_blocks(f"gif {seed}".encode()) + data[at:]
    raise ValueError(f"unknown raw form {form}")


def write_raw_file(job: tuple) -> None:
    path, form, seed, w, h = job
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(raw_file(form, seed, w, h))


def write_raw_trees(root: Path, counts: dict = None, side: float = 1.0, refused: bool = True, pool=None) -> dict:
    """The ten converters' raw trees under `root` (their --mbeir_data_dir), each in its source's layout
    (the JAX package's converters and tests/test_preprocessors.py read them so), seeded: records in
    src_data/<dataset>/, images under mbeir_images/<dataset>_images/ named as the source names them and
    written in P13_FORMS' forms at the sources' sizes times `side` (COCO's 640 x 480 and 500 x 375 kinds, up
    to 1600 px for OVEN / InfoSeek), by `pool`'s workers if given.  MSCOCO also holds a missing image, a
    truncated JPEG, an HTML page under a .jpg name, a JP2 file under a .jpg name and (with `refused`) a PSD
    file no reader identifies under a .png name and an EPS file, a format the port does not decode, under a
    .jpg name, a ZSTD TIFF (which the pass converted once it was no longer deleted) under a .jpg name, and a
    FITS, FLC, PCD, IPTC and AVIF file (P13_PLUGINS) under .jpg names.  Returns {"images": {path: form}, "truncated":
    path, "garbage": path, "unidentified": path or None, "refused": path or None, "jp2": path, "zstd": path,
    "plugins": {form: path}, "captions": [every caption and question]}."""
    counts = {**P13_COUNTS, **(counts or {})}
    rng = np.random.default_rng(P13_SEED)
    vocab = fixture_words(rng, 400)
    jobs, texts = [], []

    def text(lo: int = 4, hi: int = 11) -> str:
        out = " ".join(rng.choice(vocab, size=int(rng.integers(lo, hi))))
        texts.append(out)
        return out

    def image(rel: str, size, form: str = None) -> None:
        n = len(jobs)
        form = form or P13_FORMS[n % len(P13_FORMS)]
        w, h = (max(1, round(s * side)) for s in size)
        jobs.append((str(root / rel), form, P13_SEED + n, w, h))

    def photo():
        return [(640, 480), (480, 640), (500, 375), (375, 500), (640, 427)][int(rng.integers(0, 5))]

    def dump(rel: str, obj) -> None:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(json.dumps(obj))

    def dump_jsonl(rel: str, rows: list) -> None:
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text("".join(json.dumps(r) + "\n" for r in rows))

    special = {}
    coco = {"train": [], "val": [], "test": []}
    for i in range(counts["mscoco"]):
        split = ("train", "train", "train", "val", "test")[i % 5]
        sub = "train2014" if split == "train" else "val2014"
        name = f"{sub}/COCO_{sub}_{i:012d}.{'png' if i % 7 == 3 else 'jpg'}"
        caps = [text() for _ in range(6 if i % 4 == 0 else 5)]
        if i % 9 == 1:
            caps[2] = caps[1]  # a repeated caption: the pool holds it once
        coco[split].append({"image": name, "caption": caps if i % 11 else caps[0], "image_id": i})
        form = {8: "truncated", 10: "psd" if refused else None, 12: "eps" if refused else None, 13: "garbage",
                14: "jp2", 16: "tiff_zstd", **{18 + k: plugin for k, plugin in enumerate(P13_PLUGINS)}}.get(i)
        if i != 5:  # image 5 is missing
            image(f"mbeir_images/mscoco_images/{name}", photo(), form)
        if form:
            special[form] = str(root / f"mbeir_images/mscoco_images/{name}")
    for split, rows in coco.items():
        dump(f"src_data/mscoco/coco_karpathy_{split}.json", rows)

    cirr_names = {"train": [], "val": [], "test1": []}
    for i in range(counts["cirr"]):
        split = ("train", "train", "val", "test1")[i % 4]
        name = f"{split}-{i}-0-img0"
        rel = f"./{split if split == 'train' else 'dev'}/{i % 5}/{name}.png" if split != "test1" else f"./test1/{name}.png"
        cirr_names[split].append((name, rel))
        image(f"mbeir_images/cirr_images/{rel[2:]}", photo())
    for split, names in cirr_names.items():
        dump(f"src_data/cirr/image_splits/split.rc2.{split}.json", dict(names))
    for split in ("train", "val"):
        names = [n for n, _ in cirr_names[split]]
        rows = []
        for j, ref in enumerate(names):
            tgts = [names[(j + d) % len(names)] for d in (1, 2, 3)]
            row = {"pairid": j, "reference": ref, "caption": text(),
                   "target_soft": {tgts[0]: 1.0, tgts[1]: 0.5, tgts[2]: -1.0}}
            rows.append(row)
            if j % 5 == 0:  # the same reference and caption again: its targets join the first's
                rows.append({**row, "target_soft": {names[(j + 4) % len(names)]: 0.2}})
        rows.append({"pairid": -1, "reference": "missing-ref", "caption": text(), "target_soft": {names[0]: 1.0}})
        dump(f"src_data/cirr/captions/cap.rc2.{split}.json", rows)

    fiq_ids = []
    for i in range(counts["fashioniq"]):
        fiq_ids.append(f"B00{i:07d}")
        image(f"mbeir_images/fashioniq_images/{fiq_ids[-1]}.{'png' if i % 3 else 'jpg'}", (int(rng.integers(300, 600)), 600))
    for c, cat in enumerate(("dress", "shirt", "toptee")):
        ids = fiq_ids[c::3]
        for s, split in enumerate(("train", "val", "test")):
            dump(f"src_data/fashioniq/image_splits/split.{cat}.{split}.json", ids[s::3])
        for split in ("train", "val"):
            rows = [{"candidate": ids[j], "target": ids[(j + 1) % len(ids)],
                     "captions": [text().capitalize() + ".", text() if j % 4 else ""]}
                    for j in range(0 if split == "train" else 1, len(ids), 2)]
            dump(f"src_data/fashioniq/captions/cap.{cat}.{split}.json", rows)

    for split in ("train", "test"):
        for cat in ("dress", "jacket"):
            lines = []
            for i in range(counts["fashion200k"] // 4):
                pid = f"{cat}{split}{i}"
                rel = f"women/{cat}es/casual/{pid}/{pid}_0.jpeg"
                lines.append(f"{rel}\t0.{i + 10}\t{text()}\n")
                if i % 6 == 0:
                    lines.append(lines[-1])  # a repeated product line: kept once
                image(f"mbeir_images/fashion200k_images/{rel[len('women/'):]}", (int(rng.integers(200, 300)), 300))
            (root / f"src_data/fashion200k/labels/{cat}_{split}_detect_all.txt").parent.mkdir(parents=True, exist_ok=True)
            (root / f"src_data/fashion200k/labels/{cat}_{split}_detect_all.txt").write_text("".join(lines))

    edis_images = [f"{j:05d}.jpg" for j in range(2 * counts["edis"])]
    for name in edis_images:
        image(f"mbeir_images/edis_images/{name}", photo())
    headlines = {name: text() for name in edis_images}
    for s, split in enumerate(("train", "val", "test")):
        rows = []
        for i in range(s, counts["edis"], 3):
            cands = [edis_images[(2 * i + d) % len(edis_images)] for d in range(4)]
            rows.append({"id": i, "query": text(), "candidates": [
                {"image": c, "headline": headlines[c], "candidate_id": 100 * i + d, "score": (3, 2, 1, 3)[d]}
                for d, c in enumerate(cands)]})
        dump(f"src_data/edis/{split}.json", rows)

    csv_rows = ["id,ref_path,left_path,right_path,right_vote,split,is_imagenet\n"]
    for i in range(counts["nights"]):
        paths = [f"ref/{i // 10:03d}/{i:03d}.png", f"distort/{i // 10:03d}/{i:03d}_0.png",
                 f"distort/{i // 10:03d}/{i:03d}_1.png"]
        for p in paths:
            image(f"mbeir_images/nights_images/{p}", (512, 512))
        split = ("train", "train", "val", "test")[i % 4]
        csv_rows.append(f"{i},{paths[0]},{paths[1]},{paths[2]},{i % 2},{split},{i % 3 == 0}\n")
    (root / "src_data/nights").mkdir(parents=True, exist_ok=True)
    (root / "src_data/nights/data.csv").write_text("".join(csv_rows))

    sources = ("washington_post", "guardian", "bbc", "usa_today")
    news = []
    for i in range(counts["visualnews"]):
        src = sources[i % 4]
        rel = f"{src}/images/{i // 20:04d}/{i:05d}.jpg"
        news.append({"id": i, "source": src, "image_path": f"./{rel}", "caption": text() if i % 13 != 7 else "",
                     "article_path": f"./{src}/articles/{i}.txt"})
        image(f"mbeir_images/visualnews_images/{rel}", photo())
    dump("src_data/visualnews/origin/data.json", news)

    tsv, lineidx, webqa = b"", [], {}
    for i in range(counts["webqa"]):  # decoded before the pass, so no corrupt or refused file among them
        lineidx.append(len(tsv))
        form = P13_FORMS[i % len(P13_FORMS)]
        w, h = photo()
        data = raw_file(form, P13_SEED + 50_000 + i, max(1, round(w * side)), max(1, round(h * side)))
        tsv += f"{30_000_000 + i}\t".encode() + base64.b64encode(data) + b"\n"
    for i in range(counts["webqa"]):
        webqa[f"guid{i}"] = {
            "Guid": f"guid{i}", "Qcate": ("text", "YesNo", "color")[i % 3], "Q": text() if i % 17 != 5 else "",
            "split": ("train", "train", "val")[i % 3],
            "img_posFacts": [{"image_id": 30_000_000 + i, "caption": text()}] if i % 2 else [],
            "img_negFacts": [{"image_id": 30_000_000 + (i + 1) % counts["webqa"], "caption": text()}],
            "txt_posFacts": [{"fact": text()}] if i % 2 == 0 else [], "txt_negFacts": [{"fact": text()}]}
    dump("src_data/webqa/WebQA_train_val.json", webqa)
    (root / "src_data/webqa/imgs.tsv").write_bytes(tsv)
    (root / "src_data/webqa/imgs.lineidx").write_text("".join(f"{o}\n" for o in lineidx))

    wiki, oven_rows = [], {"train": [], "val": []}
    for i in range(counts["oven"]):
        qid = f"Q{1000 + i}"
        words = [text(8, 30) for _ in range(1 + i % 6)]  # some summaries run past 100 tokens
        wiki.append({"wikidata_id": qid, "wikipedia_title": text(1, 4), "wikipedia_content": " ".join(words),
                     "wikipedia_image_url": f"http://example.invalid/{qid}.jpg" if i % 3 else None})
        if i % 3 and i % 7 != 4:  # an entity whose image was never fetched stays text
            image(f"mbeir_images/oven_images/wikipedia_images_full/{qid[:4]}/{qid}.jpg",
                  (int(rng.integers(800, 1601)), int(rng.integers(600, 1201))))
        image_id = f"oven_{5_000_000 + 10_000 * (i % 3) + i:08d}"
        image(f"mbeir_images/oven_images/{image_id[-8:-6]}/{image_id}.jpg",
              (int(rng.integers(640, 1601)), int(rng.integers(480, 1201))))
        split = ("train", "train", "val")[i % 3]
        oven_rows[split].append({"data_id": f"oven_{split}_{i}", "image_id": image_id, "question": text(),
                                 "entity_id": qid, "data_split": f"{split}_seen"})
    wiki.append(dict(wiki[0]))  # a repeated entity: the pool holds it once
    dump_jsonl("src_data/oven/Wiki6M_ver_1_0.jsonl", wiki)
    for split, rows in oven_rows.items():
        dump_jsonl(f"src_data/oven/oven_entity_{split}.jsonl", rows)
    # InfoSeek asks about OVEN's query images, each split about the same entities in the same order (the
    # reference rewrites the pool file per split, and its training pool reads the train split's dids in the
    # last one written: ROADMAP Queue 1 item 9)
    for split in ("train", "val"):
        seek, kb, qtype = [], [], []
        for j, row in enumerate(oven_rows["train"] + oven_rows["val"]):
            entity = wiki[int(row["entity_id"][1:]) - 1000]
            content = entity["wikipedia_content"].split()
            answer = ["not in the article"] if j % 4 == 0 else [content[j % len(content)]]
            seek.append({"data_id": f"infoseek_{split}_{j}", "image_id": row["image_id"], "question": text(),
                         "answer": answer, "answer_eval": [answer[0], 1990 + j],
                         "data_split": f"{split}_unseen_entity"})
            kb.append({"data_id": seek[-1]["data_id"], "entity_id": row["entity_id"]})
            qtype.append({"data_id": seek[-1]["data_id"], "question_type": ("STRING", "TIME", "NUMERICAL")[j % 3]})
        dump_jsonl(f"src_data/infoseek/infoseek_{split}.jsonl", seek)
        dump_jsonl(f"src_data/infoseek/infoseek_{split}_withkb.jsonl", kb)
        if split == "val":  # a question-type file for one split only
            dump_jsonl(f"src_data/infoseek/infoseek_{split}_qtype.jsonl", qtype)

    if pool is None:
        for job in jobs:
            write_raw_file(job)
    else:
        list(pool.map(write_raw_file, jobs, chunksize=4))
    return {"images": {p: form for p, form, *_ in jobs}, "truncated": special["truncated"],
            "garbage": special["garbage"], "unidentified": special.get("psd"), "refused": special.get("eps"),
            "jp2": special.get("jp2"), "zstd": special.get("tiff_zstd"),
            "plugins": {form: special[form] for form in P13_PLUGINS if form in special}, "captions": texts}


P13_GENERATOR_FLAGS = ("--generate_union_train_cand_pool", "--generate_union_all_cand_pool", "--unify_train_data",
                       "--assign_task_ids", "--generate_qrels")


def arrange_for_generator(root: Path) -> None:
    """The union generator's layout over the converters' outputs, as the reference release arranged them by
    hand: each split's queries in <split>/, each pool in cand_pool/ (MSCOCO's also under its split-specific
    names), cand_pool/unsplit_cand_pool/ and, for training, cand_pool/train_cand_pool/."""
    for name in P13_CONVERTERS:
        src = root / "src_data" / name
        copies = {src / f"mbeir_{name}_{split}.jsonl": [root / split] for split in ("train", "val", "test")}
        copies[src / f"mbeir_{name}_cand_pool.jsonl"] = [root / "cand_pool", root / "cand_pool/unsplit_cand_pool"]
        copies[src / f"mbeir_{name}_train_cand_pool.jsonl"] = [root / "cand_pool/train_cand_pool"]
        for path, dirs in copies.items():
            for d in dirs if path.exists() else ():
                d.mkdir(parents=True, exist_ok=True)
                shutil.copyfile(path, d / path.name)
    for split in ("val", "test"):
        shutil.copyfile(root / "cand_pool/mbeir_mscoco_cand_pool.jsonl",
                        root / f"cand_pool/mbeir_mscoco_{split}_cand_pool.jsonl")


def converter_args(name: str) -> list:
    """The flags a user passes each converter (relative to --mbeir_data_dir): every step it has."""
    steps = ["--enable_mbeir_conversion", "--enable_candidate_pool", "--enable_training_candidate_pool"]
    if name == "infoseek":
        return steps
    extra = ["--train_samples", P13_VN_SAMPLES[0], "--val_samples", P13_VN_SAMPLES[1], "--test_samples",
             P13_VN_SAMPLES[2]] if name == "visualnews" else []
    return ["--enable_image_processing", *steps, *extra]


# the encoder held to Pillow 12.1's own bytes: sha256 of `Image.fromarray(digest_image(seed, w, h)).save(buf,
# "JPEG", comment=comment)` at its defaults, computed with Pillow 12.1.0 over libjpeg-turbo 3.1.3
P13_PILLOW_DIGESTS = {
    (1, 1, 1, None): "8895772a1116c495589e6a5e84ac69d66cb04fef56c53061b4cb0c035557b2fe",
    (2, 17, 9, b"photo"): "f85fbc52635c78c2cb707a57b91e6368055a33ad7a20bea4c015292f77f8dfd4",
    (3, 341, 256, None): "1e8d2fd88b20bc71ee1bb2dfc3311cd45a4b262128018dcba931f0e5cf957bf7",
    (4, 256, 341, "caf\xe9 ☃"): "4c47dae58809f4b8add8076ca323e1af9a4e173ab7d27d572690cdd3e4f6e395",
    (5, 640, 480, None): "04e8b1fdc37a82ea9f144d4ceadad3accd31dcd1bf21e07322795289c8f5d8cb",
    (6, 257, 255, b"x" * 300): "756c608f84b6be63f299db89d9fb5126091e7af729ed2108de2dd553a14acf1a",
    (7, 16, 16, None): "9207cc090f0c873b39a7cf09463807a60903ea3756ad56286b28717c7ac90c30",
    (8, 31, 600, None): "bcac9abb35daf1ccb6ee18027f90571407dc0f9b403196c5da369032c2cd86ad",
    (9, 500, 375, b"\xff\xd9"): "d7dea6651bb1227ad106633dd825104e9190f796abaddef0a958b8401514f2c0",
}
P13_TIMED = 120  # raw images the pass is timed on, on one process stage by stage and on its pool


def digest_image(seed: int, w: int, h: int) -> np.ndarray:
    """A seeded w x h image of integer arithmetic alone (a ramp and a hashed noise): the same array on
    every numpy, so Pillow's digests above hold on another machine."""
    y, x = np.mgrid[:h, :w].astype(np.int64)
    c = np.arange(3, dtype=np.int64)[None, None, :]
    noise = ((x[..., None] * 2654435761 + y[..., None] * 40503 + c * 97 + seed * 7919) >> 9) & 31
    smooth = x[..., None] * (3 + seed % 5) + y[..., None] * (5 + c) + 60 * c + 11 * seed
    return ((smooth + noise) % 256).astype(np.uint8)


def stub_env(root: Path) -> dict:
    """The environment of a run as on the card's machine: yaml, PIL and regex stubbed out of PYTHONPATH."""
    stubs = root / "stubs"
    for name in P12_BLOCKED:
        (stubs / name).mkdir(parents=True, exist_ok=True)
        (stubs / name / "__init__.py").write_text(f"raise ImportError('{name} is not installed on this machine')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = f"{stubs}:{REPO}"
    return env


def tree_bytes(root: Path) -> dict:
    """relative path -> bytes of every file under root; the union train split's lines sorted (its shuffle
    draws from the unseeded `random` of each run)."""
    out = {}
    for p in sorted(root.rglob("*")):
        if p.is_file():
            rel = str(p.relative_to(root))
            data = p.read_bytes()
            out[rel] = b"".join(sorted(data.splitlines(True))) if rel.startswith("train/union_train/") else data
    return out


def run_in_process(module: str, args: list) -> None:
    """`python -m module args` in this process (the twin run: the same mains, --device cpu)."""
    import runpy

    argv = sys.argv
    sys.argv = [module, *map(str, args)]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    finally:
        sys.argv = argv


def time_one_process(images: list, device: str) -> dict:
    """`io_utils.resize_and_convert_image_to_jpg` on one process over the files `images`, its stages (read,
    decode, comment, resize, encode, write) timed by the pass itself and summed; seconds, and the images
    written."""
    import contextlib
    import io

    from uniir_tpu_torch.data.preprocessing import io_utils

    stages = {}
    with contextlib.redirect_stdout(io.StringIO()):  # the pass names each file it drops
        written = sum(io_utils.resize_and_convert_image_to_jpg(p, device=device, timings=stages) is True
                      for p in images)
    return {**stages, "images": written}


def write_pipeline_tree(cli: Path, root: Path) -> dict:
    """The pipeline's layout over the constructed MSCOCO test split (task ids and qrels from the generator)
    under the names phase 12's configs read, an instruction per task, BPE merges learned from the captions."""
    from uniir_tpu_torch.data.preprocessing.io_utils import load_jsonl_as_list

    queries = load_jsonl_as_list(str(cli / "test/mbeir_mscoco_test.jsonl"))
    cands = load_jsonl_as_list(str(cli / "cand_pool/mbeir_mscoco_test_cand_pool.jsonl"))
    for sub in ("query/test", "cand_pool/local", "qrels/test", "instructions"):
        (cli / sub).mkdir(parents=True, exist_ok=True)
    shutil.copyfile(cli / "test/mbeir_mscoco_test.jsonl", cli / f"query/test/mbeir_{P12_DATASET}_test.jsonl")
    shutil.copyfile(cli / "cand_pool/mbeir_mscoco_test_cand_pool.jsonl",
                    cli / f"cand_pool/local/mbeir_{P12_POOL}_cand_pool.jsonl")
    shutil.copyfile(cli / "qrels/mbeir_mscoco_test_qrels.txt", cli / f"qrels/test/mbeir_{P12_DATASET}_test_qrels.txt")
    modality = {c["did"]: c["modality"] for c in cands}
    keys = sorted({(q["query_modality"], modality[q["pos_cand_list"][0]]) for q in queries})
    (cli / "instructions/query_instructions.tsv").write_text(
        "query_modality\tcand_modality\tdataset\tdataset_id\tprompt_1\n"
        + "".join(f"{qm}\t{cm}\tMSCOCO\t{P12_DSID}\tFind a {cm.replace(',', ' and ')} that matches this {qm}.\n"
                  for qm, cm in keys))
    texts = [c["txt"] for c in cands if c["txt"]] + [q["query_txt"] for q in queries if q["query_txt"]]
    (root / "merges.txt").write_text("#version: learned from the constructed captions\n"
                                     + "".join(f"{a} {b}\n" for a, b in learn_merges(texts, P12_MERGES)))
    (root / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\n[MASK]\n")  # BLIP's, which no run here reads
    return {"mbeir": cli, "cands": cands, "queries": [{**q, "query_txt": q["query_txt"] or ""} for q in queries]}


def converter_counts(name: str, run: tuple, text: str) -> tuple:
    """(images found, corrupt, left in place) of a converter CLI's image pass, held to its native calls: the
    pass's workers encoded each file it wrote and decoded at least those; no kernel launched."""
    counts = run[2]
    stray = {k: v for k, v in counts.items()
             if v and k not in ("pass_decode", "pass_encode", "jpeg_encode", "jpeg", "png", "gif", "webp", "tiff")}
    check(not stray, f"phase 13: {name} launched kernels: {stray}")
    if name == "infoseek":
        return 0, 0, 0
    images = int(re.search(r"Number of images found: (\d+)", text).group(1))
    corrupt = int(re.search(r"Number of corrupted files: (\d+)", text).group(1))
    kept = re.search(r"left in place \(format not decoded yet\): (\d+)", text)
    found = (images, corrupt, int(kept.group(1)) if kept else 0)
    written = images - corrupt - found[2]
    check(counts["pass_encode"] == written and counts["pass_decode"] > 0,  # ICO's DIBs, BMP, Netpbm: numpy alone
          f"phase 13: {name}'s pass wrote {written} files with {counts['pass_encode']} native encodes and "
          f"{counts['pass_decode']} native decodes")
    log(f"phase 13: {name} CLI in {run[1]:.1f} s: {images} images, {corrupt} corrupt, {found[2]} left in place; "
        f"native decodes {counts['pass_decode']}, encodes {counts['pass_encode']} in its pool (and "
        f"{counts['jpeg_encode']} in the process itself)")
    return found


def drive_construction(results: dict, smi: str) -> None:
    """Phase 13 (module docstring): the ten converters' CLIs, then the union generator's, over seeded raw
    trees, against the same mains run in this process through the twins; the pipeline CLI's embed, index
    and retrieval over the constructed MSCOCO test split, run while the twins run."""
    import hashlib
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    from uniir_tpu_torch.data import jpeg, jpeg_encode
    from uniir_tpu_torch.data import preprocess as P
    from uniir_tpu_torch.data.tokenizers.clip_bpe import CLIPTokenizer
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import seeded_clip_sf
    from uniir_tpu_torch.tools.config_updater import update_mbeir_yaml_instruct_status

    t_phase = time.perf_counter()
    for (seed, w, h, comment), digest in P13_PILLOW_DIGESTS.items():  # the encoders against Pillow's own bytes
        img = digest_image(seed, w, h)
        for encode in (jpeg_encode.encode_native, jpeg_encode.encode_twin):
            got = hashlib.sha256(encode(img, comment)).hexdigest()
            check(got == digest, f"phase 13: {encode.__name__} of the {w} x {h} image {seed} differs from Pillow's")
    log(f"phase 13: the native encoder and its twin write Pillow 12.1's bytes for all {len(P13_PILLOW_DIGESTS)} "
        "images of the digest set (1 x 1 to 640 x 480, comments of bytes and of text)")
    WORK.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase13-", dir=WORK) as tmp, ThreadPoolExecutor(5) as runner:
        root = Path(tmp)
        t0 = time.perf_counter()
        with ProcessPoolExecutor(max_workers=os.cpu_count(), mp_context=multiprocessing.get_context("spawn")) as pool:
            raw = write_raw_trees(root / "raw", pool=pool)
        log(f"phase 13: raw trees of the ten converters, {len(raw['images'])} image files "
            f"({dict(Counter(raw['images'].values()))}), in {time.perf_counter() - t0:.1f} s")
        for side in ("cli", "twin", "timed"):
            shutil.copytree(root / "raw", root / side)

        # the converters as a user runs them: a process each, on the card (the default --device), all at once
        # but InfoSeek, which reads OVEN's images after OVEN's pass
        env, logs = stub_env(root), root / "logs"
        logs.mkdir()
        module = "uniir_tpu_torch.data.preprocessing."
        groups = [(name,) for name in P13_CONVERTERS if name not in ("oven", "infoseek")] + [("oven", "infoseek")]
        chains = [[(name, module + name, ["--mbeir_data_dir", root / "cli", *converter_args(name)])
                   for name in group] for group in groups]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(chains)) as starter:
            runs = {k: v for out in starter.map(lambda c: run_chain(c, env, logs), chains) for k, v in out.items()}
        cli_s = time.perf_counter() - t0
        for name in P13_CONVERTERS:
            check(name in runs and runs[name][0] == 0, f"phase 13: {name} failed:\n"
                  f"{(logs / f'{name}.log').read_text()[-3000:] if (logs / f'{name}.log').exists() else 'not run'}")
        found = {name: converter_counts(name, runs[name], (logs / f"{name}.log").read_text()) for name in P13_CONVERTERS}
        check(found["mscoco"][1:] == (3, 1), f"phase 13: MSCOCO's pass counted {found['mscoco'][1:]}, not three "
              "corrupt files and one left in place")
        special = ("truncated", "garbage", "unidentified", "refused")
        in_cli = {k: Path(raw[k].replace(str(root / "raw"), str(root / "cli"))) for k in special}
        check(not any(in_cli[k].exists() for k in special[:3]) and in_cli["refused"].exists(),
              "phase 13: the truncated JPEG, the HTML page and the unidentified PSD file must be deleted and the EPS "
              "file left in place")
        jp2_out = Path(raw["jp2"].replace(str(root / "raw"), str(root / "cli")))
        check(jp2_out.read_bytes()[:2] == b"\xff\xd8", "phase 13: the JP2 file under a .jpg name was not converted")
        log(f"phase 13: the JP2 file ({P13_JP2}) converted to a JPEG of {jp2_out.stat().st_size} bytes, held to the "
            "twins' pass with every other file")
        zstd_out = Path(raw["zstd"].replace(str(root / "raw"), str(root / "cli")))
        check(zstd_out.exists() and zstd_out.read_bytes()[:2] == b"\xff\xd8",
              "phase 13: the ZSTD TIFF under a .jpg name was deleted or not converted")
        log(f"phase 13: the ZSTD TIFF converted to a JPEG of {zstd_out.stat().st_size} bytes, held to the twins' "
            "pass with every other file")
        for form, path in raw["plugins"].items():
            out = Path(os.path.splitext(path.replace(str(root / "raw"), str(root / "cli")))[0] + ".jpg")
            check(out.exists() and out.read_bytes()[:2] == b"\xff\xd8",
                  f"phase 13: the {form} file under a .jpg name was deleted or not converted")
        log(f"phase 13: the {', '.join(raw['plugins'])} files converted to JPEGs, held to the twins' pass with every "
            "other file")

        # the rates, alone on the host: one process stage by stage over a seeded sample of the raw images, then
        # the pass's pool over all of them in a process of its own (as a CLI runs it: the pool's workers import
        # only the pass, not this script), its start included
        files = sorted(p for p in raw["images"] if Path(p).suffix.lower() in (".png", ".jpg", ".jpeg"))
        sample = [files[k] for k in np.random.default_rng(P13_SEED).permutation(len(files))[:P13_TIMED]]
        stages = time_one_process([p.replace(str(root / "raw"), str(root / "timed")) for p in sample], DEVICE)
        per = {k: v / stages["images"] * 1e3 for k, v in stages.items() if k != "images"}
        shutil.copytree(root / "raw" / "mbeir_images", root / "pooled")
        code = ("import sys, time\nfrom uniir_tpu_torch.data.preprocessing import io_utils\nt = time.perf_counter()\n"
                "io_utils.parallel_process_image_directory(sys.argv[1], device=sys.argv[2])\n"
                "print('pool seconds', time.perf_counter() - t)\n")
        out = subprocess.run([sys.executable, "-c", code, str(root / "pooled"), DEVICE], env=env, capture_output=True,
                             text=True, timeout=600)
        check(out.returncode == 0, f"phase 13: the timed pool failed:\n{out.stderr[-3000:]}")
        pooled_s = float(re.search(r"pool seconds (\S+)", out.stdout).group(1))
        log(f"phase 13: the image pass over {len(sample)} of the raw images ({stages['images']} it wrote) on "
            f"one process: {1e3 / sum(per.values()):.1f} images/s "
            f"({sum(per.values()):.2f} ms an image); by stage, ms an image: "
            + ", ".join(f"{k} {v:.3f}" for k, v in per.items())
            + f"; the encoder's share {per['encode'] / sum(per.values()):.4f}; on the pass's pool of "
            f"{os.cpu_count()} processes, its start included: {len(files) / pooled_s:.1f} images/s ({len(files)} "
            f"files in {pooled_s:.2f} s); card {smi}; host CPU {host_cpu()}")

        # the union generator's CLI, then the pipeline's CLIs over its MSCOCO test split in the background
        arrange_for_generator(root / "cli")
        generator = module + "generator"
        gen_run = run_chain([("generator", generator, ["--mbeir_data_dir", root / "cli", *P13_GENERATOR_FLAGS])],
                            env, logs)
        check(gen_run["generator"][0] == 0, f"phase 13: the generator failed:\n{(logs / 'generator.log').read_text()[-3000:]}")
        cli_files = tree_bytes(root / "cli")
        tree = write_pipeline_tree(root / "cli", root)
        paths = fixture_configs(root, phase=13)
        common = ["--uniir_dir", root, "--mbeir_data_dir", tree["mbeir"], "--device", DEVICE]
        pipeline = "uniir_tpu_torch.tools.pipeline"
        for name in ("embed", "index", "retrieval", "retrieval_bf16"):  # the run scripts' switch (phase 12 runs its CLI)
            update_mbeir_yaml_instruct_status(str(paths[name]), True)
        chain = [("clip_embed", pipeline, ["--config_path", paths["embed"], *common, "--enable_embed"]),
                 ("clip_index", pipeline, ["--config_path", paths["index"], *common, "--enable_create_index"]),
                 ("clip_retrieval_int8", pipeline, ["--config_path", paths["retrieval"], *common, "--enable_retrieval"]),
                 ("clip_retrieval_bf16", pipeline, ["--config_path", paths["retrieval_bf16"], *common,
                                                    "--enable_retrieval"])]
        clip_cfg = CLIP_CONFIGS[MODEL]
        model = seeded_clip_sf(clip_cfg, DEVICE, seed=SEED, dtype=torch.bfloat16)
        ckpt = root / "checkpoint" / P12_EXPT["clip"]
        ckpt.mkdir(parents=True)
        torch.save(model.state_dict(), ckpt / "clip_sf_large.pth")

        results_dir = root / "retrieval_results" / P12_EXPT["clip"]

        def pipeline_chain() -> dict:  # the bf16 run writes over the int8 run's files: these are read between
            out = run_chain(chain[:3], env, logs)
            if all(rc == 0 for rc, *_ in out.values()):
                shutil.copytree(results_dir / "run_files", root / "int8_run_files")
                out.update(run_chain(chain[3:], env, logs))
            return out

        t_pipeline = time.perf_counter()
        pipeline_runs = runner.submit(pipeline_chain)

        # meanwhile in this process: the in-code reference, then the same mains through the twins
        arrays = {str(tree["mbeir"] / p): jpeg.read_image(str(tree["mbeir"] / p), DEVICE)
                  for p in sorted({c["img_path"] for c in tree["cands"] if c["img_path"]}
                                  | {q["query_img_path"] for q in tree["queries"] if q["query_img_path"]})}
        bpe = CLIPTokenizer(bpe_path=str(root / "merges.txt"))
        ref = in_code_embeds(model, lambda t: bpe(t, context_length=clip_cfg.context_length, truncate=True),
                             P.clip_transform(clip_cfg.image_size), clip_cfg.image_size, tree, arrays, {})
        del model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        for name in P13_CONVERTERS:
            run_in_process(module + name, ["--mbeir_data_dir", root / "twin", *converter_args(name),
                                           *(["--device", "cpu"] if name != "infoseek" else [])])
        arrange_for_generator(root / "twin")
        run_in_process(generator, ["--mbeir_data_dir", root / "twin", *P13_GENERATOR_FLAGS])
        twin_s = time.perf_counter() - t0
        twin_files = tree_bytes(root / "twin")
        check(sorted(cli_files) == sorted(twin_files),
              f"phase 13: the CLI and twin trees hold different files: {sorted(set(cli_files) ^ set(twin_files))[:5]}")
        differ = [k for k in cli_files if cli_files[k] != twin_files[k]]
        check(not differ, f"phase 13: {len(differ)} files differ between the CLI and twin runs: {differ[:5]}")
        jpgs = [k for k in cli_files if k.startswith("mbeir_images/") and cli_files[k][:3] == b"\xff\xd8\xff"]
        union = (root / "cli/train/union_train/mbeir_union_train.jsonl").read_text().splitlines()
        log(f"phase 13: all {len(cli_files)} files of the CLI runs equal to the twin run's: {len(jpgs)} JPEG files "
            f"the native encoder wrote, each bit-equal to the twin's; {sum(k.endswith('.jsonl') for k in cli_files)} "
            f"JSON-lines files (the union train split, {len(union)} queries with task ids, by its sorted lines: its "
            f"shuffle draws from each run's unseeded random); {len(list((root / 'cli/qrels').glob('*.txt')))} qrels "
            f"files; CLIs {cli_s:.1f} s of wall time in {len(chains)} chains, twin run {twin_s:.1f} s in this process")

        # the pipeline's runs: the kernels each implies, ids and Recall against the in-code path
        pruns = pipeline_runs.result()
        log(f"phase 13: the pipeline's runs took {time.perf_counter() - t_pipeline:.1f} s of wall time beside the "
            "twin run")
        for name, *_ in chain:
            check(name in pruns and pruns[name][0] == 0, f"phase 13: {name} failed:\n"
                  f"{(logs / f'{name}.log').read_text()[-3000:] if (logs / f'{name}.log').exists() else 'not run'}")
        want = {"clip_embed": {"K1", "jpeg"}, "clip_index": set(), "clip_retrieval_int8": {"K4"},
                "clip_retrieval_bf16": {"K2"}}
        may = {"clip_retrieval_int8": {"K2"}}  # the int8 guard's exact re-run of a batch
        for name, positive in want.items():
            counts = pruns[name][2]
            log(f"phase 13: {name} launches {({k: v for k, v in counts.items() if v})}")
            check(all(counts[k] > 0 for k in positive), f"phase 13: {name} did not launch {positive}: {counts}")
            stray = {k: v for k, v in counts.items() if v and k not in positive | may.get(name, set())}
            check(not stray, f"phase 13: {name} launched kernels its run does not imply: {stray}")
            for k in ("K1", "K2", "K4"):
                results[k]["launches"] += counts[k]
        hold_embeds("CLIP-SF over the constructed tree", cli_embeds(root, "embed", P12_EXPT["clip"]), ref, phase=13)
        # each run's ids: the int8 run's equal to the bf16 run's, the local pool's to the in-code search's at
        # the run's k
        from uniir_tpu_torch.data.registry import unhash_did, unhash_qid

        int8_files, bf16_files = run_files(root / "int8_run_files"), run_files(results_dir / "run_files")
        local = [name for name in bf16_files if "union" not in name]
        check(sorted(int8_files) == sorted(bf16_files) and len(local) == 1,
              f"phase 13: run files {sorted(bf16_files)} / {sorted(int8_files)}")
        for name, ids in bf16_files.items():
            differ = [q for q in ids if ids[q] != int8_files[name].get(q)]
            check(not differ and len(ids) == len(int8_files[name]),
                  f"phase 13: {name}: int8 and bf16 runs return different ids for {len(differ)} queries")
        got = bf16_files[local[0]]
        k = max(map(len, got.values()))
        searched = in_code_search(root, k)
        want_ids = {unhash_qid(q): [unhash_did(d) for d in row] for q, row in zip(searched[1], searched[0])}
        check(sorted(got) == sorted(want_ids), f"phase 13: {local[0]} holds {len(got)} queries, the search "
              f"{len(want_ids)}")
        differ = [q for q in want_ids if got[q] != want_ids[q]]
        check(not differ, f"phase 13: {local[0]}: the top {k} of {len(differ)} queries differ from the in-code "
              f"search's, e.g. {differ[:1]}: {[(got[q][:5], want_ids[q][:5]) for q in differ[:1]]}")
        tsv = tsv_recall(results_dir / "final_tsv")
        ref_recall = in_code_recall(root, tree, searched)
        check({k: v[0] for k, v in tsv.items()} == ref_recall,
              f"phase 13: TSV Recall {tsv} differs from the in-code search's {ref_recall}")
        log(f"phase 13: {len(tree['cands'])} constructed candidates and {len(tree['queries'])} queries embedded, "
            f"indexed and retrieved by the pipeline CLI: embed ids equal to the in-code path; {len(bf16_files)} "
            f"run files, the int8 run's ids equal to the bf16 run's for every query, {local[0]}'s top {k} equal "
            f"to the in-code search's for all {len(want_ids)} queries; Recall by task "
            f"{ {f'{t} {m}': v[0] for (t, m), v in sorted(tsv.items())} }")
    log(f"phase 13 passed in {time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

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
    names = ("attention", "attention_bwd", "topk", "int8_matmul", "int8_mlp", "preprocess", "jpeg", "png", "gif", "webp",
             "tiff", "jpeg_encode", "raster", "bcn", "jpeg2000")
    _build.build_all(names)  # one nvcc per source, all at once
    for name in names:
        _build.load(name)
        log(f"built {name}: {_build.build_seconds[name]:.1f} s\n{_build.ptxas_report(name)}")
    mark = lambda what: log(f"{what} done")  # noqa: E731
    mark("kernel builds")

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
    # the decoder phase's twins (numpy, on the host's cores but one) run while the card checks its kernels
    twins = ProcessPoolExecutor(max_workers=max(1, os.cpu_count() - 1), mp_context=multiprocessing.get_context("spawn"))
    try:
        decoder_cases, t_twins = start_decoder_cases(twins), time.perf_counter()
        check_attention(results)
        check_attention_splitk(results)
        check_attention_norm_first(results)
        check_preprocess(results)
        check_sweep_machine_code()
        check_sweeps(results)
        check_int8_matmul(results)
        check_int8_mlp(results)
        mark("kernel checks")
        check_decoders(smi, decoder_cases, t_twins)
    finally:
        twins.shutdown(cancel_futures=True)
    mark("decoder phase")
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
    mark("CLIP serving paths")
    for name in ("BLIPScoreFusion", "BLIPFeatureFusion"):  # add their K7 / K1 / K2 / K4 / K11 (/ K5 / K6) launches too
        blip_data = drive_blip_path(results, name, profile="--profile" in sys.argv[1:])
        torch.cuda.empty_cache()
        drive_int8_model_path(results, name, blip_data, profile="--profile" in sys.argv[1:])  # K5 in MED, K6 with GELU
        del blip_data
        torch.cuda.empty_cache()
    mark("BLIP serving paths")
    check_attention_bwd(results)
    for name in ("CLIPScoreFusion", "CLIPFeatureFusion"):  # add their K1 / K10 / K3 launches too
        drive_train_path(results, name)
    busy_ms = {name: drive_blip_train_path(results, name)  # add their K1 / K3 launches too
               for name in ("BLIPScoreFusion", "BLIPFeatureFusion")}
    if "--profile" in sys.argv[1:]:
        profile_train_step("CLIPScoreFusion")
        profile_train_step("CLIPFeatureFusion")
        profile_train_step("CLIPFeatureFusion", remat=True, splitk=True)
    torch.cuda.empty_cache()
    mark("training paths")
    drive_tools_path(results)  # adds its K1 / K2 / K4 launches too
    torch.cuda.empty_cache()
    mark("tools path")
    drive_processes_path(results)  # adds its ranks' K1 / K3 / K2 launches too
    torch.cuda.empty_cache()
    mark("processes path")
    # adds its runs' K1 / K2 / K3 / K4 launches too
    drive_entry_points(results, smi, busy_ms["BLIPScoreFusion"][P12_BLIP_TRAIN_BS])
    torch.cuda.empty_cache()
    mark("phase 12")
    drive_construction(results, smi)  # adds its pipeline runs' K1 / K2 / K4 launches too
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
    if sys.argv[1:2] == ["--cli"]:  # one of phase 12's runs (`run_cli`)
        run_cli(sys.argv[2:])
    else:
        main()
