#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py            # from the repo root; needs one CUDA card

1. builds the port's kernels (uniir_tpu_torch/csrc, nvcc for sm_90a) from the
   checkout and checks each against its plain PyTorch twin at the shapes the
   serving path gives it: K1 attention at CLIP-L vision and text shapes and
   the main path's batch, K2 / K4 sweeps at the main path's small pool and
   on a seeded 5.6M x 768 pool with 256 queries (also against brute force),
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
4. checks K3, the attention backward, against its twin at the CLIP-L vision
   and text shapes (and against autograd through the plain forward);
5. drives the training path through the port's own entry points -- seeded
   CLIP-SF ViT-L/14 with fp32 masters and bf16 compute, `make_clip_optimizer`,
   `make_clip_train_step`, `train_one_epoch` over synthetic collated batches
   of 32 pairs, then 105 pairs (the reference's per-GPU batch) with remat --
   and checks that K1 and K3 were launched, that the loss falls on a repeated
   batch, that one step's loss and gradients through the kernels agree with
   the twins, and that a saved train checkpoint restores bit-equal and serves.

With `--profile` it also prints torch.profiler breakdowns, by kernel group,
of the 32-pair train step and of the embed step at batch 64 in bf16 and in
each int8 mode.

Prints, before the last line, the card's name and power limit and one JSON
line with each kernel's launches, error, times and bound (the least time
the card could take: bytes moved over 3.35 TB/s or operations over the
tensor cores' dense peak, whichever is larger); the last line is
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, when
there is no CUDA card or a check fails.  Weights and the tokenizer are
seeded stand-ins (the CLIP-L checkpoint and BPE files are not in the repo).
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
EXPT = "CLIP_SF/Large/Seeded/"  # the bf16 path's experiment directory


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean device time of fn() over `iters` runs after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
    from uniir_tpu_torch.ops.attention import attention, attention_reference

    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for tag, (B, L, H, causal) in {"vision": (BATCH, 257, 16, False), "text": (BATCH, 77, 12, True)}.items():
        q, k, v = (torch.randn(B, L, H * 64, generator=g, device="cuda").bfloat16() for _ in range(3))
        out = attention(q, k, v, H, causal=causal)
        torch.cuda.synchronize()
        ref = attention_reference(q, k, v, H, causal=causal)
        err = (out.float() - ref.float()).abs().max().item()
        cos = cosine(out, ref)
        ms = cuda_ms(lambda: attention(q, k, v, H, causal=causal), 20)
        plain_ms = cuda_ms(lambda: attention_reference(q, k, v, H, causal=causal), 20)
        # the library call: F.scaled_dot_product_attention over [B, H, L, D] views of the same tensors
        heads = [t.view(B, L, H, 64).transpose(1, 2) for t in (q, k, v)]
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(*heads, is_causal=causal), 20)
        limit = bound(nbytes(q, k, v, out), 4 * B * H * L * L * 64, BF16_OPS_PER_S)
        log(f"K1 attention {tag} [{B},{L},{H * 64}] H={H} causal={causal}: max_abs_err={err} cosine={cos} "
            f"kernel_ms={ms} plain_ms={plain_ms} library_ms={library_ms} {limit}")
        # same rounding points as the twin; fp32 sums in another order -> a
        # couple of bf16 ulps of outputs of magnitude < 4
        check(err <= 3e-2 and cos >= 0.9999, f"K1 disagrees with its twin at {tag} shapes")
        worst = max(worst, err)
        if tag == "vision":
            results["K1"].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
    results["K1"]["max_abs_err"] = worst


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
    log(f"K2 / K4 at the main path's pool [{T.CHUNK}, {POOL_DIM}], valid {N_CANDS}, {N_QUERY_PAIRS} queries: "
        f"K2 max_abs_err={err}, K4 bit-equal={exact8}")
    check(err <= 1e-3 and exact8, "K2 / K4 disagree with their twins at the main path's pool")

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
    results["K2"].update(max_abs_err=err2, ms=ms2, plain_ms=plain2, library_ms=lib2, **limit2)
    results["K4"].update(max_abs_err=err4, ms=ms4, plain_ms=plain4, library_ms=lib4, **limit4)
    del pool, pool_q, pool_scale
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


def embed_and_save(embed_step, data: dict, cfg, embed_dir: str) -> dict:
    """Embed the candidates and the queries through the embedder's loop and
    write the .npy artifacts `create_index` / `run_retrieval` read."""
    from uniir_tpu_torch.retrieval.embedder import generate_embeds_and_ids_for_dataset

    out = {}
    for split, items, ids, key, name in (
        ("cand_pool", data["cands"], data["dids"], "did_list", "mscoco_task0_cand_pool"),
        ("test", data["queries"], data["qids"], "qid_list", "mscoco_task0_test"),
    ):
        emb, got_ids = generate_embeds_and_ids_for_dataset(embed_step, batches(items, ids, key, cfg))
        check(emb.shape == (len(items), cfg.embed_dim) and emb.dtype == np.float16, f"{split} embeddings {emb.shape}")
        check(bool(np.isfinite(emb).all()), f"{split} embeddings are not finite")
        os.makedirs(os.path.join(embed_dir, split), exist_ok=True)
        np.save(os.path.join(embed_dir, split, f"mbeir_{name}_embed.npy"), emb)
        np.save(os.path.join(embed_dir, split, f"mbeir_{name}_ids.npy"), got_ids)
        out[split] = emb.astype(np.float32)
    return out


def drive_main_path(results: dict, data: dict) -> None:
    from uniir_tpu_torch.models import layers
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import seeded_clip_sf
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.ops import topk as T
    from uniir_tpu_torch.retrieval.eval import run_retrieval
    from uniir_tpu_torch.retrieval.index import create_index
    from uniir_tpu_torch.train.steps import make_embed_step

    shutil.rmtree(WORK, ignore_errors=True)
    root = str(WORK)
    cfg = CLIP_CONFIGS[MODEL]
    cands, dids, copied = data["cands"], data["dids"], data["copied"]
    os.makedirs(os.path.join(root, "mbeir_data", "qrels", "test"))
    with open(os.path.join(root, "mbeir_data", "qrels", "test", "mbeir_mscoco_task0_test_qrels.txt"), "w") as f:
        for j, c in data["relevant"].items():
            f.write(f"9:{j} 0 9:{c} 1 8\n")

    t0 = time.perf_counter()
    model = seeded_clip_sf(cfg, DEVICE, seed=SEED, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"main path: seeded CLIP-SF {MODEL} bf16 ({sum(p.numel() for p in model.parameters())} parameters) "
        f"in {time.perf_counter() - t0:.1f} s; {N_CANDS} candidates, {N_QUERY_PAIRS} queries, batch {BATCH}")
    log(f"forward of one resident image+text batch of {BATCH}, bf16: {forward_ms(model, cfg)} ms")

    counters = (attn_mod.attention, T.bucket_max_scores, T.bucket_max_scores_i8)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    embed_step = make_embed_step(model)
    embed_dir = os.path.join(root, "embed", EXPT)
    embed_and_save(embed_step, data, cfg, embed_dir)
    torch.cuda.synchronize()
    t_embed = time.perf_counter() - t0
    create_index(eval_config(root, "results_int8", "int8", cfg.embed_dim))
    stats = {}
    for dtype in ("int8", "bf16"):
        out: list = []
        res = run_retrieval(eval_config(root, f"results_{dtype}", dtype, cfg.embed_dim), device=DEVICE, stats_out=out)
        stats[dtype] = (res, out[0])
    torch.cuda.synchronize()
    launches = {"K1": attn_mod.attention.launches, "K2": T.bucket_max_scores.launches,
                "K4": T.bucket_max_scores_i8.launches}
    log(f"main path: embed {t_embed:.2f} s (host clock, includes first-call set-up); launches {launches}")
    for name, n in launches.items():
        results[name]["launches"] = n
        check(n > 0, f"kernel {name} was not launched on the main path")

    # correctness of what came out
    for dtype, (res, st) in stats.items():
        (row,) = res
        log(f"retrieval pool_dtype={dtype}: Recall@1={row['Recall@1']} Recall@5={row['Recall@5']} "
            f"Recall@10={row['Recall@10']} guard_pass_rate={st['guard_pass_rate']} exact_reruns={st['exact_reruns']}")
    cand_emb = np.load(os.path.join(embed_dir, "cand_pool", "mbeir_mscoco_task0_cand_pool_embed.npy")).astype(np.float32)
    cand_emb /= np.linalg.norm(cand_emb, axis=1, keepdims=True)
    sims = cand_emb @ cand_emb.T
    off = sims[~np.eye(len(sims), dtype=bool)]
    log(f"candidate embeddings: off-diagonal cosine mean {off.mean():.4f} max {off.max():.4f}")
    runs = {d: read_run(os.path.join(root, f"results_{d}", EXPT, "run_files",
                                     "mbeir_mscoco_task0_single_pool_test_k10_run.txt")) for d in stats}
    ids = {d: {q: [did for did, _ in rows] for q, rows in run.items()} for d, run in runs.items()}
    differ = [q for q in ids["bf16"] if ids["bf16"][q] != ids["int8"][q]]
    for q in differ[:3]:
        log(f"  {q} bf16: {runs['bf16'][q]}\n  {q} int8: {runs['int8'][q]}")
    check(not differ, f"int8 and bf16 retrieval returned different ids for {len(differ)} queries")
    missing = [j for j, c in copied.items() if f"9:{c}" not in ids["bf16"][f"9:{j}"]]
    check(not missing, f"duplicated candidates missing from their queries' top 10: {missing[:5]}")

    # the same forward through the plain twins, on a small batch
    small = collate(cands[:8], dids[:8], "did_list", cfg)
    small.pop("did_list"), small.pop("n_valid")
    with_kernel = embed_step(dict(small)).float()
    layers.attention = attn_mod.attention_reference
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


# -------------------------------------------------------------- phase 4: K3


def check_attention_bwd(results: dict) -> None:
    from uniir_tpu_torch.ops.attention import attention_bwd, attention_bwd_reference, attention_reference

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = 0.0
    for tag, (B, L, H, causal) in {"vision": (BATCH, 257, 16, False), "text": (BATCH, 77, 12, True)}.items():
        q, k, v, do = (torch.randn(B, L, H * 64, generator=g, device="cuda").bfloat16() for _ in range(4))
        out = attention_bwd(q, k, v, do, H, causal=causal)
        torch.cuda.synchronize()
        ref = attention_bwd_reference(q, k, v, do, H, causal=causal)
        for name, o, r in zip(("dq", "dk", "dv"), out, ref):
            err, cos, top = (o.float() - r.float()).abs().max().item(), cosine(o, r), r.abs().max().item()
            log(f"K3 attention_bwd {tag} [{B},{L},{H * 64}] H={H} causal={causal} {name}: max_abs_err={err} "
                f"cosine={cos} max_abs_ref={top}")
            # same rounding points as the twin; fp32 sums in another order can
            # flip a bf16 rounding of ds or of an output: ~2 ulps (2^-7 relative)
            check(err <= 1e-2 * max(1.0, top) and cos >= 0.9999, f"K3 {name} disagrees with its twin at {tag} shapes")
            worst = max(worst, err)
        ms = cuda_ms(lambda: attention_bwd(q, k, v, do, H, causal=causal), 20)
        plain_ms = cuda_ms(lambda: attention_bwd_reference(q, k, v, do, H, causal=causal), 5)
        # the library call: the backward of F.scaled_dot_product_attention on the same tensors
        leaves = [t.view(B, L, H, 64).transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        sdpa = torch.nn.functional.scaled_dot_product_attention(*leaves, is_causal=causal)
        g_heads = do.view(B, L, H, 64).transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(sdpa, leaves, g_heads, retain_graph=True), 20)
        del leaves, sdpa
        limit = bound(nbytes(q, k, v, do, *out), 10 * B * H * L * L * 64, BF16_OPS_PER_S)  # five L x L x D products a head
        log(f"K3 attention_bwd {tag}: kernel_ms={ms} plain_ms={plain_ms} library_ms={library_ms} {limit}")
        if tag == "vision":
            results["K3"].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **limit)
            # an independent oracle: fp32 autograd through the plain forward
            leaves = [t.float().requires_grad_() for t in (q, k, v)]
            oracle = torch.autograd.grad(attention_reference(*leaves, H, causal=causal), leaves, do.float())
            for name, o, r in zip(("dq", "dk", "dv"), out, oracle):
                err, cos = (o.float() - r).abs().max().item(), cosine(o, r)
                log(f"K3 {tag} {name} vs autograd through the plain forward: max_abs_err={err} cosine={cos}")
                # bf16 p and ds against fp32 ones: ~2^-8 relative per term
                check(err <= 6e-2 * max(1.0, r.abs().max().item()) and cos >= 0.999,
                      f"K3 {name} disagrees with autograd through the plain forward")
            del leaves, oracle
    results["K3"]["max_abs_err"] = worst


# -------------------------------------------------- phase 5: training path


def drive_train_path(results: dict) -> None:
    from uniir_tpu_torch.core.checkpoint import CHECKPOINT_FILE, load_train_checkpoint, save_train_checkpoint
    from uniir_tpu_torch.core.config import Config
    from uniir_tpu_torch.models import layers
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import load_torch_checkpoint, seeded_clip_sf, seeded_clip_sf_train
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.train.engine import train_one_epoch
    from uniir_tpu_torch.train.optimizer import make_clip_optimizer
    from uniir_tpu_torch.train.state import TrainState
    from uniir_tpu_torch.train.steps import clip_loss, make_clip_train_step, make_embed_step

    cfg = CLIP_CONFIGS[MODEL]
    rng = np.random.default_rng(SEED + 3)
    # self-attention blocks through K1/K3 per step: the pooled last block of
    # each tower attends from one row and stays plain
    blocks = (cfg.vision_layers - 1) + (cfg.text_layers - 1)

    def setup(remat: bool, seed: int = SEED):
        model = seeded_clip_sf_train(cfg, DEVICE, seed=seed, dtype=torch.bfloat16, remat=remat)
        return TrainState(model, *make_clip_optimizer(model, TRAIN_LR, total_steps=1000)), make_clip_train_step(model)

    def train(bs: int, remat: bool, n_batches: int):
        state, step = setup(remat)
        batches = [make_train_batch(rng, bs, cfg) for _ in range(n_batches + 1)]
        state, _ = step(state, batches.pop())  # warm-up: first-call set-up stays out of the times
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attn_mod.attention.launches = attn_mod.attention_bwd.launches = 0
        config = Config.from_dict({"trainer_config": {"print_freq": n_batches}})
        t0 = time.perf_counter()
        state, stats = train_one_epoch(step, state, batches, 0, config)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / n_batches
        k1, k3 = attn_mod.attention.launches, attn_mod.attention_bwd.launches
        peak = torch.cuda.max_memory_allocated()
        log(f"train {MODEL} bs={bs} pairs ({2 * bs} rows) remat={remat}: {n_batches} steps, step_ms={step_s * 1e3} "
            f"pairs_per_s={bs / step_s} max_memory_allocated={peak} ({peak / 2**30:.2f} GiB); "
            f"loss={stats['loss']} inbatch_accuracy={stats['inbatch_accuracy']}; launches K1={k1} K3={k3}")
        check(np.isfinite(float(stats["loss"])), f"train loss is not finite at bs={bs}")
        # remat recomputes each block's forward in the backward pass
        check(k1 == n_batches * blocks * (2 if remat else 1) and k3 == n_batches * blocks,
              f"K1 / K3 launched {k1} / {k3} times in {n_batches} steps of {blocks} blocks (remat={remat})")
        results["K1"]["launches"] += k1
        results["K3"]["launches"] += k3
        return state, step

    state, step = train(TRAIN_BS, False, TRAIN_BATCHES)

    # the loss falls on one batch repeated
    batch = make_train_batch(rng, TRAIN_BS, cfg)
    losses = []
    for _ in range(REPEAT_STEPS):
        state, metrics = step(state, dict(batch))
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]
    log(f"loss over {REPEAT_STEPS} steps on one batch of {TRAIN_BS} pairs: {losses}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], "the loss does not fall on a repeated batch")

    # one step's loss and gradients through K1/K3 against the plain twins
    model = state.model
    params = list(model.parameters())
    out = clip_loss(model, batch)
    grads = torch.autograd.grad(out["loss"], params)
    layers.attention = attn_mod.attention_twin
    try:
        ref = clip_loss(model, batch)
        ref_grads = torch.autograd.grad(ref["loss"], params)
    finally:
        layers.attention = attn_mod.attention
    names = [n for n, _ in model.named_parameters()]
    coss = [cosine(g_, r_) for g_, r_ in zip(grads, ref_grads)]
    finite = all(bool(torch.isfinite(g_).all()) for g_ in grads)
    worst = int(np.argmin(coss))
    loss_err = abs(out["loss"].item() - ref["loss"].item())
    log(f"train step through K1/K3 vs the twins: loss {out['loss'].item()} vs {ref['loss'].item()}, "
        f"min gradient cosine {coss[worst]} ({names[worst]}), all gradients finite={finite}")
    # bf16 attention outputs and gradients that round in other places: each
    # gradient's direction and the loss (~log 32) survive
    check(finite and loss_err <= 1e-2 and coss[worst] >= 0.99, "train-step gradients through K1/K3 disagree with the twins")
    del grads, ref_grads, out, ref

    # checkpoint round trip, and the saved model serves
    path = save_train_checkpoint(str(WORK / "ckpt"), "clip_sf", state, 0)
    fresh, _ = setup(False, seed=SEED + 1)
    fresh, epoch = load_train_checkpoint(path, fresh)
    same = all(torch.equal(p, q) for p, q in zip(model.parameters(), fresh.model.parameters()))
    a, b = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    same_opt = a["param_groups"] == b["param_groups"] and all(
        torch.equal(v, b["state"][i][key]) for i, st in a["state"].items() for key, v in st.items())
    log(f"train checkpoint round trip: parameters bit-equal={same}, optimizer state bit-equal={same_opt}, "
        f"step {fresh.step}, epoch {epoch}")
    check(same and same_opt and fresh.step == state.step and epoch == 0, "train checkpoint round trip is not exact")
    del fresh
    served = seeded_clip_sf(cfg, DEVICE, seed=SEED + 1, dtype=torch.bfloat16)
    load_torch_checkpoint(served, os.path.join(path, CHECKPOINT_FILE))
    small = make_train_batch(rng, 4, cfg)
    emb = make_embed_step(served)(small).float()
    emb_train = make_embed_step(model)(small).float()
    cos = torch.nn.functional.cosine_similarity(emb, emb_train, dim=1).min().item()
    log(f"the saved model serves: embeddings {tuple(emb.shape)}, min cosine to the trained module's {cos}")
    check(emb.shape == (8, cfg.embed_dim) and bool(torch.isfinite(emb).all()) and cos >= 0.9999,
          "the saved train checkpoint does not serve")
    del state, step, model, params, served
    shutil.rmtree(WORK / "ckpt", ignore_errors=True)
    torch.cuda.empty_cache()

    train(REMAT_BS, True, REMAT_BATCHES)
    torch.cuda.empty_cache()


def profile_train_step() -> None:
    """torch.profiler over 3 train steps of TRAIN_BS pairs: device time by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import seeded_clip_sf_train
    from uniir_tpu_torch.train.optimizer import make_clip_optimizer
    from uniir_tpu_torch.train.state import TrainState
    from uniir_tpu_torch.train.steps import make_clip_train_step

    cfg = CLIP_CONFIGS[MODEL]
    model = seeded_clip_sf_train(cfg, DEVICE, seed=SEED, dtype=torch.bfloat16)
    state = TrainState(model, *make_clip_optimizer(model, TRAIN_LR, total_steps=1000))
    step = make_clip_train_step(model)
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
    log(f"profile of a {TRAIN_BS}-pair train step: step_ms={wall * 1e3} (host clock, without the profiler)")
    log_device_time_by_group(prof, len(batches), wall * 1e3)


PROFILE_GROUPS = {
    "K1 attention_fwd": ("attention_fwd",), "K3 attention_bwd": ("attention_bwd",),
    "K5 int8_matmul": ("int8_matmul_kernel",), "K6 int8_mlp": ("int8_mlp_kernel",),
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
    from torch.profiler import ProfilerActivity, profile

    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import seeded_clip_sf

    cfg = CLIP_CONFIGS[MODEL]
    batch = resident_batch(cfg)
    models = {"bf16": seeded_clip_sf(cfg, DEVICE, seed=SEED, dtype=torch.bfloat16), **int8_models}
    for mode, model in models.items():
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
        log(f"profile of the embed forward at batch {BATCH}, mode {mode}: forward_ms={wall * 1e3} "
            f"(host clock, without the profiler) = {BATCH / wall:.1f} pairs/s")
        log_device_time_by_group(prof, 3, wall * 1e3)


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
    names = ("attention", "attention_bwd", "topk", "int8_matmul", "int8_mlp")
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
    }
    check_attention(results)
    check_sweeps(results)
    check_int8_matmul(results)
    check_int8_mlp(results)
    data = smoke_dataset()
    drive_main_path(results, data)
    int8_models = drive_int8_path(results, data)  # adds its K1 launches to the bf16 serving path's
    if "--profile" in sys.argv[1:]:
        profile_embed_steps(int8_models)
    del data, int8_models  # the training phase reads peak memory
    torch.cuda.empty_cache()
    check_attention_bwd(results)
    drive_train_path(results)  # adds its K1 launches too
    if "--profile" in sys.argv[1:]:
        profile_train_step()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s, kernel builds included")

    fields = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms")
    print(json.dumps({"kernels": [{f: r[f] for f in fields} for r in results.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
