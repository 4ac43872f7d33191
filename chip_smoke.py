#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py            # from the repo root; needs one CUDA card

1. builds the port's kernels (uniir_tpu_torch/csrc, nvcc for sm_90a) from the
   checkout and checks each against its plain PyTorch twin at the shapes the
   serving path gives it: K1 attention at CLIP-L vision and text shapes and
   the main path's batch, K2 / K4 sweeps at the main path's small pool and
   on a seeded 5.6M x 768 pool with 256 queries (also against brute force),
   with times for kernel and twin;
2. drives the serving path once through the port's own entry points --
   seeded CLIP-SF ViT-L/14 in bf16 embeds collated query and candidate
   batches, `create_index`, then `run_retrieval` with the int8 pool (as
   shipped) and with the bf16 pool -- and checks that every kernel was
   launched there, that the embeddings are finite and agree with a run
   through the plain twins, that both pools return the same ids, and that
   every query that copies a candidate finds it in its top 10;
3. checks K3, the attention backward, against its twin at the CLIP-L vision
   and text shapes (and against autograd through the plain forward);
4. drives the training path through the port's own entry points -- seeded
   CLIP-SF ViT-L/14 with fp32 masters and bf16 compute, `make_clip_optimizer`,
   `make_clip_train_step`, `train_one_epoch` over synthetic collated batches
   of 32 pairs, then 105 pairs (the reference's per-GPU batch) with remat --
   and checks that K1 and K3 were launched, that the loss falls on a repeated
   batch, that one step's loss and gradients through the kernels agree with
   the twins, and that a saved train checkpoint restores bit-equal and serves.

With `--profile` it also prints a torch.profiler breakdown of the 32-pair
train step by kernel group.

Prints, before the last line, the card's name and power limit and one JSON
line with each kernel's launches, error and times; the last line is
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
        log(f"K1 attention {tag} [{B},{L},{H * 64}] H={H} causal={causal}: max_abs_err={err} cosine={cos} "
            f"kernel_ms={ms} plain_ms={plain_ms}")
        # same rounding points as the twin; fp32 sums in another order -> a
        # couple of bf16 ulps of outputs of magnitude < 4
        check(err <= 3e-2 and cos >= 0.9999, f"K1 disagrees with its twin at {tag} shapes")
        worst = max(worst, err)
        if tag == "vision":
            results["K1"].update(ms=ms, plain_ms=plain_ms)
    results["K1"]["max_abs_err"] = worst


# ----------------------------------------------------------- phase 2: K2 / K4


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
    log(f"K2 bf16 sweep: max_abs_err={err2} kernel_ms={ms2} plain_ms={plain2}")
    check(err2 <= 1e-5, "K2 disagrees with its twin")  # fp32 sums of 768 products of |x| < 1
    del ref

    out8 = T.bucket_max_scores_i8(queries, pool_q, pool_scale, POOL_ROWS)
    torch.cuda.synchronize()
    q_q, q_scale = T.quantize_rows(queries)
    ref8 = T.bucket_max_scores_i8_reference(q_q, q_scale, pool_q, pool_scale, POOL_ROWS)
    err4 = (out8 - ref8).abs().max().item()
    ms4 = cuda_ms(lambda: T.bucket_max_scores_i8(queries, pool_q, pool_scale, POOL_ROWS), 5)
    plain4 = cuda_ms(lambda: T.bucket_max_scores_i8_reference(q_q, q_scale, pool_q, pool_scale, POOL_ROWS), 3)
    log(f"K4 int8 sweep: max_abs_err={err4} kernel_ms={ms4} plain_ms={plain4}")
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
    results["K2"].update(max_abs_err=err2, ms=ms2, plain_ms=plain2)
    results["K4"].update(max_abs_err=err4, ms=ms4, plain_ms=plain4)
    del pool, pool_q, pool_scale
    torch.cuda.empty_cache()


# ------------------------------------------------------- phase 3: main path


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


def eval_config(root: str, results_dir: str, pool_dtype: str, dim: int):
    from uniir_tpu_torch.core.config import Config

    return Config.from_dict({
        "uniir_dir": root,
        "mbeir_data_dir": os.path.join(root, "mbeir_data"),
        "experiment": {"path_suffix": "CLIP_SF/Large/Seeded/"},
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


def drive_main_path(results: dict) -> None:
    from uniir_tpu_torch.data.registry import hash_did, hash_qid
    from uniir_tpu_torch.models import layers
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import seeded_clip_sf
    from uniir_tpu_torch.ops import attention as attn_mod
    from uniir_tpu_torch.ops import topk as T
    from uniir_tpu_torch.retrieval.embedder import generate_embeds_and_ids_for_dataset
    from uniir_tpu_torch.retrieval.eval import run_retrieval
    from uniir_tpu_torch.retrieval.index import create_index
    from uniir_tpu_torch.train.steps import make_embed_step

    shutil.rmtree(WORK, ignore_errors=True)
    root = str(WORK)
    cfg = CLIP_CONFIGS[MODEL]
    rng = np.random.default_rng(SEED)
    cands = make_items(rng, N_CANDS, cfg.image_size)
    queries = make_items(rng, N_QUERY_PAIRS, cfg.image_size)
    copied = {j: int(rng.integers(0, N_CANDS)) for j in range(0, N_QUERY_PAIRS, 4)}  # queries that copy a candidate
    for j, c in copied.items():
        queries[j] = cands[c]
    relevant = {j: copied.get(j, int(rng.integers(0, N_CANDS))) for j in range(N_QUERY_PAIRS)}
    dids = [hash_did(f"9:{i}") for i in range(N_CANDS)]
    qids = [hash_qid(f"9:{j}") for j in range(N_QUERY_PAIRS)]
    os.makedirs(os.path.join(root, "mbeir_data", "qrels", "test"))
    with open(os.path.join(root, "mbeir_data", "qrels", "test", "mbeir_mscoco_task0_test_qrels.txt"), "w") as f:
        for j, c in relevant.items():
            f.write(f"9:{j} 0 9:{c} 1 8\n")

    t0 = time.perf_counter()
    model = seeded_clip_sf(cfg, DEVICE, seed=SEED, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"main path: seeded CLIP-SF {MODEL} bf16 ({sum(p.numel() for p in model.parameters())} parameters) "
        f"in {time.perf_counter() - t0:.1f} s; {N_CANDS} candidates, {N_QUERY_PAIRS} queries, batch {BATCH}")

    counters = (attn_mod.attention, T.bucket_max_scores, T.bucket_max_scores_i8)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    embed_step = make_embed_step(model)
    embed_dir = os.path.join(root, "embed", "CLIP_SF/Large/Seeded/")
    for split, items, ids, key, name in (
        ("cand_pool", cands, dids, "did_list", "mscoco_task0_cand_pool"),
        ("test", queries, qids, "qid_list", "mscoco_task0_test"),
    ):
        emb, got_ids = generate_embeds_and_ids_for_dataset(embed_step, batches(items, ids, key, cfg))
        check(emb.shape == (len(items), cfg.embed_dim) and emb.dtype == np.float16, f"{split} embeddings {emb.shape}")
        check(bool(np.isfinite(emb).all()), f"{split} embeddings are not finite")
        os.makedirs(os.path.join(embed_dir, split), exist_ok=True)
        np.save(os.path.join(embed_dir, split, f"mbeir_{name}_embed.npy"), emb)
        np.save(os.path.join(embed_dir, split, f"mbeir_{name}_ids.npy"), got_ids)
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
    runs = {d: read_run(os.path.join(root, f"results_{d}", "CLIP_SF/Large/Seeded/", "run_files",
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
        log(f"K3 attention_bwd {tag}: kernel_ms={ms} plain_ms={plain_ms}")
        if tag == "vision":
            results["K3"].update(ms=ms, plain_ms=plain_ms)
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
    groups = {"K1 attention_fwd": ("attention_fwd",), "K3 attention_bwd": ("attention_bwd",),
              "GEMM": ("gemm", "xmma", "cutlass", "nvjet", "cublas"), "AdamW": ("multi_tensor", "adam"),
              "reduction / norm / softmax": ("reduce", "norm", "softmax"), "elementwise / copy": ("elementwise", "copy"),
              "host-to-device copy": ("memcpy htod",)}
    totals: dict = {}
    # device kernels and copies; record_function ranges would count their kernels twice
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    for e in rows:
        name = e.key.lower()
        group = next((g for g, keys in groups.items() if any(k in name for k in keys)), "other")
        totals[group] = totals.get(group, 0.0) + e.self_device_time_total / 1e3 / len(batches)
    busy = sum(totals.values())
    log(f"profile of a {TRAIN_BS}-pair train step: step_ms={wall * 1e3} (host clock, without the profiler), "
        f"device busy_ms={busy} (idle share {1 - busy / (wall * 1e3):.4f})")
    for group, ms in sorted(totals.items(), key=lambda kv: -kv[1]):
        log(f"  {group}: {ms} ms per step ({ms / busy:.4f} of device time)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:25]:
        log(f"  {e.self_device_time_total / 1e3 / len(batches):10.3f} ms  x{e.count // len(batches):4d}  {e.key[:110]}")


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
    names = ("attention", "attention_bwd", "topk")
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
    }
    check_attention(results)
    check_sweeps(results)
    drive_main_path(results)
    check_attention_bwd(results)
    drive_train_path(results)  # adds its K1 launches to the serving path's
    if "--profile" in sys.argv[1:]:
        profile_train_step()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s, kernel builds included")

    fields = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{f: r[f] for f in fields} for r in results.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
