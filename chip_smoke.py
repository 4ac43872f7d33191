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
   every query that copies a candidate finds it in its top 10.

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


def collate(items, ids, id_key: str, cfg) -> dict:
    """A batch in the collator's format (MBEIRCandidatePoolCollator / MBEIRMainCollator, eval)."""
    n_valid = len(items)
    items = items + [items[-1]] * (BATCH - n_valid)  # pad_last: repeat the last row
    ids = list(ids) + [ids[-1]] * (BATCH - n_valid)
    zero = np.zeros((cfg.image_size, cfg.image_size, 3), np.float32)
    return {
        "txt_batched": hash_tokenize([t for t, _, _, _ in items], cfg.context_length, cfg.vocab_size),
        "image_batched": np.stack([zero if im is None else im for _, im, _, _ in items]),
        "txt_mask_batched": np.asarray([m for _, _, m, _ in items], np.int32),
        "image_mask_batched": np.asarray([m for _, _, _, m in items], np.int32),
        id_key: np.asarray(ids, np.int64),
        "n_valid": np.int32(n_valid),
    }


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


def main() -> None:
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
    for name in ("attention", "topk"):
        _build.load(name)
        log(f"built {name}: {_build.build_seconds[name]:.1f} s\n{_build.ptxas_report(name)}")

    results = {
        "K1": {"name": "attention_fwd", "route": "cuda", "source": "uniir_tpu_torch/csrc/attention.cu",
               "replaces": "uniir_tpu/ops/attention_pallas.py:413"},
        "K2": {"name": "bucket_max_bf16", "route": "cuda", "source": "uniir_tpu_torch/csrc/topk.cu",
               "replaces": "uniir_tpu/ops/topk_pallas.py:118"},
        "K4": {"name": "bucket_max_i8", "route": "cuda", "source": "uniir_tpu_torch/csrc/topk.cu",
               "replaces": "uniir_tpu/ops/topk_pallas.py:291"},
    }
    check_attention(results)
    check_sweeps(results)
    drive_main_path(results)

    fields = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{f: r[f] for f in fields} for r in results.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
