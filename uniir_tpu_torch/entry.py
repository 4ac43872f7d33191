"""Entry points of the port (counterpart of __graft_entry__.py).

`entry(device=None)`   -- the flagship forward, CLIP-SF ViT-L/14 multimodal
                          embedding in bf16 at batch 8, on the card: returns
                          (fn, args), fn(*args) the [8, 768] embeddings.
`dryrun_multichip(n)`  -- n gloo ranks on the CPU (`parallel.multihost`),
                          each running one CLIP-SF train step on 2 queries
                          of a global batch of 2n, one BLIP-SF momentum step
                          on 1 query of n (the queue pointer must reach n),
                          and `sharded_topk` over a pool sharded by rows,
                          whose ids must equal a brute-force search's.
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch


def _example_batch(cfg, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    txt = rng.integers(1, cfg.vocab_size - 1, size=(n, cfg.context_length)).astype(np.int32)
    img = rng.normal(size=(n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    mask = np.ones((n,), np.int32)
    return txt, img, mask


def entry(device=None):
    """(fn, args): fn(*args) embeds 8 seeded image + text rows with a seeded
    CLIP-SF ViT-L/14 in bf16.  `device` None means the card; without one it
    raises."""
    from uniir_tpu_torch.core.device import resolve_device
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import seeded_clip_sf

    device = resolve_device(device)
    cfg = CLIP_CONFIGS["ViT-L/14"]
    model = seeded_clip_sf(cfg, device, seed=0, dtype=torch.bfloat16)
    txt, img, mask = _example_batch(cfg, 8)
    args = tuple(torch.from_numpy(x).to(device) for x in (txt, img, mask, mask))

    def fn(txt, img, txt_mask, img_mask):
        with torch.inference_mode():
            return model(txt, img, txt_mask, img_mask)

    return fn, args


def dryrun_worker(args) -> dict:
    """One rank of `dryrun_multichip`: the CLIP step, the BLIP step and the
    sharded search; raises where a check fails."""
    from uniir_tpu_torch.core import mesh
    from uniir_tpu_torch.models.blip_vit import BLIP_VIT_CONFIGS
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.med import MED_CONFIGS
    from uniir_tpu_torch.models.registry import seeded_blip_sf_train, seeded_clip_sf_train
    from uniir_tpu_torch.ops.topk import shard_pool, sharded_topk, topk_numpy_reference
    from uniir_tpu_torch.train.optimizer import make_blip_optimizer, make_clip_optimizer
    from uniir_tpu_torch.train.state import MomentumTrainState, TrainState
    from uniir_tpu_torch.train.steps import make_blip_train_step, make_clip_train_step

    n, rank, device = mesh.process_count(), mesh.process_index(), torch.device(args.device)

    # CLIP-SF: 2 queries a rank, this rank's host-major block [q_r | p_r] of a global batch of 2n pairs
    cfg = CLIP_CONFIGS["test-tiny"]
    bs = 2 * n
    txt, img, mask = _example_batch(cfg, 2 * bs)
    rows = [*range(2 * rank, 2 * rank + 2), *range(bs + 2 * rank, bs + 2 * rank + 2)]
    model = seeded_clip_sf_train(cfg, device, seed=0, dtype=torch.float32)
    mesh.broadcast_module_(model)
    state = TrainState(model, *make_clip_optimizer(model, 1e-3, 10))
    state, metrics = make_clip_train_step(model)(
        state, {"txt_batched": txt[rows], "image_batched": img[rows], "txt_mask_batched": mask[rows],
                "image_mask_batched": mask[rows]})
    assert state.step == 1, state.step
    clip_loss = metrics["loss"].item()

    # BLIP-SF: 1 query a rank; every rank enqueues the n global rows
    vit, med = BLIP_VIT_CONFIGS["test-tiny"], MED_CONFIGS["test-tiny"]
    rng = np.random.default_rng(1)
    seq, dim = 12, 16
    ids = rng.integers(4, med.vocab_size - 1, size=(2 * n, seq)).astype(np.int32)
    images = rng.normal(size=(2 * n, vit.image_size, vit.image_size, 3)).astype(np.float32)
    dids = (90_000_000 + rng.choice(10_000, size=n, replace=False)).astype(np.int64)
    rows = [rank, n + rank]
    batch = {
        "txt_batched": {"input_ids": ids[rows], "attention_mask": np.ones((2, seq), np.int32)},
        "image_batched": images[rows], "txt_mask_batched": np.ones((2,), np.int32),
        "image_mask_batched": np.ones((2,), np.int32), "p_did_list": dids[rank : rank + 1],
    }
    blip = seeded_blip_sf_train(vit, med, device, seed=0, dtype=torch.float32, embed_dim=dim)
    mesh.broadcast_module_(blip)
    bstate = MomentumTrainState.create(blip, *make_blip_optimizer(blip, 1e-3, 10), queue_size=2 * n, embed_dim=dim)
    bstate, bmetrics = make_blip_train_step(blip, with_dropout=False)(bstate, batch, 0.4)
    assert bstate.queue_ptr == n, bstate.queue_ptr
    assert bstate.queue_idx[:n].tolist() == dids.tolist(), bstate.queue_idx

    # sharded_topk: each rank holds 64 rows of a pool of 64n, searched for 8 queries
    pool = rng.normal(size=(64 * n, 32)).astype(np.float32)
    pool /= np.linalg.norm(pool, axis=1, keepdims=True)
    queries = rng.normal(size=(8, 32)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    shard, shard_rows = shard_pool(pool, device)
    _, got = sharded_topk(torch.from_numpy(queries).to(device), shard, 5, len(pool), shard_rows)
    as_bf16 = lambda x: torch.from_numpy(x).bfloat16().float().numpy()  # noqa: E731 -- the sweep's operands
    want = topk_numpy_reference(as_bf16(queries), as_bf16(pool), 5)[1]
    assert np.array_equal(got.cpu().numpy(), want), (got, want)
    return {"rank": rank, "clip_loss": clip_loss, "blip_loss": bmetrics["loss"].item(),
            "queue_ptr": bstate.queue_ptr, "topk_ids": got.cpu().tolist()}


def dryrun_multichip(n_devices: int, timeout: float = 120.0) -> list:
    """Spawn `n_devices` gloo ranks on the CPU running `dryrun_worker`;
    returns their results, raises where a rank fails."""
    from uniir_tpu_torch.parallel.multihost import launch

    with tempfile.TemporaryDirectory(prefix="uniir_dryrun_") as out_dir:
        results = launch(n_devices, out_dir, device="cpu", task="uniir_tpu_torch.entry:dryrun_worker", timeout=timeout)
    losses = {(r["clip_loss"], r["blip_loss"]) for r in results}
    assert len(losses) == 1, f"the ranks' global losses differ: {losses}"
    print(f"dryrun_multichip({n_devices}): clip loss={results[0]['clip_loss']:.4f} "
          f"blip loss={results[0]['blip_loss']:.4f} queue_ptr={results[0]['queue_ptr']} sharded_topk ids OK")
    return results


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
