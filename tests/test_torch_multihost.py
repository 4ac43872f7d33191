"""The port over several processes: two gloo ranks on the CPU against one
process and against the JAX package, at `test-tiny`.

One launch of two ranks (`uniir_tpu_torch.parallel.multihost.launch`, a
`file://` rendezvous under the test's directory, a 120 s limit) runs every
scenario of `rank_worker` and saves what each rank saw; the tests compare
it with the same functions run in this process (one rank) and with the JAX
steps on the global batch:

  * the CLIP-SF, CLIP-FF (dropout off) and hard-negative train steps, two
    updates: loss, the averaged gradients of each update and the parameters
    (`logit_scale` included, which a sum in place of the mean would double)
    within 1e-6 of one process and within the fp32 step limits of
    tests/test_torch_train.py of JAX;
  * accumulation over 2 micro-batches: one all-reduce an update;
  * BLIP-SF and BLIP-FF momentum steps: loss, params, params_m, queues and
    queue_ptr against JAX, equal on both ranks;
  * dropout: two ranks draw different masks for the same rows;
  * part-file embedding of 13 rows at batch 4, `create_index`,
    `run_retrieval` and `sharded_topk`: the one-process files and ids, one
    writer;
  * the trainer's `main` for one epoch and a resume; the default smoke
    task.

The weights come from the JAX package through `state_dict_from_jax`; the
ranks import neither JAX nor the JAX package.  A `-m gpu` twin runs the
two-rank CLIP step on the card (two ranks on cuda:0 over gloo)."""

from __future__ import annotations

import builtins
import os
import zlib

import numpy as np
import pytest
import torch

from uniir_tpu_torch.core import mesh
from uniir_tpu_torch.models.clip import CLIP_CONFIGS
from uniir_tpu_torch.parallel.multihost import launch

pytestmark = pytest.mark.multihost

W = 2  # ranks
BS = 4  # global queries of a CLIP / BLIP step (2 a rank)
LR, FUSION_LR, TOTAL_STEPS, SEED = 1e-3, 4e-3, 10, 7
TASK = f"{os.path.abspath(__file__)}:rank_worker"  # by path: another `tests` package may shadow this one
CFG, FF_CFG = CLIP_CONFIGS["test-tiny"], CLIP_CONFIGS["test-tiny-ff"]
# (model, hard_neg_num, in_batch_neg_num) of each CLIP case
CLIP_CASES = {"sf": ("sf", 0, 0), "ff": ("ff", 0, 0), "hardneg": ("sf", 1, 2)}
BLIP_SF_DIM, BLIP_QUEUE, BLIP_SEQ, ALPHA = 16, 16, 12, 0.4
# two ranks against one process: the same fp32 arithmetic but for the order
# of the sums over rows (two backwards summed by the all-reduce, one over
# both blocks).  The loss within 1e-6.  A gradient as the norm of its
# difference over its norm: measured up to 1.3e-5, in a LayerNorm weight's
# gradient, a sum over rows and tokens that cancels.  A parameter after the
# updates element by element: Adam divides each gradient element by its own
# magnitude, so the rounding of a small element moves it by a share of a
# step; measured up to 0.54% of the lr
LOSS_RTOL, GRAD_RTOL, PARAM_RTOL, PARAM_LR_SHARE = 1e-6, 5e-5, 1e-6, 0.02
# against the JAX step: tests/test_torch_train.py's fp32 step limits --
# summation order and flax's E[x^2] - E[x]^2 LayerNorm variance, 1e-5 of the
# largest element of a tensor, and Adam's amplification of gradient
# elements within rounding noise of 0 (5% of a step's lr)
JAX_RTOL, JAX_ATOL = 1e-4, 1e-5
N_CANDS, N_QUERIES, EMBED_BATCH = 13, 12, 4
POOL_N, POOL_D, POOL_Q, POOL_K = 199, 32, 8, 6


# ------------------------------------------------------------ shared inputs


def crc_tokenizer(max_len: int, vocab_size: int):
    """A tokenizer equal in every process (Python's str hash is salted per process)."""

    def fn(texts):
        out = np.zeros((len(texts), max_len), np.int32)
        for i, text in enumerate(texts):
            ids = [1] + [2 + zlib.crc32(w.encode()) % (vocab_size - 3) for w in text.lower().split()][: max_len - 2]
            ids.append(vocab_size - 1)
            out[i, : len(ids)] = ids
        return out

    return fn


def image_transform(size: int):
    def fn(img):
        return np.asarray(img.resize((size, size)), dtype=np.float32) / 255.0

    return fn


def clip_batch(cfg, bs: int, neg: int, seed: int) -> dict:
    """A collated CLIP train batch in the flat layout [q | p | n], mixed modality."""
    rng = np.random.default_rng(seed)
    n = (2 + neg) * bs
    txt = np.zeros((n, cfg.context_length), np.int32)
    for i in range(n):
        length = 3 + i % (cfg.context_length - 4)
        txt[i, :length] = rng.integers(1, cfg.vocab_size - 1, length)
        txt[i, length] = cfg.vocab_size - 1
    return {
        "txt_batched": txt,
        "image_batched": rng.random((n, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
        "txt_mask_batched": np.array([1, 1, 0] * n, np.int32)[:n],
        "image_mask_batched": np.array([1, 0, 1] * n, np.int32)[::-1][:n].copy(),
    }


def blip_batch(vit, med, seed: int, dids=None) -> dict:
    rng = np.random.default_rng(seed)
    n = 2 * BS
    ids, mask = np.zeros((n, BLIP_SEQ), np.int32), np.zeros((n, BLIP_SEQ), np.int32)
    for i in range(n):
        length = 3 + (2 * i + seed) % (BLIP_SEQ - 3)
        ids[i, :length] = rng.integers(4, med.vocab_size, length)
        mask[i, :length] = 1
    return {
        "txt_batched": {"input_ids": ids, "attention_mask": mask},
        "image_batched": rng.standard_normal((n, vit.image_size, vit.image_size, 3)).astype(np.float32),
        "txt_mask_batched": np.array([1, 1, 0] * n, np.int32)[:n],
        "image_mask_batched": np.array([1, 0, 1] * n, np.int32)[::-1][:n].copy(),
        "p_did_list": (1000 + 10 * seed + np.arange(BS) if dids is None else np.asarray(dids)).astype(np.int64),
    }


def host_block(batch: dict, bs: int, neg: int, rank: int, n_ranks: int) -> dict:
    """Rank `rank`'s block [q_r | p_r | n_r] of a global flat batch: the
    host-major layout the ranks' gathered rows make."""
    if n_ranks == 1:
        return batch
    bl = bs // n_ranks
    rows = np.r_[rank * bl : (rank + 1) * bl, bs + rank * bl : bs + (rank + 1) * bl,
                 2 * bs + rank * bl * neg : 2 * bs + (rank + 1) * bl * neg]

    def take(key, x):
        if isinstance(x, dict):
            return {k: take(k, v) for k, v in x.items()}
        if key in ("p_did_list", "nc_dids_list"):
            return x[rank * bl : (rank + 1) * bl]
        return x[rows]

    return {key: take(key, value) for key, value in batch.items()}


def record_updates(state) -> list:
    """The gradients each optimizer update applies (after the all-reduce)."""
    grads = []
    state.optimizer.register_step_pre_hook(lambda *_: grads.append(
        {n: p.grad.detach().clone() for n, p in state.model.named_parameters() if p.grad is not None}))
    return grads


class WriteLog:
    """The files this process opens for writing or saves, while active."""

    def __init__(self):
        self.paths: list = []

    def __enter__(self):
        self.saved = builtins.open, np.save, np.savez, torch.save
        open_, save, savez, tsave = self.saved

        def opened(path, mode="r", *args, **kwargs):
            if any(c in mode for c in "wax"):
                self.paths.append(os.path.abspath(str(path)))
            return open_(path, mode, *args, **kwargs)

        def logged(fn, at):  # the path is argument `at`
            def inner(*args, **kwargs):
                self.paths.append(os.path.abspath(str(args[at])))
                return fn(*args, **kwargs)
            return inner

        builtins.open, np.save, np.savez, torch.save = opened, logged(save, 0), logged(savez, 0), logged(tsave, 1)
        return self

    def __exit__(self, *exc):
        builtins.open, np.save, np.savez, torch.save = self.saved


# ---------------------------------------------------- what each rank runs


def _clip_model(kind: str, state_dict: dict, device="cpu"):
    from uniir_tpu_torch.models.clip_ff import CLIPFeatureFusion
    from uniir_tpu_torch.models.clip_sf import CLIPScoreFusion

    model = CLIPScoreFusion(CFG) if kind == "sf" else CLIPFeatureFusion(FF_CFG)
    model.load_state_dict(state_dict)
    return model.to(device)


def run_clip(inputs: dict, case: str, accum: int = 1, device="cpu") -> dict:
    """Two CLIP micro-batches through `make_clip_train_step` on this rank's
    blocks (the whole batches in one process)."""
    from uniir_tpu_torch.train.optimizer import make_clip_optimizer
    from uniir_tpu_torch.train.state import TrainState
    from uniir_tpu_torch.train.steps import make_clip_train_step

    kind, neg, in_batch = CLIP_CASES[case]
    model = _clip_model(kind, inputs[f"clip_{kind}"], device)
    mesh.broadcast_module_(model)
    state = TrainState(model, *make_clip_optimizer(model, LR, TOTAL_STEPS, fusion_learning_rate=FUSION_LR),
                       accumulation_steps=accum)
    grads = record_updates(state)
    step = make_clip_train_step(model, hard_neg_num=neg, in_batch_neg_num=in_batch)
    losses, accs = [], []
    for batch in inputs[f"clip_batches_{case}"]:
        state, metrics = step(state, host_block(batch, BS, neg, mesh.process_index(), mesh.process_count()))
        losses.append(metrics["loss"].item())
        accs.append(metrics["inbatch_accuracy"].item())
    return {"losses": losses, "accs": accs, "grads": grads, "step": state.step,
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}


def _blip_state(inputs: dict, name: str):
    from uniir_tpu_torch.models.blip_ff import BLIPFeatureFusion
    from uniir_tpu_torch.models.blip_sf import BLIPScoreFusion
    from uniir_tpu_torch.models.blip_vit import BLIP_VIT_CONFIGS
    from uniir_tpu_torch.models.med import MED_CONFIGS
    from uniir_tpu_torch.train.optimizer import make_blip_optimizer
    from uniir_tpu_torch.train.state import MomentumTrainState

    vit, med = BLIP_VIT_CONFIGS["test-tiny"], MED_CONFIGS["test-tiny"]
    model = (BLIPScoreFusion if name == "sf" else BLIPFeatureFusion)(vit, med, BLIP_SF_DIM).train()
    saved = inputs[f"blip_{name}"]
    model.load_state_dict(saved["model"])
    mesh.broadcast_module_(model)
    dim = BLIP_SF_DIM if name == "sf" else med.hidden_size
    state = MomentumTrainState.create(model, *make_blip_optimizer(model, LR, TOTAL_STEPS), queue_size=BLIP_QUEUE,
                                      embed_dim=dim)
    state.model_m.load_state_dict(saved["model_m"])
    for key in ("queue_query", "queue_cand", "queue_idx"):
        getattr(state, key).copy_(saved[key])
    state.queue_ptr = saved["queue_ptr"]
    return state


def run_blip(inputs: dict, name: str) -> dict:
    from uniir_tpu_torch.train.steps import make_blip_train_step

    state = _blip_state(inputs, name)
    step = make_blip_train_step(state.model, with_dropout=False)
    losses, accs = [], []
    for batch in inputs["blip_batches"]:
        state, metrics = step(state, host_block(batch, BS, 0, mesh.process_index(), mesh.process_count()), ALPHA)
        losses.append(metrics["loss"].item())
        accs.append(metrics["inbatch_accuracy"].item())
    return {"losses": losses, "accs": accs, "queue_ptr": state.queue_ptr,
            "params": {k: v.clone() for k, v in state.model.state_dict().items()},
            "params_m": {k: v.clone() for k, v in state.model_m.state_dict().items()},
            **{key: getattr(state, key).clone() for key in ("queue_query", "queue_cand", "queue_idx")}}


def run_dropout(inputs: dict) -> dict:
    """One CLIP-FF step with the fusion dropout on, both ranks given the same
    rows: the embeddings each rank's forward returned."""
    from uniir_tpu_torch.train.optimizer import make_clip_optimizer
    from uniir_tpu_torch.train.state import TrainState
    from uniir_tpu_torch.train.steps import make_clip_train_step

    model = _clip_model("ff", inputs["clip_ff"])
    seen = []
    model.register_forward_hook(lambda module, args, out: seen.append(out.detach().clone()))
    state = TrainState(model, *make_clip_optimizer(model, LR, TOTAL_STEPS))
    batch = clip_batch(FF_CFG, BS // W, 0, seed=5)  # every rank's block: the same rows
    make_clip_train_step(model, with_dropout=True, seed=SEED)(state, batch)
    model.eval()
    with torch.no_grad():
        seen.append(model(*(torch.as_tensor(batch[k]) for k in ("txt_batched", "image_batched", "txt_mask_batched",
                                                                   "image_mask_batched"))))
    return {"train": seen[0], "eval": seen[1]}


def embed_bundle(inputs: dict):
    from uniir_tpu_torch.models.registry import ModelBundle

    model = _clip_model("sf", inputs["clip_sf"]).eval()
    transform = image_transform(CFG.image_size)
    return ModelBundle("CLIPScoreFusion", model, crc_tokenizer(CFG.context_length, CFG.vocab_size), transform,
                       transform, (CFG.image_size, CFG.image_size), CFG.embed_dim)


def run_pipeline(inputs: dict, uniir_dir: str) -> dict:
    """Embed (part files), `create_index` and `run_retrieval` into `uniir_dir`."""
    from uniir_tpu_torch.core.config import Config
    from uniir_tpu_torch.retrieval.embedder import generate_embeds_for_config
    from uniir_tpu_torch.retrieval.eval import run_retrieval
    from uniir_tpu_torch.retrieval.index import create_index

    config = Config.from_dict(dict(inputs["eval_config"], uniir_dir=uniir_dir))
    bundle = embed_bundle(inputs)
    out = {}
    with WriteLog() as log:
        generate_embeds_for_config(bundle, config)
    out["embed_writes"] = log.paths
    with WriteLog() as log:
        out["index"] = create_index(config)
    out["index_writes"] = log.paths
    with WriteLog() as log:
        out["recall"] = run_retrieval(config, device="cpu")
    out["retrieval_writes"] = log.paths
    return out


def run_sharded_topk(inputs: dict) -> dict:
    from uniir_tpu_torch.ops.topk import shard_pool, sharded_topk

    shard, shard_rows = shard_pool(inputs["pool"], "cpu")
    scores, ids = sharded_topk(torch.from_numpy(inputs["pool_queries"]), shard, POOL_K, POOL_N, shard_rows)
    return {"scores": scores, "ids": ids, "shard_rows": shard_rows}


def run_trainer(inputs: dict, root: str) -> dict:
    """The trainer's `main` for one epoch, then resumed for a second."""
    from uniir_tpu_torch.core.config import Config
    from uniir_tpu_torch.models.registry import ModelBundle, seeded_clip_sf_train
    from uniir_tpu_torch.train import trainer

    def bundle():
        model = seeded_clip_sf_train(CFG, "cpu", seed=0, dtype=torch.float32)
        transform = image_transform(CFG.image_size)
        return ModelBundle("CLIPScoreFusion", model, crc_tokenizer(CFG.context_length, CFG.vocab_size), transform,
                           transform, (CFG.image_size, CFG.image_size), CFG.embed_dim)

    out = {}
    for epochs, resume in ((1, ""), (2, "test_sf_epoch_0")):
        config = Config.from_dict(inputs["train_config"])
        config.uniir_dir = root
        config.trainer_config.num_train_epochs = epochs
        config.model.ckpt_config.resume_training = bool(resume)
        config.model.ckpt_config.ckpt_name = resume
        with WriteLog() as log:
            result = trainer.main(config, bundle=bundle())
        out[epochs] = {"step": result["state"].step, "stats": result["stats"], "writes": log.paths,
                       "params": {n: p.detach().clone() for n, p in result["state"].model.named_parameters()}}
    return out


def rank_worker(args) -> dict:
    """Every scenario on this rank; the results go to rank{r}.pt beside the inputs."""
    from uniir_tpu_torch.parallel.multihost import smoke_worker

    d = args.task_args["dir"]
    inputs = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    rank = mesh.process_index()
    out = {"smoke": smoke_worker(args)}
    for case in args.task_args.get("cases", CLIP_CASES):
        out[case] = run_clip(inputs, case, device=args.device)
    if args.task_args.get("cases") is None:
        calls = []
        reduce = mesh.all_reduce_mean_
        mesh.all_reduce_mean_ = lambda tensors: (calls.append(len(tensors)), reduce(tensors))
        out["accum"] = run_clip(inputs, "sf", accum=2)
        mesh.all_reduce_mean_ = reduce
        out["accum"]["all_reduces"] = len(calls)
        out["dropout"] = run_dropout(inputs)
        for name in ("sf", "ff"):
            out[f"blip_{name}"] = run_blip(inputs, name)
        out["pipeline"] = run_pipeline(inputs, os.path.join(d, "two"))
        out["topk"] = run_sharded_topk(inputs)
        out["trainer"] = run_trainer(inputs, os.path.join(d, "trainer"))
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    return {"rank": rank}


# ----------------------------------------------- inputs and the two ranks


def _jax_clip(kind):
    from uniir_tpu.models.clip import CLIP_CONFIGS as JAX_CONFIGS
    from uniir_tpu.models.clip_ff import CLIPFeatureFusion as JaxFF
    from uniir_tpu.models.clip_sf import CLIPScoreFusion as JaxSF

    return JaxSF(JAX_CONFIGS["test-tiny"]) if kind == "sf" else JaxFF(JAX_CONFIGS["test-tiny-ff"])


def _jax_clip_params(kind):
    import jax

    b = clip_batch(CFG if kind == "sf" else FF_CFG, BS, 0, seed=0)
    init = jax.jit(_jax_clip(kind).init)(jax.random.PRNGKey(0), *(b[k][:2] for k in b))
    return jax.tree_util.tree_map(np.asarray, init["params"])


def _eval_config(mbeir: str) -> dict:
    data = {"enable_embed": True, "datasets_name": ["mscoco_task0"], "correspond_cand_pools_name": ["mscoco_task0"]}
    retrieve = {"enable_retrieve": True, "datasets_name": ["mscoco_task0"],
                "correspond_cand_pools_name": ["mscoco_task0"], "correspond_qrels_name": ["mscoco_task0"],
                "correspond_metrics_name": ["Recall@1, Recall@5"]}
    return {
        "mbeir_data_dir": mbeir, "seed": 2023, "experiment": {"path_suffix": "CLIP_SF/Tiny/TwoRanks/"},
        "data_config": {"image_size": f"{CFG.image_size}, {CFG.image_size}", "enable_query_instruct": False,
                        "shuffle_cand": False, "test_dir_name": "query/test", "cand_pool_dir_name": "cand_pool/local",
                        "query_instruct_path": "instructions/query_instructions.tsv"},
        "dataloader_config": {"num_workers": 2, "batch_size": EMBED_BATCH},
        "embed_config": {"embed_dir_name": "embed", "use_fp16": True, "test_datasets_config": data,
                         "cand_pools_config": {"enable_embed": True, "embed_union_pool": True,
                                               "cand_pools_name_to_embed": ["mscoco_task0"]}},
        "index_config": {"embed_dir_name": "embed", "index_dir_name": "index",
                         "cand_pools_config": {"enable_idx": True, "cand_pools_name_to_idx": ["mscoco_task0", "union"]}},
        "retrieval_config": {"qrel_dir_name": "qrels", "embed_dir_name": "embed", "index_dir_name": "index",
                             "results_dir_name": "retrieval_results", "write_to_tsv": True,
                             "test_datasets_config": retrieve},
    }


def _train_config(mbeir: str) -> dict:
    return {
        "mbeir_data_dir": mbeir, "seed": 2023,
        "data_config": {
            "image_size": f"{CFG.image_size}, {CFG.image_size}", "hard_neg_num": 0, "in_batch_neg_num": 0,
            "shuffle_cand": True, "returns": None, "enable_query_instruct": True,
            "query_instruct_path": "instructions.tsv", "train_query_data_path": "queries.jsonl",
            "train_cand_pool_path": "cand_pool.jsonl", "val_query_data_path": "queries.jsonl",
            "val_cand_pool_path": "cand_pool.jsonl",
        },
        "dataloader_config": {"num_workers": 2, "train_batch_size": 4, "valid_batch_size": 4},
        "trainer_config": {"gradient_accumulation_steps": 1, "num_train_epochs": 1, "learning_rate": 3e-3,
                           "warmup_steps": 0, "print_freq": 1},
        "evaluator": {"enable_eval": True, "eval_freq": 1, "print_freq": 10},
        "model": {"name": "CLIPScoreFusion", "short_name": "TEST_SF", "size": "Tiny", "bf16": False,
                  "clip_vision_model_name": "test-tiny",
                  "ckpt_config": {"ckpt_dir": "checkpoint/test/", "resume_training": False, "ckpt_name": ""}},
    }


def _blip_inputs(jax_states: dict) -> dict:
    """The port's starting BLIP states (online and momentum models, queues),
    carried over from the JAX states by `load_momentum_state_from_jax`."""
    from tests.test_torch_blip_train import _port_state, _to_numpy
    from uniir_tpu_torch.models.convert import load_momentum_state_from_jax

    out = {}
    for name, js in jax_states.items():
        state = _port_state(name, None)
        load_momentum_state_from_jax(state, **_to_numpy(js))
        out[f"blip_{name}"] = {"model": state.model.state_dict(), "model_m": state.model_m.state_dict(),
                               "queue_query": state.queue_query, "queue_cand": state.queue_cand,
                               "queue_idx": state.queue_idx, "queue_ptr": state.queue_ptr}
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs (JAX weights carried over, batches, an M-BEIR tree), the
    two ranks' results and the JAX states they start from."""
    from tests.helpers import build_mbeir_fixture, build_pipeline_tree
    from tests.test_torch_blip_train import _init_jax, _jax_state
    from uniir_tpu_torch.models.blip_vit import BLIP_VIT_CONFIGS
    from uniir_tpu_torch.models.convert import state_dict_from_jax
    from uniir_tpu_torch.models.med import MED_CONFIGS

    d = tmp_path_factory.mktemp("torch_multihost")
    root = str(d / "tree")
    build_pipeline_tree(root, n_queries=N_QUERIES, n_cands=N_CANDS)
    build_mbeir_fixture(str(d / "train_tree"), n_queries=16, n_cands=24)
    jax_clip = {kind: _jax_clip_params(kind) for kind in ("sf", "ff")}
    jax_blip = {name: _jax_state(name, _init_jax(name)) for name in ("sf", "ff")}
    vit, med = BLIP_VIT_CONFIGS["test-tiny"], MED_CONFIGS["test-tiny"]
    rng = np.random.default_rng(3)
    pool = torch.from_numpy(rng.standard_normal((POOL_N, POOL_D)).astype(np.float32)).bfloat16().float().numpy()
    pool[150] = pool[50]  # one row on each side of the shard boundary (100): the lower index must win
    pool[120] = pool[30]
    queries = torch.from_numpy(rng.standard_normal((POOL_Q, POOL_D)).astype(np.float32)).bfloat16().float().numpy()
    queries[0], queries[1] = pool[50], pool[30]
    inputs = {
        **{f"clip_{kind}": state_dict_from_jax(params) for kind, params in jax_clip.items()},
        **{f"clip_batches_{case}": [clip_batch(CFG if kind == "sf" else FF_CFG, BS, neg, seed) for seed in (0, 1)]
           for case, (kind, neg, _) in CLIP_CASES.items()},
        **_blip_inputs(jax_blip),
        "blip_batches": [blip_batch(vit, med, 0), blip_batch(vit, med, 1, dids=[1001, 2001, 2002, 2003])],
        "eval_config": _eval_config(os.path.join(root, "mbeir_data")),
        "train_config": _train_config(str(d / "train_tree")),
        "pool": pool, "pool_queries": queries,
    }
    torch.save(inputs, d / "inputs.pt")
    launch(W, str(d / "ranks"), device="cpu", task=TASK, task_args={"dir": str(d)}, timeout=120)
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(W)]
    return {"dir": d, "inputs": inputs, "ranks": ranks, "jax_clip": jax_clip, "jax_blip": jax_blip}


# ---------------------------------------------------------------- checks


def _close(got, want, name, rtol=GRAD_RTOL):
    """||got - want|| <= rtol * ||want||."""
    err = (got.double() - want.double()).norm().item()
    assert err <= rtol * want.double().norm().item() or err == 0.0, f"{name}: relative error {err / want.norm().item()}"


def _key_bias_third(name: str, t: torch.Tensor):
    """The key third of a fused in-projection bias: its true gradient is 0
    (a key bias shifts every logit of a row alike), so it holds rounding
    noise, which Adam turns into steps of about +-lr."""
    if name.endswith(("attn.in_proj_bias", "attn.qkv.bias")):
        n = t.numel() // 3
        return slice(n, 2 * n)
    return None


def _without_key_bias(got: torch.Tensor, want: torch.Tensor, name: str, lr: float, steps: int):
    """(got, want) without the key-bias elements, which are held only to the
    steps' bound."""
    third = _key_bias_third(name, got)
    if third is None and not name.endswith("self.key.bias"):
        return got, want
    third = third or slice(None)
    assert (got[third] - want[third]).abs().max() <= 2 * 2 * steps * lr, name
    keep = torch.ones(got.numel(), dtype=torch.bool)
    keep[third] = False
    return got[keep], want[keep]


def _params_close(got: torch.Tensor, want: torch.Tensor, name: str, lr: float, rtol: float, atol: float, steps=2):
    got, want = _without_key_bias(got, want, name, lr, steps)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol * max(1.0, want.abs().max().item()) + 0.05 * lr,
                               msg=lambda m: f"{name}: {m}")


def _params_close_to_one_process(got: torch.Tensor, want: torch.Tensor, name: str, lr: float, steps: int = 2,
                                 rtol: float = PARAM_RTOL):
    got, want = _without_key_bias(got, want, name, lr, steps)
    torch.testing.assert_close(got, want, rtol=rtol, atol=PARAM_LR_SHARE * lr, msg=lambda m: f"{name}: {m}")


def _jax_clip_run(setup, case):
    import jax

    from uniir_tpu.train.optimizer import make_clip_optimizer as jax_optimizer
    from uniir_tpu.train.state import TrainState as JaxTrainState
    from uniir_tpu.train.steps import make_clip_train_step as jax_train_step
    from uniir_tpu_torch.models.convert import state_dict_from_jax

    kind, neg, in_batch = CLIP_CASES[case]
    params = setup["jax_clip"][kind]
    state = JaxTrainState.create(params, jax_optimizer(params, LR, TOTAL_STEPS,
                                                       fusion_learning_rate=FUSION_LR if kind == "ff" else None))
    step = jax_train_step(_jax_clip(kind), hard_neg_num=neg, in_batch_neg_num=in_batch)
    losses = []
    for batch in setup["inputs"][f"clip_batches_{case}"]:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state.params))


@pytest.mark.parametrize("case", list(CLIP_CASES))
def test_two_rank_clip_steps_match_one_process_and_jax(setup, case):
    """Loss, accuracy, each update's gradients and the parameters after two
    updates, `logit_scale` included: equal on both ranks, within 1e-6 of one
    process at the same global batch, and within the fp32 step limits of
    the JAX step."""
    one = run_clip(setup["inputs"], case)
    r0, r1 = (r[case] for r in setup["ranks"])
    assert r0["losses"] == r1["losses"] and r0["accs"] == r1["accs"] == one["accs"]
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=LOSS_RTOL)
    assert len(r0["grads"]) == len(one["grads"]) == 2 and r0["step"] == 2
    for got, other, want in zip(r0["grads"], r1["grads"], one["grads"]):
        assert got.keys() == want.keys()
        for name in want:
            assert torch.equal(got[name], other[name]), name
            _close(got[name], want[name], f"grad {name}")
    (scale,) = [name for name in one["grads"][0] if name.endswith("logit_scale")]
    assert abs(one["grads"][0][scale].item()) > 1e-4  # held above, at a size a sum over the ranks would double
    lr_of = lambda n: FUSION_LR if n.startswith("t5_layers.") else LR  # noqa: E731
    for name, want in one["params"].items():
        assert torch.equal(r0["params"][name], r1["params"][name]), name
        _params_close_to_one_process(r0["params"][name], want, name, lr_of(name))

    jax_losses, jax_params = _jax_clip_run(setup, case)
    np.testing.assert_allclose(r0["losses"], jax_losses, rtol=JAX_RTOL, atol=JAX_ATOL)
    for name, want in jax_params.items():
        got, lr = r0["params"][name], lr_of(name)
        if name.startswith("t5_layers."):
            # tests/test_torch_train.py: a ReLU input within rounding of 0 may fall either way in the two
            # frameworks; at most 1 element in 10^4 of a fusion tensor off, each within the steps' bound
            third = _key_bias_third(name, got) or slice(0, 0)
            keep = torch.ones(got.numel(), dtype=torch.bool)
            keep[third] = False
            close = torch.isclose(got.flatten()[keep], want.flatten()[keep], rtol=JAX_RTOL, atol=JAX_ATOL + 0.05 * lr)
            assert (~close).sum().item() <= max(1, got.numel() // 10_000), name
            assert (got - want).abs().max() <= 2 * 2 * lr, name
        else:
            _params_close(got, want, name, lr, JAX_RTOL, JAX_ATOL)


def test_logit_scale_is_averaged_not_summed(setup):
    """`logit_scale` reads the loss directly, so each rank holds its whole
    gradient: the mean over the ranks is it, a sum would be W times it."""
    one = run_clip(setup["inputs"], "sf")
    g2, g1 = setup["ranks"][0]["sf"]["grads"][0]["logit_scale"], one["grads"][0]["logit_scale"]
    _close(g2, g1, "logit_scale")
    assert not torch.allclose(g2, W * g1, rtol=0.1)


def test_accumulation_makes_one_all_reduce_an_update(setup):
    one = run_clip(setup["inputs"], "sf", accum=2)
    for rank in setup["ranks"]:
        got = rank["accum"]
        assert got["all_reduces"] == 1 and got["step"] == 2 and len(got["grads"]) == 1
        for name, want in one["grads"][0].items():
            _close(got["grads"][0][name], want, f"grad {name}")
        for name, want in one["params"].items():
            _params_close_to_one_process(got["params"][name], want, name, LR, steps=1)


@pytest.mark.parametrize("name", ["sf", "ff"])
def test_two_rank_blip_steps_match_jax_with_equal_queues(setup, name):
    """Two BLIP momentum steps (dropout off): loss, params, params_m,
    queues and queue_ptr within the fp32 step limits of the JAX step at the
    global batch; both ranks hold the same state."""
    from tests.test_torch_blip_train import _assert_params_close, _jax_model, _to_numpy
    from uniir_tpu.train.steps import make_blip_train_step as jax_train_step
    from uniir_tpu_torch.models.convert import state_dict_from_jax

    r0, r1 = (r[f"blip_{name}"] for r in setup["ranks"])
    assert r0["losses"] == r1["losses"] and r0["queue_ptr"] == r1["queue_ptr"] == 2 * BS
    for key in ("queue_query", "queue_cand", "queue_idx"):
        assert torch.equal(r0[key], r1[key]), key
    for tree in ("params", "params_m"):
        for key, value in r0[tree].items():
            assert torch.equal(value, r1[tree][key]), (tree, key)

    js = setup["jax_blip"][name]
    step = jax_train_step(_jax_model(name), with_dropout=False)
    for batch, loss, acc in zip(setup["inputs"]["blip_batches"], r0["losses"], r0["accs"]):
        js, metrics = step(js, batch, np.float32(ALPHA))
        np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=1e-5, atol=1e-5)
        assert acc == float(metrics["inbatch_accuracy"])
    want = _to_numpy(js)
    assert r0["queue_ptr"] == int(want["queue_ptr"])
    for key in ("queue_query", "queue_cand"):
        torch.testing.assert_close(r0[key], torch.from_numpy(np.array(want[key])), rtol=1e-5, atol=1e-5)
    assert r0["queue_idx"].tolist() == want["queue_idx"].tolist()
    for tree in ("params", "params_m"):
        ref = state_dict_from_jax(want[tree])
        assert ref.keys() <= r0[tree].keys()
        for key, value in ref.items():
            _assert_params_close(r0[tree][key], value, f"{tree} {key}")


def test_two_ranks_draw_different_dropout_masks(setup):
    """Both ranks embed the same rows in a CLIP-FF step with the fusion
    dropout on: their masks, and so their embeddings, differ; without
    dropout the rows embed alike."""
    r0, r1 = (r["dropout"] for r in setup["ranks"])
    assert torch.equal(r0["eval"], r1["eval"])
    assert not torch.allclose(r0["train"], r1["train"])


def test_one_process_keeps_the_dropout_stream():
    """One process seeds dropout from (seed, step) alone, as before the
    ranks were folded in; two ranks fold in their rank."""
    from uniir_tpu_torch.train.steps import _dropout_seed, step_seed

    for seed, step in ((0, 0), (7, 3), (2023, 41)):
        old = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> np.uint64(1))
        assert step_seed(seed, step) == _dropout_seed(seed, step, 1) == old
        assert step_seed(seed, step, 0) != step_seed(seed, step, 1) != old


def _tree(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, f), root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def one_process_pipeline(setup):
    root = str(setup["dir"] / "one")
    return run_pipeline(setup["inputs"], root), root


def test_part_file_embedding_matches_one_process(setup, one_process_pipeline):
    """13 rows over 2 ranks at batch 4 (rank 0: 7 rows, a padded batch of 3;
    rank 1: 6, a padded batch of 2): rank 0's joined files are bit-equal to
    one process's, no pad row or part file is left, and rank 1 writes only
    its part files."""
    _, one_root = one_process_pipeline
    two_root = str(setup["dir"] / "two")
    embed = os.path.join("embed", "CLIP_SF/Tiny/TwoRanks")
    two, one = _tree(os.path.join(two_root, embed)), _tree(os.path.join(one_root, embed))
    assert two.keys() == one.keys() and not any(".part" in k for k in two)
    assert two == one
    ids = np.load(os.path.join(two_root, embed, "cand_pool", "mbeir_mscoco_task0_cand_pool_ids.npy"))
    assert len(ids) == N_CANDS and len(set(ids.tolist())) == N_CANDS
    writes = setup["ranks"][1]["pipeline"]["embed_writes"]
    assert writes and all(".part1" in w for w in writes), writes
    final = {os.path.relpath(w, os.path.join(two_root, embed)) for w in setup["ranks"][0]["pipeline"]["embed_writes"]
             if ".part" not in w}
    assert final == set(two), final  # rank 0 writes every joined file, the union pool's too


def test_index_and_retrieval_have_one_writer_and_the_one_process_files(setup, one_process_pipeline):
    one, one_root = one_process_pipeline
    two_root = str(setup["dir"] / "two")
    r0, r1 = (r["pipeline"] for r in setup["ranks"])
    assert r1["index"] == [] and r1["index_writes"] == [] and r1["retrieval_writes"] == []
    assert len(r0["index"]) == 2 and r0["retrieval_writes"]
    assert r0["recall"] == r1["recall"] == one["recall"]
    for sub in ("index", "retrieval_results/CLIP_SF/Tiny/TwoRanks/run_files"):
        two, ref = _tree(os.path.join(two_root, sub)), _tree(os.path.join(one_root, sub))
        assert two.keys() == ref.keys() and two == ref, sub


def test_sharded_topk_matches_jax_on_two_devices(setup):
    """Each rank sweeps its row shard (rows 0-99 / 100-198) and the ranks
    merge: the ids of the JAX `sharded_topk` over 2 CPU devices, rows
    duplicated across the shard boundary included (the lower index first)."""
    from uniir_tpu.core.mesh import make_mesh
    from uniir_tpu.ops.topk import shard_pool as jax_shard_pool
    from uniir_tpu.ops.topk import sharded_topk as jax_sharded_topk

    pool, queries = setup["inputs"]["pool"], setup["inputs"]["pool_queries"]
    mesh2 = make_mesh(n_data=2)
    want_s, want_i = jax_sharded_topk(queries, jax_shard_pool(pool, mesh2), POOL_K, mesh2, chunk_size=64, valid_n=POOL_N)
    r0, r1 = (r["topk"] for r in setup["ranks"])
    assert r0["shard_rows"] == 100 and torch.equal(r0["ids"], r1["ids"])
    assert r0["ids"].tolist() == np.asarray(want_i).tolist()
    assert r0["ids"][0, :2].tolist() == [50, 150] and r0["ids"][1, :2].tolist() == [30, 120]
    np.testing.assert_allclose(r0["scores"].numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)


def test_trainer_main_over_two_ranks_trains_checkpoints_and_resumes(setup):
    """One epoch (16 queries at 4 a rank: 2 steps) and a resumed second:
    both ranks end equal, rank 0 alone writes the checkpoint."""
    r0, r1 = (r["trainer"] for r in setup["ranks"])
    for epochs, steps in ((1, 2), (2, 4)):
        assert r0[epochs]["step"] == r1[epochs]["step"] == steps
        assert r0[epochs]["stats"] == r1[epochs]["stats"] and r0[epochs]["stats"]["epoch"] == epochs - 1
        for name, p in r0[epochs]["params"].items():
            assert torch.equal(p, r1[epochs]["params"][name]), name
        assert not [w for w in r1[epochs]["writes"] if "checkpoint" in w]
        assert any(w.endswith("checkpoint.pth.tmp") for w in r0[epochs]["writes"])
    ckpt = setup["dir"] / "trainer" / "checkpoint" / "test"
    assert sorted(os.listdir(ckpt)) == ["test_sf_epoch_0", "test_sf_epoch_1"]


def test_smoke_worker_ranks_agree_and_rank0_gathers(setup):
    r0, r1 = (r["smoke"] for r in setup["ranks"])
    assert r0["loss"] == r1["loss"] and r0["step"] == r1["step"] == 1
    assert r0["gathered"] == list(range(8)) and r1["gathered"] is None


def test_dryrun_multichip_two_ranks():
    from uniir_tpu_torch.entry import dryrun_multichip

    results = dryrun_multichip(2)
    assert [r["queue_ptr"] for r in results] == [2, 2]
    assert results[0]["topk_ids"] == results[1]["topk_ids"]


# -------------------------------------------------------- one process


def test_one_process_collectives_are_identities():
    x = torch.arange(6.0).reshape(3, 2)
    assert mesh.process_count() == 1 and mesh.process_index() == 0 and mesh.is_main_process()
    assert mesh.gather_rows(x) is x
    mesh.barrier("nothing")
    y = x.clone()
    mesh.all_reduce_mean_([y])
    mesh.broadcast_([y])
    assert torch.equal(x, y)


def test_initialisation_opts_in_on_the_variable(monkeypatch):
    monkeypatch.delenv("UNIIR_TPU_MULTIHOST", raising=False)
    assert mesh.maybe_initialize_distributed("cpu") is False and not mesh.is_initialized()


def test_a_rank_without_its_card_raises(monkeypatch):
    from uniir_tpu_torch.core.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=1"):
        resolve_device(None)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_launch_without_a_device_does_not_fall_back_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # the rank sees no card, here and on a card's machine
    with pytest.raises(RuntimeError, match="no CUDA device found"):
        launch(1, str(tmp_path), timeout=60)


def test_merge_breaks_ties_to_the_lower_id():
    from uniir_tpu_torch.ops.topk import merge_topk

    scores = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9]])
    ids = torch.tensor([[7, 40, 3, 1, 12]])
    vals, got = merge_topk(scores, ids, 3)
    assert got.tolist() == [[3, 12, 40]] and torch.equal(vals, torch.full((1, 3), 0.9))


# ------------------------------------------------------------- the card


@pytest.mark.gpu
def test_two_rank_clip_step_on_the_card(tmp_path):
    """Two ranks on cuda:0 over gloo (NCCL takes one rank a card) against one
    process on the card: the CLIP-SF steps' losses, gradients and parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from uniir_tpu_torch.models.registry import seeded_clip_sf_train

    inputs = {
        "clip_sf": seeded_clip_sf_train(CFG, "cpu", seed=0, dtype=torch.float32).state_dict(),
        "clip_batches_sf": [clip_batch(CFG, BS, 0, seed) for seed in (0, 1)],
    }
    torch.save(inputs, tmp_path / "inputs.pt")
    launch(W, str(tmp_path / "ranks"), device="cuda:0", task=TASK, backend="gloo",
           task_args={"dir": str(tmp_path), "cases": ["sf"]}, timeout=120)
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False)["sf"] for r in range(W))
    one = run_clip(inputs, "sf", device="cuda")
    assert r0["losses"] == r1["losses"]
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-5)
    for got, want in zip(r0["grads"], one["grads"]):
        for name in want:
            _close(got[name].cpu(), want[name].cpu(), f"grad {name}", rtol=1e-4)
    for name, want in one["params"].items():
        _params_close_to_one_process(r0["params"][name], want, name, LR)
