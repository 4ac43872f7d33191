"""Processes on one host: the worker and its launcher (counterpart of
uniir_tpu/parallel/multihost.py).

The reference trains and embeds with `torchrun --nproc_per_node`; the
port's entry points do the same (`UNIIR_TPU_MULTIHOST=1`, `core.mesh`).
This module starts such a group itself, in a form that runs on the CPU as
well as on cards: `launch` spawns one

    python -m uniir_tpu_torch.parallel.multihost --procs N --pid R \\
        --init <rendezvous file> --out <rank R's JSON> --device cpu

process per rank, each joins the group through the `file://` rendezvous
(no port to pick), runs a task and writes what it returns as JSON.  The
default task (`smoke_worker`) runs one CLIP-SF `test-tiny` train step on
its host-major slice of a global batch of 8 queries, then the embedder's
part-file gather (every rank writes its rows, rank 0 joins them); `--task
module:function` (or `path/to/file.py:function`) runs another function of
(args) instead -- the tests' and chip_smoke.py's rank workers -- with
`--task-args` a JSON object it reads.  `--backend` names the backend
(gloo for ranks that share one card; the default is NCCL on a card, gloo
on the CPU).  `--device` None means `cuda:LOCAL_RANK`, which raises where
that card does not exist: ranks are never packed onto one card unless a
device is named.

Every wait has a limit: the launcher kills all ranks when one fails or
when `timeout` seconds pass, and the group's own collectives time out.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parents[2]
GLOBAL_QUERIES = 8  # the smoke's global batch (queries); must divide by the number of ranks


def smoke_worker(args) -> dict:
    """One CLIP-SF `test-tiny` train step on this rank's slice of the global
    batch, then the part-file gather of the embeddings of its queries."""
    import numpy as np
    import torch

    from uniir_tpu_torch.core import mesh
    from uniir_tpu_torch.models.clip import CLIP_CONFIGS
    from uniir_tpu_torch.models.registry import seeded_clip_sf_train
    from uniir_tpu_torch.retrieval.embedder import save_embeddings
    from uniir_tpu_torch.train.optimizer import make_clip_optimizer
    from uniir_tpu_torch.train.state import TrainState
    from uniir_tpu_torch.train.steps import make_clip_train_step, make_embed_step

    n_procs, pid, device = mesh.process_count(), mesh.process_index(), torch.device(args.device)
    cfg = CLIP_CONFIGS["test-tiny"]
    model = seeded_clip_sf_train(cfg, device, seed=0, dtype=torch.float32)
    mesh.broadcast_module_(model)

    # the same global data on every rank; each takes its host-major block [q_r | p_r]
    rng = np.random.default_rng(0)
    gq = GLOBAL_QUERIES
    txt = rng.integers(1, cfg.vocab_size - 1, size=(2 * gq, cfg.context_length)).astype(np.int32)
    img = rng.normal(size=(2 * gq, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    mask = np.ones((2 * gq,), np.int32)
    lq = gq // n_procs
    rows = list(range(pid * lq, (pid + 1) * lq)) + list(range(gq + pid * lq, gq + (pid + 1) * lq))
    local = {"txt_batched": txt[rows], "image_batched": img[rows], "txt_mask_batched": mask[rows],
             "image_mask_batched": mask[rows]}

    state = TrainState(model, *make_clip_optimizer(model, 1e-3, 10))
    state, metrics = make_clip_train_step(model)(state, local)

    # the embedder's part files: every rank writes its queries' rows, rank 0 joins them in rank order
    queries = {key: value[:lq] for key, value in local.items()}
    emb = make_embed_step(model, out_dtype=torch.float32)(queries).cpu().numpy()
    gather_dir = os.path.join(os.path.dirname(os.path.abspath(args.out)), "gather")
    os.makedirs(gather_dir, exist_ok=True)
    paths = [os.path.join(gather_dir, name) for name in ("smoke_embed.npy", "smoke_ids.npy")]
    save_embeddings(*paths, emb, np.arange(pid * lq, (pid + 1) * lq, dtype=np.int64), "smoke")
    gathered = np.load(paths[1]).tolist() if pid == 0 else None
    return {
        "pid": pid, "n_procs": n_procs, "loss": metrics["loss"].item(),
        "accuracy": metrics["inbatch_accuracy"].item(), "step": state.step, "gathered": gathered,
    }


def _task(name: Optional[str]):
    """The task's function: `module:function`, or `path/to/file.py:function`."""
    if not name:
        return smoke_worker
    module, function = name.rsplit(":", 1)
    if module.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(module).stem, module)
        loaded = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(loaded)
        return getattr(loaded, function)
    return getattr(importlib.import_module(module), function)


def run_rank(args) -> dict:
    """Join the group as rank `args.pid` of `args.procs`, run the task, write
    its result to `args.out`, leave the group."""
    from uniir_tpu_torch.core import mesh
    from uniir_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    args.device = str(device)
    os.environ["UNIIR_TPU_MULTIHOST"] = "1"  # this worker is a rank by construction
    mesh.maybe_initialize_distributed(
        device, init_method=Path(os.path.abspath(args.init)).as_uri(), rank=args.pid, world_size=args.procs,
        backend=args.backend, timeout_s=args.collective_timeout,
    )
    try:
        result = _task(args.task)(args)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.replace(tmp, args.out)
    finally:
        mesh.destroy()
    return result


def launch(
    n_procs: int,
    out_dir: str,
    device: Optional[str] = None,
    task: Optional[str] = None,
    task_args: Optional[dict] = None,
    backend: Optional[str] = None,
    timeout: float = 120.0,
) -> list:
    """Run `n_procs` ranks of `task` (the smoke worker when None); returns
    their results, by rank.  `device` is every rank's; None lets each rank
    take `cuda:LOCAL_RANK`, which raises where that card is missing (the
    CPU runs only when named, `device="cpu"`).  Raises, with the
    end of the failed rank's log, when a rank exits non-zero or the ranks
    outlast `timeout` seconds; every rank is stopped before it returns."""
    os.makedirs(out_dir, exist_ok=True)
    init = os.path.join(out_dir, f"rendezvous_{os.getpid()}_{time.monotonic_ns()}")
    env = dict(os.environ, UNIIR_TPU_MULTIHOST="1", WORLD_SIZE=str(n_procs),
               PYTHONPATH=os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    procs, outs, logs = [], [], []
    try:
        for pid in range(n_procs):
            outs.append(os.path.join(out_dir, f"rank{pid}.json"))
            logs.append(os.path.join(out_dir, f"rank{pid}.log"))
            cmd = [sys.executable, "-m", "uniir_tpu_torch.parallel.multihost", "--procs", str(n_procs),
                   "--pid", str(pid), "--init", init, "--out", outs[pid],
                   "--collective-timeout", str(timeout)]
            cmd += ["--device", device] if device else []
            cmd += ["--task", task] if task else []
            cmd += ["--task-args", json.dumps(task_args)] if task_args else []
            cmd += ["--backend", backend] if backend else []
            with open(logs[pid], "w") as log:
                procs.append(subprocess.Popen(cmd, cwd=REPO, env=dict(env, RANK=str(pid), LOCAL_RANK=str(pid)),
                                              stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [pid for pid, p in enumerate(procs) if p.returncode not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0]} failed (rc={procs[failed[0]].returncode}):\n{_tail(logs[failed[0]])}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"ranks outlasted {timeout} s:\n" + "\n".join(_tail(path) for path in logs))
            time.sleep(0.05)
        for pid, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {pid} failed (rc={p.returncode}):\n{_tail(logs[pid])}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if os.path.exists(init):
            os.remove(init)
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results


def _tail(path: str, n: int = 6000) -> str:
    with open(path, errors="replace") as f:
        return f"--- {path}\n" + f.read()[-n:]


def main(argv=None) -> dict:
    from uniir_tpu_torch.core import mesh

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--procs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--init", required=True, help="the rendezvous file, the same for every rank")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="this rank's device (default cuda:LOCAL_RANK)")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: nccl on a card, gloo on the CPU)")
    ap.add_argument("--task", default=None,
                    help="module:function or file.py:function of (args) -> dict (default: the smoke worker)")
    ap.add_argument("--task-args", type=json.loads, default={}, help="a JSON object for the task")
    ap.add_argument("--collective-timeout", type=float, default=mesh.COLLECTIVE_TIMEOUT_S,
                    help="seconds a collective may wait")
    return run_rank(ap.parse_args(argv))


if __name__ == "__main__":
    main()
