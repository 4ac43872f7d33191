"""Repeat runs of K1 / K3 and of the BLIP-FF remat bit-equality case on the
card, to tell a race in a kernel from other nondeterminism.

    python scripts/chip_determinism.py            # everything, on cuda:0
    python scripts/chip_determinism.py --child N  # N runs of the remat case in this process (JSON line)

What it runs:
  1. `tests/test_torch_blip_train.py::_assert_remat_is_bit_equal` at the
     GPU case's model (bf16, 2 heads of 64, L = 17) 100 times in one
     process, recording each run's loss and a digest of its gradients with
     remat off and on, and the cases that fail;
  2. the same, 5 runs in each of 20 fresh processes (four at a time);
  3. 50 runs with the ViT's attention swapped to `attention_twin` (no K1 /
     K3), and 50 under CUBLAS_WORKSPACE_CONFIG=:4096:8, each in its own
     process;
  4. K1 and K3 alone, 200 calls each at [2, 17, 128] H2, [64, 197, 1024]
     H16 and [80, 197, 1024] H16, every output held bit-equal to the first;
  5. `compute-sanitizer --tool racecheck` and `--tool synccheck` on one K1
     and one K3 call at the first two shapes, where the tool runs.

Prints one JSON line a part and a summary; exits non-zero if K1 or K3 gave
two different outputs for the same inputs.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _test_module():
    """tests/test_torch_blip_train.py loaded from its path (another `tests`
    package may shadow the repo's on the card's machine)."""
    spec = importlib.util.spec_from_file_location("blip_train_cases", REPO / "tests" / "test_torch_blip_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(grads: dict) -> str:
    h = hashlib.sha256()
    for key in sorted(grads):
        h.update(grads[key].float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def remat_runs(n: int, twin: bool = False) -> dict:
    """n runs of the GPU remat case: losses and gradient digests with remat
    off / on, and how many runs the test's own assertion failed."""
    from uniir_tpu_torch.models import layers
    from uniir_tpu_torch.ops import attention as attn_mod

    t = _test_module()
    cuda = torch.device("cuda")
    vit = dataclasses.replace(t.DP_VIT, width=128)
    model = dict(vit=vit, med=dataclasses.replace(t.MED, encoder_width=vit.width), dtype=torch.bfloat16, device=cuda)
    if twin:
        layers.attention = attn_mod.attention_twin
    rows, failures = [], []
    for i in range(n):
        batch = t._batch(seed=8)
        row = {}
        for remat in (False, True):
            state = t._dropout_state("ff", remat=remat, **model)
            loss, grads = t._loss_and_grads(state, batch, seed=3)
            row["remat" if remat else "plain"] = (loss.float().item(), _digest(grads))
        rows.append(row)
        try:
            t._assert_remat_is_bit_equal(**model)
        except AssertionError as e:
            failures.append((i, str(e)[:200]))
    plain = {r["plain"] for r in rows}
    remat = {r["remat"] for r in rows}
    return {"runs": n, "twin": twin, "cublas_workspace": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
            "distinct_plain": sorted(map(list, plain)), "distinct_remat": sorted(map(list, remat)),
            "runs_remat_differs": sum(r["plain"] != r["remat"] for r in rows),
            "assert_failures": len(failures), "first_failures": failures[:3],
            "k1_launches": attn_mod.attention.launches, "k3_launches": attn_mod.attention_bwd.launches}


def _child(args, env_extra=None) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO), **(env_extra or {}))
    proc = subprocess.run([sys.executable, __file__, *args], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        return {"error": proc.stderr[-2000:]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def kernel_repeats(n: int = 200) -> list:
    from uniir_tpu_torch.ops import attention as A

    out = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, L, H in ((2, 17, 2), (64, 197, 16), (80, 197, 16)):
        q, k, v, do = (torch.randn(B, L, H * 64, generator=g, device="cuda").bfloat16() for _ in range(4))
        first_f = A.attention(q, k, v, H)
        first_b = A.attention_bwd(q, k, v, do, H)
        diff_f = diff_b = 0
        for _ in range(n):
            diff_f += not torch.equal(A.attention(q, k, v, H), first_f)
            diff_b += not all(torch.equal(a, b) for a, b in zip(A.attention_bwd(q, k, v, do, H), first_b))
        torch.cuda.synchronize()
        out.append({"shape": [B, L, H * 64], "heads": H, "calls": n, "k1_differs": diff_f, "k3_differs": diff_b,
                    "routes": [A.forward_route(64, L), A.backward_route(64, L)]})
    return out


SANITIZE = """
import torch
from uniir_tpu_torch.ops import attention as A
g = torch.Generator(device="cuda").manual_seed(0)
for B, L, H in ((2, 17, 2), (64, 197, 16)):
    q, k, v, do = (torch.randn(B, L, H * 64, generator=g, device="cuda").bfloat16() for _ in range(4))
    A.attention(q, k, v, H); A.attention_bwd(q, k, v, do, H)
torch.cuda.synchronize()
print("sanitized run done")
"""


def sanitizer() -> list:
    tool = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(tool):
        return [{"tool": "compute-sanitizer", "result": "not installed"}]
    out = []
    for check in ("racecheck", "synccheck"):
        t0 = time.time()
        try:
            proc = subprocess.run([tool, "--tool", check, sys.executable, "-c", SANITIZE], cwd=REPO,
                                  env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, text=True,
                                  timeout=300)
            text = (proc.stdout + proc.stderr).strip().splitlines()
            out.append({"tool": check, "rc": proc.returncode, "seconds": round(time.time() - t0, 1),
                        "tail": text[-6:]})
        except subprocess.TimeoutExpired:
            out.append({"tool": check, "result": "timed out after 300 s"})
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--child", type=int, default=0)
    parser.add_argument("--twin", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(remat_runs(args.child, twin=args.twin)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("device", torch.cuda.get_device_name(0), "|", smi, flush=True)
    from uniir_tpu_torch import _build

    _build.build_all(["attention", "attention_bwd"])
    t0 = time.time()
    one = remat_runs(100)
    print("in_process", json.dumps(one), f"({time.time() - t0:.0f} s)", flush=True)
    t0 = time.time()
    with ThreadPoolExecutor(4) as pool:
        fresh = list(pool.map(lambda _: _child(["--child", "5"]), range(20)))
    failed = sum(f.get("assert_failures", 0) for f in fresh)
    errors = [f["error"] for f in fresh if "error" in f]
    values = {tuple(v) for f in fresh for v in f.get("distinct_plain", []) + f.get("distinct_remat", [])}
    print("fresh_processes", json.dumps({"processes": 20, "runs": 100, "assert_failures": failed,
                                         "distinct_losses_and_digests": sorted(map(list, values)),
                                         "errors": errors[:2]}), f"({time.time() - t0:.0f} s)", flush=True)
    print("twin_attention", json.dumps(_child(["--child", "50", "--twin"])), flush=True)
    print("cublas_workspace", json.dumps(_child(["--child", "50"], {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})),
          flush=True)
    reps = kernel_repeats()
    print("kernel_repeats", json.dumps(reps), flush=True)
    print("sanitizer", json.dumps(sanitizer()), flush=True)
    bad = sum(r["k1_differs"] + r["k3_differs"] for r in reps)
    print(json.dumps({"ok": bad == 0, "remat_failures_in_process": one["assert_failures"],
                      "remat_failures_fresh": failed}))
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
