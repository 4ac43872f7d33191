"""Import guard: the port and chip_smoke.py stay free of JAX, flax, Pillow,
PyYAML and the JAX package (the GPU host has none of them)."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "uniir_tpu_torch"
# every port module chip_smoke.py reaches, and the script itself
SMOKE_MODULES = [
    "chip_smoke",
    "uniir_tpu_torch._build",
    "uniir_tpu_torch.core.config",
    "uniir_tpu_torch.data.registry",
    "uniir_tpu_torch.models.clip",
    "uniir_tpu_torch.models.clip_sf",
    "uniir_tpu_torch.models.convert",
    "uniir_tpu_torch.models.layers",
    "uniir_tpu_torch.models.registry",
    "uniir_tpu_torch.ops.attention",
    "uniir_tpu_torch.ops.topk",
    "uniir_tpu_torch.retrieval.embedder",
    "uniir_tpu_torch.retrieval.eval",
    "uniir_tpu_torch.retrieval.index",
    "uniir_tpu_torch.retrieval.search",
    "uniir_tpu_torch.train.steps",
    "uniir_tpu_torch.tools.pipeline",
]
FORBIDDEN = ("jax", "jaxlib", "flax", "PIL", "yaml", "uniir_tpu")


def test_smoke_modules_import_no_jax_pil_or_yaml():
    code = (
        "import importlib, json, sys\n"
        f"for m in {SMOKE_MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = set(__import__("json").loads(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


def test_no_port_file_imports_jax():
    offenders = [
        str(path.relative_to(REPO))
        for path in PORT.rglob("*.py")
        if any(line.lstrip().startswith(("import jax", "from jax")) for line in path.read_text().splitlines())
    ]
    assert offenders == []


def test_chip_smoke_refuses_to_run_without_the_repo(tmp_path):
    """Alone in a directory (or without a card) it exits non-zero and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
