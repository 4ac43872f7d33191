"""Import guard: the port and chip_smoke.py stay free of JAX, flax, Pillow,
PyYAML and the JAX package (the GPU host has none of them)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "uniir_tpu_torch"
# every port module (the list is held to the files on disk below) and the
# script itself
SMOKE_MODULES = [
    "chip_smoke",
    "uniir_tpu_torch._build",
    "uniir_tpu_torch.core.checkpoint",
    "uniir_tpu_torch.core.config",
    "uniir_tpu_torch.core.device",
    "uniir_tpu_torch.core.mesh",
    "uniir_tpu_torch.data.collator",
    "uniir_tpu_torch.data.data_utils",
    "uniir_tpu_torch.data.dataset",
    "uniir_tpu_torch.data.loader",
    "uniir_tpu_torch.data.preprocess",
    "uniir_tpu_torch.data.registry",
    "uniir_tpu_torch.data.tokenizers.bert_wordpiece",
    "uniir_tpu_torch.data.tokenizers.clip_bpe",
    "uniir_tpu_torch.entry",
    "uniir_tpu_torch.models.blip_ff",
    "uniir_tpu_torch.models.blip_sf",
    "uniir_tpu_torch.models.blip_vit",
    "uniir_tpu_torch.models.clip",
    "uniir_tpu_torch.models.clip_ff",
    "uniir_tpu_torch.models.clip_sf",
    "uniir_tpu_torch.models.convert",
    "uniir_tpu_torch.models.layers",
    "uniir_tpu_torch.models.med",
    "uniir_tpu_torch.models.registry",
    "uniir_tpu_torch.models.t5_fusion",
    "uniir_tpu_torch.ops.attention",
    "uniir_tpu_torch.ops.calibrate",
    "uniir_tpu_torch.ops.image_ops",
    "uniir_tpu_torch.ops.mlp",
    "uniir_tpu_torch.ops.quant",
    "uniir_tpu_torch.ops.topk",
    "uniir_tpu_torch.parallel.multihost",
    "uniir_tpu_torch.retrieval.analyst",
    "uniir_tpu_torch.retrieval.embedder",
    "uniir_tpu_torch.retrieval.eval",
    "uniir_tpu_torch.retrieval.hard_negs",
    "uniir_tpu_torch.retrieval.index",
    "uniir_tpu_torch.retrieval.interactive",
    "uniir_tpu_torch.retrieval.search",
    "uniir_tpu_torch.train.engine",
    "uniir_tpu_torch.train.losses",
    "uniir_tpu_torch.train.optimizer",
    "uniir_tpu_torch.train.state",
    "uniir_tpu_torch.train.steps",
    "uniir_tpu_torch.train.trainer",
    "uniir_tpu_torch.tools.calibrate_int8",
    "uniir_tpu_torch.tools.config_updater",
    "uniir_tpu_torch.tools.pipeline",
    "uniir_tpu_torch.utils.logging",
    "uniir_tpu_torch.utils.profiling",
]
FORBIDDEN = ("jax", "jaxlib", "flax", "PIL", "yaml", "regex", "uniir_tpu")
# never imported by the port, at any depth / only inside functions
NEVER = ("jax", "jaxlib", "flax", "uniir_tpu")
NOT_AT_TOP = ("PIL", "yaml", "regex")
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


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


def test_smoke_module_list_covers_every_port_module():
    """A new port file joins the subprocess import check by being listed."""
    on_disk = {".".join(p.relative_to(REPO).with_suffix("").parts) for p in PORT.rglob("*.py") if p.name != "__init__.py"}
    assert on_disk <= set(SMOKE_MODULES), sorted(on_disk - set(SMOKE_MODULES))


def test_no_port_file_imports_jax():
    offenders = [
        str(path.relative_to(REPO))
        for path in PORT.rglob("*.py")
        if any(line.lstrip().startswith(("import jax", "from jax")) for line in path.read_text().splitlines())
    ]
    assert offenders == []


def _imported_roots(node: ast.AST):
    """Top-level package names an Import / ImportFrom node brings in."""
    if isinstance(node, ast.Import):
        return [alias.name.split(".")[0] for alias in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module.split(".")[0]]
    return []


def forbidden_imports(source: str):
    """(line, package) of every import of a NEVER package at any depth --
    inside functions, classes, try blocks -- and of a NOT_AT_TOP package
    outside a function."""
    tree = ast.parse(source)
    found = [(n.lineno, root) for n in ast.walk(tree) for root in _imported_roots(n) if root in NEVER]

    def outside_functions(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            found.extend((child.lineno, root) for root in _imported_roots(child) if root in NOT_AT_TOP)
            outside_functions(child)

    outside_functions(tree)
    return sorted(found)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_nothing_forbidden_at_any_depth(path):
    assert forbidden_imports(path.read_text()) == []


def test_import_walk_sees_inside_functions():
    lazy = "def f():\n    from uniir_tpu.data.dataset import Mode\n    import PIL\n"
    assert forbidden_imports(lazy) == [(2, "uniir_tpu")]
    top = "try:\n    import yaml\nexcept ImportError:\n    yaml = None\nclass A:\n    import regex\n"
    assert forbidden_imports(top) == [(2, "yaml"), (6, "regex")]
    assert forbidden_imports("import uniir_tpu_torch.ops\nfrom . import x\n") == []


def test_chip_smoke_refuses_to_run_without_the_repo(tmp_path):
    """Alone in a directory (or without a card) it exits non-zero and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_config_updater_imports_yaml_only_inside_its_functions():
    """The updater needs PyYAML, which the card's machine lacks: it imports it
    where a file is read or written, so the module itself imports there."""
    tree = ast.parse((PORT / "tools" / "config_updater.py").read_text())
    inside = {fn.name for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
              for node in ast.walk(fn) if "yaml" in _imported_roots(node)}
    assert inside == {"load_yaml", "save_yaml"}
    assert forbidden_imports((PORT / "tools" / "config_updater.py").read_text()) == []
