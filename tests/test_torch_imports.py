"""Import guard: the port and chip_smoke.py stay free of JAX, flax, orbax,
Pillow, PyYAML, `regex` and the JAX package (the GPU host has none of them),
at any depth: not even inside a function.  `scripts/` is not walked: its
JAX -> port bridge imports both packages by design."""

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
    "uniir_tpu_torch.core.yaml_subset",
    "uniir_tpu_torch.data.bmp",
    "uniir_tpu_torch.data.collator",
    "uniir_tpu_torch.data.data_utils",
    "uniir_tpu_torch.data.dataset",
    "uniir_tpu_torch.data.gif",
    "uniir_tpu_torch.data.ico",
    "uniir_tpu_torch.data.j2k_dwt",
    "uniir_tpu_torch.data.j2k_t1",
    "uniir_tpu_torch.data.j2k_t2",
    "uniir_tpu_torch.data.jpeg",
    "uniir_tpu_torch.data.jpeg2000",
    "uniir_tpu_torch.data.jpeg_encode",
    "uniir_tpu_torch.data.loader",
    "uniir_tpu_torch.data.netpbm",
    "uniir_tpu_torch.data.png",
    "uniir_tpu_torch.data.preprocess",
    "uniir_tpu_torch.data.preprocessing.base",
    "uniir_tpu_torch.data.preprocessing.cirr",
    "uniir_tpu_torch.data.preprocessing.edis",
    "uniir_tpu_torch.data.preprocessing.fashion200k",
    "uniir_tpu_torch.data.preprocessing.fashioniq",
    "uniir_tpu_torch.data.preprocessing.generator",
    "uniir_tpu_torch.data.preprocessing.infoseek",
    "uniir_tpu_torch.data.preprocessing.io_utils",
    "uniir_tpu_torch.data.preprocessing.mscoco",
    "uniir_tpu_torch.data.preprocessing.nights",
    "uniir_tpu_torch.data.preprocessing.oven",
    "uniir_tpu_torch.data.preprocessing.visualnews",
    "uniir_tpu_torch.data.preprocessing.webqa",
    "uniir_tpu_torch.data.registry",
    "uniir_tpu_torch.data.tokenizers.bert_wordpiece",
    "uniir_tpu_torch.data.tokenizers.clip_bpe",
    "uniir_tpu_torch.data.vp8",
    "uniir_tpu_torch.data.vp8l",
    "uniir_tpu_torch.data.webp",
    "uniir_tpu_torch.data.tiff",
    "uniir_tpu_torch.data.zstd",
    "uniir_tpu_torch.data.lab",
    "uniir_tpu_torch.data.raster",
    "uniir_tpu_torch.data.qoi",
    "uniir_tpu_torch.data.tga",
    "uniir_tpu_torch.data.sgi",
    "uniir_tpu_torch.data.pcx",
    "uniir_tpu_torch.data.sun",
    "uniir_tpu_torch.data.msp",
    "uniir_tpu_torch.data.xbm",
    "uniir_tpu_torch.data.xpm",
    "uniir_tpu_torch.data.im",
    "uniir_tpu_torch.data.psd",
    "uniir_tpu_torch.data.dds",
    "uniir_tpu_torch.data.icns",
    "uniir_tpu_torch.data.mcidas",
    "uniir_tpu_torch.data.pixar",
    "uniir_tpu_torch.data.spider",
    "uniir_tpu_torch.data.xvthumb",
    "uniir_tpu_torch.data.gbr",
    "uniir_tpu_torch.data.imt",
    "uniir_tpu_torch.data.ftex",
    "uniir_tpu_torch.data.blp",
    "uniir_tpu_torch.data.fits",
    "uniir_tpu_torch.data.fli",
    "uniir_tpu_torch.data.iptc",
    "uniir_tpu_torch.data.pcd",
    "uniir_tpu_torch.data.av1_tables",
    "uniir_tpu_torch.data.av1_obu",
    "uniir_tpu_torch.data.av1_entropy",
    "uniir_tpu_torch.data.av1_block",
    "uniir_tpu_torch.data.av1_recon",
    "uniir_tpu_torch.data.av1_filters",
    "uniir_tpu_torch.data.avif",
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
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "PIL", "yaml", "regex", "uniir_tpu", "zstandard")
# never imported by the port, at any depth; Pillow only inside the functions named for its file (none)
NEVER = ("jax", "jaxlib", "flax", "orbax", "uniir_tpu", "yaml", "regex", "zstandard")
PIL_FUNCTIONS: dict = {}
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


def forbidden_imports(source: str, pil_functions=()):
    """(line, package) of every import of a NEVER package at any depth --
    inside functions, classes, try blocks -- and of Pillow anywhere but
    inside a function named in `pil_functions`."""
    found = []

    def walk(node, function):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else function
            for root in _imported_roots(child):
                if root in NEVER or (root == "PIL" and inner not in pil_functions):
                    found.append((child.lineno, root))
            walk(child, inner)

    walk(ast.parse(source), None)
    return sorted(found)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_nothing_forbidden_at_any_depth(path):
    rel = str(path.relative_to(REPO))
    assert forbidden_imports(path.read_text(), PIL_FUNCTIONS.get(rel, ())) == []


def test_import_walk_sees_inside_functions():
    lazy = "def f():\n    from uniir_tpu.data.dataset import Mode\n    import PIL\n    import yaml\n"
    assert forbidden_imports(lazy) == [(2, "uniir_tpu"), (3, "PIL"), (4, "yaml")]
    assert forbidden_imports(lazy, pil_functions=("f",)) == [(2, "uniir_tpu"), (4, "yaml")]
    top = "try:\n    import yaml\nexcept ImportError:\n    yaml = None\nclass A:\n    import regex\n"
    assert forbidden_imports(top) == [(2, "yaml"), (6, "regex")]
    assert forbidden_imports("def g():\n    import orbax.checkpoint as ocp\n") == [(2, "orbax")]
    nested = "def _pil():\n    def g():\n        from PIL import Image\n    from PIL import ImageOps\n"
    assert forbidden_imports(nested, pil_functions=("_pil",)) == [(3, "PIL")]
    assert forbidden_imports("import uniir_tpu_torch.ops\nfrom . import x\n") == []


_LOADERS = {"CDLL", "PyDLL", "LoadLibrary", "find_library", "dlopen"}


def loaded_zstd_libraries(source: str) -> list:
    """(line, text) of every library-loading call (ctypes.CDLL, find_library, ...) that names a zstd library in a
    string anywhere among its arguments."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call):
            name = node.func.attr if isinstance(node.func, ast.Attribute) else getattr(node.func, "id", "")
            if name in _LOADERS:
                for inner in ast.walk(node):
                    if isinstance(inner, ast.Constant) and isinstance(inner.value, str) and "zstd" in inner.value:
                        found.append((node.lineno, inner.value))
    return found


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_loads_no_libzstd(path):
    """The port decodes ZSTD with its own decoder (data/zstd.py, csrc/zstd.cuh): no port file, and not
    chip_smoke.py, loads a libzstd (Pillow's bundled one included) through ctypes."""
    assert loaded_zstd_libraries(path.read_text()) == []


def test_zstd_library_check_sees_loads():
    src = ("import ctypes, ctypes.util\nlib = ctypes.CDLL(ctypes.util.find_library('zstd'))\n"
           "def f():\n    return ctypes.cdll.LoadLibrary(glob.glob(d + '/libzstd-*.so*')[0])\n")
    assert [line for line, _ in loaded_zstd_libraries(src)] == [2, 2, 4]
    assert forbidden_imports("def f():\n    import zstandard\n") == [(2, "zstandard")]


def test_pillow_only_for_the_train_only_transforms():
    """No port file imports Pillow any more, the train transforms included
    (they run on numpy): no `import PIL` at any depth in any
    port file or in chip_smoke.py, and no `_pil` helper left to call."""
    offenders = {str(path.relative_to(REPO)): found for path in PORT_FILES
                 if (found := [f for f in forbidden_imports(path.read_text()) if f[1] == "PIL"])}
    assert offenders == {}
    preprocess = ast.parse((PORT / "data" / "preprocess.py").read_text())
    assert not [n for n in ast.walk(preprocess) if isinstance(n, ast.FunctionDef) and n.name == "_pil"]


def test_chip_smoke_refuses_to_run_without_the_repo(tmp_path):
    """Alone in a directory (or without a card) it exits non-zero and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_config_updater_imports_yaml_only_inside_its_functions():
    """The updater reads and writes through `core.yaml_subset`: PyYAML, which
    the card's machine lacks, is imported nowhere in it, not even inside
    `load_yaml` / `save_yaml`."""
    source = (PORT / "tools" / "config_updater.py").read_text()
    tree = ast.parse(source)
    assert not [node for node in ast.walk(tree) if "yaml" in _imported_roots(node)]
    calls = {fn.name: {ast.unparse(node.func) for node in ast.walk(fn) if isinstance(node, ast.Call)}
             for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef) and fn.name in ("load_yaml", "save_yaml")}
    assert calls == {"load_yaml": {"yaml_subset.load"}, "save_yaml": {"yaml_subset.dump"}}
    assert forbidden_imports(source) == []
