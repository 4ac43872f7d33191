"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into a shared
library with a plain C interface, under `build/uniir_tpu_torch/` at the repo
root, named by a hash of the sources and flags so an edited kernel is never
served from a stale build.  Nothing is built when a module is imported: the
first wrapper that launches a kernel calls `load(name)`.  Only the CUDA
toolkit is used (no PyTorch headers), which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "uniir_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of each library: name -> (argtypes); every one returns the
# CUDA error code of its launch.
SIGNATURES = {
    "attention": {
        "uniir_attention_fused_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
        "uniir_attention_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
        "uniir_attention_norm_first_fused_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
        "uniir_attention_norm_first_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
        "uniir_attention_splitk_fused_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
        "uniir_attention_splitk_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    },
    "attention_bwd": {
        "uniir_attention_fused_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
        "uniir_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P),
    },
    "int8_matmul": {
        "uniir_int8_matmul": (_P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "int8_mlp": {
        "uniir_int8_mlp": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P),
    },
    "preprocess": {
        "uniir_fused_preprocess": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F,
                                   _P),
        "uniir_fused_preprocess_dense": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P),
    },
    "topk": {
        "uniir_bucket_max_bf16": (_P, _P, _P, _I, _I, _I, _I, _P),
        "uniir_bucket_max_i8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "uniir_bucket_max_bf16_general": (_P, _P, _P, _I, _I, _I, _I, _P),
        "uniir_bucket_max_i8_general": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "uniir_bucket_max_i8b": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "uniir_bucket_max_i8b_general": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    },
}

# macros each library is compiled with, for limits the Python wrappers share with the C side:
# the widest D each retrieval sweep's wgmma kernel takes (its query tile beside a ring of 4 pool
# stages in shared memory; csrc/topk.cu holds it to that), read by ops/topk.py::sweep_route
DEFINES = {
    "topk": {"UNIIR_SWEEP_MAX_D_BF16": 768, "UNIIR_SWEEP_MAX_D_I8": 1152},
}

_loaded: dict = {}
# seconds spent compiling each library in this process (0.0 when it was
# already built); read by chip_smoke.py
build_seconds: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA toolkit (sm_90a)")
    return found


def _flags(name: str) -> list:
    return [*NVCC_FLAGS, *(f"-D{k}={v}" for k, v in DEFINES.get(name, {}).items())]


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash(name)}.so"


def _compile(name: str, target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = target.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (see {log}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, target)


def _ensure_built(name: str) -> float:
    """Compile `csrc/<name>.cu` unless its library exists; returns the seconds spent."""
    target = library_path(name)
    t0 = time.perf_counter()
    if not target.exists():
        _compile(name, target)
    return time.perf_counter() - t0


def build_all(names) -> None:
    """Compile the named libraries concurrently, one nvcc each, so a cold
    start costs the slowest build rather than the sum."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for name, seconds in zip(names, pool.map(_ensure_built, names)):
            build_seconds[name] = seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library `csrc/<name>.cu`, compiled first if needed."""
    if name in _loaded:
        return _loaded[name]
    if name not in build_seconds:
        build_seconds[name] = _ensure_built(name)
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.uniir_cuda_error_string.argtypes = [ctypes.c_int]
    lib.uniir_cuda_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.uniir_cuda_error_string(err).decode()})")


def ptxas_report(name: str) -> str:
    """Each kernel of a library (its mangled name, which spells out the
    template arguments) with the register and spill lines nvcc printed."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    out = []
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            out.append(line.split("'")[1])
        elif "spill" in line or ("ptxas info" in line and "Used" in line):
            out.append("    " + line.replace("ptxas info    : ", "").strip())
    return "\n".join(out)
