"""Build and load the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds, not minutes). Libraries land in ``build/torch_kernels/`` at
the root of the checkout, named by a hash of their sources and flags, so a
changed source rebuilds and an unchanged one is reused. Nothing is built or
imported at module import time: the first wrapper call on a CUDA tensor
builds (or ``build_all`` builds every kernel in parallel, as
``chip_smoke.py`` does).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("paged_attention", "flash_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

_p = ctypes.c_void_p
_i = ctypes.c_int
_i64 = ctypes.c_int64
_f = ctypes.c_float
# argtypes per exported C function: pointers and the stream as c_void_p so
# 64-bit addresses are never truncated to a C int
SIGNATURES = {
    "paged_attention": {
        "paged_decode_attention": (
            [_i, _i] + [_p] * 10 + [_i] * 10 + [_f, _p], _i),
        "paged_decode_plan": ([_i] * 10 + [_p, _p], _i),
    },
    "flash_attention": {
        "flash_attention": (
            [_i, _i, _p, _i64, _i64, _i64, _p, _i64, _i64, _i64,
             _p, _i64, _i64, _i64, _p, _i, _i, _i, _i, _f, _p], _i),
        "flash_attention_chunk": (
            [_i, _i, _p, _i64, _i64, _i64, _p, _i64, _i64, _i64,
             _p, _i64, _i64, _i64, _p, _i, _i, _i, _i, _i, _i, _f, _p], _i),
        "flash_attention_chunk_kvq": (
            [_i, _i, _p, _i64, _i64, _i64, _p, _i64, _i64, _i64, _p, _i64, _i64,
             _p, _i64, _i64, _i64, _p, _i64, _i64,
             _p, _i, _i, _i, _i, _i, _i, _f, _p], _i),
        "flash_body": ([_i, _i], _i),
    },
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, verbose: bool) -> tuple[subprocess.Popen, Path, Path]:
    out = lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC)]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def build_all(names=SOURCES, verbose: bool = False) -> dict[str, dict]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    all started together. Returns {name: {"seconds", "log", "cached"}};
    raises with the compiler's output when a build fails."""
    t0 = time.perf_counter()
    started = {}
    report: dict[str, dict] = {}
    for n in names:
        if lib_path(n).exists() and not verbose:
            report[n] = {"seconds": 0.0, "log": "", "cached": True}
        else:
            started[n] = _start(n, verbose)
    errors = []
    for n, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        report[n] = {"seconds": time.perf_counter() - t0, "log": log, "cached": False}
    if errors:
        raise RuntimeError("\n".join(errors))
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
    return lib


def current_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def dtype_code(dtype) -> int:
    """The kernels' code of a storage dtype (csrc/common.cuh DTYPE_*)."""
    import torch

    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    if dtype == torch.int8:
        return 2
    raise TypeError(f"kernels take float32, bfloat16 or int8 tensors, got {dtype}")


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
