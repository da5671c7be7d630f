"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

At first use every ``.cu`` source is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a``, then linked into one
``libkernels-<hash>.so`` with a plain C interface and loaded with
``ctypes``. The hash covers the sources and the flags, so an edited source
rebuilds and an unchanged one loads from ``build/kernels`` at the repo
root.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

F32, BF16 = 0, 1  # dtype codes of csrc/common.cuh

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of load(): the build, or only the load


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    """Compile every source in parallel, link one library at ``out``, and
    keep nvcc's and ptxas's report (registers, spills) beside it as .log."""
    nvcc = _nvcc()
    cu, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent, prefix=".build-") as tmp:
        procs = []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *CFLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        so_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(so_tmp),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so_tmp, out)
    out.with_suffix(".log").write_text("\n".join(log))


def _declare(lib: ctypes.CDLL) -> None:
    p, i64, f32, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int
    lib.trims_rmsnorm.argtypes = [p, p, p, i64, i64, i64, i64, f32, i32, i32, p]
    lib.trims_rmsnorm.restype = i32
    lib.trims_flash_attention.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, i64,
                                          p, f32, i32, i32, p]
    lib.trims_flash_attention.restype = i32
    lib.trims_decode_attention.argtypes = [p, p, p, p, p, i64, i64, i64, i64, i64,
                                           p, f32, i32, p]
    lib.trims_decode_attention.restype = i32
    lib.trims_decode_smem_bytes.argtypes = [i64, i64]
    lib.trims_decode_smem_bytes.restype = i64


def load() -> ctypes.CDLL:
    """The kernel library, built on first call in this process if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        path = build_dir() / f"libkernels-{_digest()}.so"
        if not path.exists():
            _build(path)
        build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _lib = lib
        return lib


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return F32
    if dtype == torch.bfloat16:
        return BF16
    raise TypeError(f"the port's kernels take float32 or bfloat16, not {dtype}")


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
