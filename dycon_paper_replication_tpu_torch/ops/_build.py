"""Build the port's CUDA sources with nvcc into shared libraries that have a
plain C interface, and load them with ctypes.

Each source compiles on its own (no PyTorch headers, a few seconds) into
`ops/_build/<stem>-<hash>.so`, where the hash covers the source, the
headers beside it and the flags, so an unchanged source is never rebuilt. Builds of several sources
run in parallel, one nvcc each. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"
CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")
    return path


def library_path(src: Path) -> Path:
    """Where the library built from `src` goes: its name hashes the source,
    every header (`*.cuh`) beside it, which a source may include, and the
    flags, so an edit to a shared header rebuilds every source."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(*sources: Path) -> dict[Path, str]:
    """Compile every source whose library is missing, all nvcc processes
    started together. Returns {source: compiler log} for the sources built
    now (empty log text for those already built). Raises on a failed build."""
    pending = {}
    logs = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            logs[src] = ""
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending[src] = (proc, tmp, out)
    failed = []
    for src, (proc, tmp, out) in pending.items():
        log, _ = proc.communicate()
        logs[src] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(src: Path) -> ctypes.CDLL:
    """The library built from `src`, built first if needed."""
    build(src)
    return ctypes.CDLL(str(library_path(src)))


def function(src: Path, name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function `name` of the library built from `src`, returning a
    CUDA error code (int)."""
    fn = getattr(load(src), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
