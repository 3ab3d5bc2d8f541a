"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into `build/lib<name>-<hash>.so`, where the hash covers the
source, the shared `csrc/*.cuh` headers and the flags, so an edited source is
never served a stale library.
Nothing here runs at import time: the CPU tests import every module of the
port on machines with no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
BUILD_LOGS: dict = {}  # name -> nvcc's output (registers, shared memory, spills)


def nvcc_path() -> str:
    """The CUDA compiler: `$CUDA_HOME/bin/nvcc`, else the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source, the shared headers
    of csrc/ and the flags."""
    digest = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_one(name: str) -> None:
    """Compile `csrc/<name>.cu` unless its library is built already."""
    out = library_path(name)
    if out.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private file, then rename: a concurrent build never sees
    # a half-written library
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}-{threading.get_ident()}.so")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC_DIR / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    BUILD_LOGS[name] = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)


def build(*names: str) -> None:
    """Compile several sources, one nvcc process each, all started together."""
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        list(pool.map(build_one, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_one(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
