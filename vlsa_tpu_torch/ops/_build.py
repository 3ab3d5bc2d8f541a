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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
BUILD_LOGS: dict = {}  # name -> nvcc's output (registers, shared memory, spills)
BUILD_SECONDS: dict = {}  # name -> seconds of its nvcc process, where this process built it


def ptxas_report(build_log: str) -> list:
    """Each kernel's `-Xptxas -v` lines from a build log: [{"function":
    mangled name, "registers", "stack" (bytes of local memory a thread: arrays
    the registers do not hold, spills included), "spill_stores",
    "spill_loads", "smem" (static bytes)}], in the order ptxas compiled
    them."""
    import re
    report, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1), "registers": None, "stack": None,
                   "spill_stores": None, "spill_loads": None, "smem": 0}
            report.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(smem.group(1)) if smem else 0
    return report


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


def library_path(name: str, extra_flags: tuple = ()) -> Path:
    """The library's path; its hash covers the source, the shared headers
    of csrc/ and the flags."""
    digest = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_one(name: str, extra_flags: tuple = ()) -> None:
    """Compile `csrc/<name>.cu` unless its library is built already (whose
    nvcc output then comes from the log kept beside it)."""
    out = library_path(name, extra_flags)
    log_key = " ".join((name,) + tuple(extra_flags))
    if out.exists():
        log = out.with_suffix(".log")
        if log.exists():
            BUILD_LOGS[log_key] = log.read_text()
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private file, then rename: a concurrent build never sees
    # a half-written library
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}-{threading.get_ident()}.so")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
                           str(CSRC_DIR / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    BUILD_SECONDS[log_key] = time.perf_counter() - t0
    BUILD_LOGS[log_key] = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)


def build(*names: str) -> None:
    """Compile several sources, one nvcc process each, all started together."""
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        list(pool.map(build_one, names))


def load(name: str, extra_flags: tuple = ()) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built at first use (with
    `extra_flags`, e.g. a -D of an instrumented build, a library of its own)."""
    key = (name, tuple(extra_flags))
    lib = _LIBS.get(key)
    if lib is None:
        build_one(name, extra_flags)
        lib = ctypes.CDLL(str(library_path(name, extra_flags)))
        _LIBS[key] = lib
    return lib
