"""ctypes bridge to the native batch assembler native/bagloader.cpp
(counterpart of vlsa_tpu/data/native_loader.py).

The C++ source is the repository's own, at its root; this module compiles it
with g++ at first use into the port's git-ignored `ops/build/` (keyed by a
hash of the source and the flags, written under a private name and renamed,
so concurrent builds never see a half-written library) and loads it.  Its
threads read `.npy` (f32, f16) and `.q8npz` slide files and write each bag
straight into the caller's tensors through `data_ptr()`: the batch's own
storage, with no copy after.  When no library can be built, `native_available()`
is False and the batcher builds its batches with numpy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from ..ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "bagloader.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
N_THREADS = 8

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libbagloader-{digest.hexdigest()[:12]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}-{threading.get_ident()}.so")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_long_p = ctypes.POINTER(ctypes.c_long)
    paths = ctypes.POINTER(ctypes.c_char_p)
    lib.bl_read_npy_info.argtypes = [ctypes.c_char_p, c_long_p, c_long_p]
    lib.bl_read_npy_info.restype = ctypes.c_int
    lib.bl_read_q8_info.argtypes = [ctypes.c_char_p, c_long_p, c_long_p]
    lib.bl_read_q8_info.restype = ctypes.c_int
    lib.bl_assemble_batch.argtypes = [paths, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int]
    lib.bl_assemble_batch.restype = ctypes.c_int
    lib.bl_assemble_q8_batch.argtypes = [paths, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.bl_assemble_q8_batch.restype = ctypes.c_int
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; None (after one message) when
    it cannot be built."""
    global _lib, _failed
    with _lock:
        if _lib is None and not _failed:
            try:
                _lib = _declare(ctypes.CDLL(str(_build())))
            except (RuntimeError, OSError) as exc:
                _failed = True
                print(f"[native_loader] no native loader, batches are built with numpy ({exc})")
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _read_info(fn, path: str):
    rows, cols = ctypes.c_long(), ctypes.c_long()
    rc = fn(path.encode(), ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise OSError(f"cannot parse the header of {path} (code {rc})")
    return int(rows.value), int(cols.value)


def read_npy_info(path: str):
    """(rows, cols) of a 2-D `.npy` f32 or f16 store."""
    return _read_info(get_lib().bl_read_npy_info, path)


def read_q8_info(path: str):
    """(rows, cols) of a `.q8npz` store's `q` member."""
    return _read_info(get_lib().bl_read_q8_info, path)


def _check(t: torch.Tensor, dtype: torch.dtype, shape: Sequence[int], name: str) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
            or t.device.type != "cpu":
        raise ValueError(f"{name}: a contiguous CPU {dtype} tensor of shape {tuple(shape)} "
                         f"is needed, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _assemble(lib_fn, groups: List[List[str]], target_n: int, dim: int,
              *buffers) -> torch.Tensor:
    lens = torch.empty(len(groups), dtype=torch.int64)
    # the joined path strings live in `joined` until the call returns
    joined = [";".join(g).encode() for g in groups]
    arr = (ctypes.c_char_p * len(groups))(*joined)
    rc = lib_fn(arr, len(groups), target_n, dim, *(b.data_ptr() for b in buffers),
                lens.data_ptr(), N_THREADS)
    if rc != 0:
        raise OSError(f"native batch assembly failed with code {rc}")
    return lens


def assemble_batch(groups: List[List[str]], feats: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Bag j = the `.npy` files of groups[j] in order (f16 widened to f32),
    written into feats[j] [target_n, D] f32 and mask[j] [target_n] bool,
    zero past its last row and cut at target_n.  Returns the rows each bag
    holds (int64 [len(groups)])."""
    _n_bags, target_n, dim = feats.shape
    _check(feats, torch.float32, (len(groups), target_n, dim), "feats")
    _check(mask, torch.bool, (len(groups), target_n), "mask")
    return _assemble(get_lib().bl_assemble_batch, groups, target_n, dim, feats, mask)


def assemble_q8_batch(groups: List[List[str]], q: torch.Tensor, scale: torch.Tensor,
                      inv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """`assemble_batch` for `.q8npz` stores: q [n_bags, target_n, D] int8,
    scale and inv [n_bags, target_n] f32 as stored, and mask."""
    _n_bags, target_n, dim = q.shape
    _check(q, torch.int8, (len(groups), target_n, dim), "q")
    for t, name in ((scale, "scale"), (inv, "inv")):
        _check(t, torch.float32, (len(groups), target_n), name)
    _check(mask, torch.bool, (len(groups), target_n), "mask")
    return _assemble(get_lib().bl_assemble_q8_batch, groups, target_n, dim,
                     q, scale, inv, mask)
