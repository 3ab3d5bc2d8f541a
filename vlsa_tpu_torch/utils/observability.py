"""Observability (counterpart of vlsa_tpu/utils/observability.py): a JSONL
metric log per run, a torch.profiler Chrome trace of a training epoch when
`profile_dir` is set, and `debug_nans`, which turns on autograd's anomaly
detection (a backward that makes a NaN raises, naming its forward op)."""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Optional

import torch


class JsonlLogger:
    """Append-only JSONL metrics log (none for a path of None: the ranks of
    a multi-process run but rank 0)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._fh = None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, record: dict):
        if self._fh is None:
            return
        record = dict(record)
        record.setdefault("ts", time.time())
        self._fh.write(json.dumps(record, default=float) + "\n")

    def close(self):
        if self._fh is not None:
            self._fh.close()


@contextmanager
def maybe_profile(profile_dir: Optional[str], tag: str = "train"):
    """torch.profiler around the block when a directory is configured; the
    trace goes to <profile_dir>/<tag>_trace.json (chrome://tracing, Perfetto)."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(profile_dir, f"{tag}_trace.json")
    prof.export_chrome_trace(path)
    print(f"[profiler] wrote {tag} trace to {path}")


def configure_debug(cfg: dict):
    """Debug-mode toggles, before any training."""
    if cfg.get("debug_nans"):
        torch.autograd.set_detect_anomaly(True)
        print("[debug] autograd anomaly detection enabled")
