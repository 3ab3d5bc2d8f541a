"""Determinism helper (counterpart of vlsa_tpu/utils/seed.py): seeds the
host RNGs and torch's, on the CPU and every card."""
from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    print(f"[setup] seed: {seed}")
