"""Optimizers and training control (counterpart of vlsa_tpu/optim)."""
from .ema import ModelEma  # noqa: F401
from .factory import create_optimizer, decay_mask, frozen_mask_from_cfg  # noqa: F401
from .schedulers import EarlyStopping, ReduceLROnPlateau  # noqa: F401
