"""Host-side training control: early stopping and reduce-on-plateau LR
(counterpart of vlsa_tpu/optim/schedulers.py, the same arithmetic).

`EarlyStopping` counts epochs without improvement of the monitored value
after a warmup and signals a best checkpoint; `ReduceLROnPlateau` mirrors
torch's scheduler of that name (mode "min") and, given an optimizer, writes
each new rate into every `optimizer.param_groups[i]["lr"]`.
"""
from __future__ import annotations

import numpy as np


class EarlyStopping:
    def __init__(self, warmup=5, patience=15, start_epoch=0, verbose=False):
        self.warmup = warmup
        self.patience = patience
        self.start_epoch = start_epoch
        self.verbose = verbose
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.save_checkpoint = False
        self.val_loss_min = np.inf

    def __call__(self, epoch, val_loss):
        self.save_checkpoint = False
        score = -val_loss
        if epoch < self.warmup:
            pass
        elif self.best_score is None:
            self.best_score = score
            self._update(val_loss)
        elif score - 1e-6 < self.best_score:
            self.counter += 1
            print(f"[early-stopping] counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience and epoch > self.start_epoch:
                self.early_stop = True
        else:
            self.best_score = score
            self._update(val_loss)
            self.counter = 0

    def stop(self, **kws):
        return self.early_stop

    def save_ckpt(self, **kws):
        return self.save_checkpoint

    def _update(self, val_loss):
        if self.verbose:
            print(f"[early-stopping] validation loss decreased "
                  f"({self.val_loss_min:.6f} --> {val_loss:.6f}). Saving model ...")
        self.val_loss_min = val_loss
        self.save_checkpoint = True


class ReduceLROnPlateau:
    """Mirror of torch.optim.lr_scheduler.ReduceLROnPlateau (mode='min',
    relative threshold) with vlsa_tpu's arithmetic; `step` returns the
    current rate and writes a changed one into `optimizer`."""

    def __init__(self, init_lr: float, factor: float = 0.5, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0, verbose: bool = True,
                 optimizer=None):
        self.optimizer = optimizer
        self.lr = init_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.verbose = verbose
        self.best = np.inf
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric is None:
            return self.lr
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if new_lr < self.lr and self.verbose:
                print(f"[lr-scheduler] reducing lr {self.lr:.2e} -> {new_lr:.2e}")
            self.lr = new_lr
            self.num_bad_epochs = 0
            if self.optimizer is not None:
                for group in self.optimizer.param_groups:
                    group["lr"] = new_lr
        return self.lr
