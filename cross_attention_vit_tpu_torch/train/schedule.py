"""Learning-rate schedules with torch step semantics (port of
``cross_attention_vit_tpu/train/schedule.py``).

``cosine_annealing_lr`` is torch's CosineAnnealingLR closed form, stepped per
epoch: epoch 0 runs at the base lr, and the closed form is periodic in
2·T_max, so past T_max the lr comes back up, as torch's recursion does.
``ReduceLROnPlateau`` (mode 'min', relative threshold) serves the legacy ViT3D.
"""

from __future__ import annotations

import math


def cosine_annealing_lr(base_lr: float, t_max: int, eta_min: float = 0.0):
    """Returns lr(epoch): torch CosineAnnealingLR closed form."""

    def lr(epoch: int) -> float:
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / t_max)) / 2

    return lr


class ReduceLROnPlateau:
    """torch ReduceLROnPlateau (mode='min'): multiply lr by ``factor`` after
    ``patience`` epochs without improvement beyond ``threshold`` (rel mode)."""

    def __init__(self, base_lr: float, factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = math.inf
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr
