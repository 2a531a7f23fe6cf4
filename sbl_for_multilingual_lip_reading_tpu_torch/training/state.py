"""Train state (counterpart of the JAX package's ``training/state.py``):
the model (parameters and BN running statistics), the optimizer (its
moments) and the count of updates applied."""
from __future__ import annotations

import dataclasses

import torch

from .schedule import noam_lr


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    optim_cfg: object          # an OptimConfig: the Noam schedule's constants
    step: int = 0

    def apply_gradients(self) -> float:
        """One optimizer update with the Noam lr of this step; returns the
        lr used."""
        c = self.optim_cfg
        lr = noam_lr(self.step, c.k, c.warmup_steps, c.lr_base_dim)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return lr
