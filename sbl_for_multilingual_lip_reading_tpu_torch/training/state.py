"""Train state (counterpart of the JAX package's ``training/state.py``):
the model (parameters and BN running statistics), the optimizer (its
moments) and the count of updates applied."""
from __future__ import annotations

import dataclasses

import torch

from .schedule import clip_by_global_norm_, noam_lr


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    optim_cfg: object          # an OptimConfig: the Noam schedule's constants
    step: int = 0

    def apply_gradients(self) -> float:
        """One optimizer update with the Noam lr of this step, after the
        gradients are clipped by their global norm where ``grad_clip`` is
        set; returns the lr used."""
        c = self.optim_cfg
        if c.grad_clip is not None:
            clip_by_global_norm_(self.model.parameters(), c.grad_clip)
        lr = noam_lr(self.step, c.k, c.warmup_steps, c.lr_base_dim)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return lr
