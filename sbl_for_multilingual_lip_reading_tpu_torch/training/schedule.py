"""Noam learning-rate schedule + Adam (counterpart of the JAX package's
``training/schedule.py``; reference optimizer.py:1-27):

    lr(step) = k * d_model**-0.5 * min(s**-0.5, s * warmup**-1.5),  s = step + 1

with ``step`` the number of updates already applied (the reference
increments before use, so the first update sees s = 1), computed in f32
as the JAX schedule is.  Adam is ``torch.optim.Adam`` with betas (0.9, 0.98)
and eps 1e-9 outside the square root, as optax's; its lr is set from the
schedule before every step, and its own step count starts at 0, as optax's
does.
"""
from __future__ import annotations

import numpy as np
import torch


def noam_lr(step: int, k: float = 0.2, warmup_steps: int = 4000,
            d_model: int = 512) -> float:
    s = np.float32(max(step + 1, 1))
    lr = np.float32(k * d_model ** -0.5) * np.minimum(
        s ** np.float32(-0.5), s * np.float32(warmup_steps ** -1.5))
    return float(lr)


def make_optimizer(model: torch.nn.Module, optim_cfg) -> torch.optim.Adam:
    """Adam over every parameter of ``model`` (an OptimConfig's betas and
    eps; the lr is set per step by ``TrainState.apply_gradients``)."""
    if optim_cfg.grad_clip is not None:
        raise NotImplementedError(
            "grad_clip is not ported yet: ROADMAP.md queue A item 8")
    return torch.optim.Adam(model.parameters(), lr=0.0,
                            betas=(optim_cfg.adam_b1, optim_cfg.adam_b2),
                            eps=optim_cfg.adam_eps)
