"""Noam learning-rate schedule + Adam (counterpart of the JAX package's
``training/schedule.py``; reference optimizer.py:1-27):

    lr(step) = k * d_model**-0.5 * min(s**-0.5, s * warmup**-1.5),  s = step + 1

with ``step`` the number of updates already applied (the reference
increments before use, so the first update sees s = 1), computed in f32
as the JAX schedule is.  Adam is ``torch.optim.Adam`` with betas (0.9, 0.98)
and eps 1e-9 outside the square root, as optax's; its lr is set from the
schedule before every step, and its own step count starts at 0, as optax's
does.

``clip_by_global_norm_`` is optax's ``clip_by_global_norm``, which the
JAX package chains before Adam when ``grad_clip`` is set: every gradient
becomes (g / norm) * max_norm when the global norm is at least max_norm,
and stays as it is otherwise; no epsilon (``torch.nn.utils.
clip_grad_norm_`` scales by max_norm / (norm + 1e-6) instead).  Under
tensor parallelism the norm is the unsharded model's: a sharded
parameter's squares (``tp_mesh`` set by ``parallel.shard_model``) are
summed over its model group, a replicated parameter's counted once, so
every process clips at the same norm.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch


def noam_lr(step: int, k: float = 0.2, warmup_steps: int = 4000,
            d_model: int = 512) -> float:
    s = np.float32(max(step + 1, 1))
    lr = np.float32(k * d_model ** -0.5) * np.minimum(
        s ** np.float32(-0.5), s * np.float32(warmup_steps ** -1.5))
    return float(lr)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every element's square (optax ``global_norm``),
    in f32."""
    return torch.sqrt(_squares(grads))


def _squares(grads) -> torch.Tensor:
    return sum(torch.sum(g.float() * g.float()) for g in grads)


def clip_by_global_norm_(params: Iterable[torch.nn.Parameter],
                         max_norm: float) -> torch.Tensor:
    """Clip the gradients of ``params`` in place by optax's rule and return
    their global norm before the clip (a device scalar: nothing waits for
    the device)."""
    params = [p for p in params if p.grad is not None]
    grads = [p.grad for p in params]
    sharded = [p for p in params if getattr(p, "tp_mesh", None) is not None]
    if sharded:
        from ..parallel.tensor import reduce_from_model
        whole = [p.grad for p in params
                 if getattr(p, "tp_mesh", None) is None]
        norm = torch.sqrt(_squares(whole) + reduce_from_model(
            _squares([p.grad for p in sharded]), sharded[0].tp_mesh))
    else:
        norm = global_norm(grads)
    clip = norm >= max_norm
    one = torch.ones((), device=norm.device)
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, max_norm * one, one))
    return norm


def make_optimizer(model: torch.nn.Module, optim_cfg) -> torch.optim.Adam:
    """Adam over every parameter of ``model`` (an OptimConfig's betas and
    eps; the lr is set per step by ``TrainState.apply_gradients``, which
    also applies ``grad_clip``)."""
    return torch.optim.Adam(model.parameters(), lr=0.0,
                            betas=(optim_cfg.adam_b1, optim_cfg.adam_b2),
                            eps=optim_cfg.adam_eps)
