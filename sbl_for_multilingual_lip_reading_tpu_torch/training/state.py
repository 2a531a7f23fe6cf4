"""Train state (counterpart of the JAX package's ``training/state.py``):
the model (parameters and BN running statistics), the optimizer (its
moments) and the count of updates applied, kept twice: ``step`` on the host
and ``step_dev``, an int64 on the model's device that the step itself
advances (JAX's ``state.step``), from which the lr is computed and the
epoch-fused step indexes its epoch's constants -- so a step captured as a
CUDA graph reads each replay's count.  Setting ``step`` sets both."""
from __future__ import annotations

import torch

from .schedule import clip_by_global_norm_, noam_lr_device


class TrainState:
    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 optim_cfg, step: int = 0):
        self.model, self.optimizer = model, optimizer
        self.optim_cfg = optim_cfg   # an OptimConfig: the Noam schedule's constants
        device = next(model.parameters()).device
        self.step_dev = torch.zeros((), dtype=torch.int64, device=device)
        self.lr = optimizer.param_groups[0]["lr"]
        if not torch.is_tensor(self.lr):
            self.lr = torch.zeros((), device=device)
        self.capturable = device.type == "cuda"
        self._step = 0
        self.step = step

    @property
    def step(self) -> int:
        return self._step

    @step.setter
    def step(self, value: int) -> None:
        self._step = int(value)
        self.step_dev.fill_(self._step)

    def apply_gradients(self) -> torch.Tensor:
        """One optimizer update with the Noam lr of this step (computed on
        the device), after the gradients are clipped by their global norm
        where ``grad_clip`` is set; returns the lr tensor.  Nothing is read
        on the host."""
        c = self.optim_cfg
        if c.grad_clip is not None:
            clip_by_global_norm_(self.model.parameters(), c.grad_clip)
        self.lr.copy_(noam_lr_device(self.step_dev, c.k, c.warmup_steps,
                                     c.lr_base_dim))
        for group in self.optimizer.param_groups:
            # a loaded optimizer state dict brings its own lr and flags
            if self.capturable and not group.get("capturable"):
                adam_steps_to_params_(self.optimizer, group)
            group["lr"], group["capturable"] = self.lr, self.capturable
        self.optimizer.step()
        self.step_dev.add_(1)
        self._step += 1
        return self.lr


def adam_steps_to_params_(optimizer: torch.optim.Optimizer, group) -> None:
    """Move Adam's per-parameter step counts of ``group`` onto their
    parameters' devices as f32, as ``capturable`` needs them.  A state dict
    saved without ``capturable`` (on the CPU, or by a port before the step
    became capturable) loads its counts onto the host: torch moves them to
    the parameter only for a group saved capturable."""
    for p in group["params"]:
        state = optimizer.state.get(p, {})
        step = state.get("step")
        if torch.is_tensor(step) and (step.device != p.device
                                      or step.dtype != torch.float32):
            state["step"] = step.to(device=p.device, dtype=torch.float32)
