"""Loss of the SBL train step (counterpart of the JAX package's
``training/loss.py``): label-smoothed cross-entropy with IGNORE_ID masking,
mean over non-pad tokens, and the count of correct tokens.

The reference's target distribution puts ``eps/C`` of smoothing mass on
EVERY off-target class (loss.py:43), not the textbook eps/(C-1); kept as
it is.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..vocab import IGNORE_ID


def label_smoothed_ce(pred: torch.Tensor, gold: torch.Tensor,
                      smoothing: float = 0.0) -> torch.Tensor:
    """pred: (..., C) raw logits; gold: (...,) ids with IGNORE_ID padding.
    Returns the scalar mean loss over non-ignored tokens, in f32."""
    C = pred.shape[-1]
    logp = torch.log_softmax(pred.to(torch.float32), dim=-1)
    mask = gold != IGNORE_ID
    safe = torch.where(mask, gold, 0).long()
    gold_logp = torch.gather(logp, -1, safe[..., None])[..., 0]
    if smoothing > 0.0:
        off_gold = logp.sum(dim=-1) - gold_logp
        nll = -((1.0 - smoothing) * gold_logp + (smoothing / C) * off_gold)
    else:
        nll = -gold_logp
    n = mask.sum().clamp(min=1)
    return torch.where(mask, nll, 0.0).sum() / n


def cal_performance(pred: torch.Tensor, gold: torch.Tensor,
                    smoothing: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, n_correct) for pred (B, T, C) and gold (B, T)."""
    loss = label_smoothed_ce(pred, gold, smoothing)
    correct = (pred.argmax(dim=-1) == gold) & (gold != IGNORE_ID)
    return loss, correct.sum()
