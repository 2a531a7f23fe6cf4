"""Losses of the train steps (counterpart of the JAX package's
``training/loss.py``): label-smoothed cross-entropy with IGNORE_ID masking,
mean over non-pad tokens, and the count of correct tokens (the seq2seq
workloads); the joint word + language cross-entropy of ``classify``.

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


def token_count(gold: torch.Tensor) -> torch.Tensor:
    """The tokens ``label_smoothed_ce`` averages over: gold's non-pad
    entries."""
    return (gold != IGNORE_ID).sum()


def masked_ce(logits: torch.Tensor, labels: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean CE of (B, C) logits over the samples whose label is >= 0, the
    count of those samples)."""
    valid = labels >= 0
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, labels, 0).long()[:, None])[:, 0]
    n = valid.sum()
    return torch.where(valid, nll, 0.0).sum() / n.clamp(min=1), n


def classify_terms(word_logits: torch.Tensor, word_labels: torch.Tensor,
                   lang_logits: torch.Tensor, lang_labels: torch.Tensor):
    """``classify_loss``'s parts: ((word CE, valid words), (language CE,
    valid languages), word_correct, lang_correct)."""
    w_ok = ((word_logits.argmax(dim=-1) == word_labels) & (word_labels >= 0)).sum()
    l_ok = ((lang_logits.argmax(dim=-1) == lang_labels) & (lang_labels >= 0)).sum()
    return (masked_ce(word_logits, word_labels), masked_ce(lang_logits, lang_labels),
            w_ok, l_ok)


def classify_loss(word_logits: torch.Tensor, word_labels: torch.Tensor,
                  lang_logits: torch.Tensor, lang_labels: torch.Tensor,
                  language_weight: float = 0.1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Word CE + ``language_weight`` * language CE, each a mean over its
    valid samples (the reference's classify train.py:127-130).  Returns
    (loss, word_correct, lang_correct).  Samples with a label below 0 (the
    unknown-word sentinel) are left out of loss and accuracy, as in JAX."""
    (word_ce, _), (lang_ce, _), w_ok, l_ok = classify_terms(
        word_logits, word_labels, lang_logits, lang_labels)
    return word_ce + language_weight * lang_ce, w_ok, l_ok
