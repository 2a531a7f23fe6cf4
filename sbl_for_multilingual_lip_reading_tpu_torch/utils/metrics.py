"""Evaluation metrics: WER / PER via edit distance, top-k accuracy, and a
running mean (a copy of the JAX package's ``utils/metrics.py``, which
needs no JAX; the reference's metric helpers, SBL train.py:28-42 and
utils.py:36-75).

Protocol notes kept for parity:
* ``wer_compute`` receives *joined* phoneme strings (the reference's
  ``''.join(preds)``, train.py:258) and splits on spaces -- each utterance is
  therefore a single "word", so WER is 1 - exact-sequence-match rate.
* ``per_compute`` is token-level edit distance over phoneme lists.
* The reference accumulates batch lists with ``extend`` *inside* the
  per-sample loop (train.py:262-276), duplicating entries; that eval bug is
  not reproduced: each sample counts once.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two sequences (insert/delete/substitute)."""
    if len(a) < len(b):
        a, b = b, a
    if len(b) == 0:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def wer_compute(predict: List[str], truth: List[str]) -> float:
    """Mean word error rate over paired strings (split on spaces).
    Mirrors reference wer_compute (train.py:28-33)."""
    if not truth:
        return float("nan")   # empty eval must not look like a perfect score
    wers = []
    for p, t in zip(predict, truth):
        pw, tw = p.split(" "), t.split(" ")
        wers.append(levenshtein(pw, tw) / len(tw))
    return float(np.mean(wers))


def per_compute(predict: List[Sequence[str]], truth: List[Sequence[str]]) -> float:
    """Mean phoneme error rate over paired token lists (train.py:39-42)."""
    if not truth:
        return float("nan")   # empty eval must not look like a perfect score
    pers = [levenshtein(p, t) / len(t) for p, t in zip(predict, truth)]
    return float(np.mean(pers))


def topk_accuracy(scores: np.ndarray, targets: np.ndarray, k: int = 1) -> float:
    """Percent top-k accuracy (reference utils.py:69-75)."""
    topk = np.argsort(-scores, axis=1)[:, :k]
    correct = np.any(topk == targets[:, None], axis=1)
    return float(correct.mean() * 100.0)


class AverageMeter:
    """Most-recent / running-average tracker (reference utils.py:36-54)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
