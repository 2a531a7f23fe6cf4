"""Bigram language-model bias for beam search (a copy of the JAX package's
``decode/bigram.py``; numpy only).

The reference loads a pre-built table mapping the last token id to a
frequency vector over the vocabulary and adds ``log(freq)`` to each step's
log-probabilities (the LRW-1000 project's decoder.py:12-15, 162-191).  The
table is not in the repository; this module rebuilds it from training label
sequences.  ``floor`` sets the mass of unseen bigrams: raw frequencies give
-inf for unseen pairs (hard pruning), a floor above 0 softens that.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from ..vocab import EOS_ID, SOS_ID


def build_bigram_matrix(sequences: Iterable[Sequence[int]], vocab_size: int,
                        floor: float = 0.0,
                        normalize: bool = True) -> np.ndarray:
    """Count transitions over (sos, y_0..y_n, eos) chains.  Returns (V, V)
    float32 ``freq`` with freq[last, next], rows normalized to probabilities
    when ``normalize``; ``np.log(freq)`` is the beam bias."""
    counts = np.zeros((vocab_size, vocab_size), dtype=np.float64)
    for seq in sequences:
        chain = [SOS_ID] + [int(t) for t in seq] + [EOS_ID]
        for a, b in zip(chain[:-1], chain[1:]):
            counts[a, b] += 1.0
    counts += floor
    if normalize:
        row = counts.sum(axis=1, keepdims=True)
        row[row == 0] = 1.0
        counts = counts / row
    return counts.astype(np.float32)


def bigram_from_dataset(dataset, vocab_size: int, ignore_id: int = -1,
                        floor: float = 1e-6) -> np.ndarray:
    """The bigram table of any dataset yielding 'labels' arrays.  Uses the
    dataset's ``labels_only(i)`` where it has one: ``__getitem__`` of the
    real loaders decodes a whole clip per sample, which a scan of the train
    manifest must not pay."""
    get = getattr(dataset, "labels_only", None)
    if get is None:
        def get(i):
            return dataset[i]["labels"]

    def seqs():
        for i in range(len(dataset)):
            lab = np.asarray(get(i))
            yield lab[lab != ignore_id]
    return build_bigram_matrix(seqs(), vocab_size, floor=floor)
