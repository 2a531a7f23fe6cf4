"""The bigram table of the LRW-1000 beam search: a frozen copy of the
port's ``decode/bigram.py::build_bigram_matrix`` (numpy only), and the
seeded label sequences the benchmark builds it from."""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

SOS_ID, EOS_ID = 0, 1


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


def seeded_sequences(seed: int, n: int, vocab_size: int, min_len: int,
                     max_len: int):
    """``n`` label sequences of lengths in [min_len, max_len], tokens
    uniform over the vocabulary without sos and eos, from ``seed``."""
    rng = np.random.default_rng([int(seed), 2])
    lengths = rng.integers(min_len, max_len + 1, size=n)
    return [rng.integers(2, vocab_size, size=int(k)) for k in lengths]


def seeded_bigram_logp(seed: int, vocab_size: int, params: dict) -> np.ndarray:
    """(V, V) float32 log table from ``params`` (sequences, min_len,
    max_len, floor)."""
    seqs = seeded_sequences(seed, params["sequences"], vocab_size,
                            params["min_len"], params["max_len"])
    freq = build_bigram_matrix(seqs, vocab_size, floor=params["floor"])
    return np.log(freq).astype(np.float32)
