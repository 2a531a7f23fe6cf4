"""Fixed-ratio two-stream batch sampler (a copy of the JAX package's
``data/sampler.py``; the reference's ``TwoStreamBatchSampler``,
VSR_visual_frontend_pretraining_on_LRW_LRW1000_classify/data_gen.py:340-367):
each batch takes ``batch_size - secondary_batch_size`` indices from the
primary stream (one pass per epoch) and ``secondary_batch_size`` from the
secondary stream (reshuffled and cycled without end).
"""
from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np


class TwoStreamBatchSampler:
    def __init__(self, primary_indices: Sequence[int],
                 secondary_indices: Sequence[int], batch_size: int,
                 secondary_batch_size: int, seed: int = 0):
        self.primary = np.asarray(primary_indices)
        self.secondary = np.asarray(secondary_indices)
        self.secondary_bs = secondary_batch_size
        self.primary_bs = batch_size - secondary_batch_size
        if self.primary_bs <= 0 or self.secondary_bs < 0:
            raise ValueError(
                f"secondary_batch_size ({secondary_batch_size}) must be "
                f"non-negative and strictly less than batch_size ({batch_size})")
        self.rng = np.random.default_rng(seed)

    def _eternal_secondary(self) -> Iterator[int]:
        while True:
            for i in self.rng.permutation(self.secondary):
                yield int(i)

    def __iter__(self) -> Iterator[List[int]]:
        primary = self.rng.permutation(self.primary)
        sec = self._eternal_secondary()
        for s in range(0, len(self) * self.primary_bs, self.primary_bs):
            batch = [int(i) for i in primary[s:s + self.primary_bs]]
            batch.extend(next(sec) for _ in range(self.secondary_bs))
            yield batch

    def __len__(self) -> int:
        return len(self.primary) // self.primary_bs
