"""Synthetic clip dataset: a stand-in for the licensed LRW / LRW-1000 data
(a copy of the JAX package's ``data/synthetic.py::SyntheticLipDataset``; the
same index gives the same sample, in each of the three token tables).

Index i seeds its own uint8 noise clip; even indices carry an LRW English
word's phonemes, odd ones an LRW-1000 pinyin entry's, as the mixed bilingual
corpus of the SBL reference does (data_gen.py:270-304).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..vocab import (IGNORE_ID, VOCABS, chinese_phoneme_map, encode_pinyin_ids,
                     encode_word_ids, lrw1000_words, lrw_words, word_class_id)


def _pad_labels(ids, pad_len: int) -> np.ndarray:
    out = np.full((pad_len,), IGNORE_ID, dtype=np.int32)
    ids = ids[:pad_len]
    out[:len(ids)] = ids
    return out


class SyntheticLipDataset:
    """Indexable dataset of synthetic raw clips.  A sample is a dict of
    clip_u8 (frames, raw, raw) uint8, labels and labels_reverse (pad_len,)
    int32 IGNORE-padded phoneme ids, lang_id () int32 (0 = English,
    1 = Mandarin), word_id () int32 (the word's index among the classify
    head's 1500) and n_frames () int32.  ``vocab`` names the token table of
    the labels: 'sbl' (58, unified), 'lrw' (42, English words only) or
    'lrw1000' (48, Mandarin entries only)."""

    def __init__(self, size: int = 64, frames: int = 30, raw_size: int = 96,
                 pad_len: int = 14, kind: str = "all", seed: int = 0,
                 vocab: str = "sbl"):
        if kind not in ("all", "lrw", "lrw1000"):
            raise ValueError(f"unknown kind {kind!r}")
        if vocab not in VOCABS:
            raise ValueError(f"unknown vocab {vocab!r}")
        self.size, self.frames, self.raw = size, frames, raw_size
        self.pad_len, self.kind, self.seed = pad_len, kind, seed
        self.vocab = vocab
        self._lrw = lrw_words()
        self._lrw1000 = [w for w in lrw1000_words()
                         if all(s in chinese_phoneme_map()
                                for s in w.split(" "))]

    def __len__(self):
        return self.size

    def _is_lrw(self, i: int) -> bool:
        if self.kind != "all":
            return self.kind == "lrw"
        return i % 2 == 0

    def stream_indices(self):
        """(LRW indices, LRW-1000 indices): the two streams of
        ``TwoStreamBatchSampler``."""
        idx = range(self.size)
        return ([i for i in idx if self._is_lrw(i)],
                [i for i in idx if not self._is_lrw(i)])

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1000003 + i)
        clip = rng.integers(0, 256, size=(self.frames, self.raw, self.raw),
                            dtype=np.uint8)
        if self._is_lrw(i):
            word = self._lrw[i % len(self._lrw)]
            ids = encode_word_ids(word, self.vocab)
            lang = 0
        else:
            word = self._lrw1000[i % len(self._lrw1000)]
            ids = encode_pinyin_ids(word.split(" "), self.vocab)
            lang = 1
        word_id = word_class_id(word)
        return {
            "clip_u8": clip,
            "labels": _pad_labels(ids, self.pad_len),
            "labels_reverse": _pad_labels(ids[::-1], self.pad_len),
            "lang_id": np.int32(lang),
            "word_id": np.int32(word_id),
            "n_frames": np.int32(self.frames),
        }
