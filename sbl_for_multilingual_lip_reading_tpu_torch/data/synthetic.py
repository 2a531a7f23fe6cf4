"""Synthetic clip dataset: a stand-in for the licensed LRW / LRW-1000 data
(a copy of the JAX package's ``data/synthetic.py::SyntheticLipDataset``; the
same index gives the same sample, in each of the three token tables).

Index i seeds its own uint8 noise clip; even indices carry an LRW English
word's phonemes, odd ones an LRW-1000 pinyin entry's, as the mixed bilingual
corpus of the SBL reference does (data_gen.py:270-304).

``SyntheticPatternDataset`` (a copy of the JAX one) is learnable: each word
has its own low-frequency pattern and a sample is that pattern plus its own
noise, so a model trained on one split recognizes the other
(``convergence_check --full-dims``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..vocab import (IGNORE_ID, VOCABS, chinese_phoneme_map, encode_english_word,
                     encode_pinyin_ids, encode_pinyin_seq, encode_word_ids,
                     lrw1000_words, lrw_words, word_class_id)


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

    def lang_ids(self) -> np.ndarray:
        """Every sample's lang_id without building its clip."""
        return np.array([0 if self._is_lrw(i) else 1 for i in range(self.size)],
                        np.int32)

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


class SyntheticPatternDataset:
    """A learnable synthetic set whose pixels encode the word (JAX
    ``data/synthetic.py::SyntheticPatternDataset``; equal arguments give
    byte-equal samples).  Word w (English at even w, Mandarin at odd w) has
    a (frames, raw/8, raw/8) uniform pattern from its own seed, blown up to
    8x8 blocks; sample i is the pattern of word i % n_words plus
    ``noise`` * N(0, 1) from the sample's seed, scaled to [0, 255] and cut
    to uint8.  ``split`` 'train' and 'heldout' draw disjoint noise seeds.
    Samples are the dicts of ``SyntheticLipDataset`` (word_id -1 for a word
    outside the classify head's list) and are kept once built, unless
    ``cache`` is False."""

    def __init__(self, n_words: int = 200, samples_per_word: int = 25,
                 frames: int = 30, raw_size: int = 96, pad_len: int = 14,
                 seed: int = 0, noise: float = 0.25, split: str = "train",
                 cache: bool = True):
        if split not in ("train", "heldout"):
            raise ValueError(f"unknown split {split!r}")
        self.n_words, self.spw = n_words, samples_per_word
        self.frames, self.raw, self.pad_len = frames, raw_size, pad_len
        self.seed, self.noise, self.split = seed, noise, split
        self._cache: Optional[Dict[int, Dict[str, np.ndarray]]] = (
            {} if cache else None)
        lrw = lrw_words()
        l1000 = [w for w in lrw1000_words()
                 if all(s in chinese_phoneme_map() for s in w.split(" "))]
        self.words = [("en", lrw[(i // 2) % len(lrw)]) if i % 2 == 0 else
                      ("zh", l1000[(i // 2) % len(l1000)])
                      for i in range(n_words)]
        self._patterns: Dict[int, np.ndarray] = {}

    def __len__(self):
        return self.n_words * self.spw

    def lang_ids(self) -> np.ndarray:
        """Every sample's lang_id without building its clip."""
        return np.array([0 if self.words[i % self.n_words][0] == "en" else 1
                         for i in range(len(self))], np.int32)

    def _pattern(self, w: int) -> np.ndarray:
        if w not in self._patterns:
            rng = np.random.default_rng(77777 + self.seed * 131 + w)
            small = rng.random((self.frames, self.raw // 8, self.raw // 8))
            self._patterns[w] = np.kron(small, np.ones((1, 8, 8))).astype(
                np.float32)
        return self._patterns[w]

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        out = self._build(i)
        if self._cache is not None:
            self._cache[i] = out
        return out

    def _build(self, i: int) -> Dict[str, np.ndarray]:
        w = i % self.n_words
        offset = 10 ** 7 if self.split == "heldout" else 0
        rng = np.random.default_rng(self.seed * 1000003 + offset + i)
        base = self._pattern(w)
        clip = base + self.noise * rng.standard_normal(base.shape)
        clip = np.clip(clip * 255.0, 0, 255).astype(np.uint8)
        lang, word = self.words[w]
        if lang == "en":
            ids = encode_english_word(word)
            word_id = word_class_id(word) if word in lrw_words() else -1
        else:
            ids = encode_pinyin_seq(word.split(" "))
            word_id = word_class_id(word)
        return {
            "clip_u8": clip,
            "labels": _pad_labels(ids, self.pad_len),
            "labels_reverse": _pad_labels(ids[::-1], self.pad_len),
            "lang_id": np.int32(0 if lang == "en" else 1),
            "word_id": np.int32(word_id),
            "n_frames": np.int32(self.frames),
        }
