"""Phoneme vocabularies of the seq2seq workloads (the unified 58 tokens of
``sbl``, the 42 of ``lrw``, the 48 of ``lrw1000``): token ids, id -> symbol,
and word -> token ids for the datasets' labels.

A copy of what the port needs from the JAX package's ``vocab/phonemes.py``
and its data tables (``assets/``: the ARPABET table of the 500 LRW words,
the English and pinyin phoneme maps, the LRW and LRW-1000 word lists,
which together are the classify head's 1500 words), as
the machine the port runs on has no JAX; ``tests/test_torch_port_package.py``
checks it against the original.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, List, Sequence

_ASSETS = Path(__file__).resolve().parent / "assets"

IGNORE_ID = -1
SOS_ID = 0
EOS_ID = 1

# the 58-token unified vocabulary (56 phonemes + sos/eos); index == token id
TOTAL_PHONEMES: List[str] = [
    "sos", "eos", "s", "p", "ii", "k", "i", "ng", "l", "e", "v", "e1",
    "a1", "m", "z", "zh", "o", "r", "eu", "t", "ai", "h", "th", "y", "n",
    "ch", "ae", "au", "er", "d", "f", "ei", "w", "a", "oi", "b", "uu",
    "g", "sh", "dh", "u", "zh1", "an", "ang", "en", "eng", "ie", "in",
    "ing", "uo", "ts", "iii", "ong", "j", "yu", "yue", "q", "x",
]

# the 42-token English vocabulary of the LRW seq2seq project; it spells two
# phonemes differently from TOTAL_PHONEMES ('ing' for 'ng', 'a2' for 'a1')
LRW_PHONEMES: List[str] = [
    "<sos>", "<eos>", "s", "p", "ii", "k", "i", "ing", "l", "e", "v",
    "e1", "a2", "m", "z", "zh", "o", "r", "eu", "t", "ai", "h", "th",
    "y", "n", "ch", "ae", "au", "er", "d", "f", "ei", "w", "a", "oi",
    "b", "uu", "g", "sh", "dh", "u", "zh1",
]

# the 48-token Mandarin vocabulary of the LRW-1000 seq2seq project
LRW1000_PHONEMES: List[str] = [
    "sos", "eos", "s", "au", "m", "i", "p", "ii", "t", "q", "yu", "x",
    "j", "an", "y", "eu", "sh", "iii", "d", "ong", "ang", "zh", "l",
    "e1", "f", "g", "eng", "ts", "uo", "a", "ch", "w", "en", "h", "u",
    "ai", "yue", "uu", "in", "ing", "ei", "z", "b", "zh1", "k", "ie",
    "er", "n",
]


def decode_ids(ids: Sequence[int], vocab: Sequence[str] = TOTAL_PHONEMES,
               strip_special: bool = True) -> List[str]:
    """Token ids -> phoneme symbols; drops sos/eos/IGNORE_ID when asked."""
    out = []
    for i in ids:
        i = int(i)
        if strip_special and i in (SOS_ID, EOS_ID, IGNORE_ID):
            continue
        if 0 <= i < len(vocab):
            out.append(vocab[i])
    return out


def _read_lines(name: str) -> List[str]:
    with open(_ASSETS / name) as f:
        return [ln.rstrip("\n") for ln in f if ln.strip()]


@functools.lru_cache(None)
def english_phoneme_map() -> Dict[str, str]:
    """ARPABET (with stress digit) -> unified phoneme symbol."""
    out: Dict[str, str] = {}
    for line in _read_lines("english_phonemes.txt"):
        items = line.split(" ")
        if len(items) >= 2:
            out[items[0]] = items[1]
    return out


@functools.lru_cache(None)
def chinese_phoneme_map() -> Dict[str, List[str]]:
    """Pinyin syllable -> list of unified phoneme symbols."""
    out: Dict[str, List[str]] = {}
    for line in _read_lines("chinese_phonemes.txt"):
        items = line.split("  ")
        if len(items) >= 2:
            out[items[0]] = items[1].split(" ")
    return out


@functools.lru_cache(None)
def lrw_word_arpabet() -> Dict[str, List[str]]:
    """Uppercased LRW word -> ARPABET pronunciation."""
    with open(_ASSETS / "lrw_word_arpabet.json") as f:
        return json.load(f)


@functools.lru_cache(None)
def lrw_words() -> List[str]:
    return _read_lines("lrw_words.txt")


@functools.lru_cache(None)
def lrw1000_words() -> List[str]:
    return _read_lines("lrw1000_words.txt")


def encode_english_word(word: str) -> List[int]:
    """English word -> unified token ids."""
    emap = english_phoneme_map()
    return [TOTAL_PHONEMES.index(emap[a]) for a in lrw_word_arpabet()[word.upper()]]


def encode_pinyin_seq(pinyins: Sequence[str]) -> List[int]:
    """Pinyin syllables -> unified token ids (concatenated)."""
    cmap = chinese_phoneme_map()
    return [TOTAL_PHONEMES.index(ph) for py in pinyins for ph in cmap[py]]


_LRW_RESPELL = {"ng": "ing", "a1": "a2"}
VOCABS = ("sbl", "lrw", "lrw1000")


def encode_word_ids(word: str, vocab: str = "sbl") -> List[int]:
    """English word -> token ids in the requested table: 'sbl' = the
    unified 58 tokens, 'lrw' = the LRW project's own 42 (JAX
    ``data/datasets.py::encode_word_ids``)."""
    if vocab == "lrw":
        emap = english_phoneme_map()
        phs = [emap[a] for a in lrw_word_arpabet()[word.upper()]]
        return [LRW_PHONEMES.index(_LRW_RESPELL.get(p, p)) for p in phs]
    return encode_english_word(word)


def encode_pinyin_ids(pinyins: Sequence[str], vocab: str = "sbl") -> List[int]:
    """Pinyin syllables -> token ids: 'sbl' = the unified 58 tokens,
    'lrw1000' = the Mandarin project's 48 (JAX ``encode_pinyin_ids``)."""
    if vocab == "lrw1000":
        cmap = chinese_phoneme_map()
        return [LRW1000_PHONEMES.index(ph) for py in pinyins for ph in cmap[py]]
    return encode_pinyin_seq(pinyins)


@functools.lru_cache(None)
def words_1500() -> List[str]:
    """The classify head's 1500 words: the 500 LRW words, then the 1000
    LRW-1000 pinyin strings (the JAX package's ``words_1500.txt``)."""
    return lrw_words() + lrw1000_words()


@functools.lru_cache(None)
def _word_index() -> Dict[str, int]:
    return {w: i for i, w in enumerate(words_1500())}


def word_class_id(word: str) -> int:
    """Index of ``word`` in ``words_1500``, or -1 for an unknown word."""
    return _word_index().get(word, -1)
