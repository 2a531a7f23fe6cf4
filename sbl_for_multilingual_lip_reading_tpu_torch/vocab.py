"""Phoneme vocabulary of the SBL workloads: token ids and id -> symbol.

A copy of what the port needs from the JAX package's ``vocab/phonemes.py``
(the machine the port runs on has no JAX); ``tests/test_torch_port_package.py``
checks it against the original.
"""
from __future__ import annotations

from typing import List, Sequence

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
