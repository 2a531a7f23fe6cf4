"""The least time of the attention work K12 and K1 do for the joint
CTC/attention beam, at the real lengths of each utterance (the padding a
batch runs is not needed by the algorithm).  ``roofline.bound_s`` turns
bytes and operations into seconds.

Encoder self-attention (K12), per utterance of T frames and layer: (q + u),
k, v and the output, (H, T, d) each, read or written once in bf16; the
per-head f32 bias (H, T, T), the positional term, read once; two products
of T x T x d a head.

Decoder cross-attention (K1), per utterance and call: the K hypotheses'
queries and outputs, (K, H * d) each, once; the utterance's memory K and V,
(T, H * d) each, read once for all K hypotheses; two products of K x T x d
a head.  The padding bias is not needed by the algorithm and not counted.
"""
from __future__ import annotations

from typing import Iterable

from .roofline import bound_s


def relpos_self_attention_s(lengths: Iterable[int], H: int, d: int) -> float:
    return sum(bound_s(4 * H * T * d * 2 + H * T * T * 4, 2 * 2.0 * H * T * T * d)
               for T in lengths)


def beam_cross_attention_s(lengths: Iterable[int], K: int, H: int, d: int) -> float:
    return sum(bound_s((2 * K + 2 * T) * H * d * 2, 2 * 2.0 * H * K * T * d)
               for T in lengths)
