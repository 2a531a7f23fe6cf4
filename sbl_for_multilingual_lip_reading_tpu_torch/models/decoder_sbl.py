"""Synchronous bidirectional (L2R + R2L) decoder, greedy recognize
(counterpart of the JAX package's ``models/decoder_sbl.py``).

The JAX ``lax.scan`` over decode steps becomes a Python loop; everything
else follows the JAX module:

* both directions run at once on token buffers stacked into a leading
  direction axis (2, B, L), dir 0 = l2r; each layer's weights carry that
  axis (the JAX ``nn.vmap``), so its projections run as one ``bmm``
  over (2, B*L, D) and its attention as one K1 launch over 2*B rows;
* the cross-attention K/V of every layer are projected once per clip
  (``cross_kv_i``), outside the step loop;
* the FIRST layer masks ``causal | beyond`` (keys past the current step),
  the others ``beyond`` only (the reference passes no causal mask there);
* cross-direction fusion after every layer (``_fuse_dual``), in both
  ``symmetric`` and ``reference_aliased`` modes;
* logits are read at position ``step``; ``argmax`` takes the first index
  on ties and never stops early;
* growing-buffer segments (``_segments``): step i runs on the buffer's
  first ``b+1`` positions, where b ends the step's segment, exactly the
  widths the JAX scan segments use (and ``utils/flops.py`` accounts for).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from ..ops import masks as M
from ..ops.attention import mask_to_bias
from ..vocab import EOS_ID, IGNORE_ID, SOS_ID
from .layers import (CachedCrossAttention, CrossKV, Dense, MultiHeadAttention,
                     PositionwiseFeedForward, sinusoid_position_encoding)

DIRS = 2


def preprocess_targets(labels: torch.Tensor, maxlen: int,
                       eos_id: int = EOS_ID) -> torch.Tensor:
    """(B, P) IGNORE_ID-padded labels -> (B, maxlen) eos-padded gold: valid
    tokens keep their position, everything after becomes eos."""
    B, P = labels.shape
    out = torch.full((B, maxlen), eos_id, dtype=torch.int64,
                     device=labels.device)
    take = min(P, maxlen)
    head = labels[:, :take]
    out[:, :take] = torch.where(head != IGNORE_ID, head,
                                torch.full_like(head, eos_id))
    return out


def _rev_index(length: int, step: int, device=None) -> torch.Tensor:
    """(L,) fusion reversal over the live prefix: n -> step-n for n <= step,
    positions beyond the prefix map to themselves."""
    n = torch.arange(length, device=device)
    return torch.where(n <= step, step - n, n)


def _fuse_dual(h: torch.Tensor, rev_idx: torch.Tensor,
               mode: str) -> torch.Tensor:
    """Direction-stacked fusion: h is (2, B, L, D) with dir 0 = l2r.

    symmetric:          h' = h + rev(h[::-1])
    reference_aliased:  l2r' = l2r + rev(r2l);  r2l' = 2*r2l + rev(l2r)
    """
    rev = h.flip(0).index_select(2, rev_idx)
    if mode == "symmetric":
        return h + rev
    if mode == "reference_aliased":
        out = h + rev
        out[1] = 2.0 * h[1] + rev[1]
        return out
    raise ValueError(f"unknown fusion_mode: {mode}")


class _SBLLayer(nn.Module):
    """One direction-stacked decoder layer: self-attn + cached cross-attn
    + FFN, with weights (2, ...)."""

    def __init__(self, d_model: int, n_head: int, d_k: int, d_v: int,
                 d_inner: int, dtype=torch.float32, use_kernels: bool = True):
        super().__init__()
        self.slf = MultiHeadAttention(d_model, n_head, d_k, d_v, dtype,
                                      use_kernels, dirs=DIRS)
        self.cross = CachedCrossAttention(d_model, n_head, d_k, d_v, dtype,
                                          use_kernels, dirs=DIRS)
        self.ffn = PositionwiseFeedForward(d_model, d_inner, dtype, dirs=DIRS)

    def forward(self, h, k2, v2, bias):
        h = self.slf(h, h, h, bias=bias)
        h = self.cross(h, k2, v2)
        return self.ffn(h)


class _SBLStep(nn.Module):
    """One decode step over both directions: embedding (shared by the two
    directions) + PE, the layer stack with fusion after every layer, and
    the untied per-direction output heads read at position ``step``."""

    def __init__(self, vocab_size: int, d_model: int, n_layers: int,
                 n_head: int, d_k: int, d_v: int, d_inner: int,
                 pe_maxlen: int, fusion_mode: str, dtype=torch.float32,
                 use_kernels: bool = True):
        super().__init__()
        if fusion_mode not in ("symmetric", "reference_aliased"):
            raise ValueError(f"unknown fusion_mode: {fusion_mode}")
        self.n_layers, self.fusion_mode, self.dtype = n_layers, fusion_mode, dtype
        self.tgt_word_emb = nn.Embedding(vocab_size, d_model, dtype=dtype)
        self.register_buffer("pe", sinusoid_position_encoding(pe_maxlen, d_model),
                             persistent=False)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", _SBLLayer(
                d_model, n_head, d_k, d_v, d_inner, dtype, use_kernels))
        self.tgt_word_prj = Dense(d_model, vocab_size, bias=False, dirs=DIRS,
                                  dtype=dtype)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        w = torch.empty(self.tgt_word_emb.weight.shape)
        nn.init.xavier_uniform_(w, generator=g)
        self.tgt_word_emb.weight.copy_(w)

    def forward(self, ys: torch.Tensor, enc_kv, step: int) -> torch.Tensor:
        """ys: (2, B, L) token buffers; enc_kv: per layer (k2, v2), each
        (2, B, Tk, H*d).  Returns the (2, B, V) f32 logits at ``step``."""
        L = ys.shape[-1]
        dev = ys.device
        # the PE is added in the compute dtype (JAX decoder_sbl.py:217-219)
        h = self.tgt_word_emb(ys) + self.pe[:L].to(self.dtype)
        beyond = (torch.arange(L, device=dev) > step)[None, None, :]
        first_bias = mask_to_bias(M.causal_mask(L, dev)[None] | beyond, L, L)
        stack_bias = mask_to_bias(beyond, L, L)
        rev_idx = _rev_index(L, step, dev)
        for i in range(self.n_layers):
            k2, v2 = enc_kv[i]
            h = getattr(self, f"layer_{i}")(h, k2, v2,
                                            first_bias if i == 0 else stack_bias)
            h = _fuse_dual(h, rev_idx, self.fusion_mode)
        return self.tgt_word_prj(h[:, :, step]).to(torch.float32)


class SBLDecoder(nn.Module):
    """Synchronous bidirectional decoder, inference path."""

    def __init__(self, vocab_size: int = 58, d_model: int = 512,
                 n_layers: int = 6, n_head: int = 8, d_k: int = 64,
                 d_v: int = 64, d_inner: int = 2048, pe_maxlen: int = 5000,
                 maxlen: int = 16, fusion_mode: str = "symmetric",
                 decode_segments: int = 4, dtype=torch.float32,
                 use_kernels: bool = True):
        super().__init__()
        self.maxlen, self.decode_segments = maxlen, decode_segments
        self.n_layers, self.dtype = n_layers, dtype
        self.step = _SBLStep(vocab_size, d_model, n_layers, n_head, d_k, d_v,
                             d_inner, pe_maxlen, fusion_mode, dtype, use_kernels)
        for i in range(n_layers):
            self.add_module(f"cross_kv_{i}", CrossKV(d_model, n_head, d_k, d_v,
                                                     dtype, dirs=DIRS))

    def _segments(self) -> List[Tuple[int, int]]:
        """Decode segments of growing buffer width (JAX
        ``SBLDecoder._segments``): steps [a, b) run on width b+1."""
        k = max(1, min(self.decode_segments, self.maxlen))
        bounds = [round(self.maxlen * (i + 1) / k) for i in range(k)]
        out = []
        start = 0
        for b in bounds:
            if b > start:
                out.append((start, b))
                start = b
        return out

    def compute_cross_kv(self, enc_output: torch.Tensor):
        """Per layer (k2, v2), each (2, B, Tk, H*d), projected once."""
        enc = enc_output.to(self.dtype)
        return tuple(getattr(self, f"cross_kv_{i}")(enc)
                     for i in range(self.n_layers))

    def decode(self, enc_output: torch.Tensor):
        """Greedy decode.  Returns (ys_l2r, ys_r2l, logits_l2r, logits_r2l):
        token ids (B, maxlen+1) with the leading sos, and f32 logits
        (B, maxlen, V) of every step."""
        B = enc_output.shape[0]
        ys = torch.full((DIRS, B, self.maxlen + 1), SOS_ID, dtype=torch.int64,
                        device=enc_output.device)
        enc_kv = self.compute_cross_kv(enc_output)
        logits = []
        for a, b in self._segments():
            for step in range(a, b):
                lg = self.step(ys[:, :, :b + 1], enc_kv, step)
                ys[:, :, step + 1] = lg.argmax(dim=-1)
                logits.append(lg)
        lg = torch.stack(logits, dim=2)                 # (2, B, maxlen, V)
        return ys[0], ys[1], lg[0], lg[1]

    def recognize(self, enc_output: torch.Tensor):
        """Greedy decode; returns (ys_l2r, ys_r2l), (B, maxlen+1) ids."""
        ys_l2r, ys_r2l, _, _ = self.decode(enc_output)
        return ys_l2r, ys_r2l
