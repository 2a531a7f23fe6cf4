"""Unidirectional transformer decoder of the ``lrw`` / ``lrw1000`` workloads
(counterpart of the JAX package's ``models/decoder_uni.py``): the
teacher-forced forward (the training forward when given the step's random
numbers), greedy decode with and without a K/V cache, and the step
functions beam search drives.

The JAX ``lax.scan`` loops become Python loops; everything else follows the
JAX module:

* targets get sos on the input side and eos on the output side; inputs are
  padded with eos, gold with IGNORE_ID (unlike the SBL decoder, which
  eos-pads gold too);
* with ``tie_embedding`` the output projection is the embedding table, the
  input embedding is scaled by ``d_model ** -0.5``, and the logits come out
  of an f32 product of the compute-dtype operands;
* the encoder sequence's cross-attention K/V are projected once per clip
  (``CrossKV``), not at every decode step;
* the cached path projects and attends one new token per step against flat
  (B, L, h*d) caches (``MultiHeadAttention.decode_step``), token-identical
  to the full-prefix re-run;
* with a ``DropoutRNG`` the teacher-forced forward drops as JAX's does with
  ``deterministic=False``: the embedding, the attention probabilities and
  the output of every self- and cross-attention (K3 forward, K4 backward,
  one seed per call from the rng), and the FFN output.  The decode paths
  stay deterministic.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import masks as M
from ..ops.attention import mask_to_bias
from ..vocab import EOS_ID, IGNORE_ID, SOS_ID
from .layers import (CachedCrossAttention, CrossKV, Dense, DropoutRNG,
                     MultiHeadAttention, PositionwiseFeedForward, dropout,
                     sinusoid_position_encoding)


def make_uni_cache(batch: int, length: int, n_layers: int, kd: int, vd: int,
                   dtype, device=None) -> tuple:
    """Zeroed per-layer self-attention K/V caches for cached decode: a tuple
    over layers of ((batch, length, kd), (batch, length, vd)) flat projected
    tensors."""
    return tuple((torch.zeros((batch, length, kd), dtype=dtype, device=device),
                  torch.zeros((batch, length, vd), dtype=dtype, device=device))
                 for _ in range(n_layers))


def preprocess_targets_uni(labels: torch.Tensor, maxlen: int,
                           sos_id: int = SOS_ID, eos_id: int = EOS_ID,
                           ignore_id: int = IGNORE_ID
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, P) IGNORE-padded labels -> (ys_in (B, maxlen), ys_out (B, maxlen)).

    ys_in  = [sos, y_0..y_{n-1}, eos, eos, ...]   (eos-padded)
    ys_out = [y_0..y_{n-1}, eos, IGNORE, ...]     (IGNORE-padded gold)
    """
    B, P = labels.shape
    dev = labels.device
    lengths = (labels != ignore_id).sum(dim=1)
    pos = torch.arange(maxlen, device=dev)[None, :]
    take = min(P, maxlen)
    head = labels[:, :take].to(torch.int64)
    clean = torch.where(head != ignore_id, head, torch.full_like(head, eos_id))

    ys_in = torch.full((B, maxlen), eos_id, dtype=torch.int64, device=dev)
    ys_in[:, 0] = sos_id
    end = take + 1 if take + 1 <= maxlen else maxlen
    ys_in[:, 1:end] = clean[:, :maxlen - 1]

    ys_out = torch.full((B, maxlen), eos_id, dtype=torch.int64, device=dev)
    ys_out[:, :take] = clean
    tail = torch.where(pos == lengths[:, None], eos_id, ignore_id)
    return ys_in, torch.where(pos < lengths[:, None], ys_out, tail)


class UniDecoder(nn.Module):
    """Submodules are named as flax names the JAX module's lists:
    ``slf_attn_i``, ``enc_attn_i``, ``pos_ffn_i``, ``cross_kv_i``."""

    def __init__(self, vocab_size: int = 42, d_model: int = 512,
                 n_layers: int = 6, n_head: int = 8, d_k: int = 64,
                 d_v: int = 64, d_inner: int = 2048, pe_maxlen: int = 5000,
                 maxlen: int = 14, tie_embedding: bool = True,
                 dtype=torch.float32, use_kernels: bool = True,
                 dropout: float = 0.1):
        super().__init__()
        self.vocab_size, self.d_model, self.n_layers = vocab_size, d_model, n_layers
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.maxlen, self.tie_embedding, self.dtype = maxlen, tie_embedding, dtype
        self.dropout = dropout
        self.tgt_word_emb = nn.Embedding(vocab_size, d_model)
        self.register_buffer("pe", sinusoid_position_encoding(pe_maxlen, d_model),
                             persistent=False)
        for i in range(n_layers):
            self.add_module(f"slf_attn_{i}", MultiHeadAttention(
                d_model, n_head, d_k, d_v, dtype, use_kernels, dropout=dropout))
            self.add_module(f"enc_attn_{i}", CachedCrossAttention(
                d_model, n_head, d_k, d_v, dtype, use_kernels, dropout=dropout))
            self.add_module(f"pos_ffn_{i}", PositionwiseFeedForward(
                d_model, d_inner, dtype, dropout=dropout))
            self.add_module(f"cross_kv_{i}", CrossKV(d_model, n_head, d_k, d_v,
                                                     dtype))
        if not tie_embedding:
            self.tgt_word_prj = Dense(d_model, vocab_size, bias=False,
                                      dtype=dtype, init="xavier_normal")
        self.x_logit_scale = (d_model ** -0.5) if tie_embedding else 1.0

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        w = torch.empty(self.tgt_word_emb.weight.shape)
        nn.init.xavier_uniform_(w, generator=g)
        self.tgt_word_emb.weight.copy_(w)

    def _layers(self):
        for i in range(self.n_layers):
            yield (getattr(self, f"slf_attn_{i}"), getattr(self, f"enc_attn_{i}"),
                   getattr(self, f"pos_ffn_{i}"))

    def _embed(self, ys: torch.Tensor,
               rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        T = ys.shape[1]
        emb = F.embedding(ys, self.tgt_word_emb.weight.to(self.dtype))
        h = emb * self.x_logit_scale + self.pe[:T].to(self.dtype)
        return dropout(h, self.dropout, rng)

    def _project(self, h: torch.Tensor) -> torch.Tensor:
        if self.tie_embedding:
            # an f32 product of the compute-dtype operands (JAX einsum with
            # preferred_element_type=float32)
            w = self.tgt_word_emb.weight.to(self.dtype)
            return torch.matmul(h.to(torch.float32), w.to(torch.float32).t())
        return self.tgt_word_prj(h).to(torch.float32)

    def compute_cross_kv(self, enc_output: torch.Tensor):
        """Per layer (k2, v2), each (B, Tk, H*d), projected once."""
        enc = enc_output.to(self.dtype)
        return tuple(getattr(self, f"cross_kv_{i}")(enc)
                     for i in range(self.n_layers))

    def _stack(self, h, enc_kv, non_pad, slf_bias, dec_enc_bias, rng=None):
        for (slf, cross, ffn), (k2, v2) in zip(self._layers(), enc_kv):
            h = slf(h, h, h, bias=slf_bias, rng=rng)
            if non_pad is not None:
                h = h * non_pad.to(h.dtype)
            h = cross(h, k2, v2, bias=dec_enc_bias, rng=rng)
            if non_pad is not None:
                h = h * non_pad.to(h.dtype)
            h = ffn(h, rng)
            if non_pad is not None:
                h = h * non_pad.to(h.dtype)
        return h

    def forward(self, labels: torch.Tensor, enc_output: torch.Tensor,
                enc_lengths: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None):
        """Parallel teacher-forced forward: deterministic without ``rng``
        (JAX ``deterministic=True``), the training forward with dropout
        with one.  Returns (pred, gold): f32 logits (B, maxlen, V) and
        IGNORE-padded gold (B, maxlen)."""
        ys_in, ys_out = preprocess_targets_uni(labels, self.maxlen)
        T = ys_in.shape[1]
        Tk = enc_output.shape[1]
        non_pad = M.non_pad_mask_from_ids(ys_in, EOS_ID)
        slf_bias = mask_to_bias(M.causal_mask(T, ys_in.device)[None]
                                | M.key_pad_mask_from_ids(ys_in, EOS_ID), T, T)
        dec_enc_bias = None
        if enc_lengths is not None:
            dec_enc_bias = mask_to_bias(
                M.key_pad_mask_from_lengths(enc_lengths, Tk), T, Tk)
        h = self._stack(self._embed(ys_in, rng), self.compute_cross_kv(enc_output),
                        non_pad, slf_bias, dec_enc_bias, rng)
        return self._project(h).to(torch.float32), ys_out

    def _prefix_bias(self, L: int, step: int, device) -> torch.Tensor:
        """Causal, and restricted to the live prefix (keys <= step)."""
        beyond = (torch.arange(L, device=device) > step)[None, None, :]
        return mask_to_bias(M.causal_mask(L, device)[None] | beyond, L, L)

    def recognize_greedy(self, enc_output: torch.Tensor,
                         maxlen: Optional[int] = None,
                         kv_cache: bool = True) -> torch.Tensor:
        """Batched greedy decode; returns (B, L+1) ids with the leading sos.
        ``kv_cache=False`` re-runs the full prefix each step, the
        reference's shape, for parity checks."""
        if kv_cache:
            return self.recognize_greedy_cached(enc_output, maxlen=maxlen)
        return self.recognize_greedy_uncached(enc_output, maxlen=maxlen)

    def recognize_greedy_uncached(self, enc_output: torch.Tensor,
                                  maxlen: Optional[int] = None) -> torch.Tensor:
        steps = self.maxlen if maxlen is None else maxlen
        B, dev = enc_output.shape[0], enc_output.device
        L = steps + 1
        enc_kv = self.compute_cross_kv(enc_output)
        ys = torch.full((B, L), SOS_ID, dtype=torch.int64, device=dev)
        for step in range(steps):
            h = self._stack(self._embed(ys), enc_kv, None,
                            self._prefix_bias(L, step, dev), None)
            ys[:, step + 1] = self._project(h)[:, step].argmax(dim=-1)
        return ys

    # ------------------------------------------------------- KV-cached path
    def _embed_token(self, tok: torch.Tensor, step: int) -> torch.Tensor:
        """tok (B,) ids at position ``step`` -> (B, 1, d_model)."""
        emb = F.embedding(tok[:, None], self.tgt_word_emb.weight.to(self.dtype))
        return emb * self.x_logit_scale + self.pe[step:step + 1][None].to(self.dtype)

    def decode_step_cached(self, tok: torch.Tensor, cache, enc_kv, step: int):
        """One cached autoregressive step.  tok: (B,) ids at position
        ``step``; cache: per layer (k_cache, v_cache), flat (B, L, h*d), slot
        ``step`` written in place.  Returns (f32 logits (B, V) for position
        ``step``, cache)."""
        h = self._embed_token(tok, step)
        new_cache = []
        for (slf, cross, ffn), (k2, v2), (kc, vc) in zip(self._layers(), enc_kv,
                                                         cache):
            h, kc, vc = slf.decode_step(h, kc, vc, step)
            new_cache.append((kc, vc))
            h = ffn(cross(h, k2, v2))
        return self._project(h)[:, 0].to(torch.float32), tuple(new_cache)

    def recognize_greedy_cached(self, enc_output: torch.Tensor,
                                maxlen: Optional[int] = None) -> torch.Tensor:
        steps = self.maxlen if maxlen is None else maxlen
        B, dev = enc_output.shape[0], enc_output.device
        L = steps + 1
        enc_kv = self.compute_cross_kv(enc_output)
        cache = make_uni_cache(B, L, self.n_layers, self.n_head * self.d_k,
                               self.n_head * self.d_v, self.dtype, dev)
        ys = torch.full((B, L), SOS_ID, dtype=torch.int64, device=dev)
        for step in range(steps):
            logits, cache = self.decode_step_cached(ys[:, step], cache, enc_kv,
                                                    step)
            ys[:, step + 1] = logits.argmax(dim=-1)
        return ys

    def step_logits(self, ys: torch.Tensor, enc_output: torch.Tensor,
                    step: int) -> torch.Tensor:
        """f32 logits for position ``step`` given token buffers ys (B, L):
        the building block of an external search loop."""
        return self.step_logits_cached(ys, self.compute_cross_kv(enc_output),
                                       step)

    def step_logits_cached(self, ys: torch.Tensor, enc_kv,
                           step: int) -> torch.Tensor:
        """``step_logits`` with precomputed cross-attention K/V."""
        L = ys.shape[1]
        h = self._stack(self._embed(ys), enc_kv, None,
                        self._prefix_bias(L, step, ys.device), None)
        return self._project(h[:, step:step + 1])[:, 0].to(torch.float32)
