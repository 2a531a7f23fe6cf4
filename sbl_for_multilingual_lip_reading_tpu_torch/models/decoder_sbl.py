"""Synchronous bidirectional (L2R + R2L) decoder: greedy decode and the
teacher-forced training forward (counterpart of the JAX package's
``models/decoder_sbl.py``).

The JAX ``lax.scan`` over decode steps becomes a Python loop, and its
``nn.remat`` of each step ``torch.utils.checkpoint`` (non-reentrant);
everything else follows the JAX module:

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
  widths the JAX scan segments use (and ``utils/flops.py`` accounts for);
* training: scheduled teacher forcing with ONE coin per step, shared by the
  batch and both directions; the next token is ``torch.where(coin, gold,
  argmax)``, the coin a bool on the device (drawn with the step's other
  random numbers), so the host never reads it inside the step.

Random numbers under checkpointing: ``torch.utils.checkpoint`` restores the
default RNG's state for its recompute, not an explicit generator's.  So
every random input of a decode step is fixed outside the checkpointed call:
the step gets one key (``DropoutRNG.child``: its block of the train
step's rows of random numbers), drawn beforehand from the forward's
``DropoutRNG``, and rebuilds its own ``DropoutRNG`` from it, which draws the
same attention seeds and dropout masks in the recompute as in the forward
(from rows, a fresh generator seeded alike: a generator cannot be reseeded
inside a CUDA graph's capture).  The JAX
decoder vmaps each layer over the direction axis with one dropout key per
direction; here both directions fold into one launch of 2B rows, and the
batch row in the kernels' Philox counter (and the (2, B, ...) shape of the
elementwise masks) gives each direction its own mask.

``grad_accum_bf16`` (JAX's field of the same name, off by default): while
gradients are taken, each decode segment runs its steps on bf16 copies of
the step's f32 parameters, made once at the segment's start (embedding,
every layer's projections, FFN and LayerNorms, the output heads; not the
hoisted ``cross_kv``), through ``torch.func.functional_call``; a
checkpointed step takes them as inputs.  So the steps' gradients of a
parameter sum in bf16, in autograd's buffer of the copy, last step first
as JAX's scan backward sums them, and the cast back to f32 adds the
segments in f32.  The LayerNorm weights are rounded to bf16 as in JAX.  A
forward without autograd (evaluation, K11) runs on the f32 parameters.

Tensor parallelism (``parallel.shard_model``): each layer's attention and
FFN shard on the trailing dims of their direction-stacked weights, as JAX's
``param_spec`` right-aligns its rules.  K11 (``use_fused_decoder_layer``)
takes a whole layer: under tensor parallelism the decoder runs whole in
eval, its weights gathered over the model group once a batch
(``layers.cast_dense_weights``, or ``_run`` itself), and each process runs
the kernel on the whole layer; training keeps the sharded module path.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops import masks as M
from ..ops.attention import mask_to_bias
from ..ops.decoder_layer import (fused_decoder_layer, fused_decoder_layer_plain,
                                 layer_params_to_args)
from ..utils.profiler import span
from ..vocab import EOS_ID, IGNORE_ID, SOS_ID
from .layers import (CachedCrossAttention, CrossKV, Dense, DropoutRNG,
                     MultiHeadAttention, PositionwiseFeedForward, dropout,
                     run_whole, sinusoid_position_encoding)

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
    + FFN, with weights (2, ...).  With ``use_fused_layer`` a deterministic
    call goes through kernel K11 (``ops/decoder_layer.py``), all three
    sublayers and both directions in one launch; a training call keeps the
    module composition (dropout, autograd)."""

    def __init__(self, d_model: int, n_head: int, d_k: int, d_v: int,
                 d_inner: int, dtype=torch.float32, use_kernels: bool = True,
                 dropout: float = 0.1, use_fused_layer: bool = False):
        super().__init__()
        self.d_model, self.n_head, self.d_k, self.d_v = d_model, n_head, d_k, d_v
        self.use_kernels, self.use_fused_layer = use_kernels, use_fused_layer
        kw = dict(dirs=DIRS, dropout=dropout)
        self.slf = MultiHeadAttention(d_model, n_head, d_k, d_v, dtype,
                                      use_kernels, **kw)
        self.cross = CachedCrossAttention(d_model, n_head, d_k, d_v, dtype,
                                          use_kernels, **kw)
        self.ffn = PositionwiseFeedForward(d_model, d_inner, dtype, **kw)

    def _fused_eligible(self, rng) -> bool:
        """JAX ``_SBLLayer._fused_eligible``: the switch, a deterministic
        call, d_k == d_v, and heads that fill the model width (the kernel
        packs the biases and LayerNorm vectors into one (13, d_model) tile
        and writes the (n_head * d_v)-wide context into the d_model-wide
        residual stream).  ``n_head`` is the model's, whatever the
        sublayers hold under tensor parallelism: a sharded layer here
        fails K11's shape check rather than leaving the kernel."""
        return (self.use_fused_layer and rng is None and self.d_k == self.d_v
                and self.n_head * self.d_k == self.d_model)

    def _fused(self, h, k2, v2, bias):
        if bias is not None:
            # the kernel takes one (L, L) bias for the whole batch; the SBL
            # step only builds batch-invariant causal/prefix masks, and a
            # per-sample padding mask would silently mis-mask here
            assert bias.shape[0] == 1, (
                "fused layer needs a batch-invariant self-attn mask; got "
                f"batch dim {bias.shape[0]} -- use the module path")
            bias = bias[0]
        fn = fused_decoder_layer if self.use_kernels else fused_decoder_layer_plain
        return fn(h.contiguous(), *layer_params_to_args(self),
                  k2.contiguous(), v2.contiguous(), self.n_head, mask_bias=bias)

    def forward(self, h, k2, v2, bias, rng=None):
        if self._fused_eligible(rng):
            return self._fused(h, k2, v2, bias)
        h = self.slf(h, h, h, bias=bias, rng=rng)
        h = self.cross(h, k2, v2, rng=rng)
        return self.ffn(h, rng)


class _SBLStep(nn.Module):
    """One decode step over both directions: embedding (shared by the two
    directions) + PE + dropout, the layer stack with fusion after every
    layer, and the untied per-direction output heads read at ``step``."""

    def __init__(self, vocab_size: int, d_model: int, n_layers: int,
                 n_head: int, d_k: int, d_v: int, d_inner: int,
                 pe_maxlen: int, fusion_mode: str, dtype=torch.float32,
                 use_kernels: bool = True, dropout: float = 0.1,
                 use_fused_layer: bool = False):
        super().__init__()
        if fusion_mode not in ("symmetric", "reference_aliased"):
            raise ValueError(f"unknown fusion_mode: {fusion_mode}")
        self.n_layers, self.fusion_mode, self.dtype = n_layers, fusion_mode, dtype
        self.dropout = dropout
        self.tgt_word_emb = nn.Embedding(vocab_size, d_model)
        self.register_buffer("pe", sinusoid_position_encoding(pe_maxlen, d_model),
                             persistent=False)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", _SBLLayer(
                d_model, n_head, d_k, d_v, d_inner, dtype, use_kernels, dropout,
                use_fused_layer))
        self.tgt_word_prj = Dense(d_model, vocab_size, bias=False, dirs=DIRS,
                                  dtype=dtype)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        w = torch.empty(self.tgt_word_emb.weight.shape)
        nn.init.xavier_uniform_(w, generator=g)
        self.tgt_word_emb.weight.copy_(w)

    def forward(self, ys: torch.Tensor, enc_kv, step: int,
                key=None, rows=None) -> torch.Tensor:
        """ys: (2, B, L) token buffers; enc_kv: per layer (k2, v2), each
        (2, B, Tk, H*d); key: None for a deterministic step, else the key
        of the step's random numbers (``DropoutRNG.child``; ``rows``: the
        ``DropoutRNG``'s batch rows).  Returns the (2, B, V) f32 logits at
        ``step``."""
        L = ys.shape[-1]
        dev = ys.device
        rng = None if key is None else DropoutRNG(key[0], dev, rows, key[1])
        # the table is cast where it is used (flax Embed with dtype=); the
        # PE is added in the compute dtype (JAX decoder_sbl.py:217-219)
        emb = F.embedding(ys, self.tgt_word_emb.weight.to(self.dtype))
        h = dropout(emb + self.pe[:L].to(self.dtype), self.dropout, rng,
                    batch_dim=1)
        beyond = (torch.arange(L, device=dev) > step)[None, None, :]
        first_bias = mask_to_bias(M.causal_mask(L, dev)[None] | beyond, L, L)
        stack_bias = mask_to_bias(beyond, L, L)
        rev_idx = _rev_index(L, step, dev)
        for i in range(self.n_layers):
            k2, v2 = enc_kv[i]
            h = getattr(self, f"layer_{i}")(
                h, k2, v2, first_bias if i == 0 else stack_bias, rng)
            h = _fuse_dual(h, rev_idx, self.fusion_mode)
        return self.tgt_word_prj(h[:, :, step]).to(torch.float32)


class SBLDecoder(nn.Module):
    """Synchronous bidirectional decoder: greedy ``decode`` and the
    teacher-forced training ``forward``."""

    def __init__(self, vocab_size: int = 58, d_model: int = 512,
                 n_layers: int = 6, n_head: int = 8, d_k: int = 64,
                 d_v: int = 64, d_inner: int = 2048, pe_maxlen: int = 5000,
                 maxlen: int = 16, fusion_mode: str = "symmetric",
                 decode_segments: int = 4, dtype=torch.float32,
                 use_kernels: bool = True, dropout: float = 0.1,
                 teacher_forcing_rate: float = 0.5, remat: bool = True,
                 use_fused_layer: bool = False, grad_accum_bf16: bool = False):
        super().__init__()
        self.maxlen, self.decode_segments = maxlen, decode_segments
        self.use_fused_layer = use_fused_layer
        self.grad_accum_bf16 = grad_accum_bf16
        self.n_layers, self.dtype, self.vocab_size = n_layers, dtype, vocab_size
        self.teacher_forcing_rate, self.remat = teacher_forcing_rate, remat
        self.step = _SBLStep(vocab_size, d_model, n_layers, n_head, d_k, d_v,
                             d_inner, pe_maxlen, fusion_mode, dtype, use_kernels,
                             dropout, use_fused_layer)
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

    def step_logits_cached(self, ys_l2r: torch.Tensor, ys_r2l: torch.Tensor,
                           enc_kv, step: int):
        """Both directions' f32 logits (N, V) at position ``step`` given
        paired token buffers (N, L) and precomputed cross K/V: the building
        block of the bidirectional beam search.  Runs the decode loop's own
        step module, deterministically, and writes no token."""
        lg = self.step(torch.stack([ys_l2r, ys_r2l]), enc_kv, int(step), None)
        return lg[0], lg[1]

    def _run(self, enc_output: torch.Tensor, gold: Optional[torch.Tensor],
             use_gold: Sequence[torch.Tensor], rng: Optional[DropoutRNG]):
        """The decode loop (JAX ``SBLDecoder._run``).  gold: (2, B, maxlen)
        and use_gold maxlen 0-dim bool tensors on its device, or None and
        None for the greedy decode.  Returns the token buffers (2, B,
        maxlen+1) and the f32 logits (2, B, maxlen, V)."""
        whole = [] if rng is not None else [
            m for m in self.modules() if getattr(m, "whole_in_eval", False)]
        if whole:
            # K11 under tensor parallelism: the whole decoder (nothing to
            # gather inside cast_dense_weights, which gathered it already)
            with torch.no_grad(), run_whole(whole):
                return self._loop(enc_output, gold, use_gold, None)
        return self._loop(enc_output, gold, use_gold, rng)

    def _bf16_step_params(self):
        """bf16 copies of the decode step's f32 parameters (JAX's
        ``map_variables`` ``to_bf16``), by name."""
        return {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p
                for n, p in self.step.named_parameters()}

    def _run_step(self, params, *args):
        """The decode step on its own parameters, or on ``params``."""
        if params is None:
            return self.step(*args)
        return functional_call(self.step, params, args)

    def _loop(self, enc_output, gold, use_gold, rng):
        B = enc_output.shape[0]
        ys = torch.full((DIRS, B, self.maxlen + 1), SOS_ID, dtype=torch.int64,
                        device=enc_output.device)
        enc_kv = self.compute_cross_kv(enc_output)
        grad = torch.is_grad_enabled()
        logits = []
        for a, b in self._segments():
            params = (self._bf16_step_params()
                      if self.grad_accum_bf16 and grad else None)
            for step in range(a, b):
                with span("decode.step", pos=step):
                    args = (ys[:, :, :b + 1], enc_kv, step,
                            None if rng is None else rng.child(),
                            None if rng is None else rng.rows)
                    if self.remat and grad:
                        lg = checkpoint(self._run_step, params, *args,
                                        use_reentrant=False,
                                        preserve_rng_state=False)
                    else:
                        lg = self._run_step(params, *args)
                    nxt = lg.detach().argmax(-1)
                    if gold is not None:
                        nxt = torch.where(use_gold[step], gold[:, :, step], nxt)
                    # a new buffer: the embedding (and a checkpoint) keep
                    # this step's view of the old one for the backward
                    ys = ys.clone()
                    ys[:, :, step + 1] = nxt
                    logits.append(lg)
        return ys, torch.stack(logits, dim=2)

    def forward(self, enc_output: torch.Tensor, labels_l2r: torch.Tensor,
                labels_r2l: torch.Tensor, rng: Optional[DropoutRNG] = None,
                use_gold: Optional[Sequence[bool]] = None):
        """Training forward (JAX ``SBLDecoder.__call__``).  labels_*: (B, P)
        IGNORE_ID-padded targets.  With ``rng`` the step is stochastic:
        dropout, and one teacher-forcing coin per step drawn from it unless
        ``use_gold`` (maxlen bools) is given; without, it decodes greedily.
        Returns (pred_l2r, gold_l2r, pred_r2l, gold_r2l): f32 logits
        (B, maxlen, V) and eos-padded gold (B, maxlen)."""
        gold = torch.stack([preprocess_targets(labels_l2r, self.maxlen),
                            preprocess_targets(labels_r2l, self.maxlen)])
        if use_gold is None:
            use_gold = ([False] * self.maxlen if rng is None else
                        rng.coins(self.maxlen, self.teacher_forcing_rate))
        if len(use_gold) != self.maxlen:
            raise ValueError(f"use_gold needs {self.maxlen} coins, got "
                             f"{len(use_gold)}")
        if not all(torch.is_tensor(c) for c in use_gold):
            # injected bools: one upload
            use_gold = torch.tensor([bool(c) for c in use_gold],
                                    device=gold.device).unbind(0)
        _, lg = self._run(enc_output, gold, use_gold, rng)
        return lg[0], gold[0], lg[1], gold[1]

    def decode(self, enc_output: torch.Tensor):
        """Greedy decode.  Returns (ys_l2r, ys_r2l, logits_l2r, logits_r2l):
        token ids (B, maxlen+1) with the leading sos, and f32 logits
        (B, maxlen, V) of every step."""
        with span("decode"):
            ys, lg = self._run(enc_output, None, None, None)
        return ys[0], ys[1], lg[0], lg[1]

    def recognize(self, enc_output: torch.Tensor):
        """Greedy decode; returns (ys_l2r, ys_r2l), (B, maxlen+1) ids."""
        ys_l2r, ys_r2l, _, _ = self.decode(enc_output)
        return ys_l2r, ys_r2l
