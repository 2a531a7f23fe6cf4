"""The Auto-AVSR visual speech recognition model (Ma et al., "Auto-AVSR:
Audio-Visual Speech Recognition with Automatic Labels", ICASSP 2023; the
``E2E`` model of its ``espnet/nets/pytorch_backend/e2e_asr_conformer.py``),
the port's ``ctc_attention`` kind.  Evaluation only.

    (B, T, 88, 88) frames -> the ResNet-18 frontend with Swish
    (``models/frontend.py``) -> (B, T, 512)
    -> Linear(512 -> d) x sqrt(d), ESPnet's relative positional encoding
       (2T - 1 positions)
    -> N Conformer blocks -> LayerNorm                        (the encoder)
    -> CTC head: Linear(d -> V), log-softmax over each frame  (the CTC branch)
    -> 6 pre-LN decoder layers over the encoder's output      (the decoder)

A Conformer block (macaron, pre-LN, ESPnet's ``EncoderLayer``):

    x += FFN(LN(x)) / 2;  x += RelMHA(LN(x));  x += Conv(LN(x));
    x += FFN(LN(x)) / 2;  x = LN(x)

FFN is Linear -> Swish -> Linear.  RelMHA's scores are
((q + u) k^T + rel_shift((q + v) p^T)) / sqrt(d_k), where p is the
bias-free ``linear_pos`` of the positional table and u, v are learned per
head: the positional term and the key-padding mask go to K12
(``ops/attention.py::fused_mha``) as its per-head f32 bias, beside
(q + u), k and v in the head-major layout.  Conv is pointwise d -> 2d, GLU,
a depthwise conv of ``cnn_module_kernel`` taps, BatchNorm, Swish,
pointwise d -> d; the frames past an utterance's length are zeroed before
the depthwise conv, so that an answer does not depend on its batch-mates.

The decoder (ESPnet's transformer ``Decoder``, pre-LN): an embedding x
sqrt(d) plus the sinusoidal table, then per layer x += SelfAttn(LN(x)),
x += SrcAttn(LN(x), memory), x += FFN(LN(x)) with ReLU, then a LayerNorm
and an untied ``output_layer``.  It runs one cached step at a time
(``decode_step_cached``): the self-attention on ``make_uni_cache``'s caches
(``MultiHeadAttention.decode_step``), the memory's K/V projected once per
utterance (``CrossKV``), the cross-attention of a beam's K hypotheses as K
query rows of their utterance on K1 (``CachedCrossAttention``), which reads
the memory once per utterance.

Numerics: parameters f32, products in the compute dtype (bf16), the
residual stream, LayerNorm (ESPnet's eps 1e-12), softmax and BatchNorm in
f32; the CTC head's product is f32 on the compute-dtype operands.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import MASK_FILL, fused_mha, fused_mha_plain
from ..ops.resblock import fold_bn
from ..utils.profiler import span
from .frontend import BatchNorm, VisualFrontend
from .layers import (CachedCrossAttention, CrossKV, Dense, LayerNorm,
                     MultiHeadAttention, sinusoid_position_encoding)


def rel_positional_encoding(max_len: int, d_model: int) -> torch.Tensor:
    """ESPnet's ``RelPositionalEncoding`` table for up to ``max_len``
    frames: (2 max_len - 1, d_model) f32, row k holding relative position
    max_len - 1 - k (the positive positions first), sin on the even
    channels and cos on the odd ones."""
    pos = np.arange(max_len - 1, -max_len, -1, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * -(np.log(10000.0) / d_model))
    pe = np.zeros((2 * max_len - 1, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


def rel_shift(bd: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T - 1) scores against relative positions T-1 .. -(T-1)
    -> (B, H, T, T), out[..., i, j] = bd[..., i, T - 1 - i + j] (the
    position i - j): ESPnet's ``rel_shift`` as a strided view, no copy."""
    B, H, T, W = bd.shape
    bd = bd.contiguous()
    return bd.as_strided((B, H, T, T), (H * T * W, T * W, W - 1, 1),
                         bd.storage_offset() + T - 1)


class FeedForward(nn.Module):
    """w_2(act(w_1(x))): Swish in the Conformer blocks, ReLU in the
    decoder."""

    def __init__(self, d_model: int, d_inner: int, dtype, swish: bool):
        super().__init__()
        self.swish = swish
        self.w_1 = Dense(d_model, d_inner, dtype=dtype)
        self.w_2 = Dense(d_inner, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.w_1(x)
        return self.w_2(F.silu(h) if self.swish else F.relu(h))


class RelPositionMultiHeadAttention(nn.Module):
    """ESPnet's ``RelPositionMultiHeadedAttention`` (the 2T - 1 variant)
    on K12."""

    def __init__(self, d_model: int, n_head: int, d_k: int, dtype,
                 use_kernels: bool = True):
        super().__init__()
        self.n_head, self.d_k, self.dtype = n_head, d_k, dtype
        self.use_kernels = use_kernels
        self.scale = 1.0 / math.sqrt(d_k)
        width = n_head * d_k
        self.linear_q = Dense(d_model, width, dtype=dtype)
        self.linear_k = Dense(d_model, width, dtype=dtype)
        self.linear_v = Dense(d_model, width, dtype=dtype)
        self.linear_out = Dense(width, d_model, dtype=dtype)
        self.linear_pos = Dense(d_model, width, bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(n_head, d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(n_head, d_k))

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        for p in (self.pos_bias_u, self.pos_bias_v):
            w = torch.empty(p.shape)
            nn.init.xavier_uniform_(w, generator=g)
            p.copy_(w)

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                key_bias: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, T, d_model) in the compute dtype; pos_emb (2T - 1,
        d_model); key_bias None or (B, 1, 1, T) f32, MASK_FILL at padded
        keys."""
        B, T, _ = x.shape
        H, d = self.n_head, self.d_k

        def heads(t):
            return t.view(B, T, H, d).transpose(1, 2).contiguous()

        q = self.linear_q(x).view(B, T, H, d).to(torch.float32)
        k, v = heads(self.linear_k(x)), heads(self.linear_v(x))
        p = self.linear_pos(pos_emb).view(2 * T - 1, H, d).permute(1, 2, 0)
        qu = (q + self.pos_bias_u).to(self.dtype).transpose(1, 2).contiguous()
        qv = (q + self.pos_bias_v).transpose(1, 2)
        # the positional term, f32, and the mask: K12's per-head bias
        bd = rel_shift(torch.matmul(qv, p.to(torch.float32)))
        bias = (bd * self.scale if key_bias is None
                else torch.add(key_bias, bd, alpha=self.scale)).contiguous()
        attn = fused_mha if self.use_kernels else fused_mha_plain
        ctx = attn(qu, k, v, bias, self.scale)
        return self.linear_out(ctx.transpose(1, 2).reshape(B, T, H * d))


class ConvolutionModule(nn.Module):
    """ESPnet's ``ConvolutionModule``: pointwise d -> 2d, GLU, depthwise
    conv, BatchNorm (running statistics), Swish, pointwise d -> d; the
    pointwise convs as ``Dense`` layers on (B, T, d)."""

    def __init__(self, d_model: int, kernel: int, dtype, bn_eps: float = 1e-5):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError(f"cnn_module_kernel {kernel}: an odd width")
        self.dtype = dtype
        self.pointwise_conv1 = Dense(d_model, 2 * d_model, dtype=dtype)
        self.depthwise_conv = nn.Conv1d(d_model, d_model, kernel,
                                        padding=(kernel - 1) // 2,
                                        groups=d_model, bias=True)
        self.bn = BatchNorm(d_model, eps=bn_eps)
        self.pointwise_conv2 = Dense(d_model, d_model, dtype=dtype)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        """torch's Conv1d init (uniform, 1 / sqrt(fan in) for the weight
        after kaiming's a = sqrt(5), and the bias) drawn from ``g``."""
        conv = self.depthwise_conv
        bound = 1.0 / math.sqrt(conv.weight.shape[1] * conv.weight.shape[2])
        for p in (conv.weight, conv.bias):
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))

    def forward(self, x: torch.Tensor,
                valid: Optional[torch.Tensor]) -> torch.Tensor:
        """x (B, T, d_model); valid None or (B, T, 1) bool."""
        h = F.glu(self.pointwise_conv1(x), dim=-1)
        if valid is not None:
            h = h.masked_fill(~valid, 0.0)
        conv = self.depthwise_conv
        h = F.conv1d(h.transpose(1, 2), conv.weight.to(self.dtype),
                     conv.bias.to(self.dtype), padding=conv.padding,
                     groups=conv.groups)
        bn = self.bn
        a, b = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        h = F.silu(torch.addcmul(b[:, None], h.to(torch.float32), a[:, None]))
        return self.pointwise_conv2(h.to(self.dtype).transpose(1, 2))


class ConformerBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, d_k: int, d_inner: int,
                 kernel: int, eps: float, dtype, use_kernels: bool = True):
        super().__init__()
        self.dtype = dtype
        self.feed_forward_macaron = FeedForward(d_model, d_inner, dtype, True)
        self.self_attn = RelPositionMultiHeadAttention(d_model, n_head, d_k,
                                                       dtype, use_kernels)
        self.conv_module = ConvolutionModule(d_model, kernel, dtype)
        self.feed_forward = FeedForward(d_model, d_inner, dtype, True)
        for name in ("ff_macaron", "mha", "conv", "ff", "final"):
            self.add_module(f"layer_norm_{name}", LayerNorm(d_model, eps=eps))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                key_bias: Optional[torch.Tensor],
                valid: Optional[torch.Tensor]) -> torch.Tensor:
        """x: the f32 residual stream (B, T, d_model)."""
        dt = self.dtype
        x = torch.add(x, self.feed_forward_macaron(
            self.layer_norm_ff_macaron(x).to(dt)), alpha=0.5)
        x = x + self.self_attn(self.layer_norm_mha(x).to(dt), pos_emb, key_bias)
        x = x + self.conv_module(self.layer_norm_conv(x).to(dt), valid)
        x = torch.add(x, self.feed_forward(self.layer_norm_ff(x).to(dt)), alpha=0.5)
        return self.layer_norm_final(x)


class ConformerEncoder(nn.Module):
    """(B, T, d_input) frontend features and optional (B,) lengths ->
    (B, T, d_model) in the compute dtype.  ``max_frames`` sizes the
    positional table."""

    def __init__(self, d_input: int, d_model: int, n_layers: int, n_head: int,
                 d_k: int, d_inner: int, kernel: int, eps: float,
                 max_frames: int, dtype, use_kernels: bool = True):
        super().__init__()
        self.d_model, self.n_layers, self.dtype = d_model, n_layers, dtype
        self.max_frames = max_frames
        self.embed = Dense(d_input, d_model, dtype=dtype)
        self.register_buffer("rel_pe", rel_positional_encoding(max_frames, d_model),
                             persistent=False)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", ConformerBlock(
                d_model, n_head, d_k, d_inner, kernel, eps, dtype, use_kernels))
        self.after_layer_norm = LayerNorm(d_model, eps=eps)

    def pos_emb(self, T: int) -> torch.Tensor:
        if T > self.max_frames:
            raise ValueError(f"{T} frames: the encoder takes at most "
                             f"{self.max_frames} (the config's data.frames)")
        c = self.max_frames - 1
        return self.rel_pe[c - (T - 1):c + T].to(self.dtype)

    def forward(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        h = self.embed(x.to(self.dtype)).to(torch.float32) * math.sqrt(self.d_model)
        pos_emb = self.pos_emb(T)
        key_bias = valid = None
        if lengths is not None:
            ok = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
            key_bias = torch.where(ok, 0.0, MASK_FILL).to(torch.float32)[:, None, None, :]
            valid = ok[..., None]
        for i in range(self.n_layers):
            with span("conformer.layer", layer=i):
                h = getattr(self, f"layer_{i}")(h, pos_emb, key_bias, valid)
        return self.after_layer_norm(h).to(self.dtype)


class CTCHead(nn.Module):
    """ESPnet's ``CTC``: ``ctc_lo`` Linear(d_model -> V), log-softmax."""

    def __init__(self, d_model: int, vocab_size: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.ctc_lo = Dense(d_model, vocab_size, dtype=dtype)

    def log_probs(self, enc: torch.Tensor) -> torch.Tensor:
        """(B, T, d_model) -> (B, T, V) f32: an f32 product of the
        compute-dtype operands, then the log-softmax in f32."""
        w, b = self.ctc_lo.cast or self.ctc_lo.cast_params()
        f32 = torch.float32
        logits = torch.addmm(b.to(f32), enc.reshape(-1, enc.shape[-1]).to(f32),
                             w.to(f32).t())
        return torch.log_softmax(logits, dim=-1).view(*enc.shape[:-1], -1)


class DecoderLayer(nn.Module):
    """ESPnet's pre-LN ``DecoderLayer``: self-attention, source attention
    (its K/V projections split out as ``cross_kv``), FFN with ReLU."""

    def __init__(self, d_model: int, n_head: int, d_k: int, d_inner: int,
                 eps: float, dtype, use_kernels: bool = True):
        super().__init__()
        kw = dict(dtype=dtype, use_kernels=use_kernels, dropout=0.0, post_ln=False)
        self.self_attn = MultiHeadAttention(d_model, n_head, d_k, d_k, **kw)
        self.src_attn = CachedCrossAttention(d_model, n_head, d_k, d_k, **kw)
        self.cross_kv = CrossKV(d_model, n_head, d_k, d_k, dtype)
        self.feed_forward = FeedForward(d_model, d_inner, dtype, False)
        for i in (1, 2, 3):
            self.add_module(f"layer_norm{i}", LayerNorm(d_model, eps=eps))


class AttentionDecoder(nn.Module):
    """ESPnet's transformer ``Decoder`` (pre-LN, untied output layer), run
    one cached step at a time."""

    def __init__(self, vocab_size: int, d_model: int, n_layers: int,
                 n_head: int, d_k: int, d_inner: int, eps: float, maxlen: int,
                 dtype, use_kernels: bool = True):
        super().__init__()
        self.vocab_size, self.d_model, self.n_layers = vocab_size, d_model, n_layers
        self.n_head, self.d_k, self.maxlen, self.dtype = n_head, d_k, maxlen, dtype
        self.embed = nn.Embedding(vocab_size, d_model)
        self.register_buffer("pe", sinusoid_position_encoding(maxlen + 1, d_model),
                             persistent=False)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", DecoderLayer(d_model, n_head, d_k, d_inner,
                                                       eps, dtype, use_kernels))
        self.after_layer_norm = LayerNorm(d_model, eps=eps)
        self.output_layer = Dense(d_model, vocab_size, dtype=dtype)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        w = torch.empty(self.embed.weight.shape)
        nn.init.normal_(w, generator=g)
        self.embed.weight.copy_(w)

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.n_layers)]

    def cache_widths(self) -> Tuple[int, int]:
        return self.n_head * self.d_k, self.n_head * self.d_k

    def compute_cross_kv(self, memory: torch.Tensor):
        """Per layer (k2, v2), each (B, T, H*d): once per utterance."""
        memory = memory.to(self.dtype)
        return tuple(layer.cross_kv(memory) for layer in self.layers())

    def decode_step_cached(self, tok: torch.Tensor, cache, enc_kv, step: int,
                           memory_bias: Optional[torch.Tensor] = None):
        """One cached step for N = B x K hypotheses, utterance-major (row
        b * K + k: hypothesis k of utterance b).  tok (N,) ids at position
        ``step``; cache: ``make_uni_cache(N, ...)``, slot ``step`` written
        in place; enc_kv: ``compute_cross_kv`` of the B utterances;
        memory_bias None or (B, K, T) f32, MASK_FILL at padded frames.
        Returns (f32 logits (N, V) for position ``step``, cache)."""
        N = tok.shape[0]
        B = enc_kv[0][0].shape[0]
        K = N // B
        dt, d = self.dtype, self.d_model
        x = (F.embedding(tok, self.embed.weight) * math.sqrt(d)
             + self.pe[step])[:, None]                             # (N, 1, d) f32
        new_cache = []
        for layer, (k2, v2), (kc, vc) in zip(self.layers(), enc_kv, cache):
            a, kc, vc = layer.self_attn.decode_step(layer.layer_norm1(x).to(dt),
                                                    kc, vc, step)
            new_cache.append((kc, vc))
            x = x + a
            q = layer.layer_norm2(x).to(dt).view(B, K, d)
            x = x + layer.src_attn(q, k2, v2, bias=memory_bias).view(N, 1, d)
            x = x + layer.feed_forward(layer.layer_norm3(x).to(dt))
        h = self.after_layer_norm(x).to(dt)
        return self.output_layer(h)[:, 0].to(torch.float32), tuple(new_cache)


class CTCAttentionTransformer(nn.Module):
    """Frontend, Conformer encoder, CTC head and attention decoder; the
    search is ``decode.beam.make_ctc_attention_beam_decoder``."""

    def __init__(self, frontend: VisualFrontend, encoder: ConformerEncoder,
                 ctc: CTCHead, decoder: AttentionDecoder, blank_id: int = 0):
        super().__init__()
        self.frontend, self.encoder, self.ctc, self.decoder = frontend, encoder, ctc, decoder
        self.blank_id = blank_id
        self.eos_id = self.sos_id = decoder.vocab_size - 1

    def encode(self, video: torch.Tensor,
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """video (B, T, H, W) normalised frames, zero past each utterance's
        length; lengths None (all T frames) or (B,) -> (B, T, d_model)."""
        with span("frontend"):
            x = self.frontend(video)
        with span("encoder"):
            return self.encoder(x, lengths)

    def ctc_log_probs(self, enc: torch.Tensor) -> torch.Tensor:
        with span("ctc.head"):
            return self.ctc.log_probs(enc)


def ctc_attention_from_config(cfg, frontend: VisualFrontend, dtype,
                              use_kernels: bool = True) -> CTCAttentionTransformer:
    dims, dec, cc = cfg.dims, cfg.decoder, cfg.conformer
    if dims.d_k != dims.d_v or dims.n_head * dims.d_k != dims.d_model:
        raise ValueError(f"d_model {dims.d_model}: n_head x d_k with d_k == d_v")
    encoder = ConformerEncoder(cfg.frontend.feature_dim, dims.d_model, dims.n_enc_layers,
                               dims.n_head, dims.d_k, dims.d_inner, cc.cnn_module_kernel,
                               cc.layer_norm_eps, cfg.data.frames, dtype, use_kernels)
    ctc = CTCHead(dims.d_model, dec.vocab_size, dtype)
    decoder = AttentionDecoder(dec.vocab_size, dims.d_model, dims.n_dec_layers,
                               dims.n_head, dims.d_k, dims.d_inner, cc.layer_norm_eps,
                               dec.maxlen, dtype, use_kernels)
    return CTCAttentionTransformer(frontend, encoder, ctc, decoder, cc.blank_id)
