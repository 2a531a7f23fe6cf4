"""Plain PyTorch reference of the lip-reading models the benchmark serves.

Written from the architecture's equations (the SBL paper and its reference
repository: Conv3D stem + ResNet-18 frontend, a post-LN transformer
encoder, the synchronous bidirectional decoder with hidden-state fusion
after every layer, and the unidirectional tied decoder of the LRW-1000
project), in float32 with TF32 off, with no kernel, no cache, no segment
padding and no batching trick.  It imports nothing of the program it
judges: it reads a dict of float32 tensors, the weights the benchmark made
from the seed, under the names of the program's ``state_dict``.

``prec="fp8"`` is the control: every operand of a convolution or a matrix
product is rounded to float8 e4m3 (one scale per tensor, its largest
magnitude at 448) before the product, which runs in float32.  Softmax,
LayerNorm and BatchNorm stay float32.

Departures from the reference repository, each the program's as well:
LayerNorm eps 1e-6 (flax's), BatchNorm on running statistics in eval,
attention projections with biases, the decoder's self-attention of layers
after the first unmasked inside the live prefix (the reference passes no
causal mask there).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
BN_EPS = 1e-5
MEAN, STD = 0.413621, 0.1700239      # ColorNormalize
FP8_MAX = 448.0
SOS, EOS = 0, 1


def no_tf32() -> None:
    """float32 products in float32 (the card otherwise may use TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q8(x: torch.Tensor, prec: str) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale per tensor (the
    control), or x itself."""
    if prec == "f32":
        return x
    if prec != "fp8":
        raise ValueError(f"unknown precision {prec!r}")
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    xq = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    # the rounding passes the gradient through unchanged (straight through)
    return x + (xq - x).detach()


def linear(x, w, b=None, prec="f32"):
    y = torch.matmul(q8(x, prec), q8(w, prec).t())
    return y if b is None else y + b


def matmul(a, b, prec="f32"):
    return torch.matmul(q8(a, prec), q8(b, prec))


def layer_norm(x, w, b):
    return F.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


def sinusoid(length: int, d: int, device) -> torch.Tensor:
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe = np.zeros((length, d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.tensor(pe, dtype=torch.float32, device=device)


class Weights:
    """Read access to the float32 weights by the program's names, each
    sliced to one direction of the bidirectional decoder where asked."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.t = tensors

    def __call__(self, name: str, direction: Optional[int] = None):
        w = self.t[name].to(torch.float32)
        return w if direction is None else w[direction]


# ------------------------------------------------------------- ingest, frontend
def ingest(clips_u8: torch.Tensor, crop: int) -> torch.Tensor:
    """(B, T, H, W) uint8 -> (B, T, crop, crop) float32: the test
    protocol's center crop and ColorNormalize."""
    H = clips_u8.shape[2]
    c = int(round((H - crop) / 2.0))
    x = clips_u8[:, :, c:c + crop, c:c + crop].to(torch.float32) / 255.0
    return (x - MEAN) / STD


def _bn(x, W, p):
    scale = W(p + ".weight") / torch.sqrt(W(p + ".running_var") + BN_EPS)
    shift = W(p + ".bias") - W(p + ".running_mean") * scale
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.view(shape) + shift.view(shape)


def _conv(x, w, stride, padding, prec):
    fn = F.conv3d if x.dim() == 5 else F.conv2d
    return fn(q8(x, prec), q8(w, prec), stride=stride, padding=padding)


def _block(x, W, p, stride, prec):
    y = F.relu(_bn(_conv(x, W(p + ".conv1.weight"), stride, 1, prec), W, p + ".bn1"))
    y = _bn(_conv(y, W(p + ".conv2.weight"), 1, 1, prec), W, p + ".bn2")
    key = p + ".downsample_conv.weight"
    res = x
    if key in W.t:
        res = _bn(_conv(x, W(key), stride, 0, prec), W, p + ".downsample_bn")
    return F.relu(y + res)


def frontend(video: torch.Tensor, W: Weights, cfg: dict, prec="f32") -> torch.Tensor:
    """(B, T, S, S) normalized frames -> (B, T, feature_dim): Conv3d
    (1 -> C, k (5, 7, 7), s (1, 2, 2), p (2, 3, 3)), BatchNorm, ReLU,
    MaxPool3d (1, 3, 3)/(1, 2, 2), then ResNet-18 per frame and the
    global average pool."""
    B, T = video.shape[:2]
    w = W("frontend.conv3d_weight")[:, None]           # (C, 1, 5, 7, 7)
    y = _conv(video[:, None], w, (1, 2, 2), (2, 3, 3), prec)
    y = F.relu(_bn(y, W, "frontend.bn3d"))                # (B, C, T, h, w)
    y = F.max_pool3d(y, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    C, h, w = y.shape[1], y.shape[3], y.shape[4]
    y = y.transpose(1, 2).reshape(B * T, C, h, w)
    for stage, blocks in enumerate(cfg["resnet_blocks"]):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            y = _block(y, W, f"frontend.resnet.layer{stage + 1}_block{b}",
                       stride, prec)
    return y.mean(dim=(2, 3)).reshape(B, T, -1)


# --------------------------------------------------------------------- encoder
def attention(q, k, v, n_head, causal, prec):
    """q (N, Tq, H*d), k/v (N, Tk, H*d) -> (N, Tq, H*d); softmax over the
    keys with scale 1/sqrt(d), the upper triangle masked where causal."""
    N, Tq, D = q.shape
    Tk = k.shape[1]
    d = D // n_head

    def heads(t):
        return t.reshape(N, t.shape[1], n_head, d).transpose(1, 2)

    s = matmul(heads(q), heads(k).transpose(-1, -2), prec) / math.sqrt(d)
    if causal:
        upper = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(upper, float("-inf"))
    ctx = matmul(torch.softmax(s, dim=-1), heads(v), prec)
    return ctx.transpose(1, 2).reshape(N, Tq, D)


def mha(x, kv, W, p, n_head, causal, prec, direction=None, kv_proj=None):
    """Post-LN multi-head attention: LN(fc(attn(x W_q, kv W_k, kv W_v)) + x).
    ``kv_proj``: already projected (k, v)."""
    def lin(name, t):
        return linear(t, W(f"{p}.{name}.weight", direction),
                      W(f"{p}.{name}.bias", direction), prec)
    k, v = kv_proj if kv_proj is not None else (lin("w_ks", kv), lin("w_vs", kv))
    ctx = attention(lin("w_qs", x), k, v, n_head, causal, prec)
    return layer_norm(lin("fc", ctx) + x, W(p + ".layer_norm.weight", direction),
                      W(p + ".layer_norm.bias", direction))


def ffn(x, W, p, prec, direction=None):
    def lin(name, t):
        return linear(t, W(f"{p}.{name}.weight", direction),
                      W(f"{p}.{name}.bias", direction), prec)
    h = lin("w_2", F.relu(lin("w_1", x)))
    return layer_norm(h + x, W(p + ".layer_norm.weight", direction),
                      W(p + ".layer_norm.bias", direction))


def encoder(feats, W, cfg, prec="f32"):
    T = feats.shape[1]
    h = linear(feats, W("encoder.linear_in.weight"), W("encoder.linear_in.bias"), prec)
    h = layer_norm(h, W("encoder.layer_norm_in.weight"), W("encoder.layer_norm_in.bias"))
    h = h + sinusoid(T, h.shape[-1], h.device)
    for i in range(cfg["n_enc_layers"]):
        p = f"encoder.layer_{i}"
        h = mha(h, h, W, p + ".slf_attn", cfg["n_head"], False, prec)
        h = ffn(h, W, p + ".pos_ffn", prec)
    return h


def encode(clips_u8, W, cfg, prec="f32"):
    """uint8 clips -> encoder output, the shared part of every model."""
    return encoder(frontend(ingest(clips_u8, cfg["crop_size"]), W, cfg, prec),
                   W, cfg, prec)


# ------------------------------------------------------------ the SBL decoder
def sbl_step_logits(ys: torch.Tensor, enc: torch.Tensor, W, cfg,
                    prec="f32") -> torch.Tensor:
    """ys (2, N, L) token prefixes of both directions (dir 0 left to
    right), enc (N, Tk, D) -> (2, N, V) logits of the token after position
    L - 1.  Every position of the prefix is computed afresh: the shared
    embedding + PE, then per layer each direction's self-attention (causal
    in the first layer only), cross-attention over the encoder output and
    FFN, and after each layer the fusion h_d + reverse(h_other)."""
    L = ys.shape[-1]
    emb = W("decoder.step.tgt_word_emb.weight")
    pe = sinusoid(L, emb.shape[1], ys.device)
    hs = [emb[ys[d]] + pe for d in range(2)]
    for i in range(cfg["n_dec_layers"]):
        p = f"decoder.step.layer_{i}"
        out = []
        for d in range(2):
            def lin(name, t):
                return linear(t, W(f"decoder.cross_kv_{i}.{name}.weight", d),
                              W(f"decoder.cross_kv_{i}.{name}.bias", d), prec)
            h = mha(hs[d], hs[d], W, p + ".slf", cfg["n_head"], i == 0, prec, d)
            h = mha(h, None, W, p + ".cross", cfg["n_head"], False, prec, d,
                    kv_proj=(lin("w_ks", enc), lin("w_vs", enc)))
            out.append(ffn(h, W, p + ".ffn", prec, d))
        hs = [out[0] + out[1].flip(1), out[1] + out[0].flip(1)]
    return torch.stack([linear(hs[d][:, -1], W("decoder.step.tgt_word_prj.weight", d),
                               None, prec) for d in range(2)])


def sbl_teacher_forced(ys: torch.Tensor, enc, W, cfg, prec="f32") -> torch.Tensor:
    """ys (2, N, maxlen+1) served tokens with the leading sos -> (2, N,
    maxlen, V): the reference's logits at every step, given the served
    tokens before it."""
    steps = ys.shape[-1] - 1
    return torch.stack([sbl_step_logits(ys[:, :, :s + 1], enc, W, cfg, prec)
                        for s in range(steps)], dim=2)


# ------------------------------------------------------ the unidirectional one
def uni_logits(ys: torch.Tensor, enc: torch.Tensor, W, cfg, prec="f32") -> torch.Tensor:
    """ys (N, L) input tokens (sos first), enc (N, Tk, D) -> (N, L, V)
    logits at every position: the tied decoder run causally over the
    whole prefix (embedding scaled by d^-1/2 + PE, causal self-attention,
    cross-attention, FFN; logits = h E^T)."""
    L = ys.shape[1]
    emb = W("decoder.tgt_word_emb.weight")
    d_model = emb.shape[1]
    h = emb[ys] * d_model ** -0.5 + sinusoid(L, d_model, ys.device)
    for i in range(cfg["n_dec_layers"]):
        h = mha(h, h, W, f"decoder.slf_attn_{i}", cfg["n_head"], True, prec)
        kv = [linear(enc, W(f"decoder.cross_kv_{i}.{n}.weight"),
                     W(f"decoder.cross_kv_{i}.{n}.bias"), prec) for n in ("w_ks", "w_vs")]
        h = mha(h, None, W, f"decoder.enc_attn_{i}", cfg["n_head"], False, prec,
                kv_proj=kv)
        h = ffn(h, W, f"decoder.pos_ffn_{i}", prec)
    return linear(h, emb, None, prec)


def beam_step_terms(tokens: torch.Tensor, logits: torch.Tensor,
                    bigram_logp: torch.Tensor) -> torch.Tensor:
    """Each step's term of a hypothesis's score under the search's rule:
    log softmax(logits)[next] + bigram_logp[last, next] until the
    hypothesis has emitted eos, 0 after.  tokens (N, L) with the leading
    sos, logits (N, L-1, V) at positions 0..L-2 -> (N, L-1) float32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nxt = tokens[:, 1:]
    last = tokens[:, :-1]
    step = logp.gather(-1, nxt[..., None])[..., 0] + bigram_logp[last, nxt]
    ended = torch.cumsum((last == EOS).to(torch.int64), dim=1) > 0
    return torch.where(ended, torch.zeros_like(step), step)


def beam_scores(tokens: torch.Tensor, logits: torch.Tensor,
                bigram_logp: torch.Tensor) -> torch.Tensor:
    """The score of each hypothesis (N,): the sum of its steps' terms
    (``beam_step_terms``)."""
    return beam_step_terms(tokens, logits, bigram_logp).sum(dim=1)


def frontier_gaps(tokens: torch.Tensor, logits: torch.Tensor,
                  bigram_logp: torch.Tensor) -> torch.Tensor:
    """How far the K returned hypotheses of each clip break the rule that
    every step keeps the K best continuations of the clip's whole
    frontier, read from the hypotheses alone.  tokens (n, K, L) with the
    leading sos, logits (n, K, L-1, V) at positions 0..L-2 -> (n, K, L-1):
    for the prefix of each hypothesis that step t + 1 kept, by how much its
    score lies below the K-th best of all continuations of the clip's
    returned prefixes at step t (0 where it does not).  Those prefixes are
    a part of the frontier the step expanded, so the K-th best of their
    continuations is at most the K-th best the step kept: a sound search
    breaks the rule by rounding alone."""
    n, K, L = tokens.shape
    V = logits.shape[-1]
    flat = tokens.reshape(n * K, L)
    terms = beam_step_terms(flat, logits.reshape(n * K, L - 1, V), bigram_logp)
    prefix = torch.cat([terms.new_zeros(n * K, 1), terms.cumsum(1)], 1).reshape(n, K, L)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    last = tokens[:, :, :-1]                                       # (n, K, L-1)
    child = prefix[:, :, :-1, None] + logp + bigram_logp[last]     # (n, K, L-1, V)
    carried = torch.full_like(child, float("-inf"))
    carried[..., EOS] = prefix[:, :, :-1]
    child = torch.where((last == EOS)[..., None], carried, child)
    # a prefix two hypotheses share is expanded once
    same = (tokens[:, :, None, :] == tokens[:, None, :, :]).to(torch.int64).cumprod(-1).bool()
    earlier = torch.ones(K, K, dtype=torch.bool, device=tokens.device).tril(-1)
    shared = (same[..., :-1] & earlier[None, :, :, None]).any(2)  # (n, K, L-1)
    child = child.masked_fill(shared[..., None], float("-inf"))
    pool = child.permute(0, 2, 1, 3).reshape(n, L - 1, K * V)
    kth = pool.topk(K, dim=-1).values[..., -1]                     # (n, L-1)
    return (kth[:, None, :] - prefix[:, :, 1:]).clamp(min=0)


def beam_search(enc: torch.Tensor, W, cfg, K: int, bigram_logp: torch.Tensor,
                prec="f32", frontier: bool = False):
    """The beam search of the LRW-1000 protocol, written plainly: enc (n,
    Tk, D) -> (tokens (n, K, maxlen+1) with the leading sos, scores (n,
    K)), best first.  The frontier starts from sos alone; each step every
    hypothesis that has not emitted eos is extended by every token, scored
    by log softmax of the decoder's logits (the whole prefix run again,
    ``uni_logits``) plus the bigram bias of its last token, while one that
    has is carried on with eos at no cost; the K best of all of these, over
    the whole frontier of the clip, survive.  With ``frontier`` also each
    step's last tokens (n, maxlen, K) and logits (n, maxlen, K, V) of the
    frontier it expanded (the lone first hypothesis repeated K times)."""
    n, V, steps = enc.shape[0], cfg["vocab_size"], cfg["maxlen"]
    tokens = torch.full((n, 1, 1), SOS, dtype=torch.int64, device=enc.device)
    scores = torch.zeros((n, 1), dtype=torch.float32, device=enc.device)
    seen = []
    for _ in range(steps):
        k, length = tokens.shape[1], tokens.shape[2]
        flat = tokens.reshape(n * k, length)
        logits = uni_logits(flat, enc.repeat_interleave(k, 0), W, cfg, prec)[:, -1]
        last = tokens[:, :, -1]
        seen.append((last.expand(n, K) if k == 1 else last,
                     logits.reshape(n, k, V).expand(n, K, V) if k == 1 else
                     logits.reshape(n, k, V)))
        step = torch.log_softmax(logits.to(torch.float32), -1).reshape(n, k, V)
        step = step + bigram_logp[last]
        done = last == EOS
        carried = torch.full_like(step, float("-inf"))
        carried[..., EOS] = 0.0
        cand = scores[..., None] + torch.where(done[..., None], carried, step)
        scores, idx = torch.topk(cand.reshape(n, k * V), min(K, k * V), dim=-1)
        parent, nxt = idx // V, idx % V
        tokens = torch.cat([torch.take_along_dim(tokens, parent[..., None], dim=1),
                            nxt[..., None]], dim=-1)
    if frontier:
        return (tokens, scores, torch.stack([t for t, _ in seen], 1),
                torch.stack([lg for _, lg in seen], 1))
    return tokens, scores
