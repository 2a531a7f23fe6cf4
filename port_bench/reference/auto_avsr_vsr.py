"""Plain PyTorch reference of the Auto-AVSR visual speech recognition model
(Ma et al., "Auto-AVSR: Audio-Visual Speech Recognition with Automatic
Labels", ICASSP 2023; the ``E2E`` model of github.com/mpc001/auto_avsr,
``espnet/nets/pytorch_backend/e2e_asr_conformer.py``).

Written from the architecture's equations, in float32 with TF32 off, with
no kernel, no cache and no batching trick: every utterance runs alone at
its own length.  It imports nothing of the program it judges and nothing
of JAX; it reads a dict of float32 tensors under the names of the
program's ``state_dict`` and a dict of sizes (a configuration file's
``model``).

    ingest          88 x 88 centre crop of 96 x 96 uint8, (x/255 - 0.421) / 0.165
    frontend        Conv3d(1 -> 64, 5 x 7 x 7, s 1 x 2 x 2, p 2 x 3 x 3), BN,
                    Swish, MaxPool3d(1 x 3 x 3, 1 x 2 x 2), ResNet-18 with Swish,
                    average pool
    encoder         Linear(512 -> d) x sqrt(d), relative positions (2T - 1),
                    Conformer blocks (macaron FFN / 2, RelMHA, Conv, FFN / 2,
                    LayerNorm), LayerNorm
    ctc_log_probs   Linear(d -> V), log-softmax
    decoder_logits  the pre-LN decoder over a whole prefix, causally
    prefix_scores   the CTC prefix score of each candidate label after a
                    prefix, from Graves' forward variables over the prefix's
                    blank-extended labels, and for eos the probability of
                    the prefix as the whole sequence

``prec="fp8"`` is the control: every operand of a convolution or a matrix
product is rounded to float8 e4m3 (one scale per tensor, its largest
magnitude at 448) before the product, which runs in float32.  Softmax,
LayerNorm, BatchNorm and the CTC recursions stay float32.

LayerNorm eps 1e-12 (ESPnet's), BatchNorm on running statistics with eps
1e-5.  Frames past an utterance's length are not computed at all.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

LN_EPS = 1e-12
BN_EPS = 1e-5
FP8_MAX = 448.0


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
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def linear(x, w, b=None, prec="f32"):
    y = torch.matmul(q8(x, prec), q8(w, prec).t())
    return y if b is None else y + b


def matmul(a, b, prec="f32"):
    return torch.matmul(q8(a, prec), q8(b, prec))


def layer_norm(x, W, p):
    return F.layer_norm(x, (x.shape[-1],), W(p + ".weight"), W(p + ".bias"), LN_EPS)


def swish(x):
    return x * torch.sigmoid(x)


def sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(n,) float positions -> (n, d): sin on the even channels, cos on the
    odd ones (the transformer's table)."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64, device=positions.device)
                    * -(math.log(10000.0) / d))
    ang = positions.to(torch.float64)[:, None] * div
    pe = torch.zeros(positions.shape[0], d, dtype=torch.float64, device=positions.device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe.to(torch.float32)


class Weights:
    """Read access to the float32 weights by the program's names."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.t = tensors

    def __call__(self, name: str) -> torch.Tensor:
        return self.t[name].to(torch.float32)


# ------------------------------------------------------------- ingest, frontend
def ingest(clip_u8: torch.Tensor, crop: int, mean: float, std: float) -> torch.Tensor:
    """(T, H, W) uint8 -> (T, crop, crop) float32: centre crop, normalise."""
    H = clip_u8.shape[1]
    c = int(round((H - crop) / 2.0))
    x = clip_u8[:, c:c + crop, c:c + crop].to(torch.float32) / 255.0
    return (x - mean) / std


def _bn(x, W, p):
    scale = W(p + ".weight") / torch.sqrt(W(p + ".running_var") + BN_EPS)
    shift = W(p + ".bias") - W(p + ".running_mean") * scale
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.view(shape) + shift.view(shape)


def _conv(x, w, stride, padding, prec):
    fn = F.conv3d if x.dim() == 5 else F.conv2d
    return fn(q8(x, prec), q8(w, prec), stride=stride, padding=padding)


def _block(x, W, p, stride, prec):
    y = swish(_bn(_conv(x, W(p + ".conv1.weight"), stride, 1, prec), W, p + ".bn1"))
    y = _bn(_conv(y, W(p + ".conv2.weight"), 1, 1, prec), W, p + ".bn2")
    key = p + ".downsample_conv.weight"
    res = x
    if key in W.t:
        res = _bn(_conv(x, W(key), stride, 0, prec), W, p + ".downsample_bn")
    return swish(y + res)


def frontend(video: torch.Tensor, W: Weights, cfg: dict, prec="f32") -> torch.Tensor:
    """(T, S, S) normalised frames of one utterance -> (T, feature_dim)."""
    T = video.shape[0]
    w = W("frontend.conv3d_weight")[:, None]           # (C, 1, 5, 7, 7)
    y = _conv(video[None, None], w, (1, 2, 2), (2, 3, 3), prec)
    y = swish(_bn(y, W, "frontend.bn3d"))             # (1, C, T, h, w)
    y = F.max_pool3d(y, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    y = y[0].transpose(0, 1)                           # (T, C, h, w)
    for stage, blocks in enumerate(cfg["resnet_blocks"]):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            y = _block(y, W, f"frontend.resnet.layer{stage + 1}_block{b}", stride, prec)
    return y.mean(dim=(2, 3)).reshape(T, -1)


# --------------------------------------------------------------------- encoder
def rel_positions(T: int, d: int, device) -> torch.Tensor:
    """(2T - 1, d): relative positions T - 1, ..., -(T - 1)."""
    return sinusoid(torch.arange(T - 1, -T, -1, device=device), d)


def rel_mha(x, W, p, n_head, prec):
    """Relative-position self-attention of one utterance, x (T, d):
    scores ((q + u) k^T + shift((q + v) p^T)) / sqrt(d_k), the shift by
    ESPnet's zero-pad-and-reshape."""
    T, D = x.shape
    d = D // n_head

    def lin(name, t):
        b = W(f"{p}.{name}.bias") if f"{p}.{name}.bias" in W.t else None
        return linear(t, W(f"{p}.{name}.weight"), b, prec)

    def heads(t):
        return t.reshape(t.shape[0], n_head, d).transpose(0, 1)   # (H, n, d)

    q = lin("linear_q", x).reshape(T, n_head, d)
    k, v = heads(lin("linear_k", x)), heads(lin("linear_v", x))
    pos = heads(lin("linear_pos", rel_positions(T, D, x.device)))   # (H, 2T-1, d)
    qu = (q + W(p + ".pos_bias_u")).transpose(0, 1)
    qv = (q + W(p + ".pos_bias_v")).transpose(0, 1)
    ac = matmul(qu, k.transpose(-1, -2), prec)                    # (H, T, T)
    bd = matmul(qv, pos.transpose(-1, -2), prec)                  # (H, T, 2T-1)
    padded = torch.cat([bd.new_zeros(n_head, T, 1), bd], dim=-1)
    bd = padded.view(n_head, 2 * T, T)[:, 1:].reshape(n_head, T, 2 * T - 1)[:, :, :T]
    probs = torch.softmax((ac + bd) / math.sqrt(d), dim=-1)
    ctx = matmul(probs, v, prec).transpose(0, 1).reshape(T, D)
    return lin("linear_out", ctx)


def conv_module(x, W, p, prec):
    """x (T, d): pointwise d -> 2d, GLU, depthwise conv, BN, Swish,
    pointwise d -> d."""
    def lin(name, t):
        return linear(t, W(f"{p}.{name}.weight"), W(f"{p}.{name}.bias"), prec)
    h = F.glu(lin("pointwise_conv1", x), dim=-1).t()[None]        # (1, d, T)
    w = W(p + ".depthwise_conv.weight")
    h = F.conv1d(q8(h, prec), q8(w, prec), W(p + ".depthwise_conv.bias"),
                 padding=(w.shape[-1] - 1) // 2, groups=w.shape[0])
    h = swish(_bn(h, W, p + ".bn"))[0].t()
    return lin("pointwise_conv2", h)


def ffn(x, W, p, prec, act):
    def lin(name, t):
        return linear(t, W(f"{p}.{name}.weight"), W(f"{p}.{name}.bias"), prec)
    return lin("w_2", act(lin("w_1", x)))


def encoder(feats, W, cfg, prec="f32"):
    """(T, feature_dim) -> (T, d_model)."""
    d = cfg["d_model"]
    h = linear(feats, W("encoder.embed.weight"), W("encoder.embed.bias"), prec) * math.sqrt(d)
    for i in range(cfg["n_enc_layers"]):
        p = f"encoder.layer_{i}"
        h = h + 0.5 * ffn(layer_norm(h, W, p + ".layer_norm_ff_macaron"), W,
                          p + ".feed_forward_macaron", prec, swish)
        h = h + rel_mha(layer_norm(h, W, p + ".layer_norm_mha"), W, p + ".self_attn",
                        cfg["n_head"], prec)
        h = h + conv_module(layer_norm(h, W, p + ".layer_norm_conv"), W,
                            p + ".conv_module", prec)
        h = h + 0.5 * ffn(layer_norm(h, W, p + ".layer_norm_ff"), W, p + ".feed_forward",
                          prec, swish)
        h = layer_norm(h, W, p + ".layer_norm_final")
    return layer_norm(h, W, "encoder.after_layer_norm")


def encode(clip_u8: torch.Tensor, W: Weights, cfg: dict, prec="f32") -> torch.Tensor:
    """One utterance's (T, H, W) uint8 frames -> (T, d_model)."""
    video = ingest(clip_u8, cfg["crop_size"], cfg["mean"], cfg["std"])
    return encoder(frontend(video, W, cfg, prec), W, cfg, prec)


def ctc_log_probs(enc: torch.Tensor, W: Weights, prec="f32") -> torch.Tensor:
    """(T, d_model) -> (T, V) CTC log-probabilities."""
    return torch.log_softmax(linear(enc, W("ctc.ctc_lo.weight"), W("ctc.ctc_lo.bias"),
                                    prec), dim=-1)


# --------------------------------------------------------------------- decoder
def attention(q, k, v, n_head, causal, prec):
    """q (N, Tq, H*d), k/v (N, Tk, H*d) -> (N, Tq, H*d)."""
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


def decoder_logits(ys: torch.Tensor, memory: torch.Tensor, W: Weights, cfg: dict,
                   prec="f32") -> torch.Tensor:
    """ys (N, L) prefixes (sos first) of one utterance, memory (T, d_model)
    -> (N, L, V) logits at every position: embedding x sqrt(d) + the
    sinusoidal table, pre-LN layers (causal self-attention, attention over
    the memory, FFN with ReLU), LayerNorm, the output layer."""
    N, L = ys.shape
    d = cfg["d_model"]
    H = cfg["n_head"]
    h = W("decoder.embed.weight")[ys] * math.sqrt(d) + sinusoid(
        torch.arange(L, device=ys.device), d)
    mem = memory[None].expand(N, -1, -1)
    for i in range(cfg["n_dec_layers"]):
        p = f"decoder.layer_{i}"

        def lin(name, t):
            return linear(t, W(f"{p}.{name}.weight"), W(f"{p}.{name}.bias"), prec)

        x = layer_norm(h, W, p + ".layer_norm1")
        h = h + lin("self_attn.fc", attention(lin("self_attn.w_qs", x), lin("self_attn.w_ks", x),
                                              lin("self_attn.w_vs", x), H, True, prec))
        x = layer_norm(h, W, p + ".layer_norm2")
        h = h + lin("src_attn.fc", attention(lin("src_attn.w_qs", x), lin("cross_kv.w_ks", mem),
                                             lin("cross_kv.w_vs", mem), H, False, prec))
        h = h + ffn(layer_norm(h, W, p + ".layer_norm3"), W, p + ".feed_forward", prec, F.relu)
    h = layer_norm(h, W, "decoder.after_layer_norm")
    return linear(h, W("decoder.output_layer.weight"), W("decoder.output_layer.bias"), prec)


# --------------------------------------------------------------- CTC prefixes
def _forward(x: torch.Tensor, prefixes: torch.Tensor, blank: int) -> torch.Tensor:
    """Graves' CTC forward variables of n prefixes of one length L over one
    utterance's log-probabilities x (T, V): (T, n, 2L + 1), state 2j + 1
    the label prefixes[:, j], the even states blanks."""
    T = x.shape[0]
    n, L = prefixes.shape
    S = 2 * L + 1
    ext = torch.full((n, S), blank, dtype=torch.int64, device=x.device)
    ext[:, 1::2] = prefixes
    # a label state may be entered from two states back unless it repeats
    skip = torch.zeros((n, S), dtype=torch.bool, device=x.device)
    if L > 1:
        skip[:, 3::2] = prefixes[:, 1:] != prefixes[:, :-1]
    alpha = torch.full((T, n, S), float("-inf"), device=x.device)
    emit = x[:, ext]                                               # (T, n, S)
    alpha[0, :, 0] = emit[0, :, 0]
    if L:
        alpha[0, :, 1] = emit[0, :, 1]
    for t in range(1, T):
        prev = alpha[t - 1]
        one = torch.full_like(prev, float("-inf"))
        one[:, 1:] = prev[:, :-1]
        two = torch.full_like(prev, float("-inf"))
        two[:, 2:] = torch.where(skip[:, 2:], prev[:, :-2], float("-inf"))
        alpha[t] = torch.logsumexp(torch.stack([prev, one, two]), dim=0) + emit[t]
    return alpha


def prefix_scores(x: torch.Tensor, prefixes: torch.Tensor, cands: torch.Tensor,
                  blank: int, eos: int) -> torch.Tensor:
    """The CTC prefix score log P(the labels begin with g.c) of each
    candidate c after each prefix g, over one utterance's log-probabilities
    x (T, V): the probability of the paths that first complete g.c at
    frame t, the remaining frames free, summed over t.  For eos the
    probability that the labels are g exactly; the blank -inf.
    prefixes (n, L), cands (n, C) -> (n, C)."""
    T = x.shape[0]
    n, L = prefixes.shape
    C = cands.shape[1]
    alpha = _forward(x, prefixes, blank)                           # (T, n, 2L+1)
    xc = x[:, cands]                                               # (T, n, C)
    if L == 0:
        into = alpha[:, :, 0:1].expand(T, n, C)
    else:
        # from the blank after g's last label, or from that label itself
        # unless c repeats it
        repeat = cands == prefixes[:, -1:]
        into = torch.where(repeat, alpha[:, :, -1:].expand(T, n, C),
                           torch.logaddexp(alpha[:, :, -1:], alpha[:, :, -2:-1]).expand(T, n, C))
    enter = torch.cat([(xc[:1] if L == 0 else torch.full_like(xc[:1], float("-inf"))),
                       into[:-1] + xc[1:]], dim=0)
    out = torch.logsumexp(enter, dim=0)
    whole = torch.logaddexp(alpha[-1, :, -1], alpha[-1, :, -2]) if L else alpha[-1, :, 0]
    out = torch.where(cands == eos, whole[:, None], out)
    return out.masked_fill(cands == blank, float("-inf"))
