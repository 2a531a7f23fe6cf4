"""Plain PyTorch reference of the SBL model's training steps on the cached
route, in float32 with TF32 off (``prec="fp8"``: the control, as in
``model.py``).

It follows the program's first steps from the same start: the weights and
the resident clips the benchmark made, and every random number drawn
again from the run's seed by frozen copies of the program's host code
(the epoch's order, the augmentation plans, each step's row of seeds and
teacher-forcing coins) and of its mask arithmetic (Philox4x32-10 keep
masks on the attention probabilities, counter (key, query, head, batch
row); the elementwise masks ``torch.rand(shape, generator) >= rate`` from
a generator on the device seeded with the row's seed, drawn at the
program's shapes in the program's order).  The model is written from its
equations (``model.py``'s layers, with BatchNorm on the batch's
statistics, dropout, and the teacher-forced bidirectional decode), the
loss is the label-smoothed cross-entropy of both directions, and Adam with
the Noam learning rate updates every parameter.  Nothing of the program is
imported.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import model as R

MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
SOS, EOS, IGNORE = 0, 1, -1


# --------------------------------------------- Philox keep masks (K3/K4/K5)
def _mulhilo32(a: torch.Tensor, m: int):
    lo_part = (a & 0xFFFF) * m
    hi_part = (a >> 16) * m
    mid = lo_part + ((hi_part & 0xFFFF) << 16)
    return (hi_part >> 16) + (mid >> 32), mid & MASK32


def philox4x32_10(counter, seed: int):
    """Philox4x32-10 (Random123's constants) on four int64 tensors of
    uint32 words; ``seed`` a 64-bit key."""
    c0, c1, c2, c3 = torch.broadcast_tensors(*counter)
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W[0]) & MASK32
            k1 = (k1 + PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo32(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo32(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(B: int, H: int, Tq: int, Tk: int, seed: int, rate: float,
              device) -> torch.Tensor:
    """(B, H, Tq, Tk) bool: word 0 of Philox at counter (key, query, head,
    batch row) at or above rate * 2^32."""
    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)
    bits = philox4x32_10((axis(Tk, 3), axis(Tq, 2), axis(H, 1), axis(B, 0)),
                         int(seed))[0]
    return bits >= int(rate * 4294967296.0)


class MaskStream:
    """The elementwise masks of one block of a step: ``torch.rand`` from a
    generator on ``device`` seeded with ``seed``, in call order."""

    def __init__(self, seed: int, device):
        self.device = device
        self.g = torch.Generator(device=device).manual_seed(int(seed))

    def keep(self, shape, rate: float) -> torch.Tensor:
        return torch.rand(shape, generator=self.g, device=self.device) >= rate


def dropout(x, keep, rate):
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


# ----------------------------------------- the epoch's host draws (copies)
def epoch_order(seed: int, n: int, batch: int, max_steps: int) -> np.ndarray:
    """(steps, batch) dataset indices: a permutation from default_rng(seed)."""
    perm = np.random.default_rng(seed).permutation(n)
    steps = min(n // batch, max_steps)
    return perm[:steps * batch].reshape(steps, batch)


def make_train_plans(rng, B, T, raw, crop, frame_removal_p, per_frame, clip_hi):
    """(offsets (B, T, 2), flip (B,), frame_map (B, T)): per-frame or
    per-clip crop offsets, a whole-clip flip with p 0.5, FrameRemoval (a
    frame w.p. p becomes a copy of the last kept one; it keeps that
    frame's offset)."""
    hi = raw - crop
    offs = rng.integers(0, hi + 1, size=(B, T, 2)).astype(np.int32)
    offs_clip = rng.integers(0, np.asarray(clip_hi).reshape(B, 1, 1) + 1,
                             size=(B, 1, 2)).astype(np.int32)
    offs = np.where(per_frame[:, None, None], offs, np.broadcast_to(offs_clip, (B, T, 2)))
    flip = rng.random(B) < 0.5
    drop = rng.random((B, T)) < frame_removal_p
    drop[:, 0] = False
    idx = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    fmap = np.maximum.accumulate(np.where(drop, np.int32(-1), idx), axis=1).astype(np.int32)
    offs = np.take_along_axis(offs, fmap[..., None], axis=1)
    return offs, flip, fmap


def plans_for(rng, lang: np.ndarray, T: int, raw: int, crop: int, frame_removal_p: float):
    """The plans of one batch: LRW clips (lang 0) per-frame offsets in
    [0, raw - crop], LRW-1000 clips one per clip in [0, (raw - crop) // 2]."""
    return make_train_plans(rng, len(lang), T, raw, crop, frame_removal_p,
                            per_frame=lang == 0,
                            clip_hi=np.where(lang == 0, raw - crop, (raw - crop) // 2))


class Layout(NamedTuple):
    """Where a step's forward finds its seeds: 0 the first block's mask
    generator, then one per encoder attention, then per decode step a block
    of its generator's seed and one per attention in it."""
    direct: int
    children: int
    child: int

    @property
    def size(self) -> int:
        return 1 + self.direct + self.children * (1 + self.child)

    def child_base(self, j: int) -> int:
        return 1 + self.direct + j * (1 + self.child)


def step_rows(step_seed: int, layout: Layout, coins: int, rate: float):
    host = torch.Generator().manual_seed(int(step_seed))
    seeds = torch.randint(0, 2 ** 62, (layout.size,), generator=host)
    flips = torch.rand(coins, generator=host) < rate
    return seeds.numpy(), flips.numpy()


class Draws(NamedTuple):
    order: np.ndarray          # (steps, B)
    plans: List[tuple]         # per step (offsets, flip, frame_map)
    seeds: np.ndarray          # (steps, layout.size)
    coins: np.ndarray          # (steps, maxlen)


def first_epoch_draws(seed: int, lang: np.ndarray, cfg: dict, steps: int) -> Draws:
    """What a trainer seeded with ``seed`` draws for the first ``steps``
    steps of its first epoch: the order from default_rng(seed + 0), the
    plans from default_rng(seed), and a step seed a step from a CPU
    torch.Generator(seed), each expanded into its row."""
    order = epoch_order(seed, len(lang), cfg["batch"], steps)
    rng = np.random.default_rng(seed)
    plans = [plans_for(rng, lang[o], cfg["frames"], cfg["raw_size"], cfg["crop_size"],
                       cfg["frame_removal_p"]) for o in order]
    g = torch.Generator().manual_seed(int(seed))
    layout = layout_of(cfg)
    rows = [step_rows(int(torch.randint(0, 2 ** 62, (1,), generator=g)), layout,
                      cfg["maxlen"], cfg["teacher_forcing_rate"]) for _ in order]
    return Draws(order, plans, np.stack([r[0] for r in rows]),
                 np.stack([r[1] for r in rows]))


def layout_of(cfg: dict) -> Layout:
    return Layout(cfg["n_enc_layers"], cfg["maxlen"], 2 * cfg["n_dec_layers"])


def segment_widths(maxlen: int, segments: int) -> List[int]:
    """The buffer width each decode step's masks are drawn at: steps of
    segment [a, b) run on b + 1 positions."""
    k = max(1, min(segments, maxlen))
    out, start = [], 0
    for i in range(k):
        b = round(maxlen * (i + 1) / k)
        if b > start:
            out += [b + 1] * (b - start)
            start = b
    return out


# ----------------------------------------------------------------- the step
def ingest_train(clips: torch.Tensor, offsets, flip, fmap, crop: int) -> torch.Tensor:
    """uint8 (B, T, H, W) -> float32 (B, T, crop, crop): FrameRemoval's
    gather, the per-frame crops, the flip, ColorNormalize."""
    B, T, H, W = clips.shape
    dev = clips.device
    rows = torch.arange(B, device=dev)[:, None]
    x = clips[rows, torch.as_tensor(fmap, device=dev).long()]
    off = torch.as_tensor(offsets, device=dev).long()
    span = torch.arange(crop, device=dev)
    r = (off[..., 0:1] + span)[..., :, None]                 # (B, T, crop, 1)
    c = (off[..., 1:2] + span)[..., None, :]                 # (B, T, 1, crop)
    bi = torch.arange(B, device=dev)[:, None, None, None]
    ti = torch.arange(T, device=dev)[None, :, None, None]
    x = x[bi, ti, r, c]
    x = torch.where(torch.as_tensor(flip, device=dev)[:, None, None, None], x.flip(-1), x)
    return (x.to(torch.float32) / 255.0 - R.MEAN) / R.STD


def _bn_train(x, W, p):
    dims = (0,) + tuple(range(2, x.dim()))
    mean = x.mean(dims)
    var = x.var(dims, unbiased=False)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    scale = W(p + ".weight") / torch.sqrt(var + R.BN_EPS)
    return (x - mean.view(shape)) * scale.view(shape) + W(p + ".bias").view(shape)


def _block_train(x, W, p, stride, prec):
    y = F.relu(_bn_train(R._conv(x, W(p + ".conv1.weight"), stride, 1, prec), W, p + ".bn1"))
    y = _bn_train(R._conv(y, W(p + ".conv2.weight"), 1, 1, prec), W, p + ".bn2")
    key = p + ".downsample_conv.weight"
    res = x
    if key in W.t:
        res = _bn_train(R._conv(x, W(key), stride, 0, prec), W, p + ".downsample_bn")
    return F.relu(y + res)


def _attention_train(q, k, v, n_head, causal, keep, rate, prec):
    N, Tq, D = q.shape
    Tk = k.shape[1]
    d = D // n_head

    def heads(t):
        return t.reshape(N, t.shape[1], n_head, d).transpose(1, 2)
    s = R.matmul(heads(q), heads(k).transpose(-1, -2), prec) / math.sqrt(d)
    if causal:
        s = s.masked_fill(torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).triu(1),
                          float("-inf"))
    p = dropout(torch.softmax(s, dim=-1), keep, rate)
    return R.matmul(p, heads(v), prec).transpose(1, 2).reshape(N, Tq, D)


class Step:
    """One reference training step's forward: ``loss(params, batch)``."""

    def __init__(self, cfg: dict, prec: str = "f32"):
        self.cfg, self.prec = cfg, prec
        self.layout = layout_of(cfg)
        self.widths = segment_widths(cfg["maxlen"], cfg["decode_segments"])

    def _lin(self, W, p, x, d=None, bias=True):
        return R.linear(x, W(p + ".weight", d), W(p + ".bias", d) if bias else None, self.prec)

    def _mha(self, W, p, x, kv, d, causal, keep, fc_keep, rate, kv_proj=None):
        k, v = kv_proj if kv_proj is not None else (self._lin(W, p + ".w_ks", kv, d),
                                                    self._lin(W, p + ".w_vs", kv, d))
        ctx = _attention_train(self._lin(W, p + ".w_qs", x, d), k, v, self.cfg["n_head"],
                               causal, keep, rate, self.prec)
        out = dropout(self._lin(W, p + ".fc", ctx, d), fc_keep, rate)
        return R.layer_norm(out + x, W(p + ".layer_norm.weight", d), W(p + ".layer_norm.bias", d))

    def _ffn(self, W, p, x, d, keep, rate):
        h = self._lin(W, p + ".w_2", F.relu(self._lin(W, p + ".w_1", x, d)), d)
        return R.layer_norm(dropout(h, keep, rate) + x, W(p + ".layer_norm.weight", d),
                            W(p + ".layer_norm.bias", d))

    def frontend(self, W, video, masks):
        c, prec = self.cfg, self.prec
        B, T = video.shape[:2]
        y = R._conv(video[:, None], W("frontend.conv3d_weight")[:, None], (1, 2, 2), (2, 3, 3), prec)
        y = F.relu(_bn_train(y, W, "frontend.bn3d"))
        y = F.max_pool3d(y, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        C, h, w = y.shape[1], y.shape[3], y.shape[4]
        y = y.transpose(1, 2).reshape(B * T, C, h, w)
        for stage, blocks in enumerate(c["resnet_blocks"]):
            for b in range(blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                p = f"frontend.resnet.layer{stage + 1}_block{b}"
                y = checkpoint(_block_train, y, W, p, stride, prec, use_reentrant=False)
        y = y.mean(dim=(2, 3))
        return dropout(y, masks.keep(y.shape, c["frontend_dropout"]), c["frontend_dropout"]).reshape(B, T, -1)

    def encoder(self, W, feats, masks, seeds):
        c, rate = self.cfg, self.cfg["dropout"]
        B, T, _ = feats.shape
        h = self._lin(W, "encoder.linear_in", feats)
        h = R.layer_norm(h, W("encoder.layer_norm_in.weight"), W("encoder.layer_norm_in.bias"))
        h = h + R.sinusoid(T, h.shape[-1], h.device)
        h = dropout(h, masks.keep(h.shape, rate), rate)
        for i in range(c["n_enc_layers"]):
            p = f"encoder.layer_{i}"
            keep = keep_mask(B, c["n_head"], T, T, int(seeds[1 + i]), rate, h.device)
            h = self._mha(W, p + ".slf_attn", h, h, None, False, keep,
                          masks.keep(h.shape, rate), rate)
            h = self._ffn(W, p + ".pos_ffn", h, None, masks.keep(h.shape, rate), rate)
        return h

    def decoder(self, W, enc, gold, seeds, coins):
        """gold (2, B, maxlen) eos-padded -> logits (2, B, maxlen, V)."""
        c, rate = self.cfg, self.cfg["dropout"]
        B, Tk = enc.shape[:2]
        D, H, dev = enc.shape[-1], c["n_head"], enc.device
        emb = W("decoder.step.tgt_word_emb.weight")
        kv = [[(self._lin(W, f"decoder.cross_kv_{i}.w_ks", enc, d),
                self._lin(W, f"decoder.cross_kv_{i}.w_vs", enc, d)) for d in range(2)]
              for i in range(c["n_dec_layers"])]
        ys = torch.full((2, B, 1), SOS, dtype=torch.int64, device=dev)
        logits = []
        for s in range(c["maxlen"]):
            L, Lb = s + 1, self.widths[s]
            base = self.layout.child_base(s)
            masks = MaskStream(seeds[base], dev)
            step_seeds = iter(int(x) for x in seeds[base + 1:base + 1 + self.layout.child])

            def wide(shape_tail):
                return masks.keep((2, B, Lb) + shape_tail, rate)[:, :, :L]
            h = emb[ys] + R.sinusoid(L, D, dev)
            h = dropout(h, wide((D,)), rate)
            for i in range(c["n_dec_layers"]):
                p = f"decoder.step.layer_{i}"
                k_slf = keep_mask(2 * B, H, L, L, next(step_seeds), rate, dev)
                fc_slf = wide((D,))
                k_x = keep_mask(2 * B, H, L, Tk, next(step_seeds), rate, dev)
                fc_x = wide((D,))
                ffn_keep = wide((D,))
                out = []
                for d in range(2):
                    rows = slice(d * B, (d + 1) * B)
                    x = self._mha(W, p + ".slf", h[d], h[d], d, i == 0, k_slf[rows], fc_slf[d], rate)
                    x = self._mha(W, p + ".cross", x, None, d, False, k_x[rows], fc_x[d], rate,
                                  kv_proj=kv[i][d])
                    out.append(self._ffn(W, p + ".ffn", x, d, ffn_keep[d], rate))
                h = torch.stack([out[0] + out[1].flip(1), out[1] + out[0].flip(1)])
            lg = torch.stack([R.linear(h[d][:, -1], W("decoder.step.tgt_word_prj.weight", d),
                                       None, self.prec) for d in range(2)])
            logits.append(lg)
            nxt = gold[:, :, s] if bool(coins[s]) else lg.detach().argmax(-1)
            ys = torch.cat([ys, nxt[..., None]], dim=-1)
        return torch.stack(logits, dim=2)

    def loss(self, W, batch) -> torch.Tensor:
        c = self.cfg
        video = ingest_train(batch["clips"], *batch["plans"], c["crop_size"])
        masks = MaskStream(batch["seeds"][0], video.device)
        enc = self.encoder(W, self.frontend(W, video, masks), masks, batch["seeds"])
        gold = torch.stack([eos_padded(batch["labels"], c["maxlen"]),
                            eos_padded(batch["labels_reverse"], c["maxlen"])])
        lg = self.decoder(W, enc, gold, batch["seeds"], batch["coins"])
        return 0.5 * (smoothed_ce(lg[0], gold[0], c["label_smoothing"])
                      + smoothed_ce(lg[1], gold[1], c["label_smoothing"]))


def eos_padded(labels: torch.Tensor, maxlen: int) -> torch.Tensor:
    """(B, P) IGNORE-padded labels -> (B, maxlen): each label in its
    place, eos everywhere else."""
    B, P = labels.shape
    out = torch.full((B, maxlen), EOS, dtype=torch.int64, device=labels.device)
    take = min(P, maxlen)
    head = labels[:, :take].long()
    out[:, :take] = torch.where(head != IGNORE, head, torch.full_like(head, EOS))
    return out


def smoothed_ce(logits, gold, eps):
    """Mean over the tokens of -(1 - eps) log p(gold) - eps / C * sum of
    log p over the other classes (the reference's smoothing)."""
    C = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    gold_logp = logp.gather(-1, gold[..., None])[..., 0]
    off = logp.sum(-1) - gold_logp
    return (-((1.0 - eps) * gold_logp + (eps / C) * off)).mean()


def noam_lr(step: int, k: float, warmup: int, d_model: int) -> float:
    s = np.float32(max(step + 1, 1))
    return float(np.float32(k * d_model ** -0.5) * np.minimum(
        s ** np.float32(-0.5), s * np.float32(warmup ** -1.5)))


def run_steps(params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
              batches: List[dict], cfg: dict, prec: str = "f32"):
    """The first ``len(batches)`` steps from ``params`` (float32, on the
    device; updated in place) with Adam (torch's rule, bias-corrected,
    eps outside the root) at the Noam rate.  Returns (losses, the first
    step's gradients, the parameters' change over all steps)."""
    R.no_tf32()
    step = Step(cfg, prec)
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"]
    losses, first = [], None
    for t, batch in enumerate(batches):
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        W = R.Weights({**leaves, **buffers})
        loss = step.loss(W, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        g = dict(zip(leaves, grads))
        if first is None:
            first = {k: x.detach().clone() for k, x in g.items()}
        lr = noam_lr(t, cfg["noam_k"], cfg["warmup_steps"], cfg["lr_base_dim"])
        with torch.no_grad():
            for k in params:
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                bc1, bc2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
                denom = v2[k].sqrt() / math.sqrt(bc2) + eps
                params[k] = params[k] - (lr / bc1) * m[k] / denom
    change = {k: params[k] - start[k] for k in params}
    return losses, first, change
