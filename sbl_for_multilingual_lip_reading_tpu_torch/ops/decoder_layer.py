"""Fused SBL decoder layer (kernel K11) and its plain PyTorch version.

Counterpart of the JAX package's ``ops/decoder_layer.py`` (a Pallas TPU
kernel behind ``use_fused_decoder_layer``, default off there and here): one
whole decoder layer on the deterministic decode path,

    h1 = LN(fc(self_attention(x)) + x)
    h2 = LN(fc2(cross_attention(h1, cached encoder K/V)) + h1)
    h3 = LN(w2(relu(w1(h2))) + h2)

The JAX decoder vmaps the kernel over its two directions; the port's decoder
stacks the directions on a leading axis, and so do these functions: x is
(dirs, B, L, D), every weight (dirs, out, in) as ``Dense`` stores it, every
vector (dirs, n), the cached cross K/V (dirs, B, Tk, H*d) flat as ``CrossKV``
returns them.  One launch covers both directions: on the bf16 route as a
grid of thread-block clusters, each CTA of a cluster owning a quarter of
every GEMM's columns (``pick_mma_tile``), on the f32 route one block per
tile (``pick_tile``).

Rounding points are the TPU kernel's, not the module path's: q, k, v, both
attention contexts, the ReLU output and the LayerNorm outputs that feed a
GEMM are rounded to the compute dtype; biases and LayerNorm vectors are
f32 and added in f32; the softmax probabilities are not rounded; the
residual of each sublayer is the UNROUNDED f32 output of the LayerNorm
before it; LayerNorm is ``E[x^2] - mean^2`` with eps 1e-6.  The plain
version follows the kernel line by line.  The CUDA kernel is
``csrc/decoder_layer.cu``; its design note is there.

``fused_decoder_layer`` is the wrapper ``_SBLLayer`` calls.  On CPU tensors
it runs ``fused_decoder_layer_plain``; on CUDA tensors it launches the
kernel or raises.  ``fused_decoder_layer.launches`` counts the launches.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build
from .ingest import _DTYPE_CODES

LN_EPS = 1e-6
MAX_ROWS = 64   # rows (samples x positions) of a tile
MAX_CLUSTER = 4  # CTAs of the bf16 route's cluster
# the packed (13, D) f32 vector input, in the TPU kernel's order
_VEC_ROWS = ("bq", "bk", "bv", "fc_b", "ln1_s", "ln1_b",
             "bq2", "fc2_b", "ln2_s", "ln2_b", "b2", "ln3_s", "ln3_b")


def _dense_args(dense) -> Tuple[torch.Tensor, torch.Tensor]:
    """A ``Dense``'s weight in its compute dtype (the copy of
    ``cast_dense_weights`` where there is one) and its f32 bias."""
    weight = dense.cast[0] if dense.cast is not None else dense.weight.to(dense.dtype)
    return weight, dense.bias


def layer_params_to_args(layer) -> tuple:
    """Flatten an ``_SBLLayer`` (children ``slf``/``cross``/``ffn``) into the
    positional weight arguments of :func:`fused_decoder_layer` (everything
    between ``x`` and ``ck``), in the JAX function's order."""
    slf, cross, ffn = layer.slf, layer.cross, layer.ffn
    return (
        *_dense_args(slf.w_qs), *_dense_args(slf.w_ks), *_dense_args(slf.w_vs),
        *_dense_args(slf.fc), slf.layer_norm.weight, slf.layer_norm.bias,
        *_dense_args(cross.w_qs), *_dense_args(cross.fc),
        cross.layer_norm.weight, cross.layer_norm.bias,
        *_dense_args(ffn.w_1), *_dense_args(ffn.w_2),
        ffn.layer_norm.weight, ffn.layer_norm.bias,
    )


def _check(x, weights, vectors, b1, ck, cv, n_head, mask_bias):
    if x.dim() != 4:
        raise ValueError(f"x must be (dirs, B, L, D); got {tuple(x.shape)}")
    dirs, B, L, D = x.shape
    wq, wk, wv, fc_w, wq2, fc2_w, w1, w2 = weights
    HD = wq.shape[1]
    DI = w1.shape[1]
    shapes = [(wq, (dirs, HD, D)), (wk, (dirs, HD, D)), (wv, (dirs, HD, D)),
              (fc_w, (dirs, D, HD)), (wq2, (dirs, HD, D)), (fc2_w, (dirs, D, HD)),
              (w1, (dirs, DI, D)), (w2, (dirs, D, DI)), (b1, (dirs, DI))]
    shapes += [(v, (dirs, D)) for v in vectors]
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_decoder_layer: a parameter is "
                             f"{tuple(t.shape)}, expected {shape}")
    if HD != D or HD % n_head:
        raise ValueError(f"fused_decoder_layer needs n_head * d_k == d_model; "
                         f"got {HD} and {D} with {n_head} heads")
    if ck.dim() != 4 or ck.shape[:2] != (dirs, B) or ck.shape[3] != HD \
            or cv.shape != ck.shape:
        raise ValueError(f"ck/cv must be ({dirs}, {B}, Tk, {HD}); got "
                         f"{tuple(ck.shape)}, {tuple(cv.shape)}")
    if any(w.dtype != x.dtype for w in weights) or ck.dtype != x.dtype \
            or cv.dtype != x.dtype:
        raise ValueError("fused_decoder_layer: weights and ck/cv must be in "
                         "x's dtype")
    if mask_bias is not None and tuple(mask_bias.shape) != (L, L):
        raise ValueError(f"mask_bias must be ({L}, {L}); got "
                         f"{tuple(mask_bias.shape)}")
    return dirs, B, L, D, HD // n_head, DI, ck.shape[2]


def _ln(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel's LayerNorm: f32, variance as E[x^2] - mean^2."""
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mu * mu
    return ((x32 - mu) * torch.rsqrt(var + LN_EPS)
            * scale.to(torch.float32)[:, None, None]
            + bias.to(torch.float32)[:, None, None])


def fused_decoder_layer_plain(x, wq, bq, wk, bk, wv, bv, fc_w, fc_b, ln1_s,
                              ln1_b, wq2, bq2, fc2_w, fc2_b, ln2_s, ln2_b,
                              w1, b1, w2, b2, ln3_s, ln3_b, ck, cv, n_head: int,
                              mask_bias: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of K11, with the kernel's rounding points."""
    dirs, B, L, D, dk, DI, Tk = _check(
        x, (wq, wk, wv, fc_w, wq2, fc2_w, w1, w2),
        (bq, bk, bv, fc_b, ln1_s, ln1_b, bq2, fc2_b, ln2_s, ln2_b, b2, ln3_s,
         ln3_b), b1, ck, cv, n_head, mask_bias)
    H, cdt, f32 = n_head, x.dtype, torch.float32
    if scale is None:
        scale = 1.0 / math.sqrt(dk)

    def proj(h, w, b):
        # operands in the compute dtype, widened exactly; f32 product + bias
        y = torch.matmul(h.to(f32), w.to(f32).transpose(1, 2)[:, None])
        return y + b.to(f32)[:, None, None]

    def heads(t):
        return t.reshape(dirs, B, t.shape[2], H, dk).permute(0, 1, 3, 2, 4)

    def unheads(c):
        return c.permute(0, 1, 3, 2, 4).reshape(dirs, B, c.shape[3], H * dk)

    def attend(q, k, v, bias):
        s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias.to(f32)
        p = torch.exp(s - s.max(dim=-1, keepdim=True).values)
        p = p / p.sum(dim=-1, keepdim=True)
        return torch.matmul(p, v.to(f32))

    xf = x.to(f32)
    # self-attention sublayer
    qh = heads(proj(x, wq, bq).to(cdt))
    kh = heads(proj(x, wk, bk).to(cdt))
    vh = heads(proj(x, wv, bv).to(cdt))
    ctx = unheads(attend(qh, kh, vh, mask_bias)).to(cdt)
    h1 = _ln(proj(ctx, fc_w, fc_b) + xf, ln1_s, ln1_b)
    h1c = h1.to(cdt)
    # cached cross-attention sublayer
    q2 = heads(proj(h1c, wq2, bq2).to(cdt))
    ctx2 = unheads(attend(q2, heads(ck), heads(cv), None)).to(cdt)
    h2 = _ln(proj(ctx2, fc2_w, fc2_b) + h1, ln2_s, ln2_b)
    h2c = h2.to(cdt)
    # FFN sublayer
    u = torch.relu(proj(h2c, w1, b1)).to(cdt)
    h3 = _ln(proj(u, w2, b2) + h2, ln3_s, ln3_b)
    return h3.to(cdt)


def decoder_layer_fits(L: int, D: int, DI: int) -> bool:
    """Whether K11 takes a segment of L positions at model width D and FFN
    width DI (any head width d_k = D / n_head)."""
    return L <= MAX_ROWS and DI % D == 0


def cluster_size(n_head: int) -> int:
    """CTAs of a cluster on the bf16 route: MAX_CLUSTER, or the largest
    smaller power of two dividing n_head (each CTA owns whole heads)."""
    return next(cs for cs in (MAX_CLUSTER, 2, 1) if n_head % cs == 0)


def pick_mma_tile(lib, B: int, L: int, D: int, H: int, dk: int,
                  Tk: int) -> Tuple[int, int]:
    """(samples per tile, CTAs per cluster) on the bf16 route: the cluster
    of ``cluster_size(H)`` CTAs, and the most samples whose rows (at most
    MAX_ROWS) fit each CTA's shared memory, as the source's sizer counts it."""
    cs = cluster_size(H)
    for bt in range(min(B, MAX_ROWS // L), 0, -1):
        if lib.sbl_decoder_layer_mma_smem_bytes(bt, L, D, H, dk, Tk, cs) \
                <= _build.MAX_SMEM_BYTES:
            return bt, cs
    raise ValueError(f"fused_decoder_layer: one sample of {L} positions at "
                     f"width {D} with {Tk} cross keys does not fit the "
                     f"kernel's shared memory")


def pick_tile(lib, B: int, L: int, D: int, dk: int, Tk: int, elem: int) -> int:
    """Samples per thread block on the f32 route: the most whose rows (at
    most MAX_ROWS) and buffers fit the block's shared memory."""
    for bt in range(min(B, MAX_ROWS // L), 0, -1):
        if lib.sbl_decoder_layer_smem_bytes(bt, L, D, dk, Tk, elem) \
                <= _build.MAX_SMEM_BYTES:
            return bt
    raise ValueError(f"fused_decoder_layer: one sample of {L} positions at "
                     f"width {D} does not fit the kernel's shared memory")


def fused_decoder_layer(x, wq, bq, wk, bk, wv, bv, fc_w, fc_b, ln1_s, ln1_b,
                        wq2, bq2, fc2_w, fc2_b, ln2_s, ln2_b,
                        w1, b1, w2, b2, ln3_s, ln3_b, ck, cv, n_head: int,
                        mask_bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """K11: one full SBL decoder layer, both directions in one launch.

    x:         (dirs, B, L, D) hidden states, f32 or bf16
    w*/fc*:    (dirs, out, in) weights in x's dtype
    b*/ln*:    (dirs, n) f32 biases and LayerNorm vectors
    ck/cv:     (dirs, B, Tk, H*d) cached cross K/V in x's dtype
    mask_bias: optional (L, L) f32 additive self-attention bias, shared by
               the batch and the directions
    Returns (dirs, B, L, D) in x's dtype.  CUDA tensors (contiguous) launch
    the kernel; CPU tensors take the plain version."""
    weights = (wq, wk, wv, fc_w, wq2, fc2_w, w1, w2)
    vectors = (bq, bk, bv, fc_b, ln1_s, ln1_b, bq2, fc2_b, ln2_s, ln2_b, b2,
               ln3_s, ln3_b)
    dirs, B, L, D, dk, DI, Tk = _check(x, weights, vectors, b1, ck, cv, n_head,
                                       mask_bias)
    if x.device.type == "cpu":
        return fused_decoder_layer_plain(
            x, wq, bq, wk, bk, wv, bv, fc_w, fc_b, ln1_s, ln1_b, wq2, bq2,
            fc2_w, fc2_b, ln2_s, ln2_b, w1, b1, w2, b2, ln3_s, ln3_b, ck, cv,
            n_head, mask_bias, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_decoder_layer: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_decoder_layer: dtype {x.dtype} not supported")
    if not decoder_layer_fits(L, D, DI):
        raise ValueError(f"fused_decoder_layer: L={L}, d_inner={DI} outside "
                         f"what the kernel takes (L <= {MAX_ROWS}; d_inner a "
                         f"multiple of d_model)")
    if not all(t.is_contiguous() for t in (x, ck, cv) + weights):
        raise ValueError("fused_decoder_layer: x, ck, cv and the weights must "
                         "be contiguous")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    f32 = dict(device=x.device, dtype=torch.float32)
    vecs = torch.stack([v.to(**f32) for v in vectors], dim=1).contiguous()
    b1v = b1.to(**f32).contiguous()
    bias = None if mask_bias is None else mask_bias.to(**f32).contiguous()
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    lib = _build.library()
    if x.dtype == torch.bfloat16:
        bt, cs = pick_mma_tile(lib, B, L, D, n_head, dk, Tk)
    else:
        bt, cs = pick_tile(lib, B, L, D, dk, Tk, x.element_size()), 1
    err = lib.sbl_fused_decoder_layer(
        x.data_ptr(), *(w.data_ptr() for w in weights), vecs.data_ptr(),
        b1v.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        dirs, B, L, D, n_head, dk, DI, Tk, bt, cs, float(scale),
        _DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_decoder_layer")
    fused_decoder_layer.launches += 1
    return out


fused_decoder_layer.launches = 0
