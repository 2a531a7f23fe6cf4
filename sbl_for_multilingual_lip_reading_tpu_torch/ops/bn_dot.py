"""Train-mode BatchNorm whose statistics are matrix products (counterpart of
the JAX package's ``ops/bn_dot.py``, behind ``DOT_BN=1`` or ``use_dot_bn``,
``models/frontend.py`` ``DotBatchNorm``).

Over the M = N*H*W positions of each channel (X the (C, M) matrix of x):

  forward   s1 = X . 1, s2 = diag(X X^T) (the whole C x C gram, as JAX
            takes it), mean = s1 / M, var = s2 / M - mean^2 (not clamped),
            inv = rsqrt(var + eps), y = x * (inv * scale)
            + (bias - mean * inv * scale) in f32
  backward  dy cast to x's dtype once; g_bias = DY . 1,
            sxdy = diag(DY X^T) (x, not x_hat),
            g_scale = inv * (sxdy - mean * g_bias),
            dx = dy * a - b - x * c with a = scale * inv,
            b = a * (g_bias - mean * inv * g_scale) / M,
            c = a * inv * g_scale / M

The cotangents of the returned mean and var are ignored (running
statistics only).  The products must give the sums of f32 reductions: a
sum rounded to bf16 or TF32 moves a mean by more than an ulp and flips
ReLU and max-pool routing downstream.  One product accumulates a whole
contraction, up to the stem's 13.9 M positions, in f32 registers: on an
H100 (torch 2.11, cuBLAS) bf16 operands with an f32 result
(``out_dtype=torch.float32``, the tensor cores) put the stem's statistics
5e-4 of their scale off in one product and 1.2e-5 in chunks of 4096
positions, and f32 operands with TF32 off (the CUDA cores, each add
rounded to nearest) in chunks of 4096 4.4e-6, where torch's reductions
are 1e-7 off.  So the operands are f32 and TF32 is off for the call, the
positions go in chunks of CHUNK (a batch of products over a zero-padded
(n, C, CHUNK) copy), and the chunks' C x C results are summed by a
reduction over the batch.  The port keeps activations NCHW, so X and DY
are transposed f32 copies of x and dy (``_rows``): one read of each and
one f32 write on top of the products' read.

``mesh`` (a ``parallel.DataMesh``) sums (s1, s2) and (g_bias, sxdy) over
the data-parallel processes, as ``ops/bn_relu.py`` does; the scale and
bias gradients stay this process's own sums.
"""
from __future__ import annotations

import contextlib

import torch

from .batchnorm import _all_reduce_pair
from .batchnorm import _per_channel as _c


# positions a product sums; the batch of chunks is then summed by a reduction
CHUNK = 4096


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(N, C, ...) -> f32 (n, C, CHUNK): each channel's positions in chunks
    of CHUNK, zeros past the last."""
    N, C = t.shape[:2]
    M = t.numel() // C
    n = -(-M // CHUNK)
    out = t.new_zeros(C, n * CHUNK, dtype=torch.float32)
    out[:, :M].view(C, N, -1).copy_(t.reshape(N, C, -1).transpose(0, 1))
    return out.view(C, n, CHUNK).transpose(0, 1)


@contextlib.contextmanager
def _no_tf32():
    m = torch.backends.cuda.matmul
    old = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = old


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b batched for f32 operands, with TF32 off for the call."""
    with _no_tf32():
        return torch.bmm(a, b)


def channel_products(x: torch.Tensor, y: torch.Tensor):
    """f32 (C,) (sum y, diag(Y X^T)) over every position of the (N, C, ...)
    tensors x and y (one dtype), the second from the whole C x C gram, and
    the number of positions."""
    X = _rows(x)
    Y = X if y is x else _rows(y)
    ones = torch.ones(1, CHUNK, 1, device=y.device)
    s1 = bmm_f32(Y, ones.expand(Y.shape[0], -1, -1)).sum(0)[:, 0]
    gram = bmm_f32(Y, X.transpose(1, 2)).sum(0)
    return s1, torch.diagonal(gram).contiguous(), x.numel() // x.shape[1]


class _BNDot(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps, mesh):
        s1, s2, n = channel_products(x, x)
        if mesh is not None:
            s1, s2 = _all_reduce_pair(mesh, s1, s2)
            n *= mesh.size
        mean = s1 / n
        var = s2 / n - mean * mean
        inv = torch.rsqrt(var + eps)
        y = (x.to(torch.float32) * _c(inv * scale, x)
             + _c(bias - mean * inv * scale, x))
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, inv = ctx.saved_tensors
        dyc = dy.to(x.dtype)
        own_bias, own_sxdy, n = channel_products(x, dyc)
        g_bias, sxdy = own_bias, own_sxdy
        if ctx.mesh is not None:
            g_bias, sxdy = _all_reduce_pair(ctx.mesh, own_bias, own_sxdy)
            n *= ctx.mesh.size
        g_scale = inv * (sxdy - mean * g_bias)
        si = scale * inv
        a = si
        b = si * (g_bias + (-mean * inv) * g_scale) / n
        c = si * inv * g_scale / n
        dx = (dyc.to(torch.float32) * _c(a, x) - _c(b, x)
              - x.to(torch.float32) * _c(c, x)).to(x.dtype)
        own_scale = inv * (own_sxdy - mean * own_bias)
        return dx, own_scale, own_bias, None, None


def bn_train_dot(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float, mesh=None):
    """Train-mode BatchNorm over all but axis 1 of ``x`` (N, C, ...), its
    statistics as matrix products.  Returns (f32 y, f32 (C,) mean, f32 (C,)
    biased variance); the caller casts y."""
    return _BNDot.apply(x, scale.to(torch.float32), bias.to(torch.float32),
                        float(eps), mesh)
