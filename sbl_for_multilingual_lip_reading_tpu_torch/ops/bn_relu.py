"""Train-mode BatchNorm (+ residual add) (+ ReLU) whose backward keeps only
the conv output and per-channel statistics (counterpart of the JAX
package's ``ops/bn_relu.py``, behind ``FUSED_BN_ACT=1`` or
``use_fused_bn_act``, ``models/frontend.py`` ``FusedBNAct``).

Composed in autograd, a BatchNorm followed by a ReLU keeps two full-size
tensors for the backward: the conv output (the BatchNorm's input) and the
BatchNorm's output (the ReLU's).  ``bn_act_train`` is one
``torch.autograd.Function`` that keeps x, the residual and four (C,)
vectors, and recomputes x_hat and the ReLU mask from them:

  forward   mean, var = E[x], E[x^2] - E[x]^2 in f32 (not clamped),
            rstd = rsqrt(var + eps),
            y = relu(cast((x - mean) * (rstd * scale) + bias, x.dtype)
                     [+ res])
  backward  x_hat = (x - mean) * rstd; the mask from the post-cast,
            pre-ReLU value; g = dy where the mask holds;
            s1 = sum g, s2 = sum g x_hat (f32);
            dx = rstd * scale * (g - (s1 + x_hat * s2) / M) in x's dtype,
            d_scale = s2, d_bias = s1, d_res = g

as JAX's custom VJP, on NCHW where JAX is channels-last.  The reductions
are torch's; no kernel of this package is launched.  The cotangents of the
returned mean and var are ignored: they feed the running statistics only.

``mesh`` (a ``parallel.DataMesh``, synchronised BatchNorm) takes the
statistics over the batch of every data-parallel process: the forward's
(sum x, sum x^2) and the backward's (s1, s2) are summed over the processes
before use and the count is multiplied by their number, as
``ops/batchnorm.py::bn_train`` does.  The scale and bias gradients stay
this process's own sums; the step's gradient all-reduce adds them up.
"""
from __future__ import annotations

from typing import Optional

import torch

from .batchnorm import _all_reduce_pair
from .batchnorm import _per_channel as _c


def _dims(x: torch.Tensor):
    return (0,) + tuple(range(2, x.dim()))


def _pre_relu(x, mean, rstd_scale, bias, res):
    z = ((x.to(torch.float32) - _c(mean, x)) * _c(rstd_scale, x)
         + _c(bias, x)).to(x.dtype)
    return z if res is None else z + res.to(x.dtype)


class _BNAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, res, eps, relu, mesh):
        dims = _dims(x)
        xf = x.to(torch.float32)
        s1, s2 = xf.sum(dims), (xf * xf).sum(dims)
        del xf
        n = x.numel() // x.shape[1]
        if mesh is not None:
            s1, s2 = _all_reduce_pair(mesh, s1, s2)
            n *= mesh.size
        mean = s1 / n
        var = s2 / n - mean * mean
        rstd = torch.rsqrt(var + eps)
        z = _pre_relu(x, mean, rstd * scale, bias, res)
        y = torch.relu(z) if relu else z
        ctx.save_for_backward(x, res, mean, rstd, scale, bias)
        ctx.relu, ctx.mesh = relu, mesh
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, res, mean, rstd, scale, bias = ctx.saved_tensors
        dims = _dims(x)
        xhat = (x.to(torch.float32) - _c(mean, x)) * _c(rstd, x)
        g = dy
        if ctx.relu:
            # the forward's post-cast, pre-ReLU value, as JAX recomputes it
            z = (xhat * _c(scale, x) + _c(bias, x)).to(x.dtype)
            if res is not None:
                z = z + res.to(x.dtype)
            g = torch.where(z > 0, dy, torch.zeros((), dtype=dy.dtype,
                                                    device=dy.device))
            del z
        gf = g.to(torch.float32)
        own1, own2 = gf.sum(dims), (gf * xhat).sum(dims)
        s1, s2 = own1, own2
        n = x.numel() // x.shape[1]
        if ctx.mesh is not None:
            s1, s2 = _all_reduce_pair(ctx.mesh, own1, own2)
            n *= ctx.mesh.size
        dx = (_c(rstd * scale, x) * (gf - (_c(s1, x) + xhat * _c(s2, x)) / n)
              ).to(x.dtype)
        dres = None if res is None else g.to(res.dtype)
        return dx, own2, own1, dres, None, None, None


def bn_act_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 res: Optional[torch.Tensor] = None, *, eps: float = 1e-5,
                 relu: bool = True, mesh=None):
    """Train-mode BatchNorm over all but axis 1 of ``x`` (N, C, ...), then
    ``+ res`` (in x's dtype) where given, then a ReLU where ``relu``.
    Returns (y in x's dtype, f32 (C,) mean, f32 (C,) biased variance); the
    backward saves x, res, mean, rstd, scale and bias only."""
    C = x.shape[1]
    if tuple(scale.shape) != (C,) or tuple(bias.shape) != (C,):
        raise ValueError(f"bn_act_train: scale and bias must be ({C},)")
    return _BNAct.apply(x, scale.to(torch.float32), bias.to(torch.float32),
                        res, float(eps), bool(relu), mesh)
