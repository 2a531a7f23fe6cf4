"""Visual frontend: Conv3D stem + per-frame ResNet-18 trunk (counterpart of
the JAX package's ``models/frontend.py``).

    5-frame temporal stack (kernel K2) -> 2-D stem conv (the reference's
    Conv3d(1->64, k=(5,7,7), s=(1,2,2), p=(2,3,3)) with time folded into
    batch) -> BN -> ReLU -> 3x3/s2 max pool -> ResNet-18 (BasicBlock
    [2,2,2,2]) -> global average pool -> dropout -> (B, T, 512)

Layout is NCHW with frames folded into the batch: K2's output
(B, T, 5, S, S) reshaped to (B*T, 5, S, S) is the stem conv's input, the
same NCHW form the JAX Pallas path feeds its conv.  The stem weight keeps
the reference's conv3d meaning as a conv2d weight (C, kt, 7, 7).  Weights
are f32 and convs run in the compute dtype; BatchNorm runs in f32 (batch
statistics in training, running statistics in eval) and its output is
rounded to the compute dtype, as in JAX.

Three other BatchNorms replace the default one, each behind a module
field or an environment switch read when the frontend is built, all off by
default as in JAX; each keeps ``BatchNorm``'s parameters and buffers, so
checkpoints interchange:

* ``FastBatchNorm`` (``use_pallas_bn`` / ``PALLAS_BN``) takes the train-mode
  statistics from kernels K7/K8 (``ops/batchnorm.py::bn_train``);
* ``DotBatchNorm`` (``use_dot_bn`` / ``DOT_BN``, off under ``NO_DOT_BN``)
  takes them as matrix products (``ops/bn_dot.py``), with an f32 output;
* ``FusedBNAct`` (``use_fused_bn_act`` / ``FUSED_BN_ACT``, off under
  ``NO_FUSED_BN_ACT``) runs BatchNorm, the block's residual add and the
  ReLU as one autograd function that keeps only the conv output and
  per-channel statistics for the backward (``ops/bn_relu.py``).

The choice follows JAX's order: ``DotBatchNorm``, then ``FastBatchNorm``,
then ``FusedBNAct``, then the plain ``BatchNorm``; it replaces every
BatchNorm of the frontend (the stem's ``bn3d`` and each block's ``bn1``,
``bn2`` and ``downsample_bn``).  JAX's ``GroupedBatchNorm`` (per-replica
statistics inside one program) has no module here: a data-parallel process
is a replica, and ``parallel.set_sync_batchnorm`` chooses per-process or
synchronised statistics for every one of these classes.

``use_pallas_resblock`` (default False, as in JAX) sends every eligible
BasicBlock in eval mode through kernel K10 (``ops/resblock.py``): stride 1
and equal input and output widths, five of ResNet-18's eight blocks.
``forward_stacked`` takes the already stacked and normalized output of K9
(``ops/stem.py::stack_frames_u8``) in place of a clip.

``remat`` (the config's ``remat_frontend``, JAX ``nn.remat(BasicBlock)``)
checkpoints each ResNet block in training: the backward runs the block's
forward again (``torch.utils.checkpoint``, non-reentrant) instead of
keeping its activations.  The recompute takes the same batch statistics
(K7 launches again under ``PALLAS_BN``) but leaves the running statistics
alone, so they move once a step, as in JAX.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.batchnorm import bn_train
from ..ops.bn_dot import bn_train_dot
from ..ops.bn_relu import bn_act_train
from ..ops.resblock import fold_bn, fused_resblock, fused_resblock_plain
from ..ops.stem import stack_frames, stack_frames_plain
from .layers import DropoutRNG, dropout

STEM_KT = 5


def _he_normal_fan_out(w: torch.Tensor, g: torch.Generator) -> None:
    """He-normal fan-out init of an OIHW weight (JAX
    variance_scaling(2.0, "fan_out", "normal"); reference normal_(0,
    sqrt(2/n)) with n = prod(kernel) * out_channels)."""
    fan_out = w.shape[0] * math.prod(w.shape[2:])
    with torch.no_grad():
        w.copy_(torch.empty(w.shape).normal_(0.0, math.sqrt(2.0 / fan_out),
                                             generator=g))


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def _recomputing():
    """Marks a checkpoint's recompute on this thread (the autograd engine
    runs it on the thread doing the backward)."""
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = False


def _remat_contexts():
    return contextlib.nullcontext(), _recomputing()


def _update_running(bn: "BatchNorm", mean: torch.Tensor,
                    var: torch.Tensor) -> None:
    """ra = momentum * ra + (1 - momentum) * batch, except in a recompute."""
    if getattr(_RECOMPUTE, "on", False):
        return
    with torch.no_grad():
        keep = bn.momentum
        bn.running_mean.mul_(keep).add_((1.0 - keep) * mean)
        bn.running_var.mul_(keep).add_((1.0 - keep) * var)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the processes of a mesh whose backward sums the gradient
    over them too: each process's sums feed every process's loss."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.clone()
        mesh.all_reduce_(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        ctx.mesh.all_reduce_(g)
        return g, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over NCHW channels, in f32, with its formula
    y = (x - mean) * (scale * rsqrt(var + eps)) + bias.

    Eval mode uses the running statistics.  Train mode uses the batch mean
    and the biased variance E[x^2] - E[x]^2 (flax's fast variance, clipped
    at 0), and updates ra = momentum * ra + (1 - momentum) * batch: flax's
    momentum 0.9 is the share KEPT, where ``torch.nn.BatchNorm2d`` keeps
    1 - 0.1 and tracks the unbiased variance.

    ``sync`` (a ``parallel.DataMesh``, set by ``parallel.set_sync_batchnorm``)
    takes the train-mode statistics over the batch of every data-parallel
    process: (sum x, sum x^2) summed over them, differentiably; the running
    statistics then move the same way in each.  Without it they are this
    process's own (``torch.nn.SyncBatchNorm`` is not used: it keeps the
    unbiased variance and torch's momentum)."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.sync = None
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train(x)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = x.to(torch.float32, copy=True)
        y.sub_(self.running_mean[:, None, None])
        y.mul_(mul[:, None, None])
        return y.add_(self.bias[:, None, None])

    def _train(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.sync is None:
            mean = xf.mean(dim=(0, 2, 3))
            sq = (xf * xf).mean(dim=(0, 2, 3))
        else:
            C = xf.shape[1]
            sums = _AllReduceSum.apply(torch.cat([xf.sum(dim=(0, 2, 3)),
                                                  (xf * xf).sum(dim=(0, 2, 3))]),
                                       self.sync)
            n = xf.numel() // C * self.sync.size
            mean, sq = sums[:C] / n, sums[C:] / n
        var = torch.clamp(sq - mean * mean, min=0.0)
        _update_running(self, mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class FastBatchNorm(BatchNorm):
    """``BatchNorm`` whose train-mode statistics come from one read of x
    (K7) and whose backward takes its reductions from one read of (dy, x)
    (K8), through ``bn_train`` (JAX ``FastBatchNorm``).  The same
    parameters and buffers as ``BatchNorm``, so checkpoints interchange.
    Its train output is in x's dtype; eval mode is ``BatchNorm``'s, on the
    running statistics, and launches nothing new.  ``use_kernels`` False
    takes the kernels' plain versions on any device."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9,
                 use_kernels: bool = True):
        super().__init__(channels, eps, momentum)
        self.use_kernels = use_kernels

    def _train(self, x: torch.Tensor) -> torch.Tensor:
        y, mean, var = bn_train(x, self.weight, self.bias, self.eps,
                                self.use_kernels, self.sync)
        _update_running(self, mean, var)
        return y


def _c(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


class DotBatchNorm(BatchNorm):
    """``BatchNorm`` whose train-mode statistics and their gradients are
    matrix products (``ops/bn_dot.py::bn_train_dot``; JAX
    ``DotBatchNorm``).  Its output is f32 in both modes; the caller casts.
    Eval mode is JAX's formula x * inv + (bias - mean * inv) with
    inv = rsqrt(running_var + eps) * scale."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y, mean, var = bn_train_dot(x, self.weight, self.bias, self.eps,
                                        self.sync)
            _update_running(self, mean, var)
            return y
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x.to(torch.float32) * _c(inv)
                + _c(self.bias - self.running_mean * inv))


class FusedBNAct(BatchNorm):
    """BatchNorm (+ residual add) (+ ReLU) in one step
    (``ops/bn_relu.py::bn_act_train`` in training; JAX ``FusedBNAct``): the
    output is in x's dtype, ``res`` is added in x's dtype after the
    normalisation, and ``relu`` (set when the frontend is built) ends it
    with a ReLU.  Eval mode is JAX's formula, cast to x's dtype before the
    residual and the ReLU."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.9,
                 relu: bool = True):
        super().__init__(channels, eps, momentum)
        self.relu = relu

    def forward(self, x: torch.Tensor,
                res: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            y, mean, var = bn_act_train(x, self.weight, self.bias, res,
                                        eps=self.eps, relu=self.relu,
                                        mesh=self.sync)
            _update_running(self, mean, var)
            return y
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.to(torch.float32) * _c(inv)
             + _c(self.bias - self.running_mean * inv)).to(x.dtype)
        if res is not None:
            y = y + res.to(x.dtype)
        return F.relu(y) if self.relu else y


def pallas_bn_on(field: bool) -> bool:
    """The frontend's BatchNorms are ``FastBatchNorm`` (JAX
    ``_pallas_bn_on``): the module's field, or ``PALLAS_BN`` set."""
    return field or bool(os.environ.get("PALLAS_BN"))


def dot_bn_on(field: bool) -> bool:
    """``DotBatchNorm`` asked for (JAX ``_dot_bn_on``): ``NO_DOT_BN`` turns it
    off, the module's field or ``DOT_BN`` on."""
    if os.environ.get("NO_DOT_BN"):
        return False
    return field or bool(os.environ.get("DOT_BN"))


def fused_bn_act_on(field: bool) -> bool:
    """``FusedBNAct`` asked for (JAX ``_fused_bn_act_on``): ``NO_FUSED_BN_ACT``
    turns it off, the module's field or ``FUSED_BN_ACT`` on."""
    if os.environ.get("NO_FUSED_BN_ACT"):
        return False
    return field or bool(os.environ.get("FUSED_BN_ACT"))


def batchnorm_kind(use_pallas_bn: bool = False, use_dot_bn: bool = False,
                   use_fused_bn_act: bool = False) -> type:
    """The frontend's BatchNorm class, in JAX's order of precedence."""
    if dot_bn_on(use_dot_bn):
        return DotBatchNorm
    if pallas_bn_on(use_pallas_bn):
        return FastBatchNorm
    if fused_bn_act_on(use_fused_bn_act):
        return FusedBNAct
    return BatchNorm


def make_batchnorm(channels: int, eps: float, momentum: float, kind: type,
                   use_kernels: bool, relu: bool = True) -> BatchNorm:
    if kind is FastBatchNorm:
        return FastBatchNorm(channels, eps, momentum, use_kernels)
    if kind is FusedBNAct:
        return FusedBNAct(channels, eps, momentum, relu)
    return kind(channels, eps, momentum)


class Conv2d(nn.Conv2d):
    """Bias-free 'same' conv whose f32 weight is cast to the compute dtype
    where it is used (flax ``nn.Conv`` with ``dtype=``)."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int, dtype):
        super().__init__(c_in, c_out, k, stride=stride, padding=k // 2,
                         bias=False)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(self.compute_dtype), None)


class BasicBlock(nn.Module):
    """ResNet BasicBlock (reference video_frontend.py:15-41)."""

    def __init__(self, c_in: int, filters: int, stride: int = 1,
                 bn_epsilon: float = 1e-5, dtype=torch.float32,
                 bn_momentum: float = 0.9, use_pallas_bn: bool = False,
                 use_kernels: bool = True, use_pallas_resblock: bool = False,
                 use_dot_bn: bool = False, use_fused_bn_act: bool = False):
        super().__init__()
        self.dtype = dtype
        self.stride, self.bn_epsilon = stride, bn_epsilon
        self.use_kernels = use_kernels
        self.use_pallas_resblock = use_pallas_resblock
        kind = batchnorm_kind(use_pallas_bn, use_dot_bn, use_fused_bn_act)
        self.fused_bn_act = kind is FusedBNAct

        def bn(relu=True):
            return make_batchnorm(filters, bn_epsilon, bn_momentum, kind,
                                  use_kernels, relu)
        self.conv1 = Conv2d(c_in, filters, 3, stride, dtype)
        self.bn1 = bn()
        self.conv2 = Conv2d(filters, filters, 3, 1, dtype)
        self.bn2 = bn()
        self.has_downsample = stride != 1 or c_in != filters
        if self.has_downsample:
            self.downsample_conv = Conv2d(c_in, filters, 1, stride, dtype)
            self.downsample_bn = bn(relu=False)

    def init_weights(self, g: torch.Generator) -> None:
        for conv in (self.conv1, self.conv2):
            _he_normal_fan_out(conv.weight, g)
        if self.has_downsample:
            _he_normal_fan_out(self.downsample_conv.weight, g)

    def _fused_eligible(self, x: torch.Tensor) -> bool:
        """JAX ``BasicBlock._fused_eligible``: the switch, eval mode,
        stride 1, equal widths."""
        return (self.use_pallas_resblock and not self.training
                and self.stride == 1
                and x.shape[1] == self.conv2.weight.shape[0])

    def _fused_eval(self, x: torch.Tensor) -> torch.Tensor:
        a1, b1 = fold_bn(self.bn1.weight, self.bn1.bias, self.bn1.running_mean,
                         self.bn1.running_var, self.bn_epsilon)
        a2, b2 = fold_bn(self.bn2.weight, self.bn2.bias, self.bn2.running_mean,
                         self.bn2.running_var, self.bn_epsilon)
        fn = fused_resblock if self.use_kernels else fused_resblock_plain
        return fn(x.contiguous(), self.conv1.weight.to(self.dtype), a1, b1,
                  self.conv2.weight.to(self.dtype), a2, b2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._fused_eligible(x):
            return self._fused_eval(x)
        if self.fused_bn_act:
            return self._fused_bn_act_path(x)
        y = F.relu(self.bn1(self.conv1(x)).to(self.dtype))
        y = self.bn2(self.conv2(y)).to(self.dtype)
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x)).to(self.dtype)
        return F.relu(y + residual)

    def _fused_bn_act_path(self, x: torch.Tensor) -> torch.Tensor:
        """JAX ``BasicBlock._fused_bn_act_path``: bn1 with its ReLU,
        downsample_bn without one, bn2 with the residual and the ReLU, each
        a ``FusedBNAct`` whose output is in the compute dtype."""
        y = self.conv2(self.bn1(self.conv1(x)))
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return self.bn2(y, residual)


class ResNetTrunk(nn.Module):
    """Stemless ResNet-18 trunk: four stages at strides 1/2/2/2, global
    average pool (in f32) to the feature dim.  Blocks are named
    ``layer{stage}_block{b}`` as in JAX.  ``remat`` checkpoints each block
    in training."""

    def __init__(self, c_in: int, channels: Sequence[int] = (64, 128, 256, 512),
                 blocks: Sequence[int] = (2, 2, 2, 2), bn_epsilon: float = 1e-5,
                 dtype=torch.float32, bn_momentum: float = 0.9,
                 use_pallas_bn: bool = False, use_kernels: bool = True,
                 use_pallas_resblock: bool = False, remat: bool = False,
                 use_dot_bn: bool = False, use_fused_bn_act: bool = False):
        super().__init__()
        self.dtype, self.remat = dtype, remat
        self.names = []
        for stage, (ch, nblocks) in enumerate(zip(channels, blocks)):
            for b in range(nblocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"layer{stage + 1}_block{b}"
                self.add_module(name, BasicBlock(
                    c_in, ch, stride, bn_epsilon, dtype, bn_momentum,
                    use_pallas_bn, use_kernels, use_pallas_resblock,
                    use_dot_bn, use_fused_bn_act))
                self.names.append(name)
                c_in = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.remat and self.training and torch.is_grad_enabled()
        for name in self.names:
            block = getattr(self, name)
            if remat:
                x = checkpoint(block, x, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=_remat_contexts)
            else:
                x = block(x)
        return x.to(torch.float32).mean(dim=(2, 3)).to(self.dtype)


class VisualFrontend(nn.Module):
    """(B, T, S, S) normalized grayscale clip -> (B, T, feature_dim)."""

    def __init__(self, conv3d_channels: int = 64,
                 resnet_channels: Sequence[int] = (64, 128, 256, 512),
                 resnet_blocks: Sequence[int] = (2, 2, 2, 2),
                 feature_dim: int = 512, bn_epsilon: float = 1e-5,
                 dtype=torch.float32, use_kernels: bool = True,
                 dropout: float = 0.5, bn_momentum: float = 0.9,
                 use_pallas_bn: bool = False,
                 use_pallas_resblock: bool = False, remat: bool = False,
                 use_dot_bn: bool = False, use_fused_bn_act: bool = False):
        super().__init__()
        self.dtype, self.use_kernels = dtype, use_kernels
        self.feature_dim, self.dropout = feature_dim, dropout
        self.conv3d_weight = nn.Parameter(torch.empty(
            (conv3d_channels, STEM_KT, 7, 7)))
        self.bn3d = make_batchnorm(
            conv3d_channels, bn_epsilon, bn_momentum,
            batchnorm_kind(use_pallas_bn, use_dot_bn, use_fused_bn_act),
            use_kernels)
        self.resnet = ResNetTrunk(conv3d_channels, resnet_channels,
                                  resnet_blocks, bn_epsilon, dtype, bn_momentum,
                                  use_pallas_bn, use_kernels,
                                  use_pallas_resblock, remat, use_dot_bn,
                                  use_fused_bn_act)

    def init_weights(self, g: torch.Generator) -> None:
        _he_normal_fan_out(self.conv3d_weight, g)

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """BatchNorm follows the module's train/eval mode; ``rng`` (the
        training forward's random numbers) turns on ``feat_drop``."""
        stack = stack_frames if self.use_kernels else stack_frames_plain
        return self.forward_stacked(stack(x.to(self.dtype).contiguous(), STEM_KT),
                                    rng)

    def forward_stacked(self, xs: torch.Tensor,
                        rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """The frontend from the stacked stem input on: xs is (B, T, kt, S,
        S) in the compute dtype, K2's or K9's output."""
        B, T, kt, H, W = xs.shape
        xs = xs.reshape(B * T, kt, H, W)
        y = F.conv2d(xs, self.conv3d_weight.to(self.dtype), stride=2, padding=3)
        if isinstance(self.bn3d, FusedBNAct):
            y = self.bn3d(y)
        else:
            y = F.relu(self.bn3d(y)).to(self.dtype)
        # the reference's MaxPool3d(k=(1,3,3), s=(1,2,2), p=(0,1,1)) with
        # time folded into batch (JAX ops/maxpool.py; both give a tie's
        # gradient to the row-major-first maximum)
        y = F.max_pool2d(y, 3, 2, 1)
        y = dropout(self.resnet(y), self.dropout, rng)
        return y.reshape(B, T, self.feature_dim)


def frontend_from_config(cfg, dtype=torch.float32, use_kernels: bool = True,
                         use_pallas_resblock: bool = False,
                         remat: bool = False) -> VisualFrontend:
    return VisualFrontend(
        conv3d_channels=cfg.conv3d_channels,
        resnet_channels=tuple(cfg.resnet_channels),
        resnet_blocks=tuple(cfg.resnet_blocks),
        feature_dim=cfg.feature_dim,
        bn_epsilon=cfg.bn_epsilon,
        dtype=dtype,
        use_kernels=use_kernels,
        dropout=cfg.dropout,
        bn_momentum=cfg.bn_momentum,
        use_pallas_resblock=use_pallas_resblock,
        remat=remat,
    )
